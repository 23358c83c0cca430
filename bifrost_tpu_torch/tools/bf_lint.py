"""bf_lint: run the port's static pipeline verifier
(:mod:`bifrost_tpu_torch.analysis.verify`) over a pipeline script WITHOUT
running the pipeline.

    python -m bifrost_tpu_torch.tools.bf_lint examples/fdmt_search_torch.py
    python -m bifrost_tpu_torch.tools.bf_lint --strict examples/gpuspec_simple_torch.py
    python -m bifrost_tpu_torch.tools.bf_lint --codes

**Script mode**: the script runs in a subprocess with ``BF_LINT=1``,
which makes every ``Pipeline.run()`` validate the constructed
block/ring graph, report its diagnostics, and return WITHOUT launching
block threads — the script executes end to end as a pure topology
constructor.  Post-run script logic that expects real output may fail;
that is tolerated as long as at least one pipeline was linted (the
diagnostics were already captured through ``BF_LINT_OUT``).

**Topology mode** (``--topology NAME``, ``--list-topologies``) builds
the benchmark's registered topologies; the port has no benchmark
topologies yet, so every name is unknown (exit 2) and the list is empty.

Exit codes (matching ``telemetry_diff``'s convention): 0 =
advisory mode, or strict mode with no ``BF-E``; 3 = ``--strict`` and
at least one ``BF-E`` diagnostic; 2 = the target could not be linted
at all (script crashed before building a pipeline, unknown topology).
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile

#: the repository root: scripts run from here, with the package on their
#: path
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: the benchmark's pipeline topologies, by name (none in the port yet)
TOPOLOGIES = {}


def lint_script(path, args, timeout):
    """Run ``path`` under BF_LINT=1; returns (records, proc) where
    records is the list of per-pipeline diagnostic dicts collected via
    BF_LINT_OUT."""
    out = tempfile.NamedTemporaryFile(prefix='bf_lint_', suffix='.jsonl',
                                      delete=False)
    out.close()
    env = dict(os.environ)
    env['BF_LINT'] = '1'
    env['BF_LINT_OUT'] = out.name
    env['PYTHONPATH'] = os.pathsep.join(
        [ROOT] + [p for p in env.get('PYTHONPATH', '').split(os.pathsep)
                  if p])
    proc = subprocess.run([sys.executable, path] + list(args),
                          capture_output=True, text=True, env=env,
                          cwd=ROOT, timeout=timeout)
    records = []
    try:
        with open(out.name) as f:
            for line in f:
                line = line.strip()
                if line:
                    try:
                        records.append(json.loads(line))
                    except ValueError:
                        pass
    finally:
        os.unlink(out.name)
    return records, proc


def lint_topology(name):
    """Build one registered topology in-process and validate it.
    Returns the per-pipeline record list (a topology may build several
    pipelines), or None when the topology reports itself unavailable
    on this host (e.g. a mesh topology without enough devices)."""
    makers = TOPOLOGIES
    if name not in makers:
        raise KeyError('unknown topology %r (have: %s)'
                       % (name, ', '.join(sorted(makers))))
    built = makers[name]()
    if built is None:
        return None
    pipelines = built if isinstance(built, (list, tuple)) else [built]
    records = []
    for p in pipelines:
        diags = p.validate()
        records.append({'pipeline': p.name, 'nblocks': len(p.blocks),
                        'diagnostics': [d.as_dict() for d in diags]})
    return records


def summarize(records, label, show_info=False):
    ne = nw = ni = 0
    for rec in records:
        for d in rec['diagnostics']:
            sev = d['severity']
            ne += sev == 'error'
            nw += sev == 'warning'
            ni += sev == 'info'
            if sev == 'info' and not show_info:
                continue
            where = d.get('block') or ''
            if d.get('ring'):
                where += ('@' if where else '') + 'ring:%s' % d['ring']
            print('%s %-9s %-40s %s' % (d['code'], sev, where,
                                        d['message']))
    print('bf_lint: %s — %d pipeline(s), %d error(s), %d warning(s), '
          '%d info' % (label, len(records), ne, nw, ni))
    return ne


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument('script', nargs='?',
                    help='pipeline script to lint (BF_LINT=1 mode)')
    ap.add_argument('script_args', nargs=argparse.REMAINDER,
                    help='arguments passed through to the script')
    ap.add_argument('--topology', default=None,
                    help='lint a named benchmark topology in-process')
    ap.add_argument('--list-topologies', action='store_true',
                    help='list registered bench topologies and exit')
    ap.add_argument('--codes', action='store_true',
                    help='print the diagnostic-code catalog and exit')
    ap.add_argument('--strict', action='store_true',
                    help='exit 3 when any BF-E diagnostic is reported '
                         '(default: advisory, exit 0)')
    ap.add_argument('--show-info', action='store_true',
                    help='print BF-I info diagnostics too')
    ap.add_argument('--timeout', type=float, default=300.0,
                    help='script-mode subprocess timeout (seconds)')
    args = ap.parse_args(argv)

    if args.codes:
        from ..analysis.verify import CODES
        for code in sorted(CODES):
            print('%s  %s' % (code, CODES[code]))
        return 0
    if args.list_topologies:
        for name in sorted(TOPOLOGIES):
            print(name)
        return 0

    if args.topology:
        try:
            records = lint_topology(args.topology)
        except KeyError as exc:
            print('bf_lint: %s' % exc, file=sys.stderr)
            return 2
        if records is None:
            print('bf_lint: topology %r unavailable on this host '
                  '(skipped)' % args.topology)
            return 0
        nerr = summarize(records, 'topology %s' % args.topology,
                         args.show_info)
        return 3 if (args.strict and nerr) else 0

    if not args.script:
        print('bf_lint: a script path or --topology is required '
              '(see --help)', file=sys.stderr)
        return 2
    try:
        records, proc = lint_script(args.script, args.script_args,
                                    args.timeout)
    except subprocess.TimeoutExpired:
        print('bf_lint: %s timed out' % args.script, file=sys.stderr)
        return 2
    if not records:
        print('bf_lint: %s built no pipeline under BF_LINT=1 '
              '(rc=%d)\n%s' % (args.script, proc.returncode,
                               proc.stderr[-2000:]), file=sys.stderr)
        return 2
    nerr = summarize(records, args.script, args.show_info)
    return 3 if (args.strict and nerr) else 0


if __name__ == '__main__':
    sys.exit(main())
