"""Fabric CLI: lint, launch and inspect multi-host fabric specs
(:mod:`bifrost_tpu_torch.fabric`; the counterpart of
``tools/bf_fabric.py``, same spec file).  Subcommands::

    python -m bifrost_tpu_torch.tools.bf_fabric lint spec.json
        Statically verify the spec (analysis.verify.verify_fabric:
        BF-E200 endpoint mismatch, BF-E201 port collision, BF-W202
        window/stripe sizing, BF-W203 quota against span) and print the
        report.  Exit 0 clean, 3 errors found, 2 the spec could not be
        read.

    python -m bifrost_tpu_torch.tools.bf_fabric launch spec.json \\
            --host NAME --builder pkg.mod:fn [--device cpu]
        Build and run NAME's sub-pipeline: the builder callable gets a
        FabricHostContext (ctx.source / ctx.sink wire the spec's links).
        Runs until the stream ends or SIGTERM drains the fabric.  This
        is the per-host entry point a process supervisor runs.

    python -m bifrost_tpu_torch.tools.bf_fabric up spec.json \\
            --builder pkg.mod:fn [--hosts a,b,...] [--device cpu]
        Loopback demo and drill: start every host of the spec (or a
        subset) as a ``launch`` subprocess of this machine, forward
        SIGINT/SIGTERM, and exit when all hosts have.  The builder must
        dispatch on ``ctx.host``.

    python -m bifrost_tpu_torch.tools.bf_fabric status [--verbose]
        Every launcher's ``fabric/health`` row in the local ProcLog tree
        (state, peers, end-to-end age p99), then the joined per-host x
        per-tenant rollup (``bifrost_tpu_torch.scheduler.joined_rollup``).

``pkg.mod:fn`` imports ``pkg.mod`` (relative module paths resolve from
the working directory) and calls ``fn`` with the context.  A host whose
chain copies to ``cuda`` runs on the card unless ``--device cpu``.
"""

import argparse
import importlib
import os
import signal
import subprocess
import sys

#: the directory that holds the package, put on a launched host's path
_PKG_PARENT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _load_spec(path):
    from ..fabric import FabricSpec
    return FabricSpec.load(path)


def _load_builder(spec_str):
    mod_name, _, fn_name = spec_str.partition(':')
    if not fn_name:
        raise ValueError("--builder must be 'module:function'")
    sys.path.insert(0, os.getcwd())
    mod = importlib.import_module(mod_name)
    return getattr(mod, fn_name)


def _set_device(args):
    if getattr(args, 'device', None):
        from .. import device
        device.set_device(args.device)


def cmd_lint(args):
    from ..analysis.verify import verify_fabric, format_report, errors
    try:
        spec = _load_spec(args.spec)
    except (OSError, ValueError) as exc:
        print('bf_fabric: cannot read spec %s: %s' % (args.spec, exc))
        return 2
    diags = verify_fabric(spec)
    print('bf_fabric: fabric %r: %d host(s), %d link(s), %d diagnostic(s)'
          % (spec.name, len(spec.hosts), len(spec.links), len(diags)))
    print(format_report(diags) if diags else '  (clean)')
    return 3 if errors(diags) else 0


def cmd_launch(args):
    from ..fabric import FabricHost
    _set_device(args)
    spec = _load_spec(args.spec)
    builder = _load_builder(args.builder)
    fh = FabricHost(spec, args.host, builder)
    fh.build()
    fh.run()
    state = fh.health()['state']
    print('bf_fabric: host %r finished in state %s' % (args.host, state))
    return 0 if state in ('OK', 'DEGRADED') else 3


def cmd_up(args):
    spec = _load_spec(args.spec)
    hosts = args.hosts.split(',') if args.hosts else sorted(spec.hosts)
    env = dict(os.environ)
    env['PYTHONPATH'] = os.pathsep.join(
        p for p in (_PKG_PARENT, env.get('PYTHONPATH')) if p)
    extra = ['--device', args.device] if args.device else []
    procs = {}
    for host in hosts:
        procs[host] = subprocess.Popen(
            [sys.executable, '-m', 'bifrost_tpu_torch.tools.bf_fabric',
             'launch', args.spec, '--host', host, '--builder',
             args.builder] + extra, env=env)

    def forward(signum, _frame):
        for p in procs.values():
            if p.poll() is None:
                p.send_signal(signum)
    signal.signal(signal.SIGINT, forward)
    signal.signal(signal.SIGTERM, forward)
    rc = 0
    for host, p in procs.items():
        p.wait()
        print('bf_fabric: host %r exited rc=%d' % (host, p.returncode))
        rc = rc or p.returncode
    return rc


def cmd_status(args):
    from .. import proclog
    from ..monitor_utils import list_pipelines
    from ..scheduler import joined_rollup, format_rollup
    rows = 0
    for pid in list_pipelines():
        contents = proclog.load_by_pid(pid)
        row = contents.get('fabric', {}).get('health')
        if not row:
            continue
        rows += 1
        print('%-24s host %-12s role %-8s state %-9s peers %s/%s dead=%s%s'
              % (pid, row.get('host', '?'), row.get('role', '?'),
                 row.get('state', '?'), row.get('peers_alive', '?'),
                 row.get('peers_total', '?'), row.get('peers_dead', 'none'),
                 ('  e2e_p99=%sms' % row['fabric_exit_age_p99_ms'])
                 if row.get('fabric_exit_age_p99_ms') not in (None, '')
                 else ''))
        member = contents.get('fabric', {}).get('membership')
        if member and args.verbose:
            peers = ['%s=%s' % (k[len('peer.'):], v)
                     for k, v in sorted(member.items())
                     if k.startswith('peer.')]
            if peers:
                print('  peers: %s' % '  '.join(peers))
    if not rows:
        print('bf_fabric: no fabric launchers found in the proclog tree '
              '(%s)' % proclog.proclog_dir())
    joined = joined_rollup()
    if any(r['tenants'] for r in joined):
        print('bf_fabric: host x tenant rollup:')
        print(format_rollup(joined))
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest='cmd', required=True)
    p = sub.add_parser('lint', help='statically verify a fabric spec')
    p.add_argument('spec')
    p.set_defaults(fn=cmd_lint)
    for name, fn, helptext in (
            ('launch', cmd_launch, "run one host's sub-pipeline"),
            ('up', cmd_up, 'start every host locally (demo)')):
        p = sub.add_parser(name, help=helptext)
        p.add_argument('spec')
        if name == 'launch':
            p.add_argument('--host', required=True)
        else:
            p.add_argument('--hosts', default='',
                           help='comma-separated subset (default: all)')
        p.add_argument('--builder', required=True,
                       help="builder callable as 'module:function'")
        p.add_argument('--device', default=None,
                       help="device of the hosts' 'cuda' rings (default "
                            "cuda:0)")
        p.set_defaults(fn=fn)
    p = sub.add_parser('status', help='fabric status from proclogs')
    p.add_argument('--verbose', action='store_true')
    p.set_defaults(fn=cmd_status)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == '__main__':
    sys.exit(main())
