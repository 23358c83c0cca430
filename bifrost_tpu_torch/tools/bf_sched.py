"""Scheduler CLI: plan, lint and inspect cross-host tenant placements
(:mod:`bifrost_tpu_torch.scheduler`; the counterpart of
``tools/bf_sched.py``, same spec files).  Subcommands::

    python -m bifrost_tpu_torch.tools.bf_sched plan fabric.json service.json
        Pack the service spec's tenants across the fabric spec's hosts
        (priority-weighted worst-fit on declared cores), run the joint
        verify_placement pre-gate (verify_fabric + verify_service + the
        BF-E22x placement codes) and print the placement table.  Exit 0
        when the plan is admissible, 3 on any BF-E, 2 when a spec cannot
        be read.

    python -m bifrost_tpu_torch.tools.bf_sched lint fabric.json service.json
        The same gate, diagnostics only.

    python -m bifrost_tpu_torch.tools.bf_sched status
        The joined per-host x per-tenant rollup of the local ProcLog
        tree (``fabric/health`` + ``service/tenants`` +
        ``sched/placements``).

Knobs: ``BF_SCHED_REBALANCE_SECS`` (death-watch poll),
``BF_SCHED_DISPLACE_QUOTA_FRAC`` (displaced tenants' quota scale),
``BF_SCHED_MAX_REPLACEMENTS`` (re-placement event cap),
``BF_SCHED_ARBITER_FRAC`` (the arbiter's quota transfer).
"""

import argparse
import json
import sys


def _load(fabric_path, service_path):
    from ..fabric import FabricSpec
    from ..service import TenantSpec
    spec = FabricSpec.load(fabric_path)
    with open(service_path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or not doc.get('tenants'):
        raise ValueError('service spec must be a JSON object with a '
                         'non-empty "tenants" list')
    return spec, [TenantSpec.coerce(t) for t in doc['tenants']]


def _plan_and_gate(args):
    """(spec, tenants, placement, diagnostics), or an exit code."""
    from .. import scheduler
    from ..analysis import verify
    try:
        spec, tenants = _load(args.fabric, args.service)
    except (OSError, ValueError) as exc:
        print('bf_sched: cannot read specs: %s' % exc)
        return 2
    try:
        placement = scheduler.plan_placement(
            spec, tenants,
            exclude=[h for h in (args.exclude or '').split(',') if h])
    except scheduler.PlacementError as exc:
        for d in exc.diagnostics:
            print('bf_sched: %r' % d)
        print('bf_sched: placement infeasible (%d error(s))'
              % len(exc.diagnostics))
        return 3
    return (spec, tenants, placement,
            verify.verify_placement(spec, tenants, placement.assignments))


def cmd_plan(args):
    res = _plan_and_gate(args)
    if isinstance(res, int):
        return res
    spec, tenants, placement, diags = res
    for d in diags:
        print('bf_sched: %r' % d)
    print('bf_sched: fabric %r: %d host(s), %d tenant(s), %d diagnostic(s)'
          % (spec.name, len(spec.hosts), len(tenants), len(diags)))
    for host in sorted(placement.capacity):
        tids = placement.tenants_on(host)
        demand = placement.demand.get(host, 0)
        print('  host %-12s cores=%d demand=%d  %s%s'
              % (host, placement.capacity[host], demand,
                 ' '.join(tids) or '(idle)',
                 '  OVERSUBSCRIBED' if demand > placement.capacity[host]
                 else ''))
    if placement.displaced:
        print('  displaced (quota-scaled, shed by policy): %s'
              % ', '.join(placement.displaced))
    nerr = sum(1 for d in diags if d.is_error)
    print('bf_sched: plan %s' % ('PASS' if nerr == 0
                                 else 'FAIL (%d error(s))' % nerr))
    return 3 if nerr else 0


def cmd_lint(args):
    from ..analysis.verify import format_report, errors
    res = _plan_and_gate(args)
    if isinstance(res, int):
        return res
    spec, tenants, _placement, diags = res
    print('bf_sched: fabric %r x %d tenant(s): %d diagnostic(s)'
          % (spec.name, len(tenants), len(diags)))
    print(format_report(diags) if diags else '  (clean)')
    return 3 if errors(diags) else 0


def cmd_status(args):
    from .. import scheduler
    print(scheduler.format_rollup(scheduler.joined_rollup()))
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest='cmd', required=True)
    for name, fn, helptext in (
            ('plan', cmd_plan,
             'pack tenants across hosts and print the table'),
            ('lint', cmd_lint,
             'joint placement pre-gate, diagnostics only')):
        p = sub.add_parser(name, help=helptext)
        p.add_argument('fabric', help='fabric spec JSON')
        p.add_argument('service', help='service spec JSON')
        p.add_argument('--exclude', default='',
                       help='comma-separated hosts to treat as dead')
        p.set_defaults(fn=fn)
    p = sub.add_parser('status',
                       help='joined host x tenant rollup from proclogs')
    p.set_defaults(fn=cmd_status)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == '__main__':
    sys.exit(main())
