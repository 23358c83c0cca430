"""bf_serve: run N tenant pipelines as one multi-tenant service
(:mod:`bifrost_tpu_torch.service`; the counterpart of
``tools/bf_serve.py``, same spec file)::

    python -m bifrost_tpu_torch.tools.bf_serve spec.json [--duration S]
    python -m bifrost_tpu_torch.tools.bf_serve spec.json --validate

The spec file is JSON::

    {"max_tenants": 8,                     # optional
     "tenants": [
       {"id": "replay0",
        "source": {"kind": "replay", "basenames": ["rec/pulses"],
                   "gulp_nframe": 256, "loop": 4, "restamp": true},
        "priority": 2, "ncores": 2,
        "quota_bytes_per_s": 50e6, "quota_policy": "pace",
        "slo_ms": 250, "sink": "discard"},
       {"id": "cap0",
        "source": {"kind": "udp", "port": 12345, "nsrc": 4,
                   "payload": 4096, "buffer_ntime": 512},
        "gulp_nframe": 256, "overload_policy": "drop_oldest",
        "quota_bytes_per_s": 100e6}
     ]}

Source kinds: ``replay`` (``blocks/serialize.py`` recordings, looped),
``file`` (flat binary), ``synthetic`` (paced deterministic stream),
``udp`` (live capture; the service owns the capture pump).  Sinks:
``discard`` (default) or ``serialize``.

``--validate`` runs ``analysis.verify.verify_service`` (BF-E210
duplicate tenant, BF-E211 quota below one gulp, BF-W212 core
oversubscription), builds every tenant pipeline and lints each with the
pipeline verifier, without running anything; exit 3 on any BF-E.

Without ``--validate`` the service runs until every tenant finishes (or
``--duration`` elapses) and prints the per-tenant rollup (the
``tenants`` section of ``telemetry.snapshot()``) as JSON.
``python -m bifrost_tpu_torch.tools.like_top`` renders the live
``[tenants]`` pane.  Tenant chains that copy to ``cuda`` run on the
card; ``--device cpu`` runs them on the CPU.
"""

import argparse
import json
import sys
import time

from .. import service
from ..analysis import verify


def load_spec(path):
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or not doc.get('tenants'):
        raise SystemExit('bf_serve: spec must be a JSON object with a '
                         'non-empty "tenants" list')
    specs = [service.TenantSpec.coerce(t) for t in doc['tenants']]
    return doc, specs


def _max_tenants(doc, specs):
    return int(doc.get('max_tenants', 0) or max(len(specs), 8))


def validate(doc, specs):
    diags = verify.verify_service(specs)
    for d in diags:
        print('bf_serve: %r' % d)
    nerr = sum(1 for d in diags if d.is_error)
    if nerr:
        print('bf_serve: %d spec error(s); not building' % nerr)
        return 3
    mgr = service.JobManager(max_tenants=_max_tenants(doc, specs),
                             warm=False)
    total_err = 0
    try:
        for s in specs:
            try:
                job = mgr.submit(s)
            except service.ServiceError as exc:
                # an admission refusal is a lint finding here
                total_err += 1
                print('bf_serve: tenant %-16s REJECTED: %s' % (s.id, exc))
                continue
            pdiags = job.pipeline.validate()
            errs = [d for d in pdiags if d.is_error]
            total_err += len(errs)
            print('bf_serve: tenant %-16s %d diagnostic(s), %d error(s)'
                  % (s.id, len(pdiags), len(errs)))
            for d in pdiags:
                if d.severity != 'info':
                    print('    %r' % d)
    finally:
        # a 'udp' tenant binds its capture port at build time
        for job in mgr.jobs():
            try:
                job.stop(0)
            except Exception:
                pass
    print('bf_serve: validate %s (%d tenant(s), %d error(s))'
          % ('PASS' if total_err == 0 else 'FAIL', len(specs), total_err))
    return 0 if total_err == 0 else 3


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument('spec', help='service spec JSON file')
    ap.add_argument('--duration', type=float, default=None,
                    help='stop the service after this many seconds '
                         '(default: run until every tenant finishes)')
    ap.add_argument('--validate', action='store_true',
                    help='static spec and pipeline verification only')
    ap.add_argument('--device', default=None,
                    help="device of the tenants' 'cuda' rings (default "
                         "cuda:0; 'cpu' without a card)")
    args = ap.parse_args(argv)
    if args.device:
        from .. import device
        device.set_device(args.device)

    doc, specs = load_spec(args.spec)
    if args.validate:
        return validate(doc, specs)

    mgr = service.JobManager(max_tenants=_max_tenants(doc, specs))
    for s in specs:
        try:
            job = mgr.submit(s)
        except service.ServiceError as exc:
            print('bf_serve: tenant %r rejected: %s' % (s.id, exc))
            mgr.shutdown()
            return 3
        print('bf_serve: admitted tenant %-16s cores=%s warm=%s'
              % (s.id, job.cores, 'yes' if job.warm else 'no'))
    mgr.start()
    try:
        if args.duration:
            deadline = time.monotonic() + args.duration
            while time.monotonic() < deadline and any(
                    j.state == 'RUNNING' for j in mgr.jobs()):
                time.sleep(0.25)
        else:
            mgr.wait()
    except KeyboardInterrupt:
        print('bf_serve: interrupted; shutting tenants down')
    finally:
        mgr.shutdown()
    out = service.telemetry_section()
    print(json.dumps(out, indent=1, sort_keys=True, default=str))
    # beside a fabric launcher or a scheduler, the joined host x tenant
    # table too
    try:
        from ..scheduler import joined_rollup, format_rollup
        joined = joined_rollup()
        if any(r['tenants'] for r in joined):
            print('bf_serve: host x tenant rollup:')
            print(format_rollup(joined))
    except Exception:
        pass
    failed = [tid for tid, d in out.items() if d.get('state') == 'FAILED']
    if failed:
        print('bf_serve: %d tenant(s) FAILED: %s'
              % (len(failed), ', '.join(failed)))
        return 1
    return 0


if __name__ == '__main__':
    sys.exit(main())
