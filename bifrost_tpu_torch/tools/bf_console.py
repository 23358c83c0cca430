"""Fleet console: stand up a FleetCollector and watch the rollup.

The console is the receiving end of the streaming telemetry plane
(docs/observability.md "Fleet plane"): it binds the collector's UDP
port, prints the address publishers should stream to (point each
host's ``BF_FLEET_COLLECTOR`` at it), and renders the merged per-host
/ per-tenant / alert view on an interval — the same renderer as
``like_top --fleet``.

    # collector + live text view, alert rules + black-box recorder on
    python -m bifrost_tpu_torch.tools.bf_console --bind 0.0.0.0:9720 \\
        --rules alert_rules.json --incident-dir ./incidents \\
        --prom-file /var/lib/node_exporter/bifrost_fleet.prom

    # with fabric death verdicts (unknown-vs-dead — docs/fabric.md)
    python -m bifrost_tpu_torch.tools.bf_console --fabric fabric.json --host head

``--once`` waits one interval and prints a single snapshot (usable in
pipes/tests); ``--duration`` bounds the run for scripted drills.
Exports keep flowing while the console renders: ``--rollup-file``
feeds other ``like_top --fleet`` instances, ``--prom-file`` a node
exporter.
"""

import argparse
import os
import sys
import time


from ..telemetry import fleet
from .like_top import render_fleet


def _parse_bind(value):
    host, _, port = value.rpartition(':')
    if not host:
        host, port = value, '0'
    return host, int(port)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument('--bind', default='127.0.0.1:0',
                    help='UDP address to receive telemetry on '
                         '(host:port; port 0 picks one)')
    ap.add_argument('--rules', default=None,
                    help='alert-rules JSON (default: BF_ALERT_RULES)')
    ap.add_argument('--incident-dir', default=None,
                    help='black-box bundle directory (default: '
                         'BF_FLEET_INCIDENT_DIR)')
    ap.add_argument('--rollup-file', default=None,
                    help='also write the rollup JSON here each tick '
                         '(default: BF_FLEET_ROLLUP_FILE)')
    ap.add_argument('--prom-file', default=None,
                    help='also write the merged Prometheus textfile '
                         '(default: BF_FLEET_PROM_FILE)')
    ap.add_argument('--fabric', default=None,
                    help='FabricSpec JSON: run Membership for death '
                         'verdicts (needs --host)')
    ap.add_argument('--host', default=None,
                    help='this host\'s name in the fabric spec')
    ap.add_argument('--interval', type=float, default=2.0,
                    help='render interval in seconds')
    ap.add_argument('--duration', type=float, default=None,
                    help='exit after this many seconds')
    ap.add_argument('--once', action='store_true',
                    help='wait one interval, print one snapshot, exit')
    args = ap.parse_args(argv)

    membership = None
    if args.fabric:
        if not args.host:
            print('bf_console: --fabric needs --host', file=sys.stderr)
            return 2
        from ..fabric import FabricSpec, Membership
        spec = FabricSpec.load(args.fabric)
        membership = Membership(spec, args.host)
        membership.start()

    rules = fleet.load_rules(args.rules) if args.rules \
        else fleet.load_rules()
    coll = fleet.FleetCollector(
        bind=_parse_bind(args.bind), membership=membership,
        rules=rules, incident_dir=args.incident_dir,
        rollup_file=args.rollup_file, prom_file=args.prom_file)
    coll.start()
    print('bf_console: collecting on %s:%d — set '
          'BF_FLEET_COLLECTOR=<this-host>:%d on each publisher'
          % (coll.bind_host, coll.port, coll.port))
    t0 = time.monotonic()
    try:
        while True:
            time.sleep(args.interval)
            lines = render_fleet(coll.rollup())
            print('\n'.join(lines))
            print('')
            sys.stdout.flush()
            if args.once:
                break
            if args.duration is not None and \
                    time.monotonic() - t0 >= args.duration:
                break
    except KeyboardInterrupt:
        pass
    finally:
        coll.stop()
        if membership is not None:
            membership.stop()
    return 0


if __name__ == '__main__':
    sys.exit(main())
