"""CLI: turn the local usage tracker on or off and show what it holds
(the port of ``bifrost_tpu/telemetry/__main__.py``; reference:
python/bifrost/telemetry/__main__.py, without the install key: nothing is
ever sent).

``--status`` also prints this process's live counters and histograms
(:func:`bifrost_tpu_torch.telemetry.snapshot`), which are empty in a
fresh CLI process.

    python -m bifrost_tpu_torch.telemetry --enable | --disable | --status
"""

import argparse
import json

from . import disable, enable, is_active, snapshot, usage_path

parser = argparse.ArgumentParser(
    description='update the bifrost_tpu_torch LOCAL telemetry setting '
                '(aggregates stay on this machine; no network)')
group = parser.add_mutually_exclusive_group(required=False)
group.add_argument('-e', '--enable', action='store_true',
                   help='enable local usage aggregation')
group.add_argument('-d', '--disable', action='store_true',
                   help='disable local usage aggregation')
parser.add_argument('-s', '--status', action='store_true',
                    help='show the aggregated usage counters')
args = parser.parse_args()

if args.enable:
    enable()
elif args.disable:
    disable()

# 'in-active' is the reference CLI's wording, kept for output parity
print("bifrost_tpu_torch local telemetry is %s (file: %s)"
      % ('active' if is_active() else 'in-active', usage_path()))

if args.status:
    try:
        with open(usage_path()) as f:
            data = json.load(f)
    except (OSError, ValueError):
        data = {}
    if not data:
        print("  no usage recorded")
    for name in sorted(data):
        n, nt, total = data[name]
        line = "  %-60s %8d calls" % (name, n)
        if nt:
            line += "  %.3fs total" % total
        print(line)

    snap = snapshot()
    print("\nlive process counters:")
    if not snap['counters']:
        print("  (none this process)")
    for name in sorted(snap['counters']):
        print("  %-60s %12d" % (name, snap['counters'][name]))
    print("live process histograms (count / p50 / p99):")
    if not snap['histograms']:
        print("  (none this process)")
    for name in sorted(snap['histograms']):
        h = snap['histograms'][name]
        print("  %-60s %8d  %g / %g" % (name, h['count'],
                                        h['p50'], h['p99']))
