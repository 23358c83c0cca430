"""Regression sentinel: diff two telemetry snapshots or bench
artifacts and flag drifts beyond thresholds.

    python -m bifrost_tpu_torch.tools.telemetry_diff BASELINE.json CURRENT.json
    python -m bifrost_tpu_torch.tools.telemetry_diff old_snap.json new_snap.json --strict

Accepts any JSON the framework emits — ``telemetry.snapshot()`` dumps,
``BENCH_*.json`` bench artifacts, gate artifacts — and compares every
numeric leaf it can match between the two files (flattened to
dot-paths).  A built-in watchlist knows which metrics matter and which
DIRECTION is bad:

    pattern                 worse when   threshold
    gulps_per_s / GBps /
      Msamples/s /
      value (throughput unit)  lower      10%%
    *_p99 / p99* / *_ms /
      ms_per_gulp / wait /
      value (latency unit)    higher     25%%
    occupancy_pct             higher     20 points (absolute)
    violations / dropped /
      crc_errors / reconnects
      / fallback              higher     any increase
    segment.elided_rings /
      segment.dispatches      lower      any decrease (fusion
                                         silently disengaged)
    overhead_pct              higher     2 points (absolute)
    fleet.*_errors /
      fleet.pub.errors /
      alerts.sink_errors /
      incident.errors         higher     any increase (telemetry
                                         silently dropping)
    fleet.hosts_live          lower      any decrease (a publisher
                                         stopped streaming)
    fdmt.candidates_per_s     lower      10%%
    segment.overlap_carried   lower      any decrease (halo carry
                                         silently disengaged)
    capture.pps /
      capture.gbps            lower      10%% (zero-copy batched
                                         capture path disengaged)
    capture.loss_frac         higher     +0.005 absolute

Unmatched numeric keys are compared informationally (reported at
>50%% drift, never flagged).  Exit code 0 = no regressions (advisory
mode, the default, ALWAYS exits 0 unless the inputs are unreadable);
``--strict`` exits 3 when any watched metric regressed beyond its
threshold.  ``--out``
writes the full report as JSON.
"""

import argparse
import fnmatch
import json
import sys

#: (glob over the flattened dot-path, direction, kind, threshold)
#: direction: 'lower' = lower is worse, 'higher' = higher is worse
#: kind: 'pct' relative %, 'abs' absolute delta, 'any' any worsening
WATCHLIST = [
    ('*gulps_per_s*', 'lower', 'pct', 10.0),
    ('*GBps*', 'lower', 'pct', 10.0),
    ('*Msamples*', 'lower', 'pct', 10.0),
    # bench 'value' keys are direction-tagged by flatten() from the
    # sibling 'unit' string: most configs report a speedup/throughput
    # (higher better), but e.g. BENCH_E2E's value is a latency p99
    ('*value_throughput', 'lower', 'pct', 10.0),
    ('*value_latency', 'higher', 'pct', 25.0),
    ('*overhead_pct*', 'higher', 'abs', 2.0),
    ('*occupancy_pct*', 'higher', 'abs', 20.0),
    ('*p99*', 'higher', 'pct', 25.0),
    ('*_ms*', 'higher', 'pct', 25.0),
    ('*ms_per_gulp*', 'higher', 'pct', 25.0),
    ('*wait*', 'higher', 'pct', 25.0),
    ('*violations*', 'higher', 'any', 0.0),
    ('*dropped*', 'higher', 'any', 0.0),
    # compiled pipeline segments (docs/perf.md): fewer elided rings or
    # less dispatch traffic through segments between same-config
    # rounds means fusion silently disengaged — a perf regression even
    # when wall-clock noise hides it
    ('*segment.elided_rings*', 'lower', 'any', 0.0),
    ('*segment.dispatches*', 'lower', 'any', 0.0),
    # FX correlator flagship (BENCH_FXCORR, config 19): the raced
    # X-engine's winner rate — a drop means the quantized candidate
    # stopped winning or the race landed somewhere slower
    ('*xengine.gops_per_s*', 'lower', 'pct', 10.0),
    # FDMT FRB-search flagship (BENCH_FDMT, config 22): the headline
    # candidates/s at fixed false-alarm rate, and the halo-carry
    # engagement counter — overlap_carried dropping between
    # same-config rounds means the in-program halo carry silently
    # disengaged and the chain fell back to per-gulp overlapped reads
    ('*fdmt.candidates_per_s*', 'lower', 'pct', 10.0),
    ('*segment.overlap_carried*', 'lower', 'any', 0.0),
    # elastic control plane (SCHED_CHAOS, config 20): the chaos drill
    # SIGKILLs a host mid-stream — fewer migrations or re-placement
    # events between same-config rounds means the death watch or the
    # re-placement path silently disengaged and the drill stopped
    # exercising what it gates
    # (no trailing glob: 'replacements_refused' DROPPING is fine)
    ('*scheduler.migrations', 'lower', 'any', 0.0),
    ('*scheduler.replacements', 'lower', 'any', 0.0),
    # wire-rate capture flagship (BENCH_CAPTURE, config 23): sustained
    # ingest rate of the sharded zero-copy engine — a pps/gbps drop
    # between same-config rounds usually means the zero-copy batched
    # path silently disengaged (every packet still arrives, each just
    # pays the staging copy again); loss_frac is gated absolutely
    ('*capture.pps*', 'lower', 'pct', 10.0),
    ('*capture.gbps*', 'lower', 'pct', 10.0),
    ('*capture.loss_frac*', 'higher', 'abs', 0.005),
    ('*crc_errors*', 'higher', 'any', 0.0),
    ('*reconnects*', 'higher', 'any', 0.0),
    ('*fallback*', 'higher', 'any', 0.0),
    # fleet observability plane (FLEET_OBS, config 21): decode or
    # tick errors on the collector, publish-side send errors, or
    # alert-sink write failures mean telemetry is silently dropping
    # on the floor between rounds; rollup files nest these per host
    # (hosts.<h>.counters.*) and flatten() already yields those paths
    ('*fleet.decode_errors*', 'higher', 'any', 0.0),
    ('*fleet.tick_errors*', 'higher', 'any', 0.0),
    ('*fleet.pub.errors*', 'higher', 'any', 0.0),
    ('*alerts.sink_errors*', 'higher', 'any', 0.0),
    ('*incident.errors*', 'higher', 'any', 0.0),
    # fewer live hosts for the same config means a publisher stopped
    # streaming (or the collector stopped adopting) — the fleet-plane
    # analogue of scheduler.replacements disengaging
    ('*fleet.hosts_live', 'lower', 'any', 0.0),
]

#: flattened paths never worth comparing (identities, timestamps,
#: environment echoes)
IGNORE = ['*round*', '*.buckets.*', '*origin_ns*',
          '*.min', '*.max', '*.sum', '*time_tag*', '*.pid',
          '*threshold*']


#: unit substrings marking a bench 'value' as a latency (higher worse)
_LATENCY_UNITS = ('ms', 'latency', 'age', 'seconds')


def flatten(obj, prefix=''):
    """{dot.path: float} over every numeric leaf (bools excluded).

    A dict's 'value' key is direction-AMBIGUOUS across bench configs
    (most report a speedup — higher better — but e.g. BENCH_E2E's is a
    latency p99), so when a sibling 'unit' string is present the key
    is rewritten to ``value_latency`` / ``value_throughput`` for the
    watchlist to match; a unit-less 'value' stays unmatched
    (informational only)."""
    out = {}
    if isinstance(obj, dict):
        for k, v in obj.items():
            if k == 'value' and isinstance(obj.get('unit'), str):
                unit = obj['unit'].lower()
                k = 'value_latency' if any(u in unit for u
                                           in _LATENCY_UNITS) \
                    else 'value_throughput'
            out.update(flatten(v, '%s.%s' % (prefix, k) if prefix
                               else str(k)))
    elif isinstance(obj, (int, float)) and not isinstance(obj, bool):
        out[prefix] = float(obj)
    return out


def watch_rule(path):
    for pat, direction, kind, thresh in WATCHLIST:
        if fnmatch.fnmatch(path, pat):
            return direction, kind, thresh
    return None


def compare(base, cur):
    """Findings over the keys present in BOTH files."""
    fb, fc = flatten(base), flatten(cur)
    findings = []
    for path in sorted(set(fb) & set(fc)):
        if any(fnmatch.fnmatch(path, pat) for pat in IGNORE):
            continue
        b, c = fb[path], fc[path]
        rule = watch_rule(path)
        delta = c - b
        # None, not inf: % change from a 0 base is undefined, and
        # Infinity is not valid JSON in the --out report
        pct = (delta / abs(b) * 100.0) if b else \
            (0.0 if not delta else None)
        if rule is None:
            # informational: large unmatched drifts are still worth a
            # line in the report, but never a regression verdict
            if b and abs(pct) > 50.0:
                findings.append({'path': path, 'base': b, 'cur': c,
                                 'pct': round(pct, 1),
                                 'severity': 'info'})
            continue
        direction, kind, thresh = rule
        worse = delta > 0 if direction == 'higher' else delta < 0
        if not worse:
            continue
        if kind == 'any':
            trip = abs(delta) > 0
        elif kind == 'abs':
            trip = abs(delta) > thresh
        else:
            # pct rule against a 0 base: the relative change is
            # unbounded, so any worsening trips
            trip = True if pct is None else abs(pct) > thresh
        findings.append({'path': path, 'base': b, 'cur': c,
                         'pct': None if pct is None else round(pct, 1),
                         'delta': round(delta, 6),
                         'direction': direction, 'kind': kind,
                         'threshold': thresh,
                         'severity': 'regression' if trip else 'drift'})
    return findings


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument('baseline', help='previous snapshot/artifact JSON')
    ap.add_argument('current', help='new snapshot/artifact JSON')
    ap.add_argument('--out', default=None,
                    help='write the full report as JSON here')
    ap.add_argument('--strict', action='store_true',
                    help='exit 3 when any watched metric regressed '
                         'beyond threshold (default: advisory, '
                         'always exit 0)')
    args = ap.parse_args(argv)
    try:
        with open(args.baseline) as f:
            base = json.load(f)
        with open(args.current) as f:
            cur = json.load(f)
    except (OSError, ValueError) as exc:
        print('telemetry_diff: cannot read inputs: %s' % exc,
              file=sys.stderr)
        return 2

    findings = compare(base, cur)
    regressions = [f for f in findings
                   if f['severity'] == 'regression']
    for f in findings:
        mark = {'regression': 'REGRESSED', 'drift': 'drift',
                'info': 'info'}[f['severity']]
        pct_s = ('%+.1f%%' % f['pct']) if f['pct'] is not None \
            else 'n/a'
        print('%-10s %-50s %g -> %g (%s)'
              % (mark, f['path'], f['base'], f['cur'], pct_s))
    verdict = 'REGRESSED' if regressions else 'OK'
    print('telemetry_diff: %s — %d finding(s), %d regression(s) '
          '(%s vs %s)' % (verdict, len(findings), len(regressions),
                          args.current, args.baseline))
    if args.out:
        with open(args.out, 'w') as f:
            json.dump({'baseline': args.baseline,
                       'current': args.current,
                       'findings': findings,
                       'regressions': len(regressions),
                       'pass': not regressions}, f, indent=1,
                      sort_keys=True)
            f.write('\n')
    if args.strict and regressions:
        return 3
    return 0


if __name__ == '__main__':
    sys.exit(main())
