"""Inspect the port's measured-probe winner caches
(``bifrost_tpu_torch/ops/mprobe.py``).

Selection is measured, then frozen to disk — which means a stale
winner (older package, different device kind) or a coin-flip ranking
that squeaked past the noise threshold silently shapes every later
run.  This tool makes the cache inspectable:

    python -m bifrost_tpu_torch.tools.mprobe_report                 # all families
    python -m bifrost_tpu_torch.tools.mprobe_report --family beamform
    python -m bifrost_tpu_torch.tools.mprobe_report --json          # machine-readable
    python -m bifrost_tpu_torch.tools.mprobe_report --clear         # drop winner caches

Per cached key it prints the winner, every candidate's best-of-N ms,
and the margin (runner-up / winner — values near 1.0 are coin flips
the persist policy should have re-measured; see mprobe.select's
``noise`` threshold).  Keys are prefixed with the backend tag they
were measured under, so a cache carried across device kinds is
immediately visible.

``--clear`` removes the family files (all of them, or just
``--family``); the next run re-measures.  Exit codes follow
``telemetry_diff``: 0 = ok, 2 = cache dir unreadable.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys



def cache_dir():
    from ..ops import mprobe
    return os.path.dirname(mprobe.cache_path('x'))


def _is_winner_cache(data):
    """BF_CACHE_DIR also holds non-mprobe state (telemetry_usage.json
    and friends): a file counts as a winner cache only when every
    entry is a {'winner': ...} dict — anything else is foreign and
    must be neither rendered as probes nor deleted by --clear."""
    return isinstance(data, dict) and data and all(
        isinstance(v, dict) and 'winner' in v for v in data.values())


def load_families(family=None):
    """{family: {key: entry}} from the on-disk winner caches.  Entries
    are the raw persisted dicts ({'winner': ..., 'ms': {...}});
    unreadable files surface as {'_error': ...} so a corrupt cache is
    reported, not skipped; foreign (non-mprobe) JSON files are
    skipped."""
    out = {}
    for path in sorted(glob.glob(os.path.join(cache_dir(), '*.json'))):
        name = os.path.splitext(os.path.basename(path))[0]
        if family and name != family:
            continue
        try:
            with open(path) as f:
                data = json.load(f)
        except (OSError, ValueError) as e:
            out[name] = {'_error': '%s: %s' % (type(e).__name__, e)}
            continue
        if _is_winner_cache(data):
            out[name] = data
    return out


def in_process():
    """The CURRENT process's in-process cache (winner, ms, errors per
    key) — empty from the CLI (fresh interpreter), but callers
    embedding the report (tests, notebooks) see un-persisted entries:
    measurements whose candidates errored or ranked within noise."""
    from ..ops import mprobe
    out = {}
    for name, fam in mprobe._cache.items():
        out[name] = {key: {'winner': w, 'ms': ms, 'errors': errs}
                     for key, (w, ms, errs) in fam.items()}
    return out


def margin(ms):
    """Runner-up-over-winner time ratio; None for a single candidate.
    1.0 = dead heat (a coin-flip winner), larger = decisive."""
    ranked = sorted(float(v) for v in ms.values())
    if len(ranked) < 2 or ranked[0] <= 0:
        return None
    return round(ranked[1] / ranked[0], 3)


def report(family=None):
    """Merged disk + in-process view, ready to render or JSON-dump."""
    fams = load_families(family)
    for name, entries in in_process().items():
        if family and name != family:
            continue
        dst = fams.setdefault(name, {})
        for key, entry in entries.items():
            merged = dict(entry)
            if key in dst:
                merged['persisted'] = True
            else:
                merged['persisted'] = False
            dst[key] = merged
    return fams


def render(fams):
    lines = []
    if not fams:
        lines.append('mprobe_report: no winner caches under %s'
                     % cache_dir())
        return lines
    for name in sorted(fams):
        entries = fams[name]
        lines.append('%s (%d key%s)' % (name, len(entries),
                                        '' if len(entries) == 1
                                        else 's'))
        if '_error' in entries:
            lines.append('  UNREADABLE: %s' % entries['_error'])
            continue
        for key in sorted(entries):
            e = entries[key]
            ms = e.get('ms', {}) or {}
            m = margin(ms)
            flags = []
            if m is not None and m < 1.10:
                flags.append('COIN-FLIP')
            if e.get('persisted') is False:
                flags.append('in-process only')
            if e.get('errors'):
                flags.append('errors: %s'
                             % ', '.join(sorted(e['errors'])))
            lines.append('  %s' % key)
            lines.append('    winner=%s  margin=%s%s'
                         % (e.get('winner'),
                            'n/a' if m is None else '%.3fx' % m,
                            ('  [%s]' % '; '.join(flags))
                            if flags else ''))
            for cand in sorted(ms, key=lambda c: float(ms[c])):
                lines.append('      %-14s %8.3f ms' % (cand,
                                                       float(ms[cand])))
    return lines


def clear(family=None):
    removed = []
    for path in sorted(glob.glob(os.path.join(cache_dir(), '*.json'))):
        name = os.path.splitext(os.path.basename(path))[0]
        if family and name != family:
            continue
        try:
            with open(path) as f:
                if not _is_winner_cache(json.load(f)):
                    continue           # foreign state: never delete
        except (OSError, ValueError):
            continue
        try:
            os.remove(path)
            removed.append(path)
        except OSError:
            pass
    from ..ops import mprobe
    if family:
        mprobe._cache.pop(family, None)
    else:
        mprobe._cache.clear()
    return removed


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument('--family', default=None,
                    help='limit to one cache family (e.g. beamform, '
                         'linalg_xcorr, xengine, corner_turn, fdmt)')
    ap.add_argument('--json', action='store_true',
                    help='dump the merged report as JSON')
    ap.add_argument('--clear', action='store_true',
                    help='remove the winner cache file(s) so the next '
                         'run re-measures')
    args = ap.parse_args(argv)

    if args.clear:
        removed = clear(args.family)
        for path in removed:
            print('removed %s' % path)
        if not removed:
            print('mprobe_report: nothing to clear under %s'
                  % cache_dir())
        return 0

    if not os.path.isdir(cache_dir()):
        print('mprobe_report: no cache dir at %s' % cache_dir(),
              file=sys.stderr)
        return 2
    fams = report(args.family)
    if args.json:
        print(json.dumps(fams, indent=1, sort_keys=True))
    else:
        for line in render(fams):
            print(line)
    return 0


if __name__ == '__main__':
    sys.exit(main())
