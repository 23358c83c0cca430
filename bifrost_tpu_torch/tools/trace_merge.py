"""Merge per-host Chrome traces into ONE cross-host timeline.

Each bifrost_tpu_torch process exports its spans on its OWN clock
(``time.perf_counter`` since process start — see telemetry/spans.py),
so two hosts' trace files cannot be overlaid directly.  The bridge
handshake solves this: every HELLO/HELLO_ACK exchange doubles as a
clock PING (io/bridge.py), and the sender embeds the estimated
peer-clock offset (accurate to ~RTT/2) into its trace export under
``otherData.bf_clock.sessions``.  This tool walks those session links
to put every input trace onto the FIRST input's clock and writes one
merged Chrome trace JSON:

    python -m bifrost_tpu_torch.tools.trace_merge -o merged.json host_a.json host_b.json

- Files are joined by bridge SESSION id: a file whose sessions entry
  carries an ``offset_us`` (the tx side) anchors its rx peer (the file
  registering the same session without an offset).  Chains work too
  (A->B->C shifts C by both hops' offsets).
- Unlinked files merge with zero shift and a warning (their relative
  position is then meaningless — but their spans are preserved).
- pids are renumbered per input file, with ``process_name`` metadata
  ``host=... pid=... (file)`` so Perfetto shows which host each track
  came from.

A gulp is then followable ACROSS hosts: compute spans carry
``args.trace`` (the stream-unique trace id from the header trace
context) plus ``(seq, gulp)``, and the bridge's ``bridge.tx.* /
bridge.rx.*`` spans carry the same triple, so selecting a trace id in
the merged view shows capture, transport, and remote commit on one
timeline.

Fleet incident bundles (telemetry.fleet's black-box recorder) are
accepted DIRECTLY: pass the bundle directory instead of trace files
and every ``hosts/<host>/flight.json`` timeline is merged, each host
shifted by its clock origin from the bundle's ``meta.json``
(``span_origin_wall_ns`` — the wall-clock instant of that host's
span-clock zero, stamped by the collector from the publisher's paired
wall/mono clocks):

    python -m bifrost_tpu_torch.tools.trace_merge -o merged.json \\
        incidents/incident_001_alert-host-absent
"""

import argparse
import json
import os
import sys


def load(path):
    with open(path) as f:
        data = json.load(f)
    if not isinstance(data, dict) or 'traceEvents' not in data:
        raise ValueError('%s is not a Chrome trace JSON' % path)
    return data


def is_bundle(path):
    """True when ``path`` is a fleet incident-bundle directory."""
    return (os.path.isdir(path)
            and os.path.isfile(os.path.join(path, 'meta.json')))


def expand_bundle(path):
    """(flight_paths, {path: origin_wall_ns}) for an incident bundle.

    The collector stamps each host's ``span_origin_wall_ns`` — the
    wall-clock time of that host's span-clock zero, derived from the
    publisher's paired wall/monotonic clocks — into the bundle's
    ``meta.json``.  That gives every flight.json an absolute anchor,
    so hosts align WITHOUT sharing a bridge session."""
    with open(os.path.join(path, 'meta.json')) as f:
        meta = json.load(f)
    host_meta = meta.get('hosts') or {}
    paths, origins = [], {}
    hosts_dir = os.path.join(path, 'hosts')
    names = sorted(os.listdir(hosts_dir)) if os.path.isdir(hosts_dir) \
        else []
    for host in names:
        flight = os.path.join(hosts_dir, host, 'flight.json')
        if not os.path.isfile(flight):
            continue
        paths.append(flight)
        origin = (host_meta.get(host) or {}).get('span_origin_wall_ns')
        if origin is not None:
            origins[flight] = float(origin)
    if not paths:
        raise ValueError('%s: incident bundle has no hosts/*/'
                         'flight.json timelines' % path)
    return paths, origins


def expand_inputs(inputs):
    """Expand bundle directories among ``inputs`` into their per-host
    flight traces; plain trace files pass through unchanged."""
    paths, origins = [], {}
    for item in inputs:
        if is_bundle(item):
            bpaths, borigins = expand_bundle(item)
            paths.extend(bpaths)
            origins.update(borigins)
        else:
            paths.append(item)
    return paths, origins


def trace_origin_ns(data):
    """A standalone trace's own wall-clock span origin, if stamped
    (flight.json exports carry it under otherData)."""
    origin = (data.get('otherData')
              or {}).get('bf_span_origin_wall_ns')
    return float(origin) if origin is not None else None


def clock_sessions(data):
    """{session: entry} from a trace file's bf_clock metadata."""
    other = data.get('otherData') or {}
    clock = other.get('bf_clock') or {}
    sessions = clock.get('sessions') or {}
    return {str(k): dict(v) for k, v in sessions.items()
            if isinstance(v, dict)}


def resolve_shifts(traces):
    """Per-file shift (us to ADD to its timestamps) onto file 0's
    clock, via BFS over shared bridge sessions.

    The tx side measured ``offset_us = rx_clock - tx_clock``; a
    timestamp from the rx file converts to the tx clock as
    ``t - offset_us``."""
    links = []                       # (tx_idx, rx_idx, offset_us)
    by_session = {}
    for idx, data in enumerate(traces):
        for session, entry in clock_sessions(data).items():
            by_session.setdefault(session, []).append((idx, entry))
    for session, members in by_session.items():
        txs = [(i, e) for i, e in members
               if e.get('offset_us') is not None]
        rxs = [(i, e) for i, e in members
               if e.get('offset_us') is None]
        for ti, te in txs:
            for ri, _re in rxs:
                if ti != ri:
                    links.append((ti, ri, float(te['offset_us'])))
    shifts = {0: 0.0}
    frontier = [0]
    while frontier:
        cur = frontier.pop()
        for ti, ri, off in links:
            if ti == cur and ri not in shifts:
                # rx file's clock -> tx file's clock: t - off, then
                # onto file 0's clock with the tx file's own shift
                shifts[ri] = shifts[ti] - off
                frontier.append(ri)
            elif ri == cur and ti not in shifts:
                shifts[ti] = shifts[ri] + off
                frontier.append(ti)
    return shifts


def merge(paths, origins=None):
    traces = [load(p) for p in paths]
    shifts = resolve_shifts(traces)
    # wall-clock anchoring (incident bundles): a file the session BFS
    # could not reach still aligns when both it and the reference
    # carry a span_origin_wall_ns stamp — a wall instant W sits at
    # (W - origin)/1e3 us on each file's clock, so
    # ts_ref = ts_file + (origin_file - origin_ref) / 1e3.
    origins = dict(origins or {})
    for idx, (path, data) in enumerate(zip(paths, traces)):
        if path not in origins:
            stamped = trace_origin_ns(data)
            if stamped is not None:
                origins[path] = stamped
    ref_origin = origins.get(paths[0]) if paths else None
    wall_shifted = set()
    events = []
    clocks = {}
    for idx, (path, data) in enumerate(zip(paths, traces)):
        shift = shifts.get(idx)
        if shift is None and ref_origin is not None \
                and path in origins:
            shift = (origins[path] - ref_origin) / 1e3
            wall_shifted.add(path)
        if shift is None:
            print('trace_merge: WARNING: %s shares no bridge session '
                  'with the reference trace and carries no wall-clock '
                  'origin — merged with zero shift (relative timing '
                  'meaningless)' % path, file=sys.stderr)
            shift = 0.0
        other = (data.get('otherData') or {}).get('bf_clock') or {}
        host = other.get('host',
                         (data.get('otherData') or {}).get('bf_host',
                                                           '?'))
        pid = idx + 1                # renumber: same-pid files collide
        clocks[path] = {'shift_us': round(shift, 3), 'host': host,
                        'orig_pid': other.get('pid')}
        if path in wall_shifted:
            clocks[path]['aligned_by'] = 'wall_origin'
        if path in origins:
            clocks[path]['span_origin_wall_ns'] = origins[path]
        # wall-clock skew to each bridge peer (the fabric end-to-end
        # SLO's correction term — docs/fabric.md): surfaced so an
        # operator can see host clock drift directly from the traces
        walls = {s: e['wall_offset_ns']
                 for s, e in clock_sessions(data).items()
                 if e.get('wall_offset_ns') is not None}
        if walls:
            clocks[path]['wall_offsets_ns'] = walls
        events.append({'ph': 'M', 'name': 'process_name', 'pid': pid,
                       'tid': 0,
                       'args': {'name': 'host=%s pid=%s (%s)'
                                % (host, other.get('pid', '?'),
                                   path)}})
        for ev in data['traceEvents']:
            ev = dict(ev)
            ev['pid'] = pid
            if 'ts' in ev and ev.get('ph') != 'M':
                ev['ts'] = round(ev['ts'] + shift, 3)
            events.append(ev)
    return {'traceEvents': events, 'displayTimeUnit': 'ms',
            'otherData': {'bf_merged_from': clocks}}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument('inputs', nargs='+',
                    help='per-host Chrome trace JSONs (BF_TRACE_FILE '
                         'exports) and/or fleet incident-bundle '
                         'directories; the first is the clock '
                         'reference')
    ap.add_argument('-o', '--out', required=True,
                    help='merged Chrome trace output path')
    args = ap.parse_args(argv)
    paths, origins = expand_inputs(args.inputs)
    merged = merge(paths, origins)
    with open(args.out, 'w') as f:
        json.dump(merged, f)
    n = sum(1 for e in merged['traceEvents'] if e.get('ph') != 'M')
    print('trace_merge: %d event(s) from %d file(s) -> %s'
          % (n, len(paths), args.out))
    for path, info in merged['otherData']['bf_merged_from'].items():
        if info.get('aligned_by') == 'wall_origin':
            print('trace_merge: %s: clock offset from bundle '
                  'metadata: %+0.3f ms'
                  % (info.get('host', path),
                     info['shift_us'] / 1e3))
        for session, off in (info.get('wall_offsets_ns')
                             or {}).items():
            print('trace_merge: %s: wall-clock offset to bridge peer '
                  '(session %s): %+0.3f ms'
                  % (info.get('host', path), session[:8], off / 1e6))
    return 0


if __name__ == '__main__':
    sys.exit(main())
