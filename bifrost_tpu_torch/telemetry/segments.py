"""Telemetry of compiled pipeline segments (the port of
``bifrost_tpu/telemetry/segments.py``).

A :class:`~bifrost_tpu_torch.segments.SegmentBlock` replaces a chain of
blocks and elides the rings between them, and with them every per-block
seam of the members: no ``on_data`` to span, no commit to age, no
dispatch to count.  The segment times its one call and this module
rebuilds the members' view from it:

- ``block.<member>.gulps`` keeps counting logical gulps, while
  ``block.*.dispatches`` counts real dispatches, the segment's, not the
  members' (fused members dispatch nothing);
- per-member compute spans (``<member>.on_data``): the segment's window
  cut evenly between the members and tagged ``synthesized: 1`` and
  ``segment: <name>``, since one call has one host window;
- per-member SLO commit ages (``slo.<member>.commit_age_s``): each member
  observes the segment's capture -> commit age, exact for the tail and
  at most one dispatch late for the others;
- member perf-proclog rows (:func:`publish_member_perf`), so monitors
  that find blocks by their proclogs still see the members.

``segment.dispatches`` / ``segment.gulps`` count the traffic through
segments; ``segment.compiled``, ``segment.elided_rings`` and
``segment.overlap_carried`` are counted when the compiler runs.
"""

from __future__ import annotations

from . import counters, slo, spans

__all__ = ['note_dispatch', 'publish_member_perf']


def note_dispatch(segment, members, ndispatches, ngulps, t0_us, dur_us,
                  seq, gulp, trace=None, header=None, frame_end=None):
    """Record one segment dispatch of ``ngulps`` logical gulps
    (``ndispatches`` calls when the segment is split) and synthesize the
    members' telemetry from it.  Called once a dispatch: a few counter
    increments, and span and SLO work only where those are on."""
    counters.inc('segment.dispatches', ndispatches)
    counters.inc('segment.gulps', ngulps)
    for m in members:
        counters.inc('block.%s.gulps' % m, ngulps)
    if members and spans.enabled():
        slot = dur_us / len(members)
        for i, m in enumerate(members):
            args = {'seq': seq, 'gulp': gulp, 'segment': segment,
                    'synthesized': 1}
            if trace:
                args['trace'] = trace
            spans.record('%s.on_data' % m, 'compute', t0_us + i * slot,
                         slot, args)
    if header is not None:
        try:
            age = slo.capture_age_s(header, frame_end)
        except Exception:
            age = None
        if age is not None:
            for m in members:
                slo.observe_commit(m, age, ngulps)


def publish_member_perf(proclog, segment, process_s, gulps_per_dispatch):
    """One perf-proclog row for a segment member: its share of the
    segment's host time, the segment's gulps a dispatch and the
    ``in_segment`` marker (rate-limited by the proclog; never raises)."""
    try:
        proclog.update({'acquire_time': 0.0,
                        'reserve_time': 0.0,
                        'process_time': process_s,
                        'gulps_per_dispatch':
                            round(float(gulps_per_dispatch), 3),
                        'in_segment': segment})
    except Exception:
        pass
