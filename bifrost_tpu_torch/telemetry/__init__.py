"""Telemetry of the port: always-on counters, log2 histograms and gulp
spans (the JAX package's ``bifrost_tpu/telemetry``).

:func:`snapshot` merges the counters, the histograms and, for a given
pipeline, its rings' occupancy into one plain dict.  The JAX package's
``slo``, ``profiling``, ``fleet`` and ``exporter`` modules and its local
usage tracker are not ported yet.
"""

from __future__ import annotations

from . import counters  # noqa: F401  (always-on perf counters)
from . import histograms  # noqa: F401  (log2 latency/size histograms)
from . import spans  # noqa: F401  (gulp-span tracing / flight recorder)

__all__ = ['snapshot', 'counters', 'histograms', 'spans']


def snapshot(pipeline=None):
    """``{'counters': {name: int}, 'histograms': {name: {count, sum, min,
    max, p50, p90, p99, buckets}}, 'rings': {name: {tail, head, size,
    fill}}}``.  The counters include the live ``trace.dropped_spans``
    total; ``rings`` lists the output rings of ``pipeline``'s blocks and
    is empty without one."""
    counts = counters.snapshot()
    dropped = spans.dropped_spans()
    if dropped:
        counts['trace.dropped_spans'] = \
            counts.get('trace.dropped_spans', 0) + dropped
    rings = {}
    if pipeline is not None:
        for block in pipeline.blocks:
            for ring in block.orings:
                rings[ring.name] = ring.occupancy()
    return {'counters': counts, 'histograms': histograms.snapshot(),
            'rings': rings}
