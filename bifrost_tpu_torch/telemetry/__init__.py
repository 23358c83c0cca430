"""Telemetry of the port: always-on counters, log2 histograms, gulp
spans, capture-to-commit SLO ages and the metrics exporter (the JAX
package's ``bifrost_tpu/telemetry``).

:func:`snapshot` is :func:`exporter.snapshot`: counters, histograms,
ring occupancy, card memory and the mesh counters in one plain dict,
with per-second rates on request.  The JAX package's ``profiling`` and
``fleet`` modules and its local usage tracker are not ported yet.
"""

from __future__ import annotations

from . import counters  # noqa: F401  (always-on perf counters)
from . import histograms  # noqa: F401  (log2 latency/size histograms)
from . import spans  # noqa: F401  (gulp-span tracing / flight recorder)
from . import slo  # noqa: F401  (capture-to-commit SLO ages)
from . import exporter  # noqa: F401  (snapshot, Prometheus, publisher)

__all__ = ['snapshot', 'flush', 'counters', 'histograms', 'spans', 'slo',
           'exporter']


def snapshot(pipeline=None, rates=False):
    """The unified metrics snapshot (:func:`exporter.snapshot`):
    ``pipeline`` narrows the ring section to its rings; ``rates=True``
    (or an :class:`exporter.RateTracker`) adds per-second rates since the
    tracker's previous snapshot."""
    return exporter.snapshot(pipeline, rates=rates)


def flush():
    """The counters' snapshot (``block_failures``, ``block_restarts``,
    ``ring_poisoned``, ``watchdog_stalls`` among them).  The JAX package
    also merges them into its local usage file, which the port has not
    ported."""
    return counters.snapshot()
