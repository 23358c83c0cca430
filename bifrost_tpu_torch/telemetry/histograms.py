"""Fixed-bucket log2 latency/size histograms, cheap enough for per-gulp
hot paths (the JAX package's ``bifrost_tpu/telemetry/histograms.py``:
the same buckets, registry and snapshot).

The flat counters in :mod:`bifrost_tpu_torch.telemetry.counters` answer
"how many"; these answer "how long / how big".  Each histogram is 64
power-of-two buckets: bucket ``i`` holds values in
``[2**(i + EXP_MIN - 1), 2**(i + EXP_MIN))``, so one ``math.frexp`` finds
the bucket and a 64-int walk yields any percentile.

Histogram names used by the port:

- ``block.<block>.gulp_s``       per-gulp wall time through a block's
                                 main loop (acquire + reserve + process)
- ``block.<block>.ring_wait_s``  per-gulp time blocked on ring flow
                                 control (acquire + reserve)
- ``block.<block>.batch_gulps``  gulps per ``on_data`` dispatch
- ``xfer.h2d_s``                 host-side H2D time (staging copy and
                                 copy issue)
- ``xfer.d2h_wait_s``            host-side D2H completion time (residual
                                 wait and the host copy out of a slot)
- ``xfer.h2d_nbytes`` / ``xfer.d2h_nbytes``  transfer sizes

Percentiles are bucket upper bounds clamped to the observed min/max:
monotone in ``p`` and never off by more than one power of two.
"""

from __future__ import annotations

import math
import threading

__all__ = ['Histogram', 'observe', 'get', 'get_or_create', 'snapshot',
           'clear', 'clear_matching', 'reset', 'NBUCKET', 'EXP_MIN']

#: number of power-of-two buckets per histogram
NBUCKET = 64
#: exponent of the lowest bucket's upper bound: bucket 0 collects
#: everything below 2**EXP_MIN (~60 ns for seconds; tiny for bytes)
EXP_MIN = -24


def bucket_upper(i):
    """Upper bound of bucket ``i`` (exclusive)."""
    return 2.0 ** (EXP_MIN + i)


class Histogram(object):
    """One named log2 histogram (count / sum / min / max / buckets)."""

    __slots__ = ('name', 'unit', 'count', 'total', 'vmin', 'vmax',
                 'buckets', '_lock')

    def __init__(self, name, unit=''):
        self.name = name
        self.unit = unit
        self.count = 0
        self.total = 0.0
        self.vmin = float('inf')
        self.vmax = 0.0
        self.buckets = [0] * NBUCKET
        self._lock = threading.Lock()

    def record(self, value):
        """Add one observation (negative values clamp to 0)."""
        v = float(value)
        if v < 0.0 or v != v:          # negative / NaN: clamp
            v = 0.0
        if v > 0.0:
            i = math.frexp(v)[1] - EXP_MIN   # v in [2**(e-1), 2**e)
            if i < 0:
                i = 0
            elif i >= NBUCKET:
                i = NBUCKET - 1
        else:
            i = 0
        with self._lock:
            self.count += 1
            self.total += v
            if v < self.vmin:
                self.vmin = v
            if v > self.vmax:
                self.vmax = v
            self.buckets[i] += 1

    @staticmethod
    def _percentile_locked(buckets, count, vmin, vmax, p):
        if count <= 0:
            return 0.0
        target = p / 100.0 * count
        if target < 1.0:
            target = 1.0
        cum = 0
        for i, c in enumerate(buckets):
            cum += c
            if cum >= target:
                est = bucket_upper(i)
                # clamp to the observed range: tighter than the bucket
                # edge and still monotone in p (the clamps are
                # constants over a nondecreasing estimate)
                return min(max(est, vmin), vmax)
        return vmax

    def percentile(self, p):
        """Estimated p-th percentile (upper bucket bound, clamped to
        the observed min/max; monotone in ``p``)."""
        with self._lock:
            return self._percentile_locked(self.buckets, self.count,
                                           self.vmin, self.vmax, p)

    def snapshot(self):
        """Plain-dict snapshot: count/sum/min/max, p50/p90/p99, and the
        non-empty buckets keyed by their upper-bound exponent."""
        with self._lock:
            buckets = list(self.buckets)
            count = self.count
            total = self.total
            vmin = self.vmin if count else 0.0
            vmax = self.vmax
        pct = lambda p: self._percentile_locked(buckets, count,  # noqa: E731
                                                vmin, vmax, p)
        return {
            'count': count,
            'sum': total,
            'min': vmin,
            'max': vmax,
            'p50': pct(50),
            'p90': pct(90),
            'p99': pct(99),
            'buckets': {EXP_MIN + i: c for i, c in enumerate(buckets)
                        if c},
        }


# ---------------------------------------------------------------------------
# process-wide registry
# ---------------------------------------------------------------------------

_lock = threading.Lock()
_registry = {}


def get_or_create(name, unit=''):
    """The histogram named ``name`` (created on first use).  Hot paths
    should cache the returned object and call ``record`` directly."""
    h = _registry.get(name)
    if h is None:
        with _lock:
            h = _registry.get(name)
            if h is None:
                h = Histogram(name, unit=unit)
                _registry[name] = h
    return h


def observe(name, value):
    """Record ``value`` into the histogram named ``name``."""
    get_or_create(name).record(value)


def get(name):
    """The named histogram, or None if nothing was ever recorded."""
    return _registry.get(name)


def snapshot():
    """{name: histogram snapshot} for every registered histogram."""
    with _lock:
        items = list(_registry.items())
    return {name: h.snapshot() for name, h in items}


def clear(name):
    """Zero one histogram in place (hot-path caches holding the object
    keep recording into it); False when no such histogram exists.  The
    SLO age reset uses it so a skipped sequence's stale ages leave the
    p99."""
    h = _registry.get(name)
    if h is None:
        return False
    with h._lock:
        h.count = 0
        h.total = 0.0
        h.vmin = float('inf')
        h.vmax = 0.0
        h.buckets = [0] * NBUCKET
    return True


def clear_matching(prefix):
    """Zero every registered histogram whose name starts with
    ``prefix`` (in place); returns how many were cleared."""
    with _lock:
        names = [n for n in _registry if n.startswith(prefix)]
    return sum(1 for n in names if clear(n))


def reset():
    """Drop every histogram (tests/benchmarks)."""
    with _lock:
        _registry.clear()

