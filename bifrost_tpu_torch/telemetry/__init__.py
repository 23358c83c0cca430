"""Telemetry of the port: always-on counters, log2 histograms, gulp
spans, capture-to-commit SLO ages, the metrics exporter, the one-shot
``torch.profiler`` capture and the local usage tracker (the JAX package's
``bifrost_tpu/telemetry``).

:func:`snapshot` is :func:`exporter.snapshot`: counters, histograms,
ring occupancy, card memory and the mesh counters in one plain dict,
with per-second rates on request.

The usage tracker (reference: python/bifrost/telemetry/__init__.py:86-360)
keeps per-name call counts and timings and merges them into a JSON file
under the state directory (``BF_CACHE_DIR``, else
``~/.bifrost_tpu_torch``).  It is local and opt-in, as the JAX package's:
off until :func:`enable` (or ``python -m bifrost_tpu_torch.telemetry
--enable``) persists the opt-in, and nothing is ever sent anywhere.

:mod:`.fleet` is the fleet plane: a publisher that streams this
process's telemetry to a collector (``BF_FLEET_COLLECTOR``), the
collector's per-host rollup, alert rules and incident bundles.
"""

from __future__ import annotations

import atexit
import inspect
import json
import os
import time
from functools import wraps
from threading import RLock

from . import counters  # noqa: F401  (always-on perf counters)
from . import histograms  # noqa: F401  (log2 latency/size histograms)
from . import spans  # noqa: F401  (gulp-span tracing / flight recorder)
from . import slo  # noqa: F401  (capture-to-commit SLO ages)
from . import exporter  # noqa: F401  (snapshot, Prometheus, publisher)
from . import profiling  # noqa: F401  (one-shot BF_TORCH_PROFILE capture)
from . import fleet  # noqa: F401  (fleet publisher, collector, alerts)

__all__ = ['is_active', 'enable', 'disable', 'flush', 'snapshot',
           'track_script', 'track_module', 'track_function',
           'track_function_timed', 'track_method',
           'track_method_timed', 'usage_path', 'counters',
           'histograms', 'spans', 'slo', 'exporter', 'profiling',
           'fleet']

MAX_ENTRIES = 100     # flush the in-memory cache after this many names


def _state_dir():
    base = os.environ.get('BF_CACHE_DIR')
    if base is None:
        base = os.path.join(os.path.expanduser('~'), '.bifrost_tpu_torch')
    return base


def _state_path():
    return os.path.join(_state_dir(), 'telemetry_state')


def usage_path():
    """Path of the local usage-aggregate JSON file."""
    return os.path.join(_state_dir(), 'telemetry_usage.json')


class _LocalClient(object):
    """Per-name (count, timed_count, total_seconds) aggregator with a
    bounded in-memory cache, flushed by merge into the local JSON file
    (the reference's _TelemetryClient with the network removed)."""
    _lock = RLock()

    def __init__(self):
        self._cache = {}
        self._session_start = time.time()
        self._flush_blocked = False
        self.active = self._load_state()
        atexit.register(self.flush)

    @staticmethod
    def _load_state():
        try:
            with open(_state_path()) as f:
                return f.read().strip() == 'enabled'
        except OSError:
            return False                      # opt-in: default off

    @staticmethod
    def _save_state(text):
        try:
            os.makedirs(_state_dir(), exist_ok=True)
            with open(_state_path(), 'w') as f:
                f.write(text)
        except OSError:
            pass

    def track(self, name, timing=0.0):
        if not self.active:
            return False
        with self._lock:
            entry = self._cache.setdefault(name, [0, 0, 0.0])
            entry[0] += 1
            if timing > 0:
                entry[1] += 1
                entry[2] += timing
            # a failed flush (read-only cache dir) must not turn every
            # later tracked call into repeated failing syscalls: back
            # off until an explicit flush()/disable() retries
            if len(self._cache) >= MAX_ENTRIES \
                    and not self._flush_blocked:
                if not self.flush():
                    self._flush_blocked = True
        return True

    def flush(self):
        """Merge the cache into the LOCAL usage file (atomic replace,
        serialized across processes by an fcntl lock so concurrent
        exits cannot drop each other's counts).  This is the whole of
        the reference's 'send' step — no bytes leave the machine.
        Returns True when the cache was persisted."""
        with self._lock:
            if not self._cache:
                return True
            path = usage_path()
            lockf = None
            try:
                os.makedirs(_state_dir(), exist_ok=True)
                try:
                    import fcntl
                    lockf = open(path + '.lock', 'w')
                    fcntl.flock(lockf, fcntl.LOCK_EX)
                except (ImportError, OSError):
                    lockf = None
                data = {}
                try:
                    with open(path) as f:
                        loaded = json.load(f)
                    # validate entry shape: a malformed/corrupted usage
                    # file (truncated write, foreign JSON) must cost at
                    # most the bad entries — never a TypeError out of
                    # track() or the atexit handler.  Good entries are
                    # [count, timed_count, seconds] with numeric slots.
                    if isinstance(loaded, dict):
                        for name, entry in loaded.items():
                            if (isinstance(name, str)
                                    and isinstance(entry, (list, tuple))
                                    and len(entry) >= 3
                                    and all(isinstance(v, (int, float))
                                            and not isinstance(v, bool)
                                            for v in entry[:3])):
                                data[name] = [int(entry[0]),
                                              int(entry[1]),
                                              float(entry[2])]
                except (OSError, ValueError):
                    pass
                for name, (n, nt, total) in self._cache.items():
                    old = data.get(name, [0, 0, 0.0])
                    data[name] = [old[0] + n, old[1] + nt,
                                  round(old[2] + total, 6)]
                tmp = path + '.tmp%d' % os.getpid()
                with open(tmp, 'w') as f:
                    json.dump(data, f, indent=1, sort_keys=True)
                os.replace(tmp, path)
                self._cache.clear()
                self._flush_blocked = False
                return True
            except OSError:
                return False
            finally:
                if lockf is not None:
                    lockf.close()

    def enable(self):
        self.active = True
        self._save_state('enabled')

    def disable(self):
        self.flush()
        self.active = False
        self._save_state('disabled')


_client = _LocalClient()


def is_active():
    """Whether local usage aggregation is on (never implies any
    transmission — there is none)."""
    return _client.active


def enable():
    """Opt in to LOCAL usage aggregation (persists)."""
    _client.enable()
    return True


def disable():
    """Opt out (persists); flushes any pending aggregates first."""
    _client.disable()
    return True


def track_script():
    """Record the use of a tool/script (reference: track_script)."""
    caller = inspect.currentframe().f_back
    name = os.path.basename(caller.f_globals.get('__file__', '<repl>'))
    _client.track('bifrost_tpu_torch.tools.' + name)


def track_module():
    """Record the import of a module (reference: track_module)."""
    caller = inspect.currentframe().f_back
    _client.track(caller.f_globals.get('__name__', '<unknown>'))


def _qualname(fn):
    frame = inspect.currentframe().f_back.f_back
    mod = frame.f_globals.get('__name__', '<unknown>')
    return '%s.%s()' % (mod, fn.__name__)


def track_function(fn=None):
    """Decorator: count calls of ``fn`` (no timing)."""
    if fn is None:                  # bare @track_function() usage
        return track_function
    name = _qualname(fn)

    @wraps(fn)
    def wrapper(*args, **kwargs):
        result = fn(*args, **kwargs)
        _client.track(name)
        return result
    return wrapper


def track_function_timed(fn):
    """Decorator: count calls of ``fn`` with execution time."""
    name = _qualname(fn)

    @wraps(fn)
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        result = fn(*args, **kwargs)
        _client.track(name, time.perf_counter() - t0)
        return result
    return wrapper


def track_method(method):
    """Decorator: count calls of a method, keyed by concrete class."""
    frame = inspect.currentframe().f_back
    mod = frame.f_globals.get('__name__', '<unknown>')
    name = mod + '.%s.' + method.__name__ + '()'

    @wraps(method)
    def wrapper(*args, **kwargs):
        result = method(*args, **kwargs)
        _client.track(name % type(args[0]).__name__)
        return result
    return wrapper


def track_method_timed(method):
    """Decorator: count calls of a method with execution time."""
    frame = inspect.currentframe().f_back
    mod = frame.f_globals.get('__name__', '<unknown>')
    name = mod + '.%s.' + method.__name__ + '()'

    @wraps(method)
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        result = method(*args, **kwargs)
        _client.track(name % type(args[0]).__name__,
                      time.perf_counter() - t0)
        return result
    return wrapper


def snapshot(pipeline=None, rates=False):
    """The unified metrics snapshot (:func:`exporter.snapshot`):
    ``pipeline`` narrows the ring section to its rings; ``rates=True``
    (or an :class:`exporter.RateTracker`) adds per-second rates since the
    tracker's previous snapshot."""
    return exporter.snapshot(pipeline, rates=rates)


#: robustness counters mirrored into the usage aggregates by flush()
#: (supervision layer — see telemetry/counters.py docstring)
_SURFACED_COUNTERS = ('block_failures', 'block_restarts',
                      'ring_poisoned', 'watchdog_stalls')
_surfaced_totals = {}


def flush():
    """Flush pending usage aggregates and surface the always-on perf
    counters.

    Returns the full :func:`counters.snapshot` dict (so callers —
    operators, benchmarks, the supervision tests — can read the
    robustness counters without touching internals).  When local usage
    aggregation is enabled, the deltas of the robustness counters since
    the previous flush are merged into the usage file under
    ``bifrost_tpu_torch.counters.<name>`` entries, making chronic
    failure / restart / stall churn visible in
    ``python -m bifrost_tpu_torch.telemetry --status`` history.
    """
    snap = counters.snapshot()
    if _client.active:
        with _client._lock:
            for name in _SURFACED_COUNTERS:
                total = snap.get(name, 0)
                delta = total - _surfaced_totals.get(name, 0)
                if delta > 0:
                    entry = _client._cache.setdefault(
                        'bifrost_tpu_torch.counters.' + name, [0, 0, 0.0])
                    entry[0] += delta
                    _surfaced_totals[name] = total
                elif delta < 0:
                    # counters.reset() ran: re-anchor the watermark so
                    # post-reset increments are not silently dropped
                    _surfaced_totals[name] = total
    _client.flush()
    return snap
