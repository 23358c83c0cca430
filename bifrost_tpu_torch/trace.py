"""Tracing hooks (the JAX package's ``bifrost_tpu/trace.py``).

The reference wraps NVTX ranges around block operations so nsight shows
per-op spans (reference: src/trace.hpp:48-179, --enable-trace).  The port
does the same with ``torch.cuda.nvtx`` ranges when it runs on the card,
plus wall-clock scopes everywhere; enable by setting ``BF_TRACE=1``.  On
the CPU the scopes only time.
"""

from __future__ import annotations

import os
import tempfile
import time
from contextlib import contextmanager

__all__ = ['tracing_enabled', 'reset', 'ScopedTracer', 'trace_scope',
           'start_profile', 'stop_profile']

_enabled = None
_profiler = None


def tracing_enabled():
    global _enabled
    if _enabled is None:
        _enabled = bool(int(os.environ.get('BF_TRACE', '0') or 0))
    return _enabled


def reset():
    """Forget the cached ``BF_TRACE`` state so the next
    :func:`tracing_enabled` re-reads the environment, and re-read the
    gulp-span configuration (``BF_TRACE_FILE`` / ``BF_SPAN_BUFFER``,
    :mod:`bifrost_tpu_torch.telemetry.spans`)."""
    global _enabled
    _enabled = None
    from .telemetry import spans
    spans.reconfigure()


def _nvtx():
    """``torch.cuda.nvtx`` when the port runs on the card, else None."""
    from .device import on_cuda
    if not on_cuda():
        return None
    import torch
    return torch.cuda.nvtx


class ScopedTracer(object):
    """With-block trace range (reference: ScopedTracer,
    src/trace.hpp:126-179): an NVTX range on the card under
    ``BF_TRACE=1``, and the elapsed host time in ``elapsed``."""

    def __init__(self, name):
        self.name = name
        self._nvtx = None
        self.t0 = None
        self.elapsed = None

    def __enter__(self):
        self.t0 = time.perf_counter()
        if tracing_enabled():
            self._nvtx = _nvtx()
            if self._nvtx is not None:
                self._nvtx.range_push(self.name)
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.t0
        if self._nvtx is not None:
            self._nvtx.range_pop()
        return False


@contextmanager
def trace_scope(name):
    with ScopedTracer(name) as t:
        yield t


def start_profile(logdir=None):
    """Start a ``torch.profiler`` capture of the host and, on the card,
    the device; :func:`stop_profile` writes it as a Chrome trace under
    ``logdir`` (default: ``bifrost_tpu_torch_profile`` in the temporary
    directory).  Returns ``logdir``."""
    global _profiler
    import torch.profiler as tp
    if logdir is None:
        logdir = os.path.join(tempfile.gettempdir(),
                              'bifrost_tpu_torch_profile')
    acts = [tp.ProfilerActivity.CPU]
    if _nvtx() is not None:
        acts.append(tp.ProfilerActivity.CUDA)
    prof = tp.profile(activities=acts)
    prof.start()
    _profiler = (prof, logdir)
    return logdir


def stop_profile():
    """Stop the capture :func:`start_profile` started and write
    ``trace.json`` into its directory; returns the file's path."""
    global _profiler
    prof, logdir = _profiler
    _profiler = None
    prof.stop()
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, 'trace.json')
    prof.export_chrome_trace(path)
    return path
