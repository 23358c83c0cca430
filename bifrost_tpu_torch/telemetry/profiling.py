"""One-shot ``torch.profiler`` capture of one device dispatch (the port of
``bifrost_tpu/telemetry/profiling.py``, which brackets one dispatch with
``jax.profiler``).

``BF_TORCH_PROFILE=<dir>`` makes the first eligible dispatch of the
process -- a FusedBlock, segment or stage-block gulp; under macro-gulp
execution one whole K-gulp call -- run inside a ``torch.profiler``
capture (CPU activity, and CUDA activity on the card).  The stream is
synchronized before the capture closes, so the device timeline is
complete, and the capture is written to ``<dir>`` as a Chrome trace
(``torchprof-<pid>.json``).  One capture a process: a profiler capture
is far too heavy for every gulp.  :func:`reset` arms it again.

The capture is best effort: a profiler that fails to start or stop never
takes the pipeline down (the gulp still runs, the error goes to stderr).
``torchprof.captures`` counts the traces written, and
:func:`last_trace` names the newest.
"""

from __future__ import annotations

import os
import sys
import threading

__all__ = ['profile_dir', 'profiled_dispatch', 'reset', 'last_trace']

_lock = threading.Lock()
_done = False
_last = None


def profile_dir():
    """The ``BF_TORCH_PROFILE`` capture directory, or None."""
    return os.environ.get('BF_TORCH_PROFILE') or None


def reset():
    """Arm the one-shot capture again."""
    global _done
    with _lock:
        _done = False


def last_trace():
    """The path of the newest trace this process wrote, or None."""
    return _last


def profiled_dispatch(fn):
    """``fn()`` (a dispatch thunk), inside the profiler when this
    process's one capture is armed and unspent; its result either way."""
    global _done, _last
    path = profile_dir()
    if path is None or _done:
        return fn()
    with _lock:
        if _done:
            return fn()
        _done = True
    from ..device import on_cuda
    try:
        import torch
        from torch.profiler import profile, ProfilerActivity
        acts = [ProfilerActivity.CPU]
        if on_cuda():
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
    except Exception as exc:
        sys.stderr.write('bifrost_tpu_torch: BF_TORCH_PROFILE capture '
                         'failed to start: %s\n' % exc)
        return fn()
    stopped = False
    try:
        out = fn()
        if on_cuda():
            torch.cuda.synchronize()
        prof.stop()
        stopped = True
        os.makedirs(path, exist_ok=True)
        trace = os.path.join(path, 'torchprof-%d.json' % os.getpid())
        prof.export_chrome_trace(trace)
        _last = trace
        from . import counters
        counters.inc('torchprof.captures')
        sys.stderr.write('bifrost_tpu_torch: one-dispatch torch.profiler '
                         'trace written to %s\n' % trace)
        return out
    except Exception as exc:
        if not stopped:
            raise
        sys.stderr.write('bifrost_tpu_torch: BF_TORCH_PROFILE trace '
                         'export failed: %s\n' % exc)
        return out
    finally:
        if not stopped:
            try:
                prof.stop()
            except Exception:
                pass
