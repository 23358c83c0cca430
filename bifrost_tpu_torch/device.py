"""Device selection and stream synchronization.

The reference binds a thread to a CUDA device and synchronizes the
thread's stream once per gulp (reference: src/cuda.cpp:34-99,
python/bifrost/device.py:33-95).  The port holds one explicit
``torch.device`` for the whole process: ``cuda:0`` unless the caller
asks for another with :func:`set_device` (the CPU tests call
``set_device('cpu')``).  When no card is present and the CPU was not
asked for, :func:`get_device` raises: the port never moves to the CPU
on its own.

Under the process device, a thread may be bound to one device of the
same type with :func:`bind_device`: a block under
``block_scope(device=N)`` (or ``gpu=N``) binds its thread to ``cuda:N``
before it runs, and :func:`get_device` then gives that thread
``cuda:N`` (``bifrost_tpu/device.py:45-76``).  An index at or beyond
``torch.cuda.device_count()`` raises; a CPU run has only index 0.
"""

from __future__ import annotations

import os
import threading

__all__ = ['set_device', 'get_device', 'on_cuda', 'stream_synchronize',
           'record_event', 'bind_device', 'get_bound_device',
           'get_device_index', 'force_completion', 'execution_in_order',
           'ExternalStream', 'ensure_backend']

_lock = threading.Lock()
_device = None
_tls = threading.local()


def set_device(device):
    """Select the process's device: a ``torch.device``, a string such as
    ``'cuda:0'`` or ``'cpu'``, a CUDA index, or None to return to the
    default (``cuda:0``)."""
    global _device
    import torch
    if device is None:
        with _lock:
            _device = None
        return
    if isinstance(device, int):
        device = 'cuda:%d' % device
    dev = torch.device(device)
    if dev.type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError("set_device(%r): no CUDA device is "
                               "available" % (device,))
        if dev.index is None:
            dev = torch.device('cuda', 0)
        torch.cuda.set_device(dev)
    with _lock:
        _device = dev


def get_device():
    """This thread's ``torch.device``: the one it is bound to
    (:func:`bind_device`), else the process's.  Raises RuntimeError when
    no CUDA device is present and ``set_device('cpu')`` was not
    called."""
    global _device
    dev = getattr(_tls, 'device', None) or _device
    if dev is not None:
        return dev
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError(
            "bifrost_tpu_torch: no CUDA device is available; call "
            "bifrost_tpu_torch.device.set_device('cpu') to run on the CPU")
    with _lock:
        if _device is None:
            _device = torch.device('cuda', 0)
        return _device


def on_cuda():
    return get_device().type == 'cuda'


def bind_device(index):
    """Bind the calling thread to device ``index`` of the process
    device's type (None unbinds).  On the card this is ``cuda:index``,
    made the thread's current CUDA device; ``index`` must be below
    ``torch.cuda.device_count()``.  On a CPU run only index 0 exists."""
    if index is None:
        _tls.device = None
        return
    _tls.device = None
    base = get_device()
    index = int(index)
    if base.type == 'cuda':
        import torch
        count = torch.cuda.device_count()
        if not 0 <= index < count:
            raise ValueError("device index %d: this process sees %d CUDA "
                             "device(s)" % (index, count))
        dev = torch.device('cuda', index)
        torch.cuda.set_device(dev)
    elif index != 0:
        raise ValueError("device index %d: a %s run has only device 0"
                         % (index, base.type))
    else:
        dev = base
    _tls.device = dev


def get_bound_device():
    """The device this thread was bound to with :func:`bind_device`, or
    None when no scope asked for one."""
    return getattr(_tls, 'device', None)


def get_device_index():
    """The index of this thread's device (0 on the CPU)."""
    dev = get_device()
    return dev.index if dev.index is not None else 0


def ensure_backend():
    """Initialise CUDA from the calling thread (``Pipeline.run`` calls it
    from the launching thread before any block thread starts, as the JAX
    package creates its backend there); nothing on the CPU."""
    if get_device().type == 'cuda':
        import torch
        torch.cuda.init()


def execution_in_order():
    """Whether device work completes in the order it was queued, which
    lets the pipeline's drain wait on the newest gulp only.  True unless
    ``BF_ASSUME_IN_ORDER=0``, which makes a drain wait on every gulp it
    retires."""
    return os.environ.get('BF_ASSUME_IN_ORDER', '1') != '0'


def force_completion(*tensors):
    """Wait until the queued work behind ``tensors`` has completed: one
    CUDA event recorded on each of their devices' current streams, and
    waited on.  No data is read back.  Host arrays and CPU tensors are
    complete already."""
    import torch
    devices = {t.device for t in tensors
               if isinstance(t, torch.Tensor) and t.is_cuda}
    for dev in devices:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        ev.synchronize()


class ExternalStream(object):
    """Context manager kept for the reference's cupy / pycuda interop
    API (reference: device.py:56-84); it changes nothing."""

    def __init__(self, stream=None):
        self.stream = stream

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def record_event():
    """A CUDA event recorded on this thread's current stream, or None
    on the CPU (where every op has completed when it returns)."""
    if not on_cuda():
        return None
    import torch
    ev = torch.cuda.Event()
    ev.record()
    return ev


def stream_synchronize(*events):
    """Wait for device work.  With events, waits until each has
    completed (the per-gulp drain of the pipeline); without, waits for
    this thread's current stream (reference: cudaStreamSynchronize,
    pipeline.py:628).  A no-op on the CPU."""
    if not on_cuda():
        return
    if events:
        for ev in events:
            if ev is not None:
                ev.synchronize()
        return
    import torch
    torch.cuda.current_stream().synchronize()
