"""Device selection and stream synchronization.

The reference binds a thread to a CUDA device and synchronizes the
thread's stream once per gulp (reference: src/cuda.cpp:34-99,
python/bifrost/device.py:33-95).  The port holds one explicit
``torch.device`` for the whole process: ``cuda:0`` unless the caller
asks for another with :func:`set_device` (the CPU tests call
``set_device('cpu')``).  When no card is present and the CPU was not
asked for, :func:`get_device` raises: the port never moves to the CPU
on its own.
"""

from __future__ import annotations

import threading

__all__ = ['set_device', 'get_device', 'on_cuda', 'stream_synchronize',
           'record_event']

_lock = threading.Lock()
_device = None


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
    """The process's ``torch.device``.  Raises RuntimeError when no CUDA
    device is present and ``set_device('cpu')`` was not called."""
    global _device
    dev = _device
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
