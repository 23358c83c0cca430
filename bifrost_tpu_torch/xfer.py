"""Host <-> device transfers through pinned staging buffers.

The reference moves gulps with ``cudaMemcpyAsync`` out of and into
page-locked memory (reference: src/memory.cpp:163-230).  The port does
the same with torch:

- :func:`to_device` copies the host array into a pinned staging slot and
  issues a ``non_blocking`` host-to-device copy on the current stream.
  Each thread owns two slots that alternate, and a slot is refilled only
  after the event recorded behind its last copy has completed, so the
  host-side fill of one gulp overlaps the DMA of the previous one.
- :func:`to_host` issues a ``non_blocking`` device-to-host copy into a
  pinned slot, records an event behind it and waits for that event
  before the host reads the bytes: a ``non_blocking`` copy has not
  finished when the call returns.

On the CPU device both are plain copies.  The copies never alias the
caller's buffer: a ring reuses its storage once a span is released.
"""

from __future__ import annotations

import threading

import numpy as np

from .device import get_device

__all__ = ['to_device', 'to_host', 'torch_dtype_of']

_tls = threading.local()


def torch_dtype_of(np_dtype):
    """The torch dtype of a (non-structured) numpy dtype."""
    import torch
    return torch.from_numpy(np.empty(0, dtype=np_dtype)).dtype


class _Slot(object):
    __slots__ = ('buf', 'event')

    def __init__(self):
        self.buf = None          # pinned uint8 torch tensor
        self.event = None        # completion of the last copy using buf

    def get(self, nbyte):
        import torch
        if self.event is not None:
            self.event.synchronize()
            self.event = None
        if self.buf is None or self.buf.numel() < nbyte:
            self.buf = None
            self.buf = torch.empty(max(nbyte, 1), dtype=torch.uint8,
                                   pin_memory=True)
        return self.buf[:nbyte]


def _slots(kind):
    pools = getattr(_tls, 'pools', None)
    if pools is None:
        pools = _tls.pools = {'h2d': [_Slot(), _Slot()], 'h2d_next': 0,
                              'd2h': _Slot()}
    if kind == 'd2h':
        return pools['d2h']
    i = pools['h2d_next']
    pools['h2d_next'] = 1 - i
    return pools['h2d'][i]


def to_device(arr, device=None):
    """numpy array -> new tensor on ``device`` (default: the port's)."""
    import torch
    arr = np.ascontiguousarray(arr)
    dev = get_device() if device is None else torch.device(device)
    if dev.type != 'cuda':
        return torch.from_numpy(arr.copy()).to(dev)
    tdt = torch_dtype_of(arr.dtype)
    slot = _slots('h2d')
    stage = slot.get(arr.nbytes)
    stage.numpy().view(arr.dtype).reshape(arr.shape)[...] = arr
    out = torch.empty(arr.shape, dtype=tdt, device=dev)
    out.copy_(stage.view(tdt).view(arr.shape), non_blocking=True)
    slot.event = torch.cuda.Event()
    slot.event.record()
    return out


def to_host(t, out=None):
    """tensor -> numpy.  Fills ``out`` when given (its shape must match
    and its dtype must be the tensor's), else returns a new array."""
    import torch
    if t.device.type != 'cuda':
        a = t.detach().numpy()
        if out is None:
            return a.copy()
        out[...] = a.reshape(out.shape)
        return out
    np_dtype = torch.empty(0, dtype=t.dtype).numpy().dtype
    nbyte = t.numel() * t.element_size()
    slot = _slots('d2h')
    stage = slot.get(nbyte)
    stage.view(t.dtype).view(t.shape).copy_(t, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record()
    ev.synchronize()
    host = stage.numpy().view(np_dtype).reshape(tuple(t.shape))
    if out is None:
        return host.copy()
    out[...] = host.reshape(out.shape)
    return out
