"""Space-tagged host arrays, as the ring's host storage hands them out.

The reference's ``bf.ndarray`` is a numpy subclass carrying a space and
a bifrost dtype (reference: python/bifrost/ndarray.py:120-166).  The
port needs it only for host ring spans: a thin wrapper over a numpy
view of the ring buffer plus its :class:`~bifrost_tpu_torch.dtype.DataType`.
Device spans hand out ``torch.Tensor`` directly.
"""

from __future__ import annotations

import numpy as np

from .dtype import DataType
from .space import canonical

__all__ = ['ndarray', 'copy_array', 'memset_array', 'empty']


class ndarray(object):
    """A numpy array in a host space, with its bifrost dtype.  A packed
    sub-byte type's buffer is its uint8 storage; ``shape`` is then the
    logical shape (the last axis counts samples, not bytes)."""

    __slots__ = ('_buf', '_space', '_dtype', '_shape')

    def __init__(self, buf, dtype=None, space='system', shape=None):
        buf = np.asarray(buf)
        self._buf = buf
        self._dtype = DataType(dtype if dtype is not None else buf.dtype)
        self._space = canonical(space)
        self._shape = tuple(shape) if shape is not None else None

    @property
    def space(self):
        return self._space

    @property
    def dtype(self):
        return self._dtype

    @property
    def shape(self):
        return self._shape if self._shape is not None else self._buf.shape

    def as_numpy(self):
        return self._buf

    def __repr__(self):
        return "ndarray(space=%r, dtype=%s, shape=%s)" % (
            self._space, self._dtype, self._buf.shape)


def copy_array(dst, src):
    """Copy host ``src`` (ndarray or numpy) into host ndarray ``dst``."""
    s = src.as_numpy() if isinstance(src, ndarray) else np.asarray(src)
    d = dst.as_numpy()
    if s.shape != d.shape:
        raise ValueError("Shape mismatch: %s vs %s" % (s.shape, d.shape))
    d[...] = s
    return dst


def memset_array(a, value=0):
    """Fill host ndarray ``a`` with ``value`` (structured complex types
    fill every component)."""
    buf = a.as_numpy()
    if buf.dtype.names is not None:
        buf.view(buf.dtype[0])[...] = value
    else:
        buf[...] = value
    return a


def empty(shape, dtype='f32', space='system'):
    """An uninitialised array of logical ``shape``: a host
    :class:`ndarray` (a packed type's buffer is its bytes) in a host
    space, a tensor in the device representation on the process's device
    for ``'cuda'``."""
    dtype = DataType(dtype)
    space = canonical(space)
    if space == 'cuda':
        import torch
        from .device import get_device
        from .devrep import device_rep_shape
        return torch.empty(device_rep_shape(list(shape), dtype),
                           dtype=dtype.as_torch_dtype(),
                           device=get_device())
    if dtype.is_packed:
        nbit = dtype.itemsize_bits
        store = tuple(shape[:-1]) + (-(-shape[-1] * nbit // 8),)
        buf = np.empty(store, dtype=np.uint8)
    else:
        buf = np.empty(tuple(shape), dtype=dtype.as_numpy_dtype())
    return ndarray(buf, dtype=dtype, space=space, shape=tuple(shape))
