"""Space-tagged host arrays, as the ring's host storage hands them out.

The reference's ``bf.ndarray`` is a numpy subclass carrying a space and
a bifrost dtype (reference: python/bifrost/ndarray.py:120-166).  The
port needs it only for host ring spans: a thin wrapper over a numpy
view of the ring buffer plus its :class:`~bifrost_tpu_torch.dtype.DataType`.
Device spans hand out ``torch.Tensor`` directly, and the constructors
below (``empty``, ``zeros``, ``asarray`` and the ``_like`` pair, the
JAX package's ``bifrost_tpu/ndarray.py:206-255``) give a tensor in the
device representation (:mod:`.devrep`) for ``space='cuda'``.
"""

from __future__ import annotations

import numpy as np

from .dtype import DataType
from .space import canonical

__all__ = ['ndarray', 'asarray', 'empty', 'zeros', 'empty_like',
           'zeros_like', 'copy_array', 'memset_array']


class ndarray(object):
    """A numpy array in a host space, with its bifrost dtype and the
    reference's ``native`` / ``conjugated`` flags.  A packed sub-byte
    type's buffer is its uint8 storage; ``shape`` is then the logical
    shape (the last axis counts samples, not bytes), and ``size`` and
    ``nbytes`` count logical samples.  The members are those of the JAX
    package's ndarray (``bifrost_tpu/ndarray.py:55-184``) for host
    spaces; a copy to ``'cuda'`` is a tensor in the device
    representation, as :func:`asarray` gives."""

    __slots__ = ('_buf', '_space', '_dtype', '_shape', 'native',
                 'conjugated')

    def __init__(self, buf, dtype=None, space='system', shape=None,
                 native=True, conjugated=False):
        buf = np.asarray(buf)
        self._buf = buf
        self._dtype = DataType(dtype if dtype is not None else buf.dtype)
        self._space = canonical(space)
        self._shape = tuple(shape) if shape is not None else None
        self.native = native
        self.conjugated = conjugated

    @property
    def space(self):
        return self._space

    @property
    def dtype(self):
        return self._dtype

    @property
    def bf_dtype(self):
        return self._dtype

    @property
    def shape(self):
        return self._shape if self._shape is not None else self._buf.shape

    @property
    def ndim(self):
        return len(self.shape)

    @property
    def size(self):
        return int(np.prod(self.shape)) if self.shape else 1

    @property
    def nbytes(self):
        return self.size * self._dtype.itemsize_bits // 8

    @property
    def data(self):
        """The underlying numpy array (a packed type's bytes)."""
        return self._buf

    def as_numpy(self):
        return self._buf

    def __array__(self, dtype=None, copy=None):
        return self._buf.astype(dtype) if dtype is not None else self._buf

    def copy(self, space=None):
        """A copy in ``space`` (this array's by default): a host
        :class:`ndarray` with the same flags, or for ``'cuda'`` a tensor
        in the device representation on the process's device."""
        space = self._space if space is None else canonical(space)
        if space == 'cuda':
            from .devrep import to_device_rep
            return to_device_rep(self._buf, self._dtype)
        return ndarray(np.array(self._buf, copy=True), dtype=self._dtype,
                       space=space, shape=self.shape, native=self.native,
                       conjugated=self.conjugated)

    def astype(self, dtype):
        """A host ndarray of ``dtype`` (:func:`ops.common.astype`)."""
        from .ops.common import astype
        return astype(self, dtype)

    def __getitem__(self, idx):
        if self._dtype.is_packed:
            raise TypeError("Indexing packed arrays is not supported; "
                            "unpack first (ops.unpack)")
        return self._buf[idx]

    def __setitem__(self, idx, value):
        if isinstance(value, ndarray):
            value = value.as_numpy()
        self._buf[idx] = value

    def __len__(self):
        return self.shape[0]

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


def zeros(shape, dtype='f32', space='system'):
    """:func:`empty`, zero-filled."""
    dtype = DataType(dtype)
    if canonical(space) == 'cuda':
        from .devrep import device_rep_zeros
        return device_rep_zeros(list(shape), dtype)
    return memset_array(empty(shape, dtype, space), 0)


def _is_tensor(obj):
    import sys
    torch = sys.modules.get('torch')
    return torch is not None and isinstance(obj, torch.Tensor)


def _like(other, space, fill):
    if _is_tensor(other):
        if space is not None and canonical(space) != 'cuda':
            raise TypeError("a device tensor does not carry its bifrost "
                            "dtype: use empty(shape, dtype, %r)" % space)
        import torch
        return torch.zeros_like(other) if fill else \
            torch.empty_like(other)
    make = zeros if fill else empty
    return make(other.shape, other.dtype,
                other.space if space is None else space)


def empty_like(other, space=None):
    """An uninitialised array of ``other``'s shape and dtype, in
    ``other``'s space unless ``space`` is given."""
    return _like(other, space, False)


def zeros_like(other, space=None):
    """:func:`empty_like`, zero-filled."""
    return _like(other, space, True)


def _rep_drops_last_axis(dtype):
    """Whether the device representation of ``dtype`` adds a trailing
    (re, im) axis to the logical shape."""
    from .devrep import device_rep_shape
    return len(device_rep_shape([1], dtype)) == 2


def asarray(obj, space=None, dtype=None):
    """``obj`` (an :class:`ndarray`, a device tensor, or anything numpy
    takes) as an array in ``space`` (its own space, else 'system', by
    default).  A device tensor goes to a host space as ``dtype`` (the
    bifrost dtype of its representation; the tensor's own dtype when
    None).  For a packed ``dtype``, ``obj`` is the byte storage and the
    logical shape is derived from it."""
    if isinstance(obj, ndarray):
        if space is None or canonical(space) == obj.space:
            return obj
        if canonical(space) == 'cuda':
            from .devrep import to_device_rep
            return to_device_rep(obj.as_numpy(), obj.dtype)
        return ndarray(np.array(obj.as_numpy(), copy=True),
                       dtype=obj.dtype, space=space, shape=obj.shape)
    if _is_tensor(obj):
        if space is None or canonical(space) == 'cuda':
            return obj
        if dtype is None:
            return ndarray(obj.detach().cpu().numpy(), space=space)
        dt = DataType(dtype)
        shape = tuple(obj.shape[:-1]) if _rep_drops_last_axis(dt) \
            else tuple(obj.shape)
        out = empty(shape, dt, space)
        from .devrep import from_device_rep
        from_device_rep(obj, dt, out.as_numpy())
        return out
    buf = np.asarray(obj)
    shape = None
    if dtype is not None:
        dt = DataType(dtype)
        if dt.is_packed:
            if buf.dtype != np.uint8:
                buf = buf.view(np.uint8)
            shape = buf.shape[:-1] + \
                (buf.shape[-1] * 8 // dt.itemsize_bits,)
        elif dt.as_numpy_dtype() != buf.dtype:
            if dt.as_numpy_dtype().names is not None:
                buf = buf.view(dt.as_numpy_dtype()).reshape(
                    buf.shape[:-1] + (-1,)) \
                    if buf.dtype == np.uint8 else buf
            else:
                buf = buf.astype(dt.as_numpy_dtype())
    a = ndarray(buf, dtype=dtype, space='system', shape=shape)
    if space is not None and canonical(space) != 'system':
        return asarray(a, space)
    return a
