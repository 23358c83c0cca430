"""Bifrost data types for the PyTorch/CUDA port.

Same semantics as the reference DataType (reference:
python/bifrost/DataType.py:62-109): a type is ``kind`` + ``nbits``, where
kind is one of ``i`` (signed int), ``u`` (unsigned int), ``f`` (float),
``ci`` (complex signed int, nbits per component) or ``cf`` (complex
float, nbits per component).  Host storage of complex-integer types uses
the structured numpy dtypes below, laid out as the reference lays them
out; their device form is a trailing (re, im) axis (see
:mod:`bifrost_tpu_torch.devrep`).

Sub-byte types (i1/i2/i4/u1/u2/u4/ci1/ci2) are stored bit-packed, LSB
first within the byte, as the reference packs them (reference:
python/bifrost/DataType.py:55-60; src/unpack.cpp): their host storage is
uint8.  ci4 fills one byte per sample (re in the high nibble, im in the
low one) and has a structured one-field dtype, as in
``bifrost_tpu/dtype.py:37``.
"""

from __future__ import annotations

import numpy as np

__all__ = ['DataType', 'ci4', 'ci8', 'ci16', 'ci32', 'cf16']

ci4 = np.dtype([('re_im', np.uint8)])   # 4-bit re in high nibble, im low
ci8 = np.dtype([('re', np.int8), ('im', np.int8)])
ci16 = np.dtype([('re', np.int16), ('im', np.int16)])
ci32 = np.dtype([('re', np.int32), ('im', np.int32)])
cf16 = np.dtype([('re', np.float16), ('im', np.float16)])

_KINDS = ('i', 'u', 'f', 'ci', 'cf')

_FROM_NUMPY = {
    np.dtype(np.int8): ('i', 8), np.dtype(np.int16): ('i', 16),
    np.dtype(np.int32): ('i', 32), np.dtype(np.int64): ('i', 64),
    np.dtype(np.uint8): ('u', 8), np.dtype(np.uint16): ('u', 16),
    np.dtype(np.uint32): ('u', 32), np.dtype(np.uint64): ('u', 64),
    np.dtype(np.float16): ('f', 16), np.dtype(np.float32): ('f', 32),
    np.dtype(np.float64): ('f', 64),
    np.dtype(np.complex64): ('cf', 32), np.dtype(np.complex128): ('cf', 64),
    ci8: ('ci', 8), ci16: ('ci', 16), ci32: ('ci', 32), cf16: ('cf', 16),
    ci4: ('ci', 4),
}

_TO_NUMPY = {v: k for k, v in _FROM_NUMPY.items()}


class DataType(object):
    """kind + nbits type tag, with a vector length (``'f32_x2'`` is two
    f32 a element).  Construct from a string ('ci8', 'f32', 'f32_x2',
    ...), a numpy dtype, a python scalar type or another DataType."""

    __slots__ = ('kind', 'nbits', 'veclen')

    def __init__(self, t='f32', veclen=1):
        if isinstance(t, DataType):
            self.kind, self.nbits, self.veclen = t.kind, t.nbits, t.veclen
            return
        if isinstance(t, str):
            s = t
            if '_x' in s:
                s, _, v = s.partition('_x')
                veclen = int(v)
            kind = s.rstrip('0123456789')
            bits = s[len(kind):]
            if kind in _KINDS and bits.isdigit():
                self.kind, self.nbits, self.veclen = kind, int(bits), veclen
                return
        try:
            npt = np.dtype(t)
        except TypeError:
            raise TypeError("Unsupported dtype: %r" % (t,))
        if npt not in _FROM_NUMPY:
            raise TypeError("Unsupported dtype: %r" % (t,))
        self.kind, self.nbits = _FROM_NUMPY[npt]
        self.veclen = veclen

    def __str__(self):
        s = '%s%d' % (self.kind, self.nbits)
        if self.veclen != 1:
            s += '_x%d' % self.veclen
        return s

    def __repr__(self):
        return "DataType('%s')" % (self,)

    def __eq__(self, other):
        try:
            other = DataType(other)
        except (TypeError, ValueError):
            return NotImplemented
        return (self.kind, self.nbits, self.veclen) == \
            (other.kind, other.nbits, other.veclen)

    def __ne__(self, other):
        return not self == other

    def __hash__(self):
        return hash((self.kind, self.nbits, self.veclen))

    @property
    def is_complex(self):
        return self.kind in ('ci', 'cf')

    @property
    def is_real(self):
        return not self.is_complex

    @property
    def is_floating_point(self):
        return self.kind in ('f', 'cf')

    @property
    def is_integer(self):
        return self.kind in ('i', 'u', 'ci')

    @property
    def is_signed(self):
        return self.kind in ('i', 'ci', 'f', 'cf')

    @property
    def itemsize_bits(self):
        """Total bits per element (both components of a complex, every
        lane of a vector)."""
        return self.nbits * (2 if self.is_complex else 1) * self.veclen

    @property
    def itemsize(self):
        """Bytes per element; raises for packed sub-byte types."""
        if self.itemsize_bits % 8:
            raise ValueError("%s is a packed sub-byte type" % self)
        return self.itemsize_bits // 8

    @property
    def is_packed(self):
        """True for types whose element is smaller than one byte
        (i1/i2/i4/u1/u2/u4/ci1/ci2), stored bit-packed."""
        return self.itemsize_bits < 8

    def as_numpy_dtype(self):
        """Host storage dtype; packed types report their byte storage,
        uint8, and a vector type a subarray dtype of its lanes."""
        if self.veclen != 1:
            base = DataType('%s%d' % (self.kind, self.nbits))
            return np.dtype((base.as_numpy_dtype(), (self.veclen,)))
        key = (self.kind, self.nbits)
        if key in _TO_NUMPY:
            return _TO_NUMPY[key]
        if self.is_packed:
            return np.dtype(np.uint8)
        raise TypeError("No numpy equivalent for %s" % self)

    def as_torch_dtype(self):
        """The torch dtype of this type's device representation: complex
        integers keep their component type (the (re, im) pair becomes a
        trailing axis; ci1/ci2/ci4 widen to int8), packed integers widen
        to int8/uint8, cf16 widens to complex64.  A vector type gives its
        lane's type, as the JAX package's ``as_jax_dtype`` does."""
        import torch
        if self.kind == 'ci':
            if self.nbits <= 8:
                return torch.int8
            return {16: torch.int16, 32: torch.int32}[self.nbits]
        if self.is_packed:
            return torch.int8 if self.kind == 'i' else torch.uint8
        if self.kind == 'cf':
            return torch.complex128 if self.nbits > 32 else torch.complex64
        if self.kind == 'f':
            return {16: torch.float16, 32: torch.float32,
                    64: torch.float64}[self.nbits]
        if self.kind == 'i':
            return {8: torch.int8, 16: torch.int16, 32: torch.int32,
                    64: torch.int64}[self.nbits]
        if self.kind == 'u':
            return {8: torch.uint8, 16: torch.uint16, 32: torch.uint32,
                    64: torch.uint64}[self.nbits]
        raise TypeError("No torch equivalent for %s" % self)

    def as_floating_point(self):
        """The smallest floating-point type that holds this type
        (reference: DataType.as_floating_point)."""
        if self.is_floating_point:
            return self
        nbits = 32 if self.nbits <= 16 else 64
        return DataType('%s%d' % ('cf' if self.is_complex else 'f', nbits))

    def as_real(self):
        if not self.is_complex:
            return self
        return DataType('%s%d' % (self.kind[1:], self.nbits))

    def as_complex(self):
        if self.is_complex:
            return self
        if self.kind == 'u':
            raise TypeError("No complex-unsigned types")
        return DataType('c%s%d' % (self.kind, self.nbits))

    def as_vector(self, veclen):
        return DataType('%s%d' % (self.kind, self.nbits), veclen)

    def as_nbit(self, nbits):
        return DataType('%s%d' % (self.kind, nbits), self.veclen)
