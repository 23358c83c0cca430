"""Device representation: how each bifrost dtype lives in device memory.

- real and complex float types -> the natural torch dtype
- ci8/ci16/ci32 -> int8/int16/int32 with a trailing (re, im) axis of
  length 2, the layout of ``bifrost_tpu.devrep`` (``devrep.py:25-103``).
  The fused-spectrometer kernel reads each ci8 pair as one little-endian
  int16 whose low byte is re.
- ci4 -> int8 (re, im) pairs: re from the high nibble, im from the low
  one, each sign-extended; ci1/ci2 (one 2*nbits field per sample, re in
  the high half, fields LSB first in the byte) the same way
- packed i1/i2/i4 and u1/u2/u4 -> int8/uint8, one element per sample,
  samples LSB first within each byte
- cf16 -> complex64

The host side is the numpy storage a ring span exposes (structured
``ci*`` dtypes, uint8 bytes for packed types).  Packed types cross the
host boundary packed and are unpacked (or packed again) by torch ops on
the device.  Conversions are bit-exact round trips.
"""

from __future__ import annotations

import numpy as np

from .dtype import DataType
from .xfer import engine

__all__ = ['to_device_rep', 'from_device_rep', 'device_rep_zeros',
           'device_rep_shape', 'unpack_tensor', 'pack_tensor',
           'to_device_plan', 'from_device_plan']


def _host_component_view(buf, dtype):
    """Structured ci*/cf16 host storage as a plain (..., 2) array: a
    view, whatever the strides of ``buf`` (a span of a ringlet ring
    included), so the transfer engine's one staging copy is the only
    copy."""
    try:
        return buf[..., None].view(buf.dtype[0])
    except ValueError:       # a numpy that refuses the strided view
        return np.stack([buf[n] for n in buf.dtype.names], axis=-1)


def _field_width(dtype):
    """Bits of one sample in the packed byte stream of a sub-byte type
    (ci4 included): both components of a complex sample."""
    return dtype.nbits * (2 if dtype.kind == 'ci' else 1)


def device_rep_shape(shape, dtype):
    """Device-representation shape of a logical ``shape``."""
    dtype = DataType(dtype)
    return tuple(shape) + ((2,) if dtype.kind == 'ci' else ())


def _sign_extend(v, nbits):
    """int16 tensor of ``nbits``-bit two's-complement fields -> int8."""
    import torch
    return (v - ((v & (1 << (nbits - 1))) << 1)).to(torch.int8)


def unpack_tensor(b, dtype):
    """uint8 tensor of packed ``dtype`` bytes (last axis packed) -> the
    device representation: one element per sample, and a trailing (re,
    im) axis for complex types."""
    import torch
    dtype = DataType(dtype)
    width = _field_width(dtype)
    per = 8 // width
    v = b.to(torch.int16)
    if per > 1:
        shifts = torch.arange(per, dtype=torch.int16,
                              device=b.device) * width
        v = (v.unsqueeze(-1) >> shifts) & ((1 << width) - 1)
        v = v.reshape(tuple(b.shape[:-1]) + (b.shape[-1] * per,))
    if dtype.kind == 'ci':
        n = dtype.nbits
        re = _sign_extend(v >> n, n)
        im = _sign_extend(v & ((1 << n) - 1), n)
        return torch.stack([re, im], dim=-1)
    if dtype.kind == 'i':
        return _sign_extend(v, dtype.nbits)
    return v.to(torch.uint8)


def pack_tensor(t, dtype):
    """Inverse of :func:`unpack_tensor`: device representation -> uint8
    packed bytes (each value masked to its field, as the JAX package
    packs, ``bifrost_tpu/devrep.py:79-92``)."""
    import torch
    dtype = DataType(dtype)
    width = _field_width(dtype)
    per = 8 // width
    if dtype.kind == 'ci':
        n = dtype.nbits
        mask = (1 << n) - 1
        v = ((t[..., 0].to(torch.int16) & mask) << n) | \
            (t[..., 1].to(torch.int16) & mask)
    else:
        v = t.to(torch.int16) & ((1 << width) - 1)
    if per > 1:
        v = v.reshape(tuple(v.shape[:-1]) + (v.shape[-1] // per, per))
        shifts = torch.arange(per, dtype=torch.int16,
                              device=t.device) * width
        v = (v << shifts).sum(dim=-1)
    return v.to(torch.uint8)


def _is_packed_storage(dtype):
    return dtype.is_packed or (dtype.kind == 'ci' and dtype.nbits == 4)


def to_device_plan(buf, dtype):
    """(host array to ship, device-side conversion or None) for numpy
    host storage ``buf`` of bifrost dtype ``dtype``: the array is a view
    of ``buf`` (packed bytes, ci (re, im) components) except for cf16,
    whose components are widened on the host."""
    dtype = DataType(dtype)
    if _is_packed_storage(dtype):
        return buf.view(np.uint8), lambda t: unpack_tensor(t, dtype)
    if dtype.kind == 'ci':
        return _host_component_view(buf, dtype), None
    if dtype.kind == 'cf' and dtype.nbits == 16:
        comp = _host_component_view(buf, dtype).astype(np.float32)
        return comp[..., 0] + 1j * comp[..., 1], None
    return buf, None


def to_device_rep(buf, dtype, device=None):
    """numpy host storage -> device-representation tensor (one host
    copy, into the transfer engine's staging)."""
    arr, post = to_device_plan(buf, dtype)
    t = engine().to_device(arr, device)
    return t if post is None else post(t)


def from_device_plan(t, dtype, out_buf):
    """(tensor to copy, numpy target of its bytes or None, host-side
    conversion or None) that move device-representation tensor ``t`` into
    numpy host storage ``out_buf``.  Packed types are packed on the
    device first; cf16 lands as complex64 and is narrowed on the host."""
    dtype = DataType(dtype)
    if _is_packed_storage(dtype):
        return pack_tensor(t, dtype), out_buf.view(np.uint8), None
    if dtype.kind == 'ci':
        return t, out_buf.view(out_buf.dtype[0]).reshape(
            out_buf.shape + (2,)), None
    if dtype.kind == 'cf' and dtype.nbits == 16:
        def post(arr):
            out_buf['re'] = arr.real
            out_buf['im'] = arr.imag
        return t, None, post
    return t, out_buf, None


def from_device_rep(t, dtype, out_buf):
    """device-representation tensor -> numpy host storage ``out_buf``
    (bit-exact inverse of :func:`to_device_rep`); blocks until the bytes
    are there."""
    t, target, post = from_device_plan(t, dtype, out_buf)
    arr = engine().to_host(t, target)
    if post is not None:
        post(arr)
    return out_buf


def device_rep_zeros(shape, dtype, device=None):
    """Zeros in the device representation of ``dtype``."""
    import torch
    from .device import get_device
    dtype = DataType(dtype)
    return torch.zeros(device_rep_shape(shape, dtype),
                       dtype=dtype.as_torch_dtype(),
                       device=get_device() if device is None else device)
