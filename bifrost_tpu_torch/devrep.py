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
from .xfer import to_device, to_host

__all__ = ['to_device_rep', 'from_device_rep', 'device_rep_zeros',
           'device_rep_shape', 'unpack_tensor', 'pack_tensor']


def _host_component_view(buf, dtype):
    """Structured ci*/cf16 host storage as a plain (..., 2) array."""
    buf = np.ascontiguousarray(buf)
    return buf.view(buf.dtype[0]).reshape(buf.shape + (2,))


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


def to_device_rep(buf, dtype, device=None):
    """numpy host storage -> device-representation tensor."""
    dtype = DataType(dtype)
    if _is_packed_storage(dtype):
        b = np.ascontiguousarray(buf).view(np.uint8)
        return unpack_tensor(to_device(b, device), dtype)
    if dtype.kind == 'ci':
        return to_device(_host_component_view(buf, dtype), device)
    if dtype.kind == 'cf' and dtype.nbits == 16:
        comp = _host_component_view(buf, dtype).astype(np.float32)
        return to_device(comp[..., 0] + 1j * comp[..., 1], device)
    return to_device(buf, device)


def from_device_rep(t, dtype, out_buf):
    """device-representation tensor -> numpy host storage ``out_buf``
    (bit-exact inverse of :func:`to_device_rep`)."""
    dtype = DataType(dtype)
    if _is_packed_storage(dtype):
        to_host(pack_tensor(t, dtype), out_buf.view(np.uint8))
    elif dtype.kind == 'ci':
        to_host(t, out_buf.view(out_buf.dtype[0]).reshape(
            out_buf.shape + (2,)))
    elif dtype.kind == 'cf' and dtype.nbits == 16:
        arr = to_host(t)
        out_buf['re'] = arr.real
        out_buf['im'] = arr.imag
    else:
        to_host(t, out_buf)
    return out_buf


def device_rep_zeros(shape, dtype, device=None):
    """Zeros in the device representation of ``dtype``."""
    import torch
    from .device import get_device
    dtype = DataType(dtype)
    return torch.zeros(device_rep_shape(shape, dtype),
                       dtype=dtype.as_torch_dtype(),
                       device=get_device() if device is None else device)
