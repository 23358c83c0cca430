"""Device representation: how each bifrost dtype lives in device memory.

- real and complex float types -> the natural torch dtype
- ci8/ci16/ci32 -> int8/int16/int32 with a trailing (re, im) axis of
  length 2, the layout of ``bifrost_tpu.devrep`` (``devrep.py:25-103``).
  The fused-spectrometer kernel reads each ci8 pair as one little-endian
  int16 whose low byte is re.
- cf16 -> complex64

The host side is the numpy storage a ring span exposes (structured
``ci*`` dtypes).  Conversions are bit-exact round trips.
"""

from __future__ import annotations

import numpy as np

from .dtype import DataType
from .xfer import to_device, to_host

__all__ = ['to_device_rep', 'from_device_rep', 'device_rep_zeros',
           'device_rep_shape']


def _host_component_view(buf, dtype):
    """Structured ci*/cf16 host storage as a plain (..., 2) array."""
    buf = np.ascontiguousarray(buf)
    return buf.view(buf.dtype[0]).reshape(buf.shape + (2,))


def device_rep_shape(shape, dtype):
    """Device-representation shape of a logical ``shape``."""
    dtype = DataType(dtype)
    return tuple(shape) + ((2,) if dtype.kind == 'ci' else ())


def to_device_rep(buf, dtype, device=None):
    """numpy host storage -> device-representation tensor."""
    dtype = DataType(dtype)
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
    if dtype.kind == 'ci':
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
