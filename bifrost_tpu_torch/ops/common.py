"""Shared helpers of the op library (the port of
``bifrost_tpu/ops/common.py``): an op's input as a device tensor, its
result written into a caller's output array, and the conversions between
a type's storage and its logical values.

- :func:`as_tensor` keeps the device representation (ci* as int pairs,
  packed types unpacked); :func:`as_logical` gives logical values (ci*
  as complex64), the counterpart of the JAX package's ``as_jax``.
- :func:`to_logical_numpy` / :func:`from_logical_numpy` convert host
  storage (structured ci*, packed sub-byte bytes) to and from logical
  numpy values, as ``bifrost_tpu/ops/map.py:117-212`` does.

Left out: ``donating_jit`` (the port runs eagerly).
"""

from __future__ import annotations

import numpy as np

from ..devrep import from_device_rep, to_device_rep
from ..dtype import DataType
from ..ndarray import ndarray

__all__ = ['as_tensor', 'writeback', 'complexify', 'logical_dtype',
           'as_logical', 'as_logical_numpy', 'astype', 'to_logical_numpy',
           'from_logical_numpy']


def as_tensor(x):
    """A torch tensor as it is; a host array (the port's ``ndarray`` or
    numpy) copied to the process's device in its device representation."""
    import torch
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, ndarray):
        return to_device_rep(x.as_numpy(), x.dtype)
    arr = np.asarray(x)
    return to_device_rep(arr, DataType(arr.dtype))


def writeback(y, out):
    """Write tensor ``y`` into ``out`` (a tensor, the port's host
    ``ndarray`` or a numpy array) and return ``out``; with no ``out``,
    return ``y``."""
    import torch
    if out is None:
        return y
    if isinstance(out, torch.Tensor):
        out.copy_(y)
        return out
    buf = out.as_numpy() if isinstance(out, ndarray) else out
    dt = out.dtype if isinstance(out, ndarray) else DataType(buf.dtype)
    from_device_rep(y, dt, buf)
    return out


def complexify(t, dtype):
    """A device-representation tensor of ``dtype`` (int (re, im) pairs for
    ci*) as complex64; other tensors unchanged."""
    import torch
    dtype = DataType(dtype)
    if dtype.kind == 'ci' and t.dim() and t.shape[-1] == 2 and \
            not t.is_complex():
        return torch.complex(t[..., 0].float(), t[..., 1].float())
    return t


def logical_dtype(x):
    """DataType of ``x``'s logical values: the port's ``ndarray`` keeps
    its own type; tensors and numpy arrays are typed by their element."""
    import torch
    if isinstance(x, ndarray):
        return x.dtype
    if isinstance(x, torch.Tensor):
        return DataType(torch.empty(0, dtype=x.dtype).numpy().dtype)
    return DataType(np.dtype(getattr(x, 'dtype', type(x))))


def as_logical(x):
    """Any supported array (the port's ``ndarray``, packed and complex-int
    types included, numpy, or a tensor) as a tensor of logical values on
    the process's device (complex integers become complex64)."""
    import torch
    from ..xfer import to_device
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, ndarray):
        return to_device(to_logical_numpy(x.as_numpy(), x.dtype))
    arr = np.asarray(x)
    if arr.dtype.names is not None:
        return to_device(to_logical_numpy(arr, DataType(arr.dtype)))
    return to_device(arr)


def as_logical_numpy(x):
    """The logical values of ``x`` as a numpy array."""
    import torch
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, ndarray):
        return to_logical_numpy(x.as_numpy(), x.dtype)
    arr = np.asarray(x)
    if arr.dtype.names is not None:
        return to_logical_numpy(arr, DataType(arr.dtype))
    return arr


def astype(x, dtype):
    """Space-preserving conversion (reference: ndarray.py:373-395): a
    tensor becomes a tensor in the device representation of ``dtype``;
    a host array becomes a host ``ndarray`` of ``dtype``'s storage
    (integer targets round, complex integers per component)."""
    import torch
    dtype = DataType(dtype)
    if isinstance(x, torch.Tensor):
        if dtype.kind == 'ci':
            v = x if x.is_complex() else torch.complex(
                x.float(), torch.zeros_like(x, dtype=torch.float32))
            return torch.stack([torch.round(v.real), torch.round(v.imag)],
                               dim=-1).to(dtype.as_torch_dtype())
        if dtype.kind in ('i', 'u') and (x.is_floating_point() or
                                         x.is_complex()):
            x = torch.round(x.real if x.is_complex() else x)
        elif dtype.is_real and x.is_complex():
            x = x.real
        return x.to(dtype.as_torch_dtype())
    res = from_logical_numpy(as_logical_numpy(x), dtype)
    shape = x.shape if hasattr(x, 'shape') else res.shape
    return ndarray(res, dtype=dtype, space='system', shape=tuple(shape))


def to_logical_numpy(buf, dtype):
    """Host storage (structured ci*/cf16, packed sub-byte bytes) ->
    logical numpy values: complex integers become complex64, packed
    integers int8/uint8, one element per sample (LSB first in the
    byte)."""
    dtype = DataType(dtype)
    if dtype.kind == 'ci':
        if dtype.nbits == 4:
            b = buf.view(np.uint8)
            re = (b.astype(np.int8) >> 4).astype(np.float32)
            im = (np.left_shift(b, 4).astype(np.int8) >> 4) \
                .astype(np.float32)
            return (re + 1j * im).astype(np.complex64)
        if dtype.is_packed:
            # ci1/ci2: one 2*nbits field a sample, re in its high half,
            # fields LSB first within the byte
            nbits = dtype.nbits
            width = 2 * nbits
            per = 8 // width
            b = buf.view(np.uint8)
            shifts = np.arange(per, dtype=np.uint8) * width
            fields = (b[..., None] >> shifts) & ((1 << width) - 1)
            fields = fields.reshape(buf.shape[:-1] + (-1,))

            def sext(v):
                return ((v.astype(np.int8) << (8 - nbits))
                        >> (8 - nbits)).astype(np.float32)
            re = sext(fields >> nbits)
            im = sext(fields & ((1 << nbits) - 1))
            return (re + 1j * im).astype(np.complex64)
        re = buf['re'].astype(np.float32)
        im = buf['im'].astype(np.float32)
        return (re + 1j * im).astype(np.complex64)
    if dtype.kind == 'cf' and dtype.nbits == 16:
        return (buf['re'].astype(np.float32) +
                1j * buf['im'].astype(np.float32)).astype(np.complex64)
    if dtype.is_packed:
        nbits = dtype.nbits
        b = buf.view(np.uint8)
        per = 8 // nbits
        shifts = np.arange(per, dtype=np.uint8) * nbits
        vals = (b[..., None] >> shifts) & ((1 << nbits) - 1)
        vals = vals.reshape(buf.shape[:-1] + (-1,))
        if dtype.kind == 'i':
            vals = (vals.astype(np.int8) << (8 - nbits)) >> (8 - nbits)
        return vals
    return buf


def from_logical_numpy(arr, dtype, out_buf=None):
    """Logical numpy values -> ``dtype``'s host storage (the inverse of
    :func:`to_logical_numpy`; integer targets round, packed fields are
    masked to their width).  Fills ``out_buf`` when given."""
    dtype = DataType(dtype)
    arr = np.asarray(arr)
    if dtype.kind == 'ci' and (dtype.nbits == 4 or dtype.is_packed):
        nbits = dtype.nbits
        width = 2 * nbits
        per = 8 // width
        mask = (1 << nbits) - 1
        re = np.round(arr.real).astype(np.int64) & mask
        im = np.round(arr.imag).astype(np.int64) & mask
        fields = (re << nbits) | im
        if per > 1:
            fields = fields.reshape(fields.shape[:-1] +
                                    (fields.shape[-1] // per, per))
            fields = np.bitwise_or.reduce(fields << (np.arange(per) * width),
                                          axis=-1)
        packed = fields.astype(np.uint8)
        if out_buf is not None:
            out_buf[...] = packed.view(out_buf.dtype).reshape(out_buf.shape)
            return out_buf
        return packed
    if dtype.kind == 'ci':
        out = np.empty(arr.shape, dtype=dtype.as_numpy_dtype()) \
            if out_buf is None else out_buf
        out['re'] = np.round(arr.real)
        out['im'] = np.round(arr.imag)
        return out
    if dtype.kind == 'cf' and dtype.nbits == 16:
        out = np.empty(arr.shape, dtype=dtype.as_numpy_dtype()) \
            if out_buf is None else out_buf
        out['re'] = arr.real
        out['im'] = arr.imag
        return out
    if dtype.is_packed:
        nbits = dtype.nbits
        per = 8 // nbits
        v = np.round(arr).astype(np.int64) & ((1 << nbits) - 1)
        v = v.reshape(v.shape[:-1] + (v.shape[-1] // per, per))
        packed = np.bitwise_or.reduce(v << (np.arange(per) * nbits),
                                      axis=-1).astype(np.uint8)
        if out_buf is not None:
            out_buf[...] = packed.reshape(out_buf.shape)
            return out_buf
        return packed
    if dtype.kind in ('i', 'u') and np.issubdtype(arr.dtype, np.floating):
        arr = np.round(arr)
    res = arr.astype(dtype.as_numpy_dtype())
    if out_buf is not None:
        out_buf[...] = res
        return out_buf
    return res
