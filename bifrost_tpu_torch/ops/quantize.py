"""Quantization and sub-byte unpacking (the port of
``bifrost_tpu/ops/quantize.py``; reference: src/quantize.cpp:52-90,
src/guantize.cu:73-355, src/unpack.cpp).

dst = clip(round(src * scale)) at the limits of dst's integer type.
``torch.round`` rounds half to even, as ``jnp.round`` does.  The port
carries :func:`_clip_limits`, the device math :func:`quantize_tensor`
that :class:`~bifrost_tpu_torch.stages.QuantizeStage` runs,
:func:`quantize` into host arrays of whole-byte types, and
:func:`unpack`, which expands packed or complex-integer data into a
wider type.  Packed 1/2/4-bit outputs (``_pack_into``) are not ported
yet.
"""

from __future__ import annotations

import numpy as np

from ..dtype import DataType
from .common import as_logical_numpy, from_logical_numpy

__all__ = ['quantize', 'quantize_tensor', 'unpack']


def _clip_limits(dtype):
    if dtype.kind in ('i', 'ci'):
        hi = (1 << (dtype.nbits - 1)) - 1
        return -hi - 1, hi
    if dtype.kind == 'u':
        return 0, (1 << dtype.nbits) - 1
    return None, None


def quantize_tensor(x, dtype, scale=1.):
    """clip(round(x * scale)) of a real or complex tensor, in the device
    representation of ``dtype``: complex integers as a trailing (re, im)
    axis of their component type."""
    import torch
    dt = DataType(dtype)
    lo, hi = _clip_limits(dt)
    y = x * scale
    if dt.kind == 'ci':
        if not y.is_complex():
            y = torch.complex(y.float(), torch.zeros_like(y.float()))
        re = torch.clamp(torch.round(y.real), lo, hi)
        im = torch.clamp(torch.round(y.imag), lo, hi)
        return torch.stack([re, im], dim=-1).to(dt.as_torch_dtype())
    if y.is_complex() and dt.kind in ('i', 'u', 'f'):
        y = y.real
    if lo is not None:
        y = torch.clamp(torch.round(y), lo, hi)
    return y.to(dt.as_torch_dtype())


def quantize(src, dst, scale=1.):
    """dst = clip(round(src * scale)) in dst's dtype: ``src`` a tensor, a
    numpy array or a host ndarray; ``dst`` a host ndarray (its buffer is
    filled) (reference: python/bifrost/quantize.py)."""
    import torch
    from ..ndarray import ndarray
    if dst.dtype.nbits < 8:
        raise NotImplementedError("quantize: packed %s output is not "
                                  "ported yet" % dst.dtype)
    if isinstance(src, ndarray):
        buf = src.as_numpy()
        if buf.dtype.names is not None:            # ci host storage
            comp = buf.view(buf.dtype[0]).reshape(buf.shape + (2,))
            src = np.empty(buf.shape, np.complex64)
            src.real, src.imag = comp[..., 0], comp[..., 1]
        else:
            src = buf
    if not isinstance(src, torch.Tensor):
        src = torch.from_numpy(np.ascontiguousarray(src))
    y = quantize_tensor(src, dst.dtype, scale).cpu().numpy()
    out = dst.as_numpy()
    if out.dtype.names is not None:
        out = out.view(out.dtype[0]).reshape(out.shape + (2,))
    out[...] = y.reshape(out.shape)
    return dst


def unpack(src, dst):
    """Expand packed sub-byte (or complex-integer) ``src`` into ``dst``'s
    type (reference: python/bifrost/unpack.py): both host arrays, the
    port's ``ndarray`` or numpy (a structured numpy array is typed by its
    fields, a plain one by its element)."""
    from ..ndarray import ndarray
    logical = as_logical_numpy(src)
    ddt = dst.dtype if isinstance(dst, ndarray) else DataType(dst.dtype)
    buf = dst.as_numpy() if isinstance(dst, ndarray) else dst
    from_logical_numpy(logical, ddt, out_buf=buf)
    return dst
