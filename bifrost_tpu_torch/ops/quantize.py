"""Quantization and sub-byte unpacking (the port of
``bifrost_tpu/ops/quantize.py``; reference: src/quantize.cpp:52-90,
src/guantize.cu:73-355, src/unpack.cpp).

dst = clip(round(src * scale)) at the limits of dst's integer type.
``torch.round`` rounds half to even, as ``jnp.round`` does.  The port
carries :func:`_clip_limits`, the device math :func:`quantize_tensor`
that :class:`~bifrost_tpu_torch.stages.QuantizeStage` runs,
:func:`quantize` into tensors and host arrays of every type, packed
1/2/4-bit and ci1/ci2/ci4 included (packed on the device by
``devrep.pack_tensor``; :func:`_pack_into` is the host packer, LSB-first
fields), and :func:`unpack`, which expands packed or complex-integer data
into a wider type.
"""

from __future__ import annotations

import numpy as np

from ..dtype import DataType
from .common import as_logical, as_logical_numpy, from_logical_numpy
from .map import _from_logical

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
    """dst = clip(round(src * scale)) in dst's (possibly packed) dtype
    (reference: python/bifrost/quantize.py).  ``src`` is a tensor, a
    numpy array or a host ndarray, moved to the process's device; ``dst``
    is a tensor in the device representation of its type (written in
    place) or a host ndarray (its storage is filled; packed types are
    packed on the device)."""
    import torch
    from ..devrep import from_device_rep
    from ..ndarray import ndarray
    x = as_logical(src)
    if isinstance(dst, torch.Tensor):
        ddt = DataType(torch.empty(0, dtype=dst.dtype).numpy().dtype)
        dst.copy_(quantize_tensor(x, ddt, scale))
        return dst
    ddt = dst.dtype if isinstance(dst, ndarray) else DataType(dst.dtype)
    buf = dst.as_numpy() if isinstance(dst, ndarray) else dst
    from_device_rep(quantize_tensor(x, ddt, scale).contiguous(), ddt, buf)
    return dst


def _pack_into(vals, dtype, out_buf):
    """Pack integer-valued logical values into (possibly sub-byte) host
    storage, as the JAX package does (``bifrost_tpu/ops/quantize.py:77``):
    sample k of a byte in bits [k*nbits, (k+1)*nbits); ci1/ci2/ci4 as
    one 2*nbits field a sample, re in its high half."""
    _from_logical(np.asarray(vals), DataType(dtype), out_buf=out_buf)


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
