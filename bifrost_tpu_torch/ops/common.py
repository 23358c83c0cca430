"""Shared helpers of the op library (a subset of
``bifrost_tpu/ops/common.py``): an op's input as a device tensor and its
result written into a caller's output array.  Left out: ``donating_jit``
(the port runs eagerly), ``complexify``, ``logical_dtype``, ``astype``
and ``as_logical_numpy``, which no ported op calls yet.
"""

from __future__ import annotations

import numpy as np

from ..devrep import from_device_rep, to_device_rep
from ..dtype import DataType
from ..ndarray import ndarray

__all__ = ['as_tensor', 'writeback']


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
