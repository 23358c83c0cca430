"""Arbitrary-axis ND transpose (reference: src/transpose.cu:503-561,
python/bifrost/transpose.py; JAX package: ``bifrost_tpu/ops/transpose.py``).

The reference hand-tiles shared-memory kernels and the JAX package leaves
the permutation to XLA's layout engine; the port materialises
``torch.permute`` with a contiguous copy (a strided copy kernel of
PyTorch's on the card).
"""

from __future__ import annotations

from .common import as_tensor, writeback

__all__ = ['transpose']


def transpose(dst, src, axes):
    """``dst[...] = src.transpose(axes)``; ``src`` and ``dst`` may be
    tensors or host arrays.  Returns ``dst`` (the new tensor when ``dst``
    is None)."""
    x = as_tensor(src)
    y = x.permute(tuple(int(a) for a in axes)).contiguous()
    return writeback(y, dst)
