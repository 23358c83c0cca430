"""FFTs over given axes (reference: src/fft.cu; JAX package:
``bifrost_tpu/ops/fft.py:fftn_dispatch``), through ``torch.fft`` (cuFFT
on the card).  The inverse and the DFT-as-matmul path of the JAX package
are not ported yet."""

from __future__ import annotations

__all__ = ['fftn_dispatch']


def fftn_dispatch(x, axes):
    """Forward c2c FFT of complex tensor ``x`` over ``axes``."""
    import torch
    return torch.fft.fftn(x, dim=list(axes))
