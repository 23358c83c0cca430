"""N-dimensional batched FFTs (reference: src/fft.cu:57-230, 384-413,
python/bifrost/fft.py; the port of ``bifrost_tpu/ops/fft.py:21-118``),
through ``torch.fft`` (cuFFT on the card).

The inverse is unnormalized and c2r is scaled by the transform size, as
cuFFT's are (the reference uses CUFFT_INVERSE without scaling).  Left
out: the DFT-as-matmul path (``_dft_matrices``, ``dft_matmul_fft``),
which the mesh FFT of queue 1 item 14 needs.
"""

from __future__ import annotations

import numpy as np

from .common import as_logical, logical_dtype, writeback

__all__ = ['Fft', 'fft', 'fftn_dispatch']


def fftn_dispatch(x, axes, inverse=False):
    """c2c FFT of complex tensor ``x`` over ``axes``; the inverse is
    unnormalized."""
    import torch
    if inverse:
        return torch.fft.ifftn(x, dim=list(axes), norm='forward')
    return torch.fft.fftn(x, dim=list(axes))


def _real_dtype(nbits):
    import torch
    return torch.float64 if nbits > 32 else torch.float32


def _complex_dtype(nbits):
    import torch
    return torch.complex128 if nbits > 32 else torch.complex64


class Fft(object):
    """Plan-style FFT op, mirroring bfFftInit/bfFftExecute
    (reference: python/bifrost/fft.py:41-70).  ``init`` fixes the axes,
    the transform kind (r2c, c2r or c2c, from the arrays' types) and the
    shift; ``execute`` runs it forward or inverse."""

    def __init__(self):
        self._plan = None
        self.workspace_size = 0     # cuFFT's scratch belongs to torch

    def init(self, iarray, oarray, axes=None, apply_fftshift=False):
        ishape = tuple(iarray.shape)
        idt = logical_dtype(iarray)
        odt = logical_dtype(oarray)
        if axes is None:
            axes = list(range(len(ishape)))
        elif np.isscalar(axes):
            axes = [axes]
        axes = [a % len(ishape) for a in axes]
        sizes = [oarray.shape[a] for a in axes]
        self._plan = (idt, odt, axes, sizes, apply_fftshift)
        return self

    def _forward(self, x):
        import torch
        idt, odt, axes, sizes, shift = self._plan
        if idt.is_real:                         # r2c
            y = torch.fft.rfftn(x.to(_real_dtype(idt.nbits)), dim=axes)
        elif odt.is_real:                       # c2r
            y = torch.fft.irfftn(x, s=sizes, dim=axes, norm='forward')
        else:                                   # c2c
            y = fftn_dispatch(x.to(_complex_dtype(idt.nbits)), axes)
        if shift:
            y = torch.fft.fftshift(y, dim=axes)
        return y

    def _inverse(self, x):
        import torch
        idt, odt, axes, sizes, shift = self._plan
        if shift:
            x = torch.fft.ifftshift(x, dim=axes)
        if odt.is_real:
            return torch.fft.irfftn(x, s=sizes, dim=axes, norm='forward')
        return fftn_dispatch(x, axes, inverse=True)

    def execute(self, iarray, oarray, inverse=False):
        odt = self._plan[1]
        x = as_logical(iarray)
        y = self._inverse(x) if inverse else self._forward(x)
        tgt = odt.as_floating_point()
        y = y.to(_real_dtype(tgt.nbits) if tgt.is_real
                 else _complex_dtype(tgt.nbits))
        if oarray is iarray:
            return y
        return writeback(y, oarray)

    def execute_workspace(self, iarray, oarray, workspace_ptr=None,
                          workspace_size=None, inverse=False):
        return self.execute(iarray, oarray, inverse=inverse)


def fft(iarray, oarray=None, axes=None, inverse=False, apply_fftshift=False):
    """One-shot functional FFT; returns the output (a tensor when no
    ``oarray`` is given)."""
    if oarray is None:
        oarray = iarray   # dtype/shape template only
    plan = Fft().init(iarray, oarray, axes=axes,
                      apply_fftshift=apply_fftshift)
    return plan.execute(iarray, oarray, inverse=inverse)
