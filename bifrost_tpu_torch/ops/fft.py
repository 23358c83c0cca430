"""N-dimensional batched FFTs (reference: src/fft.cu:57-230, 384-413,
python/bifrost/fft.py; the port of ``bifrost_tpu/ops/fft.py``), through
``torch.fft`` (cuFFT on the card), or as DFT matrix products.

The inverse is unnormalized and c2r is scaled by the transform size, as
cuFFT's are (the reference uses CUFFT_INVERSE without scaling).
:func:`dft_matmul_fft` is the four-step Cooley-Tukey transform as two
matrix products per axis (``compute_dtype='bf16'`` rounds their operands
to bf16), which the mesh FFT builds on.  :func:`fftn_dispatch` always
takes ``torch.fft``: the JAX package's ``BF_FFT_IMPL=dftmm`` switch
serves the TPU's matrix units, and on the card cuFFT is the faster path.
"""

from __future__ import annotations

import math

import numpy as np

from .common import as_logical, logical_dtype, writeback

__all__ = ['Fft', 'fft', 'fftn_dispatch', 'dft_matmul_fft']


def _split_factor(n):
    """Factor n = n1 * n2 with n1 ~ sqrt(n) (radix split)."""
    n1 = int(math.isqrt(n))
    while n1 > 1 and n % n1:
        n1 -= 1
    return n1, n // n1


_dft_cache = {}


def _dft_matrices(n1, n2, inverse, dtype_name):
    """Twiddle/DFT factor matrices for the four-step transform, cached
    host-side per (n1, n2, direction, dtype)."""
    key = (n1, n2, inverse, dtype_name)
    hit = _dft_cache.get(key)
    if hit is not None:
        return hit
    sgn = +1 if inverse else -1
    f1 = np.exp(sgn * 2j * np.pi *
                np.outer(np.arange(n1), np.arange(n1)) / n1)
    f2 = np.exp(sgn * 2j * np.pi *
                np.outer(np.arange(n2), np.arange(n2)) / n2)
    tw = np.exp(sgn * 2j * np.pi *
                np.outer(np.arange(n1), np.arange(n2)) / (n1 * n2))
    cdt = np.complex128 if dtype_name == 'c128' else np.complex64
    out = tuple(m.astype(cdt) for m in (f1, f2, tw))
    _dft_cache[key] = out
    return out


_dft_device_cache = {}


def _dft_tensors(n1, n2, inverse, dtype_name, device):
    """:func:`_dft_matrices` as tensors on ``device`` (the first of the
    three transposed, as the four-step's first product takes it)."""
    import torch
    key = (n1, n2, inverse, dtype_name, str(device))
    hit = _dft_device_cache.get(key)
    if hit is None:
        f1, f2, tw = _dft_matrices(n1, n2, inverse, dtype_name)
        hit = _dft_device_cache[key] = tuple(
            torch.from_numpy(np.ascontiguousarray(m)).to(device)
            for m in (f1.T, f2, tw))
    return hit


def _mm(a, b, compute_dtype):
    """Complex matrix product; with ``compute_dtype='bf16'`` each real
    plane is rounded to bf16 first and the products accumulate in
    float32."""
    import torch
    if compute_dtype != 'bf16':
        return torch.matmul(a, b)

    def planes(m):
        return (m.real.to(torch.bfloat16).float(),
                m.imag.to(torch.bfloat16).float())
    ar, ai = planes(a)
    br, bi = planes(b)
    return torch.complex(torch.matmul(ar, br) - torch.matmul(ai, bi),
                         torch.matmul(ar, bi) + torch.matmul(ai, br))


def dft_matmul_fft(x, axis=-1, inverse=False, compute_dtype=None):
    """c2c FFT of complex tensor ``x`` along one axis as two matrix
    products (Cooley-Tukey four-step: N -> (N1, N2), DFT over N1,
    twiddle, DFT over N2), unnormalized in both directions as cuFFT is.
    A prime length is one DFT matrix product.  The products run without
    TF32; ``compute_dtype='bf16'`` rounds their operands to bf16 (about
    2-3 decimal digits)."""
    import torch
    from .linalg import full_f32
    n = x.shape[axis]
    n1, n2 = _split_factor(n)
    dtn = 'c128' if x.dtype == torch.complex128 else 'c64'
    acc = torch.complex128 if dtn == 'c128' else torch.complex64
    xm = x.movedim(axis, -1).to(acc)
    with full_f32():
        if n1 == 1:            # prime length: plain DFT matmul
            f1t = _dft_tensors(n, 1, inverse, dtn, x.device)[0]
            return _mm(xm, f1t, compute_dtype).movedim(-1, axis)
        f1t, f2, tw = _dft_tensors(n1, n2, inverse, dtn, x.device)
        shp = tuple(xm.shape[:-1])
        xm = xm.reshape(shp + (n1, n2))
        # DFT over the n1 axis, then the twiddle, then over the n2 axis
        y = _mm(xm.transpose(-1, -2), f1t, compute_dtype)   # (..., n2, n1)
        y = y.transpose(-1, -2) * tw
        y = _mm(y, f2, compute_dtype)                       # (..., n1, n2)
    # output index k = k2 * n1 + k1
    y = y.transpose(-1, -2).reshape(shp + (n,))
    return y.movedim(-1, axis)


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
