"""Fused spectrometer: ci8 unpack -> FFT -> Stokes -> frequency reduce.

K1 of the port: :func:`fused_spectrometer` replaces
``bifrost_tpu/ops/spectrometer.py:fused_spectrometer`` (``pl.pallas_call``
at ``:341``, kernel body ``_kernel`` at ``:168``), the whole-chain
kernel that ``stages.match_spectrometer`` substitutes for
FftStage -> DetectStage('stokes') -> ReduceStage('freq', r).  Its CUDA
source is ``bifrost_tpu_torch/csrc/spectrometer.cu``, which states its
bound on the H100 and what its design does about it.

The port computes what the TPU kernel computes, not how: there is no
4-step matmul split, so the JAX package's limit that rfactor divide the
radix split ``n1`` (``_choose_split``, a Mosaic layout constraint) does
not apply; rfactor need only divide nfft.

The wrapper picks one of the source's two kernels by nfft alone: the
radix-16 Stockham kernel from :data:`RADIX16_MIN_NFFT` (256) to
:data:`MAX_NFFT`, the in-place radix-2 kernel for nfft 4 to 128.
:data:`launches_by_path` counts each, and the telemetry counter
``kernel.fused_spectrometer.launches`` counts both (the fleet plane
carries it).  Neither kernel gives way to the other.

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU
tensor it runs :func:`spectrometer_plain` (``torch.fft.fft`` over the
unpacked samples, then Stokes and a sum), which the CPU tests use and
the chip smoke run holds the kernel against.  :func:`spectrometer_oracle`
is the float64 numpy reference; the kernel's gate, as the JAX package's
``choose_precision`` gate, is max|got - oracle| / max|oracle| < 1e-5.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..telemetry import counters as _counters

__all__ = ['fused_spectrometer', 'spectrometer_plain',
           'spectrometer_oracle', 'MAX_NFFT', 'RADIX16_MIN_NFFT',
           'launches', 'launches_by_path', 'kernel_path']

#: largest nfft the kernel takes: two pols of float2 in shared memory
#: (2 x 8192 x 8 B = 128 KB of the 227 KB a block may use)
MAX_NFFT = 8192

#: smallest nfft of the radix-16 Stockham kernel; nfft 4 to 128 take the
#: in-place radix-2 kernel
RADIX16_MIN_NFFT = 256

#: K1 kernel launches since import (or since a caller reset it)
launches = 0

#: K1 launches by kernel, 'radix16' and 'radix2' (reset in place)
launches_by_path = {'radix16': 0, 'radix2': 0}

_twiddles = {}


def _check(volt, nfft, rfactor):
    """(T, nfft) after the JAX package's shape checks."""
    if volt.dim() != 4:
        raise ValueError("expected (time, 2 pol, nfft, re/im) ci8 input")
    T, npol, n, two = volt.shape
    if npol != 2 or two != 2:
        raise ValueError("expected (time, 2 pol, nfft, re/im) ci8 input")
    if nfft is None:
        nfft = n
    if n != nfft:
        raise ValueError("nfft mismatch")
    if nfft < 4 or nfft & (nfft - 1):
        raise ValueError("fused spectrometer requires power-of-two nfft")
    if rfactor < 1 or nfft % rfactor:
        raise ValueError("rfactor must divide nfft")
    import torch
    if volt.dtype != torch.int8:
        raise ValueError("expected int8 ci8 voltages, got %s" % volt.dtype)
    return T, nfft


def fused_spectrometer(volt, nfft=None, rfactor=4):
    """ci8 dual-pol voltages -> reduced Stokes spectra.

    volt: (T, 2, nfft, 2) int8, the device representation of 'ci8'
    gulps (time, pol, fine_time, re/im).  Returns (T, 4, nfft // rfactor)
    float32 ordered [I, Q, U, V], the semantics of the stage chain
    FftStage -> DetectStage('stokes') -> ReduceStage('freq', rfactor)."""
    T, nfft = _check(volt, nfft, rfactor)
    if volt.device.type != 'cuda':
        return spectrometer_plain(volt, rfactor)
    return _launch(volt, T, nfft, rfactor)


def kernel_path(nfft):
    """The kernel that takes ``nfft``: 'radix16' or 'radix2'."""
    return 'radix16' if nfft >= RADIX16_MIN_NFFT else 'radix2'


def _twiddle(nfft, device):
    """exp(-2 pi i k / nfft), k < nfft, built in float64 and stored as
    interleaved float32 on ``device`` (cached)."""
    key = (nfft, str(device))
    tw = _twiddles.get(key)
    if tw is None:
        import torch
        w = np.exp(-2j * np.pi * np.arange(nfft) / nfft)
        host = np.stack([w.real, w.imag], axis=-1).astype(np.float32)
        tw = _twiddles[key] = torch.from_numpy(host).to(device)
    return tw


#: argument types of the C entry bf_spectrometer
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int,
                                     ctypes.c_void_p]


def _launch(volt, T, nfft, rfactor):
    global launches
    import torch
    from .. import _build
    if nfft > MAX_NFFT:
        raise ValueError("nfft %d exceeds the kernel's shared-memory limit "
                         "of %d" % (nfft, MAX_NFFT))
    if not volt.is_contiguous() or volt.data_ptr() % 4:
        raise ValueError("fused_spectrometer: voltages must be contiguous "
                         "and 4-byte aligned")
    out = torch.empty((T, 4, nfft // rfactor), dtype=torch.float32,
                      device=volt.device)
    tw = _twiddle(nfft, volt.device)
    path = kernel_path(nfft)
    lib, fn = _build.bind('spectrometer', 'bf_spectrometer', _ARGTYPES)
    err = fn(volt.data_ptr(), tw.data_ptr(), out.data_ptr(), T,
             nfft.bit_length() - 1, rfactor, int(path == 'radix16'),
             _build.stream_ptr(volt.device))
    _build.check(lib, err, 'fused_spectrometer')
    launches += 1
    launches_by_path[path] += 1
    _counters.inc('kernel.fused_spectrometer.launches')
    return out


def spectrometer_plain(volt, rfactor=4):
    """The plain PyTorch version of K1: unpack to complex64,
    ``torch.fft.fft`` over fine_time, Stokes, and a sum over groups of
    ``rfactor`` adjacent bins."""
    import torch
    v = volt.to(torch.float32)
    s = torch.fft.fft(torch.complex(v[..., 0], v[..., 1]), dim=-1)
    x, y = s[:, 0], s[:, 1]
    xx = x.real * x.real + x.imag * x.imag
    yy = y.real * y.real + y.imag * y.imag
    xyr = x.real * y.real + x.imag * y.imag
    xyi = x.imag * y.real - x.real * y.imag
    stokes = torch.stack([xx + yy, xx - yy, 2.0 * xyr, -2.0 * xyi], dim=1)
    T, four, nf = stokes.shape
    return stokes.reshape(T, 4, nf // rfactor, rfactor).sum(-1)


def spectrometer_oracle(volt, rfactor=4):
    """float64 numpy reference of the fused kernel (testing): ``volt`` is
    a (T, 2, nfft, 2) int8 numpy array."""
    v = volt[..., 0].astype(np.float64) + 1j * volt[..., 1]
    s = np.fft.fft(v, axis=-1)
    x, y = s[:, 0], s[:, 1]
    xy = x * np.conj(y)
    stokes = np.stack([np.abs(x) ** 2 + np.abs(y) ** 2,
                       np.abs(x) ** 2 - np.abs(y) ** 2,
                       2 * xy.real, -2 * xy.imag], axis=1)
    T, four, nf = stokes.shape
    return stokes.reshape(T, 4, nf // rfactor, rfactor).sum(-1)
