"""Hand-written CUDA kernels for single stages, with their plain PyTorch
versions.  The counterpart of ``bifrost_tpu/ops/pallas_kernels.py``.

K2, :func:`stokes_detect`, replaces ``pallas_kernels.stokes_detect``
(``pl.pallas_call`` at ``pallas_kernels.py:86``); its source is
``bifrost_tpu_torch/csrc/stokes.cu``, which states its bound on the H100
and what its design does about it.  On a CUDA tensor the wrapper
launches the kernel or raises; on a CPU tensor it runs
:func:`stokes_detect_plain`, which the CPU tests use and the chip smoke
run holds the kernel against.
"""

from __future__ import annotations

import ctypes

__all__ = ['stokes_detect', 'stokes_detect_plain', 'launches']

#: K2 kernel launches since import (or since a caller reset it)
launches = 0


def stokes_detect_plain(xr, xi, yr, yi):
    """Stokes I, Q, U, V of x = xr + i xi, y = yr + i yi: four (T, F)
    float32 planes -> (T, 4, F) float32 (reference math:
    blocks/detect.py stokes mode)."""
    import torch
    xx = xr * xr + xi * xi
    yy = yr * yr + yi * yi
    xyr = xr * yr + xi * yi          # Re(x conj(y))
    xyi = xi * yr - xr * yi          # Im(x conj(y))
    return torch.stack([xx + yy, xx - yy, 2.0 * xyr, -2.0 * xyi], dim=1)


def _check_planes(planes):
    import torch
    ref = planes[0]
    if ref.dim() != 2:
        raise ValueError("stokes_detect: planes must be (T, F), got %s"
                         % (tuple(ref.shape),))
    for p in planes:
        if p.dtype != torch.float32:
            raise ValueError("stokes_detect: planes must be float32, got %s"
                             % p.dtype)
        if p.shape != ref.shape or p.device != ref.device:
            raise ValueError("stokes_detect: planes differ in shape or "
                             "device")


def stokes_detect(xr, xi, yr, yi):
    """K2: Stokes detect of four (T, F) float32 planes -> (T, 4, F).

    The planes may be strided views (e.g. of ``torch.view_as_real`` of a
    complex tensor) as long as all four share one row stride and one
    element stride."""
    planes = (xr, xi, yr, yi)
    _check_planes(planes)
    if xr.device.type != 'cuda':
        return stokes_detect_plain(xr, xi, yr, yi)
    return _launch(planes)


def _launch(planes):
    global launches
    import torch
    from .. import _build
    xr = planes[0]
    strides = xr.stride()
    if any(p.stride() != strides for p in planes) or min(strides) < 1:
        raise ValueError("stokes_detect: the four planes must share "
                         "positive row and element strides, got %s"
                         % [p.stride() for p in planes])
    T, F = xr.shape
    out = torch.empty((T, 4, F), dtype=torch.float32, device=xr.device)
    lib = _build.load('stokes')
    fn = lib.bf_stokes_detect
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 4 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(*[ctypes.c_void_p(p.data_ptr()) for p in planes],
             ctypes.c_void_p(out.data_ptr()), T, F, strides[0], strides[1],
             _build.stream_ptr(xr.device))
    _build.check(lib, err, 'stokes_detect')
    launches += 1
    return out
