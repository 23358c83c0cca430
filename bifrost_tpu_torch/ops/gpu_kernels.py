"""Hand-written CUDA kernels for single stages, with their plain PyTorch
versions.  The counterpart of ``bifrost_tpu/ops/pallas_kernels.py``.

- K2, :func:`stokes_detect`, replaces ``pallas_kernels.stokes_detect``
  (``pl.pallas_call`` at ``pallas_kernels.py:86``); its source is
  ``bifrost_tpu_torch/csrc/stokes.cu``.
- K4, :func:`beamform_int8`, K5, :func:`beamform_bf16`, and K6,
  :func:`beamform_detect_int8`, replace the beamformer kernels of the
  same names (``pl.pallas_call`` at ``pallas_kernels.py:265``, ``:307``
  and ``:384``); their source is ``bifrost_tpu_torch/csrc/beamform.cu``.
- K0, :func:`probe` behind :func:`available`, replaces the capability
  probe ``pallas_kernels.available`` (``pl.pallas_call`` at ``:40``);
  its source is ``bifrost_tpu_torch/csrc/probe.cu``.
- K7, :func:`xcorr_herm`, and K8, :func:`xcorr_cross`, replace the
  correlation kernels of the same names (``pl.pallas_call`` at
  ``pallas_kernels.py:155`` and ``:199``); their source is
  ``bifrost_tpu_torch/csrc/xcorr.cu``.
- K3, :func:`fdmt_step`, replaces the FDMT merge-step kernel
  ``pallas_kernels.fdmt_step`` (``pl.pallas_call`` at ``:459``); its
  source is ``bifrost_tpu_torch/csrc/fdmt.cu``.
- K9, :func:`ring_permute`, replaces the corner turn's ring hop
  ``pallas_kernels.ring_permute`` (``pl.pallas_call`` at ``:504``); its
  source is ``bifrost_tpu_torch/csrc/ring_permute.cu``.

Each source states its kernels' bounds on the H100 and what their design
does about them.  On a CUDA tensor a wrapper launches its kernel or
raises; on a CPU tensor it runs the ``*_plain`` version beside it, which
the CPU tests use and the chip smoke run holds the kernel against.
:data:`launches` counts each wrapper's kernel launches.  Every wrapper
calls its C entry through :func:`_fn`, which binds it once
(``_build.bind``), with pointers and the stream handle as plain ints.
"""

from __future__ import annotations

import contextlib
import ctypes
import os

from .. import _build

__all__ = ['stokes_detect', 'stokes_detect_plain', 'beamform_int8',
           'beamform_int8_plain', 'int8_staging', 'beamform_bf16',
           'beamform_bf16_plain', 'bf16_staging', 'beamform_detect_int8',
           'beamform_detect_int8_plain', 'detect_path', 'probe',
           'available', 'enabled', 'xcorr_herm', 'xcorr_herm_plain',
           'xcorr_staging', 'xcorr_cross', 'xcorr_cross_plain',
           'xcorr_cross_plan', 'smem_optin', 'fdmt_step',
           'fdmt_step_plain', 'ring_permute', 'ring_permute_plain',
           'MAX_NSTAND', 'MAX_NTIME', 'launches']

#: kernel launches per wrapper since import (or since a caller reset them)
#: (``beamform_int8_vec16``, ``beamform_bf16_vec16`` and
#: ``xcorr_herm_vec16`` count the K4, K5 and K7 launches that took the
#: 16-byte staging path, subsets of ``beamform_int8``, ``beamform_bf16``
#: and ``xcorr_herm``; ``xcorr_cross_vec16_i`` and ``xcorr_cross_vec16_j``
#: the K8 launches whose rows, or columns, took it, and
#: ``xcorr_cross_rowblock`` those whose jobs were row blocks
#: (:func:`xcorr_cross_plan`), subsets of ``xcorr_cross``;
#: ``beamform_detect_int8_mma`` the K6 launches that took its tensor-core
#: kernel (:func:`detect_path`), a subset of ``beamform_detect_int8``)
launches = {'stokes_detect': 0, 'beamform_int8': 0,
            'beamform_int8_vec16': 0, 'beamform_bf16': 0,
            'beamform_bf16_vec16': 0, 'beamform_detect_int8': 0,
            'beamform_detect_int8_mma': 0, 'probe': 0,
            'xcorr_herm': 0, 'xcorr_herm_vec16': 0, 'xcorr_cross': 0,
            'xcorr_cross_vec16_i': 0, 'xcorr_cross_vec16_j': 0,
            'xcorr_cross_rowblock': 0, 'fdmt_step': 0, 'ring_permute': 0}

#: most stations the int8 beamform kernels take: the int32 sum of
#: 2 * S products of int8 values, each at most 128 * 128, stays exact
MAX_NSTAND = (2 ** 31 - 1) // (2 * 128 * 128)

#: most stations of K6's tensor-core path: its two resident weight
#: panels (4 x 64 columns of S rounded up to 64 stations, plus 32 bytes)
#: beside its 48 KB cp.async ring and the beam sums fit the 227 KB of
#: shared memory a block may take on the H100 (``bytes`` of
#: ``bf_beamform_detect_int8_mma``)
DETECT_MMA_MAX_NSTAND = 640

#: most frames the correlation kernels sum: re = sum of 2 * T products of
#: int8 values, each at most 128 * 128, stays exact in int32
MAX_NTIME = MAX_NSTAND


def _fn(lib_name, fn_name, argtypes):
    """``(lib, fn)``: the C entry, bound once (``_build.bind``)."""
    return _build.bind(lib_name, fn_name, argtypes)


_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
#: argument types of each C entry
_STOKES_ARGS = [_P] * 5 + [_L] * 4 + [_P]
_INT8_ARGS = [_P] * 6 + [_I] * 6 + [_L] * 3 + [_P]
_BF16_ARGS = [_P] * 6 + [_I] * 7 + [_L] * 3 + [_P]
_DETECT_ARGS = [_P] * 6 + [_F] + [_I] * 5 + [_L] * 2 + [_P]
_PROBE_ARGS = [_P, _P, _I, _P]
_HERM_ARGS = [_P] * 3 + [_I] * 5 + [_L] * 4 + [_P]
_CROSS_ARGS = [_P] * 5 + [_I] * 8 + [_L] * 8 + [_P]
_SMEM_ARGS = [_I]
_FDMT_ARGS = [_P] * 5 + [_L] + [_I] * 4 + [_L, _I, _P]
_RING_ARGS = [_P, _P, _I, _L, _P]
_PEER_ARGS = [_I, _I]


# ---------------------------------------------------------------------------
# K2: Stokes detect
# ---------------------------------------------------------------------------

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
    return _launch_stokes(planes)


def _launch_stokes(planes):
    import torch
    xr = planes[0]
    strides = xr.stride()
    if any(p.stride() != strides for p in planes) or min(strides) < 1:
        raise ValueError("stokes_detect: the four planes must share "
                         "positive row and element strides, got %s"
                         % [p.stride() for p in planes])
    T, F = xr.shape
    out = torch.empty((T, 4, F), dtype=torch.float32, device=xr.device)
    lib, fn = _fn('stokes', 'bf_stokes_detect', _STOKES_ARGS)
    err = fn(*[p.data_ptr() for p in planes], out.data_ptr(), T, F,
             strides[0], strides[1], _build.stream_ptr(xr.device))
    _build.check(lib, err, 'stokes_detect')
    launches['stokes_detect'] += 1
    return out


# ---------------------------------------------------------------------------
# K4, K5: per-pol beamform of (T, F, S) voltage planes against (B, S)
# weight planes
# ---------------------------------------------------------------------------

def _dot(a, w):
    """(T, F, S) x (B, S) -> (T, F, B) in the dtype of the operands."""
    import torch
    return torch.einsum('tfs,bs->tfb', a, w)


def beamform_int8_plain(wr, wi, re, im):
    """The plain version of K4: the four dots in float64, exact while
    every partial sum stays below 2^53, cast to int32."""
    import torch
    d = torch.float64
    r, i, a, c = re.to(d), im.to(d), wr.to(d), wi.to(d)
    return ((_dot(r, a) - _dot(i, c)).to(torch.int32),
            (_dot(r, c) + _dot(i, a)).to(torch.int32))


def beamform_bf16_plain(wr, wi, re, im):
    """The plain version of K5: voltages and weights rounded to bf16
    (round to nearest even), the four dots in float32 (exact products of
    bf16 values, float32 sums)."""
    import torch
    r, i, a, c = (v.to(torch.bfloat16).float() for v in (re, im, wr, wi))
    return _dot(r, a) - _dot(i, c), _dot(r, c) + _dot(i, a)


def _check_beamform(wr, wi, re, im, wdtypes, vdtypes, what):
    if wr.dim() != 2 or wi.shape != wr.shape:
        raise ValueError("%s: weights must be two (B, S) planes, got %s "
                         "and %s" % (what, tuple(wr.shape),
                                     tuple(wi.shape)))
    if re.dim() != 3 or im.shape != re.shape:
        raise ValueError("%s: voltages must be two (T, F, S) planes, got "
                         "%s and %s" % (what, tuple(re.shape),
                                        tuple(im.shape)))
    if re.shape[2] != wr.shape[1]:
        raise ValueError("%s: %d stations in the voltages, %d in the "
                         "weights" % (what, re.shape[2], wr.shape[1]))
    if wr.dtype not in wdtypes or wi.dtype != wr.dtype:
        raise ValueError("%s: weights must be %s, got %s and %s"
                         % (what, wdtypes, wr.dtype, wi.dtype))
    if re.dtype not in vdtypes or im.dtype != re.dtype:
        raise ValueError("%s: voltages must be %s, got %s and %s"
                         % (what, vdtypes, re.dtype, im.dtype))
    devs = {t.device for t in (wr, wi, re, im)}
    if len(devs) != 1:
        raise ValueError("%s: operands on different devices: %s"
                         % (what, sorted(str(d) for d in devs)))


def _voltage_strides(re, im, what):
    if re.stride() != im.stride() or min(re.stride()) < 1:
        raise ValueError("%s: the voltage planes must share positive "
                         "strides, got %s and %s"
                         % (what, re.stride(), im.stride()))
    return re.stride()


def beamform_int8(wr, wi, re, im):
    """K4: int8 weights (B, S) and int8 voltage planes (T, F, S) ->
    (yr, yi), two (T, F, B) int32 planes with yr = re.wr^T - im.wi^T and
    yi = re.wi^T + im.wr^T per channel, exact for every int8 value, as one
    int8 tensor-core GEMM over every channel.

    The voltage planes may be strided views sharing one set of strides
    (the per-pol views of a ci8 gulp); they are read in place, the
    per-pol views of a ci8 gulp through 16-byte copies
    (:func:`int8_staging`)."""
    import torch
    _check_beamform(wr, wi, re, im, (torch.int8,), (torch.int8,),
                    'beamform_int8')
    if re.device.type != 'cuda':
        return beamform_int8_plain(wr, wi, re, im)
    T, F, S = re.shape
    B = wr.shape[0]
    if S > MAX_NSTAND:
        raise ValueError("beamform_int8: %d stations could overflow the "
                         "int32 sum (at most %d)" % (S, MAX_NSTAND))
    st, sf, ss = _voltage_strides(re, im, 'beamform_int8')
    vec, poff = int8_staging(re, im)
    wr, wi = wr.contiguous(), wi.contiguous()
    yr = torch.empty((T, F, B), dtype=torch.int32, device=re.device)
    yi = torch.empty_like(yr)
    lib, fn = _fn('beamform', 'bf_beamform_int8', _INT8_ARGS)
    err = fn(wr.data_ptr(), wi.data_ptr(), re.data_ptr(), im.data_ptr(),
             yr.data_ptr(), yi.data_ptr(), vec, poff, T, F, S, B, st, sf, ss,
             _build.stream_ptr(re.device))
    _build.check(lib, err, 'beamform_int8')
    launches['beamform_int8'] += 1
    if vec:
        launches['beamform_int8_vec16'] += 1
    return yr, yi


def int8_staging(re, im):
    """``(vec, poff)`` of K4's 16-byte staging for the int8 voltage
    planes ``re``, ``im``, or ``(0, 0)`` for its scalar staging.  The
    16-byte path takes the interleaved int8 layout of a ci8 gulp's per-pol
    views: ``im`` one byte after ``re``, a station stride ``vec`` of 2 or 4
    bytes with the pair at byte ``poff`` of it (pol 1 of a dual-pol gulp
    starts 2 bytes into the row), rows that start on 16 bytes, and
    ``S * vec`` a multiple of 16.  Both paths run the same tensor-core
    kernel; they differ only in how a chunk reaches shared memory."""
    st, sf, ss = re.stride()
    poff = re.data_ptr() % 16
    if ss not in (2, 4) or im.data_ptr() != re.data_ptr() + 1 or \
            poff + 2 > ss or st % 16 or sf % 16 or (re.shape[2] * ss) % 16:
        return 0, 0
    return ss, poff


def bf16_staging(re, im):
    """``(vec, poff)`` of K5's 16-byte staging for the voltage planes
    ``re``, ``im``, or ``(0, 0)`` for its scalar staging: the layout rule
    of :func:`int8_staging`, for int8 voltages only (float32 voltages take
    the scalar staging)."""
    import torch
    if re.dtype != torch.int8:
        return 0, 0
    return int8_staging(re, im)


def beamform_bf16(wr, wi, re, im):
    """K5: float32 weights (B, S) and int8 or float32 voltage planes
    (T, F, S) -> (yr, yi), two (T, F, B) float32 planes: the four dots
    of :func:`beamform_int8` on bf16-rounded operands with float32
    accumulation, as one GEMM over every channel.  Strided voltage planes
    are read in place; the per-pol views of a ci8 gulp through 16-byte
    loads (:func:`bf16_staging`)."""
    import torch
    _check_beamform(wr, wi, re, im, (torch.float32,),
                    (torch.int8, torch.float32), 'beamform_bf16')
    if re.device.type != 'cuda':
        return beamform_bf16_plain(wr, wi, re, im)
    T, F, S = re.shape
    B = wr.shape[0]
    st, sf, ss = _voltage_strides(re, im, 'beamform_bf16')
    vec, poff = bf16_staging(re, im)
    wr, wi = wr.contiguous(), wi.contiguous()
    yr = torch.empty((T, F, B), dtype=torch.float32, device=re.device)
    yi = torch.empty_like(yr)
    lib, fn = _fn('beamform', 'bf_beamform_bf16', _BF16_ARGS)
    err = fn(wr.data_ptr(), wi.data_ptr(), re.data_ptr(), im.data_ptr(),
             yr.data_ptr(), yi.data_ptr(),
             0 if re.dtype == torch.int8 else 1, vec, poff, T, F, S, B,
             st, sf, ss, _build.stream_ptr(re.device))
    _build.check(lib, err, 'beamform_bf16')
    launches['beamform_bf16'] += 1
    if vec:
        launches['beamform_bf16_vec16'] += 1
    return yr, yi


# ---------------------------------------------------------------------------
# K6: dual-pol int8 beamform -> Stokes -> sum of R frames
# ---------------------------------------------------------------------------

def beamform_detect_int8_plain(wxr, wxi, wyr, wyi, x, scale, rfactor):
    """The plain version of K6, step for step: the exact int32 beams of
    each pol (:func:`beamform_int8_plain`), to float32, times ``scale``,
    Stokes I, Q, U, V, and the sum of each group of ``rfactor`` frames
    taken in frame order."""
    import torch
    scale = float(scale)

    def beam(p, wr, wi):
        yr, yi = beamform_int8_plain(wr, wi, x[:, :, :, p, 0],
                                     x[:, :, :, p, 1])
        return yr.float() * scale, yi.float() * scale

    bxr, bxi = beam(0, wxr, wxi)
    byr, byi = beam(1, wyr, wyi)
    xx = bxr * bxr + bxi * bxi
    yy = byr * byr + byi * byi
    xyr = bxr * byr + bxi * byi           # Re(x conj(y))
    xyi = bxi * byr - bxr * byi           # Im(x conj(y))
    st = torch.stack([xx + yy, xx - yy, 2.0 * xyr, -2.0 * xyi], dim=2)
    T = st.shape[0]
    st = st.reshape((T // rfactor, rfactor) + st.shape[1:])
    out = st[:, 0]
    for r in range(1, rfactor):
        out = out + st[:, r]
    return out


def _check_detect(weights, x, rfactor):
    import torch
    wxr = weights[0]
    if x.dim() != 5 or tuple(x.shape[3:]) != (2, 2):
        raise ValueError("beamform_detect_int8: expected a (T, F, S, 2 pol,"
                         " 2 re/im) gulp, got %s" % (tuple(x.shape),))
    if x.dtype != torch.int8:
        raise ValueError("beamform_detect_int8: expected int8 voltages, "
                         "got %s" % x.dtype)
    for w in weights:
        if w.dtype != torch.int8 or w.shape != wxr.shape or w.dim() != 2:
            raise ValueError("beamform_detect_int8: weights must be four "
                             "(B, S) int8 planes")
        if w.device != x.device:
            raise ValueError("beamform_detect_int8: weights on %s, "
                             "voltages on %s" % (w.device, x.device))
    if wxr.shape[1] != x.shape[2]:
        raise ValueError("beamform_detect_int8: %d stations in the "
                         "voltages, %d in the weights"
                         % (x.shape[2], wxr.shape[1]))
    if rfactor < 1 or x.shape[0] % rfactor:
        raise ValueError("rfactor %d does not divide T=%d"
                         % (rfactor, x.shape[0]))


def beamform_detect_int8(wxr, wxi, wyr, wyi, x, scale, rfactor):
    """K6: the ci8 gulp ``x`` (T, F, S, 2 pol, 2 re/im) int8, beamformed
    per pol against the (B, S) int8 weight planes of X (``wxr``,
    ``wxi``) and Y (``wyr``, ``wyi``), times ``scale``, Stokes-detected
    and summed over groups of ``rfactor`` frames -> (T // rfactor, F, 4,
    B) float32 ordered [I, Q, U, V].  The beam voltages never reach
    device memory.  One launch, of the kernel :func:`detect_path`
    names."""
    import torch
    weights = (wxr, wxi, wyr, wyi)
    _check_detect(weights, x, rfactor)
    if x.device.type != 'cuda':
        return beamform_detect_int8_plain(wxr, wxi, wyr, wyi, x, scale,
                                          rfactor)
    T, F, S = x.shape[:3]
    B = wxr.shape[0]
    if S > MAX_NSTAND:
        raise ValueError("beamform_detect_int8: %d stations could overflow"
                         " the int32 sum (at most %d)" % (S, MAX_NSTAND))
    st, sf = x.stride()[:2]
    if tuple(x.stride()[2:]) != (4, 2, 1) or st % 4 or sf % 4 or \
            x.data_ptr() % 4:
        raise ValueError("beamform_detect_int8: the (S, 2, 2) axes must be "
                         "contiguous and rows 4-byte aligned, got strides "
                         "%s" % (x.stride(),))
    weights = [w.contiguous() for w in weights]
    out = torch.empty((T // rfactor, F, 4, B), dtype=torch.float32,
                      device=x.device)
    path = detect_path(x, rfactor)
    entry = 'bf_beamform_detect_int8' + ('_mma' if path == 'mma' else '')
    lib, fn = _fn('beamform', entry, _DETECT_ARGS)
    err = fn(*[w.data_ptr() for w in weights], x.data_ptr(), out.data_ptr(),
             float(scale), T, F, S, B, rfactor, st, sf,
             _build.stream_ptr(x.device))
    _build.check(lib, err, 'beamform_detect_int8')
    launches['beamform_detect_int8'] += 1
    if path == 'mma':
        launches['beamform_detect_int8_mma'] += 1
    return out


def detect_path(x, rfactor):
    """The kernel that K6 runs for the ci8 gulp ``x`` (T, F, S, 2, 2) at
    ``rfactor``: ``'mma'``, its int8 tensor-core kernel, where
    ``rfactor`` divides 16, the gulp's rows start on 16 bytes (its base
    and its frame and channel strides), ``S`` is a positive multiple of 4
    and at most :data:`DETECT_MMA_MAX_NSTAND`; else ``'dp4a'``, its
    ``__dp4a`` kernel (an ``rfactor`` of 32 or more, or not a divisor of
    16, an odd layout, too many stations).  Both give the same bits."""
    S = x.shape[2]
    st, sf = x.stride()[:2]
    if 16 % rfactor or x.data_ptr() % 16 or st % 16 or sf % 16 or \
            S <= 0 or S % 4 or S > DETECT_MMA_MAX_NSTAND:
        return 'dp4a'
    return 'mma'


# ---------------------------------------------------------------------------
# K0: the capability probe
# ---------------------------------------------------------------------------

#: devices on which the probe passed (the answer is cached per device)
_available_on = set()


def probe(x):
    """K0: ``x * 2`` of a float32 tensor, on the card by the probe kernel
    (its plain version on the CPU)."""
    import torch
    if x.dtype != torch.float32:
        raise ValueError("probe: expected float32, got %s" % x.dtype)
    dev = x.device
    if dev.type != 'cuda':
        return x * 2
    if not x.is_contiguous():
        x = x.contiguous()
    out = torch.empty_like(x)
    lib, fn = _fn('probe', 'bf_probe', _PROBE_ARGS)
    err = fn(x.data_ptr(), out.data_ptr(), x.numel(), _build.stream_ptr(dev))
    _build.check(lib, err, 'probe')
    launches['probe'] += 1
    return out


def available(device=None):
    """True when the port's CUDA kernels build and run on ``device`` (the
    process's device when None): the meaning of
    ``pallas_kernels.available``.  False off the card.  On the card it
    builds and loads every library of ``_build.SOURCES``, runs the probe
    kernel's ``x * 2`` on an (8, 128) float32 tile and checks the sum,
    once per device; a failed build, load or check raises, and never
    reads as False, which would quietly drop the kernels from every
    race."""
    import torch
    if device is None:
        from ..device import get_device
        device = get_device()
    device = torch.device(device)
    if device.type != 'cuda':
        return False
    if device.index is None:
        device = torch.device('cuda', torch.cuda.current_device())
    if device in _available_on:
        return True
    _build.build()
    for name in _build.SOURCES:
        _build.load(name)
    x = torch.ones((8, 128), dtype=torch.float32, device=device)
    total = float(probe(x).sum())
    if abs(total - 2 * 8 * 128) >= 1e-3:
        raise RuntimeError("available: the probe kernel on %s summed to %r,"
                           " not %d" % (device, total, 2 * 8 * 128))
    _available_on.add(device)
    return True


def enabled(device=None):
    """``BF_USE_PALLAS`` set and :func:`available` (the JAX rule)."""
    flag = os.environ.get('BF_USE_PALLAS', '').strip().lower()
    return flag in ('1', 'true', 'yes', 'on') and available(device)


# ---------------------------------------------------------------------------
# K7, K8: int8 correlation, vis = sum_t x_i conj(x_j), exact int32
# ---------------------------------------------------------------------------

def xcorr_cross_plain(re_i, im_i, re_j, im_j):
    """The plain version of K8 (and of K7 with i = j): the four dots
    over time in int64 on the CPU, in float64 on the card (exact while
    every partial sum stays below 2^53), then re = rr + ii, im = ir - ri
    cast to float32 -> complex64 (..., F, n_i, n_j)."""
    import torch
    d = torch.int64 if re_i.device.type == 'cpu' else torch.float64
    ri, ii, rj, ij = (v.to(d) for v in (re_i, im_i, re_j, im_j))
    dot = lambda x, y: torch.einsum('...tfa,...tfb->...fab', x, y)
    return torch.complex((dot(ri, rj) + dot(ii, ij)).float(),
                         (dot(ii, rj) - dot(ri, ij)).float())


def xcorr_herm_plain(re, im):
    """The plain version of K7: :func:`xcorr_cross_plain` of the planes
    against themselves (im = K - K^T with K = im^T re)."""
    return xcorr_cross_plain(re, im, re, im)


def _check_xcorr(re, im, what):
    import torch
    if re.dim() not in (3, 4) or im.shape != re.shape:
        raise ValueError("%s: voltages must be two (T, F, n) or (g, T, F, n)"
                         " planes, got %s and %s"
                         % (what, tuple(re.shape), tuple(im.shape)))
    if re.dtype != torch.int8 or im.dtype != torch.int8:
        raise ValueError("%s: voltages must be int8, got %s and %s"
                         % (what, re.dtype, im.dtype))
    if re.device != im.device:
        raise ValueError("%s: planes on %s and %s"
                         % (what, re.device, im.device))
    if re.shape[-3] > MAX_NTIME:
        raise ValueError("%s: %d frames could overflow the int32 sum (at "
                         "most %d)" % (what, re.shape[-3], MAX_NTIME))


def _group_strides(x, what):
    """(sg, st, sf, sn) of (T, F, n) or (g, T, F, n) planes."""
    s = x.stride()
    if min(s) < 1:
        raise ValueError("%s: the planes must have positive strides, got %s"
                         % (what, s))
    return s if x.dim() == 4 else (0,) + s


def _share_strides(re, im, what):
    if re.stride() != im.stride():
        raise ValueError("%s: re and im planes must share strides, got %s "
                         "and %s" % (what, re.stride(), im.stride()))


def _xcorr_out(re_i, nj):
    """The (.., F, n_i, n_j, 2) float32 output of a correlation launch."""
    import torch
    return torch.empty(tuple(re_i.shape[:-3]) + re_i.shape[-2:] + (nj, 2),
                       dtype=torch.float32, device=re_i.device)


def xcorr_staging(re, im):
    """1 where K7 stages the planes ``re``, ``im`` through 16-byte copies
    (and K8 each operand's), else 0 (the scalar staging): the interleaved
    layout of a ci8 gulp's re and im views, element stride 2 with ``im``
    one byte after ``re``, rows (frames, channels and groups) on 16 bytes,
    and ``n * 2`` a multiple of 16.  Both paths run the same tensor-core
    kernel; they differ only in how the inputs reach shared memory."""
    s = re.stride()
    n = re.shape[-1]
    if s[-1] != 2 or im.data_ptr() != re.data_ptr() + 1 or \
            re.data_ptr() % 16 or any(v % 16 for v in s[:-1]) or (2 * n) % 16:
        return 0
    return 1


def xcorr_herm(re, im):
    """K7: the Hermitian int8 auto-correlation of voltage planes (T, F, n)
    -> (F, n, n) complex64, vis[f, a, b] = sum_t x[t, f, a] conj(x[t, f,
    b]), exact.  Planes (g, T, F, n) give (g, F, n, n) in one launch: the
    X step's groups of a gulp.  Strided planes (the re and im views of a
    ci8 gulp) are read in place, the interleaved views through 16-byte
    copies (:func:`xcorr_staging`); the full matrix is written."""
    import torch
    _check_xcorr(re, im, 'xcorr_herm')
    if re.device.type != 'cuda':
        return xcorr_herm_plain(re, im)
    _share_strides(re, im, 'xcorr_herm')
    sg, st, sf, sn = _group_strides(re, 'xcorr_herm')
    g = re.shape[0] if re.dim() == 4 else 1
    T, F, n = re.shape[-3:]
    out = _xcorr_out(re, n)
    if T == 0:
        return torch.view_as_complex(out.zero_())
    vec = xcorr_staging(re, im)
    lib, fn = _fn('xcorr', 'bf_xcorr_herm', _HERM_ARGS)
    err = fn(re.data_ptr(), im.data_ptr(), out.data_ptr(), vec, g, T, F, n,
             sg, st, sf, sn, _build.stream_ptr(re.device))
    _build.check(lib, err, 'xcorr_herm')
    launches['xcorr_herm'] += 1
    if vec:
        launches['xcorr_herm_vec16'] += 1
    return torch.view_as_complex(out)


#: K7's and K8's tile side, finished-tile slots (each 64 rows of 65
#: float2) and frames a chunk, as ``csrc/xcorr.cu`` has them
XCORR_TILE, XCORR_SLOT_BYTES, XCORR_CHUNK = 64, 2 * 64 * 65 * 8, 256


def xcorr_cross_plan(T, n_i, n_j, smem):
    """``(rowblock, nbytes, njobs)`` of a K8 launch on ``T`` frames of
    ``n_i`` rows against ``n_j`` columns, on a card whose blocks may opt in
    to ``smem`` bytes of shared memory: ``rowblock`` 1 where a job, one
    64-input row block of a channel staged beside all the channel's
    columns (T rounded up to 32 frames, 2 bytes an input), fits beside the
    two finished-tile slots, else 0 (a job is one tile, staged in frame
    chunks of at most 256 into two buffers); ``nbytes`` the launch's
    dynamic shared memory; ``njobs`` its jobs per (group, channel), one a
    row block or one a tile.  The C entry sizes its launch the same way
    and refuses a row-block launch that does not fit."""
    tall = -(-T // 32) * 32
    nti, ntj = -(-n_i // XCORR_TILE), -(-n_j // XCORR_TILE)
    rowblock = XCORR_SLOT_BYTES + tall * XCORR_TILE * (1 + ntj) * 2
    if rowblock <= smem:
        return 1, rowblock, nti
    tch = min(tall, XCORR_CHUNK)
    return 0, XCORR_SLOT_BYTES + 2 * tch * 2 * XCORR_TILE * 2, nti * ntj


#: the shared memory a block may opt in to, by CUDA device index
_smem_by_device = {}


def smem_optin(device):
    """The shared memory a block may opt in to on CUDA ``device`` (read
    once per device through ``bf_xcorr_smem``): what
    :func:`xcorr_cross_plan` sizes K8's jobs by."""
    import torch
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    got = _smem_by_device.get(index)
    if got is None:
        lib, fn = _fn('xcorr', 'bf_xcorr_smem', _SMEM_ARGS)
        got = fn(index)
        if got < 0:
            _build.check(lib, -got, 'xcorr_cross')
        _smem_by_device[index] = got
    return got


def xcorr_cross(re_i, im_i, re_j, im_j):
    """K8: the int8 cross-correlation of planes (T, F, n_i) against (T, F,
    n_j) -> (F, n_i, n_j) complex64, vis[f, a, b] = sum_t x_i[t, f, a]
    conj(x_j[t, f, b]), exact (with a leading group axis, as
    :func:`xcorr_herm`).  K7's tensor-core kernel on the rectangle: rows
    and columns each staged through 16-byte copies where
    :func:`xcorr_staging` accepts their planes, and a job a row block
    beside all the channel's columns where :func:`xcorr_cross_plan` says
    it fits, else a tile."""
    import torch
    _check_xcorr(re_i, im_i, 'xcorr_cross')
    _check_xcorr(re_j, im_j, 'xcorr_cross')
    if re_i.shape[:-1] != re_j.shape[:-1] or re_i.device != re_j.device:
        raise ValueError("xcorr_cross: the i planes %s on %s and the j "
                         "planes %s on %s differ in frames, channels or "
                         "device" % (tuple(re_i.shape), re_i.device,
                                     tuple(re_j.shape), re_j.device))
    if re_i.device.type != 'cuda':
        return xcorr_cross_plain(re_i, im_i, re_j, im_j)
    _share_strides(re_i, im_i, 'xcorr_cross')
    _share_strides(re_j, im_j, 'xcorr_cross')
    si = _group_strides(re_i, 'xcorr_cross')
    sj = _group_strides(re_j, 'xcorr_cross')
    g = re_i.shape[0] if re_i.dim() == 4 else 1
    T, F, ni = re_i.shape[-3:]
    nj = re_j.shape[-1]
    out = _xcorr_out(re_i, nj)
    if T == 0:
        return torch.view_as_complex(out.zero_())
    vec_i, vec_j = xcorr_staging(re_i, im_i), xcorr_staging(re_j, im_j)
    rowblock = xcorr_cross_plan(T, ni, nj, smem_optin(re_i.device))[0]
    lib, fn = _fn('xcorr', 'bf_xcorr_cross', _CROSS_ARGS)
    err = fn(re_i.data_ptr(), im_i.data_ptr(), re_j.data_ptr(),
             im_j.data_ptr(), out.data_ptr(), vec_i, vec_j, rowblock, g, T,
             F, ni, nj, *si, *sj, _build.stream_ptr(re_i.device))
    _build.check(lib, err, 'xcorr_cross')
    launches['xcorr_cross'] += 1
    launches['xcorr_cross_vec16_i'] += vec_i
    launches['xcorr_cross_vec16_j'] += vec_j
    launches['xcorr_cross_rowblock'] += rowblock
    return torch.view_as_complex(out)


# ---------------------------------------------------------------------------
# K3: one FDMT merge step
# ---------------------------------------------------------------------------

def fdmt_step_plain(state, d1, d2, passthrough, sgn):
    """The plain version of K3, the FDMT merge step of the Pallas kernel
    (``pallas_kernels.fdmt_step``): for output subband s and delay d,
    ``out[.., s, d, t] = lo[t] + (hi[t + sgn * d1[s, d]] if 0 <= t + sgn *
    d1[s, d] < T else 0)`` with ``lo = state[.., 2s, d1[s, d]]`` and
    ``hi = state[.., min(2s + 1, nchan_cur - 1), d2[s, d]]``; a
    passthrough subband copies ``lo``.  ``state`` is (nchan_cur, nd_cur,
    T) or (B, nchan_cur, nd_cur, T), any float type; the tables may lie on
    any device.  One add per element, as the kernel does."""
    import torch
    nchan_cur, nd_cur, T = state.shape[-3:]
    dev = state.device
    d1 = d1.to(dev, torch.int64)
    d2 = d2.to(dev, torch.int64)
    pt = passthrough.to(dev).bool()
    nout = d1.shape[0]
    lo_rows = torch.arange(nout, device=dev) * 2
    hi_rows = torch.clamp(lo_rows + 1, max=nchan_cur - 1)
    a = state[..., lo_rows[:, None], d1, :]           # (.., nout, nd_out, T)
    hi = state[..., hi_rows[:, None], d2, :]
    ts = torch.arange(T, device=dev) + sgn * d1[:, :, None]
    ok = (ts >= 0) & (ts < T)
    b = torch.gather(hi, -1, ts.clamp(0, T - 1).expand(hi.shape))
    b = torch.where(ok, b, b.new_zeros(()))
    return torch.where(pt[:, None, None], a, a + b)


def _check_fdmt(state, d1, d2, passthrough, sgn):
    import torch
    if state.dim() not in (3, 4):
        raise ValueError("fdmt_step: state must be (nchan, nd, T) or (B, "
                         "nchan, nd, T), got %s" % (tuple(state.shape),))
    if state.dtype != torch.float32:
        raise ValueError("fdmt_step: state must be float32, got %s"
                         % state.dtype)
    if not state.is_contiguous():
        raise ValueError("fdmt_step: state must be contiguous, got strides "
                         "%s" % (state.stride(),))
    nchan_cur, _, T = state.shape[-3:]
    if T == 0:
        raise ValueError("fdmt_step: the state holds no frames (T = 0)")
    if sgn not in (1, -1):
        raise ValueError("fdmt_step: sgn must be +1 or -1, got %r" % (sgn,))
    if d1.dim() != 2 or d2.shape != d1.shape or passthrough.dim() != 1 or \
            passthrough.shape[0] != d1.shape[0]:
        raise ValueError("fdmt_step: tables must be d1, d2 (nout, nd_out) "
                         "and passthrough (nout,), got %s, %s, %s"
                         % (tuple(d1.shape), tuple(d2.shape),
                            tuple(passthrough.shape)))
    if d1.shape[0] != (nchan_cur + 1) // 2:
        raise ValueError("fdmt_step: %d output subbands for %d input "
                         "subbands" % (d1.shape[0], nchan_cur))
    for name, t in (('d1', d1), ('d2', d2), ('passthrough', passthrough)):
        if t.dtype != torch.int32:
            raise ValueError("fdmt_step: %s must be int32, got %s"
                             % (name, t.dtype))
        if t.device != state.device:
            raise ValueError("fdmt_step: %s on %s, state on %s"
                             % (name, t.device, state.device))


def fdmt_step(state, d1, d2, passthrough, sgn):
    """K3: one FDMT merge step of the contiguous float32 state (nchan_cur,
    nd_cur, T) or (B, nchan_cur, nd_cur, T) -> (.., nout, nd_out, T)
    float32, as :func:`fdmt_step_plain` defines it.  The int32 tables
    ``d1``, ``d2`` (nout, nd_out) and ``passthrough`` (nout,) must lie on
    the state's device (the engine puts them there once per plan).  One
    launch per call, the batch axis inside it."""
    import torch
    _check_fdmt(state, d1, d2, passthrough, sgn)
    if state.device.type != 'cuda':
        return fdmt_step_plain(state, d1, d2, passthrough, sgn)
    nchan_cur, nd_cur, T = state.shape[-3:]
    batch = state.shape[0] if state.dim() == 4 else 1
    nout, nd_out = d1.shape
    if nout * nd_out >= 2 ** 31:
        raise ValueError("fdmt_step: %d output rows exceed the grid"
                         % (nout * nd_out))
    if not (d1.is_contiguous() and d2.is_contiguous() and
            passthrough.is_contiguous()):
        raise ValueError("fdmt_step: the tables must be contiguous")
    out = torch.empty(tuple(state.shape[:-3]) + (nout, nd_out, T),
                      dtype=torch.float32, device=state.device)
    lib, fn = _fn('fdmt', 'bf_fdmt_step', _FDMT_ARGS)
    err = fn(state.data_ptr(), out.data_ptr(), d1.data_ptr(), d2.data_ptr(),
             passthrough.data_ptr(),
             batch, nchan_cur, nd_cur, nout, nd_out, T, int(sgn),
             _build.stream_ptr(state.device))
    _build.check(lib, err, 'fdmt_step')
    launches['fdmt_step'] += 1
    return out


# ---------------------------------------------------------------------------
# K9: one ring hop of the corner turn
# ---------------------------------------------------------------------------

#: most ranks one K9 launch takes (``kMaxRanks`` of ring_permute.cu)
RING_MAX_RANKS = 64


def ring_permute_plain(blocks):
    """The plain version of K9, the reference ring form: ``dst[(i+1) %
    D].copy_(src[i])`` for each rank i, each destination a new tensor on
    its rank's device."""
    import torch
    D = len(blocks)
    out = [torch.empty_like(b) for b in blocks]
    for i, b in enumerate(blocks):
        out[(i + 1) % D].copy_(b)
    return out


def _check_ring(blocks):
    if not blocks:
        raise ValueError("ring_permute: no blocks")
    ref = blocks[0]
    for b in blocks:
        if b.shape != ref.shape or b.dtype != ref.dtype:
            raise ValueError("ring_permute: the blocks differ in shape or "
                             "dtype: %s %s and %s %s"
                             % (tuple(ref.shape), ref.dtype, tuple(b.shape),
                                b.dtype))
    kinds = {b.device.type for b in blocks}
    if len(kinds) != 1:
        raise ValueError("ring_permute: blocks on %s"
                         % sorted(str(b.device) for b in blocks))


def _peer_access(lib, src, dst):
    """Let card ``src`` write to card ``dst``; raises where it cannot."""
    import torch
    if not torch.cuda.can_device_access_peer(src.index, dst.index):
        raise RuntimeError("ring_permute: %s has no peer access to %s, so "
                           "K9 cannot write the block there" % (src, dst))
    _, enable = _fn('ring_permute', 'bf_enable_peer', _PEER_ARGS)
    _build.check(lib, enable(src.index, dst.index), 'ring_permute')


def ring_permute(blocks):
    """K9: one hop of the corner turn's ring.  ``blocks`` are the D ranks'
    blocks of one ring in rank order, one shape and dtype, block i on rank
    i's device; returns the D received blocks, block (i+1) mod D a copy of
    block i on rank (i+1)'s device.  Any dtype: the kernel copies bytes.
    One launch per card that holds source blocks (one per hop when every
    rank is on one card); a destination on another card is written
    through peer access, and a pair of cards without it raises."""
    import torch
    _check_ring(blocks)
    if blocks[0].device.type != 'cuda':
        return ring_permute_plain(blocks)
    if len(blocks) > RING_MAX_RANKS:
        raise ValueError("ring_permute: %d ranks; one launch takes at most %d"
                         % (len(blocks), RING_MAX_RANKS))
    for b in blocks:
        if not b.is_contiguous():
            raise ValueError("ring_permute: block of strides %s is not "
                             "contiguous" % (b.stride(),))
    D = len(blocks)
    devices = [b.device for b in blocks]
    out = [torch.empty_like(b) for b in blocks]
    nbytes = blocks[0].numel() * blocks[0].element_size()
    if nbytes == 0:
        return out
    lib, fn = _fn('ring_permute', 'bf_ring_permute', _RING_ARGS)
    by_src = {}
    for i in range(D):
        by_src.setdefault(devices[i], []).append(i)
    current = torch.cuda.current_device()
    for src, ranks in by_src.items():
        dsts = {devices[(i + 1) % D] for i in ranks} - {src}
        for dst in dsts:
            _peer_access(lib, src, dst)
        with contextlib.ExitStack() as stack:
            if src.index != current:
                stack.enter_context(torch.cuda.device(src))
            stream = torch.cuda.current_stream(src)
            for dst in dsts:
                # the destination's allocation is ready on its own stream
                stream.wait_stream(torch.cuda.current_stream(dst))
            srcp = (ctypes.c_ulonglong * len(ranks))(
                *[blocks[i].data_ptr() for i in ranks])
            dstp = (ctypes.c_ulonglong * len(ranks))(
                *[out[(i + 1) % D].data_ptr() for i in ranks])
            err = fn(srcp, dstp, len(ranks), nbytes, stream.cuda_stream)
            _build.check(lib, err, 'ring_permute')
            launches['ring_permute'] += 1
            for dst in dsts:
                torch.cuda.current_stream(dst).wait_stream(stream)
    return out
