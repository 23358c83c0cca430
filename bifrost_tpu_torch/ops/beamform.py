"""Quantized coherent-beamformer engine (the port of
``bifrost_tpu/ops/beamform.py``).

The hot product is y[t, f, p, b] = sum_s w[p, b, s] * x[t, f, p, s], a
batched GEMM whose voltage operand is, in a capture pipeline, the ci8
ring's int8 (re, im) planes.  Every candidate is accuracy-gated against
the complex64 baseline at the actual shape and then raced under the
measured-selection policy of :mod:`bifrost_tpu_torch.ops.mprobe`.  The
candidates keep the JAX package's names, so ``impl=`` and
``BF_BEAM_IMPL`` mean the same in both packages:

- ``xla``          complex64 ``torch.einsum``, the exactness baseline
- ``planar``       hi-lo bf16 planes, float32 sums (f32 class)
- ``planar_bf16``  one bf16 pass per plane product (LOSSY, ~2^-8)
- ``int8_wide``    one ``torch._int_mm`` per pol of ``[re | im]``
                   against the widened int8 weight block: exact int32
                   sums of the quantized weights, times the weight scale
- ``pallas``       K4, the hand-written int8 kernel
                   (:func:`bifrost_tpu_torch.ops.gpu_kernels.beamform_int8`),
                   one launch per pol
- ``pallas_bf16``  K5, the hand-written bf16 kernel
                   (:func:`~bifrost_tpu_torch.ops.gpu_kernels.beamform_bf16`),
                   one launch per pol (LOSSY like planar_bf16)

Accuracy classes (the gate rtol each admits, against the baseline):

=========  ========  ==========================================
class      rtol      admits
=========  ========  ==========================================
``f32``    1e-3      xla, planar
``bf16``   8e-3      + planar_bf16, pallas_bf16
``int8``   4e-2      + int8_wide, pallas (weight quantization)
=========  ========  ==========================================

The kernels race only where they run natively: when the voltages are on
a CUDA device and the capability probe K0 passes there.  A forced
``impl`` runs anywhere; on the CPU a kernel wrapper runs its plain
PyTorch version.  ``BF_BEAM_GATE_RTOL`` widens or narrows the active
class bound, and a non-default bound is part of the probe-cache key.

:func:`fused_detect` is the whole-chain beamform -> Stokes -> integrate
function that ``stages.match_beamformer`` substitutes (K6).  The JAX
package's ``fused_usable`` compile probe has no counterpart: its shape
conditions live in ``match_beamformer``, and the kernel wrapper raises
on what it does not take.  Left out: the jit and trace-safety machinery
of the JAX engine (the port runs eagerly) and the mesh-sharded plans.
"""

from __future__ import annotations

import os

import numpy as np

from .linalg import GATE_RTOL, _force_env, _probe_wanted, _mm_hilo, \
    _mm_bf16, _mm_i32, _split_hilo, _dtype_name, _is_int, full_f32

__all__ = ['Beamformer', 'BEAM_CLASSES', 'beam_class_rtol',
           'quantize_weights', 'fused_mode', 'fused_detect']

#: accuracy class -> gate rtol against the complex64 baseline
BEAM_CLASSES = {'f32': GATE_RTOL, 'bf16': 8e-3, 'int8': 4e-2}

#: candidates below the f32 accuracy class by construction: they race
#: only under a class (or BF_BEAM_GATE_RTOL) admitting them, or forced
_LOSSY = frozenset(['planar_bf16', 'pallas_bf16', 'int8_wide',
                    'pallas'])

_IMPL_NAMES = ('xla', 'planar', 'planar_bf16', 'pallas_bf16',
               'int8_wide', 'pallas')

#: the int8 candidates (the static verifier's BF-W170 reads them)
_INT_IMPLS = frozenset(['int8_wide', 'pallas'])

#: the hand-written kernels' candidates: they race only where the
#: capability probe passed, so an error from one raises instead of
#: dropping it from the race
_KERNEL_IMPLS = frozenset(['pallas', 'pallas_bf16'])


def beam_class_rtol(accuracy):
    """Effective gate rtol for an accuracy class, honouring an explicit
    BF_BEAM_GATE_RTOL override."""
    try:
        env = os.environ.get('BF_BEAM_GATE_RTOL', '').strip()
        if env:
            return float(env)
    except ValueError:
        pass
    return BEAM_CLASSES[accuracy]


def quantize_weights(wr, wi):
    """(wr8, wi8, scale): symmetric int8 quantization of float32 weight
    planes.  Clips at [-127, 127], not -128, so the widened block's
    negated copy (-wi8) cannot overflow int8."""
    amax = float(max(np.max(np.abs(wr)), np.max(np.abs(wi)), 1e-30))
    scale = amax / 127.0
    q = lambda m: np.clip(np.round(m / scale), -127, 127) \
        .astype(np.int8)
    return q(wr), q(wi), scale


def _wide_weight_block(wr8, wi8):
    """(P, 2S, 2B) int8 block W2 with z @ W2 = [yr | yi] for
    z = [re | im]: one widened int8 product carries the complex one."""
    wrT = np.swapaxes(wr8, -1, -2)            # (P, S, B)
    wiT = np.swapaxes(wi8, -1, -2)
    top = np.concatenate([wrT, wiT], axis=-1)             # re rows
    bot = np.concatenate([-wiT, wrT], axis=-1)            # im rows
    return np.concatenate([top, bot], axis=-2)            # (P, 2S, 2B)


class Beamformer(object):
    """Plan-style quantized beamformer for a fixed weight set.

    ``weights``: complex, ``(B, N)`` (one weight set: per pol, or with
    pol folded into N) or ``(P, B, S)`` (per-pol weight sets).
    ``accuracy``: 'f32' (default) | 'bf16' | 'int8', the class candidates
    must stay inside to race.  ``impl`` forces a candidate (overrides the
    race and the gate; ``BF_BEAM_IMPL`` does the same).

    Calls take (re, im) voltage planes (T, F, P, S), int8 (the ci8 ring
    device rep, P possibly 1) or float, and return complex64 beams
    (T, F, P, B) on the selected candidate.
    """

    def __init__(self, weights, accuracy='f32', impl=None):
        w = np.asarray(weights)
        if w.ndim == 2:
            w = w[None]                       # (1, B, S)
        if w.ndim != 3:
            raise ValueError('weights must be (B, N) or (P, B, S)')
        self._setup(w.real, w.imag, accuracy, impl)
        self.wr8, self.wi8, self.wscale = quantize_weights(self.wr,
                                                           self.wi)

    @classmethod
    def from_arrays(cls, wr, wi, wr8, wi8, wscale, accuracy='f32',
                    impl=None):
        """An engine holding the given weight planes as they are: float32
        ``wr``, ``wi`` and int8 ``wr8``, ``wi8``, each (P, B, S) or
        (B, S), and the dequantization ``wscale``; the attributes of these
        names of a JAX package engine carry its state across."""
        eng = cls.__new__(cls)
        wr, wi = np.asarray(wr), np.asarray(wi)
        if wr.ndim == 2:
            wr, wi = wr[None], wi[None]
        if wr.ndim != 3 or wi.shape != wr.shape:
            raise ValueError('weight planes must be (B, N) or (P, B, S)')
        eng._setup(wr, wi, accuracy, impl)
        wr8 = np.ascontiguousarray(wr8, np.int8).reshape(wr.shape)
        wi8 = np.ascontiguousarray(wi8, np.int8).reshape(wr.shape)
        eng.wr8, eng.wi8, eng.wscale = wr8, wi8, float(wscale)
        return eng

    def _setup(self, wr, wi, accuracy, impl):
        if accuracy not in BEAM_CLASSES:
            raise ValueError('accuracy must be one of %s, got %r'
                             % (sorted(BEAM_CLASSES), accuracy))
        self.accuracy = accuracy
        self.npol_w, self.nbeam, self.nstand = wr.shape
        self.wr = np.ascontiguousarray(wr, np.float32)
        self.wi = np.ascontiguousarray(wi, np.float32)
        self._force = impl or _force_env('BF_BEAM_IMPL', set(_IMPL_NAMES))
        self.chosen = {}
        self.probe_ms = {}
        self._fns = {}
        self._consts = {}

    # -- candidate implementations --------------------------------------

    def _const(self, name, build, device):
        """Weight constant ``build()`` (numpy) as a tensor on
        ``device``, cached per device."""
        key = (name, str(device))
        c = self._consts.get(key)
        if c is None:
            import torch
            c = self._consts[key] = torch.from_numpy(
                np.ascontiguousarray(build())).to(device)
        return c

    def _pol_weights(self, npol):
        """Weight planes broadcast to the voltage pol count."""
        if self.npol_w == npol:
            return self.wr, self.wi, self.wr8, self.wi8
        if self.npol_w == 1:
            rep = lambda m: np.repeat(m, npol, axis=0)
            return (rep(self.wr), rep(self.wi), rep(self.wr8),
                    rep(self.wi8))
        raise ValueError('weights have %d pol sets but voltages %d'
                         % (self.npol_w, npol))

    def _impl_xla(self, npol):
        import torch
        wr, wi, _, _ = self._pol_weights(npol)
        build = lambda: (wr + 1j * wi).astype(np.complex64)

        def fn(re, im):
            wc = self._const('wc%d' % npol, build, re.device)
            x = torch.complex(re.float(), im.float())
            with full_f32():
                return torch.einsum('tfps,pbs->tfpb', x, wc)
        return fn

    def _impl_planar(self, npol, mm):
        """The four plane products through ``mm`` (:func:`_mm_hilo`,
        f32 class, or :func:`_mm_bf16`), one matmul per pol and plane
        pair, without TF32.  int8 voltages are exact in bf16, so under
        hi-lo only the weights are split (two products, not three)."""
        import torch
        wr, wi, _, _ = self._pol_weights(npol)
        hilo = mm is _mm_hilo

        def prod(a, w):
            # (T, F, P, S) x (P, B, S) -> (T, F, P, B) float32
            T, F, P, S = a.shape
            out = []
            for p in range(P):
                a2 = a[:, :, p].reshape(T * F, S)
                wT = w[p].T
                if hilo and _is_int(a2):
                    ab = a2.float()
                    bh, bl = _split_hilo(wT)
                    y = torch.matmul(ab, bh) + torch.matmul(ab, bl)
                else:
                    y = mm(a2, wT)
                out.append(y.reshape(T, F, -1))
            return torch.stack(out, dim=2)

        def fn(re, im):
            wrj = self._const('wr%d' % npol, lambda: wr, re.device)
            wij = self._const('wi%d' % npol, lambda: wi, re.device)
            with full_f32():
                yr = prod(re, wrj) - prod(im, wij)
                yi = prod(re, wij) + prod(im, wrj)
            return torch.complex(yr, yi)
        return fn

    def _impl_int8_wide(self, npol):
        import torch
        _, _, wr8, wi8 = self._pol_weights(npol)
        build = lambda: _wide_weight_block(wr8, wi8)
        scale = float(self.wscale)
        nb = self.nbeam

        def fn(re, im):
            w2 = self._const('w2%d' % npol, build, re.device)
            yr, yi = self.int8_planes(re, im, w2=w2, nbeam=nb)
            return torch.complex(yr.float() * scale, yi.float() * scale)
        return fn

    def _impl_pallas(self, npol):
        import torch
        from . import gpu_kernels
        _, _, wr8, wi8 = self._pol_weights(npol)
        scale = float(self.wscale)

        def fn(re, im):
            wr8j = self._const('wr8%d' % npol, lambda: wr8, re.device)
            wi8j = self._const('wi8%d' % npol, lambda: wi8, re.device)
            outs = []
            for p in range(re.shape[2]):
                yr, yi = gpu_kernels.beamform_int8(wr8j[p], wi8j[p],
                                                   re[:, :, p], im[:, :, p])
                outs.append(torch.complex(yr.float() * scale,
                                          yi.float() * scale))
            return torch.stack(outs, dim=2)
        return fn

    def _impl_pallas_bf16(self, npol):
        import torch
        from . import gpu_kernels
        wr, wi, _, _ = self._pol_weights(npol)

        def fn(re, im):
            wrj = self._const('wr%d' % npol, lambda: wr, re.device)
            wij = self._const('wi%d' % npol, lambda: wi, re.device)
            outs = []
            for p in range(re.shape[2]):
                yr, yi = gpu_kernels.beamform_bf16(wrj[p], wij[p],
                                                   re[:, :, p], im[:, :, p])
                outs.append(torch.complex(yr, yi))
            return torch.stack(outs, dim=2)
        return fn

    @staticmethod
    def int8_planes(re, im, w2, nbeam):
        """The exact integer core of ``int8_wide``: int8 voltage planes
        (T, F, P, S) against the (P, 2S, 2B) widened weight block ->
        (yr, yi) int32 planes (T, F, P, B): the stacked (P, T*F, 2S)
        operand ``[re | im]`` through :func:`~.linalg._mm_i32`, one
        ``torch._int_mm`` per pol, exact."""
        import torch
        T, F, P, S = re.shape
        z = torch.empty((P, T, F, 2 * S), dtype=torch.int8, device=re.device)
        z[..., :S] = re.movedim(2, 0)
        z[..., S:] = im.movedim(2, 0)
        y = _mm_i32(z.reshape(P, T * F, 2 * S), w2)
        y = y.reshape(P, T, F, 2 * nbeam).movedim(0, 2)
        return y[..., :nbeam], y[..., nbeam:]

    # -- selection -------------------------------------------------------

    def _build(self, name, npol):
        if name == 'xla':
            return self._impl_xla(npol)
        if name == 'planar':
            return self._impl_planar(npol, _mm_hilo)
        if name == 'planar_bf16':
            return self._impl_planar(npol, _mm_bf16)
        if name == 'int8_wide':
            return self._impl_int8_wide(npol)
        if name == 'pallas':
            return self._impl_pallas(npol)
        if name == 'pallas_bf16':
            return self._impl_pallas_bf16(npol)
        raise KeyError(name)

    def _fn(self, name, npol):
        key = (name, npol)
        fn = self._fns.get(key)
        if fn is None:
            fn = self._fns[key] = self._build(name, npol)
        return fn

    def _candidates(self, int_input, device=None):
        """Candidate names eligible at this input dtype, accuracy class
        and device.  Float voltages cannot feed the int8 candidates; a
        class that does not admit a lossy candidate's error excludes it;
        the kernels race only on the card."""
        rtol = beam_class_rtol(self.accuracy)
        on_card = self._pallas_raceable(device)
        names = ['xla', 'planar']
        if rtol >= BEAM_CLASSES['bf16']:
            names.append('planar_bf16')
            if on_card:
                names.append('pallas_bf16')
        if int_input and rtol >= BEAM_CLASSES['int8']:
            names.append('int8_wide')
            if on_card:
                names.append('pallas')
        return names

    @staticmethod
    def _pallas_raceable(device=None):
        """The kernels race only where they run natively: voltages on a
        CUDA device (the process's device when ``device`` is None) on
        which the capability probe K0
        (:func:`bifrost_tpu_torch.ops.gpu_kernels.available`) passes.  A
        forced impl runs them anywhere."""
        from .gpu_kernels import available
        return available(device)

    def _default(self, int_input):
        """Winner when no measurement is available: the baseline, except
        under the 'int8' class on int input, where the quantized path
        (inside the class by construction) engages even unprobed."""
        if int_input and self.accuracy == 'int8':
            return 'int8_wide'
        return 'xla'

    def _key(self, shape, dtype, int_input):
        rtol = beam_class_rtol(self.accuracy)
        key = ('acc=%s w=(%d,%d,%d) v=%s %s'
               % (self.accuracy, self.npol_w, self.nbeam, self.nstand,
                  tuple(shape), dtype))
        if rtol != BEAM_CLASSES[self.accuracy]:
            # an explicit BF_BEAM_GATE_RTOL is part of the measurement's
            # identity
            key += '|gate_rtol=%g' % rtol
        return key

    def _gate(self, names, npol, make_args):
        """(keep, had_errors): the candidates within the class rtol of
        the ``xla`` baseline at the actual shape, relative to the
        baseline's maximum.  The float candidates run without TF32
        (:func:`~.linalg.full_f32`), so the baseline is a full float32
        one.  An error from a kernel raises."""
        args = make_args()
        outs = {}
        had_errors = False
        for name in names:
            try:
                outs[name] = self._fn(name, npol)(*args)
            except Exception:
                if name in _KERNEL_IMPLS:
                    raise
                had_errors = True
        if 'xla' not in outs:
            return [n for n in outs if n not in _LOSSY], had_errors
        ref = outs['xla']
        scale = float(ref.abs().max()) or 1.0
        rtol = beam_class_rtol(self.accuracy)
        keep = [name for name, y in outs.items()
                if float((y - ref).abs().max()) / scale <= rtol]
        return keep, had_errors

    def _select(self, shape, dtype, int_input, make_args, device):
        """Measured winner for voltage planes of this shape and dtype:
        gate first, race the survivors, cache per the mprobe policy."""
        npol = shape[2]
        key = self._key(shape, dtype, int_input)
        if self._force:
            self.chosen[key] = self._force
            return self._force
        default = self._default(int_input)
        names = self._candidates(int_input, device)
        if key in self.chosen:
            return self.chosen[key]
        if not (_probe_wanted() and len(names) > 1):
            self.chosen[key] = default
            return default
        from . import mprobe
        cached = mprobe.peek('beamform', key)
        if cached is not None and cached[0] in names:
            self.chosen[key] = cached[0]
            self.probe_ms[key] = cached[1]
            return cached[0]
        keep, had_errors = self._gate(names, npol, make_args)
        fns = {n: self._fn(n, npol) for n in keep}
        winner, ms, _err = mprobe.select('beamform', key, fns, make_args,
                                         persist=not had_errors,
                                         strict=_KERNEL_IMPLS)
        self.chosen[key] = winner or default
        if winner is not None:
            self.probe_ms[key] = ms
        return self.chosen[key]

    # -- public API ------------------------------------------------------

    def prewarm(self, t, f, npol=None, int_input=True, seed=11):
        """Gate and race the candidates at the gulp shape on random
        voltages, on the process's device, so the first real call finds
        the winner chosen: the probe cost lands at sequence start, never
        on the first gulp.  Returns the winner (the class default when
        probing is off)."""
        import torch
        from ..device import get_device
        npol = npol or self.npol_w
        shape = (t, f, npol, self.nstand)
        dtype = 'int8' if int_input else 'float32'
        if not _probe_wanted() and not self._force:
            name = self._default(int_input)
            self.chosen[self._key(shape, dtype, int_input)] = name
            return name
        rng = np.random.RandomState(seed)
        if int_input:
            re = rng.randint(-64, 64, shape).astype(np.int8)
            im = rng.randint(-64, 64, shape).astype(np.int8)
        else:
            re = rng.randn(*shape).astype(np.float32)
            im = rng.randn(*shape).astype(np.float32)
        dev = get_device()
        rej = torch.from_numpy(re).to(dev)
        imj = torch.from_numpy(im).to(dev)
        return self._select(shape, dtype, int_input, lambda: (rej, imj),
                            dev)

    def __call__(self, re, im):
        """Beamform (T, F, P, S) voltage planes -> (T, F, P, B) complex64
        beams on the selected candidate (the winner chosen by a prewarm
        at this shape, a race now when probing is on, else the class
        default)."""
        int_input = _is_int(re)
        shape = tuple(re.shape)
        key = self._key(shape, _dtype_name(re), int_input)
        name = self._force or self.chosen.get(key)
        if name is None:
            if _probe_wanted():
                name = self._select(shape, _dtype_name(re), int_input,
                                    lambda: (re, im), re.device)
            else:
                name = self._default(int_input)
        return self._fn(name, shape[2])(re, im)

    def ops_per_frame(self, nfreq, npol=None):
        """Real ops per time frame of the beamform GEMM (one complex MAC
        = 8 real ops)."""
        npol = npol or self.npol_w
        return 8 * nfreq * npol * self.nbeam * self.nstand


# ---------------------------------------------------------------------------
# fused beamform -> Stokes detect -> integrate (the whole-chain kernel
# substitution, stages.match_beamformer)
# ---------------------------------------------------------------------------

def fused_mode():
    """BF_BEAM_FUSED: 'auto' (default: substitute K6 when the chain
    matches and the engine's accuracy class admits int8 or
    ``impl='pallas'`` was forced), 'force' (substitute whenever the chain
    matches) or 'off' (never substitute)."""
    v = os.environ.get('BF_BEAM_FUSED', 'auto').strip().lower()
    return v if v in ('auto', 'force', 'off') else 'auto'


def fused_detect(engine, x, rfactor):
    """The fused chain on a ci8 device-rep gulp ``x`` (T, F, S, 2, 2):
    beamform both pols with ``engine``'s quantized weights,
    Stokes-detect, integrate ``rfactor`` frames, in one launch of K6
    (:func:`bifrost_tpu_torch.ops.gpu_kernels.beamform_detect_int8`).
    Returns (T // rfactor, F, 4, B) float32 ordered [I, Q, U, V]."""
    from . import gpu_kernels
    _, _, wr8, wi8 = engine._pol_weights(2)
    w = [engine._const(name, build, x.device) for name, build in
         (('fz_wxr', lambda: wr8[0]), ('fz_wxi', lambda: wi8[0]),
          ('fz_wyr', lambda: wr8[1]), ('fz_wyi', lambda: wi8[1]))]
    return gpu_kernels.beamform_detect_int8(*w, x, engine.wscale, rfactor)
