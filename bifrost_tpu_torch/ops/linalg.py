"""Batched linear algebra (the port of ``bifrost_tpu/ops/linalg.py``;
reference: src/linalg.cu:877-904, python/bifrost/linalg.py).

- :class:`LinAlg` and :func:`matmul`, the reference's ``bfLinAlgMatMul``:
  ``c = alpha * a @ b + beta * c`` (the beamforming GEMM) and
  ``c = alpha * a @ a^H + beta * c`` when ``b`` is None (correlation).
  Three candidate families with the JAX package's names: ``_AB_IMPLS``
  and ``_AAH_IMPLS`` (``xla``, ``planar`` Karatsuba 3-product on (re, im)
  planes, ``planar_hilo`` with the bf16 hi-lo split, the lossy
  ``planar_bf16``) and ``_I8_IMPLS`` for ci8 ``a @ a^H`` (``i8_3mm``,
  ``i8_gram``, exact int32 sums).  A cf16 operand stays as two f16 planes
  end to end.  The float candidates are gated against ``xla`` (TF32 off)
  at ``_GATE_RTOL`` (``BF_LINALG_GATE_RTOL``) before the race, which runs
  through ``ops/mprobe.py`` on the card unless ``BF_LINALG_PROBE=0``;
  ``BF_LINALG_AB_IMPL`` / ``BF_LINALG_AAH_IMPL`` / ``BF_LINALG_I8_IMPL``
  force a candidate.  The JAX LinAlg reaches no Pallas kernel, and this
  one launches no hand-written kernel either.
- the environment switches :func:`_force_env` and :func:`_probe_wanted`,
  the bf16 plane products :func:`_split_hilo`, :func:`_mm_hilo` and
  :func:`_mm_bf16`, and the f32 accuracy-gate bound :data:`GATE_RTOL`
  (``LinAlg._GATE_RTOL``), which ``ops/beamform.py`` uses;
- the correlation half: the xcorr candidates and their tables,
  :func:`xcorr_int8` and :func:`xcorr_prewarm` (mprobe family
  ``linalg_xcorr``, ``BF_LINALG_XCORR_IMPL``), and the raced,
  accuracy-classed :class:`XEngine` (mprobe family ``xengine``,
  ``BF_XCORR_IMPL``, ``BF_XCORR_GATE_RTOL``), with the JAX package's
  names, keys and classes.

Left out: the jit caches and tracer branches of the JAX functions: the
port runs eagerly, and probing happens at a prewarm or on the first
eager call, never inside a gulp after ``on_sequence``.

torch has no ``preferred_element_type``: a bf16 product with a float32
result is taken here as the float32 product of bf16-rounded operands,
which is exact per term (a bf16 x bf16 product fits float32's mantissa)
and sums in float32, the semantics of the JAX package's bf16 MXU passes.
An int8 x int8 -> int32 product is :func:`_mm_i32`, one
``torch._int_mm`` per batch entry on zero-padded operands: exact at every
shape.  Every xcorr and X-engine candidate accepts (T, F, n) planes or
(g, T, F, n) planes with a leading group axis (one visibility matrix per
group), the form :class:`~bifrost_tpu_torch.stages.CorrelateStage`
hands the engine.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np

__all__ = ['GATE_RTOL', 'LinAlg', 'matmul', 'xcorr_int8', 'xcorr_prewarm',
           'XEngine', 'XCORR_CLASSES', 'xcorr_class_rtol']

#: a candidate deviating from the baseline by more than this (relative
#: to the baseline's maximum, at the actual shape) is kept out of a speed
#: race; the bound admits the hi-lo split's ~2^-16 truncation and catches
#: a broken candidate (``LinAlg._GATE_RTOL``, ``linalg.py:434``)
GATE_RTOL = 1e-3


def _force_env(var, allowed):
    v = os.environ.get(var, '').strip().lower()
    return v if v in allowed else None


def _probe_wanted():
    """``BF_LINALG_PROBE``: probe on the card unless '0', probe anywhere
    when '1' (the JAX rule, with "on TPU" read as "on the card")."""
    probe_env = os.environ.get('BF_LINALG_PROBE', '').strip()
    if probe_env == '1':
        return True
    if probe_env == '0':
        return False
    from ..device import on_cuda
    return on_cuda()


@contextlib.contextmanager
def full_f32():
    """float32 and complex64 matmuls without TF32 inside the block: the
    f32 accuracy class and its gates need full float32 products.  The
    caller's ``torch.backends.cuda.matmul.allow_tf32`` is restored on
    exit."""
    import torch
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _bf16(x):
    """``x`` rounded to bf16 (nearest even), held as float32."""
    import torch
    return x.to(torch.bfloat16).float()


def _split_hilo(x):
    """float32 -> (hi, lo), both bf16-valued float32, with x == hi + lo
    up to bf16(lo) rounding (lo carries the next 8 mantissa bits)."""
    hi = _bf16(x)
    return hi, _bf16(x - hi)


def _mm_hilo(a, b):
    """f32-accuracy-class matmul as three bf16 products with float32
    accumulation (the lo @ lo term dropped, ~2^-16 relative)."""
    import torch
    ah, al = _split_hilo(a.float())
    bh, bl = _split_hilo(b.float())
    return (torch.matmul(ah, bh)
            + (torch.matmul(ah, bl) + torch.matmul(al, bh)))


def _mm_bf16(a, b):
    """ONE bf16 product with float32 accumulation: bf16 input rounding
    (~2^-8 relative).  Lossy: races only under a widened gate or a
    forced impl."""
    import torch
    return torch.matmul(_bf16(a.float()), _bf16(b.float()))


# ---------------------------------------------------------------------------
# exact int8 products over the time axis
# ---------------------------------------------------------------------------

def _ceil_to(n, m):
    return -(-n // m) * m


def _padded(x, shape):
    """``x`` (B, m, k) int8 as a contiguous tensor of ``shape``, zero
    past its own extent."""
    import torch
    if tuple(x.shape) == tuple(shape):
        return x.contiguous()
    out = torch.zeros(shape, dtype=torch.int8, device=x.device)
    out[:, :x.shape[1], :x.shape[2]] = x
    return out


def _mm_i32(a, b):
    """(..., m, k) int8 @ (..., k, n) int8 -> (..., m, n) int32, exact:
    one ``torch._int_mm`` per batch entry.  ``_int_mm`` on the card wants
    more than 16 rows and inner and output widths that are multiples of
    8: the operands are padded with zeros, which leaves the integer sums
    unchanged."""
    import torch
    lead = a.shape[:-2]
    m, k = a.shape[-2:]
    n = b.shape[-1]
    a3 = a.reshape((-1, m, k))
    b3 = b.reshape((-1, k, n))
    nb = a3.shape[0]
    kp = _ceil_to(max(k, 1), 8)
    ap = _padded(a3, (nb, max(m, 17), kp))
    bp = _padded(b3, (nb, kp, _ceil_to(n, 8)))
    out = torch.empty((nb, m, n), dtype=torch.int32, device=a.device)
    for i in range(nb):
        out[i] = torch._int_mm(ap[i], bp[i])[:m, :n]
    return out.reshape(tuple(lead) + (m, n))


def _t_in(x):
    """(..., T, F, n) -> (..., F, n, T), contiguous."""
    return x.movedim(-3, -1).contiguous()


def _t_jn(x):
    """(..., T, F, n) -> (..., F, T, n), contiguous."""
    return x.transpose(-3, -2).contiguous()


def _tdot(x, y):
    """sum_t x[..., t, f, a] y[..., t, f, b] -> (..., F, n_x, n_y) int32."""
    return _mm_i32(_t_in(x), _t_jn(y))


def _vis(re, im):
    """Visibilities from int32 real and imaginary sums: each cast to
    float32 (exact below 2^24), then complex64."""
    import torch
    return torch.complex(re.float(), im.float())


def _swap(k):
    return k.transpose(-1, -2)


# ---------------------------------------------------------------------------
# LinAlg operands: (re, im) planes of narrow complex types
# ---------------------------------------------------------------------------

def _reim_planes(x, kind, nbits):
    """(re, im) planes of a host array of the given complex type on the
    process's device, or None: never promoted to a wider complex type,
    so the device holds and reads the narrow width."""
    import torch
    from ..device import get_device
    from ..ndarray import ndarray
    if isinstance(x, ndarray) and x.dtype.kind == kind \
            and x.dtype.nbits == nbits:
        buf = x.as_numpy()
        dev = get_device()
        return tuple(torch.from_numpy(np.ascontiguousarray(buf[f])).to(dev)
                     for f in ('re', 'im'))
    return None


def _int8_reim(x):
    """The int8 planes of a ci8 array (the exact int path)."""
    return _reim_planes(x, 'ci', 8)


def _cf16_reim(x):
    """The f16 planes of a cf16 array: half-width reads straight into the
    planar products (the reference's Cherk3mEx cf16 design point,
    src/linalg.cu:210-226)."""
    return _reim_planes(x, 'cf', 16)


def _mm_f32(a, b):
    """float32 product (f16 planes widened first, which is exact)."""
    import torch
    return torch.matmul(a.float(), b.float())


def _cmm_planar(ar, ai, br, bi, mm):
    """Complex product on planes, Karatsuba 3-multiply.  The m3 addends
    are widened to float32 first: for f16 planes re + im can leave the
    f16 range for values that are each inside it."""
    def wide(x):
        return x.float() if x.element_size() < 4 else x

    m1 = mm(ar, br)
    m2 = mm(ai, bi)
    m3 = mm(wide(ar) + wide(ai), wide(br) + wide(bi))
    return m1 - m2, m3 - m1 - m2


def _planes(x):
    """(re, im) planes of an operand: a plane tuple as it is, a complex
    tensor split, a real one with no imaginary plane."""
    if isinstance(x, tuple):
        return x
    if x.is_complex():
        return x.real, x.imag
    return x, None


def _as_complex(x):
    """An operand as one tensor for the ``xla`` baselines: plane tuples
    combined into complex64."""
    import torch
    if isinstance(x, tuple):
        return torch.complex(x[0].float(), x[1].float())
    return x


def _accumulate(y, c, beta):
    if beta != 0 and c is not None:
        y = y + beta * c
    return y


# ---------------------------------------------------------------------------
# a @ b candidates (complex-capable GEMM)
# ---------------------------------------------------------------------------

def _ab_xla(a, b, c, alpha, beta):
    import torch
    a, b = _as_complex(a), _as_complex(b)
    if a.is_complex() or b.is_complex():
        a, b = a.to(torch.complex64), b.to(torch.complex64)
    else:
        a, b = a.float(), b.float()
    return _accumulate(alpha * torch.matmul(a, b), c, beta)


def _ab_planar_with(mm):
    def impl(a, b, c, alpha, beta):
        import torch
        ar, ai = _planes(a)
        br, bi = _planes(b)
        if ai is None and bi is None:
            y = alpha * mm(ar, br).float()
        else:
            if ai is None:
                yr, yi = mm(ar, br), mm(ar, bi)
            elif bi is None:
                yr, yi = mm(ar, br), mm(ai, br)
            else:
                yr, yi = _cmm_planar(ar, ai, br, bi, mm)
            y = alpha * torch.complex(yr.float(), yi.float())
        return _accumulate(y, c, beta)
    return impl


_AB_IMPLS = {
    'xla': _ab_xla,
    'planar': _ab_planar_with(_mm_f32),
    'planar_hilo': _ab_planar_with(_mm_hilo),
    'planar_bf16': _ab_planar_with(_mm_bf16),
}


# ---------------------------------------------------------------------------
# a @ a^H candidates (complex float)
# ---------------------------------------------------------------------------

def _aah_xla(a, c, alpha, beta):
    import torch
    a = _as_complex(a).to(torch.complex64)
    return _accumulate(alpha * torch.matmul(a, a.transpose(-1, -2).conj()),
                       c, beta)


def _aah_planar_with(mm):
    def impl(a, c, alpha, beta):
        import torch
        ar, ai = _planes(a)
        arT = _swap(ar)
        if ai is None:
            y = (alpha * mm(ar, arT)).to(torch.complex64)
        else:
            aiT = _swap(ai)
            rr = mm(ar, arT)
            ii = mm(ai, aiT)
            k = mm(ai, arT)
            y = alpha * torch.complex((rr + ii).float(),
                                      (k - _swap(k)).float())
        return _accumulate(y, c, beta)
    return impl


_AAH_IMPLS = {
    'xla': _aah_xla,
    'planar': _aah_planar_with(_mm_f32),
    'planar_hilo': _aah_planar_with(_mm_hilo),
    'planar_bf16': _aah_planar_with(_mm_bf16),
}


# ---------------------------------------------------------------------------
# int8 a @ a^H candidates (ci8 correlation)
# ---------------------------------------------------------------------------

def _aah_i8_3mm(re, im, c, alpha, beta):
    """Three int8 products with int32 sums:
    A A^H = (re re^T + im im^T) + i (K - K^T), K = im re^T
    (the Cherk3mEx reduction; reference: src/linalg.cu:130-148)."""
    reT, imT = _swap(re), _swap(im)
    rr = _mm_i32(re, reT)
    ii = _mm_i32(im, imT)
    k = _mm_i32(im, reT)
    return _accumulate(alpha * _vis(rr + ii, k - _swap(k)), c, beta)


def _aah_i8_gram(re, im, c, alpha, beta):
    """One widened int8 product: z = [re; im] stacked on the row axis and
    z z^T, whose four blocks hold rr, ri, ir and ii (4/3 the MACs of the
    3-multiply in one product; exact int32 sums)."""
    import torch
    n = re.shape[-2]
    z = torch.cat([re, im], dim=-2)
    g = _mm_i32(z, _swap(z))
    rr = g[..., :n, :n]
    ri = g[..., :n, n:]     # re im^T == K^T
    ir = g[..., n:, :n]     # im re^T == K
    ii = g[..., n:, n:]
    return _accumulate(alpha * _vis(rr + ii, ir - ri), c, beta)


_I8_IMPLS = {
    'i8_3mm': _aah_i8_3mm,
    'i8_gram': _aah_i8_gram,
}

#: (family, shapes_key) -> the fallback frozen after a probe in which
#: every candidate failed or was gated out (in-process only)
_NEG_PROBE_CACHE = {}

_IMPLS = {'ab': _AB_IMPLS, 'aah': _AAH_IMPLS, 'i8': _I8_IMPLS}


class LinAlg(object):
    """Plan-style wrapper (reference: python/bifrost/linalg.py; the JAX
    package's ``LinAlg``).

    The candidate of each call family is forced by the constructor
    argument or ``BF_LINALG_AB_IMPL`` / ``BF_LINALG_AAH_IMPL`` /
    ``BF_LINALG_I8_IMPL``; otherwise, where probing is on (on the card
    unless ``BF_LINALG_PROBE=0``, anywhere under ``=1``), the candidates
    are gated and raced at the actual shape and the winner cached
    (``ops/mprobe.py`` families ``linalg_ab`` / ``linalg_aah`` /
    ``linalg_i8``); elsewhere the defaults run (``xla``, ``i8_3mm``).
    Float candidates deviating from the ``xla`` baseline by more than
    :attr:`_GATE_RTOL` of its maximum at the actual shape are excluded
    before any timing.  Float candidates run without TF32."""

    def __init__(self, ab_impl=None, aah_impl=None, i8_impl=None):
        self._force = {
            'ab': ab_impl or _force_env('BF_LINALG_AB_IMPL', _AB_IMPLS),
            'aah': aah_impl or _force_env('BF_LINALG_AAH_IMPL',
                                          _AAH_IMPLS),
            'i8': i8_impl or _force_env('BF_LINALG_I8_IMPL', _I8_IMPLS),
        }
        self.chosen = {}
        self.probe_ms = {}

    @staticmethod
    def _impl(family, name):
        """Candidate ``name`` of ``family`` as ``fn(*operands, c, alpha=,
        beta=)``; the float ones run with TF32 off."""
        fn = _IMPLS[family][name]
        if family == 'i8':
            return fn

        def call(*args, alpha, beta):
            with full_f32():
                return fn(*args, alpha, beta)
        return call

    def _pick(self, family, shapes_key, candidates, make_args,
              gate=False):
        """Winner for this call family at this shape.  ``make_args``
        returns the operands without c, alpha and beta: the probe times
        the alpha=1, beta=0 form.  With ``gate`` the candidates are
        accuracy-gated first; gate and race run at most once per (family,
        shape), and a probe in which every candidate failed freezes the
        default for the shape in-process (``_NEG_PROBE_CACHE``)."""
        if self._force[family]:
            self.chosen[family] = self._force[family]
            return self._force[family]
        default = {'ab': 'xla', 'aah': 'xla', 'i8': 'i8_3mm'}[family]
        if gate:
            # a winner admitted under a widened gate must never serve a
            # default-gate session from the shared cache
            rtol = self._gate_rtol()
            if rtol != LinAlg._GATE_RTOL:
                shapes_key = '%s|gate_rtol=%g' % (shapes_key, rtol)
        if _probe_wanted() and len(candidates) > 1:
            neg = _NEG_PROBE_CACHE.get((family, shapes_key))
            if neg is not None:
                self.chosen[family] = neg
                return neg
            from . import mprobe
            cached = mprobe.peek('linalg_%s' % family, shapes_key)
            if cached is not None and cached[0] in candidates:
                self.chosen[family] = cached[0]
                self.probe_ms[family] = cached[1]
                return cached[0]
            probe_fns = {
                n: (lambda f: lambda *a: f(*a, None, alpha=1.0,
                                           beta=0.0))(
                    self._impl(family, n))
                for n in candidates}
            persist = True
            if gate:
                keep, had_errors = self._accuracy_gate(probe_fns,
                                                       make_args)
                probe_fns = {n: probe_fns[n] for n in keep}
                persist = not had_errors
            winner, ms, _err = mprobe.select(
                'linalg_%s' % family, shapes_key, probe_fns, make_args,
                persist=persist)
            if winner is not None:
                self.chosen[family] = winner
                self.probe_ms[family] = ms
                return winner
            _NEG_PROBE_CACHE[(family, shapes_key)] = default
        self.chosen[family] = default
        return default

    #: a candidate deviating from the ``xla`` baseline by more than this
    #: (relative to its maximum, at the actual shape) stays out of the
    #: race: it admits the hi-lo split's ~2^-16 truncation and catches a
    #: broken candidate; the one-pass bf16 candidate (~2^-8) needs a
    #: widened ``BF_LINALG_GATE_RTOL`` or a force
    _GATE_RTOL = GATE_RTOL
    #: candidates below the f32 class by construction: never admitted
    #: without a passing gate measurement
    _LOSSY = frozenset(['planar_bf16'])

    @staticmethod
    def _gate_rtol():
        try:
            return float(os.environ.get('BF_LINALG_GATE_RTOL', '')
                         or LinAlg._GATE_RTOL)
        except ValueError:
            return LinAlg._GATE_RTOL

    @staticmethod
    def _accuracy_gate(impls, make_args, base='xla'):
        """(keep, had_errors): the candidates within _gate_rtol() of the
        ``xla`` baseline at the actual shape.  ``had_errors`` says a
        candidate raised, so a winner from the reduced field is not
        written to disk.  Without a baseline no lossy candidate is
        admitted."""
        args = make_args()
        outs = {}
        had_errors = False
        for name, fn in impls.items():
            try:
                outs[name] = fn(*args)
            except Exception:
                had_errors = True
        if base not in outs:
            return [n for n in outs if n not in LinAlg._LOSSY], \
                had_errors
        ref = outs[base]
        scale = float(ref.abs().max()) or 1.0
        rtol = LinAlg._gate_rtol()
        keep = [name for name, y in outs.items()
                if float((y - ref).abs().max()) / scale <= rtol]
        return keep, had_errors

    # -- public API ---------------------------------------------------------

    def matmul(self, alpha, a, b, beta, c):
        """c = alpha * a @ b + beta * c, or a @ a^H when b is None
        (reference: bfLinAlgMatMul, src/linalg.cu:877).  Operands are
        tensors, numpy arrays or the port's host ndarrays (ci8 and cf16
        included); with ``c`` the result is written into it in its
        logical type (a real ``c`` takes the real part) and ``c`` is
        returned, else the result tensor."""
        from .common import as_logical, astype, logical_dtype, writeback
        alpha = complex(alpha) if np.iscomplexobj(np.asarray(alpha)) \
            else float(alpha)
        beta = complex(beta) if np.iscomplexobj(np.asarray(beta)) \
            else float(beta)
        cj = as_logical(c) if (c is not None and beta != 0) else None

        def operand(x):
            """(tensor or (re, im) f16 plane tuple, key fragment); the
            dtype is part of the key: a winner measured for f32 is not
            one for c64 or cf16 at the same shape."""
            cf = _cf16_reim(x)
            if cf is not None:
                return cf, '%s cf16' % (tuple(cf[0].shape),)
            xj = as_logical(x)
            return xj, '%s %s' % (tuple(xj.shape), _dtype_name(xj))

        if b is None:
            reim = _int8_reim(a)
            if reim is not None:
                re, im = reim
                name = self._pick('i8', 'shape=%s' % (tuple(re.shape),),
                                  _I8_IMPLS, lambda: (re, im))
                y = self._impl('i8', name)(re, im, cj, alpha=alpha,
                                           beta=beta)
            else:
                aj, akey = operand(a)
                name = self._pick('aah', 'a=%s' % akey, _AAH_IMPLS,
                                  lambda: (aj,), gate=True)
                y = self._impl('aah', name)(aj, cj, alpha=alpha,
                                            beta=beta)
        else:
            aj, akey = operand(a)
            bj, bkey = operand(b)
            name = self._pick('ab', 'a=%s b=%s' % (akey, bkey), _AB_IMPLS,
                              lambda: (aj, bj), gate=True)
            y = self._impl('ab', name)(aj, bj, cj, alpha=alpha, beta=beta)
        if c is not None:
            odt = logical_dtype(c)
            if y.is_complex() and odt.kind not in ('cf', 'ci'):
                y = y.real
            return writeback(astype(y, odt), c)
        return y


_default = None


def matmul(alpha, a, b, beta, c):
    """:meth:`LinAlg.matmul` on a process-wide default plan."""
    global _default
    if _default is None:
        _default = LinAlg()
    return _default.matmul(alpha, a, b, beta, c)


# ---------------------------------------------------------------------------
# cross-correlation entry point (FX correlator X step; blocks.correlate
# routes here)
# ---------------------------------------------------------------------------

def _xcorr_einsum(re_i, im_i, re_j, im_j):
    rr = _tdot(re_i, re_j)
    ii = _tdot(im_i, im_j)
    ir = _tdot(im_i, re_j)
    ri = _tdot(re_i, im_j)
    return _vis(rr + ii, ir - ri)


def _xcorr_fmt(re_i, im_i, re_j, im_j):
    """Pre-transpose to (F, n, T) / (F, T, n) once, so each of the four
    contractions is a canonical batched GEMM."""
    a_re, a_im = _t_in(re_i), _t_in(im_i)
    b_re, b_im = _t_jn(re_j), _t_jn(im_j)
    rr = _mm_i32(a_re, b_re)
    ii = _mm_i32(a_im, b_im)
    ir = _mm_i32(a_im, b_re)
    ri = _mm_i32(a_re, b_im)
    return _vis(rr + ii, ir - ri)


def _xcorr_einsum3(re_i, im_i, re_j, im_j):
    """Auto-correlation only: the Hermitian structure makes the cross
    term one product (K - K^T), 3 contractions instead of 4."""
    rr = _tdot(re_i, re_i)
    ii = _tdot(im_i, im_i)
    k = _tdot(im_i, re_i)
    return _vis(rr + ii, k - _swap(k))


def _xcorr_fmt3(re_i, im_i, re_j, im_j):
    """Auto-correlation only: the pre-transposed form of the 3-product
    reduction."""
    a_re, a_im = _t_in(re_i), _t_in(im_i)
    b_re, b_im = _t_jn(re_i), _t_jn(im_i)
    rr = _mm_i32(a_re, b_re)
    ii = _mm_i32(a_im, b_im)
    k = _mm_i32(a_im, b_re)
    return _vis(rr + ii, k - _swap(k))


def _xcorr_gram(re_i, im_i, re_j, im_j):
    """Auto-correlation only (i is j): one widened int8 gram product of
    the stacked [re | im] planes in the (F, 2n, T) layout."""
    import torch
    z = torch.cat([re_i, im_i], dim=-1)             # (..., T, F, 2n)
    g = _tdot(z, z)                                 # (..., F, 2n, 2n)
    n = re_i.shape[-1]
    rr = g[..., :n, :n]
    ri = g[..., :n, n:]
    ir = g[..., n:, :n]
    ii = g[..., n:, n:]
    return _vis(rr + ii, ir - ri)


def _xcorr_pallas(re_i, im_i, re_j, im_j):
    """Auto-correlation only: K7, the hand-written Hermitian kernel
    (:func:`bifrost_tpu_torch.ops.gpu_kernels.xcorr_herm`)."""
    from .gpu_kernels import xcorr_herm
    return xcorr_herm(re_i, im_i)


def _xcorr_pallas_cross(re_i, im_i, re_j, im_j):
    """Cross blocks (the station-sharded mesh form): K8, the hand-written
    cross kernel (:func:`bifrost_tpu_torch.ops.gpu_kernels.xcorr_cross`)."""
    from .gpu_kernels import xcorr_cross
    return xcorr_cross(re_i, im_i, re_j, im_j)


_XCORR_IMPLS = {
    'einsum': _xcorr_einsum,
    'fmt': _xcorr_fmt,
    'pallas': _xcorr_pallas_cross,
}
_XCORR_AUTO_IMPLS = dict(_XCORR_IMPLS, einsum3=_xcorr_einsum3,
                         fmt3=_xcorr_fmt3, gram=_xcorr_gram,
                         pallas=_xcorr_pallas)

#: per-process winners of xcorr_int8, by shape key
_xcorr_chosen = {}

#: the hand-written kernels' candidate names: they race only where the
#: capability probe passed, so an error from one is a fault that raises,
#: never a reason to race on without it
_KERNEL_IMPLS = frozenset(['pallas'])


def _xcorr_race_impls(impls, device=None):
    """Candidates eligible for the measured race: the kernel races only
    where the planes are on the card and the capability probe K0
    (:func:`bifrost_tpu_torch.ops.gpu_kernels.available`) passes; off
    the card the list is the JAX package's off the TPU.  A forced
    ``BF_LINALG_XCORR_IMPL`` or ``impl=`` still dispatches it.  The
    kernel's errors in the race propagate."""
    if 'pallas' not in impls:
        return impls
    from .gpu_kernels import available
    if available(device):
        return impls
    return {k: v for k, v in impls.items() if k != 'pallas'}


def xcorr_int8(re_i, im_i, re_j=None, im_j=None, impl=None):
    """FX-correlator cross-multiply on int8 planes.

    (T, F, n_i) x (T, F, n_j) -> (F, n_i, n_j) complex64 visibilities
    integrated over T (vis[f, i, j] = sum_t x_i x_j^*).  When re_j/im_j
    are omitted the auto-correlation gains the Hermitian candidates
    (einsum3, fmt3, gram and K7).  Exact int32 accumulation on every
    path; the winner is measured per shape on the card
    (``BF_LINALG_XCORR_IMPL`` forces one)."""
    auto = re_j is None
    if auto:
        re_j, im_j = re_i, im_i
    impls = _XCORR_AUTO_IMPLS if auto else _XCORR_IMPLS
    # the Hermitian 3-product form is the exact auto-correlation at 3/4
    # the MACs: the default wherever no measurement is available
    default = 'einsum3' if auto else 'einsum'
    name = impl or _force_env('BF_LINALG_XCORR_IMPL', impls)
    key = 'auto=%s i=%s j=%s' % (auto, tuple(re_i.shape),
                                 tuple(re_j.shape))
    if name is None:
        want = _probe_wanted()
        if want and key not in _xcorr_chosen:
            from . import mprobe
            winner, _ms, _ = mprobe.select(
                'linalg_xcorr', key,
                _xcorr_race_impls(impls, re_i.device),
                lambda: (re_i, im_i, re_j, im_j), strict=_KERNEL_IMPLS)
            _xcorr_chosen[key] = winner or default
        name = _xcorr_chosen.get(key, default) if want else default
    return impls[name](re_i, im_i, re_j, im_j)


def xcorr_prewarm(t, f, n_i, n_j=None):
    """Probe the xcorr winner at (T, F, n) on the process's device now,
    so the first gulp finds it chosen: the probe cost lands at sequence
    start.  A no-op when probing is off."""
    if not _probe_wanted():
        return
    import torch
    from ..device import get_device
    z = torch.zeros((t, f, n_i), dtype=torch.int8, device=get_device())
    if n_j is None:
        xcorr_int8(z, z)
    else:
        zj = torch.zeros((t, f, n_j), dtype=torch.int8, device=z.device)
        xcorr_int8(z, z, zj, zj)


# ---------------------------------------------------------------------------
# XEngine: the raced, accuracy-classed X engine (FX correlator X step;
# blocks.correlate routes here).  On ci8 voltage planes the int
# candidates are exact (int32 sums, bit-identical to the int64 oracle), so
# they race under every accuracy class.
# ---------------------------------------------------------------------------

#: accuracy class -> gate rtol against the complex64 baseline.  The
#: classes bound only the float candidates: planar's hi-lo truncation
#: (~2^-16) passes 'f32'; the one-pass bf16 candidate (~2^-8) needs
#: 'bf16' or wider.
XCORR_CLASSES = {'f32': 1e-3, 'bf16': 8e-3, 'int8': 4e-2}


def xcorr_class_rtol(accuracy):
    """Effective gate rtol for an accuracy class, honouring an explicit
    BF_XCORR_GATE_RTOL override."""
    try:
        env = os.environ.get('BF_XCORR_GATE_RTOL', '').strip()
        if env:
            return float(env)
    except ValueError:
        pass
    return XCORR_CLASSES[accuracy]


def _xe_xla(re, im):
    """The exactness baseline: complex64 einsum of x @ x^H over the time
    axis, (..., T, F, n) -> (..., F, n, n), without TF32."""
    import torch
    x = torch.complex(re.float(), im.float())
    with full_f32():
        return torch.einsum('...tfi,...tfj->...fij', x, x.conj())


def _xe_planar_with(mm):
    """Hermitian 3-product on (re, im) planes in the pre-transposed
    (F, n, T) @ (F, T, n) layout, with ``mm`` setting the precision:
    hi-lo (f32 class) or one-pass bf16 (lossy); without TF32."""
    def fn(re, im):
        import torch
        ar = re.float().movedim(-3, -1)             # (..., F, n, T)
        ai = im.float().movedim(-3, -1)
        br, bi = _swap(ar), _swap(ai)
        with full_f32():
            rr = mm(ar, br)
            ii = mm(ai, bi)
            k = mm(ai, br)
        return torch.complex(rr + ii, k - _swap(k))
    return fn


#: engine candidates over (T, F, n) voltage planes -> (F, n, n) c64.  The
#: int candidates reuse the xcorr layouts: int8_3mm the Hermitian
#: 3-product, int8_wide the widened gram product, pallas K7.
_XENGINE_IMPLS = {
    'xla': _xe_xla,
    'planar': _xe_planar_with(_mm_hilo),
    'planar_bf16': _xe_planar_with(_mm_bf16),
    'int8_3mm': lambda re, im: _xcorr_einsum3(re, im, re, im),
    'int8_wide': lambda re, im: _xcorr_gram(re, im, re, im),
    'pallas': lambda re, im: _xcorr_pallas(re, im, re, im),
}

#: candidates below the f32 accuracy class by construction: never
#: admitted without a passing gate measurement.  The int candidates are
#: not here: exact on int planes.
_XENGINE_LOSSY = frozenset(['planar_bf16'])

#: candidates that consume the int8 voltage planes directly (exact int32
#: accumulation)
_XENGINE_INT_IMPLS = frozenset(['int8_3mm', 'int8_wide', 'pallas'])


def _is_int(t):
    return not (t.is_floating_point() or t.is_complex())


def _dtype_name(t):
    return str(t.dtype).replace('torch.', '')


class XEngine(object):
    """Plan-style raced X engine (the port of the JAX package's).

    ``accuracy``: 'f32' (default) | 'bf16' | 'int8', the class float
    candidates must stay inside to race; int candidates are exact on ci8
    planes and race under every class.  ``impl`` (or ``BF_XCORR_IMPL``)
    forces a candidate, bypassing gate and race; ``BF_XCORR_GATE_RTOL``
    widens or narrows the class bound and becomes part of the probe-cache
    key.

    Calls take (re, im) voltage planes shaped (T, F, n), int8 (the ci8
    ring device rep, n = station * pol) or float, and return (F, n, n)
    complex64 visibilities integrated over T.  Planes (g, T, F, n) give
    (g, F, n, n), one matrix per group, chosen by the per-group shape
    (T, F, n): a prewarm at that shape covers every gulp.
    """

    def __init__(self, accuracy='f32', impl=None):
        if accuracy not in XCORR_CLASSES:
            raise ValueError('accuracy must be one of %s, got %r'
                             % (sorted(XCORR_CLASSES), accuracy))
        self.accuracy = accuracy
        self._force = impl or _force_env('BF_XCORR_IMPL',
                                         set(_XENGINE_IMPLS))
        self.chosen = {}
        self.probe_ms = {}

    # -- selection -------------------------------------------------------

    def _build(self, name):
        return _XENGINE_IMPLS[name]

    def _candidates(self, int_input, device=None):
        """Candidate names eligible at this input dtype, accuracy class
        and device.  Float voltages cannot feed the int8 candidates; on
        int planes they are exact and race at every class; K7 races only
        on the card."""
        rtol = xcorr_class_rtol(self.accuracy)
        names = ['xla', 'planar']
        if rtol >= XCORR_CLASSES['bf16']:
            names.append('planar_bf16')
        if int_input:
            names += ['int8_3mm', 'int8_wide']
            if self._pallas_raceable(device):
                names.append('pallas')
        return names

    @staticmethod
    def _pallas_raceable(device=None):
        """K7 races only where it runs natively: planes on a CUDA device
        (the process's device when ``device`` is None) on which the
        capability probe passes.  A forced impl runs it anywhere."""
        from .gpu_kernels import available
        return available(device)

    def _default(self, int_input):
        """Winner when no measurement is available: on int planes the
        Hermitian 3-product (exact); the complex64 baseline otherwise."""
        return 'int8_3mm' if int_input else 'xla'

    def _key(self, shape, dtype, int_input):
        rtol = xcorr_class_rtol(self.accuracy)
        key = 'acc=%s v=%s %s' % (self.accuracy, tuple(shape), dtype)
        if rtol != XCORR_CLASSES[self.accuracy]:
            key += '|gate_rtol=%g' % rtol
        return key

    def _gate(self, names, make_args):
        """(keep, had_errors): the candidates within the class rtol of the
        ``xla`` baseline at the actual shape, relative to the baseline's
        maximum.  The float candidates run without TF32 (:func:`full_f32`),
        so the baseline is a full float32 one.  Each candidate's output is
        reduced to its deviation at once, so one full output beside the
        baseline's is held at a time.  K7 is exact on the int planes it
        takes: an error from it, or a deviation outside the class, raises
        instead of dropping it from the race."""
        args = make_args()
        had_errors = False
        ref = None
        if 'xla' in names:
            try:
                ref = self._build('xla')(*args)
            except Exception:
                had_errors = True
        rtol = xcorr_class_rtol(self.accuracy)
        scale = (float(ref.abs().max()) or 1.0) if ref is not None else None
        keep = []
        for name in names:
            if name == 'xla':
                if ref is not None:
                    keep.append(name)
                continue
            try:
                y = self._build(name)(*args)
            except Exception:
                if name in _KERNEL_IMPLS:
                    raise
                had_errors = True
                continue
            if ref is None:
                if name not in _XENGINE_LOSSY:
                    keep.append(name)
            else:
                dev = float((y - ref).abs().max()) / scale
                if dev <= rtol:
                    keep.append(name)
                elif name in _KERNEL_IMPLS:
                    raise RuntimeError(
                        "XEngine: the CUDA kernel %r deviates from the xla "
                        "baseline by %.3g of its maximum (class %s allows "
                        "%g)" % (name, dev, self.accuracy, rtol))
            del y
        return keep, had_errors

    def _select(self, shape, dtype, int_input, make_args, device):
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
        cached = mprobe.peek('xengine', key)
        if cached is not None and cached[0] in names:
            self.chosen[key] = cached[0]
            self.probe_ms[key] = cached[1]
            return cached[0]
        keep, had_errors = self._gate(names, make_args)
        fns = {n: self._build(n) for n in keep}
        winner, ms, _err = mprobe.select('xengine', key, fns, make_args,
                                         persist=not had_errors,
                                         strict=_KERNEL_IMPLS)
        self.chosen[key] = winner or default
        if winner is not None:
            self.probe_ms[key] = ms
        return self.chosen[key]

    # -- public API ------------------------------------------------------

    def prewarm(self, t, f, n, int_input=True, seed=11):
        """Gate and race the candidates at the per-group shape (T, F, n)
        on random voltages on the process's device, so the first gulp
        finds the winner chosen: the probe cost lands at on_sequence,
        never on the first gulp.  Returns the winner (the class default
        when probing is off)."""
        import torch
        from ..device import get_device
        shape = (t, f, n)
        dtype = 'int8' if int_input else 'float32'
        if self._force or not _probe_wanted():
            name = self._force or self._default(int_input)
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
        """Correlate (T, F, n) or (g, T, F, n) voltage planes on the
        selected candidate: the winner of a prewarm at the per-group
        shape, a race now when probing is on, else the class default."""
        int_input = _is_int(re)
        shape = tuple(re.shape[-3:])
        dtype = _dtype_name(re)
        key = self._key(shape, dtype, int_input)
        name = self._force or self.chosen.get(key)
        if name is None:
            if _probe_wanted():
                first = (re, im) if re.dim() == 3 else (re[0], im[0])
                name = self._select(shape, dtype, int_input,
                                    lambda: first, re.device)
            else:
                name = self._default(int_input)
        return self._build(name)(re, im)

    def ops_per_frame(self, nfreq, n):
        """Real ops per time frame of the correlation product (one complex
        MAC = 8 real ops), the GOP/s accounting unit."""
        return 8 * nfreq * n * n
