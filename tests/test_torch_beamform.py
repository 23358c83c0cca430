"""The quantized coherent beamformer of the PyTorch/CUDA port
(bifrost_tpu_torch.ops.beamform, the K4/K5/K6 wrappers in
ops.gpu_kernels, ops.mprobe, BeamformStage/match_beamformer and
BeamformBlock) against the JAX package on the same seeded inputs: its
engine and candidates, its Pallas kernels in interpret mode (as
tests/test_beamform.py runs them on the CPU), its pipelines, and the
float64/int64 oracles.  The port runs on the CPU device here, where each
kernel wrapper runs its plain PyTorch version; the CUDA kernels are held
against those versions on the card (chip_smoke.py, tests/test_torch_cuda.py).

Tolerances: the int8 paths (K4, int8_wide, pallas) bit-identical; K5 and
the float candidates rel <= 1e-5 of the maximum against the JAX
counterpart (float32 sums in another order); K6 rel <= 1e-6 against JAX
and < 1e-5 against the quantized-weights oracle; the classes of
BEAM_CLASSES against the float64 oracle.
"""

import contextlib
import json
from copy import deepcopy

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import bifrost_tpu as bf
from bifrost_tpu.ops import beamform as jbeam
from bifrost_tpu.ops import pallas_kernels as pk
from bifrost_tpu.stages import (BeamformStage as JBeamformStage,
                                DetectStage as JDetect,
                                ReduceStage as JReduce,
                                compose_stages as jcompose,
                                walk_headers as jwalk)
from tests.util import NumpySourceBlock, GatherSink, simple_header

import bifrost_tpu_torch as bt
from bifrost_tpu_torch import device
from bifrost_tpu_torch.ops import gpu_kernels, mprobe
from bifrost_tpu_torch.ops.beamform import (Beamformer, BEAM_CLASSES,
                                            beam_class_rtol, fused_detect,
                                            quantize_weights,
                                            _wide_weight_block)
from bifrost_tpu_torch.stages import (BeamformStage, DetectStage,
                                      ReduceStage, SpectrometerPlan,
                                      compose_stages, match_beamformer,
                                      walk_headers)

LABELS = ['time', 'freq', 'station', 'pol']


@pytest.fixture(autouse=True)
def _cpu(monkeypatch, tmp_path):
    device.set_device('cpu')
    # no probe cache of another test or session leaks in
    monkeypatch.setenv('BF_CACHE_DIR', str(tmp_path / 'cache'))
    monkeypatch.setattr(mprobe, '_cache', {})
    monkeypatch.setattr(mprobe, '_flip_uses', {})
    for var in ('BF_BEAM_IMPL', 'BF_BEAM_GATE_RTOL', 'BF_BEAM_FUSED',
                'BF_LINALG_PROBE'):
        monkeypatch.delenv(var, raising=False)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


def _weights(B, S, P=None, seed=0):
    rng = np.random.RandomState(seed)
    shape = (B, S) if P is None else (P, B, S)
    return (rng.randn(*shape) + 1j * rng.randn(*shape)) \
        .astype(np.complex64)


def _volt_planes(T, F, P, S, seed=1, lim=64):
    rng = np.random.RandomState(seed)
    re = rng.randint(-lim, lim, (T, F, P, S)).astype(np.int8)
    im = rng.randint(-lim, lim, (T, F, P, S)).astype(np.int8)
    return re, im


def _oracle(re, im, w):
    """float64 oracle: (T, F, P, S) x (P, B, S) -> (T, F, P, B)."""
    x = re.astype(np.float64) + 1j * im.astype(np.float64)
    return np.einsum('tfps,pbs->tfpb', x, w.astype(np.complex128))


def _int64_oracle(wr, wi, re, im):
    r, i = re.astype(np.int64), im.astype(np.int64)
    a, c = wr.astype(np.int64), wi.astype(np.int64)
    dot = lambda v, w: np.einsum('tfs,bs->tfb', v, w)
    return dot(r, a) - dot(i, c), dot(r, c) + dot(i, a)


def _quantized_detect_oracle(eng, x, R):
    """float64 beamform -> Stokes -> R-frame sum with the engine's
    quantized weights (tests/test_beamform.py's oracle)."""
    wq = (eng.wr8.astype(np.float64) + 1j * eng.wi8.astype(np.float64)) \
        * eng.wscale
    if wq.shape[0] == 1:
        wq = np.repeat(wq, 2, axis=0)
    volt = x[..., 0].astype(np.float64) + 1j * x[..., 1].astype(np.float64)
    y = np.einsum('tfsp,pbs->tfpb', volt, wq)
    bx, by = y[:, :, 0], y[:, :, 1]
    xx, yy = np.abs(bx) ** 2, np.abs(by) ** 2
    xy = bx * np.conj(by)
    st = np.stack([xx + yy, xx - yy, 2 * xy.real, -2 * xy.imag], axis=2)
    T, F = x.shape[:2]
    return st.reshape(T // R, R, F, 4, -1).sum(axis=1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# weights: quantization, the widened block, state carried across
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('shape,seed', [((4, 8), 0), ((2, 6, 16), 1),
                                        ((2, 64, 256), 2)])
def test_quantize_and_wide_block_bit_identical_to_jax(shape, seed):
    rng = np.random.RandomState(seed)
    wr = rng.randn(*shape).astype(np.float32)
    wi = rng.randn(*shape).astype(np.float32)
    got = quantize_weights(wr, wi)
    want = jbeam.quantize_weights(wr, wi)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]
    assert got[0].dtype == np.int8 and got[0].min() >= -127
    wr8, wi8 = (g if g.ndim == 3 else g[None] for g in got[:2])
    block = _wide_weight_block(wr8, wi8)
    np.testing.assert_array_equal(block,
                                  jbeam._wide_weight_block(wr8, wi8))
    assert block.dtype == np.int8


@pytest.mark.parametrize('P', [None, 2])
def test_from_arrays_carries_a_jax_engine_across(P):
    w = _weights(5, 12, P)
    jeng = jbeam.Beamformer(w, accuracy='int8')
    eng = Beamformer(w, accuracy='int8')
    carried = Beamformer.from_arrays(jeng.wr, jeng.wi, jeng.wr8, jeng.wi8,
                                     jeng.wscale, accuracy='int8')
    for e in (eng, carried):
        for name in ('wr', 'wi', 'wr8', 'wi8'):
            np.testing.assert_array_equal(getattr(e, name),
                                          getattr(jeng, name))
        assert e.wscale == jeng.wscale
        assert (e.npol_w, e.nbeam, e.nstand) == \
            (jeng.npol_w, jeng.nbeam, jeng.nstand)
    re, im = _volt_planes(8, 2, 2, 12)
    np.testing.assert_array_equal(
        eng._fn('int8_wide', 2)(_t(re), _t(im)).numpy(),
        carried._fn('int8_wide', 2)(_t(re), _t(im)).numpy())


def test_invalid_accuracy_and_weights_rejected():
    with pytest.raises(ValueError):
        Beamformer(_weights(4, 8), accuracy='f16')
    with pytest.raises(ValueError):
        Beamformer(np.zeros(4, np.complex64))


# ---------------------------------------------------------------------------
# K4, K5, K6: plain versions against the JAX kernels and the oracles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('shape', [(8, 2, 8, 4), (16, 4, 16, 8)])
def test_k4_matches_jax_kernel_and_int64_oracle(shape):
    T, F, S, B = shape
    rng = np.random.RandomState(3)
    wr = rng.randint(-127, 128, (B, S)).astype(np.int8)
    wi = rng.randint(-127, 128, (B, S)).astype(np.int8)
    re = rng.randint(-128, 128, (T, F, S)).astype(np.int8)
    im = rng.randint(-128, 128, (T, F, S)).astype(np.int8)
    yr, yi = gpu_kernels.beamform_int8(_t(wr), _t(wi), _t(re), _t(im))
    assert yr.dtype == yi.dtype == torch.int32
    jr, ji = pk.beamform_int8(wr, wi, re, im, interpret=True)
    np.testing.assert_array_equal(yr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(yi.numpy(), np.asarray(ji))
    want_r, want_i = _int64_oracle(wr, wi, re, im)
    np.testing.assert_array_equal(yr.numpy().astype(np.int64), want_r)
    np.testing.assert_array_equal(yi.numpy().astype(np.int64), want_i)


def test_k4_reads_the_per_pol_views_of_a_gulp():
    """The strided (T, F, S) views BeamformStage takes of a
    (T, F, S, P, 2) gulp give the same planes as contiguous copies."""
    T, F, S, B = 6, 3, 8, 3
    rng = np.random.RandomState(8)
    x = rng.randint(-128, 128, (T, F, S, 2, 2)).astype(np.int8)
    wr = rng.randint(-127, 128, (B, S)).astype(np.int8)
    wi = rng.randint(-127, 128, (B, S)).astype(np.int8)
    xt = _t(x)
    for p in range(2):
        re, im = xt[:, :, :, p, 0], xt[:, :, :, p, 1]
        assert not re.is_contiguous()
        yr, yi = gpu_kernels.beamform_int8(_t(wr), _t(wi), re, im)
        want_r, want_i = _int64_oracle(wr, wi, x[:, :, :, p, 0],
                                       x[:, :, :, p, 1])
        np.testing.assert_array_equal(yr.numpy(), want_r)
        np.testing.assert_array_equal(yi.numpy(), want_i)


#: (re, im, wr, wi) patterns at the int8 extremes: every value -128, and
#: the mixes that drive yr or yi near 2 * S * 128^2
_K4_EXTREMES = [(-128, -128, -128, -128), (-128, -128, -128, 127),
                (-128, 127, -128, 127), (127, -128, 127, -128)]


@pytest.mark.parametrize('pattern', _K4_EXTREMES + ['mixed'])
def test_k4_exact_at_minus_128(pattern):
    """K4 (its plain version here) takes weights and voltages of -128,
    which int8 cannot negate: equal to the JAX kernel in interpret mode
    and to the int64 oracle, constant extremes and a random mix of
    -128, -127 and 127."""
    T, F, S, B = 8, 2, 24, 5
    if pattern == 'mixed':
        rng = np.random.RandomState(17)
        pick = lambda shape: rng.choice([-128, -127, 127], size=shape) \
            .astype(np.int8)
        re, im = pick((T, F, S)), pick((T, F, S))
        wr, wi = pick((B, S)), pick((B, S))
    else:
        full = lambda v, shape: np.full(shape, v, np.int8)
        re, im = full(pattern[0], (T, F, S)), full(pattern[1], (T, F, S))
        wr, wi = full(pattern[2], (B, S)), full(pattern[3], (B, S))
    yr, yi = gpu_kernels.beamform_int8(_t(wr), _t(wi), _t(re), _t(im))
    jr, ji = pk.beamform_int8(wr, wi, re, im, interpret=True)
    np.testing.assert_array_equal(yr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(yi.numpy(), np.asarray(ji))
    want_r, want_i = _int64_oracle(wr, wi, re, im)
    np.testing.assert_array_equal(yr.numpy().astype(np.int64), want_r)
    np.testing.assert_array_equal(yi.numpy().astype(np.int64), want_i)
    if pattern == (-128, -128, -128, -128):
        assert (want_i == 2 * S * 128 * 128).all() and (want_r == 0).all()


def test_k4_staging_path_follows_the_layout():
    """K4 takes its 16-byte staging only where the int8 pairs sit in
    16-byte rows: the per-pol views of a dual-pol gulp and the one pol of
    a (T, F, S, 1, 2) gulp with S a multiple of 8; separate planes, rows
    off 16 bytes and a pair across a station word take the scalar
    staging.  K5's rule is the same for int8 voltages."""
    x = torch.zeros((4, 2, 8, 2, 2), dtype=torch.int8)
    base = x.data_ptr() % 16
    assert gpu_kernels.int8_staging(x[..., 0, 0], x[..., 0, 1]) == (4, base)
    assert gpu_kernels.int8_staging(x[..., 1, 0], x[..., 1, 1]) == \
        (4, base + 2)
    one = torch.zeros((4, 2, 8, 1, 2), dtype=torch.int8)
    assert gpu_kernels.int8_staging(one[..., 0, 0], one[..., 0, 1])[0] == 2
    odd = torch.zeros((4, 2, 6, 1, 2), dtype=torch.int8)
    assert gpu_kernels.int8_staging(odd[..., 0, 0], odd[..., 0, 1]) == \
        (0, 0)
    planes = torch.zeros((2, 4, 2, 8), dtype=torch.int8)
    assert gpu_kernels.int8_staging(planes[0], planes[1]) == (0, 0)
    flat = torch.zeros(4 + x.numel(), dtype=torch.int8)
    off = flat[4:].view(x.shape)
    assert gpu_kernels.int8_staging(off[..., 0, 0], off[..., 0, 1]) == (0, 0)
    # re and im swapped: im is not one byte after re
    assert gpu_kernels.int8_staging(x[..., 0, 1], x[..., 0, 0]) == (0, 0)
    # a view from the third frame of a gulp 16 bytes into its buffer
    lead = torch.zeros(16 + 6 * 2 * 8 * 4, dtype=torch.int8)
    g = lead[16:].view(6, 2, 8, 2, 2)[2:]
    assert gpu_kernels.int8_staging(g[..., 1, 0], g[..., 1, 1]) == \
        (4, (g.data_ptr() + 2) % 16)
    for re, im in ((x[..., 0, 0], x[..., 0, 1]), (x[..., 1, 0], x[..., 1, 1]),
                   (one[..., 0, 0], one[..., 0, 1]),
                   (odd[..., 0, 0], odd[..., 0, 1]), (planes[0], planes[1]),
                   (off[..., 0, 0], off[..., 0, 1])):
        assert gpu_kernels.bf16_staging(re, im) == \
            gpu_kernels.int8_staging(re, im)


@pytest.mark.parametrize('vtype', ['int8', 'float32'])
def test_k5_matches_jax_kernel_and_oracle(vtype):
    T, F, S, B = 16, 2, 16, 4
    rng = np.random.RandomState(4)
    wr = rng.randn(B, S).astype(np.float32)
    wi = rng.randn(B, S).astype(np.float32)
    if vtype == 'int8':
        re = rng.randint(-64, 64, (T, F, S)).astype(np.int8)
        im = rng.randint(-64, 64, (T, F, S)).astype(np.int8)
    else:
        re = (rng.randn(T, F, S) * 20).astype(np.float32)
        im = (rng.randn(T, F, S) * 20).astype(np.float32)
    yr, yi = gpu_kernels.beamform_bf16(_t(wr), _t(wi), _t(re), _t(im))
    assert yr.dtype == torch.float32
    got = yr.numpy() + 1j * yi.numpy()
    jr, ji = pk.beamform_bf16(wr, wi, re, im, interpret=True)
    assert _rel(got, np.asarray(jr) + 1j * np.asarray(ji)) <= 1e-5
    x = re.astype(np.float64) + 1j * im.astype(np.float64)
    ref = np.einsum('tfs,bs->tfb', x, wr.astype(np.float64) +
                    1j * wi.astype(np.float64))
    assert _rel(got, ref) <= BEAM_CLASSES['bf16']


@pytest.mark.parametrize('pol', [0, 1])
def test_k5_reads_the_per_pol_views_of_a_gulp(pol):
    """The per-pol views of a (T, F, S, 2, 2) ci8 gulp, the layout K5's
    16-byte staging reads on the card (the pair at byte 2 * pol of each
    4-byte station word, 16-byte rows), against the JAX kernel on the same
    views and the float64 oracle."""
    T, F, S, B = 12, 3, 24, 5
    rng = np.random.RandomState(11 + pol)
    x = rng.randint(-128, 128, (T, F, S, 2, 2)).astype(np.int8)
    wr = rng.randn(B, S).astype(np.float32)
    wi = rng.randn(B, S).astype(np.float32)
    xt = _t(x)
    re, im = xt[:, :, :, pol, 0], xt[:, :, :, pol, 1]
    assert gpu_kernels.bf16_staging(re, im) == (4, (xt.data_ptr() + 2 * pol)
                                                % 16)
    yr, yi = gpu_kernels.beamform_bf16(_t(wr), _t(wi), re, im)
    got = yr.numpy() + 1j * yi.numpy()
    jr, ji = pk.beamform_bf16(wr, wi, x[:, :, :, pol, 0], x[:, :, :, pol, 1],
                              interpret=True)
    assert _rel(got, np.asarray(jr) + 1j * np.asarray(ji)) <= 1e-5
    v = x[:, :, :, pol, 0].astype(np.float64) + \
        1j * x[:, :, :, pol, 1].astype(np.float64)
    ref = np.einsum('tfs,bs->tfb', v, wr.astype(np.float64) +
                    1j * wi.astype(np.float64))
    assert _rel(got, ref) <= BEAM_CLASSES['bf16']


def test_k5_staging_path_follows_the_layout():
    """K5 takes its 16-byte staging only where the int8 pairs sit in
    16-byte rows: the per-pol views of a dual-pol gulp and the one pol of
    a (T, F, S, 1, 2) gulp with S a multiple of 8; separate planes, float32
    voltages, rows off 16 bytes and a pair across a station word take the
    scalar staging."""
    x = torch.zeros((4, 2, 8, 2, 2), dtype=torch.int8)
    base = x.data_ptr() % 16
    assert gpu_kernels.bf16_staging(x[..., 0, 0], x[..., 0, 1]) == (4, base)
    assert gpu_kernels.bf16_staging(x[..., 1, 0], x[..., 1, 1]) == \
        (4, base + 2)
    one = torch.zeros((4, 2, 8, 1, 2), dtype=torch.int8)
    assert gpu_kernels.bf16_staging(one[..., 0, 0], one[..., 0, 1])[0] == 2
    odd = torch.zeros((4, 2, 6, 1, 2), dtype=torch.int8)
    assert gpu_kernels.bf16_staging(odd[..., 0, 0], odd[..., 0, 1]) == \
        (0, 0)
    planes = torch.zeros((2, 4, 2, 8), dtype=torch.int8)
    assert gpu_kernels.bf16_staging(planes[0], planes[1]) == (0, 0)
    assert gpu_kernels.bf16_staging(x[..., 0, 0].float(),
                                    x[..., 0, 1].float()) == (0, 0)
    flat = torch.zeros(4 + x.numel(), dtype=torch.int8)
    off = flat[4:].view(x.shape)
    assert gpu_kernels.bf16_staging(off[..., 0, 0], off[..., 0, 1]) == (0, 0)
    # re and im swapped: im is not one byte after re
    assert gpu_kernels.bf16_staging(x[..., 0, 1], x[..., 0, 0]) == (0, 0)


@pytest.mark.parametrize('R,P', [(1, None), (4, None), (16, None),
                                 (4, 2)])
def test_k6_matches_jax_fused_detect_and_oracle(R, P):
    T, F, S, B = 16, 3, 8, 4
    w = _weights(B, S, P)
    eng = Beamformer(w, accuracy='int8')
    jeng = jbeam.Beamformer(w, accuracy='int8')
    rng = np.random.RandomState(6)
    x = rng.randint(-64, 64, (T, F, S, 2, 2)).astype(np.int8)
    got = fused_detect(eng, _t(x), R).numpy()
    assert got.shape == (T // R, F, 4, B) and got.dtype == np.float32
    want = np.asarray(jbeam.fused_detect(jeng, x, R))
    assert _rel(got, want) <= 1e-6
    assert _rel(got, _quantized_detect_oracle(eng, x, R)) < 1e-5


def test_k6_plain_is_the_frame_ordered_sum_of_the_unfused_steps():
    """The plain version takes the kernel's steps in the kernel's order:
    the same value as beamform (int8) -> Stokes -> sum over frames."""
    T, F, S, B, R = 8, 2, 8, 3, 4
    rng = np.random.RandomState(9)
    wts = [_t(rng.randint(-127, 128, (B, S)).astype(np.int8))
           for _ in range(4)]
    x = _t(rng.randint(-128, 128, (T, F, S, 2, 2)).astype(np.int8))
    scale = 0.0123
    got = gpu_kernels.beamform_detect_int8(*wts, x, scale, R)
    beams = []
    for p in range(2):
        yr, yi = gpu_kernels.beamform_int8(wts[2 * p], wts[2 * p + 1],
                                           x[:, :, :, p, 0],
                                           x[:, :, :, p, 1])
        beams.append(torch.complex(yr.float() * scale, yi.float() * scale))
    y = torch.stack(beams, dim=2)
    st = gpu_kernels.stokes_detect_plain(
        y.real.select(2, 0).reshape(-1, B), y.imag.select(2, 0).reshape(
            -1, B), y.real.select(2, 1).reshape(-1, B),
        y.imag.select(2, 1).reshape(-1, B)).reshape(T, F, 4, B)
    want = st.reshape(T // R, R, F, 4, B)
    acc = want[:, 0]
    for r in range(1, R):
        acc = acc + want[:, r]
    assert torch.equal(got, acc)


def test_wrappers_reject_what_the_kernels_cannot_take():
    i8 = torch.zeros((4, 8), dtype=torch.int8)
    v8 = torch.zeros((2, 3, 8), dtype=torch.int8)
    with pytest.raises(ValueError):          # float weights for K4
        gpu_kernels.beamform_int8(i8.float(), i8.float(), v8, v8)
    with pytest.raises(ValueError):          # station counts differ
        gpu_kernels.beamform_int8(i8, i8, v8[..., :4], v8[..., :4])
    with pytest.raises(ValueError):          # int8 weights for K5
        gpu_kernels.beamform_bf16(i8, i8, v8, v8)
    x = torch.zeros((4, 3, 8, 2, 2), dtype=torch.int8)
    with pytest.raises(ValueError):          # R does not divide T
        gpu_kernels.beamform_detect_int8(i8, i8, i8, i8, x, 1.0, 3)
    with pytest.raises(ValueError):          # not a dual-pol ci8 gulp
        gpu_kernels.beamform_detect_int8(i8, i8, i8, i8, x[:, :, :, :1],
                                         1.0, 2)


# ---------------------------------------------------------------------------
# the engine's candidates, forced, against the JAX engine's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('name', ['xla', 'planar', 'planar_bf16',
                                  'pallas_bf16', 'int8_wide', 'pallas'])
@pytest.mark.parametrize('shape', [(8, 2, 1, 8), (16, 3, 2, 24)])
def test_forced_candidate_matches_jax_candidate(name, shape):
    T, F, P, S = shape
    B = 6
    w = _weights(B, S, P if P > 1 else None)
    eng = Beamformer(w, accuracy='int8', impl=name)
    jeng = jbeam.Beamformer(w, accuracy='int8')
    re, im = _volt_planes(T, F, P, S)
    got = eng(_t(re), _t(im))
    assert got.dtype == torch.complex64 and got.shape == (T, F, P, B)
    assert eng.chosen == {} and eng._force == name
    want = np.asarray(jeng._jit(name, P)(re, im))
    if name in ('int8_wide', 'pallas'):
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        assert _rel(got.numpy(), want) <= 1e-5
    ref = _oracle(re, im, w if w.ndim == 3 else w[None])
    bound = {'xla': 1e-5, 'planar': 1e-3}.get(
        name, BEAM_CLASSES['bf16'] if 'bf16' in name
        else BEAM_CLASSES['int8'])
    assert _rel(got.numpy(), ref) <= bound


def test_int8_planes_exact_with_padding():
    """int8_wide pads the _int_mm operands to the card's multiples of 8
    (and more than 16 rows); the integer core stays bit-identical to the
    int64 oracle at widths that need the padding."""
    T, F, P, S, B = 3, 2, 2, 5, 3
    w = _weights(B, S, P)
    eng = Beamformer(w, accuracy='int8')
    re, im = _volt_planes(T, F, P, S, lim=127)
    w2 = _t(_wide_weight_block(eng.wr8, eng.wi8))
    yr, yi = Beamformer.int8_planes(_t(re), _t(im), w2, B)
    for p in range(P):
        want_r, want_i = _int64_oracle(eng.wr8[p], eng.wi8[p],
                                       re[:, :, p], im[:, :, p])
        np.testing.assert_array_equal(yr[:, :, p].numpy(), want_r)
        np.testing.assert_array_equal(yi[:, :, p].numpy(), want_i)


# ---------------------------------------------------------------------------
# classes, the gate and the overrides
# ---------------------------------------------------------------------------

def test_candidate_eligibility_per_class(monkeypatch):
    w = _weights(4, 8, 2)
    card = torch.device('cuda', 0)
    # a card on which the capability probe K0 has passed
    monkeypatch.setattr(gpu_kernels, '_available_on', {card})
    assert Beamformer(w, accuracy='f32')._candidates(True) == \
        ['xla', 'planar']
    assert Beamformer(w, accuracy='f32')._candidates(True, card) == \
        ['xla', 'planar']
    bf16 = Beamformer(w, accuracy='bf16')
    assert bf16._candidates(True) == ['xla', 'planar', 'planar_bf16']
    assert bf16._candidates(True, card) == ['xla', 'planar', 'planar_bf16',
                                            'pallas_bf16']
    i8 = Beamformer(w, accuracy='int8')
    # the kernels race only where the voltages are on the card and K0
    # passed there
    assert i8._candidates(True) == ['xla', 'planar', 'planar_bf16',
                                    'int8_wide']
    assert i8._candidates(True, card) == ['xla', 'planar', 'planar_bf16',
                                          'pallas_bf16', 'int8_wide',
                                          'pallas']
    # float input can never feed the int8 candidates
    assert 'int8_wide' not in i8._candidates(False, card)
    assert 'pallas' not in i8._candidates(False, card)
    # the same classes as the JAX engine off the TPU
    for acc in ('f32', 'bf16', 'int8'):
        assert Beamformer(w, accuracy=acc)._candidates(True) == \
            jbeam.Beamformer(w, accuracy=acc)._candidates(True)


@pytest.mark.parametrize('kernel', ['beamform_int8', 'beamform_bf16'])
def test_kernel_error_in_race_raises(monkeypatch, kernel):
    """A kernel that the capability probe admitted and that then fails
    raises from the gate, instead of the race going on without it."""
    monkeypatch.setattr(gpu_kernels, 'available', lambda device=None: True)
    monkeypatch.setenv('BF_LINALG_PROBE', '1')

    def launch_failure(*args):
        raise RuntimeError('CUDA error 719: unspecified launch failure')
    monkeypatch.setattr(gpu_kernels, kernel, launch_failure)
    with pytest.raises(RuntimeError, match='launch failure'):
        Beamformer(_weights(4, 8, 2), accuracy='int8').prewarm(8, 2)


def test_gate_rejects_lossy_candidate_at_default_rtol():
    T, F, P, S, B = 32, 4, 2, 32, 8
    w = _weights(B, S, P)
    eng = Beamformer(w, accuracy='f32')
    re, im = _volt_planes(T, F, P, S)
    args = (_t(re), _t(im))
    keep, had_errors = eng._gate(['xla', 'planar', 'planar_bf16'], P,
                                 lambda: args)
    assert not had_errors
    assert 'xla' in keep and 'planar' in keep
    assert 'planar_bf16' not in keep
    jkeep, _ = jbeam.Beamformer(w, accuracy='f32')._gate(
        ['xla', 'planar', 'planar_bf16'], P,
        lambda: (jnp.asarray(re), jnp.asarray(im)))
    assert sorted(keep) == sorted(jkeep)


def test_gate_rtol_env_override(monkeypatch):
    monkeypatch.setenv('BF_BEAM_GATE_RTOL', '0.5')
    assert beam_class_rtol('f32') == 0.5
    monkeypatch.delenv('BF_BEAM_GATE_RTOL')
    assert beam_class_rtol('f32') == BEAM_CLASSES['f32'] == 1e-3
    eng = Beamformer(_weights(4, 8), accuracy='f32')
    k_default = eng._key((8, 2, 1, 8), 'int8', True)
    monkeypatch.setenv('BF_BEAM_GATE_RTOL', '0.5')
    k_wide = eng._key((8, 2, 1, 8), 'int8', True)
    assert k_default != k_wide and 'gate_rtol' in k_wide
    # a widened f32 engine admits the lossy candidates
    assert 'int8_wide' in eng._candidates(True)
    jeng = jbeam.Beamformer(_weights(4, 8), accuracy='f32')
    assert k_wide == jeng._key((8, 2, 1, 8), 'int8', True)


def test_bf_beam_impl_forces_candidate(monkeypatch):
    monkeypatch.setenv('BF_BEAM_IMPL', 'int8_wide')
    w = _weights(4, 8, 2)
    eng = Beamformer(w, accuracy='f32')
    assert eng._force == 'int8_wide'
    re, im = _volt_planes(8, 2, 2, 8)
    y = eng(_t(re), _t(im)).numpy()
    assert eng.prewarm(8, 2, npol=2) == 'int8_wide'
    assert _rel(y, _oracle(re, im, w)) <= BEAM_CLASSES['int8']
    monkeypatch.setenv('BF_BEAM_IMPL', 'no-such-impl')
    assert Beamformer(w)._force is None
    assert Beamformer(w, accuracy='f32', impl='planar')._force == 'planar'


def test_unprobed_default_per_class():
    """Probing is off on the CPU: the class default runs, int8_wide under
    the 'int8' class on int input, the baseline otherwise (the JAX
    engine's choice off the TPU)."""
    w = _weights(4, 8, 2)
    re, im = _volt_planes(8, 2, 2, 8)
    for acc in ('f32', 'int8'):
        eng = Beamformer(w, accuracy=acc)
        jeng = jbeam.Beamformer(w, accuracy=acc)
        want = 'int8_wide' if acc == 'int8' else 'xla'
        assert eng.prewarm(8, 2, npol=2) == want == \
            jeng.prewarm(8, 2, npol=2)
        np.testing.assert_allclose(eng(_t(re), _t(im)).numpy(),
                                   np.asarray(jeng(re, im)), rtol=1e-5,
                                   atol=1e-5 * np.abs(np.asarray(
                                       jeng(re, im))).max())


def test_ops_accounting():
    eng = Beamformer(_weights(4, 8, 2), accuracy='int8')
    assert eng.ops_per_frame(nfreq=16) == 8 * 16 * 2 * 4 * 8
    assert eng.ops_per_frame(nfreq=16, npol=1) == 8 * 16 * 1 * 4 * 8


# ---------------------------------------------------------------------------
# measured selection (ops/mprobe.py) and the engine's race
# ---------------------------------------------------------------------------

def _sleeper(ms):
    import time

    def fn(*args):
        time.sleep(ms / 1e3)
    return fn


def test_mprobe_winner_persists_and_is_peeked_back(tmp_path):
    key = 'shape=(8,)'
    winner, ms, errors = mprobe.select(
        'fam', key, {'slow': _sleeper(20), 'fast': _sleeper(0)},
        lambda: (), n_reps=2, n_calls=1)
    assert winner == 'fast' and not errors
    assert set(ms) == {'slow', 'fast'}
    path = mprobe.cache_path('fam')
    assert path == str(tmp_path / 'cache' / 'fam.json')
    with open(path) as f:
        disk = json.load(f)
    full_key = '%s|%s' % (mprobe.backend_tag(), key)
    assert disk[full_key]['winner'] == 'fast'
    # a fresh process (empty in-process cache) peeks it from disk
    mprobe._cache.clear()
    assert mprobe.peek('fam', key)[0] == 'fast'
    assert mprobe.peek('fam', 'another-shape') is None


def test_mprobe_persists_nothing_when_a_candidate_raises():
    def boom(*args):
        raise RuntimeError('no kernel here')

    winner, ms, errors = mprobe.select(
        'fam', 'k', {'ok': _sleeper(0), 'bad': boom}, lambda: (),
        n_reps=1, n_calls=1)
    assert winner == 'ok' and 'bad' in errors and 'bad' not in ms
    assert not __import__('os').path.exists(mprobe.cache_path('fam'))
    # nor when the caller says its measurement is incomplete
    mprobe.select('fam', 'k2', {'ok': _sleeper(0)}, lambda: (),
                  n_reps=1, n_calls=1, persist=False)
    assert not __import__('os').path.exists(mprobe.cache_path('fam'))


def test_mprobe_key_holds_the_device_and_own_cache_dir(monkeypatch):
    from bifrost_tpu.ops import mprobe as jprobe
    tag = mprobe.backend_tag()
    assert tag == 'torch-cpu:cpu:v%s' % bt.__version__
    assert tag != jprobe.backend_tag()
    monkeypatch.delenv('BF_CACHE_DIR')
    assert mprobe.cache_path('beamform').endswith(
        '.bifrost_tpu_torch/beamform.json')
    assert mprobe.cache_path('beamform') != jprobe.cache_path('beamform')


def test_mprobe_coin_flip_is_raced_again(monkeypatch):
    monkeypatch.setenv('BF_MPROBE_REPROBE', '2')
    calls = {'a': 0, 'b': 0}

    def counting(name):
        def fn():
            calls[name] += 1
        return fn
    cands = {'a': counting('a'), 'b': counting('b')}
    mprobe._cache['fam'] = {'%s|k' % mprobe.backend_tag():
                            ('a', {'a': 1.0, 'b': 1.05}, {})}
    assert mprobe.select('fam', 'k', cands, lambda: ())[0] == 'a'
    assert calls == {'a': 0, 'b': 0}          # served from the cache
    mprobe.select('fam', 'k', cands, lambda: (), n_reps=1, n_calls=1)
    assert calls['a'] > 0 and calls['b'] > 0  # budget spent: re-raced


def _decisive_races(monkeypatch):
    """Every race writes its ranking to disk: with a noise threshold of
    1.0 no ranking is a coin flip, however close the candidates' times
    come on a loaded host."""
    real = mprobe.select
    monkeypatch.setattr(mprobe, 'select',
                        lambda *a, **k: real(*a, **dict(k, noise=1.0)))


def test_engine_race_gates_then_times_and_caches(monkeypatch):
    """With probing on, prewarm gates the candidates against the
    baseline, races the survivors and caches the winner under the
    port's backend tag; a second engine peeks it without measuring."""
    monkeypatch.setenv('BF_LINALG_PROBE', '1')
    _decisive_races(monkeypatch)
    w = _weights(4, 8, 2)
    eng = Beamformer(w, accuracy='bf16')
    winner = eng.prewarm(16, 2, npol=2)
    assert winner in ('xla', 'planar', 'planar_bf16')
    key = eng._key((16, 2, 2, 8), 'int8', True)
    assert eng.chosen[key] == winner
    assert set(eng.probe_ms[key]) <= {'xla', 'planar', 'planar_bf16'}
    with open(mprobe.cache_path('beamform')) as f:
        disk = json.load(f)
    assert all(k.startswith('torch-cpu:cpu:') for k in disk)
    again = Beamformer(w, accuracy='bf16')
    monkeypatch.setattr(again, '_gate', None)      # must not measure
    assert again.prewarm(16, 2, npol=2) in (winner, 'xla')


# ---------------------------------------------------------------------------
# match_beamformer (tests/test_beamform.py:379-437, device-free)
# ---------------------------------------------------------------------------

def _chain(w, accuracy='int8', impl=None, mode='stokes', R=4):
    return [BeamformStage(w, accuracy=accuracy, impl=impl),
            DetectStage(mode, axis='pol'), ReduceStage('time', R)]


def _match(stages, T=8, F=2, S=4, P=2):
    hdr = simple_header([-1, F, S, P], 'ci8', labels=LABELS)
    return match_beamformer(stages, walk_headers(stages, hdr),
                            (T, F, S, P, 2), torch.int8)


def test_match_beamformer_accepts_int8_class_on_any_device():
    w = _weights(3, 4)
    plan = _match(_chain(w))
    assert isinstance(plan, SpectrometerPlan)
    assert plan.info == {'impl': 'cuda-beamform-detect', 'kernel': 'plain',
                         'rfactor': 4, 'nbeam': 3, 'accuracy': 'int8',
                         'wscale': float(Beamformer(w).wscale)}
    x = np.random.RandomState(1).randint(-64, 64, (8, 2, 4, 2, 2)) \
        .astype(np.int8)
    got = plan(_t(x)).numpy()
    assert got.shape == (2, 2, 4, 3)
    assert _rel(got, _quantized_detect_oracle(Beamformer(w, 'int8'), x,
                                              4)) < 1e-5


@pytest.mark.parametrize('fused_mode,accuracy,impl,matches', [
    ('auto', 'f32', None, False),
    ('auto', 'bf16', None, False),
    ('auto', 'f32', 'pallas', True),
    ('auto', 'int8', None, True),
    ('force', 'f32', None, True),
    ('off', 'int8', None, False),
    ('off', 'f32', 'pallas', False),
])
def test_match_beamformer_fused_mode(monkeypatch, fused_mode, accuracy,
                                     impl, matches):
    monkeypatch.setenv('BF_BEAM_FUSED', fused_mode)
    plan = _match(_chain(_weights(3, 4), accuracy=accuracy, impl=impl))
    assert (plan is not None) == matches


def test_match_beamformer_rejects_other_chains():
    w = _weights(3, 4)
    # wrong detect mode (the JAX test's coherence case is not ported:
    # scalar on a pol-less chain stands in for it)
    hdr = simple_header([-1, 2, 4], 'ci8',
                        labels=['time', 'freq', 'station'])
    st = [BeamformStage(w, accuracy='int8'), DetectStage('scalar'),
          ReduceStage('time', 4)]
    assert match_beamformer(st, walk_headers(st, hdr), (8, 2, 4, 2),
                            torch.int8) is None
    # complex float voltages: the kernel reads ci8 only
    st = _chain(w)
    hdr = simple_header([-1, 2, 4, 2], 'cf32', labels=LABELS)
    assert match_beamformer(st, walk_headers(st, hdr), (8, 2, 4, 2),
                            torch.complex64) is None
    # R does not divide the gulp
    assert _match(_chain(w, R=3)) is None
    # reduce over frequency, not frames
    st = [BeamformStage(w, accuracy='int8'),
          DetectStage('stokes', axis='pol'), ReduceStage('freq', 2)]
    assert _match(st) is None
    # two stages only
    assert _match(_chain(w)[:2]) is None


def test_block_rejects_bad_streams():
    st = BeamformStage(_weights(4, 8))
    with pytest.raises(ValueError):
        st.transform_header(simple_header(
            [-1, 4, 8], 'ci8', labels=['time', 'station', 'freq']))
    with pytest.raises(TypeError):
        st.transform_header(simple_header(
            [-1, 4, 8], 'f32', labels=['time', 'freq', 'station']))
    with pytest.raises(ValueError):
        st.transform_header(simple_header(
            [-1, 4, 6], 'ci8', labels=['time', 'freq', 'station']))


@pytest.mark.parametrize('labels,shape,w_shape,out_labels', [
    (LABELS, [-1, 2, 4, 2], (3, 4), ['time', 'freq', 'pol', 'beam']),
    (LABELS, [-1, 2, 4, 2], (2, 3, 4), ['time', 'freq', 'pol', 'beam']),
    (LABELS, [-1, 2, 4, 2], (3, 8), ['time', 'freq', 'beam']),
    (['time', 'freq', 'station'], [-1, 2, 4], (3, 4),
     ['time', 'freq', 'beam']),
])
def test_header_and_one_gulp_match_jax(labels, shape, w_shape, out_labels):
    """BeamformStage's header and gulp in all three modes, through both
    packages' compose_stages with the stage alone."""
    rng = np.random.RandomState(2)
    w = (rng.randn(*w_shape) + 1j * rng.randn(*w_shape)).astype(
        np.complex64)
    hdr = simple_header(shape, 'ci8', labels=labels)
    T = 8
    x = rng.randint(-64, 64, [T] + shape[1:] + [2]).astype(np.int8)
    stages = [BeamformStage(w, accuracy='int8')]
    jstages = [JBeamformStage(w, accuracy='int8')]
    headers = walk_headers(stages, deepcopy(hdr))
    jheaders = jwalk(jstages, deepcopy(hdr))
    assert headers[-1]['_tensor'] == jheaders[-1]['_tensor']
    assert headers[-1]['_tensor']['labels'] == out_labels
    fn, info = compose_stages(stages, headers, x.shape, torch.int8)
    jfn, _ = jcompose(jstages, jheaders, x.shape, 'int8')
    np.testing.assert_array_equal(fn(_t(x)).numpy(),
                                  np.asarray(jfn(jnp.asarray(x))))
    assert info == {'impl': 'torch-fused'}


@pytest.mark.parametrize('substitute', [True, False])
def test_compose_chain_matches_jax(monkeypatch, substitute):
    """One gulp of beamform -> Stokes (pol axis 2) -> frame sum through
    both packages' compose_stages: the K6 substitution and the per-stage
    path (DetectStage and ReduceStage on the (T, F, P, B) layout)."""
    monkeypatch.setenv('BF_BEAM_FUSED', 'force')
    T, F, S, P, B, R = 16, 2, 8, 2, 4, 4
    w = _weights(B, S)
    hdr = simple_header([-1, F, S, P], 'ci8', labels=LABELS)
    x = np.random.RandomState(4).randint(-64, 64, (T, F, S, P, 2)) \
        .astype(np.int8)
    stages = _chain(w, R=R)
    jstages = [JBeamformStage(w, accuracy='int8'),
               JDetect('stokes', axis='pol'), JReduce('time', R)]
    headers = walk_headers(stages, deepcopy(hdr))
    jheaders = jwalk(jstages, deepcopy(hdr))
    assert headers[-1]['_tensor'] == jheaders[-1]['_tensor']
    fn, info = compose_stages(stages, headers, x.shape, torch.int8,
                              substitute=substitute)
    jfn, jinfo = jcompose(jstages, jheaders, x.shape, 'int8',
                          substitute=substitute)
    got = fn(_t(x)).numpy()
    want = np.asarray(jfn(jnp.asarray(x)))
    assert got.shape == want.shape == (T // R, F, 4, B)
    assert _rel(got, want) <= 1e-6
    assert info['impl'] == ('cuda-beamform-detect' if substitute
                            else 'torch-fused')
    assert jinfo['impl'] == ('pallas-beamform-detect' if substitute
                             else 'xla-fused')
    eng = stages[0].engine
    assert _rel(got, _quantized_detect_oracle(eng, x, R)) < 1e-5


# ---------------------------------------------------------------------------
# both pipelines through bt.Pipeline against the JAX pipelines
# ---------------------------------------------------------------------------

T_, F_, S_, P_, B_, R_, NGULP = 16, 2, 8, 2, 4, 4, 3
ci8_np = np.dtype([('re', 'i1'), ('im', 'i1')])


def _ci8_gulps(seed=5, lim=32):
    rng = np.random.RandomState(seed)
    gulps = []
    for _ in range(NGULP):
        raw = np.zeros((T_, F_, S_, P_), dtype=ci8_np)
        raw['re'] = rng.randint(-lim, lim, raw.shape)
        raw['im'] = rng.randint(-lim, lim, raw.shape)
        gulps.append(raw)
    return gulps


def _header():
    return simple_header([-1, F_, S_, P_], 'ci8', labels=LABELS)


class _Source(bt.SourceBlock):
    def __init__(self, gulps, header):
        super(_Source, self).__init__(['numpy'], T_, space='system')
        self._gulps = gulps
        self._header = header

    def create_reader(self, sourcename):
        return contextlib.nullcontext(iter(self._gulps))

    def on_sequence(self, reader, sourcename):
        return [deepcopy(self._header)]

    def on_data(self, reader, ospans):
        arr = next(reader, None)
        if arr is None:
            return [0]
        ospans[0].data.as_numpy()[:arr.shape[0]] = arr
        return [arr.shape[0]]


class _Gather(bt.SinkBlock):
    def __init__(self, iring):
        super(_Gather, self).__init__(iring)
        self.headers, self.gulps = [], []

    def on_sequence(self, iseq):
        self.headers.append(iseq.header)

    def on_data(self, ispan):
        self.gulps.append(np.array(ispan.data.as_numpy(), copy=True))


def _port_pipeline(gulps, w, fused_chain, accuracy='int8', impl=None):
    with bt.Pipeline() as p:
        src = _Source(gulps, _header())
        b = bt.blocks.copy(src, space='cuda')
        if fused_chain:
            b = blk = bt.blocks.fused(
                b, [BeamformStage(w, accuracy=accuracy, impl=impl),
                    DetectStage('stokes', axis='pol'),
                    ReduceStage('time', R_)])
        else:
            blk = bt.blocks.beamform(b, w, accuracy=accuracy, impl=impl)
            b = bt.blocks.fused(blk, [DetectStage('stokes', axis='pol'),
                                      ReduceStage('time', R_)])
        b = bt.blocks.copy(b, space='system')
        sink = _Gather(b)
        p.run()
    return np.concatenate(sink.gulps), sink.headers[0], blk


def _jax_pipeline(gulps, w, fused_chain, accuracy='int8', impl=None):
    with bf.Pipeline() as p:
        src = NumpySourceBlock(gulps, _header(), gulp_nframe=T_)
        b = bf.blocks.copy(src, space='tpu')
        if fused_chain:
            b = bf.blocks.fused(
                b, [JBeamformStage(w, accuracy=accuracy, impl=impl),
                    JDetect('stokes', axis='pol'), JReduce('time', R_)])
        else:
            b = bf.blocks.beamform(b, w, accuracy=accuracy, impl=impl)
            b = bf.blocks.fused(b, [JDetect('stokes', axis='pol'),
                                    JReduce('time', R_)])
        b = bf.blocks.copy(b, space='system')
        sink = GatherSink(b)
        p.run()
    return sink.result(), sink.headers[0]


@pytest.mark.parametrize('arm', ['fused', 'block-int8', 'block-pallas',
                                 'block-pallas_bf16', 'block-f32'])
def test_pipeline_matches_jax_pipeline(monkeypatch, arm):
    monkeypatch.setenv('BF_BEAM_FUSED', 'force')   # K6 on the JAX side too
    accuracy, impl = {'fused': ('int8', None),
                      'block-int8': ('int8', None),
                      'block-pallas': ('int8', 'pallas'),
                      'block-pallas_bf16': ('bf16', 'pallas_bf16'),
                      'block-f32': ('f32', 'xla')}[arm]
    fused_chain = arm == 'fused'
    gulps = _ci8_gulps()
    w = _weights(B_, S_)
    before = dict(gpu_kernels.launches)
    got, hdr, blk = _port_pipeline(gulps, w, fused_chain, accuracy, impl)
    want, jhdr = _jax_pipeline(gulps, w, fused_chain, accuracy, impl)
    assert got.shape == want.shape == (NGULP * T_ // R_, F_, 4, B_)
    assert _rel(got, want) <= 1e-5
    assert hdr['_tensor'] == jhdr['_tensor']
    assert hdr['gulp_nframe'] == jhdr['gulp_nframe'] == T_ // R_
    # the CPU runs the plain versions: no kernel launched
    assert gpu_kernels.launches == before
    x = np.stack([np.concatenate([g['re'] for g in gulps]),
                  np.concatenate([g['im'] for g in gulps])], axis=-1)
    if fused_chain:
        assert blk.impl_info['impl'] == 'cuda-beamform-detect'
        assert blk.impl_info['kernel'] == 'plain'
        eng = Beamformer(w, accuracy='int8')
        assert _rel(got, _quantized_detect_oracle(eng, x, R_)) < 1e-5
    else:
        assert blk._gemm_ops == 8 * F_ * P_ * B_ * S_ * T_
        key = blk.engine._key((T_, F_, P_, S_), 'int8', True)
        assert blk.engine.chosen[key] == (impl or 'int8_wide')
