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

import collections
import contextlib
import json
import os
import re
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
from tests.test_torch_bounded import run_bounded

LABELS = ['time', 'freq', 'station', 'pol']
BEAMFORM_SOURCE = os.path.join(os.path.dirname(gpu_kernels.__file__),
                               os.pardir, 'csrc', 'beamform.cu')


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


# ---------------------------------------------------------------------------
# K6's tensor-core kernel (beamform_detect_mma_kernel in csrc/beamform.cu)
# modelled in numpy from its source's formulas: the tile -> (frame,
# channel) row map, the swizzled staging, the m16n8k32 .s8 fragments, the
# byte_perm selectors, the ~im fold with c_b in wrapping int32, and the
# float32 epilogue with its shuffle chain
# ---------------------------------------------------------------------------

#: kTF6, kCF6, kSC4, kBB4 of the source: frames, channels, stations of a
#: chunk and beams of a tile; bytes of a staged row
K6_TF, K6_CF, K6_SC, K6_BB = 16, 4, 64, 64
K6_ROW = 4 * K6_SC
#: a warp's lanes: mma groupID g and thread in group q
_G, _Q = np.arange(32) // 4, np.arange(32) % 4
#: byte_perm selectors: pol x's and pol y's (re, im) pairs of two station
#: words, then re and im of four stations
K6_SEL = (0x5410, 0x7632)
SPLIT_RE, SPLIT_IM = 0x6420, 0x7531


def _byte_perm(x, y, sel):
    """CUDA's __byte_perm on uint32 arrays: byte n of the result is byte
    (sel >> 4n) & 7 of the eight bytes y:x (x the low four)."""
    v = np.asarray(x, np.uint64) | (np.asarray(y, np.uint64) << np.uint64(32))
    out = np.zeros(v.shape, np.uint64)
    for n in range(4):
        b = np.uint64(8 * ((sel >> (4 * n)) & 7))
        out |= ((v >> b) & np.uint64(0xff)) << np.uint64(8 * n)
    return out.astype(np.uint32)


def _int8s(w):
    """The four int8 of each uint32 of ``w``, low byte first."""
    w = np.ascontiguousarray(w, dtype='<u4')
    return w.view(np.int8).reshape(w.shape + (4,))


def _wrap32(v):
    return ((np.asarray(v, np.int64) + 2 ** 31) % 2 ** 32 - 2 ** 31) \
        .astype(np.int32)


#: fragment ownership of m16n8k32 (PTX): A register a of lane (g, q) holds
#: row g + 8 (a % 2), k 16 (a // 2) + 4q .. + 3; B register b holds k
#: 16 b + 4q .. + 3 of column g; C register c holds row g + 8 (c // 2),
#: column 2q + c % 2
_A_ROW = (_G[:, None] + 8 * (np.arange(4) % 2))[:, :, None]
_A_COL = (16 * (np.arange(4) // 2))[None, :, None] + \
    4 * _Q[:, None, None] + np.arange(4)
_B_ROW = (16 * np.arange(2))[None, :, None] + 4 * _Q[:, None, None] + \
    np.arange(4)
_B_COL = np.broadcast_to(_G[:, None, None], _B_ROW.shape)
_C_ROW = _G[:, None] + 8 * (np.arange(4) // 2)
_C_COL = 2 * _Q[:, None] + np.arange(4) % 2


def _mma_s8(d, a, b):
    """mma.sync.m16n8k32.row.col.s32.s8.s8.s32 on lanes (..., 32): d
    (..., 32, 4) int32 plus A (16 x 32) times B (32 x 8), gathered from a
    (..., 32, 4) and b (..., 32, 2) uint32 registers by the fragment
    layout; s32 wraps (no .satfinite)."""
    A = np.zeros(a.shape[:-2] + (16, 32), np.int64)
    A[..., _A_ROW, _A_COL] = _int8s(a)
    Bm = np.zeros(b.shape[:-2] + (32, 8), np.int64)
    Bm[..., _B_ROW, _B_COL] = _int8s(b)
    D = A @ Bm
    return _wrap32(d.astype(np.int64) + D[..., _C_ROW, _C_COL])


def _k6_tiles(T, F, B):
    """(nb, tt, fq) of every tile in the kernel's order: channel quad
    fastest, then time, then the beam tile."""
    ntile_f = -(-F // K6_CF)
    ntile_tf = -(-T // K6_TF) * ntile_f
    tile = np.arange(ntile_tf * -(-B // K6_BB))
    nb, tf = tile // ntile_tf, tile % ntile_tf
    return nb, tf // ntile_f, tf % ntile_f


def _k6_stage(words, tt, fq, c, S):
    """Ring stage of chunk c of the tiles (tt, fq): (tiles, 64 rows, 16
    slots, 4 words), thread (i, v) copying vector v of MMA row i of
    row-tile mt to row 16 mt + i, slot v ^ (i & 1); zero past T, F, S."""
    T, F = words.shape[:2]
    i, v = np.arange(16)[:, None], np.arange(16)[None, :]
    t = tt[:, None, None] * K6_TF + 2 * (i % 8) + i // 8      # (n, 16, 1)
    s = c * K6_SC + 4 * v                                     # (1, 16)
    A = np.zeros((len(tt), 64, 16, 4), np.uint32)
    for mt in range(K6_CF):
        f = (fq * K6_CF + mt)[:, None, None]
        ok = (t < T) & (f < F) & (s < S)
        src = words[np.minimum(t, T - 1)[..., None],
                    np.minimum(f, F - 1)[..., None],
                    np.minimum(s, S - 4)[..., None] + np.arange(4)]
        A[:, 16 * mt + i, v ^ (i & 1)] = np.where(ok[..., None], src, 0)
    return A


def _k6_panel(wr, wi, nb, nchunk):
    """The resident panel of beam tile nb: 128 columns (wr of beams nb *
    64 .., then wi) of nchunk * 64 stations, zero past B and S, as uint32
    words of 4 stations; and c_b = sum_s wi[b, s] (0 past B)."""
    B, S = wr.shape
    bs = np.arange(nb * K6_BB, min(B, nb * K6_BB + K6_BB))
    P = np.zeros((2 * K6_BB, nchunk * K6_SC), np.int8)
    P[:len(bs), :S], P[K6_BB:K6_BB + len(bs), :S] = wr[bs], wi[bs]
    csum = np.zeros(K6_BB, np.int64)
    csum[:len(bs)] = wi[bs].astype(np.int64).sum(axis=1)
    return P.view('<u4'), _wrap32(csum)


def _shfl_up(v, delta):
    """__shfl_up_sync over the lane axis (-1): lane l takes lane l -
    delta's value, lanes below delta keep their own."""
    out = v.copy()
    out[..., delta:] = v[..., :-delta]
    return out


def _k6_mma_model(wxr, wxi, wyr, wyi, x, scale, R):
    """K6's tensor-core kernel on numpy operands -> (T / R, F, 4, B)
    float32, and how many times each output was stored."""
    T, F, S = x.shape[:3]
    B = wxr.shape[0]
    nchunk = -(-S // K6_SC)
    words = np.ascontiguousarray(x).reshape(T, F, 4 * S).view('<u4')
    nb, tt, fq = _k6_tiles(T, F, B)
    warp = np.arange(8)[:, None]
    mt, bw0 = warp % 4, 32 * (warp // 4)                      # (8, 1)
    r = 16 * mt + _G                                          # (8, 32)
    panels = [[_k6_panel(wr, wi, n, nchunk) for n in range(nb.max() + 1)]
              for wr, wi in ((wxr, wxi), (wyr, wyi))]
    # acc[p][j][0 yr, 1 yi]: (tiles, 8 warps, 32 lanes, 4 registers)
    acc = np.zeros((2, 4, 2, len(nb), 8, 32, 4), np.int32)
    for p in range(2):
        for j in range(4):
            bl = bw0[..., None] + 8 * j + 2 * _Q[:, None] + \
                np.arange(4) % 2                              # (8, 32, 4)
            csum = np.stack([panels[p][i][1] for i in nb])    # (tiles, 64)
            acc[p, j, 0] = csum[:, bl]
    for c in range(nchunk):
        A = _k6_stage(words, tt, fq, c, S)
        for kg in range(K6_SC // 32):
            w = {(h, u): A[:, r + 8 * h, (kg * 8 + 2 * _Q + u) ^ (_G & 1)]
                 for h in range(2) for u in range(2)}         # (n, 8, 32, 4)
            for p in range(2):
                ar = np.zeros(w[0, 0].shape, np.uint32)
                ai = np.zeros_like(ar)
                for (h, u), wv in w.items():
                    t0 = _byte_perm(wv[..., 0], wv[..., 1], K6_SEL[p])
                    t1 = _byte_perm(wv[..., 2], wv[..., 3], K6_SEL[p])
                    ar[..., h + 2 * u] = _byte_perm(t0, t1, SPLIT_RE)
                    ai[..., h + 2 * u] = _byte_perm(t0, t1, SPLIT_IM)
                an = ~ai
                pw = np.stack([panels[p][i][0] for i in nb])  # (n, 128, K/4)
                widx = (c * K6_SC + 32 * kg + 8 * _Q) // 4
                for j in range(4):
                    col = bw0 + _G + 8 * j
                    fr = np.stack([pw[:, col, widx], pw[:, col, widx + 1]],
                                  axis=-1)
                    col = col + K6_BB
                    fi = np.stack([pw[:, col, widx], pw[:, col, widx + 1]],
                                  axis=-1)
                    acc[p, j, 0] = _mma_s8(acc[p, j, 0], ar, fr)
                    acc[p, j, 1] = _mma_s8(acc[p, j, 1], ar, fi)
                    acc[p, j, 0] = _mma_s8(acc[p, j, 0], an, fi)
                    acc[p, j, 1] = _mma_s8(acc[p, j, 1], ai, fr)
    # the epilogue: (tiles, 8, 32) per value
    out = np.zeros((T // R, F, 4, B), np.float32)
    stores = np.zeros(out.shape, np.int64)
    f = (fq[:, None] * K6_CF + mt[:, 0])[..., None]           # (n, 8, 1)
    t = (tt[:, None, None] * K6_TF + 2 * _G)                  # (n, 1, 32)
    n = R // 2
    gl = _G % n if n else np.zeros(32, np.int64)
    sc = np.float32(scale)

    def stokes(xr, xi, yr, yi):
        bxr, bxi, byr, byi = (v.astype(np.float32) * sc
                              for v in (xr, xi, yr, yi))
        xx = bxr * bxr + bxi * bxi
        yy = byr * byr + byi * byi
        xyr = bxr * byr + bxi * byi
        xyi = bxi * byr - bxr * byi
        return [xx + yy, xx - yy, np.float32(2) * xyr, np.float32(-2) * xyi]

    def store(row, ok, b, val):
        for e in range(2):
            m = np.broadcast_to(ok & (b + e < B), val[e][0].shape)
            idx = np.nonzero(m)
            rr = np.broadcast_to(row, m.shape)[idx]
            ff = np.broadcast_to(f, m.shape)[idx]
            bb = np.broadcast_to(b + e, m.shape)[idx]
            for k in range(4):
                out[rr, ff, k, bb] = val[e][k][idx]
                np.add.at(stores, (rr, ff, k, bb), 1)

    for j in range(4):
        b = (nb[:, None, None] * K6_BB + bw0 + 8 * j + 2 * _Q)  # (n, 8, 32)
        v = [[stokes(*(acc[p, j, pl][..., 2 * h + e]
                       for p in range(2) for pl in range(2)))
              for e in range(2)] for h in range(2)]
        if n == 0:
            for h in range(2):
                store(t + h, (f < F) & (t + h < T), b, v[h])
            continue
        s = [[v[0][e][k] + v[1][e][k] for k in range(4)] for e in range(2)]
        for step in range(1, n):
            for e in range(2):
                for k in range(4):
                    prev = _shfl_up(s[e][k], 4)
                    s[e][k] = np.where(gl == step,
                                       (prev + v[0][e][k]) + v[1][e][k],
                                       s[e][k])
        store(t // R, (gl == n - 1) & (f < F) & (t < T), b, s)
    return out, stores


def _k6_operands(T, F, S, B, seed, fill=None):
    rng = np.random.RandomState(seed)
    if fill is not None:
        x = np.full((T, F, S, 2, 2), fill, np.int8)
        ws = [np.full((B, S), fill, np.int8) for _ in range(4)]
    else:
        x = rng.randint(-128, 128, (T, F, S, 2, 2)).astype(np.int8)
        ws = [rng.randint(-128, 128, (B, S)).astype(np.int8)
              for _ in range(4)]
    return ws, x


@pytest.mark.parametrize('R', [1, 2, 4, 8, 16])
@pytest.mark.parametrize('case', ['ragged', 'wide', 'minus128'])
def test_k6_mma_model_is_bit_identical_to_plain(R, case):
    """The numpy model of K6's tensor-core kernel gives the plain
    version's bits at every R that divides 16: on ragged T (40 frames, 48
    at R 16), F (3 channels) and B (65 beams) at S = 40; at S = 256 with
    two channel quads; and with -128 in every byte (yi = 2 S 128^2 per
    pol before the scale).  Each output is stored exactly once."""
    T, F, S, B, fill = {'ragged': (40 if R < 16 else 48, 3, 40, 65, None),
                        'wide': (32, 5, 256, 64, None),
                        'minus128': (16, 2, 64, 9, -128)}[case]
    ws, x = _k6_operands(T, F, S, B, R + S, fill)
    scale = 0.0123
    got, stores = _k6_mma_model(*ws, x, scale, R)
    want = gpu_kernels.beamform_detect_int8_plain(
        *[_t(w) for w in ws], _t(x), scale, R).numpy()
    assert (stores == 1).all()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    assert gpu_kernels.detect_path(_t(x), R) == 'mma'



def _wavefronts(addrs, nbytes):
    """Shared-memory wavefronts of one phase of a warp's access: the
    lanes' ``nbytes``-byte accesses at bytes ``addrs``; 32 banks of 4
    bytes, the most distinct words that fall in one bank."""
    words = {int(a) // 4 + k for a in addrs for k in range(nbytes // 4)}
    return max(collections.Counter(w % 32 for w in words).values())


def _phases(addrs, nbytes):
    """The wavefronts of each phase of one warp access (8 lanes of 16
    bytes, 16 lanes of 8)."""
    n = 128 // nbytes
    return [_wavefronts(addrs[i:i + n], nbytes) for i in range(0, 32, n)]


@pytest.mark.parametrize('S', [40, 256, 640])
def test_k6_mma_shared_memory_accesses_take_one_wavefront(S):
    """Every phase of the staging's cp.async writes, of the consumers'
    16-byte A loads (one load serves both pols) and of the 8-byte B loads
    of both panels takes one wavefront, the fewest; the two selector sets
    give each pol's re and im of the four stations of a load."""
    pw = -(-S // K6_SC) * K6_SC + 32
    lane = np.arange(32)
    for wp in range(8):
        tid = 32 * wp + lane
        i, v = tid // 16, tid % 16
        for mt in range(K6_CF):
            addrs = (16 * mt + i) * K6_ROW + 16 * (v ^ (i & 1))
            assert _phases(addrs, 16) == [1] * 4
        mt, bw0 = wp % 4, 32 * (wp // 4)
        for kg in range(K6_SC // 32):
            for h in range(2):
                for u in range(2):
                    addrs = (16 * mt + _G + 8 * h) * K6_ROW + \
                        16 * ((kg * 8 + 2 * _Q + u) ^ (_G & 1))
                    assert _phases(addrs, 16) == [1] * 4
            for c in range(-(-S // K6_SC)):
                for p in range(2):
                    for j in range(4):
                        for plane in range(2):
                            col = 2 * K6_BB * p + K6_BB * plane + bw0 + _G + \
                                8 * j
                            addrs = col * pw + c * K6_SC + 32 * kg + 8 * _Q
                            assert _phases(addrs, 8) == [1] * 2
    rng = np.random.RandomState(S)
    st = rng.randint(-128, 128, (4, 4)).astype(np.int8)   # 4 stations
    w = st.reshape(-1).view('<u4')
    for p, sel in enumerate(K6_SEL):
        t0 = _byte_perm(w[0], w[1], sel)
        t1 = _byte_perm(w[2], w[3], sel)
        assert _int8s(_byte_perm(t0, t1, SPLIT_RE)).reshape(4).tolist() \
            == st[:, 2 * p].tolist()
        assert _int8s(_byte_perm(t0, t1, SPLIT_IM)).reshape(4).tolist() \
            == st[:, 2 * p + 1].tolist()


def _source_int(name):
    with open(BEAMFORM_SOURCE) as f:
        m = re.search(r'constexpr int %s = (\d+);' % name, f.read())
    return int(m.group(1))


def test_k6_mma_model_and_limit_follow_the_source():
    """The model's tile, chunk and selectors are the source's, and
    DETECT_MMA_MAX_NSTAND is the most stations (a multiple of 4) whose
    ring, two resident panels and beam sums fit the H100's 227 KB a
    block, by the C entry's formula."""
    assert (_source_int('kTF6'), _source_int('kCF6'), _source_int('kSC4'),
            _source_int('kBB4')) == (K6_TF, K6_CF, K6_SC, K6_BB)
    with open(BEAMFORM_SOURCE) as f:
        text = f.read()
    assert 'p ? 0x%04xu : 0x%04xu' % (K6_SEL[1], K6_SEL[0]) in text
    stages = _source_int('kStages6')

    def smem(S):
        pw = -(-S // K6_SC) * K6_SC + 32
        return stages * K6_TF * K6_CF * K6_ROW + 4 * K6_BB * pw + \
            2 * K6_BB * 4

    fits = [S for S in range(4, 2048, 4) if smem(S) <= 232448]
    assert max(fits) == gpu_kernels.DETECT_MMA_MAX_NSTAND


def test_k6_variant_edits_apply_to_the_source():
    """chip_k6_variants.py's edits each apply to the tensor-core kernel
    alone and keep the source's braces balanced and both K6 entries."""
    import importlib.util
    path = os.path.join(os.path.dirname(BEAMFORM_SOURCE), os.pardir,
                        os.pardir, 'chip_k6_variants.py')
    mod_spec = importlib.util.spec_from_file_location('chip_k6_variants',
                                                      path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    with open(BEAMFORM_SOURCE) as f:
        src = f.read()
    vs = mod.variants(src)
    assert sorted(vs) == sorted([
        'kernel', 'four_stages', 'six_stages', 'time_fastest',
        'chains_by_tile', 'i2f_split', 'no_epilogue', 'no_mma', 'no_read'])
    assert vs['kernel'] == (src, True)
    k4 = src[:src.index('constexpr int kTF6')]
    for name, (text, _) in vs.items():
        assert text.count('{') == text.count('}'), name
        assert text.startswith(k4), name
        assert text.count('int bf_beamform_detect_int8(') == 1, name
        assert text.count('int bf_beamform_detect_int8_mma(') == 1, name
        assert name == 'kernel' or text != src, name


def test_k6_detect_path_follows_the_layout():
    """R dividing 16 on a gulp whose rows start on 16 bytes with S a
    positive multiple of 4 up to DETECT_MMA_MAX_NSTAND takes the
    tensor-core kernel; R of 32 or R = T = 96, a view off 16 bytes, odd
    station counts and too many stations keep the dp4a kernel.  On the
    CPU the wrapper runs the plain version and launches nothing."""
    x = torch.zeros((96, 3, 8, 2, 2), dtype=torch.int8)
    for R in (1, 2, 4, 8, 16):
        assert gpu_kernels.detect_path(x, R) == 'mma'
    assert gpu_kernels.detect_path(x[::2], 4) == 'mma'
    assert gpu_kernels.detect_path(x[:, 1:], 4) == 'mma'
    for R in (32, 96, 3):
        assert gpu_kernels.detect_path(x, R) == 'dp4a'
    flat = torch.zeros(x.numel() + 16, dtype=torch.int8)
    off = flat[4:4 + x.numel()].view(x.shape)
    assert off.data_ptr() % 16 != 0
    assert gpu_kernels.detect_path(off, 4) == 'dp4a'
    assert gpu_kernels.detect_path(x[:, :, :6], 4) == 'dp4a'
    assert gpu_kernels.detect_path(x[:, :, 1:], 4) == 'dp4a'
    top = gpu_kernels.DETECT_MMA_MAX_NSTAND
    for S, path in ((top, 'mma'), (top + 4, 'dp4a')):
        g = torch.zeros((1, 1, S, 2, 2), dtype=torch.int8)
        assert gpu_kernels.detect_path(g, 1) == path
    before = dict(gpu_kernels.launches)
    w = torch.ones((2, 8), dtype=torch.int8)
    gpu_kernels.beamform_detect_int8(w, w, w, w, x, 1.0, 8)
    assert gpu_kernels.launches == before


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
        run_bounded(p)
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
        run_bounded(p)
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
