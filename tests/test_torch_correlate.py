"""The FX correlator of the PyTorch/CUDA port (the K7/K8 wrappers and the
capability probe in ops.gpu_kernels, the xcorr candidates, xcorr_int8
and XEngine in ops.linalg, ops.quantize, QuantizeStage, CorrelateStage,
AccumulateStage and the fft, quantize, correlate and accumulate blocks)
against the JAX package on the same seeded inputs, with its Pallas
kernels in interpret mode (as tests/test_correlate.py runs them on the
CPU), and against the int64 oracle.  The port runs on the CPU device
here, where each kernel wrapper runs its plain PyTorch version; the CUDA
kernels are held against those versions on the card (chip_smoke.py,
tests/test_torch_cuda.py).

Tolerances: every int path bit-identical (integer visibilities below
2^24 are exact in complex64, so even the float candidates admit no
tolerance on ci8 planes); float planes within the accuracy class of
XCORR_CLASSES (f32 1e-3, bf16 8e-3) relative to the maximum, with TF32
off.
"""

import contextlib
from copy import deepcopy

import numpy as np
import pytest
import torch

import bifrost_tpu as bf
from bifrost_tpu.ops import linalg as JL
from bifrost_tpu.ops import pallas_kernels as pk
from bifrost_tpu.stages import (QuantizeStage as JQuantize,
                                CorrelateStage as JCorrelate)
from tests.util import NumpySourceBlock, GatherSink, simple_header

import bifrost_tpu_torch as bt
from bifrost_tpu_torch import device
from bifrost_tpu_torch.dtype import DataType
from bifrost_tpu_torch.ndarray import ndarray
from bifrost_tpu_torch.ops import gpu_kernels, mprobe
from bifrost_tpu_torch.ops import linalg as L
from bifrost_tpu_torch.ops import quantize as Q
from bifrost_tpu_torch.ops.fft import fftn_dispatch
from bifrost_tpu_torch.stages import (QuantizeStage, CorrelateStage,
                                      AccumulateStage)
from tests.test_torch_bounded import run_bounded


@pytest.fixture(autouse=True)
def _cpu(monkeypatch, tmp_path):
    device.set_device('cpu')
    monkeypatch.setattr(torch.backends.cuda.matmul, 'allow_tf32', False)
    # no probe cache of another test or session leaks in
    monkeypatch.setenv('BF_CACHE_DIR', str(tmp_path / 'cache'))
    monkeypatch.setattr(mprobe, '_cache', {})
    monkeypatch.setattr(mprobe, '_flip_uses', {})
    monkeypatch.setattr(L, '_xcorr_chosen', {})
    for var in ('BF_XCORR_IMPL', 'BF_XCORR_GATE_RTOL', 'BF_LINALG_PROBE',
                'BF_LINALG_XCORR_IMPL', 'BF_USE_PALLAS'):
        monkeypatch.delenv(var, raising=False)


def _i8(rng, shape, lo=-128):
    return rng.randint(lo, 128, size=shape).astype(np.int8)


def _planes(shape, seed=0, lo=-128):
    rng = np.random.RandomState(seed)
    return _i8(rng, shape, lo), _i8(rng, shape, lo)


def _oracle(re_i, im_i, re_j=None, im_j=None):
    """int64 oracle of vis = sum_t x_i conj(x_j) over (..., T, F, n),
    cast to complex64 (every sum here is below 2^24: exact)."""
    if re_j is None:
        re_j, im_j = re_i, im_i
    ri, ii, rj, ij = (v.astype(np.int64) for v in (re_i, im_i, re_j, im_j))
    dot = lambda x, y: np.einsum('...tfa,...tfb->...fab', x, y)
    return (dot(ri, rj) + dot(ii, ij)).astype(np.complex64) + \
        1j * (dot(ii, rj) - dot(ri, ij)).astype(np.complex64)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


# ---------------------------------------------------------------------------
# K7, K8: plain versions against the Pallas kernels and the oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('T,F,n', [(8, 3, 6), (12, 2, 40), (5, 1, 130)])
def test_xcorr_herm_plain_bit_identical_to_pallas_and_oracle(T, F, n):
    re, im = _planes((T, F, n), seed=n)
    before = gpu_kernels.launches['xcorr_herm']
    got = gpu_kernels.xcorr_herm(_t(re), _t(im))
    assert gpu_kernels.launches['xcorr_herm'] == before   # plain: no launch
    assert got.dtype == torch.complex64 and got.shape == (F, n, n)
    got = got.numpy()
    np.testing.assert_array_equal(
        got, np.asarray(pk.xcorr_herm(re, im, interpret=True)))
    np.testing.assert_array_equal(got, _oracle(re, im))


@pytest.mark.parametrize('T,F,ni,nj', [(8, 3, 6, 40), (12, 2, 40, 6),
                                       (4, 2, 130, 9)])
def test_xcorr_cross_plain_bit_identical_to_pallas_and_oracle(T, F, ni, nj):
    rng = np.random.RandomState(ni + nj)
    re_i, im_i = _i8(rng, (T, F, ni)), _i8(rng, (T, F, ni))
    re_j, im_j = _i8(rng, (T, F, nj)), _i8(rng, (T, F, nj))
    got = gpu_kernels.xcorr_cross(_t(re_i), _t(im_i), _t(re_j), _t(im_j))
    assert got.shape == (F, ni, nj)
    got = got.numpy()
    np.testing.assert_array_equal(
        got, np.asarray(pk.xcorr_cross(re_i, im_i, re_j, im_j,
                                       interpret=True)))
    np.testing.assert_array_equal(got, _oracle(re_i, im_i, re_j, im_j))


def test_xcorr_group_axis_is_one_matrix_per_group():
    """(g, T, F, n) planes give (g, F, n, n): group k equals the JAX
    kernel on group k alone (the vmapped JAX stage's form)."""
    re, im = _planes((3, 8, 2, 6), seed=4)
    got = gpu_kernels.xcorr_herm(_t(re), _t(im)).numpy()
    assert got.shape == (3, 2, 6, 6)
    for k in range(3):
        np.testing.assert_array_equal(
            got[k], np.asarray(pk.xcorr_herm(re[k], im[k], interpret=True)))
    cross = gpu_kernels.xcorr_cross(_t(re), _t(im), _t(re[..., :2]),
                                    _t(im[..., :2])).numpy()
    np.testing.assert_array_equal(cross, got[..., :2])


def test_xcorr_imaginary_sign_on_two_inputs():
    """x_0 = 1 + 2j, x_1 = 3 - 1j over one frame: vis[0, 1] = x_0 conj(x_1)
    = (1 + 2j)(3 + 1j) = 1 + 7j, and vis[1, 0] its conjugate.  A flipped
    sign of the imaginary part passes every test of real parts or autos,
    not this one."""
    re = np.array([[[1, 3]]], np.int8)
    im = np.array([[[2, -1]]], np.int8)
    want = np.array([[[5, 1 + 7j], [1 - 7j, 10]]], np.complex64)
    for got in (gpu_kernels.xcorr_herm(_t(re), _t(im)),
                gpu_kernels.xcorr_cross(_t(re), _t(im), _t(re), _t(im)),
                L.xcorr_int8(_t(re), _t(im)),
                L.XEngine(impl='pallas')(_t(re), _t(im))):
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(np.asarray(pk.xcorr_herm(re, im,
                                                           interpret=True)),
                                  want)


@pytest.mark.parametrize('fn', ['herm', 'cross'])
def test_xcorr_refuses_more_frames_than_int32_holds(fn):
    big = torch.zeros((gpu_kernels.MAX_NTIME + 1, 1, 2), dtype=torch.int8)
    ok = big[:gpu_kernels.MAX_NTIME]
    with pytest.raises(ValueError, match='overflow'):
        if fn == 'herm':
            gpu_kernels.xcorr_herm(big, big)
        else:
            gpu_kernels.xcorr_cross(big, big, big, big)
    assert gpu_kernels.MAX_NTIME == 65535
    # the largest accepted sum: 2 * 128^2 * 65535 < 2^31
    full = torch.full_like(ok, -128)
    got = gpu_kernels.xcorr_herm(full, full)
    assert got[0, 0, 0].real.item() == float(2 * 128 * 128 * 65535)


def test_xcorr_wrappers_reject_bad_operands():
    v = torch.zeros((4, 2, 8), dtype=torch.int8)
    with pytest.raises(ValueError):
        gpu_kernels.xcorr_herm(v.float(), v.float())
    with pytest.raises(ValueError):
        gpu_kernels.xcorr_herm(v, v[:, :1])
    with pytest.raises(ValueError):
        gpu_kernels.xcorr_herm(v[0], v[0])
    with pytest.raises(ValueError):
        gpu_kernels.xcorr_cross(v, v, v[:, :1], v[:, :1])


def test_probe_is_off_the_card():
    """K0: False on the CPU device (without a launch); x * 2 is its
    plain version."""
    before = gpu_kernels.launches['probe']
    assert gpu_kernels.available() is False
    assert gpu_kernels.available(torch.device('cpu')) is False
    assert gpu_kernels.available() == pk.available() is False
    assert gpu_kernels.launches['probe'] == before
    x = torch.arange(8 * 128, dtype=torch.float32).reshape(8, 128)
    assert torch.equal(gpu_kernels.probe(x), x * 2)
    assert float(gpu_kernels.probe(torch.ones((8, 128))).sum()) == 2048.0


def test_enabled_needs_the_flag_and_the_card(monkeypatch):
    monkeypatch.setenv('BF_USE_PALLAS', '1')
    assert gpu_kernels.enabled() is False         # no card here
    assert gpu_kernels.enabled() == pk.enabled()


# ---------------------------------------------------------------------------
# the candidates, port against JAX, on ci8 planes
# ---------------------------------------------------------------------------

SHAPES = [(8, 4, 6), (16, 3, 8), (12, 2, 40)]


@pytest.mark.parametrize('shape', SHAPES)
@pytest.mark.parametrize('name', sorted(JL._XENGINE_IMPLS))
def test_xengine_candidate_bit_identical_to_jax_and_oracle(shape, name):
    re, im = _planes(shape, seed=sum(shape), lo=-64)
    got = L._XENGINE_IMPLS[name](_t(re), _t(im)).numpy()
    assert got.dtype == np.complex64
    np.testing.assert_array_equal(got, np.asarray(
        JL._XENGINE_IMPLS[name](re, im)))
    if name != 'planar_bf16':
        np.testing.assert_array_equal(got, _oracle(re, im))


@pytest.mark.parametrize('family', ['auto', 'cross'])
def test_xcorr_candidates_bit_identical_to_jax_and_oracle(family):
    re, im = _planes((12, 3, 6), seed=8)
    rj, ij = (re, im) if family == 'auto' else _planes((12, 3, 5), seed=9)
    impls, jimpls = ((L._XCORR_AUTO_IMPLS, JL._XCORR_AUTO_IMPLS)
                     if family == 'auto'
                     else (L._XCORR_IMPLS, JL._XCORR_IMPLS))
    assert sorted(impls) == sorted(jimpls)
    want = _oracle(re, im, rj, ij)
    for name in impls:
        got = impls[name](_t(re), _t(im), _t(rj), _t(ij)).numpy()
        np.testing.assert_array_equal(got, want, err_msg=name)
        np.testing.assert_array_equal(
            got, np.asarray(jimpls[name](re, im, rj, ij)), err_msg=name)


def test_candidates_take_a_group_axis():
    """Every X-engine candidate maps (g, T, F, n) -> (g, F, n, n), group
    by group, as CorrelateStage hands it the gulp."""
    re, im = _planes((2, 8, 3, 6), seed=5, lo=-64)
    for name, fn in L._XENGINE_IMPLS.items():
        got = fn(_t(re), _t(im)).numpy()
        assert got.shape == (2, 3, 6, 6), name
        for k in range(2):
            np.testing.assert_array_equal(
                got[k], fn(_t(re[k]), _t(im[k])).numpy(), err_msg=name)
    np.testing.assert_array_equal(
        L._XENGINE_IMPLS['int8_wide'](_t(re), _t(im)).numpy(), _oracle(re, im))


def test_int_products_exact_at_full_int8_range():
    """_mm_i32 pads to _int_mm's shapes and stays exact for every int8
    value, -128 included, at odd sizes."""
    rng = np.random.RandomState(3)
    a = _i8(rng, (3, 5, 19))
    b = _i8(rng, (3, 19, 7))
    got = L._mm_i32(_t(a), _t(b)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(
        got, np.einsum('bmk,bkn->bmn', a.astype(np.int64),
                       b.astype(np.int64)))


@pytest.mark.parametrize('name', ['xla', 'planar', 'planar_bf16'])
def test_float_planes_within_class(name):
    """Float voltages: within the class rtol of the JAX candidate and of
    the float64 oracle (f32 1e-3 for xla and planar, bf16 8e-3 for the
    one-pass bf16 product), TF32 off."""
    rng = np.random.RandomState(6)
    re = (rng.randn(16, 4, 8) * 30).astype(np.float32)
    im = (rng.randn(16, 4, 8) * 30).astype(np.float32)
    got = L._XENGINE_IMPLS[name](_t(re), _t(im)).numpy()
    rtol = L.XCORR_CLASSES['bf16' if name == 'planar_bf16' else 'f32']
    assert _rel(got, np.asarray(JL._XENGINE_IMPLS[name](re, im))) <= rtol
    x = re.astype(np.float64) + 1j * im.astype(np.float64)
    ref = np.einsum('tfi,tfj->fij', x, np.conj(x))
    assert _rel(got, ref) <= rtol


# ---------------------------------------------------------------------------
# XEngine: classes, candidate lists, keys, defaults, the race
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('accuracy', ['f32', 'bf16', 'int8'])
def test_xengine_lists_defaults_keys_equal_jax(accuracy):
    eng, jeng = L.XEngine(accuracy=accuracy), JL.XEngine(accuracy=accuracy)
    for int_input in (True, False):
        assert eng._candidates(int_input) == jeng._candidates(int_input)
        assert eng._default(int_input) == jeng._default(int_input)
        assert eng._key((8, 4, 6), 'int8', int_input) == \
            jeng._key((8, 4, 6), 'int8', int_input)
    assert L.XCORR_CLASSES == JL.XCORR_CLASSES
    assert L._XENGINE_LOSSY == JL._XENGINE_LOSSY
    assert L._XENGINE_INT_IMPLS == JL._XENGINE_INT_IMPLS
    assert sorted(L._XENGINE_IMPLS) == sorted(JL._XENGINE_IMPLS)


def test_kernel_races_only_where_the_probe_passed(monkeypatch):
    card = torch.device('cuda', 0)
    eng = L.XEngine(accuracy='int8')
    assert 'pallas' not in eng._candidates(True)
    assert 'pallas' not in L._xcorr_race_impls(L._XCORR_AUTO_IMPLS)
    monkeypatch.setattr(gpu_kernels, '_available_on', {card})
    assert eng._candidates(True, card)[-1] == 'pallas'
    assert 'pallas' not in eng._candidates(False, card)
    assert 'pallas' in L._xcorr_race_impls(L._XCORR_AUTO_IMPLS, card)


def _probe_passes(monkeypatch):
    """Probing on and the capability probe passing, so the kernels race
    (their wrappers run the plain versions on these CPU planes)."""
    monkeypatch.setattr(gpu_kernels, 'available', lambda device=None: True)
    monkeypatch.setenv('BF_LINALG_PROBE', '1')


def _launch_failure(*args):
    raise RuntimeError('CUDA error 719: unspecified launch failure')


@pytest.mark.parametrize('entry', ['prewarm', 'call', 'auto', 'cross'])
def test_kernel_error_in_race_raises(monkeypatch, entry):
    """A kernel that the probe admitted and that then fails is a fault:
    the gate and the race raise instead of going on without it."""
    _probe_passes(monkeypatch)
    monkeypatch.setattr(gpu_kernels, 'xcorr_herm', _launch_failure)
    monkeypatch.setattr(gpu_kernels, 'xcorr_cross', _launch_failure)
    re, im = _planes((8, 2, 6), seed=18, lo=-64)
    with pytest.raises(RuntimeError, match='launch failure'):
        if entry == 'prewarm':
            L.XEngine(accuracy='int8').prewarm(8, 2, 6)
        elif entry == 'call':
            L.XEngine(accuracy='f32')(_t(re), _t(im))
        elif entry == 'auto':
            L.xcorr_int8(_t(re), _t(im))
        else:
            L.xcorr_int8(_t(re), _t(im), _t(re[..., :4]), _t(im[..., :4]))


def test_kernel_outside_its_class_raises(monkeypatch):
    """K7 is exact on int planes: a kernel whose imaginary part has the
    wrong sign fails the gate and raises, never drops out quietly."""
    _probe_passes(monkeypatch)
    monkeypatch.setattr(gpu_kernels, 'xcorr_herm',
                        lambda re, im: gpu_kernels.xcorr_herm_plain(
                            re, im).conj())
    with pytest.raises(RuntimeError, match='deviates'):
        L.XEngine(accuracy='int8').prewarm(8, 2, 6)


def test_kernel_races_when_the_probe_passes(monkeypatch):
    _probe_passes(monkeypatch)
    eng = L.XEngine(accuracy='int8')
    eng.prewarm(8, 2, 6)
    assert 'pallas' in eng.probe_ms[eng._key((8, 2, 6), 'int8', True)]
    re, im = _planes((8, 2, 6), seed=19)
    np.testing.assert_array_equal(L.xcorr_int8(_t(re), _t(im)).numpy(),
                                  _oracle(re, im))
    key = 'auto=True i=(8, 2, 6) j=(8, 2, 6)'
    assert 'pallas' in mprobe.peek('linalg_xcorr', key)[1]


@pytest.mark.parametrize('name,op', [('xla', 'einsum'),
                                     ('planar', 'matmul')])
def test_float_candidates_run_without_tf32(monkeypatch, name, op):
    """xla and planar run their products with TF32 off, forced or raced,
    and leave the caller's setting as they found it."""
    flags = []
    real = getattr(torch, op)

    def spy(*args):
        flags.append(torch.backends.cuda.matmul.allow_tf32)
        return real(*args)
    monkeypatch.setattr(torch, op, spy)
    monkeypatch.setattr(torch.backends.cuda.matmul, 'allow_tf32', True)
    re, im = _planes((8, 2, 6), seed=20, lo=-64)
    got = L.XEngine(impl=name)(_t(re), _t(im)).numpy()
    assert flags and not any(flags)
    assert torch.backends.cuda.matmul.allow_tf32 is True
    np.testing.assert_array_equal(got, _oracle(re, im))


def test_gate_rtol_env_override_keys_cache(monkeypatch):
    eng = L.XEngine(accuracy='f32')
    base = eng._key((8, 4, 6), 'int8', True)
    monkeypatch.setenv('BF_XCORR_GATE_RTOL', '0.01')
    assert L.xcorr_class_rtol('f32') == 0.01 == JL.xcorr_class_rtol('f32')
    assert 'planar_bf16' in L.XEngine(accuracy='f32')._candidates(True)
    assert eng._key((8, 4, 6), 'int8', True) == base + '|gate_rtol=0.01'


def test_bad_accuracy_rejected():
    with pytest.raises(ValueError):
        L.XEngine(accuracy='int4')


def test_forced_impl_and_env(monkeypatch):
    re, im = _planes((8, 2, 6), seed=11, lo=-64)
    for impl in ('pallas', 'xla', 'int8_wide'):
        got = L.XEngine(impl=impl)(_t(re), _t(im)).numpy()
        np.testing.assert_array_equal(got, _oracle(re, im))
    monkeypatch.setenv('BF_XCORR_IMPL', 'planar')
    eng = L.XEngine()
    assert eng._force == 'planar' == JL.XEngine()._force
    eng(_t(re), _t(im))
    assert list(eng.chosen.values()) == [] or \
        set(eng.chosen.values()) == {'planar'}


def test_race_gates_and_picks_an_exact_winner(monkeypatch):
    """With probing on (BF_LINALG_PROBE=1), prewarm gates every candidate
    against xla at the per-group shape and races the survivors; a grouped
    call then runs the winner, bit-identical to the oracle."""
    monkeypatch.setenv('BF_LINALG_PROBE', '1')
    eng = L.XEngine(accuracy='int8')
    name = eng.prewarm(8, 2, 6)
    key = eng._key((8, 2, 6), 'int8', True)
    assert eng.chosen[key] == name
    assert set(eng.probe_ms[key]) <= set(eng._candidates(True))
    assert 'planar_bf16' in eng.probe_ms[key]     # inside the int8 class
    re, im = _planes((3, 8, 2, 6), seed=12, lo=-64)
    np.testing.assert_array_equal(eng(_t(re), _t(im)).numpy(),
                                  _oracle(re, im))
    f32 = L.XEngine(accuracy='f32')
    f32.prewarm(8, 2, 6)
    assert 'planar_bf16' not in f32.probe_ms[f32._key((8, 2, 6), 'int8',
                                                      True)]


def test_unprobed_default_matches_jax():
    re, im = _planes((8, 3, 6), seed=13)
    eng = L.XEngine(accuracy='f32')
    assert eng.prewarm(8, 3, 6) == 'int8_3mm'
    assert eng.prewarm(8, 3, 6, int_input=False) == 'xla'
    np.testing.assert_array_equal(
        eng(_t(re), _t(im)).numpy(),
        np.asarray(JL.XEngine(accuracy='f32')(re, im)))
    assert eng.ops_per_frame(3, 6) == \
        JL.XEngine().ops_per_frame(3, 6) == 8 * 3 * 36


# ---------------------------------------------------------------------------
# xcorr_int8, both families
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('probe', ['0', '1'])
@pytest.mark.parametrize('family', ['auto', 'cross'])
def test_xcorr_int8_matches_jax(monkeypatch, family, probe):
    monkeypatch.setenv('BF_LINALG_PROBE', probe)
    re, im = _planes((8, 3, 6), seed=14)
    args = (re, im) if family == 'auto' else \
        (re, im) + _planes((8, 3, 4), seed=15)
    got = L.xcorr_int8(*[_t(a) for a in args]).numpy()
    np.testing.assert_array_equal(got, np.asarray(JL.xcorr_int8(*args)))
    np.testing.assert_array_equal(got, _oracle(*args))
    key = 'auto=%s i=%s j=%s' % (family == 'auto', (8, 3, 6),
                                 (8, 3, 6) if family == 'auto' else (8, 3, 4))
    if probe == '1':
        impls = L._XCORR_AUTO_IMPLS if family == 'auto' else L._XCORR_IMPLS
        assert L._xcorr_chosen[key] in impls
        assert L._xcorr_chosen[key] != 'pallas'   # off the card
    else:
        assert key not in L._xcorr_chosen


@pytest.mark.parametrize('name', ['einsum', 'fmt', 'pallas', 'gram'])
def test_xcorr_int8_forced(monkeypatch, name):
    monkeypatch.setenv('BF_LINALG_XCORR_IMPL', name)
    re, im = _planes((6, 2, 5), seed=16)
    np.testing.assert_array_equal(L.xcorr_int8(_t(re), _t(im)).numpy(),
                                  _oracle(re, im))
    np.testing.assert_array_equal(
        L.xcorr_int8(_t(re), _t(im), impl='fmt3').numpy(), _oracle(re, im))


def test_xcorr_prewarm_records_a_winner(monkeypatch):
    L.xcorr_prewarm(4, 2, 6)
    assert L._xcorr_chosen == {}                 # probing off: a no-op
    monkeypatch.setenv('BF_LINALG_PROBE', '1')
    L.xcorr_prewarm(4, 2, 6)
    L.xcorr_prewarm(4, 2, 3, 6)
    assert set(L._xcorr_chosen) == {'auto=True i=(4, 2, 6) j=(4, 2, 6)',
                                    'auto=False i=(4, 2, 3) j=(4, 2, 6)'}


# ---------------------------------------------------------------------------
# quantize
# ---------------------------------------------------------------------------

def _tie_input():
    """cf32 values with exact .5 ties, values past the int8 limits and
    random ones."""
    ties = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, 127.5, -127.5,
                     -128.5, 128.4, -128.6, 300., -300., 0., -0.], np.float32)
    rng = np.random.RandomState(17)
    rnd = (rng.randn(48) * 80).astype(np.float32)
    re = np.concatenate([ties, rnd])
    im = np.concatenate([rnd[:16], ties, rnd[16:]])
    return (re + 1j * im).astype(np.complex64).reshape(4, 16)


@pytest.mark.parametrize('dtype,scale', [('ci8', 1.), ('ci8', 0.5),
                                         ('ci16', 3.), ('i8', 1.),
                                         ('u8', 1.), ('f32', 0.25)])
def test_quantize_stage_bit_identical_to_jax(dtype, scale):
    x = _tie_input()
    if dtype == 'ci8' and scale == 0.5:
        x = x * 2            # integers whose halves are exact ties
    meta = {'shape': list(x.shape), 'dtype': DataType('cf32'),
            'reim': False}
    hdr = simple_header([-1, 16], 'cf32')
    stage, jstage = QuantizeStage(dtype, scale), JQuantize(dtype, scale)
    assert stage.transform_header(deepcopy(hdr)) == \
        jstage.transform_header(deepcopy(hdr))
    got = stage.build(meta)(_t(x)).numpy()
    want = np.asarray(jstage.build(dict(meta, dtype=bf.DataType('cf32')))(x))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_quantize_into_host_array_matches_jax():
    x = _tie_input() * 0.7
    dst = ndarray(np.zeros(x.shape, bt.dtype.ci8), dtype='ci8')
    Q.quantize(x, dst, scale=2.)
    jdst = bf.ndarray(np.zeros(x.shape, bf.dtype.ci8), dtype='ci8')
    bf.ops.quantize(x, jdst, scale=2.)
    np.testing.assert_array_equal(dst.as_numpy(), np.asarray(jdst))
    # packed outputs: ci4 (one byte a sample) and i4 of the real part
    # (two samples a byte), byte-identical to the JAX package's
    for dt, nbyte in (('ci4', x.shape[-1]), ('i4', x.shape[-1] // 2)):
        dst = ndarray(np.zeros(x.shape[:-1] + (nbyte,), np.uint8), dtype=dt,
                      shape=x.shape)
        Q.quantize(x, dst, scale=0.05)
        jdst = bf.empty(x.shape, dt, 'system')
        bf.ops.quantize(x, jdst, scale=0.05)
        assert dst.as_numpy().tobytes() == jdst.as_numpy().tobytes()


# ---------------------------------------------------------------------------
# the stages
# ---------------------------------------------------------------------------

def _corr_hdr(nchan=3, nstand=4, npol=2, gulp=None):
    return simple_header([-1, nchan, nstand, npol], 'ci8',
                         labels=['time', 'freq', 'station', 'pol'],
                         gulp_nframe=gulp)


def test_correlate_stage_header_and_group_form_match_jax():
    hdr = _corr_hdr()
    stage, jstage = CorrelateStage(4, accuracy='int8'), \
        JCorrelate(4, accuracy='int8')
    ohdr = stage.transform_header(deepcopy(hdr))
    assert ohdr == jstage.transform_header(deepcopy(hdr))
    assert ohdr['_tensor']['labels'] == ['time', 'freq', 'station_i',
                                         'pol_i', 'station_j', 'pol_j']
    rng = np.random.RandomState(18)
    x = _i8(rng, (12, 3, 4, 2, 2), -64)
    meta = {'shape': list(x.shape), 'dtype': DataType('ci8'), 'reim': True}
    got = stage.build(meta)(_t(x)).numpy()
    want = np.asarray(jstage.build(dict(meta, dtype=bf.DataType('ci8')))(x))
    assert got.shape == (3, 3, 4, 2, 4, 2)
    np.testing.assert_array_equal(got, want)
    agg = AccumulateStage(3)
    agg.transform_header(ohdr)
    summed = agg.build({'shape': list(got.shape), 'dtype': DataType('cf32'),
                        'reim': False})(torch.from_numpy(got)).numpy()
    np.testing.assert_array_equal(summed, got.sum(axis=0, keepdims=True))


def test_correlate_stage_refuses_nondividing_integration():
    stage = CorrelateStage(5)
    stage.transform_header(_corr_hdr())          # the header side is fine
    with pytest.raises(ValueError):
        stage.build({'shape': [16, 3, 4, 2, 2], 'dtype': DataType('ci8'),
                     'reim': True})
    with pytest.raises(ValueError):
        CorrelateStage(0)
    with pytest.raises(TypeError):
        CorrelateStage(4).transform_header(simple_header(
            [-1, 3, 4, 2], 'f32', labels=['time', 'freq', 'station', 'pol']))


def test_correlate_stage_forced_kernel_is_one_call_per_gulp():
    """impl='pallas': the gulp's groups go to K7 in one call (the plain
    version here), whatever the number of groups."""
    stage = CorrelateStage(2, accuracy='int8', impl='pallas')
    stage.transform_header(_corr_hdr())
    calls = []
    orig = gpu_kernels.xcorr_herm

    def spy(re, im):
        calls.append(tuple(re.shape))
        return orig(re, im)
    fn = stage.build({'shape': [8, 3, 4, 2, 2], 'dtype': DataType('ci8'),
                      'reim': True})
    x = _t(_i8(np.random.RandomState(19), (8, 3, 4, 2, 2)))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(gpu_kernels, 'xcorr_herm', spy)
        fn(x)
    assert calls == [(4, 2, 3, 8)]


# ---------------------------------------------------------------------------
# the FX chain through the port's Pipeline (tests/test_correlate.py's
# small geometry)
# ---------------------------------------------------------------------------

CNT, CNW, CNS, CNP = 16, 16, 4, 2
CR, CA = 4, 2


def _chain_volts(ngulp, seed=3):
    rng = np.random.RandomState(seed)
    gulps = []
    for _ in range(ngulp):
        raw = np.zeros((CNT, CNW, CNS, CNP), dtype=bf.dtype.ci8)
        raw['re'] = rng.randint(-64, 64, raw.shape)
        raw['im'] = rng.randint(-64, 64, raw.shape)
        gulps.append(raw)
    return gulps


class _Source(bt.SourceBlock):
    def __init__(self, gulps, header, gulp_nframe):
        super(_Source, self).__init__(['numpy'], gulp_nframe, space='system')
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


def _chain_hdr():
    return simple_header([-1, CNW, CNS, CNP], 'ci8',
                         labels=['time', 'fine', 'station', 'pol'])


def _run_port_chain(gulps, accuracy='int8', impl=None):
    with bt.Pipeline() as p:
        src = _Source(gulps, _chain_hdr(), CNT)
        b = bt.blocks.copy(src, space='cuda')
        b = bt.blocks.fft(b, axes='fine', axis_labels='freq')
        b = bt.blocks.quantize(b, 'ci8', scale=1. / CNW)
        b = bt.blocks.correlate(b, CR, accuracy=accuracy, impl=impl,
                                fusable=True)
        b = bt.blocks.accumulate(b, CA, fusable=True)
        sink = _Gather(bt.blocks.copy(b, space='system'))
        run_bounded(p)
    return np.concatenate(sink.gulps), sink.headers


def _run_jax_chain(gulps, accuracy='int8'):
    with bf.Pipeline() as p:
        src = NumpySourceBlock(gulps, _chain_hdr(), gulp_nframe=CNT)
        b = bf.blocks.copy(src, space='tpu')
        b = bf.blocks.fft(b, axes='fine', axis_labels='freq')
        b = bf.blocks.quantize(b, 'ci8', scale=1. / CNW)
        b = bf.blocks.correlate(b, CR, accuracy=accuracy, fusable=True)
        b = bf.blocks.accumulate(b, CA, fusable=True)
        sink = GatherSink(bf.blocks.copy(b, space='system'))
        run_bounded(p)
    return sink.result(), sink.headers


def _port_fx_oracle(gulps):
    """The port's own F step and quantize on the whole stream, then the
    X step in int64 and the accumulate."""
    raw = np.concatenate(gulps, axis=0)
    x = torch.complex(_t(raw['re']).float(), _t(raw['im']).float())
    q = Q.quantize_tensor(fftn_dispatch(x, [1]), 'ci8', 1. / CNW).numpy()
    ntot, n = raw.shape[0], CNS * CNP
    qr = q[..., 0].reshape(ntot // CR, CR, CNW, n)
    qi = q[..., 1].reshape(ntot // CR, CR, CNW, n)
    vis = _oracle(qr, qi)                                 # (g, F, n, n)
    vis = vis.reshape(-1, CA, CNW, n, n).sum(axis=1).astype(np.complex64)
    return vis.reshape(-1, CNW, CNS, CNP, CNS, CNP)


def test_fx_chain_matches_port_oracle_and_jax_chain():
    gulps = _chain_volts(4)
    got, hdrs = _run_port_chain(gulps)
    assert got.dtype == np.complex64
    assert got.shape == (4 * CNT // (CR * CA), CNW, CNS, CNP, CNS, CNP)
    np.testing.assert_array_equal(got, _port_fx_oracle(gulps))
    # the port's F step (pocketfft here, cuFFT on the card) and XLA's
    # round no quantized value apart on these gulps, so the chains are
    # compared end to end
    want, jhdrs = _run_jax_chain(gulps)
    np.testing.assert_array_equal(got, want)
    assert hdrs[0]['_tensor'] == jhdrs[0]['_tensor']
    assert hdrs[0]['matrix_fill_mode'] == 'full'


@pytest.mark.parametrize('accuracy,impl', [('f32', None), ('int8', 'xla'),
                                           ('int8', 'pallas'),
                                           ('bf16', 'planar')])
def test_fx_chain_arms_byte_identical(accuracy, impl):
    """On ci8 planes every candidate is exact: the arms agree bit for bit
    with the default int arm."""
    gulps = _chain_volts(2, seed=5)
    base, _ = _run_port_chain(gulps)
    got, _ = _run_port_chain(gulps, accuracy=accuracy, impl=impl)
    np.testing.assert_array_equal(got, base)


# ---------------------------------------------------------------------------
# the stateful blocks against the JAX blocks
# ---------------------------------------------------------------------------

def _stateful_gulps(n=4, seed=11, shape=(16, 8, 3, 2)):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        raw = np.zeros(shape, dtype=bf.dtype.ci8)
        raw['re'] = rng.randint(-128, 128, raw.shape)
        raw['im'] = rng.randint(-128, 128, raw.shape)
        out.append(raw)
    return out


@pytest.mark.parametrize('impl', [None, 'pallas'])
def test_correlate_block_integrates_across_gulps_like_jax(impl):
    """CorrelateBlock(64) over 4 gulps of 16 frames: one output frame,
    the sum over all 64, bit-identical to the JAX block and the oracle."""
    gulps = _stateful_gulps()
    hdr = _corr_hdr(8, 3, 2, gulp=16)
    with bt.Pipeline() as p:
        src = _Source(gulps, hdr, 16)
        b = bt.blocks.copy(src, space='cuda')
        corr = bt.blocks.correlate(b, 64, accuracy='int8', impl=impl)
        sink = _Gather(bt.blocks.copy(corr, space='system'))
        run_bounded(p)
    got = np.concatenate(sink.gulps)
    assert corr._gemm_ops == 8 * 16 * 8 * 6 ** 2
    with bf.Pipeline() as p:
        src = NumpySourceBlock(gulps, hdr, gulp_nframe=16)
        b = bf.blocks.copy(src, space='tpu')
        b = bf.blocks.correlate(b, 64, accuracy='int8')
        jsink = GatherSink(bf.blocks.copy(b, space='system'))
        run_bounded(p)
    np.testing.assert_array_equal(got, jsink.result())
    assert sink.headers[0]['_tensor'] == jsink.headers[0]['_tensor']
    raw = np.concatenate(gulps)
    want = _oracle(raw['re'].reshape(64, 8, 6), raw['im'].reshape(64, 8, 6))
    np.testing.assert_array_equal(got.reshape(1, 8, 6, 6), want[None])


def test_correlate_block_refuses_gulp_not_dividing_integration():
    gulps = _stateful_gulps(1)
    with pytest.raises(bt.PipelineInitError, match='does not divide'):
        with bt.Pipeline() as p:
            src = _Source(gulps, _corr_hdr(8, 3, 2, gulp=16), 16)
            b = bt.blocks.copy(src, space='cuda')
            _Gather(bt.blocks.correlate(b, 24))
            run_bounded(p)
@pytest.mark.parametrize('space', ['cuda', 'system'])
def test_accumulate_block_matches_jax(space):
    rng = np.random.RandomState(21)
    gulps = [(rng.randn(4, 5) + 1j * rng.randn(4, 5)).astype(np.complex64)
             for _ in range(2)]
    hdr = simple_header([-1, 5], 'cf32')
    with bt.Pipeline() as p:
        src = _Source(gulps, hdr, 4)
        b = bt.blocks.copy(src, space=space)
        b = bt.blocks.accumulate(b, 4)
        sink = _Gather(bt.blocks.copy(b, space='system'))
        run_bounded(p)
    jspace = 'tpu' if space == 'cuda' else 'system'
    with bf.Pipeline() as p:
        src = NumpySourceBlock(gulps, hdr, gulp_nframe=4)
        b = bf.blocks.copy(src, space=jspace)
        b = bf.blocks.accumulate(b, 4)
        jsink = GatherSink(bf.blocks.copy(b, space='system'))
        run_bounded(p)
    got = np.concatenate(sink.gulps)
    assert got.shape == (2, 5)
    np.testing.assert_array_equal(got, jsink.result())
    with pytest.raises(ValueError):
        bt.blocks.accumulate(None, 4, dtype='cf32', fusable=True)
