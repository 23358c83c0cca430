"""FDMT dedispersion of the PyTorch/CUDA port (the K3 wrapper and its
plain version in ops.gpu_kernels, the Fdmt engine in ops.fdmt, FdmtStage,
MatchedFilterStage, ThresholdStage, TransposeStage, chain_overlap_nframe
and the fdmt, fdmt_stage, matched_filter and threshold blocks) against
the JAX package on the same seeded inputs, with its Pallas step kernel in
interpret mode (as tests/test_fdmt.py runs it on the CPU), and against
the float64 numpy oracle ``fdmt_numpy``.  The port runs on the CPU device
here, where K3's wrapper runs its plain PyTorch version; the CUDA kernel
is held against that version on the card (chip_smoke.py,
tests/test_torch_cuda.py).

Tolerances: the plan tables equal; K3's plain version, every core and
every stage bit-identical to the JAX package (both sum the init's terms in
delay order and do one float32 add per merge-step element); every core
within 1e-4 (``FDMT_GATE_RTOL``) of the float64 oracle, relative to its
largest magnitude.
"""

import contextlib
from copy import deepcopy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bifrost_tpu as bf
from bifrost_tpu.ops import fdmt as JF
from bifrost_tpu.ops import pallas_kernels as pk
from bifrost_tpu import stages as JS

import bifrost_tpu_torch as bt
from bifrost_tpu_torch import device
from bifrost_tpu_torch import stages as TS
from bifrost_tpu_torch.ops import fdmt as TF
from bifrost_tpu_torch.ops import gpu_kernels, mprobe
from tests.test_torch_bounded import run_bounded

RTOL = 1e-4


@pytest.fixture(autouse=True)
def _cpu(monkeypatch, tmp_path):
    device.set_device('cpu')
    monkeypatch.setenv('BF_CACHE_DIR', str(tmp_path / 'cache'))
    monkeypatch.setattr(mprobe, '_cache', {})
    monkeypatch.setattr(mprobe, '_flip_uses', {})
    for var in ('BF_FDMT_IMPL', 'BF_FDMT_PROBE', 'BF_FDMT_GATE_RTOL'):
        monkeypatch.delenv(var, raising=False)


def _untraced(hdr):
    """A pipeline header without its trace context (a random id and the
    clock of each run's source)."""
    return {k: v for k, v in hdr.items() if k != '_trace'}


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


def _plans(nchan, max_delay, f0, df, exponent=-2.0):
    return (JF.Fdmt().init(nchan, max_delay, f0, df, exponent),
            TF.Fdmt().init(nchan, max_delay, f0, df, exponent))


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('nchan,max_delay,f0,df,exponent', [
    (8, 6, 100.0, 1.0, -2.0), (13, 7, 1400.0, 0.1, -2.0),
    (32, 24, 100.0, 1.0, -2.0), (100, 37, 1200.0, 4.0, -2.0),
    (33, 12, 1400.0, -0.1, -2.0), (16, 12, 1400.0, 0.5, -1.0),
    (13, 1, 1400.0, 0.1, -2.0), (1, 4, 1400.0, -0.1, -2.0)])
def test_plan_tables_equal_jax(nchan, max_delay, f0, df, exponent):
    jp, tp = _plans(nchan, max_delay, f0, df, exponent)
    assert tp._plan['nd_init'] == jp._plan['nd_init']
    assert tp.max_delay == jp.max_delay == max_delay
    assert len(tp._plan['steps']) == len(jp._plan['steps'])
    for a, b in zip(jp._plan['steps'], tp._plan['steps']):
        for name in ('d1', 'd2', 'passthrough', 'rows_lo', 'rows_hi'):
            np.testing.assert_array_equal(getattr(b, name), getattr(a, name))
            assert getattr(b, name).dtype == getattr(a, name).dtype
        assert b.nd_out == a.nd_out
    assert tp._rolls_segments() == jp._rolls_segments()


# ---------------------------------------------------------------------------
# K3: the plain version against the Pallas step kernel
# ---------------------------------------------------------------------------

def _init(plan, x, sgn):
    return TF._init_state(torch.from_numpy(x)[None], plan._plan['nd_init'],
                          sgn)[0]


@pytest.mark.parametrize('nchan,max_delay,T,sgn', [
    (16, 12, 100, 1), (16, 12, 100, -1), (13, 7, 130, 1), (13, 7, 130, -1),
    (11, 9, 64, 1), (5, 3, 1, 1), (2, 2, 129, -1)])
def test_fdmt_step_plain_bit_identical_to_pallas(nchan, max_delay, T, sgn):
    """Every step of the plan, the state carried through the plain
    version; the Pallas kernel runs on the 128-padded state and is read on
    [:T].  Odd subband counts exercise the passthrough rows and the
    rows_hi clamp."""
    _, tp = _plans(nchan, max_delay, 1400.0, 0.1)
    rng = np.random.RandomState(nchan * 7 + T)
    x = rng.randn(nchan, T).astype(np.float32)
    state = _init(tp, x, sgn)
    Tp = -(-T // 128) * 128
    saw_pass = False
    for step in tp._plan['steps']:
        d1, d2 = torch.from_numpy(step.d1), torch.from_numpy(step.d2)
        pt = torch.from_numpy(step.passthrough.astype(np.int32))
        saw_pass |= bool(step.passthrough.any())
        before = gpu_kernels.launches['fdmt_step']
        got = gpu_kernels.fdmt_step(state, d1, d2, pt, sgn)
        assert gpu_kernels.launches['fdmt_step'] == before   # plain here
        assert got.shape == (step.d1.shape[0], step.d1.shape[1], T)
        padded = np.zeros(tuple(state.shape[:2]) + (Tp,), np.float32)
        padded[..., :T] = state.numpy()
        fn = pk.fdmt_step(step.d1, step.d2,
                          step.passthrough.astype(np.int32),
                          state.shape[0] - 1, sgn, T, interpret=True)
        want = np.asarray(fn(jnp.asarray(padded)))[..., :T]
        np.testing.assert_array_equal(got.numpy(), want)
        state = got
    assert saw_pass == (nchan in (13, 11, 5))


def test_fdmt_step_plain_takes_a_batch_axis():
    """(B, nchan, nd, T) gives each batch entry's step, in one call."""
    _, tp = _plans(13, 7, 1400.0, 0.1)
    rng = np.random.RandomState(3)
    x = rng.randn(3, 13, 50).astype(np.float32)
    state = TF._init_state(torch.from_numpy(x), tp._plan['nd_init'], 1)
    step = tp._plan['steps'][0]
    tabs = (torch.from_numpy(step.d1), torch.from_numpy(step.d2),
            torch.from_numpy(step.passthrough.astype(np.int32)))
    got = gpu_kernels.fdmt_step(state.contiguous(), *tabs, 1)
    assert got.shape == (3, 7) + tuple(step.d1.shape[1:]) + (50,)
    for b in range(3):
        one = gpu_kernels.fdmt_step(state[b].contiguous(), *tabs, 1)
        np.testing.assert_array_equal(got[b].numpy(), one.numpy())


def test_fdmt_step_wrapper_rejects_what_the_kernel_cannot_take():
    _, tp = _plans(8, 6, 100.0, 1.0)
    step = tp._plan['steps'][0]
    d1, d2 = torch.from_numpy(step.d1), torch.from_numpy(step.d2)
    pt = torch.from_numpy(step.passthrough.astype(np.int32))
    nd = tp._plan['nd_init']
    good = torch.zeros((8, nd, 16))
    gpu_kernels.fdmt_step(good, d1, d2, pt, 1)
    bad = [(good.double(), d1, d2, pt, 1),                      # dtype
           (torch.zeros((8, 16, nd)).transpose(1, 2), d1, d2, pt, 1),
           (torch.zeros((8, nd, 0)), d1, d2, pt, 1),             # T = 0
           (good, d1.long(), d2, pt, 1),
           (good, d1, d2, pt.bool(), 1),
           (good, d1, d2, pt, 0),
           (torch.zeros((6, nd, 16)), d1, d2, pt, 1)]           # subbands
    for args in bad:
        with pytest.raises(ValueError):
            gpu_kernels.fdmt_step(*args)


# ---------------------------------------------------------------------------
# the cores, against each other, the JAX cores and the oracle
# ---------------------------------------------------------------------------

CORE_CASES = [(16, 12, 100, 1400.0, 0.1, False), (13, 7, 130, 1400.0, 0.1, True),
              (64, 37, 300, 1400.0, -0.1, False), (33, 12, 100, 1400.0, -0.1, True),
              (32, 32, 64, 100.0, 1.0, False), (1, 4, 32, 1400.0, -0.1, False)]


@pytest.mark.parametrize('nchan,md,T,f0,df,neg', CORE_CASES)
def test_cores_bit_identical_to_each_other_and_jax(nchan, md, T, f0, df, neg):
    jp, tp = _plans(nchan, md, f0, df)
    x = np.random.RandomState(nchan + T).randn(nchan, T).astype(np.float32)
    xt = torch.from_numpy(x)[None]
    got = {name: getattr(tp, fn)(neg)(xt)[0].numpy()
           for name, fn in (('xla', '_core_jax'), ('rolls', '_core_jax_rolls'),
                            ('pallas', '_core_pallas'))}
    want = {'xla': jax.jit(jp._core_jax(neg)),
            'rolls': jax.jit(jp._core_jax_rolls(neg)),
            'pallas': jax.jit(jp._core_pallas(neg, interpret=True))}
    for name, fn in want.items():
        assert got[name].shape == (md, T)
        np.testing.assert_array_equal(got[name], got['xla'])
        np.testing.assert_array_equal(got[name], np.asarray(fn(x)))
    ref = TF.fdmt_numpy(nchan, md, f0, df, x, negative_delays=neg)
    np.testing.assert_array_equal(
        ref, JF.fdmt_numpy(nchan, md, f0, df, x, negative_delays=neg))
    assert _rel(got['xla'], ref) < RTOL


def test_k3_core_takes_the_steps_jax_sends_to_the_gather(monkeypatch):
    """With the JAX SMEM budget at 0 (every step to the XLA gather) or 200
    bytes (the first steps to the gather, the later ones to Pallas) the
    JAX core still equals the port's K3 core, which takes every step."""
    jp, tp = _plans(16, 12, 1400.0, 0.1)
    x = np.random.RandomState(4).randn(16, 100).astype(np.float32)
    port = tp._core_pallas(False)(torch.from_numpy(x)[None])[0].numpy()
    for budget in (0, 200):
        monkeypatch.setattr(JF, 'SMEM_TABLE_BUDGET', budget)
        want = np.asarray(jax.jit(jp._core_pallas(False, interpret=True))(
            jnp.asarray(x)))
        np.testing.assert_array_equal(port, want)


def test_execute_casts_integer_input_and_keeps_batch_axes():
    jp, tp = _plans(8, 6, 100.0, 1.0)
    rng = np.random.RandomState(5)
    xi = rng.randint(0, 256, size=(2, 3, 8, 40)).astype(np.uint8)
    got = tp.execute(torch.from_numpy(xi))
    assert got.dtype == torch.float32 and got.shape == (2, 3, 6, 40)
    want = np.asarray(jp.execute(xi))
    np.testing.assert_array_equal(got.numpy(), want)
    one = tp.execute(xi[1, 2].astype(np.float32))
    np.testing.assert_array_equal(got[1, 2].numpy(), one.numpy())
    out = np.zeros((2, 3, 6, 40), np.float32)
    assert tp.execute(xi, out) is out
    np.testing.assert_array_equal(out, want)


@pytest.mark.parametrize('impl', ['xla', 'rolls', 'pallas'])
def test_forced_core_runs_on_the_cpu(monkeypatch, impl):
    """BF_FDMT_IMPL forces a core; a forced K3 on the CPU runs its plain
    version (no launch) and equals the JAX execute."""
    monkeypatch.setenv('BF_FDMT_IMPL', impl)
    jp, tp = _plans(13, 7, 1400.0, 0.1)
    x = np.random.RandomState(6).randn(13, 90).astype(np.float32)
    before = gpu_kernels.launches['fdmt_step']
    got = tp.execute(x, negative_delays=True).numpy()
    assert tp.chosen_core == impl
    assert gpu_kernels.launches['fdmt_step'] == before
    monkeypatch.delenv('BF_FDMT_IMPL')
    np.testing.assert_array_equal(
        got, np.asarray(jp.execute(x, negative_delays=True)))


def test_tables_go_to_the_device_once_per_plan(monkeypatch):
    monkeypatch.setenv('BF_FDMT_IMPL', 'pallas')
    _, tp = _plans(13, 7, 1400.0, 0.1)
    x = np.random.RandomState(7).randn(13, 90).astype(np.float32)
    for _ in range(3):
        tp.execute(x)
    tp.execute(x[:, :50])
    assert tp.table_uploads == 1
    tp.init(13, 7, 1400.0, 0.1)
    tp.execute(x)
    assert tp.table_uploads == 2


# ---------------------------------------------------------------------------
# candidates, the race and its gate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('nchan,md,f0,df', [(16, 8, 1400.0, -0.1),
                                            (64, 2100, 100.0, 1.0)])
def test_candidate_lists_equal_jax_off_the_card(nchan, md, f0, df):
    jp, tp = _plans(nchan, md, f0, df)
    assert sorted(tp._candidate_cores(False)) == \
        sorted(jp._candidate_cores(False))
    monkey_key = tp._probe_key((nchan, 256), True)
    assert monkey_key == jp._probe_key((nchan, 256), True)


def test_kernel_core_races_only_where_the_probe_passed(monkeypatch):
    _, tp = _plans(16, 8, 1400.0, -0.1)
    assert 'pallas' not in tp._candidate_cores(False)
    asked = []

    def fake_available(device=None):
        asked.append(device)
        return True
    monkeypatch.setattr(gpu_kernels, 'available', fake_available)
    assert sorted(tp._candidate_cores(False, 'cpu')) == \
        ['pallas', 'rolls', 'xla']
    assert asked == ['cpu']


def test_race_runs_under_probe_env_and_caches_its_winner(monkeypatch,
                                                         tmp_path):
    monkeypatch.setenv('BF_FDMT_PROBE', '1')
    monkeypatch.setenv('BF_CACHE_DIR', str(tmp_path))
    monkeypatch.setattr(gpu_kernels, 'available', lambda device=None: True)
    # a noise threshold of 1.0 makes every ranking decisive, so the race
    # writes its winner to disk however close the times come under load
    real = mprobe.select
    monkeypatch.setattr(mprobe, 'select',
                        lambda *a, **k: real(*a, **dict(k, noise=1.0)))
    _, tp = _plans(16, 8, 1400.0, -0.1)
    core = tp._pick_core(False, shape=(16, 128))
    assert sorted(tp.core_probe_ms) == ['pallas', 'rolls', 'xla']
    assert tp.chosen_core == min(tp.core_probe_ms, key=tp.core_probe_ms.get)
    assert tp.gate_ms is not None and tp.gate_ms >= 0
    x = np.random.RandomState(0).rand(16, 128).astype(np.float32)
    got = core(torch.from_numpy(x)[None])[0].numpy()
    assert _rel(got, tp._core_numpy(x.astype(np.float64))) < RTOL
    # a ragged later shape reuses the locked winner without racing
    monkeypatch.setattr(TF.Fdmt, '_probe_cores', lambda *a, **k: 1 / 0)
    tp._pick_core(False, shape=(16, 77))
    monkeypatch.undo()
    monkeypatch.setenv('BF_FDMT_PROBE', '1')
    monkeypatch.setenv('BF_CACHE_DIR', str(tmp_path))
    monkeypatch.setattr(gpu_kernels, 'available', lambda device=None: True)
    assert (tmp_path / 'fdmt.json').exists()
    monkeypatch.setattr(mprobe, '_cache', {})
    _, tp2 = _plans(16, 8, 1400.0, -0.1)
    tp2._pick_core(False, shape=(16, 128))
    assert tp2.chosen_core == tp.chosen_core
    assert tp2.gate_ms is None          # served from disk, no gate


def test_probe_off_keeps_the_jax_heuristic(monkeypatch):
    monkeypatch.setenv('BF_FDMT_PROBE', '0')
    jp, tp = _plans(16, 8, 1400.0, -0.1)
    tp._pick_core(False, shape=(16, 128))
    jp._pick_core(False, shape=(16, 128))
    assert tp.chosen_core == jp.chosen_core == 'rolls'
    assert tp.core_probe_ms is None


def test_kernel_error_in_the_gate_raises(monkeypatch):
    monkeypatch.setenv('BF_FDMT_PROBE', '1')
    monkeypatch.setattr(gpu_kernels, 'available', lambda device=None: True)

    def broken(*args):
        raise RuntimeError('K3 launch failed')
    monkeypatch.setattr(gpu_kernels, 'fdmt_step', broken)
    _, tp = _plans(16, 8, 1400.0, -0.1)
    with pytest.raises(RuntimeError, match='K3 launch failed'):
        tp._pick_core(False, shape=(16, 128))


def test_kernel_outside_the_gate_raises(monkeypatch):
    monkeypatch.setenv('BF_FDMT_PROBE', '1')
    monkeypatch.setattr(gpu_kernels, 'available', lambda device=None: True)
    plain = gpu_kernels.fdmt_step_plain
    monkeypatch.setattr(gpu_kernels, 'fdmt_step',
                        lambda s, *a: plain(s, *a) + 1.0)
    _, tp = _plans(16, 8, 1400.0, -0.1)
    with pytest.raises(RuntimeError, match='deviates'):
        tp._pick_core(False, shape=(16, 128))


def test_kernel_error_in_the_race_raises(monkeypatch):
    """A K3 that passes the gate and then fails while timed raises out of
    mprobe.select (strict), never races on without it."""
    monkeypatch.setenv('BF_FDMT_PROBE', '1')
    monkeypatch.setattr(gpu_kernels, 'available', lambda device=None: True)
    plain = gpu_kernels.fdmt_step_plain
    calls = []

    def flaky(*args):
        calls.append(1)
        if len(calls) > 2:
            raise RuntimeError('K3 failed in the race')
        return plain(*args)
    monkeypatch.setattr(gpu_kernels, 'fdmt_step', flaky)
    _, tp = _plans(4, 4, 1400.0, -0.1)        # two steps per core call
    with pytest.raises(RuntimeError, match='in the race'):
        tp._pick_core(False, shape=(4, 128))


def test_a_failing_torch_core_is_dropped_not_raised(monkeypatch):
    monkeypatch.setenv('BF_FDMT_PROBE', '1')
    _, tp = _plans(16, 8, 1400.0, -0.1)
    monkeypatch.setattr(TF.Fdmt, '_core_jax_rolls',
                        lambda self, neg: (lambda x: 1 / 0))
    tp._pick_core(False, shape=(16, 128))
    assert tp.chosen_core == 'xla'
    assert list(tp.core_probe_ms) == ['xla']


# ---------------------------------------------------------------------------
# stages
# ---------------------------------------------------------------------------

def _fb_header(nchan=16, labels=('freq', 'time'), dtype='f32'):
    return {'name': 'frb', 'time_tag': 0, 'refdm': 0.5,
            'refdm_units': 'pc cm^-3',
            '_tensor': {'shape': [nchan, -1], 'dtype': dtype,
                        'labels': list(labels),
                        'scales': [[1400.0, -0.5], [0.0, 1e-3]],
                        'units': ['MHz', 'ms']}}


def test_fdmt_stage_header_and_output_equal_jax():
    hdr = _fb_header()
    js, ts = JS.FdmtStage(9), TS.FdmtStage(9)
    assert ts.overlap_nframe == js.overlap_nframe == 9
    assert ts.batch_safe == js.batch_safe is True
    jh, th = js.transform_header(deepcopy(hdr)), ts.transform_header(
        deepcopy(hdr))
    assert th == jh
    x = np.random.RandomState(8).randn(16, 70).astype(np.float32)
    want = np.asarray(js.build({'shape': [16, 70]})(jnp.asarray(x)))
    got = ts.build({'shape': [16, 70]})(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    xb = np.random.RandomState(9).randint(0, 9, (2, 16, 70)).astype(np.int16)
    want = np.asarray(js.build({'shape': [2, 16, 70]})(jnp.asarray(xb)))
    got = ts.build({'shape': [2, 16, 70]})(torch.from_numpy(xb))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize('ntap,shape,dtype', [(8, [5, -1], 'f32'),
                                              (1, [5, -1], 'f32'),
                                              (3, [-1, 4], 'i16')])
def test_matched_filter_stage_equals_jax(ntap, shape, dtype):
    hdr = {'name': 'm', '_tensor': {'shape': shape, 'dtype': dtype}}
    js, ts = JS.MatchedFilterStage(ntap), TS.MatchedFilterStage(ntap)
    assert ts.overlap_nframe == js.overlap_nframe == ntap - 1
    assert ts.transform_header(deepcopy(hdr)) == \
        js.transform_header(deepcopy(hdr))
    dev = [40 if s == -1 else s for s in shape]
    x = (np.random.RandomState(ntap).randn(*dev) * 100).astype(
        np.float32 if dtype == 'f32' else np.int16)
    want = np.asarray(js.build({'shape': dev})(jnp.asarray(x)))
    got = ts.build({'shape': dev})(torch.from_numpy(x)).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_threshold_stage_equals_jax():
    x = np.random.RandomState(10).randn(6, 50).astype(np.float32)
    js, ts = JS.ThresholdStage(0.7), TS.ThresholdStage(0.7)
    hdr = _fb_header()
    assert ts.transform_header(deepcopy(hdr)) == \
        js.transform_header(deepcopy(hdr))
    want = np.asarray(js.build({})(jnp.asarray(x)))
    got = ts.build({})(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.count_nonzero(got) == np.count_nonzero(x >= np.float32(0.7))


@pytest.mark.parametrize('axes,dtype,shape', [
    (['pol', 'freq', 'time'], 'u8', [-1, 2, 6]),
    ([1, 0, 2], 'f32', [4, -1, 3]),
    (['freq', 'time', 'pol'], 'ci8', [-1, 2, 6])])
def test_transpose_stage_equals_jax(axes, dtype, shape):
    labels = ['time', 'pol', 'freq'] if isinstance(axes[0], str) else \
        ['a', 'time', 'b']
    hdr = {'name': 't', '_tensor': {
        'shape': shape, 'dtype': dtype, 'labels': labels,
        'scales': [[0, 1], None, [1200.0, 0.1]],
        'units': ['s', None, 'MHz']}}
    js, ts = JS.TransposeStage(axes), TS.TransposeStage(axes)
    assert ts.transform_header(deepcopy(hdr)) == \
        js.transform_header(deepcopy(hdr))
    dev = [5 if s == -1 else s for s in shape] + \
        ([2] if dtype == 'ci8' else [])
    npdt = {'u8': np.uint8, 'f32': np.float32, 'ci8': np.int8}[dtype]
    x = np.random.RandomState(11).randint(-100, 100, dev).astype(npdt)
    meta = {'shape': dev, 'reim': dtype == 'ci8'}
    want = np.asarray(js.build(meta)(jnp.asarray(x)))
    got = ts.build(meta)(torch.from_numpy(x))
    assert got.is_contiguous() and got.dtype == torch.from_numpy(x).dtype
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize('chain', [
    [('fdmt', 32), ('mf', 8), ('thr', 1.0)], [('mf', 4), ('fdmt', 10)],
    [('thr', 0.0)], [('fdmt', 5), ('acc', 4), ('mf', 3)],
    [('mf', 3), ('acc', 2), ('mf', 2)]])
def test_chain_overlap_nframe_agrees_with_jax(chain):
    def make(mod, kind, arg):
        return {'fdmt': lambda: mod.FdmtStage(arg),
                'mf': lambda: mod.MatchedFilterStage(arg),
                'thr': lambda: mod.ThresholdStage(arg),
                'acc': lambda: mod.AccumulateStage(arg)}[kind]()

    def build(mod):
        stages = [make(mod, k, a) for k, a in chain]
        for s in stages:
            if hasattr(s, 'factor') and s.factor:
                s.nframe_ratio = (1, s.factor)
        return stages
    assert TS.chain_overlap_nframe(build(TS)) == \
        JS.chain_overlap_nframe(build(JS))


# ---------------------------------------------------------------------------
# pipelines, both packages on the same inputs
# ---------------------------------------------------------------------------

class _FreqSource(bt.SourceBlock):
    """[freq, time] gulps into a system ring (freq lanes are ringlets)."""

    def __init__(self, gulps, header, gulp_nframe):
        super(_FreqSource, self).__init__(['frb'], gulp_nframe,
                                          space='system')
        self._gulps, self._header = gulps, header

    def create_reader(self, name):
        return contextlib.nullcontext(iter(self._gulps))

    def on_sequence(self, reader, name):
        return [deepcopy(self._header)]

    def on_data(self, reader, ospans):
        g = next(reader, None)
        if g is None:
            return [0]
        ospans[0].data.as_numpy()[...] = g
        return [g.shape[-1]]


class _JaxFreqSource(bf.SourceBlock):
    def __init__(self, gulps, header, gulp_nframe):
        super(_JaxFreqSource, self).__init__(['frb'], gulp_nframe)
        self._gulps, self._header = gulps, header

    def create_reader(self, name):
        return contextlib.nullcontext(iter(self._gulps))

    def on_sequence(self, reader, name):
        return [deepcopy(self._header)]

    def on_data(self, reader, ospans):
        g = next(reader, None)
        if g is None:
            return [0]
        ospans[0].data.as_numpy()[...] = g
        return [g.shape[-1]]


class _Gather(bt.SinkBlock):
    def __init__(self, iring):
        super(_Gather, self).__init__(iring)
        self.headers, self.gulps = [], []

    def on_sequence(self, iseq):
        self.headers.append(iseq.header)

    def on_data(self, ispan):
        self.gulps.append(np.array(ispan.data.as_numpy(), copy=True))


class _JaxGather(bf.SinkBlock):
    def __init__(self, iring):
        super(_JaxGather, self).__init__(iring)
        self.headers, self.gulps = [], []

    def on_sequence(self, iseq):
        self.headers.append(iseq.header)

    def on_data(self, ispan):
        self.gulps.append(np.array(ispan.data.as_numpy(), copy=True))


def _dsp_header(nchan):
    return {'name': 'fdmt-test', 'time_tag': 0,
            '_tensor': {'shape': [nchan, -1], 'dtype': 'f32',
                        'labels': ['freq', 'time'],
                        'scales': [[100.0, 1.0], [0.0, 1e-3]],
                        'units': ['MHz', 's']}}


def _run_fdmt_block(pkg, gulps, hdr, gulp, **kw):
    src_cls, sink_cls, space = ((_FreqSource, _Gather, 'cuda')
                                if pkg is bt else
                                (_JaxFreqSource, _JaxGather, 'tpu'))
    with pkg.Pipeline() as p:
        src = src_cls(gulps, hdr, gulp)
        b = pkg.blocks.copy(src, space=space)
        b = pkg.blocks.fdmt(b, **kw)
        sink = sink_cls(pkg.blocks.copy(b, space='system'))
        run_bounded(p)
    return np.concatenate(sink.gulps, axis=-1), sink.headers


def test_fdmt_block_with_overlap_matches_jax_and_whole_stream():
    """tests/test_blocks_dsp.py:10 through both packages: fdmt(max_dm=0.15)
    over four 16-frame gulps equals the FDMT of the whole stream on the
    committed frames, and the JAX block bit for bit."""
    nchan, T = 8, 64
    x = np.random.RandomState(0).rand(nchan, T).astype(np.float32)
    gulps = [x[:, i * 16:(i + 1) * 16].copy() for i in range(4)]
    got, hdrs = _run_fdmt_block(bt, gulps, _dsp_header(nchan), 16,
                                max_dm=0.15)
    want, jhdrs = _run_fdmt_block(bf, gulps, _dsp_header(nchan), 16,
                                  max_dm=0.15)
    max_delay = hdrs[0]['_tensor']['shape'][-2]
    assert _untraced(hdrs[0]) == _untraced(jhdrs[0]) and max_delay == 9
    np.testing.assert_array_equal(got, want)
    full = TF.Fdmt().init(nchan, max_delay, 100.0, 1.0).execute(x).numpy()
    n = got.shape[-1]
    assert n >= T - 2 * max_delay
    np.testing.assert_array_equal(got, full[:, :n])


def test_fdmt_block_negative_delays_and_max_diagonal_match_jax():
    nchan = 8
    x = np.random.RandomState(1).rand(nchan, 48).astype(np.float32)
    gulps = [x[:, i * 16:(i + 1) * 16].copy() for i in range(3)]
    for kw in ({'max_delay': 5, 'negative_delays': True},
               {'max_diagonal': 0.5}):
        got, hdrs = _run_fdmt_block(bt, gulps, _dsp_header(nchan), 16, **kw)
        want, jhdrs = _run_fdmt_block(bf, gulps, _dsp_header(nchan), 16,
                                      **kw)
        assert _untraced(hdrs[0]) == _untraced(jhdrs[0])
        np.testing.assert_array_equal(got, want)
    with bt.Pipeline():
        with pytest.raises(ValueError, match='exactly one'):
            bt.blocks.fdmt(bt.Ring(space='cuda'), max_dm=1.0, max_delay=3)


def test_fdmt_block_probes_in_on_sequence_never_in_on_data(monkeypatch):
    """The port of tests/test_prewarm.py:61: with the race forced on, the
    probe runs in the on_sequence warm-up; neither the steady spans nor
    the ragged final span probe inside on_data."""
    from bifrost_tpu_torch.blocks.fdmt import FdmtBlock
    monkeypatch.setenv('BF_FDMT_PROBE', '1')
    state = {'in_on_data': False}
    probes = []
    orig_probe = TF.Fdmt._probe_cores
    orig_on_data = FdmtBlock.on_data

    def spy_probe(self, cands, shape, negative_delays, device=None):
        probes.append((state['in_on_data'], tuple(shape)))
        return orig_probe(self, cands, shape, negative_delays, device)

    def spy_on_data(self, ispan, ospan):
        state['in_on_data'] = True
        try:
            return orig_on_data(self, ispan, ospan)
        finally:
            state['in_on_data'] = False

    monkeypatch.setattr(TF.Fdmt, '_probe_cores', spy_probe)
    monkeypatch.setattr(FdmtBlock, 'on_data', spy_on_data)
    x = np.random.RandomState(0).rand(8, 64).astype(np.float32)
    gulps = [x[:, i * 16:(i + 1) * 16].copy() for i in range(4)]
    got, _ = _run_fdmt_block(bt, gulps, _dsp_header(8), 16, max_delay=9)
    assert got.size
    assert probes == [(False, (8, 25))]


def test_fdmt_block_warmup_errors_propagate(monkeypatch):
    def broken(self, *a, **k):
        raise RuntimeError('warm-up failed')
    monkeypatch.setattr(TF.Fdmt, 'warmup', broken)
    x = np.random.RandomState(0).rand(8, 32).astype(np.float32)
    with pytest.raises(bt.PipelineInitError, match='warm-up failed'):
        _run_fdmt_block(bt, [x[:, :16], x[:, 16:]], _dsp_header(8), 16,
                        max_delay=5)


# config 22's FRB search at its own small geometry (bench_suite.py:4984)
NCHAN, GULP, MD, NTAP, F0, DF, FAR = 32, 64, 32, 8, 100.0, 1.0, 1e-3


def _frb_data(ngulp=8):
    T = ngulp * GULP
    rng = np.random.RandomState(23)
    noise = rng.randn(NCHAN, T).astype(np.float32)
    band = JF._cff(F0, F0 + NCHAN * DF, -2.0)
    x = noise.copy()
    for d_true, t0, amp in ((24, 100, 4.0), (10, 260, 4.0), (30, 390, 4.0)):
        for c in range(NCHAN):
            delay = int(round(d_true * JF._cff(F0, F0 + c * DF, -2.0) / band))
            if t0 + delay < T:
                x[c, t0 + delay] += amp
    return noise, x


def _oracle_chain(data):
    dm = TF.fdmt_numpy(NCHAN, MD, F0, DF, data.astype(np.float64))
    tv = dm.shape[-1] - (NTAP - 1)
    mf = np.zeros((MD, tv))
    for i in range(NTAP):
        mf += dm[:, i:i + tv]
    return mf


def _frb_header():
    return {'_tensor': {'shape': [NCHAN, -1], 'dtype': 'f32',
                        'labels': ['freq', 'time'],
                        'scales': [[F0, DF], [0.0, 1e-3]],
                        'units': ['MHz', 's']},
            'name': 'frb_search', 'time_tag': 0}


def _run_frb(pkg, gulps, thr):
    src_cls, sink_cls, space = ((_FreqSource, _Gather, 'cuda')
                                if pkg is bt else
                                (_JaxFreqSource, _JaxGather, 'tpu'))
    kw = {} if pkg is bt else {'segments': 'off'}
    with pkg.Pipeline(**kw) as p:
        src = src_cls(gulps, _frb_header(), GULP)
        b = pkg.blocks.copy(src, space=space)
        b = pkg.blocks.fdmt_stage(b, max_delay=MD)
        b = pkg.blocks.matched_filter(b, NTAP)
        b = pkg.blocks.threshold(b, thr)
        sink = sink_cls(pkg.blocks.copy(b, space='system'))
        run_bounded(p)
    return np.concatenate(sink.gulps, axis=-1), sink.headers


@pytest.mark.parametrize('impl', [None, 'xla', 'rolls', 'pallas'])
def test_frb_search_chain_matches_oracle_and_jax(monkeypatch, impl):
    """Config 22's chain at its own geometry, 8 gulps, threshold at a
    false-alarm rate of 1e-3 on a noise-only realization: the port (each
    core forced, and the default) equals the JAX chain bit for bit, the
    float64 oracle chain within the gate, and the oracle's candidate
    count.  (The JAX run keeps its default core: its Pallas core runs only
    on the TPU.)"""
    noise, x = _frb_data()
    thr = float(np.quantile(_oracle_chain(noise), 1.0 - FAR))
    mf = _oracle_chain(x)
    want = np.where(mf >= thr, mf, 0.0)
    gulps = [x[:, i * GULP:(i + 1) * GULP].copy() for i in range(8)]
    jgot, jhdrs = _run_frb(bf, gulps, thr)
    if impl:
        monkeypatch.setenv('BF_FDMT_IMPL', impl)
    got, hdrs = _run_frb(bt, gulps, thr)
    assert hdrs[0]['_tensor'] == jhdrs[0]['_tensor']
    np.testing.assert_array_equal(got, jgot)
    n = got.shape[-1]
    assert n >= 8 * GULP - 2 * (MD + NTAP)
    assert _rel(got, want[:, :n]) <= RTOL
    ncand = int(np.count_nonzero(got))
    assert ncand == int(np.count_nonzero(jgot)) == \
        int(np.count_nonzero(want[:, :n]))
    # every injected pulse is a candidate at its trial, in the boxcar
    # windows that hold it
    for d_true, t0 in ((24, 100), (10, 260), (30, 390)):
        assert np.count_nonzero(got[d_true, t0 - NTAP + 1:t0 + 1])
