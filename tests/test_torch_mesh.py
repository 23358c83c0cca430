"""The corner turn and the mesh paths of the port's blocks (the K9 wrapper
and its plain version in ops.gpu_kernels, parallel.corner_turn, the mesh
plans of CorrelateBlock and the time-sharded FdmtBlock) against the JAX
package on its 8-device CPU mesh (tests/test_correlate.py:230-336,
tests/test_mesh_pipeline.py:98-330), on the same seeded numpy inputs.
The port's mesh is 8 CPU ranks (or a 2-D mesh of them), where K9's
wrapper runs its plain version; the CUDA kernel is held against that
version on the card (chip_smoke.py, tests/test_torch_cuda.py).

Tolerances: corner turns, ring hops and every correlator plan bit for
bit (ci8 voltages, and cf32 voltages of small integers, keep every sum
exact in any order); FDMT on a mesh within 1e-4 of the JAX block (the
FDMT gate, relative to the largest magnitude) and bit for bit against
the port's block without a mesh.
"""

import contextlib
from copy import deepcopy

import numpy as np
import pytest
import torch

import bifrost_tpu as bf
from bifrost_tpu import parallel as jpar

import bifrost_tpu_torch as bt
from bifrost_tpu_torch import device
from bifrost_tpu_torch import parallel as par
from bifrost_tpu_torch.blocks.correlate import CorrelateBlock
from bifrost_tpu_torch.ops import gpu_kernels, mprobe
from bifrost_tpu_torch.ops import linalg as L
from bifrost_tpu_torch.parallel import ops as pops
from tests.test_torch_bounded import run_bounded

from tests.util import NumpySourceBlock, GatherSink, simple_header


@pytest.fixture(autouse=True)
def _cpu(monkeypatch, tmp_path):
    device.set_device('cpu')
    monkeypatch.setenv('BF_CACHE_DIR', str(tmp_path / 'cache'))
    monkeypatch.setattr(mprobe, '_cache', {})
    monkeypatch.setattr(mprobe, '_flip_uses', {})
    monkeypatch.setattr(L, '_xcorr_chosen', {})
    for kind in pops.collectives:
        pops.collectives[kind] = 0
    for var in ('BF_XCORR_CORNER_TURN', 'BF_XCORR_IMPL', 'BF_LINALG_PROBE',
                'BF_LINALG_XCORR_IMPL', 'BF_FDMT_IMPL', 'BF_FDMT_PROBE'):
        monkeypatch.delenv(var, raising=False)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _decisive_races(monkeypatch):
    real = mprobe.select
    monkeypatch.setattr(mprobe, 'select',
                        lambda *a, **k: real(*a, **dict(k, noise=1.0)))


# ---------------------------------------------------------------------------
# K9's plain version and wrapper on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('D', [1, 2, 3, 8])
@pytest.mark.parametrize('dtype', [np.int8, np.complex64])
def test_ring_permute_moves_each_block_one_rank_right(D, dtype):
    rng = np.random.RandomState(D)
    blocks = [_t((rng.randint(-100, 100, (3, 5)) +
                  (1j * rng.randint(-9, 9, (3, 5))
                   if dtype == np.complex64 else 0)).astype(dtype))
              for _ in range(D)]
    before = gpu_kernels.launches['ring_permute']
    got = gpu_kernels.ring_permute(blocks)
    assert gpu_kernels.launches['ring_permute'] == before   # no launch
    for i in range(D):
        assert torch.equal(got[(i + 1) % D], blocks[i])
        assert got[(i + 1) % D].data_ptr() != blocks[i].data_ptr()
    plain = gpu_kernels.ring_permute_plain(blocks)
    assert all(torch.equal(a, b) for a, b in zip(got, plain))


def test_ring_permute_equals_a_jax_ppermute_ring_hop():
    """K9's plain version, one hop on 8 ranks, against lax.ppermute with
    the corner turn's ring permutation (corner_turn.py:37-41)."""
    from jax import lax
    import jax
    from bifrost_tpu.parallel.ops import _shard_map, _P
    x = np.random.RandomState(5).randint(-128, 128, (16, 4, 3)) \
        .astype(np.int8)
    mesh = jpar.create_mesh({'sp': 8})
    perm = [(i, (i + 1) % 8) for i in range(8)]
    want = np.asarray(jax.jit(_shard_map()(
        lambda b: lax.ppermute(b, 'sp', perm), mesh=mesh,
        in_specs=_P('sp'), out_specs=_P('sp')))(x))
    blocks = [_t(x[2 * i:2 * i + 2]) for i in range(8)]
    got = torch.cat(gpu_kernels.ring_permute(blocks)).numpy()
    np.testing.assert_array_equal(got, want)


def test_ring_permute_refuses_mixed_blocks():
    with pytest.raises(ValueError, match='shape or dtype'):
        gpu_kernels.ring_permute([torch.zeros(4), torch.zeros(5)])
    with pytest.raises(ValueError, match='shape or dtype'):
        gpu_kernels.ring_permute([torch.zeros(4),
                                  torch.zeros(4, dtype=torch.int8)])
    with pytest.raises(ValueError, match='no blocks'):
        gpu_kernels.ring_permute([])


# ---------------------------------------------------------------------------
# the corner turn (tests/test_correlate.py:230-267)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('impl', ['xla', 'ring', 'pallas'])
def test_corner_turn_matches_jax_and_the_transpose_oracle(impl):
    mesh = par.create_mesh({'sp': 8})
    T, F = 16, 32
    x = np.random.RandomState(7).randint(-64, 64, (T, F, 3, 2)) \
        .astype(np.int8)
    got = par.corner_turn(mesh, 'sp', impl=impl, stacked=True)(_t(x))
    assert got.shape == (8, T, F // 8, 3, 2)
    fc = F // 8
    for d in range(8):
        np.testing.assert_array_equal(got[d].numpy(),
                                      x[:, d * fc:(d + 1) * fc])
    jimpl = 'xla' if impl == 'pallas' else impl
    want = np.asarray(jpar.corner_turn(jpar.create_mesh({'sp': 8}), 'sp',
                                       impl=jimpl, stacked=True)(x))
    np.testing.assert_array_equal(got.numpy(), want)
    kinds = {'xla': ('all_to_all', 1), 'ring': ('ppermute', 7),
             'pallas': ('ring_permute', 7)}[impl]
    assert pops.collectives[kinds[0]] == kinds[1]
    assert sum(pops.collectives.values()) == kinds[1]


@pytest.mark.parametrize('impl', ['ring', 'pallas'])
def test_ring_forms_equal_xla_on_complex(impl):
    mesh = par.create_mesh({'sp': 8})
    rng = np.random.RandomState(8)
    x = (rng.randn(8, 16, 4) + 1j * rng.randn(8, 16, 4)).astype(np.complex64)
    a = par.corner_turn(mesh, 'sp', impl='xla', stacked=True)(_t(x))
    b = par.corner_turn(mesh, 'sp', impl=impl, stacked=True)(_t(x))
    assert torch.equal(a, b)
    # unstacked: globally an identity that moves only shards
    c = par.corner_turn(mesh, 'sp', impl=impl)(_t(x))
    assert torch.equal(c, _t(x))


def test_corner_turn_on_the_time_axis_of_a_2d_mesh():
    mesh = par.create_mesh({'sp': 4, 'tp': 2})
    x = np.random.RandomState(9).randint(-9, 9, (8, 8, 2)).astype(np.int8)
    got = par.corner_turn(mesh, 'sp', impl='pallas', stacked=True)(_t(x))
    for d in range(4):
        np.testing.assert_array_equal(got[d].numpy(), x[:, 2 * d:2 * d + 2])


def test_corner_turn_errors_equal_jax():
    with pytest.raises(ValueError, match='static device count'):
        par.corner_turn_local(None, [torch.zeros(4, 8)], 'sp', impl='ring',
                              ndev=np.int32(8))
    with pytest.raises(ValueError, match='not in'):
        par.corner_turn_local(None, [torch.zeros(4, 8)], 'sp', impl='fft')
    with pytest.raises(ValueError, match='static device count'):
        jpar.corner_turn_local(np.zeros((4, 8)), 'sp', impl='ring',
                               ndev=np.int32(8))
    with pytest.raises(ValueError, match='not in'):
        jpar.corner_turn_local(np.zeros((4, 8)), 'sp', impl='fft')
    mesh = par.create_mesh({'sp': 8})
    with pytest.raises(ValueError, match='ndev=4'):
        par.corner_turn_local(mesh, [torch.zeros(4, 8)] * 8, 'sp',
                              impl='pallas', ndev=4)


# ---------------------------------------------------------------------------
# the mesh correlator through both pipelines
# ---------------------------------------------------------------------------

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
        self.gulps = []

    def on_sequence(self, iseq):
        pass

    def on_data(self, ispan):
        self.gulps.append(np.array(ispan.data.as_numpy(), copy=True))


def _ci8_gulps(shape, n, seed, lo=-64):
    rng = np.random.RandomState(seed)
    gulps = []
    for _ in range(n):
        raw = np.zeros(shape, dtype=bf.dtype.ci8)
        raw['re'] = rng.randint(lo, -lo, raw.shape)
        raw['im'] = rng.randint(lo, -lo, raw.shape)
        gulps.append(raw)
    return gulps


def _cf32_gulps(shape, sizes, seed):
    """Complex voltages of small integers: every float sum is exact."""
    rng = np.random.RandomState(seed)
    return [(rng.randint(-8, 8, (n,) + shape) +
             1j * rng.randint(-8, 8, (n,) + shape)).astype(np.complex64)
            for n in sizes]


def _hdr(shape, dtype, gulp):
    return simple_header([-1] + list(shape), dtype,
                         labels=['time', 'freq', 'station', 'pol'],
                         gulp_nframe=gulp)


def _run(pkg, mesh, gulps, hdr, nint, accuracy='int8', blocks=None):
    """One correlate(nint) chain through ``pkg``'s pipeline under
    ``block_scope(mesh=mesh)``."""
    gulp = hdr['gulp_nframe']
    if pkg is bt:
        src_cls, space, sink_cls = _Source, 'cuda', _Gather
    else:
        src_cls, space, sink_cls = NumpySourceBlock, 'tpu', GatherSink
    with pkg.Pipeline() as p:
        src = src_cls(gulps, hdr, gulp_nframe=gulp)
        b = pkg.blocks.copy(src, space=space)
        with pkg.block_scope(mesh=mesh):
            b = pkg.blocks.correlate(b, nframe_per_integration=nint,
                                     accuracy=accuracy)
        if blocks is not None:
            blocks.append(b)
        sink = sink_cls(pkg.blocks.copy(b, space='system'))
        run_bounded(p)
    if pkg is bt:
        return np.concatenate(sink.gulps)
    return sink.result()


_PLANS = {'psum': ('off', {'sp': 8}), 'corner:xla': ('xla', {'sp': 8}),
          'corner:pallas': ('pallas', {'sp': 8}),
          '2d': ('auto', {'sp': 4, 'tp': 2})}


@pytest.mark.parametrize('dtype', ['ci8', 'cf32'])
@pytest.mark.parametrize('plan', sorted(_PLANS))
def test_mesh_correlator_plans_equal_jax_bit_for_bit(monkeypatch, plan,
                                                     dtype):
    """_mesh_correlate (tests/test_correlate.py:299-336) and the 2-D
    station-sharded run (tests/test_mesh_pipeline.py:222-239) through
    both packages: every plan byte-equal to the JAX block on its mesh and
    to the port's single-device run."""
    mode, axes = _PLANS[plan]
    monkeypatch.setenv('BF_XCORR_CORNER_TURN', mode)
    shape = (8, 4, 2)
    if dtype == 'ci8':
        gulps = _ci8_gulps((16,) + shape, 2, seed=11)
    else:
        gulps = _cf32_gulps(shape, (16, 16), seed=11)
    hdr = _hdr(shape, dtype, 16)
    acc = 'int8' if dtype == 'ci8' else 'f32'
    blocks = []
    got = _run(bt, par.create_mesh(axes), gulps, hdr, 16, acc, blocks)
    assert blocks[0]._mesh_plan == ('psum' if plan == '2d' else plan)
    # the Pallas remote DMA needs a TPU: the JAX block's corner:xla plan
    # (byte-equal to its ring form, tests/test_correlate.py:252-262)
    # stands for corner:pallas
    monkeypatch.setenv('BF_XCORR_CORNER_TURN',
                       'xla' if mode == 'pallas' else mode)
    want = _run(bf, jpar.create_mesh(axes), gulps, hdr, 16, acc)
    single = _run(bt, None, gulps, hdr, 16, acc)
    assert got.shape == (2, 8, 4, 2, 4, 2) and got.dtype == np.complex64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, single)


@pytest.mark.parametrize('dtype', ['ci8', 'cf32'])
def test_mesh_correlator_partial_gulp_falls_back(dtype):
    """A partial gulp mid-integration (4 frames on 8 ranks) runs the
    single-device product while the rest ran on the mesh
    (tests/test_mesh_pipeline.py:145-159)."""
    shape = (2, 3, 2)
    if dtype == 'ci8':
        full = _ci8_gulps((16,) + shape, 1, seed=12)[0]
        gulps = [full[:8], full[8:12], full[12:]]
    else:
        gulps = _cf32_gulps(shape, (8, 4, 4), seed=12)
    hdr = _hdr(shape, dtype, 8)
    acc = 'int8' if dtype == 'ci8' else 'f32'
    blocks = []
    got = _run(bt, par.create_mesh({'sp': 8}), gulps, hdr, 16, acc, blocks)
    want = _run(bf, jpar.create_mesh({'sp': 8}), gulps, hdr, 16, acc)
    single = _run(bt, None, gulps, hdr, 16, acc)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, single)
    # the ring hands the reader whole gulps until the sequence ends, so
    # the partial gulp's build is driven here directly: 4 frames do not
    # divide 8 ranks, and the single-device product runs
    blk = blocks[0]
    x4 = bt.ops.common.as_tensor(gulps[1])
    reim = dtype == 'ci8'
    fn = blk._build(tuple(x4.shape), x4.dtype, reim)
    for kind in pops.collectives:
        pops.collectives[kind] = 0
    vis = fn(x4)
    assert not any(pops.collectives.values())
    assert torch.equal(vis, blk._local_vis_fn(reim)(x4))


@pytest.mark.parametrize('plan,expect', [
    ('off', {'psum': 1}),
    ('xla', {'all_to_all': 1, 'all_gather': 1}),
    ('pallas', {'ring_permute': 7, 'all_gather': 1}),
    ('2d', {'all_gather': 1, 'psum': 1})])
def test_collective_counters_count_what_each_plan_moves(monkeypatch, plan,
                                                        expect):
    axes = {'sp': 4, 'tp': 2} if plan == '2d' else {'sp': 8}
    if plan != '2d':
        monkeypatch.setenv('BF_XCORR_CORNER_TURN', plan)
    gulps = _ci8_gulps((16, 8, 4, 2), 1, seed=13)
    _run(bt, par.create_mesh(axes), gulps, _hdr((8, 4, 2), 'ci8', 16), 16)
    assert {k: v for k, v in pops.collectives.items() if v} == expect


def test_station_sharded_plan_runs_the_cross_family(monkeypatch):
    """On the 2-D mesh each rank's station-row block goes through
    xcorr_int8's cross family: K8's plain version when forced."""
    monkeypatch.setenv('BF_LINALG_XCORR_IMPL', 'pallas')
    calls = []
    real = gpu_kernels.xcorr_cross

    def spy(*a):
        calls.append(tuple(a[0].shape) + tuple(a[2].shape[-1:]))
        return real(*a)
    monkeypatch.setattr(gpu_kernels, 'xcorr_cross', spy)
    gulps = _ci8_gulps((16, 8, 4, 2), 1, seed=14)
    hdr = _hdr((8, 4, 2), 'ci8', 16)
    got = _run(bt, par.create_mesh({'sp': 4, 'tp': 2}), gulps, hdr, 16)
    assert calls == [(4, 8, 4, 8)] * 8
    np.testing.assert_array_equal(got, _run(bt, None, gulps, hdr, 16))


def test_forced_k9_plan_that_fails_raises(monkeypatch):
    """A corner:pallas plan whose kernel raises propagates the error: it
    never falls back to the psum plan."""
    monkeypatch.setenv('BF_XCORR_CORNER_TURN', 'pallas')

    def broken(blocks):
        raise RuntimeError('K9 launch failed')
    monkeypatch.setattr(gpu_kernels, 'ring_permute', broken)
    gulps = _ci8_gulps((16, 8, 4, 2), 1, seed=15)
    with pytest.raises(bt.PipelineRuntimeError, match='K9 launch failed'):
        _run(bt, par.create_mesh({'sp': 8}), gulps,
             _hdr((8, 4, 2), 'ci8', 16), 16)


def test_admitted_k9_plan_that_fails_in_the_race_raises(monkeypatch):
    monkeypatch.setenv('BF_LINALG_PROBE', '1')
    monkeypatch.setattr(gpu_kernels, 'available', lambda device=None: True)

    def broken(blocks):
        raise RuntimeError('K9 launch failed')
    monkeypatch.setattr(gpu_kernels, 'ring_permute', broken)
    gulps = _ci8_gulps((16, 8, 4, 2), 1, seed=15)
    with pytest.raises(bt.PipelineInitError, match='K9 launch failed'):
        _run(bt, par.create_mesh({'sp': 8}), gulps,
             _hdr((8, 4, 2), 'ci8', 16), 16)


@pytest.mark.parametrize('probe_passes', [False, True])
def test_plan_race_admits_k9_only_where_the_probe_passes(monkeypatch,
                                                         probe_passes):
    """With probing on and no forced plan the plans race at on_sequence
    (family corner_turn); corner:pallas races only where K0 passes."""
    monkeypatch.setenv('BF_LINALG_PROBE', '1')
    _decisive_races(monkeypatch)
    if probe_passes:
        monkeypatch.setattr(gpu_kernels, 'available',
                            lambda device=None: True)
    gulps = _ci8_gulps((16, 8, 4, 2), 2, seed=16)
    hdr = _hdr((8, 4, 2), 'ci8', 16)
    blocks = []
    got = _run(bt, par.create_mesh({'sp': 8}), gulps, hdr, 16,
               blocks=blocks)
    blk = blocks[0]
    want = ['corner:pallas', 'corner:xla', 'psum'] if probe_passes else \
        ['corner:xla', 'psum']
    assert sorted(blk.mesh_probe_ms) == want
    assert blk._mesh_plan == min(blk.mesh_probe_ms,
                                 key=blk.mesh_probe_ms.get)
    np.testing.assert_array_equal(got, _run(bt, None, gulps, hdr, 16))
    # a second block serves the winner from the disk cache, no race
    monkeypatch.setattr(mprobe, '_cache', {})
    monkeypatch.setattr(CorrelateBlock, '_build_mesh',
                        lambda *a, **k: 1 / 0)
    with bt.Pipeline():
        src = _Source([], hdr, 16)
        b = bt.blocks.copy(src, space='cuda')
        with bt.block_scope(mesh=par.create_mesh({'sp': 8})):
            again = bt.blocks.correlate(b, 16, accuracy='int8')
    shape = (16, 8, 4, 2, 2)
    assert again._select_mesh_plan(shape, 'int8', True) == blk._mesh_plan


def test_plan_stays_psum_without_probing_or_where_ineligible(monkeypatch):
    with bt.Pipeline():
        src = _Source([], _hdr((8, 4, 2), 'ci8', 16), 16)
        b = bt.blocks.copy(src, space='cuda')
        with bt.block_scope(mesh=par.create_mesh({'sp': 8})):
            corr = bt.blocks.correlate(b, 16)
        with bt.block_scope(mesh=par.create_mesh({'sp': 4, 'tp': 2})):
            corr2 = bt.blocks.correlate(b, 16)
    ci8 = (16, 8, 4, 2, 2)
    assert corr._select_mesh_plan(ci8, 'int8', True) == 'psum'
    monkeypatch.setenv('BF_XCORR_CORNER_TURN', 'xla')
    assert corr._select_mesh_plan(ci8, 'int8', True) == 'corner:xla'
    # channels that do not divide the mesh, a partial gulp, a 2-D mesh
    assert corr._select_mesh_plan((16, 12, 4, 2, 2), 'int8', True) == 'psum'
    assert corr._select_mesh_plan((12, 8, 4, 2, 2), 'int8', True) == 'psum'
    assert corr2._select_mesh_plan(ci8, 'int8', True) == 'psum'
    with pytest.raises(ValueError, match='ineligible'):
        corr2._build_mesh(ci8, 'int8', True, 'corner:xla')


def test_correlate_block_flags_collective_boundary():
    with bt.Pipeline():
        src = _Source([], _hdr((8, 3, 2), 'ci8', 16), 16)
        b = bt.blocks.copy(src, space='cuda')
        with bt.block_scope(mesh=par.create_mesh({'sp': 8})):
            corr = bt.blocks.correlate(b, 16)
            with bt.block_scope(gulp_nframe=16):
                inner = bt.blocks.correlate(b, 16)
        plain = bt.blocks.correlate(b, 16)
    assert isinstance(corr, CorrelateBlock)
    assert corr._collective_boundary and inner._collective_boundary
    assert inner.mesh is corr.mesh
    assert not plain._collective_boundary and plain.mesh is None


# ---------------------------------------------------------------------------
# FdmtBlock on a mesh (tests/test_mesh_pipeline.py:242-330)
# ---------------------------------------------------------------------------

class _FreqSource(bt.SourceBlock):
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
        ospans[0].data.as_numpy()[:, :g.shape[1]] = g
        return [g.shape[-1]]


def _fdmt_hdr(nchan):
    return {'name': 'fdmt-mesh', 'time_tag': 0,
            '_tensor': {'shape': [nchan, -1], 'dtype': 'f32',
                        'labels': ['freq', 'time'],
                        'scales': [[100.0, 1.0], [0.0, 1e-3]],
                        'units': ['MHz', 's']}}


def _run_port_fdmt(mesh, x, gulp, md, **kw):
    nchan, T = x.shape
    gulps = [x[:, i:i + gulp].copy() for i in range(0, T, gulp)]
    with bt.Pipeline() as p:
        src = _FreqSource(gulps, _fdmt_hdr(nchan), gulp)
        b = bt.blocks.copy(src, space='cuda')
        with bt.block_scope(mesh=mesh):
            blk = bt.blocks.fdmt(b, max_delay=md, **kw)
        sink = _Gather(bt.blocks.copy(blk, space='system'))
        run_bounded(p)
    return np.concatenate(sink.gulps, axis=-1), blk


def _run_jax_fdmt(mesh, x, gulp, md):
    from tests.test_mesh_pipeline import _run_fdmt_block
    return _run_fdmt_block(mesh, x, gulp, md)


@pytest.mark.parametrize('core', ['xla', 'pallas'])
def test_fdmt_block_on_mesh_matches_jax_and_single_device(monkeypatch, core):
    """Each span sharded over 8 ranks with its max_delay halo: the mesh
    path engages, equals the port's block without a mesh bit for bit and
    the JAX block on its mesh within 1e-4."""
    monkeypatch.setenv('BF_FDMT_IMPL', core)
    x = np.random.RandomState(30).rand(16, 120).astype(np.float32)
    meshed, blk = _run_port_fdmt(par.create_mesh({'sp': 8}), x, 56, 8)
    assert any(fn is not None for fn in blk._mesh_fns.values()), \
        blk._mesh_fns
    assert pops.collectives['ppermute'] >= 2
    base, _ = _run_port_fdmt(None, x, 56, 8)
    np.testing.assert_array_equal(meshed, base)
    # the JAX block on its default core: its Pallas core takes no
    # shard_map on the CPU
    monkeypatch.delenv('BF_FDMT_IMPL')
    jmeshed, _ = _run_jax_fdmt(jpar.create_mesh({'sp': 8}), x, 56, 8)
    assert meshed.shape == jmeshed.shape and meshed.size
    err = np.max(np.abs(meshed - jmeshed)) / np.max(np.abs(jmeshed))
    assert err <= 1e-4, err


def test_fdmt_block_on_mesh_negative_delays():
    x = np.random.RandomState(32).rand(16, 120).astype(np.float32)
    meshed, blk = _run_port_fdmt(par.create_mesh({'sp': 8}), x, 56, 8,
                                 negative_delays=True)
    assert any(fn is not None for fn in blk._mesh_fns.values())
    base, _ = _run_port_fdmt(None, x, 56, 8, negative_delays=True)
    np.testing.assert_array_equal(meshed, base)


def test_fdmt_block_mesh_indivisible_falls_back():
    """A span whose time extent does not divide the mesh (or is narrower
    than max_delay per shard) runs the single-device core."""
    x = np.random.RandomState(31).rand(16, 60).astype(np.float32)
    meshed, blk = _run_port_fdmt(par.create_mesh({'sp': 8}), x, 20, 9)
    assert all(fn is None for fn in blk._mesh_fns.values())
    base, _ = _run_port_fdmt(None, x, 20, 9)
    np.testing.assert_array_equal(meshed, base)
    jmeshed, jblk = _run_jax_fdmt(jpar.create_mesh({'sp': 8}), x, 20, 9)
    assert all(fn is None for fn in jblk._mesh_fns.values())
    assert meshed.shape == jmeshed.shape and meshed.size
    err = np.max(np.abs(meshed - jmeshed)) / np.max(np.abs(jmeshed))
    assert err <= 1e-4, err


def test_fdmt_block_mesh_warmup_runs_the_mesh_path(monkeypatch):
    """on_sequence warms the mesh path, whose core is picked at the
    per-shard window width; its errors propagate."""
    x = np.random.RandomState(33).rand(16, 112).astype(np.float32)
    seen = []
    real = bt.ops.fdmt.Fdmt._pick_core

    def spy(self, neg, shape=None, device=None):
        seen.append(shape)
        return real(self, neg, shape=shape, device=device)
    monkeypatch.setattr(bt.ops.fdmt.Fdmt, '_pick_core', spy)
    _run_port_fdmt(par.create_mesh({'sp': 8}), x, 56, 8)
    assert seen[0] == (16, 64 // 8 + 8)
    monkeypatch.setattr(bt.ops.fdmt.Fdmt, '_pick_core',
                        lambda *a, **k: 1 / 0)
    with pytest.raises(bt.PipelineInitError, match='division'):
        _run_port_fdmt(par.create_mesh({'sp': 8}), x, 56, 8)
