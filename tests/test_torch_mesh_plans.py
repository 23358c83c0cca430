"""The mesh tier's remainder in the port: frame-local mesh plans of
``FusedBlock`` and the stage blocks, ring-resident per-rank spans
(``parallel.scope.ShardedTensor``), the sharded H2D, macro-gulp spans and
donation under a mesh, mesh segments, ``BeamformBlock``'s per-shard
prewarm, and ``parallel/fft.py``, against the JAX package and the
single-rank runs.

- The JAX package's mesh-pipeline tests (``tests/test_mesh_pipeline.py``)
  that drive blocks run against the port (:func:`rehome`: the port's
  pipeline, blocks, stages, mesh and counters, 'tpu' rings as 'cuda'
  rings); those written against ``jax.Array`` (a sharded span's
  round trip, the sharded H2D, the compiled plan's HLO) have port
  counterparts of the same name, with the HLO collective count replaced
  by the port's collective-call count.
- ``tests/test_parallel_fft.py`` runs against the port's ``parallel.fft``.
- Every mesh plan's output equals the single-rank run bit for bit (the
  frame-local plan runs the same per-frame math on each rank's frames);
  the distributed FFTs are held to ``torch.fft`` at 1e-4 relative.

Every mesh here is D ranks on the CPU device (``create_mesh`` after
``set_device('cpu')``).
"""

import inspect
import types

import numpy as np
import pytest
import torch

import bifrost_tpu_torch as bt
from bifrost_tpu_torch import device, parallel, xfer
from bifrost_tpu_torch import stages as tstages
from bifrost_tpu_torch.parallel import create_mesh
from bifrost_tpu_torch.parallel.scope import ShardedTensor, time_sharding
from bifrost_tpu_torch.ring import Ring
from bifrost_tpu_torch.telemetry import counters

from tests import test_mesh_pipeline as JM
from tests import test_parallel_fft as JF
from tests.test_torch_bounded import run_bounded
from tests.test_torch_supervision import TorchGatherSink, TorchNumpySourceBlock
from tests.test_torch_wire_formats import rehome
from tests.util import simple_header


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    device.set_device('cpu')
    monkeypatch.delenv('BF_MESH_H2D', raising=False)
    counters.reset()
    yield
    counters.reset()


def _space(space):
    return 'cuda' if space == 'tpu' else space


def _copy(iring, space=None, *args, **kwargs):
    kwargs.pop('device', None)       # one CPU device: a pin is a no-op
    return bt.blocks.copy(iring, _space(space), *args, **kwargs)


class _BoundedPipeline(bt.Pipeline):
    """A pipeline whose ``run`` is bounded (:func:`run_bounded`)."""

    def run(self):
        outer = self

        class _Once(object):
            name = outer.name

            def run(self):
                return bt.Pipeline.run(outer)

            def shutdown(self):
                return outer.shutdown()
        return run_bounded(_Once())


#: ``bifrost_tpu`` as the JAX mesh tests use it, on the port
PORT_BF = types.SimpleNamespace(
    Pipeline=_BoundedPipeline, block_scope=bt.block_scope,
    blocks=types.SimpleNamespace(copy=_copy, fused=bt.blocks.fused,
                                 fft=bt.blocks.fft,
                                 detect=bt.blocks.detect))

MESH_MAP = {'bifrost_tpu.stages': tstages,
            'bifrost_tpu.telemetry.counters': counters}

#: the JAX tests written against the block API
JM_TESTS = ['test_fused_chain_on_mesh_matches_single_device',
            'test_fused_chain_on_2d_mesh',
            'test_fused_chain_mesh_indivisible_falls_back',
            'test_mesh_chain_zero_reshards',
            'test_mesh_macro_gulp_k_gt_1',
            'test_mesh_donation_under_sharding',
            'test_mesh_stage_block_sharded_plan_parity',
            'test_mesh_macro_committed_single_device_input']


def _rehome_mesh(fn):
    return rehome(fn, MESH_MAP, bf=PORT_BF, create_mesh=create_mesh,
                  counters=counters, NumpySourceBlock=TorchNumpySourceBlock,
                  GatherSink=TorchGatherSink,
                  FftStage=tstages.FftStage, DetectStage=tstages.DetectStage,
                  ReduceStage=tstages.ReduceStage)


@pytest.mark.parametrize('name', JM_TESTS)
def test_jax_mesh_pipeline_test_on_the_port(name, monkeypatch):
    fn = getattr(JM, name)
    fixtures = {'monkeypatch': monkeypatch}
    args = [fixtures[a] for a in inspect.signature(fn).parameters]
    _rehome_mesh(fn)(*args)


def _cases(fn):
    """The keyword sets of a JAX test's own ``parametrize`` marks."""
    cases = [{}]
    for m in getattr(fn, 'pytestmark', []):
        if m.name != 'parametrize':
            continue
        names = [n.strip() for n in m.args[0].split(',')]
        cases = [dict(c, **dict(zip(names, v if len(names) > 1 else (v,))))
                 for c in cases for v in m.args[1]]
    return cases


JF_CASES = [(n, c) for n in sorted(x for x in dir(JF)
                                   if x.startswith('test_'))
            for c in _cases(getattr(JF, n))]


@pytest.mark.parametrize('name,kwargs', JF_CASES,
                         ids=['%s%s' % (n, sorted(c.items()) or '')
                              for n, c in JF_CASES])
def test_jax_parallel_fft_test_on_the_port(name, kwargs):
    rehome(getattr(JF, name), {'bifrost_tpu.parallel.mesh': parallel.mesh,
                               'bifrost_tpu.parallel.fft': parallel.fft},
           jax=_PORT_JAX, jnp=_PORT_JNP)(**kwargs)


# ---------------------------------------------------------------------------
# port counterparts of the jax.Array tests
# ---------------------------------------------------------------------------

def test_sharded_ring_span_roundtrip():
    """A per-rank value committed into a 'cuda' ring span comes back per
    rank (``sharded_data``) with its layout, gathers for a plain reader,
    and the commit is counted on the sharded-gulp and per-shard-bytes
    counters (``tests/test_mesh_pipeline.py:366``)."""
    mesh = create_mesh({'sp': 8})
    ring = Ring(space='cuda', name='shard_rt')
    hdr = simple_header([-1, 4], 'f32', gulp_nframe=16)
    data = np.arange(64, dtype=np.float32).reshape(16, 4)
    arr = ShardedTensor(parallel.shard(torch.from_numpy(data), mesh,
                                       parallel.PartitionSpec('sp')), mesh, 0)
    with ring.begin_writing() as w:
        with w.begin_sequence(hdr, 16, 48) as seq:
            with ring.open_earliest_sequence(guarantee=True) as rseq:
                with seq.reserve(16) as ospan:
                    ospan.set(arr, owned=True)
                    ospan.commit(16)
                with rseq.acquire(0, 16) as ispan:
                    got = ispan.sharded_data()
                    assert got is arr
                    assert got.sharding == time_sharding(mesh, 2, 0)
                    np.testing.assert_array_equal(ispan.data.numpy(), data)
    snap = counters.snapshot()
    assert snap.get('ring.shard_rt.sharded_gulps') == 1
    assert snap.get('ring.shard_rt.shard_bytes') == data.nbytes // 8
    assert snap.get('mesh.sharded_commits') == 1
    assert snap.get('mesh.gathers') == 1


def test_sharded_h2d_placement():
    """``xfer.to_device(sharding=...)`` stages each rank's frames in its
    own slot: the bytes land per rank, and complex rides as two planes
    recombined per rank (``tests/test_mesh_pipeline.py:396``)."""
    mesh = create_mesh({'sp': 8})
    sharding = time_sharding(mesh, 3, 0)
    host = np.random.RandomState(0).randn(32, 3, 5).astype(np.float32)
    arr = xfer.to_device(host, sharding=sharding)
    assert isinstance(arr, ShardedTensor) and arr.sharding == sharding
    for r, t in enumerate(arr.shards):
        np.testing.assert_array_equal(t.numpy(), host[4 * r:4 * r + 4])
    np.testing.assert_array_equal(arr.gather().numpy(), host)
    snap = counters.snapshot()
    assert snap.get('xfer.h2d_sharded') == 1
    assert snap.get('xfer.h2d_shard_bytes') == host.nbytes // 8
    chost = (host + 1j * host).astype(np.complex64)
    carr = xfer.to_device(chost, sharding=sharding)
    assert len(carr.shards) == 8
    np.testing.assert_array_equal(carr.gather().numpy(), chost)
    assert counters.snapshot().get('xfer.h2d_sharded') == 3


def test_sharded_h2d_env_fallback(monkeypatch):
    """``BF_MESH_H2D=0`` still lands the gulp per rank (shipped whole and
    cut on the device), counted apart (``tests/test_mesh_pipeline.py:
    419``)."""
    monkeypatch.setenv('BF_MESH_H2D', '0')
    mesh = create_mesh({'sp': 8})
    sharding = time_sharding(mesh, 2, 0)
    host = np.random.RandomState(1).randn(16, 4).astype(np.float32)
    arr = xfer.to_device(host, sharding=sharding)
    assert arr.sharding == sharding
    np.testing.assert_array_equal(arr.gather().numpy(), host)
    assert counters.snapshot().get('xfer.h2d_sharded_fallback') == 1


def test_mesh_fused_plan_hlo_direct():
    """The frame-local plan of the FFT -> detect -> reduce chain makes no
    collective call (``tests/test_mesh_pipeline.py:460``, where the JAX
    test reads the compiled HLO), and its output equals the chain run
    whole, bit for bit."""
    mesh = create_mesh({'sp': 8})
    hdr = simple_header([-1, 2, 32], 'cf32',
                        labels=['time', 'pol', 'fine_time'])
    stages = [tstages.FftStage('fine_time', axis_labels='freq'),
              tstages.DetectStage('stokes', axis='pol'),
              tstages.ReduceStage('freq', factor=4)]
    headers = tstages.walk_headers(stages, hdr)
    shape = (16, 2, 32)

    def build_local(local_shape):
        fn, _info = tstages.compose_stages(stages, headers, local_shape,
                                           torch.complex64)
        return fn

    plan, in_sh, out_sh = parallel.frame_local_plan(
        mesh, build_local, shape, torch.complex64, 0, 0)
    assert in_sh == time_sharding(mesh, 3, 0)
    rng = np.random.RandomState(2)
    x = torch.from_numpy((rng.randn(*shape) + 1j * rng.randn(*shape))
                         .astype(np.complex64))
    since = parallel.collective_counts()
    out = plan(x)
    assert parallel.collective_counts(since) == {}
    whole = build_local(shape)(x)
    assert torch.equal(out.gather(), whole)


def test_frame_local_plan_declines_an_indivisible_gulp():
    mesh = create_mesh({'sp': 8})
    assert parallel.frame_local_plan(mesh, lambda s: None, (12, 4),
                                     torch.float32, 0, 0) is None


# ---------------------------------------------------------------------------
# parallel/fft.py
# ---------------------------------------------------------------------------

#: the JAX FFT tests' ``jax`` and ``jnp``, on torch: ``jit`` is the
#: function itself, arrays are tensors, and the 8-rank CPU mesh is there
_PORT_JAX = types.SimpleNamespace(jit=lambda f: f,
                                  devices=lambda: ['cpu'] * 8)
_PORT_JNP = types.SimpleNamespace(
    asarray=torch.as_tensor, complex64=torch.complex64,
    zeros=lambda shape, dtype: torch.zeros(shape, dtype=dtype))


@pytest.mark.parametrize('d', [2, 4, 8])
@pytest.mark.parametrize('order', ['natural', 'transposed'])
def test_sharded_fft_equals_torch_fft(d, order):
    mesh = create_mesh({'sp': d}, devices=['cpu'] * d)
    n, n1 = 4096, 64
    rng = np.random.RandomState(d)
    x = torch.from_numpy((rng.randn(3, n) + 1j * rng.randn(3, n))
                         .astype(np.complex64))
    since = parallel.collective_counts()
    y = parallel.sharded_fft(mesh, n, output_order=order, n1=n1,
                             nbatch=1)(x)
    ref = torch.fft.fft(x.to(torch.complex128), dim=-1)
    if order == 'transposed':
        # X[N1*s + r] with r sharded: rank k holds r in its block
        n2 = n // n1
        ref = ref.reshape(3, n2, n1).transpose(-1, -2).reshape(3, n)
    err = (y.to(torch.complex128) - ref).abs().max() / ref.abs().max()
    assert err < 1e-4
    assert parallel.collective_counts(since) == {
        'all_to_all': 3 if order == 'natural' else 2}


@pytest.mark.parametrize('inverse', [False, True])
def test_freq_sharded_dft_has_no_collective(inverse):
    mesh = create_mesh({'sp': 4}, devices=['cpu'] * 4)
    n = 8192
    rng = np.random.RandomState(9)
    x = torch.from_numpy((rng.randn(2, n) + 1j * rng.randn(2, n))
                         .astype(np.complex64))
    since = parallel.collective_counts()
    y = parallel.freq_sharded_dft(mesh, n, inverse=inverse, nbatch=1)(x)
    ref = (torch.fft.ifft(x.to(torch.complex128), norm='forward')
           if inverse else torch.fft.fft(x.to(torch.complex128)))
    err = (y.to(torch.complex128) - ref).abs().max() / ref.abs().max()
    assert err < 1e-4
    assert parallel.collective_counts(since) == {}


def test_parallel_exports_equal_the_jax_package():
    import bifrost_tpu.parallel as jpar
    jnames = {n for n in dir(jpar) if not n.startswith('_') and
              not isinstance(getattr(jpar, n), types.ModuleType)}
    missing = sorted(n for n in jnames if not hasattr(parallel, n))
    assert missing == [], missing


# ---------------------------------------------------------------------------
# the Guppi K1 chain, segments and the beamformer under a mesh
# ---------------------------------------------------------------------------

def _mesh4():
    return create_mesh({'sp': 4}, devices=['cpu'] * 4)


@pytest.mark.parametrize('k', [1, 4])
def test_guppi_k1_chain_frame_local_equals_single_rank(k):
    """The spectrometer chain (FFT -> Stokes -> reduce on ci8, K1's
    substitution) under a 4-rank mesh: a frame-local plan per gulp (and
    per K-gulp span), K1 substituted at the shard's shape, no collective,
    every span committed per rank, and the output bit for bit the
    single-rank run's."""
    from tests.test_torch_macro import run_spec
    base, _fb, _c = run_spec(1, 8)
    since = parallel.collective_counts()
    out, fb, snap = run_spec(k, 8, mesh=_mesh4())
    assert np.array_equal(out, base)
    assert parallel.collective_counts(since) == {}
    assert fb.impl_info['impl'] == 'cuda-spectrometer'
    assert (fb.impl_info['mesh'], fb.impl_info['shards']) == \
        ('shard_map[4]', 4)
    assert snap.get('mesh.whole_gulp_plans', 0) == 0
    # every mesh plan's first run recorded its collectives: none
    assert fb.impl_info['collectives'] == {}
    assert snap.get('mesh.plans_analyzed', 0) >= 1
    assert snap.get('mesh.plans_analyzed') == \
        snap.get('mesh.plans_collective_free')
    # the H2D copy and the fused block commit per rank (8 / K spans each)
    assert snap.get('mesh.sharded_commits') == 2 * 8 // k
    assert snap.get('xfer.h2d_sharded') == 8 // k
    # only the prewarm's zeros were laid out on the device
    assert snap.get('mesh.reshards') == fb.prewarm_runs


def _pinned_chain(mesh, k):
    """source -> copy('cuda_host') -> [mesh] copy('cuda') -> fused
    spectrometer -> copy('system'): the sharded H2D from a pinned
    ring."""
    from tests.test_torch_macro import (Gather, Source, spec_header,
                                        voltages, RF)
    counters.reset()
    with bt.Pipeline(gulp_batch=k) as p:
        b = bt.blocks.copy(Source(voltages(8), spec_header()),
                           space='cuda_host')
        with bt.block_scope(mesh=mesh):
            b = bt.blocks.copy(b, space='cuda')
            fb = bt.blocks.fused(b, [
                tstages.FftStage('fine_time', axis_labels='freq'),
                tstages.DetectStage('stokes', axis='pol'),
                tstages.ReduceStage('freq', RF)])
        sink = Gather(bt.blocks.copy(fb, space='system'))
        run_bounded(p)
    return sink.result(), counters.snapshot()


@pytest.mark.parametrize('h2d', ['1', '0'])
def test_sharded_h2d_from_a_cuda_host_ring(h2d, monkeypatch):
    monkeypatch.setenv('BF_MESH_H2D', h2d)
    base, _s = _pinned_chain(None, 1)
    out, snap = _pinned_chain(_mesh4(), 1)
    assert np.array_equal(out, base)
    if h2d == '1':
        assert snap.get('xfer.h2d_sharded') == 8
        assert snap.get('xfer.h2d_sharded_fallback', 0) == 0
    else:
        assert snap.get('xfer.h2d_sharded_fallback') == 8
    assert snap.get('mesh.layout_mismatch', 0) == 0


def test_mesh_segment_elides_its_interior_ring():
    """Two stage blocks under one mesh fuse into a segment (their meshes
    are equivalent), the interior ring is elided, the segment runs one
    frame-local plan, and the output equals the unsegmented run's."""
    from tests.test_torch_macro import (Gather, Source, spec_header,
                                        voltages)

    def run(mesh, segments):
        counters.reset()
        with bt.Pipeline(segments=segments) as p:
            b = bt.blocks.copy(Source(voltages(4), spec_header()),
                               space='cuda')
            with bt.block_scope(mesh=mesh):
                b = bt.blocks.fft(b, 'fine_time', axis_labels='freq')
                b = bt.blocks.detect(b, 'stokes', axis='pol')
            sink = Gather(bt.blocks.copy(b, space='system'))
            run_bounded(p)
        return sink.result(), counters.snapshot(), p

    base, _s, _p = run(None, 'off')
    out, snap, p = run(_mesh4(), 'force')
    assert np.array_equal(out, base)
    assert snap.get('segment.elided_rings') == 1
    seg = [b for b in p.blocks if hasattr(b, '_members')]
    assert len(seg) == 1 and seg[0].impl_info['mesh'] == 'shard_map[4]'
    assert seg[0]._resolve_splits() == 0


def test_mesh_boundaries_equal_the_jax_planner():
    """Segment reasons and verifier codes at mesh boundaries in both
    packages: equivalent meshes fuse, a mesh next to no mesh or to an
    inequivalent mesh breaks with 'mesh_reshard' (BF-I190), as the JAX
    planner says."""
    import bifrost_tpu as bf
    from bifrost_tpu.parallel import create_mesh as jcreate_mesh
    from bifrost_tpu import segments as jsegments
    from bifrost_tpu_torch import segments as tsegments
    import bifrost_tpu.stages as jstages

    def topo(pkg, stg, mk, ma, mb):
        hdr = simple_header([-1, 2, 32], 'cf32',
                            labels=['time', 'pol', 'fine_time'])
        src_cls = TorchNumpySourceBlock if pkg is bt else JM.NumpySourceBlock
        with pkg.Pipeline() as p:
            src = src_cls([np.zeros((16, 2, 32), np.complex64)], hdr,
                          gulp_nframe=16)
            b = pkg.blocks.copy(src, space='cuda' if pkg is bt else 'tpu')
            with pkg.block_scope(mesh=ma):
                b = pkg.blocks.fused(b, [stg.FftStage('fine_time')])
            with pkg.block_scope(mesh=mb):
                b = pkg.blocks.fused(b, [stg.DetectStage('stokes',
                                                         axis='pol')])
        return p

    cases = {'same': lambda mk: (mk({'sp': 4}),) * 2,
             'none_mesh': lambda mk: (None, mk({'sp': 4})),
             'inequivalent': lambda mk: (mk({'sp': 4}), mk({'sp': 2}))}
    for name, make in cases.items():
        reasons, codes = [], []
        for pkg, stg, mk, seg in ((bt, tstages, lambda a: create_mesh(
                a, devices=['cpu'] * int(np.prod(list(a.values())))),
                tsegments), (bf, jstages, jcreate_mesh, jsegments)):
            ma, mb = make(mk)
            p = topo(pkg, stg, mk, ma, mb)
            reasons.append(sorted(
                (str(r) for _i, r in _boundary_reasons(seg, p))))
            codes.append(sorted((d.code, d.message.split(':')[0])
                                for d in p.validate()
                                if d.code in ('BF-W140', 'BF-W141',
                                              'BF-I190')))
        assert reasons[0] == reasons[1], (name, reasons)
        assert [c for c, _m in codes[0]] == [c for c, _m in codes[1]], \
            (name, codes)
        assert ('mesh_reshard' in reasons[0]) == (name != 'same'), name


def _boundary_reasons(seg_mod, p):
    """(producer index, reason) of each device boundary of ``p``."""
    out = []
    for i, blk in enumerate(p.blocks):
        for oring in getattr(blk, 'orings', []):
            cons = [c for c in p.blocks if any(
                getattr(r, 'base', r) is oring or r is oring
                for r in getattr(c, 'irings', []))]
            if not cons:
                continue
            try:
                r = seg_mod._boundary_reason(blk, oring, cons, 'force')
            except Exception as exc:
                r = type(exc).__name__
            out.append((i, r))
    return out


def test_beamformer_block_prewarms_per_shard_and_is_exact():
    """The beamformer block under a 4-rank mesh: its engine is prewarmed
    at the shard's T / 4 frames (and T * K / 4 under a macro batch), the
    block runs a frame-local plan, and the int8 beams equal the
    single-rank run's bit for bit (the block against the oracle is
    ``tests/test_torch_beamform.py``'s)."""
    from tests.test_torch_beamform import (_Gather, _Source, _ci8_gulps,
                                           _header, _weights, B_, S_,
                                           T_)
    gulps = _ci8_gulps()
    w = _weights(B_, S_)

    def run(mesh, k):
        counters.reset()
        with bt.Pipeline(gulp_batch=k) as p:
            b = bt.blocks.copy(_Source(gulps, _header()), space='cuda')
            with bt.block_scope(mesh=mesh):
                blk = bt.blocks.beamform(b, w, accuracy='int8')
            sink = _Gather(bt.blocks.copy(blk, space='system'))
            run_bounded(p)
        return np.concatenate(sink.gulps), blk

    base, _b = run(None, 1)
    for k in (1, 3):
        out, blk = run(_mesh4(), k)
        assert np.array_equal(out, base)
        shapes = {key.split(' v=')[1].split(')')[0] + ')'
                  for key in blk.engine.chosen
                  if isinstance(key, str) and ' v=' in key}
        assert any(s.startswith('(%d,' % (T_ // 4)) for s in shapes), shapes
        if k > 1:
            assert any(s.startswith('(%d,' % (T_ * k // 4)) for s in shapes)


def test_mesh_spectrometer_example_on_four_ranks():
    """``examples/mesh_spectrometer_torch.py`` (the port's twin of
    ``examples/mesh_spectrometer.py``) on 4 ranks of the CPU device: the
    fused chain runs a frame-local plan, every gulp's Stokes-I peak is the
    tone's (256^2 + 128^2 at bin 17 // 4), and the spectra equal the
    one-rank mesh's bit for bit."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), 'examples', 'mesh_spectrometer_torch.py')
    spec = importlib.util.spec_from_file_location('mesh_spec_torch', path)
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    out = {}
    for n in (1, 4):
        p, sink = ex.build(n)
        run_bounded(p)
        out[n] = np.stack(sink.gulps)
        fb = [b for b in p.blocks if getattr(b, 'impl_info', None)][0]
        assert fb.impl_info['mesh'] == 'shard_map[%d]' % n
    assert out[4].shape == (4, 64, 4, 64)
    assert np.array_equal(out[4], out[1])
    assert (out[4][:, :, 0].argmax(axis=-1) == 17 // 4).all()
    assert np.allclose(out[4][:, :, 0].max(axis=-1), 256 ** 2 + 128 ** 2)
