"""Macro-gulp execution and buffer donation in the PyTorch/CUDA port
(bifrost_tpu_torch.macro, the pipeline's macro branches, the ring's
logical gulp counts and ``ReadSpan.take_data``), held against the port's
own K = 1 run and against the JAX package's unfused K = 1 chain in the
same process, as ``tests/test_macro_gulp.py`` and the donation tests of
``tests/test_xfer_async.py`` hold the JAX package.

Tolerances: the port at K = 4 (or donating) is byte-identical to the
port at K = 1; integer chains (the FX correlator) equal the JAX chain
exactly; float chains are within 1e-5 of the maximum of the JAX chain
(the spectrometer gate).  Every pipeline runs through ``run_bounded``.
The port runs on the CPU device (``set_device('cpu')``): each kernel
wrapper runs its plain version.
"""

import contextlib
from copy import deepcopy
from functools import lru_cache

import numpy as np
import pytest
import torch

import bifrost_tpu as bf
from bifrost_tpu import macro as jmacro
from bifrost_tpu.stages import (FftStage as JFft, DetectStage as JDetect,
                                ReduceStage as JReduce, Stage as JStage)
from tests.util import NumpySourceBlock, GatherSink, simple_header

import bifrost_tpu_torch as bt
from bifrost_tpu_torch import device, macro, xfer
from bifrost_tpu_torch.macro import (resolve_gulp_batch, chain_batch_mode,
                                     build_batched_fn)
from bifrost_tpu_torch.ring import Ring
from bifrost_tpu_torch.stages import (FftStage, DetectStage, ReduceStage,
                                      Stage)
from bifrost_tpu_torch.telemetry import counters
from tests.test_torch_bounded import run_bounded

NT, NP, NF, RF = 32, 2, 64, 4
GATE = 1e-5


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    device.set_device('cpu')
    for var in ('BF_GULP_BATCH', 'BF_DONATE', 'BF_SEGMENTS'):
        monkeypatch.delenv(var, raising=False)
    yield
    xfer.reset_engine()


def rel(got, want):
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


# ---------------------------------------------------------------------------
# the port's source and sink, and the spectrometer chain in both packages
# ---------------------------------------------------------------------------

def voltages(ngulp, seed=3, nt=NT):
    """``ngulp`` ci8 gulps as (nt, NP, NF, 2) int8 (re, im) pairs."""
    rng = np.random.RandomState(seed)
    return [rng.randint(-64, 64, (nt, NP, NF, 2)).astype(np.int8)
            for _ in range(ngulp)]


def as_ci8(g):
    raw = np.zeros(g.shape[:-1], dtype=bf.dtype.ci8)
    raw['re'], raw['im'] = g[..., 0], g[..., 1]
    return raw


def spec_header():
    return simple_header([-1, NP, NF], 'ci8',
                         labels=['time', 'pol', 'fine_time'])


class Source(bt.SourceBlock):
    """Frame-first gulps (int8 arrays of each gulp's bytes) into a system
    ring."""

    def __init__(self, gulps, header, **kw):
        super(Source, self).__init__(['numpy'], gulps[0].shape[0],
                                     space='system', **kw)
        self._gulps, self._header = gulps, header

    def create_reader(self, name):
        return contextlib.nullcontext(iter(self._gulps))

    def on_sequence(self, reader, name):
        return [deepcopy(self._header)]

    def on_data(self, reader, ospans):
        g = next(reader, None)
        if g is None:
            return [0]
        dst = ospans[0].data.as_numpy()
        if dst.dtype.names:          # a complex-integer host span
            dst = dst.view(np.int8)
        dst[...] = g.reshape(dst.shape)
        return [g.shape[0]]


class Gather(bt.SinkBlock):
    def __init__(self, iring, **kw):
        super(Gather, self).__init__(iring, **kw)
        self.gulps = []

    def on_sequence(self, iseq):
        pass

    def on_data(self, ispan):
        self.gulps.append(np.array(ispan.data.as_numpy(), copy=True))

    def result(self, axis=0):
        return np.concatenate(self.gulps, axis=axis)


def block_counter(snap, frag, kind):
    return sum(v for k, v in snap.items()
               if k.startswith('block.') and frag in k
               and k.endswith('.' + kind))


def run_spec(gulp_batch, ngulp, donate=None, stages=None, **scope):
    """source -> copy('cuda') -> fused[FFT, Stokes, reduce] -> copy
    ('system') -> sink; returns (output, the fused block, counters)."""
    counters.reset()
    with bt.Pipeline(gulp_batch=gulp_batch, donate=donate, **scope) as p:
        b = bt.blocks.copy(Source(voltages(ngulp), spec_header()),
                           space='cuda')
        fb = bt.blocks.fused(
            b, stages or [FftStage('fine_time', axis_labels='freq'),
                          DetectStage('stokes', axis='pol'),
                          ReduceStage('freq', RF)])
        sink = Gather(bt.blocks.copy(fb, space='system'))
        run_bounded(p)
    return sink.result(), fb, counters.snapshot()


@lru_cache(maxsize=None)
def jax_spec(ngulp):
    """The JAX package's unfused K = 1 spectrometer chain on the same
    gulps (segments off: the reference's segmented chain fails its own
    byte test)."""
    with bf.Pipeline(segments='off', gulp_batch=1) as p:
        src = NumpySourceBlock([as_ci8(g) for g in voltages(ngulp)],
                               spec_header(), gulp_nframe=NT)
        b = bf.blocks.copy(src, space='tpu')
        b = bf.blocks.fused(b, [JFft('fine_time', axis_labels='freq'),
                                JDetect('stokes', axis='pol'),
                                JReduce('freq', RF)])
        sink = GatherSink(bf.blocks.copy(b, space='system'))
        run_bounded(p)
    return sink.result()


# ---------------------------------------------------------------------------
# correctness and amortization
# ---------------------------------------------------------------------------

def test_batched_chain_identical_and_amortized():
    """K = 4 over 8 gulps: byte-identical to K = 1, the fused block's
    dispatches fall 4x (2 of 8 gulps), the copies batch too, and the
    executed plan records its batch; within the gate of the JAX chain."""
    out1, _, c1 = run_spec(1, 8)
    out4, fb4, c4 = run_spec(4, 8)
    assert np.array_equal(out1, out4)
    assert rel(out4, jax_spec(8)) < GATE
    assert (block_counter(c1, 'Fused', 'dispatches'),
            block_counter(c1, 'Fused', 'gulps')) == (8, 8)
    assert (block_counter(c4, 'Fused', 'dispatches'),
            block_counter(c4, 'Fused', 'gulps')) == (2, 8)
    assert block_counter(c4, 'Copy', 'dispatches') < \
        block_counter(c4, 'Copy', 'gulps')
    assert fb4.impl_info['batch'] == 4
    assert fb4.impl_info['batch_mode'] == 'block'
    # the K1 substitution still matches at the K-gulp shape
    assert fb4.impl_info['impl'] == 'cuda-spectrometer'
    assert fb4.perf_totals['ngulp'] == 2 and fb4.perf_totals['nlogical'] == 8


def test_partial_batch_flushes_at_sequence_end():
    """6 gulps at K = 4: one batch of 4, one partial batch of 2, the same
    bytes."""
    out1, _, _ = run_spec(1, 6)
    out4, _, c4 = run_spec(4, 6)
    assert np.array_equal(out1, out4)
    assert block_counter(c4, 'Fused', 'dispatches') == 2
    assert block_counter(c4, 'Fused', 'gulps') == 6


def test_env_var_enables_batching(monkeypatch):
    monkeypatch.setenv('BF_GULP_BATCH', '4')
    out, _, c = run_spec(None, 8)
    assert block_counter(c, 'Fused', 'dispatches') == 2
    monkeypatch.delenv('BF_GULP_BATCH')
    assert np.array_equal(out, run_spec(1, 8)[0])


def test_macro_donation_hits_and_identical():
    """Donation composes with macro spans: the H2D block's K-gulp chunk
    is claimed, and the donating plan publishes its donate_argnums."""
    out1, _, _ = run_spec(1, 8)
    out4, fb4, c4 = run_spec(4, 8, donate=True)
    assert np.array_equal(out1, out4)
    assert c4.get('donation.hits', 0) > 0
    assert fb4.impl_info['donate_argnums'] == [0]


def test_ring_gulp_counters_count_logical_gulps():
    """``ring.<name>.gulps`` counts logical gulps when K are committed in
    one span: the batched device rings and the K = 1 source ring all
    read 8, as in the JAX package."""
    _, _, snap = run_spec(4, 8)
    ring_gulps = [v for k, v in snap.items()
                  if k.startswith('ring.') and k.endswith('.gulps')]
    assert len(ring_gulps) == 4 and all(v == 8 for v in ring_gulps)


def test_h2d_of_a_macro_span_is_one_batched_transfer():
    """The H2D copy stages a K-gulp span with one to_device_batch call
    (8 gulps, 2 transfers); K = 1 ships one a gulp."""
    _, _, c1 = run_spec(1, 8)
    _, _, c4 = run_spec(4, 8)
    assert (c1['xfer.h2d_issued'], c1.get('xfer.h2d_batched', 0)) == (8, 0)
    assert (c4['xfer.h2d_issued'], c4['xfer.h2d_batched']) == (2, 8)


def test_counters_equal_the_jax_package_at_k4():
    """The fused block's dispatches and gulps and the ring gulp counts at
    K = 4 equal the JAX package's on the same chain."""
    from bifrost_tpu.telemetry import counters as jcounters
    _, _, snap = run_spec(4, 8)
    jcounters.reset()
    with bf.Pipeline(segments='off', gulp_batch=4) as p:
        src = NumpySourceBlock([as_ci8(g) for g in voltages(8)],
                               spec_header(), gulp_nframe=NT)
        b = bf.blocks.copy(src, space='tpu')
        b = bf.blocks.fused(b, [JFft('fine_time', axis_labels='freq'),
                                JDetect('stokes', axis='pol'),
                                JReduce('freq', RF)])
        GatherSink(bf.blocks.copy(b, space='system'))
        run_bounded(p)
    jsnap = jcounters.snapshot()
    for frag in ('Fused', 'Copy'):
        for kind in ('dispatches', 'gulps'):
            assert block_counter(snap, frag, kind) == \
                block_counter(jsnap, frag, kind), (frag, kind)
    assert sorted(v for k, v in snap.items()
                  if k.startswith('ring.') and k.endswith('.gulps')) == \
        sorted(v for k, v in jsnap.items()
               if k.startswith('ring.') and k.endswith('.gulps'))


# ---------------------------------------------------------------------------
# eligibility fallbacks
# ---------------------------------------------------------------------------

def test_host_blocks_fall_back():
    """A system -> system copy cannot batch: every dispatch stays 1:1
    and the fallback is counted."""
    counters.reset()
    with bt.Pipeline(gulp_batch=4) as p:
        b = bt.blocks.copy(Source(voltages(6), spec_header()))
        Gather(b)
        run_bounded(p)
    snap = counters.snapshot()
    assert block_counter(snap, 'Copy', 'dispatches') == \
        block_counter(snap, 'Copy', 'gulps') == 6
    assert snap.get('macro.fallback.block', 0) > 0


def test_multi_reader_ring_batches():
    """A second reader on the fused block's input ring: the fused block
    still batches (2 of 8), the case is counted as retired, and both
    readers see the whole stream unmangled."""
    counters.reset()
    with bt.Pipeline(gulp_batch=4) as p:
        b = bt.blocks.copy(Source(voltages(8), spec_header()),
                           space='cuda')
        fb = bt.blocks.fused(b, [FftStage('fine_time', axis_labels='freq'),
                                 DetectStage('stokes', axis='pol'),
                                 ReduceStage('freq', RF)])
        sink1 = Gather(bt.blocks.copy(fb, space='system'))
        sink2 = Gather(bt.blocks.copy(b, space='system'))
        run_bounded(p)
    snap = counters.snapshot()
    assert snap.get('macro.fallback.multi_reader', 0) == 0
    assert snap.get('macro.fallback.multi_reader_retired', 0) > 0
    assert block_counter(snap, 'Fused', 'gulps') == 8
    assert block_counter(snap, 'Fused', 'dispatches') == 2
    assert np.array_equal(sink1.result(), run_spec(1, 8)[0])
    raw = np.concatenate(voltages(8))
    assert np.array_equal(sink2.result().view(np.int8).reshape(raw.shape),
                          raw)


class OverlapIdent(bt.TransformBlock):
    """Claims macro safety but declares a 4-frame overlap and no halo
    carry: the overlap must still veto batching."""

    def on_sequence(self, iseq):
        return deepcopy(iseq.header)

    def define_input_overlap_nframe(self, iseq):
        return 4

    def define_output_nframes(self, input_nframe):
        return input_nframe - 4

    def macro_gulp_safe(self):
        return True

    def on_data(self, ispan, ospan):
        ospan.set(ispan.data[4:])


def test_overlap_falls_back():
    counters.reset()
    with bt.Pipeline(gulp_batch=4) as p:
        b = bt.blocks.copy(Source(voltages(6), spec_header()),
                           space='cuda')
        ob = OverlapIdent(b)
        Gather(bt.blocks.copy(ob, space='system'))
        run_bounded(p)
    snap = counters.snapshot()
    assert snap.get('macro.fallback.overlap', 0) > 0
    assert block_counter(snap, 'OverlapIdent', 'dispatches') == \
        block_counter(snap, 'OverlapIdent', 'gulps')


def test_unguaranteed_reader_falls_back():
    counters.reset()
    with bt.Pipeline(gulp_batch=4) as p:
        b = bt.blocks.copy(Source(voltages(4), spec_header()),
                           space='cuda')
        d = bt.blocks.fft(b, 'fine_time', axis_labels='freq',
                          guarantee=False)
        Gather(bt.blocks.copy(d, space='system'))
        run_bounded(p)
    assert counters.get('macro.fallback.unguaranteed') > 0


def test_resolve_gulp_batch_sources(monkeypatch):
    for pkg, resolve in ((bt, resolve_gulp_batch),
                         (bf, jmacro.resolve_gulp_batch)):
        assert resolve(pkg.Pipeline(gulp_batch=8)) == 8
        monkeypatch.setenv('BF_GULP_BATCH', '16')
        assert resolve(pkg.Pipeline()) == 16
        monkeypatch.setenv('BF_GULP_BATCH', 'junk')
        assert resolve(pkg.Pipeline()) == 1
        monkeypatch.delenv('BF_GULP_BATCH')
        assert resolve(pkg.Pipeline()) == 1
    p = bt.Pipeline()
    assert macro.retune_gulp_batch(p, 0) == 1 and resolve_gulp_batch(p) == 1
    assert macro.retune_gulp_batch(p, 6) == 6 and resolve_gulp_batch(p) == 6


# ---------------------------------------------------------------------------
# the batched function: 'block' and 'sliced' modes
# ---------------------------------------------------------------------------

def test_chain_batch_mode_classification_equals_jax():
    class Custom(Stage):
        pass

    class JCustom(JStage):
        pass
    assert chain_batch_mode([FftStage('fine_time'),
                             DetectStage('stokes', axis='pol')]) == \
        jmacro.chain_batch_mode([JFft('fine_time'),
                                 JDetect('stokes', axis='pol')]) == 'block'
    assert chain_batch_mode([FftStage('fine_time'), Custom()]) == \
        jmacro.chain_batch_mode([JFft('fine_time'), JCustom()]) == 'sliced'


def test_sliced_batched_fn_matches_per_gulp_and_jax():
    """'sliced' mode applies the per-gulp function to each G-frame slice
    and to the partial tail (29 frames: 3 gulps of 8 and 5): exactly the
    per-gulp torch result, and within the gate of the JAX lax.map."""
    import jax.numpy as jnp
    G, n = 8, 29
    x = np.random.RandomState(0).randn(n, 4).astype(np.float32)
    fn = build_batched_fn(lambda shape: (lambda a: torch.cumsum(a, 0)),
                          0, 0, G, [(n, 4)], 'sliced')
    got = fn(torch.from_numpy(x)).numpy()
    want = torch.cat([torch.cumsum(torch.from_numpy(x[i:i + G]), 0)
                      for i in range(0, n, G)]).numpy()
    assert np.array_equal(got, want)
    jfn = jmacro.build_batched_fn(
        lambda shape: (lambda a: jnp.cumsum(a, axis=0)), 0, 0, G,
        [(n, 4)], 'sliced')
    assert rel(got, np.asarray(jfn(jnp.asarray(x)))) < GATE


def test_batched_fn_multi_part_concat():
    a = torch.arange(16, dtype=torch.float32).reshape(8, 2)
    b = torch.arange(16, 32, dtype=torch.float32).reshape(8, 2)
    for mode in ('sliced', 'block'):
        fn = build_batched_fn(lambda shape: (lambda v: v * 2.0), 0, 0, 4,
                              [(8, 2), (8, 2)], mode)
        assert torch.equal(fn(a, b), torch.cat([a, b]) * 2.0)


class GulpScaled(Stage):
    """A stage whose output depends on the gulp it is given (each frame
    less its gulp's first frame): not time-concat equivariant."""

    def build(self, in_meta):
        return lambda x: x - x[:1]


def test_sliced_fused_chain_keeps_per_gulp_semantics():
    """A chain with a stage that is not batch_safe runs 'sliced' at
    K = 4: the same bytes as K = 1, a partial tail included."""
    stages = [FftStage('fine_time', axis_labels='freq'), GulpScaled()]
    out1, _, _ = run_spec(1, 6, stages=list(stages))
    out4, fb, c4 = run_spec(4, 6, stages=list(stages))
    assert np.array_equal(out1, out4)
    assert fb.impl_info['batch_mode'] == 'sliced'
    assert block_counter(c4, 'Fused', 'dispatches') == 2


# ---------------------------------------------------------------------------
# the executed plan's record
# ---------------------------------------------------------------------------

def test_impl_republish_on_executed_path_change():
    """impl_info follows the executed plan: donate toggling republishes
    both ways, a macro plan publishes its batch fields, as the JAX
    block's record does."""
    from bifrost_tpu_torch.blocks.fused import FusedBlock
    with bt.Pipeline():
        fb = FusedBlock(Ring(space='cuda'),
                        [DetectStage('stokes', axis='pol')])
    hdr = simple_header([-1, NP, NF], 'cf32',
                        labels=['time', 'pol', 'freq'])
    hdr['gulp_nframe'] = NT
    fb._headers = [hdr, fb.stages[0].transform_header(hdr)]
    x = torch.zeros((NT, NP, NF), dtype=torch.complex64)
    fb._execute_plan(x)
    assert 'donate_argnums' not in fb.impl_info
    fb._execute_plan(x.clone(), donate=True)
    assert fb.impl_info['donate_argnums'] == [0]
    fb._execute_plan(x)
    assert 'donate_argnums' not in fb.impl_info
    assert fb._published_impl == fb.impl_info
    fb._execute_macro([torch.zeros((NT * 4, NP, NF),
                                   dtype=torch.complex64)], False, NT)
    assert fb.impl_info['batch'] == 4
    assert fb.impl_info['batch_mode'] == 'block'
    fb._execute_macro([x, x], True, NT)
    assert fb.impl_info['batch'] == 2
    assert fb.impl_info['donate_argnums'] == [0, 1]


def test_prewarm_builds_the_hot_paths_plans():
    """At sequence start the block runs its plan at the gulp shape and,
    at K = 4, at the K-gulp shape: the gulps then build nothing but the
    partial tail's plan."""
    out, fb, snap = run_spec(4, 8)
    assert fb.prewarm_runs == 2
    assert snap['fused.plan_builds'] == 2


def test_prewarm_error_raises():
    """A plan that fails at sequence start stops the pipeline with the
    error (the JAX block swallows it and builds again in on_data)."""
    class Broken(Stage):
        batch_safe = True

        def build(self, in_meta):
            def fn(x):
                raise RuntimeError('broken stage')
            return fn
    with pytest.raises(bt.PipelineInitError, match='broken stage'):
        run_spec(1, 2, stages=[FftStage('fine_time', axis_labels='freq'),
                               Broken()])


# ---------------------------------------------------------------------------
# donation: ownership taken out of the ring
# ---------------------------------------------------------------------------

def _one_chunk_ring(owned, nreader=1, view=False):
    ring = Ring(space='cuda')
    hdr = simple_header([-1, 4], 'f32', gulp_nframe=8)
    w = ring.begin_writing()
    w.__enter__()
    seq = w.begin_sequence(hdr, 8, 24)
    with seq.reserve(8) as sp:
        sp.set(torch.ones((8, 4)), owned=owned)
        sp.commit(8)
    readers = [ring.open_earliest_sequence(guarantee=True)
               for _ in range(nreader)]
    if view:
        from bifrost_tpu_torch.ring import ring_view
        readers = [ring_view(ring, lambda h: h).open_earliest_sequence()]
    return ring, readers


def test_donation_denied_for_shared_chunks():
    """A chunk set without owned=True is never claimed."""
    _ring, (r,) = _one_chunk_ring(owned=False)
    with r.acquire(0, 8) as ispan:
        assert ispan.take_data() is None
        assert torch.equal(ispan.data, torch.ones((8, 4)))


def test_donation_denied_with_second_reader():
    """Two readers: neither may claim even an owned chunk."""
    _ring, (r1, r2) = _one_chunk_ring(owned=True, nreader=2)
    with r1.acquire(0, 8) as s1, r2.acquire(0, 8) as s2:
        assert s1.take_data() is None
        assert s2.take_data() is None


def test_donation_denied_through_a_view():
    _ring, (r,) = _one_chunk_ring(owned=True, view=True)
    with r.acquire(0, 8) as ispan:
        assert ispan.take_data() is None


def test_donation_claims_an_exclusive_owned_chunk():
    """The only reader claims the owned chunk: the ring forgets it."""
    ring, (r,) = _one_chunk_ring(owned=True)
    with r.acquire(0, 8) as ispan:
        x = ispan.take_data()
        assert torch.equal(x, torch.ones((8, 4)))
        assert ispan.data is x
    assert not ring._storage.chunks


def test_take_data_tiles_a_macro_span_from_per_gulp_chunks():
    """allow_parts claims the K owned per-gulp chunks tiling a span as a
    list in frame order, and nothing when one of them is not owned."""
    for owned, want in (((True, True), 2), ((True, False), None)):
        ring = Ring(space='cuda')
        hdr = simple_header([-1, 2], 'f32', gulp_nframe=4)
        with ring.begin_writing() as w:
            with w.begin_sequence(hdr, 4, 16) as seq:
                for i, o in enumerate(owned):
                    with seq.reserve(4) as sp:
                        sp.set(torch.full((4, 2), float(i)), owned=o)
                        sp.commit(4)
                r = ring.open_earliest_sequence(guarantee=True)
                with r.acquire(0, 8) as ispan:
                    assert ispan.take_data() is None
                    got = ispan.take_data(allow_parts=True)
                    if want is None:
                        assert got is None
                        assert len(ring._storage.chunks) == 2
                    else:
                        assert [float(t[0, 0]) for t in got] == [0.0, 1.0]
                        assert not ring._storage.chunks
                r.close()


def _stage_chain(donate, ngulp=4):
    counters.reset()
    with bt.Pipeline(donate=donate) as p:
        b = bt.blocks.copy(Source(voltages(ngulp), spec_header()),
                           space='cuda')
        b = bt.blocks.fft(b, 'fine_time', axis_labels='freq')
        b = bt.blocks.detect(b, 'stokes', axis='pol')
        sink = Gather(bt.blocks.copy(b, space='system'))
        run_bounded(p)
    return sink.result(), counters.snapshot()


def test_stage_block_donation_bitexact():
    """Unfused stage blocks donate too: every input chunk claimed (the
    H2D's and the FFT's), the output byte-identical."""
    out0, c0 = _stage_chain(False)
    out1, c1 = _stage_chain(True)
    assert c0.get('donation.hits', 0) == 0
    assert c1['donation.hits'] == 8 and c1.get('donation.misses', 0) == 0
    assert np.array_equal(out0, out1)


def test_fused_chain_donation_bitexact_and_reported(monkeypatch):
    """BF_DONATE=1 turns donation on; the plan record reports it."""
    out0, fb0, _ = run_spec(1, 4)
    assert 'donate_argnums' not in fb0.impl_info
    monkeypatch.setenv('BF_DONATE', '1')
    out1, fb1, c1 = run_spec(1, 4)
    assert fb1.impl_info['donate_argnums'] == [0]
    assert c1['donation.hits'] == 4
    assert np.array_equal(out0, out1)


def test_macro_consumer_of_a_k1_producer_claims_the_parts():
    """A K = 1 H2D (its gulp_batch pinned to 1) feeding a donating K = 4
    fused block: the block claims the 4 per-gulp chunks of each span and
    joins them once; the bytes equal K = 1's."""
    counters.reset()
    with bt.Pipeline(gulp_batch=4, donate=True) as p:
        b = bt.blocks.copy(Source(voltages(8), spec_header()),
                           space='cuda', gulp_batch=1)
        fb = bt.blocks.fused(b, [FftStage('fine_time', axis_labels='freq'),
                                 DetectStage('stokes', axis='pol'),
                                 ReduceStage('freq', RF)])
        sink = Gather(bt.blocks.copy(fb, space='system'))
        run_bounded(p)
    assert counters.get('donation.hits') == 2
    assert fb.impl_info['donate_argnums'] == [0, 1, 2, 3]
    assert np.array_equal(sink.result(), run_spec(1, 8)[0])


def test_macro_writer_feeding_a_k1_reader_does_not_deadlock():
    """A K = 4 fused writer, a K = 1 stage block reading its ring one
    gulp at a time (gulp_batch pinned to 1), and the bytes of the K = 1
    chain: the writer's second macro span of depth keeps both moving."""
    stages = [FftStage('fine_time', axis_labels='freq'),
              DetectStage('stokes', axis='pol')]

    def run(k):
        with bt.Pipeline(gulp_batch=k) as p:
            b = bt.blocks.copy(Source(voltages(9), spec_header()),
                               space='cuda')
            b = bt.blocks.fused(b, list(stages))
            b = bt.blocks.reduce(b, 'freq', RF, gulp_batch=1)
            sink = Gather(bt.blocks.copy(b, space='system'))
            run_bounded(p, timeout=30)
        return sink.result()
    assert np.array_equal(run(4), run(1))


# ---------------------------------------------------------------------------
# the halo carry of the FRB-search stage blocks and the FX chain
# ---------------------------------------------------------------------------

F_DM, G_DM, MD_DM, NTAP_DM = 8, 32, 8, 4


def fb_gulps(ngulp=8):
    rng = np.random.RandomState(11)
    data = rng.randn(F_DM, ngulp * G_DM).astype(np.float32)
    return [np.ascontiguousarray(data[:, i * G_DM:(i + 1) * G_DM])
            for i in range(ngulp)]


def fb_header():
    return {'name': 'filterbank', 'time_tag': 0,
            '_tensor': {'shape': [F_DM, -1], 'dtype': 'f32',
                        'labels': ['freq', 'time'],
                        'scales': [[100.0, 1.0], [0.0, 1e-3]],
                        'units': ['MHz', 's']}}


class TimeLastSource(bt.SourceBlock):
    """[freq, time] gulps into a system ring (freq lanes are ringlets)."""

    def __init__(self, gulps):
        super(TimeLastSource, self).__init__(['fb'], gulps[0].shape[-1],
                                             space='system')
        self._gulps = gulps

    def create_reader(self, name):
        return contextlib.nullcontext(iter(self._gulps))

    def on_sequence(self, reader, name):
        return [fb_header()]

    def on_data(self, reader, ospans):
        g = next(reader, None)
        if g is None:
            return [0]
        ospans[0].data.as_numpy()[...] = g
        return [g.shape[-1]]


def run_dm(segments=None, gulp_batch=1, donate=None, pkg=bt):
    """source -> copy -> fdmt_stage -> matched_filter -> threshold -> copy
    -> sink in ``pkg``; returns (output, pipeline, counters)."""
    if pkg is bt:
        counters.reset()
        with bt.Pipeline(segments=segments, gulp_batch=gulp_batch,
                         donate=donate) as p:
            b = bt.blocks.copy(TimeLastSource(fb_gulps()), space='cuda')
            b = bt.blocks.fdmt_stage(b, max_delay=MD_DM)
            b = bt.blocks.matched_filter(b, NTAP_DM)
            b = bt.blocks.threshold(b, 0.5)
            sink = Gather(bt.blocks.copy(b, space='system'))
            run_bounded(p)
        return sink.result(axis=-1), p, counters.snapshot()
    return jax_dm(), None, None


@lru_cache(maxsize=None)
def jax_dm():
    """The JAX chain, unfused, at K = 1."""
    class JSource(bf.SourceBlock):
        def __init__(self):
            super(JSource, self).__init__(['fb'], G_DM)

        def create_reader(self, name):
            return contextlib.nullcontext(iter(fb_gulps()))

        def on_sequence(self, reader, name):
            return [fb_header()]

        def on_data(self, reader, ospans):
            g = next(reader, None)
            if g is None:
                return [0]
            ospans[0].data.as_numpy()[...] = g
            return [g.shape[-1]]

    collected = []

    class JSink(bf.SinkBlock):
        def on_sequence(self, iseq):
            pass

        def on_data(self, ispan):
            collected.append(np.array(ispan.data.as_numpy(), copy=True))

    with bf.Pipeline(segments='off', gulp_batch=1) as p:
        b = bf.blocks.copy(JSource(), space='tpu')
        b = bf.blocks.fdmt_stage(b, max_delay=MD_DM)
        b = bf.blocks.matched_filter(b, NTAP_DM)
        b = bf.blocks.threshold(b, 0.5)
        JSink(bf.blocks.copy(b, space='system'))
        run_bounded(p)
    return np.concatenate(collected, axis=-1)


def test_halo_carry_stage_blocks_batch_byte_identical():
    """fdmt_stage -> matched_filter -> threshold at K = 4, each stage
    block batching with its overlap carried once a span: the K = 1 bytes,
    K-fold fewer dispatches, no overlap fallback; within the gate of the
    JAX chain."""
    base, _, c1 = run_dm()
    out, _, c4 = run_dm(gulp_batch=4)
    assert np.array_equal(base, out)
    assert rel(out, jax_dm()) < GATE
    assert c4.get('macro.fallback.overlap', 0) == 0
    for frag in ('FdmtStage', 'MatchedFilter', 'Threshold'):
        assert block_counter(c1, frag, 'dispatches') == 8
        assert block_counter(c4, frag, 'dispatches') == 2
        assert block_counter(c4, frag, 'gulps') == 8


def test_overlapped_reads_never_donate():
    """Donation on: the overlapped reads of the FRB chain miss (the next
    span re-reads the history), the bytes stay the same."""
    base, _, _ = run_dm()
    out, _, snap = run_dm(gulp_batch=4, donate=True)
    assert np.array_equal(base, out)
    # fdmt_stage and matched_filter read overlapped spans (2 each);
    # threshold reads plain ones and claims them
    assert snap['donation.misses'] == 4
    assert snap['donation.hits'] == 2


def test_macro_plans_are_eager_calls():
    """A macro plan is a Python call of the composed chain, run eagerly
    once a span: two calls on one input give two fresh output tensors
    (a CUDA-graph replay would write one static buffer), and the record
    names no graph."""
    _out, fb, _snap = run_spec(4, 8)
    key = next(k for k in fb._plans if k[0] == 'macro')
    plan = fb._plans[key]
    x = torch.zeros(key[1][0], dtype=key[2])
    a, b = plan(x), plan(x)
    assert a is not b and a.data_ptr() != b.data_ptr()
    assert torch.equal(a, b)
    assert not any('graph' in k for k in fb.impl_info)
