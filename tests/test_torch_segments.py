"""Compiled pipeline segments in the PyTorch/CUDA port
(bifrost_tpu_torch.segments and telemetry.segments), as
``tests/test_segments.py`` and ``tests/test_correlate.py:198-206`` hold
the JAX package.

A segment runs its members' functions in one call and elides the rings
between them: its output is byte-identical to the port's unfused chain,
its interior rings see no span, its members dispatch nothing but keep
their gulp counters, spans, SLO ages and proclogs, and the planner's
reason for every boundary that does not fuse equals the JAX planner's on
the same topology (sets of (producer type, reason slug)).  Float chains
are held within 1e-5 of the JAX package's unfused K = 1 chain, never its
segmented one (whose own byte test fails: XLA reorders float operations
across the fused boundary); the integer FX chain equals it exactly.
"""

from functools import lru_cache

import numpy as np
import pytest

import bifrost_tpu as bf
from bifrost_tpu import segments as jseg
from bifrost_tpu import macro as jmacro
from bifrost_tpu.blocks.fft import _StageBlock as _JStageBlock
from bifrost_tpu.stages import DetectStage as JDetect
from tests.util import NumpySourceBlock, GatherSink, simple_header

import bifrost_tpu_torch as bt
from bifrost_tpu_torch import device, segments as bseg, xfer
from bifrost_tpu_torch.blocks.fft import _StageBlock
from bifrost_tpu_torch.macro import split_ranges
from bifrost_tpu_torch.stages import DetectStage
from bifrost_tpu_torch.telemetry import counters, histograms
from tests.test_torch_bounded import run_bounded
from tests.test_torch_macro import (NT, RF, GATE, Gather, Source, as_ci8,
                                    jax_dm, rel, run_dm, spec_header,
                                    voltages, MD_DM, NTAP_DM)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    device.set_device('cpu')
    for var in ('BF_GULP_BATCH', 'BF_DONATE', 'BF_SEGMENTS'):
        monkeypatch.delenv(var, raising=False)
    yield
    xfer.reset_engine()


def run_chain(segments=None, gulp_batch=1, ngulp=6, donate=None,
              split=None, **scope):
    """source -> copy('cuda') -> fft -> detect -> reduce -> copy('system')
    -> sink as separate stage blocks; returns (output, pipeline,
    counters)."""
    counters.reset()
    with bt.Pipeline(segments=segments, gulp_batch=gulp_batch,
                     donate=donate, sync_depth=4, **scope) as p:
        b = bt.blocks.copy(Source(voltages(ngulp), spec_header()),
                           space='cuda')
        b = bt.blocks.fft(b, axes='fine_time', axis_labels='freq')
        b = bt.blocks.detect(b, mode='stokes', axis='pol')
        b = bt.blocks.reduce(b, 'freq', RF)
        sink = Gather(bt.blocks.copy(b, space='system'))
        if split is not None:
            # as the auto-tuner does: compile, then set the knob before
            # the first sequence reads it
            segs = bseg.compile_pipeline(p)
            assert segs
            bseg.retune_split(segs[0], split)
        run_bounded(p)
    return sink.result(), p, counters.snapshot()


@lru_cache(maxsize=None)
def jax_chain(ngulp):
    """The JAX package's unfused K = 1 stage-block chain."""
    with bf.Pipeline(segments='off', gulp_batch=1) as p:
        src = NumpySourceBlock([as_ci8(g) for g in voltages(ngulp)],
                               spec_header(), gulp_nframe=NT)
        b = bf.blocks.copy(src, space='tpu')
        b = bf.blocks.fft(b, axes='fine_time', axis_labels='freq')
        b = bf.blocks.detect(b, mode='stokes', axis='pol')
        b = bf.blocks.reduce(b, 'freq', RF)
        sink = GatherSink(bf.blocks.copy(b, space='system'))
        run_bounded(p)
    return sink.result()


def type_name(block_name):
    """'Pipeline_3/FftBlock_7' -> 'FftBlock'."""
    return block_name.split('/')[-1].rsplit('_', 1)[0]


def reasons(planner, pipeline, mode=None):
    return {(type_name(b['producer']), b['reason'])
            for b in planner.plan(pipeline, mode)[1]}


def elided_untouched(seg):
    """No span was ever reserved or committed on the segment's interior
    rings."""
    assert [r.name for r in seg._elided_rings] == seg._elided
    for ring in seg._elided_rings:
        occ = ring.occupancy()
        assert counters.get('ring.%s.gulps' % ring.name) == 0
        assert occ['head'] == occ['reserve_head'] == 0
        assert not ring._storage.chunks
    return True


# ---------------------------------------------------------------------------
# fusion and elision
# ---------------------------------------------------------------------------

def test_segment_fuses_byte_identical_and_elides():
    base, p0, _ = run_chain(None)
    out, p1, snap = run_chain('auto')
    assert np.array_equal(base, out)
    assert rel(out, jax_chain(6)) < GATE
    # 7 blocks -> 5: fft, detect and reduce become one SegmentBlock
    assert len(p0.blocks) == 7 and len(p1.blocks) == 5
    assert len(p1._segments) == 1
    seg = p1._segments[0]
    assert type(seg).__name__ == 'SegmentBlock'
    assert [type_name(m) for m in seg._members] == \
        ['FftBlock', 'DetectBlock', 'ReduceBlock']
    assert snap['segment.compiled'] == 1
    assert snap['segment.elided_rings'] == 2
    assert snap['segment.dispatches'] == 6
    assert snap['segment.gulps'] == 6
    assert elided_untouched(seg)
    # the members dispatch nothing, their gulps keep counting, and their
    # SLO ages are fed from the segment (the source stamps a trace
    # context)
    for m in seg._members:
        assert ('block.%s.dispatches' % m) not in snap
        assert snap['block.%s.gulps' % m] == 6
        h = histograms.get('slo.%s.commit_age_s' % m)
        assert h is not None and h.snapshot()['count'] == 6
    assert snap['block.%s.dispatches' % seg.name] == 6


def test_segment_composes_with_macro_gulp():
    base, _, _ = run_chain(None, ngulp=8)
    out, p, snap = run_chain('auto', gulp_batch=4, ngulp=8)
    assert np.array_equal(base, out)
    assert snap['segment.dispatches'] == 2
    assert snap['segment.gulps'] == 8
    assert p._segments[0].impl_info['batch'] == 4


def test_segment_threads_donation_through_interiors():
    base, _, _ = run_chain(None, ngulp=8)
    out, _, snap = run_chain('auto', gulp_batch=4, ngulp=8, donate=True)
    assert np.array_equal(base, out)
    assert snap['donation.hits'] == 2


def test_segment_keeps_a_fused_members_substitution(monkeypatch):
    """A FusedBlock member keeps its K1 substitution inside a segment,
    and the bytes equal the unfused pair's."""
    from bifrost_tpu_torch.stages import FftStage, ReduceStage
    from bifrost_tpu_torch.ops import spectrometer as spec

    def run(segments):
        with bt.Pipeline(segments=segments) as p:
            b = bt.blocks.copy(Source(voltages(4), spec_header()),
                               space='cuda')
            b = bt.blocks.fused(b, [FftStage('fine_time',
                                             axis_labels='freq'),
                                    DetectStage('stokes', axis='pol'),
                                    ReduceStage('freq', RF)])
            b = bt.blocks.scrunch(b, 2)
            sink = Gather(bt.blocks.copy(b, space='system'))
            run_bounded(p)
        return sink.result(), p
    calls = []
    real = spec.fused_spectrometer

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)
    monkeypatch.setattr(spec, 'fused_spectrometer', counting)
    base, _ = run('off')
    n_off = len(calls)
    out, p = run('force')
    assert np.array_equal(base, out)
    assert len(p._segments) == 1
    # each run: 4 gulps and the prewarm through K1
    assert n_off == 5 and len(calls) == 10


def test_force_mode_raises_without_a_fusable_chain():
    with pytest.raises(bseg.SegmentPlanError, match='host'):
        with bt.Pipeline(segments='force') as p:
            b = bt.blocks.copy(Source(voltages(1), spec_header()),
                               space='cuda')
            b = bt.blocks.fft(b, axes='fine_time', axis_labels='freq')
            Gather(bt.blocks.copy(b, space='system'))
        run_bounded(p)


def test_force_mode_runs_when_a_segment_forms():
    base, _, _ = run_chain(None)
    out, p, _ = run_chain('force')
    assert np.array_equal(base, out)
    assert len(p._segments) == 1


def test_env_var_turns_the_compiler_on(monkeypatch):
    assert bseg.resolve_mode(None) == jseg.resolve_mode(None) == 'off'
    for val, want in (('1', 'auto'), ('auto', 'auto'), ('force', 'force'),
                      ('0', 'off'), ('junk', 'off')):
        monkeypatch.setenv('BF_SEGMENTS', val)
        assert bseg.resolve_mode(None) == jseg.resolve_mode(None) == want
    monkeypatch.setenv('BF_SEGMENTS', 'auto')
    out, p, _ = run_chain(None)
    assert len(p._segments) == 1
    assert bseg.MODES == jseg.MODES and bseg.REASONS == jseg.REASONS


# ---------------------------------------------------------------------------
# boundaries that do not fuse: the JAX planner's reasons, and the bytes
# ---------------------------------------------------------------------------

class _OverlapDetect(_StageBlock):
    """An eligible stage block declaring overlap its stage does not
    derive: no segment may take it."""

    def __init__(self, iring, **kwargs):
        super(_OverlapDetect, self).__init__(
            iring, DetectStage('stokes', axis='pol'), **kwargs)

    def define_input_overlap_nframe(self, iseq):
        return 4


class _JOverlapDetect(_JStageBlock):
    def __init__(self, iring, **kwargs):
        super(_JOverlapDetect, self).__init__(
            iring, JDetect('stokes', axis='pol'), **kwargs)

    def define_input_overlap_nframe(self, iseq):
        return 4


_JOverlapDetect.__name__ = '_OverlapDetect'


def both_plans(mutate, mode=None):
    """Build source -> copy(device) -> mutate(...) -> copy(system) ->
    sink in both packages (nothing runs); return both planners' reason
    sets."""
    out = []
    for pkg, planner, space in ((bt, bseg, 'cuda'), (bf, jseg, 'tpu')):
        with pkg.Pipeline() as p:
            if pkg is bt:
                s = Source(voltages(1), spec_header())
            else:
                s = NumpySourceBlock([as_ci8(voltages(1)[0])],
                                     spec_header(), gulp_nframe=NT)
            b = pkg.blocks.copy(s, space=space)
            tail = mutate(pkg, b)
            (Gather if pkg is bt else GatherSink)(
                pkg.blocks.copy(tail, space='system'))
        out.append(reasons(planner, p, mode))
    return out


def _fft(pkg, b, **kw):
    return pkg.blocks.fft(b, axes='fine_time', axis_labels='freq', **kw)


def _detect(pkg, b, **kw):
    return pkg.blocks.detect(b, mode='stokes', axis='pol', **kw)


@pytest.mark.parametrize('case', [
    'host', 'overlap', 'tunables', 'supervision', 'unguaranteed',
    'multi_reader', 'tap', 'mesh_reshard', 'auto'])
def test_boundary_reasons_equal_jax(case):
    """Each topology of tests/test_segments.py's boundary tests gives the
    same (producer type, reason) set in both planners."""
    def mutate(pkg, b):
        if case == 'host':
            return _detect(pkg, _fft(pkg, b))
        if case == 'auto':
            return pkg.blocks.reduce(_detect(pkg, _fft(pkg, b)), 'freq', RF)
        if case == 'overlap':
            cls = _OverlapDetect if pkg is bt else _JOverlapDetect
            return cls(_fft(pkg, b))
        if case == 'tunables':
            return _detect(pkg, _fft(pkg, b, core=0), core=1)
        if case == 'supervision':
            return _detect(pkg, _fft(pkg, b), on_failure='restart')
        if case == 'unguaranteed':
            return _detect(pkg, _fft(pkg, b), guarantee=False)
        if case == 'multi_reader':
            f = _fft(pkg, b)
            (Gather if pkg is bt else GatherSink)(
                pkg.blocks.copy(f, space='system'))
            return pkg.blocks.reduce(_detect(pkg, f), 'freq', RF)
        if case == 'tap':
            f = pkg.views.rename_axis(_fft(pkg, b), 'freq', 'chan')
            return pkg.blocks.reduce(_detect(pkg, f), 'chan', RF)
        if case == 'mesh_reshard':
            if pkg is bt:
                from bifrost_tpu_torch.parallel import create_mesh
            else:
                from bifrost_tpu.parallel import create_mesh
            with pkg.block_scope(mesh=create_mesh({'sp': 2})):
                f = _fft(pkg, b)
            return _detect(pkg, f)
    mode = 'auto' if case in ('auto', 'multi_reader', 'tap') else None
    port, jax = both_plans(mutate, mode)
    assert port == jax
    want = {'host': ('FftBlock', 'disabled'),
            'overlap': ('FftBlock', 'overlap'),
            'tunables': ('FftBlock', 'tunables'),
            'supervision': ('FftBlock', 'supervision'),
            'unguaranteed': ('FftBlock', 'unguaranteed'),
            'multi_reader': ('FftBlock', 'multi_reader'),
            'tap': ('FftBlock', 'tap'),
            'mesh_reshard': ('FftBlock', 'mesh_reshard'),
            'auto': ('CopyBlock', 'host')}[case]
    assert want in port


def test_boundary_bridge_endpoint_equals_jax():
    """tests/test_segments.py:250: a source read by a bridge sink stops
    at a 'bridge' boundary in both planners; so does a bridge source's
    output."""
    out = []
    for pkg, planner, src_cls in ((bt, bseg, Source),
                                  (bf, jseg, NumpySourceBlock)):
        with pkg.Pipeline() as p:
            if pkg is bt:
                s = src_cls(voltages(1), spec_header())
            else:
                s = src_cls([as_ci8(voltages(1)[0])], spec_header(),
                            gulp_nframe=NT)
            pkg.blocks.bridge_sink(s, '127.0.0.1', 1)
        with pkg.Pipeline() as p2:
            b = pkg.blocks.bridge_source('127.0.0.1', 0)
            (Gather if pkg is bt else GatherSink)(b)
        b.listener.close()
        out.append(({r for _t, r in reasons(planner, p)},
                    reasons(planner, p2)))
    (port, port2), (jax, jax2) = out
    assert port == jax == {'bridge'}
    assert port2 == jax2 == {('BridgeSource', 'bridge')}


def test_boundary_multi_reader_fuses_the_safe_subchain():
    base, _, _ = run_chain(None)
    counters.reset()
    with bt.Pipeline(segments='auto', sync_depth=4) as p:
        b = bt.blocks.copy(Source(voltages(6), spec_header()),
                           space='cuda')
        f = bt.blocks.fft(b, axes='fine_time', axis_labels='freq')
        d = bt.blocks.detect(f, mode='stokes', axis='pol')
        r = bt.blocks.reduce(d, 'freq', RF)
        sink = Gather(bt.blocks.copy(r, space='system'))
        tap = Gather(bt.blocks.copy(f, space='system'))
        run_bounded(p)
    assert np.array_equal(base, sink.result())
    assert counters.get('segment.compiled') == 1
    assert counters.get('segment.elided_rings') == 1
    assert len(p._segments[0]._members) == 2
    assert len(tap.gulps) == 6


def test_boundary_tap_via_ring_view_fuses_behind_it():
    base, _, _ = run_chain(None)
    counters.reset()
    with bt.Pipeline(segments='auto', sync_depth=4) as p:
        b = bt.blocks.copy(Source(voltages(6), spec_header()),
                           space='cuda')
        f = bt.blocks.fft(b, axes='fine_time', axis_labels='freq')
        tap = bt.views.rename_axis(f, 'freq', 'chan')
        d = bt.blocks.detect(tap, mode='stokes', axis='pol')
        r = bt.blocks.reduce(d, 'chan', RF)
        sink = Gather(bt.blocks.copy(r, space='system'))
        run_bounded(p)
    assert np.array_equal(base, sink.result())
    assert counters.get('segment.compiled') == 1


# ---------------------------------------------------------------------------
# the halo carry through fdmt_stage -> matched_filter -> threshold
# ---------------------------------------------------------------------------

def test_halo_carry_fuses_overlap_chain_byte_identical():
    """The FRB chain fuses with its overlaps carried in the call: the
    unfused bytes, one segment of three, both interior rings untouched,
    one carried boundary counted; within the gate of the JAX chain."""
    base, _, snap0 = run_dm()
    assert snap0.get('segment.overlap_carried', 0) == 0
    out, p, snap = run_dm('force')
    assert np.array_equal(base, out)
    assert rel(out, jax_dm()) < GATE
    seg = p._segments[0]
    assert [type_name(m) for m in seg._members] == \
        ['FdmtStageBlock', 'MatchedFilterBlock', 'ThresholdBlock']
    assert snap['segment.overlap_carried'] == 1
    assert snap['segment.compiled'] == 1
    assert snap['segment.elided_rings'] == 2
    assert elided_untouched(seg)
    for m in seg._members:
        assert ('block.%s.dispatches' % m) not in snap


def test_halo_carry_macro_gulp_byte_identical():
    base, _, _ = run_dm()
    out, _, snap = run_dm('force', gulp_batch=4)
    assert np.array_equal(base, out)
    assert snap['segment.overlap_carried'] == 1
    assert snap['segment.dispatches'] == 2
    assert snap['segment.gulps'] == 8


def test_boundary_overlap_carried_reason_equals_jax():
    """'overlap_carried' (a fusing record) for the FRB chain's derivable
    overlap, in both planners."""
    def mutate(pkg, b):
        # the planner reads the topology only: no sequence flows
        b = pkg.blocks.fdmt_stage(b, max_delay=MD_DM)
        return pkg.blocks.matched_filter(b, NTAP_DM)
    out = both_plans(mutate, 'auto')
    assert out[0] == out[1]
    assert ('FdmtStageBlock', 'overlap_carried') in out[0]
    assert ('FdmtStageBlock', 'overlap') not in out[0]


# ---------------------------------------------------------------------------
# split and re-fuse (the auto-tuner's knob)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('sizes,n', [([1, 1, 1], 0), ([1, 1, 1], 1),
                                     ([1, 1, 1], 2), ([3, 1], 1),
                                     ([2, 1, 2], 5)])
def test_split_ranges_equal_jax(sizes, n):
    assert split_ranges(sizes, n) == jmacro.split_ranges(sizes, n)


@pytest.mark.parametrize('split,k,expected_disp', [(1, 1, 16), (2, 4, 6)])
def test_split_execution_byte_identical(split, k, expected_disp):
    base, _, _ = run_chain(None, ngulp=8)
    out, p, snap = run_chain('auto', gulp_batch=k, ngulp=8, split=split)
    assert np.array_equal(base, out)
    seg = p._segments[0]
    assert seg._splits_active == split
    assert snap['segment.dispatches'] == expected_disp
    assert snap['block.%s.dispatches' % seg.name] == expected_disp
    assert elided_untouched(seg)


def test_retune_split_clamps_and_applies_next_sequence():
    _, p, _ = run_chain('auto')
    seg = p._segments[0]
    assert bseg.retune_split(seg, 99) == 2
    assert bseg.retune_split(seg, -1) == 0
    assert bseg.retune_split(seg, 1) == 1
    assert seg._splits_active == 0
    assert seg._resolve_splits() == 1


# ---------------------------------------------------------------------------
# the members' telemetry
# ---------------------------------------------------------------------------

def test_synthesized_member_spans(monkeypatch, tmp_path):
    from bifrost_tpu_torch.telemetry import spans
    monkeypatch.setenv('BF_TRACE_FILE', str(tmp_path / 'trace.json'))
    try:
        _, p, _ = run_chain('auto')
        seg = p._segments[0]
        synth = [ev for _t, ev in spans.events()
                 if isinstance(ev[4], dict) and ev[4].get('synthesized')]
        assert {ev[0] for ev in synth} == \
            {'%s.on_data' % m for m in seg._members}
        assert all(ev[4]['segment'] == seg.name for ev in synth)
    finally:
        monkeypatch.delenv('BF_TRACE_FILE')
        spans.reset()
        spans.reconfigure()


def test_member_perf_proclogs_publish():
    _, p, _ = run_chain('auto', gulp_batch=4, ngulp=8)
    seg = p._segments[0]
    for name, log in seg._member_proclogs:
        with open(log.path) as f:
            perf = dict(line.split(' : ', 1) for line in
                        f.read().splitlines())
        assert perf['in_segment'] == seg.name
        assert float(perf['gulps_per_dispatch']) == 4.0


def test_root_retunes_reach_the_segment():
    """Only the head's own pins are carried: a later retune of the
    pipeline's sync_depth and gulp_batch still reaches the segment."""
    from bifrost_tpu_torch.macro import resolve_gulp_batch
    from bifrost_tpu_torch.pipeline import resolve_sync_depth
    _, p, _ = run_chain('auto')
    seg = p._segments[0]
    assert seg.__dict__.get('_sync_depth') is None
    assert resolve_sync_depth(seg) == 4
    p._sync_depth = 9
    assert resolve_sync_depth(seg) == 9
    p._gulp_batch = 8
    assert resolve_gulp_batch(seg) == 8


# ---------------------------------------------------------------------------
# the FX correlator chain (tests/test_correlate.py:198-206)
# ---------------------------------------------------------------------------

CNT, CNW, CNS, CNP, CR, CA = 16, 16, 4, 2, 4, 2


def fx_volts(ngulp, seed=3):
    rng = np.random.RandomState(seed)
    return [rng.randint(-64, 64, (CNT, CNW, CNS, CNP, 2)).astype(np.int8)
            for _ in range(ngulp)]


def fx_header():
    return simple_header([-1, CNW, CNS, CNP], 'ci8',
                         labels=['time', 'fine', 'station', 'pol'])


def run_fx(pkg, gulp_batch=1, segments=None):
    space = 'cuda' if pkg is bt else 'tpu'
    with pkg.Pipeline(gulp_batch=gulp_batch, segments=segments,
                      sync_depth=4) as p:
        if pkg is bt:
            src = Source(fx_volts(4), fx_header())
        else:
            src = NumpySourceBlock([as_ci8(g) for g in fx_volts(4)],
                                   fx_header(), gulp_nframe=CNT)
        b = pkg.blocks.copy(src, space=space)
        b = pkg.blocks.fft(b, axes='fine', axis_labels='freq')
        b = pkg.blocks.quantize(b, 'ci8', scale=1. / CNW)
        b = pkg.blocks.correlate(b, CR, accuracy='int8', fusable=True)
        b = pkg.blocks.accumulate(b, CA, fusable=True)
        sink = (Gather if pkg is bt else GatherSink)(
            pkg.blocks.copy(b, space='system'))
        run_bounded(p)
    return sink.result(), p


@pytest.mark.parametrize('arm', ['macro', 'segments', 'both'])
def test_correlator_chain_equals_jax_under_macro_and_segments(arm):
    want, _ = run_fx(bf, 1, 'off')
    k = 1 if arm == 'segments' else 4
    seg = 'off' if arm == 'macro' else 'force'
    got, p = run_fx(bt, k, seg)
    np.testing.assert_array_equal(got, want)
    assert len(p._segments) == (0 if arm == 'macro' else 1)
