"""The port's static pipeline verifier against the JAX package's
(``tests/test_analysis.py:54-300``, the BF-E180 and BF-W181 cases of
``tests/test_overload.py:274-429``, the bridge sinks' codes, and the
segment boundaries of ``tests/test_torch_segments.py``).  Each topology is built
in both packages; the diagnostics must carry the same codes on the same
blocks and rings (blocks by their place in the pipeline, rings by the
block and output that write them).
"""

import json

import numpy as np
import pytest

import bifrost_tpu as bf
from bifrost_tpu.analysis import verify as jverify
from bifrost_tpu.stages import (FftStage as JFft, DetectStage as JDetect,
                                ReduceStage as JReduce)
from tests.util import NumpySourceBlock, GatherSink, simple_header

import bifrost_tpu_torch as bt
from bifrost_tpu_torch import device, proclog, xfer
from bifrost_tpu_torch.analysis import verify
from bifrost_tpu_torch.analysis.verify import PipelineValidationError
from bifrost_tpu_torch.stages import FftStage, DetectStage, ReduceStage
from tests.test_torch_bounded import run_bounded
from tests.test_torch_macro import (Source, Gather, as_ci8, fb_header,
                                    F_DM, G_DM)
from tests.test_torch_segments import (_fft, _detect, _OverlapDetect,
                                       _JOverlapDetect, MD_DM, NTAP_DM)
from tests.test_torch_supervision import TorchNumpySourceBlock

NT, NP, NF = 64, 2, 256


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    device.set_device('cpu')
    for var in ('BF_GULP_BATCH', 'BF_DONATE', 'BF_SEGMENTS', 'BF_VALIDATE',
                'BF_LINT', 'BF_LINT_OUT', 'BF_OVERLOAD_POLICY',
                'BF_BEAM_IMPL', 'BF_XCORR_IMPL'):
        monkeypatch.delenv(var, raising=False)
    yield
    xfer.reset_engine()


class StaticSource(Source):
    """The port's source of ci8 gulps, advertising its header statically
    as the JAX tests' ``NumpySourceBlock`` does."""

    def static_oheaders(self):
        return [dict(self._header)]


class StaticNumpySource(TorchNumpySourceBlock):
    def static_oheaders(self):
        return [dict(self._header)]


def _volts(n=1, nf=NF):
    rng = np.random.RandomState(0)
    return [rng.randint(-8, 8, (NT, NP, nf, 2)).astype(np.int8)
            for _ in range(n)]


def _hdr(nf=NF):
    return simple_header([-1, NP, nf], 'ci8',
                         labels=['time', 'pol', 'fine_time'])


def _source(pkg, n=1, nf=NF):
    if pkg is bt:
        return StaticSource(_volts(n, nf), _hdr(nf))
    return NumpySourceBlock([as_ci8(v) for v in _volts(n, nf)], _hdr(nf),
                            gulp_nframe=NT)


def _sink(pkg, b, **kw):
    return (Gather if pkg is bt else GatherSink)(b, **kw)


def _dev(pkg):
    return 'cuda' if pkg is bt else 'tpu'


def _stages(pkg):
    if pkg is bt:
        return FftStage, DetectStage, ReduceStage
    return JFft, JDetect, JReduce


def _norm(p, diags):
    """Diagnostics as sorted (code, block, ring), with blocks named by
    their index in the pipeline and rings by their writer's index and
    output."""
    blocks, rings = {}, {}
    for i, b in enumerate(p.blocks):
        blocks[b.name] = 'b%d' % i
        for j, r in enumerate(getattr(b, 'orings', ()) or ()):
            rings[getattr(r, '_base_ring', r).name] = 'b%d.o%d' % (i, j)
    return sorted((d.code, blocks.get(d.block, d.block),
                   rings.get(d.ring, d.ring)) for d in diags)


def _codes(diags):
    return sorted(d.code for d in diags)


def _both(build):
    """Build the topology in both packages; return [(pipeline, diags)]
    for the port and for JAX, and assert their normalized diagnostics
    equal."""
    out = []
    for pkg in (bt, bf):
        p, extra = build(pkg)
        out.append((p, p.validate(), extra))
    assert _norm(out[0][0], out[0][1]) == _norm(out[1][0], out[1][1])
    return out


# ---------------------------------------------------------------------------
# the seeded misconfigurations of tests/test_analysis.py
# ---------------------------------------------------------------------------

def _chain(pkg, stages_fn, gulp_batch=None, **fused_kw):
    kw = {} if gulp_batch is None else {'gulp_batch': gulp_batch}
    with pkg.Pipeline(**kw) as p:
        b = pkg.blocks.copy(_source(pkg), space=_dev(pkg))
        fb = pkg.blocks.fused(b, stages_fn(*_stages(pkg)), **fused_kw)
        _sink(pkg, pkg.blocks.copy(fb, space='system'))
    return p, fb


def test_clean_chain_validates_clean():
    """The spectrometer chain: no error or warning, and only BF-I190
    infos, as in the JAX package."""
    (p, diags, _), _j = _both(lambda pkg: _chain(
        pkg, lambda F, D, R: [F('fine_time', axis_labels='freq'),
                              D('stokes', axis='pol'), R('freq', 4)]))
    assert [d for d in diags if d.severity != 'info'] == []
    assert {d.code for d in diags} <= {'BF-I190'}


def test_undersized_macro_ring_is_deadlock_error():
    (p, diags, _), _j = _both(lambda pkg: _chain(
        pkg, lambda F, D, R: [F('fine_time', axis_labels='freq')],
        gulp_batch=8, gulp_nframe=4 * NT, buffer_nframe=16 * NT))
    hits = [d for d in diags if d.code == 'BF-E101']
    assert len(hits) == 1 and 'macro K=8' in hits[0].message
    assert hits[0].ring is not None


def test_dtype_contract_break_is_error():
    (p, diags, fb), _j = _both(lambda pkg: _chain(
        pkg, lambda F, D, R: [R('freq', 4)]))
    assert [d.code for d in diags if d.is_error] == ['BF-E121']
    assert fb.name in [d.block for d in diags if d.is_error]


def test_donation_with_multi_reader_is_error():
    def build(pkg):
        F, D, _R = _stages(pkg)
        with pkg.Pipeline() as p:
            b = pkg.blocks.copy(_source(pkg), space=_dev(pkg))
            fb = pkg.blocks.fused(b, [F('fine_time', axis_labels='freq')],
                                  donate=True)
            tap = pkg.blocks.fused(b, [D('stokes', axis='pol')])
            _sink(pkg, pkg.blocks.copy(fb, space='system'))
            _sink(pkg, pkg.blocks.copy(tap, space='system'))
        return p, fb
    (p, diags, fb), _j = _both(build)
    hits = [d for d in diags if d.code == 'BF-E130']
    assert len(hits) == 1 and hits[0].block == fb.name


def test_forced_reshard_mesh_chain_warns():
    """An H2D copy outside the mesh scope feeding a mesh fused block:
    BF-W140 on the port's one-card mesh as on the JAX one-device mesh."""
    def build(pkg):
        if pkg is bt:
            mesh = bt.parallel.Mesh(['cpu'], ('sp',))
        else:
            import jax
            from jax.sharding import Mesh
            mesh = Mesh(np.array(jax.devices()[:1]), ('sp',))
        _F, D, _R = _stages(pkg)
        with pkg.Pipeline() as p:
            b = pkg.blocks.copy(_source(pkg), space=_dev(pkg))
            fb = pkg.blocks.fused(b, [D('stokes', axis='pol')], mesh=mesh)
            _sink(pkg, pkg.blocks.copy(fb, space='system', mesh=mesh))
        return p, fb
    (p, diags, fb), _j = _both(build)
    hits = [d for d in diags if d.code == 'BF-W140']
    assert hits and hits[0].block == fb.name
    assert 'reshard' in hits[0].message


def test_mesh_that_cannot_shard_the_gulp_warns():
    """BF-W141: a 3-rank mesh under a 64-frame gulp."""
    def build(pkg):
        if pkg is bt:
            mesh = bt.parallel.Mesh(['cpu'] * 3, ('sp',))
        else:
            import jax
            from jax.sharding import Mesh
            mesh = Mesh(np.array(jax.devices()[:3]), ('sp',))
        _F, D, _R = _stages(pkg)
        with pkg.Pipeline() as p:
            with pkg.block_scope(mesh=mesh):
                b = pkg.blocks.copy(_source(pkg), space=_dev(pkg))
                fb = pkg.blocks.fused(b, [D('stokes', axis='pol')])
                c = pkg.blocks.copy(fb, space='system')
            _sink(pkg, c)
        return p, fb
    (p, diags, fb), _j = _both(build)
    assert 'BF-W141' in [d.code for d in diags if d.block == fb.name]


def test_covered_declaration_is_not_flagged():
    def build(pkg):
        F, D, _R = _stages(pkg)
        with pkg.Pipeline() as p:
            b = pkg.blocks.copy(_source(pkg), space=_dev(pkg))
            fb1 = pkg.blocks.fused(b, [F('fine_time', axis_labels='freq')],
                                   buffer_nframe=NT)
            fb2 = pkg.blocks.fused(b, [D('scalar')], buffer_nframe=64 * NT)
            _sink(pkg, pkg.blocks.copy(fb1, space='system'))
            _sink(pkg, pkg.blocks.copy(fb2, space='system'))
        return p, None
    (p, diags, _), _j = _both(build)
    assert 'BF-E101' not in _codes(diags)
    assert 'BF-W102' not in _codes(diags)


def test_macro_ineligibility_reported():
    (p, diags, fb), _j = _both(lambda pkg: _chain(
        pkg, lambda F, D, R: [D('stokes', axis='pol')], gulp_batch=8,
        guarantee=False))
    w = [d for d in diags if d.code == 'BF-W160']
    assert len(w) == 1 and w[0].block == fb.name
    assert 'unguaranteed' in w[0].message
    assert any(d.code == 'BF-I161' for d in diags)


@pytest.mark.parametrize('kw,warns', [
    ({'accuracy': 'f32'}, True),
    ({'accuracy': 'int8'}, False),
    ({'accuracy': 'f32', 'impl': 'int8_wide'}, False),
    ({'accuracy': 'int8', 'impl': 'planar_bf16'}, True)])
def test_float_path_on_quantized_ring_warns(kw, warns):
    S, B = 8, 4
    rng = np.random.RandomState(0)
    w = (rng.randn(B, S) + 1j * rng.randn(B, S)).astype(np.complex64)
    hdr = simple_header([-1, NF, S, NP], 'ci8',
                        labels=['time', 'freq', 'station', 'pol'])
    raw = np.zeros((NT, NF, S, NP, 2), np.int8)

    def build(pkg):
        with pkg.Pipeline() as p:
            if pkg is bt:
                src = StaticSource([raw], hdr)
            else:
                src = NumpySourceBlock([as_ci8(raw)], hdr, gulp_nframe=NT)
            b = pkg.blocks.copy(src, space=_dev(pkg))
            b = pkg.blocks.beamform(b, w, **kw)
            _sink(pkg, pkg.blocks.copy(b, space='system'))
        return p, None
    (p, diags, _), _j = _both(build)
    assert ('BF-W170' in _codes(diags)) == warns
    if not warns:
        assert [d for d in diags if d.severity != 'info'] == []


# ---------------------------------------------------------------------------
# bridge sinks: BF-W110, BF-E150, BF-W151, BF-W152, BF-W181
# (tests/test_analysis.py:168-199, tests/test_overload.py:299-313)
# ---------------------------------------------------------------------------

#: case -> (bridge_sink kwargs, macro K of the producing chain, the
#: bridge codes the verifiers must give)
BRIDGE_CASES = {
    'window4': ({'window': 4}, None, []),
    'window0': ({'window': 0}, None, ['BF-E150']),
    'v1_crc_window': ({'protocol': 1, 'crc': True, 'window': 4}, None,
                      ['BF-W151', 'BF-W152']),
    'quota_below_span': ({'quota_bytes_per_s': 8}, None, ['BF-W181']),
    'quota_above_span': ({'quota_bytes_per_s': 1e9}, None, []),
    'window8_behind_macro_writer': ({'window': 8}, 4, ['BF-W110']),
    'window4_behind_macro_writer': ({'window': 4}, 4, []),
}


@pytest.mark.parametrize('case', sorted(BRIDGE_CASES))
def test_bridge_codes_equal_jax(case):
    kw, k, want = BRIDGE_CASES[case]

    def build(pkg):
        with pkg.Pipeline(gulp_batch=k) as p:
            src = _source(pkg)
            if k:
                b = pkg.blocks.copy(src, space=_dev(pkg))
                f = pkg.blocks.fft(b, axes='fine_time', axis_labels='freq')
                src = pkg.blocks.copy(f, space='system')
            pkg.blocks.bridge_sink(src, '127.0.0.1', 59999, **kw)
        return p, None
    (p, diags, _), _j = _both(build)
    bridge = {'BF-W110', 'BF-E150', 'BF-W151', 'BF-W152', 'BF-W181'}
    assert sorted(c for c in _codes(diags) if c in bridge) == want
    assert [d.code for d in diags if d.is_error] == \
        [c for c in want if c.startswith('BF-E')]


def test_codes_equal_the_jax_catalog():
    assert verify.CODES == jverify.CODES
    for code, title in verify.CODES.items():
        assert code.startswith('BF-') and code[3] in 'EWI' and title


@pytest.mark.parametrize('case', ['plain', 'tolerant', 'unguaranteed'])
def test_e180_guaranteed_reader_without_tolerance(case):
    """BF-E180 (``tests/test_overload.py:274``): a drop policy on a ring
    whose guaranteed reader never declared shed tolerance."""
    hdr = simple_header([-1, 3], 'f32')
    gulps = [np.zeros((4, 3), np.float32)]
    kw = {'plain': {}, 'tolerant': {'shed_tolerant': True},
          'unguaranteed': {'guarantee': False}}[case]

    def build(pkg):
        with pkg.Pipeline() as p:
            if pkg is bt:
                src = StaticNumpySource(gulps, hdr, 4,
                                        overload_policy='drop_oldest')
            else:
                src = NumpySourceBlock(gulps, hdr, gulp_nframe=4,
                                       overload_policy='drop_oldest')
            _sink(pkg, src, **kw)
        return p, None
    (p, diags, _), _j = _both(build)
    assert ('BF-E180' in _codes(diags)) == (case == 'plain')


def test_bad_overload_policy_is_e180():
    def build(pkg):
        hdr = simple_header([-1, 3], 'f32')
        gulps = [np.zeros((4, 3), np.float32)]
        with pkg.Pipeline() as p:
            if pkg is bt:
                src = StaticNumpySource(gulps, hdr, 4,
                                        overload_policy='drop_sideways')
            else:
                src = NumpySourceBlock(gulps, hdr, gulp_nframe=4,
                                       overload_policy='drop_sideways')
            _sink(pkg, src)
        return p, src
    (p, diags, src), _j = _both(build)
    assert [d.block for d in diags if d.code == 'BF-E180'] == [src.name]


# ---------------------------------------------------------------------------
# segment boundaries: BF-I190 / BF-I192 from the planner
# ---------------------------------------------------------------------------

SEGMENT_CASES = ['host', 'overlap', 'tunables', 'supervision',
                 'unguaranteed', 'multi_reader', 'tap', 'mesh_reshard',
                 'auto', 'overlap_carried']


def _segment_topology(case):
    def mutate(pkg, b):
        if case == 'host':
            return _detect(pkg, _fft(pkg, b))
        if case == 'auto':
            return pkg.blocks.reduce(_detect(pkg, _fft(pkg, b)), 'freq', 4)
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
            _sink(pkg, pkg.blocks.copy(f, space='system'))
            return pkg.blocks.reduce(_detect(pkg, f), 'freq', 4)
        if case == 'tap':
            f = pkg.views.rename_axis(_fft(pkg, b), 'freq', 'chan')
            return pkg.blocks.reduce(_detect(pkg, f), 'chan', 4)
        if case == 'mesh_reshard':
            if pkg is bt:
                from bifrost_tpu_torch.parallel import create_mesh
            else:
                from bifrost_tpu.parallel import create_mesh
            with pkg.block_scope(mesh=create_mesh({'sp': 2})):
                f = _fft(pkg, b)
            return _detect(pkg, f)
        if case == 'overlap_carried':
            b = pkg.blocks.fdmt_stage(b, max_delay=MD_DM)
            return pkg.blocks.matched_filter(b, NTAP_DM)
    mode = 'auto' if case in ('auto', 'multi_reader', 'tap',
                              'overlap_carried') else None

    def build(pkg):
        with pkg.Pipeline(segments=mode) as p:
            if case == 'overlap_carried':
                # the FRB chain's [freq, time] filterbank (nothing runs)
                gulps = [np.zeros((F_DM, G_DM), np.float32)]
                if pkg is bt:
                    src = StaticNumpySource(gulps, fb_header(), G_DM)
                else:
                    src = NumpySourceBlock(gulps, fb_header(),
                                           gulp_nframe=G_DM)
            else:
                src = _source(pkg, nf=64)
            b = pkg.blocks.copy(src, space=_dev(pkg))
            _sink(pkg, pkg.blocks.copy(mutate(pkg, b), space='system'))
        return p, None
    return build


@pytest.mark.parametrize('case', SEGMENT_CASES)
def test_segment_boundary_codes_equal_jax(case):
    (p, diags, _), _j = _both(_segment_topology(case))
    codes = _codes(diags)
    if case == 'overlap_carried':
        assert 'BF-I192' in codes
    else:
        assert 'BF-I190' in codes
    errs = [c for c in codes if c.startswith('BF-E') or c == 'BF-I199']
    # both verifiers propagate headers along base rings, past a view's
    # header transform: the reduce over the view's renamed axis reads
    # as a contract break in both
    assert errs == (['BF-E121'] if case == 'tap' else [])


# ---------------------------------------------------------------------------
# the run() gate, lint mode, the ProcLog and the sizing floors
# ---------------------------------------------------------------------------

def _bad_macro(pkg, n=1):
    F, _D, _R = _stages(pkg)
    p = pkg.Pipeline(gulp_batch=8)
    with p:
        b = pkg.blocks.copy(_source(pkg, n), space=_dev(pkg))
        fb = pkg.blocks.fused(b, [F('fine_time', axis_labels='freq')],
                              gulp_nframe=4 * NT, buffer_nframe=16 * NT)
        sink = _sink(pkg, pkg.blocks.copy(fb, space='system'))
    return p, sink


def test_validate_strict_refuses_to_run(monkeypatch):
    monkeypatch.setenv('BF_VALIDATE', 'strict')
    p, sink = _bad_macro(bt)
    with pytest.raises(PipelineValidationError) as ei:
        p.run()
    assert 'BF-E101' in str(ei.value)
    assert not sink.gulps


def test_validate_warn_still_runs(monkeypatch, capsys):
    """warn reports the same finding and the pipeline runs (the ring's
    own sizing grows past the bad declaration); off reports nothing."""
    monkeypatch.setenv('BF_VALIDATE', 'warn')
    p, sink = _bad_macro(bt, n=2)
    run_bounded(p)
    assert sink.result().shape[0] == 2 * NT
    assert 'BF-E101' in capsys.readouterr().err
    monkeypatch.setenv('BF_VALIDATE', 'off')
    p, sink = _bad_macro(bt, n=2)
    run_bounded(p)
    assert 'BF-E101' not in capsys.readouterr().err


def test_lint_intercept_builds_without_running(monkeypatch, tmp_path):
    """BF_LINT=1: run() reports and returns; the BF_LINT_OUT record has
    the JAX package's keys and the same normalized diagnostics."""
    recs = {}
    for pkg in (bt, bf):
        out = tmp_path / ('lint_%s.jsonl' % pkg.__name__)
        monkeypatch.setenv('BF_LINT', '1')
        monkeypatch.setenv('BF_LINT_OUT', str(out))
        p, sink = _bad_macro(pkg)
        p.run()
        assert sink.result() is None if pkg is bf else not sink.gulps
        rec = [json.loads(line) for line in out.read_text().splitlines()]
        assert len(rec) == 1 and rec[0]['pipeline'] == p.name
        assert rec[0]['nblocks'] == 5
        recs[pkg] = (p, rec[0])
    port, jax = recs[bt][1], recs[bf][1]
    assert sorted(port) == sorted(jax)
    for d, jd in zip(port['diagnostics'], jax['diagnostics']):
        assert sorted(d) == sorted(jd)

    class _D(object):
        def __init__(self, rec):
            self.code, self.block, self.ring = (rec['code'], rec['block'],
                                                rec['ring'])
    assert _norm(recs[bt][0], [_D(d) for d in port['diagnostics']]) == \
        _norm(recs[bf][0], [_D(d) for d in jax['diagnostics']])


def test_gate_publishes_to_the_proclog(monkeypatch, tmp_path):
    """warn mode publishes the diagnostics to the ``analysis/verify``
    ProcLog, which load_by_pid reads back, and counts them."""
    import os
    from bifrost_tpu_torch.telemetry import counters
    monkeypatch.setenv('BF_PROCLOG_DIR', str(tmp_path))
    counters.reset()
    p, _ = _bad_macro(bt)
    diags = verify.gate_run(p, 'warn')
    logs = proclog.load_by_pid(os.getpid())
    entry = logs['analysis']['verify']
    assert entry['n'] == len(diags) and entry['pipeline'] == p.name
    assert entry['errors'] == 1
    assert json.loads(entry['diag0'])['code'] == diags[0].code
    assert counters.get('analysis.diagnostics.error') == 1


def test_ring_capacity_floors_equal_jax():
    out = []
    for pkg, mod in ((bt, verify), (bf, jverify)):
        p, _ = _bad_macro(pkg)
        names = {}
        for i, b in enumerate(p.blocks):
            for j, r in enumerate(b.orings):
                names[r.name] = 'b%d.o%d' % (i, j)
        out.append({names[k]: v for k, v in
                    mod.ring_capacity_floors(p).items()})
    assert out[0] == out[1]
    assert any(v['writer_span'] == 8 * NT for v in out[0].values())


def test_new_errors_vs_and_report():
    p, _ = _bad_macro(bt)
    diags = p.validate()
    assert verify.new_errors_vs(diags, diags) == []
    assert [d.code for d in verify.new_errors_vs([], diags)] == ['BF-E101']
    assert 'BF-E101 error' in verify.format_report(diags)
    with verify.scope_overrides({'gulp_batch': 1}):
        assert 'BF-E101' not in _codes(p.validate())
    assert 'BF-E101' in _codes(p.validate())
