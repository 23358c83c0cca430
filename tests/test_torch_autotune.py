"""The port's closed-loop auto-tuner (``bifrost_tpu_torch.autotune``) and
``Pipeline.run(autotune=...)`` against the JAX package's
(``bifrost_tpu.autotune``).

- The JAX package's own auto-tuner tests (``tests/test_autotune.py``)
  run against the port's modules (:func:`rehome`), but for its ``mprobe``
  cases (the JAX kernel-race cache, not the tuner).
- One scripted sequence of snapshots and objectives goes through each
  knob's ``tick`` in both packages: the knob-value traces and the
  ``autotune.retunes`` / ``.reverts`` / ``.rejected`` counts are equal.
- ``topology_signature`` is equal for the same topology built in both
  packages; a profile dumped by either package, applied to the other's
  pipeline, sets the same knobs.
- The verifier gate refuses the same BF-E101 steps in both packages.
- A real CPU pipeline under ``autotune=True`` retunes its ``gulp_batch``
  and writes the same bytes as an untuned run.

Tolerance: exact everywhere (decisions, counters, profiles, bytes).  No
test depends on wall-clock timing except the end-to-end run, which waits
for a retune that the controller makes on its own ticks, bounded.
"""

import inspect
import json
import time
import types

import numpy as np
import pytest

import bifrost_tpu as bf
from bifrost_tpu import autotune as JA
from bifrost_tpu.analysis import verify as jverify
from bifrost_tpu.telemetry import counters as jcounters
from bifrost_tpu.telemetry import histograms as jhistograms
from bifrost_tpu.telemetry import spans as jspans

import bifrost_tpu_torch as bt
import bifrost_tpu_torch.analysis as TAN
import bifrost_tpu_torch.analysis.verify as tverify
import bifrost_tpu_torch.blocks.bridge as TBB
import bifrost_tpu_torch.macro as TM
import bifrost_tpu_torch.pipeline as TP
import bifrost_tpu_torch.segments as TS
from bifrost_tpu_torch import autotune as TA
from bifrost_tpu_torch import device
from bifrost_tpu_torch.telemetry import counters as tcounters
from bifrost_tpu_torch.telemetry import exporter as texporter
from bifrost_tpu_torch.telemetry import histograms as thistograms
from bifrost_tpu_torch.telemetry import spans as tspans

from tests import test_autotune as JT
from tests.test_torch_bounded import run_bounded
from tests.test_torch_supervision import TorchGatherSink, TorchNumpySourceBlock
from tests.test_torch_wire_formats import rehome
from tests.util import (NumpySourceBlock as JNumpySource,
                        GatherSink as JGatherSink, simple_header)


class NumpySourceBlock(TorchNumpySourceBlock):
    """The port's source of numpy gulps under the JAX class's name (the
    topology signature hashes type names), advertising its header to the
    verifier as the JAX one does."""

    def static_oheaders(self):
        return [dict(self._header)]


class GatherSink(TorchGatherSink):
    """The port's gathering sink under the JAX class's name."""


_util = types.ModuleType('tests.util')
_util.simple_header = simple_header
_util.NumpySourceBlock = NumpySourceBlock
_util.GatherSink = GatherSink

AUTOTUNE_MAP = {'bifrost_tpu': bt,
                'bifrost_tpu.autotune': TA,
                'bifrost_tpu.macro': TM,
                'bifrost_tpu.pipeline': TP,
                'bifrost_tpu.segments': TS,
                'bifrost_tpu.analysis': TAN,
                'bifrost_tpu.analysis.verify': tverify,
                'bifrost_tpu.blocks.bridge': TBB,
                'bifrost_tpu.telemetry': bt.telemetry,
                'bifrost_tpu.telemetry.counters': tcounters,
                'bifrost_tpu.telemetry.histograms': thistograms,
                'bifrost_tpu.telemetry.spans': tspans,
                'bifrost_tpu.telemetry.exporter': texporter,
                'tests.util': _util}

PKGS = {'port': (bt, TA, tverify, tcounters, NumpySourceBlock, GatherSink,
                 'cuda'),
        'jax': (bf, JA, jverify, jcounters, JNumpySource, JGatherSink,
                'tpu')}

NT = 8


@pytest.fixture(autouse=True)
def _clean(monkeypatch, tmp_path):
    device.set_device('cpu')
    monkeypatch.setenv('BF_AUTOTUNE_PROFILE', str(tmp_path / 'profile.json'))
    monkeypatch.setenv('BF_PROCLOG_DIR', str(tmp_path / 'proclog'))
    for mod in (tcounters, jcounters, thistograms, jhistograms, tspans,
                jspans):
        mod.reset()
    yield
    for mod in (tcounters, jcounters, thistograms, jhistograms, tspans,
                jspans):
        mod.reset()


# ---------------------------------------------------------------------------
# the JAX package's auto-tuner tests, on the port
# ---------------------------------------------------------------------------

def _port_segment_pipeline():
    """``tests/test_autotune.py:_segment_pipeline`` with the port's device
    space: source -> copy('cuda') -> fftshift -> fftshift ->
    copy('system') -> sink, compiled into one segment."""
    with bt.Pipeline(segments='auto') as p:
        src = NumpySourceBlock(JT._gulps(), JT._hdr(), gulp_nframe=NT)
        b = bt.blocks.copy(src, space='cuda')
        b = bt.blocks.fftshift(b, 'freq')
        b = bt.blocks.fftshift(b, 'freq')
        GatherSink(bt.blocks.copy(b, space='system'))
    segs = TS.compile_pipeline(p)
    assert len(segs) == 1
    return p, segs[0]


JT_TESTS = sorted(n for n in dir(JT) if n.startswith('test_') and
                  'mprobe' not in n)


@pytest.mark.parametrize('name', JT_TESTS)
def test_jax_autotune_test_on_the_port(name, monkeypatch, tmp_path):
    fn = getattr(JT, name)
    fixtures = {'monkeypatch': monkeypatch, 'tmp_path': tmp_path}
    args = [fixtures[a] for a in inspect.signature(fn).parameters]
    rehome(fn, AUTOTUNE_MAP, _segment_pipeline=_port_segment_pipeline)(
        *args)


def test_rehome_reaches_the_port_tuner():
    """The rehomed tests hold the port's objects: a JAX helper rehomed
    builds a port pipeline."""
    p = rehome(JT._pipeline, AUTOTUNE_MAP)()
    assert isinstance(p, bt.Pipeline)
    assert isinstance(p.blocks[0], NumpySourceBlock)
    assert isinstance(JT._pipeline(), bf.Pipeline)


# ---------------------------------------------------------------------------
# one scripted sequence through both packages' knobs
# ---------------------------------------------------------------------------

def _build(pkg, bridge=False, buffer_nframe=None):
    """source -> copy(device) -> fftshift -> copy('system') -> sink (or
    -> bridge sink) in package ``pkg``; returns (pipeline, last block)."""
    mod, _A, _v, _c, Src, Sink, dev = PKGS[pkg]
    with mod.Pipeline() as p:
        src = Src(JT._gulps(), JT._hdr(), gulp_nframe=NT)
        b = mod.blocks.copy(src, space=dev)
        b = mod.blocks.fftshift(b, 'freq')
        kw = {} if buffer_nframe is None else \
            {'gulp_nframe': 32, 'buffer_nframe': buffer_nframe}
        b = mod.blocks.copy(b, space='system', **kw)
        if bridge:
            last = mod.blocks.bridge_sink(b, '127.0.0.1', 1, window=1,
                                          nstreams=1)
        else:
            last = Sink(b)
    return p, last


def _script(names):
    """(knob prefix, snapshot, objective) steps; ``names`` holds the
    package's live names: the fftshift block, its output ring and the
    bridge sink."""
    blk, ring, sink = names['block'], names['ring'], names['sink']

    def batch(gpd, disp=10.0):
        return {'rates': {'dt': 1.0, 'counters': {
            'block.%s.dispatches' % blk: disp,
            'block.%s.gulps' % blk: disp * gpd}, 'histograms': {}},
            'rings': {}, 'histograms': {}}

    def sync(waits):
        return {'rates': {'dt': 1.0, 'counters': {
            'pipeline.gulps_device': 100.0,
            'pipeline.sync_waits': waits}, 'histograms': {}},
            'rings': {}, 'histograms': {}}

    def fill(f, stall):
        return {'rates': {'dt': 1.0, 'counters': {}, 'histograms': {
            'ring.%s.reserve_s' % ring: {'count_per_s': 50.0,
                                         'sum_per_s': stall}}},
            'rings': {ring: {'fill': f}}, 'histograms': {}}

    def stall(s):
        return {'rates': {'dt': 1.0, 'counters': {}, 'histograms': {
            'bridge.%s.send_stall_s' % sink: {'sum_per_s': s}}},
            'rings': {}, 'histograms': {}}

    steps = []
    # gulp_batch: climbs to 2 and 4 (holding through a lull), then the
    # step to 8 regresses and is reverted
    for obj, gpd in ((100., 1), (100., 1), (100., 1), (130., 2),
                     (130., 2), (130., 2), (0., 4), (None, 4), (170., 4),
                     (170., 8), (170., 8), (90., 8), (90., 8)):
        steps.append(('gulp_batch', batch(gpd), obj))
    # sync_depth: quiet, then hard waits; a gain below min_gain pins it
    for obj, w in ((100., 0.), (100., 9.), (100., 9.), (100., 9.),
                   (101., 9.), (101., 9.)):
        steps.append(('sync_depth', sync(w), obj))
    # ring capacity: pegged and blocked, it grows twice; no gain pins it
    for obj, f, s in ((100., 0.99, 0.01), (100., 0.99, 0.01),
                      (100., 0.99, 0.01), (130., 0.99, 0.01),
                      (130., 0.99, 0.01), (130., 0.99, 0.01),
                      (131., 0.5, 0.0), (131., 0.99, 0.01)):
        steps.append(('ring_bytes.' + ring, fill(f, s), obj))
    # bridge window then stripes: stalls, the window climbs and pins;
    # the extra stripe hurts and is reverted
    for obj in (100., 100., 100., 130., 130., 130., 131., 131.):
        steps.append(('bridge_window.' + sink, stall(0.5), obj))
    for obj in (100., 100., 100., 40., 40.):
        steps.append(('bridge_streams.' + sink, stall(0.5), obj))
    return steps


def _trace(pkg):
    """Run the script through ``pkg``'s tuner; returns the knob values
    after each step and the decision counters."""
    mod, A, _v, counters, _S, _K, _d = PKGS[pkg]
    p, sink = _build(pkg, bridge=True)
    shift = p.blocks[2]
    ring = getattr(shift.orings[0], '_base_ring', shift.orings[0])
    ring.resize(256, 256)            # known starting geometry
    tuner = A.AutoTuner(p, mode='on')
    knobs = {k.name: k for k in tuner.knobs}
    names = {'block': shift.name, 'ring': ring.name, 'sink': sink.name}
    trace = []
    for prefix, snap, obj in _script(names):
        knob = knobs[prefix]
        knob.tick(snap, obj)
        trace.append((prefix.split('.')[0], knob.read(), knob.converged,
                      knob.cooldown))
    snap = counters.snapshot()
    return trace, {k: snap.get('autotune.' + k, 0)
                   for k in ('retunes', 'reverts', 'rejected')}


def test_scripted_knob_traces_equal_jax():
    port, jax = _trace('port'), _trace('jax')
    assert port == jax
    trace, decisions = port
    assert decisions == {'retunes': 11, 'reverts': 2, 'rejected': 0}
    last = {}
    for knob, value, converged, _cd in trace:
        last[knob] = (value, converged)
    ring_bytes, ring_pinned = last.pop('ring_bytes')
    assert ring_bytes >= 1024 and ring_pinned    # two doublings of 256
    assert last == {'gulp_batch': (4, True), 'sync_depth': (8, True),
                    'bridge_window': (4, True), 'bridge_streams': (1, True)}


def test_tuner_constants_and_variables_equal_jax():
    for name in ('DEFAULT_INTERVAL', 'DEFAULT_COOLDOWN', 'DEFAULT_MAX_HOLD',
                 'DEFAULT_MIN_GAIN', 'MAX_GULP_BATCH', 'MAX_SYNC_DEPTH',
                 'MAX_WINDOW', 'MAX_STREAMS', 'MAX_RING_BYTES',
                 'SYNC_WAIT_TRIGGER', 'STALL_FRAC_TRIGGER',
                 'OCCUPANCY_TRIGGER', 'RESERVE_WAIT_TRIGGER'):
        assert getattr(TA, name) == getattr(JA, name), name
    assert TA.__all__ == JA.__all__
    for knob in ('_GulpBatchKnob', '_SyncDepthKnob', '_BridgeWindowKnob',
                 '_BridgeStreamsKnob', '_SegmentSplitKnob',
                 '_RingCapacityKnob'):
        assert getattr(TA, knob).reversible == getattr(JA, knob).reversible


# ---------------------------------------------------------------------------
# topology signatures and profiles across packages
# ---------------------------------------------------------------------------

def _host_chain(pkg):
    mod, _A, _v, _c, Src, Sink, _d = PKGS[pkg]
    with mod.Pipeline() as p:
        src = Src(JT._gulps(), JT._hdr(), gulp_nframe=NT)
        b = mod.blocks.copy(src, space='system')
        Sink(mod.blocks.copy(b, space='system'))
    return p


def test_topology_signature_equal_across_packages():
    port, jax = (TA.topology_signature(_host_chain('port')),
                 JA.topology_signature(_host_chain('jax')))
    assert port[0] == jax[0]
    assert sorted(port[1].values()) == sorted(jax[1].values())
    assert sorted(port[2].values()) == sorted(jax[2].values())
    # the device chain hashes its space: 'cuda' is not 'tpu'
    assert TA.topology_signature(_build('port')[0])[0] != \
        JA.topology_signature(_build('jax')[0])[0]


@pytest.mark.parametrize('src,dst', [('jax', 'port'), ('port', 'jax')])
def test_profile_dumped_by_one_package_applies_in_the_other(
        src, dst, tmp_path, monkeypatch):
    """A freeze profile dumped by ``src``'s tuner, loaded by ``dst``'s
    ``load_profile`` and applied to ``dst``'s pipeline of the same
    topology, sets the same knobs (structural keys: no name matches)."""
    path = tmp_path / ('%s.json' % src)
    monkeypatch.setenv('BF_AUTOTUNE_PROFILE', str(path))
    p = _host_chain(src)
    A = PKGS[src][1]
    tuner = A.AutoTuner(p, mode='freeze')
    knobs = {k.name: k for k in tuner.knobs}
    knobs['gulp_batch'].write(8)
    knobs['sync_depth'].write(6)
    ring = next(k for k in tuner.knobs if k.name.startswith('ring_bytes.'))
    ring.write(1 << 16)
    tuner.stop(wait=False)
    prof = json.loads(path.read_text())
    assert prof['version'] == 2 and prof['knobs']['gulp_batch'] == 8

    q = _host_chain(dst)
    D = PKGS[dst][1]
    loaded = D.load_profile(str(path))
    assert loaded == prof
    applied = D.apply_profile(q, loaded)
    assert applied == prof['knobs']
    assert q.gulp_batch == 8 and q._sync_depth == 6
    _sig, _b, rmap = D.topology_signature(q)
    rings = {r.name: r for b in q.blocks for r in b.orings}
    sizes = {rmap[name]: r.total_span for name, r in rings.items()}
    for key, nbyte in prof['knobs']['ring_total_bytes'].items():
        assert sizes[key] >= nbyte
    # the same profile lands the same values in its own package
    own = _host_chain(src)
    A.apply_profile(own, prof)
    assert (own.gulp_batch, own._sync_depth) == (q.gulp_batch,
                                                 q._sync_depth)


# ---------------------------------------------------------------------------
# the verifier gate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('buffer_nframe', [40, 72, 200])
def test_verifier_gate_refuses_the_same_steps(buffer_nframe):
    """A consumer that pins 32 frames of a ring it sized itself: a macro
    K whose writer span no longer fits beside the pin introduces BF-E101
    in both packages, and both gates refuse the same K."""
    got = {}
    for pkg in ('port', 'jax'):
        _m, A, verify, _c, _S, _K, _d = PKGS[pkg]
        p, _last = _build(pkg, buffer_nframe=buffer_nframe)
        tuner = A.AutoTuner(p, mode='on')
        allows = [tuner._verifier_allows('_gulp_batch', k)
                  for k in (2, 4, 8, 16)]
        codes = []
        for k in (2, 4, 8, 16):
            with verify.scope_overrides({'gulp_batch': k}):
                codes.append(sorted({d.code for d in
                                     verify.verify_pipeline(p)
                                     if d.code.startswith('BF-E')}))
        got[pkg] = (allows, codes)
    assert got['port'] == got['jax']
    allows, codes = got['port']
    assert [not a for a in allows] == [c == ['BF-E101'] for c in codes]
    if buffer_nframe == 40:
        assert not any(allows)


def test_gated_retune_refuses_what_jax_refuses():
    got = {}
    for pkg in ('port', 'jax'):
        _m, A, _v, counters, _S, _K, _d = PKGS[pkg]
        p, _last = _build(pkg, buffer_nframe=40)
        got[pkg] = (A.gated_retune(p, {'gulp_batch': 4}),
                    A.gated_retune(p, {'sync_depth': 3}),
                    p.gulp_batch, p._sync_depth,
                    counters.get('autotune.rejected'),
                    counters.get('autotune.profile_adoptions'))
    assert got['port'] == got['jax'] == (False, True, None, 3, 1, 1)


# ---------------------------------------------------------------------------
# a real pipeline under the controller
# ---------------------------------------------------------------------------

def _run_chain(autotune, ngulp=48):
    gulps = [np.random.RandomState(k).randn(NT, 4).astype(np.float32)
             for k in range(ngulp)]
    with bt.Pipeline() as p:
        src = NumpySourceBlock(gulps, JT._hdr(), gulp_nframe=NT)
        b = bt.blocks.copy(src, space='cuda')
        b = bt.blocks.fftshift(b, 'freq')
        sink = GatherSink(bt.blocks.copy(b, space='system'))
    if autotune is None:
        run_bounded(p)
    else:
        run_bounded(_Tuned(p, autotune))
    return sink.result(), np.concatenate(gulps)


class _Tuned(object):
    """``run_bounded`` calls ``run()``: this one passes ``autotune``."""

    def __init__(self, p, mode):
        self.p, self.mode = p, mode

    def run(self):
        return self.p.run(autotune=self.mode)

    def __getattr__(self, name):
        return getattr(self.p, name)


def test_autotuned_pipeline_retunes_and_writes_the_untuned_bytes(
        monkeypatch):
    """Under ``autotune=True`` the controller ticks and publishes every
    knob's value on its counter; the output equals an untuned run's
    byte for byte, and the fftshift of the input."""
    monkeypatch.setenv('BF_AUTOTUNE_INTERVAL', '0.02')
    monkeypatch.setenv('BF_AUTOTUNE_COOLDOWN', '0')
    plain, data = _run_chain(None)
    tcounters.reset()
    tuned, _ = _run_chain(True, ngulp=48)
    snap = tcounters.snapshot()
    assert snap.get('autotune.ticks', 0) >= 1
    assert 'autotune.gulp_batch' in snap and 'autotune.sync_depth' in snap
    assert tuned.tobytes() == plain.tobytes()
    assert plain.tobytes() == np.fft.fftshift(data, axes=1).tobytes()


def test_autotune_retunes_gulp_batch_on_a_running_pipeline(monkeypatch):
    """The controller's own ticks raise ``gulp_batch`` while the source
    still streams: the source holds its last gulp until the retune has
    been made (at most 30 s), so the test waits on the decision, not on
    a clock."""
    import threading
    monkeypatch.setenv('BF_AUTOTUNE_INTERVAL', '0.02')
    monkeypatch.setenv('BF_AUTOTUNE_COOLDOWN', '0')
    retuned = threading.Event()

    class Waiting(NumpySourceBlock):
        def on_data(self, reader, ospans):
            if reader.pos == len(reader.arrays) - 1:
                deadline = time.monotonic() + 30
                while tcounters.get('autotune.gulp_batch') <= 1 and \
                        time.monotonic() < deadline:
                    time.sleep(0.005)
            if tcounters.get('autotune.gulp_batch') > 1:
                retuned.set()
            return super(Waiting, self).on_data(reader, ospans)

    gulps = [np.full((NT, 4), k, np.float32) for k in range(400)]
    with bt.Pipeline() as p:
        src = Waiting(gulps, JT._hdr(), gulp_nframe=NT)
        b = bt.blocks.fftshift(bt.blocks.copy(src, space='cuda'), 'freq')
        sink = GatherSink(bt.blocks.copy(b, space='system'))
    run_bounded(_Tuned(p, True))
    assert retuned.is_set()
    assert tcounters.get('autotune.retunes') >= 1
    assert TM.resolve_gulp_batch(p) > 1
    np.testing.assert_array_equal(
        sink.result(), np.fft.fftshift(np.concatenate(gulps), axes=1))


def test_tuner_starts_before_the_blocks_and_stops_on_failed_init(
        monkeypatch, tmp_path):
    """A warm-start profile is applied before any block resolves its
    tunables; a failed init stops the controller."""
    path = tmp_path / 'warm.json'
    path.write_text(json.dumps({'version': 2, 'knobs': {'gulp_batch': 4}}))
    monkeypatch.setenv('BF_AUTOTUNE_PROFILE', str(path))
    seen = []

    class Probe(NumpySourceBlock):
        def on_sequence(self, reader, sourcename):
            seen.append(TM.resolve_gulp_batch(self))
            return super(Probe, self).on_sequence(reader, sourcename)

    with bt.Pipeline() as p:
        GatherSink(bt.blocks.copy(Probe(JT._gulps(), JT._hdr(),
                                        gulp_nframe=NT), space='system'))
    run_bounded(_Tuned(p, True))
    assert seen == [4]

    started = []
    real = TA.maybe_start

    def spy(pipeline, arg=None):
        t = real(pipeline, arg)
        started.append(t)
        return t
    monkeypatch.setattr(TA, 'maybe_start', spy)

    class Broken(NumpySourceBlock):
        def on_sequence(self, reader, sourcename):
            raise RuntimeError('init fails')

    with bt.Pipeline() as p:
        GatherSink(Broken(JT._gulps(), JT._hdr(), gulp_nframe=NT))
    with pytest.raises(Exception):
        run_bounded(_Tuned(p, True))
    assert started and started[0] is not None
    started[0].join(5)
    assert not started[0].is_alive()


def test_autotune_off_by_default_on_the_port():
    plain, _ = _run_chain(None, ngulp=4)
    assert plain is not None
    assert 'autotune.ticks' not in tcounters.snapshot()
