"""The port's ring overload policies, counted shedding, deferred resize
and health state machine against the JAX package's
(``tests/test_overload.py:86-272`` and ``:430-572``).  Each case runs the
same reserve and acquire schedule through a port ring and a JAX ring (its
Python core) and holds the shed ledgers, the bytes read and the health
transitions equal.  The BF-E180 verifier cases and the bridge's
shedding (``:274-429``) wait for the port's analysis and I/O tiers, and
the ringcheck case (``:205``) for its ring-protocol checker.
"""

import threading
import time

import numpy as np
import pytest

import bifrost_tpu as bf
import bifrost_tpu.native as native_mod
from bifrost_tpu.ring import Ring as JRing
from bifrost_tpu.ring import EndOfDataStop as JEndOfDataStop
from bifrost_tpu.ring import WouldBlock as JWouldBlock
from bifrost_tpu.telemetry import counters as jcounters
from bifrost_tpu.telemetry import histograms as jhistograms
from bifrost_tpu.telemetry import slo as jslo
from tests.util import NumpySourceBlock, GatherSink, simple_header

import bifrost_tpu_torch as bt
from bifrost_tpu_torch import device
from bifrost_tpu_torch.ring import Ring, EndOfDataStop, WouldBlock
from bifrost_tpu_torch.telemetry import counters, histograms, slo
from tests.test_torch_bounded import join_bounded, run_bounded
from tests.test_torch_supervision import (TorchGatherSink,
                                          TorchNumpySourceBlock)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    device.set_device('cpu')
    # the JAX rings on their Python core, the one the port mirrors
    monkeypatch.setattr(native_mod, '_lib', None)
    monkeypatch.setattr(native_mod, '_tried', True)
    monkeypatch.delenv('BF_SLO_MS', raising=False)
    for c, h, s in ((counters, histograms, slo),
                    (jcounters, jhistograms, jslo)):
        c.reset()
        h.reset()
        s.reset_budget()        # the budget is cached across tests
    yield
    for c, h, s in ((counters, histograms, slo),
                    (jcounters, jhistograms, jslo)):
        c.reset()
        h.reset()
        s.reset_budget()


RINGS = {'port': (Ring, EndOfDataStop, WouldBlock, counters, histograms),
         'jax': (JRing, JEndOfDataStop, JWouldBlock, jcounters,
                 jhistograms)}

FB = 16        # frame bytes of the (-1, 4) f32 test tensor


def _hdr(gulp=2):
    return {'_tensor': {'shape': [-1, 4], 'dtype': 'f32'},
            'gulp_nframe': gulp, 'name': 'seq'}


def _fill_ring(ring, ngulp=8, gulp=2, buf=6, reader=True):
    """Write ``ngulp`` gulps into a ``buf``-frame ring with a registered
    guaranteed reader that never reads; returns the reader."""
    rd = None
    with ring.begin_writing() as w:
        with w.begin_sequence(_hdr(gulp), gulp_nframe=gulp,
                              buf_nframe=buf) as seq:
            if reader:
                rd = ring.open_earliest_sequence(guarantee=True)
            for i in range(ngulp):
                with seq.reserve(gulp) as sp:
                    sp.data.as_numpy()[...] = np.full((gulp, 4), float(i),
                                                      np.float32)
                    sp.commit(gulp)
    return rd


def _audit(rd, eod, gulp=2):
    """A sequential consumer stepping gulp by gulp: (skipped frames,
    first values delivered)."""
    skipped, got, off = 0, [], 0
    while True:
        try:
            with rd.acquire(off, gulp) as isp:
                skipped += isp.nframe_skipped
                if isp.nframe:
                    x = isp.data
                    x = x.as_numpy() if hasattr(x, 'as_numpy') else x
                    got.append(float(x[0, 0]))
                off += gulp
        except eod:
            return skipped, got


def _policy_run(name, policy):
    ring_cls, eod, _wb, c, _h = RINGS[name]
    ring = ring_cls(space='system', name='%s_%s' % (policy, name))
    ring.set_overload_policy(policy)
    rd = _fill_ring(ring)
    skipped, got = _audit(rd, eod)
    rd.close()
    stats = ring.shed_stats()
    assert c.get('ring.%s.shed_bytes' % ring.name) == stats['shed_bytes']
    assert c.get('ring.%s.shed_gulps' % ring.name) == stats['shed_gulps']
    return skipped, got, stats


# ---------------------------------------------------------------------------
# ring overload policies
# ---------------------------------------------------------------------------

def test_drop_oldest_shed_is_byte_accurate():
    """shed_bytes equals the gap a sequential guaranteed reader sees as
    nframe_skipped, and the newest data survives, in both rings."""
    got = {n: _policy_run(n, 'drop_oldest') for n in RINGS}
    assert got['port'] == got['jax']
    skipped, values, stats = got['port']
    assert stats['shed_bytes'] == skipped * FB > 0
    assert stats['shed_gulps'] == skipped // 2
    assert values == [5.0, 6.0, 7.0]


def test_drop_newest_sheds_writer_side():
    """drop_newest refuses the reserve without blocking: the writer's gulp
    lands in scratch, its commit is counted, the oldest data survives."""
    got = {n: _policy_run(n, 'drop_newest') for n in RINGS}
    assert got['port'] == got['jax']
    skipped, values, stats = got['port']
    assert skipped == 0
    assert values == [0.0, 1.0, 2.0]
    assert stats['shed_gulps'] == 5
    assert stats['shed_bytes'] == 5 * 2 * FB


@pytest.mark.parametrize('name', sorted(RINGS))
def test_block_policy_keeps_classic_backpressure(name):
    """The default policy still blocks, and an explicit nonblocking
    reserve raises WouldBlock under every policy."""
    ring_cls, _eod, would_block, _c, _h = RINGS[name]
    for policy in ('block', 'drop_oldest', 'drop_newest'):
        ring = ring_cls(space='system', name='bp_%s_%s' % (name, policy))
        assert ring.overload_policy == 'block'
        ring.set_overload_policy(policy)
        with ring.begin_writing() as w:
            with w.begin_sequence(_hdr(), gulp_nframe=2,
                                  buf_nframe=6) as seq:
                rd = ring.open_earliest_sequence(guarantee=True)
                for i in range(3):
                    with seq.reserve(2) as sp:
                        sp.data.as_numpy()[...] = 0.0
                        sp.commit(2)
                with pytest.raises(would_block):
                    seq.reserve(2, nonblocking=True)
                rd.close()
        assert ring.shed_stats()['shed_bytes'] == 0


@pytest.mark.parametrize('name', sorted(RINGS))
def test_drop_oldest_clamps_at_open_spans(name):
    """A reader holding a span pins the shed floor: the writer blocks
    until the span is released, then sheds past it."""
    ring_cls = RINGS[name][0]
    ring = ring_cls(space='system', name='pin_%s' % name)
    ring.set_overload_policy('drop_oldest')
    done = []
    started = threading.Event()
    pinned = threading.Event()

    def writer():
        with ring.begin_writing() as w:
            with w.begin_sequence(_hdr(), gulp_nframe=2,
                                  buf_nframe=6) as seq:
                with seq.reserve(2) as sp:
                    sp.data.as_numpy()[...] = 0.0
                    sp.commit(2)
                started.set()
                assert pinned.wait(10)
                for i in range(1, 8):
                    with seq.reserve(2) as sp:
                        sp.data.as_numpy()[...] = float(i)
                        sp.commit(2)
                done.append(True)

    t = threading.Thread(target=writer, daemon=True)
    t.start()
    assert started.wait(10)
    rd = ring.open_earliest_sequence(guarantee=True)
    span = rd.acquire(0, 2)
    held = np.array(span.data.as_numpy(), copy=True)
    pinned.set()
    time.sleep(0.3)
    assert not done
    assert np.array_equal(span.data.as_numpy(), held)
    span.release()
    join_bounded(t, 10)
    assert done
    rd.close()
    assert ring.shed_stats()['shed_bytes'] > 0


def test_overload_stamp_on_next_sequence():
    """A new sequence on a drop-policy ring carries the cumulative shed
    ledger in ``_overload``, in both rings."""
    stamps = {}
    for name, (ring_cls, _e, _w, _c, _h) in RINGS.items():
        ring = ring_cls(space='system', name='st_%s' % name)
        ring.set_overload_policy('drop_newest')
        rd = _fill_ring(ring)
        rd.close()
        with ring.begin_writing() as w:
            hdr2 = _hdr()
            hdr2['name'] = 'seq2'
            with w.begin_sequence(hdr2, gulp_nframe=2,
                                  buf_nframe=6) as s2:
                stamps[name] = s2.header.get('_overload')
    assert stamps['port'] == stamps['jax'] == {
        'policy': 'drop_newest', 'shed_gulps': 5, 'shed_bytes': 5 * 2 * FB}


def test_shed_age_slo_histogram():
    """Sheds of a traced stream record the age of the dropped data on
    slo.shed_age_s, and never count SLO violations."""
    from bifrost_tpu.header_standard import ensure_trace_context as jstamp
    from bifrost_tpu_torch.header_standard import ensure_trace_context
    out = {}
    for name, stamp in (('port', ensure_trace_context), ('jax', jstamp)):
        ring_cls, _e, _w, c, h = RINGS[name]
        ring = ring_cls(space='system', name='sa_%s' % name)
        ring.set_overload_policy('drop_newest')
        hdr = _hdr()
        stamp(hdr)
        with ring.begin_writing() as w:
            with w.begin_sequence(hdr, gulp_nframe=2, buf_nframe=6) as seq:
                rd = ring.open_earliest_sequence(guarantee=True)
                for i in range(8):
                    with seq.reserve(2) as sp:
                        sp.data.as_numpy()[...] = 0.0
                        sp.commit(2)
                rd.close()
        hist = h.get('slo.shed_age_s')
        out[name] = (hist.snapshot()['count'] if hist else None,
                     c.get('slo.violations'))
    assert out['port'] == out['jax'] == (5, 0)


def test_invalid_policy_rejected():
    from bifrost_tpu.pipeline import resolve_overload_policy as jresolve
    from bifrost_tpu_torch.pipeline import resolve_overload_policy
    for ring_cls in (Ring, JRing):
        with pytest.raises(ValueError, match='drop_latest'):
            ring_cls(space='system').set_overload_policy('drop_latest')
    for mod, src, resolve in ((bt, TorchNumpySourceBlock,
                               resolve_overload_policy),
                              (bf, NumpySourceBlock, jresolve)):
        with mod.Pipeline(overload_policy='drop_sideways'):
            blk = src([np.zeros((4, 3), np.float32)],
                      simple_header([-1, 3], 'f32'), gulp_nframe=4)
            with pytest.raises(ValueError, match='drop_sideways'):
                resolve(blk)


def test_policy_resolution_scope_and_env(monkeypatch):
    from bifrost_tpu.pipeline import resolve_overload_policy as jresolve
    from bifrost_tpu_torch.pipeline import resolve_overload_policy
    hdr = simple_header([-1, 3], 'f32')
    gulps = [np.zeros((4, 3), np.float32)]
    for mod, src, resolve in ((bt, TorchNumpySourceBlock,
                               resolve_overload_policy),
                              (bf, NumpySourceBlock, jresolve)):
        monkeypatch.setenv('BF_OVERLOAD_POLICY', 'drop_newest')
        with mod.Pipeline():
            env_src = src(gulps, hdr, gulp_nframe=4)
            scoped = src(gulps, hdr, gulp_nframe=4,
                         overload_policy='drop_oldest')
            assert resolve(env_src) == 'drop_newest'
            assert resolve(scoped) == 'drop_oldest'
        monkeypatch.delenv('BF_OVERLOAD_POLICY')
        with mod.Pipeline():
            assert resolve(src(gulps, hdr, gulp_nframe=4)) is None


def test_block_sets_its_output_rings_policy():
    """Block.run puts the block's overload_policy on its output rings,
    as the JAX Block.run does."""
    policies = {}
    for name, mod, src, sink in (('port', bt, TorchNumpySourceBlock,
                                  TorchGatherSink),
                                 ('jax', bf, NumpySourceBlock, GatherSink)):
        with mod.Pipeline() as p:
            s = src([np.zeros((4, 3), np.float32)],
                    simple_header([-1, 3], 'f32'), gulp_nframe=4,
                    overload_policy='drop_newest')
            sink(s)
        run_bounded(p)
        policies[name] = s.orings[0].overload_policy
    assert policies['port'] == policies['jax'] == 'drop_newest'


# ---------------------------------------------------------------------------
# device rings (the port's chunk map; CPU tensors here)
# ---------------------------------------------------------------------------

def _device_fill(policy, ngulp=8, gulp=2, buf=6):
    """``ngulp`` gulps into a ``cuda`` ring on the CPU device with a
    guaranteed reader that never reads; returns (ring, reader, sequence
    writer's scratch tensors seen)."""
    import torch
    ring = Ring(space='cuda', name='dev_%s' % policy)
    ring.set_overload_policy(policy)
    scratch = []
    with ring.begin_writing() as w:
        with w.begin_sequence(_hdr(gulp), gulp_nframe=gulp,
                              buf_nframe=buf) as seq:
            rd = ring.open_earliest_sequence(guarantee=True)
            for i in range(ngulp):
                with seq.reserve(gulp) as sp:
                    if sp._shed:
                        scratch.append(sp.data)
                    sp.set(torch.full((gulp, 4), float(i)))
                    sp.commit(gulp)
    return ring, rd, scratch


def test_drop_oldest_on_a_device_ring_releases_skipped_chunks():
    """On a ``cuda`` ring, drop_oldest gives the same ledger and values as
    the host rings, and the chunk map holds no more than the ring's
    capacity: the shed chunks were released."""
    ring, rd, _ = _device_fill('drop_oldest')
    storage = ring._storage
    held = sum(c[0] for c in storage.chunks.values())
    assert held <= ring.total_span
    skipped, got = _audit(rd, EndOfDataStop)
    rd.close()
    want = _policy_run('jax', 'drop_oldest')
    assert (skipped, got, ring.shed_stats()['shed_bytes']) == \
        (want[0], want[1], want[2]['shed_bytes'])


def test_drop_newest_on_a_device_ring_reuses_one_scratch():
    """drop_newest on a ``cuda`` ring: each shed span's ``.data`` is the
    same scratch tensor of the span's shape (allocated once per shape),
    nothing shed reaches the chunk map, and the ledger equals the host
    ring's."""
    ring, rd, scratch = _device_fill('drop_newest')
    assert len(scratch) == 5
    assert all(t is scratch[0] for t in scratch)
    assert tuple(scratch[0].shape) == (2, 4)
    skipped, got = _audit(rd, EndOfDataStop)
    rd.close()
    want = _policy_run('jax', 'drop_newest')
    assert (skipped, got, ring.shed_stats()) == \
        (want[0], want[1], dict(want[2]))


# ---------------------------------------------------------------------------
# deferred resize
# ---------------------------------------------------------------------------

def test_request_resize_applies_at_quiescence():
    """request_resize applies at once on a quiescent ring, and while a
    span is open it stays pending until the release: the same in both
    rings."""
    trace = {}
    for name, (ring_cls, _e, _w, _c, _h) in RINGS.items():
        ring = ring_cls(space='system', name='rr_%s' % name)
        steps = []
        with ring.begin_writing() as w:
            with w.begin_sequence(_hdr(), gulp_nframe=2,
                                  buf_nframe=6) as seq:
                steps.append(ring.request_resize(2 * FB, 8 * FB))
                steps.append(ring.total_span)
                sp = seq.reserve(2)
                steps.append(ring.request_resize(2 * FB, 16 * FB))
                steps.append((ring.resize_pending, ring.total_span))
                sp.data.as_numpy()[...] = 1.0
                sp.commit(2)
                sp.close()
                steps.append((ring.resize_pending, ring.total_span))
        trace[name] = steps
    assert trace['port'] == trace['jax']
    assert trace['port'] == [True, 8 * FB, False, (True, 8 * FB),
                             (False, 16 * FB)]


# ---------------------------------------------------------------------------
# health state machine
# ---------------------------------------------------------------------------

def _mini_pipeline(mod, src_cls, sink_cls):
    hdr = simple_header([-1, 3], 'f32')
    gulps = [np.zeros((4, 3), np.float32)]
    p = mod.Pipeline()
    with p:
        src = src_cls(gulps, hdr, gulp_nframe=4)
        sink = sink_cls(src)
    return p, src, sink


PIPES = {'port': (bt, TorchNumpySourceBlock, TorchGatherSink, counters),
         'jax': (bf, NumpySourceBlock, GatherSink, jcounters)}


def _supervision(name):
    if name == 'port':
        from bifrost_tpu_torch.supervision import Supervisor, HealthMonitor
    else:
        from bifrost_tpu.supervision import Supervisor, HealthMonitor
    return Supervisor, HealthMonitor


def test_health_monitor_traversal_and_hysteresis(monkeypatch):
    monkeypatch.setenv('BF_HEALTH_HYSTERESIS', '2')
    walks = {}
    for name, (mod, src_cls, sink_cls, c) in PIPES.items():
        Supervisor, HealthMonitor = _supervision(name)
        p, src, sink = _mini_pipeline(mod, src_cls, sink_cls)
        p.supervisor = Supervisor(p)
        mon = HealthMonitor(p.supervisor, 0.0)
        walk = [mon.evaluate()['state']]
        c.inc('ring.%s.shed_gulps' % src.orings[0].name, 3)
        snap = mon.evaluate()
        walk += [snap['state'], snap['blocks'][src.name],
                 src.health_state]
        walk.append(mon.evaluate()['state'])     # one clean tick holds
        snap = mon.evaluate()
        walk += [snap['state'], src.health_state]
        c.inc('slo.violations')
        walk.append(mon.evaluate()['state'])
        p.supervisor.abort_event.set()
        walk.append(mon.evaluate()['state'])
        walk.append([(t['from'], t['to'])
                     for t in mon.snapshot()['transitions']])
        walk.append(c.get('health.transitions'))
        walks[name] = walk
    assert walks['port'] == walks['jax']
    assert walks['port'][:9] == ['OK', 'SHEDDING', 'SHEDDING', 'SHEDDING',
                                 'SHEDDING', 'OK', 'OK', 'DEGRADED',
                                 'FAILED']


def test_health_on_health_hook(monkeypatch):
    monkeypatch.setenv('BF_HEALTH_HYSTERESIS', '1')
    seen = {}
    for name, (mod, src_cls, sink_cls, c) in PIPES.items():
        Supervisor, HealthMonitor = _supervision(name)
        p, src, sink = _mini_pipeline(mod, src_cls, sink_cls)
        calls = []
        src.on_health = lambda state, prev, calls=calls: \
            calls.append((prev, state))
        p.supervisor = Supervisor(p)
        mon = HealthMonitor(p.supervisor, 0.0)
        c.inc('ring.%s.shed_gulps' % src.orings[0].name)
        mon.evaluate()
        mon.evaluate()
        seen[name] = calls
    assert seen['port'] == seen['jax'] == [('OK', 'SHEDDING'),
                                           ('SHEDDING', 'OK')]


def test_pipeline_health_api_without_run():
    for mod, src_cls, sink_cls, _c in PIPES.values():
        p, src, sink = _mini_pipeline(mod, src_cls, sink_cls)
        h = p.health()
        assert h['state'] == 'OK'
        assert set(h['blocks']) == {src.name, sink.name}


def _shedding_run(name):
    """A drop_oldest source twice as fast as an external guaranteed
    reader that copies a span, releases it and idles: the reader's idle
    windows are where the unread backlog is shed.  Returns the ledger,
    the reader's own tally and the health states sampled during the run."""
    mod, src_cls, _sink, _c = PIPES[name]
    eod = RINGS[name][1]
    hdr = simple_header([-1, 3], 'f32')
    hdr['gulp_nframe'] = 4
    ng = 120
    gulps = [np.full((4, 3), float(k), np.float32) for k in range(ng)]
    states, got, skipped = [], [0], [0]
    done = threading.Event()

    class Paced(src_cls):
        def on_data(self, reader, ospans):
            time.sleep(0.01)
            return src_cls.on_data(self, reader, ospans)

    with mod.Pipeline() as p:
        src = Paced(gulps, hdr, gulp_nframe=4,
                    overload_policy='drop_oldest', buffer_factor=2)
        ring = src.orings[0]

        def consume():
            try:
                for seq in ring.read(guarantee=True):
                    offset = 0
                    while True:
                        try:
                            span = seq.acquire(offset, 4)
                        except eod:
                            break
                        skipped[0] += span.frame_offset - offset
                        advanced = span.frame_offset + span.nframe
                        nframe = span.nframe
                        if nframe:
                            got[0] += nframe
                            span.data.as_numpy()
                        span.release()
                        if nframe == 0 and advanced <= offset:
                            break
                        offset = advanced
                        if nframe:
                            time.sleep(0.02)
            except Exception:
                pass
            finally:
                done.set()

        def sample():
            while not done.wait(0.05):
                states.append(p.health()['state'])

        ct = threading.Thread(target=consume, daemon=True)
        st = threading.Thread(target=sample, daemon=True)
        ct.start()
        st.start()
        run_bounded(p)
        join_bounded(ct, 30)
        join_bounded(st, 30)
    return ring.shed_stats(), got[0], skipped[0], states, ng


@pytest.mark.parametrize('name', sorted(PIPES))
def test_health_live_during_shedding_pipeline(name, monkeypatch):
    """End to end: the shedding pipeline's health shows SHEDDING during
    the run, and the ledger is byte-exact: produced == delivered + shed,
    with shed equal to the skips the reader saw."""
    monkeypatch.setenv('BF_HEALTH_INTERVAL', '0.5')
    shed, got, skipped, states, ng = _shedding_run(name)
    assert shed['shed_bytes'] > 0
    assert 'SHEDDING' in states
    assert shed['shed_bytes'] == skipped * 3 * 4
    assert got + skipped == ng * 4


@pytest.mark.parametrize('core', ['native', 'python'])
def test_shed_ledger_equals_the_skipped_frames_after_an_empty_span(
        core, monkeypatch):
    """The drop_oldest ledger in both port cores: a shed that advances
    the guarantee, then an acquire at the older offset (an empty span, its
    frames overwritten), then another shed.  The ledger equals the frames
    the reader skipped and never exceeds the bytes committed; before the
    repair the empty span pulled the guarantee back and the second shed
    counted 8 frames twice."""
    if core == 'python':
        monkeypatch.setenv('BF_NO_NATIVE', '1')
    else:
        monkeypatch.delenv('BF_NO_NATIVE', raising=False)
    ring, eod = Ring(space='system', name='shed_empty_' + core), \
        EndOfDataStop
    ring.set_overload_policy('drop_oldest')
    fb = 16
    hdr = {'name': 's', 'gulp_nframe': 4,
           '_tensor': {'shape': [-1, 4], 'dtype': 'f32'}}
    skipped, off, committed = 0, 0, 0
    with ring.begin_writing() as w:
        with w.begin_sequence(hdr, 4, 12) as seq:
            rd = ring.open_earliest_sequence(guarantee=True)

            def write():
                with seq.reserve(4) as sp:
                    sp.data.as_numpy()[...] = 1.0
                    sp.commit(4)
                return 4 * fb
            for _ in range(6):
                committed += write()
            sp = rd.acquire(off, 4)
            assert sp.nframe == 0 and sp.frame_offset == 4
            skipped += sp.frame_offset - off
            off = sp.frame_offset + sp.nframe
            sp.release()
            committed += write()
            while True:
                try:
                    sp = rd.acquire(off, 4)
                except eod:
                    break
                skipped += sp.frame_offset - off
                off = sp.frame_offset + sp.nframe
                sp.release()
                if off * fb >= committed:
                    break
    shed = ring.shed_stats()['shed_bytes']
    assert shed == skipped * fb
    assert shed <= committed
