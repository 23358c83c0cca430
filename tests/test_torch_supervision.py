"""The port's supervision layer against the JAX package's
(``tests/test_supervision.py:96-290`` and ``:472-563``): each drill runs
through both packages' pipelines with the same fault schedule, and the
outcomes must agree: the exception ``run()`` raises, the
``block_failures`` / ``block_restarts`` counters, the kinds of the
recorded :class:`BlockFailure` s, the health state after the run and the
data delivered.  The port runs on the CPU device; its device copies are
``copy('cuda')`` where the JAX chain has ``copy('tpu')``.  The UDP
retry case (``:565``) waits for the port's I/O tier.
"""

import contextlib
import io
import sys
import threading
import time

import numpy as np
import pytest

import bifrost_tpu as bf
from bifrost_tpu.supervision import PipelineRuntimeError as JRuntimeError
from bifrost_tpu.supervision import PipelineStallError as JStallError
from bifrost_tpu.telemetry import counters as jcounters
from bifrost_tpu.telemetry import histograms as jhistograms
from bifrost_tpu.telemetry import slo as jslo
from bifrost_tpu.testing import faults as jfaults
from tests.util import NumpySourceBlock, GatherSink, simple_header

import bifrost_tpu_torch as bt
from bifrost_tpu_torch import device
from bifrost_tpu_torch.supervision import (PipelineRuntimeError,
                                           PipelineStallError, Supervisor,
                                           jittered_backoff)
from bifrost_tpu_torch.telemetry import counters, histograms, slo
from bifrost_tpu_torch.testing import faults
from tests.test_torch_bounded import thread_stacks

#: seconds a drill's run may take before the test fails
DRILL_TIMEOUT = 30.


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    device.set_device('cpu')
    # no health thread: Pipeline.health() after a run then evaluates
    # every signal of the run at once, the same way in both packages
    monkeypatch.setenv('BF_HEALTH_INTERVAL', '0')
    monkeypatch.delenv('BF_SLO_MS', raising=False)
    for f, c, h, s in ((faults, counters, histograms, slo),
                       (jfaults, jcounters, jhistograms, jslo)):
        f.clear()
        c.reset()
        h.reset()
        s.reset_budget()        # the budget is cached across tests
    yield
    for f, s in ((faults, slo), (jfaults, jslo)):
        f.clear()
        s.reset_budget()


def _hdr():
    return simple_header([-1, 3], 'f32')


def _gulps(n=5):
    return [np.full((4, 3), float(k), dtype=np.float32) for k in range(n)]


class _Reader(object):
    def __init__(self, arrays):
        self.arrays = list(arrays)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class TorchNumpySourceBlock(bt.SourceBlock):
    """The port's twin of ``tests.util.NumpySourceBlock`` (its name holds
    ``NumpySourceBlock``, so the same fault ``match`` hits both)."""

    def __init__(self, gulps, header, gulp_nframe, names=('numpy',),
                 **kwargs):
        super(TorchNumpySourceBlock, self).__init__(list(names),
                                                    gulp_nframe, **kwargs)
        self._gulps = gulps
        self._header = header

    def create_reader(self, sourcename):
        return _Reader(self._gulps)

    def on_sequence(self, reader, sourcename):
        reader.pos = 0
        return [dict(self._header)]

    def on_data(self, reader, ospans):
        if reader.pos >= len(reader.arrays):
            return [0]
        arr = reader.arrays[reader.pos]
        reader.pos += 1
        n = min(arr.shape[0], ospans[0].nframe)
        ospans[0].data.as_numpy()[:n] = arr[:n]
        return [n]


class TorchGatherSink(bt.SinkBlock):
    def __init__(self, iring, **kwargs):
        super(TorchGatherSink, self).__init__(iring, **kwargs)
        self.headers = []
        self.gulps = []

    def on_sequence(self, iseq):
        self.headers.append(iseq.header)

    def on_data(self, ispan):
        self.gulps.append(np.array(ispan.data.as_numpy(), copy=True))

    def result(self):
        return np.concatenate(self.gulps) if self.gulps else None


class TorchIdent(bt.TransformBlock):
    """Host pass-through whose name holds ``Ident``."""

    def on_sequence(self, iseq):
        return dict(iseq.header)

    def on_data(self, ispan, ospan):
        ospan.data.as_numpy()[...] = ispan.data.as_numpy()


class JaxIdent(bf.TransformBlock):
    def on_sequence(self, iseq):
        return dict(iseq.header)

    def on_data(self, ispan, ospan):
        ospan.data.as_numpy()[...] = ispan.data.as_numpy()


class _JaxTwoSeq(NumpySourceBlock):
    def __init__(self, *args, **kwargs):
        super(_JaxTwoSeq, self).__init__(*args, **kwargs)
        self.sourcenames = ['seq-a', 'seq-b']


#: per package: the module, its fault harness, counters, histograms, SLO
#: module, source, sink, pass-through, device space and error classes
PKGS = {
    'port': dict(mod=bt, faults=faults, counters=counters,
                 histograms=histograms, slo=slo,
                 source=TorchNumpySourceBlock, sink=TorchGatherSink,
                 ident=TorchIdent, space='cuda',
                 runtime=PipelineRuntimeError, stall=PipelineStallError,
                 two_seq=lambda *a, **k: TorchNumpySourceBlock(
                     *a, names=('seq-a', 'seq-b'), **k)),
    'jax': dict(mod=bf, faults=jfaults, counters=jcounters,
                histograms=jhistograms, slo=jslo, source=NumpySourceBlock,
                sink=GatherSink, ident=JaxIdent, space='tpu',
                runtime=JRuntimeError, stall=JStallError,
                two_seq=_JaxTwoSeq),
}


def _run(pipeline, timeout=DRILL_TIMEOUT, stderr=None):
    """``pipeline.run()`` on a thread, bounded; returns what it raised
    (or None).  On time-out, every thread's stack fails the test."""
    box = []

    def target():
        try:
            with contextlib.redirect_stderr(stderr or io.StringIO()):
                pipeline.run()
            box.append(None)
        except BaseException as exc:
            box.append(exc)

    t = threading.Thread(target=target, daemon=True)
    t.start()
    t.join(timeout)
    if t.is_alive():
        stacks = thread_stacks()
        pipeline.shutdown()
        pytest.fail('Pipeline.run still running after %g s:\n%s'
                    % (timeout, stacks), pytrace=False)
    return box[0]


def _outcome(k, p, exc, sink=None):
    """What a drill left behind, comparable across the packages."""
    c = k['counters']
    kinds = sorted(f.kind for f in getattr(exc, 'failures', []))
    # how many peers a poison cascade records depends on where each
    # thread was when the abort came; that it happened does not
    out = {'exc': None if exc is None else type(exc).__name__,
           'block_failures': c.get('block_failures'),
           'block_restarts': c.get('block_restarts'),
           'kinds': [x for x in kinds if x != 'poisoned'],
           'poisoned': 'poisoned' in kinds,
           'health': p.health()['state']}
    if sink is not None:
        res = sink.result()
        out['delivered'] = None if res is None else res.tobytes()
        out['nseq'] = len(sink.headers)
    return out


def _both(drill):
    """Run ``drill(k)`` for each package and return {name: outcome}."""
    return {name: drill(k) for name, k in PKGS.items()}


# ---------------------------------------------------------------------------
# failure propagation
# ---------------------------------------------------------------------------

#: the ring-core functions a block thread waits in while its ring is full
#: (writer), empty (reader) or has no next sequence yet; both packages'
#: Python and native cores wait inside these
_RING_WAITS = ('_reserve_span', '_reserve_span_shed', '_acquire_span',
               '_open_seq', '_next_seq')


def _blocked_in_ring(thread):
    """Whether ``thread`` is parked in a ring wait: a ring span function
    on its stack whose innermost frame is a condition wait (the Python
    core) or the span function itself (the native core, blocked in C)."""
    frame = sys._current_frames().get(thread.ident)
    if frame is None:
        return False
    inner = frame.f_code.co_name
    while frame is not None:
        if frame.f_code.co_name in _RING_WAITS:
            return inner in ('wait',) + _RING_WAITS
        frame = frame.f_back
    return False


def _fault_once_blocked(exc_class, blocks, timeout=10.0):
    """A fault factory that returns its ``exc_class`` only once every
    block of ``blocks`` is parked in a ring wait, so that the abort finds
    each of them there (a thread between gulps would see the shutdown
    event and leave without a poison record)."""
    def make(site, name):
        deadline = time.monotonic() + timeout
        while not all(_blocked_in_ring(b._thread) for b in blocks):
            if time.monotonic() > deadline:
                raise AssertionError('peers never blocked:\n%s'
                                     % thread_stacks())
            time.sleep(0.001)
        return exc_class('injected fault at %s (%s)' % (site, name))
    return make


def test_abort_midstream_no_hang():
    """A mid-stream exception ends the run within shutdown_timeout and
    raises PipelineRuntimeError with the original traceback."""
    def drill(k):
        with k['mod'].Pipeline() as p:
            p.shutdown_timeout = 2.0
            src = k['source'](_gulps(50), _hdr(), gulp_nframe=4)
            blk = k['ident'](src)
            sink = k['sink'](blk)
            fault = _fault_once_blocked(k['faults'].FaultInjected,
                                        [src, sink])
            with k['faults'].injected('block.on_data', match='Ident',
                                      after=1, exc=fault):
                t0 = time.monotonic()
                exc = _run(p, timeout=20.0)
                elapsed = time.monotonic() - t0
        assert isinstance(exc, k['runtime']), repr(exc)
        assert elapsed < 2.0 + 8.0
        msg = str(exc)
        assert 'FaultInjected' in msg and 'injected fault' in msg
        assert 'Traceback' in msg
        assert 'Ident' in exc.primary.block_name
        assert k['counters'].get('ring_poisoned') > 0
        return _outcome(k, p, exc)
    got = _both(drill)
    assert got['port'] == got['jax']
    assert got['port']['block_failures'] == 1
    assert got['port']['health'] == 'FAILED'


def test_abort_poisons_upstream_source():
    """The failed block's upstream source stops too.  The fault fires
    once the source is blocked on its full ring and the sink on its empty
    one, so each package's run records the poison cascade."""
    def drill(k):
        with k['mod'].Pipeline() as p:
            p.shutdown_timeout = 2.0
            src = k['source'](_gulps(500), _hdr(), gulp_nframe=4)
            sink = k['sink'](k['ident'](src))
            fault = _fault_once_blocked(k['faults'].FaultInjected,
                                        [src, sink])
            with k['faults'].injected('block.on_data', match='Ident',
                                      after=1, exc=fault):
                exc = _run(p, timeout=20.0)
        assert isinstance(exc, k['runtime'])
        assert not any(t.is_alive() for t in p.threads)
        return _outcome(k, p, exc)
    got = _both(drill)
    assert got['port'] == got['jax']
    assert got['port']['poisoned'] is True


def test_restart_source_survives_transient_failures():
    """A restart-policy source survives 3 injected failures with backoff
    and the run completes with every gulp delivered."""
    def drill(k):
        with k['faults'].injected('block.run', match='NumpySourceBlock',
                                  count=3):
            with k['mod'].Pipeline() as p:
                src = k['source'](_gulps(3), _hdr(), gulp_nframe=4,
                                  on_failure='restart', max_restarts=5,
                                  restart_backoff=0.01)
                sink = k['sink'](src)
                exc = _run(p)
        assert exc is None, repr(exc)
        return _outcome(k, p, exc, sink)
    got = _both(drill)
    assert got['port'] == got['jax']
    assert got['port']['block_restarts'] == 3
    assert got['port']['block_failures'] == 3
    assert got['port']['delivered'] == np.concatenate(_gulps(3)).tobytes()
    assert got['port']['health'] == 'DEGRADED'


def test_restart_budget_exhaustion_escalates_to_abort():
    def drill(k):
        with k['faults'].injected('block.run', match='NumpySourceBlock',
                                  count=10):
            with k['mod'].Pipeline() as p:
                p.shutdown_timeout = 2.0
                src = k['source'](_gulps(3), _hdr(), gulp_nframe=4,
                                  on_failure='restart', max_restarts=2,
                                  restart_backoff=0.01)
                k['sink'](src)
                exc = _run(p)
        assert isinstance(exc, (k['runtime'], k['mod'].PipelineInitError))
        return {'exc': type(exc).__name__,
                'block_restarts': k['counters'].get('block_restarts'),
                'block_failures': k['counters'].get('block_failures')}
    got = _both(drill)
    assert got['port'] == got['jax']
    assert got['port']['block_restarts'] == 2


def test_restart_storm_budget_exhaustion_mid_chain(monkeypatch):
    """``test_restart_storm_budget_exhaustion_mid_macro_gulp`` without the
    macro gulps (the port has none yet): BF_RESTART_MAX=2 runs out on the
    third failure of a source feeding a device chain, and the abort is a
    clean poison cascade with exact counters."""
    monkeypatch.setenv('BF_RESTART_MAX', '2')
    nt = 8
    gulps = [np.full((nt, 3), float(k), dtype=np.float32)
             for k in range(16)]
    hdr = _hdr()
    hdr['gulp_nframe'] = nt

    def drill(k):
        with k['mod'].Pipeline() as p:
            p.shutdown_timeout = 5.0
            src = k['source'](gulps, hdr, gulp_nframe=nt,
                              on_failure='restart', restart_backoff=0.01)
            dev = k['mod'].blocks.copy(src, space=k['space'])
            host = k['mod'].blocks.copy(dev, space='system')
            sink = k['sink'](host)
            fault = _fault_once_blocked(k['faults'].FaultInjected,
                                        [dev, host, sink])
            with k['faults'].injected('block.on_data',
                                      match='NumpySourceBlock', count=3,
                                      after=2, exc=fault):
                exc = _run(p)
        assert isinstance(exc, k['runtime']), repr(exc)
        assert k['counters'].get('ring_poisoned') >= 3
        return _outcome(k, p, exc)
    got = _both(drill)
    assert got['port'] == got['jax']
    assert got['port']['block_restarts'] == 2
    assert got['port']['block_failures'] == 3
    assert got['port']['kinds'] == ['error', 'restarted', 'restarted']
    assert got['port']['poisoned']


def test_restart_storm_budget_exhaustion_mid_macro_gulp(monkeypatch):
    """``tests/test_supervision.py:172`` through both packages: the
    restart budget runs out while a K = 4 macro chain consumes the faulted
    source's stream; the abort is a clean poison cascade with the same
    exact counters in both."""
    monkeypatch.setenv('BF_RESTART_MAX', '2')
    nt = 8
    gulps = [np.full((nt, 3), float(k), dtype=np.float32)
             for k in range(16)]
    hdr = _hdr()
    hdr['gulp_nframe'] = nt

    def drill(k):
        with k['mod'].Pipeline(gulp_batch=4) as p:
            p.shutdown_timeout = 5.0
            src = k['source'](gulps, hdr, gulp_nframe=nt,
                              on_failure='restart', restart_backoff=0.01)
            dev = k['mod'].blocks.copy(src, space=k['space'])
            host = k['mod'].blocks.copy(dev, space='system')
            sink = k['sink'](host)
            fault = _fault_once_blocked(k['faults'].FaultInjected,
                                        [dev, host, sink])
            with k['faults'].injected('block.on_data',
                                      match='NumpySourceBlock', count=3,
                                      after=2, exc=fault):
                exc = _run(p)
        assert isinstance(exc, k['runtime']), repr(exc)
        assert k['counters'].get('ring_poisoned') >= 3
        return _outcome(k, p, exc)
    got = _both(drill)
    assert got['port'] == got['jax']
    assert got['port']['block_restarts'] == 2
    assert got['port']['block_failures'] == 3
    assert got['port']['kinds'] == ['error', 'restarted', 'restarted']


def test_skip_sequence_resets_slo_ages():
    """A skip_sequence drain resets the block's commit-age histogram: the
    skipped sequence's stale origin leaves the p99."""
    def drill(k):
        with k['faults'].injected('block.on_data', match='Ident', count=1,
                                  after=2):
            with k['mod'].Pipeline() as p:
                src = k['two_seq'](_gulps(5), _hdr(), gulp_nframe=4)
                blk = k['ident'](src, on_failure='skip_sequence')
                sink = k['sink'](blk)
                exc = _run(p)
        assert exc is None, repr(exc)
        h = k['histograms'].get('slo.%s.commit_age_s' % blk.name)
        assert h is not None
        out = _outcome(k, p, exc, sink)
        out['ages'] = h.snapshot()['count']
        k['slo'].observe_commit('unit_block', 123.0)
        assert k['histograms'].get(
            'slo.unit_block.commit_age_s').snapshot()['count'] == 1
        k['slo'].reset_block_ages('unit_block')
        assert k['histograms'].get(
            'slo.unit_block.commit_age_s').snapshot()['count'] == 0
        return out
    got = _both(drill)
    assert got['port'] == got['jax']
    # seq-a's 2 ages were reset by the skip; seq-b recorded its 5
    assert got['port']['ages'] == 5


def test_skip_sequence_policy_degrades_gracefully():
    """A skip_sequence transform drops the failing sequence and delivers
    the next one whole."""
    def drill(k):
        with k['faults'].injected('block.on_sequence', match='Ident',
                                  count=1, after=1):
            with k['mod'].Pipeline() as p:
                src = k['two_seq'](_gulps(3), _hdr(), gulp_nframe=4)
                blk = k['ident'](src, on_failure='skip_sequence')
                sink = k['sink'](blk)
                exc = _run(p)
        assert exc is None, repr(exc)
        return _outcome(k, p, exc, sink)
    got = _both(drill)
    assert got['port'] == got['jax']
    assert got['port']['nseq'] == 1
    assert got['port']['delivered'] == np.concatenate(_gulps(3)).tobytes()
    assert got['port']['block_failures'] == 1
    assert got['port']['block_restarts'] == 0


def test_unknown_policy_is_rejected():
    """A misspelled policy fails in the launching thread, before any
    block thread starts."""
    for k in PKGS.values():
        with k['mod'].Pipeline() as p:
            k['source'](_gulps(2), _hdr(), gulp_nframe=4,
                        on_failure='retry-plz')
            with pytest.raises(ValueError, match='retry-plz'):
                p.run()
        assert not p.threads


def test_init_failure_still_raises_pipeline_init_error():
    for k in PKGS.values():
        class BadBlock(k['mod'].TransformBlock):
            def on_sequence(self, iseq):
                raise RuntimeError("boom-at-init")

            def on_data(self, ispan, ospan):
                pass

        with k['mod'].Pipeline() as p:
            p.shutdown_timeout = 2.0
            src = k['source'](_gulps(1), _hdr(), gulp_nframe=4)
            BadBlock(src)
            exc = _run(p)
        assert isinstance(exc, k['mod'].PipelineInitError)
        assert 'boom-at-init' in str(exc)


def test_restart_keeps_one_writing_session():
    """A source restarted mid-sequence keeps its writing session open:
    downstream sees no end of data between attempts, and with the same
    schedule both packages deliver the same sequences and bytes."""
    def drill(k):
        with k['faults'].injected('block.on_data', match='NumpySourceBlock',
                                  count=1, after=2):
            with k['mod'].Pipeline() as p:
                src = k['source'](_gulps(4), _hdr(), gulp_nframe=4,
                                  on_failure='restart',
                                  restart_backoff=0.01)
                sink = k['sink'](k['ident'](src))
                exc = _run(p)
        assert exc is None, repr(exc)
        return _outcome(k, p, exc, sink)
    got = _both(drill)
    assert got['port'] == got['jax']
    assert got['port']['block_restarts'] == 1


def test_jittered_backoff_and_supervisor_defaults(monkeypatch):
    """The backoff curve and the BF_RESTART_* defaults equal the JAX
    package's."""
    from bifrost_tpu.supervision import jittered_backoff as jbackoff
    from bifrost_tpu.supervision import Supervisor as JSupervisor
    for attempt in range(8):
        assert jittered_backoff(attempt) == jbackoff(attempt)
        assert jittered_backoff(attempt, base=0.3, cap=2.0) == \
            jbackoff(attempt, base=0.3, cap=2.0)
    monkeypatch.setenv('BF_RESTART_MAX', '7')
    monkeypatch.setenv('BF_RESTART_BACKOFF', '0.25')
    with bt.Pipeline() as p:
        pass
    with bf.Pipeline() as jp:
        pass
    sup, jsup = Supervisor(p), JSupervisor(jp)
    assert (sup.default_max_restarts, sup.default_backoff) == \
        (jsup.default_max_restarts, jsup.default_backoff) == (7, 0.25)


# ---------------------------------------------------------------------------
# watchdog
# ---------------------------------------------------------------------------

def test_watchdog_stall_drill(monkeypatch):
    """A block wedged mid-gulp trips the watchdog: counter, stack and ring
    dump, and with escalation the run raises PipelineStallError."""
    monkeypatch.setenv('BF_WATCHDOG_ESCALATE', '1')

    def drill(k):
        stderr = io.StringIO()
        with k['faults'].injected('block.on_data', match='Ident', count=1,
                                  after=1, delay=3, exc=None):
            with k['mod'].Pipeline(watchdog_secs=0.5) as p:
                p.shutdown_timeout = 1.0
                src = k['source'](_gulps(50), _hdr(), gulp_nframe=4)
                k['sink'](k['ident'](src))
                exc = _run(p, timeout=20.0, stderr=stderr)
        assert isinstance(exc, k['stall']), repr(exc)
        assert isinstance(exc, k['runtime'])
        assert 'no block progressed' in str(exc)
        dump = stderr.getvalue()
        assert 'watchdog' in dump and 'Thread' in dump and 'ring' in dump
        out = _outcome(k, p, exc)
        out['stalls'] = k['counters'].get('watchdog_stalls')
        return out
    got = _both(drill)
    assert got['port'] == got['jax']
    assert got['port']['stalls'] == 1
    assert got['port']['kinds'] == ['stall']


def test_watchdog_quiet_on_healthy_pipeline(monkeypatch):
    monkeypatch.setenv('BF_WATCHDOG_ESCALATE', '1')

    def drill(k):
        with k['mod'].Pipeline(watchdog_secs=5.0) as p:
            src = k['source'](_gulps(5), _hdr(), gulp_nframe=4)
            sink = k['sink'](src)
            exc = _run(p)
        assert exc is None
        out = _outcome(k, p, exc, sink)
        out['stalls'] = k['counters'].get('watchdog_stalls')
        return out
    got = _both(drill)
    assert got['port'] == got['jax']
    assert got['port']['stalls'] == 0
    assert got['port']['health'] == 'OK'


# ---------------------------------------------------------------------------
# fault harness and telemetry surfacing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('pkg', sorted(PKGS))
def test_fault_counts_and_after_are_deterministic(pkg):
    fm = PKGS[pkg]['faults']
    f = fm.inject('unit.test', count=2, after=1)
    fm.fire('unit.test')
    with pytest.raises(fm.FaultInjected):
        fm.fire('unit.test')
    with pytest.raises(fm.FaultInjected):
        fm.fire('unit.test')
    fm.fire('unit.test')
    assert f.fired == 2
    assert fm.fired('unit.test') == 2


@pytest.mark.parametrize('pkg', sorted(PKGS))
def test_fault_match_filters_by_name(pkg):
    fm = PKGS[pkg]['faults']
    fm.inject('unit.site', match='target')
    fm.fire('unit.site', 'other-block')
    with pytest.raises(fm.FaultInjected):
        fm.fire('unit.site', 'my-target-block')


@pytest.mark.parametrize('pkg', sorted(PKGS))
def test_arm_from_env(pkg, monkeypatch):
    fm = PKGS[pkg]['faults']
    monkeypatch.setenv('BF_FAULTS', 'unit.env:blk:2:1:0')
    fm.arm_from_env()
    fm.fire('unit.env', 'blk-0')
    with pytest.raises(fm.FaultInjected):
        fm.fire('unit.env', 'blk-0')


def test_telemetry_flush_surfaces_robustness_counters():
    import bifrost_tpu.telemetry as jtelemetry
    snaps = []
    for tel, c in ((bt.telemetry, counters), (jtelemetry, jcounters)):
        c.inc('block_failures', 2)
        c.inc('ring_poisoned')
        snap = tel.flush()
        assert snap['block_failures'] == 2
        assert snap['ring_poisoned'] == 1
        assert snap.get('watchdog_stalls', 0) == 0
        snaps.append({k: snap.get(k) for k in
                      ('block_failures', 'ring_poisoned', 'watchdog_stalls')})
    assert snaps[0] == snaps[1]


# ---------------------------------------------------------------------------
# device blocks, transfers and the runtime's helpers
# ---------------------------------------------------------------------------

def test_restart_of_a_device_copy_block():
    """The H2D copy block fails at its third gulp and restarts: its
    output sequence ends there (two gulps), and the restarted block reads
    its input again from the oldest sequence still in the ring, which
    holds the whole stream (``buffer_nframe``), so nothing was
    overwritten meanwhile.  Both packages deliver the same sequences and
    bytes with the same counters."""
    def drill(k):
        with k['mod'].Pipeline() as p:
            src = k['source'](_gulps(6), _hdr(), gulp_nframe=4)
            dev = k['mod'].blocks.copy(src, space=k['space'],
                                       on_failure='restart',
                                       restart_backoff=0.01,
                                       buffer_nframe=64)
            sink = k['sink'](k['mod'].blocks.copy(dev, space='system'))
        # the H2D copy alone (the D2H copy is a CopyBlock too)
        with k['faults'].injected('block.on_data', match=dev.name,
                                  count=1, after=2):
            exc = _run(p)
        assert exc is None, repr(exc)
        return _outcome(k, p, exc, sink)
    got = _both(drill)
    assert got['port'] == got['jax']
    assert got['port']['block_restarts'] == 1
    assert got['port']['nseq'] == 2
    g = _gulps(6)
    assert got['port']['delivered'] == np.concatenate(g[:2] + g).tobytes()


def test_abort_leaves_no_transfer_outstanding():
    """A sink that fails while the D2H copy block's fills are pending:
    run() raises, and the transfer engine has nothing outstanding after
    it (fills into the poisoned rings were cancelled or completed)."""
    from bifrost_tpu_torch import xfer
    xfer.reset_engine()

    class Failing(TorchGatherSink):
        def on_data(self, ispan):
            if len(self.gulps) == 2:
                raise RuntimeError('sink failed')
            super(Failing, self).on_data(ispan)

    with bt.Pipeline() as p:
        src = TorchNumpySourceBlock(_gulps(40), _hdr(), gulp_nframe=4)
        dev = bt.blocks.copy(src, space='cuda')
        Failing(bt.blocks.copy(dev, space='system'))
        exc = _run(p)
    assert isinstance(exc, PipelineRuntimeError)
    assert 'sink failed' in str(exc)
    assert xfer.engine().outstanding == 0
    assert not any(t.is_alive() for t in p.threads)


def test_cancel_fills_targets_only_poisoned_rings():
    """TransferEngine.cancel_fills cancels the pending fills of the rings
    the predicate names; nothing lands in their bytes, the others still
    complete, and the engine ends with nothing outstanding."""
    from bifrost_tpu_torch import xfer
    from bifrost_tpu_torch.ring import Ring
    eng = xfer.TransferEngine(depth=16)
    data = np.arange(2 * 8 * 3, dtype=np.float32).reshape(16, 3)
    rings, fills = [], []
    for name in ('dead', 'alive'):
        ring = Ring(space='system', name='cf_%s' % name)
        w = ring.begin_writing()
        seq = w.begin_sequence(_hdr(), 8, 16)
        for g0 in (0, 8):
            dev = eng.to_device(data[g0:g0 + 8])
            with seq.reserve(8) as sp:
                fill = eng.host_fill(dev, 'f32', sp.data.as_numpy())
                sp.set_fill(fill)
                sp.commit(8)
            fills.append(fill)
        rings.append(ring)
    rings[0].poison(RuntimeError('aborted'))
    n = eng.cancel_fills(lambda r: r is not None and r.poisoned)
    assert n == 2 and counters.get('xfer.fills_cancelled') == 2
    assert all(f.done for f in fills[:2])
    assert not np.any(rings[0]._storage.buf)
    eng.drain(block=True)
    assert eng.outstanding == 0
    with rings[1].open_earliest_sequence(guarantee=False) as rs:
        with rs.acquire(0, 16) as span:
            np.testing.assert_array_equal(span.data.as_numpy(), data)


def test_restart_drops_the_failed_attempts_events(monkeypatch):
    """Before a restart the block waits on the newest device event its
    failed attempt left and forgets them all: the new attempt's
    run-ahead queue starts empty."""
    from bifrost_tpu_torch import pipeline as pl
    waited = []
    monkeypatch.setattr(pl.device, 'stream_synchronize',
                        lambda *ev: waited.append(ev))
    with bt.Pipeline():
        src = TorchNumpySourceBlock(_gulps(1), _hdr(), gulp_nframe=4)
    src._pending_events.extend(['ev0', 'ev1', 'ev2'])
    src._drop_pending_events()
    assert waited == [('ev2',)] and not src._pending_events
    src._drop_pending_events()
    assert waited == [('ev2',)]


def test_temp_storage_and_the_share_rule():
    """get_temp_storage: a block's own TempStorage a space, or that of
    the outermost enclosing scope with share_temp_storage; allocate
    keeps an array while its shape and type hold (the JAX rule,
    ``bifrost_tpu/pipeline.py:277-286``)."""
    import torch
    from bifrost_tpu_torch.temp_storage import TempStorage
    with bt.Pipeline() as p:
        a = TorchNumpySourceBlock(_gulps(1), _hdr(), gulp_nframe=4)
        with bt.block_scope(share_temp_storage=True) as shared:
            b = TorchNumpySourceBlock(_gulps(1), _hdr(), gulp_nframe=4)
            with bt.block_scope():
                c = TorchNumpySourceBlock(_gulps(1), _hdr(), gulp_nframe=4)
    ts_a = a.get_temp_storage('system')
    assert isinstance(ts_a, TempStorage)
    assert ts_a is a.get_temp_storage('system')
    assert b.get_temp_storage('system') is c.get_temp_storage('system') \
        is shared._own_temp_storage('system')
    assert ts_a is not b.get_temp_storage('system')
    assert p.get_temp_storage('system') is not ts_a
    x = ts_a.allocate('k', (4, 3), 'f32')
    assert x.shape == (4, 3) and x.as_numpy().dtype == np.float32
    assert ts_a.allocate('k', (4, 3), 'f32') is x
    assert ts_a.allocate('k', (5, 3), 'f32') is not x
    d = a.get_temp_storage('cuda').allocate('v', (2, 3), 'ci8')
    assert isinstance(d, torch.Tensor) and tuple(d.shape) == (2, 3, 2)
    with ts_a.allocate_raw(64) as raw:
        assert raw.shape == (64,)


def test_affinity_pins_the_block_thread():
    """A block's ``core`` tunable pins its thread, and the bind proclog
    records it; the process's own mask is untouched."""
    import os
    from bifrost_tpu_torch import affinity
    cores = affinity.available_cores()
    before = os.sched_getaffinity(0)
    seen = []

    class Probe(TorchGatherSink):
        def on_data(self, ispan):
            seen.append(affinity.get_core())
            super(Probe, self).on_data(ispan)

    with bt.Pipeline() as p:
        src = TorchNumpySourceBlock(_gulps(2), _hdr(), gulp_nframe=4)
        Probe(src, core=cores[-1])
        exc = _run(p)
    assert exc is None
    assert seen == [cores[-1]] * 2
    assert os.sched_getaffinity(0) == before
    assert affinity.spread_cores(3, [4, 5]) == [4, 5, 4]
    assert affinity.partition_cores({'a': 3, 'b': 1}, [0, 1, 2, 3]) == \
        {'a': [0, 1, 2], 'b': [3]}


def test_affinity_matches_jax_and_numa_calls_raise():
    """The core partitioning equals the JAX module's; the NUMA calls
    raise where the binding cannot be made (the JAX module returns
    False or None there)."""
    from bifrost_tpu import affinity as jaff
    from bifrost_tpu_torch import affinity
    for weights, cores in (({'a': 3, 'b': 1, 'c': 2}, list(range(7))),
                           ({'a': 1, 'b': 1, 'c': 1}, [0, 1]),
                           ({'x': 0}, [3, 4])):
        assert affinity.partition_cores(weights, cores) == \
            jaff.partition_cores(weights, cores)
    assert affinity.available_cores() == jaff.available_cores()
    with pytest.raises(OSError):
        affinity.numa_node_of_core(10 ** 6)
    assert jaff.numa_node_of_core(10 ** 6) is None
    with pytest.raises(OSError):
        affinity.bind_memory_to_node(4096, 4096, 10 ** 3)
    assert jaff.bind_memory_to_node(4096, 4096, 10 ** 3) is False
