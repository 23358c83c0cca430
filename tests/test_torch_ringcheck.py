"""The port's ring-protocol checker (``BF_RINGCHECK``) against the JAX
package's (``tests/test_analysis.py:305-549`` and the ringcheck case of
``tests/test_overload.py``).  Every drill runs on both of the port's
cores -- the native 'system' ring and the Python core -- and on a 'cuda'
ring (the chunk map, on the CPU device here), and each corruption must
raise the invariant that the JAX checker raises for the same corruption
on a JAX ring.
"""

import threading
import time

import numpy as np
import pytest
import torch

import bifrost_tpu as bf
import bifrost_tpu.native as jnative
from bifrost_tpu.analysis import ringcheck as jringcheck
from bifrost_tpu.ring import Ring as JRing, RingPoisonedError as JPoisoned
from bifrost_tpu.testing import faults as jfaults
from tests.util import simple_header

import bifrost_tpu_torch as bt
from bifrost_tpu_torch import device
from bifrost_tpu_torch.analysis import ringcheck
from bifrost_tpu_torch.analysis.ringcheck import RingProtocolError
from bifrost_tpu_torch.ring import Ring, RingPoisonedError
from bifrost_tpu_torch.ring_native import NativeRing
from bifrost_tpu_torch.telemetry import counters
from bifrost_tpu_torch.testing import faults
from tests.test_torch_bounded import join_bounded, run_bounded
from tests.test_torch_supervision import TorchGatherSink, \
    TorchNumpySourceBlock


@pytest.fixture(params=['native', 'python', 'cuda'])
def core(request, monkeypatch):
    """The port's ring under test: 'native' and 'python' are 'system'
    rings on either core, 'cuda' a device ring."""
    device.set_device('cpu')
    if request.param == 'python':
        monkeypatch.setenv('BF_NO_NATIVE', '1')
    else:
        monkeypatch.delenv('BF_NO_NATIVE', raising=False)
    # the JAX rings on their Python core
    monkeypatch.setattr(jnative, '_lib', None)
    monkeypatch.setattr(jnative, '_tried', True)
    return request.param


@pytest.fixture
def checker():
    for rc in (ringcheck, jringcheck):
        rc.set_enabled(True)
        rc.reset()
    yield ringcheck
    for f, rc in ((faults, ringcheck), (jfaults, jringcheck)):
        f.clear()
        rc.set_enabled(False)
        rc.reset()


def _ring(core, name, jax=False):
    if jax:
        return JRing(space='system', name=name)
    ring = Ring(space='cuda' if core == 'cuda' else 'system', name=name)
    assert isinstance(ring, NativeRing) == (core == 'native')
    return ring


def _open_seq(ring, gulp=8, buf=32):
    hdr = simple_header([-1, 4], 'f32')
    wr = ring.begin_writing()
    seq = wr.begin_sequence(hdr, gulp_nframe=gulp, buf_nframe=buf)
    return wr, seq


def _fill(span, val):
    if span.ring.space == 'cuda':
        span.set(torch.full(tuple(span.shape), float(val)))
    elif isinstance(span.data, np.ndarray) and \
            not hasattr(span.data, 'as_numpy'):
        span.data[...] = val
    else:
        span.data.as_numpy()[...] = val


def _drill(core, case):
    """Run one corruption drill on the port (``jax=False``) and on a JAX
    ring; return the invariants raised, in that order."""
    out = []
    for jax in (False, True):
        f = jfaults if jax else faults
        rc = jringcheck if jax else ringcheck
        Err = jringcheck.RingProtocolError if jax else RingProtocolError
        ring = _ring(core, 'rc_%s_%s_%s' % (case, core, jax), jax)
        if case == 'double_commit':
            _wr, seq = _open_seq(ring)
            with f.injected('ring.corrupt.double_commit', match=ring.name):
                span = seq.reserve(8)
                _fill(span, 1.0)
                span.commit(8)
                with pytest.raises(Err) as ei:
                    span.close()
        elif case == 'double_release':
            _wr, seq = _open_seq(ring)
            with seq.reserve(8) as span:
                _fill(span, 2.0)
                span.commit(8)
            rseq = ring.open_earliest_sequence(guarantee=True)
            rspan = rseq.acquire(0, 8)
            with f.injected('ring.corrupt.double_release', match=ring.name):
                with pytest.raises(Err) as ei:
                    rspan.release()
        elif case == 'acquire_uncommitted':
            _wr, seq = _open_seq(ring)
            with seq.reserve(8) as span:
                _fill(span, 3.0)
                span.commit(8)
            rseq = ring.open_earliest_sequence(guarantee=True)
            with f.injected('ring.corrupt.acquire_uncommitted',
                            match=ring.name):
                with pytest.raises(Err) as ei:
                    rseq.acquire(0, 8)
        elif case == 'commit_order':
            _wr, seq = _open_seq(ring, gulp=8, buf=64)
            s1 = seq.reserve(8)
            s2 = seq.reserve(8)
            _fill(s1, 1.0)
            s1.commit(4)
            with pytest.raises(Err) as ei:
                s1.close()
            # a zero commit of the newest span stays legal
            s2.commit(0)
            s2.close()
        elif case == 'guarantee_jump':
            _wr, seq = _open_seq(ring, gulp=8, buf=16)
            for val in (1.0, 2.0):
                with seq.reserve(8) as span:
                    _fill(span, val)
                    span.commit(8)
            rseq = ring.open_earliest_sequence(guarantee=True)
            with f.injected('ring.corrupt.guarantee_jump', match=ring.name):
                rseq.acquire(0, 8)
            with pytest.raises(Err) as ei:
                with seq.reserve(8) as span:
                    span.commit(0)
        elif case == 'resize_under_span':
            _wr, seq = _open_seq(ring)
            span = seq.reserve(8)
            with f.injected('ring.corrupt.resize_under_span',
                            match=ring.name):
                with pytest.raises(Err) as ei:
                    ring.request_resize(1, ring.total_span * 2)
            _fill(span, 1.0)
            span.commit(8)
            span.close()
        assert 'span history' in str(ei.value)
        assert rc.violations()
        out.append(ei.value.invariant)
    return out


@pytest.mark.parametrize('case,invariant', [
    ('double_commit', 'double_commit'),
    ('double_release', 'double_release'),
    ('acquire_uncommitted', 'acquire_uncommitted'),
    ('commit_order', 'commit_order'),
    ('guarantee_jump', 'guarantee_pin'),
    ('resize_under_span', 'resize_quiescence')])
def test_corruption_raises_the_jax_invariant(core, checker, case,
                                             invariant):
    assert _drill(core, case) == [invariant, invariant]
    assert counters.get('ringcheck.violations') >= 1


def _blocked_reader(ring, woke, Poisoned):
    def reader():
        try:
            rseq = ring.open_earliest_sequence(guarantee=True)
            rseq.acquire(0, 8)        # blocks: nothing committed
        except Poisoned:
            woke.append('poisoned')
        except Exception as exc:      # pragma: no cover
            woke.append(repr(exc))
    t = threading.Thread(target=reader, daemon=True)
    t.start()
    return t


def test_poison_wakes_blocked_spans_clean(core, checker):
    ring = _ring(core, 'rc_pw_%s' % core)
    _wr, _seq = _open_seq(ring)
    woke = []
    t = _blocked_reader(ring, woke, RingPoisonedError)
    time.sleep(0.2)
    ring.poison(RuntimeError('test poison'))
    join_bounded(t, 5)
    assert woke == ['poisoned']
    time.sleep(0.4)                   # the wake timer runs
    assert not ringcheck.violations()


def test_poison_nowake_detected(core, checker, monkeypatch):
    """Poison that does not wake: the wake timer flags the blocked
    acquire in both packages."""
    monkeypatch.setenv('BF_RINGCHECK_WAKE_SECS', '0.2')
    got = []
    for jax in (False, True):
        ring = _ring(core, 'rc_pn_%s_%s' % (core, jax), jax)
        _wr, _seq = _open_seq(ring)
        woke = []
        t = _blocked_reader(ring, woke,
                            JPoisoned if jax else RingPoisonedError)
        time.sleep(0.2)
        rc, f = (jringcheck, jfaults) if jax else (ringcheck, faults)
        with f.injected('ring.corrupt.poison_nowake', match=ring.name):
            ring.poison(RuntimeError('test poison'))
        deadline = time.monotonic() + 5
        while not rc.violations() and time.monotonic() < deadline:
            time.sleep(0.05)
        viols = rc.violations()
        assert viols and 'span history' in str(viols[-1])
        got.append(viols[-1].invariant)
        ring._wake_all()              # un-hang the reader
        join_bounded(t, 5)
        assert woke == ['poisoned']
    assert got == ['poison_wake', 'poison_wake']


def test_ringcheck_off_is_inert(core):
    ringcheck.set_enabled(False)
    ring = _ring(core, 'rc_off_%s' % core)
    _wr, seq = _open_seq(ring)
    with seq.reserve(8) as span:
        _fill(span, 1.0)
        span.commit(8)
    rseq = ring.open_earliest_sequence(guarantee=True)
    with rseq.acquire(0, 8):
        pass
    assert '_rc_shadow' not in ring.__dict__


def test_deferred_resize_clean_under_checker(core, checker):
    ring = _ring(core, 'rc_rzok_%s' % core)
    _wr, seq = _open_seq(ring)
    before = ring.total_span
    span = seq.reserve(8)
    assert not ring.request_resize(1, before * 2)
    _fill(span, 1.0)
    span.commit(8)
    span.close()
    assert ring.total_span >= before * 2
    assert not ringcheck.violations()


def test_ringcheck_inside_pipeline(core, checker):
    """A pipeline runs clean under the checker (no false positive from the
    shadow model), with BF_RINGCHECK read at run()."""
    hdr = simple_header([-1, 4], 'f32')
    gulps = [np.full((8, 4), i, np.float32) for i in range(6)]
    with bt.Pipeline() as p:
        src = TorchNumpySourceBlock(gulps, hdr, 8)
        b = bt.blocks.copy(src, space='cuda') if core == 'cuda' else src
        sink = TorchGatherSink(bt.blocks.copy(b, space='system'))
    run_bounded(p)
    np.testing.assert_array_equal(sink.result(), np.concatenate(gulps))
    assert not ringcheck.violations()


def test_drop_oldest_clean_under_ringcheck(core, checker):
    """The overload case (``tests/test_overload.py:186``): the checker
    accepts drop_oldest's forced guarantee advance."""
    ring = _ring(core, 'rc_do_%s' % core)
    ring.set_overload_policy('drop_oldest')
    hdr = {'_tensor': {'shape': [-1, 4], 'dtype': 'f32'},
           'gulp_nframe': 2, 'name': 'seq'}
    with ring.begin_writing() as w:
        with w.begin_sequence(hdr, gulp_nframe=2, buf_nframe=6) as seq:
            rd = ring.open_earliest_sequence(guarantee=True)
            for i in range(8):
                with seq.reserve(2) as sp:
                    _fill(sp, float(i))
                    sp.commit(2)
    from tests.test_torch_overload import _audit
    from bifrost_tpu_torch.ring import EndOfDataStop
    skipped, _got = _audit(rd, EndOfDataStop)
    rd.close()
    assert skipped > 0
    assert ring.shed_stats()['shed_bytes'] == skipped * 16
    assert not ringcheck.violations()
