"""The port's ring bridge (``bifrost_tpu_torch.io.bridge`` and the bridge
blocks) against the JAX package's, over loopback TCP.

- The JAX package's own bridge tests (``tests/test_bridge.py``) run
  against the port's modules (:func:`rehome`).
- Wire parity in one process: a JAX sender into a port receiver and a
  port sender into a JAX receiver, on v1, the naive loop, v2 at window 1
  and 4, two stripes, CRC, macro-gulp frames, strided multi-ringlet
  spans and a partial final gulp; the received bytes and headers are
  equal, and the data frames both senders write for the same ring
  contents are equal byte for byte.
- Resume probes, reconnect and resume, sender death, the counters of
  both packages for the same script, the verifier's bridge codes, the
  segment planner's 'bridge' reason, trace context hops and the
  cross-host SLO age, and the slice's spectrometer chain at small width
  across a bridge.

No test asserts a rate, an interval or an order of stripe arrivals, and
every join, accept and pipeline run is bounded.
"""

import importlib.util
import inspect
import itertools
import json
import os
import re
import socket
import threading
import types

import numpy as np
import pytest

import bifrost_tpu as bf
import bifrost_tpu.header_standard as JH
import bifrost_tpu.io.bridge as JB
import bifrost_tpu.ring as JR
from bifrost_tpu.telemetry import counters as jcounters

import bifrost_tpu_torch as bt
import bifrost_tpu_torch.header_standard as TH
import bifrost_tpu_torch.io.bridge as TB
import bifrost_tpu_torch.io.udp_socket as TU
import bifrost_tpu_torch.ring as TR
from bifrost_tpu_torch import device
from bifrost_tpu_torch.io import sigproc as TIO
from bifrost_tpu_torch.telemetry import counters as tcounters
from bifrost_tpu_torch.testing.faults import LinkCut

from tests import test_bridge as JT
from tests import test_overload as JO
from tests.test_torch_bounded import thread_stacks
from tests.test_torch_supervision import TorchGatherSink, TorchNumpySourceBlock
from tests.test_torch_wire_formats import rehome
from tests.util import (NumpySourceBlock as JNumpySource,
                        GatherSink as JGatherSink, simple_header)

#: seconds a test's threads may take before the test fails
TIMEOUT = 60.

_names = itertools.count()


@pytest.fixture(autouse=True)
def _cpu():
    device.set_device('cpu')


def _name(what):
    return 'tbr-%s-%d-%d' % (what, os.getpid(), next(_names))


def bounded(fn, *args, timeout=TIMEOUT, **kwargs):
    """``fn(*args, **kwargs)`` on a daemon thread, waited for at most
    ``timeout`` seconds; re-raises its exception and fails the test with
    every thread's stack on time-out."""
    box = {}

    def target():
        try:
            box['out'] = fn(*args, **kwargs)
        except BaseException as exc:
            box['exc'] = exc

    t = threading.Thread(target=target, daemon=True)
    t.start()
    t.join(timeout)
    if t.is_alive():
        pytest.fail('still running after %g s; every thread:\n%s'
                    % (timeout, thread_stacks()), pytrace=False)
    if 'exc' in box:
        raise box['exc']
    return box.get('out')


# ---------------------------------------------------------------------------
# the JAX package's bridge tests, on the port
# ---------------------------------------------------------------------------

class StaticNumpySource(TorchNumpySourceBlock):
    """The port's source of numpy gulps, advertising its header to the
    verifier as the JAX tests' ``NumpySourceBlock`` does."""

    def static_oheaders(self):
        return [dict(self._header)]


_util = types.ModuleType('tests.util')
_util.simple_header = simple_header
_util.NumpySourceBlock = StaticNumpySource
_util.GatherSink = TorchGatherSink

BRIDGE_MAP = {'bifrost_tpu': bt,
              'bifrost_tpu.ring': TR,
              'bifrost_tpu.io.bridge': TB,
              'bifrost_tpu.header_standard': TH,
              'bifrost_tpu.telemetry': bt.telemetry,
              'tests.util': _util}

JT_TESTS = sorted(n for n in dir(JT) if n.startswith('test_'))


def presized_ring(space='system', name=None, owner=None):
    """A port ring that holds 1 MiB from the start.  The JAX tests start
    the receiver before the thread that gathers its ring, and a receiver
    ring sized for 3 gulps that no reader holds yet may be lapped by a
    fast sender (their flake under load, ROADMAP queue 3); a ring that
    holds the whole stream takes that race out of the harness."""
    ring = TR.Ring(space=space, name=name, owner=owner)
    ring.resize(1 << 16, 1 << 20)
    return ring


@pytest.mark.parametrize('name', JT_TESTS)
def test_jax_bridge_test_on_the_port(name, request, monkeypatch):
    monkeypatch.delenv('BF_TRACE_FILE', raising=False)
    fn = getattr(JT, name)
    args = [request.getfixturevalue(a)
            for a in inspect.signature(fn).parameters]
    bounded(rehome(fn, BRIDGE_MAP, Ring=presized_ring), *args)


@pytest.mark.parametrize('name', JT_TESTS)
def test_jax_bridge_test_on_the_python_core(name, request, monkeypatch):
    """The same tests with the port's host rings on its Python core."""
    monkeypatch.setenv('BF_NO_NATIVE', '1')
    test_jax_bridge_test_on_the_port(name, request, monkeypatch)


# ---------------------------------------------------------------------------
# wire parity: each package's sender into the other's receiver
# ---------------------------------------------------------------------------

PKG = {'port': (TR, TB), 'jax': (JR, JB)}


def _ci8(shape, seed):
    rng = np.random.RandomState(seed)
    raw = np.zeros(shape, dtype=np.dtype([('re', 'i1'), ('im', 'i1')]))
    raw['re'] = rng.randint(-128, 128, shape)
    raw['im'] = rng.randint(-128, 128, shape)
    return raw


def _f32(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _plain_hdr(name, ncol):
    return lambda s: simple_header([-1, ncol], 'f32', name='%s%d'
                                   % (name, s), gulp_nframe=8)


def _macro_hdr(s):
    return simple_header([-1, 2, 8], 'ci8', labels=['time', 'pol', 'fine'],
                         name='macro%d' % s, gulp_nframe=8)


def _ringlet_hdr(s):
    h = simple_header([3, -1, 4], 'f32', labels=['beam', 'time', 'chan'],
                      name='rl%d' % s, gulp_nframe=8)
    h['time_tag'] = s
    return h


#: case -> (datasets, header of sequence s, gulp, sender kwargs, stripes)
CASES = {
    'v1': ([_f32((24, 6), 1)], _plain_hdr('v1_', 6), 8,
           {'protocol': 1}, 1),
    'naive': ([_f32((24, 6), 2)], _plain_hdr('naive', 6), 8,
              {'naive': True}, 1),
    'w1': ([_f32((32, 5), 3)], _plain_hdr('w1_', 5), 8, {'window': 1}, 1),
    'w4': ([_f32((64, 5), 4)], _plain_hdr('w4_', 5), 8, {'window': 4}, 1),
    'stripes2': ([_f32((64, 7), 5)], _plain_hdr('st', 7), 8,
                 {'window': 4}, 2),
    'crc': ([_f32((32, 6), 6)], _plain_hdr('crc', 6), 8,
            {'window': 2, 'crc': True}, 1),
    'macro': ([_ci8((64, 2, 8), 7)], _macro_hdr, 8,
              {'window': 4, 'gulp_batch': 4}, 1),
    # two sequences of three ringlets, the second of 20 frames: a
    # partial final gulp
    'ringlets': ([_f32((3, 16, 4), 8), _f32((3, 20, 4), 9)], _ringlet_hdr,
                 8, {'window': 3}, 2),
}


def _taxis(hdr):
    return hdr['_tensor']['shape'].index(-1)


def _fill(ring, datasets, hdr_fn, gulp):
    """Write every sequence into ``ring`` (big enough to hold them all)
    and end writing: the sender then reads a stream that is complete."""
    total = sum(d.shape[_taxis(hdr_fn(s))] for s, d in enumerate(datasets))
    with ring.begin_writing() as wr:
        for s, data in enumerate(datasets):
            hdr = hdr_fn(s)
            taxis = _taxis(hdr)
            nframe = data.shape[taxis]
            with wr.begin_sequence(hdr, gulp_nframe=gulp,
                                   buf_nframe=4 * total + gulp) as seq:
                off = 0
                while off < nframe:
                    n = min(gulp, nframe - off)
                    with seq.reserve(n) as span:
                        idx = [slice(None)] * data.ndim
                        idx[taxis] = slice(off, off + n)
                        span.data.as_numpy()[...] = data[tuple(idx)]
                        span.commit(n)
                    off += n


def _gather(ring, gulp):
    """{name: (header, bytes of the stream)} of every sequence in
    ``ring``."""
    got = {}
    for seq in ring.read(guarantee=True):
        hdr = dict(seq.header)
        taxis = _taxis(hdr)
        chunks = [np.array(span.data.as_numpy(), copy=True)
                  for span in seq.read(gulp)]
        got[hdr['name']] = (hdr, np.concatenate(chunks, axis=taxis))
    return got


def _bridge(spkg, rpkg, case, receiver_kw=None, gather_gulp=None):
    """Bridge ``case``'s stream from a ``spkg`` sender to an ``rpkg``
    receiver over loopback; returns what the receiver's ring holds, read
    in ``gather_gulp``-frame spans (the case's gulp by default)."""
    datasets, hdr_fn, gulp, kw, nstreams = CASES[case]
    SR, SB = PKG[spkg]
    RR, RB = PKG[rpkg]
    src = SR.Ring(space='system', name=_name('src'))
    dst = RR.Ring(space='system', name=_name('dst'))
    dst.resize(1 << 16, 1 << 20)     # see presized_ring
    _fill(src, datasets, hdr_fn, gulp)
    lst = RB.BridgeListener('127.0.0.1', 0)
    errors = []

    def send():
        try:
            socks = SB.connect_striped('127.0.0.1', lst.port, nstreams)
            s = SB.RingSender(src, socks, gulp_nframe=gulp, **kw)
            s.run()
            s.close()
        except BaseException as exc:
            errors.append(exc)

    def recv():
        try:
            RB.RingReceiver(lst, dst, **(receiver_kw or {})).run()
        except BaseException as exc:
            errors.append(exc)

    threads = [threading.Thread(target=f, daemon=True) for f in (recv, send)]
    for t in threads:
        t.start()
    try:
        out = bounded(_gather, dst, gather_gulp or gulp)
        for t in threads:
            t.join(TIMEOUT)
            assert not t.is_alive()
    finally:
        lst.close()
    assert not errors, errors
    return out


def _check_delivered(out, case):
    datasets, hdr_fn, _g, _kw, _n = CASES[case]
    assert sorted(out) == sorted(hdr_fn(s)['name']
                                 for s in range(len(datasets)))
    for s, data in enumerate(datasets):
        hdr, got = out[hdr_fn(s)['name']]
        assert hdr == TH.deserialize_header(TH.serialize_header(hdr_fn(s)))
        assert got.shape == data.shape
        assert got.tobytes() == data.tobytes()


@pytest.mark.parametrize('case', sorted(CASES))
def test_jax_sender_into_port_receiver(case):
    out = _bridge('jax', 'port', case)
    _check_delivered(out, case)


@pytest.mark.parametrize('case', sorted(CASES))
def test_port_sender_into_jax_receiver(case):
    out = _bridge('port', 'jax', case)
    _check_delivered(out, case)


# ---------------------------------------------------------------------------
# wire parity: the frames each sender writes, recorded off a socketpair
# ---------------------------------------------------------------------------

_FRAME = TB._FRAME


def _read_frame(sock):
    head = TB._recv_exact(sock, _FRAME.size)
    mtype, length = _FRAME.unpack(head)
    return mtype, head + (TB._recv_exact(sock, length) if length else b'')


def _record(pkg, case):
    """Run ``pkg``'s sender over socketpairs into a recorder that
    answers the handshake and acks every frame as a receiver does;
    returns (handshake payloads, data frames per stripe)."""
    datasets, hdr_fn, gulp, kw, nstreams = CASES[case]
    R, B = PKG[pkg]
    src = R.Ring(space='system', name=_name('rec'))
    _fill(src, datasets, hdr_fn, gulp)
    pairs = [socket.socketpair() for _ in range(nstreams)]
    v2 = kw.get('protocol', 2) >= 2 and not kw.get('naive')
    hellos = [None] * nstreams
    frames = [[] for _ in range(nstreams)]

    def recorder(i, sock):
        try:
            while True:
                mtype, raw = _read_frame(sock)
                if mtype == TB.MSG_HELLO:
                    hellos[i] = TH.deserialize_header(raw[_FRAME.size:])
                    TB._send_msg(sock, TB.MSG_HELLO_ACK, TH.serialize_header(
                        {'version': 2, 'ts_us': 0.0, 'wall_ns': 0}))
                    continue
                frames[i].append(raw)
                if v2:
                    seqno = raw[_FRAME.size:_FRAME.size + TB._SEQNO.size]
                    try:
                        TB._send_msg(sock, TB.MSG_ACK, seqno)
                    except OSError:
                        # another stripe's cumulative ACK already let
                        # the sender hang up: read on to the end
                        pass
                if mtype == TB.MSG_END:
                    return
        except (OSError, ConnectionError):
            return

    threads = [threading.Thread(target=recorder, args=(i, b), daemon=True)
               for i, (_a, b) in enumerate(pairs)]
    for t in threads:
        t.start()
    sender = B.RingSender(src, [a for a, _b in pairs], gulp_nframe=gulp,
                          **kw)
    bounded(sender.run)
    sender.close()
    for t in threads:
        t.join(TIMEOUT)
        assert not t.is_alive()
    for a, b in pairs:
        a.close()
        b.close()
    return hellos, frames


@pytest.mark.parametrize('case', sorted(CASES))
def test_data_frames_equal_across_packages(case):
    """HEADER, SPAN, END_SEQ and END frames are equal byte for byte;
    the handshake is equal field by field, but for the session id and
    the clock pings."""
    ph, pf = _record('port', case)
    jh, jf = _record('jax', case)
    assert [len(f) for f in pf] == [len(f) for f in jf]
    assert sum(len(f) for f in pf) > 2
    for i, (p, j) in enumerate(zip(pf, jf)):
        for k, (a, b) in enumerate(zip(p, j)):
            assert a == b, 'stripe %d frame %d differs' % (i, k)
    types = [_FRAME.unpack(f[:_FRAME.size])[0] for f in sum(pf, [])]
    assert types.count(TB.MSG_END) == 1
    assert types.count(TB.MSG_HEADER) == len(CASES[case][0])
    if CASES[case][3].get('protocol', 2) < 2 or CASES[case][3].get('naive'):
        assert ph == jh == [None]
        return
    for p, j in zip(ph, jh):
        assert sorted(p) == sorted(j)
        assert p['session'] != j['session']
        for key in ('version', 'stream_id', 'nstreams', 'window', 'crc'):
            assert p[key] == j[key], key
        for key in ('ts_us', 'wall_ns'):
            assert isinstance(p[key], type(j[key])), key


# ---------------------------------------------------------------------------
# the header codec
# ---------------------------------------------------------------------------

HEADERS = [
    {'name': 'plain', 'time_tag': 3, 'x': [1, 2.5, None, 'y'],
     'nested': {'a': {'b': True}}},
    {'np_int': np.int64(7), 'np_float': np.float32(2.5),
     'np_arr': np.arange(3, dtype=np.int32), 'np_2d': np.eye(2),
     'np_bool': np.bool_(True), 'u8': np.uint8(255), 'plain': 'x'},
    {'unicode': 'Δν 1.5 µs', 'big': 2 ** 62, 'neg': -1e-300,
     '_tensor': {'shape': [-1, 2], 'dtype': 'ci8'}},
]


@pytest.mark.parametrize('i', range(len(HEADERS)))
def test_serialize_header_bytes_equal_jax(i):
    hdr = HEADERS[i]
    got = TH.serialize_header(hdr)
    assert got == JH.serialize_header(hdr)
    assert TH.deserialize_header(got) == JH.deserialize_header(got)
    assert TH.deserialize_header(memoryview(got)) == \
        TH.deserialize_header(got.decode())


def test_serialize_header_refuses_what_jax_refuses():
    for mod in (TH, JH):
        with pytest.raises(TypeError):
            mod.serialize_header({'obj': object()})


# ---------------------------------------------------------------------------
# a cut link: reconnect and resume, sender death, resume probes
# ---------------------------------------------------------------------------


COUNTERS = {'port': tcounters, 'jax': jcounters}
CUT_DATA = _f32((48, 4), 21)


def _cut_hdr(s=0):
    return simple_header([-1, 4], 'f32', name='cut', gulp_nframe=8)


def _cut_run(spkg, rpkg, window=1, after_spans=2, reconnect=True,
             probe=None):
    """Bridge CUT_DATA (six 8-frame spans) from a ``spkg`` sender whose
    link is cut after ``after_spans`` span frames into an ``rpkg``
    receiver.  With ``reconnect`` the sender redials and the receiver
    re-accepts; without, the sender dies and, when ``probe`` names a
    package, its ``query_resume`` asks the receiver for the committed
    frames.  Returns (received, tx counters, rx counters, sender error,
    receiver errors, probe answer, dst ring)."""
    SR, SB = PKG[spkg]
    RR, RB = PKG[rpkg]
    for c in COUNTERS.values():
        c.reset()
    src = SR.Ring(space='system', name=_name('csrc'))
    dst = RR.Ring(space='system', name=_name('cdst'))
    dst.resize(1 << 16, 1 << 20)     # see presized_ring
    _fill(src, [CUT_DATA], _cut_hdr, 8)
    lst = RB.BridgeListener('127.0.0.1', 0)
    stop = threading.Event()
    box = {'rx_errors': [], 'probe': None}

    def recv():
        r = RB.RingReceiver(lst, dst, poison_on_error=not reconnect and
                            probe is None, stop_event=stop)
        while not stop.is_set():
            try:
                r.run()
                return
            except (ConnectionError, OSError) as exc:
                box['rx_errors'].append(exc)
                if not reconnect and probe is None:
                    return
            except BaseException as exc:
                box['rx_errors'].append(exc)
                return

    def send():
        first = [LinkCut(SB.connect('127.0.0.1', lst.port), after_spans)]
        redial = (lambda: [SB.connect('127.0.0.1', lst.port)]) \
            if reconnect else None
        s = SB.RingSender(src, first, gulp_nframe=8, window=window,
                          reconnect=redial, reconnect_max=3)
        try:
            s.run()
        except BaseException as exc:
            box['tx_error'] = exc
        finally:
            s.close()

    rt = threading.Thread(target=recv, daemon=True)
    rt.start()
    try:
        if reconnect:
            st = threading.Thread(target=send, daemon=True)
            st.start()
            box['out'] = bounded(_gather, dst, 8)
            st.join(TIMEOUT)
            assert not st.is_alive()
        else:
            bounded(send)
            if probe is not None:
                box['probe'] = bounded(PKG[probe][1].query_resume,
                                       '127.0.0.1', lst.port)
            else:
                with pytest.raises(RR.RingPoisonedError):
                    bounded(_gather, dst, 8)
    finally:
        stop.set()
        rt.join(TIMEOUT)
        lst.close()
    assert not rt.is_alive()

    tx = {k: v for k, v in COUNTERS[spkg].snapshot().items()
          if k.startswith('bridge.') and not k.startswith('bridge.rx.')}
    rx = {k: v for k, v in COUNTERS[rpkg].snapshot().items()
          if k.startswith('bridge.rx.')}
    return (box.get('out'), tx, rx, box.get('tx_error'),
            box['rx_errors'], box['probe'], dst)


COMBOS = [('port', 'port'), ('jax', 'jax'), ('port', 'jax'), ('jax', 'port')]


def test_reconnect_and_resume_counters_equal_jax():
    """Window 1, the link cut right after span 2: the sender redials
    once and retransmits span 2, the receiver drops it as a duplicate
    and the stream arrives whole; every pairing of the two packages
    counts the same."""
    runs = {c: _cut_run(*c) for c in COMBOS}
    for combo, (out, tx, rx, tx_err, rx_errs, _p, _d) in runs.items():
        assert tx_err is None, (combo, tx_err)
        assert out['cut'][1].tobytes() == CUT_DATA.tobytes(), combo
        assert len(rx_errs) == 1, (combo, rx_errs)
        assert tx['bridge.tx.reconnects'] == 1
        assert rx['bridge.rx.dups'] == 1
        assert tx['bridge.tx.spans'] == 7 and rx['bridge.rx.spans'] == 6
        assert tx['bridge.tx.bytes'] == \
            rx['bridge.rx.bytes'] + CUT_DATA.nbytes // 6
    want = runs[('jax', 'jax')]
    for combo, got in runs.items():
        assert got[1] == want[1], combo
        assert got[2] == want[2], combo


def test_window4_resume_drops_duplicates():
    """Window 4, the link cut after span 3: whatever was in flight is
    retransmitted, the receiver drops what it had, and the stream
    arrives whole in both packages."""
    for combo in (('port', 'port'), ('jax', 'port'), ('port', 'jax')):
        out, tx, rx, tx_err, _e, _p, _d = _cut_run(*combo, window=4,
                                                   after_spans=3)
        assert tx_err is None
        assert out['cut'][1].tobytes() == CUT_DATA.tobytes()
        assert tx['bridge.tx.reconnects'] == 1
        assert rx['bridge.rx.dups'] >= 1
        assert rx['bridge.rx.spans'] == 6


def test_sender_death_poisons_the_receiver_ring_counters_equal_jax():
    """No reconnect: the cut sender spends its budget (circuit_open) and
    raises; the receiver poisons its ring.  Same counters in every
    pairing."""
    runs = {c: _cut_run(*c, reconnect=False) for c in COMBOS}
    for combo, (_o, tx, rx, tx_err, rx_errs, _p, dst) in runs.items():
        assert isinstance(tx_err, ConnectionError), (combo, tx_err)
        assert rx_errs and isinstance(rx_errs[0], ConnectionError), combo
        assert dst.poisoned
        assert tx['bridge.circuit_open'] == 1
        assert rx['bridge.rx.spans'] == 2
    want = runs[('jax', 'jax')]
    for combo, got in runs.items():
        assert got[1] == want[1], combo
        assert got[2] == want[2], combo


@pytest.mark.parametrize('probe,receiver', [('port', 'jax'),
                                            ('jax', 'port'),
                                            ('port', 'port')])
def test_query_resume_against_either_receiver(probe, receiver):
    """After a sender died with two spans committed, a resume probe of
    either package reads the committed frames from either receiver, and
    the receiver goes on listening."""
    got = _cut_run(receiver, receiver, reconnect=False, probe=probe)[5]
    assert got == {'cut': 16}


# ---------------------------------------------------------------------------
# the sender's quotas, backoff and circuit breaker, and BF-W181
# (tests/test_overload.py), on the port
# ---------------------------------------------------------------------------


OVERLOAD_MAP = dict(BRIDGE_MAP, **{
    'bifrost_tpu.telemetry.counters': tcounters,
    'bifrost_tpu.telemetry.histograms': bt.telemetry.histograms,
    'bifrost_tpu.telemetry.slo': bt.telemetry.slo,
    'bifrost_tpu.io.udp_socket': TU,
    'bifrost_tpu.blocks.bridge': bt.blocks.bridge,
    'bifrost_tpu.blocks': bt.blocks})

JO_TESTS = ['test_w181_quota_below_one_span',
            'test_retry_backoff_is_full_jitter',
            'test_circuit_breaker_fast_fails_then_half_opens',
            'test_recover_exhaustion_counts_circuit_open']


@pytest.mark.parametrize('name', JO_TESTS)
def test_jax_overload_bridge_test_on_the_port(name, request, monkeypatch):
    tcounters.reset()
    fn = getattr(JO, name)
    args = [request.getfixturevalue(a)
            for a in inspect.signature(fn).parameters]
    bounded(rehome(fn, OVERLOAD_MAP), *args)


def _quota_run(pkg, ngulp=6):
    """tests/test_overload.py's quota scenario: a one-gulp-per-eon quota
    under drop_newest; returns (shed stats, counters, frames delivered)."""
    R, B = PKG[pkg]
    H = TH if pkg == 'port' else JH
    COUNTERS[pkg].reset()
    src = R.Ring(space='system', name=_name('qsrc'))
    dst = R.Ring(space='system', name=_name('qdst'))
    dst.resize(1 << 16, 1 << 20)     # see presized_ring
    hdr = {'_tensor': {'shape': [-1, 4], 'dtype': 'f32'},
           'gulp_nframe': 2, 'name': 'seq'}
    H.ensure_trace_context(hdr)
    with src.begin_writing() as w:
        with w.begin_sequence(hdr, gulp_nframe=2,
                              buf_nframe=2 * ngulp) as seq:
            for i in range(ngulp):
                with seq.reserve(2) as sp:
                    sp.data.as_numpy()[...] = float(i)
                    sp.commit(2)
    lst = B.BridgeListener('127.0.0.1', 0)
    sender = B.RingSender(src, gulp_nframe=2, window=4,
                          overload_policy='drop_newest',
                          quota_gulps_per_s=1e-6,
                          sock=B.connect('127.0.0.1', lst.port))
    receiver = B.RingReceiver(lst, dst)
    rt = threading.Thread(target=receiver.run, daemon=True)
    rt.start()
    bounded(sender.run)
    rt.join(TIMEOUT)
    assert not rt.is_alive()
    sender.close()
    receiver.close()
    got = sum(span.nframe for seq in dst.read(guarantee=True)
              for span in seq.read(2))
    stats = sender.shed_stats()
    stats['by_stream'] = len(stats['by_stream'])
    snap = COUNTERS[pkg].snapshot()
    # the header frame carries the hop's measured clock skew, whose
    # digits vary: bytes are held equal within a run, not across runs
    assert snap['bridge.tx.bytes'] == snap['bridge.rx.bytes']
    snap = {k: v for k, v in snap.items()
            if k.startswith('bridge.') and not k.endswith('.bytes')}
    return stats, snap, got


def test_sender_quota_sheds_fairly_per_stream_equals_jax():
    """The per-stream quota sheds all but the first gulp, on the ledger,
    the counters and the per-stream split, and delivered + shed equals
    produced, in both packages alike."""
    port, jax = _quota_run('port'), _quota_run('jax')
    assert port == jax
    stats, snap, got = port
    assert stats['shed_gulps'] == 5 and stats['by_stream'] == 1
    assert snap['bridge.tx.quota_shed_gulps'] == 5
    assert snap['bridge.tx.shed_bytes'] == 5 * 2 * 16
    assert got // 2 + stats['shed_gulps'] == 6


# ---------------------------------------------------------------------------
# trace context, hops, skew and the cross-host SLO age across a bridge
# (tests/test_observability.py:790)
# ---------------------------------------------------------------------------



def _two_pipelines(rx_pkg, tx_pkg, build_rx, build_tx):
    """Build a receiving pipeline of ``rx_pkg`` and a sending pipeline of
    ``tx_pkg`` and run both on threads, bounded; returns what
    ``build_rx`` and ``build_tx`` returned."""
    with rx_pkg.Pipeline() as prx:
        rx = build_rx()
    with tx_pkg.Pipeline() as ptx:
        tx = build_tx(rx)
    errors = []

    def run(p):
        try:
            p.run()
        except BaseException as exc:
            errors.append(exc)

    threads = [threading.Thread(target=run, args=(p,), daemon=True)
               for p in (prx, ptx)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT)
        assert not t.is_alive(), thread_stacks()
    assert not errors, errors
    return rx, tx


def _traced_bridge(pkg, path):
    """tests/test_observability.py's two-pipeline bridge, in ``pkg``,
    with span tracing on: (sink headers, histograms, bf_clock)."""
    tele = bt.telemetry if pkg is bt else bf.telemetry
    tele.spans.reconfigure()
    tele.spans.reset()
    tele.histograms.reset()
    rng = np.random.RandomState(5)
    gulps = [rng.randn(8, 4).astype(np.float32) for _ in range(4)]
    hdr = simple_header([-1, 4], 'f32', name='e2ectx', gulp_nframe=8)
    src_cls = StaticNumpySource if pkg is bt else JNumpySource
    sink_cls = TorchGatherSink if pkg is bt else JGatherSink

    def build_rx():
        bsrc = pkg.blocks.bridge_source('127.0.0.1', 0)
        return bsrc, sink_cls(bsrc)

    def build_tx(rx):
        nsrc = src_cls(gulps, hdr, gulp_nframe=8)
        return pkg.blocks.bridge_sink(nsrc, '127.0.0.1', rx[0].port)

    (bsrc, sink), _s = _two_pipelines(pkg, pkg, build_rx, build_tx)
    np.testing.assert_array_equal(sink.result(), np.concatenate(gulps))
    tele.spans.export(path)
    with open(path) as f:
        clock = json.load(f)['otherData']['bf_clock']
    hist = {k: v for k, v in tele.snapshot()['histograms'].items()
            if k.startswith('slo.') or k.startswith('bridge.')}
    return sink.headers, hist, clock


def test_trace_context_hops_and_fabric_age_across_a_bridge(monkeypatch,
                                                           tmp_path):
    """The stream's trace id crosses the bridge with one hop and a skew
    stamped; the sink ages each gulp on slo.exit_age_s and, being one
    hop from the origin, on slo.fabric_exit_age_s; the sender's session
    and clock estimates reach the trace export's bf_clock.  The same
    fields, counts and histogram names as the JAX package's run."""
    monkeypatch.setenv('BF_TRACE_FILE', str(tmp_path / 'unused.json'))
    got = {}
    try:
        for pkg in (bt, bf):
            got[pkg] = _traced_bridge(pkg, str(tmp_path / (
                'port.json' if pkg is bt else 'jax.json')))
    finally:
        monkeypatch.delenv('BF_TRACE_FILE')
        for tele in (bt.telemetry, bf.telemetry):
            tele.spans.reconfigure()
            tele.spans.reset()
    (ph, phist, pclock), (jh, jhist, jclock) = got[bt], got[bf]
    for headers in (ph, jh):
        ctx = headers[0]['_trace']
        assert len(ctx['id']) == 16 and ctx['hops'] == 1
        assert isinstance(ctx['skew_ns'], int)
    assert sorted(ph[0]['_trace']) == sorted(jh[0]['_trace'])
    def shape(hist):
        # block names differ by the test blocks' class names
        return sorted(re.sub(r'Pipeline_\d+/[A-Za-z]+_\d+', 'B', k)
                      for k in hist)
    assert shape(phist) == shape(jhist)
    for hist in (phist, jhist):
        assert hist['slo.exit_age_s']['count'] == 4
        assert hist['slo.fabric_exit_age_s']['count'] == 4
        assert any(k.startswith('slo.') and 'BridgeSource' in k and
                   k.endswith('.commit_age_s') for k in hist)
    for clock in (pclock, jclock):
        # one process holds both ends: the sender's estimate replaces
        # the receiver's registration of the same session
        roles = sorted(e['role'] for e in clock['sessions'].values())
        assert roles == ['tx']
        tx = [e for e in clock['sessions'].values() if e['role'] == 'tx']
        assert sorted(tx[0]) == ['offset_us', 'role', 'rtt_us',
                                 'wall_offset_ns']
        assert tx[0]['rtt_us'] >= 0
    assert sorted(pclock) == sorted(jclock) == ['host', 'pid', 'sessions']


# ---------------------------------------------------------------------------
# the slice's chain at small width: GUPPI RAW over a bridge into the
# spectrometer (examples/gpuspec_simple_torch.py after its reader)
# ---------------------------------------------------------------------------



ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GATE = 1e-5


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, 'examples', name + '.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope='module')
def demo(tmp_path_factory):
    """A demo GUPPI file (4 channels x 256 samples x 2 pols, 4 blocks)
    and the unbridged chains' .fil of both packages."""
    device.set_device('cpu')
    tex, jex = _example('gpuspec_simple_torch'), _example('gpuspec_simple')
    base = tmp_path_factory.mktemp('bridged')
    raw = str(base / 'demo.raw')
    tex.make_demo_raw(raw)
    ref = {}
    for pkg, ex in ((bt, tex), (bf, jex)):
        outdir = base / ('ref_' + pkg.__name__)
        outdir.mkdir()
        with pkg.Pipeline() as p:
            ex.build([raw], str(outdir))
        bounded(p.run)
        ref[pkg] = str(outdir / 'demo.raw.fil')
    return tex, raw, ref, base


def _fil(path):
    with TIO.SigprocFile(path) as f:
        nbyte = f.header_size
    with open(path, 'rb') as f:
        blob = f.read()
    return blob[:nbyte], np.frombuffer(blob[nbyte:], np.float32)


@pytest.mark.parametrize('sender', ['port', 'jax'])
@pytest.mark.parametrize('kw', [{}, {'window': 4, 'nstreams': 2,
                                     'crc': True}],
                         ids=['w1', 'w4s2crc'])
def test_bridged_guppi_spectrometer_equals_unbridged(demo, sender, kw):
    """read_guppi_raw -> bridge_sink ==TCP==> bridge_source -> the
    port's spectrometer chain: the .fil equals the port's unbridged run
    byte for byte and the JAX package's unbridged run within 1e-5."""
    tex, raw, ref, base = demo
    spkg = bt if sender == 'port' else bf
    outdir = base / ('%s_%s' % (sender, '_'.join(sorted(kw)) or 'w1'))
    outdir.mkdir()

    def build_rx():
        src = bt.blocks.bridge_source('127.0.0.1', 0)
        tex.build_after(src, str(outdir))
        return src

    def build_tx(src):
        rd = spkg.blocks.read_guppi_raw([raw], gulp_nframe=1)
        return spkg.blocks.bridge_sink(rd, '127.0.0.1', src.port, **kw)

    tcounters.reset()
    _two_pipelines(bt, spkg, build_rx, build_tx)
    head, data = _fil(str(outdir / 'demo.raw.fil'))
    thead, tdata = _fil(ref[bt])
    jhead, jdata = _fil(ref[bf])
    assert head == thead == jhead
    assert data.tobytes() == tdata.tobytes()
    assert np.abs(data - jdata).max() / np.abs(jdata).max() < GATE
    assert tcounters.get('bridge.rx.spans') == 4
    assert tcounters.get('bridge.rx.crc_errors') == 0


# ---------------------------------------------------------------------------
# lanes on the three host storages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('dtype,ncol', [('f32', 4), ('ci4', 8)])
@pytest.mark.parametrize('core', ['python', 'native', 'cuda_host',
                                  'pinned'])
def test_lane_memoryviews_alias_the_ring(core, dtype, ncol, monkeypatch):
    """A write span's lanes are ``recv_into`` targets and a read span's
    lanes ``sendmsg`` sources over the ring bytes themselves (no copy),
    one contiguous lane per ringlet, in bytes for a packed type, also
    for spans that wrap the ring's end."""
    from bifrost_tpu_torch.ring_native import NativeRing
    if core == 'python':
        monkeypatch.setenv('BF_NO_NATIVE', '1')
    else:
        monkeypatch.delenv('BF_NO_NATIVE', raising=False)
    space = 'system' if core in ('python', 'native') else 'cuda_host'
    ring = TR.Ring(space=space, name=_name('lanes'))
    assert isinstance(ring, NativeRing) == (core == 'native')
    if core == 'pinned':
        import torch
        try:
            torch.zeros(1, pin_memory=True)
        except RuntimeError as exc:
            pytest.skip('this torch cannot pin host memory: %s' % exc)
        ring._storage.pinned = True
    nframe, nspan = 5, 9
    hdr = simple_header([3, -1, ncol], dtype,
                        labels=['beam', 'time', 'chan'], gulp_nframe=nframe)
    rng = np.random.RandomState(3)
    wrapped = 0
    with ring.begin_writing() as wr:
        with wr.begin_sequence(hdr, gulp_nframe=nframe,
                               buf_nframe=2 * nframe + 2) as wseq:
            rseq = ring.open_earliest_sequence(guarantee=True)
            fb = rseq.tensor['frame_nbyte']
            for k in range(nspan):
                want = rng.randint(0, 256, (3, nframe * fb)).astype(
                    np.uint8)
                with wseq.reserve(nframe) as ws:
                    lanes = ws.lane_memoryviews()
                    assert [len(v) for v in lanes] == [nframe * fb] * 3
                    assert all(v.contiguous and not v.readonly
                               for v in lanes)
                    for lane, row in zip(lanes, want):
                        lane[:] = row.tobytes()
                    size = ring.total_span
                    wrapped += ws._begin % size + ws._nbyte > size
                    ws.commit(nframe)
                rs = rseq.acquire(k * nframe, nframe)
                got = rs.lane_memoryviews()
                assert [bytes(v) for v in got] == \
                    [row.tobytes() for row in want]
                assert rs.data.as_numpy().tobytes() == want.tobytes()
                # the lanes alias the span's view
                got[1][0] = (got[1][0] + 1) % 256
                assert rs.data.as_numpy().view(np.uint8).reshape(3, -1)[
                    1, 0] == got[1][0]
                rs.release()
            rseq.close()
    assert wrapped, 'no span wrapped the ring end'


def test_lane_memoryviews_none_for_device_rings_and_empty_spans():
    ring = TR.Ring(space='cuda', name=_name('dev'))
    hdr = simple_header([-1, 4], 'f32', gulp_nframe=2)
    with ring.begin_writing() as wr:
        with wr.begin_sequence(hdr, gulp_nframe=2, buf_nframe=4) as seq:
            with seq.reserve(2) as ws:
                assert ws.lane_memoryviews() is None
                ws.commit(0)
    host = TR.Ring(space='system', name=_name('empty'))
    with host.begin_writing() as wr:
        with wr.begin_sequence(hdr, gulp_nframe=2, buf_nframe=4) as seq:
            with seq.reserve(0) as ws:
                assert ws.lane_memoryviews() is None


def test_lanes_of_a_shed_span_are_scratch(monkeypatch):
    """A drop_newest ring sheds a reserve it has no room for: that
    span's lanes are the shed scratch, never the ring bytes a reader
    still holds (a receiver writing into them would corrupt its gulp)."""
    for no_native in ('1', ''):
        monkeypatch.setenv('BF_NO_NATIVE', no_native)
        ring = TR.Ring(space='system', name=_name('shed'))
        ring.set_overload_policy('drop_newest')
        hdr = simple_header([-1, 4], 'f32', gulp_nframe=2)
        with ring.begin_writing() as wr:
            with wr.begin_sequence(hdr, gulp_nframe=2, buf_nframe=4) as seq:
                rseq = ring.open_earliest_sequence(guarantee=True)
                for k in range(ring.total_span // (2 * 16)):
                    with seq.reserve(2) as ws:
                        assert not ws._shed
                        ws.data.as_numpy()[...] = k + 1
                        ws.commit(2)
                held = rseq.acquire(0, 2)
                before = held.data.as_numpy().copy()
                with seq.reserve(2) as ws:
                    assert ws._shed
                    for lane in ws.lane_memoryviews():
                        lane[:] = b'\xff' * len(lane)
                    ws.commit(2)
                np.testing.assert_array_equal(held.data.as_numpy(), before)
                held.release()
                rseq.close()
        assert ring.shed_stats()['shed_gulps'] == 1


@pytest.mark.parametrize('core', ['python', 'native'])
def test_partial_gulp_of_an_earlier_sequence_stops_at_its_end(core,
                                                              monkeypatch):
    """A guaranteed read of a finished sequence whose last gulp is
    partial ends at the sequence's own end on both of the port's ring
    cores, although the next sequence's frames are already committed.
    The JAX package still runs on into the next sequence (a weak spot of
    the reference, ROADMAP queue 3): its third span of the first
    sequence is 8 frames long."""
    from bifrost_tpu_torch.ring_native import NativeRing
    if core == 'python':
        monkeypatch.setenv('BF_NO_NATIVE', '1')
    else:
        monkeypatch.delenv('BF_NO_NATIVE', raising=False)
    hdr = _plain_hdr('over', 4)
    data = [_f32((20, 4), 31), _f32((20, 4), 32)]
    got = {}
    for pkg in ('port', 'jax'):
        src = PKG[pkg][0].Ring(space='system', name=_name('over'))
        if pkg == 'port':
            assert isinstance(src, NativeRing) == (core == 'native')
        _fill(src, data, hdr, 8)
        got[pkg] = [[(sp.frame_offset, sp.nframe) for sp in seq.read(8)]
                    for seq in src.read(guarantee=True)]
    assert got['port'] == [[(0, 8), (8, 8), (16, 4)],
                           [(0, 8), (8, 8), (16, 4)]]
    assert got['jax'] == [[(0, 8), (8, 8), (16, 8)],
                          [(0, 8), (8, 8), (16, 4)]]


def _sigproc_hdr(s):
    """A ['time', 'pol', 'freq'] header that write_sigproc accepts."""
    return {'name': 'part%d.fil' % s, 'time_tag': 0,
            '_tensor': {'shape': [-1, 1, 4], 'dtype': 'f32',
                        'labels': ['time', 'pol', 'freq'],
                        'scales': [[0., 1e-3], None, [1400., 1.]],
                        'units': ['s', None, 'MHz']},
            'gulp_nframe': 8}


#: two sequences whose last gulps are partial (20 and 13 frames, gulp 8)
PARTIAL = [_f32((20, 1, 4), 41), _f32((13, 1, 4), 42)]


@pytest.mark.parametrize('core', ['python', 'native'])
def test_partial_gulps_reach_write_sigproc_and_the_bridge_unmixed(
        core, tmp_path, monkeypatch):
    """A two-sequence stream with partial last gulps, fully committed
    before it is read, goes through write_sigproc and through the port's
    bridge sender (into a port and a JAX receiver): every file and every
    received sequence holds its own sequence's frames and no others.
    The receivers' rings are read one frame a span, which no overrun of
    the reader's own can reach (the JAX ring's read would overrun)."""
    from bifrost_tpu_torch.io.sigproc import SigprocFile
    from tests.test_torch_bounded import run_bounded
    if core == 'python':
        monkeypatch.setenv('BF_NO_NATIVE', '1')
    else:
        monkeypatch.delenv('BF_NO_NATIVE', raising=False)
    ring = TR.Ring(space='system', name=_name('fil'))
    _fill(ring, PARTIAL, _sigproc_hdr, 8)
    with bt.Pipeline() as p:
        bt.blocks.write_sigproc(ring, path=str(tmp_path))
        run_bounded(p)
    for s, want in enumerate(PARTIAL):
        with SigprocFile(str(tmp_path / ('part%d.fil' % s))) as sf:
            got = sf.read(64)
        assert got.shape == want.shape
        assert got.tobytes() == want.tobytes()
    CASES['partial'] = (PARTIAL, _sigproc_hdr, 8, {'window': 2}, 1)
    try:
        for rpkg in ('port', 'jax'):
            _check_delivered(_bridge('port', rpkg, 'partial',
                                     gather_gulp=1), 'partial')
    finally:
        del CASES['partial']


# ---------------------------------------------------------------------------
# device rings are refused; failures raise or poison, none is swallowed
# ---------------------------------------------------------------------------

def test_bridge_refuses_device_rings():
    """The JAX BridgeSource(space='tpu') fails at its first span
    (AttributeError on the device span's data, its ring poisoned); the
    port refuses a 'cuda' ring up front: bridge into a host ring and
    copy('cuda') from it."""
    with bt.Pipeline():
        with pytest.raises(ValueError, match='cuda_host'):
            bt.blocks.bridge_source('127.0.0.1', 0, space='cuda')
        dev = TR.Ring(space='cuda', name=_name('dev'))
        with pytest.raises(ValueError, match='space'):
            bt.blocks.bridge_sink(dev, '127.0.0.1', 9)
    with pytest.raises(ValueError, match='host ring'):
        TB.RingSender(dev, [])
    with pytest.raises(ValueError, match='host ring'):
        TB.RingReceiver(None, dev)
    with bt.Pipeline():
        src = bt.blocks.bridge_source('127.0.0.1', 0, space='cuda_host')
        assert src.orings[0].space == 'cuda_host'
        src.listener.close()


def _free_port():
    s = socket.socket()
    s.bind(('127.0.0.1', 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_failed_dial_raises_after_the_retry_budget(monkeypatch):
    """Both packages retry a refused dial BF_IO_RETRY_MAX times, count
    each on io.socket_retries, then raise."""
    monkeypatch.setenv('BF_IO_RETRY_MAX', '2')
    monkeypatch.setenv('BF_IO_RETRY_BACKOFF', '0.001')
    port = _free_port()
    seen = {}
    for pkg in ('port', 'jax'):
        COUNTERS[pkg].reset()
        with pytest.raises(ConnectionRefusedError):
            bounded(PKG[pkg][1].connect, '127.0.0.1', port)
        seen[pkg] = COUNTERS[pkg].get('io.socket_retries')
    assert seen == {'port': 2, 'jax': 2}


def test_spent_dial_budget_opens_the_circuit(monkeypatch):
    """A bridge sink whose dials are refused spends its budget, opens
    its circuit, and its restart fails fast with CircuitOpenError: the
    run raises and the failure history names both."""
    monkeypatch.setenv('BF_IO_RETRY_MAX', '1')
    monkeypatch.setenv('BF_IO_RETRY_BACKOFF', '0.001')
    port = _free_port()
    hdr = simple_header([-1, 4], 'f32', name='dial', gulp_nframe=8)
    with bt.Pipeline() as p:
        src = StaticNumpySource([np.zeros((8, 4), np.float32)], hdr,
                                gulp_nframe=8)
        bt.blocks.bridge_sink(src, '127.0.0.1', port, on_failure='restart',
                              max_restarts=1, restart_backoff=0.01)
    with pytest.raises(RuntimeError, match='CircuitOpenError'):
        bounded(p.run)
    kinds = [(f.kind, type(f.exc).__name__) for f in p.supervisor.failures]
    assert kinds == [('restarted', 'ConnectionRefusedError'),
                     ('error', 'CircuitOpenError')]
    assert isinstance(p.supervisor.failures[1].exc,
                      bt.blocks.CircuitOpenError)


def test_protocol_violation_is_fatal_and_poisons():
    """A peer that sends an unknown message type fails the bridge source
    with BridgeProtocolError (not retried as a reconnect), the run
    raises and the source's ring is poisoned."""
    with bt.Pipeline() as p:
        bsrc = bt.blocks.bridge_source('127.0.0.1', 0)
        TorchGatherSink(bsrc)
    done = threading.Event()

    def bad_peer():
        c = TB.connect('127.0.0.1', bsrc.port)
        TB._send_msg(c, 42, b'bogus')
        done.wait(TIMEOUT)
        c.close()

    t = threading.Thread(target=bad_peer, daemon=True)
    t.start()
    try:
        with pytest.raises(Exception, match='BridgeSource'):
            bounded(p.run)
    finally:
        done.set()
        t.join(TIMEOUT)
    errs = [f.exc for f in p.supervisor.failures if f.kind == 'error']
    assert len(errs) == 1 and isinstance(errs[0], TB.BridgeProtocolError)
    assert '42' in str(errs[0])
    assert bsrc.orings[0].poisoned
    assert not any(f.kind == 'reconnected' for f in p.supervisor.failures)


def test_bridge_source_parks_until_its_readers_hold_the_stream():
    """A downstream block that starts late (its thread stalls 0.5 s
    before it opens its input) still sees every gulp of a burst ten
    times the bridge source's ring: the source parks after beginning
    its sequence until the pipeline's init barrier completes."""
    from bifrost_tpu_torch.testing import faults
    rng = np.random.RandomState(17)
    gulps = [rng.randn(8, 4).astype(np.float32) for _ in range(30)]
    hdr = simple_header([-1, 4], 'f32', name='burst', gulp_nframe=8)

    def build_rx():
        bsrc = bt.blocks.bridge_source('127.0.0.1', 0)
        return bsrc, TorchGatherSink(bsrc)

    def build_tx(rx):
        src = StaticNumpySource(gulps, hdr, gulp_nframe=8)
        return bt.blocks.bridge_sink(src, '127.0.0.1', rx[0].port,
                                     window=8)

    with faults.injected('block.run', exc=None, match='TorchGatherSink',
                         delay=0.5):
        (bsrc, sink), _s = _two_pipelines(bt, bt, build_rx, build_tx)
    np.testing.assert_array_equal(sink.result(), np.concatenate(gulps))
