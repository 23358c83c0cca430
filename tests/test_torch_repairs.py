"""Deterministic drills for two port faults that showed only under load.

- A bridge sender that finds its source ring poisoned at the end of data
  withholds the clean MSG_END (v1 wire, the naive loop and the v2 pump),
  so the receiver poisons its ring: the sender is held after its last
  MSG_END_SEQ until the poison lands.  This narrows, and does not close,
  the race of ``tests/test_bridge.py::test_bridge_v1_sender_failure_
  withholds_end``, whose writer ends the stream before it poisons the
  ring: a poison that lands after the sender's check follows a clean end.
  The property that test means, a poison while the stream is open, is
  pinned without a race.
- A drop_oldest ring whose guaranteed reader opens after the oldest
  committed gulps were overwritten: the shed ledger equals the frames the
  reader skipped, on both ring cores.  A consumer thread scheduled late
  is the interleaving that left ``test_health_live_during_shedding_
  pipeline[port]`` one gulp short.
"""

import threading

import pytest

import bifrost_tpu_torch.io.bridge as TB
from bifrost_tpu_torch import device
from bifrost_tpu_torch.ring import EndOfDataStop, Ring, RingPoisonedError

from tests.test_torch_bounded import join_bounded

TIMEOUT = 30.


@pytest.fixture(autouse=True)
def _cpu():
    device.set_device('cpu')


def _hdr(name, gulp):
    return {'name': name, 'gulp_nframe': gulp,
            '_tensor': {'shape': [-1, 4], 'dtype': 'f32'}}


def _bridge(src, dst, protocol, naive=False):
    """Start a receiver and a sender thread; returns (results, threads)."""
    lst = TB.BridgeListener('127.0.0.1', 0)
    res = []

    def sender():
        sock = TB.connect('127.0.0.1', lst.port)
        try:
            TB.RingSender(src, sock, gulp_nframe=8, protocol=protocol,
                          naive=naive).run()
            res.append(('sender', None))
        except RingPoisonedError as exc:
            res.append(('sender', exc))
        finally:
            sock.close()

    def receiver():
        try:
            TB.RingReceiver(lst, dst).run()
            res.append(('receiver', None))
        except ConnectionError as exc:
            res.append(('receiver', exc))
        finally:
            lst.close()

    threads = [threading.Thread(target=f, daemon=True)
               for f in (receiver, sender)]
    for t in threads:
        t.start()
    return res, threads


def _write_one_gulp(src):
    with src.begin_writing() as wr:
        with wr.begin_sequence(_hdr('held', 8), gulp_nframe=8,
                               buf_nframe=24) as seq:
            with seq.reserve(8) as span:
                span.data.as_numpy()[...] = 1.0
                span.commit(8)


@pytest.mark.parametrize('core', ['native', 'python'])
@pytest.mark.parametrize('wire', ['v1', 'naive', 'v2'])
def test_sender_held_at_end_of_data_withholds_end_after_poison(
        wire, core, monkeypatch):
    """The writer ends the stream; the sender finds the end of data and is
    held there; the ring is poisoned; the sender goes on.  It must
    raise the poison and send no MSG_END, and the receiver's ring must be
    poisoned.  Without the check at the end of data
    (``RingSender._check_source_end``) the sender sent a clean MSG_END."""
    if core == 'python':
        monkeypatch.setenv('BF_NO_NATIVE', '1')
    else:
        monkeypatch.delenv('BF_NO_NATIVE', raising=False)
    src = Ring(space='system', name='held_src_%s_%s' % (wire, core))
    dst = Ring(space='system', name='held_dst_%s_%s' % (wire, core))
    dst.resize(1 << 12, 1 << 16)
    at_end, go = threading.Event(), threading.Event()
    next_seq = type(src)._next_seq

    def held_next_seq(ring, seq):
        try:
            return next_seq(ring, seq)
        except EndOfDataStop:
            if ring is src:
                at_end.set()
                go.wait(TIMEOUT)
            raise
    monkeypatch.setattr(type(src), '_next_seq', held_next_seq)
    sent = []
    send, emit = TB._send_msg, TB.RingSender._emit

    def logged_send(sock, mtype, payload=b''):
        sent.append(mtype)
        return send(sock, mtype, payload)

    def logged_emit(self, mtype, *a, **k):
        sent.append(mtype)
        return emit(self, mtype, *a, **k)
    monkeypatch.setattr(TB, '_send_msg', logged_send)
    monkeypatch.setattr(TB.RingSender, '_emit', logged_emit)
    _write_one_gulp(src)
    res, threads = _bridge(src, dst, 1 if wire != 'v2' else 2,
                           naive=(wire == 'naive'))
    assert at_end.wait(TIMEOUT), "the sender never reached the end of data"
    src.poison(RuntimeError("producer died after its last commit"))
    go.set()
    for t in threads:
        join_bounded(t, TIMEOUT)
    kinds = dict(res)
    assert isinstance(kinds.get('sender'), RingPoisonedError), res
    assert TB.MSG_END not in sent
    assert isinstance(kinds.get('receiver'), ConnectionError), res
    assert dst.poisoned


@pytest.mark.parametrize('core', ['native', 'python'])
def test_poison_while_the_stream_is_open_poisons_the_receiver(
        core, monkeypatch):
    """The property the JAX test means, pinned without a race: the ring is
    poisoned while its sequence is still open; the v1 sender raises and
    the receiver's ring is poisoned."""
    if core == 'python':
        monkeypatch.setenv('BF_NO_NATIVE', '1')
    else:
        monkeypatch.delenv('BF_NO_NATIVE', raising=False)
    src = Ring(space='system', name='open_src_' + core)
    dst = Ring(space='system', name='open_dst_' + core)
    dst.resize(1 << 12, 1 << 16)
    with src.begin_writing() as wr:
        with wr.begin_sequence(_hdr('open', 8), gulp_nframe=8,
                               buf_nframe=24) as seq:
            with seq.reserve(8) as span:
                span.data.as_numpy()[...] = 1.0
                span.commit(8)
            res, threads = _bridge(src, dst, 1)
            src.poison(RuntimeError("producer died mid-stream"))
            for t in threads:
                join_bounded(t, TIMEOUT)
    kinds = dict(res)
    assert isinstance(kinds.get('sender'), RingPoisonedError), res
    assert isinstance(kinds.get('receiver'), ConnectionError), res
    assert dst.poisoned


@pytest.mark.parametrize('core', ['native', 'python'])
@pytest.mark.parametrize('nlate', [1, 3])
def test_shed_ledger_counts_gulps_lost_before_a_late_reader(
        core, nlate, monkeypatch):
    """A one-gulp drop_oldest ring: ``nlate + 1`` gulps are committed
    before a guaranteed reader opens the sequence at its start, then more
    gulps with the reader idle, then the reader drains.  The ledger equals
    the frames the reader skipped.  Before the repair the gulps overwritten
    before the reader registered were skipped but never counted."""
    if core == 'python':
        monkeypatch.setenv('BF_NO_NATIVE', '1')
    else:
        monkeypatch.delenv('BF_NO_NATIVE', raising=False)
    ring = Ring(space='system', name='shed_late_%s_%d' % (core, nlate))
    ring.set_overload_policy('drop_oldest')
    fb = 16
    committed, skipped, got, off = 0, 0, 0, 0

    def drain(rd):
        nonlocal skipped, got, off
        while off * fb < committed:
            try:
                sp = rd.acquire(off, 4)
            except EndOfDataStop:
                break
            skipped += sp.frame_offset - off
            got += sp.nframe
            off = sp.frame_offset + sp.nframe
            sp.release()

    with ring.begin_writing() as w:
        with w.begin_sequence(_hdr('late', 4), 4, 4) as seq:
            def write(k):
                with seq.reserve(4) as sp:
                    sp.data.as_numpy()[...] = float(k)
                    sp.commit(4)
                return 4 * fb
            for k in range(nlate + 1):
                committed += write(k)
            rd = ring.open_earliest_sequence(guarantee=True)
            drain(rd)
            for k in range(3):
                committed += write(nlate + 1 + k)
            drain(rd)
            rd.close()
    shed = ring.shed_stats()['shed_bytes']
    assert skipped == 4 * (nlate + 2)
    assert (got + skipped) * fb == committed
    assert shed == skipped * fb
