"""The port's UDP sockets, capture engines and transmit engines against
the JAX package's on the same packets.

Every capture here is deterministic: a burst far smaller than the socket
buffer is queued before the capture reads it (or replayed from a packet
file), so what each engine places and counts does not depend on thread
timing.  The burst carries loss, reordering, late, alien, duplicate and
runt packets.  The engines compared:

- the native C engine (``NativeUDPCapture``, chosen for a native ring),
  port against JAX (the same ``native/capture.cpp``);
- the Python engine (``BF_NO_NATIVE_CAPTURE=1``) and ``DiskReader``,
  port against JAX;
- ``ShardedUDPCapture`` at 1 and 4 workers, staged and zero-copy,
  port against JAX, with the stream inside one span so that no window
  slide can race a worker, into a native and a Python-core ring.

Then: the transmit engines' wire bytes (native and Python, both
packages, all twelve formats), the engine dispatch with no hidden
fallback, the native engine's commits seen by the ring's counters,
``occupancy()`` and the ring checker, ``retry_transient``, and the JAX
package's socket-level tests rehomed onto the port.  Every loop and join
is bounded; no test asserts a rate.
"""

import itertools
import os
import threading
import time

import numpy as np
import pytest

import bifrost_tpu.io.packet_capture as JC
import bifrost_tpu.io.packet_formats as JF
import bifrost_tpu.io.packet_writer as JW
import bifrost_tpu.io.udp_socket as JU
import bifrost_tpu.native as jnative
import bifrost_tpu.ring as JR
import bifrost_tpu.telemetry.counters as jcounters
import bifrost_tpu.telemetry.histograms as jhist

import bifrost_tpu_torch.io.packet_capture as TC
import bifrost_tpu_torch.io.packet_formats as TF
import bifrost_tpu_torch.io.packet_writer as TW
import bifrost_tpu_torch.io.udp_socket as TU
import bifrost_tpu_torch.ring as TR
from bifrost_tpu_torch import device, native
from bifrost_tpu_torch.analysis import ringcheck
from bifrost_tpu_torch.ring_native import NativeRing
from bifrost_tpu_torch.telemetry import counters as tcounters
from bifrost_tpu_torch.telemetry import histograms as thist

from tests import test_udp_io as JT
from tests.test_torch_bounded import join_bounded
from tests.test_torch_wire_formats import rehome

PKGS = {'port': (TU, TF, TC, TW, TR), 'jax': (JU, JF, JC, JW, JR)}
UDP_MAP = {'bifrost_tpu.io.udp_socket': TU,
           'bifrost_tpu.io.packet_formats': TF,
           'bifrost_tpu.io.packet_capture': TC,
           'bifrost_tpu.io.packet_writer': TW,
           'bifrost_tpu.ring': TR}
NSRC, PAY = 4, 64
_names = itertools.count()


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    device.set_device('cpu')
    monkeypatch.delenv('BF_NO_NATIVE', raising=False)
    monkeypatch.delenv('BF_NO_NATIVE_CAPTURE', raising=False)


def _name(what):
    return 'tudp-%s-%d-%d' % (what, os.getpid(), next(_names))


def _header(desc):
    return 0, {'name': 'udp', '_tensor': {
        'shape': [-1, NSRC, PAY], 'dtype': 'u8',
        'labels': ['time', 'src', 'byte'],
        'scales': [[0, 1]] * 3, 'units': [None] * 3}}


def _payload(f, s):
    return bytes(((np.arange(PAY) * 7 + f * 31 + s * 11) & 0xFF)
                 .astype(np.uint8))


def _chips(f, s, payload=None):
    """A CHIPS packet of frame f (wire seq f + 1) from source s."""
    return TF.ChipsFormat().pack(TF.PacketDesc(
        seq=f + 1, src=s, nsrc=NSRC, nchan=1,
        payload=_payload(f, s) if payload is None else payload))


def _stream(f0, nframe, late, runt=True, shuffle=True):
    """Frames [f0, f0 + nframe) of every source, in blocks of 4 frames
    sent in a shuffled order (unless ``shuffle`` is False), with four cells lost, one alien source and
    one runt (unless ``runt`` is False); then a tail of one duplicate of
    a cell of the last open span and the ``late`` (frame, source)
    packets.  Returns (packets, tail, expected ring contents (nframe,
    NSRC, PAY))."""
    rng = np.random.RandomState(f0 + nframe)
    lost = {(f0 + 3, 1), (f0 + 9, 2), (f0 + nframe - 7, 0),
            (f0 + nframe - 4, 3)}
    pkts = []
    exp = np.zeros((nframe, NSRC, PAY), np.uint8)
    for b in range(f0, f0 + nframe, 4):
        cells = [(f, s) for f in range(b, min(b + 4, f0 + nframe))
                 for s in range(NSRC)]
        order = rng.permutation(len(cells)) if shuffle else \
            range(len(cells))
        for i in order:
            f, s = cells[i]
            if (f, s) in lost:
                continue
            pkts.append(_chips(f, s))
            exp[f - f0, s] = np.frombuffer(_payload(f, s), np.uint8)
        if b == f0 + 4:
            pkts.append(_chips(f0 + 6, NSRC + 2))           # alien
            if runt:
                pkts.append(b'\x01' * 8)                    # runt
    tail = [_chips(f0 + nframe - 6, 2)]                     # duplicate
    tail.extend(_chips(f, s) for f, s in late)
    return pkts, tail, exp


def _read_ring(ring, nframe_max):
    """Every committed frame of the ring's first sequence (read after
    the writer ended)."""
    got = []
    for seq in ring.read(guarantee=True):
        for span in seq.read(8):
            got.append(np.array(span.data.as_numpy(), copy=True)
                       .reshape(span.nframe, NSRC, PAY))
        break
    out = np.concatenate(got) if got else np.zeros((0, NSRC, PAY))
    assert out.shape[0] <= nframe_max
    return out


def _stats(st):
    d = st._read() if hasattr(st, '_read') else dict(st)
    return {k: (np.asarray(v).tolist() if k == 'src_ngood' else int(v))
            for k, v in d.items()}


def _hist(mod, name):
    h = mod.get(name)
    return None if h is None else (h.count, list(h.buckets))


def _run_capture(cap, pc):
    box = {}

    def loop():
        try:
            for _ in range(1000):
                if cap.recv() in (pc.CAPTURE_NO_DATA,
                                  pc.CAPTURE_INTERRUPTED):
                    break
        except BaseException as exc:
            box['exc'] = exc
        finally:
            cap.end()

    t = threading.Thread(target=loop, daemon=True)
    t.start()
    join_bounded(t)
    if 'exc' in box:
        raise box['exc']


def _single_socket_capture(pkg, engine, pkts, name, batch=8):
    """Queue ``pkts`` on a bound socket, then capture them with the
    package's UDPCapture on a 'system' ring (8-frame spans).  Returns
    (ring bytes, stats, the engine's class name, the ring)."""
    U, F, C, W, R = PKGS[pkg]
    rx = U.UDPSocket().bind(U.Address('127.0.0.1', 0))
    rx.set_timeout(0.3)
    tx = U.UDPSocket().connect(
        U.Address('127.0.0.1', rx.sock.getsockname()[1]))
    try:
        ring = R.Ring(space='system', name=name)
        cap = C.UDPCapture('chips', rx, ring, NSRC, 0, PAY, 8, 8, _header,
                           batch=batch)
        for p in pkts:
            tx.send(p)
        _run_capture(cap, C)
        return _read_ring(ring, 64), _stats(cap.stats), \
            type(cap).__name__, ring
    finally:
        tx.close()
        rx.close()


#: frames 0-23 (3 spans of 8), then two packets of span 0 after the
#: window slid past it
LATE = ((2, 1), (3, 1))


@pytest.mark.parametrize('engine', ['native', 'python'])
def test_loopback_burst_equals_jax(engine, monkeypatch):
    if engine == 'python':
        monkeypatch.setenv('BF_NO_NATIVE_CAPTURE', '1')
    elif not jnative.available():
        pytest.skip('the JAX native library did not build')
    pkts, tail, exp = _stream(0, 24, LATE)
    pkts = pkts + tail
    name = _name(engine)
    got, st, kind, ring = _single_socket_capture('port', engine, pkts,
                                                 name)
    jgot, jst, jkind, _ = _single_socket_capture('jax', engine, pkts, name)
    assert kind == jkind == ('NativeUDPCapture' if engine == 'native'
                             else 'UDPCapture')
    assert isinstance(ring, NativeRing)
    np.testing.assert_array_equal(got, jgot)
    np.testing.assert_array_equal(got, exp)
    assert st == jst
    assert st['ngood_bytes'] + st['nmissing_bytes'] == 24 * NSRC * PAY
    assert st['nmissing_bytes'] == 4 * PAY
    assert st['ninvalid'] == 1
    if engine == 'python':
        assert (st['nlate'], st['nalien'], st['ndup']) == (2, 1, 1)
        hname = 'capture.%s.reorder_depth' % name
        assert _hist(thist, hname) == _hist(jhist, hname)
        assert _hist(thist, hname)[0] > 0
    else:
        assert st['nignored'] == 3          # 2 late + 1 alien
    # the port counts every committed span on ring.<name>.gulps, the C
    # engine's commits included
    assert tcounters.get('ring.%s.gulps' % name) == 3


def test_disk_reader_equals_jax(tmp_path):
    """The same packets written by both packages' DiskWriter (equal
    files) and replayed by both DiskReaders: equal ring bytes and
    ledgers."""
    pkts, tail, exp = _stream(0, 24, LATE, runt=False)
    pkts = pkts + tail
    hi = TW.HeaderInfo()
    hi.set_nsrc(NSRC)
    jhi = JW.HeaderInfo()
    jhi.set_nsrc(NSRC)
    files = {}
    for pkg, (U, F, C, W, R), h in (('port',) + (PKGS['port'], hi),
                                    ('jax',) + (PKGS['jax'], jhi)):
        path = str(tmp_path / ('%s.dat' % pkg))
        with open(path, 'wb') as f:
            with W.DiskWriter('chips', f) as dw:
                dw.send(h, 1, 1, 0, 1, exp[:8])
        files[pkg] = path
    assert open(files['port'], 'rb').read() == \
        open(files['jax'], 'rb').read()
    stream = str(tmp_path / 'stream.dat')
    with open(stream, 'wb') as f:
        f.write(b''.join(pkts))
    out = {}
    name = _name('disk')
    for pkg in ('port', 'jax'):
        U, F, C, W, R = PKGS[pkg]
        ring = R.Ring(space='system', name=name)
        with open(stream, 'rb') as f:
            cap = C.DiskReader('chips', f, ring, NSRC, 0, PAY, 8, 8,
                               _header)
            assert cap.tell() == 0
            _run_capture(cap, C)
        out[pkg] = (_read_ring(ring, 64), _stats(cap.stats))
    np.testing.assert_array_equal(out['port'][0], out['jax'][0])
    np.testing.assert_array_equal(out['port'][0], exp)
    assert out['port'][1] == out['jax'][1]
    assert (out['port'][1]['nlate'], out['port'][1]['nalien'],
            out['port'][1]['ndup']) == (2, 1, 1)


def _sharded(pkg, nthreads, pkts, tail, first, name,
             ring_space='system', zero_copy=True):
    """Sharded capture of ``pkts`` after ``first`` (which fixes seq0),
    then ``tail``: each part is sent once the engine has received the
    one before (so a duplicate never shares a receive batch with its
    original), and the engine ends once every datagram was received."""
    U, F, C, W, R = PKGS[pkg]
    ring = R.Ring(space=ring_space, name=name)
    cap = C.ShardedUDPCapture(
        'chips', U.Address('127.0.0.1', 0), ring, NSRC, 0, PAY, 64, 64,
        _header, nthreads=nthreads, vlen=8, zero_copy=zero_copy,
        frame_size=F.ChipsFormat().header_size + PAY, timeout=0.25)
    port = cap._socks[0].sock.getsockname()[1]
    txs = [U.UDPSocket().connect(U.Address('127.0.0.1', port))
           for _ in range(NSRC)]
    try:
        txs[0].send(first)
        deadline = time.monotonic() + 60
        while cap._seq0 is None and time.monotonic() < deadline:
            time.sleep(0.005)
        assert cap._seq0 is not None
        n = 1
        for part in (pkts, tail):
            for p in part:
                # one socket a source: one flow each, as the wire has it
                src = p[0] - 1 if len(p) > 16 else 0
                txs[min(max(src, 0), NSRC - 1)].send(p)
            n += len(part)
            while cap.stats['nreceived'] < n and \
                    time.monotonic() < deadline:
                time.sleep(0.005)
            assert cap.stats['nreceived'] == n
    finally:
        cap.end()
        for t in txs:
            t.close()
    return _read_ring(ring, 128), _stats(cap.stats), cap


@pytest.mark.parametrize('zero_copy', [False, True])
@pytest.mark.parametrize('reorder', [False, True])
@pytest.mark.parametrize('nthreads', [1, 4])
def test_sharded_capture_equals_jax(nthreads, reorder, zero_copy):
    """One span of 64 frames (seq0 64, so frame 5 is late) through the
    sharded engine; at 4 workers each source is steered to its own
    worker.  The ledger equals the JAX engine's, and the port's bytes
    are the packets sent.  On the staged path the JAX engine's bytes are
    too; with the zero-copy scatter they are not compared: the JAX
    engine's cursor can fall below cells it received (a reordered batch,
    or a duplicate then a late packet) and its next scatter overwrites
    them (ROADMAP queue 3), which the port's claim never does."""
    pkts, tail, exp = _stream(64, 64, ((5, 2),), shuffle=reorder)
    first, pkts = pkts[0], pkts[1:]
    name = _name('sharded%d' % nthreads)
    got, st, cap = _sharded('port', nthreads, pkts, tail, first, name,
                            zero_copy=zero_copy)
    jgot, jst, jcap = _sharded('jax', nthreads, pkts, tail, first, name,
                               zero_copy=zero_copy)
    np.testing.assert_array_equal(got, exp)
    if not zero_copy:
        np.testing.assert_array_equal(jgot, exp)
    assert st == jst
    assert st['ngood_bytes'] == (64 * NSRC - 4) * PAY
    assert st['nmissing_bytes'] == 4 * PAY
    assert (st['nlate'], st['nalien'], st['ndup'], st['ninvalid']) == \
        (1, 1, 1, 1)
    n = len(pkts) + len(tail) + 1
    assert st['nreceived'] == n
    assert sum(w['npackets'] for w in cap._wstats) == \
        sum(w['npackets'] for w in jcap._wstats) == n
    assert cap._zero_copy_ok == jcap._zero_copy_ok == zero_copy
    if zero_copy and nthreads == 4 and cap._steered:
        assert sum(w['zero_copy'] for w in cap._wstats) > 0
    if not zero_copy:
        assert sum(w['zero_copy'] for w in cap._wstats) == 0
    assert tcounters.get('ring.%s.gulps' % name) == 1


def test_sharded_zero_copy_stress_more_workers_than_cores():
    """16 zero-copy workers (more than this host's cores, most of them
    idle), the thread switch interval cut to 10 us, a reordered stream:
    the bytes are the packets sent and every packet is in the ledger."""
    import sys
    pkts, tail, exp = _stream(64, 64, ((5, 2),), shuffle=True)
    first, pkts = pkts[0], pkts[1:]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        got, st, cap = _sharded('port', 16, pkts, tail, first,
                                _name('stress'))
    finally:
        sys.setswitchinterval(old)
    np.testing.assert_array_equal(got, exp)
    assert st['ngood_bytes'] // PAY + st['nlate'] + st['nalien'] + \
        st['ndup'] + st['ninvalid'] == st['nreceived']
    assert st['ngood_bytes'] + st['nmissing_bytes'] == 64 * NSRC * PAY


def test_sharded_capture_into_the_python_ring_core(monkeypatch):
    """The sharded engine scatters into a Python-core 'system' ring (a
    numpy buffer) as into the native ring's C buffer: the same bytes and
    ledger."""
    pkts, tail, exp = _stream(64, 64, ((5, 2),), shuffle=False)
    first, pkts = pkts[0], pkts[1:]
    got_n, st_n, _ = _sharded('port', 4, pkts, tail, first, _name('shn'))
    monkeypatch.setenv('BF_NO_NATIVE', '1')
    ring_name = _name('shp')
    got_p, st_p, cap = _sharded('port', 4, pkts, tail, first, ring_name)
    assert type(cap.ring) is TR.Ring
    np.testing.assert_array_equal(got_p, exp)
    np.testing.assert_array_equal(got_p, got_n)
    assert st_p == st_n


def test_native_transmit_wire_bytes_equal_python_and_jax(monkeypatch):
    """For every format: the port's native transmit engine, its Python
    transmitter and both of the JAX package's put the same bytes on the
    wire."""
    if not jnative.available():
        pytest.skip('the JAX native library did not build')
    for fmt_name in sorted(JT.ALL_FORMAT_CASES):
        case = JT.ALL_FORMAT_CASES[fmt_name]
        nsrc, payload = case['nsrc'], case['payload']
        data = np.arange(2 * nsrc * payload,
                         dtype=np.uint8).reshape(2, nsrc, payload)
        wires = {}
        for pkg, switch in itertools.product(('port', 'jax'),
                                             ('native', 'python')):
            if switch == 'python':
                monkeypatch.setenv('BF_NO_NATIVE_CAPTURE', '1')
            else:
                monkeypatch.delenv('BF_NO_NATIVE_CAPTURE', raising=False)
            U, F, C, W, R = PKGS[pkg]
            tx_fmt = case['tx_fmt']
            if callable(tx_fmt):
                tx_fmt = tx_fmt()
                tx_fmt = getattr(F, type(tx_fmt).__name__)(
                    **{k: getattr(tx_fmt, k) for k in
                       ('frames_per_second',) if hasattr(tx_fmt, k)})
            rx = U.UDPSocket().bind(U.Address('127.0.0.1', 0))
            rx.set_timeout(5.0)
            sock = U.UDPSocket().connect(
                U.Address('127.0.0.1', rx.sock.getsockname()[1]))
            hi = W.HeaderInfo()
            hi.set_nsrc(nsrc)
            hi.set_nchan(16)
            hi.set_gain(3)
            if case['hi_setup']:
                case['hi_setup'](hi)
            with W.UDPTransmit(tx_fmt, sock) as tx:
                assert type(tx).__name__ == (
                    'NativeUDPTransmit' if switch == 'native'
                    else 'UDPTransmit'), (pkg, switch)
                for i in range(2):
                    for j in range(nsrc):
                        tx.send(hi, case['wire_seq'](i), 1,
                                case['tx_src'](j), 1,
                                data[i, j].reshape(1, 1, -1))
                assert tx.npackets_sent == 2 * nsrc
            wires[pkg, switch] = [rx.recv(16384) for _ in range(2 * nsrc)]
            sock.close()
            rx.close()
        ref = wires['jax', 'python']
        for key, w in wires.items():
            assert w == ref, (fmt_name, key)


# ---------------------------------------------------------------------------
# engine dispatch: no hidden fallback
# ---------------------------------------------------------------------------

def _loopback_pair():
    rx = TU.UDPSocket().bind(TU.Address('127.0.0.1', 0))
    tx = TU.UDPSocket().connect(
        TU.Address('127.0.0.1', rx.sock.getsockname()[1]))
    return rx, tx


def test_engine_dispatch_and_the_one_switch(monkeypatch):
    """A native ring with a native codec gets the C engine; the Python
    core's ring and BF_NO_NATIVE_CAPTURE=1 get the Python engine; the
    transmit side follows the same switch (and BF_NO_NATIVE)."""
    rx, tx = _loopback_pair()
    try:
        ring = TR.Ring(space='system', name=_name('dispatch'))
        assert isinstance(ring, NativeRing)
        cap = TC.UDPCapture('chips', rx, ring, NSRC, 0, PAY, 8, 8,
                            _header)
        assert type(cap) is TC.NativeUDPCapture
        assert type(TW.UDPTransmit('chips', tx)) is TW.NativeUDPTransmit
        monkeypatch.setenv('BF_NO_NATIVE_CAPTURE', '1')
        cap = TC.UDPCapture('chips', rx, TR.Ring(space='system'), NSRC, 0,
                            PAY, 8, 8, _header)
        assert type(cap) is TC.UDPCapture
        assert type(TW.UDPTransmit('chips', tx)) is TW.UDPTransmit
        monkeypatch.delenv('BF_NO_NATIVE_CAPTURE')
        monkeypatch.setenv('BF_NO_NATIVE', '1')
        pring = TR.Ring(space='system')
        assert type(pring) is TR.Ring
        assert type(TC.UDPCapture('chips', rx, pring, NSRC, 0, PAY, 8, 8,
                                  _header)) is TC.UDPCapture
        assert type(TW.UDPTransmit('chips', tx)) is TW.UDPTransmit
        # a format without a C codec takes the Python engine
        monkeypatch.delenv('BF_NO_NATIVE')
        fmt = TF.ChipsFormat()
        fmt.name = 'chips2'
        assert type(TC.UDPCapture(fmt, rx, TR.Ring(space='system'), NSRC,
                                  0, PAY, 8, 8, _header)) is TC.UDPCapture
    finally:
        rx.close()
        tx.close()


def test_failed_native_build_raises_from_capture_and_transmit(
        monkeypatch, tmp_path):
    """A native library that does not build raises NativeError from
    UDPCapture(...) and UDPTransmit(...); the JAX package would take its
    Python engines quietly."""
    rx, tx = _loopback_pair()
    try:
        ring = TR.Ring(space='system', name=_name('broken'))
        assert isinstance(ring, NativeRing)
        src = tmp_path / 'src'
        src.mkdir()
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        for name in native.SOURCES:
            text = open(os.path.join(root, 'native', name)).read()
            if name == 'capture.cpp':
                text += '\nthis is not C++;\n'
            (src / name).write_text(text)
        monkeypatch.setattr(native, '_source_dir', lambda: str(src))
        monkeypatch.setattr(native, '_build_dir',
                            lambda: str(tmp_path / 'build'))
        monkeypatch.setattr(native, '_lib', None)
        monkeypatch.setattr(native, '_io_engine_supported', None)
        with pytest.raises(native.NativeError, match='this is not C'):
            TC.UDPCapture('chips', rx, ring, NSRC, 0, PAY, 8, 8, _header)
        with pytest.raises(native.NativeError, match='this is not C'):
            TW.UDPTransmit('chips', tx)
        # the one switch still gives the Python engines
        monkeypatch.setenv('BF_NO_NATIVE_CAPTURE', '1')
        assert type(TC.UDPCapture('chips', rx, ring, NSRC, 0, PAY, 8, 8,
                                  _header)) is TC.UDPCapture
        assert type(TW.UDPTransmit('chips', tx)) is TW.UDPTransmit
    finally:
        rx.close()
        tx.close()


def test_library_without_the_engines_raises(monkeypatch):
    rx, tx = _loopback_pair()
    try:
        ring = TR.Ring(space='system', name=_name('stub'))
        monkeypatch.setattr(native, 'io_engine_supported', lambda: False)
        with pytest.raises(native.NativeError, match='without the capture'):
            TC.UDPCapture('chips', rx, ring, NSRC, 0, PAY, 8, 8, _header)
        with pytest.raises(native.NativeError, match='without the capture'):
            TW.UDPTransmit('chips', tx)
    finally:
        rx.close()
        tx.close()


# ---------------------------------------------------------------------------
# the C engine's commits, seen by the Python side of the ring
# ---------------------------------------------------------------------------

def test_native_commits_reach_counters_occupancy_and_the_checker():
    """Under BF_RINGCHECK a guaranteed reader runs beside the C engine:
    no violation, the checker's committed head is the core's, every span
    is counted on ring.<name>.gulps, and occupancy() reports the end of
    writing."""
    ringcheck.reset()
    ringcheck.set_enabled(True)
    rx, tx = _loopback_pair()
    rx.set_timeout(0.3)
    try:
        name = _name('seen')
        ring = TR.Ring(space='system', name=name)
        cap = TC.UDPCapture('chips', rx, ring, NSRC, 0, PAY, 8, 8, _header)
        assert type(cap) is TC.NativeUDPCapture and ring._external_writer
        pkts, tail, exp = _stream(0, 24, LATE)
        pkts = pkts + tail
        got = []
        attached = threading.Event()

        def read():
            for seq in ring.read(guarantee=True):
                attached.set()
                for span in seq.read(8):
                    got.append(np.array(span.data.as_numpy(), copy=True))
                break

        rt = threading.Thread(target=read, daemon=True)
        rt.start()
        for p in pkts:
            tx.send(p)
        _run_capture(cap, TC)
        join_bounded(rt)
        np.testing.assert_array_equal(np.concatenate(got), exp)
        assert ringcheck.violations() == []
        shadow = ring._rc_shadow
        assert shadow.head_known and shadow.head == ring._tail_head()[1]
        assert tcounters.get('ring.%s.gulps' % name) == 3
        assert ring.occupancy()['eod'] is True
    finally:
        ringcheck.set_enabled(False)
        ringcheck.reset()
        rx.close()
        tx.close()


def test_capture_into_a_python_core_ring_equals_native_core(monkeypatch):
    """The Python engine writes the same bytes into a Python-core ring
    and into a native one."""
    monkeypatch.setenv('BF_NO_NATIVE_CAPTURE', '1')
    pkts, tail, exp = _stream(0, 24, LATE)
    pkts = pkts + tail
    got_n, st_n, _, ring_n = _single_socket_capture(
        'port', 'python', pkts, _name('pn'))
    monkeypatch.setenv('BF_NO_NATIVE', '1')
    got_p, st_p, _, ring_p = _single_socket_capture(
        'port', 'python', pkts, _name('pp'))
    assert isinstance(ring_n, NativeRing) and type(ring_p) is TR.Ring
    np.testing.assert_array_equal(got_n, got_p)
    assert st_n == st_p


# ---------------------------------------------------------------------------
# sockets
# ---------------------------------------------------------------------------

def test_retry_transient_counts_and_gives_up_like_jax(monkeypatch):
    import errno
    monkeypatch.setenv('BF_IO_RETRY_BACKOFF', '0.0001')
    monkeypatch.setenv('BF_IO_RETRY_MAX', '3')
    for mod, ctr in ((TU, tcounters), (JU, jcounters)):
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise OSError(errno.EINTR, 'interrupted')
            return 'ok'

        before = ctr.get('io.socket_retries')
        assert mod.retry_transient(flaky) == 'ok'
        assert ctr.get('io.socket_retries') - before == 2

        def refused():
            raise OSError(errno.ECONNREFUSED, 'refused')

        with pytest.raises(OSError):
            mod.retry_transient(refused)
        assert ctr.get('io.socket_retries') - before == 5

        def other():
            raise OSError(errno.EBADF, 'bad')

        with pytest.raises(OSError):
            mod.retry_transient(other)
        assert ctr.get('io.socket_retries') - before == 5
        for n in (1, 3, 10):
            assert 0 <= mod.retry_backoff_s(n, 0.01, 0.05) <= 0.05


@pytest.mark.parametrize('name', ['test_send_recv_mmsg_roundtrip',
                                  'test_format_roundtrips',
                                  'test_udp_sniffer_loopback'])
def test_jax_socket_cases_on_the_port(name):
    """The JAX package's socket-level tests on the port's modules (the
    sniffer skips where a raw socket cannot be opened, as there)."""
    rehome(getattr(JT, name), UDP_MAP)()


def test_recv_mmsg_scatter_lands_payloads_at_their_addresses():
    """The zero-copy receive: headers in the sidecar, payloads straight
    at the given addresses, true lengths reported (a short datagram
    shows its own length)."""
    rx, tx = _loopback_pair()
    rx.set_timeout(1.0)
    try:
        dst = np.zeros((3, PAY), np.uint8)
        pkts = [_chips(f, 1) for f in range(3)]
        pkts[2] = pkts[2][:40]
        for p in pkts:
            tx.send(p)
        deadline = time.monotonic() + 30
        import select
        while not select.select([rx.sock], [], [], 0.1)[0]:
            assert time.monotonic() < deadline
        addrs = dst.ctypes.data + np.arange(3, dtype=np.uint64) * PAY
        got = 0
        heads, lens = [], []
        while got < 3 and time.monotonic() < deadline:
            side, ln = rx.recv_mmsg_scatter(addrs[got:], 16, PAY)
            if side is None:
                time.sleep(0.01)
                continue
            heads.append(bytes(side[:16 * len(ln)]))
            lens.extend(ln)
            got += len(ln)
        assert lens == [16 + PAY, 16 + PAY, 40]
        for f in range(2):
            assert dst[f].tobytes() == _payload(f, 1)
        assert dst[2, :24].tobytes() == _payload(2, 1)[:24]
        assert b''.join(heads)[:16] == pkts[0][:16]
    finally:
        rx.close()
        tx.close()
