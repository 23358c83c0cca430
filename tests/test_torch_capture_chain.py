"""The slice's chain at small width through both packages: CHIPS packets
carrying (freq, stand, pol) ci4 payloads from 2 sources x 4 channels x
4 stands, captured into a ring, then

    capture ring -> copy('cuda') -> transpose(time, freq, src, stand, pol)
    -> merge_axes(src, stand) -> correlate(R, int8, K7 forced)
    -> accumulate(A) -> copy('system')

(the LWA-style correlator front end ``chip_smoke.py`` runs at full width
on the card).  From one packet file the port's visibilities equal the
JAX package's exactly, and an int64 numpy oracle's; the native engine
fed by a loopback burst gives the same visibilities as the packet file.

The JAX chain transposes and merges on the host before its copy: a JAX
device ring read through a view hands out the base layout (ROADMAP queue
3, "Weak spots in the reference"); the port transposes on the device as
the card does.
"""

import io
import threading

import numpy as np
import pytest

import bifrost_tpu as bf
import bifrost_tpu.io.packet_capture as JC
import bifrost_tpu.io.packet_writer as JW
import bifrost_tpu_torch as bt
import bifrost_tpu_torch.io.packet_capture as TC
import bifrost_tpu_torch.io.packet_writer as TW
from bifrost_tpu_torch import device
from bifrost_tpu_torch.io.udp_socket import Address, UDPSocket
from bifrost_tpu_torch.ring_native import NativeRing

from tests.test_torch_bounded import join_bounded, run_bounded
from tests.util import GatherSink

NSRC, NCHAN, NSTAND, NPOL = 2, 4, 4, 2
PAY = NCHAN * NSTAND * NPOL            # ci4: one byte a complex sample
BUF, R, A = 8, 8, 2
NFRAME = 4 * BUF                       # the capture ring's four spans
N = NSRC * NSTAND * NPOL


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    device.set_device('cpu')
    monkeypatch.delenv('BF_NO_NATIVE', raising=False)
    monkeypatch.delenv('BF_NO_NATIVE_CAPTURE', raising=False)


def _header(desc):
    return 0, {'name': 'chips-ci4', 'time_tag': 0, '_tensor': {
        'shape': [-1, NSRC, NCHAN, NSTAND, NPOL], 'dtype': 'ci4',
        'labels': ['time', 'src', 'freq', 'stand', 'pol'],
        'scales': [[0, 1], [0, NSTAND], [0, 1], [0, 1], [0, 1]],
        'units': [None] * 5}}


def _payloads(seed=7):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 256, (NFRAME, NSRC, PAY)).astype(np.uint8)


def _packet_file(W, data):
    f = io.BytesIO()
    hi = W.HeaderInfo()
    hi.set_nsrc(NSRC)
    hi.set_nchan(NCHAN)
    with W.DiskWriter('chips', f) as dw:
        dw.send(hi, 1, 1, 0, 1, data)      # CHIPS wire seq is 1-based
    return f.getvalue()


def _capture(C, ring, raw):
    cap = C.DiskReader('chips', io.BytesIO(raw), ring, NSRC, 0, PAY, BUF,
                       BUF, _header)
    for _ in range(100):
        if cap.recv() in (C.CAPTURE_NO_DATA, C.CAPTURE_INTERRUPTED):
            break
    cap.end()
    return cap


class _Gather(bt.SinkBlock):
    def __init__(self, iring):
        super(_Gather, self).__init__(iring)
        self.headers, self.gulps = [], []

    def on_sequence(self, iseq):
        self.headers.append(iseq.header)

    def on_data(self, ispan):
        self.gulps.append(np.array(ispan.data.as_numpy(), copy=True))


def _port_chain(ring):
    with bt.Pipeline() as p:
        b = bt.blocks.copy(ring, space='cuda')
        b = bt.blocks.transpose(b, ['time', 'freq', 'src', 'stand', 'pol'])
        b = bt.views.merge_axes(b, 'src', 'stand', label='station')
        b = bt.blocks.correlate(b, R, accuracy='int8', impl='pallas')
        b = bt.blocks.accumulate(b, A)
        sink = _Gather(bt.blocks.copy(b, space='system'))
        run_bounded(p)
    return np.concatenate(sink.gulps), sink.headers[0]


def _jax_chain(ring):
    with bf.Pipeline() as p:
        b = bf.blocks.transpose(ring, ['time', 'freq', 'src', 'stand', 'pol'])
        b = bf.views.merge_axes(b, 'src', 'stand', label='station')
        b = bf.blocks.copy(b, space='tpu')
        b = bf.blocks.correlate(b, R, accuracy='int8')
        b = bf.blocks.accumulate(b, A)
        sink = GatherSink(bf.blocks.copy(b, space='system'))
        run_bounded(p)
    return sink.result(), sink.headers[0]


def _oracle(data):
    """int64 visibilities of the payloads: ci4 nibbles (re high, im
    low), stations ordered (src, stand), pols fastest; one visibility
    per R frames, A of them summed."""
    s = data.view(np.int8)
    re = (s >> 4).astype(np.int64)
    im = ((data << 4).view(np.int8) >> 4).astype(np.int64)
    shape = (NFRAME, NSRC, NCHAN, NSTAND, NPOL)
    re = re.reshape(shape).transpose(0, 2, 1, 3, 4).reshape(NFRAME, NCHAN, N)
    im = im.reshape(shape).transpose(0, 2, 1, 3, 4).reshape(NFRAME, NCHAN, N)
    x = re + 1j * im
    g = NFRAME // (R * A)
    x = x.reshape(g, R * A, NCHAN, N)
    vis = np.einsum('gtfi,gtfj->gfij', x, np.conj(x))
    return vis.reshape(g, NCHAN, NSRC * NSTAND, NPOL, NSRC * NSTAND, NPOL)


def test_capture_chain_equals_jax_and_the_oracle():
    data = _payloads()
    raw = _packet_file(TW, data)
    assert raw == _packet_file(JW, data)
    ring = bt.Ring(space='system', name='tchain-port')
    cap = _capture(TC, ring, raw)
    assert cap.stats['ngood_bytes'] == NFRAME * NSRC * PAY
    assert cap.stats['nmissing_bytes'] == 0
    got, hdr = _port_chain(ring)
    jring = bf.Ring(space='system', name='tchain-jax')
    jcap = _capture(JC, jring, raw)
    assert {k: v for k, v in cap.stats.items() if k != 'src_ngood'} == \
        {k: v for k, v in jcap.stats.items() if k != 'src_ngood'}
    want, jhdr = _jax_chain(jring)
    assert got.dtype == np.complex64
    assert got.shape == (NFRAME // (R * A), NCHAN, NSRC * NSTAND, NPOL,
                         NSRC * NSTAND, NPOL)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _oracle(data))
    assert np.abs(got).max() > 0
    assert hdr['_tensor']['labels'] == jhdr['_tensor']['labels']
    assert hdr['_tensor']['shape'] == jhdr['_tensor']['shape']
    assert hdr['matrix_fill_mode'] == 'full'


def test_native_engine_from_loopback_gives_the_packet_file_result():
    """The same payloads sent over loopback (the port's native transmit
    engine) and taken by the native capture engine into a native ring:
    the chain's visibilities equal the packet file's."""
    data = _payloads(11)
    rx = UDPSocket().bind(Address('127.0.0.1', 0))
    rx.set_timeout(0.3)
    tx = UDPSocket().connect(Address('127.0.0.1', rx.sock.getsockname()[1]))
    try:
        ring = bt.Ring(space='system', name='tchain-native')
        cap = TC.UDPCapture('chips', rx, ring, NSRC, 0, PAY, BUF, BUF,
                            _header)
        assert isinstance(ring, NativeRing)
        assert isinstance(cap, TC.NativeUDPCapture)
        hi = TW.HeaderInfo()
        hi.set_nsrc(NSRC)
        hi.set_nchan(NCHAN)
        with TW.UDPTransmit('chips', tx) as t:
            assert isinstance(t, TW.NativeUDPTransmit)
            t.send(hi, 1, 1, 0, 1, data)

        def loop():
            try:
                for _ in range(100):
                    if cap.recv() in (TC.CAPTURE_NO_DATA,
                                      TC.CAPTURE_INTERRUPTED):
                        break
            finally:
                cap.end()

        th = threading.Thread(target=loop, daemon=True)
        th.start()
        join_bounded(th)
        assert cap.stats['ngood_bytes'] == NFRAME * NSRC * PAY
        got, _ = _port_chain(ring)
    finally:
        tx.close()
        rx.close()
    ring2 = bt.Ring(space='system', name='tchain-file')
    _capture(TC, ring2, _packet_file(TW, data))
    want, _ = _port_chain(ring2)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _oracle(data))
