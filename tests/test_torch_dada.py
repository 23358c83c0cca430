"""The port's PSRDADA tier (``bifrost_tpu_torch.io.dada_shm``,
``bifrost_tpu_torch.blocks.psrdada``) against the JAX package's:

- the cases of ``tests/test_dada_shm.py`` run against the port's modules
  (on keys of their own, so they never meet the JAX tests' segments);
- the two packages share segments: a ring written by one is read by the
  other, both ways;
- ``read_psrdada_buffer`` and ``read_dada_file`` through the port's
  pipeline give the bytes and headers the JAX blocks give; a stalled
  writer does not keep the port's pipeline from shutting down.

Every segment is destroyed on the way out, also when a test fails.
Skipped where System V shared memory is not available, as the JAX tests
are.
"""

import threading

import numpy as np
import pytest

import bifrost_tpu as bf
import bifrost_tpu.io.dada_shm as JD
import bifrost_tpu_torch as bt
import bifrost_tpu_torch.blocks.psrdada as TP
import bifrost_tpu_torch.io.dada_shm as TD
from bifrost_tpu_torch import device

from tests import test_dada_shm as JT
from tests.test_torch_bounded import join_bounded, run_bounded
from tests.test_torch_wire_formats import rehome
from tests.util import GatherSink

pytestmark = pytest.mark.skipif(not TD.sysv_available(),
                                reason="System V shm unavailable")

DADA_MAP = {'bifrost_tpu.io.dada_shm': TD,
            'bifrost_tpu.blocks.psrdada': TP}
#: keys of this module's segments (the JAX tests use 0x5bf0 + ...)
_KEY = 0x6bf0


@pytest.fixture(autouse=True)
def _cpu():
    device.set_device('cpu')


NEEDS_ACCOUNTING = ('test_stale_segment_recreation',
                    'test_live_ring_not_destroyed')
JAX_CASES = ('test_ipcring_flow_control_and_eod',
             'test_hdu_header_roundtrip',
             'test_stale_segment_recreation',
             'test_live_ring_not_destroyed',
             'test_psrdada_sync_golden_decode',
             'test_psrdada_sync_shm_read_and_emit',
             'test_dada_header_page_golden_decode')


@pytest.mark.parametrize('name', JAX_CASES)
def test_jax_dada_cases_on_the_port(name):
    """The JAX package's DADA cases on the port's modules.  (The stale
    segment case's crashed writer is a JAX-package process: the port
    recovers the segment the other package left.)"""
    if name in NEEDS_ACCOUNTING and not TD.shm_accounting_available():
        pytest.skip("SysV shm attachment accounting unavailable")
    rehome(getattr(JT, name), DADA_MAP, _KEY=_KEY)()


class _Gather(bt.SinkBlock):
    def __init__(self, iring):
        super(_Gather, self).__init__(iring)
        self.headers, self.gulps = [], []

    def on_sequence(self, iseq):
        self.headers.append(iseq.header)

    def on_data(self, ispan):
        self.gulps.append(np.array(ispan.data.as_numpy(), copy=True))


HDR = {'NBIT': 8, 'NCHAN': 4, 'NPOL': 2, 'NDIM': 1, 'TSAMP': 10.0,
       'FREQ': 1400.0, 'BW': 16.0, 'SOURCE': 'J0000+0000'}


def _ingest(pkg, key, data):
    """Write one observation with the JAX package's writer; read it with
    ``pkg``'s read_psrdada_buffer through its pipeline."""
    hdu = JD.DadaHDU(key, create=True, data_nbufs=4, data_bufsz=256)
    try:
        def writer():
            hdu.write_header(HDR)
            hdu.write_data(data, eod=True)

        t = threading.Thread(target=writer, daemon=True)
        t.start()
        if pkg == 'port':
            with bt.Pipeline() as p:
                sink = _Gather(bt.blocks.read_psrdada_buffer(
                    key, gulp_nframe=16))
                run_bounded(p)
            out = np.concatenate(sink.gulps)
        else:
            with bf.Pipeline() as p:
                sink = GatherSink(bf.blocks.read_psrdada_buffer(
                    key, gulp_nframe=16))
                run_bounded(p)
            out = sink.result()
        join_bounded(t)
        return out, sink.headers[0]
    finally:
        hdu.destroy()


def test_psrdada_pipeline_ingest_equals_jax():
    rng = np.random.RandomState(0)
    data = rng.randint(0, 255, size=(64, 4, 2)).astype(np.uint8)
    got, hdr = _ingest('port', _KEY + 0x60, data)
    want, jhdr = _ingest('jax', _KEY + 0x61, data)
    assert got.shape == want.shape == (64, 4, 2)
    np.testing.assert_array_equal(got.view(np.uint8), data)
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))
    assert hdr['_tensor'] == jhdr['_tensor']
    assert hdr['dada_header'] == jhdr['dada_header']
    assert hdr['dada_header']['NCHAN'] == 4
    assert hdr['source_name'] == 'J0000+0000'
    assert hdr['name'] == 'psrdada_%x' % (_KEY + 0x60)


@pytest.mark.parametrize('writer,reader', [('port', 'jax'), ('jax', 'port')])
def test_segments_are_shared_between_the_packages(writer, reader):
    """A ring made and filled by one package is read by the other: the
    sync segment, the buffers and the semaphores are one layout."""
    W = TD if writer == 'port' else JD
    R = TD if reader == 'port' else JD
    key = _KEY + (0x70 if writer == 'port' else 0x78)
    ring = W.IpcRing(key, nbufs=2, bufsz=64, create=True)
    try:
        peer = R.IpcRing(key)
        got = []

        def read():
            while True:
                res = peer.open_read_buf(timeout=30)
                assert res is not None
                buf, n, eod = res
                got.append(bytes(buf[:n]))
                peer.mark_cleared()
                if eod:
                    return

        t = threading.Thread(target=read, daemon=True)
        t.start()
        for k in range(5):
            w = ring.open_write_buf()
            w[:] = k + 1
            ring.mark_filled()
        w = ring.open_write_buf()
        w[:7] = 9
        ring.mark_filled(7, eod=True)
        join_bounded(t)
        assert got == [bytes([k + 1]) * 64 for k in range(5)] + \
            [bytes([9]) * 7]
        hdu = W.DadaHDU(key + 0x4, create=True, data_nbufs=2,
                        data_bufsz=64)
        try:
            hdu.write_header(HDR)
            text = R.DadaHDU(key + 0x4).read_header(timeout=30)
            assert b'NCHAN 4' in text and b'SOURCE J0000+0000' in text
        finally:
            hdu.destroy()
    finally:
        ring.destroy()


def test_psrdada_shutdown_with_stalled_writer():
    """As the JAX test of the same name, on the port's block and
    pipeline: the source waits on the semaphore in timed slices and sees
    the shutdown."""
    import time
    key = _KEY + 0x30
    hdu = TD.DadaHDU(key, create=True, data_nbufs=2, data_bufsz=64)
    try:
        box = {}

        def run():
            try:
                p.run()
            except bt.PipelineInitError as exc:
                # the source saw the shutdown before any header came
                box['exc'] = exc

        with bt.Pipeline() as p:
            _Gather(bt.blocks.read_psrdada_buffer(key, gulp_nframe=4))
            t = threading.Thread(target=run, daemon=True)
            t.start()
            time.sleep(0.5)
            p.shutdown()
            join_bounded(t)
        assert 'exc' not in box or 'PsrdadaSourceBlock' in str(box['exc'])
    finally:
        hdu.destroy()


def test_read_dada_file_equals_jax(tmp_path):
    """A .dada file (a 4096-byte ASCII header page, then ci8 data) read
    by both packages' read_dada_file: the same bytes, gulps and
    headers."""
    page = ('HDR_VERSION 1.0\nHDR_SIZE 4096\nNBIT 8\nNDIM 2\nNPOL 2\n'
            'NCHAN 3\nTSAMP 0.64\nFREQ 74.0\nBW 19.6\nSOURCE B0329+54\n'
            'TELESCOPE LWA-SV\n').encode()
    page += b'\x00' * (4096 - len(page))
    rng = np.random.RandomState(3)
    data = rng.randint(-128, 128, size=(50, 3, 2, 2)).astype(np.int8)
    path = str(tmp_path / 'obs.dada')
    with open(path, 'wb') as f:
        f.write(page + data.tobytes())
    with bt.Pipeline() as p:
        sink = _Gather(bt.blocks.read_dada_file([path], 16))
        run_bounded(p)
    with bf.Pipeline() as p:
        jsink = GatherSink(bf.blocks.read_dada_file([path], 16))
        run_bounded(p)
    got = np.concatenate(sink.gulps)
    want = jsink.result()
    assert [g.shape[0] for g in sink.gulps] == \
        [g.shape[0] for g in jsink.gulps] == [16, 16, 16, 2]
    assert got.view(np.int8).tobytes() == want.view(np.int8).tobytes() == \
        data.tobytes()
    assert sink.headers[0]['_tensor'] == jsink.headers[0]['_tensor']
    assert sink.headers[0]['_tensor']['dtype'] == 'ci8'
    assert sink.headers[0]['dada_header'] == jsink.headers[0]['dada_header']
