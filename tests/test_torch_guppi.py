"""The GUPPI RAW front end of the PyTorch/CUDA port (``io.guppi`` and the
``read_guppi_raw`` block) against the JAX package on the same seeded
files: header records byte for byte, DIRECTIO padding, the NPOL 4 -> 2
convention and NTIME from BLOCSIZE, the block's header dict key for key
and its data byte-identical at NBITS 4, 8 and 16.  The port runs on the
CPU device here.  Everything is compared exactly.
"""

import io
import os

import numpy as np
import pytest

import bifrost_tpu as bf
from bifrost_tpu.io import guppi as JG

import bifrost_tpu_torch as bt
from bifrost_tpu_torch import device
from bifrost_tpu_torch.io import guppi as TG
from tests.test_torch_bounded import run_bounded


@pytest.fixture(autouse=True)
def _cpu():
    device.set_device('cpu')


def _untraced(hdr):
    return {k: v for k, v in hdr.items() if k != '_trace'}


def _hdr(nchan=4, npol=2, nbits=8, ntime=16, **extra):
    hdr = {'OBSNCHAN': nchan, 'NPOL': npol, 'NBITS': nbits,
           'BLOCSIZE': nchan * ntime * min(npol, 2) * 2 * nbits // 8,
           'OBSFREQ': 1500.0, 'OBSBW': -4.0, 'STT_IMJD': 58000,
           'STT_SMJD': 3600, 'PKTIDX': 0, 'PKTSIZE': 8192,
           'TELESCOP': 'GBT', 'BACKEND': 'GUPPI', 'SRC_NAME': 'B0329+54',
           'RA': 53.25, 'DEC': 54.5, 'AZ': 120.5, 'ZA': 30.25,
           'CHAN_DM': 26.8}
    hdr.update(extra)
    return hdr


@pytest.mark.parametrize('hdr', [
    _hdr(), _hdr(nbits=4, ntime=32), _hdr(nbits=16, npol=1),
    _hdr(NTIME=16), _hdr(npol=4)])
def test_header_records_equal_jax(hdr):
    """The writer's 80-character records equal the JAX writer's, and both
    readers parse them to the same dict (NPOL 4 counts complex
    components, so it reads as 2; NTIME comes from BLOCSIZE)."""
    t, j = io.BytesIO(), io.BytesIO()
    TG.write_header(t, hdr)
    JG.write_header(j, hdr)
    assert t.getvalue() == j.getvalue()
    assert len(t.getvalue()) % 80 == 0
    t.seek(0)
    j.seek(0)
    got, want = TG.read_header(t), JG.read_header(j)
    assert got == want
    assert t.tell() == j.tell() == len(t.getvalue())
    assert got['NPOL'] == (1 if hdr['NPOL'] == 1 else 2)
    assert got['NTIME'] == hdr['BLOCSIZE'] * 8 // (
        hdr['OBSNCHAN'] * got['NPOL'] * 2 * hdr['NBITS'])


@pytest.mark.parametrize('directio', [0, 1])
def test_directio_padding_is_skipped_as_jax_skips_it(directio):
    """With DIRECTIO set, the header is padded to a 512-byte boundary;
    both readers land on the payload, and the next block's header parses
    (end of file raises EOFError in both)."""
    hdr = _hdr(DIRECTIO=directio)
    payload = bytes(range(256)) * (hdr['BLOCSIZE'] // 256)
    f = io.BytesIO()
    for b in range(2):
        TG.write_header(f, dict(hdr, PKTIDX=b))
        if directio:
            f.write(b'\0' * ((-f.tell()) % 512))
        f.write(payload)
    data = f.getvalue()
    for mod in (TG, JG):
        g = io.BytesIO(data)
        h0 = mod.read_header(g)
        if directio:
            assert g.tell() % 512 == 0
        assert g.read(h0['BLOCSIZE']) == payload
        assert mod.read_header(g)['PKTIDX'] == 1
        g.read(h0['BLOCSIZE'])
        with pytest.raises(EOFError):
            mod.read_header(g)
    assert TG.read_header(io.BytesIO(data)) == \
        JG.read_header(io.BytesIO(data))


def _write_raw(path, hdr, nblock, seed):
    """A GUPPI file of ``nblock`` seeded random blocks; returns the
    payload bytes of each block."""
    rng = np.random.RandomState(seed)
    blocks = []
    with open(path, 'wb') as f:
        for b in range(nblock):
            JG.write_header(f, dict(hdr, PKTIDX=b * 4))
            raw = rng.randint(0, 256, size=hdr['BLOCSIZE']).astype(np.uint8)
            blocks.append(raw)
            f.write(raw.tobytes())
    return blocks


class _Gather(bt.SinkBlock):
    def __init__(self, iring):
        super(_Gather, self).__init__(iring)
        self.headers, self.gulps = [], []

    def on_sequence(self, iseq):
        self.headers.append(iseq.header)

    def on_data(self, ispan):
        self.gulps.append(np.array(ispan.data.as_numpy(), copy=True))


class _JaxGather(bf.SinkBlock):
    def __init__(self, iring):
        super(_JaxGather, self).__init__(iring)
        self.headers, self.gulps = [], []

    def on_sequence(self, iseq):
        self.headers.append(iseq.header)

    def on_data(self, ispan):
        self.gulps.append(np.array(ispan.data.as_numpy(), copy=True))


def _read(pkg, paths, gulp):
    sink_cls = _Gather if pkg is bt else _JaxGather
    with pkg.Pipeline() as p:
        sink = sink_cls(pkg.blocks.read_guppi_raw(paths, gulp_nframe=gulp))
        run_bounded(p)
    return sink


@pytest.mark.parametrize('nbits,npol,gulp', [
    (8, 2, 1), (8, 2, 2), (4, 2, 1), (4, 1, 3), (16, 2, 2), (16, 1, 1)])
def test_block_headers_and_bytes_equal_jax(nbits, npol, gulp, tmp_path):
    """read_guppi_raw gives the JAX block's header dict key for key
    (``_tensor`` scales, ``time_tag``, ``raj``, ...) and the file's
    payload bytes, gulp after gulp, a ragged last gulp included."""
    hdr = _hdr(nchan=3, npol=npol, nbits=nbits, ntime=8)
    path = str(tmp_path / 'obs.raw')
    blocks = _write_raw(path, hdr, 5, seed=nbits + npol)
    got, want = _read(bt, [path], gulp), _read(bf, [path], gulp)
    assert [_untraced(h) for h in got.headers] == \
        [_untraced(h) for h in want.headers]
    t = got.headers[0]['_tensor']
    assert t['dtype'] == 'ci%d' % nbits
    assert t['shape'] == [-1, 3, 8, npol]
    assert t['labels'] == ['time', 'freq', 'fine_time', 'pol']
    assert got.headers[0]['raj'] == pytest.approx(53.25 * 24 / 360)
    assert [g.shape[0] for g in got.gulps] == \
        [g.shape[0] for g in want.gulps]
    data = np.concatenate(got.gulps)
    assert data.dtype == np.concatenate(want.gulps).dtype
    assert data.tobytes() == np.concatenate(want.gulps).tobytes()
    assert data.view(np.uint8).reshape(5, -1).tobytes() == \
        np.stack(blocks).tobytes()


def test_two_files_give_two_sequences_equal_jax(tmp_path):
    paths = []
    for i, nbits in enumerate((8, 4)):
        paths.append(str(tmp_path / ('f%d.raw' % i)))
        _write_raw(paths[-1], _hdr(nbits=nbits, ntime=8, STT_SMJD=60 * i),
                   2, seed=i)
    got, want = _read(bt, paths, 1), _read(bf, paths, 1)
    assert len(got.headers) == 2
    assert [_untraced(h) for h in got.headers] == \
        [_untraced(h) for h in want.headers]
    assert got.headers[1]['time_tag'] > got.headers[0]['time_tag']
    assert b''.join(g.tobytes() for g in got.gulps) == \
        b''.join(g.tobytes() for g in want.gulps)


def test_truncated_block_raises(tmp_path):
    hdr = _hdr(ntime=8)
    path = str(tmp_path / 'cut.raw')
    _write_raw(path, hdr, 2, seed=3)
    with open(path, 'r+b') as f:
        f.truncate(os.path.getsize(path) - 5)
    with pytest.raises(bt.PipelineRuntimeError, match='truncated'):
        _read(bt, [path], 1)


def test_ci4_block_reaches_the_device_as_int8_pairs(tmp_path):
    """An NBITS 4 file through copy('cuda'): the device tensor holds the
    sign-extended (re, im) nibbles, re from the high one, as the JAX
    package's device representation holds them."""
    from bifrost_tpu import devrep as jdevrep
    hdr = _hdr(nbits=4, ntime=16)
    path = str(tmp_path / 'ci4.raw')
    blocks = _write_raw(path, hdr, 2, seed=9)
    seen = []

    class _Probe(bt.SinkBlock):
        def on_sequence(self, iseq):
            pass

        def on_data(self, ispan):
            seen.append(ispan.data.clone())

    with bt.Pipeline() as p:
        _Probe(bt.blocks.copy(bt.blocks.read_guppi_raw([path]),
                              space='cuda'))
        run_bounded(p)
    got = np.concatenate([t.numpy() for t in seen])
    b = np.stack(blocks).view(np.int8)
    want = np.stack([b >> 4, (b << 4) >> 4], axis=-1).reshape(got.shape)
    np.testing.assert_array_equal(got, want)
    from bifrost_tpu.dtype import ci4 as jci4
    jax_rep = np.asarray(jdevrep.to_device_rep(
        np.stack(blocks).view(jci4), 'ci4'))
    np.testing.assert_array_equal(got.reshape(jax_rep.shape), jax_rep)
