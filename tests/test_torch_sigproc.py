"""SIGPROC filterbank I/O and the axis transpose of the PyTorch/CUDA port
(``io.sigproc``, the read_sigproc and write_sigproc blocks, ``ops.transpose``
and the transpose block), against the JAX package on the same seeded files
and arrays, and the file -> transpose -> fdmt(max_dm) chain of BASELINE
config 3 at a small size through both packages' pipelines.  The port runs
on the CPU device here.  Everything is compared exactly: headers and file
bytes equal, data bit for bit.
"""

import contextlib
import os
from copy import deepcopy

import numpy as np
import pytest
import torch

import bifrost_tpu as bf
from bifrost_tpu.io import sigproc as JIO
from bifrost_tpu.ops.transpose import transpose as jax_transpose
from bifrost_tpu.blocks.transpose import _host_transpose as _jax_host_transpose

import bifrost_tpu_torch as bt
from bifrost_tpu_torch import device
from bifrost_tpu_torch.io import sigproc as TIO
from bifrost_tpu_torch.ops.transpose import transpose
from bifrost_tpu_torch.blocks.transpose import _host_transpose
from tests.test_torch_bounded import run_bounded


@pytest.fixture(autouse=True)
def _cpu(monkeypatch, tmp_path):
    device.set_device('cpu')
    monkeypatch.setenv('BF_CACHE_DIR', str(tmp_path / 'cache'))
    for var in ('BF_FDMT_IMPL', 'BF_FDMT_PROBE'):
        monkeypatch.delenv(var, raising=False)


def _untraced(hdr):
    return {k: v for k, v in hdr.items() if k != '_trace'}


HEADERS = [
    {'telescope_id': 6, 'machine_id': 0, 'data_type': 1, 'nchans': 16,
     'nifs': 1, 'nbits': 8, 'fch1': 1400.0, 'foff': -0.5,
     'tstart': 58000.25, 'tsamp': 6.4e-5, 'source_name': 'FRB121102'},
    {'telescope_id': 4, 'machine_id': 7, 'data_type': 1, 'nchans': 4096,
     'nifs': 2, 'nbits': 2, 'fch1': 1200.0, 'foff': 0.09765625,
     'tstart': 59123.5, 'tsamp': 6.4e-5, 'signed': 1, 'refdm': 557.0,
     'src_raj': 53158.0, 'src_dej': 330752.0, 'rawdatafile': 'x.raw',
     'az_start': 12.5, 'za_start': 30.0, 'barycentric': 0, 'nbeams': 13,
     'ibeam': 3},
    {'data_type': 2, 'nbits': 32, 'tstart': 0.0, 'tsamp': 1e-3,
     'nsamples': 77, 'period': 0.714, 'scan_number': 2},
]


@pytest.mark.parametrize('hdr', HEADERS)
def test_header_bytes_and_parse_equal_jax(hdr, tmp_path):
    """pack_header gives the JAX writer's bytes; both readers parse the
    file the other wrote to the same header."""
    assert TIO.pack_header(hdr) == JIO.pack_header(hdr)
    path = str(tmp_path / 'h.fil')
    with open(path, 'wb') as f:
        TIO.write_header(f, hdr)
        f.write(b'\0' * 64)
    with TIO.SigprocFile(path) as t, JIO.SigprocFile(path) as j:
        assert t.header == j.header
        assert t.header_size == j.header_size
        assert t.frame_nbyte == j.frame_nbyte
        assert t.nframe() == j.nframe()
    with pytest.raises(KeyError):
        TIO.pack_header(dict(hdr, bogus=1))


def _filterbank(path, nbits, signed, ntime, nifs, nchans, seed,
                fch1=1400.0, foff=-0.5, tsamp=1e-3):
    """Write a SIGPROC file with the JAX header writer; returns the
    unpacked samples (ntime, nifs, nchans)."""
    rng = np.random.RandomState(seed)
    n = ntime * nifs * nchans
    if nbits == 32:
        vals = rng.randn(n).astype(np.float32)
        raw = vals.tobytes()
    elif nbits >= 8:
        dt = {(8, 0): np.uint8, (8, 1): np.int8, (16, 0): np.uint16,
              (16, 1): np.int16}[(nbits, signed)]
        info = np.iinfo(dt)
        vals = rng.randint(info.min, info.max + 1, size=n).astype(dt)
        raw = vals.tobytes()
    else:
        lo, hi = (-(1 << (nbits - 1)), 1 << (nbits - 1)) if signed else \
            (0, 1 << nbits)
        vals = rng.randint(lo, hi, size=n)
        fields = (vals & ((1 << nbits) - 1)).astype(np.uint8)
        per = 8 // nbits
        packed = (fields.reshape(-1, per) <<
                  (np.arange(per) * nbits).astype(np.uint8)).sum(
                      axis=1).astype(np.uint8)
        raw = packed.tobytes()
        vals = vals.astype(np.int8 if signed else np.uint8)
    hdr = {'telescope_id': 6, 'machine_id': 0, 'data_type': 1,
           'nchans': nchans, 'nifs': nifs, 'nbits': nbits, 'fch1': fch1,
           'foff': foff, 'tstart': 58000.5, 'tsamp': tsamp,
           'source_name': 'TEST', 'refdm': 0.25}
    if signed:
        hdr['signed'] = 1
    with open(path, 'wb') as f:
        JIO.write_header(f, hdr)
        f.write(raw)
    return vals.reshape(ntime, nifs, nchans)


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


def _read(pkg, path, gulp, unpack=True, axis=0):
    sink_cls = _Gather if pkg is bt else _JaxGather
    with pkg.Pipeline() as p:
        src = pkg.blocks.read_sigproc([path], gulp, unpack=unpack)
        sink = sink_cls(src)
        run_bounded(p)
    return np.concatenate(sink.gulps, axis=axis), sink.headers


@pytest.mark.parametrize('nbits,signed,unpack', [
    (8, 0, True), (8, 1, True), (32, 0, True), (16, 1, True),
    (2, 0, True), (2, 1, True), (4, 0, True), (1, 0, True),
    (8, 0, False), (32, 0, False)])
def test_read_sigproc_equals_jax(nbits, signed, unpack, tmp_path):
    """read_sigproc of 1/2/4/8/16/32-bit files (a ragged final gulp
    included) gives the JAX block's headers and samples; sub-byte samples
    unpack LSB first to 8 bits.  unpack=False reads the stored bytes."""
    path = str(tmp_path / 'in.fil')
    want = _filterbank(path, nbits, signed, 45, 2, 16, seed=nbits + signed)
    got, hdrs = _read(bt, path, 8, unpack)
    jgot, jhdrs = _read(bf, path, 8, unpack)
    assert [_untraced(h) for h in hdrs] == [_untraced(h) for h in jhdrs]
    assert hdrs[0]['_tensor']['labels'] == ['time', 'pol', 'freq']
    np.testing.assert_array_equal(got, jgot)
    assert got.dtype == jgot.dtype and got.shape == (45, 2, 16)
    np.testing.assert_array_equal(got.astype(np.float64),
                                  want.astype(np.float64))


@pytest.mark.parametrize('nbits,signed', [(8, 0), (8, 1), (32, 0), (16, 0)])
def test_write_sigproc_files_byte_identical_to_jax(nbits, signed, tmp_path):
    """read_sigproc -> copy -> write_sigproc writes the same bytes in both
    packages, and the file reads back to the input samples."""
    src = str(tmp_path / 'in.fil')
    want = _filterbank(src, nbits, signed, 40, 1, 8, seed=3)
    outs = {}
    for pkg in (bt, bf):
        outdir = tmp_path / pkg.__name__
        outdir.mkdir()
        with pkg.Pipeline() as p:
            b = pkg.blocks.read_sigproc([src], 16)
            pkg.blocks.write_sigproc(pkg.blocks.copy(b), path=str(outdir))
            run_bounded(p)
        with open(os.path.join(str(outdir), 'in.fil'), 'rb') as f:
            outs[pkg.__name__] = f.read()
    assert outs['bifrost_tpu_torch'] == outs['bifrost_tpu']
    with TIO.SigprocFile(str(tmp_path / 'bifrost_tpu_torch' / 'in.fil')) \
            as sf:
        assert sf.header['nbits'] == nbits
        np.testing.assert_array_equal(sf.read(40), want)


def test_write_sigproc_rejects_complex_and_device_rings(tmp_path):
    hdr = {'name': 'c', '_tensor': {'shape': [-1, 1, 4], 'dtype': 'cf32',
                                    'labels': ['time', 'pol', 'freq'],
                                    'scales': [[0, 1], None, [1, 1]],
                                    'units': ['s', None, 'MHz']}}
    with bt.Pipeline():
        blk = bt.blocks.write_sigproc(bt.Ring(space='system'),
                                      path=str(tmp_path))

        class _Seq(object):
            header = hdr
        with pytest.raises(TypeError, match='complex'):
            blk.on_sequence(_Seq())
    assert bt.blocks.SigprocSinkBlock.define_valid_input_spaces(blk) == \
        ('system',)


# ---------------------------------------------------------------------------
# transpose
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('shape,axes', [
    ((300, 1, 200), (2, 1, 0)), ((128, 70), (1, 0)), ((8, 6, 4), (2, 0, 1)),
    ((5, 7), (1, 0)), ((64, 1, 64, 1), (2, 1, 0, 3))])
def test_host_transpose_equals_jax_and_numpy(shape, axes):
    """The cache-blocked host path: tiled and fallback cases."""
    src = np.random.RandomState(9).randn(*shape).astype(np.float32)
    want = np.transpose(src, axes)
    out, jout = np.empty_like(want), np.empty_like(want)
    _host_transpose(out, src, axes)
    _jax_host_transpose(jout, src, axes)
    np.testing.assert_array_equal(out, want)
    np.testing.assert_array_equal(out, jout)


@pytest.mark.parametrize('dtype', [np.uint8, np.float32, np.int16])
def test_ops_transpose_equals_jax(dtype):
    x = (np.random.RandomState(2).rand(6, 5, 4) * 100).astype(dtype)
    want = np.asarray(jax_transpose(None, x, (2, 0, 1)))
    got = transpose(None, x, (2, 0, 1))
    assert got.is_contiguous() and got.dtype == torch.from_numpy(x).dtype
    np.testing.assert_array_equal(got.numpy(), want)
    out = np.zeros((4, 6, 5), dtype)
    assert transpose(out, torch.from_numpy(x), [2, 0, 1]) is out
    np.testing.assert_array_equal(out, want)


class _Source(bt.SourceBlock):
    def __init__(self, gulps, header, gulp_nframe, space='system'):
        super(_Source, self).__init__(['src'], gulp_nframe, space=space)
        self._gulps, self._header = gulps, header

    def create_reader(self, name):
        return contextlib.nullcontext(iter(self._gulps))

    def on_sequence(self, reader, name):
        return [deepcopy(self._header)]

    def on_data(self, reader, ospans):
        g = next(reader, None)
        if g is None:
            return [0]
        ospans[0].data.as_numpy()[...] = g
        return [g.shape[0]]


class _JaxSource(bf.SourceBlock):
    def __init__(self, gulps, header, gulp_nframe):
        super(_JaxSource, self).__init__(['src'], gulp_nframe)
        self._gulps, self._header = gulps, header

    def create_reader(self, name):
        return contextlib.nullcontext(iter(self._gulps))

    def on_sequence(self, reader, name):
        return [deepcopy(self._header)]

    def on_data(self, reader, ospans):
        g = next(reader, None)
        if g is None:
            return [0]
        ospans[0].data.as_numpy()[...] = g
        return [g.shape[0]]


@pytest.mark.parametrize('space', ['system', 'device'])
@pytest.mark.parametrize('dtype', ['u8', 'f32'])
def test_transpose_block_equals_jax(space, dtype):
    """[time, pol, freq] -> [pol, freq, time] on a host ring (the tiled
    numpy path) and on a device ring (TransposeStage), through both
    packages' pipelines: headers equal, data bit for bit, and the frame
    axis now last (freq lanes become ringlets)."""
    npdt = np.uint8 if dtype == 'u8' else np.float32
    x = (np.random.RandomState(5).rand(48, 2, 70) * 200).astype(npdt)
    gulps = [x[i * 16:(i + 1) * 16] for i in range(3)]
    hdr = {'name': 'fil', 'time_tag': 0,
           '_tensor': {'shape': [-1, 2, 70], 'dtype': dtype,
                       'labels': ['time', 'pol', 'freq'],
                       'scales': [[0, 1e-3], None, [1400.0, -0.5]],
                       'units': ['s', None, 'MHz']}}
    out = {}
    for pkg in (bt, bf):
        src_cls, sink_cls = (_Source, _Gather) if pkg is bt else \
            (_JaxSource, _JaxGather)
        dev = 'cuda' if pkg is bt else 'tpu'
        with pkg.Pipeline() as p:
            b = src_cls(gulps, hdr, 16)
            if space == 'device':
                b = pkg.blocks.copy(b, space=dev)
            b = pkg.blocks.transpose(b, ['pol', 'freq', 'time'])
            if space == 'device':
                b = pkg.blocks.copy(b, space='system')
            sink = sink_cls(b)
            run_bounded(p)
        out[pkg] = (np.concatenate(sink.gulps, axis=-1), sink.headers)
    got, hdrs = out[bt]
    jgot, jhdrs = out[bf]
    assert _untraced(hdrs[0]) == _untraced(jhdrs[0])
    assert hdrs[0]['_tensor']['shape'] == [2, 70, -1]
    assert got.dtype == npdt
    np.testing.assert_array_equal(got, jgot)
    np.testing.assert_array_equal(got, x.transpose(1, 2, 0))


# ---------------------------------------------------------------------------
# BASELINE config 3's path at a small size
# ---------------------------------------------------------------------------

def _config3(pkg, path, gulp, max_dm):
    sink_cls, dev = (_Gather, 'cuda') if pkg is bt else (_JaxGather, 'tpu')
    with pkg.Pipeline() as p:
        b = pkg.blocks.read_sigproc([path], gulp)
        b = pkg.blocks.copy(b, space=dev)
        b = pkg.blocks.transpose(b, ['pol', 'freq', 'time'])
        b = pkg.blocks.fdmt(b, max_dm=max_dm)
        sink = sink_cls(pkg.blocks.copy(b, space='system'))
        run_bounded(p)
    return np.concatenate(sink.gulps, axis=-1), sink.headers


@pytest.mark.parametrize('impl', [None, 'pallas'])
def test_sigproc_transpose_fdmt_chain_equals_jax(impl, monkeypatch, tmp_path):
    """read_sigproc -> copy -> transpose(['pol', 'freq', 'time']) ->
    fdmt(max_dm) -> copy('system') on a small 8-bit file: the u8 samples
    reach the device as uint8, FdmtBlock casts them to float32, and the
    output equals the JAX chain's bit for bit (the port with its default
    core and with K3's plain version forced) and the whole-stream FDMT on
    the committed frames."""
    from bifrost_tpu_torch.ops.fdmt import Fdmt
    path = str(tmp_path / 'config3.fil')
    nchan, ntime = 32, 160
    data = _filterbank(path, 8, 0, ntime, 1, nchan, seed=17, fch1=400.0,
                       foff=0.5, tsamp=1e-3)
    jgot, jhdrs = _config3(bf, path, 32, 8.0)
    if impl:
        monkeypatch.setenv('BF_FDMT_IMPL', impl)
    got, hdrs = _config3(bt, path, 32, 8.0)
    md = hdrs[0]['_tensor']['shape'][-2]
    assert hdrs[0]['_tensor'] == jhdrs[0]['_tensor']
    assert hdrs[0]['max_dm'] == jhdrs[0]['max_dm']
    assert 4 < md < 32
    assert got.dtype == np.float32 and got.shape[:2] == (1, md)
    np.testing.assert_array_equal(got, jgot)
    whole = Fdmt().init(nchan, md, 400.0, 0.5).execute(
        data[:, 0, :].T.astype(np.float32)).numpy()
    n = got.shape[-1]
    assert n >= ntime - 2 * md
    np.testing.assert_array_equal(got[0], whole[:, :n])


def test_u8_reaches_the_device_ring_as_uint8(tmp_path):
    """The 8-bit samples stay uint8 through copy('cuda') and transpose."""
    path = str(tmp_path / 'u8.fil')
    data = _filterbank(path, 8, 0, 20, 1, 8, seed=1)
    seen = []

    class _Probe(bt.SinkBlock):
        def define_valid_input_spaces(self):
            return ('cuda',)

        def on_sequence(self, iseq):
            pass

        def on_data(self, ispan):
            seen.append(ispan.data)

    with bt.Pipeline() as p:
        b = bt.blocks.read_sigproc([path], 10)
        b = bt.blocks.copy(b, space='cuda')
        _Probe(bt.blocks.transpose(b, ['pol', 'freq', 'time']))
        run_bounded(p)
    assert seen and all(t.dtype == torch.uint8 for t in seen)
    got = torch.cat([t for t in seen], dim=-1).numpy()
    np.testing.assert_array_equal(got, data.transpose(1, 2, 0))
