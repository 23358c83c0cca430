"""The port's host file blocks against the JAX package's: ``binary_read`` /
``binary_write``, ``serialize`` / ``deserialize`` (``max_file_size``
rotation, ringlet lanes, looped replay) and ``read_wav`` / ``write_wav``.
The files the port writes are byte-identical to the JAX blocks' files for
the same stream, and each package reads the other's files back to the
same values (the cases of ``tests/test_file_io.py:103,116,135`` and
``tests/test_misc_blocks.py:12`` among them).  The port runs on the CPU
device here.
"""

import contextlib
import glob
import json
import os
import wave
from copy import deepcopy

import numpy as np
import pytest

import bifrost_tpu as bf
from tests.util import NumpySourceBlock, GatherSink, simple_header

import bifrost_tpu_torch as bt
from bifrost_tpu_torch import device
from bifrost_tpu_torch.blocks.serialize import DeserializeBlock
from tests.test_torch_bounded import run_bounded
from tests.test_torch_dsp_library import _Gather, _Source


@pytest.fixture(autouse=True)
def _cpu():
    device.set_device('cpu')


def _run(pkg, build):
    """Build a pipeline with ``build(pkg)`` and run it; returns what
    ``build`` returned."""
    with pkg.Pipeline() as p:
        out = build(pkg)
    run_bounded(p)
    return out


def _source(pkg, gulps, hdr, gulp_nframe):
    if pkg is bt:
        return _Source(gulps, hdr, gulp_nframe)
    return NumpySourceBlock(gulps, hdr, gulp_nframe=gulp_nframe)


def _sink(pkg, b):
    return (_Gather if pkg is bt else GatherSink)(b)


def _files(d):
    """{name: bytes} of every file under directory ``d``."""
    out = {}
    for p in sorted(glob.glob(os.path.join(str(d), '*'))):
        with open(p, 'rb') as f:
            out[os.path.basename(p)] = f.read()
    return out


# ---------------------------------------------------------------------------
# binary_io
# ---------------------------------------------------------------------------

def test_binary_io_roundtrip(tmp_path):
    rng = np.random.RandomState(3)
    data = rng.randn(64 * 16).astype(np.float32)
    path = str(tmp_path / 'raw.bin')
    data.tofile(path)
    sink = _run(bt, lambda pkg: _sink(pkg, pkg.blocks.binary_read(
        [path], gulp_size=16, gulp_nframe=8, dtype='f32')))
    np.testing.assert_array_equal(sink.result().ravel(), data)
    assert sink.headers[0]['_tensor']['shape'] == [-1, 16]


def test_binary_write_byte_identical_and_read_across(tmp_path):
    """binary_write's file from each package is the same bytes, and the
    other package's binary_read gives the data back (a short last
    gulp included)."""
    rng = np.random.RandomState(4)
    data = rng.randint(-1000, 1000, size=(20, 6)).astype(np.int16)
    gulps = [data[:8], data[8:16], data[16:]]
    out = {}
    for pkg in (bt, bf):
        d = tmp_path / pkg.__name__
        d.mkdir()
        hdr = simple_header([-1, 6], 'i16', name=str(d / 'stream'))
        _run(pkg, lambda p: p.blocks.binary_write(
            _source(p, gulps, hdr, 8), file_ext='bin'))
        out[pkg] = d / 'stream.bin'
    assert out[bt].read_bytes() == out[bf].read_bytes() == data.tobytes()
    for reader, path in ((bt, out[bf]), (bf, out[bt])):
        sink = _run(reader, lambda p: _sink(p, p.blocks.binary_read(
            [str(path)], gulp_size=6, gulp_nframe=8, dtype='i16')))
        np.testing.assert_array_equal(sink.result(), data)


# ---------------------------------------------------------------------------
# serialize
# ---------------------------------------------------------------------------

def test_serialize_deserialize_roundtrip(tmp_path):
    rng = np.random.RandomState(4)
    data = rng.randn(16, 4).astype(np.float32)
    hdr = simple_header([-1, 4], 'f32', name='stream0')
    _run(bt, lambda p: p.blocks.serialize(
        _source(p, [data[:8], data[8:]], hdr, 8), path=str(tmp_path)))
    assert os.path.exists(str(tmp_path / 'stream0.bf.json'))
    sink = _run(bt, lambda p: _sink(p, p.blocks.deserialize(
        [str(tmp_path / 'stream0')], gulp_nframe=8)))
    np.testing.assert_array_equal(sink.result(), data)
    assert sink.headers[0]['_tensor']['labels'] == ['time', 'dim1']


def test_serialize_max_file_size_splitting(tmp_path):
    """Data files rotate at max_file_size with frame-offset names;
    deserialize reads across the segment boundaries."""
    rng = np.random.RandomState(5)
    data = rng.randn(64, 8).astype(np.float32)
    gulps = [data[i * 8:(i + 1) * 8] for i in range(8)]
    hdr = simple_header([-1, 8], 'f32', name='splitme')
    _run(bt, lambda p: p.blocks.serialize(
        _source(p, gulps, hdr, 8), path=str(tmp_path), max_file_size=600))
    dats = sorted(glob.glob(str(tmp_path / 'splitme.bf.*.dat')))
    assert len(dats) > 1, dats
    offs = [int(d.rsplit('.', 2)[1]) for d in dats]
    assert offs[0] == 0 and offs == sorted(offs)
    assert sum(os.path.getsize(d) for d in dats) == data.nbytes
    sink = _run(bt, lambda p: _sink(p, p.blocks.deserialize(
        [str(tmp_path / 'splitme')], gulp_nframe=16)))
    np.testing.assert_array_equal(sink.result(), data)


#: the trace context both packages stamp in the byte-identity tests
FIXED_TRACE = {'id': '00c0ffee00c0ffee', 'origin_ns': 1700000000000000000,
               'host': 'test-host'}


@pytest.fixture
def fixed_trace(monkeypatch):
    """Both packages' sources stamp :data:`FIXED_TRACE`."""
    import bifrost_tpu.header_standard as jhs
    import bifrost_tpu_torch.header_standard as ths
    for mod in (jhs, ths):
        monkeypatch.setattr(mod, 'new_trace_context',
                            lambda: dict(FIXED_TRACE))


@pytest.mark.parametrize('case', ['flat', 'split', 'ringlets'])
def test_serialize_byte_identical_and_read_across(tmp_path, case,
                                                  fixed_trace):
    """Both packages serialize one stream to the same files, byte for
    byte (header JSON, its ``_trace`` included, and data segments), and
    each deserializes the other's files to the same data and header."""
    rng = np.random.RandomState(6)
    if case == 'ringlets':
        # a ringlet axis before the frame axis: one .dat file per lane
        data = rng.randint(-100, 100, size=(3, 24, 5)).astype(np.int16)
        hdr = simple_header([3, -1, 5], 'i16', name='lanes',
                            labels=['beam', 'time', 'chan'])
        gulps = [data[:, i:i + 8] for i in (0, 8, 16)]
    else:
        data = rng.randn(24, 5).astype(np.float32)
        hdr = simple_header([-1, 5], 'f32', name='flat')
        hdr['telescope'] = 'TEST'
        gulps = [data[i:i + 8] for i in (0, 8, 16)]
    cap = 200 if case == 'split' else None
    out = {}
    for pkg in (bt, bf):
        d = tmp_path / pkg.__name__
        d.mkdir()
        if case == 'ringlets':
            if pkg is bt:
                src = lambda p: _LaneSource(gulps, hdr)
            else:
                src = lambda p: _JaxLaneSource(gulps, hdr)
        else:
            src = lambda p: _source(p, gulps, hdr, 8)
        _run(pkg, lambda p: p.blocks.serialize(
            src(p), path=str(d), max_file_size=cap))
        out[pkg] = d
    tfiles, jfiles = _files(out[bt]), _files(out[bf])
    assert sorted(tfiles) == sorted(jfiles)
    assert len(tfiles) > (2 if case != 'flat' else 1)
    for name in tfiles:
        if name.endswith('.bf.json'):
            assert json.loads(tfiles[name].decode())['_trace'] == \
                FIXED_TRACE
        assert tfiles[name] == jfiles[name], name
    name = hdr['name']
    for reader, d in ((bt, out[bf]), (bf, out[bt])):
        sink = _run(reader, lambda p: _sink(p, p.blocks.deserialize(
            [str(d / name)], gulp_nframe=8)))
        got = sink.result() if case != 'ringlets' else \
            np.concatenate(sink.gulps, axis=1)
        np.testing.assert_array_equal(got, data)
        assert sink.headers[0]['_tensor'] == hdr['_tensor']


class _LaneSource(bt.SourceBlock):
    """A (3, -1, 5) ringlet stream."""

    def __init__(self, gulps, header):
        super(_LaneSource, self).__init__(['lanes'], 8)
        self._gulps, self._header = list(gulps), header

    def create_reader(self, name):
        return contextlib.nullcontext()

    def on_sequence(self, reader, name):
        return [deepcopy(self._header)]

    def on_data(self, reader, ospans):
        if not self._gulps:
            return [0]
        ospans[0].data.as_numpy()[...] = self._gulps.pop(0)
        return [8]


class _JaxLaneSource(bf.SourceBlock):
    def __init__(self, gulps, header):
        super(_JaxLaneSource, self).__init__(['lanes'], 8)
        self._gulps, self._header = list(gulps), header

    def create_reader(self, name):
        return contextlib.nullcontext()

    def on_sequence(self, reader, name):
        return [deepcopy(self._header)]

    def on_data(self, reader, ospans):
        if not self._gulps:
            return [0]
        ospans[0].data.as_numpy()[...] = self._gulps.pop(0)
        return [8]


def test_deserialize_loop_renumbers_and_split_loop():
    """``loop=N`` replays every file N times, renumbering time_tag and
    naming later passes ``.loopN``; ``_split_loop`` takes the suffix
    apart as the JAX block's does."""
    from bifrost_tpu.blocks.serialize import DeserializeBlock as JD
    for name in ('a/b#loop1.0', 'x#loop0.1', 'plain', 'odd#loopx.y'):
        assert DeserializeBlock._split_loop(name) == JD._split_loop(name)


def test_deserialize_loop_replay(tmp_path):
    rng = np.random.RandomState(7)
    data = rng.randn(8, 3).astype(np.float32)
    hdr = simple_header([-1, 3], 'f32', name='rep')
    hdr['_trace'] = {'id': 'x'}
    _run(bt, lambda p: p.blocks.serialize(
        _source(p, [data], hdr, 8), path=str(tmp_path)))
    sink = _run(bt, lambda p: _sink(p, p.blocks.deserialize(
        [str(tmp_path / 'rep.bf.json')], gulp_nframe=8, loop=2,
        restamp=True)))
    assert [h['time_tag'] for h in sink.headers] == [0, 1]
    assert [h['name'] for h in sink.headers] == ['rep', 'rep.loop1']
    # restamp drops the recorded context; the source stamps a fresh one
    # a pass (tests/test_service.py:186 in the JAX package)
    ids = [h['_trace']['id'] for h in sink.headers]
    assert 'x' not in ids and len(set(ids)) == 2
    np.testing.assert_array_equal(sink.result(), np.concatenate([data] * 2))


# ---------------------------------------------------------------------------
# wav
# ---------------------------------------------------------------------------

def test_wav_roundtrip_byte_identical(tmp_path):
    """``tests/test_misc_blocks.py:12`` through the port; both packages'
    written .wav files are the same bytes."""
    rng = np.random.RandomState(0)
    data = rng.randint(-3000, 3000, size=(1000, 2)).astype(np.int16)
    path = str(tmp_path / 'test.wav')
    with wave.open(path, 'wb') as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(8000)
        w.writeframes(data.tobytes())
    written = {}
    for pkg in (bt, bf):
        outdir = tmp_path / pkg.__name__
        outdir.mkdir()

        def build(p):
            b = p.blocks.read_wav([path], gulp_nframe=256)
            sink = _sink(p, b)
            p.blocks.write_wav(p.blocks.copy(b), path=str(outdir))
            return sink
        sink = _run(pkg, build)
        np.testing.assert_array_equal(sink.result(), data)
        written[pkg] = (outdir / 'test.wav').read_bytes()
        with wave.open(str(outdir / 'test.wav'), 'rb') as w:
            assert w.getnframes() == 1000 and w.getframerate() == 8000
            back = np.frombuffer(w.readframes(1000), np.int16).reshape(-1, 2)
        np.testing.assert_array_equal(back, data)
    assert written[bt] == written[bf]
    sink = _run(bt, lambda p: _sink(p, p.blocks.read_wav(
        [path], gulp_nframe=256)))
    h = sink.headers[0]
    assert h['frame_rate'] == 8000 and h['_tensor']['dtype'] == 'i16'
    assert h['_tensor']['scales'][0] == [0, 1.0 / 8000]
