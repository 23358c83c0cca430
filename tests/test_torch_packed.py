"""Packed sub-byte types of the PyTorch/CUDA port (i1/i2/i4/u1/u2/u4/ci1/
ci2/ci4) against the JAX package: every one of the 256 byte values to the
device representation and back, equal to ``bifrost_tpu.devrep``'s; the
host storage conversions equal to ``bifrost_tpu.ops.map``'s; packed
rings (whole-byte frames only); ``read_sigproc(unpack=False)`` of 1-, 2-
and 4-bit files and the ``unpack`` block and op against the JAX blocks.
The port runs on the CPU device here.  Everything is compared exactly.
"""

import numpy as np
import pytest

import bifrost_tpu as bf
from bifrost_tpu import devrep as jdevrep
from bifrost_tpu.dtype import DataType as JDataType, ci4 as jci4
from bifrost_tpu.ops.map import _from_logical, _to_logical
from bifrost_tpu.ops.quantize import _pack_into

import bifrost_tpu_torch as bt
from bifrost_tpu_torch import device, devrep
from bifrost_tpu_torch.dtype import DataType, ci4
from bifrost_tpu_torch.ops import common
from bifrost_tpu_torch.ops.quantize import unpack
from tests.test_torch_bounded import run_bounded
from tests.test_torch_sigproc import _filterbank, _read, _untraced

PACKED = ['i1', 'i2', 'i4', 'u1', 'u2', 'u4', 'ci1', 'ci2', 'ci4']
BYTES = np.arange(256, dtype=np.uint8)


@pytest.fixture(autouse=True)
def _cpu():
    device.set_device('cpu')


def _storage(name, pkg_ci4):
    """The 256 byte values as ``name``'s host storage."""
    return BYTES.view(pkg_ci4) if name == 'ci4' else BYTES.copy()


@pytest.mark.parametrize('name', PACKED)
def test_datatype_equals_jax(name):
    t, j = DataType(name), JDataType(name)
    assert (t.kind, t.nbits, t.itemsize_bits, t.is_packed) == \
        (j.kind, j.nbits, j.itemsize_bits, j.is_packed)
    assert t.as_numpy_dtype() == j.as_numpy_dtype()
    assert str(t) == str(j)
    if t.is_packed:
        with pytest.raises(ValueError):
            t.itemsize


@pytest.mark.parametrize('name', PACKED)
def test_every_byte_to_the_device_and_back_equals_jax(name):
    """All 256 byte values: the device representation equals the JAX
    package's (its dtype, its (re, im) axis, every value), and packing it
    back gives the bytes again, as the JAX package's does.  The JAX
    package's ``to_device_rep`` raises for ci1/ci2 (it indexes fields of
    the uint8 storage); there the port is held to the JAX logical values
    (``ops.map._to_logical``) in the representation ``device_rep_dtype``
    names."""
    got = devrep.to_device_rep(_storage(name, ci4), name)
    jcomp, jreim = jdevrep.device_rep_dtype(name)
    assert got.dtype == {'int8': bt.dtype.DataType('i8').as_torch_dtype(),
                         'uint8': bt.dtype.DataType('u8').as_torch_dtype()
                         }[np.dtype(jcomp).name]
    assert (got.shape[-1] == 2 and got.dim() == 2) == jreim
    if name in ('ci1', 'ci2'):
        with pytest.raises(KeyError):
            jdevrep.to_device_rep(BYTES.copy(), name)
        logical = _to_logical(BYTES.copy(), JDataType(name))
        want = np.stack([logical.real, logical.imag], -1).astype(np.int8)
    else:
        want = np.asarray(jdevrep.to_device_rep(_storage(name, jci4),
                                                name))
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    out = np.zeros_like(_storage(name, ci4))
    devrep.from_device_rep(got, name, out)
    assert out.view(np.uint8).tobytes() == BYTES.tobytes()
    if name not in ('ci1', 'ci2'):
        jout = np.zeros_like(_storage(name, jci4))
        jdevrep.from_device_rep(want, name, jout)
        assert out.view(np.uint8).tobytes() == jout.view(np.uint8).tobytes()


@pytest.mark.parametrize('name', PACKED)
def test_host_logical_values_equal_jax(name):
    """to_logical_numpy / from_logical_numpy equal the JAX package's
    ``_to_logical`` and (for packed real types) ``_pack_into``."""
    got = common.to_logical_numpy(_storage(name, ci4), name)
    want = _to_logical(_storage(name, jci4), JDataType(name))
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    back = common.from_logical_numpy(got, name)
    if DataType(name).kind == 'ci':
        jback = _from_logical(want, JDataType(name))
    else:
        jback = np.zeros(256, np.uint8)
        _pack_into(want, JDataType(name), jback)
    assert back.tobytes() == np.asarray(jback).tobytes() == BYTES.tobytes()


@pytest.mark.parametrize('shape,dtype,ok', [
    ([-1, 3], 'u2', False), ([-1, 4], 'u2', True), ([-1, 2, 3], 'i4', True),
    ([-1, 5], 'u1', False), ([-1, 8], 'i1', True), ([-1, 3], 'ci4', True)])
def test_packed_frames_must_span_whole_bytes(shape, dtype, ok):
    """A ring sequence of a packed type needs frames of whole bytes, as
    the JAX ring requires (``bifrost_tpu/ring.py:148-163``)."""
    hdr = {'name': 'p', '_tensor': {'shape': shape, 'dtype': dtype}}
    for ring in (bt.Ring(space='system'), bf.Ring(space='system')):
        with ring.begin_writing() as w:
            if ok:
                w.begin_sequence(dict(hdr), 4, 4).end()
            else:
                with pytest.raises(ValueError, match='whole bytes'):
                    w.begin_sequence(dict(hdr), 4, 4)


@pytest.mark.parametrize('dtype,nsamp', [('u2', 16), ('i4', 6), ('i1', 24),
                                         ('ci4', 5), ('ci2', 8)])
def test_packed_ring_through_the_device_and_back(dtype, nsamp):
    """A packed host ring -> copy('cuda') -> copy('system'): the bytes
    come back unchanged, the device tensor holds the unpacked samples
    (the JAX package's logical values), and host spans are the uint8
    storage with the logical shape."""
    import contextlib
    dt = DataType(dtype)
    nbyte = nsamp * dt.itemsize_bits // 8
    rng = np.random.RandomState(nsamp)
    raw = rng.randint(0, 256, size=(12, 3, nbyte)).astype(np.uint8)
    hdr = {'name': 'p', '_tensor': {
        'shape': [-1, 3, nsamp], 'dtype': dtype,
        'labels': ['time', 'pol', 'x'], 'scales': [[0, 1]] * 3,
        'units': [None] * 3}}
    seen_dev, seen_host, shapes = [], [], []

    class _Src(bt.SourceBlock):
        def __init__(self):
            super(_Src, self).__init__(['s'], 4)

        def create_reader(self, name):
            return contextlib.nullcontext(iter([raw[:4], raw[4:8],
                                                raw[8:]]))

        def on_sequence(self, reader, name):
            return [dict(hdr)]

        def on_data(self, reader, ospans):
            g = next(reader, None)
            if g is None:
                return [0]
            buf = ospans[0].data.as_numpy()
            shapes.append((tuple(ospans[0].data.shape), buf.shape))
            buf.view(np.uint8)[...] = g.reshape(buf.shape)
            return [4]

    class _Tap(bt.SinkBlock):
        def __init__(self, iring, out):
            super(_Tap, self).__init__(iring)
            self.out = out

        def on_sequence(self, iseq):
            pass

        def on_data(self, ispan):
            d = ispan.data
            self.out.append(d.clone() if hasattr(d, 'clone') else
                            np.array(d.as_numpy().view(np.uint8)))

    with bt.Pipeline() as p:
        dev = bt.blocks.copy(_Src(), space='cuda')
        _Tap(dev, seen_dev)
        _Tap(bt.blocks.copy(dev, space='system'), seen_host)
        run_bounded(p)
    assert np.concatenate(seen_host).tobytes() == raw.tobytes()
    assert shapes[0][0] == (4, 3, nsamp)
    got = np.concatenate([t.numpy() for t in seen_dev])
    logical = _to_logical(raw.view(jci4) if dtype == 'ci4' else raw,
                          JDataType(dtype))
    if dt.kind == 'ci':
        logical = np.stack([logical.real, logical.imag], -1)
    np.testing.assert_array_equal(got, logical.astype(got.dtype))


@pytest.mark.parametrize('nbits,signed', [(1, 0), (2, 0), (2, 1), (4, 0),
                                          (4, 1)])
def test_read_sigproc_without_unpack_equals_jax(nbits, signed, tmp_path):
    """read_sigproc(unpack=False) of a 1/2/4-bit file: a packed
    ``u<n>``/``i<n>`` ring whose spans hold the stored bytes, with the
    JAX block's headers and bytes (a ragged final gulp included)."""
    path = str(tmp_path / 'in.fil')
    _filterbank(path, nbits, signed, 45, 2, 16, seed=nbits + 7 * signed)
    got, hdrs = _read(bt, path, 8, unpack=False)
    jgot, jhdrs = _read(bf, path, 8, unpack=False)
    assert [_untraced(h) for h in hdrs] == [_untraced(h) for h in jhdrs]
    assert hdrs[0]['_tensor']['dtype'] == '%s%d' % ('iu'[not signed],
                                                    nbits)
    assert got.dtype == jgot.dtype == np.uint8
    assert got.shape == jgot.shape == (45, 2, 16 * nbits // 8)
    np.testing.assert_array_equal(got, jgot)
    with open(path, 'rb') as f:
        assert f.read()[-got.size:] == got.tobytes()


def _unpack_chain(pkg, path, space, dtype):
    dev = 'cuda' if pkg is bt else 'tpu'
    from tests.test_torch_sigproc import _Gather, _JaxGather
    with pkg.Pipeline() as p:
        b = pkg.blocks.read_sigproc([path], 8, unpack=False)
        if space == 'device':
            b = pkg.blocks.copy(b, space=dev)
        b = pkg.blocks.unpack(b, dtype)
        if space == 'device':
            b = pkg.blocks.copy(b, space='system')
        sink = (_Gather if pkg is bt else _JaxGather)(b)
        run_bounded(p)
    return np.concatenate(sink.gulps), sink.headers


@pytest.mark.parametrize('space', ['system', 'device'])
@pytest.mark.parametrize('nbits,signed,dtype', [(2, 1, 'i8'), (4, 0, 'f32'),
                                                (1, 0, 'u8')])
def test_unpack_block_equals_jax(space, nbits, signed, dtype, tmp_path):
    """read_sigproc(unpack=False) -> unpack(dtype), on the host ring and
    after copy('cuda'): the JAX chain's headers and samples, which are
    read_sigproc's own unpacking."""
    path = str(tmp_path / 'in.fil')
    want = _filterbank(path, nbits, signed, 24, 1, 16, seed=nbits)
    got, hdrs = _unpack_chain(bt, path, space, dtype)
    jgot, jhdrs = _unpack_chain(bf, path, space, dtype)
    assert [_untraced(h) for h in hdrs] == [_untraced(h) for h in jhdrs]
    assert got.dtype == jgot.dtype
    np.testing.assert_array_equal(got, jgot)
    np.testing.assert_array_equal(got, want.astype(got.dtype))


@pytest.mark.parametrize('src_dtype,dst_dtype', [('ci4', 'ci8'),
                                                 ('ci4', 'cf32'),
                                                 ('i2', 'i8'),
                                                 ('u4', 'f32')])
def test_unpack_op_equals_jax(src_dtype, dst_dtype):
    src = _storage(src_dtype, ci4).reshape(8, 32)
    jsrc = _storage(src_dtype, jci4).reshape(8, 32)
    n = 32 * 8 // DataType(src_dtype).itemsize_bits
    ddt = DataType(dst_dtype).as_numpy_dtype()
    dst = bt.ndarray(np.zeros((8, n), ddt), dtype=dst_dtype)
    jdst = bf.ndarray(np.zeros((8, n), ddt), dtype=dst_dtype)
    sdt = src_dtype
    unpack(bt.ndarray(src, dtype=sdt, shape=(8, n)), dst)
    bf.ops.unpack(bf.ndarray(jsrc, dtype=sdt, shape=(8, n)), jdst)
    assert dst.as_numpy().tobytes() == np.asarray(jdst).tobytes()


def _host_array(pkg, name):
    """A (4, 16)-sample host array of type ``name`` in ``pkg``'s
    ndarray, from the byte values."""
    dt = DataType(name)
    nbyte = 4 * 16 * dt.itemsize_bits // 8
    raw = np.arange(nbyte, dtype=np.uint8) * 37
    if name.startswith('ci') and dt.nbits == 8:
        buf = raw.view(pkg.dtype.ci8).reshape(4, 16)
        return (bt.ndarray(buf, dtype=name) if pkg is bt
                else bf.ndarray(buf, dtype=name))
    buf = raw.reshape(4, -1)
    if name == 'ci4':
        buf = buf.view(ci4 if pkg is bt else jci4)
    if pkg is bt:
        return bt.ndarray(buf, dtype=name, shape=(4, 16))
    return bf.ndarray(buf, dtype=name, shape=(4, 16))


@pytest.mark.parametrize('src,dst', [('ci8', 'cf32'), ('ci4', 'ci8'),
                                     ('i4', 'f32'), ('u2', 'i16'),
                                     ('ci4', 'cf32')])
def test_common_conversions_equal_jax(src, dst):
    """``as_logical_numpy`` and the host ``astype`` of packed and
    complex-integer arrays equal the JAX package's ``ops.common``; on a
    tensor ``complexify`` gives the same complex values and ``astype``
    the device representation of the target type."""
    import torch
    from bifrost_tpu.ops import common as jcommon
    t, j = _host_array(bt, src), _host_array(bf, src)
    got = common.as_logical_numpy(t)
    want = np.asarray(jcommon.as_logical_numpy(j))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got.reshape(want.shape), want)
    assert common.logical_dtype(t) == DataType(src)
    cast = common.astype(t, dst)
    jcast = jcommon.astype(j, dst)
    assert str(cast.dtype) == str(jcast.dtype) == dst
    assert cast.as_numpy().tobytes() == np.asarray(jcast).tobytes()
    rep = devrep.to_device_rep(t.as_numpy(), src)
    if DataType(src).kind == 'ci':
        np.testing.assert_array_equal(
            common.complexify(rep, src).numpy(),
            got.reshape(rep.shape[:-1]))
    trep = common.astype(torch.from_numpy(np.ascontiguousarray(got)), dst)
    assert trep.dtype == DataType(dst).as_torch_dtype()
    assert tuple(trep.shape) == devrep.device_rep_shape(got.shape, dst)
