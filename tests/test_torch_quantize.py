"""Packed quantize outputs of the port (``ops.quantize.quantize`` into
packed 1/2/4-bit and ci1/ci2/ci4 host arrays, ``_pack_into``, the map's
``_to_logical`` / ``_from_logical``) against the JAX package: the packed
cases of ``tests/test_quantize.py`` (the hand-derived 0xE4, 0xBA, 0xF7,
0xD6 and 0x06 bytes among them), every byte equal to what the JAX package
writes for the same values.  The port runs on the CPU device here; on the
card the packing is ``devrep.pack_tensor``, which these bytes pin too.
"""

import numpy as np
import pytest
import torch

import bifrost_tpu as bf
from bifrost_tpu import ops as jops

import bifrost_tpu_torch as bt
from bifrost_tpu_torch import device
from bifrost_tpu_torch.ops import quantize as Q
from bifrost_tpu_torch.ops.map import _from_logical, _to_logical
from bifrost_tpu_torch.ops.quantize import _clip_limits, _pack_into

DataType = bt.DataType
PACKED = ('i1', 'i2', 'i4', 'u1', 'u2', 'u4', 'ci1', 'ci2', 'ci4')


@pytest.fixture(autouse=True)
def _cpu():
    device.set_device('cpu')


def _empty(shape, dtype):
    """A zeroed host ndarray of ``dtype`` (packed storage for sub-byte
    types)."""
    return bt.ops.common.astype(np.zeros(shape, np.float32), dtype)


def test_quantize_f32_to_i8_scale_clip():
    x = np.array([0.2, 1.0, -1.0, 300.0, -300.0], np.float32)
    dst = _empty((5,), 'i8')
    Q.quantize(x, dst, scale=100.)
    np.testing.assert_array_equal(dst.as_numpy(), [20, 100, -100, 127, -128])


def test_quantize_packed_i4():
    x = np.array([1., -2., 3., -4., 5., -6., 7., -8.], np.float32)
    dst = _empty((8,), 'i4')
    Q.quantize(x, dst, scale=1.)
    back = _empty((8,), 'i8')
    Q.unpack(dst, back)
    np.testing.assert_array_equal(back.as_numpy(),
                                  [1, -2, 3, -4, 5, -6, 7, -8])
    jdst = bf.empty((8,), 'i4', 'system')
    jops.quantize(bf.asarray(x), jdst, scale=1.)
    assert dst.as_numpy().tobytes() == jdst.as_numpy().tobytes()


def test_unpack_ci4_roundtrip():
    vals = np.array([1 + 2j, -3 - 4j, 7 - 8j, -8 + 7j]).astype(np.complex64)
    dst4 = _empty((4,), 'ci4')
    Q.quantize(vals, dst4, scale=1.)
    back = _empty((4,), 'cf32')
    Q.unpack(dst4, back)
    np.testing.assert_array_equal(back.as_numpy(), vals)


def test_unpack_u2():
    packed = _empty((8,), 'u2')
    vals = np.array([0, 1, 2, 3, 3, 2, 1, 0])
    _pack_into(vals, DataType('u2'), packed.as_numpy())
    out = _empty((8,), 'u8')
    Q.unpack(packed, out)
    np.testing.assert_array_equal(out.as_numpy(), vals)


def test_subbyte_bit_order_is_lsb_first():
    """Sample k lives in bits [k*nbits, (k+1)*nbits) of each byte;
    hand-derived bytes, so an MSB-first regression cannot cancel out in
    a round trip."""
    vals = _to_logical(np.array([0xE4], np.uint8), DataType('u2'))
    np.testing.assert_array_equal(vals, [0, 1, 2, 3])
    out = np.zeros(1, np.uint8)
    _pack_into(np.array([0, 1, 2, 3], np.uint8), DataType('u2'), out)
    assert out[0] == 0xE4
    vals = _to_logical(np.array([0xBA], np.uint8), DataType('u4'))
    np.testing.assert_array_equal(vals, [0xA, 0xB])
    vals = _to_logical(np.array([0xF7], np.uint8), DataType('i4'))
    np.testing.assert_array_equal(vals, [7, -1])
    vals = _to_logical(np.array([0b00000101], np.uint8), DataType('u1'))
    np.testing.assert_array_equal(vals[:3], [1, 0, 1])
    # quantize packs the same bytes (on the device, devrep.pack_tensor)
    dst = _empty((4,), 'u2')
    Q.quantize(np.array([0., 1., 2., 3.], np.float32), dst)
    assert dst.as_numpy()[0] == 0xE4
    dst = _empty((2,), 'i4')
    Q.quantize(np.array([7., -1.], np.float32), dst)
    assert dst.as_numpy()[0] == 0xF7


def test_packed_ci_field_layout():
    """Hand-derived packed-ci bytes: ci2 sample (re=1, im=-2) is the
    field 0b0110 (re high), two fields a byte LSB first: 0xD6; ci1
    (-1, 0), (0, -1) -> 0x06."""
    vals = _to_logical(np.array([0xD6], np.uint8), DataType('ci2'))
    np.testing.assert_array_equal(vals, [1 - 2j, -1 + 1j])
    packed = _from_logical(np.array([1 - 2j, -1 + 1j], np.complex64),
                           DataType('ci2'))
    np.testing.assert_array_equal(packed, [0xD6])
    dst = _empty((2,), 'ci2')
    Q.quantize(np.array([1 - 2j, -1 + 1j], np.complex64), dst)
    assert dst.as_numpy()[0] == 0xD6
    vals = _to_logical(np.array([0x06], np.uint8), DataType('ci1'))
    np.testing.assert_array_equal(vals[:2], [-1 + 0j, 0 - 1j])
    packed = _from_logical(np.asarray(vals), DataType('ci1'))
    np.testing.assert_array_equal(packed, [0x06])
    dst = _empty((4,), 'ci1')
    Q.quantize(np.asarray(vals), dst)
    assert dst.as_numpy()[0] == 0x06


@pytest.mark.parametrize('name', PACKED)
def test_packed_roundtrip_bit_exact_and_bytes_equal_jax(name):
    """quantize -> unpack is bit-exact for every packed kind over its
    whole range, and the packed bytes equal the JAX package's."""
    rng = np.random.RandomState(42)
    n = 64
    dt = DataType(name)
    lo, hi = _clip_limits(dt)
    if dt.kind == 'ci':
        vals = (rng.randint(lo, hi + 1, n) +
                1j * rng.randint(lo, hi + 1, n)).astype(np.complex64)
        bname = 'cf32'
    else:
        vals = rng.randint(lo, hi + 1, n).astype(np.float32)
        bname = 'i8' if dt.kind == 'i' else 'u8'
    dst = _empty((n,), name)
    Q.quantize(vals, dst, scale=1.)
    back = _empty((n,), bname)
    Q.unpack(dst, back)
    np.testing.assert_array_equal(back.as_numpy().astype(vals.dtype), vals)
    jdst = bf.empty((n,), name, 'system')
    jops.quantize(bf.asarray(vals), jdst, scale=1.)
    assert dst.as_numpy().tobytes() == jdst.as_numpy().tobytes()


@pytest.mark.parametrize('name', PACKED)
def test_packed_roundtrip_range_extremes_and_clip(name):
    """The clip limits survive the round trip, and values past them clip
    to them (i4's -8 packs to 0x8 and comes back as -8), as in JAX."""
    dt = DataType(name)
    lo, hi = _clip_limits(dt)
    per = max(8 // dt.itemsize_bits, 1)
    if dt.kind == 'ci':
        vals = np.resize([lo + 1j * hi, hi + 1j * lo, (lo - 5) + 1j * (hi + 5)],
                         2 * per).astype(np.complex64)
        want = np.clip(vals.real, lo, hi) + 1j * np.clip(vals.imag, lo, hi)
        back = _empty(vals.shape, 'cf32')
    else:
        vals = np.resize([lo, hi, lo - 3, hi + 3], 2 * per).astype(np.float32)
        want = np.clip(vals, lo, hi)
        back = _empty(vals.shape, 'i8' if dt.kind == 'i' else 'u8')
    dst = _empty(vals.shape, name)
    Q.quantize(vals, dst, scale=1.)
    Q.unpack(dst, back)
    np.testing.assert_array_equal(back.as_numpy().astype(want.dtype), want)
    jdst = bf.empty(vals.shape, name, 'system')
    jops.quantize(bf.asarray(vals), jdst, scale=1.)
    assert dst.as_numpy().tobytes() == jdst.as_numpy().tobytes()


def test_quantize_into_a_tensor():
    """A tensor destination is written in place in its own type."""
    x = torch.linspace(-2, 2, 16)
    dst = torch.zeros(16, dtype=torch.int8)
    ptr = dst.data_ptr()
    Q.quantize(x, dst, scale=50.)
    assert dst.data_ptr() == ptr
    expect = np.clip(np.round(np.linspace(-2, 2, 16) * 50), -128, 127)
    np.testing.assert_array_equal(dst.numpy(), expect)


def test_quantize_block_packed_host_output():
    """The quantize block on a host ring writes packed i4 spans equal to
    the JAX block's bytes."""
    import contextlib
    from copy import deepcopy
    from tests.test_torch_bounded import run_bounded
    from tests.util import NumpySourceBlock, simple_header

    x = (np.random.RandomState(8).randn(8, 16) * 4).astype(np.float32)
    hdr = simple_header([-1, 16], 'f32')

    class Src(bt.SourceBlock):
        def __init__(self):
            super(Src, self).__init__(['s'], 8)

        def create_reader(self, name):
            return contextlib.nullcontext()

        def on_sequence(self, reader, name):
            self.done = False
            return [deepcopy(hdr)]

        def on_data(self, reader, ospans):
            if self.done:
                return [0]
            self.done = True
            ospans[0].data.as_numpy()[...] = x
            return [8]

    class Sink(bt.SinkBlock):
        def on_sequence(self, iseq):
            self.hdr, self.out = iseq.header, []

        def on_data(self, ispan):
            self.out.append(np.array(ispan.data.as_numpy(), copy=True))

    with bt.Pipeline() as p:
        sink = Sink(bt.blocks.quantize(Src(), 'i4', scale=0.5))
    run_bounded(p)

    class JSink(bf.SinkBlock):
        def on_sequence(self, iseq):
            self.out = []

        def on_data(self, ispan):
            self.out.append(np.array(ispan.data.as_numpy(), copy=True))

    with bf.Pipeline() as p:
        jsink = JSink(bf.blocks.quantize(
            NumpySourceBlock([x], hdr, gulp_nframe=8), 'i4', scale=0.5))
    run_bounded(p)
    assert sink.hdr['_tensor']['dtype'] == 'i4'
    assert np.concatenate(sink.out).tobytes() == \
        np.concatenate(jsink.out).tobytes()
