"""Header-only views, ``block_view``, ring views and ``BlockChainer`` of
the PyTorch/CUDA port against the JAX package: each of the ten views
transforms the same header to the same header (and refuses what the JAX
view refuses), and view-tapped rings, host and device, read through a
pipeline give the JAX pipeline's headers and the base ring's bytes.  The
port runs on the CPU device here.  Everything is compared exactly.
"""

import contextlib
from copy import deepcopy

import numpy as np
import pytest

import bifrost_tpu as bf
from tests.util import NumpySourceBlock, GatherSink

import bifrost_tpu_torch as bt
from bifrost_tpu_torch import device
from tests.test_torch_bounded import run_bounded


@pytest.fixture(autouse=True)
def _cpu():
    device.set_device('cpu')


def _untraced(hdr):
    return {k: v for k, v in hdr.items() if k != '_trace'}


def _header(gulp=4):
    return {'name': 'v', 'time_tag': 7, 'gulp_nframe': gulp, '_tensor': {
        'shape': [-1, 4, 6, 1], 'dtype': 'f32',
        'labels': ['time', 'freq', 'fine', 'pol'],
        'scales': [[10.0, 0.5], [1400.0, 6.0], [0.0, 1000000.0], [0, 1]],
        'units': ['s', 'MHz', 'Hz', None]}}


class _Holder(object):
    """A stand-in block: just an output ring for the view to wrap."""

    def __init__(self, ring):
        self.orings = [ring]


def _apply(pkg, name, args, hdr):
    """The header that ``pkg``'s view ``name`` presents for ``hdr``."""
    blk = getattr(pkg.views, name)(_Holder(pkg.Ring(space='system')),
                                   *args)
    view = blk.orings[0]
    assert view.is_view
    return view.header_transform(deepcopy(hdr))


VIEWS = [
    ('custom', (lambda h: dict(h, extra=3),)),
    ('rename_axis', ('fine', 'fine_freq')),
    ('reinterpret_axis', ('fine', 'chan', [5.0, 2.0], 'kHz')),
    ('reinterpret_axis', (2, None, None, 'MHz')),
    ('reverse_scale', ('freq',)),
    ('add_axis', ('freq', 'beam', [0, 1], None)),
    ('add_axis', (-1,)),
    ('delete_axis', ('pol',)),
    ('astype', ('i16',)),
    ('astype', ('u8',)),
    ('split_axis', ('fine', 3, 'sub')),
    ('split_axis', ('time', 2)),
    ('merge_axes', ('freq', 'fine', 'chan')),
    ('merge_axes', (1, 2)),
    ('expose_view', ()),
]


@pytest.mark.parametrize('name,args', VIEWS,
                         ids=['%s-%d' % (v[0], i) for i, v in
                              enumerate(VIEWS)])
def test_view_header_equals_jax(name, args):
    hdr = _header()
    got = _apply(bt, name, args, hdr)
    want = _apply(bf, name, args, hdr)
    assert got == want
    assert hdr == _header()          # the transform works on a copy


@pytest.mark.parametrize('name,args', [
    ('delete_axis', ('freq',)),        # not of length 1
    ('merge_axes', ('time', 'fine')),  # not adjacent
    ('split_axis', ('fine', 4)),       # 4 does not divide 6
    ('astype', ('cf32',)),             # 64 bits do not divide 32 x 1
])
def test_view_refuses_what_jax_refuses(name, args):
    hdr = _header()
    with pytest.raises(ValueError):
        _apply(bf, name, args, hdr)
    with pytest.raises(ValueError):
        _apply(bt, name, args, hdr)


def test_merge_axes_refuses_scales_that_do_not_line_up():
    hdr = _header()
    hdr['_tensor']['scales'][2][1] = 2e6
    for pkg in (bf, bt):
        with pytest.raises(ValueError, match='line up'):
            _apply(pkg, 'merge_axes', ('freq', 'fine'), hdr)


def test_views_compose_and_share_the_base_ring():
    base = bt.Ring(space='system')
    v1 = bt.views.rename_axis(_Holder(base), 'fine', 'x')
    v2 = bt.views.merge_axes(v1, 'freq', 'x', label='chan')
    ring = v2.orings[0]
    assert ring.base is base and ring.view().base is base
    assert ring.space == 'system'
    got = ring.header_transform(_header())
    assert got['_tensor']['labels'] == ['time', 'chan', 'pol']
    assert got['_tensor']['shape'] == [-1, 24, 1]


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


class _Gather(bt.SinkBlock):
    def __init__(self, iring):
        super(_Gather, self).__init__(iring)
        self.headers, self.gulps = [], []

    def on_sequence(self, iseq):
        self.headers.append(iseq.header)

    def on_data(self, ispan):
        self.gulps.append(np.array(ispan.data.as_numpy(), copy=True))


def _stream():
    x = np.arange(8 * 4 * 6, dtype=np.float32).reshape(8, 4, 6, 1)
    return x, [x[:4], x[4:]]


def _run(pkg, chain, dev=None):
    x, gulps = _stream()
    hdr = _header()
    with pkg.Pipeline() as p:
        if pkg is bt:
            src = _Source(gulps, hdr, 4)
        else:
            src = NumpySourceBlock(gulps, hdr, gulp_nframe=4)
        base_sink = (_Gather if pkg is bt else GatherSink)(src)
        b = chain(pkg, src, dev)
        sink = (_Gather if pkg is bt else GatherSink)(b)
        run_bounded(p)
    if pkg is bt:
        return np.concatenate(sink.gulps), sink.headers, base_sink.gulps
    return sink.result(), sink.headers, None


def _split_merge(pkg, src, dev):
    b = pkg.views.split_axis(src, 'fine', 3, label='sub')
    b = pkg.views.merge_axes(b, 'freq', 'fine', label='chan')
    return pkg.views.rename_axis(b, 'sub', 'subband')


def test_view_tapped_host_ring_read_through_a_pipeline():
    """split_axis -> merge_axes -> rename_axis on a host ring: the reader
    sees the JAX pipeline's headers and the base ring's bytes, while a
    second reader on the base ring sees the base layout."""
    x, _ = _stream()
    got, hdrs, base = _run(bt, _split_merge)
    want, jhdrs, _ = _run(bf, _split_merge)
    assert [_untraced(h) for h in hdrs] == [_untraced(h) for h in jhdrs]
    assert hdrs[0]['_tensor']['shape'] == [-1, 8, 3, 1]
    assert got.shape == (8, 8, 3, 1)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got.reshape(x.shape), x)
    np.testing.assert_array_equal(np.concatenate(base), x)


def _device_chain(pkg, src, dev):
    b = pkg.blocks.copy(src, space=dev)
    b = pkg.views.merge_axes(b, 'freq', 'fine', label='chan')
    b = pkg.blocks.reduce(b, 'chan', 4, op='max')
    return pkg.blocks.copy(b, space='system')


def test_view_tapped_device_ring_read_through_a_pipeline():
    """merge_axes on a device ring feeds a device reduce: the view hands
    the committed tensor over in its layout (24 channels), and the result
    equals numpy's, under the JAX chain's headers.  (The JAX device ring
    hands the reader the base layout, (4, 6) channels, so its reduce runs
    over the wrong axis: ROADMAP queue 3, weak spots in the reference.)"""
    x, _ = _stream()
    got, hdrs, _ = _run(bt, _device_chain, 'cuda')
    _, jhdrs, _ = _run(bf, _device_chain, 'tpu')
    assert [_untraced(h) for h in hdrs] == [_untraced(h) for h in jhdrs]
    assert got.shape == (8, 6, 1)
    np.testing.assert_array_equal(
        got, x.reshape(8, 6, 4, 1).max(axis=2))


def test_frame_axis_split_view_regulps_the_reader():
    """split_axis of the frame axis: 4-frame gulps read as 2 frames of 2
    (gulp_nframe shrinks), bytes unchanged."""
    def chain(pkg, src, dev):
        return pkg.views.split_axis(src, 'time', 2, label='sub')
    x, _ = _stream()
    got, hdrs, _ = _run(bt, chain)
    want, jhdrs, _ = _run(bf, chain)
    assert [_untraced(h) for h in hdrs] == [_untraced(h) for h in jhdrs]
    assert hdrs[0]['gulp_nframe'] == 2
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got.reshape(x.shape), x)


def test_block_chainer_equals_jax():
    """BlockChainer threads the last block through blocks and views, as
    the JAX package's does (``tests/test_pipeline_cpu.py:44``)."""
    x, gulps = _stream()
    outs = {}
    for pkg in (bt, bf):
        with pkg.Pipeline() as p:
            bc = pkg.BlockChainer()
            bc.last_block = (_Source(gulps, _header(), 4) if pkg is bt else
                             NumpySourceBlock(gulps, _header(),
                                              gulp_nframe=4))
            bc.blocks.copy('system')
            bc.views.delete_axis('pol')
            bc.blocks.reverse(['fine'])
            last = bc.custom(lambda b: b)()
            assert last is bc.last_block
            sink = (_Gather if pkg is bt else GatherSink)(bc.last_block)
            run_bounded(p)
        outs[pkg] = (np.concatenate(sink.gulps) if pkg is bt
                     else sink.result(), sink.headers)
    np.testing.assert_array_equal(outs[bt][0], outs[bf][0])
    assert [_untraced(h) for h in outs[bt][1]] == \
        [_untraced(h) for h in outs[bf][1]]
    n = x.shape[2]
    np.testing.assert_array_equal(
        outs[bt][0], np.take(x[..., 0], (-np.arange(n)) % n, axis=2))
