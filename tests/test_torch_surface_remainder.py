"""The runtime surface that the port took last, against the JAX package on
the same seeded inputs, in one process (JAX on the CPU, the port on its
CPU device):

- pipeline auto-fusion (``Pipeline(auto_fuse=True)``): the JAX package's
  four ``test_auto_fuse_*`` tests rehomed onto the port, and the
  reference-style fft -> detect -> reduce chain through both packages
  (block counts, names and outputs), which on the port runs K1's plain
  version through ``match_spectrometer``;
- fused scopes (``block_scope(fuse=True)``), whose interior rings both
  packages size with ``buffer_factor`` 1, and per-block placement
  (``block_scope(device=N)`` / ``gpu=N``);
- ``on_skip`` overrides on a stream whose lost frames are fixed;
- the ring's named, timed and latest readers, ``read(whence=)`` and
  ``writing_ended`` on both port cores (the Python core on
  ``'cuda_host'``, the native core on ``'system'``);
- vector dtypes and the full host ``ndarray``;
- ``dot_graph``, ``as_default``, ``join_all``, ``num_outputs``,
  ``begin_writing`` and the device, affinity and proclog helpers.

Tolerance: float32 outputs at rtol 1e-5; everything else exact.
"""

import re
import sys
import threading
import types

import numpy as np
import pytest

import bifrost_tpu as bf
import bifrost_tpu.dtype as jdtype
import bifrost_tpu.ring as jring
from tests import test_dtype as JDT
from tests import test_ndarray as JND
from tests import test_pipeline_cpu as JPC
from tests.util import (NumpySourceBlock as JNumpySource,
                        GatherSink as JGatherSink, simple_header)

import bifrost_tpu_torch as bt
import bifrost_tpu_torch.dtype as tdtype
import bifrost_tpu_torch.ring as tring
from bifrost_tpu_torch import affinity, device, proclog
from bifrost_tpu_torch.ops import spectrometer as spec
from tests.test_torch_bounded import run_bounded
from tests.test_torch_supervision import TorchGatherSink, TorchNumpySourceBlock
from tests.test_torch_wire_formats import rehome

RTOL = 1e-5

tndarray = sys.modules['bifrost_tpu_torch.ndarray']
jndarray = sys.modules['bifrost_tpu.ndarray']


@pytest.fixture(autouse=True)
def _cpu(monkeypatch, tmp_path):
    device.set_device('cpu')
    monkeypatch.setenv('BF_PROCLOG_DIR', str(tmp_path / 'proclog'))
    monkeypatch.delenv('BF_AUTO_FUSE', raising=False)
    yield
    device.bind_device(None)


class NumpySourceBlock(TorchNumpySourceBlock):
    """The port's source of numpy gulps under the JAX helper's name."""


class GatherSink(TorchGatherSink):
    """The port's gathering sink under the JAX helper's name."""


def _port_copy(iring, space=None, *args, **kwargs):
    """``blocks.copy`` with the JAX tests' device space name mapped."""
    return bt.blocks.copy(iring, 'cuda' if space == 'tpu' else space,
                          *args, **kwargs)


def _shim(name, base, **attrs):
    """A module ``name`` that is ``base`` but for ``attrs``."""
    mod = types.ModuleType(name)
    mod.__dict__.update(attrs)
    mod.__getattr__ = lambda attr: getattr(base, attr)
    return mod


_blocks = _shim('bifrost_tpu.blocks', bt.blocks, copy=_port_copy)
_bf = _shim('bifrost_tpu', bt, blocks=_blocks)
_util = _shim('tests.util', types.ModuleType('empty'),
              simple_header=simple_header,
              NumpySourceBlock=NumpySourceBlock, GatherSink=GatherSink)


def _port_device_count():
    import torch
    return torch.cuda.device_count() if device.on_cuda() else 1


#: the JAX placement test reads ``jax.devices()``; the port's are its
#: cards (one CPU device here)
_jax = _shim('jax', types.ModuleType('empty'),
             devices=lambda: list(range(_port_device_count())))

SURFACE_MAP = {'bifrost_tpu': _bf, 'bifrost_tpu.blocks': _blocks,
               'bifrost_tpu.dtype': tdtype,
               'bifrost_tpu.pipeline': bt.pipeline, 'tests.util': _util}

AUTO_FUSE_TESTS = sorted(n for n in dir(JPC)
                         if n.startswith('test_auto_fuse_'))


def test_rehome_finds_the_jax_auto_fuse_tests():
    assert AUTO_FUSE_TESTS == [
        'test_auto_fuse_carries_per_block_tunables',
        'test_auto_fuse_output_identical_and_blocks_collapse',
        'test_auto_fuse_skips_tapped_ring',
        'test_auto_fuse_skips_view_tapped_ring']


@pytest.mark.parametrize('name', AUTO_FUSE_TESTS)
def test_jax_auto_fuse_test_on_the_port(name):
    rehome(getattr(JPC, name), SURFACE_MAP)()


def test_jax_block_scope_device_placement_on_the_port():
    """Skips, as the JAX test does, with fewer than 4 devices."""
    rehome(JPC.test_block_scope_device_placement,
           dict(SURFACE_MAP, jax=_jax))()


# ---------------------------------------------------------------------------
# auto-fusion of the reference-style spectrometer chain, both packages
# ---------------------------------------------------------------------------

def _ci8_raw(seed, shape=(8, 2, 64)):
    rng = np.random.RandomState(seed)
    raw = np.zeros(shape, dtype=jdtype.ci8)
    raw['re'] = rng.randint(-32, 32, size=shape)
    raw['im'] = rng.randint(-32, 32, size=shape)
    return raw


def _spec_chain(pkg, auto_fuse, raw, scope=None):
    """source -> copy(device) -> fft -> detect('stokes') -> reduce('freq',
    4) -> copy('system') -> sink through ``pkg``; returns (output, block
    names, pipeline)."""
    mod, src_cls, sink_cls, dev = pkg
    hdr = simple_header([-1, 2, raw.shape[2]], 'ci8',
                        labels=['time', 'pol', 'fine_time'])
    with mod.Pipeline(auto_fuse=auto_fuse) as p:
        src = src_cls([raw], hdr, gulp_nframe=raw.shape[0])
        b = mod.blocks.copy(src, space=dev)
        with mod.block_scope(**(scope or {})):
            b = mod.blocks.fft(b, axes='fine_time', axis_labels='freq')
            b = mod.blocks.detect(b, mode='stokes')
            b = mod.blocks.reduce(b, 'freq', 4)
        sink = sink_cls(mod.blocks.copy(b, space='system'))
        run_bounded(p) if mod is bt else p.run()
    return sink.result(), [blk.name for blk in p.blocks], p


PORT = (bt, NumpySourceBlock, GatherSink, 'cuda')
JAX = (bf, JNumpySource, JGatherSink, 'tpu')


def _kinds(names):
    """Block names without their instance numbers or scope paths."""
    return [re.sub(r'_\d+$', '', n.split('/')[-1]) for n in names]


@pytest.mark.parametrize('auto_fuse', [False, True])
def test_spectrometer_chain_fuses_as_in_jax(auto_fuse, monkeypatch):
    calls = []
    plain = spec.spectrometer_plain

    def counted(volt, rfactor=4):
        calls.append(tuple(volt.shape))
        return plain(volt, rfactor)
    monkeypatch.setattr(spec, 'spectrometer_plain', counted)
    raw = _ci8_raw(11)
    got, names, p = _spec_chain(PORT, auto_fuse, raw)
    want, jnames, _ = _spec_chain(JAX, auto_fuse, raw)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())
    assert _kinds(names) == _kinds(jnames)
    assert len(names) == (5 if auto_fuse else 7)
    fused = [b for b in p.blocks
             if b.name.split('/')[-1].startswith('AutoFused')]
    if auto_fuse:
        assert _kinds(b.name for b in fused) == ['AutoFused_x3_FftBlock']
        # the whole-chain kernel's plain version ran: once to prewarm,
        # once for the gulp
        assert fused[0].impl_info['impl'] == 'cuda-spectrometer'
        assert fused[0].impl_info['kernel'] == 'plain'
        assert calls == [(8, 2, 64, 2)] * 2
    else:
        assert fused == [] and calls == []


def test_auto_fuse_from_the_environment(monkeypatch):
    monkeypatch.setenv('BF_AUTO_FUSE', '1')
    assert bt.Pipeline().auto_fuse is True
    monkeypatch.setenv('BF_AUTO_FUSE', '0')
    assert bt.Pipeline().auto_fuse is False
    assert bt.Pipeline(auto_fuse=True).auto_fuse is True


def test_auto_fuse_runs_before_the_segment_compiler():
    """With both on, auto-fusion takes the chain first and the segment
    compiler sees the AutoFused block (``bifrost_tpu/pipeline.py:
    539-551``)."""
    raw = _ci8_raw(12)
    hdr = simple_header([-1, 2, 64], 'ci8',
                        labels=['time', 'pol', 'fine_time'])
    with bt.Pipeline(auto_fuse=True, segments='auto') as p:
        src = NumpySourceBlock([raw], hdr, gulp_nframe=8)
        b = bt.blocks.copy(src, space='cuda')
        b = bt.blocks.fft(b, axes='fine_time', axis_labels='freq')
        b = bt.blocks.detect(b, mode='stokes')
        b = bt.blocks.reduce(b, 'freq', 4)
        sink = GatherSink(bt.blocks.copy(b, space='system'))
        order = []
        p._auto_fuse = lambda f=p._auto_fuse: (order.append('fuse'), f())
        run_bounded(p)
    want, _, _ = _spec_chain(JAX, True, raw)
    np.testing.assert_allclose(sink.result(), want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())
    assert order == ['fuse']
    assert any(b.name.split('/')[-1].startswith('AutoFused')
               for b in p.blocks)


# ---------------------------------------------------------------------------
# fused scopes and placement
# ---------------------------------------------------------------------------

def _record_resizes(monkeypatch, module):
    seen = []
    orig = module.ReadSequence.resize

    def resize(self, gulp_nframe, buf_nframe=None, buffer_factor=None):
        seen.append((gulp_nframe, buf_nframe, buffer_factor))
        return orig(self, gulp_nframe, buf_nframe, buffer_factor)
    monkeypatch.setattr(module.ReadSequence, 'resize', resize)
    return seen


def test_fused_scope_sizes_interior_rings_as_jax(monkeypatch):
    raw = _ci8_raw(13)
    port = _record_resizes(monkeypatch, tring)
    jax_ = _record_resizes(monkeypatch, jring)
    got, _, p = _spec_chain(PORT, False, raw, scope={'fuse': True})
    want, _, jp = _spec_chain(JAX, False, raw, scope={'fuse': True})
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())
    # one resize a reader: fft, detect, reduce, the D2H copy, the sink
    assert sorted(port, key=repr) == sorted(jax_, key=repr)
    assert [f for _, _, f in port].count(1) == 2
    stage = [b for b in p.blocks if b.type in ('DetectBlock', 'ReduceBlock')]
    assert all(b.fused_ancestor is not None for b in stage)
    assert stage[0].is_fused_with(stage[1])
    copy_out = [b for b in p.blocks if b.type == 'CopyBlock'][-1]
    assert not copy_out.is_fused_with(stage[1])


def test_fused_scope_tunables_and_gpu_alias():
    with bt.Pipeline():
        with bt.block_scope(fuse=True, gpu=0) as s:
            assert s.device == 0 and s.gpu == 0
            with bt.block_scope(name='inner') as inner:
                assert inner.device == 0
                inner.cache_scope_hierarchy()
                assert inner.fused_ancestor is s
        with bt.block_scope(device=0, gpu=3) as t:
            assert t.device == 0
    assert 'device' in bt.BlockScope._TUNABLES


class _DeviceProbe(bt.SinkBlock):
    def __init__(self, iring, **kwargs):
        super(_DeviceProbe, self).__init__(iring, **kwargs)
        self.seen = []

    def on_sequence(self, iseq):
        self.seen.append((device.get_bound_device(), device.get_device(),
                          device.get_device_index()))

    def on_data(self, ispan):
        self.seen.append(ispan.data.device)


def _placement(index):
    gulps = [np.ones((4, 3), np.float32)]
    with bt.Pipeline() as p:
        src = NumpySourceBlock(gulps, simple_header([-1, 3], 'f32'),
                               gulp_nframe=4)
        with bt.block_scope(device=index):
            b = bt.blocks.copy(src, space='cuda')
            probe = _DeviceProbe(b)
        run_bounded(p)
    return probe.seen


def test_block_scope_device_zero_runs_on_the_cpu():
    import torch
    seen = _placement(0)
    cpu = torch.device('cpu')
    assert seen == [(cpu, cpu, 0), cpu]
    assert device.get_bound_device() is None     # the test's own thread


def test_block_scope_device_beyond_the_devices_raises():
    with pytest.raises(bt.PipelineInitError, match='device index 1'):
        _placement(1)


def test_bind_device_rules():
    import torch
    assert device.get_bound_device() is None
    device.bind_device(0)
    assert device.get_bound_device() == torch.device('cpu')
    with pytest.raises(ValueError):
        device.bind_device(1)
    assert device.get_bound_device() is None
    box = []
    device.bind_device(0)
    t = threading.Thread(target=lambda: box.append(
        device.get_bound_device()))
    t.start()
    t.join()
    assert box == [None]                 # a binding is per thread


# ---------------------------------------------------------------------------
# on_skip: frames lost to overwriting
# ---------------------------------------------------------------------------

#: the source writes 3 gulps of 16 frames into a ring of 16 frames with
#: no reader, so every frame is overwritten before the reader, 4 frames
#: a gulp, opens: each of its 12 gulps reaches on_skip
NSKIP_GULPS, SKIP_NT, READ_NT = 3, 16, 4


def _skip_gulps():
    return [np.repeat(np.arange(k * SKIP_NT, (k + 1) * SKIP_NT,
                                dtype=np.float32)[:, None], 3, axis=1)
            for k in range(NSKIP_GULPS)]


def _skip_classes(mod):
    class Marked(mod.TransformBlock):
        """Copies the data; lost frames become -1 and commit one frame
        short of the span."""

        def __init__(self, iring, **kwargs):
            super(Marked, self).__init__(iring, guarantee=False,
                                         gulp_nframe=READ_NT,
                                         buffer_nframe=2 * READ_NT,
                                         **kwargs)
            self.islices = []

        def on_sequence(self, iseq):
            return dict(iseq.header)

        def on_data(self, ispan, ospan):
            ospan.data.as_numpy()[...] = ispan.data.as_numpy()

        def on_skip(self, islice, ospan):
            self.islices.append((islice.start, islice.stop, islice.step,
                                 ospan.nframe))
            ospan.data.as_numpy()[...] = -1
            return max(ospan.nframe - 1, 0)

    class MultiMarked(mod.MultiTransformBlock):
        def __init__(self, irings, **kwargs):
            super(MultiMarked, self).__init__(irings, guarantee=False,
                                              gulp_nframe=READ_NT,
                                              buffer_nframe=2 * READ_NT,
                                              **kwargs)
            self.islices = []

        def on_sequence(self, iseqs):
            return [dict(s.header) for s in iseqs]

        def on_data(self, ispans, ospans):
            for i, o in zip(ispans, ospans):
                o.data.as_numpy()[...] = i.data.as_numpy()

        def on_skip(self, islices, ospans):
            self.islices.append([(s.start, s.stop, s.step)
                                 for s in islices])
            for o in ospans:
                o.data.as_numpy()[...] = -2
            return [o.nframe for o in ospans]
    return Marked, MultiMarked


def _lost_frames_run(pkg, multi):
    """Write the whole stream into its ring, then read it without a
    guarantee through an ``on_skip`` override: which frames the ring
    lost is fixed by the writes, not by thread timing."""
    mod, src_cls, sink_cls, _ = pkg
    with mod.Pipeline() as p1:
        src = src_cls(_skip_gulps(), simple_header([-1, 3], 'f32'),
                      gulp_nframe=SKIP_NT)
    run_bounded(p1) if mod is bt else p1.run()
    assert src.orings[0].writing_ended
    marked, multi_marked = _skip_classes(mod)
    with mod.Pipeline() as p2:
        blk = multi_marked([src]) if multi else marked(src)
        sink = sink_cls(blk)
    run_bounded(p2) if mod is bt else p2.run()
    return blk.islices, sink.result()


@pytest.mark.parametrize('multi', [False, True])
def test_on_skip_override_sees_jax_islices(multi):
    got_slices, got = _lost_frames_run(PORT, multi)
    want_slices, want = _lost_frames_run(JAX, multi)
    assert got_slices and got_slices == want_slices
    np.testing.assert_array_equal(got, want)
    assert len(got_slices) == 12
    # Marked commits one frame short of each span, MultiMarked whole spans
    assert got.shape == ((48, 3) if multi else (36, 3))
    assert (got == (-2 if multi else -1)).all()


def test_default_on_skip_zero_fills():
    class Plain(bt.TransformBlock):
        def __init__(self, iring):
            super(Plain, self).__init__(iring, guarantee=False,
                                        gulp_nframe=READ_NT,
                                        buffer_nframe=2 * READ_NT)

        def on_sequence(self, iseq):
            return dict(iseq.header)

        def on_data(self, ispan, ospan):
            ospan.data.as_numpy()[...] = ispan.data.as_numpy()

    with bt.Pipeline() as p1:
        src = NumpySourceBlock(_skip_gulps(), simple_header([-1, 3], 'f32'),
                               gulp_nframe=SKIP_NT)
    run_bounded(p1)
    with bt.Pipeline() as p2:
        sink = GatherSink(Plain(src))
    run_bounded(p2)
    out = sink.result()
    assert out.shape == (48, 3) and (out == 0).all()


# ---------------------------------------------------------------------------
# the ring's readers
# ---------------------------------------------------------------------------

SEQS = (('alpha', 10), ('beta', 20), ('gamma', 30))


def _read_one(rseq):
    with rseq:
        spans = [np.array(s.data.as_numpy(), copy=True)
                 for s in rseq.read(4)]
        return rseq.name, rseq.time_tag, rseq.header['name'], \
            np.concatenate(spans).tobytes()


def _readers(mod, space):
    ring = mod.Ring(space=space)
    with ring.begin_writing() as writer:
        for k, (name, ttag) in enumerate(SEQS):
            hdr = simple_header([-1, 3], 'f32', name=name)
            hdr['time_tag'] = ttag
            with writer.begin_sequence(hdr, 4, 64) as wseq:
                assert wseq.header['name'] == name
                with wseq.reserve(4) as span:
                    span.data.as_numpy()[...] = np.full((4, 3), k + 1.0,
                                                        np.float32)
                    span.commit(4)
        ended_inside = ring.writing_ended
    view = mod.ring.ring_view(ring, lambda h: dict(h, name='v-' +
                                                   h['name']))
    out = {'ended': (ended_inside, ring.writing_ended),
           'named': _read_one(ring.open_sequence('beta')),
           'at': _read_one(ring.open_sequence_at(30)),
           'latest': _read_one(ring.open_latest_sequence()),
           'earliest': _read_one(ring.open_earliest_sequence()),
           'view_named': _read_one(view.open_sequence('alpha')),
           'view_at': _read_one(view.open_sequence_at(20)),
           'view_latest': _read_one(view.open_latest_sequence()),
           'whence_latest': [s.name for s in ring.read(whence='latest')],
           'whence_earliest': [s.name for s in ring.read()],
           'view_whence': [s.header['name']
                           for s in view.read(whence='latest')]}
    for what, opener in (('missing_name', lambda: ring.open_sequence('x')),
                         ('missing_at', lambda: ring.open_sequence_at(7))):
        try:
            opener()
            out[what] = None
        except Exception as exc:
            out[what] = type(exc).__name__
    return ring, out


@pytest.mark.parametrize('space', ['cuda_host', 'system'])
def test_ring_readers_equal_jax(space):
    ring, got = _readers(bt, space)
    core = type(ring).__name__
    assert core == ('Ring' if space == 'cuda_host' else 'NativeRing')
    _, want = _readers(bf, 'system')
    assert got == want
    assert got['named'][:3] == ('beta', 20, 'beta')
    assert got['view_named'][2] == 'v-alpha'
    assert got['missing_name'] == 'EndOfDataStop'


@pytest.mark.parametrize('space', ['cuda_host', 'system'])
def test_open_sequence_waits_for_its_sequence(space):
    """A reader of a named sequence waits until the writer begins it;
    a poisoned ring wakes it with RingPoisonedError."""
    ring = bt.Ring(space=space)
    box = []

    def reader():
        with ring.open_sequence('late') as rseq:
            box.append(rseq.time_tag)
    with ring.begin_writing() as w:
        t = threading.Thread(target=reader, daemon=True)
        t.start()
        t.join(0.2)
        assert t.is_alive() and box == []
        hdr = simple_header([-1, 3], 'f32', name='late')
        hdr['time_tag'] = 5
        with w.begin_sequence(hdr, 4, 16):
            t.join(10)
    assert box == [5]
    ring2 = bt.Ring(space=space)
    errs = []

    def waiter():
        try:
            ring2.open_sequence_at(99)
        except Exception as exc:
            errs.append(type(exc).__name__)
    with ring2.begin_writing():
        t = threading.Thread(target=waiter, daemon=True)
        t.start()
        t.join(0.2)
        ring2.poison(RuntimeError('stop'))
        t.join(10)
    assert errs == ['RingPoisonedError']


def test_read_sequence_which_and_nringlet():
    ring = bt.Ring(space='system')
    with ring.begin_writing() as w:
        with w.begin_sequence(simple_header([-1, 3], 'f32', name='s0'),
                              4, 16) as ws:
            assert ws.nringlet == 1
    rs = tring.ReadSequence(ring, 'specific', name='s0')
    assert rs.name == 's0' and rs.nringlet == 1
    rs.close()
    with pytest.raises(ValueError):
        tring.ReadSequence(ring, 'sideways')


# ---------------------------------------------------------------------------
# vector dtypes and the full ndarray
# ---------------------------------------------------------------------------

DT_TESTS = sorted(n for n in dir(JDT) if n.startswith('test_')
                  and n != 'test_jax_dtypes')


@pytest.mark.parametrize('name', DT_TESTS)
def test_jax_dtype_test_on_the_port(name):
    rehome(getattr(JDT, name), {'bifrost_tpu.dtype': tdtype})()


DTYPE_NAMES = ['i4', 'u2', 'ci4', 'ci8', 'cf16', 'f32', 'f32_x2', 'ci16_x4',
               'u8_x3', 'i32', 'cf32', 'f64']


@pytest.mark.parametrize('name', DTYPE_NAMES)
def test_datatype_equals_jax(name):
    t, j = tdtype.DataType(name), jdtype.DataType(name)

    def props(d):
        out = {k: getattr(d, k) for k in
               ('kind', 'nbits', 'veclen', 'is_complex', 'is_real',
                'is_floating_point', 'is_integer', 'is_signed',
                'itemsize_bits', 'is_packed')}
        out['str'] = str(d)
        out['hash'] = hash(d) == hash(type(d)(str(d)))
        out['vec3'] = str(d.as_vector(3))
        out['nbit16'] = str(d.as_nbit(16))
        try:
            out['itemsize'] = d.itemsize
        except ValueError:
            out['itemsize'] = 'packed'
        try:
            out['numpy'] = d.as_numpy_dtype()
        except TypeError:
            out['numpy'] = 'none'
        return out
    assert props(t) == props(j)


def test_vector_torch_dtype_is_its_lane_type():
    for name in ('f32', 'i16', 'ci8', 'cf32'):
        base = tdtype.DataType(name)
        assert base.as_vector(4).as_torch_dtype() == base.as_torch_dtype()


ND_TESTS = ['test_asarray_roundtrip', 'test_packed_i4']


@pytest.mark.parametrize('name', ND_TESTS)
def test_jax_ndarray_test_on_the_port(name):
    rehome(getattr(JND, name), {'bifrost_tpu': bt})()


def _nd_facts(mod, nd, a):
    b = a.copy()
    b[1] = 7
    c = a.copy('system')
    return {'bf_dtype': str(a.bf_dtype), 'ndim': a.ndim, 'size': a.size,
            'nbytes': a.nbytes, 'len': len(a), 'shape': tuple(a.shape),
            'data': np.asarray(a.data).tobytes(),
            'getitem': np.asarray(a[1:3]).tobytes(),
            'array': np.asarray(a, dtype=np.float64).tobytes(),
            'copy_independent': (np.asarray(a.data)[1].tobytes() !=
                                 np.asarray(b.data)[1].tobytes()),
            'copy_space': c.space,
            'astype': (str(a.astype('i16').dtype),
                       np.asarray(a.astype('i16').as_numpy()).tobytes()),
            'flags': (a.native, a.conjugated,
                      nd.ndarray(a.as_numpy(), native=False,
                                 conjugated=True).conjugated)}


def test_ndarray_members_equal_jax():
    x = np.linspace(-3.6, 4.4, 12, dtype=np.float32).reshape(4, 3)
    got = _nd_facts(bt, tndarray, tndarray.asarray(x))
    want = _nd_facts(bf, jndarray, jndarray.asarray(x))
    assert got == want


def test_ndarray_packed_and_device_copy():
    for nd in (tndarray, jndarray):
        a = nd.empty((2, 8), 'i4', 'system')
        assert (a.shape, a.size, a.nbytes, a.ndim, len(a)) == \
            ((2, 8), 16, 8, 2, 2)
        with pytest.raises(TypeError):
            a[0]
    import torch
    a = tndarray.asarray(np.arange(6, dtype=np.float32))
    t = a.copy('cuda')
    assert isinstance(t, torch.Tensor) and t.device.type == 'cpu'
    np.testing.assert_array_equal(t.numpy(), np.arange(6))
    a[2] = tndarray.asarray(np.float32(9))
    assert a[2] == 9


# ---------------------------------------------------------------------------
# dot_graph, as_default, join_all, Block helpers, device/affinity/proclog
# ---------------------------------------------------------------------------

def _dot(pkg):
    mod, src_cls, sink_cls, dev = pkg
    hdr = simple_header([-1, 16], 'cf32', labels=['time', 'freq'])
    with mod.Pipeline(name='g') as p:
        src = src_cls([np.zeros((8, 16), np.complex64)], hdr,
                      gulp_nframe=8)
        b = mod.blocks.copy(src, space=dev)
        with mod.block_scope(name='stage'):
            d = mod.blocks.detect(b, mode='scalar')
        sink_cls(mod.blocks.copy(d, space='system'))
    return p.dot_graph()


def _canonical_dot(text):
    """Names numbered in order of appearance (the two packages count
    blocks and rings separately)."""
    names = {}

    def sub(m):
        return '"%s"' % names.setdefault(m.group(1), 'n%d' % len(names))
    return re.sub(r'"([^"]+)"', sub, text)


def test_dot_graph_equals_jax():
    got, want = _dot(PORT), _dot(JAX)
    assert _canonical_dot(got) == _canonical_dot(want)
    assert 'limegreen' in got and 'orange' in got


def test_as_default_join_all_and_block_helpers():
    p = bt.Pipeline(name='dflt')
    p.as_default()
    try:
        assert bt.get_default_pipeline() is p
        src = NumpySourceBlock([np.ones((4, 3), np.float32)],
                               simple_header([-1, 3], 'f32'),
                               gulp_nframe=4)
        assert src.pipeline is p and src.num_outputs() == 1
        sink = GatherSink(src)
        assert sink.num_outputs() == 0
        run_bounded(p)
        np.testing.assert_array_equal(sink.result(), 1)
    finally:
        bt.pipeline._stacks.scopes.pop()
        bt.pipeline._stacks.pipelines.pop()
    ev = threading.Event()
    slow = threading.Thread(target=ev.wait, daemon=True)
    quick = threading.Thread(target=lambda: None)
    slow.start()
    quick.start()
    assert bt.pipeline.join_all([slow, quick], 0.2) == [slow]
    ev.set()
    assert bt.pipeline.join_all([slow], 5) == []


def test_begin_writing_opens_each_ring():
    from contextlib import ExitStack
    with bt.Pipeline():
        src = NumpySourceBlock([], simple_header([-1, 3], 'f32'),
                               gulp_nframe=4)
    with ExitStack() as stack:
        writers = src.begin_writing(stack, src.orings)
        assert [w.ring for w in writers] == src.orings
        assert not src.orings[0].writing_ended
    assert src.orings[0].writing_ended


def test_device_helpers(monkeypatch):
    import torch
    monkeypatch.delenv('BF_ASSUME_IN_ORDER', raising=False)
    assert device.execution_in_order() is True
    monkeypatch.setenv('BF_ASSUME_IN_ORDER', '0')
    assert device.execution_in_order() is False
    with device.ExternalStream('s') as es:
        assert es.stream == 's'
    device.ensure_backend()
    device.force_completion(torch.ones(3), np.ones(2))   # host: no wait
    assert device.get_device_index() == 0


def test_sync_gulp_waits_on_every_event_out_of_order(monkeypatch):
    waits = []
    monkeypatch.setattr(device, 'record_event', lambda: object())
    monkeypatch.setattr(device, 'stream_synchronize',
                        lambda *ev: waits.append(ev))

    class Span(object):
        data = 1

        class ring(object):
            is_device = True

    for in_order, want in (('1', 1), ('0', 4)):
        monkeypatch.setenv('BF_ASSUME_IN_ORDER', in_order)
        with bt.Pipeline():
            blk = bt.Block([], sync_depth=1)
        del waits[:]
        blk._pending_events.extend(object() for _ in range(4))
        blk._sync_gulp([Span()])
        assert len(waits) == want


def test_set_openmp_cores_and_load_by_pid(monkeypatch, tmp_path):
    import bifrost_tpu.affinity as jaffinity
    import bifrost_tpu.proclog as jproclog
    for cores in ([0, 1, 2], 5):
        monkeypatch.delenv('OMP_NUM_THREADS', raising=False)
        affinity.set_openmp_cores(cores)
        got = dict(OMP=__import__('os').environ['OMP_NUM_THREADS'])
        jaffinity.set_openmp_cores(cores)
        assert got['OMP'] == __import__('os').environ['OMP_NUM_THREADS']
    pl = proclog.ProcLog('blk/perf')
    pl.update({'a': 1}, force=True)
    pid = __import__('os').getpid()
    assert proclog.load_by_pid(pid, include_rings=True) == \
        proclog.load_by_pid(pid)
    assert jproclog.load_by_pid(pid, include_rings=True) == \
        proclog.load_by_pid(pid)


# ---------------------------------------------------------------------------
# the names table: every public name of a JAX module that its port
# counterpart lacks is TPU-only, by design
# ---------------------------------------------------------------------------

#: (module, name) pairs the port leaves out on purpose (ROADMAP.md,
#: "Public names")
BY_DESIGN = {
    ('dtype.py', 'DataType.as_jax_dtype'), ('ndarray.py', 'ndarray.as_jax'),
    ('ops/common.py', 'as_jax'), ('ops/common.py', 'donating_jit'),
    ('devrep.py', 'device_rep_dtype'),
    ('utils.py', 'enable_compilation_cache'),
    ('ops/spectrometer.py', 'choose_precision'),
    ('ops/spectrometer.py', 'spectrometer_accuracy'),
    ('ops/spectrometer.py', 'kernel_usable'),
    ('ops/spectrometer.py', 'spectrometer_mode'),
    ('ops/beamform.py', 'fused_usable'), ('ops/fft.py', 'fft_impl_choice'),
    ('ops/fdmt.py', 'SMEM_TABLE_BUDGET'),
    ('ring.py', '_HostStorage.write_view'),
    ('ring_native.py', '_NativeStorage.write_view'),
    ('ring.py', '_DeviceStorage.fill_ghost_mirror'),
    ('blocks/copy.py', 'CopyBlock.define_valid_input_spaces'),
    ('ops/pallas_kernels.py', '*'),
}


def _public_names(path):
    """Top-level public names of a module and the public methods of its
    classes (``Class.method``), by ``ast``."""
    import ast
    out = set()
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            if not node.name.startswith('_'):
                out.add(node.name)
            if isinstance(node, ast.ClassDef):
                out.update('%s.%s' % (node.name, m.name) for m in node.body
                           if isinstance(m, ast.FunctionDef)
                           and not m.name.startswith('_'))
        elif isinstance(node, ast.Assign):
            out.update(t.id for t in node.targets
                       if isinstance(t, ast.Name)
                       and not t.id.startswith('_'))
    return out


def test_public_names_missing_from_the_port_are_by_design():
    import os
    jroot = os.path.dirname(bf.__file__)
    troot = os.path.dirname(bt.__file__)
    missing = set()
    for dirpath, _, files in os.walk(jroot):
        for f in files:
            if not f.endswith('.py'):
                continue
            rel = os.path.relpath(os.path.join(dirpath, f), jroot)
            port = os.path.join(troot, rel)
            if not os.path.exists(port):
                missing.add((rel, '*'))
                continue
            missing.update((rel, n) for n in
                           _public_names(os.path.join(jroot, rel)) -
                           _public_names(port))
    assert missing == BY_DESIGN


def test_by_design_names_are_the_jax_packages_tpu_paths():
    """The inherited copy rule and the port's substitutes of the TPU-only
    names: the device representation and its dtype, the ungated K1
    match."""
    import torch
    from bifrost_tpu_torch.blocks.copy import CopyBlock
    assert CopyBlock.define_valid_input_spaces is \
        bt.TransformBlock.define_valid_input_spaces
    assert tdtype.DataType('ci8').as_torch_dtype() == torch.int8
    x = tndarray.asarray(np.arange(4, dtype=np.float32)).copy('cuda')
    assert isinstance(x, torch.Tensor)
    assert not hasattr(tdtype.DataType, 'as_jax_dtype')


def test_chip_smoke_binds_each_module_name_once():
    """A phase's module constant may not rebind another phase's: a later
    binding of a shared name would set an earlier phase's depth."""
    import ast
    import collections
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), 'chip_smoke.py')
    seen = collections.Counter()
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            seen[node.name] += 1
        elif isinstance(node, ast.Assign):
            for target in node.targets:
                for name in ([target] if isinstance(target, ast.Name)
                             else getattr(target, 'elts', [])):
                    if isinstance(name, ast.Name):
                        seen[name.id] += 1
    assert [k for k, n in seen.items() if n > 1] == []
