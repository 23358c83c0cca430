"""The FFT / detect / reduce DSP pieces of the PyTorch/CUDA port against
the JAX package's stages, ops and blocks on the same seeded inputs:

- FftStage r2c, c2r (unnormalized), inverse and fftshift, within 1e-5 of
  max |JAX| (float32 transforms), headers equal; ``ops.fft.Fft``;
- DetectStage in every mode, on ci8 and cf32 input, one and two pols,
  within 1e-6 of max |JAX|, headers equal; the unfused detect block
  reaching K2 (its plain version here) on a (time, pol, freq) stream;
- ReduceStage and ``ops.reduce`` with every op, and the reduce block's
  host path;
- the fftshift, reverse and scrunch blocks on host and device rings,
  byte-identical where the op only moves data; print_header;
- the audio source over a fake PortAudio library, against the JAX block.

The port runs on the CPU device here.
"""

import contextlib
import importlib
from copy import deepcopy

import numpy as np
import pytest
import torch

import bifrost_tpu as bf
from bifrost_tpu import stages as JS
from tests.util import NumpySourceBlock, GatherSink

import bifrost_tpu_torch as bt
from bifrost_tpu_torch import device, stages as TS
from bifrost_tpu_torch.ndarray import ndarray
from bifrost_tpu_torch.ops import fft as tfft
from bifrost_tpu_torch.ops import gpu_kernels
from bifrost_tpu_torch.ops import reduce as treduce
from tests.test_torch_bounded import run_bounded

# the JAX package's ops/__init__ rebinds these names to functions
jfft = importlib.import_module('bifrost_tpu.ops.fft')
jreduce = importlib.import_module('bifrost_tpu.ops.reduce')

FFT_RTOL = 1e-5
DETECT_RTOL = 1e-6


@pytest.fixture(autouse=True)
def _cpu():
    device.set_device('cpu')


def _untraced(hdr):
    return {k: v for k, v in hdr.items() if k != '_trace'}


def _hdr(shape, dtype, labels):
    n = len(shape)
    return {'name': 's', 'time_tag': 0, 'gulp_nframe': 4, '_tensor': {
        'shape': list(shape), 'dtype': dtype, 'labels': list(labels),
        'scales': [[0.5 * i, 1.0 + i] for i in range(n)],
        'units': ['s', 'MHz', 's', None][:n]}}


def _devrep(x, dtype):
    """numpy logical values -> (port tensor, JAX input) device reps."""
    if dtype == 'ci8':
        pairs = np.stack([x.real, x.imag], -1).astype(np.int8)
        return torch.from_numpy(pairs), pairs
    return torch.from_numpy(np.ascontiguousarray(x)), x


def _rel(got, want):
    want = np.asarray(want)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _run_stage(tstage, jstage, hdr, x, dtype):
    """(port output, JAX output, port header, JAX header)."""
    th = tstage.transform_header(deepcopy(hdr))
    jh = jstage.transform_header(deepcopy(hdr))
    tx, jx = _devrep(x, dtype)
    reim = dtype.startswith('ci')
    meta = {'shape': list(tx.shape), 'reim': reim}
    got = tstage.build(dict(meta, dtype=bt.DataType(dtype)))(tx)
    want = jstage.build(dict(meta, dtype=bf.DataType(dtype)))(jx)
    return got.numpy(), np.asarray(want), th, jh


def _cvals(rng, shape, dtype):
    if dtype == 'ci8':
        return rng.randint(-60, 60, size=shape) + \
            1j * rng.randint(-60, 60, size=shape)
    return (rng.randn(*shape) + 1j * rng.randn(*shape)).astype(np.complex64)


# ---------------------------------------------------------------------------
# FFT
# ---------------------------------------------------------------------------

FFT_CASES = [
    # (input dtype, kwargs, axes)
    ('cf32', {}, ['fine']),
    ('cf32', {'inverse': True}, ['fine']),
    ('cf32', {'apply_fftshift': True}, ['fine']),
    ('cf32', {'inverse': True, 'apply_fftshift': True}, ['fine']),
    ('cf32', {}, ['freq', 'fine']),
    ('ci8', {'apply_fftshift': True}, ['fine']),
    ('f32', {}, ['fine']),
    ('f32', {'apply_fftshift': True}, ['freq', 'fine']),
    ('cf32', {'real_output': True}, ['fine']),
    ('cf32', {'real_output': True, 'apply_fftshift': True}, ['fine']),
    ('cf32', {'real_output': True}, ['freq', 'fine']),
]


@pytest.mark.parametrize('dtype,kwargs,axes', FFT_CASES)
def test_fft_stage_equals_jax(dtype, kwargs, axes):
    """c2c forward / inverse, r2c and c2r, with and without fftshift, over
    one and two axes: headers equal, values within 1e-5 of max |JAX|
    (the inverse and c2r unnormalized in both)."""
    rng = np.random.RandomState(len(axes) + 3 * len(kwargs))
    shape = (4, 6, 16)
    hdr = _hdr([-1, 6, 16], dtype, ['time', 'freq', 'fine'])
    if dtype == 'f32':
        x = rng.randn(*shape).astype(np.float32)
    else:
        x = _cvals(rng, shape, dtype)
    got, want, th, jh = _run_stage(
        TS.FftStage(axes, axis_labels=['a%d' % i for i in range(len(axes))],
                    **kwargs),
        JS.FftStage(axes, axis_labels=['a%d' % i for i in range(len(axes))],
                    **kwargs), hdr, x, dtype)
    assert th == jh
    assert got.dtype == want.dtype and got.shape == want.shape
    assert _rel(got, want) < FFT_RTOL


@pytest.mark.parametrize('kind', ['c2c', 'r2c', 'c2r', 'inverse', 'shift'])
def test_fft_op_equals_jax(kind):
    """The plan-style ``ops.fft.Fft`` (and the one-shot ``fft``) against
    the JAX op, into host arrays."""
    rng = np.random.RandomState(7)
    x = (rng.randn(3, 32) + 1j * rng.randn(3, 32)).astype(np.complex64)
    if kind == 'r2c':
        x = x.real.copy()
    oshape = {'r2c': (3, 17), 'c2r': (3, 62)}.get(kind, (3, 32))
    odt = np.float32 if kind == 'c2r' else np.complex64
    xi = x
    out = np.zeros(oshape, odt)
    jout = np.zeros(oshape, odt)
    shift = kind == 'shift'
    inverse = kind == 'inverse'
    tfft.Fft().init(xi, out, axes=1, apply_fftshift=shift).execute(
        xi, out, inverse=inverse)
    jplan = jfft.Fft().init(xi, jout, axes=1, apply_fftshift=shift)
    jres = np.asarray(jplan.execute(xi, jout, inverse=inverse))
    assert _rel(out, jres) < FFT_RTOL
    if kind == 'c2c':
        one = tfft.fft(xi, axes=[1]).numpy()
        assert _rel(one, jres) < FFT_RTOL


# ---------------------------------------------------------------------------
# detect
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('dtype', ['ci8', 'cf32'])
@pytest.mark.parametrize('mode,npol', [
    ('scalar', 2), ('jones', 2), ('stokes', 2), ('stokes_i', 2),
    ('coherence', 2), ('stokes', 1), ('jones', 1), ('coherence', 1)])
def test_detect_stage_equals_jax(mode, npol, dtype):
    """Every detect mode on a (time, freq, pol) stream: headers equal,
    values within 1e-6 of max |JAX|."""
    rng = np.random.RandomState(npol + len(mode))
    x = _cvals(rng, (4, 5, npol), dtype)
    hdr = _hdr([-1, 5, npol], dtype, ['time', 'freq', 'pol'])
    axis = None if mode == 'scalar' else 'pol'
    got, want, th, jh = _run_stage(TS.DetectStage(mode, axis),
                                   JS.DetectStage(mode, axis), hdr, x,
                                   dtype)
    assert th == jh
    assert got.dtype == want.dtype and got.shape == want.shape
    assert _rel(got, want) < DETECT_RTOL


def test_invalid_detect_mode_raises_as_jax():
    for stage in (TS.DetectStage, JS.DetectStage):
        with pytest.raises(ValueError):
            stage('bogus')


class _Source(bt.SourceBlock):
    def __init__(self, gulps, header, gulp_nframe):
        super(_Source, self).__init__(['src'], gulp_nframe)
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


def _pipe(pkg, gulps, hdr, chain, device_ring):
    dev = 'cuda' if pkg is bt else 'tpu'
    with pkg.Pipeline() as p:
        if pkg is bt:
            src = _Source(gulps, hdr, gulps[0].shape[0])
        else:
            src = NumpySourceBlock(gulps, hdr, gulp_nframe=gulps[0].shape[0])
        b = src
        if device_ring:
            b = pkg.blocks.copy(b, space=dev)
        b = chain(pkg, b)
        if device_ring:
            b = pkg.blocks.copy(b, space='system')
        sink = (_Gather if pkg is bt else GatherSink)(b)
        run_bounded(p)
    out = np.concatenate(sink.gulps) if pkg is bt else sink.result()
    return out, sink.headers


def test_unfused_detect_block_reaches_k2(monkeypatch):
    """detect('stokes') on a (time, pol, freq) complex64 ring runs K2's
    wrapper once per gulp (its plain version on the CPU) and equals the
    JAX detect block."""
    calls = []
    real = gpu_kernels.stokes_detect

    def spy(*planes):
        calls.append(tuple(p.shape for p in planes))
        return real(*planes)
    monkeypatch.setattr(gpu_kernels, 'stokes_detect', spy)
    rng = np.random.RandomState(3)
    x = (rng.randn(12, 2, 8) + 1j * rng.randn(12, 2, 8)).astype(np.complex64)
    gulps = [x[:4], x[4:8], x[8:]]
    hdr = _hdr([-1, 2, 8], 'cf32', ['time', 'pol', 'freq'])

    def chain(pkg, b):
        return pkg.blocks.detect(b, 'stokes')
    got, hdrs = _pipe(bt, gulps, hdr, chain, True)
    want, jhdrs = _pipe(bf, gulps, hdr, chain, True)
    assert calls == [((4, 8),) * 4] * 3
    assert [_untraced(h) for h in hdrs] == [_untraced(h) for h in jhdrs]
    assert got.shape == (12, 4, 8)
    assert _rel(got, want) < DETECT_RTOL


# ---------------------------------------------------------------------------
# reduce
# ---------------------------------------------------------------------------

OPS = ['sum', 'mean', 'min', 'max', 'stderr', 'pwrsum', 'pwrmean',
       'pwrmin', 'pwrmax', 'pwrstderr']


@pytest.mark.parametrize('op', OPS)
@pytest.mark.parametrize('axis,factor', [('freq', 4), ('freq', None),
                                         ('time', 2)])
def test_reduce_stage_equals_jax(op, axis, factor):
    """Every op over a non-frame axis (a factor, the whole axis) and the
    frame axis, on f32 input (and cf32 for the ops complex input takes):
    headers equal, values within 1e-5 of max |JAX|."""
    rng = np.random.RandomState(len(op))
    for dtype in ('f32', 'cf32'):
        if dtype == 'cf32' and op in ('min', 'max'):
            continue
        x = rng.randn(4, 8, 2).astype(np.float32)
        if dtype == 'cf32':
            x = (x + 1j * rng.randn(4, 8, 2)).astype(np.complex64)
        hdr = _hdr([-1, 8, 2], dtype, ['time', 'freq', 'pol'])
        got, want, th, jh = _run_stage(TS.ReduceStage(axis, factor, op),
                                       JS.ReduceStage(axis, factor, op),
                                       hdr, x, dtype)
        assert th == jh
        assert got.dtype == want.dtype and got.shape == want.shape
        assert _rel(got, want) < 1e-5


@pytest.mark.parametrize('op', OPS)
def test_reduce_op_equals_jax(op):
    rng = np.random.RandomState(11)
    x = rng.randn(6, 12).astype(np.float32)
    out, jout = np.zeros((6, 3), np.float32), np.zeros((6, 3), np.float32)
    treduce.reduce(x, out, op=op)
    jres = np.asarray(jreduce.reduce(x, jout, op=op))
    assert _rel(out, jres) < 1e-5
    host = ndarray(np.zeros((6, 3), np.float32))
    assert treduce.reduce(ndarray(x), host, op=op) is host
    np.testing.assert_array_equal(host.as_numpy(), out)


@pytest.mark.parametrize('op', ['sum', 'mean', 'max', 'stderr', 'pwrmean'])
@pytest.mark.parametrize('device_ring', [False, True])
def test_reduce_block_equals_jax(op, device_ring):
    """The reduce block on a host ring (numpy path) and a device ring
    (ReduceStage), against the JAX block."""
    rng = np.random.RandomState(5)
    x = rng.randn(8, 16, 2).astype(np.float32)
    gulps = [x[:4], x[4:]]
    hdr = _hdr([-1, 16, 2], 'f32', ['time', 'freq', 'pol'])

    def chain(pkg, b):
        return pkg.blocks.reduce(b, 'freq', 4, op=op)
    got, hdrs = _pipe(bt, gulps, hdr, chain, device_ring)
    want, jhdrs = _pipe(bf, gulps, hdr, chain, device_ring)
    assert [_untraced(h) for h in hdrs] == [_untraced(h) for h in jhdrs]
    assert got.shape == (8, 4, 2)
    assert _rel(got, want) < 1e-5


# ---------------------------------------------------------------------------
# fftshift, reverse, scrunch, print_header
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('device_ring', [False, True])
@pytest.mark.parametrize('block,args', [
    ('fftshift', (['freq'],)), ('fftshift', (['freq', 'pol'], True)),
    ('reverse', (['freq'],)), ('reverse', (['freq', 'pol'],))])
def test_data_moving_blocks_byte_identical_to_jax(block, args, device_ring):
    """fftshift (forward and inverse) and the cyclic reverse move data
    only: byte-identical to the JAX blocks, headers (shifted and reversed
    scales) equal, and equal to numpy's index gathers."""
    rng = np.random.RandomState(9)
    x = rng.randn(8, 7, 3).astype(np.float32)
    gulps = [x[:4], x[4:]]
    hdr = _hdr([-1, 7, 3], 'f32', ['time', 'freq', 'pol'])

    def chain(pkg, b):
        return getattr(pkg.blocks, block)(b, *args)
    got, hdrs = _pipe(bt, gulps, hdr, chain, device_ring)
    want, jhdrs = _pipe(bf, gulps, hdr, chain, device_ring)
    assert [_untraced(h) for h in hdrs] == [_untraced(h) for h in jhdrs]
    assert got.tobytes() == want.tobytes()
    axes = [1] if args[0] == ['freq'] else [1, 2]
    if block == 'fftshift':
        fn = np.fft.ifftshift if len(args) > 1 else np.fft.fftshift
        np.testing.assert_array_equal(got, fn(x, axes=axes))
    else:
        ref = x
        for ax in axes:
            n = x.shape[ax]
            ref = np.take(ref, (-np.arange(n)) % n, axis=ax)
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize('device_ring', [False, True])
@pytest.mark.parametrize('dtype', ['f32', 'i16'])
def test_scrunch_block_equals_jax(dtype, device_ring):
    """scrunch(2): the mean of frame pairs, integers averaged in float32
    and truncated back, as the JAX block does."""
    rng = np.random.RandomState(2)
    npdt = np.float32 if dtype == 'f32' else np.int16
    x = (rng.randn(8, 5) * 100).astype(npdt)
    gulps = [x[:4], x[4:]]
    hdr = _hdr([-1, 5], dtype, ['time', 'freq'])

    def chain(pkg, b):
        return pkg.blocks.scrunch(b, 2)
    got, hdrs = _pipe(bt, gulps, hdr, chain, device_ring)
    want, jhdrs = _pipe(bf, gulps, hdr, chain, device_ring)
    assert [_untraced(h) for h in hdrs] == [_untraced(h) for h in jhdrs]
    assert got.dtype == want.dtype and got.shape == (4, 5)
    if dtype == 'i16':
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(
        got, x.reshape(4, 2, 5).astype(np.float32).mean(1).astype(npdt),
        rtol=1e-6)


def test_print_header_block(capsys):
    x = np.zeros((4, 3), np.float32)
    hdr = _hdr([-1, 3], 'f32', ['time', 'freq'])
    with bt.Pipeline() as p:
        bt.blocks.print_header(_Source([x], hdr, 4))
        run_bounded(p)
    out = capsys.readouterr().out
    assert '_tensor' in out and 'freq' in out


def test_sigproc_reduce_path_byte_identical_to_jax(tmp_path):
    """BASELINE config 1's host path: read_sigproc -> transpose ->
    reduce -> write_sigproc writes the same file in both packages."""
    from tests.test_torch_sigproc import _filterbank
    path = str(tmp_path / 'in.fil')
    _filterbank(path, 32, 0, 32, 1, 16, seed=4)
    outs = {}
    for pkg in (bt, bf):
        outdir = tmp_path / pkg.__name__
        outdir.mkdir()
        with pkg.Pipeline() as p:
            b = pkg.blocks.read_sigproc([path], 8)
            b = pkg.blocks.transpose(b, ['time', 'pol', 'freq'])
            b = pkg.blocks.reduce(b, 'freq', 4)
            pkg.blocks.write_sigproc(b, path=str(outdir))
            run_bounded(p)
        outs[pkg] = (outdir / 'in.fil').read_bytes()
    assert outs[bt] == outs[bf]


class _FakePortAudio(object):
    """A PortAudio library stand-in (as ``tests/test_misc_blocks.py``'s):
    three good reads of int16 ramps, then an input overflow."""

    def __init__(self):
        self.reads = 0

    def Pa_Initialize(self):
        return 0

    def Pa_OpenDefaultStream(self, stream_p, channels, out_ch, fmt, rate,
                             fpb, cb, user):
        return 0

    def Pa_StartStream(self, stream):
        return 0

    def Pa_ReadStream(self, stream, buf, nframe):
        self.reads += 1
        if self.reads > 3:
            return -9988
        n = len(bytes(buf)) // 2
        buf[:] = (np.arange(n, dtype=np.int16) + 1000 * self.reads).tobytes()
        return 0

    def Pa_StopStream(self, stream):
        return 0

    def Pa_CloseStream(self, stream):
        return 0

    @property
    def Pa_GetErrorText(self):
        class F(object):
            restype = None

            def __call__(self, err):
                return b'fake overflow'
        return F()


class _Gather(bt.SinkBlock):
    def __init__(self, iring):
        super(_Gather, self).__init__(iring)
        self.headers, self.gulps = [], []

    def on_sequence(self, iseq):
        self.headers.append(iseq.header)

    def on_data(self, ispan):
        self.gulps.append(np.array(ispan.data.as_numpy(), copy=True))


def test_audio_block_equals_jax_with_a_fake_portaudio():
    """The port's audio source (``blocks/audio.py`` over
    ``io/portaudio.py``) against the JAX block, each over its own fake
    library: the same gulps, dtype and header."""
    from bifrost_tpu.io import portaudio as jpa
    from bifrost_tpu_torch.io import portaudio as tpa
    kw = [{'rate': 8000, 'channels': 2, 'nbits': 16}]
    tpa.set_library(_FakePortAudio())
    jpa.set_library(_FakePortAudio())
    try:
        with bt.Pipeline() as p:
            sink = _Gather(bt.blocks.read_audio(kw, gulp_nframe=8))
            run_bounded(p)
        with bf.Pipeline() as p:
            jsink = GatherSink(bf.blocks.read_audio(kw, gulp_nframe=8))
            run_bounded(p)
    finally:
        tpa.set_library(None)
        jpa.set_library(None)
    got = np.concatenate(sink.gulps)
    assert got.shape == (24, 2) and got.dtype == np.int16
    np.testing.assert_array_equal(got, jsink.result())
    np.testing.assert_array_equal(got[:8].reshape(-1),
                                  np.arange(16, dtype=np.int16) + 1000)
    hdr, jhdr = sink.headers[0], jsink.headers[0]
    assert hdr['_tensor'] == jhdr['_tensor']
    assert hdr['frame_rate'] == jhdr['frame_rate'] == 8000
    if not tpa.available():
        with pytest.raises(ImportError):
            bt.blocks.read_audio(kw, gulp_nframe=8)
