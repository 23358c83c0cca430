"""The rest of the port's DSP library against the JAX package on the same
seeded inputs, run on the CPU device:

- ``ops.fir.Fir`` and the ``fir`` block: the cases of ``tests/test_fir.py``
  and ``test_blocks_dsp.py::test_fir_block_state``, state across gulps
  (a final partial gulp included), decimation, per-channel taps and the
  mesh path, within 1e-5 of the largest magnitude of JAX and of the
  float64 oracle;
- ``ops.romein.Romein``: the cases of ``tests/test_romein.py`` within
  1e-5 of the largest magnitude of a float64 ``np.add.at`` oracle and of
  JAX (scatter-adds in a varying order agree to rounding, not bit for
  bit), and ``polmajor=False`` refused;
- ``convert_visibilities``: matrix -> storage -> matrix as in
  ``tests/test_misc_blocks.py:36``, each conversion against the JAX
  block's (exact on integer-valued visibilities) and the storage values
  against a numpy conversion;
- ``ops.fft.dft_matmul_fft``: the cases of ``tests/test_fft.py:67,87``
  with their tolerances, and the port against JAX's DFT-matmul within
  1e-5 of the largest magnitude; ``fftn_dispatch`` stays on
  ``torch.fft`` whatever ``BF_FFT_IMPL`` says.
"""

import contextlib
import importlib
from copy import deepcopy

import numpy as np
import pytest
import torch

import bifrost_tpu as bf
from bifrost_tpu.ops.fir import Fir as JFir
from bifrost_tpu.ops.romein import Romein as JRomein
from tests.util import NumpySourceBlock, GatherSink, simple_header

import bifrost_tpu_torch as bt
from bifrost_tpu_torch import device
from bifrost_tpu_torch.blocks.convert_visibilities import (
    _tri_indices, baseline_indices, matrix_to_storage, storage_to_matrix)
from bifrost_tpu_torch.ops import fft as tfft
from bifrost_tpu_torch.ops.fir import Fir
from bifrost_tpu_torch.ops.romein import Romein
from tests.test_torch_bounded import run_bounded

jfft = importlib.import_module('bifrost_tpu.ops.fft')

REL = 1e-5           # float32 results, relative to the largest magnitude


@pytest.fixture(autouse=True)
def _cpu():
    device.set_device('cpu')


def _rel(got, want):
    want = np.asarray(want)
    return float(np.max(np.abs(np.asarray(got) - want)) /
                 max(np.max(np.abs(want)), 1e-30))


# ---------------------------------------------------------------------------
# FIR
# ---------------------------------------------------------------------------

def _lfilter(coeffs, x):
    """Causal FIR oracle along axis 0 (zero initial state), float64."""
    coeffs = np.asarray(coeffs, np.float64)
    x = np.asarray(x).astype(np.complex128 if np.iscomplexobj(x)
                             else np.float64)
    ntap = len(coeffs)
    xp = np.concatenate([np.zeros((ntap - 1,) + x.shape[1:], x.dtype), x])
    out = np.zeros_like(x)
    for t in range(ntap):
        out = out + coeffs[t] * xp[ntap - 1 - t: xp.shape[0] - t]
    return out


def _fir_both(coeffs, gulps, decim=1):
    """Outputs of the port's and JAX's Fir over ``gulps`` in turn."""
    t = Fir().init(coeffs, decim=decim)
    j = JFir().init(coeffs, decim=decim)
    tout = np.concatenate([t.execute(torch.from_numpy(g)).numpy()
                           for g in gulps])
    jout = np.concatenate([np.asarray(j.execute(g)) for g in gulps])
    return tout, jout


def test_fir_matches_oracle():
    rng = np.random.RandomState(0)
    x = rng.randn(64, 4).astype(np.float32)
    coeffs = np.array([0.5, 0.3, 0.2], np.float32)
    t, j = _fir_both(coeffs, [x])
    assert _rel(t, _lfilter(coeffs, x)) < REL
    assert _rel(t, j) < REL


def test_fir_state_across_gulps():
    """Two gulps equal the concatenation; after reset_state the first
    gulp's output comes again."""
    rng = np.random.RandomState(1)
    x = rng.randn(64, 3).astype(np.float32)
    coeffs = np.array([0.4, 0.3, 0.2, 0.1], np.float32)
    t, j = _fir_both(coeffs, [x[:32], x[32:]])
    full = _lfilter(coeffs, x)
    assert _rel(t, full) < REL and _rel(t, j) < REL
    fir = Fir().init(coeffs)
    fir.execute(torch.from_numpy(x[:32]))
    fir.reset_state()
    assert _rel(fir.execute(torch.from_numpy(x[:32])).numpy(),
                full[:32]) < REL


def test_fir_decimation():
    rng = np.random.RandomState(2)
    x = rng.randn(32, 2).astype(np.float32)
    coeffs = np.array([0.5, 0.5], np.float32)
    t, j = _fir_both(coeffs, [x[:16], x[16:]], decim=4)
    assert _rel(t, _lfilter(coeffs, x)[::4]) < REL
    assert _rel(t, j) < REL


def test_fir_complex_per_channel_coeffs():
    rng = np.random.RandomState(3)
    x = (rng.randn(16, 2) + 1j * rng.randn(16, 2)).astype(np.complex64)
    coeffs = rng.randn(3, 2).astype(np.float32)   # per-channel taps
    t, j = _fir_both(coeffs, [x[:8], x[8:]])
    expect = np.zeros((16, 2), np.complex128)
    xp = np.concatenate([np.zeros((2, 2), x.dtype), x])
    for k in range(3):
        expect += coeffs[k] * xp[2 - k:2 - k + 16]
    assert t.dtype == np.complex64
    assert _rel(t, expect) < REL and _rel(t, j) < REL


def test_fir_mesh_path_equals_single_device():
    """Under a mesh the time axis is sharded over 'sp' and the history
    crosses shards; equal to the unsharded filter within rounding."""
    from bifrost_tpu_torch import parallel as par
    rng = np.random.RandomState(4)
    x = rng.randn(32, 3).astype(np.float32)
    coeffs = rng.randn(5, 3).astype(np.float32)
    mesh = par.create_mesh({'sp': 4})
    got = Fir().init(coeffs, mesh=mesh)
    ref = Fir().init(coeffs)
    out = [got.execute(torch.from_numpy(x[i:i + 16])).numpy()
           for i in (0, 16)]
    want = [ref.execute(torch.from_numpy(x[i:i + 16])).numpy()
            for i in (0, 16)]
    assert _rel(np.concatenate(out), np.concatenate(want)) < REL
    assert _rel(np.concatenate(out), _lfilter(coeffs, x)) < REL


class _Source(bt.SourceBlock):
    """Emits ``gulps`` (possibly a short last one) into a host ring."""

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
        buf = ospans[0].data.as_numpy()
        if buf.dtype.names is not None:
            buf = buf.view(buf.dtype[0]).reshape(buf.shape + (2,))
        buf[:g.shape[0]] = g
        return [g.shape[0]]


class _Gather(bt.SinkBlock):
    def __init__(self, iring):
        super(_Gather, self).__init__(iring)
        self.headers, self.gulps = [], []

    def on_sequence(self, iseq):
        self.headers.append(iseq.header)

    def on_data(self, ispan):
        self.gulps.append(np.array(ispan.data.as_numpy(), copy=True))

    def result(self):
        return np.concatenate(self.gulps)


def _torch_chain(gulps, hdr, gulp_nframe, chain):
    with bt.Pipeline() as p:
        b = bt.blocks.copy(_Source(gulps, hdr, gulp_nframe), space='cuda')
        sink = _Gather(bt.blocks.copy(chain(b), space='system'))
    run_bounded(p)
    return sink


def test_fir_block_state():
    """``test_blocks_dsp.py::test_fir_block_state`` through the port."""
    T, C = 32, 4
    rng = np.random.RandomState(3)
    x = rng.randn(T, C).astype(np.float32)
    coeffs = np.array([0.5, 0.3, 0.2], np.float32)
    hdr = simple_header([-1, C], 'f32')
    sink = _torch_chain([x[:16], x[16:]], hdr, 16,
                        lambda b: bt.blocks.fir(b, coeffs))
    xp = np.concatenate([np.zeros((2, C), np.float32), x])
    expect = sum(coeffs[t] * xp[2 - t:2 - t + T] for t in range(3))
    np.testing.assert_allclose(sink.result(), expect, rtol=1e-5)


@pytest.mark.parametrize('decim', [1, 4])
def test_fir_block_ci8_partial_gulp_equals_jax(decim):
    """ci8 input becomes cf32; the header's time step scales by decim;
    three gulps, the last one partial, equal the JAX block's output and
    the float64 oracle over the concatenated stream."""
    rng = np.random.RandomState(5 + decim)
    F, S = 3, 2
    v = rng.randint(-128, 128, size=(8 * 2 + 4, F, S, 2)).astype(np.int8)
    gulps = [v[:8], v[8:16], v[16:]]
    coeffs = rng.randn(4, F, S).astype(np.float32) if decim == 1 else \
        rng.randn(6).astype(np.float32)
    hdr = simple_header([-1, F, S], 'ci8', gulp_nframe=8)
    hdr['_tensor']['scales'] = [[0, 0.5], [0, 1], [0, 1]]
    sink = _torch_chain(gulps, hdr, 8,
                        lambda b: bt.blocks.fir(b, coeffs, decim))
    out = sink.result()
    jgulps = []
    for g in gulps:
        a = np.zeros(g.shape[:-1], bf.dtype.ci8)
        a['re'], a['im'] = g[..., 0], g[..., 1]
        jgulps.append(a)
    with bf.Pipeline() as p:
        b = bf.blocks.copy(NumpySourceBlock(jgulps, hdr, gulp_nframe=8),
                           space='tpu')
        b = bf.blocks.copy(bf.blocks.fir(b, coeffs, decim), space='system')
        jsink = GatherSink(b)
    run_bounded(p)
    jout = jsink.result()
    assert sink.headers[0]['_tensor']['dtype'] == 'cf32'
    assert sink.headers[0]['_tensor']['scales'][0] == [0, 0.5 * decim]
    assert sink.headers[0]['_tensor'] == jsink.headers[0]['_tensor']
    xc = v[..., 0] + 1j * v[..., 1].astype(np.float64)
    want = _lfilter(coeffs, xc)[::decim]
    assert out.shape == want.shape == jout.shape
    assert _rel(out, want) < REL and _rel(out, jout) < REL


def test_fir_block_refuses_decimation_not_dividing_the_gulp():
    x = np.zeros((6, 2), np.float32)
    hdr = simple_header([-1, 2], 'f32')
    with pytest.raises(bt.PipelineInitError, match='Decimation'):
        _torch_chain([x], hdr, 6, lambda b: bt.blocks.fir(b, [1., 1.], 4))


# ---------------------------------------------------------------------------
# Romein
# ---------------------------------------------------------------------------

def _romein_oracle(data, pos, kern, ngrid):
    """float64 np.add.at scatter of data * kern onto a wrapping grid."""
    data = np.asarray(data).astype(np.complex128)
    kern = np.asarray(kern).astype(np.complex128)
    grid = np.zeros((ngrid, ngrid), np.complex128)
    k = kern.shape[-1]
    d = np.arange(k)
    gy = (pos[:, 1, None, None] + d[None, :, None]) % ngrid
    gx = (pos[:, 0, None, None] + d[None, None, :]) % ngrid
    np.add.at(grid, (np.broadcast_to(gy, kern.shape),
                     np.broadcast_to(gx, kern.shape)),
              data[:, None, None] * kern)
    return grid


def _cplx(rng, *shape):
    return (rng.randn(*shape) + 1j * rng.randn(*shape)).astype(np.complex64)


def _romein_both(pos, kern, ngrid, data, **kw):
    t = Romein().init(pos, kern, ngrid).execute(torch.from_numpy(data), **kw)
    j = JRomein().init(pos, kern, ngrid).execute(data, **kw)
    return t.numpy(), np.asarray(j)


def test_gridding_matches_oracle():
    rng = np.random.RandomState(0)
    npts, ksize, ngrid = 50, 4, 32
    data = _cplx(rng, npts)
    pos = rng.randint(0, ngrid - ksize, size=(npts, 2)).astype(np.int32)
    kern = _cplx(rng, npts, ksize, ksize)
    t, j = _romein_both(pos, kern, ngrid, data)
    want = _romein_oracle(data, pos, kern, ngrid)
    assert t.dtype == np.complex64
    assert _rel(t, want) < REL and _rel(t, j) < REL


def test_gridding_wraps_at_edge():
    npts, ksize, ngrid = 10, 3, 16
    data = np.ones(npts, np.complex64)
    pos = np.full((npts, 2), ngrid - 1, np.int32)   # kernel wraps
    pos[::2, 0] = -2                                 # and from below
    kern = np.ones((npts, ksize, ksize), np.complex64)
    t, j = _romein_both(pos, kern, ngrid, data)
    np.testing.assert_array_equal(t, _romein_oracle(data, pos, kern, ngrid))
    np.testing.assert_array_equal(t, j)


def test_set_positions_and_kernels_update():
    rng = np.random.RandomState(2)
    npts, ksize, ngrid = 20, 3, 24
    data = _cplx(rng, npts)
    pos1 = rng.randint(0, ngrid - ksize, size=(npts, 2)).astype(np.int32)
    pos2 = rng.randint(0, ngrid - ksize, size=(npts, 2)).astype(np.int32)
    k1 = _cplx(rng, npts, ksize, ksize)
    k2 = _cplx(rng, npts, ksize, ksize)
    rom = Romein().init(pos1, k1, ngrid)
    x = torch.from_numpy(data)
    assert _rel(rom.execute(x).numpy(),
                _romein_oracle(data, pos1, k1, ngrid)) < REL
    rom.set_positions(pos2)
    assert _rel(rom.execute(x).numpy(),
                _romein_oracle(data, pos2, k1, ngrid)) < REL
    rom.set_kernels(k2)
    assert _rel(rom.execute(x).numpy(),
                _romein_oracle(data, pos2, k2, ngrid)) < REL


def test_accumulate_into_existing_grid():
    """accumulate=True adds onto odata: a tensor in place, a host array
    through a device copy; a second call doubles the contribution."""
    rng = np.random.RandomState(3)
    npts, ksize, ngrid = 15, 3, 16
    data = _cplx(rng, npts)
    pos = rng.randint(0, ngrid - ksize, size=(npts, 2)).astype(np.int32)
    kern = _cplx(rng, npts, ksize, ksize)
    base = _cplx(rng, ngrid, ngrid)
    rom = Romein().init(pos, kern, ngrid)
    grid = torch.from_numpy(base.copy())
    ptr = grid.data_ptr()
    got = rom.execute(torch.from_numpy(data), odata=grid, accumulate=True)
    assert got is grid and grid.data_ptr() == ptr
    once = _romein_oracle(data, pos, kern, ngrid)
    assert _rel(grid.numpy(), base + once) < REL
    rom.execute(torch.from_numpy(data), odata=grid, accumulate=True)
    assert _rel(grid.numpy(), base + 2 * once) < REL
    host = base.copy()
    rom.execute(data, odata=host, accumulate=True)
    jgot = JRomein().init(pos, kern, ngrid).execute(
        data, odata=base.copy(), accumulate=True)
    assert _rel(host, base + once) < REL
    assert _rel(host, np.asarray(jgot)) < REL


def test_batched_polarizations():
    rng = np.random.RandomState(4)
    npol, npts, ksize, ngrid = 2, 12, 3, 16
    data = _cplx(rng, npol, npts)
    pos = rng.randint(0, ngrid - ksize, size=(npts, 2)).astype(np.int32)
    kern = _cplx(rng, npts, ksize, ksize)
    t, j = _romein_both(pos, kern, ngrid, data)
    assert t.shape == (npol, ngrid, ngrid)
    for p in range(npol):
        assert _rel(t[p], _romein_oracle(data[p], pos, kern, ngrid)) < REL
    assert _rel(t, j) < REL


def test_real_input_promotes():
    rng = np.random.RandomState(5)
    npts, ksize, ngrid = 10, 2, 8
    data = rng.randn(npts).astype(np.float32)
    pos = rng.randint(0, ngrid - ksize, size=(npts, 2)).astype(np.int32)
    kern = np.ones((npts, ksize, ksize), np.complex64)
    t, j = _romein_both(pos, kern, ngrid, data)
    assert t.dtype == np.complex64
    assert _rel(t, _romein_oracle(data, pos, kern, ngrid)) < REL
    assert _rel(t, j) < REL


def test_romein_refuses_polmajor_false():
    """The JAX package stores polmajor and grids pol-major whatever it
    says (``bifrost_tpu/ops/romein.py:31-38``); the port refuses False
    (ROADMAP queue 3, by design)."""
    pos = np.zeros((4, 2), np.int32)
    kern = np.ones((4, 2, 2), np.complex64)
    with pytest.raises(NotImplementedError, match='polmajor'):
        Romein().init(pos, kern, 8, polmajor=False)
    Romein().init(pos, kern, 8, polmajor=True)


# ---------------------------------------------------------------------------
# convert_visibilities
# ---------------------------------------------------------------------------

VIS_LABELS = ['time', 'freq', 'station_i', 'pol_i', 'station_j', 'pol_j']


def _hermitian(rng, T, F, S, integer=False):
    if integer:
        full = (rng.randint(-50, 50, size=(T, F, S, 2, S, 2)) +
                1j * rng.randint(-50, 50, size=(T, F, S, 2, S, 2)))
    else:
        full = rng.randn(T, F, S, 2, S, 2) + 1j * rng.randn(T, F, S, 2, S, 2)
    full = full + np.conj(np.transpose(full, (0, 1, 4, 5, 2, 3)))
    full = full.astype(np.complex64)
    lower = full.copy()
    for i in range(S):
        for j in range(S):
            if i < j:
                lower[:, :, i, :, j, :] = 0
    lower[:, :, range(S), 0, range(S), 1] = 0       # diagonal pi < pj
    return full, lower


def _storage_numpy(full):
    """numpy matrix -> storage conversion of a full Hermitian matrix."""
    S = full.shape[2]
    bi, bj = _tri_indices(S)
    v = np.moveaxis(full[:, :, bi, :, bj, :], 0, 1)
    xx, xy, yx, yy = v[..., 0, 0], v[..., 0, 1], v[..., 1, 0], v[..., 1, 1]
    return np.stack([xx + yy, xx - yy, xy + yx, (xy - yx) * 1j], -1)


def _vis_chain(pkg, x, hdr, fmts):
    T = x.shape[0]
    with pkg.Pipeline() as p:
        if pkg is bt:
            src = _Source([x], hdr, T)
        else:
            src = NumpySourceBlock([x], hdr, gulp_nframe=T)
        b = pkg.blocks.copy(src, space='cuda' if pkg is bt else 'tpu')
        for f in fmts:
            b = pkg.blocks.convert_visibilities(b, f)
        b = pkg.blocks.copy(b, space='system')
        sink = (_Gather if pkg is bt else GatherSink)(b)
    run_bounded(p)
    return sink.result(), sink.headers[0]


def test_convert_visibilities_matrix_roundtrip():
    """matrix(lower) -> storage -> matrix(full) recovers the Hermitian
    matrix (``tests/test_misc_blocks.py:36`` through the port)."""
    T, F, S = 2, 3, 4
    full, lower = _hermitian(np.random.RandomState(1), T, F, S)
    hdr = simple_header([-1, F, S, 2, S, 2], 'cf32', labels=VIS_LABELS,
                        gulp_nframe=T)
    out, h = _vis_chain(bt, lower, hdr, ['storage', 'matrix'])
    assert h['_tensor']['labels'] == VIS_LABELS
    assert h['matrix_fill_mode'] == 'full'
    np.testing.assert_allclose(out, full, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize('fmts', [['storage'], ['matrix'],
                                  ['storage', 'matrix']])
def test_convert_visibilities_equals_jax(fmts):
    """Each conversion equals the JAX block's value for value on
    integer-valued visibilities (every sum and half exact), headers
    equal; storage equals the numpy conversion of the full matrix."""
    T, F, S = 2, 3, 5
    full, lower = _hermitian(np.random.RandomState(2), T, F, S,
                             integer=True)
    hdr = simple_header([-1, F, S, 2, S, 2], 'cf32', labels=VIS_LABELS,
                        gulp_nframe=T)
    got, th = _vis_chain(bt, lower, hdr, fmts)
    want, jh = _vis_chain(bf, lower, hdr, fmts)
    np.testing.assert_array_equal(got, want)
    for k in ('_tensor', 'matrix_fill_mode'):
        assert th.get(k) == jh.get(k)
    if fmts == ['storage']:
        assert got.shape == (T, S * (S + 1) // 2, F, 4)
        np.testing.assert_array_equal(got, _storage_numpy(full))
    else:
        np.testing.assert_array_equal(got, full)


def test_storage_helpers_direct():
    """matrix_to_storage and storage_to_matrix as functions: the storage
    of the lower triangle equals the storage of the full matrix."""
    T, F, S = 1, 2, 3
    full, lower = _hermitian(np.random.RandomState(3), T, F, S,
                             integer=True)
    bi, bj, diag = baseline_indices(S, 'cpu')
    np.testing.assert_array_equal(diag.numpy(), [0, 2, 5])
    st = matrix_to_storage(torch.from_numpy(lower), bi, bj, diag)
    np.testing.assert_array_equal(st.numpy(), _storage_numpy(full))
    np.testing.assert_array_equal(
        matrix_to_storage(torch.from_numpy(full), bi, bj, diag).numpy(),
        st.numpy())
    back = storage_to_matrix(st, bi, bj, S)
    np.testing.assert_array_equal(back.numpy(), full)


# ---------------------------------------------------------------------------
# the DFT-matmul FFT
# ---------------------------------------------------------------------------

def test_dft_matmul_fft_matches_fft():
    """Composite, prime and pow2 lengths, both directions
    (``tests/test_fft.py:67``'s tolerances), and within 1e-5 of the
    largest magnitude of JAX's DFT-matmul."""
    import jax
    import jax.numpy as jnp
    rng = np.random.RandomState(11)
    for n in (256, 120, 97):
        x = (rng.randn(4, n) + 1j * rng.randn(4, n)).astype(np.complex64)
        for inverse in (False, True):
            got = tfft.dft_matmul_fft(torch.from_numpy(x), -1,
                                      inverse=inverse).numpy()
            want = np.fft.ifft(x, axis=-1) * n if inverse \
                else np.fft.fft(x, axis=-1)
            np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-3)
            j = np.asarray(jax.jit(lambda v: jfft.dft_matmul_fft(
                v, -1, inverse=inverse))(jnp.asarray(x)))
            assert _rel(got, j) < REL
    x = (rng.randn(6, 64, 3) + 1j * rng.randn(6, 64, 3)).astype(np.complex64)
    got = tfft.dft_matmul_fft(torch.from_numpy(x), 1).numpy()
    np.testing.assert_allclose(got, np.fft.fft(x, axis=1), rtol=2e-4,
                               atol=2e-3)


def test_dft_matmul_fft_bf16_operands():
    """compute_dtype='bf16' stays inside the bf16 class (2-3 digits)."""
    rng = np.random.RandomState(13)
    x = (rng.randn(4, 256) + 1j * rng.randn(4, 256)).astype(np.complex64)
    got = tfft.dft_matmul_fft(torch.from_numpy(x), -1,
                              compute_dtype='bf16').numpy()
    assert _rel(got, np.fft.fft(x, axis=-1)) < 2e-2


def test_fftn_dispatch_takes_torch_fft_whatever_the_env(monkeypatch):
    """The port's dispatch has no ``BF_FFT_IMPL`` switch: with the JAX
    package's ``dftmm`` settings in the environment it still takes
    ``torch.fft`` (bit for bit), forward and inverse over two axes."""
    rng = np.random.RandomState(12)
    x = (rng.randn(4, 64) + 1j * rng.randn(4, 64)).astype(np.complex64)
    t = torch.from_numpy(x)
    monkeypatch.setenv('BF_FFT_IMPL', 'dftmm')
    monkeypatch.setenv('BF_FFT_DFT_DTYPE', 'bf16')
    got = tfft.fftn_dispatch(t, [-1])
    assert torch.equal(got, torch.fft.fftn(t, dim=[-1]))
    np.testing.assert_allclose(got.numpy(), np.fft.fft(x, axis=-1),
                               rtol=2e-4, atol=2e-3)
    inv = tfft.fftn_dispatch(t, [0, 1], inverse=True).numpy()
    np.testing.assert_allclose(inv, np.fft.ifftn(x) * x.size, rtol=2e-4,
                               atol=2e-3)
