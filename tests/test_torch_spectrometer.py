"""K1 of the PyTorch/CUDA port (bifrost_tpu_torch.ops.spectrometer)
against the JAX package's Pallas kernel (interpret mode, as
tests/test_spectrometer.py runs it on the CPU) and the float64 oracle,
from the same seeded int8 voltages.  On the CPU the port's wrapper runs
the kernel's plain PyTorch version; the CUDA kernel itself is held
against that version on the card by chip_smoke.py.

Tolerance: max|got - want| / max|want| < 1e-5, the JAX package's own
gate for the substituted kernel (choose_precision).

The CUDA source's radix-16 Stockham kernel cannot run here, so a numpy
model of it (``_radix16_model``) runs its passes with the source's
index, stride, padding and twiddle-table formulas, in float32, and is
held to ``np.fft.fft`` (rel < 1e-6 of the largest magnitude, the float32
FFT class); ``_wavefronts`` counts the shared-memory wavefronts of each
warp's access in that layout."""

import collections
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bifrost_tpu.ops import spectrometer as jax_spec
from bifrost_tpu_torch import device
from bifrost_tpu_torch.ops import spectrometer as spec

GATE = 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    device.set_device('cpu')


def _rel(got, want):
    return np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-30)


@pytest.mark.parametrize('T,nfft,rfactor', [(8, 256, 4), (4, 1024, 1),
                                            (4, 1024, 2), (4, 1024, 8)])
def test_matches_jax_kernel_and_oracle(T, nfft, rfactor):
    rng = np.random.RandomState(nfft + rfactor)
    volt = rng.randint(-64, 64, size=(T, 2, nfft, 2)).astype(np.int8)
    got = spec.fused_spectrometer(torch.from_numpy(volt),
                                  rfactor=rfactor).numpy()
    want = spec.spectrometer_oracle(volt, rfactor=rfactor)
    ref = np.asarray(jax_spec.fused_spectrometer(
        jnp.asarray(volt), rfactor=rfactor, time_tile=T, interpret=True))
    assert got.shape == ref.shape == (T, 4, nfft // rfactor)
    assert got.dtype == np.float32
    assert _rel(got, want) < GATE
    assert _rel(got, ref) < GATE
    # the port's oracle is the JAX package's oracle
    np.testing.assert_array_equal(
        want, jax_spec.spectrometer_oracle(volt, rfactor=rfactor))


def test_rejects_bad_shapes():
    """The same ValueErrors as the JAX kernel (tests/test_spectrometer.py
    test_rejects_bad_shapes)."""
    with pytest.raises(ValueError):          # not a power of two
        spec.fused_spectrometer(torch.zeros((4, 2, 300, 2),
                                            dtype=torch.int8))
    with pytest.raises(ValueError):          # single pol
        spec.fused_spectrometer(torch.zeros((4, 1, 256, 2),
                                            dtype=torch.int8))
    with pytest.raises(ValueError):          # rfactor does not divide
        spec.fused_spectrometer(torch.zeros((4, 2, 256, 2),
                                            dtype=torch.int8), rfactor=3)


def test_rfactor_beyond_jax_radix_split_is_accepted():
    """The JAX kernel rejects rfactor 32 at nfft 256 (it must divide the
    Mosaic radix split n1 = 16); the port only needs rfactor | nfft."""
    rng = np.random.RandomState(5)
    volt = rng.randint(-64, 64, size=(2, 2, 256, 2)).astype(np.int8)
    got = spec.fused_spectrometer(torch.from_numpy(volt), rfactor=32)
    assert _rel(got.numpy(), spec.spectrometer_oracle(volt, 32)) < GATE


# ---------------------------------------------------------------------------
# A model of the radix-16 Stockham kernel (csrc/spectrometer.cu)
# ---------------------------------------------------------------------------

SOURCE = os.path.join(os.path.dirname(spec.__file__), os.pardir, 'csrc',
                      'spectrometer.cu')

_C16 = np.float32(0.92387953251128674)   # cos(pi / 8)
_S16 = np.float32(0.38268343236508978)   # sin(pi / 8)
_H = np.float32(0.70710678118654752)     # sqrt(1 / 2)
#: W16^k as the source's constants
_W16 = {k: np.complex64(w) for k, w in {
    1: complex(_C16, -_S16), 2: complex(_H, -_H), 3: complex(_S16, -_C16),
    6: complex(-_H, -_H), 9: complex(-_C16, _S16)}.items()}


def _pad(i):
    return i + (i >> 4)


def _plan(log2n):
    """Radices of the passes: radix 16, then at most one of 2, 4 or 8."""
    return [16] * (log2n // 4) + ([1 << (log2n % 4)] if log2n % 4 else [])


def _mul_mi(z):
    return (z.imag - 1j * z.real).astype(np.complex64)


def _dft4(v, a, b, c, d):
    t0, t1, t2, t3 = v[a] + v[c], v[a] - v[c], v[b] + v[d], \
        _mul_mi(v[b] - v[d])
    v[a], v[c], v[b], v[d] = t0 + t2, t0 - t2, t1 + t3, t1 - t3


def _dft(v, R):
    """The source's dft<R> on the list v; returns the outputs in order
    (output m is left in v[slot<R>(m)])."""
    if R == 16:
        for i in range(4):
            _dft4(v, i, 4 + i, 8 + i, 12 + i)
        for k1 in (1, 2, 3):
            for n2 in (1, 2, 3):
                e, i = k1 * n2, 4 * k1 + n2
                v[i] = _mul_mi(v[i]) if e == 4 else v[i] * _W16[e]
        for i in range(4):
            _dft4(v, 4 * i, 4 * i + 1, 4 * i + 2, 4 * i + 3)
        return [v[4 * (m & 3) + (m >> 2)] for m in range(16)]
    if R == 8:
        _dft4(v, 0, 2, 4, 6)
        _dft4(v, 1, 3, 5, 7)
        v[3], v[5], v[7] = v[3] * _W16[2], _mul_mi(v[5]), v[7] * _W16[6]
        for i in range(4):
            v[2 * i], v[2 * i + 1] = v[2 * i] + v[2 * i + 1], \
                v[2 * i] - v[2 * i + 1]
        return [v[2 * (m & 3) + (m >> 2)] for m in range(8)]
    if R == 4:
        _dft4(v, 0, 1, 2, 3)
        return v
    return [v[0] + v[1], v[0] - v[1]]


def _pass_accesses(n):
    """Per pass (R, NS, first): for each thread t < n / 16 and each of its
    16 / R butterflies, j, k = j mod NS, the source indices j + r n / R
    and the destinations (j - k) R + k + m NS, as the source's pass()
    computes them."""
    nb, Ns = n // 16, 1
    t = np.arange(nb)
    for s, R in enumerate(_plan(n.bit_length() - 1)):
        groups = []
        for g in range(16 // R):
            j = t + g * nb
            k = j & (Ns - 1)
            src = [j + r * (n // R) for r in range(R)]
            dst = [(j - k) * R + k + m * Ns for m in range(R)]
            groups.append((k, src, dst))
        yield R, Ns, s == 0, groups
        Ns *= R


def _radix16_model(x, tw):
    """The kernel's FFT of (T, 2, n) complex64 rows, both pols, with the
    (n,) complex64 twiddle table: natural order in and out."""
    T, _, n = x.shape
    P = n + n // 16
    sm = np.zeros((T, 2 * P), np.complex64)
    for R, Ns, first, groups in _pass_accesses(n):
        for p in range(2):
            for k, src, dst in groups:
                v = []
                for r in range(R):
                    val = x[:, p, src[r]] if first else \
                        sm[:, p * P + _pad(src[r])]
                    if not first and r > 0:
                        i = r * k * (n // (Ns * R))
                        assert i.max() < n
                        val = val * tw[i]
                    v.append(val.astype(np.complex64))
                for m, out in enumerate(_dft(v, R)):
                    sm[:, p * P + _pad(dst[m])] = out
    idx = _pad(np.arange(n))
    return np.stack([sm[:, idx], sm[:, P + idx]], axis=1)


def _wavefronts(idx):
    """Shared-memory wavefronts of one warp's access to the float2
    elements ``idx``: 32 banks of 4 bytes, the most distinct words that
    fall in one bank."""
    words = {w for i in idx for w in (2 * int(i), 2 * int(i) + 1)}
    return max(collections.Counter(w % 32 for w in words).values())


@pytest.mark.parametrize('nfft', [256, 512, 1024, 2048, 4096, 8192])
def test_radix16_model_matches_fft(nfft):
    log2n = nfft.bit_length() - 1
    assert _plan(log2n) == {256: [16, 16], 512: [16, 16, 2],
                            1024: [16, 16, 4], 2048: [16, 16, 8],
                            4096: [16, 16, 16],
                            8192: [16, 16, 16, 2]}[nfft]
    rng = np.random.RandomState(nfft)
    volt = rng.randint(-128, 128, size=(3, 2, nfft, 2)).astype(np.int8)
    x = (volt[..., 0].astype(np.float32) +
         1j * volt[..., 1].astype(np.float32)).astype(np.complex64)
    tw = spec._twiddle(nfft, 'cpu').numpy()
    tw = (tw[:, 0] + 1j * tw[:, 1]).astype(np.complex64)
    got = _radix16_model(x, tw)
    assert got.dtype == np.complex64
    assert _rel(got, np.fft.fft(x.astype(np.complex128), axis=-1)) < 1e-6


@pytest.mark.parametrize('nfft', [256, 512, 1024, 2048, 4096, 8192])
def test_radix16_exchanges_are_conflict_free(nfft):
    """Every warp's read and write of every pass, and the epilogue's
    reads at rfactor 1, 4 and 16, take the fewest wavefronts an access
    of its threads' float2 can (two for 32 threads, one for 16); each
    pass writes every padded slot of a pol once."""
    nb = nfft // 16
    for R, Ns, first, groups in _pass_accesses(nfft):
        written = set()
        for w0 in range(0, nb, 32):
            lanes = slice(w0, w0 + 32)
            need = 2 if nb - w0 >= 32 else 1
            for k, src, dst in groups:
                for r in range(R):
                    if not first:
                        assert _wavefronts(_pad(src[r][lanes])) == need
                    assert _wavefronts(_pad(dst[r][lanes])) == need
                    written.update(_pad(dst[r][lanes]).tolist())
        assert written == set(_pad(np.arange(nfft)).tolist())
    for rfactor in (1, 4, 16):
        nout = nfft // rfactor
        for w0 in range(0, nout, nb):
            for lane0 in range(w0, min(w0 + nb, nout), 32):
                g = np.arange(lane0, min(lane0 + 32, nout))
                for q in range(rfactor):
                    assert _wavefronts(_pad(g * rfactor + q)) == \
                        (2 if len(g) > 16 else 1)


@pytest.mark.parametrize('nfft', [2 ** e for e in range(2, 14)])
def test_kernel_path_by_nfft(nfft):
    """nfft 256 to 8192 take the radix-16 kernel, 4 to 128 the radix-2
    kernel; the source's dispatch covers exactly the radix-16 range."""
    assert spec.kernel_path(nfft) == ('radix16' if nfft >= 256
                                      else 'radix2')
    with open(SOURCE) as f:
        cases = [int(c) for c in
                 re.findall(r'case (\d+): return launch_radix16<\1>',
                            f.read())]
    assert cases == list(range(spec.RADIX16_MIN_NFFT.bit_length() - 1,
                               spec.MAX_NFFT.bit_length()))


def test_cpu_tensors_launch_nothing():
    """On the CPU the wrapper runs the plain version: no count moves."""
    before = dict(spec.launches_by_path), spec.launches
    volt = torch.zeros((2, 2, 256, 2), dtype=torch.int8)
    spec.fused_spectrometer(volt)
    assert (dict(spec.launches_by_path), spec.launches) == before


def test_variant_edits_apply_to_the_source():
    """chip_k1_variants.py's edits each apply once to the kernel source
    and keep its braces balanced and both kernels' launches."""
    import importlib.util
    path = os.path.join(os.path.dirname(SOURCE), os.pardir, os.pardir,
                        'chip_k1_variants.py')
    mod_spec = importlib.util.spec_from_file_location('chip_k1_variants',
                                                      path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    with open(SOURCE) as f:
        src = f.read()
    vs = mod.variants(src)
    assert sorted(vs) == sorted(['kernel', 'three_blocks', 'shared_twiddles',
                                 'no_twiddles', 'no_load', 'no_epilogue'])
    assert vs['kernel'] == (src, True)
    for name, (text, _) in vs.items():
        assert text.count('{') == text.count('}'), name
        assert 'spectrometer_kernel<<<' in text, name
        assert 'spectrometer_radix16<L><<<' in text, name
        assert text.count('spectrometer_radix16(') == 1, name
        assert name == 'kernel' or text != src, name
