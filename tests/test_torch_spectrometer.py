"""K1 of the PyTorch/CUDA port (bifrost_tpu_torch.ops.spectrometer)
against the JAX package's Pallas kernel (interpret mode, as
tests/test_spectrometer.py runs it on the CPU) and the float64 oracle,
from the same seeded int8 voltages.  On the CPU the port's wrapper runs
the kernel's plain PyTorch version; the CUDA kernel itself is held
against that version on the card by chip_smoke.py.

Tolerance: max|got - want| / max|want| < 1e-5, the JAX package's own
gate for the substituted kernel (choose_precision)."""

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
