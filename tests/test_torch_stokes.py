"""K2 of the PyTorch/CUDA port (bifrost_tpu_torch.ops.gpu_kernels
.stokes_detect) against the JAX package's Pallas kernel in interpret
mode, from the same seeded float32 planes.  On the CPU the wrapper runs
the kernel's plain PyTorch version; the CUDA kernel is held against that
version on the card by chip_smoke.py.

Tolerance: rtol 1e-6 (both sides do the same float32 ops; the margin
covers a different rounding order of the compilers)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bifrost_tpu.ops import pallas_kernels as pk
from bifrost_tpu_torch import device
from bifrost_tpu_torch.ops import gpu_kernels

T, F = 16, 256


@pytest.fixture(autouse=True)
def _cpu():
    device.set_device('cpu')


def _planes(seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(T, F).astype(np.float32) for _ in range(4)]


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * np.max(np.abs(want)))


def test_matches_jax_kernel():
    planes = _planes(0)
    got = gpu_kernels.stokes_detect(*[torch.from_numpy(p) for p in planes])
    want = np.asarray(pk.stokes_detect(*[jnp.asarray(p) for p in planes],
                                       interpret=True))
    assert tuple(got.shape) == want.shape == (T, 4, F)
    _close(got.numpy(), want)


def test_strided_planes_from_view_as_real():
    """The four planes of view_as_real of a (T, 2, F) complex tensor,
    passed without a copy, as DetectStage passes them."""
    planes = _planes(1)
    x = torch.complex(torch.from_numpy(planes[0]),
                      torch.from_numpy(planes[1]))
    y = torch.complex(torch.from_numpy(planes[2]),
                      torch.from_numpy(planes[3]))
    v = torch.view_as_real(torch.stack([x, y], dim=1))     # (T, 2, F, 2)
    views = [v[:, 0, :, 0], v[:, 0, :, 1], v[:, 1, :, 0], v[:, 1, :, 1]]
    assert all(p.stride() == (4 * F, 2) for p in views)
    got = gpu_kernels.stokes_detect(*views)
    want = np.asarray(pk.stokes_detect(*[jnp.asarray(p) for p in planes],
                                       interpret=True))
    _close(got.numpy(), want)


def test_rejects_mismatched_planes():
    a = torch.zeros((T, F))
    with pytest.raises(ValueError):
        gpu_kernels.stokes_detect(a, a, a, torch.zeros((T, F + 1)))
    with pytest.raises(ValueError):
        gpu_kernels.stokes_detect(a, a, a, a.double())
