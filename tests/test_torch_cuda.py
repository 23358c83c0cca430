"""The port's CUDA kernels on the card, at shapes beyond the one
chip_smoke.py runs: K1 against the float64 oracle over nfft and rfactor,
K2 against its plain version on contiguous and strided planes, and the
wrappers' checks.  Marked ``cuda``; each test skips without a card.

Run on a machine with a card from the repository root (the repository's
conftest.py imports JAX, which such a machine need not have)::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: K1, max|got - oracle| / max|oracle| < 1e-5 (the
spectrometer gate); K2, bit-identical to its plain version (the kernel
rounds every multiply and add as the plain version's separate ops do).
"""

import numpy as np
import pytest
import torch

from bifrost_tpu_torch import device
from bifrost_tpu_torch.ops import gpu_kernels
from bifrost_tpu_torch.ops import spectrometer as spec

pytestmark = pytest.mark.cuda

GATE = 1e-5


@pytest.fixture(autouse=True)
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    device.set_device('cuda:0')


def _rel(got, want):
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


@pytest.mark.parametrize('T,nfft,rfactor', [
    (3, 4, 2), (8, 256, 4), (4, 1024, 1), (4, 1024, 8), (5, 2048, 32),
    (64, 4096, 4), (4, 8192, 8)])
def test_spectrometer_matches_oracle(T, nfft, rfactor):
    rng = np.random.RandomState(nfft + rfactor)
    volt = rng.randint(-128, 128, size=(T, 2, nfft, 2)).astype(np.int8)
    before = spec.launches
    got = spec.fused_spectrometer(torch.from_numpy(volt).cuda(),
                                  rfactor=rfactor)
    torch.cuda.synchronize()
    assert spec.launches == before + 1
    assert got.shape == (T, 4, nfft // rfactor)
    assert got.dtype == torch.float32 and got.is_cuda
    assert _rel(got.cpu().numpy(), spec.spectrometer_oracle(volt, rfactor)) \
        < GATE


def test_spectrometer_rejects_what_the_kernel_cannot_take():
    big = torch.zeros((2, 2, 2 * spec.MAX_NFFT, 2), dtype=torch.int8,
                      device='cuda')
    with pytest.raises(ValueError):
        spec.fused_spectrometer(big)
    strided = torch.zeros((4, 2, 512, 2), dtype=torch.int8,
                          device='cuda')[::2]
    with pytest.raises(ValueError):
        spec.fused_spectrometer(strided)


@pytest.mark.parametrize('T,F', [(16, 256), (7, 1000), (70000, 3)])
def test_stokes_matches_plain(T, F):
    """Contiguous planes, and the strided planes of view_as_real of a
    (T, 2, F) complex tensor as DetectStage passes them.  T above the
    grid's 65535 rows runs the kernel's row loop."""
    g = torch.Generator(device='cuda').manual_seed(T + F)
    x = torch.randn((T, 2, F), dtype=torch.complex64, device='cuda',
                    generator=g)
    v = torch.view_as_real(x)
    strided = (v[:, 0, :, 0], v[:, 0, :, 1], v[:, 1, :, 0], v[:, 1, :, 1])
    contiguous = tuple(p.contiguous() for p in strided)
    for planes in (strided, contiguous):
        before = gpu_kernels.launches
        got = gpu_kernels.stokes_detect(*planes)
        want = gpu_kernels.stokes_detect_plain(*planes)
        torch.cuda.synchronize()
        assert gpu_kernels.launches == before + 1
        assert torch.equal(got, want)


def test_stokes_rejects_planes_with_different_strides():
    a = torch.zeros((8, 64), device='cuda')
    b = torch.zeros((8, 128), device='cuda')[:, ::2]
    with pytest.raises(ValueError):
        gpu_kernels.stokes_detect(a, a, a, b)
