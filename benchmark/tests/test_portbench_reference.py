"""The plain references against small cases built by hand."""

import math

import numpy as np
import pytest
import torch

from benchmark.reference import fx_correlator as fxr
from benchmark.reference import precision
from benchmark.reference import spectrometer as spr


def test_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1 + 2 ** -10, 1 + 2 ** -11, 1 + 3 * 2 ** -11,
                      -1 - 2 ** -12, 3.0e38], dtype=torch.float32)
    got = precision.round_tf32(x)
    # a tie to even: 1 + 2^-11 -> 1, 1 + 3 * 2^-11 -> 1 + 2^-9
    want = torch.tensor([1.0, 1 + 2 ** -10, 1.0, 1 + 2 ** -9, -1.0,
                         got[5].item()], dtype=torch.float32)
    assert torch.equal(got, want)
    assert abs(got[5].item() - 3.0e38) / 3.0e38 < 2 ** -11


def test_stokes_of_two_tones():
    # x: a tone of amplitude 3 at bin 4 (i^t, exact in ci8); y:
    # amplitude 2 at bin 4, a quarter turn behind; nfft 16, r 4
    n, k = 16, 4
    t = np.arange(n)
    xv = 3 * np.exp(2j * np.pi * k * t / n)
    yv = 2 * np.exp(2j * np.pi * k * t / n - 0.5j * np.pi)
    v = np.zeros((1, 2, n, 2), np.int8)
    for p, z in ((0, xv), (1, yv)):
        v[0, p, :, 0] = np.round(z.real)
        v[0, p, :, 1] = np.round(z.imag)
    st = spr.stokes(torch.from_numpy(v), 4)
    x = np.fft.fft(v[0, 0, :, 0] + 1j * v[0, 0, :, 1].astype(float))
    y = np.fft.fft(v[0, 1, :, 0] + 1j * v[0, 1, :, 1].astype(float))
    xy = x * np.conj(y)
    want = np.stack([abs(x) ** 2 + abs(y) ** 2, abs(x) ** 2 - abs(y) ** 2,
                     2 * xy.real, -2 * xy.imag]).reshape(4, 4, 4).sum(-1)
    assert st.shape == (1, 4, 4)
    np.testing.assert_allclose(st[0].numpy(), want, rtol=1e-12,
                               atol=1e-9)
    # the tone sits in channel 1 (bins 4-7): I = (3 n)^2 + (2 n)^2
    assert st[0, 0, 1].item() == pytest.approx(13 * n * n, rel=1e-12)
    assert spr.error(st.float(), st) < 1e-7


def test_spectrometer_control_is_coarser():
    g = torch.Generator().manual_seed(3)
    v = torch.randint(-50, 50, (8, 2, 256, 2), generator=g,
                      dtype=torch.int8)
    ref = spr.stokes(v, 4)
    f32 = torch.stack([spr.stokes(v[i:i + 1], 4) for i in range(8)])
    assert spr.error(f32[:, 0], ref) == 0.0
    assert spr.error(spr.stokes(v, 4, 'tf32'), ref) > 1e-4


def test_f_stage_requantizes_with_ties_to_even():
    # one frame, 4 channels, 1 stand, 1 pol: a constant 3 -> FFT puts
    # 12 in channel 0; scale 1/8 -> 1.5, a tie, to even 2
    v = torch.zeros((1, 4, 1, 1, 2), dtype=torch.int8)
    v[..., 0] = 3
    q, tie = fxr.f_stage(v, 1 / 8)
    assert q[0, 0, 0] == 2 and q[0, 1:, 0].abs().sum() == 0
    assert tie[0, 0, 0] == 1 and tie[0, 1:, 0].sum() == 0


def test_visibilities_and_storage_by_hand():
    # 2 stands x 2 pols, 1 channel, 2 frames of hand-picked values
    x = torch.tensor([[[1 + 2j, 0 + 1j, 3 + 0j, -1 - 1j]],
                      [[2 + 0j, 1 - 1j, -2 + 1j, 0 + 2j]]],
                     dtype=torch.complex128)          # (t, f, n)
    vis = torch.zeros((1, 4, 4), dtype=torch.complex128)
    bud = torch.zeros((1, 4, 4), dtype=torch.float64)
    fxr.correlate(x, torch.zeros(x.shape, dtype=torch.float64), vis, bud)
    want = sum(torch.outer(x[t, 0], x[t, 0].conj()) for t in range(2))
    assert torch.equal(vis[0], want) and bud.abs().sum() == 0
    st, sb = fxr.storage(vis, bud, 2)
    assert st.shape == (3, 1, 4)          # baselines (0,0), (1,0), (1,1)
    v = want.reshape(2, 2, 2, 2)
    for b, (i, j) in enumerate(((0, 0), (1, 0), (1, 1))):
        xx, xy = v[i, 0, j, 0], v[i, 0, j, 1]
        yx, yy = v[i, 1, j, 0], v[i, 1, j, 1]
        for s, w in enumerate((xx + yy, xx - yy, xy + yx, 1j * (xy - yx))):
            assert st[b, 0, s] == w


def test_tie_budget_bounds_a_flip():
    x = torch.tensor([[[2 + 1j, -1 + 3j]]], dtype=torch.complex128)
    tie = torch.tensor([[[1.0, 0.0]]])      # value 0's real part flips
    vis = torch.zeros((1, 2, 2), dtype=torch.complex128)
    bud = torch.zeros((1, 2, 2), dtype=torch.float64)
    fxr.correlate(x, tie, vis, bud)
    for flip in (3 + 1j, 1 + 1j):          # either neighbour of 2
        y = x.clone()
        y[0, 0, 0] = flip
        v2 = torch.outer(y[0, 0], y[0, 0].conj())
        assert ((v2 - vis[0]).abs() <= bud[0] + 1e-12).all()
    assert bud[0, 1, 1] == 0                # no flip touches (1, 1)
    n, worst = fxr.outside(vis + torch.tensor([[[0, 0], [0, 1]]]),
                           vis, bud)
    assert (n, worst) == (1, 1.0)
    assert math.isclose(bud[0, 0, 0].item(), (3 + 1) ** 2 - 3 ** 2)
