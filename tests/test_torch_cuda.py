"""The port's CUDA kernels on the card, at shapes beyond the one
chip_smoke.py runs: K1 against the float64 oracle and its plain version
over every power-of-two nfft from 4 to 8192 at r 1, 4 and nfft, at the
int8 extremes, and on the kernel that each nfft picks (radix-16 Stockham
from 256, radix-2 below, by the per-path counter),
K2 against its plain version on contiguous and strided planes, K4, K5
and K6 (the beamformer) against the int64/float64 oracles and their
plain versions at ragged and full-width shapes (K4 and K5 over every
layout their wrappers take: separate planes, float32 voltages for K5 and
the per-pol views of ci8 gulps, through the 16-byte and the scalar
staging, with resident and streamed weight panels; K4 also at the int8
extremes, -128 everywhere, and at the int32 edge S = MAX_NSTAND; K6
at every R from 1 to 32 and R = T, -128 everywhere, and which of its
two kernels each layout takes), K0 (the capability
probe), K7 and K8 (the correlator) against their plain versions and the
int64 oracle at ragged shapes and on strided gulp views (K7 over every
layout its wrapper takes, the 16-byte and the scalar staging, resident
and chunked channels, at the int8 extremes and at T = MAX_NTIME; K8 with
its rows and its columns each in every such layout, mixed, on row-block
and chunked jobs, with groups, ragged n_i and n_j, at the int8 extremes
and at T = MAX_NTIME, and which path and staging each launch took), the
binding cache of the launch path, K3 (the FDMT
merge step) against its plain version over whole plans (ragged T,
negative delays, passthrough rows, a batch axis, tables above 256 KB),
K9 (the corner turn's ring hop) against its plain version for 2 to 4
ranks on one card and the mesh correlator's three {'sp': 4} plans byte
for byte, and the wrappers' checks; and the DSP library's torch paths
on the card: ``map`` (a masked if/else, a wrapping gather, out-of-range
gathers and stores, a host ci8 input unpacked on the card), FIR state
across gulps, Romein's atomic scatter with wrap and accumulate, and the
visibility storage round trip; and the transfer engine (pinned slots
that recycle only after their copy's event, H2D alias safety, D2H on
the copy stream after a producer kernel with no synchronize, fills into
pageable and pinned targets, the ``cuda_host`` direct paths); and the
capture tier (the sharded zero-copy engine into a pinned ``cuda_host``
ring, whose H2D is the direct one, and the capture chain's K7 against
its plain version); and the ring bridge (into a pinned ``cuda_host``
ring whose H2D is the direct one, and out of a ring that an async D2H
fills).  Marked ``cuda``; each test skips without a card.

Run on a machine with a card from the repository root (the repository's
conftest.py imports JAX, which such a machine need not have)::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: K1, max|got - oracle| / max|oracle| < 1e-5 (the
spectrometer gate); K2, bit-identical to its plain version (the kernel
rounds every multiply and add as the plain version's separate ops do);
K4, bit-identical to the int64 oracle; K5, rel <= 1e-5 of its plain
version (float32 sums in another order) and <= 8e-3 of the float64
oracle (the bf16 class); K6, bit-identical to its plain version on its
tensor-core kernel (R dividing 16, rows on 16 bytes), rel <= 1e-6 on
its dp4a kernel, and < 1e-5 of the quantized-weights float64 oracle;
K7 and K8, bit-identical to their plain versions and to the int64
oracle; K3, bit-identical to
its plain version (one float32 add per element in both) and the K3 core
to the torch gather core, and within 1e-4 of the float64 numpy oracle
relative to its largest magnitude; K9 and the corner turn, bit-identical
(a copy of bytes); map and the storage round trip exact, FIR and Romein
< 1e-5 of the float64 oracle.
"""

import numpy as np
import pytest
import torch

from bifrost_tpu_torch import device
from bifrost_tpu_torch.ops import gpu_kernels
from bifrost_tpu_torch.ops import spectrometer as spec
from bifrost_tpu_torch.ops.beamform import Beamformer, fused_detect

pytestmark = pytest.mark.cuda

GATE = 1e-5


@pytest.fixture(autouse=True)
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    device.set_device('cuda:0')


def _rel(got, want):
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


#: every nfft the kernels take: radix-2 from 4 to 128, radix-16 from 256
SPEC_NFFTS = [2 ** e for e in range(2, 14)]


def _spectrometer_run(volt, rfactor):
    """K1 on ``volt`` (numpy int8): its output after one launch through
    the kernel that its nfft picks, both counters checked."""
    nfft = volt.shape[2]
    path = spec.kernel_path(nfft)
    before, by_path = spec.launches, dict(spec.launches_by_path)
    got = spec.fused_spectrometer(torch.from_numpy(volt).cuda(),
                                  rfactor=rfactor)
    torch.cuda.synchronize()
    assert spec.launches == before + 1
    by_path[path] += 1
    assert spec.launches_by_path == by_path
    assert got.shape == (volt.shape[0], 4, nfft // rfactor)
    assert got.dtype == torch.float32 and got.is_cuda
    return got.cpu().numpy()


@pytest.mark.parametrize('rf', ['1', '4', 'nfft'])
@pytest.mark.parametrize('nfft', SPEC_NFFTS)
def test_spectrometer_matches_oracle(nfft, rf):
    rfactor = {'1': 1, '4': min(4, nfft), 'nfft': nfft}[rf]
    T = 64 if nfft == 4096 else 5
    rng = np.random.RandomState(nfft + rfactor)
    volt = rng.randint(-128, 128, size=(T, 2, nfft, 2)).astype(np.int8)
    got = _spectrometer_run(volt, rfactor)
    assert _rel(got, spec.spectrometer_oracle(volt, rfactor)) < GATE
    want = spec.spectrometer_plain(torch.from_numpy(volt).cuda(), rfactor)
    assert _rel(got, want.cpu().numpy()) < GATE


@pytest.mark.parametrize('nfft', SPEC_NFFTS)
def test_spectrometer_at_int8_extremes(nfft):
    """-128 in every byte (all power in bin 0), and a mix of -128 and
    +-127."""
    volt = np.full((3, 2, nfft, 2), -128, dtype=np.int8)
    got = _spectrometer_run(volt, 4)
    assert _rel(got, spec.spectrometer_oracle(volt, 4)) < GATE
    rng = np.random.RandomState(nfft)
    mix = rng.choice(np.array([-128, -127, 127], dtype=np.int8),
                     size=(3, 2, nfft, 2))
    got = _spectrometer_run(mix, 1)
    assert _rel(got, spec.spectrometer_oracle(mix, 1)) < GATE


def test_spectrometer_path_by_nfft():
    """nfft 256 to 8192 launch the radix-16 Stockham kernel, 4 to 128 the
    radix-2 kernel: one launch each, counted on its own path."""
    for key in spec.launches_by_path:
        spec.launches_by_path[key] = 0
    for nfft in SPEC_NFFTS:
        volt = np.ones((2, 2, nfft, 2), dtype=np.int8)
        _spectrometer_run(volt, 4)
    assert spec.launches_by_path == {
        'radix16': sum(n >= 256 for n in SPEC_NFFTS),
        'radix2': sum(n < 256 for n in SPEC_NFFTS)}
    assert [spec.kernel_path(n) for n in SPEC_NFFTS] == \
        ['radix2'] * 6 + ['radix16'] * 6


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
        before = gpu_kernels.launches['stokes_detect']
        got = gpu_kernels.stokes_detect(*planes)
        want = gpu_kernels.stokes_detect_plain(*planes)
        torch.cuda.synchronize()
        assert gpu_kernels.launches['stokes_detect'] == before + 1
        assert torch.equal(got, want)


def test_stokes_rejects_planes_with_different_strides():
    a = torch.zeros((8, 64), device='cuda')
    b = torch.zeros((8, 128), device='cuda')[:, ::2]
    with pytest.raises(ValueError):
        gpu_kernels.stokes_detect(a, a, a, b)


# ---------------------------------------------------------------------------
# K4, K5, K6: the beamformer kernels
# ---------------------------------------------------------------------------

def _int64_oracle(wr, wi, re, im):
    r, i = re.astype(np.int64), im.astype(np.int64)
    a, c = wr.astype(np.int64), wi.astype(np.int64)
    dot = lambda v, w: np.einsum('tfs,bs->tfb', v, w)
    return dot(r, a) - dot(i, c), dot(r, c) + dot(i, a)


def _i8(rng, shape, lo=-128):
    return rng.randint(lo, 128, size=shape).astype(np.int8)


@pytest.mark.parametrize('T,F,S,B', [(70, 3, 8, 3), (33, 2, 40, 65),
                                     (8, 2, 8, 4)])
def test_beamform_int8_matches_int64_oracle(T, F, S, B):
    """Ragged shapes: T, B and S not multiples of the kernel's tiles;
    full-range int8 (weights from -127, as quantized)."""
    rng = np.random.RandomState(T + S + B)
    wr, wi = _i8(rng, (B, S), -127), _i8(rng, (B, S), -127)
    re, im = _i8(rng, (T, F, S)), _i8(rng, (T, F, S))
    before = gpu_kernels.launches['beamform_int8']
    yr, yi = gpu_kernels.beamform_int8(*[torch.from_numpy(a).cuda()
                                         for a in (wr, wi, re, im)])
    torch.cuda.synchronize()
    assert gpu_kernels.launches['beamform_int8'] == before + 1
    assert yr.dtype == torch.int32 and yr.shape == (T, F, B)
    want_r, want_i = _int64_oracle(wr, wi, re, im)
    np.testing.assert_array_equal(yr.cpu().numpy(), want_r)
    np.testing.assert_array_equal(yi.cpu().numpy(), want_i)


def test_beamform_int8_full_width_on_gulp_views():
    """The main path's shape and layout: the strided per-pol views of a
    (512, 512, 256, 2, 2) ci8 gulp, 64 beams; bit-identical to the plain
    version everywhere and to the int64 oracle on three channels."""
    T, F, S, B = 512, 512, 256, 64
    g = torch.Generator(device='cuda').manual_seed(4)
    x = torch.randint(-128, 128, (T, F, S, 2, 2), dtype=torch.int8,
                      device='cuda', generator=g)
    rng = np.random.RandomState(4)
    wr, wi = _i8(rng, (B, S), -127), _i8(rng, (B, S), -127)
    wrc, wic = torch.from_numpy(wr).cuda(), torch.from_numpy(wi).cuda()
    for p in range(2):
        re, im = x[:, :, :, p, 0], x[:, :, :, p, 1]
        yr, yi = gpu_kernels.beamform_int8(wrc, wic, re, im)
        pr, pi = gpu_kernels.beamform_int8_plain(wrc, wic, re, im)
        torch.cuda.synchronize()
        assert torch.equal(yr, pr) and torch.equal(yi, pi)
        for f in (0, 255, 511):
            want_r, want_i = _int64_oracle(
                wr, wi, re[:, f:f + 1].cpu().numpy(),
                im[:, f:f + 1].cpu().numpy())
            np.testing.assert_array_equal(yr[:, f:f + 1].cpu().numpy(),
                                          want_r)
            np.testing.assert_array_equal(yi[:, f:f + 1].cpu().numpy(),
                                          want_i)


def _beam_operands(layout, T, F, S, rng):
    """The voltage planes of one K4 or K5 case on the card, and their numpy
    values: separate int8 or float32 planes, or the per-pol views of a
    ci8 gulp (pol 0 or 1 of (T, F, S, 2, 2); pol 1 of a gulp that starts 16
    bytes into its buffer, viewed from its third frame; pol 0 of a gulp 4
    bytes into its buffer, off the 16-byte rows; the one pol of a
    (T, F, S, 1, 2) gulp)."""
    if layout == 'float32':
        re = (rng.randn(T, F, S) * 30).astype(np.float32)
        im = (rng.randn(T, F, S) * 30).astype(np.float32)
        return torch.from_numpy(re).cuda(), torch.from_numpy(im).cuda(), \
            re, im
    if layout == 'int8':
        re, im = _i8(rng, (T, F, S)), _i8(rng, (T, F, S))
        return torch.from_numpy(re).cuda(), torch.from_numpy(im).cuda(), \
            re, im
    P = 1 if layout == 'single' else 2
    skip = 2 if layout == 'offset' else 0
    lead = {'offset': 16, 'unaligned': 4}.get(layout, 0)
    pol = 1 if layout in ('pol1', 'offset') else 0
    g = _i8(rng, (T + skip, F, S, P, 2))
    buf = torch.zeros(lead + g.size, dtype=torch.int8, device='cuda')
    buf[lead:] = torch.from_numpy(g.ravel()).cuda()
    x = buf[lead:].view(g.shape)[skip:]
    g = g[skip:]
    return x[:, :, :, pol, 0], x[:, :, :, pol, 1], g[:, :, :, pol, 0], \
        g[:, :, :, pol, 1]


@pytest.mark.parametrize('layout', ['int8', 'float32', 'pol0', 'pol1',
                                    'offset', 'unaligned', 'single'])
@pytest.mark.parametrize('T,F,S,B', [(70, 3, 8, 3), (33, 2, 40, 65),
                                     (128, 4, 256, 64), (9, 5, 300, 130),
                                     (40, 7, 1024, 64)])
def test_beamform_bf16_matches_plain_and_oracle(layout, T, F, S, B):
    """K5 on every layout its wrapper takes: M = T * F rows not a multiple
    of the 128-row tile, S not a multiple of the 64-station chunk (40,
    300) and past the resident panel (300, 1024: streamed from L2), B not a
    multiple of 8 or 64 (3, 65, 130).  The gulp views go through the
    16-byte staging wherever their rows allow it, the rest through the
    scalar staging."""
    rng = np.random.RandomState(T + S + B)
    wr = rng.randn(B, S).astype(np.float32)
    wi = rng.randn(B, S).astype(np.float32)
    re, im, re_np, im_np = _beam_operands(layout, T, F, S, rng)
    vec16 = layout in ('pol0', 'pol1', 'offset') or \
        (layout == 'single' and S % 8 == 0)
    assert (gpu_kernels.bf16_staging(re, im)[0] != 0) == vec16
    args = [torch.from_numpy(wr).cuda(), torch.from_numpy(wi).cuda(), re, im]
    torch.backends.cuda.matmul.allow_tf32 = False
    before = {k: gpu_kernels.launches[k]
              for k in ('beamform_bf16', 'beamform_bf16_vec16')}
    yr, yi = gpu_kernels.beamform_bf16(*args)
    pr, pi = gpu_kernels.beamform_bf16_plain(*args)
    torch.cuda.synchronize()
    assert gpu_kernels.launches['beamform_bf16'] == \
        before['beamform_bf16'] + 1
    assert gpu_kernels.launches['beamform_bf16_vec16'] == \
        before['beamform_bf16_vec16'] + int(vec16)
    assert yr.shape == yi.shape == (T, F, B) and yr.dtype == torch.float32
    got = torch.complex(yr, yi).cpu().numpy()
    assert _rel(got, torch.complex(pr, pi).cpu().numpy()) <= 1e-5
    x = re_np.astype(np.float64) + 1j * im_np.astype(np.float64)
    ref = np.einsum('tfs,bs->tfb', x, wr.astype(np.float64) +
                    1j * wi.astype(np.float64))
    assert _rel(got, ref) <= 8e-3


@pytest.mark.parametrize('layout', ['int8', 'pol0', 'pol1', 'offset',
                                    'unaligned', 'single'])
@pytest.mark.parametrize('T,F,S,B', [(70, 3, 8, 3), (33, 2, 40, 65),
                                     (128, 4, 256, 64), (9, 5, 300, 130),
                                     (40, 7, 1024, 64)])
def test_beamform_int8_layouts_match_int64_oracle(layout, T, F, S, B):
    """K4 on every int8 layout its wrapper takes, full-range weights (-128
    included): M = T * F rows not a multiple of the 128-row tile, S not a
    multiple of the 64-station chunk (40, 300) and past the resident panel
    (300, 1024: streamed from L2), B not a multiple of 8 or 64 (3, 65,
    130).  Bit-identical to the int64 oracle; the 16-byte counter moves
    exactly where int8_staging says the 16-byte path runs."""
    rng = np.random.RandomState(T + S + B)
    wr, wi = _i8(rng, (B, S)), _i8(rng, (B, S))
    re, im, re_np, im_np = _beam_operands(layout, T, F, S, rng)
    vec16 = layout in ('pol0', 'pol1', 'offset') or \
        (layout == 'single' and S % 8 == 0)
    assert (gpu_kernels.int8_staging(re, im)[0] != 0) == vec16
    keys = ('beamform_int8', 'beamform_int8_vec16')
    before = {k: gpu_kernels.launches[k] for k in keys}
    yr, yi = gpu_kernels.beamform_int8(torch.from_numpy(wr).cuda(),
                                       torch.from_numpy(wi).cuda(), re, im)
    torch.cuda.synchronize()
    assert gpu_kernels.launches['beamform_int8'] == \
        before['beamform_int8'] + 1
    assert gpu_kernels.launches['beamform_int8_vec16'] == \
        before['beamform_int8_vec16'] + int(vec16)
    assert yr.shape == yi.shape == (T, F, B) and yr.dtype == torch.int32
    want_r, want_i = _int64_oracle(wr, wi, re_np, im_np)
    np.testing.assert_array_equal(yr.cpu().numpy(), want_r)
    np.testing.assert_array_equal(yi.cpu().numpy(), want_i)


#: (re, im, wr, wi) at the int8 extremes: every value -128, and the mixes
#: that drive yr or yi near 2 * S * 128^2; 'mixed' draws -128, -127, 127
_K4_EXTREMES = [(-128, -128, -128, -128), (-128, -128, -128, 127),
                (-128, 127, -128, 127), (127, -128, 127, -128), 'mixed']


def _extreme_operands(pattern, layout, T, F, S, B, seed):
    """Weights (B, S) and voltage planes (T, F, S) of one extremes case:
    separate int8 planes, or pol 0 or 1 of a (T, F, S, 2, 2) gulp whose
    other pol holds random bytes; numpy values beside the card tensors."""
    rng = np.random.RandomState(seed)
    if pattern == 'mixed':
        vals = [rng.choice([-128, -127, 127], size=shape).astype(np.int8)
                for shape in ((T, F, S), (T, F, S), (B, S), (B, S))]
    else:
        vals = [np.full(shape, v, np.int8) for v, shape in
                zip(pattern, ((T, F, S), (T, F, S), (B, S), (B, S)))]
    re, im, wr, wi = vals
    if layout == 'int8':
        rec, imc = torch.from_numpy(re).cuda(), torch.from_numpy(im).cuda()
    else:
        p = int(layout[-1])
        g = _i8(rng, (T, F, S, 2, 2))
        g[:, :, :, p, 0], g[:, :, :, p, 1] = re, im
        x = torch.from_numpy(g).cuda()
        rec, imc = x[:, :, :, p, 0], x[:, :, :, p, 1]
    return (torch.from_numpy(wr).cuda(), torch.from_numpy(wi).cuda(), rec,
            imc), (wr, wi, re, im)


def _check_k4_exact(args, values, vec16):
    before = gpu_kernels.launches['beamform_int8_vec16']
    yr, yi = gpu_kernels.beamform_int8(*args)
    pr, pi = gpu_kernels.beamform_int8_plain(*args)
    torch.cuda.synchronize()
    assert gpu_kernels.launches['beamform_int8_vec16'] == before + int(vec16)
    assert torch.equal(yr, pr) and torch.equal(yi, pi)
    want_r, want_i = _int64_oracle(*values)
    np.testing.assert_array_equal(yr.cpu().numpy(), want_r)
    np.testing.assert_array_equal(yi.cpu().numpy(), want_i)
    return want_r, want_i


@pytest.mark.parametrize('pattern', _K4_EXTREMES)
@pytest.mark.parametrize('layout', ['int8', 'pol0', 'pol1'])
def test_beamform_int8_exact_at_the_int8_extremes(layout, pattern):
    """Weights and voltages of -128 (which int8 cannot negate) and mixes
    of -128 and 127, at a ragged shape (resident panel), through the
    scalar and the 16-byte staging: bit-identical to the plain version and
    the int64 oracle."""
    T, F, S, B = 33, 3, 200, 70
    args, values = _extreme_operands(pattern, layout, T, F, S, B, 31)
    _check_k4_exact(args, values, layout != 'int8')


@pytest.mark.parametrize('pattern', _K4_EXTREMES)
@pytest.mark.parametrize('layout,S', [('int8', gpu_kernels.MAX_NSTAND),
                                      ('pol1', gpu_kernels.MAX_NSTAND - 3)])
def test_beamform_int8_exact_at_the_int32_edge(layout, S, pattern):
    """S = MAX_NSTAND (and the largest S of the 16-byte path below it),
    small T * F and B, streamed panel: every -128 gives yi = 2 S 128^2 =
    2,147,450,880 and the mixes give |yr| or |yi| near it; the s32
    accumulators wrap, never saturate, so every result is exact."""
    T, F, B = 3, 2, 3
    args, values = _extreme_operands(pattern, layout, T, F, S, B, 37)
    want_r, want_i = _check_k4_exact(args, values, layout != 'int8')
    if pattern == (-128, -128, -128, -128):
        assert (want_i == 2 * S * 128 * 128).all() and \
            want_i.max() > 2 ** 31 - 2 ** 18
    assert max(np.abs(want_r).max(), np.abs(want_i).max()) < 2 ** 31


def test_beamform_int8_build_and_launch_failures_raise(monkeypatch):
    """K4 raises when its C entry refuses a launch (the 16-byte staging
    asked of separate planes), and when its library does not build (a
    failing ``_fn``), from the wrapper and from the engine's forced
    ``pallas`` candidate alike; nothing falls back."""
    import ctypes
    from bifrost_tpu_torch import _build
    rng = np.random.RandomState(5)
    T, F, S, B = 8, 2, 32, 4
    w = torch.from_numpy(_i8(rng, (B, S))).cuda()
    re = torch.from_numpy(_i8(rng, (T, F, S))).cuda()
    im = torch.from_numpy(_i8(rng, (T, F, S))).cuda()
    yr = torch.empty((T, F, B), dtype=torch.int32, device='cuda')
    lib, fn = gpu_kernels._fn('beamform', 'bf_beamform_int8',
                              [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 +
                              [ctypes.c_longlong] * 3 + [ctypes.c_void_p])
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    err = fn(ptr(w), ptr(w), ptr(re), ptr(im), ptr(yr), ptr(yr), 4, 0, T, F,
             S, B, F * S, S, 1, _build.stream_ptr(re.device))
    assert err != 0
    with pytest.raises(RuntimeError, match='beamform_int8: CUDA error'):
        _build.check(lib, err, 'beamform_int8')

    def nvcc_failure(*args):
        raise RuntimeError('nvcc failed for beamform')
    monkeypatch.setattr(gpu_kernels, '_fn', nvcc_failure)
    with pytest.raises(RuntimeError, match='nvcc failed'):
        gpu_kernels.beamform_int8(w, w, re, im)
    eng = Beamformer((rng.randn(1, B, S) + 1j * rng.randn(1, B, S))
                     .astype(np.complex64), accuracy='int8', impl='pallas')
    with pytest.raises(RuntimeError, match='nvcc failed'):
        eng(re[:, :, None], im[:, :, None])


def _detect_oracle(eng, x, R):
    wq = (eng.wr8.astype(np.float64) + 1j * eng.wi8.astype(np.float64)) \
        * eng.wscale
    if wq.shape[0] == 1:
        wq = np.repeat(wq, 2, axis=0)
    volt = x[..., 0].astype(np.float64) + 1j * x[..., 1].astype(np.float64)
    y = np.einsum('tfsp,pbs->tfpb', volt, wq)
    bx, by = y[:, :, 0], y[:, :, 1]
    xx, yy = np.abs(bx) ** 2, np.abs(by) ** 2
    xy = bx * np.conj(by)
    st = np.stack([xx + yy, xx - yy, 2 * xy.real, -2 * xy.imag], axis=2)
    T, F = x.shape[:2]
    return st.reshape(T // R, R, F, 4, -1).sum(axis=1)


def _detect_planes_oracle(ws, scale, x, R):
    """float64 beamform -> Stokes -> R-frame sum with int8 weight planes
    (wxr, wxi, wyr, wyi) times ``scale``."""
    wq = np.stack([ws[0] + 1j * ws[1].astype(np.float64),
                   ws[2] + 1j * ws[3].astype(np.float64)]) * scale
    volt = x[..., 0].astype(np.float64) + 1j * x[..., 1].astype(np.float64)
    y = np.einsum('tfsp,pbs->tfpb', volt, wq)
    bx, by = y[:, :, 0], y[:, :, 1]
    xx, yy = np.abs(bx) ** 2, np.abs(by) ** 2
    xy = bx * np.conj(by)
    st = np.stack([xx + yy, xx - yy, 2 * xy.real, -2 * xy.imag], axis=2)
    T, F = x.shape[:2]
    return st.reshape(T // R, R, F, 4, -1).sum(axis=1)


def _check_detect(ws, xc, scale, R, path):
    """One K6 launch on the card: its path by the per-path counter, and
    on the tensor-core path the plain version's bits (<= 1e-6 on the dp4a
    path).  Returns the output as numpy."""
    before = dict(gpu_kernels.launches)
    got = gpu_kernels.beamform_detect_int8(*ws, xc, scale, R)
    want = gpu_kernels.beamform_detect_int8_plain(*ws, xc, scale, R)
    torch.cuda.synchronize()
    assert gpu_kernels.detect_path(xc, R) == path
    assert gpu_kernels.launches['beamform_detect_int8'] == \
        before['beamform_detect_int8'] + 1
    assert gpu_kernels.launches['beamform_detect_int8_mma'] == \
        before['beamform_detect_int8_mma'] + (path == 'mma')
    T, F, S = xc.shape[:3]
    assert got.shape == (T // R, F, 4, ws[0].shape[0])
    assert got.dtype == torch.float32
    if path == 'mma':
        assert torch.equal(got, want)
    else:
        assert float((got - want).abs().max() / want.abs().max()) <= 1e-6
    return got.cpu().numpy()


#: (T, F, S, B) of each K6 shape: 'ragged' has T off the 16-frame tile
#: where R allows it, F off the channel quad and B off the beam tile;
#: 'wide' resident panels of 256 stations; 'minus128' -128 in every byte
#: of the gulp and the weights
def _detect_shape(shape, R):
    return {'ragged': (40 if R in (1, 2, 4, 8, 'T') else 3 * R, 3, 40, 65),
            'wide': (96, 2, 256, 64),
            'minus128': (32, 5, 64, 9)}[shape]


@pytest.mark.parametrize('R', [1, 2, 4, 8, 16, 32, 'T'])
@pytest.mark.parametrize('P', [1, 2])
@pytest.mark.parametrize('shape', ['ragged', 'wide', 'minus128'])
def test_beamform_detect_matches_plain_and_oracle(R, P, shape):
    """K6 through ``fused_detect`` (P = 1: one weight set for both pols)
    at every R: R dividing 16 on the tensor-core kernel, bit-identical
    to the plain version; R = 32 and R = T on the dp4a kernel, within
    1e-6; both below 1e-5 of the float64 oracle."""
    T, F, S, B = _detect_shape(shape, R)
    R = T if R == 'T' else R
    path = 'mma' if 16 % R == 0 else 'dp4a'
    rng = np.random.RandomState(T + R + P)
    if shape == 'minus128':
        x = np.full((T, F, S, 2, 2), -128, np.int8)
        wn = [np.full((B, S), -128, np.int8)] * 4
        scale = 0.0123
        ws = [torch.from_numpy(w).cuda() for w in wn]
        got = _check_detect(ws, torch.from_numpy(x).cuda(), scale, R, path)
        assert _rel(got, _detect_planes_oracle(wn, scale, x, R)) < 1e-5
        return
    wshape = (B, S) if P == 1 else (P, B, S)
    w = (rng.randn(*wshape) + 1j * rng.randn(*wshape)).astype(np.complex64)
    eng = Beamformer(w, accuracy='int8')
    x = _i8(rng, (T, F, S, 2, 2))
    xc = torch.from_numpy(x).cuda()
    before = dict(gpu_kernels.launches)
    got = fused_detect(eng, xc, R)
    torch.cuda.synchronize()
    assert gpu_kernels.launches['beamform_detect_int8'] == \
        before['beamform_detect_int8'] + 1
    assert gpu_kernels.launches['beamform_detect_int8_mma'] == \
        before['beamform_detect_int8_mma'] + (path == 'mma')
    _, _, wr8, wi8 = eng._pol_weights(2)
    ws = [torch.from_numpy(np.ascontiguousarray(a)).cuda()
          for a in (wr8[0], wi8[0], wr8[1], wi8[1])]
    want = _check_detect(ws, xc, eng.wscale, R, path)
    assert np.array_equal(got.cpu().numpy(), want) if path == 'mma' else \
        _rel(got.cpu().numpy(), want) <= 1e-6
    assert _rel(want, _detect_oracle(eng, x, R)) < 1e-5


def test_beamform_detect_path_by_layout():
    """Which K6 kernel each input takes, from the per-path counter: a
    contiguous gulp and frame- or channel-strided views of it (rows still
    on 16 bytes) at R 8 take the tensor-core kernel; R 32, a view off 16
    bytes, a station-strided view and S above DETECT_MMA_MAX_NSTAND the
    dp4a kernel.  Each matches the plain version.  The tensor-core C
    entry refuses an input it does not take, and the wrapper raises."""
    import ctypes
    from bifrost_tpu_torch import _build
    rng = np.random.RandomState(12)
    T, F, S, B = 64, 6, 64, 40
    ws = [torch.from_numpy(_i8(rng, (B, S))).cuda() for _ in range(4)]
    x = torch.from_numpy(_i8(rng, (T, F, S, 2, 2))).cuda()
    _check_detect(ws, x, 0.5, 8, 'mma')
    _check_detect(ws, x[::2], 0.5, 8, 'mma')
    _check_detect(ws, x[:, 1:], 0.5, 8, 'mma')
    _check_detect(ws, x, 0.5, 32, 'dp4a')
    flat = torch.empty(x.numel() + 16, dtype=torch.int8, device='cuda')
    off = flat[4:4 + x.numel()].view(x.shape)
    off.copy_(x)
    assert off.data_ptr() % 16 == 4
    _check_detect(ws, off, 0.5, 8, 'dp4a')
    _check_detect([w[:, 1:].contiguous() for w in ws], x[:, :, 1:], 0.5, 8,
                  'dp4a')
    big = gpu_kernels.DETECT_MMA_MAX_NSTAND + 4
    wb = [torch.from_numpy(_i8(rng, (B, big))).cuda() for _ in range(4)]
    xb = torch.from_numpy(_i8(rng, (16, 2, big, 2, 2))).cuda()
    _check_detect(wb, xb, 0.5, 8, 'dp4a')
    top = gpu_kernels.DETECT_MMA_MAX_NSTAND
    _check_detect([w[:, :top].contiguous() for w in wb],
                  xb[:, :, :top].contiguous(), 0.5, 8, 'mma')
    out = torch.empty((T // 32, F, 4, B), dtype=torch.float32, device='cuda')
    lib, fn = gpu_kernels._fn('beamform', 'bf_beamform_detect_int8_mma',
                              gpu_kernels._DETECT_ARGS)
    err = fn(*[w.data_ptr() for w in ws], x.data_ptr(), out.data_ptr(), 0.5,
             T, F, S, B, 32, F * S * 4, S * 4, _build.stream_ptr(x.device))
    assert err != 0
    with pytest.raises(RuntimeError, match='beamform_detect_int8: CUDA'):
        _build.check(lib, err, 'beamform_detect_int8')


def test_beamform_wrappers_reject_bad_operands():
    w8 = torch.zeros((4, 8), dtype=torch.int8, device='cuda')
    v8 = torch.zeros((6, 2, 8), dtype=torch.int8, device='cuda')
    with pytest.raises(ValueError):          # float voltages for K4
        gpu_kernels.beamform_int8(w8, w8, v8.float(), v8.float())
    with pytest.raises(ValueError):          # weights on the host
        gpu_kernels.beamform_int8(w8.cpu(), w8.cpu(), v8, v8)
    with pytest.raises(ValueError):          # int8 weights for K5
        gpu_kernels.beamform_bf16(w8, w8, v8, v8)
    with pytest.raises(ValueError):          # voltages on the host
        gpu_kernels.beamform_bf16(w8.float(), w8.float(), v8.cpu(),
                                  v8.cpu())
    x = torch.zeros((8, 2, 8, 2, 2), dtype=torch.int8, device='cuda')
    with pytest.raises(ValueError):          # float gulp for K6
        gpu_kernels.beamform_detect_int8(w8, w8, w8, w8, x.float(), 1.0, 2)
    with pytest.raises(ValueError):          # weights on the host
        gpu_kernels.beamform_detect_int8(w8.cpu(), w8, w8, w8, x, 1.0, 2)
    with pytest.raises(ValueError):          # stations not contiguous
        gpu_kernels.beamform_detect_int8(
            w8[:, :4], w8[:, :4], w8[:, :4], w8[:, :4], x[:, :, ::2],
            1.0, 2)


# ---------------------------------------------------------------------------
# K0, K7, K8: the capability probe and the correlation kernels
# ---------------------------------------------------------------------------

def _xcorr_oracle(re_i, im_i, re_j, im_j):
    """int64 oracle of vis = sum_t x_i conj(x_j) over (..., T, F, n)."""
    ri, ii, rj, ij = (v.astype(np.int64) for v in (re_i, im_i, re_j, im_j))
    dot = lambda x, y: np.einsum('...tfa,...tfb->...fab', x, y)
    return (dot(ri, rj) + dot(ii, ij)).astype(np.complex64) + \
        1j * (dot(ii, rj) - dot(ri, ij)).astype(np.complex64)


def test_available_runs_the_probe_kernel():
    gpu_kernels._available_on.clear()
    before = gpu_kernels.launches['probe']
    assert gpu_kernels.available() is True
    assert gpu_kernels.launches['probe'] == before + 1
    assert gpu_kernels.available(torch.device('cuda', 0)) is True
    assert gpu_kernels.launches['probe'] == before + 1      # cached
    assert gpu_kernels.available(torch.device('cpu')) is False
    x = torch.arange(1000, dtype=torch.float32, device='cuda')
    assert torch.equal(gpu_kernels.probe(x), x * 2)


def test_available_loads_every_kernel_library():
    from bifrost_tpu_torch import _build
    gpu_kernels._available_on.clear()
    assert gpu_kernels.available() is True
    assert set(_build.SOURCES) <= set(_build._libs)


@pytest.mark.parametrize('entry', ['prewarm', 'auto', 'cross'])
def test_kernel_that_fails_to_build_raises_from_the_engines(
        monkeypatch, tmp_path, entry):
    """A kernel library that does not build (a failing ``_fn``) raises
    from the X engine's prewarm and from xcorr_int8's race on the card,
    never leaves them racing on without it."""
    from bifrost_tpu_torch.ops import linalg as L, mprobe
    monkeypatch.setenv('BF_CACHE_DIR', str(tmp_path))
    monkeypatch.delenv('BF_LINALG_PROBE', raising=False)
    monkeypatch.setattr(mprobe, '_cache', {})
    monkeypatch.setattr(L, '_xcorr_chosen', {})

    def nvcc_failure(*args):
        raise RuntimeError('nvcc failed for xcorr')
    monkeypatch.setattr(gpu_kernels, '_fn', nvcc_failure)
    rng = np.random.RandomState(21)
    re = torch.from_numpy(_i8(rng, (16, 2, 40))).cuda()
    im = torch.from_numpy(_i8(rng, (16, 2, 40))).cuda()
    with pytest.raises(RuntimeError, match='nvcc failed'):
        if entry == 'prewarm':
            L.XEngine(accuracy='int8').prewarm(16, 2, 40)
        elif entry == 'auto':
            L.xcorr_int8(re, im)
        else:
            L.xcorr_int8(re, im, re[..., :8], im[..., :8])


@pytest.mark.parametrize('G,T,F,n', [(None, 8, 3, 6), (None, 33, 2, 40),
                                     (None, 70, 2, 130), (3, 40, 2, 65),
                                     (None, 1, 1, 1)])
def test_xcorr_herm_matches_plain_and_oracle(G, T, F, n):
    """Ragged tiles (n not a multiple of 64, T not of 32), full-range
    int8, with and without the group axis."""
    rng = np.random.RandomState(T + n)
    shape = (T, F, n) if G is None else (G, T, F, n)
    re, im = _i8(rng, shape), _i8(rng, shape)
    rec, imc = torch.from_numpy(re).cuda(), torch.from_numpy(im).cuda()
    before = gpu_kernels.launches['xcorr_herm']
    got = gpu_kernels.xcorr_herm(rec, imc)
    want = gpu_kernels.xcorr_herm_plain(rec, imc)
    torch.cuda.synchronize()
    assert gpu_kernels.launches['xcorr_herm'] == before + 1
    assert got.dtype == torch.complex64
    assert got.shape == shape[:-3] + (F, n, n)
    assert torch.equal(got, want)
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  _xcorr_oracle(re, im, re, im))


@pytest.mark.parametrize('T,F,ni,nj', [(8, 3, 6, 40), (33, 2, 130, 6),
                                       (64, 2, 64, 128), (5, 1, 1, 3)])
def test_xcorr_cross_matches_plain_and_oracle(T, F, ni, nj):
    rng = np.random.RandomState(T + ni + nj)
    re_i, im_i = _i8(rng, (T, F, ni)), _i8(rng, (T, F, ni))
    re_j, im_j = _i8(rng, (T, F, nj)), _i8(rng, (T, F, nj))
    args = [torch.from_numpy(a).cuda() for a in (re_i, im_i, re_j, im_j)]
    before = gpu_kernels.launches['xcorr_cross']
    got = gpu_kernels.xcorr_cross(*args)
    want = gpu_kernels.xcorr_cross_plain(*args)
    torch.cuda.synchronize()
    assert gpu_kernels.launches['xcorr_cross'] == before + 1
    assert got.shape == (F, ni, nj)
    assert torch.equal(got, want)
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  _xcorr_oracle(re_i, im_i, re_j, im_j))


def test_xcorr_kernels_on_strided_gulp_views():
    """The FX path's layout: the re and im views of a (T, F, S, P, 2) ci8
    gulp, grouped (g, r, F, S*P) for K7 in one launch, and a station-row
    block against all inputs for K8."""
    T, F, S, P, R = 64, 8, 96, 2, 32
    g = torch.Generator(device='cuda').manual_seed(8)
    x = torch.randint(-128, 128, (T, F, S, P, 2), dtype=torch.int8,
                      device='cuda', generator=g)
    re = x[..., 0].reshape(T // R, R, F, S * P)
    im = x[..., 1].reshape(T // R, R, F, S * P)
    assert re.data_ptr() == x.data_ptr()          # a view, not a copy
    before = gpu_kernels.launches['xcorr_herm']
    got = gpu_kernels.xcorr_herm(re, im)
    torch.cuda.synchronize()
    assert gpu_kernels.launches['xcorr_herm'] == before + 1
    assert torch.equal(got, gpu_kernels.xcorr_herm_plain(re, im))
    xh = x.cpu().numpy()
    rn = xh[..., 0].reshape(T // R, R, F, S * P)
    inn = xh[..., 1].reshape(T // R, R, F, S * P)
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  _xcorr_oracle(rn, inn, rn, inn))
    assert (got.imag != 0).any()
    assert torch.equal(got.imag, -got.imag.transpose(-1, -2))
    ri, ii = x[:, :, :32, :, 0].reshape(T, F, 64), \
        x[:, :, :32, :, 1].reshape(T, F, 64)
    rj, ij = x[..., 0].reshape(T, F, S * P), x[..., 1].reshape(T, F, S * P)
    got = gpu_kernels.xcorr_cross(ri, ii, rj, ij)
    assert torch.equal(got, gpu_kernels.xcorr_cross_plain(ri, ii, rj, ij))


def test_xcorr_two_input_sign():
    """x_0 = 1 + 2j, x_1 = 3 - 1j for one frame: vis[0, 1] = x_0 conj(x_1)
    = (1 + 2j)(3 + 1j) = 1 + 7j, vis[1, 0] = 1 - 7j."""
    re = torch.tensor([[[1, 3]]], dtype=torch.int8, device='cuda')
    im = torch.tensor([[[2, -1]]], dtype=torch.int8, device='cuda')
    for got in (gpu_kernels.xcorr_herm(re, im)[0],
                gpu_kernels.xcorr_cross(re, im, re, im)[0]):
        assert got[0, 1].item() == complex(1, 7)
        assert got[1, 0].item() == complex(1, -7)
        assert got[0, 0].item() == complex(5, 0)


def test_xcorr_wrappers_reject_bad_operands():
    v = torch.zeros((4, 2, 8), dtype=torch.int8, device='cuda')
    with pytest.raises(ValueError):          # float planes
        gpu_kernels.xcorr_herm(v.float(), v.float())
    with pytest.raises(ValueError):          # planes on two devices
        gpu_kernels.xcorr_herm(v, v.cpu())
    with pytest.raises(ValueError):          # a zero-stride layout
        gpu_kernels.xcorr_herm(v[:1].expand(4, 2, 8), v[:1].expand(4, 2, 8))
    with pytest.raises(ValueError):          # re and im strides differ
        gpu_kernels.xcorr_herm(v, v.transpose(0, 1).contiguous()
                               .transpose(0, 1))
    with pytest.raises(ValueError):          # more frames than int32 holds
        big = torch.zeros((gpu_kernels.MAX_NTIME + 1, 1, 1),
                          dtype=torch.int8, device='cuda')
        gpu_kernels.xcorr_herm(big, big)
    with pytest.raises(ValueError):          # channels differ
        gpu_kernels.xcorr_cross(v, v, v[:, :1], v[:, :1])


#: K7's layouts: the re and im views of a (G T, F, S, P, 2) ci8 gulp with
#: P = 1 and 2, separate contiguous planes, and planes with odd strides
_K7_LAYOUTS = ['gulp_p1', 'gulp_p2', 'planes', 'odd']


def _k7_planes(layout, G, T, F, n, values):
    """(re, im) card planes (G, T, F, n') of one K7 layout holding
    ``values(shape)`` int8 arrays, and their numpy copies; n' = n, or the
    2 * ceil(n / 2) inputs of a dual-pol gulp."""
    if layout.startswith('gulp'):
        P = int(layout[-1])
        S = -(-n // P)
        x = values((G * T, F, S, P, 2))
        xc = torch.from_numpy(x).cuda()
        shape = (G, T, F, S * P)
        re = xc[..., 0].reshape(shape)
        im = xc[..., 1].reshape(shape)
        assert re.data_ptr() == xc.data_ptr()        # views, not copies
        return re, im, x[..., 0].reshape(shape), x[..., 1].reshape(shape)
    re, im = values((G, T, F, n)), values((G, T, F, n))
    if layout == 'planes':
        return (torch.from_numpy(re).cuda(), torch.from_numpy(im).cuda(), re,
                im)
    # odd strides: every third input of a row of an odd number of bytes
    width = 3 * n + 2 - (3 * n + 1) % 2
    big = [np.zeros((G, T, F, width), np.int8) for _ in range(2)]
    big[0][..., 1:3 * n:3], big[1][..., 1:3 * n:3] = re, im
    rec, imc = (torch.from_numpy(b).cuda()[..., 1:3 * n:3] for b in big)
    assert rec.stride()[-1] == 3 and rec.stride()[-2] % 2 == 1
    return rec, imc, re, im


def _check_k7(re, im, re_np, im_np, channels=None):
    """K7 against its plain version (whole) and the int64 oracle (on
    ``channels``, all when None), the 16-byte counter where
    xcorr_staging says, and the Hermitian structure."""
    vec = gpu_kernels.xcorr_staging(re, im)
    n0, v0 = (gpu_kernels.launches[k] for k in ('xcorr_herm',
                                                 'xcorr_herm_vec16'))
    got = gpu_kernels.xcorr_herm(re, im)
    want = gpu_kernels.xcorr_herm_plain(re, im)
    torch.cuda.synchronize()
    assert gpu_kernels.launches['xcorr_herm'] == n0 + 1
    assert gpu_kernels.launches['xcorr_herm_vec16'] == v0 + vec
    G, T, F, n = re.shape
    assert got.shape == (G, F, n, n) and got.dtype == torch.complex64
    assert torch.equal(got, want)
    host = got.cpu().numpy()
    for f in range(F) if channels is None else channels:
        np.testing.assert_array_equal(
            host[:, f], _xcorr_oracle(re_np[:, :, f:f + 1],
                                      im_np[:, :, f:f + 1],
                                      re_np[:, :, f:f + 1],
                                      im_np[:, :, f:f + 1])[:, 0])
    assert torch.equal(got.imag, -got.imag.transpose(-1, -2))
    assert torch.equal(got.real, got.real.transpose(-1, -2))
    assert not torch.diagonal(got.imag, dim1=-2, dim2=-1).any()
    return vec


@pytest.mark.parametrize('n', [1, 63, 64, 65, 200, 512, 1000])
@pytest.mark.parametrize('layout', _K7_LAYOUTS)
def test_xcorr_herm_layouts_match_plain_and_oracle(layout, n):
    """Every layout at every n, T cycling through 1, 31, 32, 33, 128 and
    257 and G through 1 and 3 (the resident and the chunked staging both
    run); the 16-byte path is taken exactly by the aligned gulp views
    with n' a multiple of 8."""
    k = _K7_LAYOUTS.index(layout) * 7 + [1, 63, 64, 65, 200, 512,
                                         1000].index(n)
    T = (1, 31, 32, 33, 128, 257)[k % 6]
    G = (1, 3)[k % 2]
    F = 2 if n < 512 else 1
    rng = np.random.RandomState(k)
    re, im, re_np, im_np = _k7_planes(layout, G, T, F, n,
                                      lambda shape: _i8(rng, shape))
    vec = _check_k7(re, im, re_np, im_np)
    assert vec == int(layout.startswith('gulp') and re.shape[-1] % 8 == 0)


@pytest.mark.parametrize('T', [1, 31, 32, 33, 128, 257])
@pytest.mark.parametrize('G', [1, 3])
def test_xcorr_herm_frames_and_groups(G, T):
    """Each T of the list with and without groups, through the 16-byte
    path (a dual-pol gulp of 100 stations) and the scalar path."""
    rng = np.random.RandomState(T + G)
    for layout in ('gulp_p2', 'planes'):
        re, im, re_np, im_np = _k7_planes(layout, G, T, 3, 200,
                                          lambda shape: _i8(rng, shape))
        assert _check_k7(re, im, re_np, im_np) == int(layout == 'gulp_p2')


#: K7's planes at the int8 extremes: every value -128, and mixes of -128,
#: -127 and 127
_K7_EXTREMES = ['-128', 'mixed']


def _extreme_values(pattern, rng):
    if pattern == '-128':
        return lambda shape: np.full(shape, -128, np.int8)
    return lambda shape: rng.choice([-128, -127, 127], size=shape) \
        .astype(np.int8)


@pytest.mark.parametrize('pattern', _K7_EXTREMES)
@pytest.mark.parametrize('layout', _K7_LAYOUTS)
def test_xcorr_herm_exact_at_the_int8_extremes(layout, pattern):
    """-128 everywhere (which int8 cannot negate: K7 takes ~im instead)
    and +-127/-128 mixes, at a ragged shape: bit-identical to the plain
    version and the int64 oracle."""
    rng = np.random.RandomState(41)
    re, im, re_np, im_np = _k7_planes(layout, 3, 33, 2, 200,
                                      _extreme_values(pattern, rng))
    _check_k7(re, im, re_np, im_np)


@pytest.mark.parametrize('pattern', _K7_EXTREMES)
@pytest.mark.parametrize('layout', ['gulp_p2', 'planes'])
def test_xcorr_herm_exact_at_the_int32_edge(layout, pattern):
    """T = MAX_NTIME frames at small n and F: every -128 gives re = 2 T
    128^2 = 2,147,450,880 on every output; the s32 accumulators wrap,
    never saturate, so every result is exact."""
    T = gpu_kernels.MAX_NTIME
    rng = np.random.RandomState(43)
    re, im, re_np, im_np = _k7_planes(layout, 1, T, 2, 8,
                                      _extreme_values(pattern, rng))
    _check_k7(re, im, re_np, im_np)
    if pattern == '-128':
        got = gpu_kernels.xcorr_herm(re, im)
        assert (got.real == 2 * T * 128 * 128).all()
        assert float(got.real.max()) > 2 ** 31 - 2 ** 18


def test_xcorr_herm_launch_failure_raises():
    """K7's C entry refuses the 16-byte staging asked of separate planes,
    and the wrapper's check turns that into an exception."""
    from bifrost_tpu_torch import _build
    re = torch.zeros((1, 8, 2, 16), dtype=torch.int8, device='cuda')
    im = torch.zeros_like(re)
    out = torch.empty((1, 2, 16, 16, 2), dtype=torch.float32, device='cuda')
    lib, fn = gpu_kernels._fn('xcorr', 'bf_xcorr_herm',
                              gpu_kernels._HERM_ARGS)
    err = fn(re.data_ptr(), im.data_ptr(), out.data_ptr(), 1, 1, 8, 2, 16,
             8 * 2 * 16, 2 * 16, 16, 1, _build.stream_ptr(re.device))
    assert err != 0
    with pytest.raises(RuntimeError, match='xcorr_herm: CUDA error'):
        _build.check(lib, err, 'xcorr_herm')


#: K8's operand layouts: K7's, for the rows and for the columns apart
_K8_PAIRS = [(li, lj) for li in _K7_LAYOUTS for lj in _K7_LAYOUTS]

#: the launch counters of K8: launches, rows and columns through the
#: 16-byte staging, row-block jobs
_K8_COUNTERS = ('xcorr_cross', 'xcorr_cross_vec16_i', 'xcorr_cross_vec16_j',
                'xcorr_cross_rowblock')


def _k8_operands(li, lj, G, T, F, ni, nj, values):
    """(card planes, numpy planes) of K8's rows in layout ``li`` and its
    columns in layout ``lj``, (G, T, F, n') each."""
    ri, ii, ri_np, ii_np = _k7_planes(li, G, T, F, ni, values)
    rj, ij, rj_np, ij_np = _k7_planes(lj, G, T, F, nj, values)
    return (ri, ii, rj, ij), (ri_np, ii_np, rj_np, ij_np)


def _check_k8(ops, hosts):
    """K8 against its plain version and the int64 oracle, the staging
    counters where xcorr_staging says and the row-block counter where
    xcorr_cross_plan says.  Returns (vec_i, vec_j, rowblock)."""
    ri, ii, rj, ij = ops
    T, F, ni = ri.shape[-3:]
    nj = rj.shape[-1]
    path = (gpu_kernels.xcorr_staging(ri, ii),
            gpu_kernels.xcorr_staging(rj, ij),
            gpu_kernels.xcorr_cross_plan(T, ni, nj,
                                         gpu_kernels.smem_optin(ri.device))[0])
    before = [gpu_kernels.launches[k] for k in _K8_COUNTERS]
    got = gpu_kernels.xcorr_cross(*ops)
    want = gpu_kernels.xcorr_cross_plain(*ops)
    torch.cuda.synchronize()
    assert tuple(gpu_kernels.launches[k] - n
                 for k, n in zip(_K8_COUNTERS, before)) == (1,) + path
    assert got.shape == ri.shape[:-3] + (F, ni, nj)
    assert got.dtype == torch.complex64
    assert torch.equal(got, want)
    np.testing.assert_array_equal(got.cpu().numpy(), _xcorr_oracle(*hosts))
    return path


@pytest.mark.parametrize('li,lj', _K8_PAIRS)
def test_xcorr_cross_layouts_match_plain_and_oracle(li, lj):
    """Rows and columns each in every K7 layout (P = 1 and 2 gulp views on
    the 16-byte path, separate planes and odd strides on the scalar one),
    mixed, at ragged T, n_i and n_j (1 included) with and without groups,
    on row-block jobs and, at T = 256 and n_j = 512, on chunked ones; the
    16-byte staging is taken exactly by the gulp views with n' a multiple
    of 8."""
    k = _K8_PAIRS.index((li, lj))
    T = (1, 31, 33, 128, 64, 256)[k % 6]
    ni = (1, 63, 65, 130, 200, 256, 100)[k % 7]
    nj = 512 if T == 256 else (1, 64, 100, 512, 257, 130)[k % 5]
    G = (1, 3)[k % 2]
    rng = np.random.RandomState(100 + k)
    ops, hosts = _k8_operands(li, lj, G, T, 2, ni, nj,
                              lambda shape: _i8(rng, shape))
    vec_i, vec_j, rowblock = _check_k8(ops, hosts)
    assert vec_i == int(li.startswith('gulp') and ops[0].shape[-1] % 8 == 0)
    assert vec_j == int(lj.startswith('gulp') and ops[2].shape[-1] % 8 == 0)
    assert rowblock == int(T <= 128)


@pytest.mark.parametrize('T', [1, 31, 32, 33, 128, 256, 300])
@pytest.mark.parametrize('G', [1, 3])
def test_xcorr_cross_frames_and_groups(G, T):
    """Each T of the list with and without groups, against 512 columns:
    row-block jobs up to T = 128, chunked beyond (T = 300 in two chunks),
    through the 16-byte staging (dual-pol gulps of 100 and 256 stations)
    and through mixed stagings (rows as planes, columns a one-pol
    gulp)."""
    rng = np.random.RandomState(T + G)
    for li, lj in (('gulp_p2', 'gulp_p2'), ('planes', 'gulp_p1')):
        ops, hosts = _k8_operands(li, lj, G, T, 3, 200, 512,
                                  lambda shape: _i8(rng, shape))
        path = _check_k8(ops, hosts)
        assert path == (int(li == 'gulp_p2'), 1, int(T <= 128))


#: K8's layout pairs at the int8 extremes: each layout with itself and
#: two mixes
_K8_EXTREME_PAIRS = [(l, l) for l in _K7_LAYOUTS] + \
    [('gulp_p2', 'odd'), ('odd', 'gulp_p1')]


@pytest.mark.parametrize('pattern', _K7_EXTREMES)
@pytest.mark.parametrize('li,lj', _K8_EXTREME_PAIRS)
def test_xcorr_cross_exact_at_the_int8_extremes(li, lj, pattern):
    """-128 everywhere (which int8 cannot negate: K8 takes ~im instead)
    and +-127/-128 mixes, at a ragged shape: bit-identical to the plain
    version and the int64 oracle."""
    rng = np.random.RandomState(47)
    ops, hosts = _k8_operands(li, lj, 3, 33, 2, 70, 200,
                              _extreme_values(pattern, rng))
    _check_k8(ops, hosts)


@pytest.mark.parametrize('pattern', _K7_EXTREMES)
@pytest.mark.parametrize('li,lj', [('gulp_p2', 'planes'),
                                   ('planes', 'gulp_p2')])
def test_xcorr_cross_exact_at_the_int32_edge(li, lj, pattern):
    """T = MAX_NTIME frames (chunked jobs, 256 chunks) at small n and F:
    every -128 gives re = 2 T 128^2 = 2,147,450,880 on every output; the
    s32 accumulators wrap, never saturate, so every result is exact."""
    T = gpu_kernels.MAX_NTIME
    rng = np.random.RandomState(53)
    ops, hosts = _k8_operands(li, lj, 1, T, 2, 8, 12,
                              _extreme_values(pattern, rng))
    assert _check_k8(ops, hosts)[2] == 0
    if pattern == '-128':
        got = gpu_kernels.xcorr_cross(*ops)
        assert (got.real == 2 * T * 128 * 128).all()
        assert float(got.real.max()) > 2 ** 31 - 2 ** 18


def _cross_entry(ops, out, vec_i, vec_j, rowblock):
    """bf_xcorr_cross called directly on (G, T, F, n) planes."""
    from bifrost_tpu_torch import _build
    ri, ii, rj, ij = ops
    G, T, F, ni = ri.shape
    lib, fn = gpu_kernels._fn('xcorr', 'bf_xcorr_cross',
                              gpu_kernels._CROSS_ARGS)
    err = fn(ri.data_ptr(), ii.data_ptr(), rj.data_ptr(), ij.data_ptr(),
             out.data_ptr(), vec_i, vec_j, rowblock, G, T, F, ni,
             rj.shape[-1], *ri.stride(), *rj.stride(),
             _build.stream_ptr(ri.device))
    return lib, err


def test_xcorr_cross_rowblock_and_chunked_jobs_agree():
    """At a shape whose row blocks fit, the C entry's chunked jobs (asked
    for with rowblock 0) give the bits of the wrapper's row-block jobs,
    at the mesh's 2-D block shape cut to 8 channels."""
    rng = np.random.RandomState(59)
    ops, hosts = _k8_operands('gulp_p2', 'gulp_p2', 1, 128, 8, 256, 512,
                              lambda shape: _i8(rng, shape))
    assert _check_k8(ops, hosts) == (1, 1, 1)
    out = torch.empty((1, 8, 256, 512, 2), dtype=torch.float32,
                      device='cuda')
    lib, err = _cross_entry(ops, out, 1, 1, 0)
    assert err == 0
    torch.cuda.synchronize()
    assert torch.equal(torch.view_as_complex(out),
                       gpu_kernels.xcorr_cross(*ops))


def test_xcorr_cross_launch_failure_raises():
    """K8's C entry refuses the 16-byte staging asked of separate planes
    (rows or columns) and row-block jobs that do not fit in shared memory
    (T = 256 at 512 columns), and the wrapper's check turns that into an
    exception."""
    from bifrost_tpu_torch import _build
    rng = np.random.RandomState(61)
    ops, _ = _k8_operands('planes', 'gulp_p2', 1, 256, 2, 64, 512,
                          lambda shape: _i8(rng, shape))
    out = torch.empty((1, 2, 64, 512, 2), dtype=torch.float32,
                      device='cuda')
    for vec_i, vec_j, rowblock in ((1, 1, 0), (0, 1, 1)):
        lib, err = _cross_entry(ops, out, vec_i, vec_j, rowblock)
        assert err != 0, (vec_i, vec_j, rowblock)
        with pytest.raises(RuntimeError, match='xcorr_cross: CUDA error'):
            _build.check(lib, err, 'xcorr_cross')
    lib, err = _cross_entry(ops, out, 0, 1, 0)
    assert err == 0
    torch.cuda.synchronize()
    assert torch.equal(torch.view_as_complex(out)[0],
                       gpu_kernels.xcorr_cross_plain(*(v[0] for v in ops)))


def test_binding_cache_sets_argtypes_once_per_entry():
    """Each C entry is bound once: repeated launches of K0, K7 and K8 find
    their ctypes function with the argtypes tuple of the first binding
    (a reassignment would build a new one), distinct entries apart."""
    from bifrost_tpu_torch import _build
    x = torch.ones((8, 128), dtype=torch.float32, device='cuda')
    v = torch.zeros((4, 2, 8), dtype=torch.int8, device='cuda')
    calls = [lambda: gpu_kernels.probe(x),
             lambda: gpu_kernels.xcorr_herm(v, v),
             lambda: gpu_kernels.xcorr_cross(v, v, v, v)]
    for call in calls:
        call()
    keys = [('probe', 'bf_probe'), ('xcorr', 'bf_xcorr_herm'),
            ('xcorr', 'bf_xcorr_cross')]
    first = {k: _build._bound[k][1].argtypes for k in keys}
    fns = {k: _build._bound[k][1] for k in keys}
    assert len({id(f) for f in fns.values()}) == 3
    for _ in range(3):
        for call in calls:
            call()
    torch.cuda.synchronize()
    for k in keys:
        assert _build._bound[k][1] is fns[k]
        assert _build._bound[k][1].argtypes is first[k]


def test_to_host_carries_complex64_whole():
    """The correlator's cf32 output reaches the host as complex64 through
    pinned staging: one copy of the interleaved pairs, no float planes."""
    from bifrost_tpu_torch import xfer
    g = torch.Generator(device='cuda').manual_seed(9)
    t = torch.randn((3, 64, 65), dtype=torch.complex64, device='cuda',
                    generator=g)
    host = xfer.to_host(t)
    assert host.dtype == np.complex64 and host.shape == (3, 64, 65)
    np.testing.assert_array_equal(host, t.cpu().numpy())
    out = np.zeros((3, 64, 65), np.complex64)
    assert xfer.to_host(t, out) is out
    np.testing.assert_array_equal(out, host)


# ---------------------------------------------------------------------------
# K3: the FDMT merge step
# ---------------------------------------------------------------------------

def _plan_tables(plan):
    return [(torch.from_numpy(st.d1).cuda(), torch.from_numpy(st.d2).cuda(),
             torch.from_numpy(st.passthrough.astype(np.int32)).cuda())
            for st in plan._plan['steps']]


@pytest.mark.parametrize('nchan,md,f0,df,T,sgn,B', [
    (16, 12, 1400.0, 0.1, 1, 1, None), (13, 7, 1400.0, 0.1, 127, -1, None),
    (300, 200, 400.0, 0.5, 1000, 1, None), (300, 200, 400.0, 0.5, 1000, -1,
                                            3),
    (64, 37, 1400.0, -0.1, 127, 1, 2), (1024, 20000, 100.0, 1.0, 100, 1,
                                        None)])
def test_fdmt_step_matches_plain_over_a_plan(nchan, md, f0, df, T, sgn, B):
    """Every step of the plan, the state carried through K3, each step
    bit-identical to the plain version on the same input.  300 channels
    give passthrough rows and the rows_hi clamp; (1024, 20000) has step
    tables of 3 MB, above the JAX core's 256 KB SMEM budget."""
    from bifrost_tpu_torch.ops.fdmt import Fdmt, _init_state
    plan = Fdmt().init(nchan, md, f0, df)
    rng = np.random.RandomState(nchan + T)
    shape = (nchan, T) if B is None else (B, nchan, T)
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32)).cuda()
    state = _init_state(x if B else x[None], plan._plan['nd_init'], sgn)
    state = state if B else state[0]
    saw_pass = False
    for (d1, d2, pt), st in zip(_plan_tables(plan), plan._plan['steps']):
        saw_pass |= bool(st.passthrough.any())
        before = gpu_kernels.launches['fdmt_step']
        got = gpu_kernels.fdmt_step(state, d1, d2, pt, sgn)
        want = gpu_kernels.fdmt_step_plain(state, d1, d2, pt, sgn)
        torch.cuda.synchronize()
        assert gpu_kernels.launches['fdmt_step'] == before + 1
        assert got.shape == want.shape == state.shape[:-3] + \
            tuple(st.d1.shape) + (T,)
        assert torch.equal(got, want)
        state = got
    assert saw_pass == (nchan in (13, 300))


@pytest.mark.parametrize('neg', [False, True])
def test_fdmt_k3_core_equals_gather_core_and_oracle(neg, monkeypatch):
    """The whole engine with K3 forced against the torch gather core (bit
    for bit) and the float64 numpy oracle (1e-4), on a non-power-of-two
    plan; the step tables go to the card once per plan."""
    from bifrost_tpu_torch.ops.fdmt import Fdmt, fdmt_numpy
    monkeypatch.setenv('BF_FDMT_IMPL', 'pallas')
    plan = Fdmt().init(300, 200, 400.0, 0.5)
    rng = np.random.RandomState(3)
    x = rng.randn(2, 300, 700).astype(np.float32)
    xc = torch.from_numpy(x).cuda()
    before = gpu_kernels.launches['fdmt_step']
    for _ in range(3):
        got = plan.execute(xc, negative_delays=neg)
    torch.cuda.synchronize()
    nstep = len(plan._plan['steps'])
    assert gpu_kernels.launches['fdmt_step'] == before + 3 * nstep
    assert plan.table_uploads == 1
    want = plan._core_jax(neg)(xc)
    assert torch.equal(got, want)
    ref = fdmt_numpy(300, 200, 400.0, 0.5, x[1], negative_delays=neg)
    assert _rel(got[1].cpu().numpy(), ref) < 1e-4


def test_fdmt_step_rejects_what_the_kernel_cannot_take():
    from bifrost_tpu_torch.ops.fdmt import Fdmt
    plan = Fdmt().init(8, 6, 100.0, 1.0)
    d1, d2, pt = _plan_tables(plan)[0]
    nd = plan._plan['nd_init']
    good = torch.zeros((8, nd, 16), device='cuda')
    gpu_kernels.fdmt_step(good, d1, d2, pt, 1)
    bad = [(good.double(), d1, d2, pt),                       # dtype
           (good.cpu(), d1, d2, pt),                          # device
           (good, d1.cpu(), d2, pt),                          # table device
           (torch.zeros((8, 16, nd), device='cuda').transpose(1, 2),
            d1, d2, pt),                                      # layout
           (torch.zeros((8, nd, 0), device='cuda'), d1, d2, pt),   # T = 0
           (good, d1.long(), d2, pt)]                         # table type
    for args in bad:
        with pytest.raises(ValueError):
            gpu_kernels.fdmt_step(*args, 1)


def test_to_host_fills_a_strided_host_span():
    """A device gulp reaches a ringlet-layout host span (a strided view
    into the ring's buffer) in place, as copy('system') writes the FDMT
    output's dispersion ringlets."""
    from bifrost_tpu_torch import xfer
    g = torch.Generator(device='cuda').manual_seed(10)
    t = torch.randn((37, 100), device='cuda', generator=g)
    ring = np.zeros((37, 160), np.float32)
    span = ring[:, 40:140]
    assert xfer.to_host(t, span) is span
    np.testing.assert_array_equal(ring[:, 40:140], t.cpu().numpy())
    assert not ring[:, :40].any() and not ring[:, 140:].any()


# ---------------------------------------------------------------------------
# the transfer engine on the card: copy streams, pinned slots, fills
# ---------------------------------------------------------------------------

def _xfer_engine(**kw):
    from bifrost_tpu_torch import xfer
    from bifrost_tpu_torch.telemetry import counters
    counters.reset()
    return xfer, xfer.TransferEngine(**kw), counters


def _hold_h2d_stream(eng, ms=50):
    """Queue ``ms`` of spinning on the current stream and make the
    engine's H2D stream wait for it: the next copies stay pending."""
    dev = torch.device('cuda:0')
    torch.cuda._sleep(int(ms * 1.5e6))
    eng._stream('h2d', dev).wait_stream(torch.cuda.current_stream(dev))


def test_pinned_pool_recycles_only_after_the_event():
    """An H2D slot is not reused while its copy is pending: with the copy
    stream held, a second gulp of the key takes a fresh pinned buffer;
    once the copies are done, the slot recycles.  Values stay right."""
    xfer, eng, counters = _xfer_engine(staging=1)
    rng = np.random.RandomState(31)
    arrs = [rng.randn(1024, 1024).astype(np.float32) for _ in range(3)]
    # the key's one slot exists before the stream is held: a pinned
    # allocation may wait for the card
    warm = eng.to_device(arrs[2])
    torch.cuda.synchronize()
    counters.reset()
    _hold_h2d_stream(eng, 200)
    d0 = eng.to_device(arrs[0])
    slot = [s for s in eng._pool._busy if s.ref() is d0][0]
    assert not slot.event.query()
    d1 = eng.to_device(arrs[1])
    assert counters.get('xfer.h2d_staged') == 1
    assert counters.get('xfer.h2d_unstaged') == 1
    torch.cuda.synchronize()
    d2 = eng.to_device(arrs[2])
    assert counters.get('xfer.h2d_staged') == 2
    assert eng._pool._nalloc[((1024, 1024), 'float32')] == 1
    for a, d in zip(arrs + [arrs[2]], (d0, d1, d2, warm)):
        np.testing.assert_array_equal(d.cpu().numpy(), a)
    assert eng.pinned_bytes() == arrs[0].nbytes


def test_h2d_source_can_be_recycled_at_once():
    """The caller overwrites its host buffer straight after to_device,
    while the copy is still queued: the tensor keeps the old bytes."""
    xfer, eng, counters = _xfer_engine()
    src = np.arange(1 << 22, dtype=np.float32)
    want = src.copy()
    _hold_h2d_stream(eng)
    d = eng.to_device(src)
    src[...] = -1.0
    np.testing.assert_array_equal(d.cpu().numpy(), want)


def test_d2h_after_producer_kernel_without_synchronize():
    """A D2H issued on the engine's copy stream right after a kernel on
    the caller's stream (held back by a spin) waits for that kernel: 32
    gulps, byte for byte, in order and out of order, with no explicit
    synchronize."""
    xfer, eng, counters = _xfer_engine(depth=8)
    g = torch.Generator(device='cuda').manual_seed(32)
    futs, want = [], []
    for i in range(32):
        x = torch.randint(-1000, 1000, (256, 1024), device='cuda',
                          generator=g, dtype=torch.int32)
        want.append(x.cpu().numpy() * 3 + i)
        torch.cuda._sleep(int(2e6))
        y = x * 3 + i              # the producer, queued behind the spin
        futs.append(eng.to_host_async(y))
        del x, y
    for i in list(range(1, 32, 2)) + list(range(0, 32, 2)):
        np.testing.assert_array_equal(futs[i].result(), want[i])
    assert counters.get('xfer.d2h_async') == 32
    assert eng.outstanding == 0


def test_host_fill_into_pageable_and_pinned_targets():
    """A fill lands in a pageable target through a pinned slot and in a
    contiguous pinned target directly; a strided pinned target takes the
    slot.  Bytes equal the tensor's."""
    xfer, eng, counters = _xfer_engine(depth=8)
    t = torch.randn((64, 512), device='cuda')
    want = t.cpu().numpy()
    pageable = np.zeros((64, 512), np.float32)
    pinned = torch.zeros((64, 512), pin_memory=True).numpy()
    pinned_wide = torch.zeros((64, 600), pin_memory=True).numpy()
    for out in (pageable, pinned, pinned_wide[:, 40:552]):
        fill = eng.host_fill(t, 'f32', out)
        fill.wait()
        np.testing.assert_array_equal(out, want)
    assert counters.get('xfer.d2h_direct') == 1
    assert counters.get('xfer.d2h_staged') == 2


def _cuda_host_chain(first, last, gulps):
    import contextlib
    import bifrost_tpu_torch as bt

    class Source(bt.SourceBlock):
        def __init__(self):
            super(Source, self).__init__(['x'], 64, space=first)
            self.it = iter(gulps)

        def create_reader(self, name):
            return contextlib.nullcontext()

        def on_sequence(self, reader, name):
            return [{'name': 'x', 'time_tag': 0, '_tensor': {
                'shape': [-1, 2, 512], 'dtype': 'ci8',
                'labels': ['time', 'pol', 'chan'], 'scales': [[0, 1]] * 3,
                'units': [None] * 3}}]

        def on_data(self, reader, ospans):
            g = next(self.it, None)
            if g is None:
                return [0]
            ospans[0].data.as_numpy().view(np.int8)[...] = \
                g.reshape(64, 2, 1024)
            return [64]

    class Sink(bt.SinkBlock):
        def __init__(self, iring):
            super(Sink, self).__init__(iring)
            self.out = []

        def on_sequence(self, iseq):
            pass

        def on_data(self, ispan):
            self.out.append(np.array(ispan.data.as_numpy().view(np.int8),
                                     copy=True))

    with bt.Pipeline() as p:
        b = bt.blocks.copy(Source(), space='cuda')
        sink = Sink(bt.blocks.copy(b, space=last))
    _run_bounded(p)
    return np.concatenate(sink.out)


def _run_bounded(p, timeout=120):
    """``p.run()`` on a daemon thread, failing the test (after shutting
    the pipeline down) if it has not ended within ``timeout`` seconds."""
    import threading
    box = {}

    def target():
        try:
            p.run()
        except BaseException as exc:
            box['exc'] = exc

    t = threading.Thread(target=target, daemon=True)
    t.start()
    t.join(timeout)
    if t.is_alive():
        p.shutdown()
        pytest.fail('pipeline still running after %g s' % timeout)
    if 'exc' in box:
        raise box['exc']


def test_cuda_host_direct_paths():
    """cuda_host -> copy('cuda') -> copy('cuda_host'): the H2D reads the
    pinned span itself and the D2H lands in the pinned span, with no
    staging copy, and the bytes equal the system-ring chain's."""
    from bifrost_tpu_torch import xfer
    from bifrost_tpu_torch.telemetry import counters
    rng = np.random.RandomState(33)
    gulps = [rng.randint(-128, 128, (64, 2, 512, 2)).astype(np.int8)
             for _ in range(6)]
    xfer.reset_engine()
    counters.reset()
    got = _cuda_host_chain('cuda_host', 'cuda_host', gulps)
    assert counters.get('xfer.h2d_direct') == 6
    assert counters.get('xfer.d2h_direct') == 6
    assert counters.get('xfer.h2d_staged') + \
        counters.get('xfer.h2d_unstaged') == 0
    counters.reset()
    want = _cuda_host_chain('system', 'system', gulps)
    assert counters.get('xfer.h2d_direct') == 0
    assert counters.get('xfer.d2h_staged') == 6
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.concatenate(gulps).reshape(
        got.shape))


# ---------------------------------------------------------------------------
# K9: the corner turn's ring hop, D ranks on one card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('D', [2, 3, 4])
@pytest.mark.parametrize('shape,dtype', [
    ((64, 33, 5, 2, 2), torch.int8),         # 16-byte multiple
    ((7, 3, 5), torch.int8),                 # 105 bytes: a byte tail
    ((5, 3, 7), torch.complex64),            # 840 bytes, not of 16
    ((16, 64, 3, 2), torch.complex64)])
def test_ring_permute_bit_identical_to_plain(D, shape, dtype):
    g = torch.Generator(device='cuda').manual_seed(D)
    if dtype == torch.int8:
        blocks = [torch.randint(-128, 128, shape, dtype=torch.int8,
                                device='cuda', generator=g)
                  for _ in range(D)]
    else:
        blocks = [torch.complex(torch.randn(shape, device='cuda',
                                            generator=g),
                                torch.randn(shape, device='cuda',
                                            generator=g))
                  for _ in range(D)]
    before = gpu_kernels.launches['ring_permute']
    got = gpu_kernels.ring_permute(blocks)
    torch.cuda.synchronize()
    assert gpu_kernels.launches['ring_permute'] == before + 1
    want = gpu_kernels.ring_permute_plain(blocks)
    for i in range(D):
        assert got[i].is_cuda and got[i].dtype == dtype
        assert torch.equal(got[i], want[i])
        assert torch.equal(got[(i + 1) % D], blocks[i])


def test_ring_permute_unaligned_views():
    """Blocks that start off a 16-byte boundary take the byte path."""
    base = torch.randint(-128, 128, (4 * 1001 + 3,), dtype=torch.int8,
                         device='cuda')
    blocks = [base[3 + i * 1001:3 + (i + 1) * 1001] for i in range(4)]
    got = gpu_kernels.ring_permute(blocks)
    for i in range(4):
        assert torch.equal(got[(i + 1) % 4], blocks[i])


def test_ring_permute_rejects_what_the_kernel_cannot_take():
    a = torch.zeros((4, 6), device='cuda')
    with pytest.raises(ValueError):
        gpu_kernels.ring_permute([a, a.t()])               # shape
    with pytest.raises(ValueError):
        gpu_kernels.ring_permute([a[:, ::2], a[:, 1::2]])  # strides
    with pytest.raises(ValueError):
        gpu_kernels.ring_permute([a, a.cpu()])             # devices
    with pytest.raises(ValueError, match='at most 64'):
        gpu_kernels.ring_permute([a] * 65)                 # ranks


def test_ring_permute_without_peer_access_raises(monkeypatch):
    if torch.cuda.device_count() < 2:
        pytest.skip('needs two cards')
    monkeypatch.setattr(torch.cuda, 'can_device_access_peer',
                        lambda a, b: False)
    blocks = [torch.zeros(16, device='cuda:0'),
              torch.zeros(16, device='cuda:1')]
    with pytest.raises(RuntimeError, match='peer access'):
        gpu_kernels.ring_permute(blocks)


def _mesh_block(mesh):
    """A CorrelateBlock (K7 forced) under ``block_scope(mesh=mesh)``, fed
    by a device ring."""
    import contextlib
    import bifrost_tpu_torch as bt

    class _Src(bt.SourceBlock):
        def create_reader(self, name):
            return contextlib.nullcontext()

    with bt.Pipeline():
        h2d = bt.blocks.copy(_Src(['x'], 16, space='system'), space='cuda')
        with bt.block_scope(mesh=mesh):
            return bt.blocks.correlate(h2d, 64, accuracy='int8',
                                       impl='pallas')


def test_mesh_correlator_plans_byte_equal_on_one_card():
    """psum (K7 per rank), corner:xla and corner:pallas (K9 hops) on four
    ranks of cuda:0, each byte-equal to the single-device product."""
    from bifrost_tpu_torch import parallel as par
    g = torch.Generator(device='cuda').manual_seed(5)
    x = torch.randint(-128, 128, (64, 16, 24, 2, 2), dtype=torch.int8,
                      device='cuda', generator=g)
    mesh = par.create_mesh({'sp': 4}, devices=['cuda:0'] * 4)
    single = _mesh_block(None)._local_vis_fn(True)(x)
    for plan in ('psum', 'corner:xla', 'corner:pallas'):
        blk = _mesh_block(mesh)
        before = dict(gpu_kernels.launches)
        got = blk._build_mesh(tuple(x.shape), 'int8', True, plan)(x)
        torch.cuda.synchronize()
        n = {k: gpu_kernels.launches[k] - before[k] for k in before}
        assert n['xcorr_herm'] == 4, (plan, n)
        assert n['ring_permute'] == (3 if plan == 'corner:pallas' else 0)
        assert torch.equal(got, single), plan


# ---------------------------------------------------------------------------
# the DSP library on the card: map, FIR, Romein, convert_visibilities
# ---------------------------------------------------------------------------

def test_map_masked_if_and_negative_wrap_on_the_card():
    """bf.map's SIMT if/else under a mask and a gather whose negative
    indices wrap, evaluated on cuda tensors, equal numpy; the output
    tensor is written in place."""
    from bifrost_tpu_torch.ops import map as tmap
    n = 64
    a = np.arange(n * n, dtype=np.float32).reshape(n, n)
    ta = torch.from_numpy(a).cuda()
    tb = torch.zeros(n, n, device='cuda')
    ptr = tb.data_ptr()
    tmap.map('if (i > j) { b(i,j) = a(i,j); } else { b(i,j) = -a(j,i); }',
             {'a': ta, 'b': tb}, shape=(n, n), axis_names=('i', 'j'))
    assert tb.data_ptr() == ptr
    want = np.where(np.arange(n)[:, None] > np.arange(n)[None, :], a, -a.T)
    np.testing.assert_array_equal(tb.cpu().numpy(), want)
    x = torch.randint(-1000, 1000, (8, 4096), dtype=torch.int32,
                      device='cuda')
    y = torch.empty_like(x)
    tmap.map('y(t,f) = x(t,f-x.shape(1)/2)', {'x': x, 'y': y},
             shape=x.shape, axis_names=('t', 'f'))
    assert torch.equal(y, torch.fft.fftshift(x, dim=1))


def test_map_out_of_range_gather_clamps_and_store_drops_on_the_card():
    """Past the end of an axis, a gather clamps and a store is dropped,
    as jnp does, on cuda tensors."""
    from bifrost_tpu_torch.ops import map as tmap
    a = torch.arange(1, 9, dtype=torch.int32, device='cuda')
    b = torch.full((8,), -5, dtype=torch.int32, device='cuda')
    tmap.map('b(i+1) = a(i+3)', {'a': a, 'b': b}, shape=(8,),
             axis_names=('i',))
    assert b.tolist() == [-5, 4, 5, 6, 7, 8, 8, 8]


def test_map_ci8_host_input_unpacks_on_the_card():
    """A host ci8 array crosses as its bytes and is unpacked on the card;
    the cf32 output tensor equals the integers exactly."""
    from bifrost_tpu_torch.ndarray import ndarray
    from bifrost_tpu_torch.ops import map as tmap
    rng = np.random.RandomState(3)
    buf = np.zeros(4096, np.dtype([('re', 'i1'), ('im', 'i1')]))
    buf['re'] = rng.randint(-128, 128, 4096)
    buf['im'] = rng.randint(-128, 128, 4096)
    out = torch.zeros(4096, dtype=torch.complex64, device='cuda')
    tmap.map('b(i) = a(i)', {'a': ndarray(buf, dtype='ci8'), 'b': out},
             shape=(4096,), axis_names=('i',))
    want = buf['re'].astype(np.float32) + 1j * buf['im']
    np.testing.assert_array_equal(out.cpu().numpy(), want)


def test_fir_state_across_gulps_on_the_card():
    """Per-channel 16-tap FIR over three gulps (the last partial) on
    cuda equals the float64 oracle over the stream within 1e-5."""
    from bifrost_tpu_torch.ops.fir import Fir
    rng = np.random.RandomState(4)
    x = (rng.randn(40, 8, 3) + 1j * rng.randn(40, 8, 3)).astype(np.complex64)
    c = rng.randn(16, 8, 3).astype(np.float32)
    fir = Fir().init(c)
    out = np.concatenate([fir.execute(torch.from_numpy(x[a:b]).cuda())
                          .cpu().numpy() for a, b in ((0, 16), (16, 32),
                                                      (32, 40))])
    xp = np.concatenate([np.zeros((15, 8, 3)), x.astype(np.complex128)])
    want = sum(c[k] * xp[15 - k:15 - k + 40] for k in range(16))
    assert _rel(out, want) < GATE


def test_romein_accumulate_and_wrap_on_the_card():
    """Romein's atomic scatter on cuda, positions that wrap past both
    edges, within 1e-5 of a float64 np.add.at oracle; accumulate=True
    into the same grid doubles it."""
    from bifrost_tpu_torch.ops.romein import Romein
    rng = np.random.RandomState(5)
    npts, k, ngrid, nb = 500, 7, 64, 3
    pos = rng.randint(-k, ngrid, size=(npts, 2)).astype(np.int32)
    kern = (rng.randn(npts, k, k) + 1j * rng.randn(npts, k, k)) \
        .astype(np.complex64)
    data = (rng.randn(nb, npts) + 1j * rng.randn(nb, npts)) \
        .astype(np.complex64)
    rom = Romein().init(pos, kern, ngrid)
    grid = rom.execute(torch.from_numpy(data).cuda())
    want = np.zeros((nb, ngrid, ngrid), np.complex128)
    d = np.arange(k)
    gy = (pos[:, 1, None, None] + d[None, :, None]) % ngrid
    gx = (pos[:, 0, None, None] + d[None, None, :]) % ngrid
    for b in range(nb):
        np.add.at(want[b], (np.broadcast_to(gy, kern.shape),
                            np.broadcast_to(gx, kern.shape)),
                  data[b, :, None, None].astype(np.complex128) * kern)
    assert _rel(grid.cpu().numpy(), want) < GATE
    rom.execute(torch.from_numpy(data).cuda(), odata=grid, accumulate=True)
    assert _rel(grid.cpu().numpy(), 2 * want) < GATE


def test_convert_visibilities_storage_round_trip_on_the_card():
    """matrix -> storage -> matrix of integer-valued Hermitian
    visibilities on cuda recovers the full matrix exactly, and the
    storage equals the numpy conversion."""
    from bifrost_tpu_torch.blocks.convert_visibilities import (
        _tri_indices, baseline_indices, matrix_to_storage,
        storage_to_matrix)
    rng = np.random.RandomState(6)
    T, F, S = 2, 16, 24
    full = rng.randint(-99, 99, (T, F, S, 2, S, 2)) + \
        1j * rng.randint(-99, 99, (T, F, S, 2, S, 2))
    full = (full + np.conj(full.transpose(0, 1, 4, 5, 2, 3))) \
        .astype(np.complex64)
    b_i, b_j = _tri_indices(S)
    bi, bj, diag = baseline_indices(S, 'cuda')
    st = matrix_to_storage(torch.from_numpy(full).cuda(), bi, bj, diag)
    v = np.moveaxis(full[:, :, b_i, :, b_j, :], 0, 1)
    xx, xy, yx, yy = v[..., 0, 0], v[..., 0, 1], v[..., 1, 0], v[..., 1, 1]
    want = np.stack([xx + yy, xx - yy, xy + yx, (xy - yx) * 1j], -1)
    np.testing.assert_array_equal(st.cpu().numpy(), want)
    back = storage_to_matrix(st, bi, bj, S)
    np.testing.assert_array_equal(back.cpu().numpy(), full)


# ---------------------------------------------------------------------------
# the supervised runtime on the card: abort with fills in flight, a device
# block's restart, drop_oldest on a cuda ring
# ---------------------------------------------------------------------------

def _sup_blocks(gulps):
    import bifrost_tpu_torch as bt

    class Source(bt.SourceBlock):
        def __init__(self, **kw):
            super(Source, self).__init__(['g'], gulps[0].shape[0],
                                         space='system', **kw)

        def create_reader(self, name):
            import contextlib
            return contextlib.nullcontext([0])

        def on_sequence(self, reader, name):
            return [{'name': 'g', 'time_tag': 0,
                     'gulp_nframe': gulps[0].shape[0],
                     '_tensor': {'shape': [-1, 2, gulps[0].shape[2]],
                                 'dtype': 'ci8'}}]

        def on_data(self, reader, ospans):
            if reader[0] == len(gulps):
                return [0]
            ospans[0].data.as_numpy().view(np.int8)[...] = \
                gulps[reader[0]].reshape(ospans[0].data.as_numpy().view(
                    np.int8).shape)
            reader[0] += 1
            return [gulps[0].shape[0]]

    class Sink(bt.SinkBlock):
        def __init__(self, iring, fail_at=None, **kw):
            super(Sink, self).__init__(iring, **kw)
            self.out, self.nseq, self.fail_at = [], 0, fail_at

        def on_sequence(self, iseq):
            self.nseq += 1

        def on_data(self, ispan):
            if len(self.out) == self.fail_at:
                raise RuntimeError('sink failed')
            self.out.append(np.array(ispan.data.as_numpy().view(np.int8),
                                     copy=True))
    return Source, Sink


def _sup_gulps(n, seed=41):
    rng = np.random.RandomState(seed)
    return [rng.randint(-128, 128, (64, 2, 512, 2)).astype(np.int8)
            for _ in range(n)]


def test_abort_with_fills_in_flight_leaves_nothing_held():
    """A sink that fails while the D2H block's fills are in flight: run()
    raises, no thread is left, the engine has nothing outstanding and the
    card's allocated memory falls back to within one gulp of where it
    stood before the run."""
    import gc
    import bifrost_tpu_torch as bt
    from bifrost_tpu_torch import xfer
    gulps = _sup_gulps(24)
    Source, Sink = _sup_blocks(gulps)
    xfer.reset_engine()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    with bt.Pipeline() as p:
        b = bt.blocks.copy(Source(), space='cuda')
        Sink(bt.blocks.copy(b, space='system'), fail_at=3)
    with pytest.raises(bt.PipelineRuntimeError, match='sink failed'):
        _run_bounded(p)
    assert not any(t.is_alive() for t in p.threads)
    assert xfer.engine().outstanding == 0
    del p, b
    gc.collect()
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() <= before + gulps[0].nbytes


def test_restart_of_a_device_block_keeps_the_stream():
    """The H2D block fails once mid-stream and restarts: it waits on the
    failed attempt's events before it goes on, its output sequence ends
    at the failure (no end of data downstream), and every gulp after the
    restart arrives byte for byte (the ring held the whole stream)."""
    import bifrost_tpu_torch as bt
    from bifrost_tpu_torch.telemetry import counters
    from bifrost_tpu_torch.testing import faults
    gulps = _sup_gulps(6)
    Source, Sink = _sup_blocks(gulps)
    counters.reset()
    with bt.Pipeline() as p:
        b = bt.blocks.copy(Source(), space='cuda', on_failure='restart',
                           restart_backoff=0.01,
                           # the stream and the source's last reserve
                           buffer_nframe=8 * 64)
        sink = Sink(bt.blocks.copy(b, space='system'))
    with faults.injected('block.on_data', match=b.name, count=1, after=2):
        _run_bounded(p)
    assert counters.get('block_restarts') == 1
    assert sink.nseq == 2
    want = gulps[:2] + gulps
    assert len(sink.out) == len(want)
    for got, g in zip(sink.out, want):
        np.testing.assert_array_equal(got, g.reshape(got.shape))


def test_drop_oldest_on_a_cuda_ring_releases_what_it_sheds():
    """drop_oldest on a cuda ring: a reader that idles between spans is
    shed past whole gulps, the ledger equals its skipped frames, every
    gulp it reads equals its input, and the chunk map never holds more
    than the ring's capacity (shed chunks are released)."""
    import time
    from bifrost_tpu_torch.ring import Ring, EndOfDataStop
    ring = Ring(space='cuda', name='drop_oldest_cuda')
    ring.set_overload_policy('drop_oldest')
    hdr = {'name': 's', 'gulp_nframe': 4,
           '_tensor': {'shape': [-1, 1024], 'dtype': 'f32'}}
    gulps = [torch.full((4, 1024), float(i), device='cuda')
             for i in range(40)]
    held, got, skipped = [], [], [0]
    import threading
    ready = threading.Event()

    def reader():
        seq = ring.open_earliest_sequence(guarantee=True)
        ready.set()
        off = 0
        while True:
            try:
                sp = seq.acquire(off, 4)
            except EndOfDataStop:
                break
            skipped[0] += sp.frame_offset - off
            if sp.nframe:
                got.append((sp.frame_offset // 4, float(sp.data[0, 0])))
            nxt = sp.frame_offset + sp.nframe
            sp.release()
            if not sp.nframe and nxt <= off:
                break
            off = nxt
            time.sleep(0.01)
        seq.close()

    with ring.begin_writing() as w:
        with w.begin_sequence(hdr, 4, 12) as s:
            t = threading.Thread(target=reader, daemon=True)
            t.start()
            assert ready.wait(10)
            for g in gulps:
                with s.reserve(4) as sp:
                    sp.set(g)
                    sp.commit(4)
                held.append(sum(c[0] for c in ring._storage.chunks.values()))
    t.join(30)
    assert not t.is_alive()
    shed = ring.shed_stats()
    assert shed['shed_bytes'] > 0
    assert shed['shed_bytes'] == skipped[0] * 4096
    assert shed['shed_gulps'] == len(gulps) - len(got)
    assert all(v == float(i) for i, v in got)
    assert max(held) <= ring.total_span


# ---------------------------------------------------------------------------
# macro-gulp spans and donation on the card
# ---------------------------------------------------------------------------

def test_spectrometer_at_a_k_gulp_shape_equals_its_plain_version():
    """K1 at the macro span of 4 gulps of 2048 frames (8192 x 2 x 4096,
    r 4), as a K = 4 FusedBlock gives it: within the gate of its plain
    version and of the float64 oracle on four rows, one launch."""
    g = torch.Generator(device='cuda').manual_seed(7)
    x = torch.randint(-128, 128, (4 * 2048, 2, 4096, 2), dtype=torch.int8,
                      device='cuda', generator=g)
    before = spec.launches
    got = spec.fused_spectrometer(x, rfactor=4)
    assert spec.launches == before + 1
    want = spec.spectrometer_plain(x, rfactor=4)
    assert _rel(got.cpu().numpy(), want.cpu().numpy()) < GATE
    rows = [0, 2047, 2048, 8191]
    oracle = spec.spectrometer_oracle(x[rows].cpu().numpy(), 4)
    assert _rel(got[rows].cpu().numpy(), oracle) < GATE


def test_take_data_of_an_h2d_chunk_is_not_recycled_before_its_reader():
    """A chunk the engine's H2D stream filled, claimed by a reader on
    another stream: the reader's kernel is held back, the reader drops
    the chunk, and a new H2D of the same size follows at once.  The
    claim recorded the reader's stream on the chunk, so the allocator
    does not hand its memory to the new copy before the held-back kernel
    has read it."""
    from bifrost_tpu_torch import xfer
    from bifrost_tpu_torch.ring import Ring
    n = 1 << 22
    ones = np.ones((16, n // 16), np.float32)
    junk = np.full((16, n // 16), -7.0, np.float32)
    ring = Ring(space='cuda')
    hdr = {'name': 's', 'gulp_nframe': 16,
           '_tensor': {'shape': [-1, n // 16], 'dtype': 'f32'}}
    eng = xfer.engine()
    side = torch.cuda.Stream()
    def commit_owned(seq):
        # in a function, so that no writer-side reference outlives it
        with seq.reserve(16) as sp:
            sp.set(eng.to_device(ones), owned=True)
            sp.commit(16)

    with ring.begin_writing() as w:
        with w.begin_sequence(hdr, 16, 48) as seq:
            commit_owned(seq)
            r = ring.open_earliest_sequence(guarantee=True)
            with torch.cuda.stream(side):
                with r.acquire(0, 16) as ispan:
                    x = ispan.take_data()
                    assert x is not None and not ring._storage.chunks
                    torch.cuda._sleep(200_000_000)
                    y = x * 2.0
                del x, ispan
                later = eng.to_device(junk)
            torch.cuda.synchronize()
            r.close()
    assert torch.equal(later, torch.from_numpy(junk).cuda())
    assert bool((y == 2.0).all())


def test_macro_writer_and_k1_reader_on_the_card():
    """A K = 4 fused writer (K1 substituted at 4 x 1024 frames) feeding a
    stage block pinned to K = 1: no deadlock, the K = 1 chain's bytes,
    and the fused block's 4 launches a span cover its gulps."""
    import contextlib
    import bifrost_tpu_torch as bt
    from bifrost_tpu_torch.stages import FftStage, DetectStage, ReduceStage
    rng = np.random.RandomState(3)
    gulps = [rng.randint(-64, 64, (1024, 2, 1024, 2)).astype(np.int8)
             for _ in range(9)]

    class Src(bt.SourceBlock):
        def __init__(self):
            super(Src, self).__init__(['v'], 1024, space='system')

        def create_reader(self, name):
            return contextlib.nullcontext(iter(gulps))

        def on_sequence(self, reader, name):
            return [{'name': 'v', 'time_tag': 0,
                     '_tensor': {'shape': [-1, 2, 1024], 'dtype': 'ci8',
                                 'labels': ['time', 'pol', 'fine_time'],
                                 'scales': [[0, 1]] * 3,
                                 'units': [None] * 3}}]

        def on_data(self, reader, ospans):
            g = next(reader, None)
            if g is None:
                return [0]
            ospans[0].data.as_numpy().view(np.int8)[...] = \
                g.reshape(ospans[0].data.as_numpy().view(np.int8).shape)
            return [1024]

    class Sink(bt.SinkBlock):
        def __init__(self, iring):
            super(Sink, self).__init__(iring)
            self.out = []

        def on_sequence(self, iseq):
            pass

        def on_data(self, ispan):
            self.out.append(np.array(ispan.data.as_numpy(), copy=True))

    def run(k):
        with bt.Pipeline(gulp_batch=k) as p:
            b = bt.blocks.copy(Src(), space='cuda')
            fb = bt.blocks.fused(b, [FftStage('fine_time',
                                              axis_labels='freq'),
                                     DetectStage('stokes', axis='pol'),
                                     ReduceStage('freq', 4)])
            b = bt.blocks.scrunch(fb, 2, gulp_batch=1)
            sink = Sink(bt.blocks.copy(b, space='system'))
        before = spec.launches
        _run_bounded(p, timeout=60)
        return np.concatenate(sink.out), spec.launches - before, fb
    out4, n4, fb4 = run(4)
    out1, n1, fb1 = run(1)
    assert np.array_equal(out4, out1)
    assert n1 == 9 + fb1.prewarm_runs and n4 == 3 + fb4.prewarm_runs


# ---------------------------------------------------------------------------
# the native ring core, the ring-protocol checker and the profiler on the
# card
# ---------------------------------------------------------------------------

def test_native_system_ring_fed_by_deferred_d2h_fills():
    """copy('cuda') -> copy('system') with the transfer engine's deferred
    fills landing in a native 'system' ring: every byte arrives, the
    fills ran deferred, and the ring is a NativeRing."""
    import bifrost_tpu_torch as bt
    from bifrost_tpu_torch import xfer
    from bifrost_tpu_torch.ring_native import NativeRing
    from bifrost_tpu_torch.telemetry import counters
    gulps = _sup_gulps(12)
    Source, Sink = _sup_blocks(gulps)
    counters.reset()
    with bt.Pipeline() as p:
        b = bt.blocks.copy(Source(), space='cuda')
        d2h = bt.blocks.copy(b, space='system', buffer_nframe=3 * 64)
        sink = Sink(d2h)
    assert isinstance(d2h.orings[0], NativeRing)
    _run_bounded(p)
    assert len(sink.out) == len(gulps)
    for got, g in zip(sink.out, gulps):
        np.testing.assert_array_equal(got, g.reshape(got.shape))
    assert counters.get('xfer.d2h_issued') >= len(gulps)
    assert xfer.engine().outstanding == 0


@pytest.mark.parametrize('case,invariant', [
    ('double_commit', 'double_commit'),
    ('double_release', 'double_release'),
    ('acquire_uncommitted', 'acquire_uncommitted'),
    ('guarantee_jump', 'guarantee_pin'),
    ('resize_under_span', 'resize_quiescence')])
def test_ringcheck_on_a_cuda_ring(case, invariant):
    """Each ring.corrupt.* seam on a 'cuda' ring on the card raises the
    checker's invariant."""
    from bifrost_tpu_torch.analysis import ringcheck
    from bifrost_tpu_torch.analysis.ringcheck import RingProtocolError
    from bifrost_tpu_torch.ring import Ring
    from bifrost_tpu_torch.testing import faults
    ringcheck.set_enabled(True)
    ringcheck.reset()
    try:
        ring = Ring(space='cuda', name='rc_card_' + case)
        hdr = {'name': 's', 'gulp_nframe': 8,
               '_tensor': {'shape': [-1, 4], 'dtype': 'f32'}}
        seq = ring.begin_writing().begin_sequence(hdr, 8, 16)

        def put(val):
            with seq.reserve(8) as sp:
                sp.set(torch.full((8, 4), val, device='cuda'))
                sp.commit(8)
        site = 'ring.corrupt.' + case
        with pytest.raises(RingProtocolError) as ei:
            if case == 'double_commit':
                with faults.injected(site, match=ring.name):
                    put(1.0)
            elif case == 'resize_under_span':
                sp = seq.reserve(8)
                with faults.injected(site, match=ring.name):
                    ring.request_resize(1, ring.total_span * 2)
            else:
                put(1.0)
                put(2.0)
                rseq = ring.open_earliest_sequence(guarantee=True)
                if case == 'double_release':
                    span = rseq.acquire(0, 8)
                    with faults.injected(site, match=ring.name):
                        span.release()
                elif case == 'acquire_uncommitted':
                    with faults.injected(site, match=ring.name):
                        rseq.acquire(8, 8)
                else:
                    with faults.injected(site, match=ring.name):
                        rseq.acquire(0, 8)
                    put(3.0)
        assert ei.value.invariant == invariant
    finally:
        faults.clear()
        ringcheck.set_enabled(False)
        ringcheck.reset()


def test_profiler_capture_names_a_cuda_kernel(monkeypatch, tmp_path):
    """BF_TORCH_PROFILE on a fused K1 chain: one capture whose Chrome
    trace holds kernel events, K1's among them."""
    import contextlib
    import json
    import os
    import bifrost_tpu_torch as bt
    from bifrost_tpu_torch.stages import FftStage, DetectStage, ReduceStage
    from bifrost_tpu_torch.telemetry import counters, profiling
    rng = np.random.RandomState(3)
    gulps = [rng.randint(-64, 64, (256, 2, 1024, 2)).astype(np.int8)
             for _ in range(3)]

    class Src(bt.SourceBlock):
        def __init__(self):
            super(Src, self).__init__(['v'], 256, space='system')

        def create_reader(self, name):
            return contextlib.nullcontext(iter(gulps))

        def on_sequence(self, reader, name):
            return [{'name': 'v', 'time_tag': 0,
                     '_tensor': {'shape': [-1, 2, 1024], 'dtype': 'ci8',
                                 'labels': ['time', 'pol', 'fine_time'],
                                 'scales': [[0, 1]] * 3,
                                 'units': [None] * 3}}]

        def on_data(self, reader, ospans):
            g = next(reader, None)
            if g is None:
                return [0]
            ospans[0].data.as_numpy().view(np.int8)[...] = \
                g.reshape(ospans[0].data.as_numpy().view(np.int8).shape)
            return [256]

    class Sink(bt.SinkBlock):
        def on_sequence(self, iseq):
            pass

        def on_data(self, ispan):
            pass

    monkeypatch.setenv('BF_TORCH_PROFILE', str(tmp_path))
    profiling.reset()
    counters.reset()
    try:
        with bt.Pipeline() as p:
            b = bt.blocks.copy(Src(), space='cuda')
            b = bt.blocks.fused(b, [FftStage('fine_time',
                                             axis_labels='freq'),
                                    DetectStage('stokes', axis='pol'),
                                    ReduceStage('freq', 4)])
            Sink(bt.blocks.copy(b, space='system'))
        _run_bounded(p)
    finally:
        profiling.reset()
    assert counters.get('torchprof.captures') == 1
    trace = profiling.last_trace()
    assert os.path.exists(trace)
    with open(trace) as f:
        events = json.load(f)['traceEvents']
    kernels = {e['name'] for e in events if e.get('cat') == 'kernel'}
    assert any('spectrometer' in k for k in kernels), sorted(kernels)


# ---------------------------------------------------------------------------
# capture: the sharded engine into a pinned ring, and the capture chain's K7
# ---------------------------------------------------------------------------

def _chips_packets(nframe, nsrc, pay, f0=0, seed=5):
    """CHIPS packets of frames [f0, f0 + nframe) of every source (wire
    seq f + 1) with seeded payloads; returns (packets, payloads)."""
    from bifrost_tpu_torch.io.packet_formats import ChipsFormat, PacketDesc
    rng = np.random.RandomState(seed)
    data = rng.randint(0, 256, (nframe, nsrc, pay)).astype(np.uint8)
    fmt = ChipsFormat()
    pkts = [fmt.pack(PacketDesc(seq=f0 + f + 1, src=s, nsrc=nsrc, nchan=1,
                                payload=data[f, s].tobytes()))
            for f in range(nframe) for s in range(nsrc)]
    return pkts, data


def _capture_header(shape, dtype, labels, scales):
    def cb(desc):
        return 0, {'name': 'cap', 'time_tag': 0, '_tensor': {
            'shape': [-1] + list(shape), 'dtype': dtype,
            'labels': list(labels), 'scales': scales,
            'units': [None] * (len(shape) + 1)}}
    return cb


class _CaptureGather(object):
    def __init__(self, bt):
        class Sink(bt.SinkBlock):
            def on_sequence(self, iseq):
                self.gulps = []

            def on_data(self, ispan):
                self.gulps.append(np.array(ispan.data.as_numpy(), copy=True))
        self.cls = Sink


def test_sharded_capture_into_a_cuda_host_ring_takes_the_direct_h2d():
    """ShardedUDPCapture (4 workers, zero-copy) into a pinned cuda_host
    ring, then copy('cuda') -> copy('system'): every H2D ships the span
    itself (xfer.h2d_direct once a gulp, nothing staged), held until its
    copy ends, and the bytes are the packets sent."""
    import threading
    import time
    import bifrost_tpu_torch as bt
    from bifrost_tpu_torch import xfer
    from bifrost_tpu_torch.io.packet_capture import ShardedUDPCapture
    from bifrost_tpu_torch.io.udp_socket import Address, UDPSocket
    from bifrost_tpu_torch.telemetry import counters
    nsrc, pay, bt_ = 4, 512, 64
    pkts, data = _chips_packets(4 * bt_, nsrc, pay)
    ring = bt.Ring(space='cuda_host', name='cuda-sharded-capture')
    assert ring._storage.pinned
    cap = ShardedUDPCapture(
        'chips', Address('127.0.0.1', 0), ring, nsrc, 0, pay, bt_, bt_,
        _capture_header([nsrc, pay], 'u8', ['time', 'src', 'byte'],
                        [[0, 1]] * 3),
        nthreads=4, vlen=16, frame_size=16 + pay, timeout=0.25)
    port = cap._socks[0].sock.getsockname()[1]
    xfer.reset_engine()
    counters.reset()
    Sink = _CaptureGather(bt).cls
    box = {}
    with bt.Pipeline() as p:
        sink = Sink(bt.blocks.copy(bt.blocks.copy(ring, space='cuda'),
                                   space='system'))

        def run():
            try:
                p.run()
            except BaseException as exc:
                box['exc'] = exc

        t = threading.Thread(target=run, daemon=True)
        t.start()
        txs = [UDPSocket().connect(Address('127.0.0.1', port))
               for _ in range(nsrc)]
        try:
            # the copy block must hold the ring before it laps
            txs[0].send(pkts[0])
            deadline = time.monotonic() + 60
            while not ring._readers and time.monotonic() < deadline:
                time.sleep(0.01)
            for i, pk in enumerate(pkts[1:], 1):
                txs[i % nsrc].send(pk)
                if i % 64 == 0:
                    time.sleep(0.001)
            while cap.stats['nreceived'] < len(pkts) and \
                    time.monotonic() < deadline:
                time.sleep(0.01)
        finally:
            cap.end()
            for tx in txs:
                tx.close()
        t.join(120)
        assert not t.is_alive()
    if 'exc' in box:
        raise box['exc']
    got = np.concatenate(sink.gulps)
    st = cap.stats
    ngulp = got.shape[0] // bt_
    assert ngulp * bt_ * nsrc * pay == st['ngood_bytes'] + \
        st['nmissing_bytes']
    cells = got.reshape(-1, nsrc, pay)
    same = (cells == data[:cells.shape[0]]).all(axis=-1)
    assert (same | ~cells.any(axis=-1)).all()
    assert counters.get('xfer.h2d_direct') == ngulp
    assert counters.get('xfer.h2d_staged') == 0
    if cap._steered:
        assert sum(w['zero_copy'] for w in cap._wstats) > 0


def test_capture_chain_k7_equals_its_plain_version():
    """The slice's chain at small width on the card from a packet file:
    capture ring (ci4) -> copy('cuda') -> transpose -> merge_axes ->
    correlate(R, int8, K7 forced) -> accumulate(A): K7 once a gulp, and
    the visibilities equal K7's plain version (float64 products) of the
    captured bytes."""
    import io
    import bifrost_tpu_torch as bt
    from bifrost_tpu_torch.io.packet_capture import (
        DiskReader, CAPTURE_NO_DATA, CAPTURE_INTERRUPTED)
    nsrc, nchan, nstand, npol = 2, 8, 16, 2
    pay, g, r, a = nchan * nstand * npol, 32, 32, 2
    pkts, data = _chips_packets(4 * g, nsrc, pay, seed=9)
    ring = bt.Ring(space='system', name='cuda-capture-chain')
    cap = DiskReader('chips', io.BytesIO(b''.join(pkts)), ring, nsrc, 0,
                     pay, g, g, _capture_header(
                         [nsrc, nchan, nstand, npol], 'ci4',
                         ['time', 'src', 'freq', 'stand', 'pol'],
                         [[0, 1], [0, nstand], [0, 1], [0, 1], [0, 1]]))
    for _ in range(100):
        if cap.recv() in (CAPTURE_NO_DATA, CAPTURE_INTERRUPTED):
            break
    cap.end()
    for k in gpu_kernels.launches:
        gpu_kernels.launches[k] = 0
    Sink = _CaptureGather(bt).cls
    with bt.Pipeline() as p:
        b = bt.blocks.copy(ring, space='cuda')
        b = bt.blocks.transpose(b, ['time', 'freq', 'src', 'stand', 'pol'])
        b = bt.views.merge_axes(b, 'src', 'stand', label='station')
        b = bt.blocks.correlate(b, r, accuracy='int8', impl='pallas')
        sink = Sink(bt.blocks.copy(bt.blocks.accumulate(b, a),
                                   space='system'))
        p.run()
    assert gpu_kernels.launches['xcorr_herm'] == 4
    got = np.concatenate(sink.gulps)
    u = torch.from_numpy(data).cuda().view(-1, nsrc, nchan, nstand, npol)
    re = (u.view(torch.int8) >> 4).permute(0, 2, 1, 3, 4)
    im = ((u << 4).view(torch.int8) >> 4).permute(0, 2, 1, 3, 4)
    n = nsrc * nstand * npol
    want = gpu_kernels.xcorr_herm_plain(re.reshape(4, g, nchan, n),
                                        im.reshape(4, g, nchan, n))
    want = want.reshape(2, a, nchan, n, n).sum(dim=1).cpu().numpy()
    assert got.shape == (2, nchan, nsrc * nstand, npol, nsrc * nstand,
                         npol)
    np.testing.assert_array_equal(got.reshape(2, nchan, n, n),
                                  want.astype(np.complex64))


# ---------------------------------------------------------------------------
# the ring bridge on the card's host side
# ---------------------------------------------------------------------------

def _bridge_blocks(bt, gulps):
    """A ci8 source of ``gulps`` (64 frames x 2 pols x 512 channels) and
    a sink that keeps its gulps' int8 bytes."""
    import contextlib

    class Source(bt.SourceBlock):
        def __init__(self):
            super(Source, self).__init__(['x'], 64)
            self.it = iter(gulps)

        def create_reader(self, name):
            return contextlib.nullcontext()

        def on_sequence(self, reader, name):
            return [{'name': 'x', 'time_tag': 0, '_tensor': {
                'shape': [-1, 2, 512], 'dtype': 'ci8',
                'labels': ['time', 'pol', 'chan'], 'scales': [[0, 1]] * 3,
                'units': [None] * 3}}]

        def on_data(self, reader, ospans):
            g = next(self.it, None)
            if g is None:
                return [0]
            ospans[0].data.as_numpy().view(np.int8)[...] = \
                g.reshape(64, 2, 1024)
            return [64]

    class Sink(bt.SinkBlock):
        def __init__(self, iring):
            super(Sink, self).__init__(iring)
            self.out = []

        def on_sequence(self, iseq):
            pass

        def on_data(self, ispan):
            self.out.append(np.array(ispan.data.as_numpy().view(np.int8),
                                     copy=True))

    return Source, Sink


def _run_both(*pipelines, timeout=120):
    import threading
    errors = []

    def run(p):
        try:
            p.run()
        except BaseException as exc:
            errors.append(exc)

    threads = [threading.Thread(target=run, args=(p,), daemon=True)
               for p in pipelines]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    if any(t.is_alive() for t in threads):
        for p in pipelines:
            p.shutdown()
        pytest.fail('bridge pipelines still running after %g s' % timeout)
    if errors:
        raise errors[0]


def test_bridge_into_a_cuda_host_ring_takes_the_direct_h2d():
    """bridge_sink ==TCP==> bridge_source(space='cuda_host') ->
    copy('cuda'): the receiver recv_into's the pinned ring's lanes and
    the H2D reads them in place (xfer.h2d_direct once a gulp, nothing
    staged); the bytes arrive as sent, 4 spans of credit over 2 stripes
    with CRC."""
    import bifrost_tpu_torch as bt
    from bifrost_tpu_torch import xfer
    from bifrost_tpu_torch.telemetry import counters
    rng = np.random.RandomState(34)
    gulps = [rng.randint(-128, 128, (64, 2, 512, 2)).astype(np.int8)
             for _ in range(6)]
    xfer.reset_engine()
    counters.reset()
    Source, Sink = _bridge_blocks(bt, gulps)
    with bt.Pipeline() as prx:
        src = bt.blocks.bridge_source('127.0.0.1', 0, space='cuda_host')
        b = bt.blocks.copy(src, space='cuda')
        sink = Sink(bt.blocks.copy(b, space='system'))
    with bt.Pipeline() as ptx:
        bt.blocks.bridge_sink(Source(), '127.0.0.1', src.port, window=4,
                              nstreams=2, crc=True)
    _run_both(prx, ptx)
    assert src.orings[0]._storage.pinned
    assert counters.get('bridge.rx.spans') == 6
    assert counters.get('bridge.rx.crc_errors') == 0
    assert counters.get('xfer.h2d_direct') == 6
    assert counters.get('xfer.h2d_staged') + \
        counters.get('xfer.h2d_unstaged') == 0
    got = np.concatenate(sink.out)
    np.testing.assert_array_equal(got, np.concatenate(gulps).reshape(
        got.shape))


def test_bridge_sink_behind_an_async_d2h_ships_the_device_bytes():
    """source -> copy('cuda') -> copy('system') (deferred D2H fills) ->
    bridge_sink with 4 spans of credit: each span the sender holds and
    sends carries the device's bytes, so the fills complete before the
    lanes go to sendmsg."""
    import bifrost_tpu_torch as bt
    from bifrost_tpu_torch import xfer
    from bifrost_tpu_torch.telemetry import counters
    rng = np.random.RandomState(35)
    gulps = [rng.randint(-128, 128, (64, 2, 512, 2)).astype(np.int8)
             for _ in range(8)]
    xfer.reset_engine()
    counters.reset()
    Source, Sink = _bridge_blocks(bt, gulps)
    with bt.Pipeline() as prx:
        src = bt.blocks.bridge_source('127.0.0.1', 0)
        sink = Sink(src)
    with bt.Pipeline() as ptx:
        b = bt.blocks.copy(Source(), space='cuda')
        h = bt.blocks.copy(b, space='system')
        bt.blocks.bridge_sink(h, '127.0.0.1', src.port, window=4)
    _run_both(prx, ptx)
    assert counters.get('xfer.d2h_async') == 8
    assert counters.get('bridge.tx.spans') == 8
    got = np.concatenate(sink.out)
    np.testing.assert_array_equal(got, np.concatenate(gulps).reshape(
        got.shape))


# ---------------------------------------------------------------------------
# the auto-tuner and the fleet plane on the card
# ---------------------------------------------------------------------------

def _k1_chain(bt, gulps, hold=None, gulp_batch=None):
    """Two sequences of ci8 gulps (1024 x 2 x 1024) -> copy('cuda') ->
    fused[FFT, Stokes, reduce 4] (K1) -> copy('system') -> sink.  With
    ``hold``, the second sequence begins once ``hold()`` is true (at most
    30 s)."""
    import contextlib
    import time
    from bifrost_tpu_torch.stages import FftStage, DetectStage, ReduceStage

    class Src(bt.SourceBlock):
        def __init__(self):
            super(Src, self).__init__(['a', 'b'], 1024, space='system')

        def create_reader(self, name):
            return contextlib.nullcontext(iter(gulps))

        def on_sequence(self, reader, name):
            if name == 'b' and hold is not None:
                deadline = time.monotonic() + 30
                while not hold() and time.monotonic() < deadline:
                    time.sleep(0.005)
            return [{'name': name, 'time_tag': 0,
                     '_tensor': {'shape': [-1, 2, 1024], 'dtype': 'ci8',
                                 'labels': ['time', 'pol', 'fine_time'],
                                 'scales': [[0, 1]] * 3,
                                 'units': [None] * 3}}]

        def on_data(self, reader, ospans):
            g = next(reader, None)
            if g is None:
                return [0]
            ospans[0].data.as_numpy().view(np.int8)[...] = \
                g.reshape(ospans[0].data.as_numpy().view(np.int8).shape)
            return [1024]

    class Sink(bt.SinkBlock):
        def __init__(self, iring):
            super(Sink, self).__init__(iring)
            self.out = []

        def on_sequence(self, iseq):
            pass

        def on_data(self, ispan):
            self.out.append(np.array(ispan.data.as_numpy(), copy=True))

    with bt.Pipeline(gulp_batch=gulp_batch) as p:
        b = bt.blocks.copy(Src(), space='cuda')
        fb = bt.blocks.fused(b, [FftStage('fine_time', axis_labels='freq'),
                                 DetectStage('stokes', axis='pol'),
                                 ReduceStage('freq', 4)])
        sink = Sink(bt.blocks.copy(fb, space='system'))
    return p, fb, sink


def test_autotune_retunes_gulp_batch_on_a_fused_k1_block(monkeypatch):
    """Pipeline.run(autotune=True) over two sequences: the controller
    doubles gulp_batch during the first, the second runs K1 on K-gulp
    spans (fewer launches than gulps, every one on the radix-16 kernel),
    and the output equals an untuned run's byte for byte."""
    import bifrost_tpu_torch as bt
    from bifrost_tpu_torch.telemetry import counters
    monkeypatch.setenv('BF_AUTOTUNE_INTERVAL', '0.02')
    monkeypatch.setenv('BF_AUTOTUNE_COOLDOWN', '0')
    monkeypatch.setenv('BF_AUTOTUNE_PROFILE', '/nonexistent/profile.json')
    rng = np.random.RandomState(22)
    gulps = [rng.randint(-64, 64, (1024, 2, 1024, 2)).astype(np.int8)
             for _ in range(16)]
    p, fb, sink = _k1_chain(bt, gulps)
    _run_bounded(p)
    plain = np.concatenate(sink.out)
    counters.reset()
    p, fb, sink = _k1_chain(
        bt, gulps, hold=lambda: counters.get('autotune.gulp_batch') > 1)
    before = dict(spec.launches_by_path)
    nlaunch = spec.launches

    class Tuned(object):
        def __init__(self, p):
            self.p = p

        def run(self):
            return self.p.run(autotune=True)

        def shutdown(self):
            self.p.shutdown()
    _run_bounded(Tuned(p))
    launches = spec.launches - nlaunch
    assert counters.get('autotune.retunes') >= 1
    assert counters.get('autotune.gulp_batch') > 1
    assert launches - fb.prewarm_runs < 2 * len(gulps)   # two sequences
    assert spec.launches_by_path['radix16'] - before['radix16'] == launches
    np.testing.assert_array_equal(np.concatenate(sink.out), plain)


def test_fleet_full_snapshot_carries_the_card_memory_section():
    """A fleet publisher's full snapshot carries the exporter's device
    section from torch's allocator once CUDA is in use; its collector
    keeps it on the host's rollup entry."""
    from bifrost_tpu_torch.telemetry import fleet
    x = torch.empty(1 << 24, dtype=torch.uint8, device='cuda')
    coll = fleet.FleetCollector(rules=[])
    pub = fleet.FleetPublisher(collector=('127.0.0.1', coll.port),
                               host='card', interval=0.1)
    sent = []
    pub._send = sent.append
    try:
        pub.publish(full=True)
        for msg in sent:
            coll._handle(msg, ('127.0.0.1', 1))
        dev = sent[0]['devices'][str(torch.cuda.current_device())]
        assert dev['platform'] == 'cuda'
        assert dev['bytes_in_use'] >= x.numel()
        assert 0 < dev['bytes_free'] <= dev['bytes_limit']
        assert coll.rollup()['hosts']['card']['devices'] == \
            sent[0]['devices']
    finally:
        pub._sock.close()
        coll._sock.close()


def test_service_tenants_share_the_default_stream_and_one_engine(tmp_path):
    """By design: the service's tenants share the process's CUDA context,
    its default stream and its transfer engine.  Two tenants replaying
    one recording through copy('cuda') -> fused K1 -> copy('system')
    record, from their own sink threads, the same current stream (the
    default) and the same engine, and deliver the same bytes as K1 on
    the recorded gulps."""
    import contextlib
    import bifrost_tpu_torch as bt
    from bifrost_tpu_torch import service, xfer
    from bifrost_tpu_torch.stages import FftStage, DetectStage, ReduceStage
    rng = np.random.RandomState(31)
    gulps = [rng.randint(-64, 64, (1024, 2, 1024, 2)).astype(np.int8)
             for _ in range(3)]

    class Src(bt.SourceBlock):
        def __init__(self):
            super(Src, self).__init__(['rec'], 1024, space='system')
            self.n = 0

        def create_reader(self, name):
            return contextlib.nullcontext()

        def on_sequence(self, reader, name):
            return [{'name': 'rec', 'time_tag': 0,
                     '_tensor': {'shape': [-1, 2, 1024], 'dtype': 'ci8',
                                 'labels': ['time', 'pol', 'fine_time'],
                                 'scales': [[0, 1]] * 3,
                                 'units': [None] * 3}}]

        def on_data(self, reader, ospans):
            if self.n == len(gulps):
                return [0]
            dst = ospans[0].data.as_numpy().view(np.int8)
            dst[...] = gulps[self.n].reshape(dst.shape)
            self.n += 1
            return [1024]

    with bt.Pipeline() as p:
        bt.blocks.serialize(Src(), path=str(tmp_path))
    _run_bounded(p)
    seen = {}

    class Sink(bt.SinkBlock):
        def __init__(self, iring, tid):
            super(Sink, self).__init__(iring)
            self.tid, self.out = tid, []

        def on_sequence(self, iseq):
            seen[self.tid] = (torch.cuda.current_stream().cuda_stream,
                              xfer.engine())

        def on_data(self, ispan):
            self.out.append(np.array(ispan.data.as_numpy(), copy=True))

    sinks = {}

    def build(tid):
        def b(gate):
            fb = bt.blocks.fused(bt.blocks.copy(gate, space='cuda'), [
                FftStage('fine_time', axis_labels='freq'),
                DetectStage('stokes', axis='pol'), ReduceStage('freq', 4)])
            sinks[tid] = Sink(bt.blocks.copy(fb, space='system'), tid)
        return b
    service.reset_registry()
    mgr = service.JobManager(max_tenants=2, warm=False)
    for tid in ('t0', 't1'):
        mgr.submit(service.TenantSpec(tid, gulp_nframe=1024, source={
            'kind': 'replay', 'basenames': [str(tmp_path / 'rec')],
            'gulp_nframe': 1024}), build(tid))
    mgr.start()
    assert mgr.wait(120) == {'t0': 'DONE', 't1': 'DONE'}
    assert seen['t0'] == seen['t1']
    assert seen['t0'][0] == torch.cuda.default_stream().cuda_stream
    assert seen['t0'][1] is xfer.engine()
    for tid in ('t0', 't1'):
        assert len(sinks[tid].out) == len(gulps)
        for got, g in zip(sinks[tid].out, gulps):
            want = spec.fused_spectrometer(torch.from_numpy(g).cuda(),
                                           rfactor=4).cpu().numpy()
            assert got.tobytes() == want.tobytes()


# ---------------------------------------------------------------------------
# the mesh tier's frame-local plans, 4 ranks on one card
# ---------------------------------------------------------------------------

def _k1_mesh_chain(mesh, k=1, first='system', ngulp=8, T=1024, nfft=1024):
    """source (``first`` space) -> [mesh] copy('cuda') -> fused[FFT,
    Stokes, reduce(4)] (K1) -> copy('system') -> sink; returns (the
    output bytes, K1 launches, the fused block, counters)."""
    import contextlib
    import bifrost_tpu_torch as bt
    from bifrost_tpu_torch.stages import FftStage, DetectStage, ReduceStage
    from bifrost_tpu_torch.telemetry import counters
    rng = np.random.RandomState(71)
    gulps = [rng.randint(-128, 128, (T, 2, nfft, 2)).astype(np.int8)
             for _ in range(ngulp)]

    class Source(bt.SourceBlock):
        def __init__(self):
            super(Source, self).__init__(['k1'], T, space=first)
            self.it = iter(gulps)

        def create_reader(self, name):
            return contextlib.nullcontext()

        def on_sequence(self, reader, name):
            return [{'name': 'k1', 'time_tag': 0, '_tensor': {
                'shape': [-1, 2, nfft], 'dtype': 'ci8',
                'labels': ['time', 'pol', 'fine_time'],
                'scales': [[0, 1]] * 3, 'units': [None] * 3}}]

        def on_data(self, reader, ospans):
            g = next(self.it, None)
            if g is None:
                return [0]
            dst = ospans[0].data.as_numpy().view(np.int8)
            dst[...] = g.reshape(dst.shape)
            return [T]

    class Sink(bt.SinkBlock):
        def __init__(self, iring):
            super(Sink, self).__init__(iring)
            self.out = []

        def on_sequence(self, iseq):
            pass

        def on_data(self, ispan):
            self.out.append(np.array(ispan.data.as_numpy(), copy=True))

    counters.reset()
    n0 = spec.launches
    with bt.Pipeline(gulp_batch=k) as p:
        src = Source()
        with bt.block_scope(mesh=mesh):
            b = bt.blocks.copy(src, space='cuda')
            fb = bt.blocks.fused(b, [
                FftStage('fine_time', axis_labels='freq'),
                DetectStage('stokes', axis='pol'), ReduceStage('freq', 4)])
        sink = Sink(bt.blocks.copy(fb, space='system'))
    _run_bounded(p)
    return (np.concatenate(sink.out), spec.launches - n0, fb,
            counters.snapshot())


@pytest.mark.parametrize('k', [1, 4])
def test_mesh_frame_local_k1_plan_equals_single_rank(k):
    """The K1 chain under {'sp': 4} on one card: each rank launches K1 on
    its shard (4 launches a dispatch, prewarm runs included), no
    collective runs, and the bytes equal the single-rank run's."""
    from bifrost_tpu_torch import parallel
    base, n1, _fb, _s = _k1_mesh_chain(None)
    mesh = parallel.create_mesh({'sp': 4}, devices=['cuda:0'] * 4)
    since = parallel.collective_counts()
    got, n4, fb, snap = _k1_mesh_chain(mesh, k=k)
    assert got.tobytes() == base.tobytes()
    assert parallel.collective_counts(since) == {}
    assert fb.impl_info['impl'] == 'cuda-spectrometer'
    assert fb.impl_info['mesh'] == 'shard_map[4]'
    assert n4 == 4 * (8 // k + fb.prewarm_runs)
    assert snap.get('mesh.sharded_commits') == 2 * 8 // k


def test_mesh_sharded_h2d_from_cuda_host_equals_single_rank():
    """A pinned cuda_host source feeds the mesh's H2D copy: each rank's
    frames are copied straight from the pinned span (no staging), and the
    K1 chain's bytes equal the single-rank run's."""
    from bifrost_tpu_torch import parallel, xfer
    base, _n, _fb, _s = _k1_mesh_chain(None)
    xfer.reset_engine()
    mesh = parallel.create_mesh({'sp': 4}, devices=['cuda:0'] * 4)
    got, n4, fb, snap = _k1_mesh_chain(mesh, first='cuda_host')
    assert got.tobytes() == base.tobytes()
    assert snap.get('xfer.h2d_sharded') == 8
    assert snap.get('xfer.h2d_direct') == 8 * 4
    assert snap.get('xfer.h2d_staged', 0) + \
        snap.get('xfer.h2d_unstaged', 0) == 0
    assert n4 == 4 * (8 + fb.prewarm_runs)


# ---------------------------------------------------------------------------
# the runtime surface: auto-fusion and force_completion
# ---------------------------------------------------------------------------

def _flagship_chain(auto_fuse, explicit, gulps):
    """source -> copy('cuda') -> fft -> detect('stokes') -> reduce('freq',
    4) -> copy('system') -> sink on ``gulps`` of (1024, 2, 4096) ci8, as
    three stage blocks (under ``auto_fuse``) or one ``blocks.fused``
    block; returns (output bytes, K1 launches, pipeline)."""
    import contextlib
    import bifrost_tpu_torch as bt
    from bifrost_tpu_torch.stages import FftStage, DetectStage, ReduceStage
    nt, nfft = gulps[0].shape[0], gulps[0].shape[2]

    class Src(bt.SourceBlock):
        def __init__(self):
            super(Src, self).__init__(['v'], nt, space='system')

        def create_reader(self, name):
            return contextlib.nullcontext(iter(gulps))

        def on_sequence(self, reader, name):
            return [{'name': 'v', 'time_tag': 0,
                     '_tensor': {'shape': [-1, 2, nfft], 'dtype': 'ci8',
                                 'labels': ['time', 'pol', 'fine_time'],
                                 'scales': [[0, 1]] * 3,
                                 'units': [None] * 3}}]

        def on_data(self, reader, ospans):
            g = next(reader, None)
            if g is None:
                return [0]
            dst = ospans[0].data.as_numpy().view(np.int8)
            dst[...] = g.reshape(dst.shape)
            return [nt]

    class Sink(bt.SinkBlock):
        def __init__(self, iring):
            super(Sink, self).__init__(iring)
            self.out = []

        def on_sequence(self, iseq):
            pass

        def on_data(self, ispan):
            self.out.append(np.array(ispan.data.as_numpy(), copy=True))

    with bt.Pipeline(auto_fuse=auto_fuse) as p:
        b = bt.blocks.copy(Src(), space='cuda')
        if explicit:
            b = bt.blocks.fused(b, [FftStage('fine_time', axis_labels='freq'),
                                    DetectStage('stokes', axis='pol'),
                                    ReduceStage('freq', 4)])
        else:
            b = bt.blocks.fft(b, axes='fine_time', axis_labels='freq')
            b = bt.blocks.detect(b, mode='stokes')
            b = bt.blocks.reduce(b, 'freq', 4)
        sink = Sink(bt.blocks.copy(b, space='system'))
    before = spec.launches
    _run_bounded(p, timeout=120)
    return np.concatenate(sink.out).tobytes(), spec.launches - before, p


def test_auto_fused_flagship_chain_launches_k1_as_the_explicit_block():
    """``Pipeline(auto_fuse=True)`` over the three stage blocks leaves one
    AutoFused_x3 block that launches K1 once a gulp and once to prewarm,
    and its output is byte for byte the explicit ``fused`` chain's."""
    rng = np.random.RandomState(25)
    gulps = [rng.randint(-64, 64, (1024, 2, 4096, 2)).astype(np.int8)
             for _ in range(3)]
    fused, n_fused, p = _flagship_chain(True, False, gulps)
    want, n_explicit, _ = _flagship_chain(False, True, gulps)
    auto = [b for b in p.blocks
            if b.name.split('/')[-1].startswith('AutoFused_x3_')]
    assert len(auto) == 1 and len(p.blocks) == 5
    assert auto[0].impl_info['impl'] == 'cuda-spectrometer'
    assert auto[0].impl_info['kernel'] == 'cuda'
    assert n_fused == 3 + auto[0].prewarm_runs == n_explicit
    assert fused == want


def test_force_completion_waits_on_a_kernels_tensor():
    """``force_completion`` returns only once the kernel writing its
    tensor has completed: an event recorded just after the launch has
    completed by then, with no readback."""
    x = torch.zeros(1, device='cuda')
    torch.cuda._sleep(1000)                # load both kernels first
    y = x + 1
    torch.cuda.synchronize()
    torch.cuda._sleep(int(1e9))            # ~0.5 s of spinning
    y = x + 1
    done = torch.cuda.Event()
    done.record()
    assert not done.query()
    device.force_completion(y)
    assert done.query()
    assert float(y.cpu()[0]) == 1.0
