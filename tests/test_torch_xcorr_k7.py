"""K7's arithmetic and the launch path shared by every kernel wrapper, on
the CPU.

K7 (``bifrost_tpu_torch/csrc/xcorr.cu``) runs the Hermitian int8 X step
on the int8 tensor cores: time is the contraction axis of an s8 x s8 ->
s32 product that wraps, with two accumulators an output,

    vr = [re | im] . [re | im]^T
    vi = [im | re] . [re | ~im]^T, started at R_a = sum_t re_a,

over frames zero-padded to a multiple of 32.  ``~im = -im - 1`` is an
int8 for every int8 value, so ``vi = sum_t (im_a re_b - re_a im_b)``
exactly, -128 included.  :func:`k7_model` below is that arithmetic in
torch, step for step; it is held bit for bit to the JAX package's
``pallas_kernels.xcorr_herm`` in interpret mode and to the int64 oracle,
at the int8 extremes and at T = MAX_NTIME, and the two traps of the
design (a missing R_a start, padding that is not zero) are shown to
change the result.  The kernel itself runs on the card
(tests/test_torch_cuda.py, chip_smoke.py).

The launch path: every wrapper binds its C entry once
(``_build.bind``; tested here with a fake library in place of
``_build.load``), reads the caller's current stream on every launch
(``_build.stream_ptr``) and picks K7's staging from the layout
(``gpu_kernels.xcorr_staging``).

Tolerances: none; every comparison is exact.
"""

import numpy as np
import pytest
import torch

from bifrost_tpu.ops import pallas_kernels as pk

from bifrost_tpu_torch import _build, device
from bifrost_tpu_torch.ops import gpu_kernels


@pytest.fixture(autouse=True)
def _cpu():
    device.set_device('cpu')


def _wrap(v):
    """The int32 an int64 tensor wraps to (two's complement)."""
    return (v + 2 ** 31) % 2 ** 32 - 2 ** 31


def k7_model(re, im, mutant=None):
    """K7's arithmetic on (T, F, n) int8 planes -> (F, n, n) complex64.

    Frames are padded to a multiple of 32 with zeros (``mutant='pad'``:
    with ~0); the s32 accumulators wrap after every 32-frame step, as an
    m16n8k32 product's do; vi starts at R_a, the sum of re over the
    staged frames (``mutant='no_ra'``: at 0)."""
    T, F, n = re.shape
    tpad = -(-T // 32) * 32
    fill = -1 if mutant == 'pad' else 0          # ~0 as an int8
    r = torch.full((tpad, F, n), fill, dtype=torch.int8)
    i = torch.full((tpad, F, n), fill, dtype=torch.int8)
    r[:T], i[:T] = re, im
    ni = torch.bitwise_not(i)                    # -im - 1, an int8 always
    assert ni.dtype == torch.int8
    r64, i64, ni64 = (v.to(torch.int64) for v in (r, i, ni))
    dot = lambda x, y: torch.einsum('tfa,tfb->fab', x, y)
    vr = torch.zeros((F, n, n), dtype=torch.int64)
    vi = torch.zeros((F, n, n), dtype=torch.int64)
    if mutant != 'no_ra':
        vi += r64.sum(0)[:, :, None]
    for k in range(0, tpad, 32):
        s = slice(k, k + 32)
        # [re | im] . [re | im] and [im | re] . [re | ~im] over 32 frames
        vr = _wrap(vr + dot(r64[s], r64[s]) + dot(i64[s], i64[s]))
        vi = _wrap(vi + dot(i64[s], r64[s]) + dot(r64[s], ni64[s]))
    return torch.complex(vr.to(torch.float32), vi.to(torch.float32))


def _oracle(re, im):
    """int64 oracle over (T, F, n) -> complex64 (the int64 -> float32 cast
    rounds as the kernel's __int2float_rn does)."""
    r, i = re.astype(np.int64), im.astype(np.int64)
    dot = lambda x, y: np.einsum('tfa,tfb->fab', x, y)
    return (dot(r, r) + dot(i, i)).astype(np.float32) + \
        1j * (dot(i, r) - dot(r, i)).astype(np.float32)


def _values(pattern, shape, rng):
    if pattern == 'random':
        return rng.randint(-128, 128, size=shape).astype(np.int8)
    if pattern == 'mixed':
        return rng.choice([-128, -127, 127], size=shape).astype(np.int8)
    return np.full(shape, int(pattern), np.int8)


#: (T, F, n) of the model cases: tails of 1 and 31 frames, none, ragged n
_K7_SHAPES = [(1, 2, 3), (31, 2, 5), (32, 1, 8), (33, 2, 7), (70, 3, 9)]


@pytest.mark.parametrize('pattern', ['random', '-128', '127', 'mixed'])
@pytest.mark.parametrize('T,F,n', _K7_SHAPES)
def test_k7_model_equals_pallas_and_oracle(T, F, n, pattern):
    """The model of K7's tensor-core arithmetic is bit-identical to the JAX
    kernel in interpret mode, the int64 oracle and the port's plain
    version, for random planes and at the int8 extremes."""
    rng = np.random.RandomState(T * 7 + n)
    re, im = _values(pattern, (T, F, n), rng), _values(pattern, (T, F, n),
                                                       rng)
    got = k7_model(torch.from_numpy(re), torch.from_numpy(im)).numpy()
    np.testing.assert_array_equal(got, _oracle(re, im))
    np.testing.assert_array_equal(
        got, np.asarray(pk.xcorr_herm(re, im, interpret=True)))
    np.testing.assert_array_equal(
        got, gpu_kernels.xcorr_herm(torch.from_numpy(re),
                                    torch.from_numpy(im)).numpy())


@pytest.mark.parametrize('pattern', ['-128', 'mixed'])
def test_k7_model_exact_at_the_int32_edge(pattern):
    """T = MAX_NTIME: every -128 gives re = 2 T 128^2 = 2,147,450,880,
    just below 2^31, on every output; the model's wrapping s32 sums give
    the exact values, equal to the JAX kernel and the int64 oracle."""
    T, F, n = gpu_kernels.MAX_NTIME, 2, 3
    rng = np.random.RandomState(5)
    re, im = _values(pattern, (T, F, n), rng), _values(pattern, (T, F, n),
                                                       rng)
    got = k7_model(torch.from_numpy(re), torch.from_numpy(im)).numpy()
    np.testing.assert_array_equal(got, _oracle(re, im))
    np.testing.assert_array_equal(
        got, np.asarray(pk.xcorr_herm(re, im, interpret=True)))
    if pattern == '-128':
        assert (got.real == np.float32(2 * T * 128 * 128)).all()
        assert (got.imag == 0).all()


@pytest.mark.parametrize('mutant', ['no_ra', 'pad'])
def test_k7_model_traps_change_the_result(mutant):
    """The two traps of the design are real: without the R_a start vi
    misses -sum re_a, and a tail padded with ~0 adds (-1)(-1) + (-1)(-1)
    to vr for every padded frame; both differ from the oracle (what the
    chip smoke run's mutants of the kernel show on the card)."""
    T, F, n = 33, 2, 5
    rng = np.random.RandomState(9)
    re, im = _values('random', (T, F, n), rng), _values('random', (T, F, n),
                                                        rng)
    got = k7_model(torch.from_numpy(re), torch.from_numpy(im), mutant)
    assert not np.array_equal(got.numpy(), _oracle(re, im))


def test_k7_staging_path_follows_the_layout():
    """K7 takes its 16-byte staging only for the interleaved re and im
    views of a ci8 gulp whose rows sit on 16 bytes with n * 2 a multiple
    of 16 (one pol or two, with or without the group axis); separate
    planes, odd n, odd strides and a view off 16 bytes take the scalar
    staging."""
    x = torch.zeros((8, 2, 8, 2, 2), dtype=torch.int8)     # T F S P 2
    re, im = x[..., 0].reshape(8, 2, 16), x[..., 1].reshape(8, 2, 16)
    assert gpu_kernels.xcorr_staging(re, im) == \
        int(x.data_ptr() % 16 == 0)
    if x.data_ptr() % 16 == 0:
        grouped = (x[..., 0].reshape(2, 4, 2, 16),
                   x[..., 1].reshape(2, 4, 2, 16))
        assert gpu_kernels.xcorr_staging(*grouped) == 1
        one = torch.zeros((8, 2, 8, 1, 2), dtype=torch.int8)
        assert gpu_kernels.xcorr_staging(one[..., 0, 0], one[..., 0, 1]) == \
            int(one.data_ptr() % 16 == 0)
        # a frame offset keeps the rows on 16 bytes; an input offset not
        assert gpu_kernels.xcorr_staging(re[1:], im[1:]) == 1
        assert gpu_kernels.xcorr_staging(re[..., 1:9], im[..., 1:9]) == 0
    odd = torch.zeros((8, 2, 7, 1, 2), dtype=torch.int8)
    assert gpu_kernels.xcorr_staging(odd[..., 0, 0], odd[..., 0, 1]) == 0
    planes = torch.zeros((8, 2, 16), dtype=torch.int8)
    assert gpu_kernels.xcorr_staging(planes, planes.clone()) == 0
    wide = torch.zeros((8, 2, 48), dtype=torch.int8)
    assert gpu_kernels.xcorr_staging(wide[..., ::3], wide[..., 1::3]) == 0


class _FakeFn:
    """A ctypes function stand-in that counts its argtypes assignments."""

    def __init__(self, name):
        self.name = name
        self.sets = 0
        self._argtypes = None

    @property
    def argtypes(self):
        return self._argtypes

    @argtypes.setter
    def argtypes(self, value):
        self.sets += 1
        self._argtypes = tuple(value)


class _FakeLib:
    def __init__(self, name):
        self.name = name
        self.fns = {}

    def __getattr__(self, fn_name):
        if fn_name.startswith('bf_'):
            return self.fns.setdefault(fn_name, _FakeFn(fn_name))
        raise AttributeError(fn_name)


@pytest.fixture
def fake_libs(monkeypatch):
    libs, loads = {}, []

    def load(name):
        loads.append(name)
        return libs.setdefault(name, _FakeLib(name))
    monkeypatch.setattr(_build, 'load', load)
    monkeypatch.setattr(_build, '_bound', {})
    return libs, loads


def test_bind_sets_argtypes_once_per_entry(fake_libs):
    """A C entry is bound at its first use: argtypes and restype set once,
    the library looked up once; later binds return the same function."""
    libs, loads = fake_libs
    types = gpu_kernels._HERM_ARGS
    lib, fn = _build.bind('xcorr', 'bf_xcorr_herm', types)
    for _ in range(5):
        again = _build.bind('xcorr', 'bf_xcorr_herm', types)
        assert again[0] is lib and again[1] is fn
    assert fn.sets == 1 and fn.argtypes == tuple(types)
    assert fn.restype is _build.ctypes.c_int
    assert loads == ['xcorr']


def test_bind_keeps_distinct_entries_apart(fake_libs):
    """Entries of one library and entries of the same name in two
    libraries are bound separately, each with its own argtypes."""
    libs, loads = fake_libs
    herm = _build.bind('xcorr', 'bf_xcorr_herm', gpu_kernels._HERM_ARGS)[1]
    cross = _build.bind('xcorr', 'bf_xcorr_cross', gpu_kernels._CROSS_ARGS)[1]
    probe = _build.bind('probe', 'bf_probe', gpu_kernels._PROBE_ARGS)[1]
    other = _build.bind('stokes', 'bf_probe', gpu_kernels._STOKES_ARGS)[1]
    assert len({id(f) for f in (herm, cross, probe, other)}) == 4
    assert herm.argtypes == tuple(gpu_kernels._HERM_ARGS)
    assert cross.argtypes == tuple(gpu_kernels._CROSS_ARGS)
    assert probe.argtypes == tuple(gpu_kernels._PROBE_ARGS)
    assert other.argtypes == tuple(gpu_kernels._STOKES_ARGS)
    assert all(f.sets == 1 for f in (herm, cross, probe, other))
    assert sorted(_build._bound) == [('probe', 'bf_probe'),
                                     ('stokes', 'bf_probe'),
                                     ('xcorr', 'bf_xcorr_cross'),
                                     ('xcorr', 'bf_xcorr_herm')]


def test_wrappers_bind_through_the_cache(fake_libs):
    """gpu_kernels._fn, which every wrapper calls, is the cached binding."""
    libs, loads = fake_libs
    a = gpu_kernels._fn('beamform', 'bf_beamform_int8',
                        gpu_kernels._INT8_ARGS)
    b = gpu_kernels._fn('beamform', 'bf_beamform_int8',
                        gpu_kernels._INT8_ARGS)
    assert a == b and a[1].sets == 1 and loads == ['beamform']


def test_argtypes_cover_each_c_entry():
    """Pointers and the stream go as void pointers, counts as int and
    strides as long long: the shapes of the C entries' parameter lists."""
    c = _build.ctypes
    assert gpu_kernels._HERM_ARGS == [c.c_void_p] * 3 + [c.c_int] * 5 + \
        [c.c_longlong] * 4 + [c.c_void_p]
    assert gpu_kernels._CROSS_ARGS == [c.c_void_p] * 5 + [c.c_int] * 5 + \
        [c.c_longlong] * 8 + [c.c_void_p]
    assert gpu_kernels._PROBE_ARGS == [c.c_void_p, c.c_void_p, c.c_int,
                                       c.c_void_p]


def test_stream_ptr_reads_the_current_stream_each_call(monkeypatch):
    """The stream handle comes from torch's raw current-stream call where
    the CUDA build has one, for the tensor's device index, read anew on
    every launch: a stream made current between two launches is the one
    the second launch gets."""
    current = {'stream': 111}
    seen = []

    def raw(index):
        seen.append(index)
        return current['stream']
    monkeypatch.setattr(torch._C, '_cuda_getCurrentRawStream', raw,
                        raising=False)
    monkeypatch.setattr(_build, '_raw_stream', None)
    dev = torch.device('cuda', 3)
    assert _build.stream_ptr(dev) == 111
    current['stream'] = 222
    assert _build.stream_ptr(dev) == 222
    assert seen == [3, 3]


def test_stream_ptr_without_the_raw_call(monkeypatch):
    """Where torch has no raw current-stream call, the handle is the
    current ``torch.cuda.Stream``'s, still read on every call."""
    handles = iter([5, 6])

    class _Stream:
        def __init__(self):
            self.cuda_stream = next(handles)
    monkeypatch.delattr(torch._C, '_cuda_getCurrentRawStream',
                        raising=False)
    monkeypatch.setattr(torch.cuda, 'current_stream',
                        lambda index: _Stream())
    monkeypatch.setattr(_build, '_raw_stream', None)
    dev = torch.device('cuda', 0)
    assert _build.stream_ptr(dev) == 5
    assert _build.stream_ptr(dev) == 6
