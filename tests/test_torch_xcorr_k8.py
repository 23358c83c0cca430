"""K8's arithmetic, job walk and plan, on the CPU.

K8 (``bifrost_tpu_torch/csrc/xcorr.cu``, ``xcorr_kernel<false>``) is K7's
exact int8 tensor-core correlator on a rectangle: rows are the inputs a
of x_i, columns the inputs b of x_j, and time is the contraction axis of
an s8 x s8 -> s32 product that wraps, with two accumulators an output,

    vr = [re_i | im_i] . [re_j | im_j]^T
    vi = [im_i | re_i] . [re_j | ~im_j]^T + R_a,   R_a = sum_t re_i[a],

over frames and inputs zero-padded to multiples of 32 and 64.
``~im = -im - 1`` is an int8 for every int8 value, so ``vi = sum_t
(im_a re_b - re_a im_b)`` exactly, -128 included.  :func:`k8_model` is
that arithmetic in torch, step for step; it is held bit for bit to the
JAX package's ``pallas_kernels.xcorr_cross`` in interpret mode and to
the int64 oracle, at the int8 extremes, on ragged shapes and at T =
MAX_NTIME, and the traps of the design (no R_a, padding that is not
zero, R taken from the columns, which K7's single operand could never
show) are shown to change the result.

The job walk: :func:`compute_side` and :func:`store_side` follow the
kernel's compute warps (row block and column blocks staged as cp.async
groups, each tile started once its groups are in; or one tile a job in
frame chunks through two buffers) and its store warps.  Both must visit
the same tiles in the same order, and every output element must be
written exactly once, with no mirror.  ``xcorr_cross_plan`` decides the
path, which is pinned at the port's shapes.  The kernel itself runs on
the card (tests/test_torch_cuda.py, chip_smoke.py).

Tolerances: none; every comparison is exact.
"""

import os

import numpy as np
import pytest
import torch

from bifrost_tpu.ops import pallas_kernels as pk

from bifrost_tpu_torch import device
from bifrost_tpu_torch.ops import gpu_kernels

SOURCE = os.path.join(os.path.dirname(gpu_kernels.__file__), '..', 'csrc',
                      'xcorr.cu')

#: shared memory a block may opt in to on the H100
H100_SMEM = 232448


@pytest.fixture(autouse=True)
def _cpu():
    device.set_device('cpu')


def _wrap(v):
    """The int32 an int64 tensor wraps to (two's complement)."""
    return (v + 2 ** 31) % 2 ** 32 - 2 ** 31


def _cdiv(a, b):
    return -(-a // b)


def _pad(x, T, n, fill):
    out = torch.full((T, x.shape[1], n), fill, dtype=torch.int8)
    out[:x.shape[0], :, :x.shape[2]] = x
    return out


def k8_model(re_i, im_i, re_j, im_j, mutant=None):
    """K8's arithmetic on (T, F, n_i) and (T, F, n_j) int8 planes ->
    (F, n_i, n_j) complex64.

    Frames are padded to a multiple of 32 and inputs to a multiple of 64
    with zeros (``mutant='pad'``: with ~0); the s32 accumulators wrap
    after every 32-frame step, as an m16n8k32 product's do; R, summed
    step by step from the rows (``mutant='ra_from_columns'``: from the
    columns), is added to vi at the end (``mutant='no_ra'``: not)."""
    T, F, ni = re_i.shape
    nj = re_j.shape[-1]
    tpad = _cdiv(T, 32) * 32
    fill = -1 if mutant == 'pad' else 0          # ~0 as an int8
    pi, pj = _cdiv(ni, 64) * 64, _cdiv(nj, 64) * 64
    ri, ii = (_pad(v, tpad, pi, fill) for v in (re_i, im_i))
    rj, ij = (_pad(v, tpad, pj, fill) for v in (re_j, im_j))
    nij = torch.bitwise_not(ij)                  # -im - 1, an int8 always
    assert nij.dtype == torch.int8
    ri, ii, rj, ij, nij = (v.to(torch.int64) for v in (ri, ii, rj, ij, nij))
    dot = lambda x, y: torch.einsum('tfa,tfb->fab', x, y)
    vr = torch.zeros((F, pi, pj), dtype=torch.int64)
    vi = torch.zeros((F, pi, pj), dtype=torch.int64)
    rows = mutant != 'ra_from_columns'
    racc = torch.zeros((F, pi if rows else pj), dtype=torch.int64)
    for k in range(0, tpad, 32):
        s = slice(k, k + 32)
        # [re | im] . [re | im] and [im | re] . [re | ~im] over 32 frames,
        # and R: re against a column of ones
        vr = _wrap(vr + dot(ri[s], rj[s]) + dot(ii[s], ij[s]))
        vi = _wrap(vi + dot(ii[s], rj[s]) + dot(ri[s], nij[s]))
        racc = _wrap(racc + (ri[s] if rows else rj[s]).sum(0))
    if mutant != 'no_ra':
        vi = _wrap(vi + (racc[:, :, None] if rows else racc[:, None, :]))
    vr, vi = vr[:, :ni, :nj], vi[:, :ni, :nj]
    return torch.complex(vr.to(torch.float32), vi.to(torch.float32))


def _oracle(re_i, im_i, re_j, im_j):
    """int64 oracle over (T, F, n) planes -> complex64 (the int64 ->
    float32 cast rounds as the kernel's __int2float_rn does)."""
    ri, ii, rj, ij = (v.astype(np.int64) for v in (re_i, im_i, re_j, im_j))
    dot = lambda x, y: np.einsum('tfa,tfb->fab', x, y)
    return (dot(ri, rj) + dot(ii, ij)).astype(np.float32) + \
        1j * (dot(ii, rj) - dot(ri, ij)).astype(np.float32)


def _values(pattern, shape, rng):
    if pattern == 'random':
        return rng.randint(-128, 128, size=shape).astype(np.int8)
    if pattern == 'mixed':
        return rng.choice([-128, -127, 127], size=shape).astype(np.int8)
    return np.full(shape, int(pattern), np.int8)


def _operands(pattern, T, F, ni, nj, seed):
    rng = np.random.RandomState(seed)
    return [_values(pattern, (T, F, n), rng) for n in (ni, ni, nj, nj)]


#: (T, F, n_i, n_j) of the model cases: tails of 1 and 31 frames and none,
#: n_i != n_j, n_i or n_j of 1, ragged 64-input blocks
_K8_SHAPES = [(1, 2, 3, 5), (31, 2, 1, 9), (33, 2, 7, 1), (32, 1, 8, 70),
              (65, 3, 70, 9), (63, 2, 65, 64)]


@pytest.mark.parametrize('pattern', ['random', '-128', '127', 'mixed'])
@pytest.mark.parametrize('T,F,ni,nj', _K8_SHAPES)
def test_k8_model_equals_pallas_and_oracle(T, F, ni, nj, pattern):
    """The model of K8's tensor-core arithmetic is bit-identical to the JAX
    kernel in interpret mode, the int64 oracle and the port's plain
    version, for random planes and at the int8 extremes."""
    ops = _operands(pattern, T, F, ni, nj, T * 7 + ni * 3 + nj)
    got = k8_model(*(torch.from_numpy(v) for v in ops)).numpy()
    assert got.shape == (F, ni, nj)
    np.testing.assert_array_equal(got, _oracle(*ops))
    np.testing.assert_array_equal(
        got, np.asarray(pk.xcorr_cross(*ops, interpret=True)))
    np.testing.assert_array_equal(
        got, gpu_kernels.xcorr_cross(*(torch.from_numpy(v)
                                       for v in ops)).numpy())


@pytest.mark.parametrize('pattern', ['-128', 'mixed'])
def test_k8_model_exact_at_the_int32_edge(pattern):
    """T = MAX_NTIME: every -128 gives re = 2 T 128^2 = 2,147,450,880,
    just below 2^31, on every output; the model's wrapping s32 sums give
    the exact values, equal to the JAX kernel and the int64 oracle."""
    T, F, ni, nj = gpu_kernels.MAX_NTIME, 2, 3, 5
    ops = _operands(pattern, T, F, ni, nj, 5)
    got = k8_model(*(torch.from_numpy(v) for v in ops)).numpy()
    np.testing.assert_array_equal(got, _oracle(*ops))
    np.testing.assert_array_equal(
        got, np.asarray(pk.xcorr_cross(*ops, interpret=True)))
    if pattern == '-128':
        assert (got.real == np.float32(2 * T * 128 * 128)).all()
        assert (got.imag == 0).all()


@pytest.mark.parametrize('T,F,ni,nj', _K8_SHAPES)
@pytest.mark.parametrize('mutant', ['no_ra', 'pad', 'ra_from_columns'])
def test_k8_model_traps_change_the_result(mutant, T, F, ni, nj):
    """The traps of the design are real at every model shape: without R_a
    vi misses -sum re_a; a tail padded with ~0 adds (-1)(-1) + (-1)(-1)
    to vr for every padded frame (none where T is a multiple of 32); R
    summed from the columns puts sum_t re_b where sum_t re_a belongs
    (what K7, whose rows and columns are one operand, cannot show)."""
    ops = _operands('random', T, F, ni, nj, 9 + T + ni)
    got = k8_model(*(torch.from_numpy(v) for v in ops), mutant=mutant)
    want = _oracle(*ops)
    if mutant == 'pad' and T % 32 == 0:
        np.testing.assert_array_equal(got.numpy(), want)
        return
    assert not np.array_equal(got.numpy(), want)
    if mutant == 'ra_from_columns':
        # right only where the two sums meet
        same = ops[0].astype(np.int64).sum(0)[:, :, None] == \
            ops[2].astype(np.int64).sum(0)[:, None, :]
        np.testing.assert_array_equal(got.numpy()[same], want[same])
        assert not np.array_equal(got.numpy()[~same], want[~same])


# ---------------------------------------------------------------------------
# the job walk of xcorr_kernel<false>
# ---------------------------------------------------------------------------

def _tile_of(k, ntj):
    """xc_tile_of<false>: tile k of a channel's rectangle, by rows."""
    return k // ntj, k % ntj


def _job(job, rowblock, nti, ntj):
    """xc_job<false>: (channel, k0, k1) of a job."""
    if not rowblock:
        return job // (nti * ntj), job % (nti * ntj), job % (nti * ntj) + 1
    k0 = (job % nti) * ntj
    return job // nti, k0, k0 + ntj


def _geometry(G, F, n_i, n_j, rowblock):
    nti, ntj = _cdiv(n_i, 64), _cdiv(n_j, 64)
    return nti, ntj, G * F * (nti if rowblock else nti * ntj)


def compute_side(block, grid, G, F, T, n_i, n_j, rowblock):
    """The tiles block ``block`` of ``grid`` hands over, in order, as the
    compute warps walk them: resident (row block), the row block staged
    as cp.async group 0 (pieces 0 .. 7) and column block b as group 1 + b
    (pieces 8 + 8 b ..), each tile multiplied once the groups up to its
    own are in, from the pieces of its row block and its column block;
    chunked, steps of (tile, frame chunk) that issue the next step's
    copies into the other buffer before they multiply this one's.
    Returns the handed-over (channel, ti, tj) and the slot waits."""
    nti, ntj, njobs = _geometry(G, F, n_i, n_j, rowblock)
    jobs = range(block, njobs, grid)
    handed = []
    if rowblock:
        ngrp = 1 + ntj
        for job in jobs:
            chan, k0, k1 = _job(job, True, nti, ntj)
            groups = [('i', k0 // ntj * 64)] + \
                [('j', 64 * b) for b in range(ntj)]
            arrived = 0
            for k in range(k0, k1):
                ti, tj = _tile_of(k, ntj)
                need = 1 + tj
                # cp.async.wait_group min(7, ngrp - 1 - need): at most
                # that many of the ngrp groups are still in flight
                arrived = max(arrived, ngrp - min(7, ngrp - 1 - need))
                assert arrived >= need + 1
                ca, cb = 0, 8 + 8 * tj
                assert groups[ca // 8] == ('i', 64 * ti)
                assert groups[cb // 8] == ('j', 64 * tj)
                handed.append((chan, ti, tj))
    else:
        tch = min(_cdiv(T, 32) * 32, gpu_kernels.XCORR_CHUNK)
        nchunk = _cdiv(T, tch)
        nstep = len(jobs) * nchunk
        buffers = [None, None]

        def issue(step):
            job = block + step // nchunk * grid
            chan, k, _ = _job(job, False, nti, ntj)
            buffers[step & 1] = (chan,) + _tile_of(k, ntj) + \
                (step % nchunk * tch,)
        if nstep:
            issue(0)
        for step in range(nstep):
            c = step % nchunk
            if step + 1 < nstep:
                issue(step + 1)
            chan, ti, tj, t0 = buffers[step & 1]
            assert t0 == c * tch                   # this step's chunk
            if c == 0:
                tile = (chan, ti, tj)
            assert (chan, ti, tj) == tile          # one tile a job
            if c == nchunk - 1:
                handed.append(tile)
    waits = [i % 2 for i in range(len(handed)) if i >= 2]
    return handed, waits


def store_side(block, grid, G, F, n_i, n_j, rowblock):
    """The tiles block ``block`` of ``grid`` writes, in order, as the
    store warps walk the same jobs, and the slots they give back."""
    nti, ntj, njobs = _geometry(G, F, n_i, n_j, rowblock)
    jobs = range(block, njobs, grid)
    ntiles = len(jobs) * (ntj if rowblock else 1)
    written = []
    for job in jobs:
        chan, k0, k1 = _job(job, rowblock, nti, ntj)
        written.extend((chan,) + _tile_of(k, ntj) for k in range(k0, k1))
    assert len(written) == ntiles
    arrivals = [i % 2 for i in range(ntiles) if i + 2 < ntiles]
    return written, arrivals


@pytest.mark.parametrize('rowblock', [1, 0])
@pytest.mark.parametrize('G,ni,nj', [(1, 1, 1), (1, 63, 65), (3, 128, 512),
                                     (1, 200, 70), (3, 65, 1), (2, 1, 300)])
def test_k8_walk_writes_every_output_once(G, ni, nj, rowblock):
    """For one and several groups, ragged n_i and n_j, and persistent grids
    of 1, 3, 7 and 132 blocks (at most one a job): each block's compute
    side hands over the tiles its store side writes, in the same order,
    with as many slot waits as slots given back, slot by slot; the tiles
    cover every output element of every (group, channel) exactly once,
    and none is mirrored."""
    F = 2
    for T in (33, 300):
        nti, ntj, njobs = _geometry(G, F, ni, nj, rowblock)
        for want in (1, 3, 7, 132):
            grid = min(want, njobs)
            count = np.zeros((G * F, ni, nj), np.int32)
            for block in range(grid):
                handed, waits = compute_side(block, grid, G, F, T, ni, nj,
                                             rowblock)
                written, arrivals = store_side(block, grid, G, F, ni, nj,
                                               rowblock)
                assert handed == written
                assert sorted(waits) == sorted(arrivals)
                for chan, ti, tj in written:
                    assert ti < nti and tj < ntj
                    count[chan, 64 * ti:64 * ti + 64,
                          64 * tj:64 * tj + 64] += 1
            assert (count == 1).all()


def test_k8_walk_follows_the_source():
    """The walk above is the kernel's: the source holds the same tile
    index, job split, group order, wait rule and piece offsets, and
    writes K8's tiles unmirrored into the (n_i, n_j) matrix."""
    with open(SOURCE) as f:
        src = f.read()
    for line in ('ti = k / a.ntj;', 'tj = k % a.ntj;',
                 'chan = job / a.nti;',
                 'j.k0 = (int)(job - chan * a.nti) * a.ntj;',
                 'j.k1 = j.k0 + a.ntj;', 'chan = job / a.ntiles;',
                 'j.k0 = (int)(job - chan * a.ntiles);',
                 'const int ngrp = kHerm ? a.nti : 1 + a.ntj;',
                 'const int need = kHerm ? ti : 1 + tj;',
                 'cp_async_wait_upto(ngrp - 1 - need);',
                 'const int cb = kHerm ? 8 * tj : 8 + 8 * tj;',
                 'jb.k0 / a.ntj * kTile7, 0, a.tch);',
                 'k7_stage(a, a.xj, stage, off, 8 + 8 * b, kTile7 * b, 0,',
                 'k7_write(o, a.xi.n, a.xj.n, ti * kTile7, tj * kTile7,',
                 'kHerm && ti != tj,',
                 'a.nch = a.resident ? 8 + 8 * ntj : 2 * kTile7 / 8;',
                 'a.njobs = (long long)ngroup * nfreq * (a.resident ? nti '
                 ': a.ntiles);',
                 'constexpr int kTile7 = 64;', 'constexpr int kSlots7 = 2;',
                 'constexpr int kOutRow7 = kTile7 + 1;',
                 'constexpr int kChunk7 = 256;'):
        assert line in src, line


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

def test_xcorr_cross_plan_at_the_ports_shapes():
    """On the H100 both of the port's T = 128 shapes (the kernel table's
    128 x 512 rows and the 2-D mesh's 256 x 512) take the row-block path,
    2 (128 + 64 * 8) * 128 + 66,560 = 214,016 bytes of shared memory,
    and T = 256 at n_j = 512 (and T = 300) the chunked path: two 256-frame
    buffers of 128 inputs (65,536 bytes each) beside the slots."""
    plan = gpu_kernels.xcorr_cross_plan
    assert plan(128, 128, 512, H100_SMEM) == (1, 214016, 2)
    assert plan(128, 256, 512, H100_SMEM) == (1, 214016, 4)
    assert plan(256, 128, 512, H100_SMEM) == (0, 197632, 2 * 8)
    assert plan(300, 256, 512, H100_SMEM) == (0, 197632, 4 * 8)
    # the whole channel staged (what the design does not do) would not fit
    # in the mesh's shape
    assert 2 * 128 * (256 + 512) + 66560 > H100_SMEM


@pytest.mark.parametrize('T', [1, 31, 32, 33, 64, 96, 128, 160, 256, 300,
                               65535])
@pytest.mark.parametrize('nj', [1, 64, 65, 200, 512, 1000])
def test_xcorr_cross_plan_rule(T, nj):
    """A row block when 2 ceil(T / 32) 32 (64 + 64 ceil(n_j / 64)) bytes
    fit beside the 66,560 of the slots, else a tile a job with chunks of
    at most 256 frames; the jobs per channel follow."""
    ni = 130
    rowblock, nbytes, njobs = gpu_kernels.xcorr_cross_plan(T, ni, nj,
                                                           H100_SMEM)
    tall = _cdiv(T, 32) * 32
    res = 66560 + 2 * tall * (64 + 64 * _cdiv(nj, 64))
    assert rowblock == int(res <= H100_SMEM)
    if rowblock:
        assert (nbytes, njobs) == (res, 3)
    else:
        assert nbytes == 66560 + 2 * min(tall, 256) * 128 * 2
        assert nbytes <= H100_SMEM
        assert njobs == 3 * _cdiv(nj, 64)


def test_k8_variant_edits_apply_to_the_source():
    """chip_k8_variants.py's edits each apply once to the shared kernel,
    keep the source's braces balanced and both C entries."""
    import importlib.util
    path = os.path.join(os.path.dirname(SOURCE), os.pardir, os.pardir,
                        'chip_k8_variants.py')
    mod_spec = importlib.util.spec_from_file_location('chip_k8_variants',
                                                      path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    with open(SOURCE) as f:
        src = f.read()
    vs = mod.variants(src)
    assert sorted(vs) == ['early_rowblock', 'kernel', 'no_mma', 'no_stage',
                          'no_write']
    assert vs['kernel'] == (src, True)
    for name, (text, keeps) in vs.items():
        assert text.count('{') == text.count('}'), name
        assert text.count('int bf_xcorr_herm(') == 1, name
        assert text.count('int bf_xcorr_cross(') == 1, name
        assert keeps == (name in ('kernel', 'early_rowblock'))
        assert (text == src) == (name == 'kernel')
