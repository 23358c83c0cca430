#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (bifrost_tpu_torch) on one card.

    python3 chip_smoke.py

Run from the repository root on a machine with one NVIDIA H100 and the
CUDA toolkit (nvcc).  It imports nothing of JAX or of bifrost_tpu.  It:

1. prints the card (nvidia-smi name and power limit);
2. builds every CUDA kernel of the port from bifrost_tpu_torch/csrc;
3. runs K2 (Stokes detect) at T=16384, F=4096 on the strided planes of a
   complex FFT output, as the main path gives it, against its plain
   PyTorch version (rtol 1e-6), and times both with CUDA events;
4. runs K1 (fused spectrometer) against the float64 oracle at T=64,
   nfft=4096, r=4 (gate 1e-5 relative to the maximum), over every
   power-of-two nfft from 4 to 8192 at small T and r 1, 4 and nfft
   against the oracle and its plain version (each nfft through the
   kernel its size picks: radix-16 Stockham from 256, radix-2 below,
   counted by path), and against its plain version at full width; times
   the kernel (bracketed and queued), the plain version, the PyTorch
   chain fft -> Stokes -> reduce (the library yardstick) and cuFFT alone
   on the unpacked gulp, and the kernel and cuFFT at nfft 1024, 2048 and
   8192 on gulps of as many samples;
5. drives the Guppi spectrometer chain through the port's Pipeline at
   full width (16384 x 2 x 4096 ci8 gulps, r=4; 3 warm-up and 16 timed
   gulps): system ring -> copy('cuda') -> FusedBlock -> copy('system') ->
   sink, once with the K1 substitution and once without (K2 path).
   Launch counters are zeroed just before and read just after each run;
   each run must launch its kernel once per gulp, and every K1 launch
   must take the radix-16 kernel.  The two outputs must
   agree within 1e-5, and rows are checked against the oracle;
5a. writes GUPPI RAW files at Breakthrough Listen's GBT recording
   geometry (64 coarse channels, 2 pols, 128 MiB blocks) to a temporary
   directory, 4 blocks at NBITS 8 (524288 samples) and 2 at NBITS 4
   (1048576), each seeded noise plus one tone per channel, and runs the
   north star's chain over each through examples/gpuspec_simple_torch.py's
   build() with one block a gulp (read_guppi_raw -> copy('cuda') ->
   fused[FFT -> Stokes -> reduce(4)] -> copy('system') -> merge_axes ->
   transpose -> write_sigproc).  The .fil header fields must equal what
   the Guppi header gives, its data must be within 1e-5 of a float64
   numpy oracle on the first 2 blocks, and every tone must peak at its
   bin; the ci4 block's device representation must equal a numpy
   unpacking bit for bit.  Prints the file-to-file rate (host-bound) and
   each block's host ms per gulp;
5b. drives copy('cuda') -> fft -> detect('stokes') (unfused) ->
   copy('system') on the spectrometer arm's gulps: K2 must launch once
   per gulp and every output equal stokes_detect_plain;
5c. runs bf.map (bifrost_tpu_torch.map) on a spectrometer gulp: the
   polarisation products of tests/test_map.py on its complex64
   voltages (equal to torch's products and to numpy on 64 rows: every
   product of these integers is exact), the fftshift index vector along
   the 4096 axis (equal to torch.fft.fftshift) and the ci8 expression on
   the raw gulp from host memory (equal to the unpacked gulp), each
   timed; dft_matmul_fft on the gulp's 4096-point rows within 1e-4 of
   torch.fft.fft, timed beside it; and fused([FftStage, MapStage('b =
   a.mag2()', dtype='f32'), ReduceStage('freq', 4)]) through the
   pipeline (1 warm-up and 3 timed gulps) within 1e-5 of a float64
   |FFT|^2 summed by 4 on 64 rows;
6. runs the beamformer kernels at the full-width shapes of BASELINE
   config 4 (512 frames x 512 channels x 256 stations x 2 pols ci8, 64
   beams, R=8): K4 (int8, one int8 tensor-core GEMM over every channel)
   on both pols' views bit-identical to its plain version and on pol 0
   to the int64 oracle on three channels, K5 (bf16, one GEMM over every
   channel) within 1e-5 of its plain version and inside the bf16 class of
   the float64 oracle, the K4 and K5 launches on the per-pol views through
   the 16-byte staging, K6 (beamform -> Stokes -> integrate) on its
   int8 tensor-core kernel bit-identical to its plain version and below
   1e-5 against the float64 oracle on a T=64 cut, and over an R sweep
   at T=96 (R 1, 2, 4, 8, 16 on the tensor-core kernel, bit-identical;
   R 32, R = T and a gulp 4 bytes off 16 on the dp4a kernel, within
   1e-6; each launch's kernel by the per-path counter); each timed with
   CUDA events beside its plain version and a library yardstick, and
   queued (K4 against torch._int_mm of the widened block, K5 against
   torch.mm with an f32 output and the bf16-output torch.matmul, K6
   against the torch chain and twice K4's queued time, the unfused
   path's products); K4 and K5 count the whole gulp read by each
   per-pol launch;
7. drives the beamformer chain through the Pipeline at that width (3
   warm-up and 16 timed gulps) in four arms, K6 (fused substitution),
   K4 and K5 (beamform block with the kernel forced -> fused Stokes and
   frame sum) and f32 (the complex64 baseline), zeroing the launch
   counters just before and reading them just after each; K6 must
   launch once per gulp, every launch on its tensor-core kernel, K4 and
   K5 twice (once per pol), every K4 and K5 launch through the 16-byte
   staging.  The K4 and K6 arms must agree
   within 1e-5, each arm must stay inside its accuracy class of the f32
   arm, and every output must be finite and (64, 512, 4, 64).  A fifth
   arm leaves the candidate to the engine's race, in a fresh probe-cache
   directory, prints each candidate's ms and its choice and stays inside
   the int8 class;
7a. drives a 16-tap FIR block over 3 ci8 gulps of that shape, taps per
   (channel, station, pol) at decim 1 and then shared taps at decim 4,
   each within 1e-5 of a float64 oracle over the concatenated stream on
   4 channels, across the gulp boundaries; times Fir.execute on a gulp;
8. checks the capability probe K0: available() is True on the card and
   launches the probe kernel once (a second call is cached); times it
   one call bracketed, queued and replayed from a CUDA graph (device time
   alone) beside torch.mul(x, 2.0);
9. runs the correlator kernels at the FX path's shapes: K7 (xcorr_herm)
   on the (2, 128, 1024, 512) group planes of a (256, 1024, 256, 2) ci8
   gulp, read in place as strided views, in one launch; K8 (xcorr_cross)
   on a 128-input station-row block against all 512 inputs, T=128.  Each
   is bit-identical to its plain version (float64 products on the card)
   and to the int64 oracle on channels 0, 511 and 1023, K7's imaginary
   part nonzero and antisymmetric, K8 equal to K7's rows; each timed
   (bracketed and queued) beside its plain version and the complex64
   einsum yardstick, and beside zero_() of its output (the write
   ceiling).  K8 also at the 2-D mesh's block (T=128, 256 rows) and at
   T=256 (128 rows, chunked jobs), bit-identical and timed queued; every
   K8 launch must take the row-block jobs and the staging that
   xcorr_cross_plan and xcorr_staging give, by its counters;
10. drives the FX correlator through the Pipeline at BASELINE config 5's
   width with config 19's chain (256 stations x 2 pols, 1024 channels,
   256-frame gulps: copy('cuda') -> fft -> quantize('ci8', 1/32) ->
   correlate(128, fusable) -> accumulate(2, fusable) -> copy('system'))
   in three arms, K7 forced (one launch per gulp), the engine's race from
   an empty probe cache (K0 asked afresh), and the complex64 'xla'
   baseline; all three byte-identical to each other and to an oracle
   made on the card (torch's FFT and quantize, float64 products).  A
   fourth arm, BASELINE config 5's X step alone, runs the stateful
   correlate(256) on 64-frame ci8 gulps (one K7 launch per gulp) against
   the int64 oracle; the cross family of xcorr_int8 runs K8 on the four
   station-row blocks of a gulp, as the station-sharded plan calls it,
   each launch on row-block jobs;
10a. drives the fx-K7 arm's chain followed by
   convert_visibilities('storage'), as examples/fx_correlator.py builds
   it (1 warm-up and 2 timed gulps, 1.08 GB of storage each): one K7
   launch per gulp, every storage output equal value for value to the
   numpy conversion of the FX oracle's visibilities, a storage -> matrix
   round trip on the card equal to the oracle's full matrix; prints the
   D2H ms per gulp beside fx-K7's;
10b. grids 64 channels of 32,896 points (config 5's baselines with the
   autos) through 7 x 7 complex64 kernels onto a 1024 x 1024 grid with
   ops.romein.Romein (537 MB of grid), within 1e-5 of a float64
   scatter on 2 channels, and again with accumulate=True (the grid
   doubles); each execute timed;
11. runs K3 (the FDMT merge step) over every step of three plans at the
   full-width span (16384 + 1970 frames): 4096 channels over 1200-1600
   MHz to max_delay 1970, the same band in 3000 channels (passthrough
   rows, the rows_hi clamp), and 4096 channels with negative delays.
   Every step is bit-identical to its plain version, the K3 core to the
   torch gather core, and both within fdmt_gate_rtol() (1e-4) of a
   float64 reference (fdmt_numpy on the host for the first plan, the
   float64 gather core on the card, held to it, for the others).  Times
   the 12 launches of a gulp, each step, the plain version and the
   gather core's steps;
12. drives FDMT through the Pipeline at that width on a seeded noise
   stream with dispersed pulses injected at known trials and frames (2
   warm-up and 10 timed 16384-frame gulps) in four arms: fdmt-file
   (BASELINE config 3: an 8-bit .fil written by write_sigproc ->
   read_sigproc -> copy('cuda') -> transpose(['pol', 'freq', 'time']) ->
   fdmt(max_dm=100) -> copy('system'), K3 forced; max_delay must come
   out as 1970, every span equal to the K3 core on its data), and config
   22's FRB search ([freq, time] f32 source -> copy('cuda') ->
   fdmt_stage(1970) -> matched_filter(8) -> threshold(thr) ->
   copy('system'), thr at a false-alarm rate of 1e-3 on a noise-only
   realization) with K3 forced (frb-K3, 12 launches per gulp), with the
   race from an empty probe cache (frb-race) and with the torch gather
   core (frb-torch).  The frb arms are byte-identical, every arm is
   within 1e-4 of the float64 oracle chain, the candidates equal the
   oracle's apart from samples within rtol of the threshold, and every
   pulse peaks within 1 trial and 1 frame of where it was injected;
13. runs K9 (the corner turn's ring hop; right after the build, so a
   broken K9 stops the run early) at the corner turn's shapes on one card: 4 int8 blocks of (64, 1024, 256, 2, 2), 3 such blocks, and 4
   complex64 blocks whose byte count is not a multiple of 16, each
   bit-identical to its plain version; the whole corner turn
   (impl='pallas') of a (256, 1024, 256, 2, 2) gulp over 4 ranks of the
   card equal to the transpose oracle; K9, its plain version and
   torch.roll of the stacked blocks timed with CUDA events;
14. drives BASELINE config 5's array through copy('cuda') ->
   correlate(256, accuracy='int8') under block_scope(mesh=...) ->
   copy('system') on 256-frame gulps (1 warm-up and 2 timed), the mesh's
   ranks all on cuda:0, in six arms: single (no mesh, the reference, held
   to the float64 products and the int64 oracle), mesh-psum ({'sp': 4},
   BF_XCORR_CORNER_TURN=off), mesh-corner-xla and mesh-corner-K9 (the
   corner-turn plan forced with all_to_all or K9 hops), mesh-2d ({'sp':
   2, 'tp': 2}, station-sharded, K8 forced), each with K7 forced, and
   mesh-race (the plans and the X engine race from an empty probe
   cache); every mesh arm byte-identical to the single run, with 4 K7 (or
   4 K8, on row-block jobs) launches per gulp and 3 K9 launches per gulp
   in mesh-corner-K9;
15. drives config 22's [freq, time] stream through copy('cuda') ->
   fdmt(max_delay=1970) -> copy('system'), K3 forced, under an {'sp': 2}
   mesh of the card (spans of 2 x 9177 frames) and without a mesh: every
   span bit-identical;
16. prints a JSON line of pipeline rates per chain, one of the DSP
   library phases' numbers, one JSON line of per-kernel numbers
   ({"kernels": [...]}, K0-K9), the nvidia-smi line, and as the last
   line {"ok": true, "device": {...}}.

Any failure raises and exits non-zero before the last line; with no
CUDA device it exits 1 at once.
"""

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

NTIME, NPOL, NFINE, RFACTOR = 16384, 2, 4096, 4
NWARM, NTIMED = 3, 16
ORACLE_NTIME = 64
GATE = 1e-5              # spectrometer accuracy gate vs the float64 oracle
STOKES_RTOL = 1e-6
NRUNS = 20
# H100 SXM data sheet: HBM3 rate, FP32 rate outside the tensor cores,
# dense bf16 and int8 tensor-core rates
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
PEAK_BF16_PER_S = 989e12
PEAK_INT8_PER_S = 1979e12
# the beamformer: BASELINE config 4 with config 13's integration
BT, BF, BS, BP, BB, BR = 512, 512, 256, 2, 64, 8
BEAM_ORACLE_NTIME = 64
BEAM_SWEEP_NTIME = 96     # K6's R sweep: R 1 .. 32 and R = T = 96
# the FX correlator: BASELINE config 5's array (256 stations, 2 pols, 1024
# channels) through config 19's chain, 256-frame gulps, R = 128 frames
# per visibility and A = 2 visibilities per output.  A visibility is at
# most 2 * 128^2 * R * A = 8.4e6 < 2^24, so every int32 sum, its float32
# cast and the float32 accumulate are exact whatever the summation
# order: arms and oracles are compared bit for bit.  The quantize scale
# 1/32 = 1/sqrt(1024) keeps the requantized values spread over int8.
XT, XF, XS, XP, XR, XA = 256, 1024, 256, 2, 128, 2
XN = XS * XP
XSCALE = 1. / 32
XWARM, XTIMED = 2, 3
# the stateful X step: 64-frame gulps, 256 frames per integration
XST, XSINT, XSWARM, XSTIMED = 64, 256, 4, 8
XCHANNELS = (0, 511, 1023)
# FDMT dedispersion: an L-band filterbank of 4096 channels (1200-1600 MHz,
# 64 us, one pol) dedispersed to BASELINE config 3's max_dm = 100, which
# FdmtBlock sizes to a max_delay of 1970 frames; 16384-frame gulps, so the
# FDMT reads 16384 + 1970 frames per span.  Config 22's matched filter
# (8 taps) and threshold at a false-alarm rate of 1e-3 on a noise-only
# realization.  FODD channels over the same band give a plan with
# passthrough rows (an odd subband count at three of its steps).
FCH, FF0, FDF, FTSAMP, FMAXDM, FMD = 4096, 1200.0, 400.0 / 4096, 64e-6, \
    100.0, 1970
FG, FNTAP, FFAR, FWARM, FTIMED = 16384, 8, 1e-3, 2, 10
FODD = 3000
# dispersed pulses injected into the stream: (trial, frame), each FPW
# frames wide (the matched filter's width) at FAMP per channel-sample, one
# across the boundary of gulps 4 and 5.  The frame is where the pulse
# starts in the lowest channel; the FDMT's own per-channel delays put its
# peak a frame or so off that (see pulse_expect)
FPULSES = ((100, 5000), (400, 20000), (800, 40000), (1200, 60000),
           (1500, 81915), (1800, 110000), (1969, 120000), (1000, 180000))
FAMP, FPW = 3.0, 8
# the mesh tier: MD ranks that all live on cuda:0 (as the JAX package's
# tests put their 8-device meshes on one CPU).  K9 at the corner turn's
# blocks, MD x (XT / MD, XF, XS, XP, 2) int8; the stateful correlate(XT)
# on XT-frame gulps of BASELINE config 5's array under each mesh plan
# (1 warm-up and 2 timed gulps, a 2.1 GB output each); config 22's FDMT
# stream on an {'sp': 2} mesh (spans of 16384 + 1970 = 2 x 9177 frames)
MD = 4
MWARM, MTIMED = 1, 2
MFDMT = 2
# the Guppi RAW front end (examples/gpuspec_simple_torch.py): Breakthrough
# Listen's GBT L-band recording geometry, 64 coarse channels of 2.9296875
# MHz (-187.5 MHz), 2 pols, 128 MiB blocks (524,288 samples at 8 bits,
# 1,048,576 at 4), one block a gulp, r 4; 4 ci8 blocks and 2 ci4 blocks,
# the first GORACLE of each held to the float64 oracle
GCH, GFREQ, GBW, GBLOCSIZE, GR = 64, 1501.4648, -187.5, 134217728, 4
GBLOCKS = {8: 4, 4: 2}
GORACLE = 2
# the unfused detect('stokes') arm: the spectrometer arm's gulps
DWARM, DTIMED = 1, 3
# the DSP library: map and MapStage on the spectrometer arm's gulps (the
# fused map arm 1 warm-up and 3 timed gulps); the FX chain ending in
# convert_visibilities('storage') (1 warm-up and 2 timed gulps, 1.08 GB
# of storage each); a 16-tap FIR over 3 beamformer gulps, held to the
# float64 oracle on FIR_CHANNELS; Romein gridding of config 5's 32,896
# baselines (autos included) with 7 x 7 kernels onto a 1024 x 1024 grid
# for 64 channels at once (537 MB of grid), held to a float64 scatter on
# ROMEIN_ORACLE channels
PWARM, PTIMED = 1, 3
SWARM, STIMED = 1, 2
FIR_TAPS, FIR_DECIM, FIR_CHANNELS = 16, 4, (0, 171, 340, 511)
RNPTS, RKSIZE, RNGRID, RNCHAN, ROMEIN_ORACLE = XS * (XS + 1) // 2, 7, \
    1024, 64, 2
DFT_GATE = 1e-4


def log(*args):
    print(*args, flush=True)


def require(cond, what):
    if not cond:
        raise RuntimeError('chip_smoke check failed: ' + what)


def rel_err(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def nvidia_smi_line():
    p = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                        '--format=csv,noheader'],
                       capture_output=True, text=True, timeout=60)
    require(p.returncode == 0, 'nvidia-smi failed: %s' % p.stderr)
    return p.stdout.strip().splitlines()[0]


def cuda_ms(fn, runs=NRUNS, warm=2):
    """Median milliseconds of ``fn`` over ``runs`` launches, each
    bracketed by CUDA events."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def cuda_ms_queued(fn, calls=20, runs=5):
    """Median device milliseconds per call of ``fn`` over ``runs`` batches
    of ``calls`` back-to-back calls, each batch bracketed by CUDA events:
    what a call costs the card when calls queue, the host's preparation
    of one call hidden behind the device work of the one before."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return float(np.median(times))


def cuda_ms_graph(fn, calls=20, runs=5):
    """Median device milliseconds per call of ``fn`` from replays of a
    CUDA graph that holds ``calls`` calls: the device time of a call with
    no host time in it (a launch shorter than its host-side preparation
    keeps the card waiting even when calls queue)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return cuda_ms_queued(graph.replay, calls=1, runs=runs) / calls


def bound(nbyte, nops, peak_ops=PEAK_FP32_PER_S):
    """(bound_ms, bound_by) from the bytes moved once and the operations
    at the peak rate of their type (FP32 unless given)."""
    t_bytes = nbyte / PEAK_BYTES_PER_S * 1e3
    t_ops = nops / peak_ops * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def phase_stokes(gpu_kernels):
    """K2 at the main path's shape: the four strided planes of
    view_as_real of the (T, 2, F) complex64 FFT output."""
    import torch
    T, F = NTIME, NFINE
    g = torch.Generator(device='cuda').manual_seed(2)
    x = torch.randn((T, 2, F), dtype=torch.complex64, device='cuda',
                    generator=g)
    v = torch.view_as_real(x)
    planes = (v[:, 0, :, 0], v[:, 0, :, 1], v[:, 1, :, 0], v[:, 1, :, 1])
    got = gpu_kernels.stokes_detect(*planes)
    want = gpu_kernels.stokes_detect_plain(*planes)
    torch.cuda.synchronize()
    abs_err = float((got - want).abs().max())
    rel = abs_err / float(want.abs().max())
    log('K2 stokes_detect (%d, %d): max abs err %.3g, rel %.3g'
        % (T, F, abs_err, rel))
    require(rel <= STOKES_RTOL, 'K2 disagrees with its plain version: '
            'rel %.3g' % rel)
    ms = cuda_ms(lambda: gpu_kernels.stokes_detect(*planes))
    plain_ms = cuda_ms(lambda: gpu_kernels.stokes_detect_plain(*planes))
    bms, by = bound(32 * T * F, 10 * T * F)
    log('K2 kernel %.4f ms, plain %.4f ms, bound %.4f ms (%s)'
        % (ms, plain_ms, bms, by))
    return {'name': 'stokes_detect', 'route': 'cuda',
            'source': 'bifrost_tpu_torch/csrc/stokes.cu',
            'replaces': 'bifrost_tpu/ops/pallas_kernels.py:86',
            'shape': [T, F], 'max_abs_err': abs_err, 'max_rel_err': rel,
            'ms': ms, 'kernel_ms': ms, 'plain_ms': plain_ms,
            'bound_ms': bms, 'bound_by': by, 'library_ms': None}


def library_chain(volt, rfactor):
    """The PyTorch library chain the kernel replaces (yardstick only):
    cuFFT through torch.fft.fft, then Stokes and the reduce."""
    import torch
    s = torch.fft.fft(torch.view_as_complex(volt.float()), dim=-1)
    x, y = s[:, 0], s[:, 1]
    xx, yy = x.abs().square(), y.abs().square()
    xy = x * y.conj()
    st = torch.stack([xx + yy, xx - yy, 2 * xy.real, -2 * xy.imag], dim=1)
    return st.reshape(st.shape[0], 4, -1, rfactor).sum(-1)


def library_fft(volt):
    """cuFFT alone (yardstick only): torch.fft.fft of the already
    unpacked complex64 gulp."""
    import torch
    return torch.fft.fft(volt, dim=-1)


def spectrometer_bound(T, nfft, rfactor):
    """K1's bound: 2 B in a complex sample and 16 B / rfactor out; the
    FFTs' 5 N log2 N flop and Stokes' 20 a bin."""
    nbyte = 2 * T * NPOL * nfft + 4 * 4 * T * (nfft // rfactor)
    nflop = T * NPOL * 5 * nfft * int(np.log2(nfft)) + 20 * T * nfft
    return bound(nbyte, nflop)


def spectrometer_sweep(spec):
    """Every power-of-two nfft from 4 to MAX_NFFT at small T, r 1, 4 and
    nfft, against the plain version and the float64 oracle, each through
    the kernel that its nfft picks (the per-path counter)."""
    import torch
    worst = {}
    e = 2
    while (1 << e) <= spec.MAX_NFFT:
        nfft = 1 << e
        T = 5 if nfft >= 1024 else 9
        rng = np.random.RandomState(100 + e)
        v = rng.randint(-128, 128, size=(T, NPOL, nfft, 2)).astype(np.int8)
        volt = torch.from_numpy(v).cuda()
        path = spec.kernel_path(nfft)
        for rfactor in sorted({1, min(4, nfft), nfft}):
            before = spec.launches_by_path[path]
            got = spec.fused_spectrometer(volt, rfactor=rfactor)
            plain = spec.spectrometer_plain(volt, rfactor)
            torch.cuda.synchronize()
            require(spec.launches_by_path[path] == before + 1,
                    'K1 at nfft %d did not take the %s kernel' % (nfft, path))
            got = got.cpu().numpy()
            r_oracle = rel_err(got, spec.spectrometer_oracle(v, rfactor))
            r_plain = rel_err(got, plain.cpu().numpy())
            require(r_oracle < GATE and r_plain < GATE,
                    'K1 at nfft %d, r %d: rel %.3g of the oracle, %.3g of '
                    'the plain version' % (nfft, rfactor, r_oracle, r_plain))
            worst[nfft] = max(worst.get(nfft, 0.0), r_oracle)
        e += 1
    log('K1 sweep, nfft 4 to %d at r 1, 4 and nfft, worst rel to the '
        'oracle by nfft: %s' % (spec.MAX_NFFT, json.dumps(
            {str(k): float('%.3g' % v) for k, v in worst.items()})))
    return worst


def spectrometer_by_nfft(spec, nffts=(1024, 2048, 8192)):
    """K1 and cuFFT alone at other nfft, T chosen so a gulp holds the
    main path's samples."""
    import torch
    out = {}
    for nfft in nffts:
        T = NTIME * NFINE // nfft
        g = torch.Generator(device='cuda').manual_seed(nfft)
        volt = torch.randint(-128, 128, (T, NPOL, nfft, 2), dtype=torch.int8,
                             device='cuda', generator=g)
        run = lambda: spec.fused_spectrometer(volt, rfactor=RFACTOR)
        unpacked = torch.view_as_complex(volt.float())
        bms, by = spectrometer_bound(T, nfft, RFACTOR)
        out[nfft] = {'shape': [T, NPOL, nfft, 2], 'ms': cuda_ms(run),
                     'ms_queued': cuda_ms_queued(run),
                     'library_fft_ms': cuda_ms_queued(
                         lambda: library_fft(unpacked)),
                     'bound_ms': bms, 'bound_by': by}
        del volt, unpacked
        torch.cuda.empty_cache()
    log('K1 by nfft (gulps of %d samples, r %d): %s'
        % (NTIME * NFINE, RFACTOR, json.dumps(out)))
    return out


def phase_spectrometer(spec):
    import torch
    # the accuracy gate, against the float64 oracle
    rng = np.random.RandomState(11)
    small = rng.randint(-64, 64, size=(ORACLE_NTIME, NPOL, NFINE, 2)) \
        .astype(np.int8)
    got = spec.fused_spectrometer(torch.from_numpy(small).cuda(),
                                  rfactor=RFACTOR).cpu().numpy()
    oracle_rel = rel_err(got, spec.spectrometer_oracle(small, RFACTOR))
    log('K1 fused_spectrometer vs float64 oracle (T=%d): rel %.3g'
        % (ORACLE_NTIME, oracle_rel))
    require(oracle_rel < GATE, 'K1 fails the 1e-5 oracle gate: %.3g'
            % oracle_rel)
    sweep = spectrometer_sweep(spec)
    # full width, against the plain version
    g = torch.Generator(device='cuda').manual_seed(3)
    volt = torch.randint(-64, 64, (NTIME, NPOL, NFINE, 2),
                         dtype=torch.int8, device='cuda', generator=g)
    got = spec.fused_spectrometer(volt, rfactor=RFACTOR)
    want = spec.spectrometer_plain(volt, RFACTOR)
    torch.cuda.synchronize()
    abs_err = float((got - want).abs().max())
    rel = abs_err / float(want.abs().max())
    log('K1 full width vs plain: max abs err %.4g, rel %.3g'
        % (abs_err, rel))
    require(rel < GATE, 'K1 disagrees with its plain version: %.3g' % rel)
    del got, want
    run = lambda: spec.fused_spectrometer(volt, rfactor=RFACTOR)
    plain = lambda: spec.spectrometer_plain(volt, RFACTOR)
    chain = lambda: library_chain(volt, RFACTOR)
    unpacked = torch.view_as_complex(volt.float())
    fft = lambda: library_fft(unpacked)
    ms = cuda_ms(run)
    plain_ms = cuda_ms(plain)
    library_ms = cuda_ms(chain)
    queued = {'kernel': cuda_ms_queued(run),
              'plain': cuda_ms_queued(plain, calls=5, runs=3),
              'library': cuda_ms_queued(chain, calls=5, runs=3),
              'library_fft': cuda_ms_queued(fft)}
    library_fft_ms = cuda_ms(fft)
    del unpacked
    bms, by = spectrometer_bound(NTIME, NFINE, RFACTOR)
    log('K1 kernel %.4f ms (queued %.4f), plain %.4f ms, torch chain %.4f '
        'ms, cuFFT alone %.4f ms (queued %.4f), bound %.4f ms (%s)'
        % (ms, queued['kernel'], plain_ms, library_ms, library_fft_ms,
           queued['library_fft'], bms, by))
    torch.cuda.empty_cache()
    by_nfft = spectrometer_by_nfft(spec)
    return {'name': 'fused_spectrometer', 'route': 'cuda',
            'source': 'bifrost_tpu_torch/csrc/spectrometer.cu',
            'replaces': 'bifrost_tpu/ops/spectrometer.py:341',
            'shape': [NTIME, NPOL, NFINE, 2], 'rfactor': RFACTOR,
            'kernel_path': spec.kernel_path(NFINE),
            'oracle_rel_err': oracle_rel, 'max_abs_err': abs_err,
            'max_rel_err': rel, 'ms': ms, 'kernel_ms': ms,
            'plain_ms': plain_ms, 'bound_ms': bms, 'bound_by': by,
            'library_ms': library_ms,
            'library': 'torch fft -> Stokes -> sum chain',
            'library_fft_ms': library_fft_ms, 'ms_queued': queued,
            'ms_queued_per': 'launch (median of batches of queued calls: '
                             '5 x 20; plain and chain 3 x 5)',
            'by_nfft': by_nfft,
            'sweep_oracle_rel_err': {str(k): v for k, v in sweep.items()}}


def make_gulps(seed=5, n=2):
    """``n`` full-width ci8 gulps in host memory, as (T, 2, nfft, 2)
    int8 (re, im) pairs."""
    rng = np.random.default_rng(seed)
    return [rng.integers(-64, 64, size=(NTIME, NPOL, NFINE, 2),
                         dtype=np.int8) for _ in range(n)]


def drive(bt, gulps, header, chain, nwarm=NWARM, ntimed=NTIMED, per_out=1):
    """Drive source -> copy('cuda') -> chain -> copy('system') -> sink.
    ``gulps`` are int8 arrays of one gulp's ci8 bytes each, sent in turn
    (the gulp's frame count is ``gulps[0].shape[0]``); ``chain(h2d)``
    builds the device blocks and returns [(role, block), ...], the last
    one feeding the D2H copy, which sends one output span per ``per_out``
    gulps.  Returns (outputs {output index: array} of outputs 0, 1 and
    the last, seconds of the timed gulps, per-block host milliseconds per
    gulp)."""
    ngulp = nwarm + ntimed
    nout = ngulp // per_out
    first = nwarm // per_out - 1
    ntime = gulps[0].shape[0]

    class Source(bt.SourceBlock):
        def __init__(self):
            super(Source, self).__init__(['voltages'], ntime,
                                         space='system')
            self.count = 0

        def create_reader(self, name):
            return contextlib.nullcontext()

        def on_sequence(self, reader, name):
            return [json.loads(json.dumps(header))]

        def on_data(self, reader, ospans):
            if self.count == ngulp:
                return [0]
            # copy as int8: numpy copies structured (ci8) arrays
            # element by element, some 40x slower than a memcpy
            dst = ospans[0].data.as_numpy().view(np.int8)
            dst[...] = gulps[self.count % len(gulps)].reshape(dst.shape)
            self.count += 1
            return [ntime]

    class Sink(bt.SinkBlock):
        keep = (0, 1, nout - 1)

        def __init__(self, iring):
            super(Sink, self).__init__(iring)
            self.n = 0
            self.t0 = self.t1 = None
            self.out = {}

        def on_sequence(self, iseq):
            pass

        def on_data(self, ispan):
            # host bytes here mean the device work of this gulp is done
            if self.n == first:
                self.t0 = time.perf_counter()
            elif self.n == nout - 1:
                self.t1 = time.perf_counter()
            if self.n in self.keep:
                self.out[self.n] = np.array(ispan.data.as_numpy(),
                                            copy=True)
            self.n += 1

    with bt.Pipeline() as p:
        src = Source()
        h2d = bt.blocks.copy(src, space='cuda')
        blocks = chain(h2d)
        d2h = bt.blocks.copy(blocks[-1][1], space='system')
        sink = Sink(d2h)
        p.run()
    require(sink.n == nout, 'sink received %d of %d outputs'
            % (sink.n, nout))
    per_gulp = {}
    for role, blk in [('source', src), ('h2d', h2d)] + blocks + \
            [('d2h', d2h), ('sink', sink)]:
        tot = blk.perf_totals
        per_gulp[role] = {k: tot[k] / max(tot['ngulp'], 1) * 1e3
                          for k in ('acquire', 'reserve', 'process')}
    return sink.out, sink.t1 - sink.t0, per_gulp


def run_pipeline(bt, gulps, substitute):
    """The spectrometer chain: ``gulps`` are (T, 2, nfft, 2) int8 arrays.
    Returns (outputs, Msamples/s, impl_info, per-block host ms/gulp)."""
    from bifrost_tpu_torch.stages import FftStage, DetectStage, ReduceStage
    nfine = gulps[0].shape[2]
    header = {'name': 'guppi', 'time_tag': 0,
              '_tensor': {'shape': [-1, NPOL, nfine], 'dtype': 'ci8',
                          'labels': ['time', 'pol', 'fine_time'],
                          'scales': [[0, 1]] * 3, 'units': [None] * 3}}
    blocks = []

    def chain(h2d):
        blocks.append(('fused', bt.blocks.fused(
            h2d, [FftStage('fine_time', axis_labels='freq'),
                  DetectStage('stokes', axis='pol'),
                  ReduceStage('freq', RFACTOR)], substitute=substitute)))
        return blocks

    out, secs, per_gulp = drive(bt, gulps, header, chain)
    msps = NTIMED * NTIME * NPOL * nfine / secs / 1e6
    return out, msps, blocks[0][1].impl_info, per_gulp


def zero_counts(spec, gpu_kernels):
    spec.launches = 0
    for counts in (spec.launches_by_path, gpu_kernels.launches):
        for k in counts:
            counts[k] = 0


def read_counts(spec, gpu_kernels):
    return dict(gpu_kernels.launches, fused_spectrometer=spec.launches,
                **{'fused_spectrometer_' + k: n
                   for k, n in spec.launches_by_path.items()})


def log_per_gulp(per_gulp):
    for role, t in per_gulp.items():
        log('  %-6s host ms/gulp: acquire %.2f reserve %.2f process %.2f'
            % (role, t['acquire'], t['reserve'], t['process']))


def phase_pipeline(bt, spec, gpu_kernels, smi):
    volts = make_gulps()
    runs = {}
    for substitute in (True, False):
        zero_counts(spec, gpu_kernels)
        out, msps, info, per_gulp = run_pipeline(bt, volts, substitute)
        counts = read_counts(spec, gpu_kernels)
        log('pipeline substitute=%s: impl %s, launches %s, %.1f Msamples/s '
            '(%s)' % (substitute, info, counts, msps, smi))
        log_per_gulp(per_gulp)
        runs[substitute] = (out, msps, info, counts)
    ngulp = NWARM + NTIMED
    out_k1, msps_k1, info_k1, n_k1 = runs[True]
    out_k2, msps_k2, info_k2, n_k2 = runs[False]
    require(info_k1.get('impl') == 'cuda-spectrometer' and
            info_k1.get('kernel') == 'cuda',
            'substituted run did not plan the CUDA spectrometer: %s'
            % info_k1)
    require(info_k2.get('impl') == 'torch-fused',
            'unsubstituted run planned %s' % info_k2)
    require(n_k1['fused_spectrometer'] >= ngulp,
            'K1 launched %d times for %d gulps'
            % (n_k1['fused_spectrometer'], ngulp))
    require(n_k1['fused_spectrometer_radix16'] ==
            n_k1['fused_spectrometer'],
            'K1 took the radix-16 kernel in %d of %d launches'
            % (n_k1['fused_spectrometer_radix16'],
               n_k1['fused_spectrometer']))
    require(n_k2['stokes_detect'] >= ngulp,
            'K2 launched %d times for %d gulps'
            % (n_k2['stokes_detect'], ngulp))
    for k in out_k1:
        a, b = out_k1[k], out_k2[k]
        require(a.shape == (NTIME, 4, NFINE // RFACTOR) and
                np.isfinite(a).all() and np.isfinite(b).all(),
                'gulp %d: bad shape or non-finite output' % k)
        r = rel_err(a, b)
        log('gulp %d: K1 path vs K2 path rel %.3g' % (k, r))
        require(r < GATE, 'the two paths disagree on gulp %d: %.3g'
                % (k, r))
        rows = [0, 1, NTIME // 2, NTIME - 1]
        v = volts[k % len(volts)][rows]
        want = spec.spectrometer_oracle(v, RFACTOR)
        for out in (a, b):
            r = rel_err(out[rows], want)
            require(r < GATE, 'gulp %d rows vs oracle: %.3g' % (k, r))
    return {'msps_cuda_spectrometer': msps_k1, 'msps_torch_fused': msps_k2,
            'launches_k1_run': n_k1, 'launches_k2_run': n_k2}


# ---------------------------------------------------------------------------
# the Guppi RAW front end: the north star's chain, file to file
# ---------------------------------------------------------------------------

def guppi_header(nbits, block, nchan=GCH, blocsize=GBLOCSIZE):
    """A GUPPI block header at Breakthrough Listen's GBT L-band recording
    geometry (64 coarse channels of 2.9296875 MHz, negative bandwidth as
    the GBT writes it)."""
    return {'BACKEND': 'GUPPI', 'TELESCOP': 'GBT', 'SRC_NAME': 'HIP65057',
            'OBSFREQ': GFREQ, 'OBSBW': GBW, 'OBSNCHAN': nchan, 'NPOL': 4,
            'NBITS': nbits, 'BLOCSIZE': blocsize, 'DIRECTIO': 0,
            'STT_IMJD': 58000, 'STT_SMJD': 43200, 'PKTSIZE': 8192,
            'PKTIDX': block * (blocsize // 8192), 'RA': 199.9, 'DEC': -1.5,
            'AZ': 130.5, 'ZA': 40.25, 'CHAN_DM': 0.0}


def guppi_tone_bins(nchan, ntime):
    """One tone per coarse channel, each at its own fine bin."""
    return (ntime // 7 + 7919 * np.arange(nchan)) % ntime


def write_guppi(path, nbits, nblock, nchan=GCH, blocsize=GBLOCSIZE,
                seed=31):
    """Write a GUPPI RAW file of ``nblock`` blocks of seeded uniform noise
    plus, in pol 0, one tone per channel at guppi_tone_bins; returns the
    (nchan, ntime, 2, 2) int8 samples of the first GORACLE blocks."""
    from bifrost_tpu_torch.io import guppi as guppi_io
    ntime = blocsize * 8 // (nchan * NPOL * 2 * nbits)
    amp, noise = (40, 20) if nbits == 8 else (4, 3)
    t = np.arange(ntime)
    ph = 2 * np.pi * np.outer(guppi_tone_bins(nchan, ntime), t) / ntime
    tone_re = np.round(amp * np.cos(ph)).astype(np.int8)
    tone_im = np.round(amp * np.sin(ph)).astype(np.int8)
    del ph
    rng = np.random.default_rng(seed)
    kept = []
    with open(path, 'wb') as f:
        for b in range(nblock):
            v = rng.integers(-noise, noise + 1, size=(nchan, ntime, NPOL, 2),
                             dtype=np.int8)
            v[:, :, 0, 0] += tone_re
            v[:, :, 0, 1] += tone_im
            guppi_io.write_header(f, guppi_header(nbits, b, nchan,
                                                  blocsize))
            if nbits == 8:
                f.write(v.tobytes())
            else:
                u = v.view(np.uint8)
                f.write((((u[..., 0] & 15) << 4) | (u[..., 1] & 15))
                        .astype(np.uint8).tobytes())
            if b < GORACLE:
                kept.append(v)
    return kept


def guppi_oracle(spec, v, rfactor, nthread=8):
    """float64 numpy oracle of the chain on one block: (nchan, ntime, 2,
    2) int8 -> the .fil frame (4, nchan * ntime / r), coarse channel
    major, by ``spectrometer_oracle`` per channel (chunks of channels in
    a thread pool: numpy's FFT releases the GIL)."""
    from concurrent.futures import ThreadPoolExecutor
    nchan = v.shape[0]
    chunk = max(nchan // nthread, 1)

    def one(c0):
        x = np.ascontiguousarray(v[c0:c0 + chunk].transpose(0, 2, 1, 3))
        return spec.spectrometer_oracle(x, rfactor)
    with ThreadPoolExecutor(nthread) as pool:
        st = np.concatenate(list(pool.map(one, range(0, nchan, chunk))))
    return st.transpose(1, 0, 2).reshape(4, -1)


def fil_expect(nbits, nchan=GCH, blocsize=GBLOCSIZE, rfactor=GR):
    """The .fil header fields that the Guppi header gives."""
    ntime = blocsize * 8 // (nchan * NPOL * 2 * nbits)
    df = GBW / nchan
    return {'nchans': nchan * ntime // rfactor, 'nifs': 4, 'nbits': 32,
            'fch1': GFREQ - 0.5 * (nchan - 1) * df,
            'foff': df * rfactor / ntime,
            'tsamp': ntime / abs(df * 1e6),
            'tstart': 58000 + 43200 / 86400.}


def check_ci4_devrep(bt, path, v):
    """The device representation of the file's first ci4 block, unpacked
    on the card, against a numpy unpacking of the same bytes, bit for
    bit, and packed back to the same bytes."""
    from bifrost_tpu_torch import devrep
    from bifrost_tpu_torch.dtype import ci4
    from bifrost_tpu_torch.io import guppi as guppi_io
    with open(path, 'rb') as f:
        h = guppi_io.read_header(f)
        raw = np.frombuffer(f.read(h['BLOCSIZE']), np.uint8)
    s = raw.view(np.int8)
    want = np.stack([s >> 4, (raw << 4).view(np.int8) >> 4], axis=-1)
    got = devrep.to_device_rep(raw.view(ci4), 'ci4')
    require(got.device.type == bt.device.get_device().type,
            'the ci4 block did not reach the device')
    require(np.array_equal(got.cpu().numpy(), want),
            'ci4 device representation differs from the numpy unpacking')
    require(np.array_equal(want.reshape(v.shape), v),
            'the ci4 file does not hold the samples written')
    back = np.zeros(raw.shape, np.uint8)
    devrep.from_device_rep(got, 'ci4', back)
    require(back.tobytes() == raw.tobytes(),
            'ci4 bytes do not survive the device round trip')
    log('guppi-ci4: device representation of block 0 (%d bytes) equal to '
        'the numpy unpacking, bit for bit, and packs back to the same '
        'bytes' % raw.size)


def run_guppi_arm(bt, spec, gpu_kernels, nbits, nblock, tmp,
                  nchan=GCH, blocsize=GBLOCSIZE, rfactor=GR):
    """Write a GUPPI file, run examples/gpuspec_simple_torch.build() over
    it with gulp_nframe 1 and check the .fil: header fields, the float64
    oracle on the first GORACLE blocks, every tone at its bin."""
    import importlib.util
    from bifrost_tpu_torch.io import sigproc as sigproc_io
    arm = 'guppi-ci%d' % nbits
    here = os.path.dirname(os.path.abspath(__file__))
    mod = importlib.util.spec_from_file_location(
        'gpuspec_simple_torch',
        os.path.join(here, 'examples', 'gpuspec_simple_torch.py'))
    example = importlib.util.module_from_spec(mod)
    mod.loader.exec_module(example)
    ntime = blocsize * 8 // (nchan * NPOL * 2 * nbits)
    path = os.path.join(tmp, 'bl%d.raw' % nbits)
    t0 = time.perf_counter()
    kept = write_guppi(path, nbits, nblock, nchan, blocsize)
    t_write = time.perf_counter() - t0
    if nbits == 4:
        check_ci4_devrep(bt, path, kept[0])
    zero_counts(spec, gpu_kernels)
    with bt.Pipeline() as p:
        example.build([path], tmp, gulp_nframe=1, rfactor=rfactor)
        t0 = time.perf_counter()
        p.run()
        secs = time.perf_counter() - t0
    counts = read_counts(spec, gpu_kernels)
    msps = nblock * nchan * ntime * NPOL / secs / 1e6
    per_gulp = {}
    for blk in p.blocks:
        tot = blk.perf_totals
        per_gulp[blk.name] = {k: tot[k] / max(tot['ngulp'], 1) * 1e3
                              for k in ('acquire', 'reserve', 'process')}
    fil = path + '.fil'
    with sigproc_io.SigprocFile(fil) as f:
        hdr, hsize = f.header, f.header_size
    expect = fil_expect(nbits, nchan, blocsize, rfactor)
    for key, want in expect.items():
        require(np.isclose(hdr[key], want, rtol=1e-12, atol=0),
                '%s: .fil %s is %r, the Guppi header gives %r'
                % (arm, key, hdr[key], want))
    nf = expect['nchans']
    data = np.fromfile(fil, np.float32, offset=hsize)
    require(data.size == nblock * 4 * nf, '%s: .fil holds %d values, not '
            '%d' % (arm, data.size, nblock * 4 * nf))
    data = data.reshape(nblock, 4, nf)
    require(np.isfinite(data).all(), '%s: non-finite output' % arm)
    t0 = time.perf_counter()
    errs = []
    for b, v in enumerate(kept):
        want = guppi_oracle(spec, v, rfactor)
        errs.append(float(np.abs(data[b] - want).max() /
                          np.abs(want).max()))
        require(errs[-1] < GATE, '%s block %d: %.3g of the oracle '
                '(gate %g)' % (arm, b, errs[-1], GATE))
    t_oracle = time.perf_counter() - t0
    peaks = data[:, 0].reshape(nblock, nchan, -1).argmax(-1)
    bins = guppi_tone_bins(nchan, ntime) // rfactor
    require((peaks == bins[None]).all(), '%s: %d of %d tones off their bin'
            % (arm, int((peaks != bins[None]).sum()), peaks.size))
    os.remove(path)
    os.remove(fil)
    log('%s: %d blocks of %d MiB (%d channels x %d samples x 2 pols), '
        '.fil header as the Guppi header gives it, oracle rel %s (gate %g, '
        '%d blocks), all %d tones at their bins; launches %s'
        % (arm, nblock, blocsize >> 20, nchan, ntime,
           ['%.3g' % e for e in errs], GATE, len(kept), peaks.size,
           {k: n for k, n in counts.items() if n}))
    log('%s: %.1f Msamples/s of input, file to file (host-bound rate, '
        'not comparable with any bench), %.2f s for %d blocks; writing the '
        'file %.1f s, oracle %.1f s' % (arm, msps, secs, nblock, t_write,
                                       t_oracle))
    log_per_gulp(per_gulp)
    return {'nbits': nbits, 'blocks': nblock, 'ntime': ntime,
            'msps_file_to_file': msps, 'seconds': secs,
            'oracle_rel_err': errs, 'host_ms_per_gulp': per_gulp,
            'launches': {k: n for k, n in counts.items() if n}}


def phase_guppi(bt, spec, gpu_kernels):
    import tempfile
    import torch
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for nbits in (8, 4):
            out['ci%d' % nbits] = run_guppi_arm(bt, spec, gpu_kernels,
                                                nbits, GBLOCKS[nbits], tmp)
            torch.cuda.empty_cache()
    return out


def phase_detect_block(bt, spec, gpu_kernels, smi):
    """The unfused detect('stokes') block on the (time, pol, freq)
    complex64 ring that an fft block makes of the spectrometer arm's
    gulps: K2 once per gulp, every output equal to stokes_detect_plain of
    the same FFT on the card."""
    import torch
    volts = make_gulps(seed=7)
    header = {'name': 'guppi', 'time_tag': 0,
              '_tensor': {'shape': [-1, NPOL, NFINE], 'dtype': 'ci8',
                          'labels': ['time', 'pol', 'fine_time'],
                          'scales': [[0, 1]] * 3, 'units': [None] * 3}}
    blocks = []

    def chain(h2d):
        b = bt.blocks.fft(h2d, 'fine_time', axis_labels='freq')
        blocks.append(('fft', b))
        blocks.append(('detect', bt.blocks.detect(b, 'stokes')))
        return blocks

    ngulp = DWARM + DTIMED
    zero_counts(spec, gpu_kernels)
    out, secs, per_gulp = drive(bt, volts, header, chain, nwarm=DWARM,
                                ntimed=DTIMED)
    counts = read_counts(spec, gpu_kernels)
    require(counts['stokes_detect'] == ngulp,
            'detect-K2: K2 launched %d times for %d gulps'
            % (counts['stokes_detect'], ngulp))
    worst = 0.0
    dev = bt.device.get_device()
    for k, got in out.items():
        x = torch.fft.fft(torch.view_as_complex(
            torch.from_numpy(volts[k % len(volts)]).to(dev).float()), dim=-1)
        v = torch.view_as_real(x)
        want = gpu_kernels.stokes_detect_plain(
            v[:, 0, :, 0], v[:, 0, :, 1], v[:, 1, :, 0],
            v[:, 1, :, 1]).cpu().numpy()
        require(got.shape == (NTIME, 4, NFINE) and np.isfinite(got).all(),
                'detect-K2 gulp %d: bad shape or non-finite output' % k)
        worst = max(worst, rel_err(got, want))
    require(worst <= STOKES_RTOL, 'detect-K2 differs from '
            'stokes_detect_plain: rel %.3g' % worst)
    msps = DTIMED * NTIME * NPOL * NFINE / secs / 1e6
    log('detect-K2: fft -> detect(stokes) blocks, K2 launched %d times for '
        '%d gulps, outputs %s within %.3g of stokes_detect_plain; %.1f '
        'Msamples/s (%s)' % (counts['stokes_detect'], ngulp,
                             sorted(out), worst, msps, smi))
    log_per_gulp(per_gulp)
    return {'launches': counts['stokes_detect'], 'gulps': ngulp,
            'max_rel_err': worst, 'msps': msps}


def beam_weights(seed=21):
    """Random complex (P, B, S) weights of the beamformer cells."""
    rng = np.random.RandomState(seed)
    shape = (BP, BB, BS)
    return (rng.randn(*shape) + 1j * rng.randn(*shape)).astype(np.complex64)


def int64_beams(wr, wi, re, im):
    """int64 oracle of K4 on numpy planes: (T, F, S) x (B, S)."""
    r, i = re.astype(np.int64), im.astype(np.int64)
    a, c = wr.astype(np.int64), wi.astype(np.int64)
    dot = lambda v, w: np.einsum('tfs,bs->tfb', v, w)
    return dot(r, a) - dot(i, c), dot(r, c) + dot(i, a)


def detect_oracle(eng, x, rfactor):
    """float64 beamform (quantized weights) -> Stokes -> frame sum of a
    (T, F, S, 2, 2) int8 numpy gulp -> (T / R, F, 4, B)."""
    wq = (eng.wr8.astype(np.float64) + 1j * eng.wi8.astype(np.float64)) \
        * eng.wscale
    volt = x[..., 0].astype(np.float64) + 1j * x[..., 1].astype(np.float64)
    y = np.einsum('tfsp,pbs->tfpb', volt, wq)
    bx, by = y[:, :, 0], y[:, :, 1]
    xx, yy = np.abs(bx) ** 2, np.abs(by) ** 2
    xy = bx * np.conj(by)
    st = np.stack([xx + yy, xx - yy, 2 * xy.real, -2 * xy.imag], axis=2)
    T, F = x.shape[:2]
    return st.reshape(T // rfactor, rfactor, F, 4, -1).sum(axis=1)


def max_abs_err(got, want):
    """max |got - want|, one slice of the leading axis at a time, so a
    full-width output needs no full-size temporary."""
    return max(float((g - w).abs().max()) for g, w in zip(got, want))


def kernel_entry(name, source, line, got, want, ms, plain_ms, nbyte, nops,
                 peak, library_ms, **extra):
    """The kernels-line entry of one kernel: the error of its output
    ``got`` against its plain version's ``want`` (``max_rel_err`` relative
    to max |want| unless the caller passes its own), its times and its
    bound."""
    abs_err = max_abs_err(got, want)
    if 'max_rel_err' not in extra:
        scale = max(float(w.abs().max()) for w in want)
        extra['max_rel_err'] = abs_err / scale if scale else abs_err
    bms, by = bound(nbyte, nops, peak)
    log('%s kernel %.4f ms, plain %.4f ms, library %s ms, bound %.4f ms '
        '(%s), max abs err vs plain %.4g'
        % (name, ms, plain_ms, library_ms, bms, by, abs_err))
    return dict({'name': name, 'route': 'cuda', 'source': source,
                 'replaces': 'bifrost_tpu/ops/pallas_kernels.py:%d' % line,
                 'max_abs_err': abs_err, 'ms': ms, 'kernel_ms': ms,
                 'plain_ms': plain_ms, 'bound_ms': bms, 'bound_by': by,
                 'library_ms': library_ms}, **extra)


def detect_sweep(gpu_kernels, ws, x, scale):
    """K6 at every R from 1 to 32 and R = T on the frames ``x`` (a cut
    of the full-width gulp), and once on a copy whose rows start 4 bytes
    off 16: each launch on the kernel ``detect_path`` names, by the
    per-path counter; the tensor-core kernel bit-identical to the plain
    version, the dp4a kernel within 1e-6."""
    import torch
    T = x.shape[0]
    flat = torch.empty(x.numel() + 16, dtype=torch.int8, device='cuda')
    off = flat[4:4 + x.numel()].view(x.shape)
    off.copy_(x)
    out = {}
    for R, xv in [(r, x) for r in (1, 2, 4, 8, 16, 32, T)] + [(8, off)]:
        path = gpu_kernels.detect_path(xv, R)
        n, m = (gpu_kernels.launches[k] for k in (
            'beamform_detect_int8', 'beamform_detect_int8_mma'))
        got = gpu_kernels.beamform_detect_int8(*ws, xv, scale, R)
        want = gpu_kernels.beamform_detect_int8_plain(*ws, xv, scale, R)
        torch.cuda.synchronize()
        require(gpu_kernels.launches['beamform_detect_int8'] == n + 1 and
                gpu_kernels.launches['beamform_detect_int8_mma'] ==
                m + (path == 'mma'),
                'K6 at R %d did not count one launch on its %s kernel'
                % (R, path))
        require(path == ('mma' if 16 % R == 0 and xv is x else 'dp4a'),
                'K6 at R %d took the %s kernel' % (R, path))
        rel = float((got - want).abs().max() / want.abs().max())
        same = bool(torch.equal(got, want))
        key = 'R%d%s' % (R, '' if xv is x else '_off16')
        out[key] = {'path': path, 'rel': rel, 'bit_identical': same}
        log('K6 sweep T=%d %s: %s kernel, rel %.3g vs plain (bit-identical:'
            ' %s)' % (T, key, path, rel, same))
        require(same if path == 'mma' else rel <= 1e-6,
                'K6 at R %d (%s kernel) disagrees with its plain version: '
                '%.3g' % (R, path, rel))
    return out


def phase_beamform_kernels(gpu_kernels, beam):
    """K4, K5 and K6 at the full-width shapes of the beamformer path, each
    against its plain version (and the oracle), timed with CUDA events."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    T, F, S, P, B, R = BT, BF, BS, BP, BB, BR
    src = 'bifrost_tpu_torch/csrc/beamform.cu'
    eng = beam.Beamformer(beam_weights(), accuracy='int8')
    g = torch.Generator(device='cuda').manual_seed(7)
    x = torch.randint(-128, 128, (T, F, S, P, 2), dtype=torch.int8,
                      device='cuda', generator=g)
    # the per-pol views BeamformStage hands the kernels (pol 0)
    re, im = x[:, :, :, 0, 0], x[:, :, :, 0, 1]
    cuda = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()
    wr8, wi8 = cuda(eng.wr8[0]), cuda(eng.wi8[0])
    wr, wi = cuda(eng.wr[0]), cuda(eng.wi[0])
    # widened operands of the library yardsticks, built untimed
    w2 = cuda(beam._wide_weight_block(eng.wr8, eng.wi8)[0])
    z = torch.cat([re, im], dim=-1).reshape(T * F, 2 * S)
    # a pol's view touches every 32-byte sector of the interleaved gulp, so
    # each per-pol launch reads the whole gulp
    out_bytes = 2 * T * F * B * 4
    gulp_bytes = x.numel()
    nops = 8 * T * F * B * S

    # K4: exact int32, one int8 GEMM over every channel; both pols' views
    # of the gulp through the 16-byte staging
    k4_run = lambda: gpu_kernels.beamform_int8(wr8, wi8, re, im)
    plain4 = lambda: gpu_kernels.beamform_int8_plain(wr8, wi8, re, im)
    for p in (1, 0):
        rp, ip = x[:, :, :, p, 0], x[:, :, :, p, 1]
        n4, v4 = (gpu_kernels.launches[k] for k in ('beamform_int8',
                                                     'beamform_int8_vec16'))
        yr, yi = gpu_kernels.beamform_int8(wr8, wi8, rp, ip)
        require(gpu_kernels.launches['beamform_int8'] == n4 + 1 and
                gpu_kernels.launches['beamform_int8_vec16'] == v4 + 1,
                'K4 on the pol %d view did not take the 16-byte staging: %s'
                % (p, gpu_kernels.int8_staging(rp, ip)))
        pr, pi = gpu_kernels.beamform_int8_plain(wr8, wi8, rp, ip)
        torch.cuda.synchronize()
        require(torch.equal(yr, pr) and torch.equal(yi, pi),
                'K4 on pol %d is not bit-identical to its plain version' % p)
        if p:
            del yr, yi, pr, pi
    for f in (0, F // 2, F - 1):
        want_r, want_i = int64_beams(eng.wr8[0], eng.wi8[0],
                                     re[:, f:f + 1].cpu().numpy(),
                                     im[:, f:f + 1].cpu().numpy())
        require(np.array_equal(yr[:, f:f + 1].cpu().numpy(), want_r) and
                np.array_equal(yi[:, f:f + 1].cpu().numpy(), want_i),
                'K4 differs from the int64 oracle on channel %d' % f)
    log('K4 beamform_int8 (%d, %d, %d) x %d beams: both pols bit-identical '
        'to the plain version, pol 0 to the int64 oracle on 3 channels, '
        'both through the 16-byte staging' % (T, F, S, B))
    lib4 = lambda: torch._int_mm(z, w2)
    queued4 = {'kernel': cuda_ms_queued(k4_run),
               'plain': cuda_ms_queued(plain4, calls=5, runs=3),
               'library': cuda_ms_queued(lib4)}
    log('K4 queued (ms per call of 20 back to back): %s' % queued4)
    k4 = kernel_entry(
        'beamform_int8', src, 265, torch.complex(yr.double(), yi.double()),
        torch.complex(pr.double(), pi.double()), cuda_ms(k4_run),
        cuda_ms(plain4, runs=5),
        gulp_bytes + 2 * B * S + out_bytes, nops, PEAK_INT8_PER_S,
        cuda_ms(lib4), shape=[T, F, S, B],
        per='launch (one pol, one call bracketed)',
        staging=gpu_kernels.int8_staging(re, im),
        library='torch._int_mm of [re | im] (T*F, 2S) x widened (2S, 2B)',
        ms_queued=queued4,
        ms_queued_per='launch (median of batches of queued calls: 5 x 20; '
                      'plain 3 x 5)')
    del yr, yi, pr, pi

    # K5: bf16 products, float32 sums, one GEMM over every channel; the
    # main path's launch takes the 16-byte staging
    n5, v5 = (gpu_kernels.launches[k] for k in ('beamform_bf16',
                                                 'beamform_bf16_vec16'))
    yr, yi = gpu_kernels.beamform_bf16(wr, wi, re, im)
    require(gpu_kernels.launches['beamform_bf16'] == n5 + 1 and
            gpu_kernels.launches['beamform_bf16_vec16'] == v5 + 1,
            'K5 on the per-pol view did not take the 16-byte staging: %s'
            % (gpu_kernels.bf16_staging(re, im),))
    pr, pi = gpu_kernels.beamform_bf16_plain(wr, wi, re, im)
    torch.cuda.synchronize()
    got, want = torch.complex(yr, yi), torch.complex(pr, pi)
    rel5 = float((got - want).abs().max() / want.abs().max())
    log('K5 beamform_bf16 vs plain: rel %.3g' % rel5)
    require(rel5 <= 1e-5, 'K5 disagrees with its plain version: %.3g'
            % rel5)
    xs = (re[:, :4].double() + 1j * im[:, :4].double())
    ref = torch.einsum('tfs,bs->tfb', xs, (wr.double() + 1j * wi.double()))
    rel5o = float((got[:, :4] - ref).abs().max() / ref.abs().max())
    log('K5 vs float64 oracle (4 channels): rel %.3g' % rel5o)
    require(rel5o <= beam.BEAM_CLASSES['bf16'],
            'K5 outside the bf16 class of the oracle: %.3g' % rel5o)
    # the yardsticks: one bf16 GEMM of [re | im] against the widened block,
    # with an f32 output (K5's function) and with a bf16 output
    w2b = torch.cat([torch.cat([wr.T, wi.T], 1),
                     torch.cat([-wi.T, wr.T], 1)], 0).bfloat16()
    zb = z.bfloat16()
    k5_run = lambda: gpu_kernels.beamform_bf16(wr, wi, re, im)
    plain5 = lambda: gpu_kernels.beamform_bf16_plain(wr, wi, re, im)
    lib16 = lambda: torch.matmul(zb, w2b)
    lib32 = lambda: torch.mm(zb, w2b, out_dtype=torch.float32)
    try:
        y32 = lib32()
    except (TypeError, RuntimeError, NotImplementedError) as e:
        log('K5 yardstick: torch.mm(..., out_dtype=float32) not available '
            'on this card (%s)' % e)
        lib32 = y32 = None
    if y32 is not None:
        y32 = torch.complex(y32[:, :B], y32[:, B:]).reshape(T, F, B)
        lrel = max_abs_err(y32, want) / float(want.abs().max())
        log('K5 f32-output yardstick vs K5\'s plain version: rel %.3g'
            % lrel)
        del y32
    queued = {'kernel': cuda_ms_queued(k5_run),
              'plain': cuda_ms_queued(plain5, calls=5, runs=3),
              'library_bf16': cuda_ms_queued(lib16)}
    if lib32 is not None:
        queued['library'] = cuda_ms_queued(lib32)
    log('K5 queued (ms per call of 20 back to back): %s' % queued)
    k5 = kernel_entry(
        'beamform_bf16', src, 307, got, want, cuda_ms(k5_run),
        cuda_ms(plain5, runs=5),
        gulp_bytes + 2 * B * S * 4 + out_bytes, nops, PEAK_BF16_PER_S,
        cuda_ms(lib32) if lib32 is not None else None,
        shape=[T, F, S, B], per='launch (one pol, one call bracketed)',
        max_rel_err=rel5, oracle_rel_err=rel5o,
        staging=gpu_kernels.bf16_staging(re, im),
        library='torch.mm(out_dtype=float32) of bf16 [re | im] x widened '
                'f32 block rounded to bf16',
        library_bf16_ms=cuda_ms(lib16),
        library_bf16='bf16-output torch.matmul of the same operands',
        ms_queued=queued,
        ms_queued_per='launch (median of batches of queued calls: 5 x 20; '
                      'plain 3 x 5)')
    del yr, yi, pr, pi, got, want, zb, z
    torch.cuda.empty_cache()

    # K6: beamform -> Stokes -> frame sum, against plain and the oracle
    small = x[:BEAM_ORACLE_NTIME].cpu().numpy()
    got = beam.fused_detect(eng, torch.from_numpy(small).cuda(), R)
    orel = rel_err(got.cpu().numpy(), detect_oracle(eng, small, R))
    log('K6 beamform_detect_int8 vs float64 oracle (T=%d): rel %.3g'
        % (BEAM_ORACLE_NTIME, orel))
    require(orel < 1e-5, 'K6 fails the 1e-5 oracle gate: %.3g' % orel)
    ws = [cuda(a) for a in (eng.wr8[0], eng.wi8[0], eng.wr8[1],
                            eng.wi8[1])]
    sweep6 = detect_sweep(gpu_kernels, ws, x[:BEAM_SWEEP_NTIME],
                          eng.wscale)
    n6, m6 = (gpu_kernels.launches[k] for k in ('beamform_detect_int8',
                                                 'beamform_detect_int8_mma'))
    got = beam.fused_detect(eng, x, R)
    require(gpu_kernels.launches['beamform_detect_int8'] == n6 + 1 and
            gpu_kernels.launches['beamform_detect_int8_mma'] == m6 + 1,
            'K6 at full width did not take its tensor-core kernel (%s)'
            % gpu_kernels.detect_path(x, R))
    want = gpu_kernels.beamform_detect_int8_plain(*ws, x, eng.wscale, R)
    torch.cuda.synchronize()
    rel6 = float((got - want).abs().max() / want.abs().max())
    same6 = bool(torch.equal(got, want))
    log('K6 full width vs plain: rel %.3g (bit-identical: %s)'
        % (rel6, same6))
    require(same6, 'K6 is not bit-identical to its plain version at full '
            'width: rel %.3g' % rel6)
    chain = eng._fn('int8_wide', P)
    stages_re, stages_im = x[..., 0].transpose(2, 3), x[..., 1].transpose(2, 3)

    def library_chain6():
        y = chain(stages_re, stages_im)
        bx, by = y[:, :, 0], y[:, :, 1]
        xx, yy = bx.abs().square(), by.abs().square()
        xy = bx * by.conj()
        st = torch.stack([xx + yy, xx - yy, 2 * xy.real, -2 * xy.imag], 2)
        return st.reshape(T // R, R, F, 4, B).sum(1)

    lib6 = library_chain6()
    lrel = float((lib6 - want).abs().max() / want.abs().max())
    require(lrel < 1e-5, 'the library chain disagrees with K6: %.3g' % lrel)
    del lib6
    k6_run = lambda: beam.fused_detect(eng, x, R)
    plain6 = lambda: gpu_kernels.beamform_detect_int8_plain(
        *ws, x, eng.wscale, R)
    queued6 = {'kernel': cuda_ms_queued(k6_run),
               'plain': cuda_ms_queued(plain6, calls=2, runs=3),
               'library': cuda_ms_queued(library_chain6, calls=5, runs=3),
               'unfused_2x_k4': 2 * queued4['kernel']}
    log('K6 queued (ms per call of 20 back to back; the torch chain 3 x 5, '
        'plain 3 x 2; twice K4 as the unfused yardstick): %s' % queued6)
    k6 = kernel_entry(
        'beamform_detect_int8', src, 384, got, want, cuda_ms(k6_run),
        cuda_ms(plain6, runs=5),
        x.numel() + 4 * B * S + (T // R) * F * 4 * B * 4, 2 * nops,
        PEAK_INT8_PER_S, cuda_ms(library_chain6, runs=10),
        shape=[T, F, S, P, 2], rfactor=R, per='launch (one gulp)',
        max_rel_err=rel6, bit_identical=same6, oracle_rel_err=orel,
        path=gpu_kernels.detect_path(x, R), r_sweep=sweep6,
        library='torch chain int8_wide (torch._int_mm) -> Stokes -> '
                'frame sum',
        unfused_2x_k4='ms_queued: two K4 launches (one per pol), before '
                      'their Stokes and frame sum',
        ms_queued=queued6,
        ms_queued_per='launch (median of batches of queued calls: 5 x 20; '
                      'library 3 x 5, plain 3 x 2)')
    del got, want, x
    torch.cuda.empty_cache()
    return k4, k5, k6


def beam_gulps(seed=9, n=2):
    """``n`` full-width ci8 gulps (T, F, S, P, 2) int8 in host memory."""
    rng = np.random.default_rng(seed)
    return [rng.integers(-64, 64, size=(BT, BF, BS, BP, 2), dtype=np.int8)
            for _ in range(n)]


def run_beam_arm(bt, gulps, w, arm):
    """One arm of the beamformer pipeline; returns (outputs, seconds of
    the timed gulps, per-block host ms/gulp, the beam block)."""
    from bifrost_tpu_torch.stages import (BeamformStage, DetectStage,
                                          ReduceStage)
    header = {'name': 'beams', 'time_tag': 0,
              '_tensor': {'shape': [-1, BF, BS, BP], 'dtype': 'ci8',
                          'labels': ['time', 'freq', 'station', 'pol'],
                          'scales': [[0, 1]] * 4, 'units': [None] * 4}}
    accuracy, impl = {'K6': ('int8', None), 'K4': ('int8', 'pallas'),
                      'K5': ('bf16', 'pallas_bf16'), 'f32': ('f32', 'xla'),
                      'race': ('int8', None)}[arm]
    blocks = []

    def chain(h2d):
        if arm == 'K6':
            blocks.append(('beam', bt.blocks.fused(
                h2d, [BeamformStage(w, accuracy=accuracy),
                      DetectStage('stokes', axis='pol'),
                      ReduceStage('time', BR)])))
        else:
            b = bt.blocks.beamform(h2d, w, accuracy=accuracy, impl=impl)
            blocks.append(('beam', b))
            blocks.append(('detect', bt.blocks.fused(
                b, [DetectStage('stokes', axis='pol'),
                    ReduceStage('time', BR)])))
        return blocks

    out, secs, per_gulp = drive(bt, gulps, header, chain)
    return out, secs, per_gulp, blocks[0][1]


def phase_beamform_pipeline(bt, spec, gpu_kernels, beam, smi):
    import tempfile
    gulps = beam_gulps()
    w = beam_weights()
    ngulp = NWARM + NTIMED
    nsamp = BT * BF * BS * BP
    gop = 8 * BT * BF * BP * BB * BS / 1e9
    runs, rates = {}, {}
    for arm in ('K6', 'K4', 'K5', 'f32', 'race'):
        with contextlib.ExitStack() as stack:
            if arm == 'race':
                # the engine's own race, from an empty probe cache
                tmp = stack.enter_context(tempfile.TemporaryDirectory())
                stack.enter_context(environ(BF_CACHE_DIR=tmp))
            zero_counts(spec, gpu_kernels)
            out, secs, per_gulp, blk = run_beam_arm(bt, gulps, w, arm)
            counts = read_counts(spec, gpu_kernels)
        rates[arm] = {'msps': NTIMED * nsamp / secs / 1e6,
                      'gops': NTIMED * gop / secs}
        info = getattr(blk, 'impl_info', None)
        if info is None:
            info = {'chosen': dict(blk.engine.chosen),
                    'probe_ms': dict(blk.engine.probe_ms)}
        log('beamformer pipeline arm %s: %s, launches %s, %.1f Msamples/s, '
            '%.1f GOP/s (%s)' % (arm, info, counts, rates[arm]['msps'],
                                 rates[arm]['gops'], smi))
        log_per_gulp(per_gulp)
        runs[arm] = (out, counts, info)
        rates[arm]['per_gulp_ms'] = per_gulp
        rates[arm]['info'] = info
    info6 = runs['K6'][2]
    require(info6.get('impl') == 'cuda-beamform-detect' and
            info6.get('kernel') == 'cuda',
            'the K6 arm did not plan the CUDA beamform-detect: %s' % info6)
    for arm, name, per in (('K6', 'beamform_detect_int8', 1),
                           ('K4', 'beamform_int8', BP),
                           ('K5', 'beamform_bf16', BP)):
        n = runs[arm][1][name]
        require(n >= per * ngulp, '%s launched %d times for %d gulps'
                % (name, n, ngulp))
    for arm, name in (('K4', 'beamform_int8'), ('K5', 'beamform_bf16')):
        n = runs[arm][1]
        require(n[name + '_vec16'] == n[name],
                'the %s arm took the 16-byte staging in %d of %d launches'
                % (arm, n[name + '_vec16'], n[name]))
    n = runs['K6'][1]
    require(n['beamform_detect_int8_mma'] == n['beamform_detect_int8'],
            'the K6 arm took the tensor-core kernel in %d of %d launches'
            % (n['beamform_detect_int8_mma'], n['beamform_detect_int8']))
    race = runs['race'][2]
    for key, ms in race.get('probe_ms', {}).items():
        log('beamformer race (%s): ms per call %s; chose %s'
            % (key, ms, race['chosen'].get(key)))
    ref = runs['f32'][0]
    for k in ref:
        for arm in ('K6', 'K4', 'K5', 'f32', 'race'):
            a = runs[arm][0][k]
            require(a.shape == (BT // BR, BF, 4, BB) and
                    np.isfinite(a).all(),
                    'arm %s gulp %d: bad shape %s or non-finite output'
                    % (arm, k, a.shape))
        r46 = rel_err(runs['K4'][0][k], runs['K6'][0][k])
        bounds = {'K6': beam.BEAM_CLASSES['int8'],
                  'K4': beam.BEAM_CLASSES['int8'],
                  'K5': beam.BEAM_CLASSES['bf16'],
                  'race': beam.BEAM_CLASSES['int8']}
        rels = {arm: rel_err(runs[arm][0][k], ref[k]) for arm in bounds}
        log('gulp %d: K4 vs K6 rel %.3g; vs f32: %s'
            % (k, r46, ', '.join('%s %.3g' % kv for kv in rels.items())))
        require(r46 < 1e-5, 'K4 and K6 arms disagree on gulp %d: %.3g'
                % (k, r46))
        for arm, b in bounds.items():
            require(rels[arm] <= b, 'arm %s outside its class on gulp %d: '
                    '%.3g > %g' % (arm, k, rels[arm], b))
    return {'rates': rates,
            'launches': {arm: runs[arm][1] for arm in runs}}


_legacy_fn = {}


def legacy_probe(x):
    """K0 launched the way every wrapper launched before its C entry was
    bound once: the library looked up, argtypes and restype set, each
    pointer wrapped in a ctypes.c_void_p and a torch.cuda.Stream made, on
    every call, through a ctypes.CDLL (which releases the GIL for the
    call).  Same kernel; not counted in the launch counters.  It is timed
    beside K0 as the launch path's "before" in the same run."""
    import ctypes
    import torch
    from bifrost_tpu_torch import _build
    x = x.contiguous()
    out = torch.empty_like(x)
    _build.load('probe')
    # the library as ctypes.CDLL loads it (a call releases the GIL), with
    # its own function object: the cached binding of bf_probe stays as is
    lib = _legacy_fn.get('lib')
    if lib is None:
        lib = _legacy_fn['lib'] = ctypes.CDLL(_build._lib_path('probe')[1])
        lib.bf_error_string.argtypes = [ctypes.c_int]
        lib.bf_error_string.restype = ctypes.c_char_p
    fn = lib.bf_probe
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(out.data_ptr()),
             x.numel(), ctypes.c_void_p(
                 torch.cuda.current_stream(x.device).cuda_stream))
    _build.check(lib, err, 'legacy probe')
    return out


def phase_probe(gpu_kernels):
    """K0: available() builds and runs the probe kernel on the card once,
    and a second call answers from its cache; K0 timed beside torch.mul
    and beside its launch path before the binding cache."""
    import torch
    gpu_kernels._available_on.clear()
    before = gpu_kernels.launches['probe']
    t0 = time.perf_counter()
    ok = gpu_kernels.available()
    first_ms = (time.perf_counter() - t0) * 1e3
    require(ok is True, 'available() returned %r on the card' % (ok,))
    require(gpu_kernels.launches['probe'] == before + 1,
            'available() launched the probe %d times'
            % (gpu_kernels.launches['probe'] - before))
    require(gpu_kernels.available() is True and
            gpu_kernels.launches['probe'] == before + 1,
            'a second available() did not answer from its cache')
    x = torch.ones((8, 128), dtype=torch.float32, device='cuda')
    got = gpu_kernels.probe(x)
    want = x * 2
    torch.cuda.synchronize()
    log('K0 probe: available() True in %.1f ms (first call, one launch, '
        'library already built)' % first_ms)
    # bracketed, one call's time holds the wrapper's host time; queued (20
    # back to back), what a call costs the card while the host keeps up;
    # replayed from a CUDA graph, the device time alone
    k0_run = lambda: gpu_kernels.probe(x)
    lib0 = lambda: torch.mul(x, 2.0)
    old0 = lambda: legacy_probe(x)
    require(torch.equal(old0(), want), 'the legacy K0 launch differs')
    queued = {'kernel': cuda_ms_queued(k0_run),
              'plain': cuda_ms_queued(lambda: x * 2),
              'library': cuda_ms_queued(lib0),
              'legacy_launch': cuda_ms_queued(old0)}
    graph = {'kernel': cuda_ms_graph(k0_run), 'library': cuda_ms_graph(lib0)}
    legacy_ms = cuda_ms(old0)
    log('K0 queued (ms per call of 20 back to back): %s; device time from '
        'CUDA-graph replays: %s; the legacy launch path bracketed %.4f ms; '
        'K0 queued / torch.mul queued %.3f'
        % (queued, graph, legacy_ms, queued['kernel'] / queued['library']))
    return kernel_entry(
        'probe', 'bifrost_tpu_torch/csrc/probe.cu', 40, got, want,
        cuda_ms(k0_run), cuda_ms(lambda: x * 2),
        2 * x.numel() * 4, x.numel(), PEAK_FP32_PER_S,
        cuda_ms(lambda: torch.mul(x, 2.0)), shape=[8, 128],
        per='launch (one call bracketed)', available_first_call_ms=first_ms,
        library='torch.mul(x, 2.0)', ms_queued=queued,
        ms_queued_per='launch (median of 5 batches of 20 queued calls)',
        ms_graph=graph,
        ms_graph_per='launch (median of 5 replays of a CUDA graph of 20 '
                     'calls)', legacy_launch_ms=legacy_ms,
        legacy_launch='the same kernel through the launch path before the '
                      'binding cache (argtypes set, pointers wrapped and a '
                      'torch.cuda.Stream made on every call, the GIL '
                      'released for the call)')


def xcorr_oracle(re_i, im_i, re_j, im_j):
    """int64 oracle of vis = sum_t x_i conj(x_j) on numpy planes (..., T,
    F, n), cast to complex64 (exact below 2^24)."""
    ri, ii, rj, ij = (v.astype(np.int64) for v in (re_i, im_i, re_j, im_j))
    dot = lambda x, y: np.einsum('...tfa,...tfb->...fab', x, y)
    return (dot(ri, rj) + dot(ii, ij)).astype(np.complex64) + \
        1j * (dot(ii, rj) - dot(ri, ij)).astype(np.complex64)


def check_channels(name, got, planes):
    """``got`` (..., F, ni, nj) against the int64 oracle on XCHANNELS."""
    for f in XCHANNELS:
        sub = [p[..., f:f + 1, :].cpu().numpy() for p in planes]
        want = xcorr_oracle(*sub)
        require(np.array_equal(got[..., f:f + 1, :, :].cpu().numpy(), want),
                '%s differs from the int64 oracle on channel %d' % (name, f))


def xcorr_herm_shapes(gpu_kernels, x):
    """K7 beyond the FX gulp: x-stateful's 64-frame gulp (XST, XF, XN),
    the mesh arms' 256-frame gulp (XT, XF, XN), whose channel does not fit
    in shared memory (staged in time chunks, a tile at a time), and a
    ragged case (3 groups of 33 frames, 3 channels, 200 inputs: a tail of
    one frame past a multiple of 32) through the 16-byte and the scalar
    staging; each bit-identical to the plain version, the first and the
    ragged ones to the int64 oracle.  Returns the kernels-line fields."""
    import torch
    out = {}
    for name, T in (('x_stateful', XST), ('chunked_T256', XT)):
        re = x[:T, ..., 0].reshape(T, XF, XN)
        im = x[:T, ..., 1].reshape(T, XF, XN)
        v0 = gpu_kernels.launches['xcorr_herm_vec16']
        got = gpu_kernels.xcorr_herm(re, im)
        want = gpu_kernels.xcorr_herm_plain(re, im)
        torch.cuda.synchronize()
        require(gpu_kernels.launches['xcorr_herm_vec16'] == v0 + 1,
                'K7 at (%d, %d, %d) did not take the 16-byte staging'
                % (T, XF, XN))
        require(torch.equal(got, want), 'K7 at (%d, %d, %d) is not '
                'bit-identical to its plain version' % (T, XF, XN))
        if T == XST:
            check_channels('K7 (x-stateful)', got, (re, im, re, im))
        del got, want
        run = lambda: gpu_kernels.xcorr_herm(re, im)
        nbyte = 2 * T * XF * XN + 8 * XF * XN * XN
        out[name] = {'shape': [T, XF, XN], 'ms': cuda_ms(run),
                     'ms_queued': cuda_ms_queued(run),
                     'bound_ms': bound(nbyte, 8 * T * XF * XN * XN,
                                       PEAK_INT8_PER_S)[0]}
        log('K7 at (%d, %d, %d): bit-identical to its plain version; %s'
            % (T, XF, XN, out[name]))
    g = torch.Generator(device='cuda').manual_seed(14)
    gulp = torch.randint(-128, 128, (3 * 33, 3, 100, 2, 2), dtype=torch.int8,
                         device='cuda', generator=g)
    re = gulp[..., 0].reshape(3, 33, 3, 200)
    im = gulp[..., 1].reshape(3, 33, 3, 200)
    for layout, planes in (('16-byte', (re, im)),
                           ('scalar', (re.contiguous(), im.contiguous()))):
        v0 = gpu_kernels.launches['xcorr_herm_vec16']
        got = gpu_kernels.xcorr_herm(*planes)
        want = gpu_kernels.xcorr_herm_plain(*planes)
        torch.cuda.synchronize()
        require(gpu_kernels.launches['xcorr_herm_vec16'] - v0 ==
                (layout == '16-byte'), 'K7 (ragged) took the wrong staging')
        require(torch.equal(got, want), 'K7 (ragged, %s staging) is not '
                'bit-identical to its plain version' % layout)
        host = [p.cpu().numpy() for p in planes]
        require(np.array_equal(got.cpu().numpy(),
                               xcorr_oracle(host[0], host[1], host[0],
                                            host[1])),
                'K7 (ragged, %s staging) differs from the int64 oracle'
                % layout)
    log('K7 ragged (3, 33, 3, 200): bit-identical to its plain version and '
        'the int64 oracle through the 16-byte and the scalar staging')
    return out


def phase_xcorr_kernels(gpu_kernels):
    """K7 and K8 at the FX path's shapes, on the strided views of a ci8
    gulp, each against its plain version and the int64 oracle, timed
    beside the plain version and the complex64 einsum yardstick (the
    'xla' candidate; the int8 -> complex64 conversion is not timed)."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device='cuda').manual_seed(12)
    x = torch.randint(-128, 128, (XT, XF, XS, XP, 2), dtype=torch.int8,
                      device='cuda', generator=g)
    ng = XT // XR
    re = x[..., 0].reshape(ng, XR, XF, XN)
    im = x[..., 1].reshape(ng, XR, XF, XN)
    require(re.data_ptr() == x.data_ptr(), 'the K7 planes are not views')
    before, v0 = (gpu_kernels.launches[k] for k in ('xcorr_herm',
                                                     'xcorr_herm_vec16'))
    got = gpu_kernels.xcorr_herm(re, im)
    want = gpu_kernels.xcorr_herm_plain(re, im)
    torch.cuda.synchronize()
    require(gpu_kernels.launches['xcorr_herm'] == before + 1,
            'K7 took more than one launch for the gulp')
    require(gpu_kernels.launches['xcorr_herm_vec16'] == v0 + 1,
            'K7 on the gulp views did not take the 16-byte staging')
    require(got.shape == (ng, XF, XN, XN) and got.dtype == torch.complex64,
            'K7 gave %s %s' % (tuple(got.shape), got.dtype))
    require(torch.equal(got, want), 'K7 is not bit-identical to its plain '
            'version')
    check_channels('K7', got, (re, im, re, im))
    require(bool((got.imag != 0).any()), 'K7 gave no imaginary part')
    require(torch.equal(got.imag, -got.imag.transpose(-1, -2)),
            'the imaginary part of K7 is not antisymmetric')
    log('K7 xcorr_herm (%d, %d, %d, %d) -> (%d, %d, %d, %d): bit-identical '
        'to its plain version and to the int64 oracle on channels %s, '
        'imaginary part antisymmetric'
        % (ng, XR, XF, XN, ng, XF, XN, XN, list(XCHANNELS)))
    xc = torch.complex(re.float(), im.float())
    lib = lambda: torch.einsum('...tfi,...tfj->...fij', xc, xc.conj())
    k7_run = lambda: gpu_kernels.xcorr_herm(re, im)
    queued7 = {'kernel': cuda_ms_queued(k7_run),
               'library': cuda_ms_queued(lib, calls=5, runs=3)}
    log('K7 queued (ms per call of 20 back to back; library 3 x 5): %s'
        % queued7)
    k7 = kernel_entry(
        'xcorr_herm', 'bifrost_tpu_torch/csrc/xcorr.cu', 155, got, want,
        cuda_ms(k7_run),
        cuda_ms(lambda: gpu_kernels.xcorr_herm_plain(re, im), runs=3),
        2 * XT * XF * XN + 8 * ng * XF * XN * XN, 8 * XT * XF * XN * XN,
        PEAK_INT8_PER_S, cuda_ms(lib, runs=5),
        shape=[ng, XR, XF, XN], per='launch (one gulp, one call bracketed)',
        staging=gpu_kernels.xcorr_staging(re, im),
        library="complex64 torch.einsum('tfi,tfj->fij', x, x.conj()), the "
                "'xla' candidate, conversion untimed", ms_queued=queued7,
        ms_queued_per='launch (median of 5 batches of 20 queued calls; '
                      'library 3 x 5)')
    # the card's write rate in practice: zeroing the same 4.29 GB, queued
    k7['write_ceiling_ms'] = cuda_ms_queued(lambda: got.zero_())
    k7['write_ceiling'] = "out.zero_() of K7's output, queued"
    log('K7: zeroing its output (the write ceiling) takes %.4f ms'
        % k7['write_ceiling_ms'])
    del xc, want, got
    k7.update(xcorr_herm_shapes(gpu_kernels, x))

    # K8: a 4-way station-row block against all inputs, T = 128
    sb = XS // 4
    ri = x[:XR, :, :sb, :, 0].reshape(XR, XF, sb * XP)
    ii = x[:XR, :, :sb, :, 1].reshape(XR, XF, sb * XP)
    rj = x[:XR, ..., 0].reshape(XR, XF, XN)
    ij = x[:XR, ..., 1].reshape(XR, XF, XN)
    got8, want8, path8 = xcorr_cross_checked(gpu_kernels, 'the table shape',
                                             ri, ii, rj, ij)
    require(path8['rowblock'] == 1 and path8['vec16_i'] == 1 and
            path8['vec16_j'] == 1, 'K8 at the table shape did not take the '
            'row-block jobs and the 16-byte staging: %s' % path8)
    got7 = gpu_kernels.xcorr_herm(re, im)
    require(torch.equal(got8, got7[0, :, :sb * XP, :]),
            "K8's rows differ from K7's")
    check_channels('K8', got8, (ri, ii, rj, ij))
    log('K8 xcorr_cross (%d, %d, %d) x (%d, %d, %d): bit-identical to its '
        'plain version, to the int64 oracle on channels %s and to K7\'s '
        'rows; %s' % (XR, XF, sb * XP, XR, XF, XN, list(XCHANNELS), path8))
    del got7
    xi_c = torch.complex(ri.float(), ii.float())
    xj_c = torch.complex(rj.float(), ij.float())
    lib8 = lambda: torch.einsum('tfi,tfj->fij', xi_c, xj_c.conj())
    k8_run = lambda: gpu_kernels.xcorr_cross(ri, ii, rj, ij)
    queued8 = {'kernel': cuda_ms_queued(k8_run),
               'library': cuda_ms_queued(lib8, calls=5, runs=3)}
    log('K8 queued (ms per call of 20 back to back; library 3 x 5): %s'
        % queued8)
    k8 = kernel_entry(
        'xcorr_cross', 'bifrost_tpu_torch/csrc/xcorr.cu', 199, got8, want8,
        cuda_ms(k8_run),
        cuda_ms(lambda: gpu_kernels.xcorr_cross_plain(ri, ii, rj, ij),
                runs=5),
        2 * XR * XF * (sb * XP + XN) + 8 * XF * sb * XP * XN,
        8 * XR * XF * sb * XP * XN, PEAK_INT8_PER_S, cuda_ms(lib8),
        shape=[XR, XF, sb * XP, XN], per='launch', path=path8,
        library="complex64 torch.einsum('tfi,tfj->fij', x_i, x_j.conj()), "
                "conversion untimed", ms_queued=queued8,
        ms_queued_per='launch (median of 5 batches of 20 queued calls; '
                      'library 3 x 5)')
    # the card's write rate in practice: zeroing the same 537 MB, queued
    k8['write_ceiling_ms'] = cuda_ms_queued(lambda: got8.zero_())
    k8['write_ceiling'] = "out.zero_() of K8's output, queued"
    log('K8: zeroing its output (the write ceiling) takes %.4f ms'
        % k8['write_ceiling_ms'])
    del got8, want8, xi_c, xj_c
    k8.update(xcorr_cross_shapes(gpu_kernels, x))
    del x
    torch.cuda.empty_cache()
    return k7, k8


#: K8's launch counters: launches, rows and columns through the 16-byte
#: staging, row-block jobs
K8_COUNTERS = ('xcorr_cross', 'xcorr_cross_vec16_i', 'xcorr_cross_vec16_j',
               'xcorr_cross_rowblock')


def xcorr_cross_plan(gpu_kernels, T, ni, nj):
    """1 where K8's jobs are row blocks at this shape on this card."""
    import torch
    return gpu_kernels.xcorr_cross_plan(
        T, ni, nj, gpu_kernels.smem_optin(torch.device('cuda', 0)))[0]


def xcorr_cross_checked(gpu_kernels, what, ri, ii, rj, ij):
    """One K8 launch, held bit for bit to its plain version, and the path
    it took by the counters, which must be the one xcorr_staging and
    xcorr_cross_plan give.  Returns (got, want, path)."""
    import torch
    before = [gpu_kernels.launches[k] for k in K8_COUNTERS]
    got = gpu_kernels.xcorr_cross(ri, ii, rj, ij)
    want = gpu_kernels.xcorr_cross_plain(ri, ii, rj, ij)
    torch.cuda.synchronize()
    n, vi, vj, rb = (gpu_kernels.launches[k] - b
                     for k, b in zip(K8_COUNTERS, before))
    require(n == 1, 'K8 at %s took %d launches' % (what, n))
    path = {'vec16_i': vi, 'vec16_j': vj, 'rowblock': rb}
    plan = {'vec16_i': gpu_kernels.xcorr_staging(ri, ii),
            'vec16_j': gpu_kernels.xcorr_staging(rj, ij),
            'rowblock': xcorr_cross_plan(gpu_kernels, ri.shape[-3],
                                         ri.shape[-1], rj.shape[-1])}
    require(path == plan, 'K8 at %s took %s, not the planned %s'
            % (what, path, plan))
    require(torch.equal(got, want), 'K8 at %s is not bit-identical to its '
            'plain version' % what)
    return got, want, path


def xcorr_cross_shapes(gpu_kernels, x):
    """K8 beyond the table shape: the 2-D mesh's block (128 frames, 256
    rows against 512 columns; row-block jobs) and 256 frames of 128 rows
    against 512 columns (chunked jobs), each bit-identical to its plain
    version on the planned path and timed queued beside its bound.
    Returns the kernels-line fields."""
    out = {}
    for name, T, sr in (('mesh_2d', XR, XS // 2),
                        ('chunked_T256', XT, XS // 4)):
        ri = x[:T, :, :sr, :, 0].reshape(T, XF, sr * XP)
        ii = x[:T, :, :sr, :, 1].reshape(T, XF, sr * XP)
        rj = x[:T, ..., 0].reshape(T, XF, XN)
        ij = x[:T, ..., 1].reshape(T, XF, XN)
        shape = (T, XF, sr * XP, XN)
        got, want, path = xcorr_cross_checked(gpu_kernels, str(shape), ri,
                                              ii, rj, ij)
        require(path['rowblock'] == int(name == 'mesh_2d'),
                'K8 at %s took the wrong jobs: %s' % (shape, path))
        del got, want
        nbyte = 2 * T * XF * (sr * XP + XN) + 8 * XF * sr * XP * XN
        out[name] = {'shape': list(shape), 'path': path,
                     'ms_queued': cuda_ms_queued(
                         lambda: gpu_kernels.xcorr_cross(ri, ii, rj, ij)),
                     'bound_ms': bound(nbyte, 8 * T * XF * sr * XP * XN,
                                       PEAK_INT8_PER_S)[0]}
        log('K8 at %s: bit-identical to its plain version; %s'
            % (shape, out[name]))
    return out


def fx_gulps(seed=13, n=2):
    """``n`` full-width ci8 station gulps (T, F, S, P, 2) int8 in host
    memory."""
    rng = np.random.default_rng(seed)
    return [rng.integers(-128, 128, size=(XT, XF, XS, XP, 2), dtype=np.int8)
            for _ in range(n)]


def fx_oracle(gulp):
    """The FX chain's output for one gulp, made on the card: the port's
    F step (torch.fft through fftn_dispatch) and quantize, then the X
    step in float64 products (K7's plain version) and the accumulate.
    Returns a host array (1, F, S, P, S, P) complex64."""
    import torch
    from bifrost_tpu_torch.ops.fft import fftn_dispatch
    from bifrost_tpu_torch.ops.gpu_kernels import xcorr_herm_plain
    from bifrost_tpu_torch.ops.quantize import quantize_tensor
    x = torch.from_numpy(gulp).cuda()
    xc = torch.complex(x[..., 0].float(), x[..., 1].float())
    q = quantize_tensor(fftn_dispatch(xc, [1]), 'ci8', XSCALE)
    del x, xc
    ng = XT // XR
    vis = xcorr_herm_plain(q[..., 0].reshape(ng, XR, XF, XN),
                           q[..., 1].reshape(ng, XR, XF, XN))
    vis = vis.reshape(ng // XA, XA, XF, XN, XN).sum(dim=1)
    out = vis.reshape(ng // XA, XF, XS, XP, XS, XP).cpu().numpy()
    del q, vis
    torch.cuda.empty_cache()
    return out


def fx_header(labels, nframe):
    return {'name': 'fx', 'time_tag': 0, 'gulp_nframe': nframe,
            '_tensor': {'shape': [-1, XF, XS, XP], 'dtype': 'ci8',
                        'labels': labels, 'scales': [[0, 1]] * 4,
                        'units': [None] * 4}}


def run_fx_arm(bt, gulps, arm):
    """One arm of the FX correlator pipeline; returns (outputs, seconds
    of the timed gulps, per-block host ms/gulp, the X engine's choice).
    The blocks, and the device tensors their rings hold, are released
    before it returns: the next arm needs the card's memory."""
    blocks = []
    if arm == 'x-stateful':
        header = fx_header(['time', 'freq', 'station', 'pol'], XST)

        def chain(h2d):
            blocks.append(('correlate', bt.blocks.correlate(
                h2d, XSINT, impl='pallas')))
            return blocks
        out, secs, per_gulp = drive(bt, gulps, header, chain, XSWARM,
                                    XSTIMED, per_out=XSINT // XST)
        return out, secs, per_gulp, engine_info(blocks)
    accuracy, impl = {'fx-K7': ('int8', 'pallas'), 'fx-race': ('int8', None),
                      'fx-f32': ('f32', 'xla'),
                      'fx-storage': ('int8', 'pallas')}[arm]
    header = fx_header(['time', 'fine', 'station', 'pol'], XT)

    def chain(h2d):
        b = bt.blocks.fft(h2d, axes='fine', axis_labels='freq')
        blocks.append(('fft', b))
        b = bt.blocks.quantize(b, 'ci8', scale=XSCALE)
        blocks.append(('quantize', b))
        b = bt.blocks.correlate(b, XR, accuracy=accuracy, impl=impl,
                                fusable=True)
        blocks.append(('correlate', b))
        b = bt.blocks.accumulate(b, XA, fusable=True)
        blocks.append(('accumulate', b))
        if arm == 'fx-storage':
            # examples/fx_correlator.py's chain ends in the storage format
            blocks.append(('convert', bt.blocks.convert_visibilities(
                b, 'storage')))
        return blocks
    nwarm, ntimed = (SWARM, STIMED) if arm == 'fx-storage' else \
        (XWARM, XTIMED)
    out, secs, per_gulp = drive(bt, gulps, header, chain, nwarm, ntimed)
    return out, secs, per_gulp, engine_info(blocks)


def engine_info(blocks):
    """The correlate block's engine choice; drops every block."""
    import gc
    import torch
    eng = dict(blocks)['correlate'].engine
    info = {'chosen': dict(eng.chosen), 'probe_ms': dict(eng.probe_ms)}
    del blocks[:], eng
    gc.collect()
    torch.cuda.empty_cache()
    return info


def phase_fx_pipeline(bt, spec, gpu_kernels, smi):
    import tempfile
    import torch
    gulps = fx_gulps()
    oracle = [fx_oracle(gv) for gv in gulps]
    ngulp = XWARM + XTIMED
    nsamp = XT * XF * XS * XP
    gop = 8 * XT * XF * XN * XN / 1e9
    nbl = XS * (XS + 1) // 2 * XF
    runs, rates = {}, {}
    ref = None
    for arm in ('fx-K7', 'fx-race', 'fx-f32'):
        with contextlib.ExitStack() as stack:
            if arm == 'fx-race':
                # the engine's own gate and race from an empty probe
                # cache, asking the capability probe K0 afresh
                tmp = stack.enter_context(tempfile.TemporaryDirectory())
                stack.enter_context(environ(BF_CACHE_DIR=tmp))
                gpu_kernels._available_on.clear()
            torch.cuda.reset_peak_memory_stats()
            zero_counts(spec, gpu_kernels)
            out, secs, per_gulp, info = run_fx_arm(bt, gulps, arm)
            counts = read_counts(spec, gpu_kernels)
        peak = torch.cuda.max_memory_allocated() / 1e9
        rates[arm] = {'msps': XTIMED * nsamp / secs / 1e6,
                      'gops': XTIMED * gop / secs,
                      'baseline_channels_per_s':
                          XTIMED * (XT // (XR * XA)) * nbl / secs,
                      'peak_device_gb': peak, 'info': info,
                      'per_gulp_ms': per_gulp}
        log('FX pipeline arm %s: %s, launches %s, %.1f Msamples/s, %.1f '
            'X-step GOP/s, %.4g baseline-channels/s, peak device memory '
            '%.1f GB (%s)' % (arm, info, counts, rates[arm]['msps'],
                              rates[arm]['gops'],
                              rates[arm]['baseline_channels_per_s'], peak,
                              smi))
        log_per_gulp(per_gulp)
        for k, a in out.items():
            require(a.shape == (1, XF, XS, XP, XS, XP) and
                    a.dtype == np.complex64 and np.isfinite(a).all(),
                    'arm %s output %d: bad shape, type or values' % (arm, k))
            if ref is None:
                require(np.array_equal(a, oracle[k % len(gulps)]),
                        'arm %s output %d differs from the oracle' % (arm, k))
            else:
                require(np.array_equal(a, ref[k]), 'arm %s output %d is '
                        'not byte-identical to the fx-K7 arm' % (arm, k))
        if ref is None:
            ref = out
        log('arm %s: outputs %s byte-identical to %s'
            % (arm, sorted(out), 'the oracle' if arm == 'fx-K7'
               else 'the fx-K7 arm (and so to the oracle)'))
        runs[arm] = counts
        del out
    require(runs['fx-K7']['xcorr_herm'] == ngulp,
            'fx-K7: %d K7 launches for %d gulps'
            % (runs['fx-K7']['xcorr_herm'], ngulp))
    require(runs['fx-race']['probe'] >= 1, 'fx-race: K0 was not asked')
    key = [k for k in rates['fx-race']['info']['probe_ms']]
    require(key and 'pallas' in rates['fx-race']['info']['probe_ms'][key[0]],
            'fx-race: K7 did not race: %s' % rates['fx-race']['info'])
    del ref
    torch.cuda.empty_cache()

    # BASELINE config 5's X step alone: the stateful block over 64-frame
    # gulps, one output per 4 gulps, held to the int64 oracle
    xgulps = [g[i * XST:(i + 1) * XST] for g in gulps
              for i in range(XT // XST)]
    torch.cuda.reset_peak_memory_stats()
    zero_counts(spec, gpu_kernels)
    out, secs, per_gulp, info = run_fx_arm(bt, xgulps, 'x-stateful')
    counts = read_counts(spec, gpu_kernels)
    peak = torch.cuda.max_memory_allocated() / 1e9
    nxg = XSWARM + XSTIMED
    per_out = XSINT // XST
    require(counts['xcorr_herm'] == nxg, 'x-stateful: %d K7 launches for %d '
            'gulps' % (counts['xcorr_herm'], nxg))
    for k, a in out.items():
        block = np.concatenate([xgulps[(k * per_out + i) % len(xgulps)]
                                for i in range(per_out)])
        re = block[..., 0].reshape(XSINT, XF, XN)
        im = block[..., 1].reshape(XSINT, XF, XN)
        rc, ic = torch.from_numpy(re).cuda(), torch.from_numpy(im).cuda()
        whole = gpu_kernels.xcorr_herm_plain(rc, ic).cpu().numpy()
        require(np.array_equal(a.reshape(XF, XN, XN), whole),
                'x-stateful output %d differs from the float64 products'
                % k)
        del rc, ic, whole
        for f in XCHANNELS:
            want = xcorr_oracle(re[:, f:f + 1], im[:, f:f + 1],
                                re[:, f:f + 1], im[:, f:f + 1])
            require(np.array_equal(a[0, f].reshape(XN, XN), want[0]),
                    'x-stateful output %d channel %d differs from the int64 '
                    'oracle' % (k, f))
        require(np.isfinite(a).all() and a.shape == (1, XF, XS, XP, XS, XP),
                'x-stateful output %d: bad shape or values' % k)
    samp = XST * XF * XS * XP
    rates['x-stateful'] = {
        'msps': XSTIMED * samp / secs / 1e6,
        'gops': XSTIMED * 8 * XST * XF * XN * XN / 1e9 / secs,
        'baseline_channels_per_s': XSTIMED // per_out * nbl / secs,
        'peak_device_gb': peak, 'per_gulp_ms': per_gulp, 'info': info}
    log('FX pipeline arm x-stateful: launches %s, %.1f Msamples/s, %.1f '
        'X-step GOP/s, %.4g baseline-channels/s, peak device memory %.1f '
        'GB; outputs %s equal the float64 products (exact) and the int64 '
        'oracle on channels %s (%s)'
        % (counts, rates['x-stateful']['msps'], rates['x-stateful']['gops'],
           rates['x-stateful']['baseline_channels_per_s'], peak, sorted(out),
           list(XCHANNELS), smi))
    log_per_gulp(per_gulp)
    runs['x-stateful'] = counts
    del out
    torch.cuda.empty_cache()
    return {'rates': rates, 'launches': runs, 'gulps': gulps,
            'oracle': oracle}


def phase_xcorr_int8(L, gpu_kernels):
    """xcorr_int8's cross family through its public entry point, as the
    station-sharded mesh plan calls it: the four 64-station row blocks of
    a T=128 ci8 cut against all inputs, K8 forced; the rows stacked equal
    the auto family's full matrix."""
    import torch
    g = torch.Generator(device='cuda').manual_seed(14)
    x = torch.randint(-128, 128, (XR, XF, XS, XP, 2), dtype=torch.int8,
                      device='cuda', generator=g)
    rj = x[..., 0].reshape(XR, XF, XN)
    ij = x[..., 1].reshape(XR, XF, XN)
    sb = XS // 4
    for k in K8_COUNTERS:
        gpu_kernels.launches[k] = 0
    rows = [L.xcorr_int8(x[:, :, b * sb:(b + 1) * sb, :, 0]
                         .reshape(XR, XF, sb * XP),
                         x[:, :, b * sb:(b + 1) * sb, :, 1]
                         .reshape(XR, XF, sb * XP), rj, ij, impl='pallas')
            for b in range(4)]
    counts = {k: gpu_kernels.launches[k] for k in K8_COUNTERS}
    n = counts['xcorr_cross']
    full = L.xcorr_int8(rj, ij, impl='pallas')
    torch.cuda.synchronize()
    require(n == 4, 'xcorr_int8 cross: %d K8 launches for 4 blocks' % n)
    require(counts['xcorr_cross_rowblock'] ==
            4 * xcorr_cross_plan(gpu_kernels, XR, sb * XP, XN),
            'xcorr_int8 cross: K8 jobs off the plan: %s' % counts)
    require(torch.equal(torch.cat(rows, dim=1), full),
            'the cross blocks differ from the auto-correlation')
    log('xcorr_int8 cross family: 4 station-row blocks (K8) equal the auto '
        'family (K7) at (%d, %d, %d); K8 counters %s' % (XR, XF, XN, counts))
    del rows, full, x
    torch.cuda.empty_cache()
    return counts


def fdmt_work(plan, T):
    """(bytes, adds) of one gulp's merge steps, from the plan's tables.
    A step reads each (row, delay) of its input state that its tables
    name once: a lo pair (rows_lo, d1) whole, a hi pair (rows_hi, d2)
    from the least shift d1 any output row reads it with; rows a table
    never names (a subband's delays past its own nd) are not read.  It
    writes its whole output once; one add per output element of a merged
    (not passthrough) subband."""
    nbyte = nadd = 0
    for st in plan._plan['steps']:
        nout, nd = st.d1.shape
        nd_in = int(max(st.d1.max(), st.d2.max())) + 1
        lo = np.unique(st.rows_lo[:, None].astype(np.int64) * nd_in + st.d1)
        merged = ~st.passthrough
        hi = (st.rows_hi[merged, None].astype(np.int64) * nd_in +
              st.d2[merged]).ravel()
        shift = np.broadcast_to(st.d1[merged], (int(merged.sum()), nd)) \
            .ravel()
        key, inv = np.unique(hi, return_inverse=True)
        least = np.full(len(key), T, np.int64)
        np.minimum.at(least, inv, shift)
        nread = len(lo) * T + int(np.maximum(T - least, 0).sum())
        nbyte += (nread + nout * nd * T) * 4
        nadd += int(merged.sum()) * nd * T
    return nbyte, nadd


def phase_fdmt_kernel(gpu_kernels, F):
    """K3 over every merge step of three plans at the full-width span
    (16384 + 1970 frames): the 4096-channel plan, a 3000-channel plan over
    the same band (passthrough rows and the rows_hi clamp) and the
    4096-channel plan with negative delays.  Each step is bit-identical to
    the plain version, the K3 core to the torch gather core, and both are
    within fdmt_gate_rtol() of a float64 reference: fdmt_numpy on the host
    for the first plan (which also holds the float64 gather core used as
    the reference of the other two and of the pipeline arms).  Times K3,
    the plain version and the gather core per gulp at the first plan."""
    import torch
    rtol = F.fdmt_gate_rtol()
    T = FG + FMD
    entry = None
    for label, nchan, sgn in (('full', FCH, 1), ('passthrough', FODD, 1),
                              ('negative', FCH, -1)):
        df = 400.0 / nchan
        neg = sgn < 0
        plan = F.Fdmt().init(nchan, FMD, FF0, df)
        g = torch.Generator(device='cuda').manual_seed(31 + nchan + sgn)
        x = torch.randn((1, nchan, T), device='cuda', generator=g)
        tabs = plan._step_tables(x.device)
        state = F._init_state(x, plan._plan['nd_init'], sgn)
        states, npass, err = [], 0, 0.0
        for t, st in zip(tabs, plan._plan['steps']):
            got = gpu_kernels.fdmt_step(state, t['d1'], t['d2'], t['pt'],
                                        sgn)
            want = gpu_kernels.fdmt_step_plain(state, t['d1'], t['d2'],
                                               t['pt'], sgn)
            err = max(err, float((got - want).abs().max()))
            require(torch.equal(got, want), 'K3 (%s plan) differs from its '
                    'plain version at a step of shape %s'
                    % (label, tuple(st.d1.shape)))
            npass += int(st.passthrough.sum())
            states.append(state)
            state = got
        k3 = state[:, 0, :FMD]
        require(torch.equal(k3, plan._core_jax(neg)(x)),
                'the K3 core (%s plan) differs from the gather core' % label)
        ref_s = None
        ref = plan._core_jax(neg)(x.double())[0]
        if label == 'full':
            t0 = time.perf_counter()
            ref_np = F.fdmt_numpy(nchan, FMD, FF0, df, x[0].cpu().numpy(),
                                  negative_delays=neg)
            ref_s = time.perf_counter() - t0
            gref = rel_err(ref.cpu().numpy(), ref_np)
            require(gref < 1e-12, 'the float64 gather core differs from '
                    'fdmt_numpy by %.3g' % gref)
        rel = float((k3[0].double() - ref).abs().max() / ref.abs().max())
        require(rel <= rtol, 'K3 (%s plan) is %.3g from the float64 '
                'reference (gate %g)' % (label, rel, rtol))
        if label == 'passthrough':
            require(npass > 0, 'the %d-channel plan has no passthrough rows'
                    % nchan)
        log('K3 fdmt_step, %s plan (%d channels, sgn %+d, %d steps, %d '
            'passthrough rows, T=%d): every step bit-identical to its plain '
            'version, K3 core bit-identical to the gather core, rel %.3g of '
            'the float64 reference%s'
            % (label, nchan, sgn, len(tabs), npass, T, rel,
               ' (fdmt_numpy on the host in %.1f s; float64 gather core on '
               'the card %.3g from it)' % (ref_s, gref) if ref_s else ''))
        if label != 'full':
            continue
        steps = list(zip(states, tabs))

        def k3_gulp():
            for s, t in steps:
                gpu_kernels.fdmt_step(s, t['d1'], t['d2'], t['pt'], sgn)

        def plain_gulp():
            for s, t in steps:
                gpu_kernels.fdmt_step_plain(s, t['d1'], t['d2'], t['pt'],
                                            sgn)

        def gather_gulp():
            for s, t in steps:
                F._torch_merge_step(s, t, sgn, T)

        ms = cuda_ms(k3_gulp)
        step_ms = [cuda_ms(lambda s=s, t=t: gpu_kernels.fdmt_step(
            s, t['d1'], t['d2'], t['pt'], sgn)) for s, t in steps]
        plain_ms = cuda_ms(plain_gulp, runs=5)
        gather_ms = cuda_ms(gather_gulp, runs=5)
        core_ms = {'pallas': cuda_ms(lambda: plan._core_pallas(neg)(x),
                                     runs=5),
                   'xla': cuda_ms(lambda: plan._core_jax(neg)(x), runs=5)}
        nbyte, nadd = fdmt_work(plan, T)
        bms, by = bound(nbyte, nadd)
        log('K3 per gulp (%d launches): kernel %.4f ms, plain %.4f ms, torch '
            'gather steps %.4f ms (several calls, no single torch call), '
            'bound %.4f ms (%s, %.4g GB); per step %s ms; whole cores '
            '(init + steps) K3 %.4f ms, gather %.4f ms'
            % (len(steps), ms, plain_ms, gather_ms, bms, by, nbyte / 1e9,
               ['%.4f' % m for m in step_ms], core_ms['pallas'],
               core_ms['xla']))
        entry = {'name': 'fdmt_step', 'route': 'cuda',
                 'source': 'bifrost_tpu_torch/csrc/fdmt.cu',
                 'replaces': 'bifrost_tpu/ops/pallas_kernels.py:459',
                 'max_abs_err': err, 'ms': ms, 'kernel_ms': ms,
                 'plain_ms': plain_ms, 'bound_ms': bms, 'bound_by': by,
                 'library_ms': None, 'yardstick_ms': gather_ms,
                 'yardstick': 'the torch gather core\'s merge steps '
                              '(several calls, no single torch call)',
                 'step_ms': step_ms, 'core_ms': core_ms,
                 'per': 'gulp (%d launches, one per merge step)'
                        % len(steps),
                 'shape': [FCH, FMD, T], 'oracle_rel_err': rel,
                 'numpy_reference_s': ref_s}
        del steps, states
    torch.cuda.empty_cache()
    return entry


@contextlib.contextmanager
def environ(**values):
    """Set (a str) or unset (None) environment variables for a block."""
    old = {k: os.environ.get(k) for k in values}
    for k, v in values.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def pulse_delays(d):
    """The injection's delay of each channel for a pulse at trial ``d``:
    round(d * cff(f0, f_c) / cff(f0, f_top)) with f_c the channel's lower
    edge (config 22's injection)."""
    from bifrost_tpu_torch.ops.fdmt import _cff
    band = _cff(FF0, FF0 + FCH * FDF, -2.0)
    frac = np.array([_cff(FF0, FF0 + c * FDF, -2.0) / band
                     for c in range(FCH)])
    return np.rint(d * frac).astype(np.int64)


def fdmt_stream():
    """The seeded [freq, time] f32 noise stream of FWARM + FTIMED gulps on
    the card, and the same stream with the FPULSES injected: in channel c
    a pulse at (trial d, frame t0) adds FAMP to frames t0 + delay_c + [0,
    FPW), delay_c from pulse_delays."""
    import torch
    N = (FWARM + FTIMED) * FG
    g = torch.Generator(device='cuda').manual_seed(41)
    noise = torch.randn((FCH, N), device='cuda', generator=g)
    x = noise.clone()
    chans = torch.arange(FCH, device='cuda')[:, None]
    for d, t0 in FPULSES:
        delay = pulse_delays(d)
        idx = torch.from_numpy(t0 + delay[:, None] +
                               np.arange(FPW)[None]).to('cuda')
        require(int(idx.max()) < N, 'pulse (%d, %d) runs past the stream'
                % (d, t0))
        x[chans, idx] += FAMP
    return noise, x


def fdmt_oracle(plan, window, ntap):
    """The float64 oracle chain on one [freq, time] window: the FDMT (the
    float64 gather core, held to fdmt_numpy in phase_fdmt_kernel), then,
    with ``ntap`` > 1, the fixed-order boxcar.  Returns (max_delay,
    frames) float64 with the frames whose lookahead the window holds."""
    dm = plan._core_jax(False)(window[None].double())[0]
    n = dm.shape[-1] - (ntap - 1)
    out = dm[:, :n].clone()
    for i in range(1, ntap):
        out += dm[:, i:i + n]
    return out


def run_fdmt_arm(bt, source, chain, nout_frames):
    """Drive source -> chain -> copy('system') -> a sink that writes every
    output span into one host array of ``nout_frames`` frames on the last
    axis.  Returns (array, output header, seconds of the FTIMED timed
    gulps at the sink, seconds from the source's first gulp to the sink's
    last, per-block host ms/gulp over each block's own gulps after its
    first FWARM, the chain's blocks).

    Six rings of three gulps lie between source and sink, more than the
    run's gulps: a block at the head can run a whole run ahead, and the
    sink's window then times the tail draining.  So each block's own
    steady ms/gulp is taken as well (a thread snapshots its totals when
    it has done FWARM gulps); the slowest block's time bounds the chain's
    rate."""
    import threading
    ngulp = FWARM + FTIMED

    class Sink(bt.SinkBlock):
        def __init__(self, iring):
            super(Sink, self).__init__(iring)
            self.n = self.off = 0
            self.t0 = self.t1 = self.out = self.header = None

        def on_sequence(self, iseq):
            self.header = iseq.header
            shape = [s for s in iseq.header['_tensor']['shape'] if s != -1]
            self.out = np.empty(shape + [nout_frames], np.float32)

        def on_data(self, ispan):
            if self.n == FWARM - 1:
                self.t0 = time.perf_counter()
            elif self.n == ngulp - 1:
                self.t1 = time.perf_counter()
            a = ispan.data.as_numpy()
            self.out[..., self.off:self.off + a.shape[-1]] = a
            self.off += a.shape[-1]
            self.n += 1

    snaps, done = {}, threading.Event()

    def watch(roles):
        while not done.is_set():
            for role, blk in roles:
                if role not in snaps and blk.perf_totals['ngulp'] >= FWARM:
                    snaps[role] = dict(blk.perf_totals)
            time.sleep(5e-4)

    with bt.Pipeline() as p:
        src = source()
        h2d = bt.blocks.copy(src, space='cuda')
        blocks = chain(h2d)
        d2h = bt.blocks.copy(blocks[-1][1], space='system')
        sink = Sink(d2h)
        roles = [('source', src), ('h2d', h2d)] + blocks + \
            [('d2h', d2h), ('sink', sink)]
        watcher = threading.Thread(target=watch, args=(roles,), daemon=True)
        watcher.start()
        t_start = time.perf_counter()
        try:
            p.run()
        finally:
            done.set()
            watcher.join()
    require(sink.n == ngulp and sink.off == nout_frames,
            'the sink received %d spans and %d frames, not %d and %d'
            % (sink.n, sink.off, ngulp, nout_frames))
    per_gulp = {}
    for role, blk in roles:
        tot, snap = blk.perf_totals, snaps[role]
        n = tot['ngulp'] - snap['ngulp']
        require(n > 0, '%s ran no gulp after its first %d' % (role, FWARM))
        per_gulp[role] = {k: (tot[k] - snap[k]) / n * 1e3
                          for k in ('acquire', 'reserve', 'process')}
    return (sink.out, sink.header, sink.t1 - sink.t0, sink.t1 - t_start,
            per_gulp, blocks)


def freq_time_source(bt, host):
    """A source of [freq, time] f32 gulps from the host stream ``host``
    (FCH, N): freq lanes are the ring's ringlets."""
    header = {'name': 'frb', 'time_tag': 0,
              '_tensor': {'shape': [FCH, -1], 'dtype': 'f32',
                          'labels': ['freq', 'time'],
                          'scales': [[FF0, FDF], [0.0, FTSAMP]],
                          'units': ['MHz', 's']}}

    class Source(bt.SourceBlock):
        def __init__(self):
            super(Source, self).__init__(['frb'], FG, space='system')
            self.k = 0

        def create_reader(self, name):
            return contextlib.nullcontext()

        def on_sequence(self, reader, name):
            return [json.loads(json.dumps(header))]

        def on_data(self, reader, ospans):
            if self.k * FG >= host.shape[1]:
                return [0]
            ospans[0].data.as_numpy()[...] = \
                host[:, self.k * FG:(self.k + 1) * FG]
            self.k += 1
            return [FG]
    return Source


def write_filterbank(bt, path_dir, u8_tf):
    """Write the 8-bit stream ``u8_tf`` (N, 1, FCH) to <path_dir>/frb.fil
    through the port's write_sigproc block (its header code and data
    writer), from a [time, pol, freq] u8 source."""
    header = {'name': 'frb.fil', 'time_tag': 0, 'telescope': 'Parkes',
              'machine': 'FAKE', 'source_name': 'FRB_SIM', 'refdm': 0.0,
              '_tensor': {'shape': [-1, 1, FCH], 'dtype': 'u8',
                          'labels': ['time', 'pol', 'freq'],
                          'scales': [[59000 * 86400.0 - 40587 * 86400.0,
                                      FTSAMP], None, [FF0, FDF]],
                          'units': ['s', None, 'MHz']}}

    class Source(bt.SourceBlock):
        def __init__(self):
            super(Source, self).__init__(['u8'], FG, space='system')
            self.k = 0

        def create_reader(self, name):
            return contextlib.nullcontext()

        def on_sequence(self, reader, name):
            return [json.loads(json.dumps(header))]

        def on_data(self, reader, ospans):
            if self.k * FG >= u8_tf.shape[0]:
                return [0]
            ospans[0].data.as_numpy()[...] = \
                u8_tf[self.k * FG:(self.k + 1) * FG]
            self.k += 1
            return [FG]

    with bt.Pipeline() as p:
        bt.blocks.write_sigproc(Source(), path=path_dir)
        p.run()
    return os.path.join(path_dir, 'frb.fil')


def pulse_peaks(out, ntap):
    """For every injected pulse, the (trial, frame) of the largest value of
    the ``ntap``-frame box sum of ``out`` (max_delay, frames) near it.
    With ntap 1 the box sum is the boxcar the search's matched filter
    applies; an FPW-wide pulse peaks where it starts."""
    found = []
    for d, t0 in FPULSES:
        d0, d1 = max(d - 4, 0), min(d + 5, out.shape[0])
        f0, f1 = t0 - 24, t0 + 24 + ntap
        w = out[d0:d1, f0:f1].astype(np.float64)
        if ntap > 1:
            w = sum(w[:, i:w.shape[1] - ntap + 1 + i] for i in range(ntap))
        i, j = np.unravel_index(int(np.argmax(w)), w.shape)
        found.append((d0 + int(i), f0 + int(j)))
    return found


def fdmt_windows(plan, trials):
    """The frames each channel adds to output frame t of each FDMT trial
    (positive delays): [t + D[i, c], t + D[i, c] + K[i, c]] for trial
    ``trials[i]``, walked down the plan's tables from the last step (the
    lo half keeps the shift, the hi half adds d1; K is the init delay)."""
    n = len(trials)
    tr, row = np.arange(n), np.zeros(n, np.int64)
    dly, sh = np.asarray(trials, np.int64), np.zeros(n, np.int64)
    for st in reversed(plan._plan['steps']):
        a, b = st.d1[row, dly], st.d2[row, dly]
        m = ~st.passthrough[row]
        tr = np.concatenate([tr, tr[m]])
        sh = np.concatenate([sh, sh[m] + a[m]])
        dly = np.concatenate([a, b[m]])
        row = np.concatenate([st.rows_lo[row], st.rows_hi[row][m]])
    D = np.zeros((n, plan._plan['nchan']), np.int64)
    K = np.zeros_like(D)
    D[tr, row], K[tr, row] = sh, dly
    return D, K


def pulse_expect(plan):
    """For every injected pulse, {trial: frames} for the trials within 1
    of its own: the frames where the noiseless FPW-frame box sum of that
    trial's FDMT row peaks, from the plan's per-channel windows
    (fdmt_windows) over the injected frames (pulse_delays)."""
    us = np.arange(-24, 24 + FPW)
    expect = []
    for d, t0 in FPULSES:
        trials = [i for i in (d - 1, d, d + 1) if 0 <= i < FMD]
        D, K = fdmt_windows(plan, trials)
        inj = pulse_delays(d)
        lo = us[None, :, None] + D[:, None, :]
        hit = np.minimum(lo + K[:, None, :], inj + FPW - 1) - \
            np.maximum(lo, inj) + 1
        r = np.maximum(hit, 0).sum(-1)
        box = sum(r[:, j:r.shape[1] - FPW + 1 + j] for j in range(FPW))
        expect.append({i: tuple(int(t0 + u) for u in
                                us[:box.shape[1]][box[k] == box[k].max()])
                       for k, i in enumerate(trials)})
    return expect


def check_peaks(arm, found, expect):
    """Each pulse peaks within 1 trial of its own, at the very frame the
    plan's windows give for that trial (pulse_expect)."""
    for (d, t0), (fd, ft), want in zip(FPULSES, found, expect):
        require(fd in want and ft in want[fd],
                '%s: the pulse injected at trial %d, frame %d peaks at %d, '
                '%d; expected at a frame of %s' % (arm, d, t0, fd, ft, want))
    log('%s: all %d injected pulses peak within 1 trial of where they were '
        'injected, each at the frame the plan gives: %s'
        % (arm, len(FPULSES), found))


def phase_fdmt_pipeline(bt, spec, gpu_kernels, F, smi):
    """The FDMT arms through the port's Pipeline at full width (see the
    module docstring), each checked against the float64 oracle chain."""
    import tempfile
    import torch
    rtol = F.fdmt_gate_rtol()
    ngulp = FWARM + FTIMED
    N = ngulp * FG
    nsamp = FTIMED * FG * FCH
    t_setup = time.perf_counter()
    noise, x = fdmt_stream()
    plan = F.Fdmt().init(FCH, FMD, FF0, FDF)
    nsteps = len(plan._plan['steps'])
    halo = FMD + FNTAP - 1
    # where the plan's own per-channel delays put each pulse's peak: within
    # a frame of its injected frame at its own trial
    expect = pulse_expect(plan)
    offs = [[f - t0 for f in want[d]]
            for (d, t0), want in zip(FPULSES, expect)]
    require(all(abs(o) <= 1 for off in offs for o in off),
            'the plan puts a pulse more than a frame from where it was '
            'injected: %s' % offs)
    log('FDMT pulses: the plan puts each peak, at its own trial, at these '
        'frames from the injected one: %s' % offs)
    # the threshold: config 22's false-alarm rule on the noise-only
    # realization of the first span
    thr = float(np.quantile(fdmt_oracle(plan, noise[:, :FG + halo], FNTAP)
                            .cpu().numpy(), 1.0 - FFAR))
    del noise
    host = x.cpu().numpy()
    u8 = (x * 16 + 128).round().clamp(0, 255).to(torch.uint8)
    rates = {}
    log('FDMT stream: %d gulps of %d x %d f32 (%.2f GB), %d pulses, '
        'threshold %.6g at FAR %g; set-up %.1f s'
        % (ngulp, FCH, FG, host.nbytes / 1e9, len(FPULSES), thr, FFAR,
           time.perf_counter() - t_setup))
    # xfer.to_device makes a strided host span contiguous before staging
    # it: the frb source's span is FCH ringlets of FG frames
    copies = []
    for _ in range(5):
        t0 = time.perf_counter()
        np.ascontiguousarray(host[:, :FG])
        copies.append((time.perf_counter() - t0) * 1e3)
    span_copy_ms = float(np.median(copies))
    log('contiguous copy of a %d-ringlet host span (%.0f MB), as '
        'xfer.to_device makes it per frb gulp: %.2f ms (host clock, median '
        'of 5)' % (FCH, FCH * FG * 4 / 1e6, span_copy_ms))

    def report(arm, secs, secs_run, per_gulp, counts, extra):
        peak = torch.cuda.max_memory_allocated() / 1e9
        slow = max(per_gulp, key=lambda r: per_gulp[r]['process'])
        slow_ms = per_gulp[slow]['process']
        rates[arm] = dict({
            'msps': nsamp / secs / 1e6, 'seconds': secs,
            'msps_run': ngulp * FG * FCH / secs_run / 1e6,
            'seconds_run': secs_run, 'slowest_block': slow,
            'slowest_block_ms': slow_ms,
            'msps_slowest_block': FG * FCH / slow_ms / 1e3,
            'peak_device_gb': peak, 'per_gulp_ms': per_gulp,
            'launches': counts}, **extra)
        log('FDMT arm %s (Msamples/s of channel-samples of input): %.1f at '
            'the sink over the %d timed gulps, %.1f over the whole run with '
            'its start (%.2f s), %.1f at the slowest block (%s, %.2f ms of '
            'process per gulp); launches %s, peak device memory %.1f GB, '
            '%s (%s)'
            % (arm, rates[arm]['msps'], FTIMED, rates[arm]['msps_run'],
               secs_run, rates[arm]['msps_slowest_block'], slow, slow_ms,
               counts, peak, extra, smi))
        log_per_gulp(per_gulp)

    # fdmt-file: BASELINE config 3's path from an 8-bit .fil file
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        path = write_filterbank(bt, tmp, u8.T.contiguous().cpu().numpy()
                                .reshape(N, 1, FCH))
        write_s = time.perf_counter() - t0
        blocks = []

        def file_chain(h2d):
            b = bt.blocks.transpose(h2d, ['pol', 'freq', 'time'])
            blocks.append(('transpose', b))
            blocks.append(('fdmt', bt.blocks.fdmt(b, max_dm=FMAXDM)))
            return blocks

        with environ(BF_FDMT_IMPL='pallas'):
            torch.cuda.reset_peak_memory_stats()
            zero_counts(spec, gpu_kernels)
            out, hdr, secs, secs_run, per_gulp, _ = run_fdmt_arm(
                bt, lambda: bt.blocks.read_sigproc([path], FG), file_chain,
                N - FMD)
            counts = read_counts(spec, gpu_kernels)
    md = hdr['_tensor']['shape'][-2]
    require(md == FMD, 'fdmt(max_dm=%g) sized max_delay %d, not %d'
            % (FMAXDM, md, FMD))
    # one run of the core per gulp, and one in the block's on_sequence
    # warm-up
    require(counts['fdmt_step'] == (ngulp + 1) * nsteps,
            'fdmt-file: %d K3 launches for %d gulps and the warm-up'
            % (counts['fdmt_step'], ngulp))
    report('fdmt-file', secs, secs_run, per_gulp, counts,
           {'max_delay': md, 'file_gb': N * FCH / 1e9,
            'file_write_s': write_s, 'core': dict(blocks)['fdmt']
            .fdmt.chosen_core})
    del blocks
    # equal to the kernel phase's path (K3 core on the u8 data as f32) and
    # within the gate of the float64 oracle, span by span
    out = out[0]
    k3core = plan._core_pallas(False)
    err = scale = 0.0
    for k in range(ngulp):
        a, n = k * FG, min(FG, N - FMD - k * FG)
        win = u8[:, a:min(a + FG + FMD, N)].float()
        got = torch.from_numpy(np.ascontiguousarray(out[:, a:a + n])) \
            .to('cuda')
        require(torch.equal(got, k3core(win[None])[0, :, :n]),
                'fdmt-file span %d differs from the K3 core on its data' % k)
        ref = fdmt_oracle(plan, win, 1)[:, :n]
        err = max(err, float((got.double() - ref).abs().max()))
        scale = max(scale, float(ref.abs().max()))
    rel = err / scale
    require(rel <= rtol, 'fdmt-file is %.3g from the float64 oracle' % rel)
    log('fdmt-file: max_delay %d from max_dm %g; every span equal to the '
        'K3 core on its data and %.3g of the float64 oracle'
        % (md, FMAXDM, rel))
    check_peaks('fdmt-file', pulse_peaks(out, FPW), expect)
    rates['fdmt-file']['oracle_rel_err'] = rel
    del out, u8

    # the FRB search (config 22's chain) in three arms
    nout = N - halo
    ref_out = None
    launches = {}
    for arm, impl in (('frb-K3', 'pallas'), ('frb-race', None),
                      ('frb-torch', 'xla')):
        blocks = []

        def frb_chain(h2d):
            b = bt.blocks.fdmt_stage(h2d, max_delay=FMD)
            blocks.append(('fdmt_stage', b))
            b = bt.blocks.matched_filter(b, FNTAP)
            blocks.append(('matched_filter', b))
            blocks.append(('threshold', bt.blocks.threshold(b, thr)))
            return blocks

        with contextlib.ExitStack() as stack:
            if arm == 'frb-race':
                tmp = stack.enter_context(tempfile.TemporaryDirectory())
                stack.enter_context(environ(BF_CACHE_DIR=tmp,
                                            BF_FDMT_IMPL=None))
            else:
                stack.enter_context(environ(BF_FDMT_IMPL=impl))
            torch.cuda.reset_peak_memory_stats()
            zero_counts(spec, gpu_kernels)
            out, hdr, secs, secs_run, per_gulp, _ = run_fdmt_arm(
                bt, freq_time_source(bt, host), frb_chain, nout)
            counts = read_counts(spec, gpu_kernels)
        eng = dict(blocks)['fdmt_stage']._stage.engine
        extra = {'core': eng.chosen_core, 'probe_ms': eng.core_probe_ms,
                 'gate_ms': eng.gate_ms, 'ncand': int(np.count_nonzero(out))}
        report(arm, secs, secs_run, per_gulp, counts, extra)
        launches[arm] = counts
        if arm == 'frb-K3':
            require(counts['fdmt_step'] == ngulp * nsteps,
                    'frb-K3: %d K3 launches for %d gulps of %d steps'
                    % (counts['fdmt_step'], ngulp, nsteps))
            ref_out = out
        else:
            require(np.array_equal(out.view(np.uint32),
                                   ref_out.view(np.uint32)),
                    '%s is not byte-identical to frb-K3' % arm)
            log('%s: output byte-identical to frb-K3' % arm)
        if arm == 'frb-race':
            require(eng.gate_ms is not None and eng.core_probe_ms and
                    'pallas' in eng.core_probe_ms,
                    'frb-race: the race did not run with K3: %s' % extra)
        del out, blocks
    # the float64 oracle chain, span by span; candidates and pulses
    err = scale = 0.0
    ncand = nwant = nmiss = nnear = 0
    chunks = []
    for k in range(ngulp):
        a, n = k * FG, min(FG, nout - k * FG)
        chunks.append((a, fdmt_oracle(plan, x[:, a:min(a + FG + halo, N)],
                                      FNTAP)[:, :n]))
    scale = max(float(r.abs().max()) for _, r in chunks)
    for a, ref in chunks:
        n = ref.shape[-1]
        got = torch.from_numpy(np.ascontiguousarray(ref_out[:, a:a + n])) \
            .to('cuda').double()
        cand, want = got != 0, ref >= thr
        both = cand & want
        if bool(both.any()):
            err = max(err, float((got - ref)[both].abs().max()))
        near = (ref - thr).abs() <= rtol * scale
        miss = cand ^ want
        require(not bool((miss & ~near).any()), 'a candidate differs from '
                'the oracle away from the threshold at span from %d' % a)
        ncand += int(cand.sum())
        nwant += int(want.sum())
        nmiss += int(miss.sum())
        nnear += int(near.sum())
    del chunks
    rel = err / scale
    require(rel <= rtol, 'the FRB arms are %.3g from the float64 oracle' % rel)
    log('FRB search: %d candidates, oracle %d; %d differ, all among the %d '
        'samples within rtol*scale of the threshold; candidates %.3g of the '
        'float64 oracle chain' % (ncand, nwant, nmiss, nnear, rel))
    check_peaks('frb arms', pulse_peaks(ref_out, 1), expect)
    del ref_out, x, host
    torch.cuda.empty_cache()
    launches['fdmt-file'] = rates['fdmt-file']['launches']
    return {'rates': rates, 'launches': launches, 'threshold': thr,
            'candidates': ncand, 'oracle_candidates': nwant,
            'candidates_differing': nmiss, 'samples_near_threshold': nnear,
            'oracle_rel_err': rel, 'strided_span_copy_ms': span_copy_ms}


def phase_ring_permute(gpu_kernels, par):
    """K9 at the corner turn's shapes on one card: MD and 3 int8 blocks of
    (XT / MD, XF, XS, XP, 2) and MD complex64 blocks whose byte count is
    not a multiple of 16, each bit-identical to its plain version; the
    whole corner turn (impl='pallas') over MD ranks of the card equal to
    the transpose oracle; K9, its plain version and torch.roll timed."""
    import torch
    g = torch.Generator(device='cuda').manual_seed(51)
    shape = (XT // MD, XF, XS, XP, 2)
    blocks = [torch.randint(-128, 128, shape, dtype=torch.int8,
                            device='cuda', generator=g) for _ in range(MD)]
    cshape = (63, 1023, 3)
    cblocks = [torch.complex(torch.randn(cshape, device='cuda', generator=g),
                             torch.randn(cshape, device='cuda', generator=g))
               for _ in range(MD)]
    nbytes_c = cblocks[0].numel() * 8
    require(nbytes_c % 16, 'the complex64 case is a multiple of 16 bytes')
    for name, bl in (('int8 D=%d' % MD, blocks), ('int8 D=3', blocks[:3]),
                     ('complex64 D=%d, %d bytes' % (MD, nbytes_c), cblocks)):
        before = gpu_kernels.launches['ring_permute']
        got = gpu_kernels.ring_permute(bl)
        want = gpu_kernels.ring_permute_plain(bl)
        torch.cuda.synchronize()
        require(gpu_kernels.launches['ring_permute'] == before + 1,
                'K9 (%s): %d launches for one hop'
                % (name, gpu_kernels.launches['ring_permute'] - before))
        D = len(bl)
        require(all(torch.equal(a, b) for a, b in zip(got, want)) and
                all(torch.equal(got[(i + 1) % D], bl[i]) for i in range(D)),
                'K9 (%s) is not bit-identical to its plain version' % name)
        log('K9 ring_permute %s of %s: bit-identical to its plain version'
            % (name, tuple(bl[0].shape)))
        del got, want
    # the corner turn of a whole gulp over MD ranks of the card
    x = torch.randint(-128, 128, (XT, XF, XS, XP, 2), dtype=torch.int8,
                      device='cuda', generator=g)
    mesh = par.create_mesh({'sp': MD}, devices=['cuda'] * MD)
    before = gpu_kernels.launches['ring_permute']
    ct = par.corner_turn(mesh, 'sp', impl='pallas', stacked=True)(x)
    torch.cuda.synchronize()
    nhop = gpu_kernels.launches['ring_permute'] - before
    fc = XF // MD
    require(nhop == MD - 1, 'the K9 corner turn made %d launches, not %d'
            % (nhop, MD - 1))
    require(ct.shape == (MD, XT, fc, XS, XP, 2) and
            all(torch.equal(ct[d], x[:, d * fc:(d + 1) * fc])
                for d in range(MD)),
            'the K9 corner turn differs from the transpose oracle')
    log('corner turn (impl=pallas) of a (%d, %d, %d, %d, 2) gulp over %d '
        'ranks of one card: %d K9 launches, equal to the transpose oracle'
        % (XT, XF, XS, XP, MD, nhop))
    del ct, x
    got = gpu_kernels.ring_permute(blocks)
    want = gpu_kernels.ring_permute_plain(blocks)
    stacked = torch.stack(blocks)
    # ms brackets one call, as for every kernel; a hop moves 537 MB in some
    # 0.2 ms, near the host's own cost of one wrapper call, so the device
    # time per call of queued calls is kept beside it as ms_queued
    hop = lambda: gpu_kernels.ring_permute(blocks)
    plain = lambda: gpu_kernels.ring_permute_plain(blocks)
    roll = lambda: torch.roll(stacked, 1, 0)
    ms, plain_ms, library_ms = cuda_ms(hop), cuda_ms(plain), cuda_ms(roll)
    queued = {'kernel': cuda_ms_queued(hop), 'plain': cuda_ms_queued(plain),
              'library': cuda_ms_queued(roll)}
    nbyte = 2 * MD * blocks[0].numel()
    entry = kernel_entry(
        'ring_permute', 'bifrost_tpu_torch/csrc/ring_permute.cu', 504,
        [b.view(torch.uint8) for b in got],
        [b.view(torch.uint8) for b in want], ms, plain_ms, nbyte, 0,
        PEAK_FP32_PER_S, library_ms, shape=[MD] + list(shape),
        per='hop (one call bracketed alone)',
        library='torch.roll(stacked, 1, 0) on the (D, ...) stack',
        error_unit='bytes', ms_queued=queued,
        ms_queued_per='hop (median of 5 batches of 20 queued calls)')
    log('K9 queued (ms per call of 20 back to back): %s' % queued)
    del got, want, stacked, blocks, cblocks
    torch.cuda.empty_cache()
    return entry


def mesh_oracle(gulp):
    """The stateful correlate(XT) output of one gulp: the single-device
    product in float64 on the card (K7's plain version), held to the int64
    oracle on XCHANNELS.  Returns a host array (1, XF, XS, XP, XS, XP)."""
    import torch
    from bifrost_tpu_torch.ops.gpu_kernels import xcorr_herm_plain
    re = gulp[..., 0].reshape(XT, XF, XN)
    im = gulp[..., 1].reshape(XT, XF, XN)
    whole = xcorr_herm_plain(torch.from_numpy(re).cuda(),
                             torch.from_numpy(im).cuda()).cpu().numpy()
    for f in XCHANNELS:
        sl = slice(f, f + 1)
        want = xcorr_oracle(re[:, sl], im[:, sl], re[:, sl], im[:, sl])
        require(np.array_equal(whole[sl], want),
                'the float64 products differ from the int64 oracle on '
                'channel %d' % f)
    torch.cuda.empty_cache()
    return whole.reshape(1, XF, XS, XP, XS, XP)


def run_mesh_arm(bt, par, gulps, axes, impl):
    """The stateful correlate(XT, accuracy='int8', impl) under
    block_scope(mesh=...) (no mesh when ``axes`` is None), the mesh's
    ranks all on cuda:0.  Returns (outputs, seconds of the timed gulps,
    per-block host ms/gulp, what the block chose)."""
    import gc
    import torch
    mesh = None
    if axes is not None:
        n = int(np.prod(list(axes.values())))
        mesh = par.create_mesh(axes, devices=['cuda'] * n)
    blocks = []

    def chain(h2d):
        with bt.block_scope(mesh=mesh):
            blocks.append(('correlate', bt.blocks.correlate(
                h2d, XT, accuracy='int8', impl=impl)))
        return blocks

    out, secs, per_gulp = drive(bt, gulps, fx_header(
        ['time', 'freq', 'station', 'pol'], XT), chain, MWARM, MTIMED)
    blk = blocks[0][1]
    info = {'plan': blk._mesh_plan if mesh is not None else None,
            'plan_probe_ms': blk.mesh_probe_ms,
            'chosen': dict(blk.engine.chosen),
            'probe_ms': dict(blk.engine.probe_ms)}
    del blocks[:], blk
    gc.collect()
    torch.cuda.empty_cache()
    return out, secs, per_gulp, info


#: the mesh correlator's arms: (name, mesh axes, environment, impl); the
#: first is the single-device run the others are held to
MESH_ARMS = (
    ('single', None, {}, 'pallas'),
    ('mesh-psum', {'sp': MD}, {'BF_XCORR_CORNER_TURN': 'off'}, 'pallas'),
    ('mesh-corner-xla', {'sp': MD}, {'BF_XCORR_CORNER_TURN': 'xla'},
     'pallas'),
    ('mesh-corner-K9', {'sp': MD}, {'BF_XCORR_CORNER_TURN': 'pallas'},
     'pallas'),
    ('mesh-2d', {'sp': 2, 'tp': 2}, {'BF_LINALG_XCORR_IMPL': 'pallas'},
     'pallas'),
    ('mesh-race', {'sp': MD}, {'BF_XCORR_CORNER_TURN': 'auto'}, None))


def phase_mesh_correlator(bt, spec, gpu_kernels, par, smi):
    """BASELINE config 5's array through copy('cuda') -> correlate(XT)
    under block_scope(mesh=...) -> copy('system'), in the arms of
    MESH_ARMS: each byte-identical to the single-device run, which equals
    the float64 products and the int64 oracle."""
    import tempfile
    import torch
    gulps = fx_gulps(seed=17)
    oracle = [mesh_oracle(gv) for gv in gulps]
    ngulp = MWARM + MTIMED
    nsamp = XT * XF * XS * XP
    runs, rates, ref = {}, {}, None
    for arm, axes, env, impl in MESH_ARMS:
        with contextlib.ExitStack() as stack:
            stack.enter_context(environ(**dict(
                {'BF_XCORR_CORNER_TURN': None, 'BF_LINALG_XCORR_IMPL': None},
                **env)))
            if arm == 'mesh-race':
                # the plans and the engine race from an empty probe cache
                tmp = stack.enter_context(tempfile.TemporaryDirectory())
                stack.enter_context(environ(BF_CACHE_DIR=tmp))
            torch.cuda.reset_peak_memory_stats()
            zero_counts(spec, gpu_kernels)
            for k in par.collectives:
                par.collectives[k] = 0
            out, secs, per_gulp, info = run_mesh_arm(bt, par, gulps, axes,
                                                     impl)
            counts = read_counts(spec, gpu_kernels)
            coll = dict(par.collectives)
        peak = torch.cuda.max_memory_allocated() / 1e9
        per = {k: v / float(ngulp) for k, v in counts.items() if v}
        rates[arm] = {'msps': MTIMED * nsamp / secs / 1e6, 'seconds': secs,
                      'peak_device_gb': peak, 'launches': counts,
                      'launches_per_gulp': per, 'collectives': coll,
                      'info': info, 'per_gulp_ms': per_gulp}
        log('mesh correlator arm %s (%s): plan %s, %.1f Msamples/s, launches '
            '%s (per gulp %s), collectives %s, peak device memory %s GB '
            '(%s)' % (arm, axes, info['plan'], rates[arm]['msps'], counts,
                      per, coll, peak, smi))
        if info['plan_probe_ms']:
            log('  plan race (ms per call): %s' % info['plan_probe_ms'])
        log_per_gulp(per_gulp)
        for k, a in out.items():
            require(a.shape == (1, XF, XS, XP, XS, XP) and
                    a.dtype == np.complex64 and np.isfinite(a).all(),
                    'arm %s output %d: bad shape, type or values' % (arm, k))
            if ref is None:
                require(np.array_equal(a, oracle[k % len(gulps)]),
                        'arm %s output %d differs from the float64 products'
                        % (arm, k))
            else:
                require(np.array_equal(a, ref[k]), 'arm %s output %d is not '
                        'byte-identical to the single-device run' % (arm, k))
        if ref is None:
            ref = out
        log('arm %s: outputs %s byte-identical to %s'
            % (arm, sorted(out), 'the float64 products and the int64 oracle'
               if arm == 'single' else 'the single-device run'))
        runs[arm] = counts
        del out
    want = {'single': ('xcorr_herm', ngulp),
            'mesh-psum': ('xcorr_herm', MD * ngulp),
            'mesh-corner-xla': ('xcorr_herm', MD * ngulp),
            'mesh-corner-K9': ('xcorr_herm', MD * ngulp),
            # one more: xcorr_prewarm's call at on_sequence
            'mesh-2d': ('xcorr_cross', MD * ngulp + 1)}
    for arm, (kern, n) in want.items():
        require(runs[arm][kern] == n, '%s: %d %s launches, not %d'
                % (arm, runs[arm][kern], kern, n))
    # every K8 launch of the 2-D plan (the gulps' station-row blocks and
    # the prewarm's) on row-block jobs where the plan says so
    rb = xcorr_cross_plan(gpu_kernels, XT // 2, XN // 2, XN)
    require(runs['mesh-2d']['xcorr_cross_rowblock'] ==
            rb * runs['mesh-2d']['xcorr_cross'],
            'mesh-2d: K8 jobs off the plan: %s'
            % {k: runs['mesh-2d'][k] for k in K8_COUNTERS})
    require(runs['mesh-corner-K9']['ring_permute'] == (MD - 1) * ngulp,
            'mesh-corner-K9: %d K9 launches for %d gulps'
            % (runs['mesh-corner-K9']['ring_permute'], ngulp))
    race = rates['mesh-race']['info']
    require(race['plan_probe_ms'] and 'corner:pallas' in race['plan_probe_ms'],
            'mesh-race: K9 did not race: %s' % race)
    del ref, oracle
    torch.cuda.empty_cache()
    return {'rates': rates, 'launches': runs}


def phase_fdmt_mesh(bt, spec, gpu_kernels, F, par, smi):
    """Config 22's [freq, time] stream through copy('cuda') ->
    fdmt(max_delay=FMD) -> copy('system'), K3 forced, under an {'sp':
    MFDMT} mesh of the card and without one: every span bit-identical."""
    import torch
    ngulp = FWARM + FTIMED
    N = ngulp * FG
    _, x = fdmt_stream()
    host = x.cpu().numpy()
    del x
    nsteps = len(F.Fdmt().init(FCH, FMD, FF0, FDF)._plan['steps'])
    rates, outs = {}, {}
    for arm, axes in (('fdmt-single', None), ('fdmt-mesh', {'sp': MFDMT})):
        mesh = None if axes is None else \
            par.create_mesh(axes, devices=['cuda'] * MFDMT)
        blocks = []

        def chain(h2d):
            with bt.block_scope(mesh=mesh):
                blocks.append(('fdmt', bt.blocks.fdmt(h2d, max_delay=FMD)))
            return blocks

        with environ(BF_FDMT_IMPL='pallas'):
            torch.cuda.reset_peak_memory_stats()
            zero_counts(spec, gpu_kernels)
            for k in par.collectives:
                par.collectives[k] = 0
            out, hdr, secs, secs_run, per_gulp, _ = run_fdmt_arm(
                bt, freq_time_source(bt, host), chain, N - FMD)
            counts = read_counts(spec, gpu_kernels)
            coll = dict(par.collectives)
        blk = dict(blocks)['fdmt']
        engaged = sorted(str(k) for k, fn in blk._mesh_fns.items()
                         if fn is not None)
        peak = torch.cuda.max_memory_allocated() / 1e9
        slow = max(per_gulp, key=lambda r: per_gulp[r]['process'])
        nshard = 1 if axes is None else MFDMT
        rates[arm] = {
            'msps': FTIMED * FG * FCH / secs / 1e6,
            'msps_run': ngulp * FG * FCH / secs_run / 1e6,
            'slowest_block': slow,
            'msps_slowest_block':
                FG * FCH / per_gulp[slow]['process'] / 1e3,
            'peak_device_gb': peak, 'launches': counts, 'collectives': coll,
            'mesh_shapes': engaged, 'core': blk.fdmt.chosen_core,
            'per_gulp_ms': per_gulp}
        log('FDMT arm %s (%s): mesh path on spans %s, %.1f Msamples/s at the '
            'sink, %.1f over the whole run, %.1f at the slowest block (%s); '
            'launches %s, collectives %s, peak device memory %s GB (%s)'
            % (arm, axes, engaged, rates[arm]['msps'], rates[arm]['msps_run'],
               rates[arm]['msps_slowest_block'], slow, counts, coll, peak,
               smi))
        log_per_gulp(per_gulp)
        require(hdr['_tensor']['shape'][-2] == FMD, 'max_delay %s'
                % hdr['_tensor']['shape'][-2])
        # one run of the core per shard per gulp, and one in on_sequence
        require(counts['fdmt_step'] == (ngulp + 1) * nsteps * nshard,
                '%s: %d K3 launches for %d gulps on %d shards'
                % (arm, counts['fdmt_step'], ngulp, nshard))
        if axes is not None:
            require(engaged, 'fdmt-mesh: the mesh path never engaged')
        outs[arm] = out
        del blocks, blk
    require(np.array_equal(outs['fdmt-mesh'].view(np.uint32),
                           outs['fdmt-single'].view(np.uint32)),
            'fdmt-mesh is not bit-identical to the chain without a mesh')
    log('fdmt-mesh: every span bit-identical to the chain without a mesh')
    del outs, host
    torch.cuda.empty_cache()
    return {'rates': rates}


# ---------------------------------------------------------------------------
# the DSP library: map, the FX chain's storage format, FIR, Romein
# ---------------------------------------------------------------------------

def event_ms(fn):
    """(result, milliseconds) of one call of ``fn`` bracketed by CUDA
    events."""
    import torch
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


POL_PRODUCTS = """
    auto x = a(_,0);
    auto y = a(_,1);
    b(_,0).assign(x.mag2(), y.mag2());
    b(_,1) = x*y.conj();
    """


def phase_map(bt, smi):
    """bf.map on the spectrometer arm's gulp (16384 x 2 x 4096 ci8): the
    polarisation products of tests/test_map.py on its complex64 voltages,
    the fftshift index vector along the 4096 axis, and the ci8 expression
    on the raw gulp from host memory; then fused([FFT, MapStage('b =
    a.mag2()'), reduce(freq, 4)]) through the pipeline against a float64
    oracle, and dft_matmul_fft against torch.fft.fft on the gulp's rows."""
    import torch
    from bifrost_tpu_torch.ndarray import ndarray
    from bifrost_tpu_torch.ops import map as M
    from bifrost_tpu_torch.ops.fft import dft_matmul_fft
    from bifrost_tpu_torch.stages import FftStage, MapStage, ReduceStage
    dev = bt.device.get_device()
    volts = make_gulps(seed=17)
    raw = volts[0]
    v = torch.view_as_complex(torch.from_numpy(raw).to(dev).float())
    ms = {}
    # the polarisation products, pol last: (T, F, 2)
    a = v.permute(0, 2, 1).contiguous()
    b = torch.empty_like(a)
    ms['pol_products'] = cuda_ms(lambda: M.map(
        POL_PRODUCTS, {'a': a, 'b': b}, shape=a.shape[:2]), runs=3, warm=1)
    x, y = a[..., 0], a[..., 1]
    require(torch.equal(b[..., 0], torch.complex(x.real ** 2 + x.imag ** 2,
                                                 y.real ** 2 + y.imag ** 2))
            and torch.equal(b[..., 1], x * y.conj()),
            'map: polarisation products differ from the torch products')
    h = a[:ORACLE_NTIME].cpu().numpy()
    m2 = lambda z: z.real ** 2 + z.imag ** 2
    want = np.stack([m2(h[..., 0]) + 1j * m2(h[..., 1]),
                     h[..., 0] * h[..., 1].conj()], -1)
    require(np.array_equal(b[:ORACLE_NTIME].cpu().numpy(), want),
            'map: polarisation products differ from numpy')
    del a, b, x, y
    # the fftshift index vector along the 4096 axis
    out = torch.empty_like(v)
    ms['fftshift'] = cuda_ms(lambda: M.map(
        'b(t,p,f) = a(t,p,f-a.shape(2)/2)', {'a': v, 'b': out},
        shape=v.shape, axis_names=('t', 'p', 'f')), runs=3, warm=1)
    require(torch.equal(out, torch.fft.fftshift(v, dim=2)),
            'map: the fftshift index vector differs from torch.fft.fftshift')
    del out
    # the ci8 expression on the raw gulp, from host memory
    flat = raw.view(np.dtype([('re', 'i1'), ('im', 'i1')])).reshape(-1)
    c = torch.empty(flat.shape[0], dtype=torch.complex64, device=dev)
    ms['ci8'] = cuda_ms(lambda: M.map(
        'b(i) = a(i)', {'a': ndarray(flat, dtype='ci8'), 'b': c},
        shape=flat.shape, axis_names=('i',)), runs=3, warm=1)
    require(torch.equal(c, v.reshape(-1)),
            'map: the ci8 expression differs from the unpacked gulp')
    del c
    log('map (16384 x 2 x 4096; medians of 3 after a warm-up): polarisation '
        'products %.2f ms, equal to torch and to numpy on %d rows; fftshift '
        'along 4096 %.2f ms, equal to torch.fft.fftshift; ci8 from host '
        '%.2f ms, equal to the unpacked gulp (%s)' % (ms['pol_products'], ORACLE_NTIME,
                                ms['fftshift'], ms['ci8'], smi))
    # DFT-matmul FFT on the gulp's 4096-point rows
    ref = torch.fft.fft(v, dim=-1)
    got = dft_matmul_fft(v, -1)
    dft_rel = float((got - ref).abs().max() / ref.abs().max())
    del got, ref
    require(dft_rel < DFT_GATE, 'dft_matmul_fft differs from torch.fft.fft: '
            'rel %.3g' % dft_rel)
    ms['dft_matmul_fft'] = cuda_ms(lambda: dft_matmul_fft(v, -1), runs=5)
    ms['cufft'] = cuda_ms(lambda: torch.fft.fft(v, dim=-1), runs=5)
    log('dft_matmul_fft (4096 = 64 x 64) on 32768 rows: rel %.3g of '
        'torch.fft.fft, %.3f ms against cuFFT %.3f ms (%s)'
        % (dft_rel, ms['dft_matmul_fft'], ms['cufft'], smi))
    del v
    torch.cuda.empty_cache()
    # MapStage fused between the FFT and the reduce, through the pipeline
    header = {'name': 'guppi', 'time_tag': 0,
              '_tensor': {'shape': [-1, NPOL, NFINE], 'dtype': 'ci8',
                          'labels': ['time', 'pol', 'fine_time'],
                          'scales': [[0, 1]] * 3, 'units': [None] * 3}}
    blocks = []

    def chain(h2d):
        blocks.append(('fused', bt.blocks.fused(
            h2d, [FftStage('fine_time', axis_labels='freq'),
                  MapStage('b = a.mag2()', dtype='f32'),
                  ReduceStage('freq', RFACTOR)])))
        return blocks
    outs, secs, per_gulp = drive(bt, volts, header, chain, PWARM, PTIMED)
    info = blocks[0][1].impl_info
    require(info.get('impl') == 'torch-fused', 'map arm planned %s' % info)
    worst = 0.0
    for k, o in outs.items():
        require(o.shape == (NTIME, NPOL, NFINE // RFACTOR) and
                o.dtype == np.float32 and np.isfinite(o).all(),
                'map arm output %d: bad shape, type or values' % k)
        g = volts[k % len(volts)][:ORACLE_NTIME].astype(np.float64)
        spec64 = np.fft.fft(g[..., 0] + 1j * g[..., 1], axis=-1)
        want = (np.abs(spec64) ** 2).reshape(
            ORACLE_NTIME, NPOL, NFINE // RFACTOR, RFACTOR).sum(-1)
        worst = max(worst, rel_err(o[:ORACLE_NTIME], want))
    require(worst < GATE, 'map arm differs from the float64 oracle: %.3g'
            % worst)
    msps = PTIMED * NTIME * NPOL * NFINE / secs / 1e6
    log('map arm fused[FFT -> MapStage(mag2) -> reduce(freq, 4)]: impl %s, '
        'outputs %s within %.3g of the float64 oracle on %d rows, %.1f '
        'Msamples/s (%s)' % (info, sorted(outs), worst, ORACLE_NTIME, msps,
                             smi))
    log_per_gulp(per_gulp)
    del blocks
    return {'ms': ms, 'dft_rel_err': dft_rel, 'map_arm_rel_err': worst,
            'map_arm_msps': msps, 'map_arm_per_gulp_ms': per_gulp}


def storage_numpy(full, b_i, b_j):
    """numpy matrix -> storage conversion of a full Hermitian
    (t, f, S, 2, S, 2) visibility: Stokes I, Q, U, V of each baseline,
    four (t, f, nbl) arrays (a storage output's [..., k] swapped on its
    last two axes)."""
    t, f, nstand = full.shape[:3]
    n = 2 * nstand
    p = np.arange(2)
    idx = ((2 * b_i[:, None, None] + p[None, :, None]) * n +
           2 * b_j[:, None, None] + p[None, None, :]).ravel()
    v = np.take(full.reshape(t, f, n * n), idx, axis=2) \
        .reshape(t, f, len(b_i), 2, 2)
    xx, xy, yx, yy = v[..., 0, 0], v[..., 0, 1], v[..., 1, 0], v[..., 1, 1]
    return [xx + yy, xx - yy, xy + yx, (xy - yx) * 1j]


def phase_fx_storage(bt, spec, gpu_kernels, fx, smi):
    """The fx-K7 arm's chain followed by convert_visibilities('storage'),
    as examples/fx_correlator.py builds it: every K7 launch counted, each
    storage output equal value for value to the numpy conversion of the
    oracle's visibilities (the FX phase's, made on the card in float64
    products), a storage -> matrix round trip equal to the oracle's full
    Hermitian matrix."""
    import torch
    from bifrost_tpu_torch.blocks.convert_visibilities import (
        baseline_indices, storage_to_matrix)
    gulps, oracle = fx.pop('gulps'), fx.pop('oracle')
    ngulp = SWARM + STIMED
    torch.cuda.reset_peak_memory_stats()
    zero_counts(spec, gpu_kernels)
    out, secs, per_gulp, info = run_fx_arm(bt, gulps, 'fx-storage')
    counts = read_counts(spec, gpu_kernels)
    peak = torch.cuda.max_memory_allocated() / 1e9
    require(counts['xcorr_herm'] == ngulp, 'fx-storage: %d K7 launches for '
            '%d gulps' % (counts['xcorr_herm'], ngulp))
    dev = bt.device.get_device()
    bi, bj, _ = baseline_indices(XS, dev)
    b_i, b_j = bi.cpu().numpy(), bj.cpu().numpy()
    nbl = len(b_i)
    t0 = time.perf_counter()
    want = [storage_numpy(o, b_i, b_j) for o in oracle]
    numpy_s = time.perf_counter() - t0
    for k, a in out.items():
        require(a.shape == (1, nbl, XF, 4) and a.dtype == np.complex64 and
                np.isfinite(a).all(),
                'fx-storage output %d: bad shape, type or values' % k)
        require(all(np.array_equal(a[..., j], w.swapaxes(1, 2))
                    for j, w in enumerate(want[k % len(gulps)])),
                'fx-storage output %d differs from the numpy storage '
                'conversion of the oracle' % k)
    del want
    back, rt_ms = event_ms(lambda: storage_to_matrix(
        torch.from_numpy(out[0]).to(dev), bi, bj, XS))
    require(np.array_equal(back.cpu().numpy(), oracle[0]),
            'fx-storage: the storage -> matrix round trip differs from the '
            "oracle's full matrix")
    del back, oracle
    d2h = per_gulp['d2h']['process']
    d2h_k7 = fx['rates']['fx-K7']['per_gulp_ms']['d2h']['process']
    rate = {'msps': STIMED * XT * XF * XS * XP / secs / 1e6,
            'baseline_channels_per_s':
                STIMED * (XT // (XR * XA)) * nbl * XF / secs,
            'd2h_ms_per_gulp': d2h, 'fx_k7_d2h_ms_per_gulp': d2h_k7,
            'storage_gb_per_gulp': nbl * XF * 4 * 8 / 1e9,
            'round_trip_ms': rt_ms, 'numpy_conversion_s': numpy_s,
            'peak_device_gb': peak, 'launches': counts, 'info': info,
            'per_gulp_ms': per_gulp}
    log('fx-storage: fx-K7 chain -> convert_visibilities(storage), %d K7 '
        'launches for %d gulps; outputs %s (%d baselines x %d x 4, %.2f GB) '
        'equal the numpy conversion of the oracle; storage -> matrix round '
        'trip %.1f ms equals the oracle (numpy conversions %.1f s); %.1f '
        'Msamples/s, %.4g baseline-channels/s, D2H %.1f ms a gulp against '
        'fx-K7\'s %.1f, peak device memory %.1f GB (%s)'
        % (counts['xcorr_herm'], ngulp, sorted(out), nbl, XF,
           rate['storage_gb_per_gulp'], rt_ms, numpy_s, rate['msps'],
           rate['baseline_channels_per_s'], d2h, d2h_k7, peak, smi))
    log_per_gulp(per_gulp)
    del out
    torch.cuda.empty_cache()
    return rate


def fir_oracle(coeffs, x):
    """Causal FIR of complex128 ``x`` along axis 0 with zero history,
    float64 taps ``coeffs`` (ntap,) or (ntap, *x.shape[1:])."""
    ntap = coeffs.shape[0]
    xp = np.concatenate([np.zeros((ntap - 1,) + x.shape[1:], x.dtype), x])
    out = np.zeros_like(x)
    for t in range(ntap):
        out += coeffs[t] * xp[ntap - 1 - t: xp.shape[0] - t]
    return out


def phase_fir(bt, smi):
    """FirBlock on 3 ci8 gulps of BASELINE config 4's shape (512 x 512 x
    256 x 2): a 16-tap filter with real taps per (channel, station, pol),
    decim 1, as fir.cu filters across ant-pols; then shared (16,) taps
    and decim 4.  Both within 1e-5 (of the largest magnitude) of a
    float64 oracle over the concatenated stream, on FIR_CHANNELS, across
    the gulp boundaries."""
    import torch
    from bifrost_tpu_torch.ops.fir import Fir
    gulps = beam_gulps(seed=23, n=3)
    header = {'name': 'fir', 'time_tag': 0, 'gulp_nframe': BT,
              '_tensor': {'shape': [-1, BF, BS, BP], 'dtype': 'ci8',
                          'labels': ['time', 'freq', 'station', 'pol'],
                          'scales': [[0, 1e-3]] + [[0, 1]] * 3,
                          'units': ['s'] + [None] * 3}}
    rng = np.random.default_rng(29)
    taps = {'fir-perchan': (rng.standard_normal(
                (FIR_TAPS, BF, BS, BP), dtype=np.float32), 1),
            'fir-shared': (rng.standard_normal(FIR_TAPS, dtype=np.float32),
                           FIR_DECIM)}
    chans = list(FIR_CHANNELS)
    stream = np.concatenate([g[:, chans] for g in gulps]).astype(np.float64)
    xc = stream[..., 0] + 1j * stream[..., 1]
    del stream
    res = {}
    for arm, (coeffs, decim) in taps.items():
        blocks = []

        def chain(h2d):
            blocks.append(('fir', bt.blocks.fir(h2d, coeffs, decim)))
            return blocks
        outs, secs, per_gulp = drive(bt, gulps, header, chain, 1, 2)
        require(sorted(outs) == [0, 1, 2], '%s: outputs %s' % (arm,
                                                               sorted(outs)))
        for k, o in outs.items():
            require(o.shape == (BT // decim, BF, BS, BP) and
                    o.dtype == np.complex64 and np.isfinite(o).all(),
                    '%s output %d: bad shape, type or values' % (arm, k))
        got = np.concatenate([outs[k][:, chans] for k in range(3)])
        c = coeffs[:, chans].astype(np.float64) if coeffs.ndim > 1 \
            else coeffs.astype(np.float64)
        want = fir_oracle(c, xc)[::decim]
        rel = rel_err(got, want)
        require(rel < GATE, '%s differs from the float64 oracle: %.3g'
                % (arm, rel))
        del outs, got, want, blocks
        # one gulp's FIR on the card, state carried
        x = torch.view_as_complex(torch.from_numpy(gulps[0]).to(
            bt.device.get_device()).float())
        fir = Fir().init(coeffs, decim=decim)
        ms = cuda_ms(lambda: fir.execute(x), runs=5)
        del x, fir
        torch.cuda.empty_cache()
        res[arm] = {'rel_err': rel, 'execute_ms': ms,
                    'msps': 2 * BT * BF * BS * BP / secs / 1e6,
                    'per_gulp_ms': per_gulp}
        log('%s: 16 taps %s, decim %d, 3 gulps; within %.3g of the float64 '
            'oracle on channels %s across the gulp boundaries; Fir.execute '
            '%.3f ms a gulp on the card, %.1f Msamples/s through the '
            'pipeline (%s)' % (arm, 'per (channel, station, pol)'
                               if coeffs.ndim > 1 else 'shared', decim, rel,
                               chans, ms, res[arm]['msps'], smi))
        log_per_gulp(per_gulp)
    return res


def phase_romein(bt, smi):
    """Romein gridding at imaging size: RNPTS points (config 5's
    baselines, autos included) with 7 x 7 complex64 kernels onto a 1024 x
    1024 grid, 64 channels at once; within 1e-5 (of the largest
    magnitude) of a float64 scatter on ROMEIN_ORACLE channels, and a
    second call with accumulate=True doubles the grid to the same
    tolerance.  Each execute timed."""
    import torch
    from bifrost_tpu_torch.ops.romein import Romein
    rng = np.random.default_rng(31)
    pos = rng.integers(0, RNGRID, size=(RNPTS, 2)).astype(np.int32)
    cplx = lambda *shape: (rng.standard_normal(shape) + 1j *
                           rng.standard_normal(shape)).astype(np.complex64)
    kern = cplx(RNPTS, RKSIZE, RKSIZE)
    data = cplx(RNCHAN, RNPTS)
    rom = Romein().init(pos, kern, RNGRID)
    x = torch.from_numpy(data).to(bt.device.get_device())
    grid, ms1 = event_ms(lambda: rom.execute(x))
    require(tuple(grid.shape) == (RNCHAN, RNGRID, RNGRID) and
            grid.dtype == torch.complex64, 'romein: grid %s %s'
            % (tuple(grid.shape), grid.dtype))
    d = np.arange(RKSIZE)
    gy = (pos[:, 1, None, None] + d[None, :, None]) % RNGRID
    gx = (pos[:, 0, None, None] + d[None, None, :]) % RNGRID
    lin = np.broadcast_to(gy * RNGRID + gx, kern.shape).reshape(-1)
    want = []
    for c in range(ROMEIN_ORACLE):
        w = (data[c, :, None, None].astype(np.complex128) * kern).reshape(-1)
        want.append((np.bincount(lin, w.real, RNGRID * RNGRID) + 1j *
                     np.bincount(lin, w.imag, RNGRID * RNGRID))
                    .reshape(RNGRID, RNGRID))
    want = np.stack(want)
    got = grid[:ROMEIN_ORACLE].cpu().numpy()
    rel1 = rel_err(got, want)
    require(np.isfinite(got).all() and rel1 < GATE,
            'romein differs from the float64 scatter: %.3g' % rel1)
    _, ms2 = event_ms(lambda: rom.execute(x, odata=grid, accumulate=True))
    rel2 = rel_err(grid[:ROMEIN_ORACLE].cpu().numpy(), 2 * want)
    require(rel2 < GATE, 'romein accumulate=True does not double the grid: '
            '%.3g' % rel2)
    ms_steady = cuda_ms(lambda: rom.execute(x), runs=5)
    del grid, x
    torch.cuda.empty_cache()
    log('romein: %d points x %d channels, %dx%d kernels onto %d^2 '
        '(%.0f MB of grid): execute %.2f ms (first), accumulate %.2f ms, '
        'median of 5 %.2f ms; within %.3g / %.3g (accumulated) of the '
        'float64 scatter on %d channels (%s)'
        % (RNPTS, RNCHAN, RKSIZE, RKSIZE, RNGRID,
           RNCHAN * RNGRID * RNGRID * 8 / 1e6, ms1, ms2, ms_steady, rel1,
           rel2, ROMEIN_ORACLE, smi))
    return {'execute_ms': ms1, 'accumulate_ms': ms2,
            'median_ms': ms_steady, 'rel_err': rel1,
            'rel_err_accumulated': rel2}


def main():
    import torch
    if not torch.cuda.is_available():
        sys.stderr.write('chip_smoke: no CUDA device is available\n')
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import bifrost_tpu_torch as bt
    from bifrost_tpu_torch import _build
    from bifrost_tpu_torch.ops import gpu_kernels
    from bifrost_tpu_torch.ops import spectrometer as spec
    from bifrost_tpu_torch.ops import beamform as beam
    from bifrost_tpu_torch.ops import linalg as L
    from bifrost_tpu_torch.ops import fdmt as F
    from bifrost_tpu_torch import parallel as par

    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    log('card: %s | torch.cuda.get_device_name: %s | torch %s, CUDA %s'
        % (smi, name, torch.__version__, torch.version.cuda))
    bt.device.set_device('cuda:0')

    t0 = time.perf_counter()
    built = _build.build()
    log('built %s in %.1f s' % (sorted(built) or 'nothing (cached)',
                                time.perf_counter() - t0))
    for lib, text in sorted(_build.build_logs.items()):
        for line in text.splitlines():
            if 'registers' in line or 'smem' in line:
                log('  %s: %s' % (lib, line.strip()))

    phase_s = {}

    def run(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        torch.cuda.empty_cache()
        phase_s[name] = time.perf_counter() - t
        log('phase %s: %.1f s' % (name, phase_s[name]))
        return out

    k9 = run('K9', phase_ring_permute, gpu_kernels, par)
    k2 = run('K2', phase_stokes, gpu_kernels)
    k1 = run('K1', phase_spectrometer, spec)
    pipe = run('spectrometer pipeline', phase_pipeline, bt, spec,
               gpu_kernels, smi)
    guppi = run('guppi', phase_guppi, bt, spec, gpu_kernels)
    dk2 = run('detect-K2', phase_detect_block, bt, spec, gpu_kernels, smi)
    dsp = {'map': run('map', phase_map, bt, smi)}
    k4, k5, k6 = run('K4-K6', phase_beamform_kernels, gpu_kernels, beam)
    bpipe = run('beamformer pipeline', phase_beamform_pipeline, bt, spec,
                gpu_kernels, beam, smi)
    dsp['fir'] = run('fir', phase_fir, bt, smi)
    k0 = run('K0', phase_probe, gpu_kernels)
    k7, k8 = run('K7, K8', phase_xcorr_kernels, gpu_kernels)
    fx = run('FX pipeline', phase_fx_pipeline, bt, spec, gpu_kernels, smi)
    dsp['fx_storage'] = run('fx-storage', phase_fx_storage, bt, spec,
                            gpu_kernels, fx, smi)
    dsp['romein'] = run('romein', phase_romein, bt, smi)
    n8 = run('xcorr_int8 cross', phase_xcorr_int8, L, gpu_kernels)
    k3 = run('K3', phase_fdmt_kernel, gpu_kernels, F)
    fdmt = run('FDMT pipeline', phase_fdmt_pipeline, bt, spec, gpu_kernels,
               F, smi)
    mesh = run('mesh correlator', phase_mesh_correlator, bt, spec,
               gpu_kernels, par, smi)
    fmesh = run('FDMT mesh', phase_fdmt_mesh, bt, spec, gpu_kernels, F,
                par, smi)
    k1['launches'] = pipe['launches_k1_run']['fused_spectrometer']
    k1['launches_radix16'] = \
        pipe['launches_k1_run']['fused_spectrometer_radix16']
    k2['launches'] = pipe['launches_k2_run']['stokes_detect']
    k2['launches_detect_block'] = dk2['launches']
    k2['launches_detect_block_of'] = \
        'the detect-K2 arm (%d gulps, unfused detect block)' % dk2['gulps']
    k4['launches'] = bpipe['launches']['K4']['beamform_int8']
    k5['launches'] = bpipe['launches']['K5']['beamform_bf16']
    k4['launches_vec16'] = bpipe['launches']['K4']['beamform_int8_vec16']
    k5['launches_vec16'] = bpipe['launches']['K5']['beamform_bf16_vec16']
    k6['launches'] = bpipe['launches']['K6']['beamform_detect_int8']
    k6['launches_mma'] = bpipe['launches']['K6']['beamform_detect_int8_mma']
    for k in (k1, k2, k4, k5, k6):
        k['launches_per_gulp'] = k['launches'] / float(NWARM + NTIMED)
    k0['launches'] = fx['launches']['fx-race']['probe']
    k0['launches_of'] = 'the fx-race arm (one available() per process)'
    k7['launches'] = fx['launches']['fx-K7']['xcorr_herm']
    k7['launches_per_gulp'] = k7['launches'] / float(XWARM + XTIMED)
    k7['launches_x_stateful'] = fx['launches']['x-stateful']['xcorr_herm']
    k7['launches_vec16'] = fx['launches']['fx-K7']['xcorr_herm_vec16']
    k7['launches_x_stateful_vec16'] = \
        fx['launches']['x-stateful']['xcorr_herm_vec16']
    k8['launches'] = n8['xcorr_cross']
    k8['launches_of'] = 'xcorr_int8 cross family, 4 station-row blocks'
    k8['launches_rowblock'] = n8['xcorr_cross_rowblock']
    k8['launches_vec16'] = [n8['xcorr_cross_vec16_i'],
                            n8['xcorr_cross_vec16_j']]
    k8['launches_mesh_2d'] = {k: mesh['launches']['mesh-2d'][k]
                              for k in K8_COUNTERS}
    k3['launches'] = fdmt['launches']['frb-K3']['fdmt_step']
    k3['launches_per_gulp'] = k3['launches'] / float(FWARM + FTIMED)
    k3['launches_fdmt_file'] = fdmt['launches']['fdmt-file']['fdmt_step']
    k9['launches'] = mesh['launches']['mesh-corner-K9']['ring_permute']
    k9['launches_per_gulp'] = k9['launches'] / float(MWARM + MTIMED)
    k9['launches_of'] = 'the mesh-corner-K9 arm (%d ranks, %d hops a gulp)' \
        % (MD, MD - 1)
    kernels = [k0, k1, k2, k3, k4, k5, k6, k7, k8, k9]
    # the wrappers' host time: one call bracketed less a call's share of
    # 20 queued back to back
    for k in (k0, k1, k4, k5, k6, k7, k8, k9):
        k['host_ms'] = k['ms'] - k['ms_queued']['kernel']
    log('wrapper host time (bracketed less queued, ms): %s' % json.dumps(
        {k['name']: round(k['host_ms'], 4)
         for k in (k0, k1, k4, k5, k6, k7, k8, k9)}))
    log('total %.1f s; by phase %s' % (
        time.perf_counter() - t_start,
        json.dumps({k: round(v, 1) for k, v in phase_s.items()})))
    log(json.dumps({'pipeline': {
        'gulp': [NTIME, NPOL, NFINE], 'rfactor': RFACTOR,
        'gulps_timed': NTIMED,
        'msps_cuda_spectrometer': pipe['msps_cuda_spectrometer'],
        'msps_torch_fused': pipe['msps_torch_fused']}, 'card': smi}))
    log(json.dumps({'guppi_pipeline': {
        'nchan': GCH, 'blocsize': GBLOCSIZE, 'rfactor': GR,
        'obsfreq_mhz': GFREQ, 'obsbw_mhz': GBW, 'gulp_nframe': 1,
        'rate': 'Msamples/s of input, file to file, host clock (host-bound)',
        'arms': guppi, 'detect_k2': dk2}, 'card': smi}))
    log(json.dumps({'beamformer_pipeline': {
        'gulp': [BT, BF, BS, BP], 'nbeam': BB, 'rfactor': BR,
        'gulps_timed': NTIMED, 'arms': bpipe['rates']}, 'card': smi}))
    log(json.dumps({'fx_pipeline': {
        'gulp': [XT, XF, XS, XP], 'nframe_per_vis': XR, 'naccumulate': XA,
        'scale': XSCALE, 'gulps_timed': XTIMED,
        'x_stateful_gulp': [XST, XF, XS, XP], 'x_stateful_integration': XSINT,
        'x_stateful_gulps_timed': XSTIMED, 'arms': fx['rates'],
        'launches': fx['launches']}, 'card': smi}))
    log(json.dumps({'fdmt_pipeline': {
        'nchan': FCH, 'f0_mhz': FF0, 'df_mhz': FDF, 'tsamp_s': FTSAMP,
        'max_dm': FMAXDM, 'max_delay': FMD, 'gulp': FG, 'ntap': FNTAP,
        'far': FFAR, 'gulps_timed': FTIMED, 'pulses': FPULSES,
        **fdmt}, 'card': smi}))
    log(json.dumps({'mesh_pipeline': {
        'ranks_on_one_card': MD, 'gulp': [XT, XF, XS, XP],
        'nframe_per_integration': XT, 'gulps_timed': MTIMED,
        'arms': mesh['rates'], 'fdmt': {
            'mesh': {'sp': MFDMT}, 'nchan': FCH, 'gulp': FG,
            'max_delay': FMD, 'gulps_timed': FTIMED,
            'arms': fmesh['rates']}}, 'card': smi}))
    log(json.dumps({'dsp_library': dict(dsp, phase_s={
        k: phase_s[k] for k in ('map', 'fx-storage', 'fir', 'romein')}),
        'card': smi}))
    log(json.dumps({'kernels': kernels}))
    log(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name,
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
