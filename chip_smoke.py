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
   nfft=4096, r=4 (gate 1e-5 relative to the maximum) and against its
   plain version at full width, and times the kernel, the plain version
   and the PyTorch chain fft -> Stokes -> reduce (the library yardstick);
5. drives the Guppi spectrometer chain through the port's Pipeline at
   full width (16384 x 2 x 4096 ci8 gulps, r=4; 3 warm-up and 16 timed
   gulps): system ring -> copy('cuda') -> FusedBlock -> copy('system') ->
   sink, once with the K1 substitution and once without (K2 path).
   Launch counters are zeroed just before and read just after each run;
   each run must launch its kernel once per gulp.  The two outputs must
   agree within 1e-5, and rows are checked against the oracle;
6. runs the beamformer kernels at the full-width shapes of BASELINE
   config 4 (512 frames x 512 channels x 256 stations x 2 pols ci8, 64
   beams, R=8): K4 (int8) bit-identical to its plain version and to the
   int64 oracle on three channels, K5 (bf16) within 1e-5 of its plain
   version, K6 (beamform -> Stokes -> integrate) within 1e-6 of its plain
   version and below 1e-5 against the float64 oracle on a T=64 cut; each
   timed with CUDA events beside its plain version and a library
   yardstick;
7. drives the beamformer chain through the Pipeline at that width (3
   warm-up and 16 timed gulps) in four arms, K6 (fused substitution),
   K4 and K5 (beamform block with the kernel forced -> fused Stokes and
   frame sum) and f32 (the complex64 baseline), zeroing the launch
   counters just before and reading them just after each; K6 must
   launch once per gulp, K4 and K5 twice (once per pol).  The K4 and K6
   arms must agree within 1e-5, each arm must stay inside its accuracy
   class of the f32 arm, and every output must be finite and
   (64, 512, 4, 64).  A fifth arm leaves the candidate to the engine's
   race, in a fresh probe-cache directory, and prints its choice;
8. checks the capability probe K0: available() is True on the card and
   launches the probe kernel once (a second call is cached);
9. runs the correlator kernels at the FX path's shapes: K7 (xcorr_herm)
   on the (2, 128, 1024, 512) group planes of a (256, 1024, 256, 2) ci8
   gulp, read in place as strided views, in one launch; K8 (xcorr_cross)
   on a 128-input station-row block against all 512 inputs, T=128.  Each
   is bit-identical to its plain version (float64 products on the card)
   and to the int64 oracle on channels 0, 511 and 1023, K7's imaginary
   part nonzero and antisymmetric, K8 equal to K7's rows; each timed
   beside its plain version and the complex64 einsum yardstick;
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
   station-row blocks of a gulp, as the station-sharded plan calls it;
11. prints a JSON line of pipeline rates, one JSON line of per-kernel
   numbers ({"kernels": [...]}), the nvidia-smi line, and as the last
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
XWARM, XTIMED = 2, 6
# the stateful X step: 64-frame gulps, 256 frames per integration
XST, XSINT, XSWARM, XSTIMED = 64, 256, 4, 16
XCHANNELS = (0, 511, 1023)


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
    ms = cuda_ms(lambda: spec.fused_spectrometer(volt, rfactor=RFACTOR))
    plain_ms = cuda_ms(lambda: spec.spectrometer_plain(volt, RFACTOR))
    library_ms = cuda_ms(lambda: library_chain(volt, RFACTOR))
    nsamp = NTIME * NPOL * NFINE
    nbyte = 2 * nsamp + 4 * 4 * NTIME * (NFINE // RFACTOR)
    nflop = NTIME * NPOL * 5 * NFINE * int(np.log2(NFINE)) + \
        20 * NTIME * NFINE
    bms, by = bound(nbyte, nflop)
    log('K1 kernel %.4f ms, plain %.4f ms, torch chain %.4f ms, '
        'bound %.4f ms (%s)' % (ms, plain_ms, library_ms, bms, by))
    torch.cuda.empty_cache()
    return {'name': 'fused_spectrometer', 'route': 'cuda',
            'source': 'bifrost_tpu_torch/csrc/spectrometer.cu',
            'replaces': 'bifrost_tpu/ops/spectrometer.py:341',
            'shape': [NTIME, NPOL, NFINE, 2], 'rfactor': RFACTOR,
            'oracle_rel_err': oracle_rel, 'max_abs_err': abs_err,
            'max_rel_err': rel, 'ms': ms, 'kernel_ms': ms,
            'plain_ms': plain_ms, 'bound_ms': bms, 'bound_by': by,
            'library_ms': library_ms}


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
    for k in gpu_kernels.launches:
        gpu_kernels.launches[k] = 0


def read_counts(spec, gpu_kernels):
    return dict(gpu_kernels.launches, fused_spectrometer=spec.launches)


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
    out_bytes = 2 * T * F * B * 4
    in_bytes = 2 * T * F * S + 2 * B * S
    nops = 8 * T * F * B * S

    # K4: exact int32
    yr, yi = gpu_kernels.beamform_int8(wr8, wi8, re, im)
    pr, pi = gpu_kernels.beamform_int8_plain(wr8, wi8, re, im)
    torch.cuda.synchronize()
    require(torch.equal(yr, pr) and torch.equal(yi, pi),
            'K4 is not bit-identical to its plain version')
    for f in (0, F // 2, F - 1):
        want_r, want_i = int64_beams(eng.wr8[0], eng.wi8[0],
                                     re[:, f:f + 1].cpu().numpy(),
                                     im[:, f:f + 1].cpu().numpy())
        require(np.array_equal(yr[:, f:f + 1].cpu().numpy(), want_r) and
                np.array_equal(yi[:, f:f + 1].cpu().numpy(), want_i),
                'K4 differs from the int64 oracle on channel %d' % f)
    log('K4 beamform_int8 (%d, %d, %d) x %d beams: bit-identical to its '
        'plain version and to the int64 oracle on 3 channels' % (T, F, S, B))
    k4 = kernel_entry(
        'beamform_int8', src, 265, torch.complex(yr.double(), yi.double()),
        torch.complex(pr.double(), pi.double()),
        cuda_ms(lambda: gpu_kernels.beamform_int8(wr8, wi8, re, im)),
        cuda_ms(lambda: gpu_kernels.beamform_int8_plain(wr8, wi8, re, im),
                runs=5),
        in_bytes + out_bytes, nops, PEAK_INT8_PER_S,
        cuda_ms(lambda: torch._int_mm(z, w2)),
        shape=[T, F, S, B], per='launch (one pol)',
        library='torch._int_mm of [re | im] (T*F, 2S) x widened (2S, 2B)')
    del yr, yi, pr, pi

    # K5: bf16 products, float32 sums
    yr, yi = gpu_kernels.beamform_bf16(wr, wi, re, im)
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
    w2b = torch.cat([torch.cat([wr.T, wi.T], 1),
                     torch.cat([-wi.T, wr.T], 1)], 0).bfloat16()
    zb = z.bfloat16()
    k5 = kernel_entry(
        'beamform_bf16', src, 307, got, want,
        cuda_ms(lambda: gpu_kernels.beamform_bf16(wr, wi, re, im)),
        cuda_ms(lambda: gpu_kernels.beamform_bf16_plain(wr, wi, re, im),
                runs=5),
        in_bytes + out_bytes, nops, PEAK_BF16_PER_S,
        cuda_ms(lambda: torch.matmul(zb, w2b)),
        shape=[T, F, S, B], per='launch (one pol)', max_rel_err=rel5,
        oracle_rel_err=rel5o,
        library='bf16 torch.matmul of [re | im] x widened f32 block '
                'rounded to bf16')
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
    got = beam.fused_detect(eng, x, R)
    want = gpu_kernels.beamform_detect_int8_plain(*ws, x, eng.wscale, R)
    torch.cuda.synchronize()
    rel6 = float((got - want).abs().max() / want.abs().max())
    log('K6 full width vs plain: rel %.3g (bit-identical: %s)'
        % (rel6, torch.equal(got, want)))
    require(rel6 <= 1e-6, 'K6 disagrees with its plain version: %.3g'
            % rel6)
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
    k6 = kernel_entry(
        'beamform_detect_int8', src, 384, got, want,
        cuda_ms(lambda: beam.fused_detect(eng, x, R)),
        cuda_ms(lambda: gpu_kernels.beamform_detect_int8_plain(
            *ws, x, eng.wscale, R), runs=5),
        x.numel() + 4 * B * S + (T // R) * F * 4 * B * 4, 2 * nops,
        PEAK_INT8_PER_S, cuda_ms(library_chain6, runs=10),
        shape=[T, F, S, P, 2], rfactor=R, per='launch (one gulp)',
        max_rel_err=rel6, oracle_rel_err=orel,
        library='torch chain int8_wide (torch._int_mm) -> Stokes -> '
                'frame sum')
    del got, want, lib6, x
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
                old = os.environ.get('BF_CACHE_DIR')
                os.environ['BF_CACHE_DIR'] = tmp
                stack.callback(lambda: os.environ.pop('BF_CACHE_DIR')
                               if old is None else
                               os.environ.__setitem__('BF_CACHE_DIR', old))
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
                  'K5': beam.BEAM_CLASSES['bf16']}
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


def phase_probe(gpu_kernels):
    """K0: available() builds and runs the probe kernel on the card once,
    and a second call answers from its cache."""
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
    return kernel_entry(
        'probe', 'bifrost_tpu_torch/csrc/probe.cu', 40, got, want,
        cuda_ms(lambda: gpu_kernels.probe(x)), cuda_ms(lambda: x * 2),
        2 * x.numel() * 4, x.numel(), PEAK_FP32_PER_S,
        cuda_ms(lambda: torch.mul(x, 2.0)), shape=[8, 128],
        per='launch', available_first_call_ms=first_ms,
        library='torch.mul(x, 2.0)')


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
    before = gpu_kernels.launches['xcorr_herm']
    got = gpu_kernels.xcorr_herm(re, im)
    want = gpu_kernels.xcorr_herm_plain(re, im)
    torch.cuda.synchronize()
    require(gpu_kernels.launches['xcorr_herm'] == before + 1,
            'K7 took more than one launch for the gulp')
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
    k7 = kernel_entry(
        'xcorr_herm', 'bifrost_tpu_torch/csrc/xcorr.cu', 155, got, want,
        cuda_ms(lambda: gpu_kernels.xcorr_herm(re, im)),
        cuda_ms(lambda: gpu_kernels.xcorr_herm_plain(re, im), runs=3),
        2 * XT * XF * XN + 8 * ng * XF * XN * XN, 8 * XT * XF * XN * XN,
        PEAK_INT8_PER_S, cuda_ms(lib, runs=5),
        shape=[ng, XR, XF, XN], per='launch (one gulp)',
        library="complex64 torch.einsum('tfi,tfj->fij', x, x.conj()), the "
                "'xla' candidate, conversion untimed")
    del xc, want

    # K8: a 4-way station-row block against all inputs, T = 128
    sb = XS // 4
    ri = x[:XR, :, :sb, :, 0].reshape(XR, XF, sb * XP)
    ii = x[:XR, :, :sb, :, 1].reshape(XR, XF, sb * XP)
    rj = x[:XR, ..., 0].reshape(XR, XF, XN)
    ij = x[:XR, ..., 1].reshape(XR, XF, XN)
    before = gpu_kernels.launches['xcorr_cross']
    got8 = gpu_kernels.xcorr_cross(ri, ii, rj, ij)
    want8 = gpu_kernels.xcorr_cross_plain(ri, ii, rj, ij)
    torch.cuda.synchronize()
    require(gpu_kernels.launches['xcorr_cross'] == before + 1,
            'K8 took more than one launch')
    require(torch.equal(got8, want8), 'K8 is not bit-identical to its '
            'plain version')
    require(torch.equal(got8, got[0, :, :sb * XP, :]),
            "K8's rows differ from K7's")
    check_channels('K8', got8, (ri, ii, rj, ij))
    log('K8 xcorr_cross (%d, %d, %d) x (%d, %d, %d): bit-identical to its '
        'plain version, to the int64 oracle on channels %s and to K7\'s '
        'rows' % (XR, XF, sb * XP, XR, XF, XN, list(XCHANNELS)))
    del got
    xi_c = torch.complex(ri.float(), ii.float())
    xj_c = torch.complex(rj.float(), ij.float())
    k8 = kernel_entry(
        'xcorr_cross', 'bifrost_tpu_torch/csrc/xcorr.cu', 199, got8, want8,
        cuda_ms(lambda: gpu_kernels.xcorr_cross(ri, ii, rj, ij)),
        cuda_ms(lambda: gpu_kernels.xcorr_cross_plain(ri, ii, rj, ij),
                runs=5),
        2 * XR * XF * (sb * XP + XN) + 8 * XF * sb * XP * XN,
        8 * XR * XF * sb * XP * XN, PEAK_INT8_PER_S,
        cuda_ms(lambda: torch.einsum('tfi,tfj->fij', xi_c, xj_c.conj())),
        shape=[XR, XF, sb * XP, XN], per='launch',
        library="complex64 torch.einsum('tfi,tfj->fij', x_i, x_j.conj()), "
                "conversion untimed")
    del got8, want8, xi_c, xj_c, x
    torch.cuda.empty_cache()
    return k7, k8


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
                      'fx-f32': ('f32', 'xla')}[arm]
    header = fx_header(['time', 'fine', 'station', 'pol'], XT)

    def chain(h2d):
        b = bt.blocks.fft(h2d, axes='fine', axis_labels='freq')
        blocks.append(('fft', b))
        b = bt.blocks.quantize(b, 'ci8', scale=XSCALE)
        blocks.append(('quantize', b))
        b = bt.blocks.correlate(b, XR, accuracy=accuracy, impl=impl,
                                fusable=True)
        blocks.append(('correlate', b))
        blocks.append(('accumulate', bt.blocks.accumulate(b, XA,
                                                          fusable=True)))
        return blocks
    out, secs, per_gulp = drive(bt, gulps, header, chain, XWARM, XTIMED)
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
                old = os.environ.get('BF_CACHE_DIR')
                os.environ['BF_CACHE_DIR'] = tmp
                stack.callback(lambda: os.environ.pop('BF_CACHE_DIR')
                               if old is None else
                               os.environ.__setitem__('BF_CACHE_DIR', old))
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
    del ref, oracle
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
    return {'rates': rates, 'launches': runs}


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
    gpu_kernels.launches['xcorr_cross'] = 0
    rows = [L.xcorr_int8(x[:, :, b * sb:(b + 1) * sb, :, 0]
                         .reshape(XR, XF, sb * XP),
                         x[:, :, b * sb:(b + 1) * sb, :, 1]
                         .reshape(XR, XF, sb * XP), rj, ij, impl='pallas')
            for b in range(4)]
    n = gpu_kernels.launches['xcorr_cross']
    full = L.xcorr_int8(rj, ij, impl='pallas')
    torch.cuda.synchronize()
    require(n == 4, 'xcorr_int8 cross: %d K8 launches for 4 blocks' % n)
    require(torch.equal(torch.cat(rows, dim=1), full),
            'the cross blocks differ from the auto-correlation')
    log('xcorr_int8 cross family: 4 station-row blocks (K8) equal the auto '
        'family (K7) at (%d, %d, %d)' % (XR, XF, XN))
    del rows, full, x
    torch.cuda.empty_cache()
    return n


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

    k2 = phase_stokes(gpu_kernels)
    torch.cuda.empty_cache()
    k1 = phase_spectrometer(spec)
    torch.cuda.empty_cache()
    pipe = phase_pipeline(bt, spec, gpu_kernels, smi)
    torch.cuda.empty_cache()
    k4, k5, k6 = phase_beamform_kernels(gpu_kernels, beam)
    bpipe = phase_beamform_pipeline(bt, spec, gpu_kernels, beam, smi)
    torch.cuda.empty_cache()
    k0 = phase_probe(gpu_kernels)
    k7, k8 = phase_xcorr_kernels(gpu_kernels)
    fx = phase_fx_pipeline(bt, spec, gpu_kernels, smi)
    n8 = phase_xcorr_int8(L, gpu_kernels)
    k1['launches'] = pipe['launches_k1_run']['fused_spectrometer']
    k2['launches'] = pipe['launches_k2_run']['stokes_detect']
    k4['launches'] = bpipe['launches']['K4']['beamform_int8']
    k5['launches'] = bpipe['launches']['K5']['beamform_bf16']
    k6['launches'] = bpipe['launches']['K6']['beamform_detect_int8']
    for k in (k1, k2, k4, k5, k6):
        k['launches_per_gulp'] = k['launches'] / float(NWARM + NTIMED)
    k0['launches'] = fx['launches']['fx-race']['probe']
    k0['launches_of'] = 'the fx-race arm (one available() per process)'
    k7['launches'] = fx['launches']['fx-K7']['xcorr_herm']
    k7['launches_per_gulp'] = k7['launches'] / float(XWARM + XTIMED)
    k7['launches_x_stateful'] = fx['launches']['x-stateful']['xcorr_herm']
    k8['launches'] = n8
    k8['launches_of'] = 'xcorr_int8 cross family, 4 station-row blocks'
    kernels = [k1, k2, k4, k5, k6, k0, k7, k8]
    log('total %.1f s' % (time.perf_counter() - t_start))
    log(json.dumps({'pipeline': {
        'gulp': [NTIME, NPOL, NFINE], 'rfactor': RFACTOR,
        'gulps_timed': NTIMED,
        'msps_cuda_spectrometer': pipe['msps_cuda_spectrometer'],
        'msps_torch_fused': pipe['msps_torch_fused']}, 'card': smi}))
    log(json.dumps({'beamformer_pipeline': {
        'gulp': [BT, BF, BS, BP], 'nbeam': BB, 'rfactor': BR,
        'gulps_timed': NTIMED, 'arms': bpipe['rates']}, 'card': smi}))
    log(json.dumps({'fx_pipeline': {
        'gulp': [XT, XF, XS, XP], 'nframe_per_vis': XR, 'naccumulate': XA,
        'scale': XSCALE, 'gulps_timed': XTIMED,
        'x_stateful_gulp': [XST, XF, XS, XP], 'x_stateful_integration': XSINT,
        'x_stateful_gulps_timed': XSTIMED, 'arms': fx['rates'],
        'launches': fx['launches']}, 'card': smi}))
    log(json.dumps({'kernels': kernels}))
    log(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name,
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
