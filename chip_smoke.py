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
6. prints a JSON line of pipeline rates, one JSON line of per-kernel
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
# H100 SXM data sheet: HBM3 rate and FP32 rate outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12


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


def bound(nbyte, nflop):
    """(bound_ms, bound_by) from the bytes moved once and the FP32 ops."""
    t_bytes = nbyte / PEAK_BYTES_PER_S * 1e3
    t_ops = nflop / PEAK_FP32_PER_S * 1e3
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


def run_pipeline(bt, gulps, substitute, ntime=NTIME, nwarm=NWARM,
                 ntimed=NTIMED):
    """Drive source -> copy('cuda') -> fused -> copy('system') -> sink.
    ``gulps`` are (T, 2, nfft, 2) int8 arrays, sent in turn.  Returns
    (outputs {gulp index: array}, Msamples/s, impl_info, per-block host
    milliseconds per gulp)."""
    from bifrost_tpu_torch.stages import FftStage, DetectStage, ReduceStage
    ngulp = nwarm + ntimed
    nfine = gulps[0].shape[2]
    gulps = [g.reshape(ntime, NPOL, 2 * nfine) for g in gulps]
    header = {'name': 'guppi', 'time_tag': 0,
              '_tensor': {'shape': [-1, NPOL, nfine], 'dtype': 'ci8',
                          'labels': ['time', 'pol', 'fine_time'],
                          'scales': [[0, 1]] * 3, 'units': [None] * 3}}

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
            ospans[0].data.as_numpy().view(np.int8)[...] = \
                gulps[self.count % len(gulps)]
            self.count += 1
            return [ntime]

    class Sink(bt.SinkBlock):
        keep = (0, 1, ngulp - 1)

        def __init__(self, iring):
            super(Sink, self).__init__(iring)
            self.n = 0
            self.t0 = self.t1 = None
            self.out = {}

        def on_sequence(self, iseq):
            pass

        def on_data(self, ispan):
            # host bytes here mean the device work of this gulp is done
            if self.n == nwarm - 1:
                self.t0 = time.perf_counter()
            elif self.n == ngulp - 1:
                self.t1 = time.perf_counter()
            if self.n in self.keep:
                self.out[self.n] = np.array(ispan.data.as_numpy(),
                                            copy=True)
            self.n += 1

    with bt.Pipeline() as p:
        src = Source()
        h2d = bt.blocks.copy(src, space='cuda')
        fb = bt.blocks.fused(h2d, [FftStage('fine_time',
                                            axis_labels='freq'),
                                   DetectStage('stokes', axis='pol'),
                                   ReduceStage('freq', RFACTOR)],
                             substitute=substitute)
        d2h = bt.blocks.copy(fb, space='system')
        sink = Sink(d2h)
        p.run()
    require(sink.n == ngulp, 'sink received %d of %d gulps'
            % (sink.n, ngulp))
    msps = ntimed * ntime * NPOL * nfine / (sink.t1 - sink.t0) / 1e6
    per_gulp = {}
    for role, blk in (('source', src), ('h2d', h2d), ('fused', fb),
                      ('d2h', d2h), ('sink', sink)):
        tot = blk.perf_totals
        per_gulp[role] = {k: tot[k] / max(tot['ngulp'], 1) * 1e3
                          for k in ('acquire', 'reserve', 'process')}
    return sink.out, msps, fb.impl_info, per_gulp


def phase_pipeline(bt, spec, gpu_kernels, smi):
    volts = make_gulps()
    runs = {}
    for substitute in (True, False):
        spec.launches = 0
        gpu_kernels.launches = 0
        out, msps, info, per_gulp = run_pipeline(bt, volts, substitute)
        counts = {'fused_spectrometer': spec.launches,
                  'stokes_detect': gpu_kernels.launches}
        log('pipeline substitute=%s: impl %s, launches %s, %.1f Msamples/s '
            '(%s)' % (substitute, info, counts, msps, smi))
        for role, t in per_gulp.items():
            log('  %-6s host ms/gulp: acquire %.2f reserve %.2f process %.2f'
                % (role, t['acquire'], t['reserve'], t['process']))
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
    k1['launches'] = pipe['launches_k1_run']['fused_spectrometer']
    k2['launches'] = pipe['launches_k2_run']['stokes_detect']
    for k in (k1, k2):
        k['launches_per_gulp'] = k['launches'] / float(NWARM + NTIMED)
    log('total %.1f s' % (time.perf_counter() - t_start))
    log(json.dumps({'pipeline': {
        'gulp': [NTIME, NPOL, NFINE], 'rfactor': RFACTOR,
        'gulps_timed': NTIMED,
        'msps_cuda_spectrometer': pipe['msps_cuda_spectrometer'],
        'msps_torch_fused': pipe['msps_torch_fused']}, 'card': smi}))
    log(json.dumps({'kernels': [k1, k2]}))
    log(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name,
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
