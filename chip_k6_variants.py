#!/usr/bin/env python3
"""Where K6's time goes on the card: its int8 tensor-core kernel against
copies of its source with one part changed, built and timed in turns.

    python3 chip_k6_variants.py

Run from the repository root on a machine with an NVIDIA card and the
CUDA toolkit (nvcc).  Each variant is a copy of
``bifrost_tpu_torch/csrc/beamform.cu`` with one edit to
``beamform_detect_mma_kernel``, built with the port's nvcc flags into
``bifrost_tpu_torch/_build/variants/``:

- ``kernel``: the source as it is (a 3-stage cp.async ring, tiles
  ordered channel quad fastest, the four n8 tiles' shuffle chains
  stepped together);
- ``four_stages``, ``six_stages``: a deeper ring;
- ``time_fastest``: tiles ordered time fastest, then channel quad;
- ``chains_by_tile``: the epilogue forms one n8 tile's Stokes values and
  runs its chain before the next tile's;
- ``i2f_split``: int32 -> float32 as 65536 hi + lo on the FP32 pipe
  (two exact parts, one rounding in an fma) instead of I2F;
- ``no_epilogue``, ``no_mma``, ``no_read``: the Stokes and frame-sum
  epilogue, the MMAs (each replaced by one xor-add of its operands) or
  the HBM read (every cp.async zero-fills) dropped.  Their output is
  wrong by design; they show what the dropped part costs.

Each variant is launched through its ``bf_beamform_detect_int8_mma`` on
the full-width beamformer gulp (512 x 512 x 256 stations x 2 pols ci8,
64 beams) at R 8, 1 and 16 and timed queued (median of 5 batches of 20
back-to-back launches) in the order a, b, ..., ..., b, a.  The variants
that keep the function must be bit-identical to the plain version.  It
prints ptxas' register and spill lines of the kernel, one JSON line per
R and the card's name and power limit.
"""

import ctypes
import json
import os
import subprocess
import sys

T, F, S, B = 512, 512, 256, 64
RS = (8, 1, 16)
SCALE = 0.0123

#: the epilogue's body with one n8 tile's Stokes values and chain at a
#: time
CHAINS_BY_TILE = r'''  const int nb = tile / a.ntile_tf, tf = tile - nb * a.ntile_tf;
  const int tt = tf / a.ntile_f, fq = tf - tt * a.ntile_f;
  const int f = fq * kCF6 + mt, t = tt * kTF6 + 2 * g;
  const int n = a.R >> 1;
  const int gl = n ? g % n : 0;
  const bool fin = f < a.F;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int b = nb * kBB4 + bw0 + 8 * j + 2 * q;
    float v[2][2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        k6_stokes(acc[0][j][0][2 * h + e], acc[0][j][1][2 * h + e],
                  acc[1][j][0][2 * h + e], acc[1][j][1][2 * h + e], a.scale,
                  v[h][e]);
    if (n == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (fin && t + h < a.T) k6_store(a, t + h, f, b, v[h]);
      continue;
    }
    float s[2][4];
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int k = 0; k < 4; ++k) s[e][k] = __fadd_rn(v[0][e][k], v[1][e][k]);
    for (int step = 1; step < n; ++step) {
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float prev = __shfl_up_sync(~0u, s[e][k], 4);
          if (gl == step)
            s[e][k] = __fadd_rn(__fadd_rn(prev, v[0][e][k]), v[1][e][k]);
        }
    }
    if (gl == n - 1 && fin && t < a.T) k6_store(a, t / a.R, f, b, s);
  }
}

'''

I2F_SPLIT = r'''__device__ __forceinline__ float k6_i2f(int v) {
  const float hi = __int_as_float(0x4B000000 | ((v >> 16) + 0x400000)) -
                   12582912.f;
  const float lo = __int_as_float(0x4B000000 | (v & 0xffff)) - 8388608.f;
  return __fmaf_rn(hi, 65536.f, lo);
}

'''


def variants(src):
    """{name: (source, keeps the function)}; each edit must apply."""
    k6 = (src.index('constexpr int kTF6'), src.index('int64_t cdiv('))

    def edit(old, new, count=1):
        body = src[k6[0]:k6[1]]
        assert body.count(old) == count, old
        return src[:k6[0]] + body.replace(old, new) + src[k6[1]:]

    def between(first, last, new):
        assert src.count(first) == 1 and src.count(last) == 1
        a, b = src.index(first), src.index(last)
        assert k6[0] <= a < b <= k6[1], (first, last)
        return src[:a] + new + src[b:]

    epi = '  const int nb = tile / a.ntile_tf, tf = tile - nb * a.ntile_tf;\n'
    kernel_start = '__global__ void __launch_bounds__(kThreads4, 1)\n' \
        'beamform_detect_mma_kernel'
    stokes = '// Stokes I, Q, U, V of one frame and beam'
    body = src[src.index(stokes):src.index('// I, Q, U, V of beams b, b + 1')]
    assert body.count('__int2float_rn(') == 4
    i2f = between(stokes, '// I, Q, U, V of beams b, b + 1',
                  I2F_SPLIT + body.replace('__int2float_rn(', 'k6_i2f('))
    mmas = ['mma_s8(acc[p][j][%d], %s, %s[j]);' % (d, a, b) for d, a, b in
            ((0, 'ar', 'fr'), (1, 'ar', 'fi'), (0, 'an', 'fi'),
             (1, 'ai', 'fr'))]
    no_mma = src
    for m in mmas:
        assert no_mma[k6[0]:k6[1]].count(m) == 1, m
        d, a, b = m[len('mma_s8('):-2].split(', ')
        no_mma = no_mma.replace(m, '%s[0] += (int)(%s[0] ^ %s.x);'
                                % (d, a, b))
    return {
        'kernel': (src, True),
        'four_stages': (edit('kStages6 = 3;', 'kStages6 = 4;'), True),
        'six_stages': (edit('kStages6 = 3;', 'kStages6 = 6;'), True),
        'time_fastest': (edit(
            'const int tt = tf / a.ntile_f, fq = tf - tt * a.ntile_f;',
            'const int fq = tf / (a.ntile_tf / a.ntile_f), '
            'tt = tf - fq * (a.ntile_tf / a.ntile_f);', 2), True),
        'chains_by_tile': (between(epi, kernel_start, CHAINS_BY_TILE),
                           True),
        'i2f_split': (i2f, True),
        'no_epilogue': (edit('    k6_epilogue(a, acc',
                             '    if (a.R < 0) k6_epilogue(a, acc'), False),
        'no_mma': (no_mma, False),
        'no_read': (edit('ok ? 16 : 0);', '0);'), False),
    }


def build(names_sources, out_dir):
    """One nvcc per variant, all started together: {name: C entry}."""
    from bifrost_tpu_torch import _build
    from bifrost_tpu_torch.ops import gpu_kernels as gk
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, src in names_sources.items():
        cu = os.path.join(out_dir, 'k6_%s.cu' % name)
        with open(cu, 'w') as f:
            f.write(src)
        so = os.path.join(out_dir, 'libk6_%s.so' % name)
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc()] + _build.NVCC_FLAGS + ['-o', so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (so, p) in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError('nvcc failed for %s:\n%s' % (name, out))
        lines = out.splitlines()
        for i, line in enumerate(lines):
            if 'Compiling' in line and 'beamform_detect_mma' in line:
                for info in lines[i + 1:i + 4]:
                    if 'registers' in info or 'spill' in info:
                        print(name, info.strip(), flush=True)
        fn = ctypes.CDLL(so).bf_beamform_detect_int8_mma
        fn.argtypes, fn.restype = gk._DETECT_ARGS, ctypes.c_int
        fns[name] = fn
    return fns


def main():
    import torch
    if not torch.cuda.is_available():
        sys.stderr.write('chip_k6_variants: no CUDA device is available\n')
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import chip_smoke as cs
    from bifrost_tpu_torch import _build, device
    from bifrost_tpu_torch.ops import gpu_kernels as gk
    device.set_device('cuda:0')
    smi = cs.nvidia_smi_line()
    with open(os.path.join(_build.CSRC, 'beamform.cu')) as f:
        vs = variants(f.read())
    fns = build({k: v[0] for k, v in vs.items()},
                os.path.join(_build.BUILD_DIR, 'variants'))
    names = list(vs)
    g = torch.Generator(device='cuda').manual_seed(7)
    x = torch.randint(-128, 128, (T, F, S, 2, 2), dtype=torch.int8,
                      device='cuda', generator=g)
    ws = [torch.randint(-128, 128, (B, S), dtype=torch.int8, device='cuda',
                        generator=g) for _ in range(4)]
    for R in RS:
        want = gk.beamform_detect_int8_plain(*ws, x, SCALE, R)
        out = torch.empty_like(want)
        args = lambda: ([w.data_ptr() for w in ws] +
                        [x.data_ptr(), out.data_ptr(), SCALE, T, F, S, B, R,
                         F * S * 4, S * 4, _build.stream_ptr(x.device)])
        res = {}
        for name in names:
            out.fill_(float('nan'))
            if fns[name](*args()) != 0:
                raise RuntimeError('%s did not launch' % name)
            torch.cuda.synchronize()
            same = bool(torch.equal(out, want))
            if vs[name][1] and not same:
                raise RuntimeError('%s is not bit-identical to the plain '
                                   'version at R %d' % (name, R))
            res[name] = {'bit_identical': same, 'ms_queued': []}
        for name in names + names[::-1]:
            fn = fns[name]
            res[name]['ms_queued'].append(
                cs.cuda_ms_queued(lambda: fn(*args())))
        nbyte = x.numel() + 4 * B * S + want.numel() * 4
        bms, by = cs.bound(nbyte, 16 * T * F * B * S, cs.PEAK_INT8_PER_S)
        print(json.dumps({'rfactor': R, 'shape': [T, F, S, 2, 2],
                          'nbeam': B, 'bound_ms': bms, 'bound_by': by,
                          'variants': res, 'card': smi}), flush=True)
        del want, out
        torch.cuda.empty_cache()
    print(smi)
    return 0


if __name__ == '__main__':
    sys.exit(main())
