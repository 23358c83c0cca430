#!/usr/bin/env python3
"""Where K1's time goes on the card: the radix-16 spectrometer kernel
against copies of its source with one part changed, built and timed in
turns.

    python3 chip_k1_variants.py

Run from the repository root on a machine with an NVIDIA card and the
CUDA toolkit (nvcc).  Each variant is a copy of
``bifrost_tpu_torch/csrc/spectrometer.cu`` with one edit, built with the
port's nvcc flags into ``bifrost_tpu_torch/_build/variants/``:

- ``kernel``: the source as it is (two blocks an SM at nfft 4096, at
  most 128 registers a thread);
- ``three_blocks``: three blocks an SM at nfft 4096 (at most 85
  registers a thread, so ptxas spills);
- ``shared_twiddles``: each pass's twiddles loaded once a thread and
  used for both pols (half the twiddle loads);
- ``no_twiddles``, ``no_load``, ``no_epilogue``: the twiddle loads and
  multiplies, the ci8 read (values made from the index instead) or the
  Stokes epilogue dropped.  Their output is wrong by design; they show
  what the dropped part costs.

Each variant's radix-16 kernel is timed queued (median of 5 batches of
20 back-to-back launches) on gulps of 16384 x 2 x 4096 and 8192 x 2 x
8192 ci8 samples, r 4, in the order a, b, ..., ..., b, a.  The variants
that keep the function are held to the plain version (rel < 1e-5).  It
prints ptxas' register and spill lines, one JSON line per nfft and the
card's name and power limit.
"""

import ctypes
import json
import os
import subprocess
import sys

GATE = 1e-5
RFACTOR = 4
NSAMPLES = 16384 * 4096


def variants(src):
    """{name: (source, keeps the function)}; each edit must apply."""
    def edit(old, new):
        assert src.count(old) == 1, old
        return src.replace(old, new)

    shared = edit('''#pragma unroll
  for (int p = 0; p < 2; ++p) {
    float2 v[16];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int j = t + g * nb;
      const int k = j & (NS - 1);
#pragma unroll
      for (int r = 0; r < R; ++r) {''', '''  float2 w[16];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int k = (t + g * nb) & (NS - 1);
#pragma unroll
    for (int r = 1; r < R; ++r)
      if constexpr (!kFirst)
        w[g * R + r] = __ldg(twiddle + r * k * (n / (NS * R)));
  }
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    float2 v[16];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int j = t + g * nb;
#pragma unroll
      for (int r = 0; r < R; ++r) {''')
    shared = shared.replace(
        'if (r > 0) x = cmul(x, __ldg(twiddle + r * k * (n / (NS * R))));',
        'if (r > 0) x = cmul(x, w[g * R + r]);')
    epilogue = ('  // Stokes of x = pol 0, y = pol 1, summed over rfactor '
                'adjacent bins.\n  const int nout = K::kN / rfactor;')
    end = 'template <int L>\nint launch_radix16'
    assert src.count(epilogue) == 1 and src.count(end) == 1
    a, b = src.index(epilogue), src.index(end)
    return {
        'kernel': (src, True),
        'three_blocks': (edit(
            'kMinBlocks = 512 / (kThreads < 32 ? 32 : kThreads);',
            'kMinBlocks = 768 / (kThreads < 32 ? 32 : kThreads);'), True),
        'shared_twiddles': (shared, True),
        'no_twiddles': (edit('__ldg(twiddle + r * k * (n / (NS * R)))',
                             'make_float2(1.f, 0.f)'), False),
        'no_load': (edit('unpack_ci8(__ldg(row + p * n + src))',
                         'unpack_ci8((uint16_t)(src * 40503u + p))'), False),
        'no_epilogue': (src[:a] + '  if (t == 0) out[tr] = sm[0].x + '
                        'sm[K::kPadded].y;\n}\n\n' + src[b:], False),
    }


def build(names_sources, out_dir):
    """One nvcc per variant, all started together: {name: C entry}."""
    from bifrost_tpu_torch import _build
    from bifrost_tpu_torch.ops import spectrometer as spec
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, src in names_sources.items():
        cu = os.path.join(out_dir, name + '.cu')
        with open(cu, 'w') as f:
            f.write(src)
        so = os.path.join(out_dir, 'lib%s.so' % name)
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc()] + _build.NVCC_FLAGS + ['-o', so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (so, p) in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError('nvcc failed for %s:\n%s' % (name, out))
        for line in out.splitlines():
            if 'registers' in line or 'spill' in line:
                print(name, line.strip(), flush=True)
        fn = ctypes.CDLL(so).bf_spectrometer
        fn.argtypes, fn.restype = spec._ARGTYPES, ctypes.c_int
        fns[name] = fn
    return fns


def main():
    import torch
    if not torch.cuda.is_available():
        sys.stderr.write('chip_k1_variants: no CUDA device is available\n')
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import chip_smoke as cs
    from bifrost_tpu_torch import _build, device
    from bifrost_tpu_torch.ops import spectrometer as spec
    device.set_device('cuda:0')
    smi = cs.nvidia_smi_line()
    with open(os.path.join(_build.CSRC, 'spectrometer.cu')) as f:
        vs = variants(f.read())
    fns = build({k: v[0] for k, v in vs.items()},
                os.path.join(_build.BUILD_DIR, 'variants'))
    names = list(vs)
    for nfft in (4096, 8192):
        T = NSAMPLES // nfft
        g = torch.Generator(device='cuda').manual_seed(nfft)
        volt = torch.randint(-128, 128, (T, 2, nfft, 2), dtype=torch.int8,
                             device='cuda', generator=g)
        want = spec.spectrometer_plain(volt, RFACTOR)
        tw = spec._twiddle(nfft, volt.device)
        out = torch.empty_like(want)
        args = lambda: (volt.data_ptr(), tw.data_ptr(), out.data_ptr(), T,
                        nfft.bit_length() - 1, RFACTOR, 1,
                        _build.stream_ptr(volt.device))
        res = {}
        for name in names:
            if fns[name](*args()) != 0:
                raise RuntimeError('%s did not launch' % name)
            torch.cuda.synchronize()
            rel = float((out - want).abs().max() / want.abs().max())
            if vs[name][1] and not rel < GATE:
                raise RuntimeError('%s disagrees with the plain version: '
                                   'rel %.3g' % (name, rel))
            res[name] = {'rel_err': rel, 'ms_queued': []}
        for name in names + names[::-1]:
            fn = fns[name]
            res[name]['ms_queued'].append(
                cs.cuda_ms_queued(lambda: fn(*args())))
        bms, by = cs.spectrometer_bound(T, nfft, RFACTOR)
        print(json.dumps({'nfft': nfft, 'shape': [T, 2, nfft, 2],
                          'rfactor': RFACTOR, 'bound_ms': bms,
                          'bound_by': by, 'variants': res,
                          'card': smi}), flush=True)
        del volt, want, out
        torch.cuda.empty_cache()
    print(smi)
    return 0


if __name__ == '__main__':
    sys.exit(main())
