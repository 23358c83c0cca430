#!/usr/bin/env python3
"""Where K8's time goes on the card: the correlator kernel against copies
of its source with one part changed, built and timed in turns.

    python3 chip_k8_variants.py [--source NAME=PATH ...]

Run from the repository root on a machine with an NVIDIA card and the
CUDA toolkit (nvcc).  Each variant is a copy of
``bifrost_tpu_torch/csrc/xcorr.cu`` with one edit to ``xcorr_kernel``
(which K7 and K8 share), built with the port's nvcc flags into
``bifrost_tpu_torch/_build/variants/``:

- ``kernel``: the source as it is;
- ``no_write``: the store warps take each finished tile from its slot
  but write nothing to HBM;
- ``no_stage``: a block stages only its first resident job; later jobs
  multiply what lies in shared memory, so the input read, the cp.async
  groups and the wait for a job's first blocks drop out;
- ``no_mma``: the fragment loads and tensor-core products of each tile
  dropped;
- ``early_rowblock``: K8's row block in two alternating buffers (16 KB
  more at T = 128), the next job's issued before this job's last tile,
  so a job waits only for its first column block.

``no_write``, ``no_stage`` and ``no_mma`` give wrong output by design; they show what the dropped
part costs.  ``--source NAME=PATH`` adds another version of the file
(the parent commit's, say): its K7 is timed beside the variants', and
its K8 too where it has this version's C entries.

K8 is launched through each variant's ``bf_xcorr_cross`` on the strided
views of a seeded (256, 1024, 256, 2, 2) ci8 gulp at three shapes: the
kernel table's 128 rows against 512 columns over 128 frames and the 2-D
mesh's 256 rows (row-block jobs), and 128 rows over 256 frames (chunked
jobs); K7 through ``bf_xcorr_herm`` at the FX path's (2, 128, 1024, 512)
and at T = 256.  Each is timed queued (median of 5 batches of 20
back-to-back launches) in the order a, b, ..., ..., b, a; the variants
that keep the function must be bit-identical to the plain version.  It
prints ptxas' register and spill lines of both kernels, one JSON line
per shape and the card's name and power limit.
"""

import ctypes
import json
import os
import subprocess
import sys

XT, XF, XS, XP = 256, 1024, 256, 2
#: (name, K7 or K8, frames, stations of the rows): K8's rows are the
#: first stations, its columns all of them
SHAPES = (('k8_table', 'k8', 128, 64), ('k8_mesh_2d', 'k8', 128, 128),
          ('k8_chunked_T256', 'k8', 256, 64), ('k7_fx', 'k7', 128, XS),
          ('k7_T256', 'k7', 256, XS))


#: K8's row block in two alternating buffers (pieces 0 .. 7 and 8 .. 15,
#: the columns from piece 16), the next job's issued before this job's
#: last tile
EARLY_ROWBLOCK = (
    ('      bar_sync(kBarCompute, kCompute7);      // the last job is done\n',
     '      bar_sync(kBarCompute, kCompute7);      // the last job is done\n'
     '      const int rb = 8 * (int)(((job - blockIdx.x) / gridDim.x) & 1);\n'),
    ('        k7_stage(a, a.xi, stage, xc_off(a.xi, jb), 0,\n'
     '                 jb.k0 / a.ntj * kTile7, 0, a.tch);\n'
     '        cp_async_commit();\n',
     '        if (job == blockIdx.x) {\n'
     '          k7_stage(a, a.xi, stage, xc_off(a.xi, jb), rb,\n'
     '                   jb.k0 / a.ntj * kTile7, 0, a.tch);\n'
     '          cp_async_commit();\n'
     '        }\n'),
    ('k7_stage(a, a.xj, stage, off, 8 + 8 * b, kTile7 * b, 0, a.tch);',
     'k7_stage(a, a.xj, stage, off, 16 + 8 * b, kTile7 * b, 0, a.tch);'),
    ('        if (need > in) {\n'
     '          cp_async_wait_upto(ngrp - 1 - need);\n',
     '        int extra = 0;\n'
     '        if (!kHerm && k == jb.k1 - 1 && job + gridDim.x < a.njobs) {\n'
     '          const XJob nx = xc_job<kHerm>(a, job + gridDim.x);\n'
     '          k7_stage(a, a.xi, stage, xc_off(a.xi, nx), 8 - rb,\n'
     '                   nx.k0 / a.ntj * kTile7, 0, a.tch);\n'
     '          cp_async_commit();\n'
     '          extra = 1;\n'
     '        }\n'
     '        if (need > in) {\n'
     '          cp_async_wait_upto(ngrp - 1 - need + extra);\n'),
    ('const int ca = kHerm ? 8 * ti : 0;', 'const int ca = kHerm ? 8 * ti : rb;'),
    ('const int cb = kHerm ? 8 * tj : 8 + 8 * tj;',
     'const int cb = kHerm ? 8 * tj : 16 + 8 * tj;'),
    ('a.nch = a.resident ? 8 + 8 * ntj : 2 * kTile7 / 8;',
     'a.nch = a.resident ? 16 + 8 * ntj : 2 * kTile7 / 8;'))


def variants(src):
    """{name: (source, keeps the function)}; each edit must apply once."""
    def edit(old, new, text=src):
        assert text.count(old) == 1, old
        return text.replace(old, new)

    early = src
    for old, new in EARLY_ROWBLOCK:
        early = edit(old, new, early)
    return {
        'kernel': (src, True),
        'no_write': (edit('      k7_write(o, a.xi.n, a.xj.n,',
                          '      if (a.ntime < 0) k7_write(o, a.xi.n, '
                          'a.xj.n,'), False),
        'no_stage': (edit('      bar_sync(kBarCompute, kCompute7);      '
                          '// the last job is done\n      if (kHerm) {',
                          '      bar_sync(kBarCompute, kCompute7);      '
                          '// the last job is done\n      '
                          'if (job != blockIdx.x) {\n      } else if '
                          '(kHerm) {'), False),
        'no_mma': (edit('  for (int kg = 0; kg < nkg; ++kg) {',
                        '  for (int kg = 0; kg < nkg && lane < 0; ++kg) {'),
                   False),
        'early_rowblock': (early, True),
    }


def build(names_sources, out_dir):
    """One nvcc per source, all started together: {name: (herm, cross)}
    C entries (cross None for a source without this version's K8
    entries)."""
    from bifrost_tpu_torch import _build
    from bifrost_tpu_torch.ops import gpu_kernels as gk
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, src in names_sources.items():
        cu = os.path.join(out_dir, 'k8_%s.cu' % name)
        with open(cu, 'w') as f:
            f.write(src)
        so = os.path.join(out_dir, 'libk8_%s.so' % name)
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
            if 'Compiling entry' in line:
                for info in lines[i + 1:i + 4]:
                    if 'registers' in info or 'spill' in info:
                        print(name, line.split("'")[1][-40:], info.strip(),
                              flush=True)
        lib = ctypes.CDLL(so)
        herm = lib.bf_xcorr_herm
        herm.argtypes, herm.restype = gk._HERM_ARGS, ctypes.c_int
        cross = None
        if hasattr(lib, 'bf_xcorr_smem'):
            cross = lib.bf_xcorr_cross
            cross.argtypes, cross.restype = gk._CROSS_ARGS, ctypes.c_int
        fns[name] = (herm, cross)
    return fns


def main():
    import torch
    if not torch.cuda.is_available():
        sys.stderr.write('chip_k8_variants: no CUDA device is available\n')
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import chip_smoke as cs
    from bifrost_tpu_torch import _build, device
    from bifrost_tpu_torch.ops import gpu_kernels as gk
    device.set_device('cuda:0')
    smi = cs.nvidia_smi_line()
    with open(os.path.join(_build.CSRC, 'xcorr.cu')) as f:
        vs = variants(f.read())
    sources = {k: v[0] for k, v in vs.items()}
    for arg in sys.argv[1:]:
        if arg == '--source':
            continue
        name, path = arg.split('=', 1)
        with open(path) as f:
            sources[name] = f.read()
    fns = build(sources, os.path.join(_build.BUILD_DIR, 'variants'))
    g = torch.Generator(device='cuda').manual_seed(12)
    x = torch.randint(-128, 128, (XT, XF, XS, XP, 2), dtype=torch.int8,
                      device='cuda', generator=g)
    stream = _build.stream_ptr(x.device)
    for shape, kern, T, sr in SHAPES:
        if kern == 'k7':
            ng = XT // T if T < XT else 1
            re = x[..., 0].reshape(ng, T, XF, XS * XP)
            im = x[..., 1].reshape(ng, T, XF, XS * XP)
            ops, nj = (re, im), XS * XP
            want = gk.xcorr_herm_plain(re, im)
            names = list(sources)

            def args(out, re=re, im=im, ng=ng, T=T):
                return (re.data_ptr(), im.data_ptr(), out.data_ptr(), 1, ng,
                        T, XF, XS * XP) + re.stride() + (stream,)
            nbyte = 2 * XT * XF * XS * XP + 8 * ng * XF * (XS * XP) ** 2
            nops = 8 * XT * XF * (XS * XP) ** 2
        else:
            ri = x[:T, :, :sr, :, 0].reshape(T, XF, sr * XP)
            ii = x[:T, :, :sr, :, 1].reshape(T, XF, sr * XP)
            rj = x[:T, ..., 0].reshape(T, XF, XS * XP)
            ij = x[:T, ..., 1].reshape(T, XF, XS * XP)
            ops, nj = (ri, ii, rj, ij), XS * XP
            want = gk.xcorr_cross_plain(*ops)
            names = [n for n in sources if fns[n][1] is not None]
            rowblock = gk.xcorr_cross_plan(T, sr * XP, nj,
                                           gk.smem_optin(x.device))[0]

            def args(out, ri=ri, ii=ii, rj=rj, ij=ij, T=T, sr=sr,
                     rowblock=rowblock):
                return (ri.data_ptr(), ii.data_ptr(), rj.data_ptr(),
                        ij.data_ptr(), out.data_ptr(), 1, 1, rowblock, 1, T,
                        XF, sr * XP, nj, 0) + ri.stride() + (0,) + \
                    rj.stride() + (stream,)
            nbyte = 2 * T * XF * (sr * XP + nj) + 8 * XF * sr * XP * nj
            nops = 8 * T * XF * sr * XP * nj
        out = torch.empty(tuple(want.shape) + (2,), dtype=torch.float32,
                          device='cuda')
        res = {}
        for name in names:
            fn = fns[name][0 if kern == 'k7' else 1]
            out.fill_(float('nan'))
            if fn(*args(out)) != 0:
                raise RuntimeError('%s did not launch at %s' % (name, shape))
            torch.cuda.synchronize()
            same = bool(torch.equal(torch.view_as_complex(out), want))
            if vs.get(name, (None, True))[1] and not same:
                raise RuntimeError('%s is not bit-identical to the plain '
                                   'version at %s' % (name, shape))
            res[name] = {'bit_identical': same, 'ms_queued': []}
        for name in names + names[::-1]:
            fn = fns[name][0 if kern == 'k7' else 1]
            res[name]['ms_queued'].append(
                cs.cuda_ms_queued(lambda: fn(*args(out))))
        bms, by = cs.bound(nbyte, nops, cs.PEAK_INT8_PER_S)
        print(json.dumps({'shape': shape, 'dims': [list(o.shape)
                                                   for o in ops],
                          'bound_ms': bms, 'bound_by': by, 'variants': res,
                          'card': smi}), flush=True)
        del want, out, ops
        torch.cuda.empty_cache()
    print(smi)
    return 0


if __name__ == '__main__':
    sys.exit(main())
