"""The spectrometer chain (upstream Bifrost's testbench/gpuspec_simple.py
as ``examples/gpuspec_simple_torch.py`` builds it through the port):

  source (pinned cuda_host ring) -> copy('cuda') -> fused[FFT(fine_time)
  -> detect('stokes') -> reduce(fine_freq, r)] -> copy('cuda_host')
  -> sink

Input frames are pol-major, [time, pol, fine_time] ci8; one output frame
of (4, nfft / r) float32 Stokes per input frame.
"""

import math

import numpy as np

from . import _seed

#: each value printed beside its limit, the limit from the workload file
CHECK = ('spec_err',)


def geometry(config, traffic):
    nfft = int(traffic['nfft'])
    npol = int(config['npol'])
    nbyte = int(config['block_bytes']) * int(config['blocks_per_gulp'])
    nsamp = nbyte // 2                      # ci8: 2 bytes a sample
    if nsamp % (npol * nfft):
        raise ValueError('a gulp of %d samples does not hold whole '
                         'frames of nfft %d' % (nsamp, nfft))
    return {'gulp_nframe': nsamp // (npol * nfft), 'npol': npol,
            'nfft': nfft, 'rfactor': int(config['rfactor']),
            'frame_shape': [npol, nfft], 'gulp_nbyte': nbyte,
            'samples_per_frame': npol * nfft,
            'in_frames_per_out_frame': 1,
            'sigma': 12.0, 'tone_amp': 24.0}


def header(geom):
    return {'name': 'portbench_guppi', 'time_tag': 0,
            '_tensor': {'shape': [-1] + list(geom['frame_shape']),
                        'dtype': 'ci8',
                        'labels': ['time', 'pol', 'fine_time'],
                        'scales': [[0, 1]] * 3, 'units': [None] * 3}}


def make_gulp(geom, seed, slot, device):
    """Slot ``slot``'s gulp, (T, 2, nfft, 2) int8 on ``device``:
    Gaussian voltages of ``sigma`` rms a component with one tone a pol
    at a seeded fine bin, rounded and clipped to ci8."""
    import torch
    t, p, n = geom['gulp_nframe'], geom['npol'], geom['nfft']
    g = _seed.generator(seed, slot, device)
    v = torch.randn((t, p, n, 2), generator=g, device=device,
                    dtype=torch.float32)
    v.mul_(geom['sigma'])
    bins = torch.randint(0, n, (p,), generator=g, device=device)
    ph = torch.arange(n, device=device, dtype=torch.float64)
    for k in range(p):
        arg = (2 * math.pi / n) * ((ph * bins[k]) % n)
        v[:, k, :, 0] += (geom['tone_amp'] * torch.cos(arg)).float()
        v[:, k, :, 1] += (geom['tone_amp'] * torch.sin(arg)).float()
    return torch.clamp(torch.round(v), -128, 127).to(torch.int8)


def build(bt, src, geom, config, nslot):
    """The chain after ``src``: ({stage: [blocks]}, the last block)."""
    from bifrost_tpu_torch.stages import DetectStage, FftStage, ReduceStage
    h2d = bt.blocks.copy(src, space='cuda',
                         buffer_nframe=nslot * geom['gulp_nframe'])
    spec = bt.blocks.fused(h2d, [
        FftStage('fine_time', axis_labels='fine_freq'),
        DetectStage('stokes', axis='pol'),
        ReduceStage('fine_freq', geom['rfactor'])])
    d2h = bt.blocks.copy(spec, space='cuda_host')
    return {'h2d': [h2d], 'spectrometer': [spec], 'd2h': [d2h]}, d2h


def output_nbyte(geom):
    return geom['gulp_nframe'] * 4 * (geom['nfft'] // geom['rfactor']) * 4


def check(samples, gulp_of, geom, ref, precision='float64'):
    """{'spec_err': the worst sample's error}: each sample is (first
    input gulp index, the output's float32 bytes as numpy);
    ``gulp_of(index)`` makes that input gulp again; ``ref`` is the
    chain's reference module.  With ``precision='tf32'`` the control
    stands in for the program."""
    import torch
    worst = 0.0
    for g0, out in samples:
        volt = gulp_of(g0)
        want = ref.stokes(volt, geom['rfactor'])
        if precision == 'float64':
            got = torch.from_numpy(np.ascontiguousarray(out)).view(
                torch.float32).reshape(want.shape)
        else:
            got = ref.stokes(volt, geom['rfactor'], precision)
        worst = max(worst, ref.error(got, want))
        del volt, want, got
    return {'spec_err': worst}
