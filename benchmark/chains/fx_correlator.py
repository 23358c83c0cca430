"""The FX correlator chain (``examples/fx_correlator_torch.py``'s chain
through the port, at full width):

  source (pinned cuda_host ring) -> copy('cuda') -> fft(fine -> freq) [F]
  -> quantize('ci8', scale) [F] -> correlate(R, int8) [X]
  -> accumulate(A) [X] -> convert_visibilities('storage')
  -> copy('cuda_host') -> sink

Input frames are [time, fine, station, pol] ci8; one output frame, the
storage-format (baseline, freq, IQUV) complex64 visibilities, per R x A
input frames.
"""

import math

import numpy as np

from . import _seed

#: each value printed beside its limit, the limit from the workload file
CHECK = ('vis_outside',)


def geometry(config, traffic):
    t, f = int(config['ntime_per_gulp']), int(config['nchan'])
    s, p = int(config['nstand']), int(config['npol'])
    r = int(config['nframe_per_vis'])
    a = int(config['nvis_per_dump'])
    if t % r or (r * a) % t:
        raise ValueError('R %d must divide the gulp (%d frames) and R x A '
                         'must be whole gulps' % (r, t))
    return {'gulp_nframe': t, 'nchan': f, 'nstand': s, 'npol': p,
            'nframe_per_vis': r, 'nvis_per_dump': a,
            'frame_shape': [f, s, p], 'gulp_nbyte': t * f * s * p * 2,
            'samples_per_frame': f * s * p,
            'in_frames_per_out_frame': r * a,
            'scale': float(config['quantize_scale']),
            'sky_sigma': 7.0, 'noise_sigma': 4.0}


def header(geom):
    return {'name': 'portbench_fx', 'time_tag': 0,
            '_tensor': {'shape': [-1] + list(geom['frame_shape']),
                        'dtype': 'ci8',
                        'labels': ['time', 'fine', 'station', 'pol'],
                        'scales': [[0, 1]] * 4, 'units': [None] * 4}}


def make_gulp(geom, seed, slot, device):
    """Slot ``slot``'s gulp, (T, F, S, P, 2) int8 on ``device``: a
    common sky seen by every stand with a seeded phase, plus each
    stand's own noise, rounded and clipped to ci8."""
    import torch
    t, f, s, p = (geom['gulp_nframe'], geom['nchan'], geom['nstand'],
                  geom['npol'])
    g = _seed.generator(seed, slot, device)
    sky = torch.randn((t, f, 1, p, 2), generator=g, device=device,
                      dtype=torch.float32) * geom['sky_sigma']
    v = torch.randn((t, f, s, p, 2), generator=g, device=device,
                    dtype=torch.float32) * geom['noise_sigma']
    phase = torch.rand((s,), generator=g, device=device,
                       dtype=torch.float32) * (2 * math.pi)
    c = torch.cos(phase).view(1, 1, s, 1)
    sn = torch.sin(phase).view(1, 1, s, 1)
    v[..., 0] += sky[..., 0] * c - sky[..., 1] * sn
    v[..., 1] += sky[..., 0] * sn + sky[..., 1] * c
    return torch.clamp(torch.round(v), -128, 127).to(torch.int8)


def build(bt, src, geom, config, nslot):
    """The chain after ``src``: ({stage: [blocks]}, the last block)."""
    h2d = bt.blocks.copy(src, space='cuda',
                         buffer_nframe=nslot * geom['gulp_nframe'])
    f = bt.blocks.fft(h2d, axes='fine', axis_labels='freq')
    q = bt.blocks.quantize(f, config['quantize_dtype'], scale=geom['scale'])
    x = bt.blocks.correlate(q, geom['nframe_per_vis'],
                            accuracy=config['x_accuracy'], fusable=True)
    acc = bt.blocks.accumulate(x, geom['nvis_per_dump'])
    st = bt.blocks.convert_visibilities(acc, config['output_format'])
    d2h = bt.blocks.copy(st, space='cuda_host')
    return {'h2d': [h2d], 'fx_f': [f, q], 'fx_x': [x, acc],
            'storage': [st], 'd2h': [d2h]}, d2h


def output_nbyte(geom):
    s = geom['nstand']
    return s * (s + 1) // 2 * geom['nchan'] * 4 * 8


def check(samples, gulp_of, geom, ref, precision='float64'):
    """{'vis_outside': visibility values outside their reference's tie
    budget, summed over the samples}, with the widest excess beside it
    (not compared).  Each sample is (first input gulp index, the
    output's complex64 bytes as numpy); ``gulp_of(index)`` makes that
    input gulp again.  With ``precision='tf32'`` the control stands in
    for the program."""
    import torch
    ngulp = geom['in_frames_per_out_frame'] // geom['gulp_nframe']
    s, f = geom['nstand'], geom['nchan']
    n = s * geom['npol']
    total, worst, dev32 = 0, 0.0, 0.0
    for g0, out in samples:
        dev = None
        vis = budget = vis_c = None
        for g in range(g0, g0 + ngulp):
            volt = gulp_of(g)
            if vis is None:
                dev = volt.device
                vis = torch.zeros((f, n, n), dtype=torch.complex128,
                                  device=dev)
                budget = torch.zeros((f, n, n), dtype=torch.float64,
                                     device=dev)
                if precision != 'float64':
                    vis_c = torch.zeros_like(vis)
                    scratch = torch.zeros_like(budget)
            q, tie = ref.f_stage(volt, geom['scale'])
            ref.correlate(q, tie, vis, budget)
            if vis_c is not None:
                qc, tc = ref.f_stage(volt, geom['scale'], precision)
                ref.correlate(qc, torch.zeros_like(tc), vis_c, scratch)
                dev32 = max(dev32, ref.f32_deviation(volt, geom['scale']))
            del volt, q, tie
        want, bound = ref.storage(vis, budget, s)
        if vis_c is None:
            got = torch.from_numpy(np.ascontiguousarray(out)).view(
                torch.complex64)
        else:
            got, _ = ref.storage(vis_c, budget, s)
        cnt, exc = ref.outside(got, want, bound)
        total += cnt
        worst = max(worst, exc)
        del vis, budget, vis_c, want, bound, got
    out = {'vis_outside': total, 'vis_worst_excess': worst}
    if precision != 'float64':
        # beside the control: how much of the tie band float32 uses
        out['f32_dev_over_band'] = dev32 / ref.TIE_BAND
    return out
