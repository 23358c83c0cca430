"""The FX correlator's plain reference: F (FFT over the fine axis) ->
requantize to ci8 (``round(x * scale)``, ties to even, clipped to
[-128, 127]) -> X (the exact Hermitian product V_ab = sum_t x_a conj(x_b)
of every (station, pol) pair, per channel) -> accumulate -> storage
format (the lower triangle's baselines (i, j), i >= j, in row order,
each with Stokes I = XX + YY, Q = XX - YY, U = XY + YX, V = i (XY - YX)),
as upstream Bifrost's correlate and convert_visibilities define them.

The F stage runs in float64; X sums integers exactly in float64.  A
float32 F stage may round a spectral value that lies within its own
rounding error of a quantization tie to the other side.  The reference
marks every value whose float64 image lies within ``TIE_BAND`` of a tie
and carries the bound of what flipping them could change in each
visibility (``budget``); a program value outside its budget is wrong.

``precision='tf32'`` is the control: the F stage's FFT output rounded to
TF32 (float32's exponent, 10 mantissa bits) before the requantization,
the step below the float32 the configuration states.
"""

import torch

from .precision import round_tf32

#: half-width of the band around a quantization tie (in units of the
#: quantized value) inside which a float32 F stage may round either way
TIE_BAND = 2.0 ** -12


def f_stage(volt, scale, precision='float64'):
    """(T, F, S, P, 2) int8 voltages -> (q, tie): the requantized
    spectra (T, F, S*P) complex128 with integer parts, and (T, F, S*P)
    float64 counts (0-2) of the components lying within TIE_BAND of a
    tie."""
    t, f, s, p, _ = volt.shape
    if precision == 'float64':
        x = torch.complex(volt[..., 0].double(), volt[..., 1].double())
        y = torch.fft.fft(x, dim=1) * scale
    elif precision == 'tf32':
        x = torch.complex(volt[..., 0].float(), volt[..., 1].float())
        y = (round_tf32(torch.fft.fft(x, dim=1)) * scale).to(
            torch.complex128)
    else:
        raise ValueError(precision)
    y = y.reshape(t, f, s * p)
    parts = []
    ties = []
    for comp in (y.real, y.imag):
        parts.append(torch.clamp(torch.round(comp), -128, 127))
        frac = comp - torch.floor(comp)
        ties.append(((frac - 0.5).abs() < TIE_BAND).double())
    return torch.complex(parts[0], parts[1]), ties[0] + ties[1]


def f32_deviation(volt, scale):
    """The widest gap, in units of the quantized value, between a
    float32 F stage (cuFFT in complex64, as the program's F block runs
    it) and the float64 one on ``volt``: what TIE_BAND has to hold."""
    x64 = torch.complex(volt[..., 0].double(), volt[..., 1].double())
    x32 = torch.complex(volt[..., 0].float(), volt[..., 1].float())
    d = torch.fft.fft(x32, dim=1).to(torch.complex128) - \
        torch.fft.fft(x64, dim=1)
    return float(torch.maximum(d.real.abs(), d.imag.abs()).max()) * scale


def correlate(q, tie, vis, budget, chan_block=128):
    """Add one gulp's products to ``vis`` (F, n, n) complex128 and their
    flip bounds to ``budget`` (F, n, n) float64, in place.  With L the
    |re| + |im| of each value and M = L + tie, a flip changes
    x_a conj(x_b) by at most M_a M_b - L_a L_b."""
    t, f, n = q.shape
    for c0 in range(0, f, chan_block):
        qc = q[:, c0:c0 + chan_block].permute(1, 0, 2)      # (c, t, n)
        vis[c0:c0 + chan_block] += torch.matmul(
            qc.transpose(1, 2), qc.conj())
        lc = qc.real.abs() + qc.imag.abs()
        mc = lc + tie[:, c0:c0 + chan_block].permute(1, 0, 2)
        budget[c0:c0 + chan_block] += \
            torch.matmul(mc.transpose(1, 2), mc) - \
            torch.matmul(lc.transpose(1, 2), lc)


def baselines(nstand, device):
    """(i, j) station indices of every baseline, i >= j, in row order."""
    ii, jj = torch.tril_indices(nstand, nstand, device=device)
    return ii, jj


def storage(vis, budget, nstand):
    """(F, S*2, S*2) visibilities and budgets -> (nbl, F, 4) Stokes
    I, Q, U, V complex128 and their (nbl, F, 4) float64 bounds."""
    f = vis.shape[0]
    v = vis.reshape(f, nstand, 2, nstand, 2)
    b = budget.reshape(f, nstand, 2, nstand, 2)
    ii, jj = baselines(nstand, vis.device)
    vb = v[:, ii, :, jj, :]            # (nbl, F, 2, 2)
    bb = b[:, ii, :, jj, :]
    xx, xy, yx, yy = vb[..., 0, 0], vb[..., 0, 1], vb[..., 1, 0], \
        vb[..., 1, 1]
    bxx, bxy, byx, byy = bb[..., 0, 0], bb[..., 0, 1], bb[..., 1, 0], \
        bb[..., 1, 1]
    st = torch.stack([xx + yy, xx - yy, xy + yx, 1j * (xy - yx)], dim=-1)
    sb = torch.stack([bxx + byy, bxx + byy, bxy + byx, bxy + byx], dim=-1)
    return st, sb


def outside(program, ref, bound):
    """(count, worst): the program's Stokes values ((1, nbl, F, 4) or
    (nbl, F, 4)) outside ref +- bound, and the widest excess.  Every
    value of both sides is an integer held exactly, so the squared gap
    is compared with the squared bound exactly."""
    p = torch.as_tensor(program).to(ref.device).reshape(ref.shape)
    d = p.to(torch.complex128) - ref
    gap2 = d.real * d.real + d.imag * d.imag
    out = gap2 > bound * bound
    n = int(out.sum())
    worst = float((gap2.sqrt() - bound).max().clamp(min=0)) if n else 0.0
    return n, worst
