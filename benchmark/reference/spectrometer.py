"""The spectrometer's plain reference: FFT over fine time of ci8 dual-pol
voltages, Stokes I, Q, U, V and the sum of ``rfactor`` adjacent fine
channels, in float64 (upstream Bifrost's ``detect('stokes')`` with
V = -2 Im(X Y*), testbench/gpuspec_simple.py's chain).

``precision='tf32'`` is the control: the same arithmetic with every
FFT output, product and sum rounded to TF32, the step below the float32
the configuration states.  It rounds only at those points, so it
understates what a TF32 FFT would lose; a check it fails, a TF32 program
fails too.
"""

import torch

from .precision import round_tf32

#: complex samples a block of rows may hold (bounds the reference's
#: memory whatever the FFT length)
BLOCK_SAMPLES = 1 << 25


def stokes(volt, rfactor, precision='float64'):
    """(T, 2, nfft, 2) int8 voltages -> (T, 4, nfft // rfactor) Stokes,
    float64 (float32 for the control)."""
    t, npol, nfft, _ = volt.shape
    if npol != 2:
        raise ValueError('two polarisations expected, got %d' % npol)
    rows = max(1, BLOCK_SAMPLES // (npol * nfft))
    out = []
    for r0 in range(0, t, rows):
        v = volt[r0:r0 + rows]
        if precision == 'float64':
            x = torch.complex(v[..., 0].double(), v[..., 1].double())
            s = torch.fft.fft(x, dim=-1)
            rnd = _identity
        elif precision == 'tf32':
            x = torch.complex(v[..., 0].float(), v[..., 1].float())
            s = round_tf32(torch.fft.fft(x, dim=-1))
            rnd = round_tf32
        else:
            raise ValueError(precision)
        x, y = s[:, 0], s[:, 1]
        xx = rnd(rnd(x.real * x.real) + rnd(x.imag * x.imag))
        yy = rnd(rnd(y.real * y.real) + rnd(y.imag * y.imag))
        xy_re = rnd(rnd(x.real * y.real) + rnd(x.imag * y.imag))
        xy_im = rnd(rnd(x.imag * y.real) - rnd(x.real * y.imag))
        st = torch.stack([rnd(xx + yy), rnd(xx - yy), rnd(2 * xy_re),
                          rnd(-2 * xy_im)], dim=1)
        st = st.reshape(st.shape[0], 4, nfft // rfactor, rfactor)
        acc = st[..., 0]
        for k in range(1, rfactor):
            acc = rnd(acc + st[..., k])
        out.append(acc)
    return torch.cat(out)


def _identity(x):
    return x


def error(program, ref):
    """The widest gap between the program's spectra and the reference's,
    each gap over the reference's Stokes I of its (time, channel) plus
    the mean Stokes I: a relative error that a bright tone and a faint
    channel read alike (I bounds |Q|, |U| and |V|)."""
    p = torch.as_tensor(program).to(ref.device, torch.float64)
    r = ref.to(torch.float64)
    if p.shape != r.shape:
        raise ValueError('shape %s against the reference %s'
                         % (tuple(p.shape), tuple(r.shape)))
    scale = r[:, :1] + r[:, 0].mean()
    return float(((p - r).abs() / scale).max())
