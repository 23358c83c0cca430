"""Work of the FX correlator's F stage for one gulp: FFT over the fine
axis and requantization to ci8, whatever kernels do it.

Bytes: the ci8 voltages read once and the ci8 spectra written once.
Operations: 5 N log2 N float32 flops for each N-point complex FFT, 2 for
each component scaled (the rounding and the clip are not counted)."""

import math

from . import peaks

STAGE = 'fx_f'


def work(geometry):
    """{'bytes', 'flop', 'bound_s'} of one gulp."""
    nsamp = geometry['gulp_nframe'] * geometry['nchan'] * \
        geometry['nstand'] * geometry['npol']
    nfft = geometry['nchan']
    nbyte = nsamp * 2 + nsamp * 2                     # ci8 in, ci8 out
    flop = nsamp * 5 * math.log2(nfft) + nsamp * 2
    return {'bytes': nbyte, 'flop': flop,
            'bound_s': peaks.bound_s(nbyte=nbyte, fp32_flop=flop)}
