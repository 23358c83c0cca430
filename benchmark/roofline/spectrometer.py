"""Work of the spectrometer stage for one gulp: FFT over fine time ->
Stokes IQUV -> sum of ``rfactor`` fine channels, whatever kernels do it
(K1 alone, or an unpack, cuFFT, K2 and a sum).

Bytes: the ci8 gulp read once and the reduced float32 Stokes written
once.  Operations: 5 N log2 N float32 flops for each N-point complex
FFT (the radix-2 count), 16 for each Stokes sample (two pols: 4 squares
and sums for |X|^2 and |Y|^2, one complex product X Y*, 4 combinations)
and one add for each sample summed away."""

import math

from . import peaks

STAGE = 'spectrometer'


def work(geometry):
    """{'bytes', 'flop', 'bound_s'} of one gulp."""
    ntime, npol, nfft = (geometry['gulp_nframe'], geometry['npol'],
                         geometry['nfft'])
    r = geometry['rfactor']
    nbyte_in = ntime * npol * nfft * 2                # ci8
    nbyte_out = ntime * 4 * (nfft // r) * 4           # float32 IQUV
    nbyte = nbyte_in + nbyte_out
    flop = (ntime * npol * 5 * nfft * math.log2(nfft) +
            ntime * nfft * 16 +
            ntime * 4 * nfft * (r - 1) / r)
    return {'bytes': nbyte, 'flop': flop,
            'bound_s': peaks.bound_s(nbyte=nbyte, fp32_flop=flop)}
