"""Work of the FX correlator's X stage for one gulp: the Hermitian
product x x^H of every channel over the gulp's frames and its
accumulation, whatever kernels do it.

Bytes: the ci8 spectra read once, and one integration's visibility
matrix (complex64, every (station, pol) pair, as the stage emits it)
written once per ``nvis_per_dump`` gulps.  Operations: the lower
triangle with its diagonal, n (n + 1) / 2 pairs of the n = stations x
pols inputs, each pair a complex multiply-add of int8 values (4 real
multiply-adds, 8 operations) per frame and channel."""

from . import peaks

STAGE = 'fx_x'


def work(geometry):
    """{'bytes', 'int8_op', 'bound_s'} of one gulp."""
    t, f = geometry['gulp_nframe'], geometry['nchan']
    n = geometry['nstand'] * geometry['npol']
    nbyte_in = t * f * n * 2
    nvis = t // geometry['nframe_per_vis']
    nbyte_out = nvis * f * n * n * 8 / geometry['nvis_per_dump']
    nbyte = nbyte_in + nbyte_out
    op = 8 * t * f * n * (n + 1) / 2
    return {'bytes': nbyte, 'int8_op': op,
            'bound_s': peaks.bound_s(nbyte=nbyte, int8_op=op)}
