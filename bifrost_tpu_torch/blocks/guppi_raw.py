"""GUPPI RAW source block (reference:
python/bifrost/blocks/guppi_raw.py:38-139; the port of
``bifrost_tpu/blocks/guppi_raw.py``).

Output tensor: ['time', 'freq', 'fine_time', 'pol'], dtype ci<NBITS>,
one frame per GUPPI block, in a ``system`` ring.  Each block's payload is
read straight into the ring span (``readinto``), no intermediate copy.
"""

from __future__ import annotations

import numpy as np

from ..pipeline import SourceBlock
from ..io import guppi as guppi_io

__all__ = ['GuppiRawSourceBlock', 'read_guppi_raw']


def _mjd2unix(mjd):
    return (mjd - 40587) * 86400


class GuppiRawSourceBlock(SourceBlock):
    def __init__(self, sourcenames, gulp_nframe=1, *args, **kwargs):
        super(GuppiRawSourceBlock, self).__init__(
            sourcenames, gulp_nframe=gulp_nframe, *args, **kwargs)

    def create_reader(self, sourcename):
        return open(sourcename, 'rb')

    def on_sequence(self, reader, sourcename):
        ihdr = guppi_io.read_header(reader)
        nbit = ihdr['NBITS']
        assert nbit in (4, 8, 16, 32, 64)
        nchan = ihdr['OBSNCHAN']
        bw_MHz = ihdr['OBSBW']
        cfreq_MHz = ihdr['OBSFREQ']
        df_MHz = bw_MHz / nchan
        f0_MHz = cfreq_MHz - 0.5 * (nchan - 1) * df_MHz
        dt_s = 1. / df_MHz / 1e6   # negative bw => negative dt, as upstream
        byte_offset = ihdr.get('PKTIDX', 0) * ihdr.get('PKTSIZE', 0)
        frame_nbyte = ihdr['BLOCSIZE'] / ihdr['NTIME']
        offset_secs = byte_offset / (frame_nbyte / dt_s) \
            if frame_nbyte else 0.
        tstart_mjd = ihdr.get('STT_IMJD', 40587) + \
            (ihdr.get('STT_SMJD', 0) + offset_secs) / 86400.
        tstart_unix = _mjd2unix(tstart_mjd)
        ohdr = {
            '_tensor': {
                'dtype': 'ci%d' % nbit,
                'shape': [-1, nchan, ihdr['NTIME'], ihdr['NPOL']],
                'labels': ['time', 'freq', 'fine_time', 'pol'],
                'scales': [[tstart_unix, abs(dt_s) * ihdr['NTIME']],
                           [f0_MHz, df_MHz], [0, dt_s], None],
                'units': ['s', 'MHz', 's', None],
            },
            'az_start': ihdr.get('AZ'),
            'za_start': ihdr.get('ZA'),
            'raj': (ihdr.get('RA') or 0.) * (24. / 360.),
            'dej': ihdr.get('DEC'),
            'source_name': ihdr.get('SRC_NAME'),
            'refdm': ihdr.get('CHAN_DM'),
            'refdm_units': 'pc cm^-3',
            'telescope': ihdr.get('TELESCOP'),
            'machine': ihdr.get('BACKEND'),
            'rawdatafile': sourcename,
            'coord_frame': 'topocentric',
            'time_tag': int(round(tstart_unix * 2 ** 32)),
            'name': sourcename,
        }
        self._skip_header = False   # first block's header already consumed
        return [ohdr]

    def on_data(self, reader, ospans):
        ospan = ospans[0]
        flat = ospan.data.as_numpy().view(np.uint8).reshape(-1)
        fb = ospan.frame_nbyte
        nframe = 0
        # one GUPPI block (header + BLOCSIZE payload) per frame
        for k in range(ospan.nframe):
            if self._skip_header:
                try:
                    guppi_io.read_header(reader)
                except EOFError:
                    break
            self._skip_header = True
            nbyte = reader.readinto(memoryview(flat[k * fb:(k + 1) * fb]))
            if nbyte == 0:
                break
            if nbyte % fb:
                raise IOError("Block data is truncated")
            nframe += 1
        return [nframe]


def read_guppi_raw(filenames, gulp_nframe=1, *args, **kwargs):
    """Block: read GUPPI RAW files (format ref:
    github.com/UCBerkeleySETI/breakthrough RAW-File-Format.md)."""
    return GuppiRawSourceBlock(filenames, gulp_nframe, *args, **kwargs)
