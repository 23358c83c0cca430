"""SIGPROC filterbank source + sink blocks (the port of
``bifrost_tpu/blocks/sigproc.py``; reference:
python/bifrost/blocks/sigproc.py:51-390).

Both blocks are host blocks and numpy only: the source writes
``['time', 'pol', 'freq']`` spans into a ``system`` ring (8-bit and wider
samples as stored; 1/2/4-bit samples unpacked to 8 bits, or with
``unpack=False`` kept packed, as a ``u1``/``u2``/``u4`` ring whose spans
hold the stored bytes), and the sink takes only ``system`` rings, as in
the JAX package.
"""

from __future__ import annotations

import os

import numpy as np

from ..pipeline import SourceBlock, SinkBlock
from ..dtype import DataType
from ..io import sigproc as sigproc_io

__all__ = ['SigprocSourceBlock', 'SigprocSinkBlock',
           'read_sigproc', 'write_sigproc']


def _mjd2unix(mjd):
    return (mjd - 40587) * 86400


def _unix2mjd(unix):
    return unix / 86400. + 40587


def _get(obj, key, default=None):
    return obj[key] if key in obj else default


class SigprocSourceBlock(SourceBlock):
    def __init__(self, filenames, gulp_nframe, unpack=True,
                 *args, **kwargs):
        super(SigprocSourceBlock, self).__init__(filenames, gulp_nframe,
                                                 *args, **kwargs)
        self.unpack = unpack

    def create_reader(self, sourcename):
        return sigproc_io.SigprocFile(sourcename)

    def on_sequence(self, ireader, sourcename):
        ihdr = ireader.header
        assert ihdr['data_type'] in (1, 2, 6), \
            "filterbank / time series / subbands only"
        coord_frame = 'topocentric'
        for cf in ('pulsarcentric', 'barycentric'):
            if bool(ihdr.get(cf)):
                coord_frame = cf
                break
        tstart_unix = _mjd2unix(ihdr['tstart'])
        nbit = ihdr['nbits']
        if self.unpack:
            nbit = max(nbit, 8)
        ohdr = {
            '_tensor': {
                'dtype': ('i' if ihdr.get('signed', 0) else 'u')
                         + str(nbit) if nbit != 32 else 'f32',
                'shape': [-1, ihdr.get('nifs', 1), ihdr.get('nchans', 1)],
                'labels': ['time', 'pol', 'freq'],
                'scales': [[tstart_unix, ihdr['tsamp']], None,
                           [ihdr.get('fch1', 0.), ihdr.get('foff', 1.)]],
                'units': ['s', None, 'MHz'],
            },
            'frame_rate': 1. / ihdr['tsamp'],
            'source_name': _get(ihdr, 'source_name'),
            'rawdatafile': _get(ihdr, 'rawdatafile'),
            'az_start': _get(ihdr, 'az_start'),
            'za_start': _get(ihdr, 'za_start'),
            'raj': _get(ihdr, 'src_raj'),
            'dej': _get(ihdr, 'src_dej'),
            'refdm': _get(ihdr, 'refdm', 0.),
            'refdm_units': 'pc cm^-3',
            'telescope': sigproc_io.id2telescope(
                _get(ihdr, 'telescope_id', 0)),
            'machine': sigproc_io.id2machine(_get(ihdr, 'machine_id', 0)),
            'coord_frame': coord_frame,
            'time_tag': int(round(tstart_unix * 2 ** 32)),
            'name': sourcename,
        }
        return [ohdr]

    def on_data(self, reader, ospans):
        ospan = ospans[0]
        if self.unpack:
            indata = reader.read(ospan.nframe)
            nframe = indata.shape[0]
            buf = ospan.data.as_numpy()
            if buf.dtype.names is None:
                buf[:nframe] = indata.astype(buf.dtype)
            else:
                buf[:nframe] = indata
        else:
            nbyte = reader.readinto(ospan.data.as_numpy())
            if nbyte % ospan.frame_nbyte:
                raise IOError("Input file is truncated")
            nframe = nbyte // ospan.frame_nbyte
        return [nframe]


class SigprocSinkBlock(SinkBlock):
    """Write a ['time', 'pol', 'freq'] (or time-series) stream to .fil
    (reference: blocks/sigproc.py SigprocSinkBlock)."""

    def __init__(self, iring, path=None, *args, **kwargs):
        super(SigprocSinkBlock, self).__init__(iring, *args, **kwargs)
        self.path = path or ''
        self._file = None

    def define_valid_input_spaces(self):
        return ('system',)

    def on_sequence(self, iseq):
        from ..units import convert_units
        hdr = iseq.header
        tensor = hdr['_tensor']
        labels = tensor['labels']
        dtype = DataType(tensor['dtype'])
        if dtype.is_complex:
            raise TypeError("SIGPROC files hold detected (real) data; "
                            "got complex dtype %s" % dtype)
        freq_units = None
        if labels == ['time', 'pol', 'freq']:
            data_type = 1
            nifs, nchans = tensor['shape'][1], tensor['shape'][2]
            fch1, foff = tensor['scales'][2]
            freq_units = tensor['units'][2] if 'units' in tensor else None
        elif labels == ['time']:
            data_type = 2
            nifs, nchans = 1, 1
            fch1, foff = hdr.get('cfreq', 0.), hdr.get('bw', 1.)
        elif labels == ['time', 'pol']:
            data_type = 2
            nifs, nchans = tensor['shape'][1], 1
            fch1, foff = hdr.get('cfreq', 0.), hdr.get('bw', 1.)
        else:
            raise ValueError("Unsupported axis labels for sigproc: %s"
                             % labels)
        if freq_units:
            fch1 = convert_units(fch1, freq_units, 'MHz')
            foff = convert_units(foff, freq_units, 'MHz')
        t0, tsamp = tensor['scales'][0]
        time_units = tensor['units'][0] if 'units' in tensor else None
        if time_units:
            t0 = convert_units(t0, time_units, 's')
            tsamp = convert_units(tsamp, time_units, 's')
        filename = hdr.get('name', 'output')
        base = os.path.basename(str(filename)) or 'output'
        if not base.endswith('.fil') and not base.endswith('.tim'):
            base += '.fil' if data_type == 1 else '.tim'
        filepath = os.path.join(self.path, base)
        self._file = open(filepath, 'wb')
        shdr = {
            'telescope_id': sigproc_io.telescope2id(
                hdr.get('telescope', 'fake')),
            'machine_id': sigproc_io.machine2id(hdr.get('machine', 'FAKE')),
            'data_type': data_type,
            'nchans': nchans,
            'nifs': nifs,
            'nbits': dtype.itemsize_bits,
            'fch1': fch1,
            'foff': foff,
            'tstart': _unix2mjd(t0),
            'tsamp': tsamp,
            'refdm': hdr.get('refdm') or 0.,
        }
        if dtype.kind == 'i':
            shdr['signed'] = 1
        if hdr.get('source_name'):
            shdr['source_name'] = hdr['source_name']
        if hdr.get('raj') is not None:
            shdr['src_raj'] = hdr['raj']
        if hdr.get('dej') is not None:
            shdr['src_dej'] = hdr['dej']
        sigproc_io.write_header(self._file, shdr)

    def on_data(self, ispan):
        buf = ispan.data.as_numpy()
        self._file.write(np.ascontiguousarray(buf).tobytes())

    def on_sequence_end(self, iseq):
        if self._file is not None:
            self._file.close()
            self._file = None


def read_sigproc(filenames, gulp_nframe, unpack=True, *args, **kwargs):
    """Block: read SIGPROC filterbank/time-series files.
    Output tensor: ['time', 'pol', 'freq'], space system."""
    return SigprocSourceBlock(filenames, gulp_nframe, unpack,
                              *args, **kwargs)


def write_sigproc(iring, path=None, *args, **kwargs):
    """Block: write a stream to SIGPROC files."""
    return SigprocSinkBlock(iring, path, *args, **kwargs)
