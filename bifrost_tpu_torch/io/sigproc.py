"""SIGPROC filterbank / time-series file format (the port's copy of
``bifrost_tpu/io/sigproc.py``, whole and unchanged: numpy only).

Format (public SIGPROC spec; reference implementation:
python/bifrost/sigproc.py, sigproc2.py): a header of
``<u4 length><keyword>`` records between HEADER_START and HEADER_END,
with int / double / string values, followed by raw little-endian data
of shape (time, nifs, nchans) at ``nbits`` per sample.
"""

from __future__ import annotations

import os
import struct

import numpy as np

__all__ = ['SigprocFile', 'write_header', 'pack_header',
           'id2telescope', 'telescope2id', 'id2machine', 'machine2id']

_INT_KEYS = {'telescope_id', 'machine_id', 'data_type', 'nchans', 'nbits',
             'nifs', 'scan_number', 'barycentric', 'pulsarcentric',
             'ibeam', 'nbeams', 'nsamples'}
_DBL_KEYS = {'az_start', 'za_start', 'src_raj', 'src_dej', 'tstart',
             'tsamp', 'fch1', 'foff', 'refdm', 'period', 'fchannel'}
_STR_KEYS = {'source_name', 'rawdatafile'}
_CHR_KEYS = {'signed'}

_TELESCOPES = {0: 'fake', 1: 'Arecibo', 2: 'Ooty', 3: 'Nancay',
               4: 'Parkes', 5: 'Jodrell', 6: 'GBT', 7: 'GMRT',
               8: 'Effelsberg', 52: 'LWA-OV', 53: 'LWA-SV', 64: 'MeerKAT',
               65: 'KAT-7'}
_MACHINES = {0: 'FAKE', 1: 'PSPM', 2: 'WAPP', 3: 'AOFTM', 4: 'BPP',
             5: 'OOTY', 6: 'SCAMP', 7: 'GBT Pulsar Spigot', 52: 'LWA-DP',
             53: 'LWA-ADP'}


def id2telescope(tid):
    return _TELESCOPES.get(tid, 'unknown(%s)' % tid)


def telescope2id(name):
    for k, v in _TELESCOPES.items():
        if v.lower() == str(name).lower():
            return k
    return 0


def id2machine(mid):
    return _MACHINES.get(mid, 'unknown(%s)' % mid)


def machine2id(name):
    for k, v in _MACHINES.items():
        if v.lower() == str(name).lower():
            return k
    return 0


def _read_string(f):
    n, = struct.unpack('<i', f.read(4))
    if not 0 < n < 256:
        raise IOError("Invalid sigproc string length: %d" % n)
    return f.read(n).decode('ascii')


def _read_header(f):
    if _read_string(f) != 'HEADER_START':
        raise IOError("Missing HEADER_START (not a sigproc file?)")
    hdr = {}
    while True:
        key = _read_string(f)
        if key == 'HEADER_END':
            break
        if key in _INT_KEYS:
            hdr[key], = struct.unpack('<i', f.read(4))
        elif key in _DBL_KEYS:
            hdr[key], = struct.unpack('<d', f.read(8))
        elif key in _STR_KEYS:
            hdr[key] = _read_string(f)
        elif key in _CHR_KEYS:
            hdr[key], = struct.unpack('<b', f.read(1))
        else:
            raise KeyError("Unknown sigproc header key: %r" % key)
    return hdr


def pack_header(hdr):
    """Serialize a header dict to bytes."""
    def s(txt):
        b = txt.encode('ascii')
        return struct.pack('<i', len(b)) + b

    out = [s('HEADER_START')]
    for key, val in hdr.items():
        if key in _INT_KEYS:
            out.append(s(key) + struct.pack('<i', int(val)))
        elif key in _DBL_KEYS:
            out.append(s(key) + struct.pack('<d', float(val)))
        elif key in _STR_KEYS:
            out.append(s(key) + s(str(val)))
        elif key in _CHR_KEYS:
            out.append(s(key) + struct.pack('<b', int(val)))
        else:
            raise KeyError("Unknown sigproc header key: %r" % key)
    out.append(s('HEADER_END'))
    return b''.join(out)


def write_header(f, hdr):
    f.write(pack_header(hdr))


class SigprocFile(object):
    """Streaming reader (reference: python/bifrost/sigproc2.py
    SigprocFile)."""

    def __init__(self, filename=None):
        self.f = None
        if filename is not None:
            self.open(filename)

    def open(self, filename):
        self.f = open(filename, 'rb')
        self.header = _read_header(self.f)
        # SIGPROC integer data is unsigned unless flagged otherwise
        self.header.setdefault('signed', 0)
        self.header_size = self.f.tell()
        self.nbits = self.header['nbits']
        self.nchans = self.header.get('nchans', 1)
        self.nifs = self.header.get('nifs', 1)
        self.frame_nbit = self.nbits * self.nchans * self.nifs
        if self.frame_nbit % 8:
            raise IOError("Frame does not span whole bytes")
        self.frame_nbyte = self.frame_nbit // 8
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        if self.f is not None:
            self.f.close()
            self.f = None

    def nframe(self):
        pos = self.f.tell()
        self.f.seek(0, os.SEEK_END)
        n = (self.f.tell() - self.header_size) // self.frame_nbyte
        self.f.seek(pos)
        return n

    def readinto(self, buf):
        """Read raw (possibly packed) bytes into a buffer."""
        view = np.asarray(buf).view(np.uint8)
        data = self.f.read(view.nbytes)
        flat = view.reshape(-1)
        flat[:len(data)] = np.frombuffer(data, np.uint8)
        return len(data)

    def read(self, nframe):
        """Read and unpack up to nframe frames into an
        (n, nifs, nchans) array (sub-byte data promoted to 8 bits,
        reference: sigproc unpack path)."""
        raw = self.f.read(nframe * self.frame_nbyte)
        nframe_read = len(raw) // self.frame_nbyte
        raw = np.frombuffer(raw[:nframe_read * self.frame_nbyte], np.uint8)
        nbits = self.nbits
        signed = bool(self.header.get('signed', 0))
        if nbits >= 8:
            dtype = {8: np.int8 if signed else np.uint8,
                     16: np.int16 if signed else np.uint16,
                     32: np.float32}[nbits]
            data = raw.view(dtype)
        else:
            per = 8 // nbits
            # LSB-first sample order within each byte (reference:
            # python/bifrost/sigproc.py:281 'assumes LSB-first')
            shifts = (np.arange(per) * nbits).astype(np.uint8)
            vals = (raw[:, None] >> shifts) & ((1 << nbits) - 1)
            vals = vals.reshape(-1)
            if signed:
                # sign-extend the sub-byte field
                data = ((vals.astype(np.int16) << (8 - nbits)).astype(
                    np.int8) >> (8 - nbits))
            else:
                data = vals.astype(np.uint8)
        return data.reshape(nframe_read, self.nifs, self.nchans)
