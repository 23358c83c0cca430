"""PSRDADA ring/file sources, the port of ``bifrost_tpu/blocks/psrdada.py``
(reference: python/bifrost/blocks/psrdada.py,
python/bifrost/psrdada.py, dada_file.py).

The DADA *file* format (a 4096-byte ASCII header + raw data) and the
shared-memory ring source are both implemented without libpsrdada: the
shm ring rides :mod:`bifrost_tpu_torch.io.dada_shm` (System V IPC via ctypes,
psrdada dada_hdu/ipcbuf architecture — see that module's interop note).
"""

from __future__ import annotations

import ctypes.util

import numpy as np

from ..pipeline import SourceBlock

__all__ = ['DadaFileSourceBlock', 'PsrdadaSourceBlock', 'read_dada_file',
           'read_psrdada_buffer', 'HAVE_PSRDADA']

HAVE_PSRDADA = ctypes.util.find_library('psrdada') is not None

DADA_HEADER_SIZE = 4096


def _parse_dada_header(raw):
    hdr = {}
    for line in raw.decode('ascii', 'replace').split('\n'):
        line = line.split('#', 1)[0].strip()
        if not line:
            continue
        parts = line.split(None, 1)
        if len(parts) != 2:
            continue
        key, val = parts
        for cast in (int, float):
            try:
                val = cast(val)
                break
            except ValueError:
                continue
        hdr[key] = val
    return hdr


def _dada_tensor_header(dhdr, name):
    """Sequence header from parsed DADA key/values (shared by the file
    and shm sources)."""
    nbit = int(dhdr.get('NBIT', 8))
    npol = int(dhdr.get('NPOL', 1))
    nchan = int(dhdr.get('NCHAN', 1))
    ndim = int(dhdr.get('NDIM', 1))    # 2 = complex
    dtype = ('ci%d' if ndim == 2 else 'i%d') % nbit
    tsamp = float(dhdr.get('TSAMP', 1.0)) * 1e-6
    freq = float(dhdr.get('FREQ', 0.0))
    bw = float(dhdr.get('BW', 1.0))
    return {
        '_tensor': {
            'dtype': dtype,
            'shape': [-1, nchan, npol],
            'labels': ['time', 'freq', 'pol'],
            'scales': [[0, tsamp],
                       [freq - 0.5 * bw, bw / max(nchan, 1)], None],
            'units': ['s', 'MHz', None],
        },
        'source_name': dhdr.get('SOURCE'),
        'telescope': dhdr.get('TELESCOPE'),
        'name': name,
        'dada_header': {k: v for k, v in dhdr.items()},
    }


def _fill_span(ospan, raw):
    """Copy raw bytes into a write span; returns whole frames filled."""
    buf = ospan.data.as_numpy()
    if len(raw) % ospan.frame_nbyte:
        raw = raw[:len(raw) - len(raw) % ospan.frame_nbyte]
    flat = buf.view(np.uint8).reshape(-1)
    flat[:len(raw)] = np.frombuffer(raw, np.uint8)
    return len(raw) // ospan.frame_nbyte


class DadaFileSourceBlock(SourceBlock):
    """Read PSRDADA .dada files (reference: blocks/dada_file.py)."""

    def create_reader(self, sourcename):
        return open(sourcename, 'rb')

    def on_sequence(self, reader, sourcename):
        raw = reader.read(DADA_HEADER_SIZE)
        dhdr = _parse_dada_header(raw)
        hdr_size = int(dhdr.get('HDR_SIZE', DADA_HEADER_SIZE))
        # data starts exactly at HDR_SIZE, which may be smaller or larger
        # than the default probe read
        reader.seek(hdr_size)
        return [_dada_tensor_header(dhdr, sourcename)]

    def on_data(self, reader, ospans):
        ospan = ospans[0]
        raw = reader.read(ospan.data.as_numpy().nbytes)
        return [_fill_span(ospan, raw)]


class _HduReader(object):
    """Streams one observation's bytes out of a DadaHDU data ring.
    Waits observe ``stop_event`` (set by pipeline shutdown) via timed
    semaphore ops, so a stalled writer cannot wedge shutdown."""

    POLL_SECS = 0.2

    def __init__(self, hdu, stop_event=None):
        self.hdu = hdu
        self._stop = stop_event
        self.header_raw = hdu.read_header(
            timeout=self.POLL_SECS,
            should_stop=self._should_stop if stop_event is not None
            else None)
        self._leftover = b''
        self._eod = self.header_raw is None

    def _should_stop(self):
        return self._stop is not None and self._stop.is_set()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def read_bytes(self, nbyte):
        out = [self._leftover[:nbyte]]
        got = len(out[0])
        self._leftover = self._leftover[nbyte:]
        while got < nbyte and not self._eod:
            res = self.hdu.data.open_read_buf(
                self.POLL_SECS if self._stop is not None else None)
            if res is None:
                if self._should_stop():
                    self._eod = True
                    break
                continue
            buf, n, eod = res
            chunk = bytes(buf[:n])
            self.hdu.data.mark_cleared()
            self._eod = eod
            take = min(nbyte - got, len(chunk))
            out.append(chunk[:take])
            self._leftover = chunk[take:]
            got += take
        return b''.join(out)


class PsrdadaSourceBlock(SourceBlock):
    """Read observations from a PSRDADA-style shared-memory ring
    (reference: blocks/psrdada.py:365 PsrdadaSourceBlock).

    ``keys`` are ring keys (ints or hex strings like '0xdada'); each
    observation (header page + data until EOD) becomes one sequence."""

    def __init__(self, keys, gulp_nframe, nobs=1, *args, **kwargs):
        keys = [keys] if not isinstance(keys, (list, tuple)) else keys
        keys = [k if isinstance(k, int) else int(str(k), 16)
                for k in keys]
        # one sourcename per expected observation per ring
        names = [k for k in keys for _ in range(nobs)]
        super(PsrdadaSourceBlock, self).__init__(names, gulp_nframe,
                                                 *args, **kwargs)
        self._hdus = {}

    def create_reader(self, key):
        from ..io.dada_shm import DadaHDU
        if key not in self._hdus:
            self._hdus[key] = DadaHDU(key)
        return _HduReader(self._hdus[key], stop_event=self.shutdown_event)

    def on_sequence(self, reader, key):
        if reader.header_raw is None:       # shut down while waiting
            raise EOFError("shutdown before a DADA header arrived")
        dhdr = _parse_dada_header(reader.header_raw)
        return [_dada_tensor_header(dhdr, 'psrdada_%x' % key)]

    def on_data(self, reader, ospans):
        ospan = ospans[0]
        raw = reader.read_bytes(ospan.data.as_numpy().nbytes)
        return [_fill_span(ospan, raw)]


def read_dada_file(filenames, gulp_nframe, *args, **kwargs):
    """Block: read PSRDADA .dada files."""
    return DadaFileSourceBlock(filenames, gulp_nframe, *args, **kwargs)


def read_psrdada_buffer(keys, gulp_nframe=None, nobs=1, *args, **kwargs):
    """Block: read from a PSRDADA-style shared-memory ring (no
    libpsrdada needed; see io.dada_shm for the interop contract)."""
    if gulp_nframe is None:
        raise TypeError("read_psrdada_buffer requires gulp_nframe")
    return PsrdadaSourceBlock(keys, gulp_nframe, nobs, *args, **kwargs)
