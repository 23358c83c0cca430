"""GUPPI RAW format (Breakthrough-Listen / guppi_daq); the port's own
copy of ``bifrost_tpu/io/guppi.py`` (numpy-free, unchanged).

Format (public spec; reference implementation:
python/bifrost/guppi_raw.py:28-99): blocks of 80-char FITS-like header
records ('KEY     = value', 'END' terminated, optional DIRECTIO 512-byte
alignment) each followed by BLOCSIZE bytes of [chan][time][pol] complex
integer voltages.
"""

from __future__ import annotations

__all__ = ['read_header', 'write_header']

RECORD_LEN = 80
DIRECTIO_ALIGN = 512


def read_header(f):
    hdr = {}
    nread = 0
    while True:
        record = f.read(RECORD_LEN)
        nread += RECORD_LEN
        if len(record) < RECORD_LEN:
            if not hdr and len(record) == 0:
                raise EOFError("No more blocks")
            raise IOError("EOF mid-header")
        record = record.decode('ascii', 'replace')
        if record.startswith('END'):
            break
        key, _, val = record.partition('=')
        key, val = key.strip(), val.strip()
        try:
            val = int(val)
        except ValueError:
            try:
                val = float(val)
            except ValueError:
                if val[:1] in ("'", '"'):
                    val = val[1:-1].rstrip()
        hdr[key] = val
    if hdr.get('DIRECTIO', 0):
        pad = (-f.tell()) % DIRECTIO_ALIGN
        if pad:
            f.read(pad)
    if 'NPOL' in hdr:
        # NPOL=4 conventionally counts complex components
        hdr['NPOL'] = 1 if hdr['NPOL'] == 1 else 2
    if 'NTIME' not in hdr and 'BLOCSIZE' in hdr:
        hdr['NTIME'] = hdr['BLOCSIZE'] * 8 // (
            hdr['OBSNCHAN'] * hdr['NPOL'] * 2 * hdr['NBITS'])
    return hdr


def write_header(f, hdr):
    """Write a GUPPI block header (no DIRECTIO padding)."""
    for key, val in hdr.items():
        if key in ('NTIME',):
            continue
        if isinstance(val, str):
            sval = "'%s'" % val
        else:
            sval = repr(val)
        record = '%-8s= %s' % (key[:8], sval)
        f.write(record.ljust(RECORD_LEN)[:RECORD_LEN].encode('ascii'))
    f.write(b'END' + b' ' * (RECORD_LEN - 3))
