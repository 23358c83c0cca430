"""Packet transmit: ring/array data -> UDP or disk packets (the port of
``bifrost_tpu/io/packet_writer.py``).

``UDPTransmit(...)`` with a format that has a native filler and a socket
with a file descriptor is a :class:`NativeUDPTransmit`, whose
construction raises ``native.NativeError`` when the library does not
build or load; ``BF_NO_NATIVE_CAPTURE=1`` (or ``BF_NO_NATIVE=1``, which
switches the whole library off) selects the Python transmitter.  The
JAX package falls back to Python quietly when its library is missing.

Mirrors the reference writer stack (reference: src/packet_writer.hpp
HeaderInfo + per-format fillers + disk/UDP senders + token-bucket
RateLimiter at packet_writer.hpp:59; python API
python/bifrost/packet_writer.py:42-105).
"""

from __future__ import annotations

import time

import numpy as np

from .packet_formats import get_format, PacketDesc

__all__ = ['HeaderInfo', 'UDPTransmit', 'NativeUDPTransmit',
           'DiskWriter', 'RateLimiter']


class HeaderInfo(object):
    """Mutable header template (reference: bfHeaderInfo*)."""

    def __init__(self):
        self.nsrc = 1
        self.nchan = 1
        self.chan0 = 0
        self.tuning = 0
        self.gain = 0
        self.decimation = 1

    def set_nsrc(self, v):
        self.nsrc = v

    def set_nchan(self, v):
        self.nchan = v

    def set_chan0(self, v):
        self.chan0 = v

    def set_tuning(self, v):
        self.tuning = v

    def set_gain(self, v):
        self.gain = v

    def set_decimation(self, v):
        self.decimation = v


class RateLimiter(object):
    """Token-bucket packets-per-second limiter (reference:
    packet_writer.hpp:59)."""

    def __init__(self, rate_pps=0):
        self.rate = rate_pps
        self._next_time = None

    def wait(self, npackets=1):
        if not self.rate:
            return
        now = time.monotonic()
        if self._next_time is None:
            self._next_time = now
        self._next_time += npackets / float(self.rate)
        delay = self._next_time - now
        if delay > 0:
            time.sleep(delay)


_WRITER_SEQ = [0]


class _WriterBase(object):
    def __init__(self, fmt, core=None):
        self.fmt = get_format(fmt)
        self.core = core
        self.limiter = RateLimiter(0)
        self.npackets_sent = 0
        self.nbytes_sent = 0
        # observable like the reference's udp_transmit proclogs
        # (tools/like_bmon.py reads these for the TX pane)
        from ..proclog import ProcLog
        _WRITER_SEQ[0] += 1
        self._stats_proclog = ProcLog(
            '%s_transmit_%d/stats' % (self.fmt.name, _WRITER_SEQ[0]))

    def _log_stats(self, force=False):
        self._stats_proclog.update(
            {'npackets': self.npackets_sent,
             'nbytes': self.nbytes_sent}, force=force)

    def set_rate_limit(self, rate_pps):
        self.limiter = RateLimiter(rate_pps)

    def reset_counter(self):
        self.npackets_sent = 0
        self.nbytes_sent = 0

    def _send_bytes(self, data):
        raise NotImplementedError

    def send(self, headerinfo, seq, seq_increment, src, src_increment,
             idata):
        """Send idata as packets: shape (nseq, nsrc, payload...) — packet
        (i, j) carries seq + i*seq_increment, src + j*src_increment
        (reference: bfPacketWriterSend)."""
        arr = np.ascontiguousarray(np.asarray(idata))
        if arr.ndim < 2:
            arr = arr.reshape(1, 1, -1)
        nseq, nsrc = arr.shape[0], arr.shape[1]
        payloads = arr.reshape(nseq, nsrc, -1)
        for i in range(nseq):
            for j in range(nsrc):
                desc = PacketDesc(
                    seq=seq + i * seq_increment,
                    src=src + j * src_increment,
                    nsrc=headerinfo.nsrc, chan0=headerinfo.chan0,
                    nchan=headerinfo.nchan, tuning=headerinfo.tuning,
                    gain=headerinfo.gain,
                    decimation=headerinfo.decimation,
                    payload=payloads[i, j].tobytes())
                self.limiter.wait()
                # frame counter rides the wire frame_count_word where the
                # format has one (reference: packet_writer.hpp framecount)
                raw = self.fmt.pack(desc, framecount=self.npackets_sent)
                self._send_bytes(raw)
                self.npackets_sent += 1
                self.nbytes_sent += len(raw)
        self._log_stats()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        # final totals must land regardless of write throttling
        self._log_stats(force=True)
        return False


def _native_tx_usable(fmt, sock):
    from ..native import disabled
    from .packet_capture import native_io_usable, NATIVE_TX_FMT_IDS
    return not disabled() and \
        native_io_usable(fmt, sock, NATIVE_TX_FMT_IDS)


class UDPTransmit(_WriterBase):
    """UDP packet transmitter.  When the format has a native filler
    (native/capture.cpp transmit engine) the whole header-fill +
    sendmmsg loop runs in C++ (module docstring for the switches)."""

    def __new__(cls, fmt=None, sock=None, *args, **kwargs):
        if cls is UDPTransmit and _native_tx_usable(fmt, sock):
            return super(UDPTransmit, cls).__new__(NativeUDPTransmit)
        return super(UDPTransmit, cls).__new__(cls)

    def __init__(self, fmt, sock, core=None):
        super(UDPTransmit, self).__init__(fmt, core)
        self.sock = sock

    def _send_bytes(self, data):
        self.sock.send(data)


class NativeUDPTransmit(UDPTransmit):
    """Native transmit engine: C++ header fill + sendmmsg batches +
    in-engine token-bucket pacing (reference: packet_writer.hpp:59-580).
    """

    def __init__(self, fmt, sock, core=None):
        import ctypes
        from .. import native as native_mod
        from .packet_capture import NATIVE_TX_FMT_IDS, load_io_engines
        _WriterBase.__init__(self, fmt, core)
        self.sock = sock
        self._lib = load_io_engines()
        handle = ctypes.c_void_p()
        native_mod.check(self._lib.bft_transmit_create(
            ctypes.byref(handle), NATIVE_TX_FMT_IDS[self.fmt.name],
            sock.fileno()), 'transmit')
        self._handle = handle
        # codec parameters the C fillers need beyond HeaderInfo
        if getattr(self.fmt, 'nbeam', 0):
            self._lib.bft_transmit_set_nbeam(handle, int(self.fmt.nbeam))
        if self.fmt.name == 'vdif':
            f = self.fmt
            self._lib.bft_transmit_set_vdif(
                handle, int(f.frames_per_second), int(bool(f.legacy)),
                int(f.log2_nchan), int(f.nbit),
                int(bool(f.is_complex)), int(f.station_id),
                int(f.ref_epoch))

    def set_rate_limit(self, rate_pps):
        self.limiter = RateLimiter(rate_pps)   # kept for introspection
        self._lib.bft_transmit_set_rate(self._handle, int(rate_pps))

    def send(self, headerinfo, seq, seq_increment, src, src_increment,
             idata):
        import ctypes
        from .. import native as native_mod
        arr = np.ascontiguousarray(np.asarray(idata))
        if arr.ndim < 2:
            arr = arr.reshape(1, 1, -1)
        nseq, nsrc = arr.shape[0], arr.shape[1]
        payloads = np.ascontiguousarray(
            arr.reshape(nseq, nsrc, -1).view(np.uint8))
        nsent = ctypes.c_longlong(0)
        rc = self._lib.bft_transmit_send(
            self._handle, int(seq), int(seq_increment), int(src),
            int(src_increment), int(headerinfo.nsrc),
            int(headerinfo.chan0), int(headerinfo.nchan),
            int(headerinfo.tuning), int(headerinfo.gain),
            int(headerinfo.decimation), int(self.npackets_sent),
            payloads.ctypes.data_as(
                ctypes.POINTER(ctypes.c_ubyte)),
            nseq, nsrc, payloads.shape[-1], ctypes.byref(nsent))
        # count packets that made it out even on a partial failure
        self.npackets_sent += nsent.value
        self.nbytes_sent += nsent.value * (
            payloads.shape[-1] + self.fmt.header_size)
        self._log_stats()
        native_mod.check(rc, 'send')

    def __del__(self):
        try:
            if getattr(self, '_handle', None) is not None:
                self._lib.bft_transmit_destroy(self._handle)
                self._handle = None
        except Exception:
            pass


class DiskWriter(_WriterBase):
    def __init__(self, fmt, fh, core=None):
        super(DiskWriter, self).__init__(fmt, core)
        self.fh = fh

    def _send_bytes(self, data):
        self.fh.write(data)
