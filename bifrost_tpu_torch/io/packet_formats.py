"""Wire formats for packet capture/transmit — bit-exact reference layouts
(the port of ``bifrost_tpu/io/packet_formats.py``, pure numpy and struct).

The reference implements per-telescope formats as C++ decoder /
header-filler pairs over ``__attribute__((packed))`` structs
(reference: src/formats/*.hpp; base classes formats/base.hpp:91-155).
Each codec here is a small object with

- ``header_size``
- ``pack(desc, framecount=0) -> bytes`` — mirrors the reference
  *HeaderFiller* byte-for-byte (so transmitted packets are accepted by
  reference/real receivers)
- ``unpack(buf) -> PacketDesc | None`` — mirrors the reference
  *Decoder* field-for-field (so real recorded packets decode
  identically); returns None where the reference's frame-size /
  validity gates reject the packet outright
- ``decode_batch(arr) -> (seqs, srcs, payload_offset[, valid])`` —
  vectorized header decode over a ``(npkt, pkt_bytes)`` uint8 batch
  (one recvmmsg worth); EVERY gallery codec implements it so no wire
  format falls into the per-packet ``struct.unpack`` slow path.  The
  optional 4th element is a bool mask mirroring unpack's rejection
  gates (sync word, frame size, valid_mode bit); ``None``/omitted
  means all rows valid.  A codec whose payload offset is not uniform
  across the batch (VDIF mixing legacy and non-legacy framing) raises
  ValueError and the capture engine falls back to per-packet decode
  for that batch.

Wire-convention notes (all faithful to the reference):

- LWA-style formats (tbn/drx/drx8/tbf/cor) carry a little-endian
  ``sync_word`` 0x5CDEC0DE followed by big-endian fields; frame sizes
  are fixed (TBN 1048, DRX 4128, DRX8 8224 bytes) and enforced
  (reference: tbn.hpp:33, drx.hpp:33, drx8.hpp:33 — the reference's
  drx8 decoder compares against DRX_FRAME_SIZE, an apparent bug; we
  use the intended DRX8_FRAME_SIZE).
- chips/ibeam wire sequence numbers are 1-based; decoders subtract 1
  (chips.hpp:64, ibeam.hpp:73) while fillers write the caller's value
  verbatim — pack/unpack therefore round-trip to ``seq - 1``, exactly
  like the reference pair.
- pbeam's decoder composes ``src = beam*nserver + (server-1)`` from the
  1-based wire beam (pbeam.hpp:76); its filler writes
  ``beam = src/nserver + 1`` — the reference pair round-trips with a
  +nserver offset absorbed by the capture ``src0``; we mirror both
  sides exactly.
"""

from __future__ import annotations

import math
import struct

import numpy as np

__all__ = ['PacketDesc', 'get_format', 'register_format', 'FORMATS']

SYNC_WORD = 0x5CDEC0DE

TBN_FRAME_SIZE = 1048     # reference: tbn.hpp:33
DRX_FRAME_SIZE = 4128     # reference: drx.hpp:33
DRX8_FRAME_SIZE = 8224    # reference: drx8.hpp:33


def _field(arr, off, dtype):
    """Per-row fixed-width header field at byte offset ``off`` of a
    (npkt, pkt_bytes) uint8 batch, widened to int64 (every decode_batch
    works in int64 so seq arithmetic never wraps)."""
    nbyte = np.dtype(dtype).itemsize
    return arr[:, off:off + nbyte].copy().view(dtype).astype(
        np.int64).ravel()


def _field_raw(arr, off, dtype):
    """Like :func:`_field` but keeps the native unsigned dtype — for
    sync-word comparisons whose values don't fit in int63."""
    nbyte = np.dtype(dtype).itemsize
    return arr[:, off:off + nbyte].copy().view(dtype).ravel()


def _isqrt(x):
    """Exact elementwise integer sqrt of a nonnegative int64 array —
    matches ``math.isqrt`` (np.sqrt alone can round across the
    perfect-square boundary)."""
    r = np.sqrt(x.astype(np.float64)).astype(np.int64)
    r -= r * r > x
    r += (r + 1) * (r + 1) <= x
    return r


class PacketDesc(object):
    """Decoded packet metadata (reference: formats/base.hpp PacketDesc)."""

    __slots__ = ('seq', 'src', 'nsrc', 'chan0', 'nchan', 'time_tag',
                 'tuning', 'tuning1', 'gain', 'decimation', 'beam',
                 'valid_mode', 'sync', 'nchan_tot', 'npol', 'npol_tot',
                 'pol0', 'payload', 'payload_size')

    def __init__(self, seq=0, src=0, nsrc=1, chan0=0, nchan=1, time_tag=0,
                 tuning=0, tuning1=0, gain=0, decimation=1, beam=0,
                 valid_mode=0, sync=0, nchan_tot=0, npol=0, npol_tot=0,
                 pol0=0, payload=b''):
        self.seq = seq
        self.src = src
        self.nsrc = nsrc
        self.chan0 = chan0
        self.nchan = nchan
        self.time_tag = time_tag
        self.tuning = tuning
        self.tuning1 = tuning1
        self.gain = gain
        self.decimation = decimation
        self.beam = beam
        self.valid_mode = valid_mode
        self.sync = sync
        self.nchan_tot = nchan_tot
        self.npol = npol
        self.npol_tot = npol_tot
        self.pol0 = pol0
        self.payload = payload
        self.payload_size = len(payload)


class _FormatBase(object):
    name = None
    header_struct = None
    # Formats whose decoded src composes multiple wire fields (e.g.
    # pbeam's (beam, server) pair) must apply the capture's src0 in
    # *composed* units inside unpack(), like the reference decoders do
    # (pbeam.hpp:70, cor.hpp:77: (beam - src0) * nserver + server - 1).
    # When True the engine pushes its src0 into the codec and skips its
    # own flat rebase.
    applies_src0 = False
    src0 = 0

    @property
    def header_size(self):
        return self.header_struct.size

    def pack(self, desc, framecount=0):
        raise NotImplementedError

    def unpack(self, buf):
        raise NotImplementedError


class SimpleFormat(_FormatBase):
    """u64be seq + payload (reference: src/formats/simple.hpp:33-93)."""

    name = 'simple'
    header_struct = struct.Struct('>Q')

    def pack(self, desc, framecount=0):
        return self.header_struct.pack(desc.seq) + bytes(desc.payload)

    def unpack(self, buf):
        if len(buf) < self.header_size:
            return None
        (seq,) = self.header_struct.unpack_from(buf)
        return PacketDesc(seq=seq, src=0, nsrc=1, nchan=1,
                          payload=buf[self.header_size:])

    def decode_batch(self, arr, length=None):
        """Vectorized header decode for a (npkt, pkt_bytes) uint8 array
        (recvmmsg batch).  Returns (seqs, srcs, payload_offset)."""
        return _field(arr, 0, '>u8'), np.zeros(len(arr), np.int64), \
            self.header_size


class ChipsFormat(_FormatBase):
    """CHIPS F-engine packets (reference: src/formats/chips.hpp:33-43).

    Wire header (14 bytes, packed): u8 roach (1-based), u8 gbe/tuning,
    u8 nchan, u8 nsubband, u8 subband, u8 nroach, u16be chan0,
    u64be seq (1-based)."""

    name = 'chips'
    header_struct = struct.Struct('>BBBBBBHQ')
    #: (byte offset, wire bias) of a single-byte source id usable for
    #: deterministic REUSEPORT steering: worker = (byte - bias) & mask
    #: (udp_socket.attach_reuseport_cbpf)
    SRC_STEER_BYTE = (0, 1)

    def pack(self, desc, framecount=0):
        # mirror CHIPSHeaderFiller (chips.hpp:169-183)
        return self.header_struct.pack(
            (desc.src + 1) & 0xFF, desc.tuning & 0xFF, desc.nchan & 0xFF,
            1, 0, desc.nsrc & 0xFF, desc.chan0 & 0xFFFF,
            desc.seq) + bytes(desc.payload)

    def unpack(self, buf):
        # mirror CHIPSDecoder (chips.hpp:55-73)
        if len(buf) < self.header_size:
            return None
        roach, gbe, nchan, _nsub, _sub, nroach, chan0, seq = \
            self.header_struct.unpack_from(buf)
        return PacketDesc(seq=seq - 1, src=roach - 1, nsrc=nroach,
                          tuning=gbe, nchan=nchan, chan0=chan0,
                          payload=buf[self.header_size:])

    def decode_batch(self, arr, length=None):
        """Vectorized header decode (see SimpleFormat.decode_batch) —
        wire seq and roach are 1-based, exactly like unpack."""
        return _field(arr, 8, '>u8') - 1, \
            arr[:, 0].astype(np.int64) - 1, self.header_size


class PBeamFormat(_FormatBase):
    """Power-beam spectra (reference: src/formats/pbeam.hpp:33-46).

    Wire header (18 bytes, packed): u8 server (1-based), u8 beam
    (1-based), u8 gbe, u8 nchan, u8 nbeam, u8 nserver, u16be navg,
    u16be chan0, u64be seq (a timestamp; decoder seq = wire_seq/navg)."""

    name = 'pbeam'
    header_struct = struct.Struct('>BBBBBBHHQ')
    applies_src0 = True

    def __init__(self, nbeam=1, src0=0):
        self.nbeam = nbeam
        # src0 is in wire-beam (1-based) units, not composed-source
        # units (reference: pbeam.hpp:70)
        self.src0 = src0

    def pack(self, desc, framecount=0):
        # mirror PBeamHeaderFiller (pbeam.hpp:126-147)
        nserver = max(desc.nsrc // self.nbeam, 1)
        server = (desc.src % nserver) + 1
        beam = (desc.src // nserver) + 1
        return self.header_struct.pack(
            server & 0xFF, beam & 0xFF, desc.tuning & 0xFF,
            desc.nchan & 0xFF, self.nbeam & 0xFF, nserver & 0xFF,
            desc.decimation & 0xFFFF, desc.chan0 & 0xFFFF,
            desc.seq) + bytes(desc.payload)

    def unpack(self, buf):
        # mirror PBeamDecoder (pbeam.hpp:58-84)
        if len(buf) < self.header_size:
            return None
        server, beam, gbe, nchan, nbeam, nserver, navg, chan0, wseq = \
            self.header_struct.unpack_from(buf)
        navg = max(navg, 1)
        src = (beam - self.src0) * max(nserver, 1) + (server - 1)
        return PacketDesc(seq=wseq // navg, time_tag=wseq,
                          decimation=navg, src=src, beam=nbeam,
                          tuning=gbe, nchan=nchan,
                          chan0=chan0 - nchan * src,
                          payload=buf[self.header_size:])

    def decode_batch(self, arr, length=None):
        """Vectorized decode mirroring unpack: src composes the
        1-based wire (beam, server) pair with src0 applied in wire-beam
        units (pbeam.hpp:70), seq divides the wire timestamp by navg."""
        server = arr[:, 0].astype(np.int64)
        beam = arr[:, 1].astype(np.int64)
        nserver = np.maximum(arr[:, 5].astype(np.int64), 1)
        navg = np.maximum(_field(arr, 6, '>u2'), 1)
        wseq = _field(arr, 10, '>u8')
        srcs = (beam - self.src0) * nserver + (server - 1)
        return wseq // navg, srcs, self.header_size


class TbnFormat(_FormatBase):
    """LWA TBN frames, 1048 bytes total (reference: src/formats/tbn.hpp).

    Wire header (24 bytes, packed): u32le sync 0x5CDEC0DE, u32be
    frame_count, u32be tuning_word, u16be tbn_id (1-based stand |
    flags), u16be gain, u64be time_tag.  Payload: 512 ci8 samples
    (1024 bytes).  seq = time_tag // decimation // 512 with the
    decimation learned stream-side (reference: TBNCache) — here a
    constructor parameter."""

    name = 'tbn'
    frame_size = TBN_FRAME_SIZE
    header_struct = struct.Struct('<I')
    _rest = struct.Struct('>IIHHQ')
    seq_quantum = 512

    def __init__(self, decimation=1):
        self.decimation = max(int(decimation), 1)

    @property
    def header_size(self):
        return self.header_struct.size + self._rest.size

    def pack(self, desc, framecount=0):
        # mirror TBNHeaderFiller (tbn.hpp:124-141)
        return (self.header_struct.pack(SYNC_WORD) +
                self._rest.pack(framecount & 0xFFFFFF, desc.tuning,
                                (desc.src + 1) & 0x3FFF, desc.gain,
                                desc.seq) +
                bytes(desc.payload))

    def unpack(self, buf):
        # mirror TBNDecoder (tbn.hpp:80-111); wire seq IS the time_tag
        if len(buf) != TBN_FRAME_SIZE:
            return None
        (sync,) = self.header_struct.unpack_from(buf)
        fcount, tuning, tbn_id, gain, time_tag = \
            self._rest.unpack_from(buf, self.header_struct.size)
        if sync != SYNC_WORD:
            return None
        return PacketDesc(
            seq=time_tag // self.decimation // self.seq_quantum,
            src=(tbn_id & 1023) - 1, time_tag=time_tag, tuning=tuning,
            gain=gain, valid_mode=(tbn_id >> 15) & 1,
            decimation=self.decimation, sync=sync, nchan=1,
            payload=buf[self.header_size:])

    def decode_batch(self, arr, length=None):
        """Vectorized decode mirroring unpack's gates: frame size must
        be exactly 1048, sync word must match, and the TBN-mode bit
        (tbn_id bit 15 — the engine's valid_mode reject) marks the row
        invalid.  ``length`` is the true datagram size when ``arr`` is
        padded to a receive stride (or truncated to a header sidecar)."""
        tbn_id = _field(arr, 12, '>u2')
        time_tag = _field(arr, 16, '>u8')
        seqs = time_tag // self.decimation // self.seq_quantum
        srcs = (tbn_id & 1023) - 1
        if (arr.shape[1] if length is None else length) \
                != TBN_FRAME_SIZE:
            valid = np.zeros(len(arr), bool)
        else:
            valid = np.equal(_field_raw(arr, 0, '<u4'),
                             np.uint32(SYNC_WORD))
            valid &= ((tbn_id >> 15) & 1) == 0
        return seqs, srcs, self.header_size, valid


class DrxFormat(_FormatBase):
    """LWA DRX frames, 4128 bytes total (reference: src/formats/drx.hpp).

    Wire header (32 bytes, packed): u32le sync, u8 id (beam 1-3 in bits
    0-2, tuning 1-2 in bits 3-5, reserved bit 6, pol in bit 7), 3 bytes
    frame count, u32be seconds, u16be decimation, u16be time_offset,
    u64be time_tag, u32be tuning_word, u32be flags.  Payload: 4096 ci4
    samples.  Decoded src = ((tuning-1) << 1) | pol;
    seq = (time_tag - time_offset) // decimation // 4096."""

    name = 'drx'
    frame_size = DRX_FRAME_SIZE
    npayload = 4096
    header_struct = struct.Struct('<IB')
    _rest = struct.Struct('>3sIHHQII')
    seq_quantum = 4096

    @property
    def header_size(self):
        return self.header_struct.size + self._rest.size

    def pack(self, desc, framecount=0):
        # mirror DRXHeaderFiller (drx.hpp:156-172): desc.src is the raw
        # wire ID byte (bit 6 masked off)
        return (self.header_struct.pack(SYNC_WORD, desc.src & 0xBF) +
                self._rest.pack(b'\x00\x00\x00', 0,
                                desc.decimation & 0xFFFF, 0, desc.seq,
                                desc.tuning, 0) +
                bytes(desc.payload))

    def unpack(self, buf):
        # mirror DRXDecoder (drx.hpp:66-96)
        if len(buf) != self.frame_size:
            return None
        sync, pkt_id = self.header_struct.unpack_from(buf)
        _fc, _secs, decim, toff, time_tag, tuning_word, _flags = \
            self._rest.unpack_from(buf, self.header_struct.size)
        if sync != SYNC_WORD:
            return None
        beam = (pkt_id & 0x7) - 1
        tune = ((pkt_id >> 3) & 0x7) - 1
        pol = (pkt_id >> 7) & 0x1
        src = (tune << 1) | pol
        decim = max(decim, 1)
        time_tag = time_tag - toff
        desc = PacketDesc(seq=time_tag // decim // self.seq_quantum,
                          src=src, beam=beam, time_tag=time_tag,
                          decimation=decim, sync=sync,
                          valid_mode=(pkt_id >> 6) & 0x1, nchan=1,
                          payload=buf[self.header_size:])
        if src // 2 == 0:
            desc.tuning = tuning_word
        else:
            desc.tuning1 = tuning_word
        return desc

    def decode_batch(self, arr, length=None):
        """Vectorized decode mirroring unpack (drx8 inherits with its
        own frame_size/seq_quantum): src composes the wire id byte's
        tuning and pol bits; the reserved bit (valid_mode) rejects."""
        pkt_id = arr[:, 4].astype(np.int64)
        decim = np.maximum(_field(arr, 12, '>u2'), 1)
        time_tag = _field(arr, 16, '>u8') - _field(arr, 14, '>u2')
        tune = ((pkt_id >> 3) & 0x7) - 1
        srcs = (tune << 1) | ((pkt_id >> 7) & 0x1)
        seqs = time_tag // decim // self.seq_quantum
        if (arr.shape[1] if length is None else length) \
                != self.frame_size:
            valid = np.zeros(len(arr), bool)
        else:
            valid = np.equal(_field_raw(arr, 0, '<u4'),
                             np.uint32(SYNC_WORD))
            valid &= ((pkt_id >> 6) & 0x1) == 0
        return seqs, srcs, self.header_size, valid


class Drx8Format(DrxFormat):
    """DRX with 8+8-bit samples, 8224 bytes total (reference:
    src/formats/drx8.hpp; the reference decoder's size gate references
    DRX_FRAME_SIZE — an apparent bug — we use the intended 8224)."""

    name = 'drx8'
    frame_size = DRX8_FRAME_SIZE
    npayload = 8192


class IBeamFormat(_FormatBase):
    """LWA ibeam voltage-beam packets (reference: src/formats/ibeam.hpp:33-41).

    Wire header (13 bytes, packed): u8 server (1-based), u8 gbe,
    u8 nchan, u8 nbeam, u8 nserver, u16be chan0 (global: logical chan0
    + nchan*src), u64be seq (1-based)."""

    name = 'ibeam'
    header_struct = struct.Struct('>BBBBBHQ')

    def __init__(self, nbeam=1):
        self.nbeam = nbeam

    def pack(self, desc, framecount=0):
        # mirror IBeamHeaderFiller (ibeam.hpp:92-109): seq written
        # verbatim (wire convention is 1-based, so like chips the pair
        # round-trips to seq-1); wire chan0 is the *global* first
        # channel, reconstructed from the logical chan0
        wire_chan0 = (desc.chan0 + desc.nchan * desc.src) & 0xFFFF
        return self.header_struct.pack(
            (desc.src + 1) & 0xFF, desc.tuning & 0xFF, desc.nchan & 0xFF,
            self.nbeam & 0xFF, desc.nsrc & 0xFF, wire_chan0,
            desc.seq) + bytes(desc.payload)

    def unpack(self, buf):
        # mirror IBeamDecoder (ibeam.hpp:56-81)
        if len(buf) < self.header_size:
            return None
        server, gbe, nchan, nbeam, nserver, chan0, seq = \
            self.header_struct.unpack_from(buf)
        src = server - 1
        return PacketDesc(seq=seq - 1, src=src, nsrc=nserver, beam=nbeam,
                          tuning=gbe, nchan=nchan,
                          chan0=chan0 - nchan * src,
                          payload=buf[self.header_size:])

    def decode_batch(self, arr, length=None):
        """Vectorized decode mirroring unpack — wire seq and server
        are 1-based, exactly like chips."""
        return _field(arr, 7, '>u8') - 1, \
            arr[:, 0].astype(np.int64) - 1, self.header_size


class CorFormat(_FormatBase):
    """LWA COR visibility packets (reference: src/formats/cor.hpp:33-44).

    Wire header (32 bytes, packed): u32le sync, u32be frame_count_word
    (flag 0x02 in bits 24-31; nchan_decim / nserver / server in bits
    16-23 / 8-15 / 0-7), u32be second_count, u16be first_chan, u16be
    gain, u64be time_tag, u32be navg, u16be stand0 (1-based), u16be
    stand1 (1-based).  Decoded src enumerates (baseline, server);
    seq = time_tag // 196e6 // (navg/100)."""

    name = 'cor'
    header_struct = struct.Struct('<I')
    _rest = struct.Struct('>IIHHQIHH')
    applies_src0 = True

    def __init__(self, nsrc=1, src0=0):
        # src0 is in baseline units (reference: cor.hpp:77-78)
        self.src0 = src0
        # total number of (baseline, server) sources; sets the stand
        # count used to (de)compose baseline indices, like the
        # reference's decoder nsrc (cor.hpp:74)
        self.nsrc = max(int(nsrc), 1)

    @property
    def header_size(self):
        return self.header_struct.size + self._rest.size

    def _nserver_of(self, tuning):
        return max((tuning >> 8) & 0xFF, 1)

    def pack(self, desc, framecount=0):
        # mirror CORHeaderFiller (cor.hpp:117-146): recover the stand
        # pair from the flat baseline index
        n = int((math.isqrt(8 * desc.nsrc + 1) - 1) // 2)
        b = 2 + 2 * (n - 1) + 1
        stand0 = int((b - math.sqrt(b * b - 8 * desc.src)) / 2)
        stand1 = desc.src - stand0 * (2 * (n - 1) + 1 - stand0) // 2
        fcw = (0x02 << 24) | (desc.tuning & 0xFFFFFF)
        return (self.header_struct.pack(SYNC_WORD) +
                self._rest.pack(fcw, 0, desc.chan0 & 0xFFFF, desc.gain,
                                desc.seq, desc.decimation,
                                (stand0 + 1) & 0xFFFF,
                                (stand1 + 1) & 0xFFFF) +
                bytes(desc.payload))

    def unpack(self, buf):
        # mirror CORDecoder (cor.hpp:62-97)
        if len(buf) < self.header_size:
            return None
        (sync,) = self.header_struct.unpack_from(buf)
        fcw, _secs, first_chan, gain, time_tag, navg, stand0, stand1 = \
            self._rest.unpack_from(buf, self.header_struct.size)
        if sync != SYNC_WORD:
            return None
        pld = buf[self.header_size:]
        nchan_decim = (fcw >> 16) & 0xFF
        nserver = max((fcw >> 8) & 0xFF, 1)
        server = fcw & 0xFF
        nchan_pkt = len(pld) // (8 * 4)
        stand0, stand1 = stand0 - 1, stand1 - 1
        nstand = int((math.isqrt(8 * self.nsrc // nserver + 1) - 1) // 2)
        navg = max(navg, 1)
        src = (stand0 * (2 * (nstand - 1) + 1 - stand0) // 2 +
               stand1 + 1 - self.src0) * nserver + (server - 1)
        return PacketDesc(
            seq=time_tag // 196000000 // max(navg // 100, 1),
            time_tag=time_tag, decimation=navg, src=src,
            nsrc=self.nsrc, nchan=nchan_pkt,
            chan0=first_chan - nchan_decim * nchan_pkt * (server - 1),
            tuning=(nserver << 8) | max(server - 1, 0), gain=gain,
            sync=sync, payload=pld)

    def decode_batch(self, arr, length=None):
        """Vectorized decode mirroring unpack: src enumerates the
        (baseline, server) pair from the 1-based wire stands, with the
        stand count recovered from this codec's nsrc per packet (the
        per-packet nserver rides the frame-count word) and src0
        applied in baseline units (cor.hpp:77)."""
        fcw = _field(arr, 4, '>u4')
        time_tag = _field(arr, 16, '>u8')
        navg = np.maximum(_field(arr, 24, '>u4'), 1)
        stand0 = _field(arr, 28, '>u2') - 1
        stand1 = _field(arr, 30, '>u2') - 1
        nserver = np.maximum((fcw >> 8) & 0xFF, 1)
        server = fcw & 0xFF
        nstand = (_isqrt(8 * (self.nsrc // nserver) + 1) - 1) // 2
        srcs = (stand0 * (2 * (nstand - 1) + 1 - stand0) // 2 +
                stand1 + 1 - self.src0) * nserver + (server - 1)
        seqs = time_tag // 196000000 // np.maximum(navg // 100, 1)
        valid = np.equal(_field_raw(arr, 0, '<u4'),
                         np.uint32(SYNC_WORD))
        return seqs, srcs, self.header_size, valid


class Snap2Format(_FormatBase):
    """SNAP2 F-engine packets (reference: src/formats/snap2.hpp:50-60).

    Wire header (28 bytes, packed, big-endian as read by the decoder's
    be*toh calls): u64 seq, u32 sync_time, u16 npol, u16 npol_tot,
    u16 nchan, u16 nchan_tot, u32 chan_block_id, u32 chan0, u32 pol0.
    Decoded src = pol0//npol + chan_block_id*npol_blocks.  (The
    reference *filler* stores its fields without byte swaps —
    inconsistent with its own decoder; we pack decoder-readably.)"""

    name = 'snap2'
    header_struct = struct.Struct('>QIHHHHIII')

    def pack(self, desc, framecount=0):
        npol = desc.npol or 2
        npol_tot = desc.npol_tot or npol
        nchan_tot = desc.nchan_tot or desc.nchan * desc.nsrc
        return self.header_struct.pack(
            desc.seq, desc.time_tag & 0xFFFFFFFF, npol, npol_tot,
            desc.nchan, nchan_tot, desc.src, desc.chan0, desc.pol0) + \
            bytes(desc.payload)

    def unpack(self, buf):
        # mirror SNAP2Decoder (snap2.hpp:70-103)
        if len(buf) < self.header_size:
            return None
        seq, sync_time, npol, npol_tot, nchan, nchan_tot, \
            chan_block_id, chan0, pol0 = self.header_struct.unpack_from(buf)
        npol = max(npol, 1)
        nchan = max(nchan, 1)
        npol_blocks = max(npol_tot // npol, 1)
        nchan_blocks = max(nchan_tot // nchan, 1)
        return PacketDesc(
            seq=seq, time_tag=sync_time, tuning=chan0,
            nsrc=npol_blocks * nchan_blocks, nchan=nchan,
            chan0=chan_block_id * nchan, nchan_tot=nchan_tot,
            npol=npol, npol_tot=npol_tot, pol0=pol0,
            src=pol0 // npol + chan_block_id * npol_blocks,
            payload=buf[self.header_size:])

    def decode_batch(self, arr, length=None):
        """Vectorized decode mirroring unpack: src composes the pol
        block with the channel block id."""
        seqs = _field(arr, 0, '>u8')
        npol = np.maximum(_field(arr, 12, '>u2'), 1)
        npol_tot = _field(arr, 14, '>u2')
        chan_block_id = _field(arr, 20, '>u4')
        pol0 = _field(arr, 28, '>u4')
        srcs = pol0 // npol + chan_block_id * \
            np.maximum(npol_tot // npol, 1)
        return seqs, srcs, self.header_size


class VdifFormat(_FormatBase):
    """VDIF frames (public VDIF spec; reference: src/formats/vdif.hpp).

    16-byte base header of little-endian 32-bit words with LSB-first
    bitfields; non-legacy frames carry a 16-byte extended header before
    the payload.
      w0: seconds(30) | legacy(1) | invalid(1)
      w1: frame_in_second(24) | ref_epoch(6) | unassigned(2)
      w2: frame_length/8(24) | log2_nchan(5) | version(3)
      w3: station_id(16) | thread_id(10) | bits/sample-1(5) | complex(1)
    seq = seconds * frames_per_second + frame_in_second (the reference
    learns frames_per_second stream-side via VDIFCache; constructor
    parameter here); src = thread_id."""

    name = 'vdif'
    header_struct = struct.Struct('<4I')
    ext_struct = struct.Struct('<4I')

    def __init__(self, frames_per_second=25600, legacy=False,
                 log2_nchan=0, nbit=8, is_complex=True, station_id=0,
                 ref_epoch=0):
        self.frames_per_second = frames_per_second
        self.legacy = legacy
        self.log2_nchan = log2_nchan
        self.nbit = nbit
        self.is_complex = is_complex
        self.station_id = station_id
        self.ref_epoch = ref_epoch

    @property
    def header_size(self):
        # non-legacy frames carry the 16-byte extended header too; this
        # must match pack()'s framing so fixed-record disk streams of
        # VDIF frames read back aligned (packet_capture DiskReader sizes
        # records as header_size + payload)
        if self.legacy:
            return self.header_struct.size
        return self.header_struct.size + self.ext_struct.size

    def pack(self, desc, framecount=0):
        secs = desc.seq // self.frames_per_second
        fnum = desc.seq % self.frames_per_second
        hdr_len = 16 if self.legacy else 32
        frame_len8 = (hdr_len + len(desc.payload)) // 8
        w0 = (secs & 0x3FFFFFFF) | ((1 << 30) if self.legacy else 0)
        w1 = (fnum & 0xFFFFFF) | ((self.ref_epoch & 0x3F) << 24)
        w2 = (frame_len8 & 0xFFFFFF) | ((self.log2_nchan & 0x1F) << 24)
        w3 = (self.station_id & 0xFFFF) | ((desc.src & 0x3FF) << 16) | \
            (((self.nbit - 1) & 0x1F) << 26) | \
            ((1 << 31) if self.is_complex else 0)
        out = self.header_struct.pack(w0, w1, w2, w3)
        if not self.legacy:
            out += self.ext_struct.pack(0, 0, 0, 0)
        return out + bytes(desc.payload)

    def unpack(self, buf):
        # mirror VDIFDecoder (vdif.hpp:119-168)
        if len(buf) < self.header_struct.size:
            return None
        w0, w1, w2, w3 = self.header_struct.unpack_from(buf)
        if w0 & 0x80000000:           # invalid flag
            return None
        legacy = (w0 >> 30) & 1
        off = self.header_struct.size
        if not legacy:
            off += self.ext_struct.size
            if len(buf) < off:
                return None
        secs = w0 & 0x3FFFFFFF
        fnum = w1 & 0xFFFFFF
        ref_epoch = (w1 >> 24) & 0x3F
        log2_nchan = (w2 >> 24) & 0x1F
        thread_id = (w3 >> 16) & 0x3FF
        nbit = ((w3 >> 26) & 0x1F) + 1
        is_complex = (w3 >> 31) & 1
        pld = buf[off:]
        return PacketDesc(
            seq=secs * self.frames_per_second + fnum,
            time_tag=secs, src=thread_id,
            chan0=1 << log2_nchan, nchan=len(pld) // 8,
            tuning=(ref_epoch << 16) | (nbit << 8) | is_complex,
            payload=pld)

    def decode_batch(self, arr, length=None):
        """Vectorized decode mirroring unpack: the invalid bit rejects
        the row; the legacy bit selects the 16- vs 32-byte payload
        offset.  A batch MIXING legacy and non-legacy framing has no
        single payload offset — raise ValueError so the engine falls
        back to per-packet decode for that batch."""
        w0 = _field(arr, 0, '<u4')
        w1 = _field(arr, 4, '<u4')
        w3 = _field(arr, 12, '<u4')
        legacy = (w0 >> 30) & 1
        if int(legacy.min()) != int(legacy.max()):
            raise ValueError(
                'VDIF batch mixes legacy and non-legacy framing: no '
                'uniform payload offset')
        off = self.header_struct.size + \
            (0 if legacy[0] else self.ext_struct.size)
        seqs = (w0 & 0x3FFFFFFF) * self.frames_per_second + \
            (w1 & 0xFFFFFF)
        srcs = (w3 >> 16) & 0x3FF
        valid = (w0 & 0x80000000) == 0
        return seqs, srcs, int(off), valid


class TbfFormat(_FormatBase):
    """LWA TBF buffered-voltage frames (reference: src/formats/tbf.hpp
    — header-filler only in the reference; decode inverts it).

    Wire header (24 bytes, packed): u32le sync, u32be frame_count_word
    (TBF flag 0x01 in bits 24-31), u32be seconds_count, u16be
    first_chan, u16be nstand, u64be time_tag."""

    name = 'tbf'
    header_struct = struct.Struct('<I')
    _rest = struct.Struct('>IIHHQ')

    @property
    def header_size(self):
        return self.header_struct.size + self._rest.size

    def pack(self, desc, framecount=0):
        # mirror TBFHeaderFiller (tbf.hpp:42-59): 'src' rides first_chan
        fcw = (0x01 << 24) | (framecount & 0xFFFFFF)
        return (self.header_struct.pack(SYNC_WORD) +
                self._rest.pack(fcw, 0, desc.src & 0xFFFF,
                                desc.nsrc & 0xFFFF, desc.seq) +
                bytes(desc.payload))

    def unpack(self, buf):
        if len(buf) < self.header_size:
            return None
        (sync,) = self.header_struct.unpack_from(buf)
        fcw, _secs, first_chan, nstand, time_tag = \
            self._rest.unpack_from(buf, self.header_struct.size)
        if sync != SYNC_WORD:
            return None
        return PacketDesc(seq=time_tag, time_tag=time_tag,
                          src=first_chan, nsrc=nstand, sync=sync,
                          payload=buf[self.header_size:])

    def decode_batch(self, arr, length=None):
        """Vectorized decode mirroring unpack: seq IS the time tag and
        src rides the first_chan field."""
        valid = np.equal(_field_raw(arr, 0, '<u4'),
                         np.uint32(SYNC_WORD))
        return _field(arr, 16, '>u8'), _field(arr, 12, '>u2'), \
            self.header_size, valid


class VBeamFormat(_FormatBase):
    """Voltage-beam frames (reference: src/formats/vbeam.hpp — header
    filler only; the reference fills sync_word + time_tag and zeroes
    the rest).

    Wire header (52 bytes, packed): u64le sync 0xAABBCCDD00000000,
    u64le sync_time, u64be time_tag, f64le bw_hz, f64le sfreq,
    u32le nchan, u32le chan0, u32le npol."""

    name = 'vbeam'
    SYNC = 0xAABBCCDD00000000
    header_struct = struct.Struct('<QQ')
    _mid = struct.Struct('>Q')
    _tail = struct.Struct('<ddIII')

    @property
    def header_size(self):
        return (self.header_struct.size + self._mid.size +
                self._tail.size)

    def pack(self, desc, framecount=0):
        # mirror VBeamHeaderFiller (vbeam.hpp:44-57) + populate the
        # descriptive fields the reference leaves zeroed
        return (self.header_struct.pack(self.SYNC, desc.time_tag) +
                self._mid.pack(desc.seq) +
                self._tail.pack(0.0, 0.0, desc.nchan, desc.chan0,
                                desc.npol) +
                bytes(desc.payload))

    def unpack(self, buf):
        if len(buf) < self.header_size:
            return None
        sync, sync_time = self.header_struct.unpack_from(buf)
        (time_tag,) = self._mid.unpack_from(buf, self.header_struct.size)
        _bw, _sfreq, nchan, chan0, npol = self._tail.unpack_from(
            buf, self.header_struct.size + self._mid.size)
        if sync != self.SYNC:
            return None
        return PacketDesc(seq=time_tag, time_tag=sync_time,
                          nchan=max(nchan, 1), chan0=chan0, npol=npol,
                          payload=buf[self.header_size:])

    def decode_batch(self, arr, length=None):
        """Vectorized decode mirroring unpack: single-source stream,
        seq from the big-endian time tag, gated on the 64-bit sync."""
        valid = np.equal(_field_raw(arr, 0, '<u8'),
                         np.uint64(self.SYNC))
        return _field(arr, 16, '>u8'), np.zeros(len(arr), np.int64), \
            self.header_size, valid


FORMATS = {}


def register_format(cls_or_obj):
    obj = cls_or_obj() if isinstance(cls_or_obj, type) else cls_or_obj
    FORMATS[obj.name] = obj
    return cls_or_obj


for _f in (SimpleFormat, ChipsFormat, PBeamFormat, TbnFormat, DrxFormat,
           IBeamFormat, CorFormat, Snap2Format, VdifFormat, TbfFormat,
           Drx8Format, VBeamFormat):
    register_format(_f)


def get_format(fmt, **kwargs):
    """Look up a format; accepts 'chips', 'chips_64' (with a parameter
    suffix, ignored here), or a format object.  Keyword arguments build
    a fresh parameterized instance (e.g. get_format('cor', nsrc=184))."""
    if not isinstance(fmt, str):
        return fmt
    base = fmt.split('_')[0]
    if base not in FORMATS:
        raise KeyError("Unknown packet format: %r (known: %s)"
                       % (fmt, sorted(FORMATS)))
    if kwargs:
        return type(FORMATS[base])(**kwargs)
    return FORMATS[base]
