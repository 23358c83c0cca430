"""Packet capture engine: UDP/disk packets -> ring, with per-source loss
accounting and sequence-change callbacks.

Architecture mirrors the reference capture stack (reference:
src/packet_capture.hpp:150-607, python/bifrost/packet_capture.py):

- a pluggable *method* supplies raw packets (UDP socket, disk reader)
- the *engine* decodes them with a wire format (io.packet_formats),
  scatters payloads into a sliding window of TWO open ring spans
  (double buffering, reference: packet_capture.hpp:485-534), commits
  the oldest span as the window slides, counts good/missing bytes per
  source, and zero-blanks sources with >50% loss in a span
- a user *sequence callback* builds the ring header when a new
  observation starts (C->Python callback boundary in the reference;
  plain Python here)

Ring frame layout: (time, nsrc, payload_bytes) — the sequence callback's
header tensor must describe the same frame size.  The slot arithmetic is
in bytes: a packed ring (ci4, say) is written through its uint8 storage.

This is the port of ``bifrost_tpu/io/packet_capture.py``.  It writes
into every host ring core of the port: a ``system`` ring on the native
core (``ring_native.NativeRing``, whose buffer the C engine writes), a
``system`` ring on the Python core, and a pinned ``cuda_host`` ring
(whose span views are numpy views of page-locked torch memory, so the
zero-copy scatter lands where ``copy('cuda')`` ships from directly).

Engine choice, with no hidden fallback: ``UDPCapture(...)`` on a native
ring with a format that has a C++ codec is a :class:`NativeUDPCapture`;
its construction raises ``native.NativeError`` when the library does not
build or load, or lacks the engines.  ``BF_NO_NATIVE_CAPTURE=1`` is the
one switch to the Python engine on a native ring (the JAX package falls
back to Python quietly when its library is missing).  A ring on the
Python core takes the Python engine: the C engine writes only into a
native ring's buffer.
"""

from __future__ import annotations

import ctypes
import errno
import os
import select
import socket as socket_mod
import threading
import time as time_mod

import numpy as np

from .packet_formats import get_format, PacketDesc
from ..ring import RingWriter

__all__ = ['PacketCaptureCallback', 'UDPCapture', 'NativeUDPCapture',
           'ShardedUDPCapture', 'UDPSniffer', 'DiskReader',
           'CAPTURE_STARTED', 'CAPTURE_CONTINUED', 'CAPTURE_ENDED',
           'CAPTURE_NO_DATA', 'CAPTURE_INTERRUPTED']

CAPTURE_STARTED = 1
CAPTURE_CONTINUED = 2
CAPTURE_ENDED = 4
CAPTURE_NO_DATA = 8
CAPTURE_INTERRUPTED = 16


class PacketCaptureCallback(object):
    """Holds per-format sequence callbacks (reference:
    python/bifrost/packet_capture.py:45-89).  A callback is
    ``fn(desc: PacketDesc) -> (time_tag, header_dict)``."""

    def __init__(self):
        self._callbacks = {}

    def __getattr__(self, name):
        if name.startswith('set_'):
            fmt = name[4:]

            def setter(fn):
                self._callbacks[fmt] = fn
            return setter
        raise AttributeError(name)

    def get(self, fmt_name):
        return self._callbacks.get(fmt_name)


class _PacketCapture(object):
    def __init__(self, fmt, ring, nsrc, src0, max_payload_size,
                 buffer_ntime, slot_ntime, sequence_callback, core=None):
        self.nsrc = int(np.prod(nsrc)) if not np.isscalar(nsrc) else nsrc
        # 'cor' decoding depends on the source count (it sets the stand
        # count used to compose baseline indices, reference cor.hpp:74);
        # parameterize the codec with the engine's nsrc.  Other
        # parameterized codecs (TbnFormat(decimation=...)) are passed in
        # as format objects.
        if isinstance(fmt, str) and fmt.split('_')[0] == 'cor':
            self.fmt = get_format('cor', nsrc=self.nsrc)
        else:
            self.fmt = get_format(fmt)
        self.ring = ring
        if getattr(self.fmt, 'applies_src0', False):
            # pbeam/cor apply src0 in composed (beam/baseline) units
            # inside the decoder, like the reference (pbeam.hpp:70,
            # cor.hpp:77); the engine must not rebase again.  Copy the
            # codec first: get_format() may hand back the shared
            # registry singleton.  A src0 already configured on a
            # passed-in format object wins over the engine default 0;
            # conflicting nonzero values are an error.
            import copy as _copy
            fmt_src0 = getattr(self.fmt, 'src0', 0)
            if src0 and fmt_src0 and src0 != fmt_src0:
                raise ValueError(
                    "conflicting src0: capture got %d but the %s codec "
                    "was built with src0=%d" % (src0, self.fmt.name,
                                                fmt_src0))
            self.fmt = _copy.copy(self.fmt)
            self.fmt.src0 = src0 or fmt_src0
            src0 = 0
        self.src0 = src0
        self.payload_size = max_payload_size
        self.buffer_ntime = buffer_ntime
        self.slot_ntime = slot_ntime
        self.callback = sequence_callback.get(self.fmt.name) \
            if isinstance(sequence_callback, PacketCaptureCallback) \
            else sequence_callback
        self.core = core
        self._writer = None
        self._wseq = None
        self._seq0 = None
        self._bufs = []          # [(start_seq, WriteSpan, view, got_mask)]
        # loss ledger: nignored is kept as the historical aggregate and
        # always equals nlate + nalien (late = seq behind the window or
        # before seq0; alien = src outside [src0, src0+nsrc))
        self.stats = {'ngood_bytes': 0, 'nmissing_bytes': 0,
                      'nignored': 0, 'ninvalid': 0,
                      'nlate': 0, 'nalien': 0, 'ndup': 0, 'nreceived': 0,
                      'src_ngood': np.zeros(self.nsrc, np.int64)}
        # one lock serializes all window/ledger state; recvmmsg and
        # header decode run outside it.  RLock: _process_one nests
        # inside _ingest_batch's critical section on mixed batches.
        self._lock = threading.RLock()
        self._claim_cv = threading.Condition(self._lock)
        self._commit_cv = threading.Condition(self._lock)
        self._claims = {}        # span start -> in-flight zero-copy claims
        self._ncommits = 0
        self._max_seq = None     # highest seq seen (reorder-depth ref)
        self._raw_stride = max_payload_size + 1024
        self._reorder_hist = 'capture.%s.reorder_depth' % ring.name
        from ..proclog import ProcLog
        self._stats_proclog = ProcLog('%s_capture/stats' % ring.name)

    # -- method interface --------------------------------------------------
    def _recv_packet(self):
        raise NotImplementedError

    # -- engine ------------------------------------------------------------
    def _begin_sequence(self, desc):
        if self._writer is None:
            self._writer = RingWriter(self.ring)
        time_tag, hdr = self.callback(desc)
        hdr.setdefault('time_tag', time_tag)
        hdr.setdefault('name', hdr.get('name', 'capture-%d' % time_tag))
        # downstream pipeline blocks size their gulps from the header
        hdr.setdefault('gulp_nframe', self.buffer_ntime)
        # stamp cumulative capture loss into _overload so it rides the
        # same shed-accounting channel ring.py merges writer-side
        # (nonzero on sequence restarts after a gapped stream)
        stamp = dict(hdr.get('_overload') or {})
        stamp.update({
            'capture_missing_bytes': int(self.stats['nmissing_bytes']),
            'capture_late': int(self.stats['nlate']),
            'capture_alien': int(self.stats['nalien']),
            'capture_invalid': int(self.stats['ninvalid'])})
        hdr['_overload'] = stamp
        self._wseq = self._writer.begin_sequence(
            hdr, gulp_nframe=self.buffer_ntime,
            buf_nframe=4 * self.buffer_ntime)
        self._seq0 = (desc.seq // self.slot_ntime) * self.slot_ntime
        self._bufs = []
        self._committed_end = 0

    def _open_buf(self, start):
        span = self._wseq.reserve(self.buffer_ntime)
        view = span.data.as_numpy().view(np.uint8).reshape(
            self.buffer_ntime, self.nsrc, -1)
        # NOTE: no view[...] = 0 here — only the cells still missing at
        # commit get blanked (from the got-mask complement), so the hot
        # path never touches bytes a packet is about to overwrite
        got = np.zeros((self.buffer_ntime, self.nsrc), bool)
        self._bufs.append((start, span, view, got))

    def _span_retirable(self, start):
        """Whether the head span may retire now (engine lock held).
        The sharded engine overrides this with bounded-skew
        backpressure; the single-threaded engines always say yes."""
        return True

    def _commit_oldest(self):
        # zero-copy claims pin a span against commit; cv.wait drops
        # the engine lock, so several workers can be in here at once.
        # Each call retires AT MOST the span that was head at entry:
        # if the head moved while we waited, a sibling already retired
        # it and popping again would empty (and then restart!) the
        # window.
        if not self._bufs:
            return
        target = self._bufs[0][0]
        deadline = None
        while self._bufs and self._bufs[0][0] == target:
            if self._claims.get(target, 0):
                self._claim_cv.wait()
                continue
            if not self._span_retirable(target):
                # give lagging zero-copy workers a short grace to fill
                # this span before retiring it (their queued packets
                # would otherwise all turn into late drops); the bound
                # keeps a stalled flow from wedging the window
                now = time_mod.monotonic()
                if deadline is None:
                    deadline = now + 0.05
                if now < deadline:
                    self._claim_cv.wait(deadline - now)
                    continue
            break
        if not self._bufs or self._bufs[0][0] != target:
            return
        start, span, view, got = self._bufs.pop(0)
        self._committed_end = start + self.buffer_ntime
        # blank ONLY what was missed: per-span zero-fill is gone, so
        # never-written cells hold stale ring bytes until this point
        miss_t, miss_s = np.nonzero(~got)
        if miss_t.size:
            view[miss_t, miss_s, :] = 0
        # per-source loss accounting + >50%-loss blanking
        # (reference: packet_capture.hpp:505-534)
        pkt_bytes = self.payload_size
        ngood_col = got.sum(axis=0).astype(np.int64)
        self.stats['src_ngood'] += ngood_col * pkt_bytes
        ngood = int(ngood_col.sum())
        self.stats['ngood_bytes'] += ngood * pkt_bytes
        self.stats['nmissing_bytes'] += \
            (self.buffer_ntime * self.nsrc - ngood) * pkt_bytes
        for src in np.nonzero(ngood_col * 2 < self.buffer_ntime)[0]:
            view[:, src] = 0   # blank unreliable source
        span.commit(self.buffer_ntime)
        span.close()
        self._ncommits += 1
        self._commit_cv.notify_all()
        self._stats_proclog.update(self._stats_snapshot())

    def _stats_snapshot(self):
        st = self.stats
        d = {'ngood_bytes': st['ngood_bytes'],
             'nmissing_bytes': st['nmissing_bytes'],
             'ninvalid': st['ninvalid'],
             'nignored': st['nignored'],
             'nlate': st['nlate'],
             'nalien': st['nalien'],
             'ndup': st['ndup'],
             'nreceived': st['nreceived'],
             'npackets': st['ngood_bytes'] // self.payload_size}
        for i, w in enumerate(getattr(self, '_wstats', ()) or ()):
            d['worker%d_npackets' % i] = w['npackets']
            d['worker%d_nbytes' % i] = w['nbytes']
            d['worker%d_zero_copy' % i] = w['zero_copy']
        return d

    def _ensure_window(self, off):
        """Slide/open spans (engine lock held) until ``off`` lies below
        the window end.  Returns True if any span was committed."""
        committed = False
        while True:
            if self._bufs:
                last_end = self._bufs[-1][0] + self.buffer_ntime
            else:
                # empty window mid-stream (flush, or every span just
                # retired): NEVER restart from 0 — resume at the
                # committed high-water mark, jumping forward to the
                # span holding ``off`` if the stream skipped ahead
                last_end = max(
                    getattr(self, '_committed_end', 0),
                    off // self.buffer_ntime * self.buffer_ntime)
            if self._bufs and off < last_end:
                return committed
            if len(self._bufs) == 2:
                self._commit_oldest()   # may drop the lock on claim waits
                committed = True
                continue                # re-derive: window may have moved
            self._open_buf(last_end)

    def _note_seqs(self, seqs):
        """Track the highest seq seen and feed the reorder-depth
        histogram (how far behind the running max each arrival is)."""
        if not len(seqs):
            return
        prev = self._max_seq
        if prev is None:
            self._max_seq = int(seqs.max())
            return
        seqs = np.asarray(seqs, np.int64)
        run = np.maximum.accumulate(
            np.concatenate(([prev], seqs)))[:-1]
        depths = run - seqs
        from ..telemetry import histograms
        for d in depths[depths > 0][:32]:      # bound the slow path
            histograms.observe(self._reorder_hist, int(d))
        self._max_seq = max(prev, int(seqs.max()))

    # -- vectorized batch path (recvmmsg + decode_batch formats) -----------
    def _assign_batch(self, offs, srcs, payloads, rows=None):
        """Scatter a decoded batch into the open window, sliding it as
        needed.  ``offs``/``srcs`` are compact (already filtered);
        ``rows`` maps them back to rows of ``payloads`` so the gather +
        span write is the only payload copy.  Returns True if any span
        was committed."""
        committed = False
        if rows is None:
            rows = np.arange(len(offs))
        pw = payloads.shape[1]
        remaining = np.ones(len(offs), bool)
        while remaining.any():
            last_end = (self._bufs[-1][0] + self.buffer_ntime) \
                if self._bufs else 0
            beyond = remaining & (offs >= last_end)
            in_window = remaining & (offs < last_end)
            idx = np.nonzero(in_window)[0]
            if idx.size:
                o = offs[idx]
                for start, span, view, got in self._bufs:
                    m = (o >= start) & (o < start + self.buffer_ntime)
                    if m.any():
                        sel = idx[m]
                        ts = offs[sel] - start
                        ss = srcs[sel]
                        ndup = int(got[ts, ss].sum())
                        if ndup:
                            self.stats['ndup'] += ndup
                        view[ts, ss, :pw] = payloads[rows[sel]]
                        if pw < view.shape[2]:
                            view[ts, ss, pw:] = 0   # stale lane tails
                        got[ts, ss] = True
                if self._bufs:
                    nlate = int((o < self._bufs[0][0]).sum())
                    if nlate:
                        self.stats['nlate'] += nlate
                        self.stats['nignored'] += nlate
                remaining[idx] = False
            if beyond.any():
                # slide ONLY to the nearest out-of-window offset: jumping
                # straight to the batch max would retire the intermediate
                # spans before this batch's packets landed in them
                # (anything still pending would then misclassify as late)
                committed |= self._ensure_window(int(offs[beyond].min()))
            elif not idx.size:
                break
        return committed

    def _recv_batched(self):
        """recv() over whole recvmmsg batches with vectorized header
        decode — the per-packet Python cost (struct.unpack + slice +
        scatter) collapses into a handful of numpy ops per batch."""
        started = False
        committed = False
        while not committed:
            raw, lengths = self._recv_raw_batch()
            if raw is None:
                return CAPTURE_NO_DATA if self._seq0 is None \
                    else CAPTURE_INTERRUPTED
            s, c = self._ingest_batch(raw, lengths)
            started = started or s
            committed = committed or c
        return CAPTURE_STARTED if started else CAPTURE_CONTINUED

    def _ingest_batch(self, raw, lengths, wstat=None, info=None):
        """Decode one recvmmsg batch (outside the lock) and scatter it
        into the window (under the lock).  ``wstat`` is an optional
        per-worker counter dict; ``info`` an optional out-dict filled
        with the batch's in-range srcs + max seq (used by sharded
        workers to learn their flow for zero-copy engagement).
        Returns (started, committed)."""
        n = len(lengths)
        stride = self._raw_stride
        arr = np.frombuffer(raw, np.uint8,
                            count=n * stride).reshape(n, stride)
        if wstat is not None:
            wstat['npackets'] += n
            wstat['nbytes'] += int(sum(lengths))
        started = committed = False
        fallback = len(set(lengths)) != 1
        ok = seqs = srcs = hoff = None
        if not fallback:
            if lengths[0] < self.fmt.header_size:
                with self._lock:
                    self.stats['nreceived'] += n
                    self.stats['ninvalid'] += n     # runts
                return False, False
            try:
                out = self.fmt.decode_batch(arr, lengths[0])
            except ValueError:
                # e.g. a VDIF batch mixing legacy/non-legacy framing
                fallback = True
            else:
                seqs, srcs, hoff = out[:3]
                fvalid = out[3] if len(out) > 3 else None
                ok = np.ones(n, bool) if fvalid is None \
                    else np.asarray(fvalid, bool).copy()
        if fallback:
            # mixed sizes / undecodable batch: per-packet slow path
            # over zero-copy slices of the raw buffer
            for i in range(n):
                s, c = self._process_one(
                    raw[i * stride:i * stride + lengths[i]])
                started = started or s
                committed = committed or c
            return started, committed
        srcs = srcs - self.src0
        in_range = (srcs >= 0) & (srcs < self.nsrc)
        with self._lock:
            self.stats['nreceived'] += n
            ninvalid = n - int(ok.sum())
            if ninvalid:
                self.stats['ninvalid'] += ninvalid
            nalien = int((ok & ~in_range).sum())
            if nalien:
                self.stats['nalien'] += nalien
                self.stats['nignored'] += nalien
            ok &= in_range
            if not ok.any():
                return False, False
            if self._seq0 is None:
                first = int(np.nonzero(ok)[0][0])
                desc = self.fmt.unpack(bytes(arr[first, :lengths[first]]))
                if desc is None:
                    self.stats['ninvalid'] += 1
                    return False, False
                desc.src -= self.src0
                self._begin_sequence(desc)
                started = True
            keep = np.nonzero(ok)[0]
            kseqs = seqs[keep].astype(np.int64)
            self._note_seqs(kseqs)
            if info is not None:
                info['srcs'] = np.unique(srcs[keep])
                info['max_seq'] = int(kseqs.max())
            offs = kseqs - self._seq0
            fresh = offs >= 0
            nlate = int((~fresh).sum())
            if nlate:
                self.stats['nlate'] += nlate
                self.stats['nignored'] += nlate
            if not fresh.any():
                return started, False
            payloads = arr[:, hoff:lengths[0]]
            committed = self._assign_batch(
                offs[fresh], srcs[keep[fresh]].astype(np.int64),
                payloads, keep[fresh])
        return started, committed

    def _recv_raw_batch(self):
        return None, None       # only UDPCapture implements this

    def _process_one(self, pkt):
        """Single-packet slow path used by recv() and mixed batches."""
        desc = self.fmt.unpack(pkt)
        with self._lock:
            self.stats['nreceived'] += 1
            if desc is None or desc.valid_mode:
                # reference decoders gate on valid_mode (tbn.hpp:64,
                # drx.hpp:64); the native engine does the same
                self.stats['ninvalid'] += 1
                return False, False
            desc.src -= self.src0
            if desc.src < 0 or desc.src >= self.nsrc:
                self.stats['nalien'] += 1
                self.stats['nignored'] += 1
                return False, False
            started = False
            if self._seq0 is None:
                self._begin_sequence(desc)
                started = True
            self._note_seqs(np.asarray([desc.seq], np.int64))
            off = desc.seq - self._seq0
            if off < 0:
                self.stats['nlate'] += 1
                self.stats['nignored'] += 1
                return started, False
            committed = self._ensure_window(off)
            for start, span, view, got in self._bufs:
                if start <= off < start + self.buffer_ntime:
                    t = off - start
                    payload = np.frombuffer(desc.payload, np.uint8)
                    if got[t, desc.src]:
                        self.stats['ndup'] += 1
                    view[t, desc.src, :len(payload)] = payload
                    if len(payload) < view.shape[2]:
                        view[t, desc.src, len(payload):] = 0
                    got[t, desc.src] = True
                    break
                elif off < start:
                    self.stats['nlate'] += 1
                    self.stats['nignored'] += 1   # too late
                    break
            return started, committed

    def recv(self):
        """Process packets until one buffer's worth of time has been
        committed (reference: bfPacketCaptureRecv)."""
        if getattr(self, '_use_batch', False):
            return self._recv_batched()
        started = False
        committed = False
        while not committed:
            pkt = self._recv_packet()
            if pkt is None:
                return CAPTURE_NO_DATA if self._seq0 is None \
                    else CAPTURE_INTERRUPTED
            s, c = self._process_one(pkt)
            started = started or s
            committed = committed or c
        return CAPTURE_STARTED if started else CAPTURE_CONTINUED

    def flush(self):
        with self._lock:
            # Trim trailing speculative spans first: a zero-copy claim
            # may have opened a span purely on seq prediction (the
            # readable packet turned out late/alien, so nothing ever
            # landed).  An all-empty unclaimed TRAILING span holds no
            # evidence its seqs exist on the wire — drop the
            # reservation (zero-frame commit) rather than publish a
            # phantom all-missing span that breaks the
            # good+missing == window-covered ledger identity.
            while (self._bufs and not self._bufs[-1][3].any()
                   and not self._claims.get(self._bufs[-1][0], 0)):
                _, span, _, _ = self._bufs.pop()
                span.commit(0)
                span.close()
            while self._bufs:
                self._commit_oldest()

    def end(self):
        self.flush()
        with self._lock:
            # final cumulative stats must land regardless of throttling
            self._stats_proclog.update(self._stats_snapshot(), force=True)
            if self._wseq is not None:
                self._wseq.end()
                self._wseq = None
            if self._writer is not None:
                self.ring.end_writing()
                self._writer = None
            self._seq0 = None
        return CAPTURE_ENDED

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.end()


#: wire formats with a native C++ decoder (native/capture.cpp);
#: ids must match the FMT_* enum there
NATIVE_FMT_IDS = {'simple': 0, 'chips': 1, 'tbn': 2, 'drx': 3,
                  'drx8': 4, 'ibeam': 5, 'cor': 6, 'pbeam': 7,
                  'snap2': 8, 'vdif': 9, 'tbf': 10, 'vbeam': 11}
#: formats the native TRANSMIT engine can fill headers for
NATIVE_TX_FMT_IDS = dict(NATIVE_FMT_IDS)


def native_io_usable(fmt, sock, fmt_ids=None):
    """Whether a native I/O engine applies: ``BF_NO_NATIVE_CAPTURE`` is
    unset, the format has a C++ codec and the socket a file descriptor.
    The library is not consulted here: the engine's constructor loads it,
    and a build or load that fails, or a library without the engines,
    raises there instead of falling back to Python."""
    if os.environ.get('BF_NO_NATIVE_CAPTURE'):
        return False
    base = fmt.split('_')[0] if isinstance(fmt, str) else \
        getattr(fmt, 'name', None)
    ids = NATIVE_FMT_IDS if fmt_ids is None else fmt_ids
    return base in ids and hasattr(sock, 'fileno')


def _native_capture_usable(fmt, sock, ring):
    from ..ring_native import NativeRing
    return isinstance(ring, NativeRing) and native_io_usable(fmt, sock)


def load_io_engines():
    """The native library for the capture and transmit engines; raises
    ``NativeError`` when it is switched off (``BF_NO_NATIVE``), fails to
    build or load, or was built without the engines."""
    from .. import native as native_mod
    lib = native_mod.load()
    if lib is None:
        raise native_mod.NativeError(
            "native I/O engine asked for with BF_NO_NATIVE set; set "
            "BF_NO_NATIVE_CAPTURE=1 for the Python engines")
    if not native_mod.io_engine_supported():
        raise native_mod.NativeError(
            "the native library was built without the capture and "
            "transmit engines (they need Linux recvmmsg/sendmmsg)")
    return lib


class UDPCapture(_PacketCapture):
    """Capture packets from a UDP socket (reference:
    bfUdpCaptureCreate, src/packet_capture.cpp:324).

    Dispatch: when the ring is native and the format has a C++ decoder,
    construction returns a :class:`NativeUDPCapture` — the whole
    recv/decode/scatter loop runs in native/capture.cpp like the
    reference engine, and a library that cannot be had raises
    (BF_NO_NATIVE_CAPTURE=1 selects Python; module docstring).
    The Python engine uses recvmmsg batching + vectorized decode when
    the socket and format support it, per-packet recv otherwise."""

    BATCH = 128

    def __new__(cls, fmt=None, sock=None, ring=None, *args, **kwargs):
        if cls is UDPCapture and _native_capture_usable(fmt, sock, ring):
            return super(UDPCapture, cls).__new__(NativeUDPCapture)
        return super(UDPCapture, cls).__new__(cls)

    def __init__(self, fmt, sock, ring, nsrc, src0, max_payload_size,
                 buffer_ntime, slot_ntime, sequence_callback, core=None,
                 batch=None):
        super(UDPCapture, self).__init__(
            fmt, ring, nsrc, src0, max_payload_size, buffer_ntime,
            slot_ntime, sequence_callback, core)
        self.sock = sock
        self.batch = batch or self.BATCH
        self._pending = []
        self._pending_idx = 0
        self._use_mmsg = hasattr(sock, 'recv_mmsg')
        # fully-vectorized path: recvmmsg raw buffer + batch header
        # decode (formats that define decode_batch)
        self._raw_stride = max_payload_size + 1024
        self._use_batch = (hasattr(sock, 'recv_mmsg_raw') and
                           hasattr(self.fmt, 'decode_batch'))

    def _recv_raw_batch(self):
        return self.sock.recv_mmsg_raw(self.batch, self._raw_stride)

    def _recv_plain(self):
        from .udp_socket import UDPSocket, retry_transient
        try:
            # retry_transient handles EINTR/ECONNREFUSED with capped
            # backoff (telemetry: io.socket_retries) — a briefly
            # restarting peer must not kill a long-running capture.
            # UDPSocket.recv already retries internally; wrapping it
            # again would square the retry budget, so only plain
            # socket objects handed to the capture get the wrapper.
            if isinstance(self.sock, UDPSocket):
                return self.sock.recv(self.payload_size + 1024)
            return retry_transient(
                lambda: self.sock.recv(self.payload_size + 1024))
        except (socket_mod.timeout, TimeoutError):
            return None
        except OSError as e:
            if e.errno in (errno.EAGAIN, errno.EWOULDBLOCK):
                return None
            raise

    def _recv_packet(self):
        if not self._use_mmsg:
            return self._recv_plain()
        if self._pending_idx >= len(self._pending):
            try:
                batch = self.sock.recv_mmsg(self.batch,
                                            self.payload_size + 1024)
            except (OSError, AttributeError):
                self._use_mmsg = False
                return self._recv_plain()
            if not batch:
                return None
            self._pending = batch
            self._pending_idx = 0
        pkt = self._pending[self._pending_idx]
        self._pending_idx += 1
        return pkt


class _BftPktDesc(ctypes.Structure):
    # mirrors bft_pkt_desc in native/capture.cpp
    _fields_ = [('seq', ctypes.c_longlong),
                ('time_tag', ctypes.c_longlong),
                ('src', ctypes.c_int),
                ('nsrc', ctypes.c_int),
                ('nchan', ctypes.c_int),
                ('chan0', ctypes.c_int),
                ('tuning', ctypes.c_int),
                ('tuning1', ctypes.c_int),
                ('gain', ctypes.c_int),
                ('decimation', ctypes.c_int),
                ('beam', ctypes.c_int),
                ('npol', ctypes.c_int),
                ('npol_tot', ctypes.c_int),
                ('pol0', ctypes.c_int),
                ('nchan_tot', ctypes.c_int),
                ('payload_size', ctypes.c_int)]


class NativeUDPCapture(UDPCapture):
    """UDP capture driven end-to-end by the native engine
    (native/capture.cpp): recvmmsg batches, C++ header decode, scatter
    straight into the native ring's buffer, loss accounting and
    blanking — the reference's capture-thread architecture
    (src/packet_capture.hpp:150-607).  Python is entered only once per
    sequence to build the ring header (the same C->Python callback
    boundary the reference has).

    The C engine reserves and commits through the ring's C core, past
    the port's span wrappers.  So that the Python side still sees those
    commits, each ``recv``, ``flush`` and ``end`` counts the spans the
    core's head moved by on ``ring.<name>.gulps``, the ring's
    ``occupancy()`` reports the end of writing, and the ring checker
    (``BF_RINGCHECK``) takes its committed head from the core at each
    acquire (``NativeRing._external_writer``)."""

    def __init__(self, fmt, sock, ring, nsrc, src0, max_payload_size,
                 buffer_ntime, slot_ntime, sequence_callback, core=None,
                 batch=None):
        import json
        from .. import native as native_mod
        # shared setup (format/callback resolution, counters, proclog)
        _PacketCapture.__init__(self, fmt, ring, nsrc, src0,
                                max_payload_size, buffer_ntime,
                                slot_ntime, sequence_callback, core)
        self.sock = sock
        self._lib = load_io_engines()
        self._cb_error = None
        handle = ctypes.c_void_p()
        # composed-src formats (pbeam/cor) apply src0 in the C decoder
        # in beam/baseline units; the base init has already folded the
        # engine src0 into the codec, so forward the codec's value
        if getattr(self.fmt, 'applies_src0', False):
            src0 = int(self.fmt.src0)
        native_mod.check(self._lib.bft_capture_create(
            ctypes.byref(handle), NATIVE_FMT_IDS[self.fmt.name],
            sock.fileno(), ring._handle, self.nsrc, src0,
            max_payload_size, buffer_ntime, slot_ntime), 'capture')
        self._handle = handle
        if getattr(self.fmt, 'decimation', None):
            # TBN derives seq from time_tag via the stream decimation
            self._lib.bft_capture_set_decimation(
                handle, int(self.fmt.decimation))
        elif getattr(self.fmt, 'frames_per_second', None):
            # VDIF: seq = secs * fps + frame; fps rides the same slot
            self._lib.bft_capture_set_decimation(
                handle, int(self.fmt.frames_per_second))
        self._applied_timeout = object()     # force first sync
        self._sync_timeout()

        CB = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p,
                              ctypes.POINTER(_BftPktDesc),
                              ctypes.POINTER(ctypes.c_longlong),
                              ctypes.POINTER(ctypes.c_char),
                              ctypes.c_int,
                              ctypes.POINTER(ctypes.c_char),
                              ctypes.c_int)

        def header_cb(user, desc_p, time_tag_out, name_buf, name_cap,
                      hdr_buf, hdr_cap):
            try:
                d = desc_p.contents
                desc = PacketDesc(seq=d.seq, src=d.src, nsrc=d.nsrc,
                                  nchan=d.nchan, chan0=d.chan0,
                                  time_tag=d.time_tag, tuning=d.tuning,
                                  tuning1=d.tuning1, gain=d.gain,
                                  decimation=max(d.decimation, 1),
                                  beam=d.beam, npol=d.npol,
                                  npol_tot=d.npol_tot, pol0=d.pol0,
                                  nchan_tot=d.nchan_tot)
                time_tag, hdr = self.callback(desc)
                hdr.setdefault('time_tag', time_tag)
                hdr.setdefault('name', 'capture-%d' % time_tag)
                hdr.setdefault('gulp_nframe', self.buffer_ntime)
                # the C engine begins writing after this call returns
                with self.ring._lock:
                    self.ring._eod = False
                name = str(hdr['name']).encode()[:name_cap - 1]
                ctypes.memmove(name_buf, name + b'\x00', len(name) + 1)
                raw = json.dumps(hdr).encode()
                if len(raw) + 1 > hdr_cap:
                    raise ValueError("header JSON too large")
                ctypes.memmove(hdr_buf, raw + b'\x00', len(raw) + 1)
                time_tag_out[0] = time_tag
                return 0
            except BaseException as e:
                # surfaced by the next recv() on the Python side
                self._cb_error = e
                return -1

        self._cb = CB(header_cb)     # keep a reference alive
        self._lib.bft_capture_set_header_callback(
            handle, ctypes.cast(self._cb, ctypes.c_void_p), None)
        self.stats = _NativeCaptureStats(self)
        ring._external_writer = True
        self._span_nbyte = self.buffer_ntime * self.nsrc * max_payload_size
        self._seen_head = ring._tail_head()[1]

    def _note_commits(self):
        """Count the spans the C core committed since the last call on
        ``ring.<name>.gulps`` (one span is one gulp of the header's
        ``gulp_nframe``)."""
        head = self.ring._tail_head()[1]
        n = (head - self._seen_head) // self._span_nbyte
        if n > 0:
            from ..telemetry import counters
            counters.inc('ring.%s.gulps' % self.ring.name, n)
            self._seen_head += n * self._span_nbyte

    def _sync_timeout(self):
        """Mirror the socket's (possibly updated) timeout into the
        native poll: None = block like the Python engine's select."""
        t = getattr(self.sock, '_timeout', None)
        if t != self._applied_timeout:
            self._lib.bft_capture_set_timeout_ms(
                self._handle, -1 if t is None else max(int(t * 1000), 1))
            self._applied_timeout = t

    def recv(self):
        from .. import native as native_mod
        self._sync_timeout()
        status = ctypes.c_int(0)
        native_mod.check(self._lib.bft_capture_recv(
            self._handle, ctypes.byref(status)), 'recv')
        self._note_commits()
        if self._cb_error is not None:
            err, self._cb_error = self._cb_error, None
            raise err
        if status.value in (CAPTURE_STARTED, CAPTURE_CONTINUED):
            st = self.stats._read()
            st['npackets'] = st.get('ngood_bytes', 0) // \
                self.payload_size
            self._stats_proclog.update({
                k: v for k, v in st.items() if k != 'src_ngood'})
        return status.value

    def flush(self):
        self._lib.bft_capture_flush(self._handle)
        self._note_commits()

    def end(self):
        self._lib.bft_capture_end(self._handle)
        self._note_commits()
        with self.ring._lock:
            self.ring._eod = True
        st = self.stats._read()
        st['npackets'] = st.get('ngood_bytes', 0) // self.payload_size
        self._stats_proclog.update(
            {k: v for k, v in st.items() if k != 'src_ngood'},
            force=True)
        return CAPTURE_ENDED

    def __del__(self):
        try:
            if getattr(self, '_handle', None) is not None:
                self._lib.bft_capture_destroy(self._handle)
                self._handle = None
        except Exception:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.end()


class _NativeCaptureStats(object):
    """Read-through view of the native engine's counters, dict-like to
    match the Python engine's ``stats``."""

    def __init__(self, cap):
        self._cap = cap

    def _read(self):
        ll = ctypes.c_longlong
        g, m, iv, ig = ll(0), ll(0), ll(0), ll(0)
        self._cap._lib.bft_capture_stats(
            self._cap._handle, ctypes.byref(g), ctypes.byref(m),
            ctypes.byref(iv), ctypes.byref(ig))
        src = (ll * self._cap.nsrc)()
        self._cap._lib.bft_capture_src_ngood(
            self._cap._handle, src, self._cap.nsrc)
        return {'ngood_bytes': g.value, 'nmissing_bytes': m.value,
                'ninvalid': iv.value, 'nignored': ig.value,
                'src_ngood': np.asarray(list(src), np.int64)}

    def __getitem__(self, key):
        return self._read()[key]

    def get(self, key, default=None):
        return self._read().get(key, default)

    def __repr__(self):
        return repr(self._read())


class ShardedUDPCapture(_PacketCapture):
    """N-worker sharded UDP capture: worker threads drain private
    ``SO_REUSEPORT`` socket queues (or dup()s of one shared queue when
    REUSEPORT is unavailable), each pinned through affinity.py, all
    scattering into the SAME double-buffered span window under one
    engine lock — per-source loss accounting and the >50%-blanking
    protocol stay exactly as exact as the single-thread engine's
    (the JAX package's docs/networking.md, "Wire-rate capture").

    Zero-copy scatter engages per worker when every condition holds:

    - the format has a fixed frame size (``fmt.frame_size`` or the
      ``frame_size`` hint) and a ``decode_batch``,
    - the frame's payload fits the ring lane,
    - the worker's queue is exclusive (REUSEPORT mode, or a single
      worker), and
    - the worker has learned its flow: REUSEPORT hashes datagrams per
      5-tuple, so a staged batch showing exactly one in-range source
      means this worker owns that source's stream.

    An engaged worker claims its source's next expected span cells
    (claims pin spans against commit), points ``recvmmsg`` split
    iovecs at them (header -> sidecar, payload -> cell), consumes
    nonblockingly, and verifies the decoded headers against the
    prediction — misses are repaired per packet (bounce-copy to the
    true cell) and the worker falls back to the staged
    one-vectorized-copy path until the flow looks clean again.

    Construction: pass an :class:`.udp_socket.Address` to let the
    engine create + bind its worker sockets (REUSEPORT mode), or an
    already-bound socket to shard it across threads."""

    def __init__(self, fmt, addr_or_sock, ring, nsrc, src0,
                 max_payload_size, buffer_ntime, slot_ntime,
                 sequence_callback, core=None, nthreads=None,
                 vlen=None, zero_copy=None, frame_size=None,
                 cores=None, timeout=0.25):
        super(ShardedUDPCapture, self).__init__(
            fmt, ring, nsrc, src0, max_payload_size, buffer_ntime,
            slot_ntime, sequence_callback, core)
        env = os.environ
        if nthreads is None:
            nthreads = int(env.get('BF_CAPTURE_THREADS', '') or 2)
        if vlen is None:
            vlen = int(env.get('BF_CAPTURE_VLEN', '') or 64)
        if zero_copy is None:
            zero_copy = env.get('BF_CAPTURE_ZERO_COPY', '1') != '0'
        self.nthreads = max(int(nthreads), 1)
        self.vlen = max(min(int(vlen), self.buffer_ntime), 1)
        self._timeout = timeout

        from .udp_socket import UDPSocket, Address
        self._own_socks = []
        if hasattr(addr_or_sock, 'sockaddr'):     # an Address
            first = UDPSocket(reuseport=True).bind(addr_or_sock)
            self._own_socks.append(first)
            socks = [first]
            if first.reuseport:
                # siblings bind the RESOLVED port (addr.port may be 0)
                port = first.sock.getsockname()[1]
                sib = Address(addr_or_sock.address, port) \
                    if port != addr_or_sock.port else addr_or_sock
                for _ in range(self.nthreads - 1):
                    s = UDPSocket(reuseport=True).bind(sib)
                    self._own_socks.append(s)
                    socks.append(s)
            else:
                for _ in range(self.nthreads - 1):
                    s = UDPSocket.from_fd(first.fileno())
                    self._own_socks.append(s)
                    socks.append(s)
            self._exclusive = first.reuseport or self.nthreads == 1
        else:
            base = addr_or_sock
            self.sock = base                       # caller still owns it
            if hasattr(base, 'recv_mmsg_raw'):
                socks = [base]
            else:
                w = UDPSocket.from_fd(base.fileno())
                self._own_socks.append(w)
                socks = [w]
            for _ in range(self.nthreads - 1):
                s = UDPSocket.from_fd(base.fileno())
                self._own_socks.append(s)
                socks.append(s)
            self._exclusive = self.nthreads == 1
        self._socks = socks
        for s in self._socks:
            s.set_timeout(timeout)

        # Deterministic source steering: when the wire format carries a
        # single-byte source id (chips' leading roach byte), a classic
        # BPF on the REUSEPORT group routes worker = (id - bias) & mask
        # over the UDP payload, pinning each source's stream to ONE
        # worker queue regardless of sender ports.  Without it the
        # kernel's 4-tuple hash may pile several sources onto one
        # worker (zero-copy then can't engage) — steering makes the
        # flow-learning deterministic.  Power-of-two worker counts
        # only (classic BPF has AND but no modulus).
        steer = getattr(self.fmt, 'SRC_STEER_BYTE', None)
        self._steered = False
        if (steer is not None and self.nthreads > 1 and
                getattr(socks[0], 'reuseport', False) and
                self.nthreads & (self.nthreads - 1) == 0 and
                hasattr(socks[0], 'attach_reuseport_cbpf')):
            off, bias = steer
            try:
                socks[0].attach_reuseport_cbpf([
                    (0x30, 0, 0, off),             # ldb payload[off]
                    (0x14, 0, 0, bias),            # sub #bias
                    (0x54, 0, 0, self.nthreads - 1),   # and #mask
                    (0x16, 0, 0, 0)])              # ret A
                self._steered = True
            except OSError:
                pass

        self._frame_size = frame_size or \
            getattr(self.fmt, 'frame_size', None)
        pay = (self._frame_size - self.fmt.header_size) \
            if self._frame_size else 0
        self._zc_payload = pay
        self._zero_copy_ok = bool(
            zero_copy and self._exclusive and
            hasattr(self.fmt, 'decode_batch') and
            0 < pay <= self.payload_size and
            all(hasattr(s, 'recv_mmsg_scatter') for s in self._socks))

        self._wstats = [dict(npackets=0, nbytes=0, zero_copy=0)
                        for _ in range(self.nthreads)]
        self._wstate = [dict(src=None, next=None, zc=False)
                        for _ in range(self.nthreads)]
        from .. import affinity
        self._cores = affinity.spread_cores(
            self.nthreads, cores if cores is not None else
            ([core] if core is not None and core >= 0 else None))
        self._stop = False
        self._error = None
        self._started_seen = False
        self._threads = []
        for i in range(self.nthreads):
            t = threading.Thread(
                target=self._worker, args=(i,),
                name='capture-%s-w%d' % (ring.name, i), daemon=True)
            self._threads.append(t)
            t.start()

    # -- worker side -------------------------------------------------------
    def _worker(self, widx):
        sock = self._socks[widx]
        try:
            core = self._cores[widx] if self._cores else None
            if core is not None:
                from .. import affinity
                affinity.set_core(core)
            st = self._wstate[widx]
            while not self._stop:
                if st['zc'] and self._seq0 is not None:
                    self._zero_copy_round(widx, sock, st)
                else:
                    self._staged_round(widx, sock, st)
        except BaseException as e:
            with self._lock:
                self._error = e
                self._commit_cv.notify_all()
                self._claim_cv.notify_all()

    def _staged_round(self, widx, sock, st):
        raw, lengths = sock.recv_mmsg_raw(self.vlen, self._raw_stride)
        if raw is None:
            return
        info = {}
        self._ingest_batch(raw, lengths, self._wstats[widx], info)
        if not self._zero_copy_ok:
            return
        u = info.get('srcs')
        with self._lock:
            if u is not None and len(u) == 1:
                # the kernel hashes per flow: one in-range source in
                # the whole batch means this worker owns that source's
                # stream
                st['src'] = int(u[0])
                st['next'] = int(info['max_seq']) + 1
                st['zc'] = True
            else:
                st['src'] = None
                st['zc'] = False
            self._claim_cv.notify_all()

    def _zero_copy_round(self, widx, sock, st):
        H = self.fmt.header_size
        F = self._frame_size
        P = self._zc_payload
        # wait for data BEFORE claiming: claims must only ever be held
        # across the nonblocking recvmmsg below.  While the queue is
        # hot (last batch came back full) skip the select — the claim
        # is released immediately on an empty recv, so the worst case
        # is one wasted claim per queue drain.
        if not st.get('hot'):
            ready, _, _ = select.select([sock.sock], [], [],
                                        self._timeout)
            if not ready or self._stop:
                # idle flow: drop the engagement so a stale cursor
                # can't hold the skew gate (_span_retirable) against
                # commits
                with self._lock:
                    st['zc'] = False
                    st['src'] = None
                    self._claim_cv.notify_all()
                return
        with self._lock:
            claim = self._claim_cells(st['src'], st['next'])
            if claim is None:
                # cursor unreachable (window raced past it) — resync
                # through the staged path
                st['zc'] = False
                st['src'] = None
                self._claim_cv.notify_all()
                return
            addrs, starts = claim
        try:
            side, lens = sock.recv_mmsg_scatter(addrs, H, P)
        except BaseException:
            with self._lock:
                self._release_claims(starts)
            raise
        with self._lock:
            self._release_claims(starts)
            if side is None:
                st['hot'] = False
                return
            n = len(lens)
            st['hot'] = n == len(addrs)
            ws = self._wstats[widx]
            ws['npackets'] += n
            ws['nbytes'] += int(sum(lens))
            ws['zero_copy'] += n
            self.stats['nreceived'] += n
            hdr_arr = np.frombuffer(side, np.uint8,
                                    count=n * H).reshape(n, H)
            try:
                out = self.fmt.decode_batch(hdr_arr, F)
            except ValueError:
                self.stats['ninvalid'] += n
                st['zc'] = False
                st['src'] = None
                self._claim_cv.notify_all()
                return
            seqs, srcs, hoff = out[:3]
            fvalid = out[3] if len(out) > 3 else None
            if hoff != H:
                self.stats['ninvalid'] += n
                st['zc'] = False
                st['src'] = None
                self._claim_cv.notify_all()
                return
            seqs = np.asarray(seqs, np.int64)
            e = int(st['next'])
            exp = np.arange(e, e + n, dtype=np.int64)
            okrow = np.asarray(lens, np.int64) == F
            if fvalid is not None:
                okrow &= np.asarray(fvalid, bool)
            srcs0 = np.asarray(srcs, np.int64) - self.src0
            self._note_seqs(seqs[okrow])
            hit = okrow & (srcs0 == st['src']) & (seqs == exp)
            if bool(hit.all()):
                self._mark_got(exp - self._seq0, st['src'])
                st['next'] = e + n
            else:
                self._repair_zc_batch(st, exp, seqs, srcs0, okrow, P)
            self._claim_cv.notify_all()   # progress: skew gate may open

    def _span_retirable(self, start):
        """Bounded-skew backpressure (engine lock held): the head span
        may not retire while an ENGAGED zero-copy sibling's cursor is
        still inside it.  On skewed hosts one worker would otherwise
        slide the window ahead and turn the other worker's entire
        kernel queue into late drops.  Advisory only — _commit_oldest
        waits a bounded grace, so a stalled flow cannot wedge the
        window."""
        if self._seq0 is None:
            return True
        end = start + self.buffer_ntime
        for st in self._wstate:
            nxt = st['next']
            if st['zc'] and nxt is not None and \
                    nxt - self._seq0 < end:
                return False
        return True

    def _claim_cells(self, src, e):
        """Engine lock held.  Claim the span cells for seqs
        [e, e+vlen) of ``src`` — sliding the window forward as needed —
        and return (cell_addresses, claimed_span_starts), or None when
        the cursor is unreachable (behind seq0 or the window head).
        Claims pin their spans against commit until released.

        The claim stops short of the first cell that already holds a
        packet of ``src`` (None when that is the first cell): after a
        reordered batch the cursor can lie below cells received before,
        and a speculative scatter over them would overwrite their bytes
        while the ledger still counts them good.  The JAX engine has no
        such stop (``bifrost_tpu/io/packet_capture.py:1135-1166``)."""
        off0 = e - self._seq0
        if off0 < 0:
            return None
        self._ensure_window(off0)
        if not self._bufs or off0 < self._bufs[0][0]:
            return None
        last_end = self._bufs[-1][0] + self.buffer_ntime
        k = min(self.vlen, last_end - off0)
        for start, span, view, got in self._bufs:
            lo = max(off0, start)
            hi = min(off0 + k, start + self.buffer_ntime)
            if lo < hi:
                held = np.nonzero(got[lo - start:hi - start, src])[0]
                if held.size:
                    k = lo - off0 + int(held[0])
                    break
        if k <= 0:
            return None
        addrs = np.empty(k, np.uint64)
        starts = []
        P = self._zc_payload
        for start, span, view, got in self._bufs:
            lo = max(off0, start)
            hi = min(off0 + k, start + self.buffer_ntime)
            if lo >= hi:
                continue
            lane = view.shape[2]
            ts = np.arange(lo - start, hi - start, dtype=np.int64)
            addrs[lo - off0:hi - off0] = \
                (view.ctypes.data +
                 (ts * self.nsrc + src) * lane).astype(np.uint64)
            if P < lane:
                view[ts, src, P:] = 0     # pre-zero stale lane tails
            self._claims[start] = self._claims.get(start, 0) + 1
            starts.append(start)
        return addrs, starts

    def _release_claims(self, starts):
        for s in starts:
            c = self._claims.get(s, 0) - 1
            if c > 0:
                self._claims[s] = c
            else:
                self._claims.pop(s, None)
        self._claim_cv.notify_all()

    def _locate(self, off):
        for start, span, view, got in self._bufs:
            if start <= off < start + self.buffer_ntime:
                return view, got, off - start
        return None

    def _mark_got(self, offs, src):
        for start, span, view, got in self._bufs:
            m = (offs >= start) & (offs < start + self.buffer_ntime)
            if m.any():
                ts = offs[m] - start
                ndup = int(got[ts, src].sum())
                if ndup:
                    self.stats['ndup'] += ndup
                got[ts, src] = True

    def _repair_zc_batch(self, st, exp, seqs, srcs0, okrow, P):
        """Engine lock held.  Slow path after a speculative scatter
        whose decoded headers disagree with the prediction: each
        payload currently sits at its PREDICTED cell
        (exp[i], st['src']).  Pass 1 bounce-copies every misplaced
        payload out BEFORE any window motion (a slide for one packet
        must not retire a span still holding another's bytes); pass 2
        places them at their true cells."""
        n = len(exp)
        src_pred = st['src']
        moves = []            # (i, seq, src, payload_copy)
        good_max = None
        demote = False
        for i in range(n):
            if not okrow[i]:
                self.stats['ninvalid'] += 1
                continue
            q = int(seqs[i])
            s = int(srcs0[i])
            if s < 0 or s >= self.nsrc:
                self.stats['nalien'] += 1
                self.stats['nignored'] += 1
                demote = True
                continue
            good_max = q if good_max is None else max(good_max, q)
            if s != src_pred:
                demote = True
            if q == int(exp[i]) and s == src_pred:
                self._mark_got(np.asarray([q - self._seq0]), s)
                continue
            loc = self._locate(int(exp[i]) - self._seq0)
            if loc is None:           # predicted span raced away
                self.stats['nlate'] += 1
                self.stats['nignored'] += 1
                continue
            pview, _, pt = loc
            moves.append((q, s, pview[pt, src_pred, :P].copy()))
        for q, s, payload in moves:
            toff = q - self._seq0
            if self._bufs and toff < self._bufs[0][0]:
                self.stats['nlate'] += 1
                self.stats['nignored'] += 1
                continue
            self._ensure_window(toff)
            loc = self._locate(toff)
            if loc is None:
                self.stats['nlate'] += 1
                self.stats['nignored'] += 1
                continue
            tview, tgot, tt = loc
            if tgot[tt, s]:
                self.stats['ndup'] += 1
            tview[tt, s, :P] = payload
            if P < tview.shape[2]:
                tview[tt, s, P:] = 0
            tgot[tt, s] = True
        if good_max is not None:
            st['next'] = good_max + 1
        if demote:
            st['zc'] = False
            st['src'] = None

    # -- consumer side -----------------------------------------------------
    def set_timeout(self, secs):
        self._timeout = secs
        for s in self._socks:
            s.set_timeout(secs)

    def recv(self):
        """Block until the workers commit a span (or the timeout
        expires): the worker threads ARE the capture loop; recv() is
        the pacing/observation point the single-thread engine's recv()
        is for callers."""
        with self._commit_cv:
            if self._error is not None:
                err, self._error = self._error, None
                raise err
            n0 = self._ncommits
            deadline = (time_mod.monotonic() + self._timeout) \
                if self._timeout is not None else None
            while (self._ncommits == n0 and self._error is None and
                    not self._stop):
                if deadline is None:
                    self._commit_cv.wait(1.0)
                else:
                    rem = deadline - time_mod.monotonic()
                    if rem <= 0:
                        break
                    self._commit_cv.wait(rem)
            if self._error is not None:
                err, self._error = self._error, None
                raise err
            if self._ncommits == n0:
                return CAPTURE_NO_DATA if self._seq0 is None \
                    else CAPTURE_INTERRUPTED
            if not self._started_seen:
                self._started_seen = True
                return CAPTURE_STARTED
            return CAPTURE_CONTINUED

    def end(self):
        self._stop = True
        with self._lock:
            self._commit_cv.notify_all()
            self._claim_cv.notify_all()
        for t in self._threads:
            t.join(timeout=5.0)
        rc = super(ShardedUDPCapture, self).end()
        for s in self._own_socks:
            try:
                s.close()
            except Exception:
                pass
        self._own_socks = []
        return rc


class UDPSniffer(_PacketCapture):
    """Promiscuous capture: sees every inbound UDP datagram on the host
    via a raw IPPROTO_UDP socket, filtered to ``addr``'s port, with the
    IP + UDP headers stripped (reference: bfUdpSnifferCreate,
    src/packet_capture.cpp:352, UDPSnifferCapture method
    packet_capture.hpp:287-304).  Requires CAP_NET_RAW/root."""

    def __init__(self, fmt, addr, ring, nsrc, src0, max_payload_size,
                 buffer_ntime, slot_ntime, sequence_callback, core=None):
        super(UDPSniffer, self).__init__(
            fmt, ring, nsrc, src0, max_payload_size, buffer_ntime,
            slot_ntime, sequence_callback, core)
        self.port = addr.port if hasattr(addr, 'port') else int(addr)
        self.raw = socket_mod.socket(socket_mod.AF_INET,
                                     socket_mod.SOCK_RAW,
                                     socket_mod.IPPROTO_UDP)
        self.raw.settimeout(0.5)

    def set_timeout(self, secs):
        self.raw.settimeout(secs)

    def _recv_packet(self):
        while True:
            try:
                dgram = self.raw.recv(65535)
            except (socket_mod.timeout, TimeoutError):
                return None
            except OSError as e:
                if e.errno in (errno.EAGAIN, errno.EWOULDBLOCK):
                    return None
                raise
            if len(dgram) < 1:
                continue
            ihl = (dgram[0] & 0xF) * 4          # IP header length
            if len(dgram) < ihl + 8:
                continue
            dport = int.from_bytes(dgram[ihl + 2:ihl + 4], 'big')
            if self.port and dport != self.port:
                continue
            return dgram[ihl + 8:]              # strip IP + UDP headers

    def close(self):
        self.raw.close()

    def __exit__(self, *exc):
        self.end()
        self.close()


class DiskReader(_PacketCapture):
    """Replay packets from a file of fixed-size records (reference:
    bfDiskReaderCreate, src/packet_capture.cpp:300; seek/tell for
    replayable ingest, packet_capture.cpp:417-426)."""

    def __init__(self, fmt, fh, ring, nsrc, src0, max_payload_size,
                 buffer_ntime, slot_ntime, sequence_callback, core=None):
        super(DiskReader, self).__init__(
            fmt, ring, nsrc, src0, max_payload_size, buffer_ntime,
            slot_ntime, sequence_callback, core)
        self.fh = fh
        self._pkt_size = self.fmt.header_size + max_payload_size

    def _recv_packet(self):
        raw = self.fh.read(self._pkt_size)
        if len(raw) < self._pkt_size:
            return None
        return raw

    def seek(self, offset, whence=0):
        return self.fh.seek(offset * self._pkt_size, whence)

    def tell(self):
        return self.fh.tell() // self._pkt_size
