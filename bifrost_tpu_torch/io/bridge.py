"""Ring bridge: ship a ring's stream to a ring on another host (the JAX
package's ``bifrost_tpu/io/bridge.py``, same wire, same names).

The reference couples servers with an RDMA point-to-point transport
carrying header and span messages (reference: src/rdma.{cpp,hpp};
python/bifrost/rdma.py RingSender / RingReceiver).  This bridge carries
the same messages over TCP, wire format v2:

- **Zero-copy framing**: the sender hands the span's per-lane
  memoryviews (``ReadSpan.lane_memoryviews``) to a vectored
  ``socket.sendmsg``; the receiver ``recv_into``\\ s straight into the
  reserved span's lanes (strided multi-ringlet spans lane by lane; the
  out-of-order striped path reassembles in host memory, then scatters).
- **Credit window**: spans stay acquired (the ring guarantee held) until
  the receiver acks their commit, so backpressure reaches the source
  ring and unacked spans can be retransmitted verbatim after a
  reconnect.  ``BF_BRIDGE_WINDOW`` spans may be in flight (default 1).
- **Striping**: ``BF_BRIDGE_STREAMS`` parallel TCP connections carry
  frames interleaved by sequence number; the receiver reassembles them
  in order.
- **Integrity and sequencing**: every v2 frame carries a u64 sequence
  number; spans add a logical-gulp count (a macro-gulp sender ships K
  gulps a frame) and an optional CRC32 (``BF_BRIDGE_CRC=1``).

The receiver detects the legacy v1 wire (a bare MSG_HEADER first, no
MSG_HELLO), which ``RingSender(protocol=1)`` emits;
``RingSender(naive=True)`` is the copying send loop of the original
implementation, the baseline arm.

Host rings only: the lanes are host bytes (``system``, the native core,
or pinned ``cuda_host``).  A ``cuda`` ring is refused with a ValueError;
bridge into a host ring and ``copy('cuda')`` from it.

Wire framing: [u8 type][u64le length][payload]; v2 payloads begin with a
u64le frame sequence number.
"""

from __future__ import annotations

import errno as errno_mod
import os
import socket
import struct
import threading
import time
import uuid
import zlib
from collections import OrderedDict

import numpy as np

from ..header_standard import (serialize_header, deserialize_header,
                               trace_context, TRACE_CONTEXT_KEY)
from ..ring import EndOfDataStop, RingPoisonedError
from .udp_socket import retry_transient

__all__ = ['RingSender', 'RingReceiver', 'BridgeListener',
           'BridgeProtocolError', 'listen', 'connect', 'connect_striped',
           'bridge_streams', 'bridge_window', 'bridge_crc',
           'query_resume', 'WIRE_VERSION']

MSG_HEADER = 1
MSG_SPAN = 2
MSG_END_SEQ = 3
MSG_END = 4
MSG_HELLO = 5
MSG_HELLO_ACK = 6
MSG_ACK = 7

WIRE_VERSION = 2

_FRAME = struct.Struct('<BQ')    # [type][payload length]
_SEQNO = struct.Struct('<Q')     # v2: global frame sequence number
_SPAN2 = struct.Struct('<II')    # v2 span meta: [ngulps][crc32]

#: sanity bound on a single frame's payload (a corrupt length field
#: must raise BridgeProtocolError, not attempt a 2**63-byte recv)
_MAX_FRAME = 1 << 40

_DATA_TYPES = frozenset((MSG_HEADER, MSG_SPAN, MSG_END_SEQ, MSG_END))


class BridgeProtocolError(RuntimeError):
    """The peer sent something the wire format forbids: an unknown
    message type, a span before any sequence header, an oversized or
    undersized frame, a sequence-number gap on a single stream, a CRC
    mismatch, or a session/handshake violation."""


def bridge_streams(default=1):
    """Striping factor: ``BF_BRIDGE_STREAMS`` (default 1)."""
    try:
        return max(int(os.environ.get('BF_BRIDGE_STREAMS', '')
                       or default), 1)
    except ValueError:
        return default


def bridge_window(default=1):
    """Credit window in spans: ``BF_BRIDGE_WINDOW`` (default 1)."""
    try:
        return max(int(os.environ.get('BF_BRIDGE_WINDOW', '')
                       or default), 1)
    except ValueError:
        return default


def bridge_crc():
    """Whether span CRC32 is enabled: ``BF_BRIDGE_CRC=1``."""
    return os.environ.get('BF_BRIDGE_CRC', '0') == '1'


def bridge_quota_mbps(default=0.0):
    """Per-stream byte quota at the sender: ``BF_BRIDGE_QUOTA_MBPS``
    MB/s per stream (0 = unlimited)."""
    try:
        return max(float(os.environ.get('BF_BRIDGE_QUOTA_MBPS', '')
                         or default), 0.0)
    except ValueError:
        return default


def bridge_quota_gulps(default=0.0):
    """Per-stream gulp quota at the sender:
    ``BF_BRIDGE_QUOTA_GULPS`` gulps/s per stream (0 = unlimited)."""
    try:
        return max(float(os.environ.get('BF_BRIDGE_QUOTA_GULPS', '')
                         or default), 0.0)
    except ValueError:
        return default


def bridge_backoff_cap(default=2.0):
    """Cap of the full-jitter exponential redial backoff:
    ``BF_BRIDGE_BACKOFF_CAP`` seconds (default 2.0)."""
    try:
        return max(float(os.environ.get('BF_BRIDGE_BACKOFF_CAP', '')
                         or default), 0.0)
    except ValueError:
        return default


class _TokenBucket(object):
    """Token bucket for the per-stream sender quotas: refills at
    ``rate`` units/s up to ``capacity``.  ``admit`` is
    consume-or-refuse (drop policies); ``take_with_debt`` always
    consumes and returns the time to sleep until the bucket is whole
    again (block policy = rate limiting, never starvation — a span
    larger than the capacity still passes, it just pays its full
    refill time)."""

    __slots__ = ('rate', 'capacity', 'tokens', 'stamp')

    def __init__(self, rate, capacity=None):
        self.rate = float(rate)
        self.capacity = float(capacity if capacity is not None
                              else max(rate, 1.0))
        self.tokens = self.capacity
        self.stamp = time.monotonic()

    def _refill(self):
        now = time.monotonic()
        self.tokens = min(self.capacity,
                          self.tokens + (now - self.stamp) * self.rate)
        self.stamp = now

    def admit(self, n):
        self._refill()
        if self.tokens >= n:
            self.tokens -= n
            return True
        return False

    def take_with_debt(self, n):
        self._refill()
        self.tokens -= n
        if self.tokens >= 0:
            return 0.0
        return -self.tokens / max(self.rate, 1e-9)


def _counters():
    from ..telemetry import counters
    return counters


def _histograms():
    from ..telemetry import histograms
    return histograms


def _spans():
    from ..telemetry import spans
    return spans


def _require_host_ring(ring, who):
    """The bridge moves host bytes: a ``cuda`` ring has no lanes to send
    from or receive into, so it is refused here rather than at the first
    span."""
    if getattr(ring, 'is_device', False):
        raise ValueError(
            "%s needs a host ring ('system' or 'cuda_host'), not %r ring "
            "%r: bridge into a host ring and copy('cuda') from it"
            % (who, ring.space, ring.name))


def _trace_id(hdr):
    """The stream's trace id from a sequence header's trace context
    (header_standard.trace_context), or None — bridge tx/rx spans
    carry it so a gulp is traceable across the host boundary
    (tools/trace_merge.py)."""
    ctx = trace_context(hdr)
    return ctx['id'] if ctx else None


def _rate_mbps(last_pub, nbytes):
    """Inter-publish byte rate in MB/s for the stats proclogs:
    ``(rate, new_last_pub)`` given the previous ``(monotonic, bytes)``
    pair (or None on the first publish)."""
    now = time.monotonic()
    rate = 0.0
    if last_pub is not None:
        dt = now - last_pub[0]
        if dt > 0:
            rate = (nbytes - last_pub[1]) / dt / 1e6
    return max(rate, 0.0), (now, nbytes)


# ---------------------------------------------------------------------------
# Sockets
# ---------------------------------------------------------------------------

class BridgeListener(object):
    """Persistent listening socket for the receiving end: survives
    across connections so a sender can reconnect-and-resume
    (blocks.bridge.BridgeSource accepts through one of these)."""

    def __init__(self, address, port, backlog=16):
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            srv.bind((address, port))
            srv.listen(backlog)
        except BaseException:
            srv.close()
            raise
        self.srv = srv
        self.address = srv.getsockname()[0]
        self.port = srv.getsockname()[1]

    def accept(self, timeout=None):
        """Accept one connection (optionally bounded by ``timeout``
        seconds — raises ``socket.timeout`` on expiry)."""
        self.srv.settimeout(timeout)
        conn, _ = self.srv.accept()
        _tune_stream_socket(conn)
        conn.settimeout(None)
        return conn

    def close(self):
        self.srv.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _tune_stream_socket(sock):
    """Per-connection tuning: TCP_NODELAY (headers must not wait for
    Nagle) and 4MB socket buffers — the kernel-side pipeline depth the
    credit window streams into.  Oversized requests are clamped by
    net.core.{r,w}mem_max; best-effort."""
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    for opt in (socket.SO_SNDBUF, socket.SO_RCVBUF):
        try:
            sock.setsockopt(socket.SOL_SOCKET, opt, 1 << 22)
        except OSError:
            pass


def listen(address, port):
    """Accept one bridge connection; returns a connected socket.  The
    listening socket is ALWAYS closed — including when the accept
    itself fails (a crash here must not leak the bound port)."""
    lst = BridgeListener(address, port, backlog=1)
    try:
        return lst.accept()
    finally:
        lst.close()


def connect(address, port, timeout=10.0):
    """Dial the receiving end.  Transient dial errors (the listener
    not up yet -> ECONNREFUSED, EINTR, and cross-host ETIMEDOUT) are
    retried with the shared io backoff (``BF_IO_RETRY_MAX`` /
    ``BF_IO_RETRY_BACKOFF``)."""
    def _dial():
        try:
            return socket.create_connection((address, port),
                                            timeout=timeout)
        except socket.timeout as exc:
            # the timeout parameter surfaces as socket.timeout with
            # errno None; normalize so the retry actually fires
            raise OSError(errno_mod.ETIMEDOUT,
                          'bridge dial to %s:%d timed out'
                          % (address, port)) from exc
    sock = retry_transient(_dial, extra=(errno_mod.ETIMEDOUT,))
    _tune_stream_socket(sock)
    sock.settimeout(None)
    return sock


def connect_striped(address, port, nstreams, timeout=10.0):
    """Dial ``nstreams`` parallel connections to one receiver."""
    socks = []
    try:
        for _ in range(max(int(nstreams), 1)):
            socks.append(connect(address, port, timeout=timeout))
    except BaseException:
        for s in socks:
            try:
                s.close()
            except OSError:
                pass
        raise
    return socks


try:
    _IOV_MAX = os.sysconf('SC_IOV_MAX')
except (AttributeError, ValueError, OSError):
    _IOV_MAX = 1024


def _sendmsg_all(sock, buffers):
    """Vectored sendall: one ``sendmsg`` per kernel round, resuming
    after short writes without copying (the zero-copy framing send
    primitive).  The buffer list is chunked at IOV_MAX so spans with
    more ringlet lanes than the kernel's iovec limit still send."""
    bufs = []
    for b in buffers:
        mv = b if isinstance(b, memoryview) else memoryview(b)
        if mv.format != 'B':
            mv = mv.cast('B')
        if len(mv):
            bufs.append(mv)
    while bufs:
        try:
            n = sock.sendmsg(bufs[:_IOV_MAX])
        except InterruptedError:
            continue
        while bufs and n >= len(bufs[0]):
            n -= len(bufs[0])
            bufs.pop(0)
        if n:
            bufs[0] = bufs[0][n:]


def _recv_exact_into(sock, view):
    """Fill ``view`` (a writable memoryview) directly from the socket
    — the receive-side zero-copy primitive (no intermediate chunks)."""
    got = 0
    n = len(view)
    while got < n:
        try:
            c = sock.recv_into(view[got:])
        except InterruptedError:
            continue
        if c == 0:
            raise ConnectionError("bridge peer closed")
        got += c


def _send_msg(sock, mtype, payload=b''):
    """v1-framed control send (also used for v2 handshake/ACK frames,
    whose payloads are small)."""
    if payload:
        _sendmsg_all(sock, [_FRAME.pack(mtype, len(payload)), payload])
    else:
        sock.sendall(_FRAME.pack(mtype, 0))


def _recv_exact(sock, n):
    buf = bytearray(n)
    _recv_exact_into(sock, memoryview(buf))
    return bytes(buf)


def _recv_msg_naive(sock):
    """The seed implementation's receive: chunked ``recv`` into fresh
    bytes objects joined with ``b''.join`` — two extra copies per
    frame against the recv_into paths (the baseline arm)."""
    hdr = _recv_exact(sock, _FRAME.size)
    mtype, length = _FRAME.unpack(hdr)
    if length > _MAX_FRAME:
        raise BridgeProtocolError(
            "frame of %d bytes exceeds the %d-byte bound" % (length,
                                                             _MAX_FRAME))
    chunks, n = [], length
    while n > 0:
        c = sock.recv(min(n, 1 << 20))
        if not c:
            raise ConnectionError("bridge peer closed")
        chunks.append(c)
        n -= len(c)
    return mtype, b''.join(chunks)


def _recv_msg(sock):
    hdr = _recv_exact(sock, _FRAME.size)
    mtype, length = _FRAME.unpack(hdr)
    if length > _MAX_FRAME:
        raise BridgeProtocolError(
            "frame of %d bytes exceeds the %d-byte bound (corrupt "
            "stream?)" % (length, _MAX_FRAME))
    payload = _recv_exact(sock, length) if length else b''
    return mtype, payload


def _bytes_into_span(arr, payload, ringlet_shape):
    """Scatter C-order (ringlet-major) payload bytes into a possibly
    strided span view (ringlet lanes are contiguous individually)."""
    raw = np.frombuffer(payload, np.uint8)
    if arr.flags['C_CONTIGUOUS']:
        arr.view(np.uint8).reshape(-1)[:len(raw)] = raw
        return
    nring_dims = len(ringlet_shape)
    pos = 0
    for idx in np.ndindex(*arr.shape[:nring_dims]):
        sub = arr[idx]
        nb = min(sub.nbytes, len(raw) - pos)
        sub.view(np.uint8).reshape(-1)[:nb] = raw[pos:pos + nb]
        pos += sub.nbytes


def _lane_crc(lanes, crc=0):
    for lane in lanes:
        crc = zlib.crc32(lane, crc)
    return crc & 0xffffffff


class _Frame(object):
    """One in-flight v2 frame: kept (with its span, when any) until the
    receiver's cumulative ACK covers it, so a reconnect can retransmit
    it verbatim and the ring guarantee keeps the span's bytes alive."""

    __slots__ = ('seq', 'mtype', 'head', 'lanes', 'span', 'nbyte',
                 'ack')

    def __init__(self, seq, mtype, head, lanes=None, span=None, nbyte=0,
                 ack=None):
        self.seq = seq
        self.mtype = mtype
        self.head = head          # outer frame hdr + seqno + meta bytes
        self.lanes = lanes        # payload buffer list (or None)
        self.span = span          # held ReadSpan (MSG_SPAN only)
        self.nbyte = nbyte        # payload bytes (telemetry)
        self.ack = ack            # (seq_name, frame_offset, nframe,
                                  # nbyte) for the on_span_acked hook

    def buffers(self):
        return [self.head] + list(self.lanes or ())


# ---------------------------------------------------------------------------
# Sender
# ---------------------------------------------------------------------------

class RingSender(object):
    """Pump a ring's sequences/spans into one or more connected sockets
    (reference: rdma.py RingSender; wire format: docs/networking.md).

    ``sock`` is a connected socket or a list of them (striping).  The
    default v2 wire pipelines ``window`` spans of credit over
    ``len(socks)`` striped connections with zero-copy vectored sends;
    ``protocol=1`` emits the legacy v1 wire, ``naive=True`` the seed
    implementation's copying loop (the baseline arm).

    ``reconnect`` (optional) is a zero-arg callable returning a fresh
    socket list; on a transport failure the sender redials through it
    and retransmits every unacked frame (the receiver drops duplicates
    by sequence number).  ``shutdown_event`` requests a clean early
    MSG_END between spans (Pipeline shutdown).
    """

    def __init__(self, ring, sock=None, gulp_nframe=None, guarantee=True,
                 protocol=WIRE_VERSION, window=None, crc=None,
                 gulp_batch=1, naive=False, dial=None, reconnect=None,
                 reconnect_max=3, shutdown_event=None, heartbeat=None,
                 drain_timeout=60.0, name=None, overload_policy=None,
                 quota_bytes_per_s=None, quota_gulps_per_s=None,
                 on_shed=None, on_span_acked=None):
        _require_host_ring(ring, 'RingSender')
        self.ring = ring
        if sock is None:
            self.socks = []
        else:
            self.socks = list(sock) if isinstance(sock, (list, tuple)) \
                else [sock]
        self.dial = dial
        self.gulp_nframe = gulp_nframe
        self.guarantee = guarantee
        self.naive = bool(naive)
        self.protocol = 1 if naive else int(protocol)
        self.window = bridge_window() if window is None \
            else max(int(window), 1)
        self.crc = bridge_crc() if crc is None else bool(crc)
        self.gulp_batch = max(int(gulp_batch or 1), 1)
        self.reconnect = reconnect
        self.reconnect_max = int(reconnect_max)
        self.shutdown_event = shutdown_event
        self.heartbeat = heartbeat
        self.drain_timeout = float(drain_timeout)
        self.session = uuid.uuid4().hex
        self.name = name or ring.name

        self._lock = threading.Lock()
        self._credit = threading.Condition(self._lock)
        self._seq_no = 0
        self._unacked = OrderedDict()      # seq -> _Frame
        self._inflight_spans = 0
        self._error = None
        self._ack_hup = None
        self._generation = 0
        self._reconnects = 0
        self._done = False
        self._ack_threads = []
        self._h_stall = None
        self._stats_proclog = None
        self._tx_bytes = 0
        self._tx_frames = 0
        self._tx_spans = 0
        self._last_pub = None        # (monotonic, bytes) for rate
        self._seqs = None
        self._seq_gen = None
        #: per-sequence trace identity for tx spans (trace id from the
        #: header's trace context + local sequence ordinal)
        self._cur_trace = None
        self._cur_seq = -1
        #: bytes of one span at the current sequence's batch geometry —
        #: what a runtime window retune needs to grow the source ring
        self._cur_span_nbyte = 0
        #: pending stripe-count retune, applied by the pump thread at
        #: the next span boundary (retune_streams/_apply_restripe)
        self._restripe_pending = None
        #: overload policy AT THE CREDIT WINDOW (docs/robustness.md
        #: "Overload & degradation"): 'block' (default — classic
        #: credit backpressure into the source ring), 'drop_newest'
        #: (no credit -> the just-read gulp is released unsent,
        #: counted), 'drop_oldest' (after a credit stall the sender
        #: skips the accumulated backlog and ships the freshest data,
        #: counted).  Shed spans were never emitted, so the reconnect
        #: retransmit window and the shed ledger COMPOSE: a redial
        #: replays only unacked live frames, never dropped spans.
        self.overload_policy = overload_policy or 'block'
        if self.overload_policy not in ('block', 'drop_oldest',
                                        'drop_newest'):
            raise ValueError("Unknown bridge overload policy %r"
                             % (self.overload_policy,))
        #: per-stream quotas (token buckets keyed by the sequence's
        #: trace id): byte and gulp rates per second; 0/None =
        #: unlimited.  Fair by construction — one stream exhausting
        #: its bucket sheds (drop policies) or rate-limits (block)
        #: only itself.
        self.quota_bytes_per_s = float(
            quota_bytes_per_s if quota_bytes_per_s is not None
            else bridge_quota_mbps() * 1e6)
        self.quota_gulps_per_s = float(
            quota_gulps_per_s if quota_gulps_per_s is not None
            else bridge_quota_gulps())
        self.on_shed = on_shed
        #: ack-ledger hook (bifrost_tpu.fabric.AckLedger): called as
        #: ``on_span_acked(seq_name, frame_offset, nframe, nbyte)``
        #: for every span the receiver's cumulative ACK releases — the
        #: durable "delivered" journal whole-host rejoin resumes from
        self.on_span_acked = on_span_acked
        #: wall-clock offset to the receiving host estimated by the
        #: handshake ping (peer_wall_ns - our_wall_ns; None until a v2
        #: handshake completes).  Stamped into shipped trace contexts
        #: as the cumulative ``skew_ns`` so a downstream sink can age
        #: data against the ORIGIN host's clock (telemetry.slo fabric
        #: end-to-end age).
        self.wall_offset_ns = None
        self._wall_rtt_us = None
        self._cur_seq_name = None
        self._quota_buckets = {}     # stream id -> (bytes_tb, gulps_tb)
        self._shed_gulps = 0
        self._shed_bytes = 0
        self._shed_by_stream = {}    # stream id -> [spans, bytes]

    # -- public ------------------------------------------------------------
    def prime(self):
        """Open the ring reader NOW (blocks until the first sequence
        exists) so the read guarantee pins the stream's head before
        any socket work.  BridgeSink calls this before the pipeline
        init barrier: the upstream producer is then provably
        registered-against before it commits its first gulp.
        Idempotent; run() primes implicitly when skipped."""
        if self._seqs is None:
            self._seqs = self._iter_sequences()
        return self

    def retune_window(self, window):
        """Runtime credit-window retune (the auto-tuner's knob —
        docs/autotune.md).  ``self.window`` is read by ``_wait_credit``
        on every span, so the new value takes effect immediately; a
        GROWN window additionally needs ``window + 2`` spans of source
        ring depth (the same sizing rule the per-sequence ``resize``
        applies), requested through the non-blocking deferred-resize
        protocol so this never stalls the send loop.  Until the ring
        growth lands, the wider window self-caps at the available
        depth (docs/networking.md, BF-W110 semantics) — still safe,
        just not yet fully pipelined."""
        window = max(int(window), 1)
        self.window = window
        nbyte = self._cur_span_nbyte
        if nbyte:
            try:
                self.ring.request_resize(nbyte, (window + 2) * nbyte)
            except Exception:
                pass
        with self._credit:
            self._credit.notify_all()
        return window

    def retune_streams(self, nstreams):
        """Runtime stripe-count retune (the auto-tuner's
        ``BF_BRIDGE_STREAMS`` knob — docs/autotune.md).  Striping is
        fixed at connect time (frames interleave across the socket
        list by sequence number), so the change is applied by the PUMP
        thread at the next span boundary as a planned restripe: drain
        the credit window (every frame acked — nothing to retransmit),
        close the stripes, redial through ``dial`` (which reads the
        owner's updated stripe count), and re-handshake.  The receiver
        treats the redial like any reconnect-and-resume; counted on
        ``bridge.tx.restripes``, never against the reconnect budget."""
        self._restripe_pending = max(int(nstreams), 1)
        with self._credit:
            self._credit.notify_all()
        return self._restripe_pending

    def _apply_restripe(self):
        """The pump-thread half of :meth:`retune_streams` (span
        boundary, v2 wire only)."""
        n, self._restripe_pending = self._restripe_pending, None
        if self.dial is None or self.naive or self.protocol < 2 \
                or n == len(self.socks):
            return
        # drain the window with a SHORT bound: a backlogged link that
        # cannot ack within the grace window simply defers the
        # restripe to a later span boundary (the knob's step lands
        # late) — the full _drain would hard-abort after its 60s
        # stall timeout, turning a tuning probe into a transport
        # failure.  Transport errors during the wait ride the
        # ordinary _check_error -> _recover path (whose redial
        # already dials the new stripe count).
        deadline = time.monotonic() + 5.0
        while True:
            self._check_error()
            with self._credit:
                if not self._unacked:
                    break
                self._credit.wait(0.1)
            if self._stop_requested():
                return
            if time.monotonic() >= deadline:
                self._restripe_pending = n
                return
        self._stop_threads(join=True)
        for s in self.socks:
            try:
                s.close()
            except OSError:
                pass
        try:
            self.socks = list(self.dial())
            self._handshake(self.socks)
        except (OSError, ConnectionError, BridgeProtocolError) as exc:
            # a transient dial failure (or an open circuit breaker)
            # during a PLANNED restripe must ride the ordinary
            # reconnect machinery — jittered backoff, budget,
            # nothing to retransmit (the window was drained) — not
            # abort the sender: a tuning probe must never turn a
            # link blip into a pipeline failure.  The recovery dial
            # reads the owner's already-updated stripe count, so the
            # restripe completes through it (counted as a reconnect).
            self._recover(exc)
            return
        self._start_threads()
        _counters().inc('bridge.tx.restripes')

    def run(self):
        self.prime()
        try:
            if not self.socks:
                if self.dial is None:
                    raise ValueError("RingSender needs sockets or a "
                                     "dial callable")
                self.socks = list(self.dial())
            if self.naive:
                return self._run_naive()
            if self.protocol < 2:
                return self._run_v1()
            return self._run_v2()
        finally:
            # every exit — clean, failed dial/handshake, poisoned ring
            # — finalizes the primed reader: an abandoned guarantee
            # would pin the source ring's tail until GC (and a native
            # ring may be torn down before then)
            self._close_seqs()

    def close(self):
        self._stop_threads(join=True)
        self._close_seqs()
        for s in self.socks:
            try:
                s.close()
            except OSError:
                pass

    def _close_seqs(self):
        """Finalize the ring.read generator NOW: an abandoned reader
        would keep its guarantee registered (pinning the source ring's
        tail) until garbage collection, and a native ring may already
        be torn down by then."""
        gen, self._seq_gen, self._seqs = self._seq_gen, None, None
        if gen is not None:
            try:
                gen.close()
            except Exception:
                pass

    # -- telemetry ---------------------------------------------------------
    def _observe_tx(self, nbyte, is_span):
        c = _counters()
        c.inc('bridge.tx.frames')
        c.inc('bridge.tx.bytes', nbyte)
        with self._lock:
            self._tx_bytes += nbyte
            self._tx_frames += 1
            if is_span:
                self._tx_spans += 1
        if is_span:
            c.inc('bridge.tx.spans')
        self._publish_stats()

    def _publish_stats(self, force=False):
        """like_bmon TX row: the monitors read ``*_transmit_*/stats``
        entries with nbytes/npackets (tools/like_bmon.py); the
        inter-publish byte rate feeds pipeline2dot's cross-host
        boundary annotation."""
        try:
            if self._stats_proclog is None:
                from ..proclog import ProcLog
                self._stats_proclog = ProcLog(
                    '%s_bridge_transmit/stats' % self.name)
            if force or self._stats_proclog.ready():
                rate, self._last_pub = _rate_mbps(self._last_pub,
                                                  self._tx_bytes)
                self._stats_proclog.update(
                    {'nbytes': self._tx_bytes,
                     'npackets': self._tx_frames,
                     'nspans': self._tx_spans,
                     'rate_MBps': round(rate, 3),
                     'reconnects': self._reconnects,
                     'shed_gulps': self._shed_gulps,
                     'shed_bytes': self._shed_bytes}, force=force)
        except Exception:
            pass

    def _record_stall(self, dt):
        if self._h_stall is None:
            self._h_stall = _histograms().get_or_create(
                'bridge.%s.send_stall_s' % self.name, unit='s')
        self._h_stall.record(dt)

    # -- overload shedding & quotas (docs/robustness.md) -------------------
    def _stream_id(self):
        return self._cur_trace or ('seq%d' % self._cur_seq)

    def _note_shed(self, nbyte, ngulps, reason):
        """Count one sender-side shed (credit window, backlog skip, or
        quota) in LOGICAL gulps + bytes: the
        ``bridge.tx.shed_gulps/.shed_bytes`` counters (quota sheds
        additionally on ``bridge.tx.quota_shed_gulps``), the
        per-stream ledger the stats proclog publishes, and the
        BridgeSink's ``on_shed`` degraded-mode callback."""
        c = _counters()
        c.inc('bridge.tx.shed_gulps', ngulps)
        c.inc('bridge.tx.shed_bytes', nbyte)
        if reason == 'quota':
            c.inc('bridge.tx.quota_shed_gulps', ngulps)
        stream = self._stream_id()
        with self._lock:
            self._shed_gulps += ngulps
            self._shed_bytes += nbyte
            entry = self._shed_by_stream.setdefault(stream, [0, 0])
            entry[0] += ngulps
            entry[1] += nbyte
            while len(self._shed_by_stream) > self._MAX_STREAM_STATE:
                self._shed_by_stream.pop(
                    next(iter(self._shed_by_stream)))
        if self.on_shed is not None:
            try:
                self.on_shed(reason, ngulps, nbyte)
            except Exception:
                pass
        self._publish_stats()

    def shed_stats(self):
        """Cumulative sender-side shed ledger: total gulps/bytes and
        the per-stream split (the fair-shedding audit)."""
        with self._lock:
            return {'shed_gulps': self._shed_gulps,
                    'shed_bytes': self._shed_bytes,
                    'by_stream': {k: tuple(v) for k, v
                                  in self._shed_by_stream.items()}}

    #: retained per-stream quota buckets / shed-ledger entries: the
    #: sender streams ONE sequence at a time, so old streams' state is
    #: only history — bound it so a months-long sender with thousands
    #: of sequences doesn't grow without limit
    _MAX_STREAM_STATE = 64

    def _quota_state(self, stream):
        tbs = self._quota_buckets.get(stream)
        if tbs is None:
            b = _TokenBucket(self.quota_bytes_per_s) \
                if self.quota_bytes_per_s > 0 else None
            g = _TokenBucket(self.quota_gulps_per_s) \
                if self.quota_gulps_per_s > 0 else None
            tbs = self._quota_buckets[stream] = (b, g)
            while len(self._quota_buckets) > self._MAX_STREAM_STATE:
                self._quota_buckets.pop(
                    next(iter(self._quota_buckets)))
        return tbs

    def _quota_admit(self, nbyte, ngulps):
        """Apply the per-stream quota to one span: True = send it.
        Under a drop policy an over-quota span is refused (the caller
        sheds it); under 'block' the span always passes but pays its
        refill time first — rate limiting, not starvation."""
        if self.quota_bytes_per_s <= 0 and self.quota_gulps_per_s <= 0:
            return True
        b, g = self._quota_state(self._stream_id())
        if self.overload_policy == 'block':
            wait = 0.0
            if b is not None:
                wait = max(wait, b.take_with_debt(nbyte))
            if g is not None:
                wait = max(wait, g.take_with_debt(ngulps))
            while wait > 0 and not self._stop_requested():
                step = min(wait, 0.05)
                time.sleep(step)
                wait -= step
            return True
        ok = True
        if b is not None and not b.admit(nbyte):
            ok = False
        if ok and g is not None and not g.admit(ngulps):
            # refund the byte tokens the first bucket consumed
            if b is not None:
                b.tokens = min(b.capacity, b.tokens + nbyte)
            ok = False
        return ok

    def _credit_available(self):
        """Non-blocking credit check (drop policies): True when a span
        may be emitted now.  Transport errors still recover through
        the blocking path."""
        self._check_error()
        with self._credit:
            return self._inflight_spans < self.window \
                and self._error is None

    def _skip_backlog(self, seq, offset, batch, frame_nbyte,
                      hdr_gulp=1):
        """drop_oldest at the credit window: after a stall, skip the
        accumulated backlog beyond ``window`` spans and resume at the
        freshest data — the skipped (oldest unsent) gulps are counted
        shed.  The reader guarantee advances at the next acquire, so
        the source ring's writer unblocks without replaying a stale
        burst after a reconnect (resume-after-shed)."""
        try:
            occ = self.ring.occupancy()
            head = occ.get('head')
            if head is None:
                return offset
            begin = seq._seq.begin
            end = getattr(seq._seq, 'end', None)
            if end is not None:
                head = min(head, end)
            avail = (head - begin) // max(frame_nbyte, 1)
            # frames below the ring tail were already lost (and
            # COUNTED) by the ring's own drop policy — the bridge
            # ledger must only cover readable frames it chooses to
            # skip, or the two ledgers would double-count the audit
            tail_f = -(-max(occ.get('tail', 0) - begin, 0)
                       // max(frame_nbyte, 1))
        except Exception:
            return offset
        start = max(offset, tail_f)
        backlog_spans = (avail - start) // max(batch, 1)
        keep = max(int(self.window), 1)
        if backlog_spans <= keep:
            return offset
        nskip = backlog_spans - keep
        gulps_per_span = max(1, -(-batch // max(hdr_gulp, 1)))
        self._note_shed(nskip * batch * frame_nbyte,
                        nskip * gulps_per_span, 'backlog')
        return start + nskip * batch

    # -- naive / v1 paths --------------------------------------------------
    def _iter_sequences(self):
        """Sequence iterator, PRIMED before any socket work: priming
        registers the reader's guarantee at the earliest sequence, so
        a fast producer cannot overwrite frames while the sender is
        still dialing/handshaking (the startup race window)."""
        import itertools
        seqs = self.ring.read(guarantee=self.guarantee)
        self._seq_gen = seqs         # closed explicitly in close()/_abort
        try:
            first = next(seqs)
        except (StopIteration, EndOfDataStop):
            # a ring that ends with ZERO sequences is a valid (empty)
            # stream: the pump still dials and ships a clean MSG_END —
            # a fan-out leg that never received a stripe must not turn
            # end-of-stream into a block failure
            return iter(())
        return itertools.chain([first], seqs)

    def _stop_requested(self):
        return (self.shutdown_event is not None
                and self.shutdown_event.is_set())

    def _run_naive(self):
        """The seed implementation: per-span ``ascontiguousarray`` +
        ``tobytes`` copies and a blocking ``sendall`` per message —
        kept as the measured baseline arm."""
        sock = self.socks[0]
        seqs = self._seqs
        ok = False
        try:
            for seq in seqs:
                hdr = dict(seq.header)
                _send_msg(sock, MSG_HEADER, serialize_header(hdr))
                gulp = self.gulp_nframe or hdr.get('gulp_nframe', 1)
                for span in seq.read(gulp):
                    buf = np.ascontiguousarray(span.data.as_numpy())
                    _send_msg(sock, MSG_SPAN, buf.tobytes())
                    self._observe_tx(buf.nbytes, True)
                    if self._stop_requested():
                        break
                _send_msg(sock, MSG_END_SEQ)
                if self._stop_requested():
                    break
            ok = True
        finally:
            # Only a CLEAN end of pump sends MSG_END: on failure the
            # connection closes without it, so the receiver poisons
            # its ring instead of treating a truncated stream as
            # complete.  (The seed sent MSG_END unconditionally here,
            # which both masked the primary exception on a broken
            # socket and faked a clean end on a healthy one.)
            if ok:
                _send_msg(sock, MSG_END)
            self._publish_stats(force=True)

    def _span_lanes(self, span):
        """(buffers, nbyte): zero-copy per-lane memoryviews when the
        span's storage exports them, else one gathered copy."""
        lanes = span.lane_memoryviews()
        if lanes is None:
            buf = np.ascontiguousarray(span.data.as_numpy())
            lanes = [memoryview(buf).cast('B')]
        return lanes, sum(len(v) for v in lanes)

    def _run_v1(self):
        """Legacy v1 wire (no seq numbers / acks / striping) with
        zero-copy vectored sends: what a v2 endpoint emits when told to
        negotiate down for an old receiver."""
        sock = self.socks[0]
        seqs = self._seqs
        ok = False
        try:
            for seq in seqs:
                hdr = dict(seq.header)
                _send_msg(sock, MSG_HEADER, serialize_header(hdr))
                gulp = self.gulp_nframe or hdr.get('gulp_nframe', 1)
                for span in seq.read(gulp):
                    lanes, nbyte = self._span_lanes(span)
                    _sendmsg_all(sock, [_FRAME.pack(MSG_SPAN, nbyte)]
                                 + lanes)
                    self._observe_tx(nbyte, True)
                    if self.heartbeat is not None:
                        self.heartbeat()
                    if self._stop_requested():
                        break
                _send_msg(sock, MSG_END_SEQ)
                if self._stop_requested():
                    break
            ok = True
        finally:
            # clean end only — see _run_naive's finally
            if ok:
                _send_msg(sock, MSG_END)
            self._publish_stats(force=True)

    def _stamp_hop(self, hdr):
        """Mark one bridge hop on the shipped header's trace context:
        ``hops`` counts host boundaries crossed, and ``skew_ns``
        accumulates the handshake-measured wall-clock offset of each
        hop — so ``origin_ns + skew_ns`` is the ORIGIN host's capture
        instant expressed on the RECEIVING host's wall clock, and a
        fabric sink can report a true cross-host end-to-end age
        (telemetry.slo ``slo.fabric_exit_age_s``).  No-op for streams
        without a trace context."""
        ctx = trace_context(hdr)
        if ctx is None:
            return
        ctx = dict(ctx)
        ctx['hops'] = int(ctx.get('hops', 0) or 0) + 1
        if self.wall_offset_ns is not None:
            try:
                ctx['skew_ns'] = (int(ctx.get('skew_ns', 0) or 0)
                                  + int(self.wall_offset_ns))
            except (TypeError, ValueError):
                ctx['skew_ns'] = int(self.wall_offset_ns)
        hdr[TRACE_CONTEXT_KEY] = ctx

    # -- v2 plumbing -------------------------------------------------------
    def _handshake(self, socks, timeout=30.0):
        """HELLO/HELLO_ACK exchange, bounded: a peer that accepted
        the TCP connection but never answers must surface as a
        ConnectionError (retryable), not a forever-blocked thread.

        The exchange doubles as a clock PING (docs/observability.md):
        each HELLO carries this side's span-clock timestamp; a
        context-aware receiver echoes its own in the HELLO_ACK, and
        the sender estimates the peer's span-clock offset at half the
        round trip — the shift ``tools/trace_merge.py`` uses to join
        both hosts' Chrome traces onto one timeline.  v2 peers without
        the timestamps simply omit them (extra JSON keys are ignored
        both ways), so the wire stays version-compatible."""
        spans_mod = _spans()
        for s in socks:
            s.settimeout(timeout)
        t_sent = {}
        t_sent_wall = {}
        try:
            for i, s in enumerate(socks):
                hello = {'version': WIRE_VERSION,
                         'session': self.session,
                         'stream_id': i, 'nstreams': len(socks),
                         'window': self.window, 'crc': bool(self.crc),
                         'ts_us': round(spans_mod.now_us(), 3),
                         'wall_ns': time.time_ns()}
                t_sent[i] = spans_mod.now_us()
                t_sent_wall[i] = time.time_ns()
                _send_msg(s, MSG_HELLO, serialize_header(hello))
            for i, s in enumerate(socks):
                mtype, payload = _recv_msg(s)
                t_ack = spans_mod.now_us()
                if mtype != MSG_HELLO_ACK:
                    raise BridgeProtocolError(
                        "expected HELLO_ACK, got message type %d "
                        "(v1-only peer? configure "
                        "RingSender(protocol=1))" % mtype)
                try:
                    ack = deserialize_header(payload)
                except Exception:
                    ack = {}
                peer_ts = ack.get('ts_us')
                wall_off = None
                peer_wall = ack.get('wall_ns')
                if isinstance(peer_wall, int):
                    # same ping, wall clocks: the receiver stamped its
                    # wall clock ~mid-flight, so the offset estimate is
                    # accurate to ~RTT/2 — good enough to age data
                    # against the ORIGIN host's capture instant across
                    # the fabric (telemetry.slo fabric exit age)
                    rtt_ns = max((t_ack - t_sent[i]) * 1e3, 0.0)
                    wall_off = peer_wall - (t_sent_wall[i]
                                            + rtt_ns / 2.0)
                    if self._wall_rtt_us is None or \
                            (t_ack - t_sent[i]) < self._wall_rtt_us:
                        self._wall_rtt_us = t_ack - t_sent[i]
                        self.wall_offset_ns = int(wall_off)
                if isinstance(peer_ts, (int, float)):
                    rtt = max(t_ack - t_sent[i], 0.0)
                    # peer stamped its clock ~mid-flight: offset =
                    # peer_clock - our_clock at the same instant
                    offset = peer_ts - (t_sent[i] + rtt / 2.0)
                    spans_mod.note_peer_clock(self.session, 'tx',
                                              offset_us=offset,
                                              rtt_us=rtt,
                                              wall_offset_ns=wall_off)
                else:
                    spans_mod.note_peer_clock(self.session, 'tx')
        except socket.timeout as exc:
            raise ConnectionError(
                "bridge handshake timed out after %.0fs"
                % timeout) from exc
        finally:
            for s in socks:
                try:
                    s.settimeout(None)
                except OSError:
                    pass

    def _start_threads(self):
        self._generation += 1
        self._ack_hup = None
        gen = self._generation
        self._ack_threads = [
            threading.Thread(target=self._ack_loop, args=(gen, s),
                             name='bf-bridge-ack%d' % i, daemon=True)
            for i, s in enumerate(self.socks)]
        for t in self._ack_threads:
            t.start()

    def _stop_threads(self, join=True):
        # unblock ACK readers parked in recv
        for s in self.socks:
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        if join:
            for t in self._ack_threads:
                t.join(timeout=5.0)
        self._ack_threads = []

    def _post_error(self, gen, exc):
        with self._credit:
            if self._done or gen != self._generation:
                return
            if self._error is None:
                self._error = exc
            self._credit.notify_all()

    def _ack_loop(self, gen, sock):
        try:
            while True:
                mtype, payload = _recv_msg(sock)
                if mtype != MSG_ACK or len(payload) != _SEQNO.size:
                    raise BridgeProtocolError(
                        "expected ACK frame, got type %d" % mtype)
                (ackno,) = _SEQNO.unpack(payload)
                self._apply_ack(ackno)
        except BridgeProtocolError as exc:
            # protocol corruption on the ACK channel is NEVER benign:
            # without an ack reader the pump would stall silently at
            # the credit window
            self._post_error(gen, exc)
        except (OSError, ConnectionError) as exc:
            # EOF with nothing unacked is the receiver hanging up
            # after its final ACK — benign; a genuinely dead link
            # resurfaces on the next TX write.  With striping the
            # final cumulative ACK may still be in flight on ANOTHER
            # stripe when this one sees EOF, so give it a short grace
            # window before declaring a transport failure.
            deadline = time.monotonic() + 0.5
            while True:
                with self._credit:
                    if not self._unacked or self._done \
                        or gen != self._generation:
                        # remember the hangup: if the pump later emits
                        # a span (absorbed by the socket buffer) it
                        # must not park in _wait_credit with no ack
                        # reader left alive
                        self._ack_hup = exc
                        return
                if time.monotonic() >= deadline:
                    break
                time.sleep(0.005)
            self._post_error(gen, exc)

    def _apply_ack(self, ackno):
        """Cumulative ACK: every frame with seq <= ackno is committed
        on the far side — drop it and release its span (un-pinning the
        source ring's guarantee: this is where backpressure credit
        returns)."""
        released = []
        acked_info = []
        popped = 0
        with self._credit:
            while self._unacked:
                seq, frame = next(iter(self._unacked.items()))
                if seq > ackno:
                    break
                del self._unacked[seq]
                popped += 1
                if frame.span is not None:
                    self._inflight_spans -= 1
                    released.append(frame.span)
                    if frame.ack is not None:
                        acked_info.append(frame.ack)
            if popped:
                # not just span releases: _drain waits for CONTROL
                # frames (END_SEQ/END) too, and must wake on their acks
                self._credit.notify_all()
        for span in released:
            try:
                span.release()
            except Exception:
                pass
        if self.on_span_acked is not None:
            # the delivered-frames journal (fabric AckLedger): called
            # outside the credit lock — the hook may touch the disk
            for info in acked_info:
                try:
                    self.on_span_acked(*info)
                except Exception:
                    pass

    def _check_error(self):
        with self._credit:
            exc = self._error
        if exc is not None:
            self._recover(exc)

    def _recover(self, exc):
        """Transport failure: redial through ``reconnect`` with
        full-jitter exponential backoff (bounded attempts, counted on
        ``bridge.redial_attempts``) and retransmit every unacked
        frame; budget exhaustion counts ``bridge.circuit_open`` and
        aborts — the BridgeSink's circuit breaker then fast-fails
        further dials for a cool-off instead of hammering a dead
        peer."""
        from .udp_socket import retry_backoff_s
        if self.reconnect is None \
                or self._reconnects >= self.reconnect_max:
            _counters().inc('bridge.circuit_open')
            self._abort()
            raise exc
        self._stop_threads(join=True)
        for s in self.socks:
            try:
                s.close()
            except OSError:
                pass
        last = exc
        cap = bridge_backoff_cap()
        attempt0 = self._reconnects
        while self._reconnects < self.reconnect_max:
            self._reconnects += 1
            _counters().inc('bridge.tx.reconnects')
            _counters().inc('bridge.redial_attempts')
            # full-jitter exponential backoff between redials (base
            # 50 ms, cap BF_BRIDGE_BACKOFF_CAP): a fleet of senders
            # redialing a restarted receiver must not arrive in
            # synchronized waves.  Interruptible by shutdown.
            delay = retry_backoff_s(self._reconnects - attempt0,
                                    backoff=0.05, cap=cap)
            if delay > 0:
                if self.shutdown_event is not None:
                    if self.shutdown_event.wait(delay):
                        # clean shutdown mid-backoff: abort the
                        # transport and surface the original error —
                        # NOT a budget exhaustion, so no circuit_open
                        self._abort()
                        raise last
                else:
                    time.sleep(delay)
            try:
                self.socks = list(self.reconnect())
                self._handshake(self.socks)
                with self._credit:
                    self._error = None
                    pending = list(self._unacked.values())
                # retransmit everything unacked, in order (the
                # receiver drops frames it already committed by
                # sequence number); a failure HERE consumes budget and
                # redials instead of aborting a recoverable link
                for frame in pending:
                    _sendmsg_all(
                        self.socks[frame.seq % len(self.socks)],
                        frame.buffers())
                    self._observe_tx(frame.nbyte,
                                     frame.mtype == MSG_SPAN)
                self._start_threads()
                return
            except (OSError, ConnectionError,
                    BridgeProtocolError) as redial_exc:
                last = redial_exc
                self._stop_threads(join=True)
                for s in self.socks:
                    try:
                        s.close()
                    except OSError:
                        pass
        _counters().inc('bridge.circuit_open')
        self._abort()
        raise last

    def _transmit(self, frame):
        """Send one frame inline from the pump thread.  The "send
        queue" of the windowed design is the kernel socket buffer: a
        blocking sendmsg returns once the kernel has the bytes, so the
        pump overlaps ring acquire with the NIC drain without a
        per-frame thread handoff (which costs a GIL switch per frame —
        measured 4x slower on single-core hosts).  Striped frames
        round-robin across connections; each TCP stream keeps its own
        congestion window."""
        try:
            _sendmsg_all(self.socks[frame.seq % len(self.socks)],
                         frame.buffers())
        except (OSError, ValueError) as exc:
            # _recover retransmits every unacked frame — including
            # this one (registered before the send)
            self._recover(exc)
            return
        self._observe_tx(frame.nbyte, frame.mtype == MSG_SPAN)

    def _emit(self, mtype, payload=b'', span=None, lanes=None, meta=b'',
              ack=None):
        with self._credit:
            seq_no = self._seq_no
            self._seq_no += 1
        if lanes is None:
            lanes = [payload] if payload else []
        nbyte = sum(len(b) for b in lanes)
        head = (_FRAME.pack(mtype, _SEQNO.size + len(meta) + nbyte)
                + _SEQNO.pack(seq_no) + meta)
        frame = _Frame(seq_no, mtype, head, lanes, span, nbyte, ack)
        with self._credit:
            self._unacked[seq_no] = frame
            if span is not None:
                self._inflight_spans += 1
        self._transmit(frame)
        return frame

    def _emit_span(self, span, gulp):
        lanes, nbyte = self._span_lanes(span)
        crc = _lane_crc(lanes) if self.crc else 0
        ngulps = max(1, -(-span.nframe // max(gulp, 1)))
        spans_mod = _spans()
        t0 = spans_mod.now_us() if spans_mod.enabled() else None
        ack_info = None
        if self.on_span_acked is not None:
            ack_info = (self._cur_seq_name, span.frame_offset,
                        span.nframe, nbyte)
        self._emit(MSG_SPAN, span=span, lanes=lanes,
                   meta=_SPAN2.pack(ngulps, crc), ack=ack_info)
        if t0 is not None:
            # tx span under the stream's trace identity: the same
            # (trace, seq, gulp) triple the receiving host records,
            # so the merged timeline shows the hop itself
            spans_mod.record('bridge.tx.%s' % self.name, 'bridge', t0,
                             spans_mod.now_us() - t0,
                             {'trace': self._cur_trace,
                              'seq': self._cur_seq,
                              'gulp': span.frame_offset // max(gulp, 1),
                              'gulps': ngulps, 'bytes': nbyte})
        if self.heartbeat is not None:
            self.heartbeat()

    def _wait_credit(self):
        """Block until fewer than ``window`` spans are unacked — the
        point where receiver-side commit pressure reaches the source
        ring.  Blocked time lands on the send-stall histogram."""
        self._check_error()
        with self._credit:
            if self._inflight_spans < self.window \
                    and self._error is None:
                return
        t0 = time.perf_counter()
        while True:
            with self._credit:
                if self._error is None \
                        and self._inflight_spans < self.window:
                    break
                if self._error is None:
                    # credit can only return through a live ack
                    # reader: if none remains (peer hung up during a
                    # lull and the EOF looked benign), waiting is a
                    # permanent stall — recover instead
                    if self._inflight_spans > 0 and not any(
                            t.is_alive() for t in self._ack_threads):
                        self._error = self._ack_hup or \
                            ConnectionError(
                                "bridge ack channel closed with "
                                "%d span(s) in flight"
                                % self._inflight_spans)
                    else:
                        self._credit.wait(0.1)
            self._check_error()
            if self._stop_requested():
                break
        self._record_stall(time.perf_counter() - t0)

    def _drain(self):
        """Wait until every emitted frame is acked (clean shutdown /
        end of stream).  The timeout measures STALL, not total drain:
        every ack that lands resets it, so a slow-but-healthy link is
        never aborted while the window is still moving."""
        deadline = time.monotonic() + self.drain_timeout
        last_pending = None
        while True:
            self._check_error()
            with self._credit:
                if not self._unacked:
                    return
                pending = len(self._unacked)
                # like _wait_credit: acks can only arrive through a
                # live ack reader — with none left, waiting out the
                # stall timeout is pointless
                if self._error is None and not any(
                        t.is_alive() for t in self._ack_threads):
                    self._error = self._ack_hup or ConnectionError(
                        "bridge ack channel closed with %d frame(s) "
                        "unacked" % pending)
                    continue
                self._credit.wait(0.1)
            if pending != last_pending:
                last_pending = pending
                deadline = time.monotonic() + self.drain_timeout
            if time.monotonic() >= deadline:
                # release held spans and stop threads: a leaked span
                # would pin the source ring's tail forever
                self._abort()
                raise ConnectionError(
                    "bridge drain stalled: %d frame(s) unacked with "
                    "no progress for %.0fs"
                    % (pending, self.drain_timeout))

    def _abort(self):
        """Transport is dead and unrecoverable: release held spans and
        close WITHOUT MSG_END so the receiver poisons its ring (a
        truncated stream must not look complete)."""
        self._done = True
        self._stop_threads(join=True)
        spans = []
        with self._credit:
            for frame in self._unacked.values():
                if frame.span is not None:
                    spans.append(frame.span)
            self._unacked.clear()
            self._inflight_spans = 0
        for span in spans:
            try:
                span.release()
            except Exception:
                pass
        self._close_seqs()
        self._publish_stats(force=True)

    def _run_v2(self):
        # the ring reader was primed (guarantee pinned) before any
        # socket work — see prime()
        seqs = self._seqs
        self._handshake(self.socks)
        self._start_threads()
        try:
            for seq in seqs:
                hdr = dict(seq.header)
                gulp = int(self.gulp_nframe
                           or hdr.get('gulp_nframe', 1) or 1)
                batch = gulp * self.gulp_batch
                # span identity + logical-gulp crediting must use the
                # SHIPPED header's gulp size — the receiver derives its
                # (trace, seq, gulp) triple and ring.<name>.gulps
                # credits from that header (falling back to 1), so a
                # sender-side gulp_nframe override must not skew either
                hdr_gulp = int(hdr.get('gulp_nframe', 1) or 1)
                self._cur_trace = _trace_id(hdr)
                self._cur_seq += 1
                self._cur_seq_name = hdr.get('name') or \
                    ('seq%d' % self._cur_seq)
                self._stamp_hop(hdr)
                self._emit(MSG_HEADER, serialize_header(hdr))
                # reader-side buffering: the credit window pins the
                # tail at the oldest unacked span, so the ring needs
                # window+2 spans of depth or the producer stalls early
                try:
                    seq.resize(batch, buffer_factor=self.window + 2)
                except Exception:
                    pass
                try:
                    self._cur_span_nbyte = \
                        batch * seq.tensor['frame_nbyte']
                except Exception:
                    self._cur_span_nbyte = 0
                offset = 0
                try:
                    frame_nbyte = seq.tensor['frame_nbyte']
                except Exception:
                    frame_nbyte = 1
                while not self._stop_requested():
                    # planned restripe (retune_streams): applied here,
                    # at a span boundary, after draining the window
                    if self._restripe_pending is not None:
                        self._apply_restripe()
                    # overload policy at the credit window
                    # (docs/robustness.md): 'block' waits like the
                    # classic pump; 'drop_newest' sheds the gulp in
                    # hand when no credit is available; 'drop_oldest'
                    # waits, then skips the accumulated backlog and
                    # resumes at the freshest data
                    shed_this = False
                    if self.overload_policy == 'drop_newest':
                        shed_this = not self._credit_available()
                        if shed_this:
                            self._check_error()
                    else:
                        self._wait_credit()
                        if self.overload_policy == 'drop_oldest':
                            offset = self._skip_backlog(
                                seq, offset, batch, frame_nbyte,
                                hdr_gulp)
                    try:
                        span = seq.acquire(offset, batch)
                    except EndOfDataStop:
                        break
                    # frames overwritten before our guarantee pinned
                    # (startup race / unguaranteed reader) are skipped
                    # forward, like the reference sender
                    advanced = span.frame_offset + span.nframe
                    if span.nframe == 0:
                        span.release()
                        if advanced > offset:
                            offset = advanced
                            continue
                        break
                    offset = advanced
                    ngulps = max(1, -(-span.nframe
                                      // max(hdr_gulp, 1)))
                    if not shed_this and \
                            not self._quota_admit(
                                span.nframe * frame_nbyte, ngulps):
                        span.release()
                        self._note_shed(span.nframe * frame_nbyte,
                                        ngulps, 'quota')
                        if self.heartbeat is not None:
                            self.heartbeat()
                        continue
                    if shed_this:
                        nbyte = span.nframe * frame_nbyte
                        span.release()
                        self._note_shed(nbyte, ngulps, 'credit')
                        if self.heartbeat is not None:
                            self.heartbeat()
                        continue
                    self._emit_span(span, hdr_gulp)
                self._emit(MSG_END_SEQ)
                if self._stop_requested():
                    break
        except RingPoisonedError:
            if not self._stop_requested():
                # upstream failure: abort WITHOUT a clean MSG_END so
                # the receiver poisons its ring too
                self._abort()
                raise
            # pipeline shutdown poisons rings as a wakeup: fall
            # through to the clean MSG_END below
        except BaseException:
            self._abort()
            raise
        self._emit(MSG_END)
        self._drain()
        self._done = True
        self._stop_threads(join=True)
        self._publish_stats(force=True)


# ---------------------------------------------------------------------------
# Receiver
# ---------------------------------------------------------------------------

class RingReceiver(object):
    """Receive a bridged stream into a destination ring
    (reference: rdma.py RingReceiver; wire format: docs/networking.md).

    ``sock`` is a connected socket, a list of sockets (pre-accepted
    stripes), or a :class:`BridgeListener` (the receiver accepts as
    many stripes as the sender's HELLO advertises).  The wire version
    is auto-detected from the first frame, so v1 senders keep working.

    Protocol state (expected sequence number, the open output
    sequence) survives transport errors: calling :meth:`run` again
    with a fresh connection RESUMES the stream — retransmitted frames
    are dropped by sequence number and re-acked.  A transport error
    with ``poison_on_error`` (default) poisons the destination ring so
    downstream readers see a dead producer instead of a silently
    truncated stream.
    """

    def __init__(self, sock, ring, writer=None, crc=None,
                 poison_on_error=True, heartbeat=None,
                 stop_event=None, naive=False, name=None,
                 adopt_sessions=False):
        _require_host_ring(ring, 'RingReceiver')
        self.sock = sock
        self.ring = ring
        self.heartbeat = heartbeat
        self.stop_event = stop_event
        self.name = name or ring.name
        self.crc_forced = crc
        self.poison_on_error = poison_on_error
        #: whole-host rejoin choreography (bifrost_tpu.fabric,
        #: docs/fabric.md): accept a HELLO from a NEW session instead
        #: of raising — the dead sender host's stream is truncated
        #: (its open output sequence ends), the frame-sequence counter
        #: resets, and the rejoined host's fresh session continues the
        #: stream (counted on ``bridge.rx.sessions_adopted``).  The
        #: receiver also answers resume PROBES (``query_resume``) with
        #: its per-sequence committed-frame counts so the rejoined
        #: sender replays only frames this side never committed.
        self.adopt_sessions = bool(adopt_sessions)
        #: seed-implementation receive loop (chunked recv + b''.join +
        #: frombuffer scatter — two extra copies per span); kept as
        #: the measured baseline arm
        self.naive = bool(naive)

        self._writer = writer
        self._owns_writer = writer is None
        self._ended = False
        self._done = False
        self._protocol = None
        self._session = None
        self._crc = bool(crc)
        self._window = 1
        self._expected = 0
        # open output sequence state (survives reconnects)
        self._wseq = None
        self._frame_nbyte = None
        self._ringlet_shape = None
        self._nringlet = 1
        self._accepted = []
        self._h_wait = None
        self._stats_proclog = None
        self._rx_bytes = 0
        self._rx_frames = 0
        self._rx_spans = 0
        self._rx_dups = 0
        self._rx_crc_errors = 0
        self._last_pub = None        # (monotonic, bytes) for rate
        #: per-sequence trace identity for rx spans (mirrors the
        #: sender: trace id from the shipped header + local ordinal)
        self._cur_trace = None
        self._cur_seq = -1
        self._cur_gulp_nframe = 1
        #: cumulative committed frames per sequence NAME — the resume
        #: map a rejoin probe reads (docs/fabric.md)
        self._frames_by_seq = {}
        self._cur_seq_key = None
        self._sessions_adopted = 0
        #: optional hook fired (no args) when a NEW session is
        #: adopted or a resume probe is answered — the fabric wires
        #: this to ``Membership.confirm_resume`` so a restarted
        #: peer's hold-down ends the moment its resume choreography
        #: touches this receiver (docs/scheduler.md)
        self.on_session_adopted = None

    # -- public ------------------------------------------------------------
    def run(self):
        """Process the stream until MSG_END (returns) or a transport /
        protocol failure (raises; call again with a fresh connection
        to resume)."""
        from ..ring import RingWriter
        if self._done:
            return
        if self._writer is None:
            self._writer = RingWriter(self.ring)
        try:
            while True:
                socks = self._materialize_socks()
                first = _recv_msg(socks[0])
                if first[0] == MSG_HELLO:
                    hello = deserialize_header(first[1])
                    if hello.get('probe'):
                        # resume probe (query_resume): answer with the
                        # committed-frame map and keep listening — a
                        # probe is a side question, not the stream
                        self._answer_probe(socks[0])
                        if isinstance(self.sock, BridgeListener):
                            continue
                        raise ConnectionError(
                            "resume probe on a dedicated bridge "
                            "socket (no listener to re-accept from)")
                    socks = self._handshake(socks, hello)
                    if len(socks) == 1:
                        self._run_v2_single(socks[0])
                    else:
                        self._run_v2_striped(socks)
                else:
                    self._protocol = 1
                    self._run_v1(socks[0], first)
                break
        except BaseException as exc:
            self._close_accepted()
            if self.poison_on_error and not self._done:
                try:
                    self.ring.poison(exc)
                except Exception:
                    pass
            raise
        self._done = True
        self._close_accepted()
        if self._owns_writer and not self._ended:
            self._ended = True
            self.ring.end_writing()
        self._publish_stats(force=True)

    def close(self):
        self._close_accepted()
        socks = self.sock if isinstance(self.sock, (list, tuple)) \
            else [self.sock]
        for s in socks:
            if isinstance(s, (socket.socket, BridgeListener)):
                try:
                    s.close()
                except OSError:
                    pass

    # -- socket management -------------------------------------------------
    def _materialize_socks(self):
        if isinstance(self.sock, BridgeListener):
            return [self._accept_next()]
        if isinstance(self.sock, (list, tuple)):
            return list(self.sock)
        return [self.sock]

    def _accept_next(self):
        """Accept one connection, polling ``stop_event`` so a pipeline
        shutdown is not stuck behind a blocking accept."""
        while True:
            if self.stop_event is not None and self.stop_event.is_set():
                raise ConnectionError("bridge receiver stopped while "
                                      "waiting for a connection")
            try:
                conn = self.sock.accept(
                    timeout=0.25 if self.stop_event is not None
                    else None)
            except socket.timeout:
                continue
            self._accepted.append(conn)
            return conn

    def _close_accepted(self):
        for s in self._accepted:
            try:
                s.close()
            except OSError:
                pass
        self._accepted = []

    # -- telemetry ---------------------------------------------------------
    def _observe_rx(self, nbyte, is_span):
        c = _counters()
        c.inc('bridge.rx.frames')
        c.inc('bridge.rx.bytes', nbyte)
        self._rx_bytes += nbyte
        self._rx_frames += 1
        if is_span:
            self._rx_spans += 1
            c.inc('bridge.rx.spans')
        if self.heartbeat is not None:
            self.heartbeat()
        self._publish_stats()

    def _publish_stats(self, force=False):
        """like_bmon RX row: ``*_capture/stats`` shape the monitors
        already parse (ngood/missing/invalid/ignored); the
        inter-publish byte rate feeds pipeline2dot's cross-host
        boundary annotation."""
        try:
            if self._stats_proclog is None:
                from ..proclog import ProcLog
                self._stats_proclog = ProcLog(
                    '%s_bridge_capture/stats' % self.name)
            if force or self._stats_proclog.ready():
                rate, self._last_pub = _rate_mbps(self._last_pub,
                                                  self._rx_bytes)
                self._stats_proclog.update(
                    {'ngood_bytes': self._rx_bytes,
                     'nmissing_bytes': 0,
                     'ninvalid': self._rx_crc_errors,
                     'nignored': self._rx_dups,
                     'rate_MBps': round(rate, 3),
                     'npackets': self._rx_frames}, force=force)
        except Exception:
            pass

    def _record_wait(self, dt):
        if self._h_wait is None:
            self._h_wait = _histograms().get_or_create(
                'bridge.%s.recv_wait_s' % self.name, unit='s')
        self._h_wait.record(dt)

    # -- shared stream state -----------------------------------------------
    def _begin_seq(self, hdr):
        from ..ring import _tensor_info
        if self._wseq is not None:
            raise BridgeProtocolError(
                "MSG_HEADER while the previous sequence %r is still "
                "open (missing MSG_END_SEQ)" % (self._wseq.name,))
        gulp = hdr.get('gulp_nframe', 1) or 1
        self._cur_trace = _trace_id(hdr)
        self._cur_seq += 1
        self._cur_gulp_nframe = max(int(gulp), 1)
        self._cur_seq_key = hdr.get('name') or ('seq%d' % self._cur_seq)
        # receive-side buffering stays at the classic 3 gulps: the
        # credit window's overlap lives on the SENDER side (spans in
        # flight) and in the kernel socket buffers — a window-scaled
        # ring here would put a multi-span allocation on the stream
        # startup path for no measured gain
        self._wseq = self._writer.begin_sequence(hdr, gulp_nframe=gulp,
                                                 buf_nframe=3 * gulp)
        info = _tensor_info(hdr)
        self._frame_nbyte = info['frame_nbyte']
        self._ringlet_shape = info['ringlet_shape']
        self._nringlet = info['nringlet']

    def _end_seq(self):
        if self._wseq is not None:
            self._wseq.end()
            self._wseq = None

    #: retained per-sequence-name resume entries: rejoins only ever
    #: resume RECENT sequences, so ancient history is dead weight in
    #: both receiver memory and the handshake/probe payload that
    #: ships the whole map — bound it (insertion-ordered eviction;
    #: re-committing an evicted name simply restarts its count, which
    #: a frontier max-merge on the sender side tolerates)
    _MAX_SEQ_STATE = 256

    def _note_committed(self, nframe):
        """Advance the per-sequence-name committed-frame count — the
        resume map rejoin probes read (``query_resume``)."""
        if self._cur_seq_key is not None:
            # pop + reinsert = move-to-end: the LIVE sequence is never
            # the eviction victim, however long ago it was opened
            total = self._frames_by_seq.pop(self._cur_seq_key, 0) \
                + nframe
            self._frames_by_seq[self._cur_seq_key] = total
            while len(self._frames_by_seq) > self._MAX_SEQ_STATE:
                self._frames_by_seq.pop(
                    next(iter(self._frames_by_seq)))

    def _require_seq(self, mtype):
        if self._wseq is None:
            raise BridgeProtocolError(
                "message type %d before any MSG_HEADER (no open "
                "sequence)" % mtype)

    def _reserve(self, payload_nbyte):
        self._require_seq(MSG_SPAN)
        lane_nbyte = payload_nbyte // max(self._nringlet, 1)
        nframe = lane_nbyte // self._frame_nbyte
        if nframe * self._frame_nbyte * max(self._nringlet, 1) \
                != payload_nbyte:
            # fail HERE: silently flooring would leave remainder bytes
            # on the stream (desynchronized framing) or drop them
            # (undetected truncation)
            raise BridgeProtocolError(
                "span payload of %d bytes does not tile %d ringlet "
                "lane(s) of %d-byte frames"
                % (payload_nbyte, self._nringlet, self._frame_nbyte))
        return self._wseq.reserve(nframe), nframe

    def _record_rx_span(self, t0, nbyte, ngulps, frame_offset):
        """One rx span under the stream's trace identity — the
        receiving-host twin of the sender's ``bridge.tx.*`` span."""
        spans_mod = _spans()
        spans_mod.record(
            'bridge.rx.%s' % self.name, 'bridge', t0,
            spans_mod.now_us() - t0,
            {'trace': self._cur_trace, 'seq': self._cur_seq,
             'gulp': frame_offset // self._cur_gulp_nframe,
             'gulps': ngulps, 'bytes': nbyte})

    def _commit_span_bytes(self, payload, ngulps=1, crc=None):
        """Striped / v1 path: payload already in host memory; scatter
        into the reserved span."""
        spans_mod = _spans()
        t0 = spans_mod.now_us() if spans_mod.enabled() else None
        if crc is not None and self._crc:
            got = zlib.crc32(payload) & 0xffffffff
            if got != crc:
                raise self._crc_mismatch(crc, got)
        span, nframe = self._reserve(len(payload))
        frame_offset = span.frame_offset
        try:
            lanes = span.lane_memoryviews()
            if lanes is not None:
                off = 0
                mv = memoryview(payload)
                for lane in lanes:
                    lane[:] = mv[off:off + len(lane)]
                    off += len(lane)
            else:
                _bytes_into_span(span.data.as_numpy(), payload,
                                 self._ringlet_shape)
            span._ngulps = max(int(ngulps), 1)
            span.commit(nframe)
        except BaseException:
            span.commit(0)
            span.close()
            raise
        span.close()
        self._note_committed(nframe)
        if t0 is not None:
            self._record_rx_span(t0, len(payload), ngulps,
                                 frame_offset)

    def _recv_span_into_ring(self, sock, payload_nbyte, ngulps, crc):
        """Single-stream zero-copy path: ``recv_into`` straight into
        the reserved span's lane views (no intermediate buffer)."""
        spans_mod = _spans()
        t0 = spans_mod.now_us() if spans_mod.enabled() else None
        span, nframe = self._reserve(payload_nbyte)
        frame_offset = span.frame_offset
        try:
            lanes = span.lane_memoryviews()
            if lanes is None:
                buf = bytearray(payload_nbyte)
                _recv_exact_into(sock, memoryview(buf))
                if self._crc:
                    got = zlib.crc32(bytes(buf)) & 0xffffffff
                    if got != crc:
                        raise self._crc_mismatch(crc, got)
                _bytes_into_span(span.data.as_numpy(), bytes(buf),
                                 self._ringlet_shape)
            else:
                for lane in lanes:
                    _recv_exact_into(sock, lane)
                if self._crc:
                    got = _lane_crc(lanes)
                    if got != crc:
                        raise self._crc_mismatch(crc, got)
            span._ngulps = max(int(ngulps), 1)
            span.commit(nframe)
        except BaseException:
            span.commit(0)
            span.close()
            raise
        span.close()
        self._note_committed(nframe)
        if t0 is not None:
            self._record_rx_span(t0, payload_nbyte, ngulps,
                                 frame_offset)

    def _crc_mismatch(self, want, got):
        self._rx_crc_errors += 1
        _counters().inc('bridge.rx.crc_errors')
        return BridgeProtocolError(
            "span CRC mismatch: frame says 0x%08x, payload is 0x%08x"
            % (want, got))

    # -- v1 ----------------------------------------------------------------
    def _commit_span_bytes_naive(self, payload):
        """Seed scatter: frombuffer + element assignment through the
        span's numpy view (baseline arm; see _recv_msg_naive)."""
        span, nframe = self._reserve(len(payload))
        try:
            _bytes_into_span(span.data.as_numpy(), payload,
                             self._ringlet_shape)
            span.commit(nframe)
        except BaseException:
            span.commit(0)
            span.close()
            raise
        span.close()

    def _run_v1(self, sock, first=None):
        recv = _recv_msg_naive if self.naive else _recv_msg
        while True:
            if first is not None:
                mtype, payload = first
                first = None
            else:
                t0 = time.perf_counter()
                mtype, payload = recv(sock)
                self._record_wait(time.perf_counter() - t0)
            if mtype == MSG_END:
                self._end_seq()
                break
            if mtype == MSG_HEADER:
                self._begin_seq(deserialize_header(payload))
                self._observe_rx(len(payload), False)
            elif mtype == MSG_SPAN:
                if self.naive:
                    self._commit_span_bytes_naive(payload)
                else:
                    self._commit_span_bytes(payload)
                self._observe_rx(len(payload), True)
            elif mtype == MSG_END_SEQ:
                self._end_seq()
                self._observe_rx(0, False)
            else:
                raise BridgeProtocolError(
                    "unknown bridge message type %d (payload %d "
                    "bytes)" % (mtype, len(payload)))

    # -- v2 ----------------------------------------------------------------
    def _answer_probe(self, sock):
        """Answer one resume probe (``query_resume``): the committed
        frame count per sequence name — what a rejoining sender host
        needs to replay ONLY the frames this side never committed —
        then close the probe connection."""
        ack = serialize_header({'version': WIRE_VERSION, 'probe': True,
                                'session': self._session,
                                'resume': dict(self._frames_by_seq),
                                'wall_ns': time.time_ns()})
        try:
            _send_msg(sock, MSG_HELLO_ACK, ack)
        finally:
            try:
                sock.close()
            except OSError:
                pass
        if self.on_session_adopted is not None:
            try:
                self.on_session_adopted()
            except Exception:
                pass

    def _handshake(self, socks, hello):
        self._protocol = 2
        if isinstance(hello, (bytes, bytearray, memoryview)):
            hello = deserialize_header(hello)
        session = hello.get('session')
        if self._session is not None and session != self._session:
            if not self.adopt_sessions:
                raise BridgeProtocolError(
                    "HELLO from a different session (%r, expected %r)"
                    % (session, self._session))
            # whole-host rejoin (docs/fabric.md): the old sender host
            # is dead and a NEW process is continuing the stream.  End
            # the truncated output sequence, reset the frame-sequence
            # protocol for the fresh session, and let the rejoined
            # sender resume (it probed the committed-frame map first,
            # so only unacked frames are replayed).
            self._end_seq()
            self._expected = 0
            self._sessions_adopted += 1
            _counters().inc('bridge.rx.sessions_adopted')
            if self.on_session_adopted is not None:
                try:
                    self.on_session_adopted()
                except Exception:
                    pass
        self._session = session
        if session:
            # register the session in this process's trace metadata so
            # trace_merge.py can pair this host's timeline with the
            # sender's (which holds the ping-estimated clock offset)
            _spans().note_peer_clock(session, 'rx')
        nstreams = max(int(hello.get('nstreams', 1) or 1), 1)
        self._window = max(int(hello.get('window', 1) or 1), 1)
        if self.crc_forced is None:
            self._crc = bool(hello.get('crc'))
        if isinstance(self.sock, BridgeListener):
            while len(socks) < nstreams:
                socks.append(self._accept_next())
        if len(socks) < nstreams:
            raise BridgeProtocolError(
                "sender advertises %d stripes but only %d "
                "connection(s) are available" % (nstreams, len(socks)))
        for s in socks[1:]:
            mtype, payload = _recv_msg(s)
            if mtype != MSG_HELLO:
                raise BridgeProtocolError(
                    "expected HELLO on stripe connection, got type %d"
                    % mtype)
            peer = deserialize_header(payload)
            if peer.get('session') != self._session:
                raise BridgeProtocolError(
                    "stripe HELLO from a different session")
        spans_mod = _spans()
        for s in socks:
            # per-sock timestamp: the clock-ping echo must be stamped
            # at SEND time, not once for the batch (the sender halves
            # its measured RTT around this instant).  wall_ns rides
            # along so the sender can estimate the WALL-clock offset
            # too (the fabric end-to-end SLO's skew correction).
            entry = {'version': WIRE_VERSION,
                     'ts_us': round(spans_mod.now_us(), 3),
                     'wall_ns': time.time_ns()}
            if self.adopt_sessions:
                entry['resume'] = dict(self._frames_by_seq)
            ack = serialize_header(entry)
            _send_msg(s, MSG_HELLO_ACK, ack)
        return socks

    def _send_ack(self, sock):
        _send_msg(sock, MSG_ACK, _SEQNO.pack(self._expected - 1))

    def _read_frame_head(self, sock):
        t0 = time.perf_counter()
        hdr = _recv_exact(sock, _FRAME.size)
        self._record_wait(time.perf_counter() - t0)
        mtype, length = _FRAME.unpack(hdr)
        if length > _MAX_FRAME:
            raise BridgeProtocolError(
                "frame of %d bytes exceeds the %d-byte bound"
                % (length, _MAX_FRAME))
        if mtype not in _DATA_TYPES:
            # fail HERE: consuming a seqno from a non-data frame would
            # desynchronize the stream and misreport the defect
            raise BridgeProtocolError(
                "unknown bridge message type %d on the v2 stream"
                % mtype)
        if length < _SEQNO.size:
            raise BridgeProtocolError(
                "v2 data frame (type %d) without a sequence number"
                % mtype)
        (seqno,) = _SEQNO.unpack(_recv_exact(sock, _SEQNO.size))
        return mtype, seqno, length - _SEQNO.size

    def _dispatch(self, mtype, body, ngulps=1, crc=None):
        """Apply one in-order v2 frame whose payload is already in
        host memory (striped reassembly / control frames)."""
        if mtype == MSG_HEADER:
            self._begin_seq(deserialize_header(body))
            self._observe_rx(len(body), False)
        elif mtype == MSG_SPAN:
            self._commit_span_bytes(body, ngulps=ngulps, crc=crc)
            self._observe_rx(len(body), True)
        elif mtype == MSG_END_SEQ:
            self._end_seq()
            self._observe_rx(0, False)
        elif mtype == MSG_END:
            self._end_seq()
        else:
            raise BridgeProtocolError(
                "unknown bridge message type %d" % mtype)

    def _run_v2_single(self, sock):
        while True:
            mtype, seqno, body_len = self._read_frame_head(sock)
            if seqno < self._expected:
                # retransmit after a sender reconnect: drop + re-ack
                if body_len:
                    _recv_exact(sock, body_len)
                self._rx_dups += 1
                _counters().inc('bridge.rx.dups')
                self._send_ack(sock)
                continue
            if seqno > self._expected:
                raise BridgeProtocolError(
                    "sequence gap on a single stream: got frame %d, "
                    "expected %d" % (seqno, self._expected))
            if mtype == MSG_SPAN:
                if body_len < _SPAN2.size:
                    raise BridgeProtocolError("truncated span frame")
                ngulps, crc = _SPAN2.unpack(
                    _recv_exact(sock, _SPAN2.size))
                nbyte = body_len - _SPAN2.size
                self._recv_span_into_ring(sock, nbyte, ngulps, crc)
                self._observe_rx(nbyte, True)
                self._expected += 1
                self._send_ack(sock)
            else:
                body = _recv_exact(sock, body_len) if body_len else b''
                self._dispatch(mtype, body)
                self._expected += 1
                self._send_ack(sock)
                if mtype == MSG_END:
                    return

    def _run_v2_striped(self, socks):
        """Reassemble frames arriving out of order across stripes: one
        reader thread per connection fills a bounded pending map, the
        committer applies frames in sequence order and acks on the
        stripe each frame arrived from."""
        cond = threading.Condition()
        pending = {}
        state = {'error': None, 'done': False}
        limit = self._window * 2 + 8

        def reader(sock, idx):
            try:
                while True:
                    hdr = _recv_exact(sock, _FRAME.size)
                    mtype, length = _FRAME.unpack(hdr)
                    if length > _MAX_FRAME or length < _SEQNO.size:
                        raise BridgeProtocolError(
                            "bad v2 frame (type %d, %d bytes)"
                            % (mtype, length))
                    (seqno,) = _SEQNO.unpack(
                        _recv_exact(sock, _SEQNO.size))
                    body = _recv_exact(sock, length - _SEQNO.size)
                    with cond:
                        while (len(pending) >= limit
                               and state['error'] is None
                               and not state['done']
                               and seqno > self._expected):
                            cond.wait(0.1)
                        if state['done']:
                            return
                        pending[seqno] = (mtype, body, idx)
                        cond.notify_all()
                    if mtype == MSG_END:
                        return
            except (OSError, ConnectionError,
                    BridgeProtocolError) as exc:
                with cond:
                    if not state['done'] and state['error'] is None:
                        state['error'] = exc
                    cond.notify_all()

        threads = [threading.Thread(target=reader, args=(s, i),
                                    name='bf-bridge-rx%d' % i,
                                    daemon=True)
                   for i, s in enumerate(socks)]
        for t in threads:
            t.start()
        try:
            while True:
                t0 = time.perf_counter()
                with cond:
                    while True:
                        # discard retransmits that arrived out of order
                        stale = [s for s in pending
                                 if s < self._expected]
                        for s in stale:
                            _, _, idx = pending.pop(s)
                            self._rx_dups += 1
                            _counters().inc('bridge.rx.dups')
                            _send_msg(socks[idx], MSG_ACK,
                                      _SEQNO.pack(self._expected - 1))
                        if self._expected in pending:
                            mtype, body, idx = \
                                pending.pop(self._expected)
                            cond.notify_all()
                            break
                        if state['error'] is not None:
                            raise state['error']
                        cond.wait(0.1)
                self._record_wait(time.perf_counter() - t0)
                if mtype == MSG_SPAN:
                    if len(body) < _SPAN2.size:
                        raise BridgeProtocolError(
                            "truncated span frame")
                    ngulps, crc = _SPAN2.unpack(body[:_SPAN2.size])
                    self._dispatch(mtype,
                                   memoryview(body)[_SPAN2.size:],
                                   ngulps=ngulps, crc=crc)
                else:
                    self._dispatch(mtype, body)
                self._expected += 1
                _send_msg(socks[idx], MSG_ACK,
                          _SEQNO.pack(self._expected - 1))
                if mtype == MSG_END:
                    return
        finally:
            with cond:
                state['done'] = True
                cond.notify_all()
            for s in socks:
                try:
                    s.shutdown(socket.SHUT_RD)
                except OSError:
                    pass
            for t in threads:
                t.join(timeout=5.0)


# ---------------------------------------------------------------------------
# rejoin resume probe (bifrost_tpu.fabric; docs/fabric.md)
# ---------------------------------------------------------------------------

def query_resume(address, port, timeout=5.0):
    """Ask a listening bridge receiver how many frames per sequence
    name it has COMMITTED — the rejoin handshake of the whole-host
    failure choreography: a relaunched sender host replays only from
    this frontier, so the rejoined stream is lossless without
    duplicating frames the receiver already has.  Returns
    ``{seq_name: committed_frames}`` (empty for a fresh receiver).
    Raises ``ConnectionError``/``BridgeProtocolError`` when the
    receiver is unreachable or not a v2 endpoint."""
    sock = connect(address, port, timeout=timeout)
    try:
        sock.settimeout(timeout)
        hello = {'version': WIRE_VERSION, 'probe': True,
                 'session': 'probe-%s' % uuid.uuid4().hex[:8]}
        _send_msg(sock, MSG_HELLO, serialize_header(hello))
        mtype, payload = _recv_msg(sock)
        if mtype != MSG_HELLO_ACK:
            raise BridgeProtocolError(
                "resume probe expected HELLO_ACK, got type %d" % mtype)
        ack = deserialize_header(payload)
        resume = ack.get('resume') or {}
        return {str(k): int(v) for k, v in resume.items()
                if isinstance(v, (int, float))}
    finally:
        try:
            sock.close()
        except OSError:
            pass
