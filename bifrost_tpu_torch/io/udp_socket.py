"""UDP socket helpers, the port of ``bifrost_tpu/io/udp_socket.py`` (reference: src/Socket.cpp, src/udp_socket.cpp,
python/bifrost/udp_socket.py, address.py).

Batched receive: :meth:`UDPSocket.recv_mmsg` drains many datagrams per
syscall via libc ``recvmmsg`` (the reference's batching shim:
src/Socket.hpp:145-158), which is what lets a Python capture loop
approach line rate — the per-packet cost drops from one syscall +
bytes-object to an amortized slice of a preallocated buffer.
"""

from __future__ import annotations

import ctypes
import errno as errno_mod
import os
import select
import socket
import time as time_mod

__all__ = ['Address', 'UDPSocket', 'retry_transient',
           'retry_backoff_s']

#: errnos worth retrying with backoff: interrupted syscalls and the
#: ICMP port-unreachable a connected UDP socket reports as
#: ECONNREFUSED when the peer briefly restarts
_TRANSIENT_ERRNOS = frozenset({errno_mod.EINTR, errno_mod.ECONNREFUSED})


def _retry_budget():
    try:
        return int(os.environ.get('BF_IO_RETRY_MAX', '') or 8)
    except ValueError:
        return 8


def _retry_backoff():
    try:
        return float(os.environ.get('BF_IO_RETRY_BACKOFF', '') or 0.005)
    except ValueError:
        return 0.005


def _retry_cap():
    try:
        return float(os.environ.get('BF_IO_RETRY_CAP', '') or 0.25)
    except ValueError:
        return 0.25


def retry_backoff_s(attempt, backoff=None, cap=None):
    """Sleep length for retry ``attempt`` (1-based): FULL-JITTER
    exponential backoff — ``uniform(0, min(cap, base * 2**(n-1)))``.
    A fleet of endpoints retrying a restarted peer on a fixed cadence
    arrives in synchronized waves (thundering herd); full jitter
    de-correlates them while keeping the exponential envelope (cap
    ``BF_IO_RETRY_CAP``, default 0.25 s; the bridge redial path passes
    its own, larger cap)."""
    import random
    if backoff is None:
        backoff = _retry_backoff()
    if cap is None:
        cap = _retry_cap()
    return random.uniform(0.0, min(backoff * (2 ** (attempt - 1)),
                                   cap))


def retry_transient(fn, budget=None, backoff=None, extra=()):
    """Run ``fn()`` retrying transient socket errnos (EINTR /
    ECONNREFUSED) with full-jitter exponential backoff, up to a capped
    budget (``BF_IO_RETRY_MAX``, default 8; base
    ``BF_IO_RETRY_BACKOFF`` seconds, default 5ms; per-sleep cap
    ``BF_IO_RETRY_CAP``, default 0.25 s).  Retries are counted on the
    ``io.socket_retries`` telemetry counter; budget exhaustion
    re-raises the last error.  EAGAIN/EWOULDBLOCK are NOT retried here
    — on a nonblocking/timeout socket they mean "no data", which
    callers handle as a normal condition.  ``extra`` names additional
    errnos the CALLER knows are transient in its context (the TCP ring
    bridge retries ETIMEDOUT on cross-host dials, io/bridge.py)."""
    if budget is None:
        budget = _retry_budget()
    if backoff is None:
        backoff = _retry_backoff()
    attempt = 0
    while True:
        try:
            return fn()
        except OSError as e:
            if e.errno not in _TRANSIENT_ERRNOS and \
                    e.errno not in extra:
                raise
            attempt += 1
            if attempt > budget:
                raise        # budget exhausted: surface the real error
            from ..telemetry import counters
            counters.inc('io.socket_retries')
        time_mod.sleep(retry_backoff_s(attempt, backoff))


class _iovec(ctypes.Structure):
    _fields_ = [('iov_base', ctypes.c_void_p),
                ('iov_len', ctypes.c_size_t)]


class _msghdr(ctypes.Structure):
    _fields_ = [('msg_name', ctypes.c_void_p),
                ('msg_namelen', ctypes.c_uint),
                ('msg_iov', ctypes.POINTER(_iovec)),
                ('msg_iovlen', ctypes.c_size_t),
                ('msg_control', ctypes.c_void_p),
                ('msg_controllen', ctypes.c_size_t),
                ('msg_flags', ctypes.c_int)]


class _mmsghdr(ctypes.Structure):
    _fields_ = [('msg_hdr', _msghdr),
                ('msg_len', ctypes.c_uint)]


_MSG_DONTWAIT = 0x40
#: pass MSG_TRUNC in recvmmsg flags so msg_len reports each datagram's
#: TRUE length even when the iovecs are smaller (runt/oversize
#: detection on the zero-copy scatter path)
_MSG_TRUNC = 0x20

_libc = None


def _get_libc():
    global _libc
    if _libc is None:
        _libc = ctypes.CDLL(None, use_errno=True)
    return _libc


def recvmmsg_available():
    try:
        return hasattr(_get_libc(), 'recvmmsg')
    except Exception:
        return False


class Address(object):
    """Resolved socket address (reference: python/bifrost/address.py)."""

    def __init__(self, address, port, family=socket.AF_INET):
        self.address = address
        self.port = port
        self.family = family
        infos = socket.getaddrinfo(address, port, family,
                                   socket.SOCK_DGRAM)
        self._sockaddr = infos[0][4]

    @property
    def sockaddr(self):
        return self._sockaddr

    @property
    def mtu(self):
        return 9000 if self.address.startswith('127.') else 1500

    def __str__(self):
        return '%s:%d' % self._sockaddr[:2]


class UDPSocket(object):
    """Thin RAII UDP socket (reference: python/bifrost/udp_socket.py)."""

    def __init__(self, reuseport=False):
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        # SO_REUSEPORT lets N capture workers bind the SAME addr:port,
        # with the kernel flow-hashing datagrams across their private
        # queues (the sharded-capture fan-out).
        # Best-effort: callers check .reuseport before relying on the
        # exclusive-queue property.
        self.reuseport = False
        if reuseport:
            try:
                self.sock.setsockopt(socket.SOL_SOCKET,
                                     socket.SO_REUSEPORT, 1)
                self.reuseport = True
            except (AttributeError, OSError):
                pass
        try:
            self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF,
                                 1 << 22)
        except OSError:
            pass
        self._timeout = None

    @classmethod
    def from_fd(cls, fd):
        """Wrap a dup() of an existing socket fd: shares the SAME
        kernel receive queue but carries its own Python-side state
        (mmsg buffer caches, timeout) — the sharded capture's
        N-threads-one-socket fallback needs private per-worker receive
        buffers even when the queue is shared."""
        obj = cls.__new__(cls)
        obj.sock = socket.socket(fileno=os.dup(fd))
        obj.reuseport = False
        obj._timeout = None
        return obj

    def bind(self, addr):
        self.sock.bind(addr.sockaddr)
        return self

    def attach_reuseport_cbpf(self, insns):
        """Attach a classic-BPF selector to this socket's REUSEPORT
        group: the kernel runs the program over each datagram's UDP
        payload and the return value picks the group member (by join
        order) that receives it.  Deterministic steering — e.g. by a
        source-id byte in the packet header — replaces the default
        4-tuple flow hash, so a multi-worker capture can pin each
        wire source to one worker's queue regardless of what ports
        the senders happen to use.  ``insns`` is a list of
        (code, jt, jf, k) classic-BPF instructions; raises OSError
        when the kernel rejects the program."""
        class _Filter(ctypes.Structure):
            _fields_ = [('code', ctypes.c_uint16),
                        ('jt', ctypes.c_uint8),
                        ('jf', ctypes.c_uint8),
                        ('k', ctypes.c_uint32)]

        class _Fprog(ctypes.Structure):
            _fields_ = [('len', ctypes.c_uint16),
                        ('filter', ctypes.POINTER(_Filter))]
        arr = (_Filter * len(insns))(*[_Filter(*i) for i in insns])
        prog = _Fprog(len(insns), arr)
        SO_ATTACH_REUSEPORT_CBPF = getattr(
            socket, 'SO_ATTACH_REUSEPORT_CBPF', 51)
        self.sock.setsockopt(socket.SOL_SOCKET,
                             SO_ATTACH_REUSEPORT_CBPF, bytes(prog))

    def connect(self, addr):
        self.sock.connect(addr.sockaddr)
        return self

    def set_timeout(self, secs):
        self._timeout = secs
        self.sock.settimeout(secs)

    def fileno(self):
        return self.sock.fileno()

    def recv_into(self, buf):
        return retry_transient(lambda: self.sock.recv_into(buf))

    def recv(self, nbyte=65536):
        return retry_transient(lambda: self.sock.recv(nbyte))

    # -- batched receive ---------------------------------------------------
    def _mmsg_setup(self, vlen, pkt_size):
        bufs = ctypes.create_string_buffer(vlen * pkt_size)
        iovecs = (_iovec * vlen)()
        hdrs = (_mmsghdr * vlen)()
        base = ctypes.addressof(bufs)
        for i in range(vlen):
            iovecs[i].iov_base = base + i * pkt_size
            iovecs[i].iov_len = pkt_size
            hdrs[i].msg_hdr.msg_name = None
            hdrs[i].msg_hdr.msg_namelen = 0
            hdrs[i].msg_hdr.msg_iov = ctypes.pointer(iovecs[i])
            hdrs[i].msg_hdr.msg_iovlen = 1
            hdrs[i].msg_hdr.msg_control = None
            hdrs[i].msg_hdr.msg_controllen = 0
        self._mmsg = (vlen, pkt_size, bufs, iovecs, hdrs)

    def recv_mmsg_raw(self, vlen, pkt_size):
        """Receive up to ``vlen`` datagrams of at most ``pkt_size`` bytes
        in ONE ``recvmmsg`` syscall (reference shim: Socket.hpp:145-158).

        Waits for readability up to the socket timeout, then drains
        nonblockingly.  Returns ``(buffer, lengths)`` — the whole reused
        receive buffer (fixed ``pkt_size`` stride) plus per-packet
        lengths, for zero-copy vectorized decoding — or (None, None) on
        timeout.  Transient errnos (EINTR, ECONNREFUSED) are retried
        with backoff and counted on ``io.socket_retries``; other real
        errnos raise, like the per-packet recv path."""
        mm = getattr(self, '_mmsg', None)
        if mm is None or mm[0] != vlen or mm[1] != pkt_size:
            self._mmsg_setup(vlen, pkt_size)
            mm = self._mmsg
        _, _, bufs, _, hdrs = mm
        ready, _, _ = select.select([self.sock], [], [], self._timeout)
        if not ready:
            return None, None

        def _drain():
            n = _get_libc().recvmmsg(self.sock.fileno(), hdrs, vlen,
                                     _MSG_DONTWAIT, None)
            if n < 0:
                err = ctypes.get_errno()
                if err in (errno_mod.EAGAIN, errno_mod.EWOULDBLOCK):
                    return 0
                raise OSError(err, 'recvmmsg failed')
            return n

        n = retry_transient(_drain)
        if n == 0:
            return None, None
        return memoryview(bufs), [hdrs[i].msg_len for i in range(n)]

    # -- zero-copy split scatter -------------------------------------------
    def _scatter_setup(self, vlen, head_size, pay_size):
        sidecar = ctypes.create_string_buffer(vlen * head_size)
        iovecs = (_iovec * (2 * vlen))()
        hdrs = (_mmsghdr * vlen)()
        sbase = ctypes.addressof(sidecar)
        iov_size = ctypes.sizeof(_iovec)
        for i in range(vlen):
            iovecs[2 * i].iov_base = sbase + i * head_size
            iovecs[2 * i].iov_len = head_size
            iovecs[2 * i + 1].iov_base = None
            iovecs[2 * i + 1].iov_len = pay_size
            hdrs[i].msg_hdr.msg_name = None
            hdrs[i].msg_hdr.msg_namelen = 0
            hdrs[i].msg_hdr.msg_iov = ctypes.cast(
                ctypes.byref(iovecs, 2 * i * iov_size),
                ctypes.POINTER(_iovec))
            hdrs[i].msg_hdr.msg_iovlen = 2
            hdrs[i].msg_hdr.msg_control = None
            hdrs[i].msg_hdr.msg_controllen = 0
        # numpy view over the iovec table: an _iovec is two native
        # words, so (2*vlen, 2) uint64 — column 0 of the odd rows holds
        # the payload pointers, poked VECTORIZED per batch
        import numpy as _np
        iov_np = _np.frombuffer(iovecs, dtype=_np.uint64).reshape(
            2 * vlen, 2)
        self._scat = (vlen, head_size, pay_size, sidecar, iovecs,
                      hdrs, iov_np)

    def recv_mmsg_scatter(self, addrs, head_size, pay_size):
        """Consume up to ``len(addrs)`` datagrams in ONE ``recvmmsg``,
        SPLITTING each across two iovecs: the wire header lands in an
        internal per-socket sidecar buffer (``head_size`` bytes per
        row) and the payload lands DIRECTLY at the caller-supplied
        memory address ``addrs[i]`` (``pay_size`` bytes capacity) — no
        staging copy; this is the zero-copy capture scatter
        (the JAX package's docs/networking.md, "Wire-rate capture").

        ``addrs`` is a uint64 array/sequence of raw destination
        addresses the caller guarantees exclusive and alive across the
        call (the capture engine's span-cell claims).  Nonblocking:
        the caller selects for readability first.  Returns
        ``(sidecar_memoryview, lengths)`` where ``lengths`` are TRUE
        datagram lengths (``MSG_TRUNC``: a length != the expected
        frame size marks a runt/oversize whose payload cell must be
        repaired), or ``(None, None)`` when nothing was queued."""
        vlen = len(addrs)
        sc = getattr(self, '_scat', None)
        if sc is None or sc[0] < vlen or sc[1] != head_size or \
                sc[2] != pay_size:
            self._scatter_setup(max(vlen, sc[0] if sc else 0),
                                head_size, pay_size)
            sc = self._scat
        _, _, _, sidecar, _, hdrs, iov_np = sc
        import numpy as _np
        iov_np[1:2 * vlen:2, 0] = _np.asarray(addrs, _np.uint64)

        def _drain():
            n = _get_libc().recvmmsg(
                self.sock.fileno(), hdrs, vlen,
                _MSG_DONTWAIT | _MSG_TRUNC, None)
            if n < 0:
                err = ctypes.get_errno()
                if err in (errno_mod.EAGAIN, errno_mod.EWOULDBLOCK):
                    return 0
                raise OSError(err, 'recvmmsg (scatter) failed')
            return n

        n = retry_transient(_drain)
        if n == 0:
            return None, None
        return memoryview(sidecar), [hdrs[i].msg_len for i in range(n)]

    def recv_mmsg(self, vlen, pkt_size):
        """recv_mmsg_raw + per-packet memoryview slicing (slices are
        valid until the next call)."""
        buf, lengths = self.recv_mmsg_raw(vlen, pkt_size)
        if buf is None:
            return None
        return [buf[i * pkt_size: i * pkt_size + lengths[i]]
                for i in range(len(lengths))]

    def send_mmsg(self, packets):
        """Send many datagrams in ONE ``sendmmsg`` syscall (connected
        socket).  Returns the number actually sent.  The scatter/gather
        structures are cached across calls with matching sizes, so the
        steady-state cost is one memcpy per packet + one syscall."""
        vlen = len(packets)
        if not vlen:
            return 0
        sizes = tuple(len(p) for p in packets)
        cached = getattr(self, '_smsg', None)
        if cached is None or cached[0] != sizes:
            total = sum(sizes)
            buf = ctypes.create_string_buffer(total)
            iovecs = (_iovec * vlen)()
            hdrs = (_mmsghdr * vlen)()
            base = ctypes.addressof(buf)
            off = 0
            for i, sz in enumerate(sizes):
                iovecs[i].iov_base = base + off
                iovecs[i].iov_len = sz
                hdrs[i].msg_hdr.msg_iov = ctypes.pointer(iovecs[i])
                hdrs[i].msg_hdr.msg_iovlen = 1
                off += sz
            offs, off = [], 0
            for sz in sizes:
                offs.append(off)
                off += sz
            self._smsg = cached = (sizes, buf, iovecs, hdrs, offs)
        _, buf, _, hdrs, offs = cached
        view = memoryview(buf).cast('B')
        for i, p in enumerate(packets):
            view[offs[i]:offs[i] + sizes[i]] = bytes(p) \
                if not isinstance(p, (bytes, bytearray, memoryview)) else p
        # Loop on partial sends and retry EAGAIN/EINTR, mirroring the
        # native transmit engine's flush(); other errnos raise instead
        # of silently dropping the batch tail.
        import errno as errno_mod
        import time as time_mod
        libc = _get_libc()
        fd = self.sock.fileno()
        hdr_size = ctypes.sizeof(_mmsghdr)
        base = ctypes.addressof(hdrs)
        # honor the socket timeout like recv_mmsg_raw does: on expiry
        # return the partial count instead of spinning on EAGAIN
        deadline = (time_mod.monotonic() + self._timeout) \
            if self._timeout is not None else None
        sent = 0
        while sent < vlen:
            ctypes.set_errno(0)
            n = libc.sendmmsg(
                fd, ctypes.cast(base + sent * hdr_size,
                                ctypes.POINTER(_mmsghdr)),
                vlen - sent, 0)
            if n < 0:
                err = ctypes.get_errno()
                if err in (errno_mod.EAGAIN, errno_mod.EWOULDBLOCK):
                    wait = 0.01
                    if deadline is not None:
                        wait = deadline - time_mod.monotonic()
                        if wait <= 0:
                            break
                        wait = min(wait, 0.01)
                    select.select([], [fd], [], wait)
                    continue
                if err == errno_mod.EINTR:
                    continue
                raise OSError(err, "sendmmsg: " + os.strerror(err))
            sent += n
        return sent

    def send(self, data):
        return self.sock.send(data)

    def close(self):
        self.sock.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
