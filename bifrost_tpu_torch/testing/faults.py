"""Deterministic fault injection at the framework's seams (the JAX
package's ``bifrost_tpu/testing/faults.py``, with the same site names and
the same semantics).

The hot paths call :func:`fire` at well-defined seams; when no fault is
armed this is one module-global boolean test.  Tests (and operators
doing chaos drills) arm faults through the API::

    from bifrost_tpu_torch.testing import faults
    with faults.injected('xfer.result', count=1, after=2):
        pipeline.run()          # the third D2H completion raises

or through the environment (read by ``Pipeline.run``)::

    BF_FAULTS="xfer.result::1:2:0" python my_pipeline.py

Seams wired into the port (site names are stable API):

- ``ring.reserve``     writer-side span reservation (``Ring`` name)
- ``ring.acquire``     reader-side span acquisition (``Ring`` name)
- ``xfer.h2d``         host->device staging in the transfer engine
- ``xfer.d2h``         device->host readback issue
- ``xfer.result``      transfer-future completion (deferred D2H fills
                       fail here, exercising the ring-poison path)
- ``block.run``        each (re)entry of a block's main loop (block name)
- ``block.on_sequence`` before a block's ``on_sequence`` (block name)
- ``block.on_data``    before each gulp's ``on_data`` (block name)

Protocol-corruption seams, consumed through :func:`armed` (which
returns True instead of raising): each breaks the ring protocol on
purpose, in both ring cores, so tests can show that the ring-protocol
checker (``analysis.ringcheck``, ``BF_RINGCHECK=1``) catches it:

- ``ring.corrupt.double_commit``   commit the same write span twice
- ``ring.corrupt.double_release``  release the same read span twice
- ``ring.corrupt.acquire_uncommitted``  report an acquired span one frame
                       past the committed head
- ``ring.corrupt.guarantee_jump``  force a guaranteed reader's guarantee
                       to the head while it holds an open span
- ``ring.corrupt.poison_nowake``   poison without waking blocked spans
- ``ring.corrupt.resize_under_span``  report a storage re-layout to the
                       checker while spans are open

Transport seam: :class:`LinkCut` wraps a bridge sender's socket and cuts
the link after a given span frame, so that reconnect and resume
(retransmit, duplicate drop) can be driven the same way in any process.

A fault fires ``count`` times after skipping its first ``after``
matching calls; ``delay`` seconds of sleep are injected before the
exception (a delay with ``exc=None`` makes a pure stall).  ``match`` is a
substring test against the name the seam supplies (ring name; empty
matches all).
"""

from __future__ import annotations

import errno
import os
import socket
import struct
import threading
import time

__all__ = ['FaultInjected', 'inject', 'injected', 'clear', 'fire',
           'fired', 'arm_from_env', 'active', 'armed', 'LinkCut']


class FaultInjected(RuntimeError):
    """Default exception raised by an armed fault."""


class _Fault(object):
    __slots__ = ('site', 'match', 'exc', 'count', 'after', 'delay',
                 'fired')

    def __init__(self, site, match='', exc=FaultInjected, count=1,
                 after=0, delay=0.0):
        self.site = site
        self.match = match
        self.exc = exc
        self.count = int(count)
        self.after = int(after)
        self.delay = float(delay)
        self.fired = 0

    def _make_exc(self, site, name):
        exc = self.exc
        if exc is None:
            return None
        if isinstance(exc, BaseException):
            return exc
        if isinstance(exc, type) and issubclass(exc, BaseException):
            return exc("injected fault at %s (%s)" % (site, name))
        return exc(site, name)      # callable factory

    def __repr__(self):
        return ('_Fault(site=%r, match=%r, count=%d, after=%d, '
                'delay=%g, fired=%d)' % (self.site, self.match,
                                         self.count, self.after,
                                         self.delay, self.fired))


_lock = threading.Lock()
_faults = []
_active = False
_env_armed = False


def active():
    """Whether any fault is currently armed."""
    return _active


def inject(site, exc=FaultInjected, match='', count=1, after=0,
           delay=0.0):
    """Arm a fault at ``site``.

    ``exc`` may be an exception class (instantiated with a descriptive
    message), an exception instance (raised as-is, every firing), a
    callable ``f(site, name) -> exception``, or None for a delay-only
    fault.  Returns the armed fault object (its ``fired`` attribute
    counts firings).
    """
    global _active
    f = _Fault(site, match=match, exc=exc, count=count, after=after,
               delay=delay)
    with _lock:
        _faults.append(f)
        _active = True
    return f


class injected(object):
    """Context manager: arm a fault on entry, disarm it on exit."""

    def __init__(self, site, exc=FaultInjected, match='', count=1,
                 after=0, delay=0.0):
        self._args = (site, exc, match, count, after, delay)
        self.fault = None

    def __enter__(self):
        site, exc, match, count, after, delay = self._args
        self.fault = inject(site, exc=exc, match=match, count=count,
                            after=after, delay=delay)
        return self.fault

    def __exit__(self, *exc_info):
        remove(self.fault)
        return False


def remove(fault):
    """Disarm one fault."""
    global _active
    with _lock:
        try:
            _faults.remove(fault)
        except ValueError:
            pass
        if not _faults:
            _active = False


def clear():
    """Disarm every fault (tests call this between cases)."""
    global _active, _env_armed
    with _lock:
        del _faults[:]
        _active = False
        _env_armed = False


def fired(site=None):
    """Total firings, optionally restricted to one site."""
    with _lock:
        return sum(f.fired for f in _faults
                   if site is None or f.site == site)


def _consume(site, name):
    """Consume and return the first armed fault matching (site, name),
    or None — the one place the site/match/after/count bookkeeping
    lives (both :func:`fire` and :func:`armed` go through it)."""
    with _lock:
        for f in _faults:
            if f.site != site or f.match not in (name or ''):
                continue
            if f.after > 0:
                f.after -= 1
                continue
            if f.fired >= f.count:
                continue
            f.fired += 1
            return f
    return None


def fire(site, name=''):
    """Seam hook: fire the first matching armed fault.

    No-op (one boolean test) when nothing is armed.  Called by the
    framework at the sites documented in the module docstring; custom
    blocks may call it at their own seams too.
    """
    if not _active:
        return
    hit = _consume(site, name)
    if hit is None:
        return
    if hit.delay > 0:
        time.sleep(hit.delay)
    exc = hit._make_exc(site, name)
    if exc is not None:
        raise exc


def armed(site, name=''):
    """Corruption-seam hook: consume the first matching armed fault and
    return True, WITHOUT raising — the seam then performs its
    deliberate protocol violation itself.  No-op (False, one boolean
    test) when nothing is armed.  Count/after/match semantics are
    identical to :func:`fire` (shared :func:`_consume`); ``delay`` and
    ``exc`` are ignored."""
    if not _active:
        return False
    return _consume(site, name) is not None


def arm_from_env(env=None):
    """Arm faults described by ``BF_FAULTS``.

    Format: ``site[:match[:count[:after[:delay]]]]``, ``;``-separated
    for multiple faults; the exception is always :class:`FaultInjected`.
    Idempotent per process (re-arming requires :func:`clear`).
    """
    global _env_armed
    with _lock:
        if _env_armed:
            return
        _env_armed = True
    spec = (env if env is not None
            else os.environ.get('BF_FAULTS', '')).strip()
    if not spec:
        return
    for part in spec.split(';'):
        part = part.strip()
        if not part:
            continue
        bits = part.split(':')
        site = bits[0]
        match = bits[1] if len(bits) > 1 else ''
        try:
            count = int(bits[2]) if len(bits) > 2 and bits[2] else 1
            after = int(bits[3]) if len(bits) > 3 and bits[3] else 0
            delay = float(bits[4]) if len(bits) > 4 and bits[4] else 0.0
        except ValueError:
            raise ValueError("Malformed BF_FAULTS entry: %r" % part)
        inject(site, match=match, count=count, after=after, delay=delay)


class LinkCut(object):
    """Socket proxy for a bridge sender's connection that cuts the link
    right after the sender has handed over its ``after_spans``-th span
    frame (v1 or v2 framing, counted in ``sendmsg``).  From then on every
    send through the proxy raises ConnectionResetError; receives go dark
    as that frame starts (each raises once it returns), so the receiver
    commits the span but the sender never reads its ACK.  After the redial the sender retransmits
    the span and the receiver drops the duplicate.

    The cut link closes cleanly: ``shutdown`` only half-closes it and
    ``close`` reads what the peer still sends (its ACKs) until the peer
    hangs up, so that no unread byte turns the close into a reset that
    would discard the span's last bytes on their way.  Every other
    attribute is the wrapped socket's."""

    _SPAN = 2
    _FRAME = struct.Struct('<BQ')

    def __init__(self, sock, after_spans, close_timeout=30.0):
        self._sock = sock
        self._after = int(after_spans)
        self._close_timeout = float(close_timeout)
        self._spans = 0
        self._left = 0           # bytes of the frame being sent
        self._in_span = False
        self._dark = False       # receives raise from here on
        self.cut = threading.Event()

    def _reset(self):
        return ConnectionResetError(
            errno.ECONNRESET, 'bridge link cut after span frame %d'
            % self._after)

    def sendmsg(self, buffers, *args):
        if self.cut.is_set():
            raise self._reset()
        bufs = list(buffers)
        if not self._left and bufs:
            # a frame starts here: [u8 type][u64 length] heads it
            head = bytes(memoryview(bufs[0]).cast('B')[:self._FRAME.size])
            if len(head) == self._FRAME.size:
                mtype, length = self._FRAME.unpack(head)
                self._left = self._FRAME.size + length
                self._in_span = mtype == self._SPAN
                if self._in_span and self._spans + 1 >= self._after:
                    self._dark = True
        n = self._sock.sendmsg(bufs, *args)
        self._left = max(self._left - n, 0)
        if not self._left and self._in_span:
            # the whole span frame is handed over (a short write goes on
            # in the next call, which carries no head)
            self._in_span = False
            self._spans += 1
            if self._spans >= self._after:
                self.cut.set()
        return n

    def sendall(self, data, *args):
        if self.cut.is_set():
            raise self._reset()
        return self._sock.sendall(data, *args)

    def recv_into(self, view, *args):
        if self._dark:
            raise self._reset()
        n = self._sock.recv_into(view, *args)
        if self._dark:
            raise self._reset()
        return n

    def shutdown(self, how):
        if not self.cut.is_set():
            return self._sock.shutdown(how)
        try:
            self._sock.shutdown(socket.SHUT_WR)
        except OSError:
            pass

    def close(self):
        if self.cut.is_set():
            self.shutdown(socket.SHUT_RDWR)
            try:
                self._sock.settimeout(self._close_timeout)
                while self._sock.recv(1 << 16):
                    pass
            except OSError:
                pass
        self._sock.close()

    def __getattr__(self, name):
        return getattr(self._sock, name)
