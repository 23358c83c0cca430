"""Dynamic ring-protocol checker (``BF_RINGCHECK=1``), the port of
``bifrost_tpu/analysis/ringcheck.py``.

A shadow state machine hooked into the span lifecycle seams that both of
the port's ring cores share (the ``WriteSpan`` / ``ReadSpan`` /
``ReadSequence`` wrappers and ``Ring.poison``, ``Ring.request_resize``
and the storage re-layout): it replays every reserve, commit, acquire,
release and poison against its own model of what a correct ring may do,
and raises :class:`RingProtocolError` with the ring's recent span history
the moment the stream of events becomes impossible.

Invariants (``RingProtocolError.invariant``):

- ``commit_order`` / ``double_commit`` -- a span is committed once, and a
  partial commit is legal only on the newest outstanding reservation;
- ``guarantee_pin`` -- no reservation overwrites bytes at or after a
  guaranteed reader's pin (its oldest open span, else its released
  high-water mark), derived from the event stream itself;
- ``acquire_uncommitted`` -- an acquired span lies within the committed
  head;
- ``double_release`` -- a reader releases only spans it holds;
- ``poison_wake`` -- ``poison()`` wakes every blocked seam operation
  within ``BF_RINGCHECK_WAKE_SECS`` (default 2 s);
- ``resize_quiescence`` -- a storage re-layout happens with no span open.

A violation raises in the thread that made the illegal call (a wake
violation at the next seam touch on that ring) and is also kept on
:func:`violations` and counted on ``ringcheck.violations``.  With
``BF_RINGCHECK`` off (the default) each seam is one global read.  The
``ring.corrupt.*`` fault seams (``testing.faults``) break each invariant
on purpose so that tests show the checker catches it in both cores.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque

__all__ = ['RingProtocolError', 'enabled', 'reconfigure', 'set_enabled',
           'hook', 'violations', 'reset']


class RingProtocolError(RuntimeError):
    """A ring-protocol invariant was violated (BF_RINGCHECK=1).

    ``ring_name`` is the offending ring, ``invariant`` a stable slug of
    the violated rule (``commit_order``, ``double_commit``,
    ``double_release``, ``acquire_uncommitted``, ``guarantee_pin``,
    ``poison_wake``, ``resize_quiescence``), and the message embeds the
    ring's recent span-history trace."""

    def __init__(self, ring_name, invariant, detail, history=''):
        self.ring_name = ring_name
        self.invariant = invariant
        msg = ("BF-RINGCHECK: invariant %r violated on ring %r: %s"
               % (invariant, ring_name, detail))
        if history:
            msg += "\nrecent span history (oldest first):\n" + history
        super(RingProtocolError, self).__init__(msg)


def _env_enabled():
    return os.environ.get('BF_RINGCHECK', '0').strip() == '1'


def _env_wake_secs():
    try:
        return float(os.environ.get('BF_RINGCHECK_WAKE_SECS', '2.0'))
    except ValueError:
        return 2.0


_enabled = _env_enabled()
_viol_lock = threading.Lock()
_violations = []                  # RingProtocolError instances


def enabled():
    """Whether the checker is armed (one bool test on the hot seams)."""
    return _enabled


def reconfigure():
    """Re-read ``BF_RINGCHECK`` (Pipeline.run calls this so a long-lived
    process can toggle the checker between runs)."""
    global _enabled
    _enabled = _env_enabled()


def set_enabled(on):
    """Programmatic toggle (tests)."""
    global _enabled
    _enabled = bool(on)


def violations():
    """Every violation recorded so far (raised or deferred)."""
    with _viol_lock:
        return list(_violations)


def reset():
    """Clear the recorded-violation list (tests call this between
    cases; per-ring shadow state lives on the rings themselves and
    dies with them)."""
    with _viol_lock:
        del _violations[:]


def _record(exc):
    with _viol_lock:
        _violations.append(exc)
    try:
        from ..telemetry import counters
        counters.inc('ringcheck.violations')
    except Exception:
        pass


class _Reader(object):
    """Shadow state of one ReadSequence on one ring."""

    __slots__ = ('guarantee', 'opens', 'pin', 'release_high')

    def __init__(self, guarantee):
        self.guarantee = bool(guarantee)
        self.opens = []          # begins of OPEN read spans
        #: shadow of the reader's guarantee pin in absolute bytes;
        #: None until the first acquire makes it exact (the core seeds
        #: its pin with a tail clamp the shadow cannot see, so an
        #: earlier value could only be conservative and false-positive)
        self.pin = None
        self.release_high = None


class _Shadow(object):
    """Per-ring shadow state machine.  Holds NO reference to the ring
    (the ring owns the shadow); everything it needs arrives through the
    seam calls."""

    HISTORY = 128

    def __init__(self, ring_name):
        self.name = ring_name
        self.lock = threading.Lock()
        self.history = deque(maxlen=self.HISTORY)
        self.t0 = time.monotonic()
        #: open write spans in reserve order: [id -> dict] as a list of
        #: dicts {id, begin, nbyte, closed, commit}
        self.wspans = []
        #: committed head in absolute bytes (advanced by the in-order
        #: prefix of closed spans, mirroring the core's barrier)
        self.head = 0
        self.head_known = False   # becomes True at the first commit
        self.readers = {}         # id(rseq) -> _Reader
        self.poisoned = False
        #: blocked seam operations: token -> (op, thread, t_enter)
        self.pending = {}
        self._tok = 0
        #: violations detected asynchronously (poison-wake timer);
        #: raised at the next seam touch
        self.deferred = []

    # -- history -----------------------------------------------------------
    def _note(self, op, detail):
        self.history.append((time.monotonic() - self.t0,
                             threading.current_thread().name, op,
                             detail))

    def format_history(self, last=24):
        out = []
        for t, thr, op, detail in list(self.history)[-last:]:
            out.append("  t+%8.3fs [%s] %-14s %s" % (t, thr, op, detail))
        return '\n'.join(out)

    def _raise(self, invariant, detail):
        exc = RingProtocolError(self.name, invariant, detail,
                                self.format_history())
        self._note('VIOLATION', '%s: %s' % (invariant, detail))
        _record(exc)
        raise exc

    def _check_deferred(self):
        if self.deferred:
            exc = self.deferred.pop(0)
            raise exc

    # -- pending-op bookkeeping (poison-wake invariant) --------------------
    def _enter(self, op, detail):
        self._tok += 1
        tok = self._tok
        self.pending[tok] = (op, threading.current_thread().name,
                             time.monotonic())
        self._note(op + '.enter', detail)
        return tok

    def _exit(self, tok):
        self.pending.pop(tok, None)

    # -- writer side -------------------------------------------------------
    def reserve_enter(self, nbyte):
        with self.lock:
            self._check_deferred()
            return self._enter('reserve', 'nbyte=%d' % nbyte)

    def reserve_abort(self, tok):
        with self.lock:
            self._exit(tok)
            self._note('reserve.abort', '')

    def shed_advance(self, new_tail):
        """A ``drop_oldest`` overload shed forcibly advanced guaranteed
        readers' CORE guarantees up to ``new_tail`` — clamped at each reader's oldest open span.
        Mirror that in the shadow pins so the legitimately-admitted
        overwriting reserve is not flagged as a guarantee_pin
        violation (readers holding open spans keep their pin: the
        core clamped there too, so the reserve stays bounded by
        them)."""
        with self.lock:
            self._note('shed', 'new_tail=%d' % new_tail)
            for rd in self.readers.values():
                if rd.guarantee and rd.pin is not None \
                        and not rd.opens:
                    rd.pin = max(rd.pin, new_tail)

    def reserve_done(self, tok, span, begin, nbyte, ring_size):
        with self.lock:
            self._exit(tok)
            self._note('reserve', 'begin=%d nbyte=%d' % (begin, nbyte))
            self.wspans.append({'id': id(span), 'begin': begin,
                                'nbyte': nbyte, 'closed': False,
                                'commit': None})
            if self.poisoned or not ring_size:
                return
            # guarantee-pin invariant, end to end: the bytes this
            # reservation will overwrite (everything below its implied
            # new tail) must lie strictly before every guaranteed
            # reader's pin.  A core whose guarantee jumped forward past
            # a held span admits a reserve that lands here.
            new_tail = begin + nbyte - ring_size
            for rd in self.readers.values():
                if not rd.guarantee or rd.pin is None:
                    continue
                pin = min(rd.opens) if rd.opens else rd.pin
                if new_tail > pin:
                    self._raise(
                        'guarantee_pin',
                        'reserve [%d, %d) implies tail %d past a '
                        'guaranteed reader pinned at %d (open spans: '
                        '%s) — the writer is overwriting bytes a held '
                        'span still exports'
                        % (begin, begin + nbyte, new_tail, pin,
                           rd.opens or '[]'))

    def commit(self, span, commit_nbyte):
        with self.lock:
            self._check_deferred()
            sid = id(span)
            rec = None
            for r in self.wspans:
                if r['id'] == sid and not r['closed']:
                    rec = r
                    break
            if rec is None:
                self._raise(
                    'double_commit',
                    'commit of %d bytes for a span that is not an '
                    'open reservation (begin=%s) — double commit or '
                    'commit of a foreign span'
                    % (commit_nbyte,
                       getattr(span, '_begin', '?')))
            if commit_nbyte < rec['nbyte']:
                # partial commits truncate the reserve head: only the
                # newest outstanding reservation may do that
                newest = self.wspans[-1]
                if newest is not rec:
                    self._raise(
                        'commit_order',
                        'partial commit (%d < %d) of span begin=%d '
                        'while a later reservation (begin=%d) is '
                        'outstanding' % (commit_nbyte, rec['nbyte'],
                                         rec['begin'],
                                         newest['begin']))
            rec['closed'] = True
            rec['commit'] = commit_nbyte
            # apply the in-order prefix, mirroring the core's barrier
            while self.wspans and self.wspans[0]['closed']:
                r = self.wspans.pop(0)
                self.head = r['begin'] + r['commit']
                self.head_known = True
                if r['commit'] < r['nbyte']:
                    # truncation rolls later offsets back; drop stale
                    # shadow spans (there are none per the check above)
                    break
            self._note('commit', 'begin=%d nbyte=%d'
                       % (rec['begin'], commit_nbyte))

    def external_head(self, head):
        """Commits made past the span wrappers (the native capture engine
        commits through the C core): take the core's committed head."""
        with self.lock:
            if not self.head_known or head > self.head:
                self._note('commit.external', 'head=%d' % head)
                self.head = head
                self.head_known = True

    # -- reader side -------------------------------------------------------
    def reader_opened(self, rseq):
        with self.lock:
            self.readers[id(rseq)] = _Reader(
                getattr(rseq, 'guarantee', True))
            self._note('reader.open', 'guarantee=%s'
                       % getattr(rseq, 'guarantee', True))

    def reader_moved(self, rseq, new_begin):
        with self.lock:
            rd = self.readers.get(id(rseq))
            if rd is None:
                return
            self._note('reader.moved', 'begin=%d' % new_begin)
            if not rd.guarantee:
                return
            if rd.opens:
                rd.pin = min(rd.opens)
            elif rd.pin is not None:
                rd.pin = max(rd.pin, new_begin)

    def reader_closed(self, rseq):
        with self.lock:
            self.readers.pop(id(rseq), None)
            self._note('reader.close', '')

    def acquire_enter(self, rseq, want_begin):
        with self.lock:
            self._check_deferred()
            rd = self.readers.get(id(rseq))
            if rd is not None and rd.guarantee and not rd.opens:
                # mirror the core's pre-wait guarantee bump: with no
                # span open the pin may advance to the requested begin
                # (bounded by the committed head)
                bump = min(want_begin, self.head) if self.head_known \
                    else want_begin
                if rd.pin is not None:
                    rd.pin = max(rd.pin, bump)
            return self._enter('acquire', 'want=%d' % want_begin)

    def acquire_abort(self, tok):
        with self.lock:
            self._exit(tok)
            self._note('acquire.abort', '')

    def acquire_done(self, tok, rseq, begin, nbyte):
        with self.lock:
            self._exit(tok)
            self._note('acquire', 'begin=%d nbyte=%d' % (begin, nbyte))
            if nbyte and self.head_known and not self.poisoned \
                    and begin + nbyte > self.head:
                self._raise(
                    'acquire_uncommitted',
                    'acquired span [%d, %d) extends past the committed '
                    'head %d — the reader was handed frames no commit '
                    'ever published' % (begin, begin + nbyte, self.head))
            rd = self.readers.get(id(rseq))
            if rd is None:
                rd = self.readers[id(rseq)] = _Reader(
                    getattr(rseq, 'guarantee', True))
            rd.opens.append(begin)
            if rd.guarantee:
                rd.pin = min(rd.opens)

    def release(self, rseq, begin, nbyte=0):
        with self.lock:
            self._check_deferred()
            rd = self.readers.get(id(rseq))
            if rd is None or begin not in rd.opens:
                self._raise(
                    'double_release',
                    'release of span begin=%d that this reader does '
                    'not hold (open spans: %s) — double release or '
                    'release of a foreign span'
                    % (begin, rd.opens if rd is not None else None))
            rd.opens.remove(begin)
            # the consumed frontier advances to the span's END (the
            # core's release does the same): a released span's bytes
            # were read, so the pin may move past them
            rel = begin + max(int(nbyte or 0), 0)
            rd.release_high = rel if rd.release_high is None \
                else max(rd.release_high, rel)
            if rd.guarantee and rd.pin is not None:
                rd.pin = min(rd.opens) if rd.opens \
                    else max(rd.pin, rd.release_high)
            self._note('release', 'begin=%d' % begin)

    # -- resize (the deferred resize protocol) -----------------------------
    def resize_requested(self, contig, total):
        with self.lock:
            self._check_deferred()
            self._note('resize.request', 'contig=%d total=%d'
                       % (contig, total))

    def resize_applied(self, nwrite_open, nread_open, size):
        """A storage re-layout is about to happen: assert the shadow
        state agrees the ring is quiescent (no open write reservation,
        no open read span) — a core applying a resize under a live
        span is handing out views that are about to dangle."""
        with self.lock:
            self._check_deferred()
            open_reads = sum(len(rd.opens)
                             for rd in self.readers.values())
            if self.wspans or open_reads:
                self._raise(
                    'resize_quiescence',
                    'storage re-layout to size=%d while spans are '
                    'open (write reservations: %d shadow / %d core, '
                    'open read spans: %d shadow / %d core) — a live '
                    "span's zero-copy view would dangle; resizes "
                    'must defer until the oldest open span releases'
                    % (size, len(self.wspans), nwrite_open,
                       open_reads, nread_open))
            self._note('resize.apply', 'size=%d' % size)

    # -- poison ------------------------------------------------------------
    def poisoned_now(self):
        with self.lock:
            if self.poisoned:
                return
            self.poisoned = True
            blocked = dict(self.pending)
            self._note('poison', 'pending=%d' % len(blocked))
        if not blocked:
            return
        wake = _env_wake_secs()

        def check():
            with self.lock:
                stuck = [(tok, info) for tok, info in blocked.items()
                         if tok in self.pending]
                if not stuck:
                    return
                detail = ', '.join(
                    '%s in thread %s (blocked %.1fs)'
                    % (op, thr, time.monotonic() - t)
                    for _tok, (op, thr, t) in stuck)
                exc = RingProtocolError(
                    self.name, 'poison_wake',
                    'poison did not wake every blocked span within '
                    '%.1fs: %s' % (wake, detail),
                    self.format_history())
                self._note('VIOLATION', 'poison_wake: %s' % detail)
                _record(exc)
                # raise at the next seam touch on this ring (the
                # blocked thread itself cannot be interrupted from
                # here)
                self.deferred.append(exc)

        t = threading.Timer(wake, check)
        t.daemon = True
        t.start()


def hook(ring):
    """The ring's shadow checker, or None when BF_RINGCHECK is off.
    The shadow is created lazily and stored on the ring instance, so
    both cores (NativeRing extends Ring) share one code path and a
    disabled checker costs one bool test."""
    if not _enabled:
        return None
    shadow = ring.__dict__.get('_rc_shadow')
    if shadow is None:
        shadow = _Shadow(getattr(ring, 'name', '?'))
        shadow = ring.__dict__.setdefault('_rc_shadow', shadow)
    return shadow
