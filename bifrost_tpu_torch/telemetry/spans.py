"""Gulp-span tracing: per-thread event buffers, Chrome trace-event
export, and the flight recorder (the JAX package's
``bifrost_tpu/telemetry/spans.py``).

Every instrumented operation (block compute in ``pipeline.py``, H2D and
D2H transfer time in ``xfer.py``) records one complete span (name,
category, start, duration, args) into a bounded per-thread buffer:
recording takes no lock (the buffer is ``threading.local``), so tracing
stays cheap enough for the gulp hot path.

- **Chrome trace export**: ``BF_TRACE_FILE=trace.json`` makes
  ``Pipeline.run`` write a Chrome trace-event JSON on exit (one track
  per block thread), loadable in Perfetto or ``chrome://tracing``.
  Compute spans carry ``{'seq': sequence, 'gulp': index}`` args, so a
  gulp can be followed across blocks.
- **flight recorder**: :func:`enable_flight_recorder` turns recording on
  without a trace file, and :func:`flight_record` renders the most
  recent spans of every thread as a text timeline.
- **cross-host clocks**: each bridge handshake registers its session
  (:func:`note_peer_clock`, the sender with the ping-estimated offsets),
  and the export carries them under ``otherData.bf_clock``
  (:func:`clock_info`), so that two hosts' traces can be joined on one
  clock.

``BF_SPAN_BUFFER`` bounds events kept per thread (default 65536; the
buffer is a ring, the oldest events fall off).  Timestamps are
microseconds on the ``time.perf_counter`` clock, relative to process
start.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque

__all__ = ['enabled', 'trace_file', 'span', 'record',
           'record_elapsed', 'now_us', 'configure', 'reconfigure',
           'enable_flight_recorder', 'disable_flight_recorder',
           'export', 'export_if_configured', 'flight_record',
           'prune_dead_buffers', 'reset', 'events',
           'dropped_spans', 'note_peer_clock', 'clock_info',
           'flight_events']

DEFAULT_BUFFER = 65536
#: per-thread buffer size in flight-recorder-only mode (no trace
#: file): the only consumer reads the last ~32 spans per thread, so a
#: full-size export buffer would be pure waste
FLIGHT_BUFFER = 256
#: dead-thread buffers kept for export before the oldest are pruned
MAX_BUFFERS = 512

_t0 = time.perf_counter()

_config_lock = threading.Lock()
_configured = False
_trace_file = None
_buf_cap = DEFAULT_BUFFER
_flight = 0              # recorder-only refcount
_enabled = False
#: configuration generation — bumped on every (re)configure and
#: flight-recorder toggle so live threads rebuild their buffers with
#: the current capacity instead of keeping a stale maxlen forever
_gen = 0

_tls = threading.local()
_buffers_lock = threading.Lock()
_buffers = []            # [(threading.Thread, deque, drops:[int])]
#: drop counts inherited from PRUNED (dead-thread) buffers, so
#: ``dropped_spans`` stays monotonic across Pipeline.run's
#: prune_dead_buffers calls — it is exported as a cumulative counter
#: (Prometheus rate() breaks on a counter that decreases)
_dropped_retired = 0

_clock_lock = threading.Lock()
_sessions = {}           # session -> {'role', 'offset_us', 'rtt_us', ...}


def now_us():
    """Microseconds since process start on the span clock."""
    return (time.perf_counter() - _t0) * 1e6


def configure():
    """Read ``BF_TRACE_FILE`` / ``BF_SPAN_BUFFER`` (first call only;
    use :func:`reconfigure` to force a re-read)."""
    global _configured, _trace_file, _buf_cap, _enabled, _gen
    with _config_lock:
        if _configured:
            return
        _trace_file = os.environ.get('BF_TRACE_FILE') or None
        try:
            _buf_cap = max(int(os.environ.get('BF_SPAN_BUFFER', '')
                               or DEFAULT_BUFFER), 16)
        except ValueError:
            _buf_cap = DEFAULT_BUFFER
        _enabled = bool(_trace_file) or _flight > 0
        _gen += 1
        _configured = True


def reconfigure():
    """Re-read the environment (tests / long-lived operator processes
    toggling tracing without a restart — also reached via
    ``bifrost_tpu_torch.trace.reset()``)."""
    global _configured
    with _config_lock:
        _configured = False
    configure()


def enable_flight_recorder():
    """Turn span recording on without a trace file (the flight
    recorder).  Refcounted: pair every call with
    :func:`disable_flight_recorder` so a long-lived process is not left
    recording forever."""
    global _flight, _enabled, _gen
    with _config_lock:
        _flight += 1
        _enabled = True
        _gen += 1


def disable_flight_recorder():
    """Drop one flight-recorder hold; recording stays on while any
    hold remains or a trace file is configured.  Already-buffered events
    remain readable."""
    global _flight, _enabled, _gen
    with _config_lock:
        _flight = max(_flight - 1, 0)
        _enabled = bool(_trace_file) or _flight > 0
        _gen += 1


def enabled():
    """Whether spans are being recorded (cheap hot-path check)."""
    if not _configured:
        configure()
    return _enabled


def trace_file():
    if not _configured:
        configure()
    return _trace_file


def _buf():
    old = getattr(_tls, 'buf', None)
    if old is not None and getattr(_tls, 'gen', None) == _gen:
        return old, _tls.drops
    # (re)build this thread's buffer at the CURRENT capacity: flight-
    # recorder-only mode needs just the recent tail, a configured
    # trace file gets the full export buffer — and a reconfigure must
    # apply to threads that outlive it (the long-lived-process toggle
    # flow), so stale-generation buffers are migrated, keeping their
    # newest events
    cap = _buf_cap if _trace_file else min(_buf_cap, FLIGHT_BUFFER)
    b = deque(old if old is not None else (), maxlen=cap)
    drops = getattr(_tls, 'drops', None)
    if drops is None:
        # a one-int list, shared by reference with the registry so the
        # owning thread bumps it lock-free and readers see it
        drops = [0]
    _tls.buf = b
    _tls.gen = _gen
    _tls.drops = drops
    t = threading.current_thread()
    with _buffers_lock:
        if old is not None:
            # same thread's buffer migrating to a new capacity: its
            # drops list is carried over, so no retired accumulation
            _buffers[:] = [e for e in _buffers if e[1] is not old]
        if len(_buffers) >= MAX_BUFFERS:
            # prune every dead thread's buffer so a long-lived
            # process running many pipelines cannot accumulate
            # unbounded RETIRED buffers.  Live threads are never
            # dropped — a process keeping > MAX_BUFFERS threads
            # simultaneously alive holds that many buffers by
            # necessity (the cap is for retirees only).
            _retire_locked(lambda e: e[0].is_alive())
        _buffers.append((t, b, drops))
    return b, drops


def _retire_locked(keep):
    """Drop registry entries failing ``keep``, folding their drop
    counts into the retired total (callers hold _buffers_lock)."""
    global _dropped_retired
    _dropped_retired += sum(e[2][0] for e in _buffers if not keep(e))
    _buffers[:] = [e for e in _buffers if keep(e)]


def _append(ev):
    """Append one event to this thread's buffer, counting the event it
    evicts when the ring is saturated: overflow used to be silent, and
    a flight record / trace that quietly lost its oldest spans reads
    as 'nothing happened before this' (the ``trace.dropped_spans``
    counter in ``telemetry.snapshot()`` says otherwise)."""
    b, drops = _buf()
    if b.maxlen is not None and len(b) >= b.maxlen:
        drops[0] += 1
    b.append(ev)


def dropped_spans():
    """Total spans evicted by per-thread buffer overflow across the
    process, INCLUDING threads whose buffers were since pruned — the
    count is cumulative/monotonic, as a counter export requires
    (saturation indicator: raise ``BF_SPAN_BUFFER`` or export more
    often when this grows)."""
    with _buffers_lock:
        return _dropped_retired + sum(e[2][0] for e in _buffers)


def _drain(buf):
    """Copy a (possibly foreign) thread's deque.  The owning thread
    appends without a lock; deque appends are atomic but iterating
    during one raises RuntimeError — retry, then fall back to an
    item-by-item best-effort copy."""
    for _ in range(4):
        try:
            return list(buf)
        except RuntimeError:
            continue
    out = []
    try:
        for ev in buf.copy():
            out.append(ev)
    except RuntimeError:
        pass
    return out


def record(name, cat, ts_us, dur_us, args=None):
    """Record one complete span (timestamps from :func:`now_us`).
    No-op when recording is disabled."""
    if not enabled():
        return
    _append((name, cat, ts_us, dur_us, args))


def record_elapsed(name, cat, dt_s, **args):
    """Record a span that ends NOW and lasted ``dt_s`` seconds — the
    one-liner for instrumentation sites that already timed an
    operation with ``time.perf_counter`` (ring waits, transfers)."""
    if not enabled():
        return
    dur = dt_s * 1e6
    _append((name, cat, now_us() - dur, dur, args or None))


def prune_dead_buffers():
    """Drop retired (dead-thread) buffers — ``Pipeline.run`` calls
    this at startup so a fresh run's trace export / flight record is
    not contaminated by earlier runs' threads.  Live threads
    (including concurrently running pipelines) are untouched."""
    with _buffers_lock:
        _retire_locked(lambda e: e[0].is_alive())


# ---------------------------------------------------------------------------
# cross-host clock correlation
# ---------------------------------------------------------------------------

def note_peer_clock(session, role, offset_us=None, rtt_us=None,
                    wall_offset_ns=None):
    """Register a bridge session this process took part in.

    The sender passes the offsets its handshake ping estimated
    (``offset_us``: the receiver's span clock less the sender's at the
    same instant, ``rtt_us``: the round trip it rode on,
    ``wall_offset_ns``: the same for the wall clock); the receiver
    registers with its role only.  A re-registration keeps the estimate
    of the lowest round trip, and never replaces an estimate by none."""
    with _clock_lock:
        cur = _sessions.get(session)
        if cur is not None and offset_us is not None \
                and cur.get('rtt_us') is not None \
                and rtt_us is not None \
                and rtt_us >= cur['rtt_us']:
            return
        entry = {'role': role}
        if offset_us is not None:
            entry['offset_us'] = round(float(offset_us), 3)
        if rtt_us is not None:
            entry['rtt_us'] = round(float(rtt_us), 3)
        if wall_offset_ns is not None:
            entry['wall_offset_ns'] = int(wall_offset_ns)
        if cur is not None and 'offset_us' not in entry \
                and 'offset_us' in cur:
            return
        _sessions[session] = entry


def clock_info():
    """This process's clock metadata for the trace export: host, pid and
    every bridge session seen (with the sender's estimates)."""
    import socket as socket_mod
    with _clock_lock:
        sessions = {k: dict(v) for k, v in _sessions.items()}
    return {'host': socket_mod.gethostname(), 'pid': os.getpid(),
            'sessions': sessions}


class span(object):
    """With-block recording one complete span::

        with spans.span('fft.on_data', 'compute', seq=0, gulp=3):
            ...

    The span closes (and is recorded) on ANY exit — exceptions from
    fault injection or real failures still produce a complete,
    correctly nested event, which is what makes the flight recorder
    trustworthy around crashes."""

    __slots__ = ('name', 'cat', 'args', 't0')

    def __init__(self, name, cat='', **args):
        self.name = name
        self.cat = cat
        self.args = args or None
        self.t0 = None

    def __enter__(self):
        if enabled():
            self.t0 = now_us()
        return self

    def __exit__(self, *exc):
        if self.t0 is not None:
            t1 = now_us()
            _append((self.name, self.cat, self.t0,
                     t1 - self.t0, self.args))
        return False


def events():
    """Snapshot of all recorded events as
    ``[(thread_name, (name, cat, ts_us, dur_us, args)), ...]``."""
    with _buffers_lock:
        bufs = [(t.name, b) for t, b, _d in _buffers]
    out = []
    for tname, buf in bufs:
        out.extend((tname, ev) for ev in _drain(buf))
    return out


# ---------------------------------------------------------------------------
# Chrome trace export
# ---------------------------------------------------------------------------

def export(path=None):
    """Write every buffered span as Chrome trace-event JSON (one track
    per thread; load in Perfetto or chrome://tracing).  Returns the
    path written, or None when no path is configured.

    Serialization is hand-rolled per event (one %-format through a
    cached template instead of a dict build and a json.dump walk): the
    export runs inside ``Pipeline.run``'s teardown.  Only ``args``
    (arbitrary user payload) goes through ``json.dumps``."""
    if path is None:
        path = trace_file()
    if not path:
        return None
    with _buffers_lock:
        bufs = [(t.ident or 0, t.name, b) for t, b, _d in _buffers]
    pid = os.getpid()
    dumps = json.dumps
    chunks = ['{"traceEvents":[']
    first = True
    for tid, tname, buf in bufs:
        chunks.append('%s{"ph":"M","name":"thread_name","pid":%d,'
                      '"tid":%d,"args":{"name":%s}}'
                      % ('' if first else ',', pid, tid, dumps(tname)))
        first = False
        head = ',{"name":%s,"cat":%s,"ph":"X","pid":' + str(pid) + \
            ',"tid":' + str(tid) + ',"ts":%.3f,"dur":%.3f'
        for name, cat, ts, dur, args in _drain(buf):
            chunks.append(head % (dumps(name), dumps(cat or 'bf'),
                                  ts, dur))
            if args:
                chunks.append(',"args":%s}' % dumps(args))
            else:
                chunks.append('}')
    chunks.append('],"displayTimeUnit":"ms","otherData":%s}'
                  % dumps({'bf_clock': clock_info(),
                           'bf_dropped_spans': dropped_spans()}))
    # pid AND thread ident: two pipelines' teardown exports in one
    # process must not truncate each other's tmp file mid-write
    tmp = '%s.tmp%d.%d' % (path, pid, threading.get_ident())
    with open(tmp, 'w') as f:
        f.write(''.join(chunks))
    os.replace(tmp, path)
    return path


def export_if_configured():
    """Export when (and only when) ``BF_TRACE_FILE`` is set; errors are
    reported but never propagate into pipeline teardown (a failed
    export must not mask the pipeline's own failure in
    ``Pipeline.run``'s finally block)."""
    path = trace_file()
    if not path:
        return None
    try:
        return export(path)
    except Exception as exc:
        import sys
        sys.stderr.write('bifrost_tpu_torch: trace export to %r failed: %s\n'
                         % (path, exc))
        return None


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------

def flight_record(per_thread=32):
    """Text timeline of the most recent ``per_thread`` spans of every
    thread, merged and time-sorted: what led up to a stall or a
    failure."""
    merged = []
    with _buffers_lock:
        bufs = [(t.name, b) for t, b, _d in _buffers]
    for tname, buf in bufs:
        for ev in _drain(buf)[-per_thread:]:
            merged.append((ev[2], tname, ev))
    if not merged:
        return ('=== flight recorder: no spans recorded '
                '(tracing/flight recording was off) ===')
    merged.sort(key=lambda e: e[0])
    lines = ['=== flight recorder: last %d span(s)/thread, '
             'oldest first ===' % per_thread]
    dropped = dropped_spans()
    if dropped:
        # saturation disclosure: the timeline below is missing its
        # oldest events — without this line a saturated recorder reads
        # as 'nothing happened before this'
        lines.append('  NOTE: %d span(s) dropped to buffer overflow '
                     '(BF_SPAN_BUFFER saturation) — the oldest '
                     'history below is incomplete' % dropped)
    for ts, tname, (name, cat, _ts, dur, args) in merged:
        extra = ' %r' % (args,) if args else ''
        lines.append('  t=%12.3fms +%10.3fms  [%-7s] %-24s %s%s'
                     % (ts / 1e3, dur / 1e3, (cat or 'bf')[:7],
                        tname[-24:], name, extra))
    lines.append('=== end flight recorder ===')
    return '\n'.join(lines)


def flight_events(per_thread=64):
    """Structured twin of :func:`flight_record`: the most recent
    ``per_thread`` spans of every thread as ``[[thread_name, name,
    cat, ts_us, dur_us, args], ...]`` sorted by start time.  The fleet
    publisher attaches them to full snapshots and flight-request
    replies (:mod:`.fleet`), and incident bundles render them as
    Chrome traces."""
    with _buffers_lock:
        bufs = [(t.name, b) for t, b, _d in _buffers]
    out = []
    for tname, buf in bufs:
        for name, cat, ts, dur, args in _drain(buf)[-per_thread:]:
            out.append([tname, name, cat or 'bf',
                        round(ts, 3), round(dur, 3), args])
    out.sort(key=lambda e: e[3])
    return out


def reset():
    """Drop all buffered events, drop counts, clock registrations and
    thread registrations (tests)."""
    global _tls, _dropped_retired
    with _buffers_lock:
        del _buffers[:]
        _dropped_retired = 0
    with _clock_lock:
        _sessions.clear()
    _tls = threading.local()
