"""NativeRing: the 'system' ring on the C++ core of
``bifrost_tpu_torch/csrc/native/ring.cpp`` (the port of
``bifrost_tpu/ring_native.py``).

It keeps the internal protocol of :class:`bifrost_tpu_torch.ring.Ring`,
so the ``WriteSequence`` / ``ReadSequence`` / span wrappers of
``ring.py`` are shared and the behaviour a block sees is the same; the
locked state machine (blocking reserve and acquire, guarantees, the
in-order commit barrier, the ghost mirror, live and deferred resize,
drop_oldest shedding) and the byte buffer live in C, which releases the
GIL while it blocks.  Spans are zero-copy numpy views of the native
buffer.

What stays in Python: the shed ledger and counters (``_note_shed``), the
drop_newest scratch, poison, the deferred D2H fills (``xfer.HostFill``)
with the resize holds that keep the C core from re-laying the buffer out
under one, and the open-span bookkeeping that ``occupancy()`` reports.
"""

from __future__ import annotations

import ctypes
import json
import threading

import numpy as np

from . import native
from .analysis import ringcheck as _rc
from .ring import Ring, EndOfDataStop, WouldBlock
from .testing import faults

__all__ = ['NativeRing']

#: bft_ring_open_sequence's ``which`` codes
_WHICH = {'specific': 0, 'at': 1, 'latest': 2, 'earliest': 3}


class _NativeSeq(object):
    """Sequence facade over a native handle (the attributes of the Python
    core's ``_Sequence``)."""

    __slots__ = ('_lib', '_handle', 'name', 'time_tag', 'header', 'begin',
                 'nringlet')

    def __init__(self, lib, handle):
        self._lib = lib
        self._handle = handle
        name = ctypes.c_char_p()
        ttag = ctypes.c_longlong()
        hdr = ctypes.c_char_p()
        hlen = ctypes.c_longlong()
        begin = ctypes.c_longlong()
        nrl = ctypes.c_longlong()
        native.check(lib.bft_seq_info(
            handle, ctypes.byref(name), ctypes.byref(ttag),
            ctypes.byref(hdr), ctypes.byref(hlen), ctypes.byref(begin),
            ctypes.byref(nrl)), 'seq_info')
        self.name = (name.value or b'').decode()
        self.time_tag = ttag.value
        raw = ctypes.string_at(hdr, hlen.value) if hlen.value else b'{}'
        self.header = json.loads(raw.decode())
        self.begin = begin.value
        self.nringlet = nrl.value

    @property
    def end(self):
        e = ctypes.c_longlong()
        native.check(self._lib.bft_seq_end_offset(self._handle,
                                                  ctypes.byref(e)))
        return None if e.value < 0 else e.value

    @property
    def finished(self):
        return self.end is not None


class _NativeStorage(object):
    """Zero-copy numpy views of the native buffer.  The C core mirrors the
    ghost region at commit and acquire, so those hooks do nothing here;
    a deferred fill that lands after its commit mirrors again."""

    pinned = False

    def __init__(self, ring):
        self._ring = ring

    def _lanes(self):
        """The buffer as (nringlet, size + ghost) uint8, and its size."""
        ring = self._ring
        buf = ctypes.POINTER(ctypes.c_ubyte)()
        size = ctypes.c_longlong()
        ghost = ctypes.c_longlong()
        nrl = ctypes.c_longlong()
        native.check(ring._lib.bft_ring_geometry(
            ring._handle, ctypes.byref(buf), ctypes.byref(size),
            ctypes.byref(ghost), ctypes.byref(nrl)), 'geometry')
        lane = size.value + ghost.value
        if not buf or not lane:
            return np.zeros((max(nrl.value, 1), 0), np.uint8), size.value
        base = np.ctypeslib.as_array(buf, shape=(nrl.value * lane,))
        return base.reshape(nrl.value, lane), size.value

    @property
    def buf(self):
        return self._lanes()[0]

    def view(self, offset, nbyte):
        lanes, size = self._lanes()
        bo = offset % size
        return lanes[:, bo:bo + nbyte]

    def commit_ghost(self, offset, nbyte):
        pass            # bft_ring_commit mirrors

    def refresh_ghost(self, offset, nbyte):
        pass            # bft_reader_acquire mirrors

    def discard_before(self, offset):
        pass

    def fill_ghost_mirror(self, offset, nbyte):
        """Mirror a wrapped span's overflow to the buffer start again
        after its deferred fill landed: the C core mirrored at commit,
        before the bytes existed (``bifrost_tpu/ring_native.py:108-127``)."""
        lanes, size = self._lanes()
        over = offset % size + nbyte - size
        if over > 0:
            lanes[:, :over] = lanes[:, size:size + over]


class NativeRing(Ring):
    """A 'system' ring on the C++ core (module docstring)."""

    #: set by an engine that reserves and commits through the C core
    #: itself (``io.packet_capture.NativeUDPCapture``): the ring checker
    #: then takes its committed head from the core at each acquire
    _external_writer = False

    def __init__(self, space='system', name=None, owner=None):
        super(NativeRing, self).__init__(space=space, name=name,
                                         owner=owner)
        self._lib = native.load()
        if self._lib is None:
            raise native.NativeError("native ring core disabled "
                                     "(BF_NO_NATIVE)")
        handle = ctypes.c_void_p()
        native.check(self._lib.bft_ring_create(
            ctypes.byref(handle), self.name.encode()), 'create')
        self._handle = handle
        self._storage = _NativeStorage(self)
        self._seq_cache = {}          # native pointer -> _NativeSeq
        self._cache_lock = threading.Lock()
        #: live native reader ids: poison releases their guarantees so
        #: writers blocked in bft_ring_reserve wake
        self._native_reader_ids = set()
        #: drop_oldest reserves and guaranteed-reader registrations take
        #: turns, so a late reader's charge and the core's shed count
        #: never cover the same bytes; ``_nguaranteed`` counts the
        #: guaranteed readers
        self._shed_reg_lock = threading.Lock()
        self._nguaranteed = 0
        #: deferred fills holding a C-side resize hold (their numpy view
        #: of the buffer would dangle under a re-layout)
        self._fill_holds = []

    def __del__(self):
        try:
            if getattr(self, '_handle', None) is not None:
                self._lib.bft_ring_destroy(self._handle)
                self._handle = None
        except Exception:
            pass

    _SEQ_CACHE_MAX = 64

    def _wrap_seq(self, handle_value):
        with self._cache_lock:
            seq = self._seq_cache.get(handle_value)
            if seq is None:
                seq = _NativeSeq(self._lib, ctypes.c_void_p(handle_value))
                self._seq_cache[handle_value] = seq
                # retired sequences' parsed headers can be large
                while len(self._seq_cache) > self._SEQ_CACHE_MAX:
                    self._seq_cache.pop(next(iter(self._seq_cache)))
            return seq

    def _geometry(self):
        size = ctypes.c_longlong()
        ghost = ctypes.c_longlong()
        nrl = ctypes.c_longlong()
        native.check(self._lib.bft_ring_geometry(
            self._handle, None, ctypes.byref(size), ctypes.byref(ghost),
            ctypes.byref(nrl)), 'geometry')
        return size.value, ghost.value, nrl.value

    def _tail_head(self):
        tail = ctypes.c_longlong()
        head = ctypes.c_longlong()
        native.check(self._lib.bft_ring_tail_head(
            self._handle, ctypes.byref(tail), ctypes.byref(head)))
        return tail.value, head.value

    # -- geometry ---------------------------------------------------------
    def resize(self, contiguous_bytes, total_bytes=None, nringlet=1):
        # a deferred fill writes through a view of the current buffer:
        # complete the fills before the core may re-lay it out
        for f in [f for f in self._pending_fills if not f.done]:
            f.wait()
        native.check(self._lib.bft_ring_resize(
            self._handle, contiguous_bytes,
            -1 if total_bytes is None else total_bytes, nringlet),
            'resize')
        self._write_ring_proclog(*self._geometry())

    def request_resize(self, contiguous_bytes, total_bytes=None,
                       nringlet=1):
        """Grow without blocking (:meth:`Ring.request_resize`): recorded
        in the C core and applied by its commit and release paths once
        the ring is quiescent; a pending deferred fill holds the apply
        off.  True when the new geometry is live on return."""
        self._prune_fill_holds()
        rc = _rc.hook(self) if _rc._enabled else None
        if rc is not None:
            total = total_bytes if total_bytes is not None \
                else contiguous_bytes * 4
            rc.resize_requested(contiguous_bytes, total)
            if faults.armed('ring.corrupt.resize_under_span', self.name):
                rc.resize_applied(self._nwrite_open, self._nread_open,
                                  int(total))
        applied = ctypes.c_int()
        native.check(self._lib.bft_ring_request_resize(
            self._handle, contiguous_bytes,
            -1 if total_bytes is None else total_bytes, int(nringlet),
            ctypes.byref(applied)), 'request_resize')
        if applied.value:
            self._write_ring_proclog(*self._geometry())
        return bool(applied.value)

    @property
    def resize_pending(self):
        pending = ctypes.c_int()
        native.check(self._lib.bft_ring_resize_pending(
            self._handle, ctypes.byref(pending)))
        return bool(pending.value)

    @property
    def total_span(self):
        return self._geometry()[0]

    @property
    def ghost_span(self):
        return self._geometry()[1]

    @property
    def nringlet(self):
        return self._geometry()[2]

    def occupancy(self):
        """Flow-control state (:meth:`Ring.occupancy`): tail, head and
        capacity from the C core, the open spans from the wrappers."""
        tail, head = self._tail_head()
        size = self._geometry()[0]
        with self._lock:
            reserve_head = head
            if self._open_wspans:
                last = self._open_wspans[-1]
                reserve_head = last._begin + last._nbyte
            return {'tail': tail, 'head': head,
                    'reserve_head': reserve_head, 'size': size,
                    'fill': min(head - tail, size) / size if size else 0.0,
                    'nwrite_open': self._nwrite_open,
                    'nread_open': self._nread_open, 'eod': self._eod,
                    'poisoned': self._poisoned is not None}

    # -- deferred fills and resize holds ----------------------------------
    def _register_fill(self, fill):
        super(NativeRing, self)._register_fill(fill)
        with self._lock:
            self._fill_holds.append(fill)
        self._lib.bft_ring_resize_hold(self._handle, 1)

    def _prune_fill_holds(self):
        with self._lock:
            done = [f for f in self._fill_holds if f.done]
            self._fill_holds = [f for f in self._fill_holds if not f.done]
        for _ in done:
            self._lib.bft_ring_resize_hold(self._handle, -1)

    def _fills_overlapping(self, begin, nbyte):
        out = super(NativeRing, self)._fills_overlapping(begin, nbyte)
        self._prune_fill_holds()
        return out

    def _fills_before(self, limit):
        out = super(NativeRing, self)._fills_before(limit)
        self._prune_fill_holds()
        return out

    # -- failure ----------------------------------------------------------
    def _wake_external(self):
        """Wake threads blocked in the C core: ending the writing session
        releases blocked readers and sequence waits (the wrappers report
        the poison), and moving every reader's guarantee to the head
        releases blocked writers."""
        try:
            self._lib.bft_ring_end_writing(self._handle)
            _tail, head = self._tail_head()
            with self._lock:
                rids = list(self._native_reader_ids)
            for rid in rids:
                # mode 2: past open spans too (the ring is dead)
                self._lib.bft_reader_set_guarantee(self._handle, rid,
                                                   head, 2)
        except Exception:
            pass

    def _corrupt_guarantee_jump(self, rseq):
        """The ``ring.corrupt.guarantee_jump`` seam in the C core: force
        the reader's guarantee to the head past its open spans."""
        rid = getattr(rseq, '_native_reader_id', None)
        if rid is None:
            return
        _tail, head = self._tail_head()
        self._lib.bft_reader_set_guarantee(self._handle, rid, head, 2)

    # -- writer side ------------------------------------------------------
    def _begin_writing(self):
        with self._lock:
            self._eod = False
        native.check(self._lib.bft_ring_begin_writing(self._handle))

    def end_writing(self):
        with self._lock:
            self._eod = True
        native.check(self._lib.bft_ring_end_writing(self._handle))

    def _begin_sequence(self, name, time_tag, header, nringlet):
        self._check_poison()
        hdr = json.dumps(header).encode()
        out = ctypes.c_void_p()
        rc = self._lib.bft_ring_begin_sequence(
            self._handle, name.encode(), int(time_tag), hdr, len(hdr),
            int(nringlet), ctypes.byref(out))
        if rc == -2:
            raise RuntimeError(
                "Cannot begin sequence %r: previous sequence is still "
                "open" % name)
        native.check(rc, 'begin_sequence')
        return self._wrap_seq(out.value)

    def _end_sequence(self, seq):
        native.check(self._lib.bft_ring_end_sequence(self._handle,
                                                     seq._handle))

    def _granted(self, span, begin, sid):
        span._begin = begin
        span._native_id = sid
        with self._lock:
            self._open_wspans.append(span)
            self._nwrite_open += 1

    def _check_reserve_rc(self, rc):
        # poison may have landed while blocked in the C core, whose
        # wake-up hands back a meaningless reservation
        self._check_poison()
        if rc == -2:
            raise RuntimeError("Cannot reserve a span while a partial "
                               "commit is pending")
        native.check(rc, 'reserve')

    def _reserve_span(self, span, nonblocking=False):
        self._check_poison()
        begin = ctypes.c_longlong()
        sid = ctypes.c_longlong()
        rc = self._lib.bft_ring_reserve(
            self._handle, span._nbyte, 1 if nonblocking else 0,
            ctypes.byref(begin), ctypes.byref(sid))
        if rc == native.BFT_WOULD_BLOCK:
            self._check_poison()
            raise WouldBlock()
        self._check_reserve_rc(rc)
        self._granted(span, begin.value, sid.value)

    def _reserve_span_shed(self, span, frame_nbyte):
        """drop_oldest reserve (:meth:`Ring._reserve_span_shed`): the
        guarantee-advance protocol runs in the C core under its mutex and
        returns the counted advance of the minimum guarantee."""
        self._check_poison()
        begin = ctypes.c_longlong()
        sid = ctypes.c_longlong()
        shed = ctypes.c_longlong()
        with self._shed_reg_lock:
            rc = self._lib.bft_ring_reserve_shed(
                self._handle, span._nbyte, int(max(frame_nbyte or 1, 1)),
                ctypes.byref(begin), ctypes.byref(sid), ctypes.byref(shed))
            if rc == native.BFT_OK and self._nguaranteed:
                with self._lock:
                    self._shed_frontier = max(self._shed_frontier,
                                              self._tail_head()[0])
        self._check_reserve_rc(rc)
        self._granted(span, begin.value, sid.value)
        return shed.value

    def _commit_span(self, wspan, commit_nbyte):
        with self._lock:
            if commit_nbyte < wspan._nbyte and self._open_wspans and \
                    self._open_wspans[-1] is not wspan:
                raise RuntimeError(
                    "Partial commit with later spans outstanding")
        native.check(self._lib.bft_ring_commit(
            self._handle, wspan._native_id, commit_nbyte), 'commit')
        with self._lock:
            wspan._commit_nbyte = commit_nbyte
            wspan._closed = True
            if wspan in self._open_wspans:
                self._open_wspans.remove(wspan)
                self._nwrite_open -= 1
        if commit_nbyte:
            self._note_commit(wspan, commit_nbyte)

    # -- reader side ------------------------------------------------------
    def _open_seq(self, which, name=None, time_tag=None):
        if which not in _WHICH:
            raise ValueError("Invalid 'which': %r" % which)
        self._check_poison()
        out = ctypes.c_void_p()
        rc = self._lib.bft_ring_open_sequence(
            self._handle, _WHICH[which], (name or '').encode(),
            int(time_tag or 0), ctypes.byref(out))
        self._check_poison()
        if rc == native.BFT_END_OF_DATA:
            raise EndOfDataStop("No sequence available")
        native.check(rc, 'open_sequence')
        return self._wrap_seq(out.value)

    def _next_seq(self, seq):
        self._check_poison()
        out = ctypes.c_void_p()
        rc = self._lib.bft_seq_next(self._handle, seq._handle,
                                    ctypes.byref(out))
        self._check_poison()
        if rc == native.BFT_END_OF_DATA:
            raise EndOfDataStop("No next sequence")
        native.check(rc, 'seq_next')
        return self._wrap_seq(out.value)

    def _register_reader(self, rseq):
        if not rseq.guarantee:
            self._create_reader(rseq)
            return
        with self._shed_reg_lock:
            rid = self._create_reader(rseq)
            # forward only: bft_reader_create put the guarantee at the
            # tail, and below the tail it would pin unreadable bytes
            native.check(self._lib.bft_reader_set_guarantee(
                self._handle, rid, rseq._seq.begin, 1))
            with self._lock:
                self._nguaranteed += 1
                self._charge_late_reader(rseq, self._tail_head()[0])

    def _create_reader(self, rseq):
        rid = ctypes.c_longlong()
        native.check(self._lib.bft_reader_create(
            self._handle, 1 if rseq.guarantee else 0, ctypes.byref(rid)),
            'reader_create')
        rseq._native_reader_id = rid.value
        with self._lock:
            self._native_reader_ids.add(rid.value)
            self._readers.add(id(rseq))
        return rid.value

    def _reader_moved(self, rseq, new_seq):
        if rseq.guarantee:
            native.check(self._lib.bft_reader_set_guarantee(
                self._handle, rseq._native_reader_id, new_seq.begin, 1))

    def _acquire_span(self, rseq, offset, nbyte, frame_nbyte):
        self._check_poison()
        begin = ctypes.c_longlong()
        got = ctypes.c_longlong()
        rid = rseq._native_reader_id
        rc = self._lib.bft_reader_acquire(
            self._handle, rid, rseq._seq._handle, offset, nbyte,
            frame_nbyte, ctypes.byref(begin), ctypes.byref(got))
        # the poison wake-up surfaces as an end of data (or a partial
        # span) from the C core: report the poison instead
        self._check_poison()
        if rc == native.BFT_END_OF_DATA:
            raise EndOfDataStop("Sequence consumed")
        native.check(rc, 'acquire')
        if not got.value and rseq.guarantee:
            # an empty span (its frames were overwritten) pins nothing;
            # the C core put the guarantee at it, below the bytes the
            # shed ledger already counted: lift it to the tail, or the
            # next shed counts those bytes again
            tail, _head = self._tail_head()
            self._lib.bft_reader_set_guarantee(self._handle, rid, tail, 2)
        if self._external_writer and _rc._enabled:
            _rc.hook(self).external_head(self._tail_head()[1])
        with self._lock:
            self._nread_open += 1
        nget = got.value
        if nget:
            # the C core hands a finished sequence's partial last gulp
            # out whole, into the next sequence: end it at the
            # sequence's own end
            seq_end = rseq._seq.end
            if seq_end is not None and begin.value + nget > seq_end:
                nget = max(seq_end - begin.value, 0)
        return begin.value, nget

    def _release_span(self, rseq, span_begin):
        native.check(self._lib.bft_reader_release(
            self._handle, rseq._native_reader_id, span_begin), 'release')
        with self._lock:
            self._nread_open -= 1

    def _close_read_seq(self, rseq):
        rid = getattr(rseq, '_native_reader_id', None)
        if rid is not None:
            with self._lock:
                self._native_reader_ids.discard(rid)
                self._readers.discard(id(rseq))
                if rseq.guarantee:
                    self._nguaranteed -= 1
            native.check(self._lib.bft_reader_destroy(self._handle, rid))
            rseq._native_reader_id = None

    def _overwritten_in(self, begin, nbyte):
        out = ctypes.c_longlong()
        native.check(self._lib.bft_ring_overwritten_in(
            self._handle, begin, nbyte, ctypes.byref(out)))
        return out.value
