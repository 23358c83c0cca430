"""Ring buffer runtime: the Python core of the port.

Semantics of the reference ring (reference: src/ring_impl.{hpp,cpp},
python/bifrost/ring2.py), as ``bifrost_tpu/ring.py`` implements them:

- absolute monotonic byte offsets; buffer index = offset % size
- sequences (named data units with a JSON-able header and a time_tag),
  linked in order
- guaranteed readers lock the tail at their oldest open span;
  unguaranteed readers can be overwritten and observe
  ``nframe_skipped`` / ``nframe_overwritten``
- blocking acquire with a partial final span at sequence end
- in-order commit barrier for several outstanding write spans
- live resize that preserves buffered data

Storage:

- **Host rings** ('system', 'cuda_host'): a byte buffer of ``nringlet``
  lanes of ``size + ghost`` bytes each; the ghost region makes spans
  that wrap the end contiguous, and spans are zero-copy numpy views.
  'cuda_host' buffers are page-locked when the port runs on a card.
- **Device rings** ('cuda'): a chunk map of committed ``torch.Tensor``
  gulps keyed by absolute byte offset.  A commit records a CUDA event
  on the writer's stream, and a reader makes its own stream wait on that
  event before it touches the tensor, so blocks on different threads
  (and so possibly different streams) are ordered without a host sync.
  A committed tensor belongs to the ring: neither side may write into it
  in place.  A ring's only reader may claim a chunk its writer marked
  owned (:meth:`ReadSpan.take_data`, buffer donation): the chunk leaves
  the ring, and the reader drops it once its work on it is queued.

Ring views (:func:`ring_view`, :class:`RingView`) share a base ring's
buffer, locks and guarantees and present transformed sequence headers;
they move no data.  A view read from a device ring hands out the
committed tensor reshaped to the view's layout, so a device view must
keep each frame's byte count and the ringlet count.

A host span may be committed before its bytes arrive: a block sets a
deferred D2H fill on it (:meth:`WriteSpan.set_fill`, an
``xfer.HostFill``), and readers of any overlapping span, a writer whose
reservation wraps onto it, and ``resize`` complete the fill first.  A
fill that fails poisons the ring.

Overload policies (``bifrost_tpu/ring.py:749-980``): a ring's reserve
path blocks behind its slowest guaranteed reader by default
(``'block'``).  Under ``'drop_oldest'`` the writer advances guaranteed
readers past unread whole frames instead (never past a span a reader
holds open); the skipped frames surface downstream as
``nframe_skipped``, and on a device ring their chunks are released with
the tail.  Under ``'drop_newest'`` a reserve that would block is shed
instead: the writer computes into a scratch span (a device tensor of the
span's shape on a ``cuda`` ring, allocated once per shape) and its
commit is counted, not published.  Every shed counts on
``ring.<name>.shed_gulps`` / ``.shed_bytes``, the ring's
:meth:`Ring.shed_stats` and, for a traced stream, the
``slo.shed_age_s`` histogram; each new sequence on a drop-policy ring
carries the cumulative ledger in its ``_overload`` header.

:meth:`Ring.request_resize` grows the ring without blocking: at once
when no span is open and no deferred fill targets the buffer, else at
the next span release or commit that leaves the ring quiescent.

Each commit counts its logical gulps (K for a macro-gulp span,
``WriteSpan._ngulps``) on ``ring.<name>.gulps`` and records the capture ->
commit age of a traced stream (``telemetry.slo``); reserves and acquires
record their flow-control wait on ``ring.<name>.reserve_s`` /
``.acquire_s`` and as ``ring`` spans.  :meth:`Ring.poison` wakes a
failing block's peers instead of leaving them blocked.  The
``ring.reserve`` and ``ring.acquire`` fault seams (``testing.faults``)
sit where the JAX ring has them, and so do the hooks of the ring-protocol
checker (``analysis.ringcheck``, ``BF_RINGCHECK=1``) and its
``ring.corrupt.*`` seams.

``Ring(space='system')`` returns a :class:`~bifrost_tpu_torch.ring_native.
NativeRing`, whose state machine and buffer live in the C++ core of
``csrc/native/`` (built at first use), unless ``BF_NO_NATIVE`` is set.
'cuda_host' rings stay on this core (their buffer is torch's page-locked
memory) and 'cuda' rings keep the chunk map.  Both cores share the
sequence and span wrappers below.
"""

from __future__ import annotations

import bisect
import json
import threading
import time
import weakref
from functools import reduce

import numpy as np

from .dtype import DataType
from .ndarray import ndarray
from .space import canonical
from .testing import faults
# the ring-protocol checker: with BF_RINGCHECK off each seam below reads
# one module global
from .analysis import ringcheck as _rc

__all__ = ['Ring', 'RingWriter', 'WriteSequence', 'ReadSequence',
           'WriteSpan', 'ReadSpan', 'EndOfDataStop', 'WouldBlock',
           'RingPoisonedError', 'split_shape', 'ring_view', 'RingView',
           'live_rings']

_INF = float('inf')

# the telemetry modules, looked up once (they import nothing of the ring)
_obs = None


def _observability():
    global _obs
    if _obs is None:
        from .telemetry import counters, histograms, slo, spans
        _obs = (counters, histograms, spans, slo)
    return _obs


#: every Ring alive in this process (the exporter's ring section when no
#: pipeline is named)
_live_rings = weakref.WeakSet()


def live_rings():
    """The rings alive in this process."""
    return list(_live_rings)


class EndOfDataStop(Exception):
    """A read reached the end of a ring's data (reference:
    BF_STATUS_END_OF_DATA)."""


class WouldBlock(Exception):
    """A nonblocking reserve found no space (reference:
    BF_STATUS_WOULD_BLOCK)."""


class RingPoisonedError(RuntimeError):
    """A blocking ring operation on a ring that :meth:`Ring.poison`
    marked dead: the stream can never complete."""

    def __init__(self, ring_name, cause=None):
        msg = "ring %r poisoned" % (ring_name,)
        if cause is not None:
            msg += " (cause: %s: %s)" % (type(cause).__name__, cause)
        super(RingPoisonedError, self).__init__(msg)
        self.cause = cause


def split_shape(shape):
    """Split a tensor shape at the time axis (-1) into
    (ringlet_shape, frame_shape): (2,3,-1,4,5) -> ([2,3], [4,5])."""
    for i, dim in enumerate(shape):
        if dim == -1:
            return list(shape[:i]), list(shape[i + 1:])
    raise ValueError("No time dimension (-1) found in shape %s" % (shape,))


def ring_view(ring, header_transform):
    """A view of ``ring`` whose read sequences present transformed headers
    (reference: ring2.py:75-82; ``bifrost_tpu/ring.py:136-146``).  A view
    of a view composes the two transforms."""
    new_ring = ring.view()
    old = ring.header_transform
    if old is not None:
        inner = header_transform
        header_transform = lambda hdr: inner(old(hdr))
    new_ring.header_transform = header_transform
    return new_ring


def _tensor_info(header):
    """Per-frame layout from a sequence header's ``_tensor``."""
    t = header['_tensor']
    ringlet_shape, frame_shape = split_shape(t['shape'])
    dtype = DataType(t['dtype'])
    frame_nbit = reduce(lambda x, y: x * y, frame_shape, 1) * \
        dtype.itemsize_bits
    if frame_nbit % 8:
        raise ValueError("Frame of %s x %s does not span whole bytes"
                         % (frame_shape, dtype))
    return {
        'dtype': dtype,
        'ringlet_shape': ringlet_shape,
        'nringlet': reduce(lambda x, y: x * y, ringlet_shape, 1),
        'frame_shape': frame_shape,
        'frame_nbyte': frame_nbit // 8,
    }


# ---------------------------------------------------------------------------
# Storage
# ---------------------------------------------------------------------------

class _HostStorage(object):
    """Byte buffer with a ghost region (host spaces)."""

    def __init__(self, pinned=False):
        self.buf = None          # (nringlet, size + ghost) uint8
        self.size = 0
        self.ghost = 0
        self.nringlet = 1
        self.pinned = pinned

    def _alloc(self, nringlet, nbyte):
        if self.pinned:
            import torch
            return torch.zeros((nringlet, nbyte), dtype=torch.uint8,
                               pin_memory=True).numpy()
        return np.zeros((nringlet, nbyte), dtype=np.uint8)

    def allocate(self, size, ghost, nringlet, tail, head):
        new = self._alloc(nringlet, size + ghost)
        if self.buf is not None and head > tail:
            # preserve [tail, head) across the re-layout; only the
            # existing lanes carry data when the ringlet count grows
            nl = min(self.nringlet, nringlet)
            if head - tail > size:
                tail = head - size
            o = tail
            while o < head:
                run = min(head - o, self.size - o % self.size,
                          size - o % size)
                new[:nl, o % size:o % size + run] = \
                    self.buf[:nl, o % self.size:o % self.size + run]
                o += run
        self.buf, self.size, self.ghost, self.nringlet = \
            new, size, ghost, nringlet

    def view(self, offset, nbyte):
        bo = offset % self.size
        return self.buf[:, bo:bo + nbyte]

    def commit_ghost(self, offset, nbyte):
        """After a write that ran past the nominal end, mirror the
        overflow to the buffer start (reference: _ghost_write,
        ring_impl.cpp:249-288)."""
        over = offset % self.size + nbyte - self.size
        if over > 0:
            self.buf[:, :over] = self.buf[:, self.size:self.size + over]

    def refresh_ghost(self, offset, nbyte):
        """Before a read that runs past the nominal end, refresh the
        ghost from the buffer start (reference: _ghost_read)."""
        over = offset % self.size + nbyte - self.size
        if over > 0:
            self.buf[:, self.size:self.size + over] = self.buf[:, :over]

    def discard_before(self, offset):
        pass

    def fill_ghost_mirror(self, offset, nbyte):
        """Ghost maintenance for a deferred fill (``xfer.HostFill``) that
        landed after its span's commit."""
        self.commit_ghost(offset, nbyte)


class _DeviceStorage(object):
    """Chunk map of committed tensors keyed by absolute byte offset.
    Each chunk's logical shape is (*ringlet_shape, nframe, *frame_shape)
    in the device representation; ``event`` marks the completion of the
    work that produced it (None on the CPU).  ``lock`` is the ring's
    lock, under which the writer puts and discards chunks."""

    def __init__(self, lock=None):
        self._lock = lock if lock is not None else threading.RLock()
        #: offset -> (nbyte, tensor, taxis, event, owned); ``owned``
        #: marks a tensor made for this ring alone (donation may claim it)
        self.chunks = {}
        self._offsets = []      # sorted keys of self.chunks
        self.size = 0
        self.ghost = 0
        self.nringlet = 1

    def allocate(self, size, ghost, nringlet, tail, head):
        self.size, self.ghost, self.nringlet = size, ghost, nringlet

    def put(self, offset, nbyte, tensor, taxis, event, owned=False):
        if offset not in self.chunks:
            bisect.insort(self._offsets, offset)
        self.chunks[offset] = (nbyte, tensor, taxis, event, owned)

    def take(self, offset, nbyte):
        """Claim the owned chunk covering exactly [offset, offset+nbyte)
        for donation: remove it from the map and return it, else None.
        The caller's stream is ordered after the chunk's event first.
        Later reads of the range see a gap (zeros): the caller must be
        its only reader."""
        hit = self.chunks.get(offset)
        if hit is None or hit[0] != nbyte or not hit[4]:
            return None
        del self.chunks[offset]
        self._offsets.remove(offset)
        _wait(hit[3])
        return hit[1]

    def take_tiling(self, offset, nbyte):
        """Claim a run of two or more owned chunks that tile [offset,
        offset+nbyte) exactly (the K per-gulp chunks of a K = 1 producer
        under a macro consumer): remove them and return the tensors in
        offset order, else None with the map untouched."""
        end = offset + nbyte
        i = bisect.bisect_left(self._offsets, offset)
        run, covered = [], offset
        while covered < end and i < len(self._offsets):
            o = self._offsets[i]
            if o != covered:
                return None
            cn, t, _taxis, ev, owned = self.chunks[o]
            if not owned or o + cn > end:
                return None
            run.append((o, t, ev))
            covered = o + cn
            i += 1
        if covered != end or len(run) < 2:
            return None
        for o, _t, ev in run:
            del self.chunks[o]
            _wait(ev)
        self._offsets = sorted(self.chunks)
        return [t for _o, t, _ev in run]

    def get(self, offset, nbyte, frame_nbyte, zeros_fn):
        """The tensor covering [offset, offset+nbyte): the committed
        chunk itself when one covers the request exactly, else a
        concatenation of chunk slices along the time axis, with zeros
        for frames no chunk holds (overwritten or never written).  The
        chunks are looked up under the ring's lock: the writer puts and
        discards chunks from its own thread, and a lookup that ran beside
        a discard could skip a chunk and zero-fill its frames.  The
        slices are joined after the lock is released."""
        with self._lock:
            hit = self.chunks.get(offset)
            if hit is not None and hit[0] == nbyte:
                _wait(hit[3])
                return hit[1]
            end = offset + nbyte
            i = max(bisect.bisect_right(self._offsets, offset) - 1, 0)
            parts, covered, taxis = [], offset, None
            while covered < end and i < len(self._offsets):
                o = self._offsets[i]
                cn, t, ctaxis, ev = self.chunks[o][:4]
                i += 1
                if o + cn <= covered:
                    continue
                if o >= end:
                    break
                if o > covered:
                    parts.append((o - covered) // frame_nbyte)
                    covered = o
                f0 = (covered - o) // frame_nbyte
                f1 = min(cn, end - o) // frame_nbyte
                _wait(ev)
                parts.append(t.narrow(ctaxis, f0, f1 - f0))
                taxis = ctaxis
                covered = o + f1 * frame_nbyte
            if covered < end:
                parts.append((end - covered) // frame_nbyte)
        import torch
        if taxis is None:
            return zeros_fn(nbyte // frame_nbyte)
        pieces = [zeros_fn(p) if isinstance(p, int) else p
                  for p in parts]
        if len(pieces) == 1:
            return pieces[0]
        return torch.cat(pieces, dim=taxis)

    def discard_before(self, offset):
        dead = [o for o, c in self.chunks.items() if o + c[0] <= offset]
        for o in dead:
            del self.chunks[o]
        if dead:
            self._offsets = sorted(self.chunks)


def _wait(event):
    """Order this thread's current stream after ``event``."""
    if event is not None:
        import torch
        torch.cuda.current_stream().wait_event(event)


# ---------------------------------------------------------------------------
# Ring
# ---------------------------------------------------------------------------

class _Sequence(object):
    __slots__ = ('name', 'time_tag', 'header', 'begin', 'end', 'next',
                 'nringlet')

    def __init__(self, name, time_tag, header, begin, nringlet):
        self.name = name
        self.time_tag = time_tag
        self.header = header
        self.begin = begin      # absolute byte offset of frame 0
        self.end = None         # one past the last frame, once ended
        self.next = None
        self.nringlet = nringlet

    @property
    def finished(self):
        return self.end is not None


class Ring(object):
    """A first-in-first-out multi-reader byte ring with named sequences
    (reference: python/bifrost/ring2.py:84-148)."""

    instance_count = 0

    #: reserve-path overload policies (module docstring)
    OVERLOAD_POLICIES = ('block', 'drop_oldest', 'drop_newest')

    def __new__(cls, space='system', name=None, owner=None):
        # 'system' rings run on the native core (``bifrost_tpu/ring.py:
        # 457-466``); a failed build raises instead of falling back
        if cls is Ring and canonical(space) == 'system':
            from . import native
            if native.available():
                from .ring_native import NativeRing
                return super(Ring, cls).__new__(NativeRing)
        return super(Ring, cls).__new__(cls)

    def __init__(self, space='system', name=None, owner=None):
        self.space = canonical(space)
        if name is None:
            name = 'ring_%i' % Ring.instance_count
            Ring.instance_count += 1
        self.name = name
        #: the block writing this ring (commit ages are named after it)
        self.owner = owner
        self._lock = threading.RLock()
        self._read_cond = threading.Condition(self._lock)
        self._write_cond = threading.Condition(self._lock)
        self._seq_cond = threading.Condition(self._lock)
        self._span_cond = threading.Condition(self._lock)
        if self.space == 'cuda':
            self._storage = _DeviceStorage(self._lock)
        else:
            pinned = False
            if self.space == 'cuda_host':
                from .device import on_cuda
                pinned = on_cuda()
            self._storage = _HostStorage(pinned)
        self._size = 0
        self._ghost = 0
        self._nringlet = 1
        self._tail = 0
        self._head = 0
        self._reserve_head = 0
        self._sequences = []
        self._seq_by_name = {}
        self._open_wspans = []        # in reserve order
        self._guarantees = {}         # id(ReadSequence) -> abs offset
        self._open_reads = {}         # id(ReadSequence) -> open begins
        self._release_high = {}       # id(ReadSequence) -> max released end
        self._open_read_ends = {}     # id(ReadSequence) -> {begin: end}
        self._readers = set()         # id(ReadSequence), every reader
        self._eod = False
        self._nwrite_open = 0
        self._nread_open = 0
        self._poisoned = None
        self._pending_fills = []      # xfer.HostFill, committed spans
        self._pending_resize = None   # (contiguous, total, nringlet)
        self.overload_policy = 'block'
        self._shed_gulps = 0
        self._shed_bytes = 0
        #: the stream offset up to which the shed ledger has charged (or
        #: a guaranteed reader passed) every overwritten byte
        self._shed_frontier = 0
        self._scratch = {}            # drop_newest scratch, by shape
        self._h_reserve = None
        self._h_acquire = None
        self.header_transform = None
        self.is_view = False
        _live_rings.add(self)

    @property
    def is_device(self):
        return self.space == 'cuda'

    def view(self):
        """A reader-side view of this ring: it shares all ring state
        (geometry, storage, synchronization) and differs only in its
        header transform (reference: ring2.py:108-112)."""
        return RingView(self)

    # -- geometry ---------------------------------------------------------
    def resize(self, contiguous_bytes, total_bytes=None, nringlet=1):
        """(Re)allocate: max contiguous span + total capacity, preserving
        live data; the ring only ever grows (reference: bfRingResize,
        ring_impl.cpp:115-210)."""
        with self._lock:
            if total_bytes is None:
                total_bytes = contiguous_bytes * 4
            # a pending request_resize lands here too: this path waits
            # for quiescence anyway
            if self._pending_resize is not None:
                pc, pt, pn = self._pending_resize
                contiguous_bytes = max(contiguous_bytes, pc)
                total_bytes = max(total_bytes, pt)
                nringlet = max(nringlet, pn)
                self._pending_resize = None
            ghost = max(self._ghost, contiguous_bytes)
            size = max(self._size, total_bytes)
            nringlet = max(self._nringlet, nringlet)
            if (size, ghost, nringlet) == (self._size, self._ghost,
                                           self._nringlet):
                return
            # no span may hold a view into the old layout, and no
            # deferred fill may still target the old buffer: waiting on a
            # fill drops the lock, so check both until they hold together
            while True:
                while self._nwrite_open or self._nread_open:
                    self._span_cond.wait()
                fills = [f for f in self._pending_fills if not f.done]
                if not fills:
                    break
                self._lock.release()
                try:
                    for f in fills:
                        f.wait()
                finally:
                    self._lock.acquire()
            self._apply_geometry_locked(size, ghost, nringlet)

    def _apply_geometry_locked(self, size, ghost, nringlet):
        """Re-lay the storage out; under the lock, on a quiescent ring
        (no open span, no incomplete fill into the buffer), which the
        ring-protocol checker asserts against its shadow state."""
        rc = _rc.hook(self) if _rc._enabled else None
        if rc is not None:
            rc.resize_applied(self._nwrite_open, self._nread_open, size)
        self._storage.allocate(size, ghost, nringlet,
                               self._tail, self._head)
        self._size, self._ghost, self._nringlet = size, ghost, nringlet
        self._write_cond.notify_all()
        self._read_cond.notify_all()
        self._write_ring_proclog(size, ghost, nringlet)

    def _write_ring_proclog(self, size, ghost, nringlet):
        """Record this ring's geometry under ``rings/<name>`` for the
        monitors (``like_ps``, ``like_pmap``; ``bifrost_tpu/ring.py:702``):
        space, binding (-1, unbound), ghost, span, stride, nringlet."""
        try:
            from .proclog import ProcLog
            if getattr(self, '_geom_proclog', None) is None:
                self._geom_proclog = ProcLog('rings/%s' % self.name)
            self._geom_proclog.update({
                'space': self.space, 'core': -1, 'ghost': ghost,
                'span': ghost, 'stride': size, 'nringlet': nringlet},
                force=True)
        except Exception:
            pass            # monitors never break a resize

    def request_resize(self, contiguous_bytes, total_bytes=None,
                       nringlet=1):
        """Grow the ring without blocking (``bifrost_tpu/ring.py:626``):
        at once when the ring is quiescent, else recorded and applied by
        the span release or commit that leaves no span open and no fill
        pending.  The geometry only grows, as in :meth:`resize`.  True
        when the new geometry is live on return, False while pending."""
        with self._lock:
            if total_bytes is None:
                total_bytes = contiguous_bytes * 4
            ghost = max(self._ghost, contiguous_bytes)
            size = max(self._size, total_bytes)
            nringlet = max(self._nringlet, nringlet)
            if (size, ghost, nringlet) == (self._size, self._ghost,
                                           self._nringlet):
                return True
            if self._pending_resize is not None:
                pc, pt, pn = self._pending_resize
                contiguous_bytes = max(contiguous_bytes, pc)
                total_bytes = max(total_bytes, pt)
                nringlet = max(nringlet, pn)
            self._pending_resize = (contiguous_bytes, total_bytes,
                                    nringlet)
            rc = _rc.hook(self) if _rc._enabled else None
            if rc is not None:
                rc.resize_requested(contiguous_bytes, total_bytes)
                if faults.armed('ring.corrupt.resize_under_span',
                                self.name):
                    # a core that re-lays the storage out now, under
                    # whatever spans are open
                    rc.resize_applied(self._nwrite_open,
                                      self._nread_open, int(total_bytes))
            return self._maybe_apply_pending_locked()

    @property
    def resize_pending(self):
        """Whether a request_resize has not applied yet."""
        return self._pending_resize is not None

    def _maybe_apply_pending_locked(self):
        """Apply a pending request_resize if the ring is quiescent now
        (under the lock); True when no request is left pending."""
        if self._pending_resize is None:
            return True
        if self._nwrite_open or self._nread_open:
            return False
        if any(not f.done for f in self._pending_fills):
            return False
        contig, total, nringlet = self._pending_resize
        self._pending_resize = None
        ghost = max(self._ghost, contig)
        size = max(self._size, total)
        nringlet = max(self._nringlet, nringlet)
        if (size, ghost, nringlet) != (self._size, self._ghost,
                                       self._nringlet):
            self._apply_geometry_locked(size, ghost, nringlet)
        return True

    @property
    def total_span(self):
        return self._size

    @property
    def ghost_span(self):
        return self._ghost

    @property
    def nringlet(self):
        return self._nringlet

    def occupancy(self):
        """Flow-control state: absolute byte offsets of the oldest and
        newest committed bytes and of the reserve head, the capacity, the
        share of it the committed bytes hold (``fill``), the open span
        counts, end of data and poisoning (the watchdog's dump reads
        it)."""
        with self._lock:
            size = self._size
            return {'tail': self._tail, 'head': self._head,
                    'reserve_head': self._reserve_head, 'size': size,
                    'fill': min(self._head - self._tail, size) / size
                    if size else 0.0,
                    'nwrite_open': self._nwrite_open,
                    'nread_open': self._nread_open, 'eod': self._eod,
                    'poisoned': self._poisoned is not None}

    # -- overload policy and counted shedding -----------------------------
    def set_overload_policy(self, policy):
        """Set the reserve path's policy ('block' | 'drop_oldest' |
        'drop_newest'); a misspelled one raises here."""
        if policy not in self.OVERLOAD_POLICIES:
            raise ValueError(
                "Unknown overload policy %r on ring %s (expected one "
                "of %s)" % (policy, self.name,
                            ', '.join(self.OVERLOAD_POLICIES)))
        self.overload_policy = policy
        return policy

    def shed_stats(self):
        """The ring's cumulative shed ledger (equal to its
        ``ring.<name>.shed_gulps`` / ``.shed_bytes`` counters)."""
        with self._lock:
            return {'policy': self.overload_policy,
                    'shed_gulps': self._shed_gulps,
                    'shed_bytes': self._shed_bytes}

    def _note_shed(self, nbyte, ngulps, header=None, frame_end=None):
        """Count one shed: the ledger, the counters and, for a traced
        stream, the age of the dropped data on ``slo.shed_age_s``."""
        if nbyte <= 0:
            return
        with self._lock:
            self._shed_gulps += ngulps
            self._shed_bytes += nbyte
        c, _h, _s, slo = _observability()
        c.inc('ring.%s.shed_gulps' % self.name, ngulps)
        c.inc('ring.%s.shed_bytes' % self.name, nbyte)
        if header is not None:
            try:
                age = slo.capture_age_s(header, frame_end)
                if age is not None:
                    slo.observe_shed(age)
            except Exception:
                pass            # the SLO feed never breaks shedding

    def _scratch_tensor(self, shape, dtype):
        """The drop_newest scratch tensor of a device ring, in the device
        representation of logical ``shape``: one per (shape, dtype),
        reused by every shed gulp of that shape."""
        key = (tuple(shape), str(dtype))
        with self._lock:
            t = self._scratch.get(key)
        if t is None:
            from .devrep import device_rep_zeros
            t = device_rep_zeros(list(shape), dtype)
            with self._lock:
                t = self._scratch.setdefault(key, t)
        return t

    def _scratch_host(self, nringlet, nbyte):
        """The drop_newest scratch bytes of a host ring, one buffer per
        geometry."""
        key = (nringlet, nbyte)
        with self._lock:
            buf = self._scratch.get(key)
            if buf is None:
                buf = self._scratch[key] = np.zeros((nringlet, nbyte),
                                                    dtype=np.uint8)
            return buf

    # -- failure ----------------------------------------------------------
    @property
    def poisoned(self):
        return self._poisoned is not None

    def _check_poison(self):
        if self._poisoned is not None:
            raise RingPoisonedError(self.name, self._poisoned)

    def poison(self, exc=None):
        """Mark the ring dead: every blocked or later reserve, acquire
        and sequence wait raises :class:`RingPoisonedError`."""
        with self._lock:
            if self._poisoned is not None:
                return
            self._poisoned = exc if exc is not None else \
                RuntimeError("ring poisoned")
            self._eod = True
        from .telemetry import counters
        counters.inc('ring_poisoned')
        rc = _rc.hook(self) if _rc._enabled else None
        if rc is not None:
            # the seam operations blocked now: the checker's timer then
            # proves that the wake-up released them
            rc.poisoned_now()
        if faults.armed('ring.corrupt.poison_nowake', self.name):
            # leave blocked spans asleep; the test that arms this wakes
            # its thread afterwards with _wake_all
            return
        self._wake_all()

    def _wake_all(self):
        """Wake every thread blocked on this ring (the poison wake-up)."""
        with self._lock:
            for cond in (self._read_cond, self._write_cond,
                         self._seq_cond, self._span_cond):
                cond.notify_all()
        self._wake_external()

    def _wake_external(self):
        """Wake threads blocked outside the Python locks (the native
        core's)."""

    def _corrupt_guarantee_jump(self, rseq):
        """Force ``rseq``'s guarantee to the head while it may hold open
        spans: the ``ring.corrupt.guarantee_jump`` seam, which the
        checker must catch at the overwriting reserve it admits."""
        with self._lock:
            if id(rseq) in self._guarantees:
                self._guarantees[id(rseq)] = self._head
            self._open_reads.pop(id(rseq), None)
            self._write_cond.notify_all()

    # -- writer side ------------------------------------------------------
    def begin_writing(self):
        return RingWriter(self)

    def _begin_writing(self):
        with self._lock:
            self._eod = False

    def end_writing(self):
        with self._lock:
            self._eod = True
            self._read_cond.notify_all()
            self._seq_cond.notify_all()

    @property
    def writing_ended(self):
        """Whether the writer has ended its writing session."""
        return self._eod

    def _begin_sequence(self, name, time_tag, header, nringlet):
        with self._lock:
            self._check_poison()
            seq = _Sequence(name, time_tag, header, self._head, nringlet)
            if self._sequences:
                prev = self._sequences[-1]
                if not prev.finished:
                    raise RuntimeError(
                        "Cannot begin sequence %r: previous sequence %r "
                        "is still open" % (name, prev.name))
                prev.next = seq
            self._sequences.append(seq)
            self._seq_by_name[name] = seq
            self._seq_cond.notify_all()
            return seq

    def _end_sequence(self, seq):
        with self._lock:
            seq.end = self._head
            self._read_cond.notify_all()
            self._seq_cond.notify_all()

    def _min_guarantee(self):
        return min(self._guarantees.values()) if self._guarantees else _INF

    def _reserve_prologue_locked(self, nbyte):
        """Checks before a reserve (under the lock): poison, a pending
        partial commit, and a contiguous window too small for ``nbyte``
        (grown here)."""
        self._check_poison()
        # a queued partial commit truncates reserve_head when it
        # lands: reserving past it would hand out stale offsets
        for sp in self._open_wspans:
            if sp._closed and sp._commit_nbyte < sp._nbyte:
                raise RuntimeError(
                    "Cannot reserve a span while a partial commit "
                    "is pending")
        if nbyte > self._ghost:
            # guaranteed-contiguous window too small: grow it
            self._lock.release()
            try:
                self.resize(nbyte, max(self._size, nbyte * 4),
                            self._nringlet)
            finally:
                self._lock.acquire()

    def _grant_locked(self, span, begin, nbyte):
        new_reserve = begin + nbyte
        self._reserve_head = new_reserve
        if new_reserve - self._size > self._tail:
            self._advance_tail(new_reserve - self._size)
        span._begin = begin
        self._open_wspans.append(span)
        self._nwrite_open += 1

    def _reserve_span(self, span, nonblocking=False):
        nbyte = span._nbyte
        with self._lock:
            self._reserve_prologue_locked(nbyte)
            begin = self._reserve_head
            new_reserve = begin + nbyte
            while new_reserve - self._size > min(self._head,
                                                 self._min_guarantee()):
                if nonblocking:
                    raise WouldBlock()
                self._write_cond.wait()
                self._check_poison()
            self._grant_locked(span, begin, nbyte)

    def _reserve_span_shed(self, span, frame_nbyte):
        """Blocking reserve under ``drop_oldest``
        (``bifrost_tpu/ring.py:799-870``): where flow control would wait
        on a guaranteed reader, advance that reader's guarantee past the
        bytes needed in whole frames, never past its oldest open span,
        and count the advance of the minimum guarantee as shed bytes.
        It still waits on the committed head and on readers pinned by
        open spans.  Returns the shed bytes."""
        nbyte = span._nbyte
        frame_nbyte = max(int(frame_nbyte or 1), 1)
        shed = 0
        with self._lock:
            self._reserve_prologue_locked(nbyte)
            begin = self._reserve_head
            new_reserve = begin + nbyte
            while True:
                new_tail = new_reserve - self._size
                if new_tail <= min(self._head, self._min_guarantee()):
                    break
                advanced = False
                if new_tail <= self._head and self._guarantees:
                    old_min = self._min_guarantee()
                    for key, g in list(self._guarantees.items()):
                        if g >= new_tail:
                            continue
                        target = g + -(-(new_tail - g) //
                                       frame_nbyte) * frame_nbyte
                        opens = self._open_reads.get(key)
                        if opens:
                            target = min(target, min(opens))
                        if target > g:
                            self._guarantees[key] = target
                            advanced = True
                    if advanced:
                        new_min = self._min_guarantee()
                        if old_min != _INF and new_min > old_min:
                            shed += new_min - old_min
                        continue        # re-check the limit
                self._write_cond.wait()
                self._check_poison()
            if self._guarantees:
                self._shed_frontier = max(self._shed_frontier,
                                          new_reserve - self._size)
            self._grant_locked(span, begin, nbyte)
        return shed

    def _advance_tail(self, new_tail):
        # overwrite: pull the tail past unguaranteed readers
        # (reference: ring_impl.cpp:509-555)
        self._tail = new_tail
        self._storage.discard_before(new_tail)
        while (len(self._sequences) > 1 and self._sequences[0].finished
               and self._sequences[0].end <= new_tail
               and self._sequences[0].next is not None):
            self._sequences.pop(0)

    def _commit_span(self, wspan, commit_nbyte):
        with self._lock:
            # a partial commit truncates reserve_head, so it is only
            # legal on the newest outstanding span
            if commit_nbyte < wspan._nbyte and self._open_wspans and \
                    self._open_wspans[-1] is not wspan:
                raise RuntimeError(
                    "Partial commit with later spans outstanding")
            wspan._commit_nbyte = commit_nbyte
            wspan._closed = True
            # in-order commit barrier (reference: ring_impl.cpp:591-594)
            while self._open_wspans and self._open_wspans[0]._closed:
                sp = self._open_wspans.pop(0)
                cb = sp._commit_nbyte
                if cb < sp._nbyte:
                    self._reserve_head = sp._begin + cb
                self._head = sp._begin + cb
                if cb > 0:
                    sp._finalize_storage(cb)
                self._nwrite_open -= 1
            # quiescence point: a pending request_resize may land now
            if self._pending_resize is not None:
                self._maybe_apply_pending_locked()
            self._read_cond.notify_all()
            self._span_cond.notify_all()
        if commit_nbyte:
            self._note_commit(wspan, commit_nbyte)

    def _note_commit(self, wspan, commit_nbyte):
        """Per-commit telemetry: the span's logical gulps (K for a
        macro span) on ``ring.<name>.gulps`` and,
        for a traced stream, the capture -> commit age named after the
        ring's owner (``telemetry.slo``)."""
        c, _h, _s, slo = _observability()
        ngulps = wspan._ngulps
        c.inc('ring.%s.gulps' % self.name, ngulps)
        try:
            header = wspan._sequence.header
            if header.get('_trace') is not None:
                name = self.owner.name if self.owner is not None \
                    else self.name
                frame_end = wspan.frame_offset + \
                    commit_nbyte // wspan.frame_nbyte
                age = slo.capture_age_s(header, frame_end)
                if age is not None:
                    slo.observe_commit(name, age, ngulps)
        except Exception:
            pass                     # the SLO feed never breaks commits

    # -- reader side ------------------------------------------------------
    def open_sequence(self, name, guarantee=True):
        """The sequence called ``name``; waits until it is begun."""
        return ReadSequence(self, 'specific', name=name,
                            guarantee=guarantee,
                            header_transform=self.header_transform)

    def open_sequence_at(self, time_tag, guarantee=True):
        """The first sequence whose ``time_tag`` is ``time_tag``; waits
        until one is begun."""
        return ReadSequence(self, 'at', time_tag=time_tag,
                            guarantee=guarantee,
                            header_transform=self.header_transform)

    def open_latest_sequence(self, guarantee=True):
        """The newest sequence begun; waits for a first one."""
        return ReadSequence(self, 'latest', guarantee=guarantee,
                            header_transform=self.header_transform)

    def open_earliest_sequence(self, guarantee=True):
        """The earliest sequence that still holds unread data."""
        return ReadSequence(self, 'earliest', guarantee=guarantee,
                            header_transform=self.header_transform)

    def read(self, whence='earliest', guarantee=True):
        """Generator over sequences as they appear, from the one
        ``whence`` opens ('earliest', 'latest'; reference:
        ring2.py:140-148)."""
        return _read_sequences(self, self.header_transform, guarantee,
                               whence)

    def _open_seq(self, which, name=None, time_tag=None):
        """The sequence ``which`` names ('specific' by name, 'at' by time
        tag, 'latest', 'earliest'), waiting until it exists
        (``bifrost_tpu/ring.py:1134-1160``): EndOfDataStop once writing
        has ended without it, RingPoisonedError on a poisoned ring."""
        with self._lock:
            while True:
                if which == 'specific':
                    if name in self._seq_by_name:
                        return self._seq_by_name[name]
                elif which == 'at':
                    for seq in self._sequences:
                        if seq.time_tag == time_tag:
                            return seq
                elif which == 'latest':
                    if self._sequences:
                        return self._sequences[-1]
                elif which == 'earliest':
                    for seq in self._sequences:
                        if not seq.finished or seq.end > self._tail:
                            return seq
                    if self._sequences:
                        return self._sequences[-1]
                else:
                    raise ValueError("Invalid 'which': %r" % which)
                self._check_poison()
                if self._eod:
                    raise EndOfDataStop("No sequence available")
                self._seq_cond.wait()

    def _next_seq(self, seq):
        with self._lock:
            while seq.next is None:
                self._check_poison()
                if self._eod and seq.finished:
                    raise EndOfDataStop("No next sequence")
                self._seq_cond.wait()
            return seq.next

    def _register_reader(self, rseq):
        with self._lock:
            self._readers.add(id(rseq))
            if rseq.guarantee:
                self._guarantees[id(rseq)] = max(rseq._seq.begin,
                                                 self._tail)
                self._charge_late_reader(rseq, self._tail)

    def _charge_late_reader(self, rseq, tail):
        """A guaranteed reader that opens a drop_oldest sequence after its
        oldest committed bytes were overwritten (no guaranteed reader held
        them) will see them as skipped frames: charge them to the shed
        ledger once, so it still equals the slowest reader's skips.  The
        caller excludes drop_oldest reserves while it runs."""
        if self.overload_policy != 'drop_oldest':
            return
        seq = rseq._seq
        lost = tail - max(seq.begin, self._shed_frontier)
        self._shed_frontier = max(self._shed_frontier, tail)
        if lost <= 0:
            return
        header = seq.header
        try:
            fb = _tensor_info(header)['frame_nbyte']
            gulp_nbyte = int(header.get('gulp_nframe', 0) or 0) * fb
        except (KeyError, TypeError, ValueError):
            fb, gulp_nbyte = 1, 0
        self._note_shed(lost, max(1, -(-lost // (gulp_nbyte or lost))),
                        header=header,
                        frame_end=max((tail - seq.begin) // max(fb, 1), 0))

    def _reader_moved(self, rseq, new_seq):
        if rseq.guarantee:
            with self._lock:
                g = max(new_seq.begin, self._tail)
                opens = self._open_reads.get(id(rseq))
                if opens:
                    g = min(g, min(opens))
                self._guarantees[id(rseq)] = g

    def _acquire_span(self, rseq, offset, nbyte, frame_nbyte):
        """Block until [seq.begin+offset, +nbyte) is readable; returns
        (abs_begin, nbyte) with any skip rounded up to whole frames
        (reference: ring_impl.cpp:633-704)."""
        seq = rseq._seq
        with self._lock:
            self._check_poison()
            want = seq.begin + offset
            if rseq.guarantee and not self._open_reads.get(id(rseq)):
                self._guarantees[id(rseq)] = max(
                    self._guarantees.get(id(rseq), want),
                    min(want, self._head))
            while True:
                self._check_poison()
                seq_end = seq.end if seq.finished else None
                if seq_end is not None and want >= seq_end:
                    raise EndOfDataStop("Sequence consumed")
                limit = seq_end if seq_end is not None else \
                    (self._head if self._eod else None)
                if self._eod and limit is not None and want >= limit:
                    raise EndOfDataStop("Ring consumed")
                if want + nbyte <= self._head:
                    # a finished sequence's partial last gulp ends at
                    # the sequence's end, not in the next sequence
                    end = want + nbyte if seq_end is None else \
                        min(want + nbyte, seq_end)
                    break
                if limit is not None and limit <= self._head:
                    end = min(limit, want + nbyte)
                    break
                self._read_cond.wait()
            begin = want
            if begin < self._tail:
                skip = -(-(self._tail - begin) // frame_nbyte) * frame_nbyte
                begin = min(begin + skip, end)
            if rseq.guarantee:
                opens = self._open_reads.setdefault(id(rseq), [])
                opens.append(begin)
                ends = self._open_read_ends.setdefault(id(rseq), {})
                ends[begin] = max(ends.get(begin, 0), end)
                # the guarantee sits at the oldest open span
                g = min(opens)
                cur = self._guarantees.get(id(rseq), g)
                if begin >= end:
                    # an empty span (its frames were overwritten) pins
                    # nothing: leave the guarantee where the shed ledger
                    # counted it to, or the next shed counts those bytes
                    # again
                    g = max(g, cur)
                if g > cur:
                    self._write_cond.notify_all()
                self._guarantees[id(rseq)] = g
            self._nread_open += 1
            return begin, max(end - begin, 0)

    def _release_span(self, rseq, span_begin):
        with self._lock:
            if rseq.guarantee and id(rseq) in self._guarantees:
                opens = self._open_reads.get(id(rseq), [])
                if span_begin in opens:
                    opens.remove(span_begin)
                ends = self._open_read_ends.get(id(rseq), {})
                span_end = span_begin if span_begin in opens else \
                    ends.pop(span_begin, span_begin)
                rh = max(self._release_high.get(id(rseq), 0), span_end)
                self._release_high[id(rseq)] = rh
                # advance to the oldest still-open span, else to the
                # released high-water mark
                # the reader consumed up to rh: a drop_oldest shed
                # racing this window must not count those bytes again
                g = min(opens) if opens else rh
                self._guarantees[id(rseq)] = max(
                    self._guarantees[id(rseq)], g)
            self._nread_open -= 1
            if self._pending_resize is not None:
                self._maybe_apply_pending_locked()
            self._write_cond.notify_all()
            self._span_cond.notify_all()

    def _close_read_seq(self, rseq):
        with self._lock:
            for d in (self._guarantees, self._open_reads,
                      self._open_read_ends, self._release_high):
                d.pop(id(rseq), None)
            self._readers.discard(id(rseq))
            self._write_cond.notify_all()

    def _take_exclusive(self, rseq, begin, nbyte, allow_parts=False):
        """Claim the committed chunk covering exactly [begin,
        begin+nbyte) for donation (``bifrost_tpu/ring.py:1312``), or
        None where exclusivity is not proven: the ring must have one
        reader, guaranteed, reading through no view and holding one open
        span (the caller's), and the chunk must be owned
        (``WriteSpan.set(..., owned=True)``).  With ``allow_parts`` a
        run of owned chunks tiling the range is claimed as a list."""
        if not self.is_device or not rseq.guarantee or \
                rseq.header_transform is not None:
            return None
        with self._lock:
            if self._nread_open != 1 or len(self._readers) != 1 or \
                    len(self._guarantees) != 1:
                return None
            got = self._storage.take(begin, nbyte)
            if got is None and allow_parts:
                got = self._storage.take_tiling(begin, nbyte)
        # the consumer's stream reads the tensors after this: the caching
        # allocator must not hand their memory out before that work ends
        for t in (got if isinstance(got, list) else [got]):
            if t is not None and t.is_cuda:
                import torch
                t.record_stream(torch.cuda.current_stream(t.device))
        return got

    def _overwritten_in(self, begin, nbyte):
        with self._lock:
            return max(0, min(self._tail - begin, nbyte))

    # -- deferred D2H fills (xfer.HostFill) -------------------------------
    def _register_fill(self, fill):
        with self._lock:
            self._pending_fills.append(fill)

    def _fills_overlapping(self, begin, nbyte):
        """Incomplete fills overlapping [begin, begin+nbyte) in absolute
        offsets (completed ones are pruned).  Callers wait on them outside
        the ring lock."""
        with self._lock:
            self._pending_fills = [f for f in self._pending_fills
                                   if not f.done]
            return [f for f in self._pending_fills
                    if f.begin is not None
                    and f.begin < begin + nbyte
                    and begin < f.begin + f.nbyte]

    def _fills_before(self, limit):
        """Incomplete fills whose bytes a reservation ending past
        ``limit + size`` is about to overwrite (the same buffer region one
        lap later): the writer completes these before new bytes land."""
        with self._lock:
            self._pending_fills = [f for f in self._pending_fills
                                   if not f.done]
            return [f for f in self._pending_fills
                    if f.begin is not None and f.begin < limit]


class RingView(object):
    """Reader-side view of a Ring: the same buffer and synchronization,
    another header transform (``bifrost_tpu/ring.py:1338-1390``).  Every
    attribute but the reading entry points is the base ring's."""

    def __init__(self, base, header_transform=None):
        if isinstance(base, RingView):
            base = base._base_ring
        self._base_ring = base
        self.header_transform = header_transform
        self.is_view = True

    @property
    def base(self):
        return self._base_ring

    def view(self):
        return RingView(self._base_ring, self.header_transform)

    def __getattr__(self, name):
        return getattr(self._base_ring, name)

    def open_sequence(self, name, guarantee=True):
        return ReadSequence(self._base_ring, 'specific', name=name,
                            guarantee=guarantee,
                            header_transform=self.header_transform)

    def open_sequence_at(self, time_tag, guarantee=True):
        return ReadSequence(self._base_ring, 'at', time_tag=time_tag,
                            guarantee=guarantee,
                            header_transform=self.header_transform)

    def open_latest_sequence(self, guarantee=True):
        return ReadSequence(self._base_ring, 'latest', guarantee=guarantee,
                            header_transform=self.header_transform)

    def open_earliest_sequence(self, guarantee=True):
        return ReadSequence(self._base_ring, 'earliest',
                            guarantee=guarantee,
                            header_transform=self.header_transform)

    def read(self, whence='earliest', guarantee=True):
        return _read_sequences(self._base_ring, self.header_transform,
                               guarantee, whence)


def _read_sequences(ring, header_transform, guarantee, whence='earliest'):
    """The sequences of ``ring`` as they appear, from the one ``whence``
    opens, with headers through ``header_transform``."""
    with ReadSequence(ring, whence, guarantee=guarantee,
                      header_transform=header_transform) as cur:
        while True:
            try:
                yield cur
                cur.increment()
            except EndOfDataStop:
                return


class RingWriter(object):
    """Writing session: ``with ring.begin_writing() as w:``
    (reference: ring2.py:150-162)."""

    def __init__(self, ring):
        self.ring = ring
        ring._begin_writing()

    def __enter__(self):
        return self

    def __exit__(self, typ, value, tb):
        self.ring.end_writing()

    def begin_sequence(self, header, gulp_nframe, buf_nframe):
        return WriteSequence(self.ring, header, gulp_nframe, buf_nframe)


class _SequenceAPI(object):
    @property
    def ring(self):
        return self._ring

    @property
    def name(self):
        return self._seq.name

    @property
    def time_tag(self):
        return self._seq.time_tag

    @property
    def nringlet(self):
        return self._seq.nringlet

    @property
    def header(self):
        return self._seq.header

    @property
    def tensor(self):
        if self._tensor is None:
            self._tensor = _tensor_info(self.header)
        return self._tensor


class WriteSequence(_SequenceAPI):
    def __init__(self, ring, header, gulp_nframe, buf_nframe):
        self._ring = ring
        self._tensor = None
        header['_tensor']['dtype'] = str(header['_tensor']['dtype'])
        # round trip through JSON: enforces serializability and
        # decouples the stored header from the caller's dict
        self._stored_header = json.loads(json.dumps(header))
        # a drop-policy ring stamps its cumulative shed ledger into every
        # new sequence header, merged with any stamp already there
        policy = getattr(ring, 'overload_policy', 'block')
        if policy != 'block':
            stats = ring.shed_stats()
            stamp = dict(self._stored_header.get('_overload') or {})
            stamp.update({'policy': policy,
                          'shed_gulps': stats['shed_gulps'],
                          'shed_bytes': stats['shed_bytes']})
            self._stored_header['_overload'] = stamp
        tensor = _tensor_info(self._stored_header)
        ring.resize(gulp_nframe * tensor['frame_nbyte'],
                    buf_nframe * tensor['frame_nbyte'],
                    tensor['nringlet'])
        self._seq = ring._begin_sequence(
            header.get('name', ''), header.get('time_tag', -1),
            self._stored_header, tensor['nringlet'])

    @property
    def header(self):
        return self._stored_header

    def __enter__(self):
        return self

    def __exit__(self, typ, value, tb):
        self.end()

    def end(self):
        self._ring._end_sequence(self._seq)

    def reserve(self, nframe, nonblocking=False):
        return WriteSpan(self._ring, self, nframe, nonblocking)


class ReadSequence(_SequenceAPI):
    """A reader of one sequence of ``ring`` at a time: the one ``which``
    names ('specific' with ``name``, 'at' with ``time_tag``, 'latest',
    'earliest'), then the ones after it (:meth:`increment`)."""

    def __init__(self, ring, which='specific', name='', time_tag=None,
                 guarantee=True, header_transform=None):
        self._ring = ring
        self._tensor = None
        self.guarantee = guarantee
        self.header_transform = header_transform
        self._seq = ring._open_seq(which, name=name, time_tag=time_tag)
        ring._register_reader(self)
        rc = _rc.hook(ring) if _rc._enabled else None
        if rc is not None:
            rc.reader_opened(self)

    @property
    def header(self):
        """The sequence header, through the view's transform (applied to
        a copy) when the sequence was opened on a ring view."""
        hdr = self._seq.header
        if self.header_transform is not None:
            hdr = self.header_transform(json.loads(json.dumps(hdr)))
            if hdr is None:
                raise ValueError("Header transform returned None")
        return hdr

    def __enter__(self):
        return self

    def __exit__(self, typ, value, tb):
        self.close()

    def close(self):
        self._ring._close_read_seq(self)
        rc = _rc.hook(self._ring) if _rc._enabled else None
        if rc is not None:
            rc.reader_closed(self)

    def increment(self):
        """Move to the next sequence (reference: ring2.py:293-298)."""
        nxt = self._ring._next_seq(self._seq)
        self._seq = nxt
        self._tensor = None
        self._ring._reader_moved(self, nxt)
        rc = _rc.hook(self._ring) if _rc._enabled else None
        if rc is not None:
            rc.reader_moved(self, nxt.begin)

    def acquire(self, frame_offset, nframe):
        return ReadSpan(self, frame_offset, nframe)

    def read(self, nframe, stride=None, begin=0):
        """Generator of gulp-sized spans (reference: ring2.py:301-311).

        An overlapped read (stride < nframe) acquires span N+1 before
        it releases span N, so the guarantee never passes the history
        frames the two share.  That is deadlock-free only when the ring
        also absorbs the writer's reserve granularity on top of both
        spans; when it is smaller the read releases first."""
        if stride is None:
            stride = nframe
        offset = begin
        if stride >= nframe:
            while True:
                try:
                    with self.acquire(offset, nframe) as span:
                        yield span
                        offset += stride
                except EndOfDataStop:
                    return
        hold_nbyte = (nframe + stride) * self.tensor['frame_nbyte']
        prev = None
        try:
            while True:
                if prev is not None:
                    # too small to hold ahead: ask the ring to grow (it
                    # does at the next quiescent moment) and release first
                    # until it has
                    ring = self._ring
                    ghost = ring.ghost_span
                    need = hold_nbyte + ghost
                    if ring.total_span < need and \
                            not ring.request_resize(ghost, need):
                        prev.release()
                        prev = None
                try:
                    span = self.acquire(offset, nframe)
                except EndOfDataStop:
                    return
                if prev is not None:
                    prev.release()
                prev = span
                yield span
                offset += stride
        finally:
            if prev is not None:
                prev.release()

    def resize(self, gulp_nframe, buf_nframe=None, buffer_factor=None):
        """Reader-side buffering request; the default buffer_factor of 3
        keeps a gulp in flight on each side (reference: ring2.py:312-319)."""
        if buf_nframe is None:
            buf_nframe = int(np.ceil(gulp_nframe * (buffer_factor or 3)))
        fb = self.tensor['frame_nbyte']
        return self._ring.resize(gulp_nframe * fb, buf_nframe * fb)


# ---------------------------------------------------------------------------
# Spans
# ---------------------------------------------------------------------------

def _as_view_layout(x, shape, dtype):
    """A committed device tensor in a ring view's layout: reshaped, and
    bit-cast where the view changed the element type."""
    shape = tuple(shape)
    if tuple(x.shape) == shape:
        return x
    tdt = dtype.as_torch_dtype()
    if x.dtype != tdt:
        x = x.contiguous().view(tdt)
    return x.reshape(shape)


class _SpanAPI(object):
    @property
    def ring(self):
        return self._ring

    @property
    def sequence(self):
        return self._sequence

    @property
    def tensor(self):
        return self._sequence.tensor

    @property
    def frame_nbyte(self):
        return self.tensor['frame_nbyte']

    @property
    def nframe(self):
        return self._nbyte // self.frame_nbyte

    @property
    def frame_offset(self):
        return (self._begin - self._sequence._seq.begin) // self.frame_nbyte

    @property
    def shape(self):
        t = self.tensor
        return t['ringlet_shape'] + [self.nframe] + t['frame_shape']

    @property
    def dtype(self):
        return self.tensor['dtype']

    @property
    def device_shape(self):
        """Shape of this span's tensor on a device ring."""
        from .devrep import device_rep_shape
        return device_rep_shape(self.shape, self.dtype)

    def lane_memoryviews(self):
        """Zero-copy byte views of this span's ring storage, one
        contiguous ``memoryview`` per ringlet lane in ringlet-major order
        (the bridge's wire layout).  Host rings only (the Python core,
        the native core and pinned ``cuda_host``); None for ``cuda``
        rings and empty spans.  The views alias the ring buffer: valid
        while the span is open, and writable, so that a write span is a
        ``recv_into`` target and a read span a ``sendmsg`` source."""
        if self._ring.is_device or not self._nbyte:
            return None
        if getattr(self, '_shed', False):
            # a drop_newest shed holds no ring bytes: its lanes are the
            # scratch that .data hands out
            raw = self._ring._scratch_host(self.tensor['nringlet'],
                                           self._nbyte)
        else:
            raw = self._ring._storage.view(self._begin, self._nbyte)
        return [memoryview(raw[i]) for i in range(raw.shape[0])]

    def _host_view(self, writeable):
        """Zero-copy numpy view of the ring bytes, shaped
        (*ringlet_shape, nframe, *frame_shape); a packed sub-byte type's
        view is its uint8 storage, the last axis counted in bytes."""
        return self._typed_view(
            self._ring._storage.view(self._begin, self._nbyte), writeable)

    def _typed_view(self, raw, writeable):
        """``raw`` (nringlet, nbyte) uint8 as this span's typed array."""
        t = self.tensor
        dtype = t['dtype']
        frame_shape = list(t['frame_shape'])
        if dtype.is_packed:
            frame_shape[-1] = frame_shape[-1] * dtype.itemsize_bits // 8
        view = raw.view(dtype.as_numpy_dtype())
        view = view.reshape([t['nringlet'], self.nframe] + frame_shape)
        view = view.reshape(t['ringlet_shape'] + [self.nframe] + frame_shape)
        view.flags['WRITEABLE'] = writeable
        return ndarray(view, dtype=dtype, space=self._ring.space,
                       shape=self.shape)


class WriteSpan(_SpanAPI):
    """Reserved output region (reference: ring2.py:451-476).

    Host rings: ``.data`` is a writable zero-copy view.
    Device rings: publish a computed tensor with ``span.set(t)``; the
    tensor then belongs to the ring.

    A span that a ``drop_newest`` ring shed (``_shed``) holds no ring
    bytes: ``.data`` is scratch of the span's shape and its commit is
    counted as shed, not published."""

    def __init__(self, ring, sequence, nframe, nonblocking=False):
        faults.fire('ring.reserve', ring.name)
        self._ring = ring
        self._sequence = sequence
        fb = sequence.tensor['frame_nbyte']
        self._nbyte = nframe * fb
        self._closed = False
        self._commit_nbyte = None
        self._tensor = None
        self._event = None
        self._data = None
        self._fill = None
        self._shed = False
        self._owned = False
        #: logical gulps this span covers: a macro span of K gulps sets
        #: K, so ``ring.<name>.gulps`` keeps counting logical gulps
        self._ngulps = 1
        # commit nothing unless told otherwise, so an exception in the
        # writer publishes no garbage (reference: ring2.py:463-464)
        self.commit_nframe = 0
        _c, hist, spans, _slo = _observability()
        # the checker tracks the blocking reserve and checks the granted
        # span against its shadow guarantees
        rc = _rc.hook(ring) if _rc._enabled else None
        rc_tok = rc.reserve_enter(self._nbyte) if rc is not None else None
        # an explicit nonblocking reserve keeps its WouldBlock contract
        policy = 'block' if nonblocking else ring.overload_policy
        t0 = time.perf_counter()
        shed_nbyte = 0
        try:
            if policy == 'drop_oldest':
                shed_nbyte = ring._reserve_span_shed(self, fb)
            elif policy == 'drop_newest':
                try:
                    ring._reserve_span(self, True)
                except WouldBlock:
                    self._shed = True
            else:
                ring._reserve_span(self, nonblocking)  # sets self._begin
        except BaseException:
            if rc is not None:
                rc.reserve_abort(rc_tok)
            raise
        if self._shed:
            # drop_newest shed this gulp: the writer fills scratch and
            # the commit is counted instead of published; its logical
            # place is the committed head
            if rc is not None:
                rc.reserve_abort(rc_tok)
            self._begin = ring.occupancy()['head']
            return
        dt = time.perf_counter() - t0
        if rc is not None:
            if shed_nbyte:
                # mirror the forced guarantee advance before the check
                rc.shed_advance(self._begin + self._nbyte -
                                ring.total_span)
            rc.reserve_done(rc_tok, self, self._begin, self._nbyte,
                            ring.total_span)
        if shed_nbyte:
            # whole frames of the live sequence, in gulps of the header's
            # logical gulp
            try:
                gulp = int(sequence.header.get('gulp_nframe', 0) or 0)
            except (TypeError, ValueError):
                gulp = 0
            gulp_nbyte = gulp * fb if gulp > 0 else self._nbyte
            ring._note_shed(
                shed_nbyte, max(1, -(-shed_nbyte // max(gulp_nbyte, 1))),
                header=sequence.header,
                frame_end=max((self._begin + self._nbyte - ring.total_span
                               - sequence._seq.begin) // fb, 0))
        if ring._h_reserve is None:
            ring._h_reserve = hist.get_or_create(
                'ring.%s.reserve_s' % ring.name, unit='s')
        ring._h_reserve.record(dt)
        spans.record_elapsed('%s.reserve' % ring.name, 'ring', dt)
        if not ring.is_device and ring._pending_fills:
            # a wrapped reservation reuses bytes that a pending deferred
            # fill still targets: complete those before writing
            for f in ring._fills_before(self._begin + self._nbyte -
                                        ring.total_span):
                f.wait()

    @property
    def data(self):
        if self._ring.is_device:
            if self._shed and self._tensor is None:
                return self._ring._scratch_tensor(self.shape, self.dtype)
            return self._tensor
        if self._data is None:
            if self._shed:
                raw = self._ring._scratch_host(self.tensor['nringlet'],
                                               self._nbyte)
                self._data = self._typed_view(raw, writeable=True)
            else:
                self._data = self._host_view(writeable=True)
        return self._data

    def set(self, array, owned=False):
        """Publish a gulp into this span: a tensor of the span's device
        shape on a device ring (kept, not copied), or an array copied
        into the host view.  ``owned=True`` declares a device tensor
        made for this ring alone, so that its single consumer may claim
        the chunk for donation (:meth:`ReadSpan.take_data`)."""
        if self._ring.is_device:
            if tuple(array.shape) != tuple(self.device_shape):
                raise ValueError("span expects shape %s, got %s"
                                 % (tuple(self.device_shape),
                                    tuple(array.shape)))
            self._tensor = array
            self._owned = bool(owned)
        else:
            src = array.as_numpy() if isinstance(array, ndarray) else array
            self.data.as_numpy()[...] = src
        return self

    def set_fill(self, fill):
        """Publish this host span's bytes as a deferred D2H fill (an
        ``xfer.HostFill`` targeting a view of this span): the span commits
        at once and readers wait on the fill, so the writer never waits
        on the transfer."""
        if self._ring.is_device:
            raise ValueError("set_fill is for host-space rings")
        self._fill = fill
        return self

    def commit(self, nframe):
        if not 0 <= nframe <= self.nframe:
            raise ValueError("cannot commit %d frames of a %d-frame span"
                             % (nframe, self.nframe))
        self.commit_nframe = nframe

    def __enter__(self):
        return self

    def __exit__(self, typ, value, tb):
        self.close()

    def close(self):
        commit_nbyte = self.commit_nframe * self.frame_nbyte
        if self._shed:
            # drop_newest: nothing entered the ring; count what the
            # writer would have published (nothing on the error path)
            self._tensor = None
            if commit_nbyte:
                self._ring._note_shed(
                    commit_nbyte, self._ngulps,
                    header=self._sequence.header,
                    frame_end=self.frame_offset + self.commit_nframe)
            if self._fill is not None:
                self._fill.cancel()
            return
        if self._ring.is_device:
            if self._tensor is not None:
                from .device import record_event
                self._event = record_event()
        elif self._fill is not None:
            if commit_nbyte == self._nbyte:
                # commit now, bytes later: the fill redoes the ghost
                # mirror once they land; readers wait on it
                self._fill.attach(self._ring, self._begin, commit_nbyte)
                self._ring._register_fill(self._fill)
            elif commit_nbyte:
                # partial commit: the truncated tail rolls back and may
                # be re-reserved the moment this commit lands, so the
                # fill (which targets the whole span) completes now,
                # while the whole reservation is still ours
                self._fill.attach(self._ring, self._begin, commit_nbyte)
                self._fill.wait()
            else:
                # nothing published: a late write would land in bytes
                # that may be re-reserved
                self._fill.cancel()
        elif commit_nbyte:
            self._ring._storage.commit_ghost(self._begin, commit_nbyte)
        # the checker sees the commit before the core does, so an illegal
        # one raises before it changes the ring
        rc = _rc.hook(self._ring) if _rc._enabled else None
        if rc is not None:
            rc.commit(self, commit_nbyte)
        self._ring._commit_span(self, commit_nbyte)
        if faults.armed('ring.corrupt.double_commit', self._ring.name):
            # commit the same span again
            if rc is not None:
                rc.commit(self, commit_nbyte)
            self._ring._commit_span(self, commit_nbyte)

    def _finalize_storage(self, commit_nbyte):
        # called under the ring lock once this commit lands in order
        if self._ring.is_device and self._tensor is not None:
            t = self.tensor
            taxis = len(t['ringlet_shape'])
            x = self._tensor
            nframe_c = commit_nbyte // t['frame_nbyte']
            if nframe_c < self.nframe:
                x = x.narrow(taxis, 0, nframe_c)
            elif hasattr(x, 'shards'):
                # a mesh plan's output stays per rank in the ring
                _note_sharded(self._ring, x)
            self._ring._storage.put(self._begin, commit_nbyte, x, taxis,
                                    self._event, self._owned)


def _note_sharded(ring, x):
    """Count a per-rank commit (``parallel.scope.ShardedTensor``) on
    ``ring.<name>.sharded_gulps`` / ``.shard_bytes`` and
    ``mesh.sharded_commits``."""
    c = _observability()[0]
    c.inc('ring.%s.sharded_gulps' % ring.name)
    c.inc('ring.%s.shard_bytes' % ring.name, int(x.shard_nbytes))
    c.inc('mesh.sharded_commits')


def _gathered(x):
    """A per-rank value (``ShardedTensor``) gathered for a reader that
    does not take the layout; any other value as it is."""
    return x.gather() if hasattr(x, 'shards') else x


class ReadSpan(_SpanAPI):
    """Acquired input region (reference: ring2.py:478-503).  On a device
    ring ``.data`` is a tensor the reader must not write into; a span a
    mesh plan committed per rank reads as the gathered tensor there, and
    as the per-rank ``parallel.scope.ShardedTensor`` through
    :meth:`sharded_data`."""

    def __init__(self, sequence, frame_offset, nframe):
        faults.fire('ring.acquire', sequence.ring.name)
        self._ring = ring = sequence.ring
        self._sequence = sequence
        fb = sequence.tensor['frame_nbyte']
        _c, hist, spans, _slo = _observability()
        rc = _rc.hook(ring) if _rc._enabled else None
        rc_tok = rc.acquire_enter(
            sequence, sequence._seq.begin + frame_offset * fb) \
            if rc is not None else None
        t0 = time.perf_counter()
        try:
            self._begin, self._nbyte = ring._acquire_span(
                sequence, frame_offset * fb, nframe * fb, fb)
        except BaseException:
            if rc is not None:
                rc.acquire_abort(rc_tok)
            raise
        dt = time.perf_counter() - t0
        if rc is not None:
            rc_nbyte = self._nbyte
            if faults.armed('ring.corrupt.acquire_uncommitted', ring.name):
                # report one frame past what the core handed out
                rc_nbyte += fb
            rc.acquire_done(rc_tok, sequence, self._begin, rc_nbyte)
        if faults.armed('ring.corrupt.guarantee_jump', ring.name):
            # jump this reader's guarantee to the head while the span is
            # open; the checker catches the overwriting reserve
            ring._corrupt_guarantee_jump(sequence)
        if ring._h_acquire is None:
            ring._h_acquire = hist.get_or_create(
                'ring.%s.acquire_s' % ring.name, unit='s')
        ring._h_acquire.record(dt)
        spans.record_elapsed('%s.acquire' % ring.name, 'ring', dt)
        self.requested_frame_offset = frame_offset
        self.nframe_skipped = min(self.frame_offset - frame_offset, nframe)
        self._holds = []
        if not self._ring.is_device and self._nbyte:
            # land any in-flight D2H fill overlapping this span before
            # exposing its bytes (outside the ring lock).  A failed fill
            # raises here: release the span first, so the ring's open
            # span count stays balanced while the error propagates
            try:
                for f in self._ring._fills_overlapping(self._begin,
                                                       self._nbyte):
                    f.wait()
                self._ring._storage.refresh_ghost(self._begin, self._nbyte)
            except BaseException:
                if rc is not None:
                    rc.release(sequence, self._begin, self._nbyte)
                self._ring._release_span(sequence, self._begin)
                raise
        self._data = None

    @property
    def data(self):
        if self._data is None:
            if self._ring.is_device:
                t = self.tensor
                x = _gathered(self._raw_device_data())
                if self._sequence.header_transform is not None:
                    x = _as_view_layout(x, self.device_shape, t['dtype'])
                self._data = x
            else:
                self._data = self._host_view(writeable=False)
        return self._data

    def _raw_device_data(self):
        t = self.tensor

        def zeros_fn(nframe):
            from .devrep import device_rep_zeros
            return device_rep_zeros(
                t['ringlet_shape'] + [nframe] + t['frame_shape'],
                t['dtype'])

        return self._ring._storage.get(self._begin, self._nbyte,
                                       t['frame_nbyte'], zeros_fn)

    def sharded_data(self):
        """Device rings: the span's committed value as it lies in the
        ring, a per-rank ``ShardedTensor`` where a mesh plan committed
        one (else the tensor ``.data`` gives).  Mesh plans read their
        input through this, so a layout that matches theirs is never
        gathered."""
        if self._data is not None or not self._ring.is_device or \
                self._sequence.header_transform is not None:
            return self.data
        return self._raw_device_data()

    def take_data(self, allow_parts=False, sharded=False):
        """Device rings: claim this span's committed chunk for donation
        (``bifrost_tpu/ring.py:2047``).  The chunk leaves the ring, so the
        caller holds the only reference and the caching allocator can
        recycle its memory once the caller's work on it is queued.
        Returns the tensor, or None where exclusivity is not proven (a
        second reader, a view, a partial or stitched span, a chunk not
        owned): callers then read ``.data``.  With ``allow_parts`` (macro
        spans) a run of owned chunks tiling the span is returned as a
        list in frame order, which the caller must consume whole: this
        span's ``.data`` would read zeros after it."""
        if not self._ring.is_device or self._data is not None or \
                not self._nbyte:
            return None
        got = self._ring._take_exclusive(self._sequence, self._begin,
                                         self._nbyte, allow_parts)
        if got is not None and not sharded:
            # a reader that does not take per-rank values (``sharded``)
            # gets them gathered
            got = [_gathered(x) for x in got] if isinstance(got, list) \
                else _gathered(got)
        if got is not None and not isinstance(got, list) and \
                not hasattr(got, 'shards'):
            self._data = got
        return got

    @property
    def nframe_overwritten(self):
        """Frames of this span overwritten while held (unguaranteed
        readers; reference: ring2.py:491-497)."""
        if self._sequence.guarantee:
            return 0
        nbyte = self._ring._overwritten_in(self._begin, self._nbyte)
        return -(-nbyte // self.frame_nbyte) if nbyte else 0

    def hold(self, event):
        """Keep this span until ``event`` completes: a copy issued from
        its bytes (``xfer.TransferEngine.to_device_direct``) still reads
        them, and a released span may be overwritten."""
        if event is not None:
            self._holds.append(event)

    def __enter__(self):
        return self

    def __exit__(self, typ, value, tb):
        self.release()

    def release(self):
        holds, self._holds = self._holds, []
        try:
            for ev in holds:
                ev.synchronize()
        finally:
            # the checker sees the release before the core does
            rc = _rc.hook(self._ring) if _rc._enabled else None
            if rc is not None:
                rc.release(self._sequence, self._begin, self._nbyte)
            self._ring._release_span(self._sequence, self._begin)
            if faults.armed('ring.corrupt.double_release',
                            self._ring.name):
                # release the same span again
                if rc is not None:
                    rc.release(self._sequence, self._begin)
                self._ring._release_span(self._sequence, self._begin)
