"""Asynchronous host <-> device transfer engine (the single-device part
of the JAX package's ``bifrost_tpu/xfer.py``, with its names, knobs and
counters).

The reference moves gulps with ``cudaMemcpyAsync`` out of and into
page-locked memory on a stream of its own (reference:
src/memory.cpp:163-230, src/cuda.cpp:34).  The engine does the same with
torch, on one H2D and one D2H ``torch.cuda.Stream`` per device, so a
transfer runs beside the kernels that the blocks queue on their own
streams:

- **H2D staging ring**: a host gulp is copied once (``np.copyto``, which
  takes strided spans as they are) into a pinned staging slot, and
  ``copy_(non_blocking=True)`` ships it on the H2D stream.  Slots are
  kept per (shape, dtype), at most ``BF_XFER_STAGING`` a key, and a slot
  returns to the free list only once the event behind its copy reports
  ``query()`` true; a slot whose tensor died before that was seen is
  dropped, not reused.  When every slot of a key is busy, or the gulp is
  below ``BF_XFER_STAGE_MIN`` bytes, or strict mode is on, a fresh pinned
  buffer is used instead: correctness never depends on the pool's size.
  The caller's stream waits on the copy's event before the tensor is
  returned, and the tensor is marked used on that stream
  (``record_stream``), so the caching allocator never hands its memory
  out while a kernel of the caller still reads it.  The caller may
  recycle its host buffer the moment the call returns.
- **pinned spans**: :meth:`TransferEngine.to_device_direct` ships a
  contiguous span of a pinned ``cuda_host`` ring with no host copy; the
  caller holds the span until the returned event completes.  A D2H into
  a contiguous pinned target lands there directly.
- **non-blocking D2H**: :meth:`TransferEngine.to_host_async` issues the
  copy on the D2H stream after the caller's stream (so it never reads a
  tensor its producer has not finished) and returns a
  :class:`TransferFuture`; the engine bounds the futures in flight.
  ``to_host`` keeps its blocking contract.  A pageable target is filled
  through a pinned slot and one host copy when the future completes.
- **deferred ring fills**: :class:`HostFill` lets a block commit a host
  ring span whose bytes are still in flight; the ring gates readers on
  the fill (``ring.py``), so the writer never waits on the D2H.

Complex tensors cross the host boundary whole (complex64 pairs), with no
(re, im) plane split: torch moves them natively.

On the CPU device (``set_device('cpu')``) ``torch.from_numpy`` aliases its
source, so every H2D gets a fresh buffer that only the new tensor holds
(the JAX engine's zero-copy branch); ``zero_copy=False`` drives the slot
protocol there for tests, with completion taken from
``_StagingPool.ready``.

Tunables (environment, with the JAX package's defaults):

- ``BF_XFER_ASYNC=0``      blocking D2H and fills (also implied by
                           ``BF_SYNC_STRICT=1``)
- ``BF_XFER_DEPTH``        max in-flight async D2H transfers (default 4)
- ``BF_XFER_STAGING``      staging slots per (shape, dtype) (default 4)
- ``BF_XFER_STAGE_MIN``    min bytes to use a staging slot (default 16384)
- ``BF_SYNC_STRICT=1``     synchronous transfers, no slot reuse

A D2H gulp above a quarter of ``_PIN_KEY_BYTES`` gets fewer slots and a
lower in-flight bound, so that one key never pins more than about
``_PIN_KEY_BYTES``.
"""

from __future__ import annotations

import os
import threading
import time
import warnings
import weakref
from collections import deque

import numpy as np

from .testing import faults

__all__ = ['to_device', 'to_device_batch', 'to_host', 'to_host_async',
           'prefetch', 'engine', 'reset_engine', 'async_enabled',
           'strict_mode', 'TransferEngine', 'TransferFuture', 'HostFill',
           'torch_dtype_of']

#: pinned bytes the D2H slots of one (shape, dtype) may hold, about
_PIN_KEY_BYTES = 1 << 32


def torch_dtype_of(np_dtype):
    """The torch dtype of a (non-structured) numpy dtype."""
    import torch
    return torch.from_numpy(np.empty(0, dtype=np_dtype)).dtype


def _np_dtype_of(torch_dtype):
    import torch
    return torch.empty(0, dtype=torch_dtype).numpy().dtype


def _counters():
    from .telemetry import counters
    return counters


_obs_mods = None


def _obs():
    """(histograms, spans), cached after the first import."""
    global _obs_mods
    if _obs_mods is None:
        from .telemetry import histograms, spans
        _obs_mods = (histograms, spans)
    return _obs_mods


def _env_int(name, default):
    try:
        return int(os.environ.get(name, '') or default)
    except ValueError:
        return default


def async_enabled():
    """Whether the non-blocking D2H queue and deferred fills are active.
    ``BF_SYNC_STRICT=1`` implies synchronous transfers."""
    if os.environ.get('BF_XFER_ASYNC', '1') == '0':
        return False
    return not strict_mode()


def strict_mode():
    return os.environ.get('BF_SYNC_STRICT', '0') == '1'


def _alloc(shape, dtype, pinned):
    """(pinned uint8 tensor or None, numpy view of it as ``shape`` /
    ``dtype``): a fresh host buffer.  A pinned allocation that fails
    raises."""
    dtype = np.dtype(dtype)
    nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
    if not pinned:
        return None, np.empty(shape, dtype)
    import torch
    buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    return buf, buf.numpy().view(dtype).reshape(shape)


def _as_tensor(host):
    """A CPU tensor on ``host``'s memory (read-only spans included: the
    engine only reads through it)."""
    import torch
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', UserWarning)
        return torch.from_numpy(host)


def _host_tensor(buf, host):
    """The CPU tensor a copy reads or writes: the pinned buffer ``buf``
    itself, typed and shaped as ``host``, so that torch's pinned
    allocator keeps the memory until the copy completes whoever frees it;
    without a pinned buffer, a tensor on ``host``."""
    if buf is None:
        return _as_tensor(host)
    return buf.view(torch_dtype_of(host.dtype)).view(host.shape)


def _pinned(arr):
    """Whether numpy ``arr`` lies in page-locked memory."""
    try:
        return bool(_as_tensor(arr).is_pinned())
    except (TypeError, RuntimeError):
        return False


class _Slot(object):
    """One staging buffer, either free (in the pool) or bound to the
    transfer made from it."""

    __slots__ = ('buf', 'host', 'key', 'recycled', 'ref', 'event',
                 '__weakref__')

    def __init__(self, buf, host, key):
        self.buf = buf           # pinned uint8 tensor (None on the CPU)
        self.host = host         # numpy view of buf as the key's shape
        self.key = key
        self.recycled = False
        self.ref = None          # weakref to the tensor made from it
        self.event = None        # completion of its H2D copy


class _StagingPool(object):
    """Bounded per-(shape, dtype) set of reusable pinned staging buffers.

    An H2D slot returns to the free list only when its copy is observed
    complete (:meth:`ready`, scanned at acquire time).  A slot whose
    tensor died before its completion was seen is dropped rather than
    recycled (torch's pinned allocator keeps the memory until the copy
    drains; the pool allocates a replacement).  D2H slots (keys that
    start with ``'d2h'``) are handed back with :meth:`release_unused` once
    their bytes are copied out, or dropped when the transfer failed.
    When a key's slots are all busy, :meth:`acquire` returns None and the
    caller takes a fresh buffer."""

    def __init__(self, depth):
        self.depth = max(int(depth), 1)
        # RLock: _on_array_death is a weakref finalizer and may run from
        # a GC pass inside a locked region of the same thread
        self._lock = threading.RLock()
        self._free = {}      # key -> [(buf, host)]
        self._busy = []      # [_Slot]
        self._nalloc = {}    # key -> slots currently accounted
        self._nbytes = {}    # key -> bytes of one slot

    @staticmethod
    def ready(slot):
        """Completion predicate of a bound slot's copy (tests replace it
        to drive the protocol on the CPU)."""
        return slot.event is None or slot.event.query()

    def pinned_bytes(self):
        """Bytes of the slots the pool accounts for (free or busy)."""
        with self._lock:
            return sum(n * self._nbytes[k] for k, n in self._nalloc.items())

    def _drop_slot(self, slot):
        # under self._lock: retire a slot whose transfer completion was
        # never observed: its buffer must never be reused
        if not slot.recycled:
            slot.recycled = True
            self._nalloc[slot.key] = \
                max(self._nalloc.get(slot.key, 1) - 1, 0)
            try:
                self._busy.remove(slot)
            except ValueError:
                pass

    def _on_array_death(self, slot):
        with self._lock:
            self._drop_slot(slot)

    def drop(self, slot):
        """Retire ``slot`` without reuse (its transfer failed or was
        abandoned while it may still run)."""
        with self._lock:
            self._drop_slot(slot)

    def release_unused(self, slot):
        """Return a slot whose buffer no transfer still uses straight to
        the free list."""
        with self._lock:
            if not slot.recycled:
                slot.recycled = True
                self._free.setdefault(slot.key, []).append(
                    (slot.buf, slot.host))

    def acquire(self, shape, dtype, kind=None, cap=None, pinned=True):
        """A staging slot for (shape, dtype), or None when the key's
        ``cap`` (default ``depth``) slots are all in use.  A new slot is
        pinned memory unless ``pinned`` is False (the CPU device)."""
        shape, dtype = tuple(shape), np.dtype(dtype)
        key = (shape, str(dtype)) if kind is None \
            else (kind, shape, str(dtype))
        with self._lock:
            for slot in list(self._busy):
                if slot.recycled:
                    continue
                t = slot.ref() if slot.ref is not None else None
                if t is None:
                    continue           # the finalizer owns it
                if self.ready(slot):
                    slot.recycled = True
                    self._free.setdefault(slot.key, []).append(
                        (slot.buf, slot.host))
                    self._busy.remove(slot)
            free = self._free.get(key)
            if free:
                return _Slot(*free.pop(), key=key)
            if self._nalloc.get(key, 0) < (cap or self.depth):
                buf, host = _alloc(shape, dtype, pinned)
                self._nalloc[key] = self._nalloc.get(key, 0) + 1
                self._nbytes[key] = int(host.nbytes)
                return _Slot(buf, host, key)
            return None

    def bind(self, slot, tensor, event):
        """Tie an H2D ``slot`` to the tensor made from it; the slot
        recycles once ``event`` is observed complete."""
        slot.event = event
        slot.ref = weakref.ref(tensor,
                               lambda _ref, s=slot: self._on_array_death(s))
        with self._lock:
            self._busy.append(slot)


class TransferFuture(object):
    """Handle for one non-blocking D2H copy.

    ``ready()`` is a cheap poll of the copy's event; ``result()`` waits
    on it (counting ``xfer.sync_waits`` only when it had to wait), does
    the host side (the copy out of a pinned slot, where there is one) and
    caches the value.  Futures complete correctly in any order.

    A transfer that fails (an injected fault, a CUDA error) completes
    the future with that error: every ``result()`` re-raises it, ``done``
    becomes True so the engine's drain retires it, and deferred ring
    fills turn it into ring poisoning (see :class:`HostFill`)."""

    __slots__ = ('_arrays', '_event', '_finish', '_abandon', '_done',
                 '_result', '_error', '_lock', '_nbytes')

    def __init__(self, arrays, event, finish, abandon=None, result=None,
                 done=False, nbytes=0):
        self._arrays = list(arrays)   # device tensors kept until done
        self._event = event
        self._finish = finish
        self._abandon = abandon
        self._done = done
        self._result = result
        self._error = None
        self._lock = threading.Lock()
        self._nbytes = int(nbytes)

    def ready(self):
        if self._done or self._event is None:
            return True
        try:
            return self._event.query()
        except RuntimeError:
            return True            # failed: result() will raise

    def result(self):
        with self._lock:
            if self._done:
                if self._error is not None:
                    raise self._error
                return self._result
            hist, spans = _obs()
            t0 = time.perf_counter()
            try:
                faults.fire('xfer.result')
                if self._event is not None and not self._event.query():
                    _counters().inc('xfer.sync_waits')
                    self._event.synchronize()
                self._result = self._finish()
            except Exception as exc:
                self._error = exc
                self._settle()
                _counters().inc('xfer.errors')
                raise
            # D2H completion as the host sees it: the residual wait on
            # the in-flight copy and the host copy out of a slot
            dt = time.perf_counter() - t0
            hist.observe('xfer.d2h_wait_s', dt)
            spans.record_elapsed('d2h', 'xfer', dt, bytes=self._nbytes)
            self._done = True
            self._arrays = []
            self._finish = self._abandon = None
            return self._result

    def cancel(self):
        """Abandon the transfer unread: nothing is written into its
        target after this returns."""
        with self._lock:
            if not self._done:
                self._settle()

    def _settle(self):
        # under self._lock: finish a transfer that will not be read
        self._done = True
        self._arrays = []
        self._finish = None
        abandon, self._abandon = self._abandon, None
        if abandon is not None:
            abandon()

    @property
    def error(self):
        return self._error

    @property
    def done(self):
        return self._done


class HostFill(object):
    """Deferred fill of a committed host ring span from an in-flight D2H
    transfer.

    The writing block registers the fill on the ring instead of
    blocking; readers acquiring any overlapping span call :meth:`wait`
    first (``ring.py``), so the bytes are materialized when first needed.
    ``wait`` is idempotent and thread-safe (readers, another block's
    per-gulp drain and the writer's wrap gate may race to complete the
    same fill).

    A failed transfer is not swallowed: the first ``wait`` records the
    error, poisons the target ring (waking every reader and writer with
    ``RingPoisonedError`` instead of handing them a span of garbage) and
    re-raises; later waits re-raise the same error."""

    __slots__ = ('future', 'dtype', 'out', 'post', 'begin', 'nbyte',
                 '_storage', '_ring', 'done', 'error', '_lock')

    def __init__(self, future, dtype, out_view, post=None):
        self.future = future
        self.dtype = dtype
        self.out = out_view
        self.post = post          # host-side conversion of the result
        self.begin = None
        self.nbyte = 0
        self._storage = None
        self._ring = None
        self.done = False
        self.error = None
        self._lock = threading.Lock()

    def attach(self, ring, begin, nbyte):
        """Bind the fill to its committed byte range so the ghost mirror
        can run after the data lands (called by ``WriteSpan.close``).  A
        fill that already completed (synchronous mode, or another
        thread's drain before the span closed) mirrors here; no reader
        can have acquired the span yet."""
        self._storage = ring._storage
        self._ring = ring
        self.begin = begin
        self.nbyte = nbyte
        with self._lock:
            if self.done and self.error is None and nbyte:
                self._storage.fill_ghost_mirror(begin, nbyte)

    def cancel(self):
        """Abandon the fill without writing (its span committed no bytes:
        the region may be re-reserved, and a late write would corrupt the
        next span)."""
        with self._lock:
            if not self.done:
                self.done = True
                self.future.cancel()

    def wait(self):
        """Complete the fill: wait on the transfer, land the bytes in the
        span's host view, then redo the ghost mirror for wrapped spans
        (the commit-time mirror ran before the bytes landed)."""
        with self._lock:
            if self.done:
                if self.error is not None:
                    raise self.error
                return
            try:
                host = self.future.result()
                if self.post is not None:
                    self.post(host)
                if self._storage is not None and self.nbyte:
                    self._storage.fill_ghost_mirror(self.begin,
                                                    self.nbyte)
            except Exception as exc:
                self.done = True
                self.error = exc
                _counters().inc('xfer.fill_errors')
                if self._ring is not None:
                    self._ring.poison(exc)
                raise
            self.done = True


class TransferEngine(object):
    """Pipelined host <-> device transfer engine (module docstring)."""

    def __init__(self, depth=None, staging=None, stage_min=None,
                 zero_copy=None):
        self.depth = depth if depth is not None \
            else _env_int('BF_XFER_DEPTH', 4)
        self.stage_min = stage_min if stage_min is not None \
            else _env_int('BF_XFER_STAGE_MIN', 1 << 14)
        #: override for tests; None = zero-copy on the CPU device only
        self._zero_copy = zero_copy
        self._pool = _StagingPool(staging if staging is not None
                                  else _env_int('BF_XFER_STAGING', 4))
        self._pending = deque()     # TransferFutures (to_host_async)
        self._fills = deque()       # HostFills (host_fill)
        self._lock = threading.Lock()
        self._streams = {}          # (kind, device index) -> Stream

    def _is_zero_copy(self, dev):
        if self._zero_copy is not None:
            return self._zero_copy
        return dev.type != 'cuda'

    @staticmethod
    def _device(device):
        import torch
        from .device import get_device
        return get_device() if device is None else torch.device(device)

    def _stream(self, kind, dev):
        """The engine's ``kind`` ('h2d' or 'd2h') copy stream on ``dev``."""
        key = (kind, dev.index)
        s = self._streams.get(key)
        if s is None:
            import torch
            with self._lock:
                s = self._streams.get(key)
                if s is None:
                    s = self._streams[key] = torch.cuda.Stream(device=dev)
        return s

    def pinned_bytes(self):
        """Pinned bytes the engine's staging slots hold."""
        return self._pool.pinned_bytes()

    def _bound(self, nbytes):
        """In-flight D2H bound for a transfer of ``nbytes``: ``depth``,
        lowered for gulps so large that ``depth + 1`` slots would pin
        more than ``_PIN_KEY_BYTES``."""
        return max(1, min(self.depth, _PIN_KEY_BYTES // max(int(nbytes),
                                                              1)))

    # -- H2D ---------------------------------------------------------------
    def _upload(self, src, dev, fresh):
        """Copy CPU tensor ``src`` to a new tensor on ``dev``; returns
        (tensor, event behind the copy or None).  On the card the copy
        runs on the engine's H2D stream and the caller's stream waits on
        it.  On the CPU a ``fresh`` source is the result itself (nothing
        else holds it), else it is cloned."""
        import torch
        if dev.type != 'cuda':
            return (src if fresh else src.clone()), None
        s = self._stream('h2d', dev)
        cur = torch.cuda.current_stream(dev)
        with torch.cuda.stream(s):
            out = torch.empty(src.shape, dtype=src.dtype, device=dev)
            out.copy_(src, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(s)
        # the tensor's memory came from the copy stream's pool and is
        # used on the caller's: order the caller after the copy, and keep
        # the allocator from reusing the memory before the caller's work
        cur.wait_event(ev)
        out.record_stream(cur)
        return out, ev

    def _stage_ship(self, shape, dtype, nbytes, fill, dev):
        """The one copy of the staging-slot protocol (shared by
        :meth:`to_device` and :meth:`to_device_batch`): acquire a slot
        (size and strict gated) or a fresh buffer, let ``fill(host)``
        write the host bytes, ship them, and bind the slot to the new
        tensor for recycling.  A fill that fails returns its slot unused;
        a ship that fails drops it (its copy may have been issued)."""
        c = _counters()
        slot = None
        if not self._is_zero_copy(dev) and nbytes >= self.stage_min \
                and not strict_mode():
            slot = self._pool.acquire(shape, dtype,
                                      pinned=dev.type == 'cuda')
        if slot is not None:
            try:
                fill(slot.host)
            except Exception:
                self._pool.release_unused(slot)
                raise
            try:
                out, ev = self._upload(_host_tensor(slot.buf, slot.host),
                                       dev, False)
            except Exception:
                self._pool.drop(slot)
                raise
            self._pool.bind(slot, out, ev)
            c.inc('xfer.h2d_staged')
        else:
            buf, host = _alloc(shape, dtype, dev.type == 'cuda')
            fill(host)
            out, _ = self._upload(_host_tensor(buf, host), dev, True)
            c.inc('xfer.h2d_unstaged')
        c.inc('xfer.h2d_issued')
        c.inc('xfer.h2d_bytes', int(nbytes))
        return out

    def _observe_h2d(self, t0, nbytes):
        hist, spans = _obs()
        dt = time.perf_counter() - t0
        hist.observe('xfer.h2d_s', dt)
        hist.observe('xfer.h2d_nbytes', int(nbytes))
        spans.record_elapsed('h2d', 'xfer', dt, bytes=int(nbytes))

    def to_device(self, arr, device=None):
        """numpy -> tensor on ``device`` (default: the port's), with
        exactly one host copy.  Safe against the caller mutating or
        recycling ``arr`` after the call returns."""
        arr = np.asarray(arr)
        dev = self._device(device)
        t0 = time.perf_counter()
        faults.fire('xfer.h2d')
        out = self._stage_ship(
            arr.shape, arr.dtype, int(arr.nbytes),
            lambda host: np.copyto(host, arr, casting='no'), dev)
        self._observe_h2d(t0, arr.nbytes)
        return out

    def to_device_direct(self, arr, device=None):
        """Ship a C-contiguous numpy array that lies in pinned memory (a
        ``cuda_host`` span) with no host copy; returns (tensor, event).
        The caller must not change or release ``arr`` before ``event``
        completes (None: the copy is done).  On the CPU the tensor is a
        copy."""
        dev = self._device(device)
        if dev.type == 'cuda' and not (arr.flags.c_contiguous and
                                       _pinned(arr)):
            raise ValueError("to_device_direct needs a C-contiguous array "
                             "in pinned memory")
        t0 = time.perf_counter()
        faults.fire('xfer.h2d')
        out, ev = self._upload(_as_tensor(arr), dev, False)
        c = _counters()
        c.inc('xfer.h2d_direct')
        c.inc('xfer.h2d_issued')
        c.inc('xfer.h2d_bytes', int(arr.nbytes))
        self._observe_h2d(t0, arr.nbytes)
        return out, ev

    def prefetch(self, arr, device=None):
        """Issue the H2D copy of ``arr`` now and return the tensor at
        once (the copy is asynchronous): stage gulp N+1 while gulp N
        computes.  Identical to :meth:`to_device`; the name documents
        intent at call sites."""
        return self.to_device(arr, device)

    def to_device_batch(self, arrs, device=None):
        """Stage K same-shape host gulps with one engine call: one
        staging buffer covering the batch, one host copy pass, one copy
        to the device.  Returns the stacked ``(K, *shape)`` tensor."""
        arrs = [np.asarray(a) for a in arrs]
        if not arrs:
            raise ValueError("to_device_batch needs at least one array")
        shape, dtype = arrs[0].shape, arrs[0].dtype
        for a in arrs[1:]:
            if a.shape != shape or a.dtype != dtype:
                raise ValueError(
                    "to_device_batch requires uniform shape/dtype "
                    "(got %s/%s vs %s/%s)"
                    % (a.shape, a.dtype, shape, dtype))
        dev = self._device(device)
        faults.fire('xfer.h2d')
        t0 = time.perf_counter()
        k = len(arrs)
        bshape = (k,) + tuple(shape)
        nbytes = int(np.dtype(dtype).itemsize * np.prod(bshape))

        def fill(host):
            for i, a in enumerate(arrs):
                np.copyto(host[i], a, casting='no')

        out = self._stage_ship(bshape, dtype, nbytes, fill, dev)
        _counters().inc('xfer.h2d_batched', k)
        self._observe_h2d(t0, nbytes)
        return out

    # -- D2H ---------------------------------------------------------------
    def _future_for(self, t, target=None):
        """TransferFuture of tensor ``t``'s bytes, landing in numpy
        ``target`` (same element type and size) when given, else in a
        new host array."""
        faults.fire('xfer.d2h')
        if hasattr(t, 'as_numpy'):         # bifrost_tpu_torch.ndarray
            t = t.as_numpy()
        if isinstance(t, np.ndarray):
            if target is not None:
                np.copyto(target, t.reshape(target.shape))
                t = target
            return TransferFuture([], None, None, result=t, done=True)
        nbytes = t.numel() * t.element_size()
        c = _counters()
        c.inc('xfer.d2h_issued')
        c.inc('xfer.d2h_bytes', int(nbytes))
        _obs()[0].observe('xfer.d2h_nbytes', int(nbytes))
        if t.device.type != 'cuda':
            return TransferFuture([t], None,
                                  lambda: _cpu_result(t, target),
                                  nbytes=nbytes)
        return self._d2h(t, target, nbytes)

    def _d2h(self, t, target, nbytes):
        import torch
        dev = t.device
        shape = tuple(t.shape)
        np_dtype = _np_dtype_of(t.dtype)
        slot = abandon = None
        if target is not None and target.flags.c_contiguous and \
                target.dtype == np_dtype and target.size == t.numel() \
                and _pinned(target):
            host = target
            dst = _as_tensor(target).view(shape)
            _counters().inc('xfer.d2h_direct')
        else:
            if target is not None:
                slot = self._pool.acquire(shape, np_dtype, kind='d2h',
                                          cap=self._bound(nbytes) + 1)
                _counters().inc('xfer.d2h_staged')
            buf, host = (slot.buf, slot.host) if slot is not None \
                else _alloc(shape, np_dtype, True)
            dst = _host_tensor(buf, host)
        s = self._stream('d2h', dev)
        # the copy reads what the caller's stream produced (its ring
        # reads waited on the chunk's event there)
        s.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(s):
            dst.copy_(t, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(s)
        # the caller may free t on its own stream while the copy reads it
        t.record_stream(s)
        if slot is not None:
            pool = self._pool

            def finish():
                np.copyto(target, host.reshape(target.shape))
                pool.release_unused(slot)
                return target

            def abandon():
                # reuse the slot only once the copy into it is over
                try:
                    ev.synchronize()
                except RuntimeError:
                    pool.drop(slot)
                else:
                    pool.release_unused(slot)
        elif target is not None and host is target:
            def finish():
                return target

            def abandon():
                # the copy writes into the caller's span: let it land
                # before the span's bytes can be handed out again
                try:
                    ev.synchronize()
                except RuntimeError:
                    pass
        elif target is not None:
            def finish():
                np.copyto(target, host.reshape(target.shape))
                return target
        else:
            def finish():
                return host
        return TransferFuture([t], ev, finish, abandon, nbytes=nbytes)

    def to_host(self, arr, out=None):
        """tensor -> numpy; blocks until the bytes are on the host (the
        D2H sync point, reference: cudaStreamSynchronize per gulp).
        Fills ``out`` when given (its element type must be the tensor's,
        its size the tensor's) and returns it."""
        return self._future_for(arr, out).result()

    def _bound_queue(self, queue, item, nbytes):
        """Append ``item``; returns the oldest items past the in-flight
        bound, for the caller to complete outside the lock."""
        bound = self._bound(nbytes)
        with self._lock:
            queue.append(item)
            over = []
            while len(queue) > bound:
                over.append(queue.popleft())
        return over

    def to_host_async(self, arr):
        """Start a non-blocking D2H copy of ``arr``; returns a
        :class:`TransferFuture`.  Registering one past the in-flight
        bound completes the oldest first.  With the engine disabled
        (``BF_XFER_ASYNC=0`` / strict mode) the future is completed before
        returning."""
        fut = self._future_for(arr)
        if not async_enabled():
            fut.result()
            return fut
        _counters().inc('xfer.d2h_async')
        for old in self._bound_queue(self._pending, fut, fut._nbytes):
            if not old.done and not old.ready():
                # a real wait: the bound forced a drain before the copy
                # finished on its own
                _counters().inc('xfer.depth_waits')
            old.result()
        return fut

    def host_fill(self, dev_arr, dtype, out_view):
        """A :class:`HostFill` landing ``dev_arr`` (the device
        representation of bifrost dtype ``dtype``) in ``out_view``.
        Bounded like :meth:`to_host_async`; completed before returning
        when the engine is disabled."""
        from .devrep import from_device_plan
        t, target, post = from_device_plan(dev_arr, dtype, out_view)
        fut = self._future_for(t, target)
        fill = HostFill(fut, dtype, out_view, post)
        if not async_enabled():
            fill.wait()
            return fill
        _counters().inc('xfer.d2h_async')
        for old in self._bound_queue(self._fills, fill, fut._nbytes):
            # HostFill.done flips only inside wait(): poll the transfer
            # before charging a real wait
            if not old.done and not old.future.ready():
                _counters().inc('xfer.depth_waits')
            old.wait()
        return fill

    def drain(self, block=False):
        """Retire completed async transfers (non-blocking scan); with
        ``block=True``, force every outstanding one to complete.  Returns
        the number retired.  The pipeline's gulp loop calls this once a
        gulp.

        A failed transfer raises out of the draining thread (after the
        failure is recorded on the future or fill, so the queues still
        retire it): the block whose gulp loop drained it then fails
        instead of the error vanishing."""
        n = 0
        error = None
        with self._lock:
            pending = list(self._pending)
            fills = list(self._fills)
        for fut in pending:
            if block or fut.ready():
                try:
                    fut.result()
                except Exception as exc:
                    error = error if error is not None else exc
        for fill in fills:
            if block or fill.done or fill.future.ready():
                try:
                    fill.wait()
                except Exception as exc:
                    error = error if error is not None else exc
        with self._lock:
            for q in (self._pending, self._fills):
                while q and q[0].done:
                    q.popleft()
                    n += 1
        if error is not None:
            raise error
        return n

    def cancel_fills(self, pred):
        """Cancel the incomplete deferred fills whose target ring
        satisfies ``pred(ring)`` (``Pipeline.run`` after an abort: fills
        into poisoned rings that nobody will read); their staging slots
        go back to the pool and nothing lands in the ring.  Returns the
        number cancelled."""
        with self._lock:
            fills = [f for f in self._fills if not f.done]
        n = 0
        for fill in fills:
            if pred(fill._ring):
                fill.cancel()
                n += 1
        if n:
            _counters().inc('xfer.fills_cancelled', n)
        return n

    @property
    def outstanding(self):
        with self._lock:
            return (sum(1 for f in self._pending if not f.done) +
                    sum(1 for f in self._fills if not f.done))


def _cpu_result(t, target):
    """The host side of a D2H from the CPU device: a copy of ``t``'s
    values into ``target`` or into a new array."""
    a = t.detach().resolve_conj().resolve_neg().numpy()
    if target is None:
        return a.copy()
    np.copyto(target, a.reshape(target.shape))
    return target


_engine = None
_engine_lock = threading.Lock()


def engine():
    """The process-wide TransferEngine (created on first use)."""
    global _engine
    if _engine is None:
        with _engine_lock:
            if _engine is None:
                _engine = TransferEngine()
    return _engine


def reset_engine():
    """Drop the process engine, completing what it has in flight (tests:
    re-read the environment; ``chip_smoke.py``: release its slots)."""
    global _engine
    with _engine_lock:
        if _engine is not None:
            try:
                _engine.drain(block=True)
            except Exception:
                pass       # failed transfers die with the engine
        _engine = None


def to_device(arr, device=None):
    """numpy -> tensor through the transfer engine (module docstring).
    The caller may mutate or recycle ``arr`` at once."""
    return engine().to_device(arr, device)


def to_host(arr, out=None):
    """tensor -> numpy; blocks until the bytes are on the host.  Takes
    tensors, numpy arrays and the port's ndarrays; fills ``out`` when
    given."""
    if hasattr(arr, 'as_numpy'):       # bifrost_tpu_torch.ndarray
        arr = arr.as_numpy()
    if isinstance(arr, np.ndarray):
        if out is None:
            return arr
        np.copyto(out, arr.reshape(out.shape))
        return out
    return engine().to_host(arr, out)


def to_host_async(arr):
    """Non-blocking D2H; returns a :class:`TransferFuture`."""
    return engine().to_host_async(arr)


def prefetch(arr, device=None):
    """Issue an H2D transfer ahead of need; returns the tensor."""
    return engine().prefetch(arr, device)


def to_device_batch(arrs, device=None):
    """Stage K same-shape host gulps with one engine call; returns the
    stacked (K, *shape) tensor."""
    return engine().to_device_batch(arrs, device)
