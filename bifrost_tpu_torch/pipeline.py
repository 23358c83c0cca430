"""Pipeline runtime: scoped configuration, thread-per-block execution,
gulp/overlap negotiation and zero-fill of lost frames.

Semantics of the reference pipeline (reference:
python/bifrost/pipeline.py:84-779), as ``bifrost_tpu/pipeline.py``
implements them: a Pipeline collects the Blocks built under it;
``run()`` starts one thread per block; blocks talk through rings; a
two-phase init barrier aborts cleanly when a block fails to open its
sequences; unguaranteed readers that fall behind zero-fill the skipped
frames.

On the card, a block's per-gulp work is asynchronous.  Each gulp that
commits device tensors records a CUDA event, and once ``sync_depth``
gulps are outstanding the block waits on the newest of the older ones
(one event wait per drain, no host read of data) — the bound on device
run-ahead the reference gets from one ``cudaStreamSynchronize`` per gulp
(reference: pipeline.py:628).

Each gulp of each block counts into ``pipeline.gulps`` (and
``pipeline.gulps_device``, ``pipeline.sync_waits``), its block's
``block.<name>.dispatches`` / ``.gulps`` counters and ``gulp_s`` /
``ring_wait_s`` / ``batch_gulps`` histograms, and, when span recording
is on (``BF_TRACE_FILE``), a ``<name>.on_data`` compute span carrying
(seq, gulp); under ``BF_TRACE=1`` the dispatch is also an NVTX range on
the card.  Once a gulp the block retires the transfer engine's completed
D2H transfers (``xfer.engine().drain()``), so a failed transfer fails the
block that drained it.  ``run()`` arms ``BF_FAULTS``, re-reads the span
configuration, and before it returns completes every transfer still in
flight and writes the trace file.

The JAX package's supervision policies, SLOs, compiled segments,
auto-tuner and static verifier are not part of this runtime yet; their
place is kept as a no-op seam (:meth:`Pipeline._prepare_graph`).  A
failing block always aborts the pipeline: its output rings are poisoned
so peers wake up, and ``run()`` raises :class:`PipelineRuntimeError`
with the original traceback.
"""

from __future__ import annotations

import queue as queue_mod
import signal
import threading
import time
import traceback
import warnings
from collections import defaultdict, deque
from contextlib import ExitStack
from copy import copy

from . import device, xfer
from .ndarray import memset_array
from .proclog import ProcLog
from .ring import Ring, EndOfDataStop, RingPoisonedError, ring_view
from .space import space_accessible
from .telemetry import counters as _counters
from .telemetry import histograms as _histograms
from .telemetry import spans as _spans
from .testing import faults
from .trace import ScopedTracer, tracing_enabled as _tracing

__all__ = ['Pipeline', 'BlockScope', 'Block', 'SourceBlock',
           'MultiTransformBlock', 'TransformBlock', 'SinkBlock',
           'get_default_pipeline', 'get_current_block_scope',
           'block_scope', 'block_view', 'get_ring', 'izip',
           'PipelineInitError',
           'PipelineRuntimeError', 'resolve_sync_depth']


def izip(*iterables):
    """Zip generators, stopping cleanly at the first end of data."""
    while True:
        try:
            yield [next(it) for it in iterables]
        except (EndOfDataStop, StopIteration):
            return


class _Stacks(threading.local):
    def __init__(self):
        self.pipelines = []
        self.scopes = []


_stacks = _Stacks()


def get_default_pipeline():
    if not _stacks.pipelines:
        _stacks.pipelines.append(Pipeline())
        _stacks.scopes.append(_stacks.pipelines[-1])
    return _stacks.pipelines[-1]


def get_current_block_scope():
    if not _stacks.scopes:
        get_default_pipeline()
    return _stacks.scopes[-1]


def block_scope(*args, **kwargs):
    return BlockScope(*args, **kwargs)


def resolve_sync_depth(scope):
    """Device run-ahead in gulps: the ``sync_depth`` tunable, else
    :data:`BlockScope.DEFAULT_SYNC_DEPTH`."""
    d = scope.sync_depth
    return BlockScope.DEFAULT_SYNC_DEPTH if d is None else max(int(d), 0)


class BlockScope(object):
    """Nestable configuration scope; unset tunables inherit from the
    enclosing scope (reference: pipeline.py:84-162).

    Tunables: gulp_nframe, buffer_nframe, buffer_factor, sync_depth
    (device run-ahead in gulps), sync_strict (True: every D2H completes
    before its span commits, as ``BF_SYNC_STRICT=1`` makes it) and mesh
    (a :class:`bifrost_tpu_torch.parallel.Mesh` for the sharded ops of the
    blocks within the scope; the correlator and FDMT blocks read it)."""

    DEFAULT_SYNC_DEPTH = 4

    instance_count = 0

    _TUNABLES = ('gulp_nframe', 'buffer_nframe', 'buffer_factor',
                 'sync_depth', 'sync_strict', 'mesh')

    def __init__(self, name=None, gulp_nframe=None, buffer_nframe=None,
                 buffer_factor=None, sync_depth=None, sync_strict=None,
                 mesh=None):
        if name is None:
            name = 'BlockScope_%i' % BlockScope.instance_count
            BlockScope.instance_count += 1
        self.name = name
        self._gulp_nframe = gulp_nframe
        self._buffer_nframe = buffer_nframe
        self._buffer_factor = buffer_factor
        self._sync_depth = sync_depth
        self._sync_strict = sync_strict
        self._mesh = mesh
        self._parent_scope = get_current_block_scope() \
            if not isinstance(self, Pipeline) else None
        if self._parent_scope is not None:
            self._parent_scope._children.append(self)
            self.name = self._parent_scope.name + '/' + self.name
        self._children = []

    def __enter__(self):
        _stacks.scopes.append(self)
        return self

    def __exit__(self, typ, value, tb):
        popped = _stacks.scopes.pop()
        assert popped is self

    def __getattr__(self, name):
        if name.startswith('_') or name not in BlockScope._TUNABLES:
            raise AttributeError(name)
        value = self.__dict__.get('_' + name)
        if value is not None:
            return value
        parent = self.__dict__.get('_parent_scope')
        return getattr(parent, name) if parent is not None else None


class PipelineInitError(Exception):
    pass


class PipelineRuntimeError(RuntimeError):
    """A block failed while the pipeline ran; carries each failure as
    (block name, exception, formatted traceback)."""

    def __init__(self, failures):
        self.failures = list(failures)
        name, exc, tb = self.failures[0]
        super(PipelineRuntimeError, self).__init__(
            "block %s failed: %s: %s\n%s"
            % (name, type(exc).__name__, exc, tb))


class Pipeline(BlockScope):
    """Collects blocks and runs each in its own thread
    (reference: pipeline.py:221-293)."""

    instance_count = 0

    def __init__(self, name=None, **kwargs):
        if name is None:
            name = 'Pipeline_%i' % Pipeline.instance_count
            Pipeline.instance_count += 1
        super(Pipeline, self).__init__(name=name, **kwargs)
        self.blocks = []
        self.threads = []
        self.shutdown_timeout = 5.
        self.all_blocks_finished_initializing_event = threading.Event()
        self.block_init_queue = queue_mod.Queue()
        self._failures = []
        self._failure_lock = threading.Lock()

    def synchronize_block_initializations(self):
        """Init barrier: every block opens its output sequences before
        any block processes data; a failed block aborts the pipeline
        (reference: pipeline.py:236-248)."""
        uninitialized = set(self.blocks)
        while uninitialized:
            block, ok = self.block_init_queue.get()
            uninitialized.discard(block)
            if not ok:
                self.shutdown()
                raise PipelineInitError(
                    "The following block failed to initialize: %s%s"
                    % (block.name, self._failure_detail(block)))
        self.all_blocks_finished_initializing_event.set()

    def _failure_detail(self, block):
        with self._failure_lock:
            for name, _exc, tb in self._failures:
                if name == block.name:
                    return '\n' + tb.rstrip()
        return ''

    def _record_failure(self, block, exc):
        with self._failure_lock:
            self._failures.append((block.name, exc,
                                   traceback.format_exc()))

    def _prepare_graph(self):
        """Seam where the JAX package rewrites and checks the block
        graph before it runs (segment compiler, static verifier,
        auto-tuner).  The port has none of them yet."""

    def run(self):
        """Start every block thread, wait for all of them, complete the
        transfers still in flight, and raise :class:`PipelineRuntimeError`
        if any block failed (or, with none failed, the error of a
        transfer that failed after its block finished)."""
        self._prepare_graph()
        faults.arm_from_env()
        # honour BF_TRACE_FILE / BF_SPAN_BUFFER changes since the last
        # run, and keep earlier runs' dead threads out of this trace
        _spans.reconfigure()
        _spans.prune_dead_buffers()
        self._failures = []
        self.all_blocks_finished_initializing_event.clear()
        self.threads = [threading.Thread(target=block.run, name=block.name,
                                         daemon=True)
                        for block in self.blocks]
        try:
            for thread in self.threads:
                thread.start()
            try:
                self.synchronize_block_initializations()
                for thread in self.threads:
                    while thread.is_alive():
                        thread.join(timeout=0.2)
            except KeyboardInterrupt:
                self.shutdown()
                raise
            # no deferred fill outlives its pipeline
            try:
                xfer.engine().drain(block=True)
            except Exception:
                if not self._failures:
                    raise
        finally:
            _spans.export_if_configured()
        if self._failures:
            raise PipelineRuntimeError(self._failures)

    def shutdown(self):
        """Stop every block: set their shutdown events and poison their
        rings so that threads blocked in ring waits wake up."""
        cause = RuntimeError("pipeline shutdown")
        for block in self.blocks:
            block.shutdown_event.set()
            for ring in list(block.orings) + list(block.irings):
                ring.poison(cause)
        self.all_blocks_finished_initializing_event.set()
        deadline = time.monotonic() + self.shutdown_timeout
        for thread in self.threads:
            thread.join(max(deadline - time.monotonic(), 0))

    def shutdown_on_signals(self, signals=None):
        """Shut the pipeline down on SIGHUP, SIGINT, SIGQUIT, SIGTERM or
        SIGTSTP (or the given signals; reference: pipeline.py:282-290)."""
        if signals is None:
            signals = [signal.SIGHUP, signal.SIGINT, signal.SIGQUIT,
                       signal.SIGTERM, signal.SIGTSTP]
        for sig in signals:
            signal.signal(sig, self._handle_signal_shutdown)

    def _handle_signal_shutdown(self, signum, frame):
        warnings.warn("Received signal %d, shutting down pipeline" % signum,
                      RuntimeWarning)
        self.shutdown()

    def __enter__(self):
        _stacks.pipelines.append(self)
        _stacks.scopes.append(self)
        return self

    def __exit__(self, typ, value, tb):
        _stacks.scopes.pop()
        popped = _stacks.pipelines.pop()
        assert popped is self


def get_ring(block_or_ring):
    try:
        return block_or_ring.orings[0]
    except AttributeError:
        return block_or_ring


def block_view(block, header_transform):
    """A view of ``block`` whose output headers are transformed on the fly
    (reference: pipeline.py:305-322; ``bifrost_tpu/pipeline.py:760-766``):
    a shallow copy whose output rings are ring views.  The copy is not a
    block of the pipeline; the blocks built on it read the views."""
    new_block = copy(block)
    new_block.orings = [ring_view(oring, header_transform)
                        for oring in new_block.orings]
    return new_block


class Block(BlockScope):
    """Base class: ring ownership, thread entry, proclogs
    (reference: pipeline.py:324-434)."""

    instance_counts = defaultdict(lambda: 0)

    def __init__(self, irings, name=None, type_=None, **kwargs):
        self.type = type_ or self.__class__.__name__
        self.name = name or ('%s_%i'
                             % (self.type, Block.instance_counts[self.type]))
        Block.instance_counts[self.type] += 1
        super(Block, self).__init__(name=self.name, **kwargs)
        self.pipeline = get_default_pipeline()
        self.pipeline.blocks.append(self)
        self.irings = [get_ring(iring) for iring in irings]
        for i, (iring, valid) in enumerate(
                zip(self.irings, self._define_valid_input_spaces())):
            if not space_accessible(iring.space, valid):
                raise ValueError(
                    "Block %s input %d's space (%s) must be accessible "
                    "from one of: %s" % (self.name, i, iring.space, valid))
        self.orings = []   # set by subclasses
        self.shutdown_event = threading.Event()
        self.perf_proclog = ProcLog(self.name + '/perf')
        #: seconds spent per phase over all gulps, and the gulp count
        self.perf_totals = {'acquire': 0.0, 'reserve': 0.0,
                            'process': 0.0, 'ngulp': 0}
        self._pending_events = deque()
        self._h_gulp = self._h_wait = self._h_batch = None

    def create_ring(self, *args, **kwargs):
        return Ring(*args, **kwargs)

    def run(self):
        try:
            with ExitStack() as oring_stack:
                orings = [oring_stack.enter_context(oring.begin_writing())
                          for oring in self.orings]
                self.main(orings)
            # a block can finish without opening a sequence (empty
            # input): release the init barrier anyway
            self.pipeline.block_init_queue.put((self, True))
        except RingPoisonedError as exc:
            # a peer failed or shutdown is winding us down
            self._poison_orings(exc)
            if not self.pipeline.all_blocks_finished_initializing_event \
                    .is_set():
                self.pipeline.block_init_queue.put((self, False))
        except Exception as exc:
            if not self.shutdown_event.is_set():
                self.pipeline._record_failure(self, exc)
            self.pipeline.block_init_queue.put((self, False))
            # abort: wake the consumers and stop the producers too
            self._poison_orings(exc)
            for iring in self.irings:
                iring.poison(exc)

    def _poison_orings(self, exc):
        for oring in self.orings:
            oring.poison(exc)

    def _observe_gulp(self, acquire, reserve, process):
        """Per-gulp telemetry: the three host-clock times summed in
        ``perf_totals`` and the last gulp's in the perf proclog
        (``acquire`` is -1 for sources), the ``block.<name>.gulp_s`` and
        ``.ring_wait_s`` histograms, and one dispatch of one gulp on the
        ``block.<name>.dispatches`` / ``.gulps`` counters and the
        ``.batch_gulps`` histogram (the JAX package's
        ``_observe_gulp`` and ``_observe_dispatch``)."""
        tot = self.perf_totals
        tot['acquire'] += max(acquire, 0.0)
        tot['reserve'] += reserve
        tot['process'] += process
        tot['ngulp'] += 1
        self.perf_proclog.update({'acquire_time': acquire,
                                  'reserve_time': reserve,
                                  'process_time': process})
        if self._h_gulp is None:
            self._h_gulp = _histograms.get_or_create(
                'block.%s.gulp_s' % self.name, unit='s')
            self._h_wait = _histograms.get_or_create(
                'block.%s.ring_wait_s' % self.name, unit='s')
            self._h_batch = _histograms.get_or_create(
                'block.%s.batch_gulps' % self.name, unit='gulps')
        wait = max(acquire, 0.0) + reserve
        self._h_gulp.record(wait + process)
        self._h_wait.record(wait)
        _counters.inc('block.%s.dispatches' % self.name)
        _counters.inc('block.%s.gulps' % self.name)
        self._h_batch.record(1)

    def _dispatch(self, fn, seq, gulp, *args):
        """``fn(*args)`` inside the gulp's compute span (seq, gulp)
        when span recording is on, and an NVTX range under
        ``BF_TRACE=1``."""
        with ExitStack() as scopes:
            if _spans.enabled():
                scopes.enter_context(_spans.span(
                    self.name + '.on_data', 'compute', seq=seq, gulp=gulp))
            if _tracing():
                scopes.enter_context(ScopedTracer(self.name + '/on_data'))
            return fn(*args)

    def begin_sequences(self, exit_stack, orings, oheaders,
                        igulp_nframes, istride_nframes):
        # the output header's gulp_nframe excludes overlap
        # (reference: pipeline.py:383-399)
        ostride_nframes = self._define_output_nframes(istride_nframes)
        for ohdr, ostride in zip(oheaders, ostride_nframes):
            ohdr['gulp_nframe'] = ostride
        ogulp_nframes = self._define_output_nframes(igulp_nframes)
        # writers buffer one gulp; extra depth belongs to readers
        oseqs = [exit_stack.enter_context(
                     oring.begin_sequence(ohdr, ogulp, ogulp))
                 for oring, ohdr, ogulp
                 in zip(orings, oheaders, ogulp_nframes)]
        # init barrier (reference: pipeline.py:401-403)
        self.pipeline.block_init_queue.put((self, True))
        self.pipeline.all_blocks_finished_initializing_event.wait()
        ogulp_overlaps = [g - s for g, s
                          in zip(ogulp_nframes, ostride_nframes)]
        return oseqs, ogulp_overlaps

    def reserve_spans(self, exit_stack, oseqs, igulp_nframes=()):
        ogulp_nframes = self._define_output_nframes(list(igulp_nframes))
        return [exit_stack.enter_context(oseq.reserve(onframe))
                for oseq, onframe in zip(oseqs, ogulp_nframes)]

    def commit_spans(self, ospans, ostrides_actual, ogulp_overlaps):
        if ostrides_actual is None:
            ostrides_actual = [None] * len(ospans)
        for ospan, ostride, overlap in zip(ospans, ostrides_actual,
                                           ogulp_overlaps):
            ospan.commit(ostride if ostride is not None
                         else max(ospan.nframe - overlap, 0))

    def _sync_gulp(self, ospans):
        """Bound device run-ahead: record an event behind each gulp that
        committed device tensors and, once more than ``sync_depth`` are
        outstanding, wait on the newest of the older ones (the stream
        runs in order, so that implies all of them; counted in
        ``pipeline.sync_waits``).  Then retire the transfer engine's
        completed D2H transfers without blocking."""
        _counters.inc('pipeline.gulps')
        if any(s.ring.is_device and s.data is not None for s in ospans):
            _counters.inc('pipeline.gulps_device')
            ev = device.record_event()
            if ev is not None:
                pend = self._pending_events
                pend.append(ev)
                if len(pend) > resolve_sync_depth(self):
                    while len(pend) > 1:
                        last = pend.popleft()
                    _counters.inc('pipeline.sync_waits')
                    device.stream_synchronize(last)
        xfer.engine().drain()

    def _define_output_nframes(self, input_nframes):
        return self.define_output_nframes(input_nframes)

    def define_output_nframes(self, input_nframes):
        raise NotImplementedError

    def _define_valid_input_spaces(self):
        return self.define_valid_input_spaces()

    def define_valid_input_spaces(self):
        return ['any'] * len(self.irings)


class SourceBlock(Block):
    """0-in/1-out block reading from named sources
    (reference: pipeline.py:436-507)."""

    def __init__(self, sourcenames, gulp_nframe, space=None, *args,
                 **kwargs):
        super(SourceBlock, self).__init__([], *args,
                                          gulp_nframe=gulp_nframe, **kwargs)
        self.sourcenames = sourcenames
        self.orings = [self.create_ring(space=space or 'system')]
        self._seq_count = 0

    def main(self, orings):
        for sourcename in self.sourcenames:
            if self.shutdown_event.is_set():
                break
            self._read_source(orings, sourcename)

    def _read_source(self, orings, sourcename):
        with self.create_reader(sourcename) as ireader:
            oheaders = self.on_sequence(ireader, sourcename)
            for ohdr in oheaders:
                ohdr.setdefault('time_tag', self._seq_count)
                ohdr.setdefault('name',
                                'unnamed-sequence-%i' % self._seq_count)
            self._seq_count += 1
            seq_id = self._seq_count - 1
            gulp = 0
            with ExitStack() as oseq_stack:
                oseqs, ogulp_overlaps = self.begin_sequences(
                    oseq_stack, orings, oheaders, [], [])
                while not self.shutdown_event.is_set():
                    t0 = time.time()
                    with ExitStack() as ospan_stack:
                        ospans = self.reserve_spans(ospan_stack, oseqs)
                        t1 = time.time()
                        ostrides = self._dispatch(self.on_data, seq_id,
                                                  gulp, ireader, ospans)
                        gulp += 1
                        self._sync_gulp(ospans)
                        self.commit_spans(ospans, ostrides, ogulp_overlaps)
                        if any(o == 0 for o in ostrides):
                            break
                    self._observe_gulp(-1, t1 - t0, time.time() - t1)

    def define_output_nframes(self, _):
        return [self.gulp_nframe] * len(self.orings)

    def define_valid_input_spaces(self):
        return []

    def create_reader(self, sourcename):
        """A context manager giving the reader passed to on_sequence
        and on_data."""
        raise NotImplementedError

    def on_sequence(self, reader, sourcename):
        """Return a list of output headers."""
        raise NotImplementedError

    def on_data(self, reader, ospans):
        """Fill ospans; return frames committed per output (0 ends the
        sequence)."""
        raise NotImplementedError


class MultiTransformBlock(Block):
    """N-in/N-out engine: zip-reads the input rings, negotiates gulp and
    overlap, zero-fills skipped and overwritten frames
    (reference: pipeline.py:517-688)."""

    def __init__(self, irings_, guarantee=True, *args, **kwargs):
        super(MultiTransformBlock, self).__init__(irings_, *args, **kwargs)
        self.guarantee = guarantee
        self.orings = [self.create_ring(space=iring.space)
                       for iring in self.irings]
        self._seq_count = 0

    def main(self, orings):
        for iseqs in izip(*[iring.read(guarantee=self.guarantee)
                            for iring in self.irings]):
            if self.shutdown_event.is_set():
                break
            if not self._process_sequence(orings, iseqs):
                break

    def _process_sequence(self, orings, iseqs):
        oheaders = self._on_sequence(iseqs)
        for ohdr in oheaders:
            ohdr.setdefault('time_tag', self._seq_count)
        self._seq_count += 1
        seq_id = self._seq_count - 1
        gulp = 0

        istride_nframes = [self.gulp_nframe or iseq.header['gulp_nframe']
                           for iseq in iseqs]
        igulp_overlaps = self._define_input_overlap_nframe(iseqs)
        igulp_nframes = [g + o for g, o
                         in zip(istride_nframes, igulp_overlaps)]

        for iseq, igulp in zip(iseqs, igulp_nframes):
            iseq.resize(gulp_nframe=igulp, buf_nframe=self.buffer_nframe,
                        buffer_factor=self.buffer_factor)

        with ExitStack() as oseq_stack:
            oseqs, ogulp_overlaps = self.begin_sequences(
                oseq_stack, orings, oheaders, igulp_nframes,
                istride_nframes)
            if self.shutdown_event.is_set():
                return False
            prev_time = time.time()
            for ispans in izip(*[iseq.read(igulp, istride)
                                 for iseq, igulp, istride
                                 in zip(iseqs, igulp_nframes,
                                        istride_nframes)]):
                if self.shutdown_event.is_set():
                    return False
                if any(ispan.nframe_skipped for ispan in ispans):
                    # zero-fill frames lost to overwriting
                    # (reference: pipeline.py:590-606)
                    with ExitStack() as ospan_stack:
                        iskip_nframes = [ispan.nframe_skipped
                                         for ispan in ispans]
                        ospans = self.reserve_spans(ospan_stack, oseqs,
                                                    iskip_nframes)
                        self._on_skip(ospans)
                        self._sync_gulp(ospans)
                        self.commit_spans(
                            ospans, [o.nframe for o in ospans],
                            ogulp_overlaps)
                if all(ispan.nframe == 0 for ispan in ispans):
                    continue
                cur_time = time.time()
                acquire_time = cur_time - prev_time
                prev_time = cur_time
                with ExitStack() as ospan_stack:
                    ospans = self.reserve_spans(
                        ospan_stack, oseqs,
                        [ispan.nframe for ispan in ispans])
                    cur_time = time.time()
                    reserve_time = cur_time - prev_time
                    prev_time = cur_time
                    ostrides = self._dispatch(self._on_data, seq_id, gulp,
                                              ispans, ospans)
                    gulp += 1
                    if any(ispan.nframe_overwritten for ispan in ispans):
                        # the input changed under us: publish zeros
                        # (reference: pipeline.py:630-644)
                        self._on_skip(ospans)
                    self._sync_gulp(ospans)
                    self.commit_spans(ospans, ostrides, ogulp_overlaps)
                cur_time = time.time()
                self._observe_gulp(acquire_time, reserve_time,
                                   cur_time - prev_time)
                prev_time = cur_time
        self._on_sequence_end(iseqs)
        return True

    def _on_skip(self, ospans):
        """Publish zeros into every output span."""
        from .devrep import device_rep_zeros
        for ospan in ospans:
            if ospan.ring.is_device:
                ospan.set(device_rep_zeros(ospan.shape, ospan.dtype))
            else:
                memset_array(ospan.data, 0)

    def _on_sequence(self, iseqs):
        return self.on_sequence(iseqs)

    def _on_sequence_end(self, iseqs):
        return self.on_sequence_end(iseqs)

    def _on_data(self, ispans, ospans):
        return self.on_data(ispans, ospans)

    def _define_input_overlap_nframe(self, iseqs):
        return self.define_input_overlap_nframe(iseqs)

    def define_input_overlap_nframe(self, iseqs):
        """Frames of overlap between successive input spans, per input."""
        return [0] * len(self.irings)

    def define_output_nframes(self, input_nframes):
        return input_nframes

    def on_sequence(self, iseqs):
        """Return one output header per output."""
        raise NotImplementedError

    def on_sequence_end(self, iseqs):
        pass

    def on_data(self, ispans, ospans):
        """Process ispans into ospans; return frames to commit per
        output (or None to commit whole spans)."""
        raise NotImplementedError


class TransformBlock(MultiTransformBlock):
    """1-in/1-out specialization (reference: pipeline.py:690-741)."""

    def __init__(self, iring, *args, **kwargs):
        super(TransformBlock, self).__init__([iring], *args, **kwargs)
        self.iring = self.irings[0]

    def _define_valid_input_spaces(self):
        return [self.define_valid_input_spaces()]

    def define_valid_input_spaces(self):
        return 'any'

    def _define_input_overlap_nframe(self, iseqs):
        return [self.define_input_overlap_nframe(iseqs[0])]

    def define_input_overlap_nframe(self, iseq):
        return 0

    def _define_output_nframes(self, input_nframes):
        return [self.define_output_nframes(input_nframes[0])]

    def define_output_nframes(self, input_nframe):
        return input_nframe

    def _on_sequence(self, iseqs):
        return [self.on_sequence(iseqs[0])]

    def on_sequence(self, iseq):
        raise NotImplementedError

    def _on_sequence_end(self, iseqs):
        return self.on_sequence_end(iseqs[0])

    def on_sequence_end(self, iseq):
        pass

    def _on_data(self, ispans, ospans):
        return [self.on_data(ispans[0], ospans[0])]

    def on_data(self, ispan, ospan):
        raise NotImplementedError


class SinkBlock(MultiTransformBlock):
    """1-in/0-out specialization (reference: pipeline.py:744-779)."""

    def __init__(self, iring, *args, **kwargs):
        super(SinkBlock, self).__init__([iring], *args, **kwargs)
        self.orings = []
        self.iring = self.irings[0]

    def _define_valid_input_spaces(self):
        return [self.define_valid_input_spaces()]

    def define_valid_input_spaces(self):
        return 'any'

    def _define_input_overlap_nframe(self, iseqs):
        return [self.define_input_overlap_nframe(iseqs[0])]

    def define_input_overlap_nframe(self, iseq):
        return 0

    def _define_output_nframes(self, input_nframes):
        return []

    def _on_sequence(self, iseqs):
        self.on_sequence(iseqs[0])
        return []

    def on_sequence(self, iseq):
        raise NotImplementedError

    def _on_sequence_end(self, iseqs):
        return self.on_sequence_end(iseqs[0])

    def on_sequence_end(self, iseq):
        pass

    def _on_data(self, ispans, ospans):
        self.on_data(ispans[0])
        return []

    def on_data(self, ispan):
        raise NotImplementedError
