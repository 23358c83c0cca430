"""Pipeline runtime: scoped configuration, thread-per-block execution,
gulp/overlap negotiation and zero-fill of lost frames.

Semantics of the reference pipeline (reference:
python/bifrost/pipeline.py:84-779), as ``bifrost_tpu/pipeline.py``
implements them: a Pipeline collects the Blocks built under it;
``run()`` starts one thread per block; blocks talk through rings; a
two-phase init barrier aborts cleanly when a block fails to open its
sequences; unguaranteed readers that fall behind hand the frames lost to
overwriting to the block's ``on_skip`` (zero-fill by default) and skip
the next gulp too.

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

Supervision (:mod:`bifrost_tpu_torch.supervision`,
``bifrost_tpu/pipeline.py:537-1068``): a block that raises is handled by
its ``on_failure`` tunable.  ``abort`` (the default) poisons every ring
and ``run()`` raises :class:`PipelineRuntimeError` with the original
traceback; ``restart`` re-enters the block's main loop with backoff,
its writing session held open; ``skip_sequence`` abandons the sequence
at hand.  ``run()`` arms the stall watchdog (``watchdog_secs`` /
``BF_WATCHDOG_SECS``), the health monitor (:meth:`Pipeline.health`) and
the metrics publisher (``telemetry.exporter``) after the init barrier,
and stops them when it returns.  The fault seams ``block.run``,
``block.on_sequence`` and ``block.on_data`` sit where the JAX pipeline
has them.

Source blocks stamp a trace context into each sequence header
(``header_standard``), transforms and sinks propagate it, compute spans
carry its id, rings age commits against it and sinks record the
capture -> exit age (``telemetry.slo``).  A block's ``overload_policy``
tunable (or ``BF_OVERLOAD_POLICY``) sets its output rings' policy at
start; its ``core`` tunable pins its thread (``affinity``).

Macro-gulp execution (:mod:`bifrost_tpu_torch.macro`): under the
``gulp_batch`` tunable (or ``BF_GULP_BATCH``) an eligible block reads,
reserves and commits K gulps a span and dispatches once for them; the
output headers keep the logical gulp, a macro writer's ring holds a
second macro span of depth, and ``block.<name>.dispatches`` counts
dispatches beside the logical ``.gulps``.  Under the ``donate`` tunable
(or ``BF_DONATE=1``) the stage blocks claim their input chunks out of
the ring (:meth:`TransformBlock._take_donatable`, counted on
``donation.hits`` / ``.misses``).  ``Pipeline(segments=...)`` (or
``BF_SEGMENTS``) runs the segment compiler
(:mod:`bifrost_tpu_torch.segments`) in :meth:`Pipeline._prepare_graph`
before any thread starts, after ``Pipeline(auto_fuse=True)`` (or
``BF_AUTO_FUSE=1``) has replaced each chain of single-stage device blocks
by one FusedBlock (:meth:`Pipeline._auto_fuse`).  Blocks under
``block_scope(fuse=True)`` give the rings between them one gulp of
buffering; a block's ``device`` tunable binds its thread to that card.

Then ``run()`` checks the graph that will run with the static verifier
(:mod:`bifrost_tpu_torch.analysis.verify`, :meth:`Pipeline.validate`):
``BF_VALIDATE=warn`` (the default) reports, ``strict`` refuses a pipeline
with any ``BF-E`` diagnostic, ``off`` skips it, and ``BF_LINT=1`` reports
and returns without starting a thread.  It re-reads ``BF_RINGCHECK``
(the ring-protocol checker) before the threads start.  Under
``BF_TORCH_PROFILE=<dir>`` the first dispatch of a device block (a fused
block, segment or stage block) runs inside a one-shot ``torch.profiler``
capture (:mod:`bifrost_tpu_torch.telemetry.profiling`).
"""

from __future__ import annotations

import os
import queue as queue_mod
import signal
import sys
import threading
import time
import traceback
import warnings
from collections import defaultdict, deque
from contextlib import ExitStack
from copy import copy

from . import affinity, device, xfer
from .header_standard import (TRACE_CONTEXT_KEY, ensure_trace_context,
                              propagate_trace_context)
from .ndarray import memset_array
from .proclog import ProcLog
from .ring import Ring, EndOfDataStop, RingPoisonedError, ring_view
from .space import space_accessible
from .supervision import PipelineRuntimeError, PipelineStallError
from .telemetry import counters as _counters
from .telemetry import exporter as _metrics_exporter
from .telemetry import histograms as _histograms
from .telemetry import slo as _slo
from .telemetry import spans as _spans
from .telemetry import profiling as _profiling
from .temp_storage import TempStorage
from .testing import faults
from .trace import ScopedTracer, tracing_enabled as _tracing

__all__ = ['Pipeline', 'BlockScope', 'Block', 'SourceBlock',
           'MultiTransformBlock', 'TransformBlock', 'SinkBlock',
           'get_default_pipeline', 'get_current_block_scope',
           'block_scope', 'block_view', 'get_ring', 'izip',
           'PipelineInitError', 'PipelineRuntimeError',
           'PipelineStallError', 'resolve_sync_depth',
           'resolve_overload_policy', 'resolve_donate', 'join_all']


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


def resolve_donate(scope):
    """Buffer donation for ``scope``: the ``donate`` tunable where set in
    the scope chain, else ``BF_DONATE=1`` (off by default)."""
    d = scope.donate
    if d is not None:
        return bool(d)
    return os.environ.get('BF_DONATE', '0') == '1'


def resolve_sync_depth(scope):
    """Device run-ahead in gulps: the ``sync_depth`` tunable where set in
    the scope chain, else ``BF_SYNC_DEPTH``, else
    :data:`BlockScope.DEFAULT_SYNC_DEPTH`.  Read per gulp, so the
    auto-tuner's change of ``pipeline._sync_depth`` holds from the next
    gulp.  0 is legal: a hard drain every gulp."""
    d = scope.sync_depth
    if d is None:
        try:
            d = int(os.environ.get('BF_SYNC_DEPTH', '') or
                    BlockScope.DEFAULT_SYNC_DEPTH)
        except ValueError:
            d = BlockScope.DEFAULT_SYNC_DEPTH
    try:
        return max(int(d), 0)
    except (TypeError, ValueError):
        return BlockScope.DEFAULT_SYNC_DEPTH


def resolve_overload_policy(scope):
    """The overload policy of ``scope``'s output rings: the
    ``overload_policy`` tunable where set in the scope chain, else
    ``BF_OVERLOAD_POLICY``, else None (the ring keeps its own, 'block'
    unless set directly).  A bad value raises here."""
    p = scope.overload_policy
    if p is None:
        p = os.environ.get('BF_OVERLOAD_POLICY', '').strip() or None
    if p is not None and p not in Ring.OVERLOAD_POLICIES:
        raise ValueError(
            "Unknown overload policy %r (BF_OVERLOAD_POLICY / "
            "overload_policy scope tunable); expected one of %s"
            % (p, ', '.join(Ring.OVERLOAD_POLICIES)))
    return p


class BlockScope(object):
    """Nestable configuration scope; unset tunables inherit from the
    enclosing scope (reference: pipeline.py:84-162).

    Tunables: gulp_nframe, buffer_nframe, buffer_factor, sync_depth
    (device run-ahead in gulps), sync_strict (True: every D2H completes
    before its span commits, as ``BF_SYNC_STRICT=1`` makes it), mesh (a
    :class:`bifrost_tpu_torch.parallel.Mesh` for the sharded ops of the
    blocks within the scope; the correlator and FDMT blocks read it),
    core (the host core a block's thread is pinned to),
    share_temp_storage (blocks under the scope share one
    :class:`~bifrost_tpu_torch.temp_storage.TempStorage` a space),
    on_failure ('abort' | 'restart' | 'skip_sequence'), max_restarts and
    restart_backoff (defaults ``BF_RESTART_MAX`` 3 and
    ``BF_RESTART_BACKOFF`` 0.1 s), overload_policy ('block' |
    'drop_oldest' | 'drop_newest', for the block's output rings),
    shed_tolerant (a consumer's declaration that it accepts gapped input
    from a drop-policy ring), gulp_batch (the macro-gulp batch K,
    :func:`bifrost_tpu_torch.macro.resolve_gulp_batch`), donate (buffer
    donation, :func:`resolve_donate`) and device (the index of the card a
    block's thread binds before it runs, :func:`device.bind_device`;
    ``gpu=`` is its alias, as in the reference).

    ``fuse=True`` makes the scope a fused scope
    (``bifrost_tpu/pipeline.py:264-274``): a ring written by one block of
    the scope and read by another gets one gulp of buffering
    (``buffer_factor`` 1), so that producer and consumer alternate
    (reference: pipeline.py:558-568)."""

    DEFAULT_SYNC_DEPTH = 4

    instance_count = 0

    _TUNABLES = ('gulp_nframe', 'buffer_nframe', 'buffer_factor',
                 'sync_depth', 'sync_strict', 'mesh', 'core', 'device',
                 'share_temp_storage', 'on_failure', 'max_restarts',
                 'restart_backoff', 'overload_policy', 'shed_tolerant',
                 'donate', 'gulp_batch')

    def __init__(self, name=None, gulp_nframe=None, buffer_nframe=None,
                 buffer_factor=None, sync_depth=None, sync_strict=None,
                 mesh=None, core=None, share_temp_storage=False,
                 on_failure=None, max_restarts=None, restart_backoff=None,
                 overload_policy=None, shed_tolerant=None, donate=None,
                 gulp_batch=None, fuse=False, device=None, gpu=None):
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
        self._core = core
        self._share_temp_storage = share_temp_storage
        self._on_failure = on_failure
        self._max_restarts = max_restarts
        self._restart_backoff = restart_backoff
        self._overload_policy = overload_policy
        self._shed_tolerant = shed_tolerant
        self._donate = donate
        self._gulp_batch = gulp_batch
        self._device = device if device is not None else gpu
        self._fused = fuse
        self._temp_storage = {}
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

    @property
    def gpu(self):
        """The reference's name of the ``device`` tunable."""
        return self.device

    def _scope_hierarchy(self):
        """The enclosing scopes, outermost first."""
        out, parent = [], self._parent_scope
        while parent is not None:
            out.append(parent)
            parent = parent._parent_scope
        return list(reversed(out))

    def cache_scope_hierarchy(self):
        """Record the enclosing scopes and the outermost fused one
        (``fused_ancestor``, None when no enclosing scope fuses)."""
        self.scope_hierarchy = self._scope_hierarchy()
        self.fused_ancestor = None
        for ancestor in self.scope_hierarchy:
            if ancestor._fused:
                self.fused_ancestor = ancestor
                break

    def is_fused_with(self, other):
        """Whether this scope and ``other`` lie under the same fused
        scope (both must have cached their hierarchy)."""
        return (self.fused_ancestor is not None and
                self.fused_ancestor is getattr(other, 'fused_ancestor',
                                               None))

    def _own_temp_storage(self, space):
        if space not in self._temp_storage:
            self._temp_storage[space] = TempStorage(space)
        return self._temp_storage[space]

    def get_temp_storage(self, space):
        """Scratch storage for ``space``: that of the outermost enclosing
        scope with ``share_temp_storage`` set, else this scope's own
        (``bifrost_tpu/pipeline.py:277-286``)."""
        for scope in getattr(self, 'scope_hierarchy',
                             self._scope_hierarchy()):
            if scope.share_temp_storage:
                return scope._own_temp_storage(space)
        return self._own_temp_storage(space)

    def dot_graph(self):
        """Graphviz DOT source of the block and ring graph under this
        scope (reference: pipeline.py:163-201), ring nodes coloured by
        space."""
        lines = ['digraph "%s" {' % self.name]
        space_colors = {'system': 'orange', 'cuda': 'limegreen',
                        'cuda_host': 'deepskyblue'}

        def walk(scope):
            for child in scope._children:
                if isinstance(child, Block):
                    lines.append('  "%s" [shape=box,style=filled,'
                                 'fillcolor=white];' % child.name)
                    for oring in child.orings:
                        lines.append('  "%s" [shape=ellipse,style=filled,'
                                     'fillcolor=%s];'
                                     % (oring.name,
                                        space_colors.get(oring.space,
                                                         'white')))
                        lines.append('  "%s" -> "%s";'
                                     % (child.name, oring.name))
                    for iring in child.irings:
                        lines.append('  "%s" -> "%s";'
                                     % (iring.name, child.name))
                else:
                    walk(child)

        walk(self)
        lines.append('}')
        return '\n'.join(lines)


class PipelineInitError(Exception):
    pass


def join_all(threads, timeout):
    """Join ``threads`` within ``timeout`` seconds in all; returns those
    still alive."""
    deadline = time.time() + timeout
    alive = list(threads)
    while True:
        alive = [t for t in alive if not _try_join(t)]
        remaining = max(deadline - time.time(), 0)
        if not alive or remaining == 0:
            return alive
        alive[0].join(min(remaining, 0.5))


def _try_join(thread, timeout=0.):
    thread.join(timeout)
    return not thread.is_alive()


class Pipeline(BlockScope):
    """Collects blocks and runs each in its own thread
    (reference: pipeline.py:221-293)."""

    instance_count = 0

    def __init__(self, name=None, auto_fuse=None, watchdog_secs=None,
                 segments=None, **kwargs):
        if name is None:
            name = 'Pipeline_%i' % Pipeline.instance_count
            Pipeline.instance_count += 1
        super(Pipeline, self).__init__(name=name, **kwargs)
        if auto_fuse is None:
            auto_fuse = os.environ.get('BF_AUTO_FUSE',
                                       '0').strip() == '1'
        #: pipeline auto-fusion (:meth:`_auto_fuse`), run by run()
        self.auto_fuse = auto_fuse
        #: segment-compiler mode (:mod:`bifrost_tpu_torch.segments`):
        #: None defers to BF_SEGMENTS (off by default); 'auto' replaces
        #: every provably safe chain of stage blocks by one SegmentBlock
        #: and elides the rings inside it; 'force' also raises when none
        #: forms
        self.segments = segments
        #: the SegmentBlocks the compiler made (run())
        self._segments = []
        #: stall-watchdog window in seconds (None: BF_WATCHDOG_SECS or
        #: off)
        self.watchdog_secs = watchdog_secs
        self.blocks = []
        self.threads = []
        self.shutdown_timeout = 5.
        #: the failure-policy engine; created by run()
        self.supervisor = None
        self._shutting_down = False
        self.all_blocks_finished_initializing_event = threading.Event()
        self.block_init_queue = queue_mod.Queue()

    def as_default(self):
        """Make this pipeline the default one of the calling thread (and
        its outermost scope), without a ``with`` block."""
        _stacks.pipelines.append(self)
        _stacks.scopes.append(self)

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
                detail = ''
                if self.supervisor is not None:
                    recorded = self.supervisor.failures_for(block.name)
                    if recorded:
                        detail = '\n' + recorded[-1].traceback.rstrip()
                raise PipelineInitError(
                    "The following block failed to initialize: %s%s"
                    % (block.name, detail))
        self.all_blocks_finished_initializing_event.set()

    def _prepare_graph(self):
        """Rewrite the block graph before any thread starts, in the JAX
        package's order (``bifrost_tpu/pipeline.py:539-551``): auto-fusion
        when ``auto_fuse`` is on, then the segment compiler unless its
        mode is 'off', both before the verifier, so that it judges the
        graph that will run."""
        if self.auto_fuse:
            self._auto_fuse()
        from . import segments as _segments
        if _segments.resolve_mode(self.segments) != 'off':
            _segments.compile_pipeline(self)

    def _auto_fuse(self):
        """Replace each chain of adjacent single-stage device blocks by
        one FusedBlock (``bifrost_tpu/pipeline.py:401-505``), so that a
        reference-style pipeline written as separate fft / detect /
        reduce blocks runs the fused chain, and the whole-chain kernel
        where the chain matches one (K1 for the Guppi spectrometer).

        On with ``Pipeline(auto_fuse=True)`` or ``BF_AUTO_FUSE=1``.  A
        block joins a chain when it is a :class:`_StageBlock` with one
        input on a ``'cuda'`` ring and a guarantee; an interior ring must
        have exactly one consumer, reading it directly (a ``block_view``
        tap counts as a consumer), and every block of a chain must
        resolve the same core, device, mesh, gulp and buffering
        tunables.  The FusedBlock, named ``AutoFused_x<n>_<head>``, is
        built under the head's scope with the chain's resolved tunables
        and writes into the tail's output ring, whose owner it becomes;
        the replaced blocks leave the pipeline and start no thread."""
        from .blocks.fft import _StageBlock
        from .blocks.fused import FusedBlock

        def fusable(b):
            # device rings only: a stage block on a host ring runs a host
            # path that does not fuse
            return (isinstance(b, _StageBlock)
                    and len(b.irings) == 1 and len(b.orings) == 1
                    and b.irings[0].space == 'cuda'
                    and getattr(b, 'guarantee', True))

        tunables = ('core', 'device', 'mesh', 'gulp_nframe',
                    'buffer_factor', 'buffer_nframe', 'sync_depth',
                    'sync_strict')

        def compatible(a, b):
            for t in tunables:
                va, vb = getattr(a, t), getattr(b, t)
                if va is not vb and va != vb:
                    return False
            return True

        # keyed by the underlying ring: a view tap reads through a
        # RingView whose identity differs from the producer's ring
        def base_ring(r):
            return getattr(r, '_base_ring', r)

        consumers = {}
        for b in self.blocks:
            for r in getattr(b, 'irings', ()):
                consumers.setdefault(id(base_ring(r)), []).append(b)

        def sole_consumer(prod):
            lst = consumers.get(id(base_ring(prod.orings[0])), [])
            if len(lst) != 1:
                return None
            # read directly: a view carries a header transform that the
            # fused chain would drop
            nxt = lst[0]
            direct = any(r is prod.orings[0] for r in nxt.irings)
            return nxt if direct else None

        chains = []
        in_chain = set()
        for b in self.blocks:
            if not fusable(b) or id(b) in in_chain:
                continue
            prod = getattr(b.irings[0], 'owner', None)
            if (prod is not None and fusable(prod)
                    and sole_consumer(prod) is b
                    and compatible(prod, b)):
                continue                  # inside another chain
            chain = [b]
            while True:
                nxt = sole_consumer(chain[-1])
                if (nxt is not None and fusable(nxt)
                        and id(nxt) not in in_chain
                        and compatible(chain[-1], nxt)):
                    chain.append(nxt)
                else:
                    break
            if len(chain) >= 2:
                chains.append(chain)
                in_chain.update(id(x) for x in chain)

        for chain in chains:
            head, tail = chain[0], chain[-1]
            # built under the head's scope, into this pipeline whatever
            # the thread's default, with the chain's resolved tunables
            # (settings made on the blocks themselves are not visible
            # through the parent scope)
            _stacks.pipelines.append(self)
            _stacks.scopes.append(head._parent_scope or self)
            try:
                fb = FusedBlock(
                    head.irings[0], [blk._stage for blk in chain],
                    name='AutoFused_x%d_%s'
                         % (len(chain), head.name.split('/')[-1]),
                    **{t: getattr(head, t) for t in tunables})
            finally:
                _stacks.scopes.pop()
                _stacks.pipelines.pop()
            # the tail's output ring becomes the FusedBlock's, and its
            # owner follows (fused-scope buffering reads ring.owner); the
            # ring fb made for itself is never written
            fb.orings = [tail.orings[0]]
            tail.orings[0].owner = fb
            for blk in chain:
                self.blocks.remove(blk)
                parent = blk._parent_scope
                if parent is not None and blk in parent._children:
                    parent._children.remove(blk)

    def run(self, autotune=None):
        """Start every block thread and supervise them to the end
        (``bifrost_tpu/pipeline.py:537-676``).

        ``autotune`` starts the closed-loop auto-tuner
        (:mod:`bifrost_tpu_torch.autotune`): ``True`` or ``'on'`` tunes,
        ``'freeze'`` tunes, pins and dumps a profile, ``None`` defers to
        ``BF_AUTOTUNE``.  It starts before the block threads, so that a
        warm-start profile is applied before the first sequence resolves
        its tunables, and stops before the metrics publisher.

        A block that raises is handled by its ``on_failure`` policy; a
        fatal failure poisons every ring, the wind-down waits at most
        ``shutdown_timeout``, and the failure re-raises here as
        :class:`PipelineRuntimeError` with its traceback.  The watchdog,
        health monitor and metrics publisher run between the init
        barrier and the end.  Before it returns, ``run()`` completes the
        transfers still in flight (after an abort, the deferred fills
        into poisoned rings are cancelled instead) and raises, with no
        block failed, the error of a transfer that failed after its
        block finished."""
        from .supervision import Supervisor
        from .analysis import ringcheck as _ringcheck
        from .analysis import verify as _verify
        self._prepare_graph()
        # ``bifrost_tpu/pipeline.py:546-566``: lint mode builds and
        # reports without running; the gate reports (warn) or refuses
        # on a BF-E (strict)
        if os.environ.get('BF_LINT', '').strip() == '1':
            _verify.lint_intercept(self)
            return
        mode = _verify.validate_mode()
        if mode != 'off':
            _verify.gate_run(self, mode)
        # a device pipeline initialises CUDA from this thread, before any
        # block thread touches the card
        if any(r.space != 'system' for b in self.blocks
               for r in list(b.irings) + list(b.orings)):
            device.ensure_backend()
        faults.arm_from_env()
        _ringcheck.reconfigure()
        # honour BF_TRACE_FILE / BF_SPAN_BUFFER / BF_SLO_MS changes since
        # the last run, and keep earlier runs' dead threads out of this
        # trace
        _spans.reconfigure()
        _spans.prune_dead_buffers()
        _slo.reset_budget()
        self._shutting_down = False
        self.supervisor = Supervisor(self)
        self.all_blocks_finished_initializing_event.clear()
        metrics = None
        from . import autotune as _autotune
        tuner = _autotune.maybe_start(self, autotune)
        try:
            try:
                self.threads = [threading.Thread(target=block.run,
                                                 name=block.name,
                                                 daemon=True)
                                for block in self.blocks]
                for block, thread in zip(self.blocks, self.threads):
                    block._thread = thread
                    thread.start()
            except BaseException:
                # no controller ticks against a pipeline that never ran
                if tuner is not None:
                    tuner.stop(wait=False)
                raise
            try:
                self.synchronize_block_initializations()
                self.supervisor.start_watchdog(self.watchdog_secs)
                self.supervisor.start_health()
                metrics = _metrics_exporter.MetricsPublisher(self)
                metrics.start()
                self._join_supervised()
            except KeyboardInterrupt:
                self.shutdown()
                raise
            finally:
                self.supervisor.stop_watchdog()
                self.supervisor.stop_health()
                if tuner is not None:
                    tuner.stop()         # publishes the final knob state
                if metrics is not None:
                    metrics.stop()       # publishes one last snapshot
            self._complete_transfers()
        finally:
            _spans.export_if_configured()
        self.supervisor.raise_if_failed()

    def _join_supervised(self):
        """Join the block threads in 0.2 s slices; after an abort, wait
        at most ``shutdown_timeout`` for the rest."""
        abort_deadline = None
        alive = list(self.threads)
        while alive:
            alive[0].join(timeout=0.2)
            alive = [t for t in alive if t.is_alive()]
            if alive and self.supervisor.abort_event.is_set():
                if abort_deadline is None:
                    abort_deadline = time.monotonic() + \
                        self.shutdown_timeout
                elif time.monotonic() >= abort_deadline:
                    for t in alive:
                        warnings.warn(
                            "Thread %s did not shut down in time after "
                            "pipeline abort" % t.name, RuntimeWarning)
                    break

    def _complete_transfers(self):
        """No deferred fill outlives its pipeline: after an abort the
        fills into poisoned rings are cancelled (nobody will read them);
        the rest complete.  A transfer error raises when no block
        failed."""
        eng = xfer.engine()
        if self.supervisor.abort_event.is_set():
            eng.cancel_fills(lambda ring: ring is not None and
                             ring.poisoned)
        try:
            eng.drain(block=True)
        except Exception:
            if not any(f.fatal for f in self.supervisor.failures):
                raise

    def validate(self):
        """The static verifier's diagnostics for the graph as built,
        without running anything (``bifrost_tpu/pipeline.py:675-689``).
        ``run()`` rewrites the graph with auto-fusion and the segment
        compiler before its own check, so this sees the graph before
        fusion, with a BF-I190 for each boundary the compiler would not
        fuse."""
        from .analysis import verify
        return verify.verify_pipeline(self)

    def health(self):
        """The pipeline's health (``bifrost_tpu/pipeline.py:691-708``):
        ``{'state': 'OK' | 'DEGRADED' | 'SHEDDING' | 'STALLED' |
        'FAILED', 'since': unix time, 'blocks': {name: state},
        'transitions': [...]}``, kept current by the health monitor while
        ``run()`` is live and evaluated on demand otherwise."""
        supervisor = self.supervisor
        if supervisor is None:
            return {'state': 'OK', 'since': None,
                    'blocks': {b.name: 'OK' for b in self.blocks},
                    'transitions': []}
        return supervisor.health_snapshot()

    def shutdown(self):
        """Stop every block: set their shutdown events and poison their
        rings so that threads blocked in ring waits wake up."""
        self._shutting_down = True
        cause = RuntimeError("pipeline shutdown")
        for block in self.blocks:
            block.shutdown()
            for ring in list(block.orings) + list(block.irings):
                ring.poison(cause)
        self.all_blocks_finished_initializing_event.set()
        join_all(self.threads, timeout=self.shutdown_timeout)
        for thread in self.threads:
            if thread.is_alive():
                warnings.warn("Thread %s did not shut down in time"
                              % thread.name, RuntimeWarning)

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

    #: whether this block's dispatch is a device dispatch that the
    #: one-shot ``BF_TORCH_PROFILE`` capture may bracket (the fused,
    #: segment and stage blocks set it)
    _profile_eligible = False

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
        self.bind_proclog = ProcLog(self.name + '/bind')
        #: seconds spent per phase over all dispatches, the dispatch
        #: count (``ngulp``) and the logical gulps they covered
        #: (``nlogical``, K a dispatch under macro-gulp execution)
        self.perf_totals = {'acquire': 0.0, 'reserve': 0.0,
                            'process': 0.0, 'ngulp': 0, 'nlogical': 0}
        self._pending_events = deque()
        self._h_gulp = self._h_wait = self._h_batch = None
        #: supervision: the thread running this block (set by
        #: Pipeline.run) and the heartbeat the watchdog reads
        self._thread = None
        self._hb_time = None
        self._hb_gulps = 0
        #: trace context of the sequence at hand
        self._trace_ctx = None
        #: macro-gulp state of the sequence at hand (set by
        #: MultiTransformBlock._process_sequence): the active batch K
        #: (1 = off), the logical input gulp and the input overlap
        self._gulp_batch_active = 1
        self._macro_gulp_in = None
        self._macro_overlap_in = 0
        #: kept current by the health monitor (see :meth:`on_health`)
        self.health_state = 'OK'
        self.init_trace = ''.join(traceback.format_stack()[:-1])

    def create_ring(self, *args, **kwargs):
        return Ring(*args, owner=self, **kwargs)

    def shutdown(self):
        self.shutdown_event.set()

    def heartbeat(self):
        """Record progress for the watchdog (once a gulp through
        ``_sync_gulp``, and at sequence boundaries)."""
        self._hb_time = time.monotonic()
        self._hb_gulps += 1

    def on_health(self, state, prev):
        """Called by the health monitor when this block's health state
        changes (OK -> DEGRADED under SLO pressure, -> SHEDDING when its
        rings drop): override to cheapen work under pressure and restore
        it on the way back.  Runs on the monitor's thread; must be quick
        and must not raise (errors count on ``health.hook_errors``)."""

    def run(self):
        if self.core is not None:
            affinity.set_core(self.core if isinstance(self.core, int)
                              else self.core[0])
        self.bind_proclog.update({'ncore': 1, 'core0': affinity.get_core()},
                                 force=True)
        self.cache_scope_hierarchy()
        # the output rings take the block's overload policy
        policy = resolve_overload_policy(self)
        if policy is not None:
            for oring in self.orings:
                getattr(oring, '_base_ring', oring) \
                    .set_overload_policy(policy)
        self._hb_time = time.monotonic()
        with ExitStack() as oring_stack:
            # the writing session stays open across restarts: ending it
            # between attempts would hand downstream an end of data
            orings = self.begin_writing(oring_stack, self.orings)
            self._supervised_main(orings)

    def num_outputs(self):
        return len(self.orings)

    def begin_writing(self, exit_stack, orings):
        """Open the writing session of each of ``orings`` on
        ``exit_stack``; returns the rings."""
        return [exit_stack.enter_context(oring.begin_writing())
                for oring in orings]

    def _supervised_main(self, orings):
        """``main`` under the pipeline's failure policies
        (``bifrost_tpu/pipeline.py:990-1055``): a clean return ends the
        block; a poisoned ring (a peer failed, or shutdown) poisons the
        outputs and ends it; any other error goes to the supervisor,
        which restarts the block after a backoff or aborts the pipeline.
        Before a restart the device events of the failed attempt are
        waited on and dropped, so the new attempt's run-ahead bound
        starts empty.  A block with a ``device`` tunable binds its thread
        to that card first (:func:`device.bind_device`); an index with no
        card fails the block like any error, before the init barrier."""
        supervisor = self.pipeline.supervisor
        restarts = 0
        while True:
            try:
                faults.fire('block.run', self.name)
                if self.device is not None:
                    device.bind_device(self.device)
                self.main(orings)
                # a block can finish without opening a sequence (empty
                # input, every sequence skipped): release the barrier
                self.pipeline.block_init_queue.put((self, True))
                if supervisor is not None:
                    supervisor.block_finished(self)
                return
            except RingPoisonedError as exc:
                if supervisor is not None:
                    supervisor.block_poisoned(self, exc)
                self._poison_orings(exc)
                if (not self.pipeline
                        .all_blocks_finished_initializing_event.is_set()
                        and not self.pipeline._shutting_down):
                    self.pipeline.block_init_queue.put((self, False))
                return
            except Exception as exc:
                if supervisor is not None and \
                        not self.shutdown_event.is_set():
                    decision, delay = supervisor.block_failed(
                        self, exc, restarts)
                    if decision == 'restart':
                        restarts += 1
                        self._drop_pending_events()
                        # shutdown cancels the backoff
                        if not self.shutdown_event.wait(delay):
                            continue
                        return
                self.pipeline.block_init_queue.put((self, False))
                self._poison_orings(exc)
                sys.stderr.write("From block instantiated here:\n")
                sys.stderr.write(self.init_trace)
                if supervisor is None:
                    raise
                traceback.print_exc()
                return

    def _drop_pending_events(self):
        """Wait on the device events a failed attempt left and forget
        them."""
        pend, self._pending_events = self._pending_events, deque()
        if pend:
            try:
                device.stream_synchronize(pend[-1])
            except Exception:
                pass     # the failed attempt's own error is recorded

    def _poison_orings(self, exc):
        for oring in self.orings:
            try:
                oring.poison(exc)
            except Exception:
                pass

    def _failure_policy(self):
        return self.on_failure or 'abort'

    def _may_skip(self):
        """Whether skip_sequence can absorb a failure here: only once the
        init barrier is released (skipping a block's first sequence would
        leave downstream blocks with no sequence to open)."""
        return (self._failure_policy() == 'skip_sequence' and
                self.pipeline.all_blocks_finished_initializing_event
                .is_set())

    def _observe_exit_age(self, iheader, frame_end):
        """Capture -> pipeline-exit age of a sink's gulp; a no-op without
        a trace context in the input header.  A stream that crossed one
        or more bridge hops also records the fabric age: the same
        instant against the origin host's capture time, corrected by the
        hops' handshake clock offsets (``skew_ns``)."""
        age = _slo.capture_age_s(iheader, frame_end)
        if age is not None:
            _slo.observe_exit(self.name, age)
            ctx = self._trace_ctx or {}
            if ctx.get('hops'):
                _slo.observe_fabric_exit(self.name, age)

    def _observe_gulp(self, acquire, reserve, process):
        """Per-dispatch telemetry: the three host-clock times summed in
        ``perf_totals`` and the last dispatch's in the perf proclog
        (``acquire`` is -1 for sources), and the ``block.<name>.gulp_s``
        and ``.ring_wait_s`` histograms."""
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

    def _observe_dispatch(self, ngulps):
        """One ``on_data`` dispatch covering ``ngulps`` logical gulps:
        the ``block.<name>.dispatches`` / ``.gulps`` counters, the
        ``.batch_gulps`` histogram and ``perf_totals['nlogical']`` (the
        JAX package's ``_observe_dispatch``)."""
        ngulps = max(int(ngulps), 1)
        _counters.inc('block.%s.dispatches' % self.name)
        _counters.inc('block.%s.gulps' % self.name, ngulps)
        self.perf_totals['nlogical'] += ngulps
        if self._h_batch is None:
            self._h_batch = _histograms.get_or_create(
                'block.%s.batch_gulps' % self.name, unit='gulps')
        self._h_batch.record(ngulps)

    def _dispatch(self, fn, seq, gulp, *args):
        """``fn(*args)`` after the ``block.on_data`` fault seam, inside
        the gulp's compute span (seq, gulp and the stream's trace id)
        when span recording is on, and an NVTX range under
        ``BF_TRACE=1``; a device block's dispatch may be the one-shot
        ``BF_TORCH_PROFILE`` capture (``bifrost_tpu/pipeline.py:
        1790-1808``)."""
        faults.fire('block.on_data', self.name)
        with ExitStack() as scopes:
            if _spans.enabled():
                kwargs = {'seq': seq, 'gulp': gulp}
                if self._trace_ctx is not None:
                    kwargs['trace'] = self._trace_ctx.get('id')
                scopes.enter_context(_spans.span(
                    self.name + '.on_data', 'compute', **kwargs))
            if _tracing():
                scopes.enter_context(ScopedTracer(self.name + '/on_data'))
            if self._profile_eligible:
                return _profiling.profiled_dispatch(lambda: fn(*args))
            return fn(*args)

    def begin_sequences(self, exit_stack, orings, oheaders,
                        igulp_nframes, istride_nframes, batch=1):
        # the output header's gulp_nframe excludes overlap
        # (reference: pipeline.py:383-399); under a macro batch the
        # nframes are K-gulp values and the header keeps the logical
        # gulp, so downstream defaults do not change with this block's K
        ostride_nframes = self._define_output_nframes(istride_nframes)
        for ohdr, ostride in zip(oheaders, ostride_nframes):
            ohdr['gulp_nframe'] = ostride // batch
        ogulp_nframes = self._define_output_nframes(igulp_nframes)
        # writers buffer one gulp; extra depth belongs to readers.  A
        # macro writer carries a second macro span of depth: a K = 1
        # reader's guarantee lags one of its spans, and a ring of one
        # macro span could never grant the next macro reserve
        # (``bifrost_tpu/pipeline.py:1080-1095``)
        obuf_factor = 2 if batch > 1 else 1
        oseqs = [exit_stack.enter_context(
                     oring.begin_sequence(ohdr, ogulp, obuf_factor * ogulp))
                 for oring, ohdr, ogulp
                 in zip(orings, oheaders, ogulp_nframes)]
        # init barrier (reference: pipeline.py:401-403)
        self.pipeline.block_init_queue.put((self, True))
        self.pipeline.all_blocks_finished_initializing_event.wait()
        self.heartbeat()     # a sequence boundary counts as progress
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
        runs in order, so that implies all of them; under
        ``BF_ASSUME_IN_ORDER=0`` it waits on each; counted in
        ``pipeline.sync_waits``).  Then retire the transfer engine's
        completed D2H transfers without blocking."""
        _counters.inc('pipeline.gulps')
        self.heartbeat()
        if any(s.ring.is_device and s.data is not None for s in ospans):
            _counters.inc('pipeline.gulps_device')
            ev = device.record_event()
            if ev is not None:
                pend = self._pending_events
                pend.append(ev)
                if len(pend) > resolve_sync_depth(self):
                    popped = [pend.popleft() for _ in range(len(pend) - 1)]
                    # in order, the newest retired event implies the
                    # others; BF_ASSUME_IN_ORDER=0 waits on each
                    if device.execution_in_order():
                        popped = popped[-1:]
                    for ev in popped:
                        _counters.inc('pipeline.sync_waits')
                        device.stream_synchronize(ev)
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
        # a restarted main resumes at the source that failed
        sourcenames = list(self.sourcenames)
        if not hasattr(self, '_source_index'):
            self._source_index = 0
        while self._source_index < len(sourcenames):
            sourcename = sourcenames[self._source_index]
            if self.shutdown_event.is_set():
                break
            try:
                self._read_source(orings, sourcename)
            except (EndOfDataStop, RingPoisonedError):
                raise
            except Exception as exc:
                if not self._may_skip():
                    raise
                # skip_sequence: the failed source's output sequence has
                # ended; record it and go on with the next source
                supervisor = self.pipeline.supervisor
                if supervisor is not None:
                    supervisor.block_skipped(self, exc)
                _slo.reset_block_ages(self.name)
            self._source_index += 1

    def _read_source(self, orings, sourcename):
        with self.create_reader(sourcename) as ireader:
            faults.fire('block.on_sequence', self.name)
            oheaders = self.on_sequence(ireader, sourcename)
            ctx = None
            for ohdr in oheaders:
                ohdr.setdefault('time_tag', self._seq_count)
                ohdr.setdefault('name',
                                'unnamed-sequence-%i' % self._seq_count)
                # the stream's origin: one trace context a source
                # sequence, shared by every output
                if ctx is None:
                    ctx = ensure_trace_context(ohdr)
                elif isinstance(ohdr, dict):
                    ohdr.setdefault(TRACE_CONTEXT_KEY, dict(ctx))
            self._trace_ctx = ctx
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
                    self._observe_dispatch(1)

    def define_output_nframes(self, _):
        return [self.gulp_nframe] * self.num_outputs()

    def define_valid_input_spaces(self):
        return []

    def static_oheaders(self):
        """The output headers this source will advertise, one a ring,
        when they are known without opening the source, else None (the
        default): the static verifier propagates from them
        (``bifrost_tpu/pipeline.py:1334``).  No side effects;
        ``on_sequence`` stays the runtime authority."""
        return None

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
            try:
                if not self._process_sequence(orings, iseqs):
                    break
            except (EndOfDataStop, RingPoisonedError):
                raise
            except Exception as exc:
                if not self._may_skip():
                    raise
                # skip_sequence: the failed sequence's output has ended;
                # read the rest of its input and go on with the next
                supervisor = self.pipeline.supervisor
                if supervisor is not None:
                    supervisor.block_skipped(self, exc)
                _slo.reset_block_ages(self.name)
                self._drain_sequences(iseqs)

    # -- macro-gulp execution (bifrost_tpu_torch.macro) ----------------
    def macro_gulp_safe(self):
        """Whether ``on_data`` can take a K-gulp span in one dispatch with
        per-gulp results.  False by default: host blocks stay at K = 1.
        The stage blocks, FusedBlock and the device copies override it."""
        return False

    def macro_overlap_safe(self):
        """Whether a K-gulp span may carry the block's declared input
        overlap (the in-segment halo carry): read as K * stride +
        overlap frames, with the committed K * stride frames equal to K
        overlapped gulps.  False by default: an overlap forces K = 1
        (``macro.fallback.overlap``)."""
        return False

    def _macro_input_consumers(self):
        """Readers of this block's input ring in the pipeline (through
        views too), kept for ``macro.fallback.multi_reader_retired``."""
        def base(r):
            return getattr(r, '_base_ring', r)
        target = base(self.irings[0])
        return sum(1 for b in self.pipeline.blocks
                   for r in getattr(b, 'irings', ()) if base(r) is target)

    def _macro_static_reason(self):
        """The K = 1 fallback reason that the block and its topology
        give before any sequence opens, or None (shared with
        ``FusedBlock._prewarm``, which builds no K-gulp plan that a
        static fallback would discard)."""
        if not self.macro_gulp_safe():
            return 'block'
        if len(self.irings) != 1 or len(self.orings) > 1:
            return 'topology'
        if not getattr(self, 'guarantee', True):
            return 'unguaranteed'
        return None

    def _resolve_macro_batch(self, iseqs, istride_nframes, igulp_overlaps):
        """The batch K of this sequence: the requested K (``gulp_batch``
        or ``BF_GULP_BATCH``) when every condition holds, else 1, with
        the reason counted on ``macro.fallback.<reason>``
        (``bifrost_tpu/pipeline.py:1465-1505``)."""
        from .macro import resolve_gulp_batch, fallback_reason
        k = resolve_gulp_batch(self)
        if k <= 1:
            return 1
        reason = self._macro_static_reason()
        if reason is None and any(igulp_overlaps) and \
                not self.macro_overlap_safe():
            reason = 'overlap'
        if reason is None and any(not g or g <= 0
                                  for g in istride_nframes):
            reason = 'dynamic_gulp'
        if reason is None:
            # a K-gulp span's output must be exactly K gulps' outputs for
            # one commit to equal K
            try:
                per = self._define_output_nframes(list(istride_nframes))
                mac = self._define_output_nframes(
                    [g * k for g in istride_nframes])
                if mac != [o * k for o in per]:
                    reason = 'nonlinear'
            except Exception:
                reason = 'nonlinear'
        if reason is not None:
            fallback_reason(reason)
            return 1
        if self._macro_input_consumers() > 1:
            fallback_reason('multi_reader_retired')
        return k

    def _drain_sequences(self, iseqs):
        """Read and discard the rest of the input sequences
        (skip_sequence): a reader that merely stopped would hold its
        guarantee and block the producer."""
        for iseq in iseqs:
            gulp = self.gulp_nframe or \
                iseq.header.get('gulp_nframe', 1) or 1
            for _span in iseq.read(gulp):
                self.heartbeat()
                if self.shutdown_event.is_set():
                    return

    def _process_sequence(self, orings, iseqs):
        faults.fire('block.on_sequence', self.name)
        oheaders = self._on_sequence(iseqs)
        for ohdr in oheaders:
            ohdr.setdefault('time_tag', self._seq_count)
        # the stream identity follows the data
        self._trace_ctx = propagate_trace_context(iseqs[0].header,
                                                  oheaders)
        self._seq_count += 1
        seq_id = self._seq_count - 1
        gulp = 0

        istride_nframes = [self.gulp_nframe or iseq.header['gulp_nframe']
                           for iseq in iseqs]
        igulp_overlaps = self._define_input_overlap_nframe(iseqs)
        # macro-gulp execution: an eligible block reads K gulps a span;
        # the span carries the overlap history once, at its head (the
        # halo carry), not K times
        batch = self._resolve_macro_batch(iseqs, istride_nframes,
                                          igulp_overlaps)
        self._gulp_batch_active = batch
        self._macro_gulp_in = istride_nframes[0] if istride_nframes \
            else None
        self._macro_overlap_in = igulp_overlaps[0] if igulp_overlaps \
            else 0
        if batch > 1:
            istride_nframes = [s * batch for s in istride_nframes]
        igulp_nframes = [g + o for g, o
                         in zip(istride_nframes, igulp_overlaps)]

        for iseq, igulp in zip(iseqs, igulp_nframes):
            buffer_factor = self.buffer_factor
            if buffer_factor is None:
                # blocks of one fused scope share one gulp of buffering,
                # so that producer and consumer alternate (reference:
                # pipeline.py:558-568; bifrost_tpu/pipeline.py:1564-1577)
                src_block = iseq.ring.owner
                if src_block is not None and self.is_fused_with(src_block):
                    buffer_factor = 1
            iseq.resize(gulp_nframe=igulp, buf_nframe=self.buffer_nframe,
                        buffer_factor=buffer_factor)

        iframe0s = [0 for _ in igulp_nframes]
        force_skip = False
        with ExitStack() as oseq_stack:
            oseqs, ogulp_overlaps = self.begin_sequences(
                oseq_stack, orings, oheaders, igulp_nframes,
                istride_nframes, batch=batch)
            if self.shutdown_event.is_set():
                return False
            prev_time = time.time()
            for ispans in izip(*[iseq.read(igulp, istride, iframe0)
                                 for iseq, igulp, istride, iframe0
                                 in zip(iseqs, igulp_nframes,
                                        istride_nframes, iframe0s)]):
                if self.shutdown_event.is_set():
                    return False
                if any(ispan.nframe_skipped for ispan in ispans):
                    # frames lost to overwriting go to on_skip, zero-fill
                    # by default (reference: pipeline.py:590-606); its
                    # spans commit whole unless it returns strides: lost
                    # frames carry no overlap history to hold back
                    with ExitStack() as ospan_stack:
                        iskip_slices = [
                            slice(f0, f0 + ispan.nframe_skipped, istride)
                            for f0, istride, ispan
                            in zip(iframe0s, istride_nframes, ispans)]
                        iskip_nframes = [ispan.nframe_skipped
                                         for ispan in ispans]
                        ospans = self.reserve_spans(ospan_stack, oseqs,
                                                    iskip_nframes)
                        ostrides = self._on_skip(iskip_slices, ospans)
                        if ostrides is None:
                            ostrides = [None] * len(ospans)
                        ostrides = [osp.nframe if st is None else st
                                    for st, osp in zip(ostrides, ospans)]
                        self._sync_gulp(ospans)
                        ng = self._set_span_gulps(ospans, iskip_nframes[0],
                                                  0)
                        self.commit_spans(ospans, ostrides, ogulp_overlaps)
                        self._observe_dispatch(ng)
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
                    if not force_skip:
                        ostrides = self._dispatch(self._on_data, seq_id,
                                                  gulp, ispans, ospans)
                        self._sync_gulp(ospans)
                    gulp += 1
                    any_overwritten = any(ispan.nframe_overwritten
                                          for ispan in ispans)
                    if force_skip or any_overwritten:
                        # the input changed under us: on_skip publishes
                        # the gulp instead, and the next gulp is skipped
                        # too so that the reader catches up (reference:
                        # pipeline.py:630-644)
                        force_skip = any_overwritten
                        iskip_slices = [
                            slice(ispan.frame_offset,
                                  ispan.frame_offset +
                                  ispan.nframe_overwritten, istride)
                            for ispan, istride
                            in zip(ispans, istride_nframes)]
                        ostrides = self._on_skip(iskip_slices, ospans)
                        self._sync_gulp(ospans)
                    ngulps = self._set_span_gulps(
                        ospans, ispans[0].nframe if ispans else 0,
                        self._macro_overlap_in)
                    self.commit_spans(ospans, ostrides, ogulp_overlaps)
                cur_time = time.time()
                self._observe_gulp(acquire_time, reserve_time,
                                   cur_time - prev_time)
                self._observe_dispatch(ngulps)
                prev_time = cur_time
                if not self.orings and self._trace_ctx is not None:
                    # a sink: the gulp leaves the pipeline here
                    self._observe_exit_age(
                        iseqs[0].header,
                        ispans[0].frame_offset + ispans[0].nframe)
        self._on_sequence_end(iseqs)
        return True

    def _set_span_gulps(self, ospans, nframe, overlap):
        """The logical gulps a dispatch over ``nframe`` input frames
        covered (1 at K = 1; a partial batch at sequence end rounds up,
        and overlap frames are history, not gulps), set on the output
        spans for ``ring.<name>.gulps``; returns the count."""
        ngulps = 1
        if self._gulp_batch_active > 1 and self._macro_gulp_in:
            ngulps = max(1, -(-(nframe - overlap) // self._macro_gulp_in))
        for ospan in ospans:
            ospan._ngulps = ngulps
        return ngulps

    def _on_skip(self, islices, ospans):
        return self.on_skip(islices, ospans)

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

    def on_skip(self, islices, ospans):
        """Fill ``ospans`` for input frames lost to overwriting:
        ``islices`` holds one slice of input frames per input, as the
        JAX package gives them (``bifrost_tpu/pipeline.py:1613-1640``,
        ``:1680-1694``).  Return frames to commit per output, or None.
        The default publishes zeros into every output span."""
        for ospan in ospans:
            _zero_span(ospan)


def _zero_span(ospan):
    """Publish zeros into ``ospan``."""
    if ospan.ring.is_device:
        from .devrep import device_rep_zeros
        ospan.set(device_rep_zeros(ospan.shape, ospan.dtype))
    else:
        memset_array(ospan.data, 0)


class TransformBlock(MultiTransformBlock):
    """1-in/1-out specialization (reference: pipeline.py:690-741)."""

    def __init__(self, iring, *args, **kwargs):
        super(TransformBlock, self).__init__([iring], *args, **kwargs)
        self.iring = self.irings[0]
        self._donate_on = None

    # -- buffer donation (FusedBlock and the stage blocks) ---------------
    def _donation_on(self):
        """The ``donate`` setting, resolved once a sequence (blocks reset
        ``_donate_on`` to None in ``on_sequence``)."""
        if self._donate_on is None:
            self._donate_on = resolve_donate(self)
        return self._donate_on

    def _take_donatable(self, ispan, allow_parts=False, sharded=False):
        """The input span's chunk claimed for donation
        (:meth:`bifrost_tpu_torch.ring.ReadSpan.take_data`), a list of
        the chunks tiling a macro span with ``allow_parts``, or None:
        donation off, an overlapped read (the next span re-reads the
        history frames; ``bifrost_tpu/pipeline.py:1822-1827``), or no
        proof of exclusivity.  Callers read ``ispan.data`` on None.
        Counts ``donation.hits`` / ``donation.misses``.  A mesh plan
        passes ``sharded`` to take a per-rank chunk as it lies.

        In the port, donation is a transfer of ownership, not an XLA
        buffer alias: the chunk leaves the ring, the block's function
        reads it, and the block drops it, so the caching allocator can
        give its memory to the next output instead of the ring holding
        it until its writer laps it."""
        if not self._donation_on():
            return None
        if self._macro_overlap_in:
            _counters.inc('donation.misses')
            return None
        x = ispan.take_data(allow_parts=allow_parts, sharded=sharded)
        _counters.inc('donation.hits' if x is not None
                      else 'donation.misses')
        return x

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

    def _on_skip(self, islices, ospans):
        return [self.on_skip(islices[0], ospans[0])]

    def on_skip(self, islice, ospan):
        """Fill ``ospan`` for the input frames ``islice`` lost to
        overwriting; return the frames to commit, or None.  The default
        publishes zeros."""
        _zero_span(ospan)


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

    def _on_skip(self, islices, ospans):
        return []
