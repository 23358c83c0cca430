"""Bridge blocks: the TCP ring bridge (:mod:`..io.bridge`, wire v2)
inside a pipeline, so that the cross-host hop takes part in supervision
(restart policies, poison propagation, a clean MSG_END on shutdown) and
telemetry (``bridge.tx/rx.*`` counters, send-stall and recv-wait
histograms, the bridge stats ProcLogs) like any other block (the JAX
package's ``bifrost_tpu/blocks/bridge.py``).

- :class:`BridgeSink` reads its input ring and pumps it to a remote
  :class:`BridgeSource` over ``nstreams`` striped TCP connections with a
  ``window``-span credit pipeline.  Transient dial failures and
  mid-stream drops are redialed with the shared io backoff
  (``retry_transient``) and unacked spans retransmitted; a permanent
  failure raises and the supervisor applies the block's ``on_failure``.
- :class:`BridgeSource` listens, accepts the sender (again after each
  reconnect) and writes the stream into its output ring, a host ring.
  Sender death without a clean MSG_END, or a spent reconnect budget,
  poisons the output ring so that downstream blocks fail fast.

Topology (sender host / receiver host)::

    # host A
    bt.blocks.bridge_sink(producer, 'hostB', 9000)
    # host B
    src = bt.blocks.bridge_source('0.0.0.0', 9000, space='cuda_host')
    ... = bt.blocks.copy(src, space='cuda')
"""

from __future__ import annotations

import os
import threading
import time

from ..pipeline import Block
from ..proclog import ProcLog
from ..io.bridge import (RingSender, RingReceiver, BridgeListener,
                         connect_striped, bridge_streams,
                         bridge_window, bridge_crc)
# one knob for all transient-socket budgets: BF_IO_RETRY_MAX (default
# 8) is both the dial-retry budget and the reconnect budget here
from ..io.udp_socket import (_retry_budget as _reconnect_budget,
                             retry_backoff_s)

__all__ = ['BridgeSink', 'BridgeSource', 'bridge_sink', 'bridge_source',
           'CircuitOpenError']


class CircuitOpenError(ConnectionError):
    """Raised by a BridgeSink dial while its circuit breaker is open:
    the peer exhausted a full redial budget moments ago, so further
    dials fast-fail for a cool-off window (``BF_BRIDGE_COOLOFF_SECS``)
    instead of hammering a dead endpoint — the supervisor's restart
    backoff then paces recovery attempts."""


def _cooloff_secs():
    try:
        return max(float(os.environ.get('BF_BRIDGE_COOLOFF_SECS', '')
                         or 5.0), 0.0)
    except ValueError:
        return 5.0


class _CircuitBreaker(object):
    """Per-endpoint dial circuit breaker (docs/robustness.md): opened
    when a sender EXHAUSTS its reconnect budget (individual dial
    failures are the redial backoff's business, not the breaker's);
    while open, dials fast-fail with :class:`CircuitOpenError`.
    After the cool-off dials are admitted again (half-open); a
    successful dial closes the circuit, another budget exhaustion
    re-opens a full window."""

    def __init__(self):
        self._lock = threading.Lock()
        self._open_until = 0.0

    def check(self, peer):
        with self._lock:
            now = time.monotonic()
            if now < self._open_until:
                raise CircuitOpenError(
                    'bridge circuit to %s open for another %.1fs '
                    '(redial budget exhausted)'
                    % (peer, self._open_until - now))

    def success(self):
        with self._lock:
            self._open_until = 0.0

    def failure(self):
        """A whole sender run ended in transport failure (the redial
        budget is spent): (re)open the circuit for a cool-off window.
        (The ``bridge.circuit_open`` counter is incremented by the
        sender's budget-exhaustion path, the event that drives
        this.)"""
        with self._lock:
            self._open_until = time.monotonic() + _cooloff_secs()


class _BridgeBlock(Block):
    """Shared supervision plumbing for the bridge endpoints."""

    def _publish_bridge_role(self, role, peer):
        """``<block>/bridge`` ProcLog marking this block as a
        CROSS-HOST boundary: tools/pipeline2dot.py renders bridge
        endpoints distinctly (annotated with the live tx/rx rates and
        reconnect counts from the ``*_bridge_transmit|capture/stats``
        entries the transport publishes)."""
        ProcLog(self.name + '/bridge').update(
            {'role': role, 'peer': peer}, force=True)

    def _release_init_barrier(self):
        """Bridge endpoints check in at the pipeline init barrier
        immediately and DO NOT park on it: their sequences come from
        (or go to) the network, so downstream blocks can only open
        their inputs — and complete the barrier — once the bridge is
        already moving data.  (A file SourceBlock gets the same effect
        by creating its output sequence before parking.)"""
        self.pipeline.block_init_queue.put((self, True))
        self.heartbeat()

    def _record_reconnect(self, exc):
        """Surface a non-fatal transport reconnect to the supervisor's
        failure record (kind='reconnected') so operators see flapping
        links in the pipeline's failure history, not just a counter."""
        supervisor = getattr(self.pipeline, 'supervisor', None)
        if supervisor is not None:
            from ..supervision import BlockFailure
            supervisor.record(BlockFailure(self.name, exc,
                                           kind='reconnected',
                                           fatal=False))


class _ParkedWriter(object):
    """A bridge source's writer of its output ring: the first sequence
    begins, then the receiver parks until every block of the pipeline
    has checked in at the init barrier, as a file source parks after
    creating its sequence.  The downstream readers have then opened the
    sequence and hold their guarantees before the first span lands, so
    a stream that arrives faster than they start loses nothing.  (The
    JAX BridgeSource commits at once: a burst longer than its ring can
    lap a reader that is still opening.)"""

    def __init__(self, writer, block):
        self._writer = writer
        self._block = block

    def begin_sequence(self, *args, **kwargs):
        seq = self._writer.begin_sequence(*args, **kwargs)
        ready = self._block.pipeline.all_blocks_finished_initializing_event
        while not ready.wait(0.1):
            if self._block.shutdown_event.is_set():
                break
        return seq

    def __getattr__(self, name):
        return getattr(self._writer, name)


class BridgeSink(_BridgeBlock):
    """1-in/0-out block pumping its input ring to a remote
    BridgeSource (io.bridge.RingSender under Pipeline supervision).

    ``nstreams``/``window``/``crc`` default to ``BF_BRIDGE_STREAMS`` /
    ``BF_BRIDGE_WINDOW`` / ``BF_BRIDGE_CRC``; the macro-gulp scope
    tunable (``gulp_batch`` / ``BF_GULP_BATCH``) makes the sender ship
    K gulps per frame.  ``protocol=1`` negotiates down to the legacy
    v1 wire for old receivers.
    """

    def __init__(self, iring, address, port, nstreams=None, window=None,
                 crc=None, guarantee=True, protocol=None,
                 connect_timeout=10.0, reconnect_max=None,
                 quota_bytes_per_s=None, quota_gulps_per_s=None,
                 prime_early=None, *args, **kwargs):
        super(BridgeSink, self).__init__([iring], *args, **kwargs)
        self.orings = []
        self.iring = self.irings[0]
        self.guarantee = guarantee
        self.address = address
        self.port = int(port)
        # keep the REQUESTED values next to the clamped effective ones:
        # the static verifier (analysis.verify) flags
        # nonsensical requests (window=0 -> BF-E150) that the clamps
        # below would otherwise silently paper over
        self.requested_window = window
        self.requested_streams = nstreams
        self.nstreams = bridge_streams() if nstreams is None \
            else max(int(nstreams), 1)
        self.window = bridge_window() if window is None \
            else max(int(window), 1)
        self.crc = bridge_crc() if crc is None else bool(crc)
        self.protocol = protocol
        self.connect_timeout = float(connect_timeout)
        self.reconnect_max = _reconnect_budget() if reconnect_max is None \
            else int(reconnect_max)
        #: per-stream quotas at the sender (None = BF_BRIDGE_QUOTA_*
        #: env defaults; 0 = unlimited) — docs/robustness.md
        self.quota_bytes_per_s = quota_bytes_per_s
        self.quota_gulps_per_s = quota_gulps_per_s
        #: pin the read guarantee BEFORE the init barrier (None =
        #: auto: only when the producing block lives in this
        #: pipeline).  A producer that creates its output sequences
        #: LAZILY per stripe (fabric FanOutBlock) must pass False:
        #: priming would wait for a sequence that can only appear
        #: after the barrier this block is holding up.
        self.prime_early = prime_early
        #: reading a drop-policy ring through the credit window is
        #: this block's JOB (sheds are counted, stamped, and surfaced
        #: through its own ledger): declare shed tolerance so the
        #: static verifier does not flag the guaranteed read (BF-E180)
        if self.shed_tolerant is None:
            self._shed_tolerant = True
        #: per-endpoint dial circuit breaker (persists across
        #: supervisor restarts of this block)
        self._breaker = _CircuitBreaker()
        self._shed_recorded = False
        self._sender = None
        #: fabric hooks (bifrost_tpu.fabric, docs/fabric.md):
        #: ``on_span_acked(seq_name, frame_offset, nframe, nbyte)``
        #: feeds the durable delivered-frames ledger a whole-host
        #: rejoin resumes from; ``on_fabric_shed(reason, ngulps,
        #: nbyte)`` mirrors sender-side sheds into the same ledger so
        #: the loss audit survives a SIGKILL
        self.on_span_acked = None
        self.on_fabric_shed = None
        self.out_proclog = ProcLog(self.name + '/out')
        self.out_proclog.update({'nring': 0})
        self._publish_bridge_role('sink',
                                  '%s:%d' % (self.address, self.port))

    def _define_valid_input_spaces(self):
        # the bridge exports raw host bytes; device rings have no
        # host-resident span view to frame
        return ['system']

    def _connect(self):
        # fast-fail while the circuit is open; a SUCCESSFUL dial
        # closes it.  An individual dial failure does NOT open the
        # breaker — that is the jittered redial backoff's job; the
        # breaker only opens when a whole sender run exhausts its
        # reconnect budget (see main)
        self._breaker.check('%s:%d' % (self.address, self.port))
        socks = connect_striped(self.address, self.port,
                                self.nstreams,
                                timeout=self.connect_timeout)
        self._breaker.success()
        return socks

    def _reconnect(self):
        exc = ConnectionError("bridge link to %s:%d dropped; redialing"
                              % (self.address, self.port))
        self._record_reconnect(exc)
        return self._connect()

    def _record_shed(self, reason, ngulps, nbyte):
        """RingSender.on_shed callback: surface the FIRST shed of a
        run to the supervisor's failure record (kind='degraded') so
        the overload shows in pipeline history, not just counters —
        later sheds of the same run only count (one record per
        overload episode, not per gulp)."""
        if self.on_fabric_shed is not None:
            try:
                self.on_fabric_shed(reason, ngulps, nbyte)
            except Exception:
                pass
        if self._shed_recorded:
            return
        self._shed_recorded = True
        supervisor = getattr(self.pipeline, 'supervisor', None)
        if supervisor is not None:
            from ..supervision import BlockFailure
            exc = RuntimeError(
                'bridge sender shedding under overload (%s): '
                '%d gulp(s) / %d byte(s) dropped, counted on '
                'bridge.tx.shed_*' % (reason, ngulps, nbyte))
            supervisor.record(BlockFailure(self.name, exc,
                                           kind='degraded',
                                           fatal=False))

    def main(self, orings):
        from ..macro import resolve_gulp_batch
        from ..pipeline import resolve_overload_policy
        sender = RingSender(
            self.iring,
            gulp_nframe=self.gulp_nframe,
            guarantee=self.guarantee,
            protocol=1 if self.protocol == 1 else 2,
            window=self.window, crc=self.crc,
            gulp_batch=resolve_gulp_batch(self),
            naive=False,
            dial=self._connect,
            reconnect=self._reconnect,
            reconnect_max=self.reconnect_max,
            shutdown_event=self.shutdown_event,
            heartbeat=self.heartbeat,
            name=self.name,
            overload_policy=resolve_overload_policy(self),
            quota_bytes_per_s=self.quota_bytes_per_s,
            quota_gulps_per_s=self.quota_gulps_per_s,
            on_shed=self._record_shed,
            on_span_acked=self.on_span_acked)
        self._sender = sender
        # one 'degraded' supervisor record per RUN: a restarted main
        # (new overload episode) records again
        self._shed_recorded = False
        # When the producing block lives in THIS pipeline, pin the read
        # guarantee BEFORE checking in at the init barrier: the producer
        # creates its output sequence and only starts committing gulps
        # after the barrier completes, so no frame can be overwritten
        # while the bridge is still dialing.  An externally-fed ring may
        # never produce a sequence before the barrier — check in first
        # there and accept the attach-to-live-stream race instead.
        base = getattr(self.iring, '_base_ring', self.iring)
        producer = getattr(base, 'owner', None)
        prime = self.prime_early
        if prime is None:
            prime = producer is not None \
                and producer in self.pipeline.blocks
        if prime:
            sender.prime()
        self._release_init_barrier()
        try:
            sender.run()
        except (ConnectionError, OSError):
            # the sender gave up (redial budget spent, transport
            # aborted): open the circuit so an on_failure='restart'
            # policy paces further dials instead of hammering a dead
            # peer.  Not during shutdown — a teardown wakeup is not a
            # peer failure.
            if not self.shutdown_event.is_set():
                self._breaker.failure()
            raise
        finally:
            sender.close()

    def define_output_nframes(self, input_nframes):
        return []

    def retune_window(self, window):
        """Runtime credit-window retune (the auto-tuner's knob —
        docs/autotune.md): updates this block's ``window`` (what a
        restarted sender would be built with) and the LIVE sender's
        window when one is running.  A grown window requests the extra
        source-ring depth through the deferred-resize protocol; see
        :meth:`~bifrost_tpu_torch.io.bridge.RingSender.retune_window`."""
        window = max(int(window), 1)
        self.window = window
        sender = self._sender
        if sender is not None:
            sender.retune_window(window)
        return window

    def retune_streams(self, nstreams):
        """Runtime stripe-count retune (the auto-tuner's
        ``BF_BRIDGE_STREAMS`` knob — docs/autotune.md): updates this
        block's ``nstreams`` (what the dial callable connects with)
        and asks the LIVE sender to restripe at its next span
        boundary — a drained, planned redial the receiver re-accepts
        like any reconnect, counted on ``bridge.tx.restripes``; see
        :meth:`~bifrost_tpu_torch.io.bridge.RingSender.retune_streams`."""
        nstreams = max(int(nstreams), 1)
        self.nstreams = nstreams
        sender = self._sender
        if sender is not None:
            sender.retune_streams(nstreams)
        return nstreams


class BridgeSource(_BridgeBlock):
    """0-in/1-out block receiving a bridged stream into its output
    ring (io.bridge.RingReceiver under Pipeline supervision).

    ``space`` is a host space, ``'system'`` or ``'cuda_host'`` (pinned,
    so that ``copy('cuda')`` takes the direct H2D); ``'cuda'`` raises a
    ValueError: the receiver writes host bytes.

    The listening socket binds at CONSTRUCTION time (``self.port``
    carries the resolved port for ``port=0`` test topologies).  A
    dropped sender is re-accepted up to ``reconnect_max`` times with
    the stream state preserved (resume by frame sequence number);
    exhaustion raises, and the supervisor poisons the output ring.
    """

    def __init__(self, address, port, space='system', crc=None,
                 reconnect_max=None, adopt_sessions=False,
                 *args, **kwargs):
        from ..space import canonical
        if canonical(space) == 'cuda':
            raise ValueError(
                "bridge_source receives host bytes: give it space='system' "
                "or 'cuda_host' and copy('cuda') from its output, not "
                "space=%r" % (space,))
        super(BridgeSource, self).__init__([], *args, **kwargs)
        self.orings = [self.create_ring(space=space)]
        self.listener = BridgeListener(address, port)
        self.address = self.listener.address
        self.port = self.listener.port
        self.crc = crc
        #: whole-host rejoin (bifrost_tpu.fabric, docs/fabric.md):
        #: accept a NEW sender session mid-stream (the old host died)
        #: instead of raising, and answer resume probes
        self.adopt_sessions = bool(adopt_sessions)
        self.reconnect_max = _reconnect_budget() if reconnect_max is None \
            else int(reconnect_max)
        #: forwarded onto the receiver: fired when a new sender
        #: session is adopted or a resume probe answered (the fabric
        #: wires this to Membership.confirm_resume)
        self.on_session_adopted = None
        self.out_proclog = ProcLog(self.name + '/out')
        rnames = {'nring': len(self.orings)}
        for i, r in enumerate(self.orings):
            rnames['ring%i' % i] = r.name
        self.out_proclog.update(rnames)
        self._receiver = None
        self._publish_bridge_role('source',
                                  '%s:%d' % (self.address, self.port))

    def _define_valid_input_spaces(self):
        return []

    def main(self, orings):
        self._release_init_barrier()
        # a restarted main (on_failure='restart') re-binds the SAME
        # resolved port: the constructor's listener was closed by the
        # previous attempt's finally
        if self.listener is None:
            self.listener = BridgeListener(self.address, self.port)
        # the RECEIVER persists across supervisor restarts: its
        # protocol state (expected frame seqno, session, open output
        # sequence) is what lets a still-alive sender redial and
        # RESUME instead of hitting a sequence-gap protocol error
        if self._receiver is None:
            self._receiver = RingReceiver(
                self.listener, self.orings[0],
                writer=_ParkedWriter(orings[0], self),
                crc=self.crc, poison_on_error=False,
                heartbeat=self.heartbeat,
                stop_event=self.shutdown_event, name=self.name,
                adopt_sessions=self.adopt_sessions)
        else:
            self._receiver.sock = self.listener
        self._receiver.on_session_adopted = self.on_session_adopted
        receiver = self._receiver
        attempts = 0
        try:
            while True:
                try:
                    receiver.run()
                    return            # clean MSG_END
                except (ConnectionError, OSError) as exc:
                    # (BridgeProtocolError is a RuntimeError, not an
                    # OSError — protocol violations propagate as fatal)
                    if self.shutdown_event.is_set():
                        return
                    attempts += 1
                    if attempts > self.reconnect_max:
                        raise
                    # sender dropped mid-stream: re-accept and resume
                    # (retransmitted frames dedup by sequence number),
                    # after a full-jitter backoff so a flapping peer
                    # doesn't spin the accept loop hot
                    self._record_reconnect(exc)
                    from ..io.bridge import bridge_backoff_cap
                    delay = retry_backoff_s(attempts, backoff=0.05,
                                            cap=bridge_backoff_cap())
                    if delay and self.shutdown_event.wait(delay):
                        return
        finally:
            self.listener.close()
            self.listener = None

    def define_output_nframes(self, input_nframes):
        return []


def bridge_sink(iring, address, port, *args, **kwargs):
    """Pipeline helper: pump ``iring`` to a remote bridge_source."""
    return BridgeSink(iring, address, port, *args, **kwargs)


def bridge_source(address, port, *args, **kwargs):
    """Pipeline helper: receive a bridged stream into a new ring."""
    return BridgeSource(address, port, *args, **kwargs)
