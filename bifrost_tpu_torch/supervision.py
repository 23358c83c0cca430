"""Pipeline supervision: failure policies, the health state machine and
the stall watchdog (the JAX package's ``bifrost_tpu/supervision.py``).

- **abort** (default): the failure is recorded, every block's shutdown
  event is set, every ring is poisoned (``ring.Ring.poison``) so blocked
  ``acquire``/``reserve`` calls wake at once with
  :class:`~bifrost_tpu_torch.ring.RingPoisonedError`, and
  ``Pipeline.run`` re-raises the aggregate as
  :class:`PipelineRuntimeError` carrying the original traceback.

- **restart**: the block's main loop is re-entered with exponential
  backoff, up to ``max_restarts`` attempts; an exhausted budget
  escalates to abort.  The block's writing session stays open, so
  downstream sees one stream.

- **skip_sequence**: the block abandons the current sequence (its output
  sequence ends cleanly) and goes on with the next one.

Policies are scope tunables (``BlockScope(on_failure='restart',
max_restarts=5, restart_backoff=0.25)``), inherited like every other
tunable.

The **watchdog** (``BF_WATCHDOG_SECS`` or ``Pipeline(watchdog_secs=...)``)
watches per-block heartbeats; when no live block has moved for the
window it dumps every thread's stack, every ring's occupancy and the
span flight recorder's recent events to stderr and the
``pipeline/watchdog`` proclog, counts ``watchdog_stalls`` and, with
``BF_WATCHDOG_ESCALATE=1``, aborts the pipeline with
:class:`PipelineStallError`.

The **health monitor** derives OK / DEGRADED / SHEDDING / STALLED /
FAILED from the counters (shed gulps, SLO violations, restarts) and the
heartbeats.  Counters of tiers the port has not ported (the bridge and
the fabric) are absent, and read as 0.

All of it runs on the CPU through the fault seams of
:mod:`bifrost_tpu_torch.testing.faults`.
"""

from __future__ import annotations

import os
import random
import sys
import threading
import time
import traceback

from .telemetry import counters

__all__ = ['PipelineRuntimeError', 'PipelineStallError', 'BlockFailure',
           'Supervisor', 'POLICIES', 'HEALTH_STATES', 'HealthMonitor',
           'dump_thread_stacks', 'ring_occupancies', 'live_health',
           'add_escalation_watch', 'remove_escalation_watch']

#: recognized on_failure policies
POLICIES = ('abort', 'restart', 'skip_sequence')

#: pipeline health states, least to most severe (docs/robustness.md
#: "Overload & degradation"): OK -> DEGRADED (SLO violations, restarts,
#: bridge reconnects) -> SHEDDING (drop-policy loss in progress) ->
#: STALLED (no block progressing) -> FAILED (fatal failure / abort)
HEALTH_STATES = ('OK', 'DEGRADED', 'SHEDDING', 'STALLED', 'FAILED')

#: pipeline states severe enough to notify escalation watchers (the
#: fleet plane's incident black-box trigger — docs/observability.md)
ESCALATION_STATES = ('SHEDDING', 'STALLED', 'FAILED')

#: live HealthMonitor weakrefs + escalation callbacks (fleet plane)
_live_monitors = []
_escalation_cbs = []
_registry_lock = threading.Lock()


def live_health():
    """{pipeline_name: health snapshot} over every HealthMonitor
    currently alive in this process — what the fleet publisher
    attaches to each streamed snapshot (telemetry.fleet)."""
    out = {}
    with _registry_lock:
        refs = list(_live_monitors)
    for ref in refs:
        mon = ref()
        if mon is None:
            with _registry_lock:
                if ref in _live_monitors:
                    _live_monitors.remove(ref)
            continue
        try:
            name = getattr(mon.supervisor.pipeline, 'name', 'pipeline')
            out[name] = mon.snapshot()
        except Exception:
            pass
    return out


def add_escalation_watch(cb):
    """Register ``cb(pipeline_name, from_state, to_state, reason)``,
    invoked on every health transition INTO an ESCALATION_STATES
    member (errors swallowed + counted on ``health.hook_errors``)."""
    with _registry_lock:
        if cb not in _escalation_cbs:
            _escalation_cbs.append(cb)


def remove_escalation_watch(cb):
    with _registry_lock:
        if cb in _escalation_cbs:
            _escalation_cbs.remove(cb)


def _notify_escalation(pipeline_name, from_state, to_state, reason):
    with _registry_lock:
        cbs = list(_escalation_cbs)
    for cb in cbs:
        try:
            cb(pipeline_name, from_state, to_state, reason)
        except Exception:
            counters.inc('health.hook_errors')


_BACKOFF_CAP = 5.0


def _env_float(name, default):
    try:
        return float(os.environ.get(name, '') or default)
    except ValueError:
        return default


def _env_int(name, default):
    try:
        return int(os.environ.get(name, '') or default)
    except ValueError:
        return default


def jittered_backoff(attempt, base=0.1, cap=_BACKOFF_CAP,
                     jitter=0.0):
    """Exponential backoff delay for retry ``attempt`` (0-based):
    ``min(base * 2**attempt, cap)``, plus an optional uniform random
    slice of ``jitter * delay`` so a fleet retrying in lockstep
    de-synchronizes — the one backoff curve shared by the block
    supervisor and the scheduler's re-placement loop."""
    delay = min(base * (2 ** attempt), cap)
    if jitter > 0:
        delay += random.uniform(0, jitter * delay)
    return delay


class BlockFailure(object):
    """One recorded failure: which block, what was raised, the formatted
    traceback, and whether it was fatal to the pipeline (``kind`` is
    'error', 'restarted', 'skipped', 'poisoned', 'reconnected',
    'degraded', or 'stall' — 'reconnected' records a bridge endpoint's
    non-fatal transport redial, 'degraded' the first overload shed of
    a bridge sender's run, blocks/bridge.py)."""

    __slots__ = ('block_name', 'exc', 'traceback', 'when', 'kind',
                 'fatal', 'restarts')

    def __init__(self, block_name, exc, kind='error', fatal=True,
                 restarts=0, tb=None):
        self.block_name = block_name
        self.exc = exc
        self.traceback = tb if tb is not None else ''.join(
            traceback.format_exception(type(exc), exc,
                                       exc.__traceback__))
        self.when = time.time()
        self.kind = kind
        self.fatal = fatal
        self.restarts = restarts

    def summary(self):
        return '%s [%s]: %s: %s' % (self.block_name, self.kind,
                                    type(self.exc).__name__, self.exc)

    def __repr__(self):
        return 'BlockFailure(%s)' % self.summary()


class PipelineRuntimeError(RuntimeError):
    """Aggregate raised by ``Pipeline.run`` when any block failed
    fatally.  ``failures`` holds every :class:`BlockFailure` recorded
    (fatal and not); the message embeds the original tracebacks so the
    root cause survives the thread boundary."""

    def __init__(self, failures):
        if isinstance(failures, str):
            super(PipelineRuntimeError, self).__init__(failures)
            self.failures = []
            return
        self.failures = list(failures)
        fatal = [f for f in self.failures if f.fatal]
        lines = ['pipeline failed: %d fatal / %d total block failure(s)'
                 % (len(fatal), len(self.failures))]
        for f in self.failures:
            lines.append('  - ' + f.summary())
        for f in fatal:
            lines.append('--- %s ---' % f.block_name)
            lines.append(f.traceback.rstrip())
        super(PipelineRuntimeError, self).__init__('\n'.join(lines))

    @property
    def primary(self):
        """The first fatal failure (the root cause), or None."""
        for f in self.failures:
            if f.fatal:
                return f
        return None


class PipelineStallError(PipelineRuntimeError):
    """Watchdog escalation: no block made progress within the window."""


# ---------------------------------------------------------------------------
# Diagnostics
# ---------------------------------------------------------------------------

def dump_thread_stacks():
    """Formatted stacks of every live thread (the watchdog's stall
    dump; also useful from a debugger)."""
    frames = sys._current_frames()
    names = {t.ident: t.name for t in threading.enumerate()}
    out = []
    for ident, frame in frames.items():
        out.append('Thread %s (%s):' % (names.get(ident, '?'), ident))
        out.append(''.join(traceback.format_stack(frame)).rstrip())
    return '\n'.join(out)


def ring_occupancies(pipeline):
    """{ring_name: occupancy dict} for every ring in the pipeline."""
    seen = {}
    for block in pipeline.blocks:
        for ring in (list(getattr(block, 'orings', ())) +
                     list(getattr(block, 'irings', ()))):
            base = getattr(ring, '_base_ring', ring)
            if id(base) in seen:
                continue
            try:
                seen[id(base)] = (base.name, base.occupancy())
            except Exception as exc:
                seen[id(base)] = (getattr(base, 'name', '?'),
                                  {'error': repr(exc)})
    return dict(seen.values())


# ---------------------------------------------------------------------------
# Supervisor
# ---------------------------------------------------------------------------

class Supervisor(object):
    """Per-pipeline failure collector + policy engine + watchdog owner.

    Created by ``Pipeline.run``; block threads report through
    :meth:`block_failed` / :meth:`block_poisoned` / :meth:`block_skipped`
    and the pipeline thread raises the aggregate via
    :meth:`raise_if_failed`.
    """

    def __init__(self, pipeline):
        self.pipeline = pipeline
        self.failures = []
        self.abort_event = threading.Event()
        self._lock = threading.Lock()
        self._watchdog = None
        self.health = None
        self.default_max_restarts = _env_int('BF_RESTART_MAX', 3)
        self.default_backoff = _env_float('BF_RESTART_BACKOFF', 0.1)
        # fail fast, in the launching thread, on a misspelled policy —
        # not at the moment the policy is first needed
        for block in pipeline.blocks:
            self.policy_of(block)

    # -- policy resolution -------------------------------------------------
    @staticmethod
    def policy_of(block):
        policy = getattr(block, 'on_failure', None) or 'abort'
        if policy not in POLICIES:
            raise ValueError("Unknown on_failure policy %r on block %s "
                             "(expected one of %s)"
                             % (policy, block.name, ', '.join(POLICIES)))
        return policy

    def _restart_budget(self, block):
        budget = getattr(block, 'max_restarts', None)
        return self.default_max_restarts if budget is None else int(budget)

    def _backoff(self, block, restarts):
        base = getattr(block, 'restart_backoff', None)
        base = self.default_backoff if base is None else float(base)
        return jittered_backoff(restarts, base=base)

    # -- failure reporting (called from block threads) ---------------------
    def record(self, failure):
        with self._lock:
            self.failures.append(failure)
        return failure

    def block_failed(self, block, exc, restarts):
        """Apply ``block``'s policy to a failure that escaped its main
        loop.  Returns ``('restart', delay_seconds)`` or
        ``('abort', 0.0)``; the abort side effects (poison + shutdown)
        have already run when this returns."""
        counters.inc('block_failures')
        policy = self.policy_of(block)
        if (policy == 'restart'
                and restarts < self._restart_budget(block)
                and not self.abort_event.is_set()
                and not block.shutdown_event.is_set()):
            counters.inc('block_restarts')
            delay = self._backoff(block, restarts)
            self.record(BlockFailure(block.name, exc, kind='restarted',
                                     fatal=False, restarts=restarts + 1))
            return 'restart', delay
        failure = self.record(BlockFailure(block.name, exc,
                                           restarts=restarts))
        self.abort(failure)
        return 'abort', 0.0

    def block_skipped(self, block, exc):
        """Record a skip_sequence degradation (non-fatal)."""
        counters.inc('block_failures')
        self.record(BlockFailure(block.name, exc, kind='skipped',
                                 fatal=False))

    def block_poisoned(self, block, exc):
        """A block died on a poisoned ring: a cascade, not a root cause.
        Recorded for diagnostics unless the pipeline is simply shutting
        down (then it is the intended wakeup)."""
        if getattr(self.pipeline, '_shutting_down', False) \
                and not self.abort_event.is_set():
            return
        self.record(BlockFailure(block.name, exc, kind='poisoned',
                                 fatal=False))

    def block_finished(self, block):
        pass     # hook for symmetry / future per-block accounting

    # -- abort -------------------------------------------------------------
    def abort(self, failure=None):
        """Poison every ring and set every shutdown event so all block
        threads wake promptly; idempotent."""
        if self.abort_event.is_set():
            return
        self.abort_event.set()
        cause = failure.exc if failure is not None else \
            RuntimeError('pipeline aborted')
        # release anyone parked at the init barrier
        self.pipeline.all_blocks_finished_initializing_event.set()
        for block in self.pipeline.blocks:
            block.shutdown_event.set()
        for block in self.pipeline.blocks:
            for ring in (list(getattr(block, 'orings', ())) +
                         list(getattr(block, 'irings', ()))):
                try:
                    ring.poison(cause)
                except Exception:
                    pass

    def raise_if_failed(self):
        with self._lock:
            failures = list(self.failures)
        fatal = [f for f in failures if f.fatal]
        if not fatal:
            return
        cls = PipelineStallError if isinstance(fatal[0].exc,
                                               PipelineStallError) \
            else PipelineRuntimeError
        raise cls(failures) from fatal[0].exc

    def failures_for(self, block_name):
        with self._lock:
            return [f for f in self.failures
                    if f.block_name == block_name]

    # -- health state machine (docs/robustness.md) -------------------------
    def start_health(self):
        """Start the pipeline health monitor (BF_HEALTH_INTERVAL
        seconds per tick, default 0.5; 0 disables the thread —
        ``Pipeline.health()`` then evaluates on demand)."""
        interval = _env_float('BF_HEALTH_INTERVAL', 0.5)
        self.health = HealthMonitor(self, interval)
        if interval and interval > 0:
            self.health.start()
        return self.health

    def stop_health(self):
        if self.health is not None:
            self.health.stop()

    def health_snapshot(self):
        """Current pipeline + per-block health.  While the monitor
        thread is live its last tick is authoritative — an on-demand
        evaluation would consume the monitor's counter deltas and
        hysteresis clean-ticks out from under it; with no thread
        (BF_HEALTH_INTERVAL=0, or before/after a run) evaluate now."""
        if self.health is None:
            self.health = HealthMonitor(self, 0.0)
        return self.health.snapshot(
            evaluate=not self.health.is_alive())

    # -- watchdog ----------------------------------------------------------
    def start_watchdog(self, secs=None):
        """Start the stall watchdog (no-op when no window configured).
        ``secs`` falls back to ``BF_WATCHDOG_SECS``; escalation to
        abort is opt-in via ``BF_WATCHDOG_ESCALATE=1``."""
        if secs is None:
            secs = _env_float('BF_WATCHDOG_SECS', 0.0)
        if not secs or secs <= 0:
            return None
        escalate = os.environ.get('BF_WATCHDOG_ESCALATE', '0') == '1'
        # an armed watchdog turns on the span flight recorder (even
        # without BF_TRACE_FILE): a stall report then carries the
        # timeline of what was happening BEFORE everything stopped,
        # not just where each thread is parked now
        from .telemetry import spans
        spans.enable_flight_recorder()
        self._watchdog = _Watchdog(self, float(secs), escalate)
        self._watchdog.start()
        return self._watchdog

    def stop_watchdog(self):
        if self._watchdog is not None:
            self._watchdog.stop()
            self._watchdog = None
            # release this run's flight-recorder hold (refcounted, so
            # a concurrently armed pipeline keeps recording)
            from .telemetry import spans
            spans.disable_flight_recorder()


class HealthMonitor(threading.Thread):
    """Pipeline health state machine (docs/robustness.md "Overload &
    degradation"): derives one whole-pipeline state and one state per
    block from the live robustness signals —

    - **FAILED**: the supervisor recorded a fatal failure / aborted.
    - **STALLED**: no live block has heartbeat within
      ``BF_HEALTH_STALL_SECS`` (default 5, or the armed watchdog
      window), or the watchdog counted a stall.
    - **SHEDDING**: a drop-policy ring or the bridge shed data since
      the last tick (``ring.*.shed_gulps`` / ``bridge.tx.shed_spans``
      deltas).
    - **DEGRADED**: SLO violations, block restarts/skips, or bridge
      reconnects/circuit events since the last tick.
    - **OK** otherwise.

    Escalation is immediate; de-escalation requires
    ``BF_HEALTH_HYSTERESIS`` consecutive clean ticks (default 4) so a
    bursty overload does not flap the state.  Every evaluation is
    published to the ``pipeline/health`` ProcLog (rendered by
    ``tools/like_top.py``); transitions count on
    ``health.transitions`` and are kept in a bounded history.  On a
    per-block transition the block's ``health_state`` attribute is
    updated and its :meth:`~bifrost_tpu_torch.pipeline.Block.on_health`
    degraded-mode hook is invoked (errors swallowed + counted)."""

    #: severity order (index into HEALTH_STATES)
    _SEV = {s: i for i, s in enumerate(HEALTH_STATES)}

    def __init__(self, supervisor, interval):
        super(HealthMonitor, self).__init__(name='bf-health',
                                            daemon=True)
        self.supervisor = supervisor
        self.interval = max(float(interval or 0.0), 0.0)
        self.hysteresis = max(_env_int('BF_HEALTH_HYSTERESIS', 4), 1)
        stall = _env_float('BF_HEALTH_STALL_SECS', 0.0)
        if stall <= 0:
            stall = getattr(supervisor.pipeline, 'watchdog_secs',
                            None) or _env_float('BF_WATCHDOG_SECS',
                                                0.0) or 5.0
        self.stall_secs = float(stall)
        self._stop_event = threading.Event()
        self._eval_lock = threading.Lock()
        self._last = {}              # counter name -> last value
        self._state = 'OK'
        self._since = time.time()
        self._clean_ticks = 0
        self._block_states = {}
        self._transitions = []       # (unix_ts, from, to, reason)
        self._proclog = None
        self._nfail_seen = 0
        import weakref
        with _registry_lock:
            _live_monitors.append(weakref.ref(self))

    def stop(self):
        self._stop_event.set()

    def run(self):
        while not self._stop_event.wait(self.interval):
            try:
                self.evaluate()
            except Exception:
                counters.inc('health.hook_errors')
            if self._state == 'FAILED':
                # terminal: keep the final state published and exit
                return

    # -- signal collection -------------------------------------------------
    def _delta(self, snap, name):
        cur = snap.get(name, 0)
        prev = self._last.get(name, 0)
        self._last[name] = cur
        return max(cur - prev, 0)

    def _ring_owner_names(self):
        """{ring_name: owning block name} for shed attribution."""
        out = {}
        for block in self.supervisor.pipeline.blocks:
            for ring in getattr(block, 'orings', ()) or ():
                base = getattr(ring, '_base_ring', ring)
                out[getattr(base, 'name', '?')] = block.name
        return out

    # -- evaluation --------------------------------------------------------
    def evaluate(self, now=None):
        from .telemetry import counters as _c
        with self._eval_lock:
            snap = _c.snapshot()
            now = time.monotonic() if now is None else now
            sup = self.supervisor
            owners = self._ring_owner_names()

            # per-block raw severity this tick
            shed_by_block = {}
            for name in list(snap):
                if name.startswith('ring.') and \
                        name.endswith('.shed_gulps'):
                    d = self._delta(snap, name)
                    if d:
                        ring = name[len('ring.'):-len('.shed_gulps')]
                        owner = owners.get(ring)
                        if owner is not None:
                            shed_by_block[owner] = \
                                shed_by_block.get(owner, 0) + d
            bridge_shed = (self._delta(snap, 'bridge.tx.shed_gulps') +
                           self._delta(snap,
                                       'bridge.tx.quota_shed_gulps'))
            slo_violations = self._delta(snap, 'slo.violations')
            degraded_events = (
                self._delta(snap, 'block_restarts') +
                self._delta(snap, 'bridge.tx.reconnects') +
                self._delta(snap, 'bridge.redial_attempts') +
                self._delta(snap, 'bridge.circuit_open') +
                # fabric choreography (bifrost_tpu.fabric): a fan-out
                # leg re-striped onto survivors, a fan-in origin
                # marked gapped, or a dead sender session adopted —
                # the pipeline is degraded-but-running, not failed
                self._delta(snap, 'fabric.fanout.restripes') +
                self._delta(snap, 'fabric.fanin.gapped') +
                self._delta(snap, 'bridge.rx.sessions_adopted'))
            stalls = self._delta(snap, 'watchdog_stalls')

            with sup._lock:
                failures = list(sup.failures)
            new_failures = failures[self._nfail_seen:]
            self._nfail_seen = len(failures)
            fatal = sup.abort_event.is_set() or \
                any(f.fatal for f in failures)

            blocks = sup.pipeline.blocks
            live = [b for b in blocks
                    if getattr(b, '_thread', None) is not None
                    and b._thread.is_alive()]
            beats = [getattr(b, '_hb_time', None) for b in live]
            beats = [b for b in beats if b is not None]
            all_stalled = bool(live) and bool(beats) and \
                (now - max(beats)) >= self.stall_secs

            per_block_sev = {b.name: 'OK' for b in blocks}

            def raise_sev(name, state):
                if name in per_block_sev and \
                        self._SEV[state] > \
                        self._SEV[per_block_sev[name]]:
                    per_block_sev[name] = state

            for f in new_failures:
                if f.fatal:
                    raise_sev(f.block_name, 'FAILED')
                elif f.kind in ('restarted', 'skipped', 'reconnected',
                                'degraded'):
                    raise_sev(f.block_name, 'DEGRADED')
            for name, nshed in shed_by_block.items():
                raise_sev(name, 'SHEDDING')
            for b in blocks:
                # consume the per-block SLO delta EVERY tick (a
                # lazily-established baseline would attribute all
                # historical violations to whichever tick first
                # evaluates the block)
                if self._delta(snap, 'slo.%s.violations' % b.name):
                    raise_sev(b.name, 'DEGRADED')

            # pipeline severity this tick
            if fatal:
                raw = 'FAILED'
            elif stalls or all_stalled:
                raw = 'STALLED'
            elif shed_by_block or bridge_shed:
                raw = 'SHEDDING'
            elif slo_violations or degraded_events or \
                    any(s == 'DEGRADED'
                        for s in per_block_sev.values()):
                raw = 'DEGRADED'
            else:
                raw = 'OK'

            self._apply(raw, per_block_sev, {
                'shed_gulps': sum(shed_by_block.values()),
                'bridge_shed': bridge_shed,
                'slo_violations': slo_violations,
                'degraded_events': degraded_events,
                'stalled': bool(stalls or all_stalled),
            })
            return self._snapshot_locked()

    def _apply(self, raw, per_block_sev, reasons):
        # escalate immediately; de-escalate only after `hysteresis`
        # consecutive ticks at the lower severity (anti-flap)
        cur = self._state
        if self._SEV[raw] >= self._SEV[cur]:
            nxt = raw
            self._clean_ticks = 0
        else:
            self._clean_ticks += 1
            nxt = raw if self._clean_ticks >= self.hysteresis else cur
        if nxt != cur:
            reason = ', '.join('%s=%s' % kv
                               for kv in sorted(reasons.items())
                               if kv[1]) or 'recovered'
            self._transitions.append((time.time(), cur, nxt, reason))
            del self._transitions[:-32]
            self._state = nxt
            self._since = time.time()
            self._clean_ticks = 0
            counters.inc('health.transitions')
            if nxt in ESCALATION_STATES and \
                    self._SEV[nxt] > self._SEV[cur]:
                # escalation hook (fleet incident black-box): fires
                # only on the way UP — recovery transitions through
                # SHEDDING etc. are not new incidents
                _notify_escalation(
                    getattr(self.supervisor.pipeline, 'name',
                            'pipeline'), cur, nxt, reason)
        # per-block: immediate escalation, shared hysteresis counter
        # is overkill per block — blocks recover with the pipeline
        for block in self.supervisor.pipeline.blocks:
            sev = per_block_sev.get(block.name, 'OK')
            prev = self._block_states.get(block.name, 'OK')
            if self._SEV[sev] < self._SEV[prev] and \
                    self._clean_ticks == 0 and nxt != 'OK':
                sev = prev          # hold until the pipeline recovers
            if sev != prev:
                self._block_states[block.name] = sev
                block.health_state = sev
                try:
                    block.on_health(sev, prev)
                except Exception:
                    counters.inc('health.hook_errors')
        self._publish()

    def _snapshot_locked(self):
        return {
            'state': self._state,
            'since': self._since,
            'blocks': dict(self._block_states) or
                {b.name: 'OK'
                 for b in self.supervisor.pipeline.blocks},
            'transitions': [
                {'when': t, 'from': a, 'to': b, 'reason': r}
                for t, a, b, r in self._transitions],
        }

    def snapshot(self, evaluate=False):
        """Current health dict (``Pipeline.health()``); with
        ``evaluate`` recompute now instead of returning the last
        tick's view."""
        if evaluate:
            return self.evaluate()
        with self._eval_lock:
            return self._snapshot_locked()

    def _publish(self):
        try:
            from .proclog import ProcLog
            if self._proclog is None:
                self._proclog = ProcLog('pipeline/health')
            self._proclog.update({
                'state': self._state,
                'since_unix': round(self._since, 3),
                'transitions':
                    counters.get('health.transitions'),
                'blocks': ','.join(
                    '%s=%s' % kv
                    for kv in sorted(self._block_states.items())
                    if kv[1] != 'OK') or 'all-ok',
            }, force=True)
        except Exception:
            pass


class _Watchdog(threading.Thread):
    """Daemon thread watching block heartbeats for whole-pipeline
    stalls.  A stall is declared when EVERY live block has been idle
    for at least ``timeout`` seconds — a single block waiting on input
    is normal backpressure, but nobody moving means the pipeline is
    wedged (deadlock, hung device call, dead upstream)."""

    def __init__(self, supervisor, timeout, escalate):
        super(_Watchdog, self).__init__(name='bf-watchdog', daemon=True)
        self.supervisor = supervisor
        self.timeout = timeout
        self.escalate = escalate
        self._stop_event = threading.Event()
        self._fired_epoch = -1.0
        self._proclog = None

    def stop(self):
        self._stop_event.set()

    def _live_blocks(self):
        out = []
        for block in self.supervisor.pipeline.blocks:
            thread = getattr(block, '_thread', None)
            if thread is not None and thread.is_alive():
                out.append(block)
        return out

    def run(self):
        poll = max(min(self.timeout / 4.0, 1.0), 0.05)
        while not self._stop_event.wait(poll):
            if self.supervisor.abort_event.is_set():
                return
            blocks = self._live_blocks()
            if not blocks:
                return
            now = time.monotonic()
            beats = [getattr(b, '_hb_time', None) or now for b in blocks]
            newest = max(beats)
            if now - newest < self.timeout:
                continue
            if newest <= self._fired_epoch:
                continue            # already reported this stall
            self._fired_epoch = newest
            self._report(blocks, now - newest)
            if self.escalate:
                stall = PipelineStallError(
                    'pipeline stalled: no block progressed for %.1fs '
                    '(BF_WATCHDOG_SECS=%g); stalled blocks: %s'
                    % (now - newest, self.timeout,
                       ', '.join(b.name for b in blocks)))
                failure = self.supervisor.record(BlockFailure(
                    '<watchdog>', stall, kind='stall', fatal=True,
                    tb=stall.args[0]))
                self.supervisor.abort(failure)
                return

    def _report(self, blocks, idle):
        counters.inc('watchdog_stalls')
        stacks = dump_thread_stacks()
        rings = ring_occupancies(self.supervisor.pipeline)
        lines = ['=== bifrost_tpu_torch watchdog: pipeline stall '
                 '(no progress for %.1fs) ===' % idle]
        for b in blocks:
            lines.append('  block %-40s gulps=%d idle=%.1fs'
                         % (b.name, getattr(b, '_hb_gulps', 0),
                            time.monotonic() -
                            (getattr(b, '_hb_time', None) or 0)))
        for name, occ in sorted(rings.items()):
            lines.append('  ring  %-40s %r' % (name, occ))
        lines.append(stacks)
        try:
            from .telemetry import spans
            lines.append(spans.flight_record())
        except Exception as exc:
            lines.append('(flight recorder unavailable: %r)' % exc)
        lines.append('=== end watchdog dump ===')
        sys.stderr.write('\n'.join(lines) + '\n')
        try:
            from .proclog import ProcLog
            if self._proclog is None:
                self._proclog = ProcLog('pipeline/watchdog')
            self._proclog.update({
                'stalls': counters.get('watchdog_stalls'),
                'last_stall_unix': time.time(),
                'idle_secs': round(idle, 3),
                'stalled_blocks': ','.join(b.name for b in blocks),
            }, force=True)
        except Exception:
            pass
