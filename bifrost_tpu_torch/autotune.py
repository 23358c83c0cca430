"""Closed-loop auto-tuning: a controller that reads the port's telemetry
and retunes the hot-path knobs while a pipeline runs (the counterpart of
``bifrost_tpu/autotune.py``, with the same constants, rules, variables,
counters and profile format).

The knobs are the macro-gulp batch K (``Pipeline(gulp_batch=K)``), the
dispatch-ahead ``sync_depth``, each bridge sink's credit window and
stripe count, each compiled segment's split count and each ring's
capacity.  The telemetry already measures what an operator would tune
by: dispatch amortization (``block.*.gulps`` / ``block.*.dispatches``),
hard syncs (``pipeline.sync_waits``), credit stalls
(``bridge.*.send_stall_s``), ring occupancy and reserve waits.

**Controller model.**  :class:`AutoTuner` is a daemon thread started by
``Pipeline.run(autotune=True)`` / ``BF_AUTOTUNE=1``.  Each tick
(``BF_AUTOTUNE_INTERVAL`` seconds) it takes
``telemetry.snapshot(rates=<own tracker>)`` and walks its knob table.  A
knob fires only when its trigger signal clears a threshold, steps
geometrically (doubling), then holds for a cooldown before it judges the
objective (logical pipeline gulps/s over a sliding window): a step that
did not gain the min-gain fraction is reverted (K, sync_depth, window,
streams, split) or simply kept (ring growth), and the knob pins.  A knob
climbs until climbing stops paying and never dithers.

**Retune protocol.**  ``sync_depth`` is read per gulp
(``resolve_sync_depth``), ``gulp_batch`` per sequence
(``_resolve_macro_batch``), the bridge window per span.  Ring capacity
changes go through ``Ring.request_resize``, applied at span quiescence
on both ring cores.  Before a step that can change ring geometry the
controller re-runs the static verifier with the candidate supplied
through ``verify.scope_overrides`` (a thread-local seam; the live
pipeline is not touched) and refuses any step that would introduce a
``BF-E`` diagnostic (``verify.new_errors_vs``); ring growth is clamped
up to ``verify.ring_capacity_floors``.

**Observability.**  ``autotune.<knob>`` counters track each knob's
current value; ``autotune.retunes`` / ``.reverts`` / ``.rejected`` count
decisions; the ``analysis/autotune`` ProcLog holds the live knob panel
(``bifrost_tpu_torch.tools.like_top`` renders it); span recording gets
one ``autotune.retune`` event per change.

**Freeze profiles.**  ``BF_AUTOTUNE=freeze`` tunes until converged, then
pins the configuration and dumps it as a JSON profile
(``BF_AUTOTUNE_PROFILE``, default ``autotune_profile.json``).  A profile
that exists at startup is applied as the starting configuration in every
mode, behind the same verifier gate.  The profile is the JAX package's
format, so either package loads the other's.
"""

from __future__ import annotations

import json
import os
import threading
import time

from .supervision import _env_float, _env_int

__all__ = ['AutoTuner', 'maybe_start', 'resolve_mode', 'apply_profile',
           'adopt_profile', 'load_profile', 'topology_signature']

#: controller tick period (seconds)
DEFAULT_INTERVAL = 0.5
#: ticks a knob holds after a retune before evaluating the objective
DEFAULT_COOLDOWN = 2
#: ticks a pending step may wait for engagement before forced judgment
DEFAULT_MAX_HOLD = 40
#: fractional objective improvement a step must deliver to keep going
DEFAULT_MIN_GAIN = 0.02
#: knob ceilings (growth is geometric, so these bound the step count)
MAX_GULP_BATCH = 16
MAX_SYNC_DEPTH = 32
MAX_WINDOW = 32
MAX_STREAMS = 8
#: per-ring growth ceiling for the capacity knob (bytes)
MAX_RING_BYTES = 256 << 20
#: hysteresis thresholds for the trigger signals
SYNC_WAIT_TRIGGER = 0.05     # hard waits per device gulp
STALL_FRAC_TRIGGER = 0.05    # send-stall seconds per wall second
OCCUPANCY_TRIGGER = 0.90     # ring fill fraction
RESERVE_WAIT_TRIGGER = 5e-4  # reserve-blocked seconds per wall second


def resolve_mode(arg=None):
    """Effective autotune mode: ``'off'`` | ``'on'`` | ``'freeze'``.
    ``arg`` is the ``Pipeline.run(autotune=...)`` value; ``None``
    defers to ``BF_AUTOTUNE`` (``1``/``on`` tune, ``freeze`` tune +
    pin + dump profile, anything else off)."""
    if arg is None:
        arg = os.environ.get('BF_AUTOTUNE', '')
    if isinstance(arg, str):
        val = arg.strip().lower()
        if val in ('1', 'on', 'true', 'yes'):
            return 'on'
        if val == 'freeze':
            return 'freeze'
        return 'off'
    return 'on' if arg else 'off'


def profile_path():
    return os.environ.get('BF_AUTOTUNE_PROFILE',
                          'autotune_profile.json')


def load_profile(path=None):
    """The saved knob profile dict, or None when absent/unreadable."""
    path = path or profile_path()
    try:
        with open(path) as f:
            prof = json.load(f)
    except (OSError, ValueError):
        return None
    return prof if isinstance(prof, dict) and 'knobs' in prof else None


def topology_signature(pipeline):
    """Structural identity of a pipeline's block/ring graph:
    ``(hash, block_keys, ring_keys)``.

    ``block_keys``/``ring_keys`` map LIVE names to STRUCTURAL keys —
    a block is ``<Type>#<n>`` (the n-th block of that type in
    construction order), a ring is ``<producer key>.out<j>`` (or
    ``<first consumer key>.in<j>`` for externally-fed rings) — and
    the hash digests block types plus ring roles (producer/consumer
    positions and spaces).  Names never enter any of it, so renaming
    a ring or a block leaves the signature — and every key — intact.

    This is what makes freeze profiles portable: version-2 profiles key their per-ring/per-block knobs by
    structural key instead of positional name, so a profile survives
    a topology rename that used to invalidate every entry."""
    import hashlib
    blocks = list(pipeline.blocks)
    counts = {}
    bkey = {}
    for b in blocks:
        t = type(b).__name__
        i = counts.get(t, 0)
        counts[t] = i + 1
        bkey[id(b)] = '%s#%d' % (t, i)

    def base(r):
        return getattr(r, '_base_ring', r)

    ring_key, ring_live = {}, {}
    for b in blocks:
        for j, r in enumerate(getattr(b, 'orings', None) or []):
            br = base(r)
            ring_key.setdefault(id(br), '%s.out%d' % (bkey[id(b)], j))
            ring_live.setdefault(id(br), getattr(br, 'name', '?'))
    for b in blocks:
        for j, r in enumerate(getattr(b, 'irings', None) or []):
            br = base(r)
            ring_key.setdefault(id(br), '%s.in%d' % (bkey[id(b)], j))
            ring_live.setdefault(id(br), getattr(br, 'name', '?'))
    struct = []
    for b in blocks:
        def keys(rings):
            return ','.join(
                '%s:%s' % (ring_key[id(base(r))],
                           getattr(base(r), 'space', '?'))
                for r in (rings or []))
        struct.append('%s|in=%s|out=%s'
                      % (bkey[id(b)], keys(getattr(b, 'irings', None)),
                         keys(getattr(b, 'orings', None))))
    digest = hashlib.sha1('\n'.join(struct).encode()).hexdigest()[:16]
    return (digest,
            {b.name: bkey[id(b)] for b in blocks},
            {ring_live[rid]: key for rid, key in ring_key.items()})


def apply_profile(pipeline, profile):
    """Pin a pipeline's tunables to a saved profile's knob values
    (the freeze-replay path; also the warm start when a profile file
    already exists).  Ring capacities are requested through the
    deferred-resize protocol.  Version-2 profiles key per-ring /
    per-block knobs by STRUCTURAL key (:func:`topology_signature`),
    so a renamed ring or block still receives its entry; version-1
    name keys still apply as names.  Unknown keys are skipped — a
    profile from a different topology applies what it can."""
    knobs = (profile or {}).get('knobs', {})
    if 'gulp_batch' in knobs:
        from .macro import retune_gulp_batch
        retune_gulp_batch(pipeline, knobs['gulp_batch'])
    if 'sync_depth' in knobs:
        # 0 is legal (hard drain every gulp — resolve_sync_depth): a
        # profile frozen at 0 must restore the operator's memory bound
        pipeline._sync_depth = max(int(knobs['sync_depth']), 0)
    _sig, bmap, rmap = topology_signature(pipeline)
    live_block = {v: k for k, v in bmap.items()}
    live_ring = {v: k for k, v in rmap.items()}
    windows = knobs.get('bridge_window', {})
    streams = knobs.get('bridge_streams', {})
    if windows or streams:
        from .blocks.bridge import BridgeSink
        by_name = {b.name: b for b in pipeline.blocks
                   if isinstance(b, BridgeSink)}
        for key, w in windows.items():
            b = by_name.get(live_block.get(key, key))
            if b is not None:
                b.retune_window(int(w))
        for key, n in streams.items():
            b = by_name.get(live_block.get(key, key))
            if b is not None:
                b.retune_streams(int(n))
    splits = knobs.get('segment_split', {})
    if splits:
        from . import segments as _segments
        by_name = {b.name: b
                   for b in getattr(pipeline, '_segments', [])}
        for key, n in splits.items():
            b = by_name.get(live_block.get(key, key))
            if b is not None:
                _segments.retune_split(b, int(n))
    ring_bytes = knobs.get('ring_total_bytes', {})
    if ring_bytes:
        rings = _pipeline_rings(pipeline)
        for key, nbyte in ring_bytes.items():
            r = rings.get(live_ring.get(key, key))
            if r is not None:
                try:
                    r.request_resize(r._ghost or 1, int(nbyte))
                except Exception:
                    pass
    return knobs


def adopt_profile(pipeline, knobs):
    """Pin a NEW pipeline's tunables to a knob set harvested from a
    previous converged or finished run (a service tier's warm start):
    the job starts at the converged configuration instead of
    re-converging.  A thin
    wrapper over :func:`apply_profile` that makes the adoption
    observable: every call counts on ``autotune.profile_adoptions``
    (the warm-start test's assertion signal)."""
    applied = apply_profile(pipeline, {'knobs': dict(knobs or {})})
    from .telemetry import counters
    counters.inc('autotune.profile_adoptions')
    return applied


def gated_retune(pipeline, knobs):
    """Verifier-gated LIVE retune of a (possibly running) pipeline —
    the write path of a controller outside the pipeline (a
    cross-tenant arbiter): the candidate knob set rides
    ``verify.scope_overrides``, is diffed against the pipeline's
    CURRENT diagnostics (``new_errors_vs``), and only applies (via
    :func:`adopt_profile`) when it introduces no new BF-E — exactly
    the retune protocol the in-pipeline controller uses, exposed for
    a controller that sits OUTSIDE the pipeline.  Returns True when
    applied; refusals count on ``autotune.rejected``."""
    from .analysis import verify
    knobs = dict(knobs or {})
    overrides = {}
    if 'gulp_batch' in knobs:
        try:
            overrides['gulp_batch'] = int(knobs['gulp_batch'])
        except (TypeError, ValueError):
            knobs.pop('gulp_batch')
    windows = knobs.get('bridge_window') or {}
    if isinstance(windows, dict) and windows:
        try:
            _sig, bmap, _rmap = topology_signature(pipeline)
            live = {v: k for k, v in bmap.items()}
        except Exception:
            live = {}
        overrides['bridge_window'] = {
            live.get(key, key): w for key, w in windows.items()}
    if overrides:
        try:
            baseline = verify.verify_pipeline(pipeline)
            with verify.scope_overrides(overrides):
                cand = verify.verify_pipeline(pipeline)
        except Exception:
            baseline, cand = [], []   # never let the gate crash a
            #                           control loop
        if verify.new_errors_vs(baseline, cand):
            from .telemetry import counters
            counters.inc('autotune.rejected')
            return False
    adopt_profile(pipeline, knobs)
    return True


def _pipeline_rings(pipeline):
    """{name: base ring} over every ring the pipeline's blocks touch."""
    rings = {}
    for b in pipeline.blocks:
        for r in (list(getattr(b, 'irings', ()) or ()) +
                  list(getattr(b, 'orings', ()) or ())):
            base = getattr(r, '_base_ring', r)
            rings[base.name] = base
    return rings


def maybe_start(pipeline, arg=None):
    """``Pipeline.run``'s hook: start an :class:`AutoTuner` for the
    resolved mode, or return None when off.  Never lets a controller
    construction failure take the pipeline down."""
    mode = resolve_mode(arg)
    if mode == 'off':
        return None
    try:
        tuner = AutoTuner(pipeline, mode=mode)
        tuner.start()
        return tuner
    except Exception:
        return None


# ---------------------------------------------------------------------------
# knobs
# ---------------------------------------------------------------------------

class _Knob(object):
    """One tunable under closed-loop control.

    Subclasses define ``read()`` (current value), ``triggered(sig)``
    (does the trigger signal justify a step), ``signal(snap)`` (the
    per-tick trigger metric), ``step(value)`` (next candidate) and
    ``write(value)`` (apply).  The shared ``tick`` logic implements
    the step -> cooldown -> evaluate -> continue/revert/converge state
    machine described in the module docstring."""

    name = 'knob'
    reversible = True

    def __init__(self, tuner):
        self.tuner = tuner
        self.converged = False
        self.cooldown = 0            # ticks until evaluation/next step
        self.pending = None          # (old_value, baseline_objective)
        self.held = 0                # ticks spent waiting for engage

    # -- subclass API ------------------------------------------------------
    def read(self):
        raise NotImplementedError

    def write(self, value):
        raise NotImplementedError

    def signal(self, snap):
        raise NotImplementedError

    def triggered(self, sig):
        raise NotImplementedError

    def step(self, value):
        raise NotImplementedError

    def guard(self, value):
        """Extra safety check for a candidate value (verifier gate);
        True = allowed."""
        return True

    def engaged(self, snap):
        """Whether the last step has actually LANDED in the runtime.
        Most knobs apply immediately; a macro-K change waits for the
        next sequence (``_resolve_macro_batch`` is per-sequence), so
        judging the objective before then would judge the OLD config.
        Pending evaluation holds until engagement, bounded by
        ``tuner.max_hold_ticks`` (a knob that can never engage — e.g.
        macro fallback to K=1 — is judged anyway and pins)."""
        return True

    # -- shared state machine ----------------------------------------------
    def tick(self, snap, objective):
        if self.converged:
            return
        if self.cooldown > 0:
            self.cooldown -= 1
            return
        t = self.tuner
        if self.pending is not None:
            if self.held < t.max_hold_ticks and \
                    not self.engaged(snap):
                self.held += 1
                self.cooldown = 1
                return
            if objective is None or objective <= 0:
                # traffic paused (sequence boundary, compile) — judging
                # a step against a zero objective would spuriously
                # revert it; hold and evaluate at the next live tick
                self.cooldown = 1
                return
            self.held = 0
            old, baseline = self.pending
            self.pending = None
            if baseline is None or baseline <= 0:
                # the step was taken before the objective window had a
                # baseline (first live tick): unjudgeable.  Keep it
                # and stay in the climb — judging 'unknown' as gain=0
                # would falsely pin every first-tick step at a single
                # doubling
                pass
            else:
                gain = (objective - baseline) / baseline
                if gain < -t.min_gain and self.reversible:
                    # the step HURT: undo it and pin
                    t._apply(self, old, kind='revert')
                    self.converged = True
                    return
                if gain < t.min_gain:
                    # kept, but climbing stopped paying: pin here
                    self.converged = True
                    return
        sig = self.signal(snap)
        if sig is None or not self.triggered(sig):
            return
        cur = self.read()
        nxt = self.step(cur)
        if nxt is None or nxt == cur:
            self.converged = True
            return
        if not self.guard(nxt):
            t._count('autotune.rejected')
            self.converged = True
            return
        self.pending = (cur, objective)
        self.cooldown = t.cooldown_ticks
        t._apply(self, nxt, kind='retune', signal=sig)


class _GulpBatchKnob(_Knob):
    """Macro-gulp batch K: grow while dispatch amortization still pays.
    Trigger: the device blocks' achieved gulps-per-dispatch tracks the
    current K (batching engages at all) and the dispatch rate is still
    high enough that halving it can matter.  Applies at the next
    sequence (the per-sequence ``_resolve_macro_batch``)."""

    name = 'gulp_batch'

    def read(self):
        from .macro import resolve_gulp_batch
        return resolve_gulp_batch(self.tuner.pipeline)

    def write(self, value):
        from .macro import retune_gulp_batch
        retune_gulp_batch(self.tuner.pipeline, value)

    def signal(self, snap):
        # per-BLOCK amortization, not the aggregate: sources/sinks
        # dispatch 1:1 forever and would dilute the ratio below any
        # threshold once K grows — what matters is that SOME block's
        # achieved gulps-per-dispatch tracks the current K
        rates = snap.get('rates', {}).get('counters', {})
        disp_total = 0.0
        best_gpd = 0.0
        for k, v in rates.items():
            if not (k.startswith('block.') and
                    k.endswith('.dispatches')):
                continue
            disp_total += v
            g = rates.get(k[:-len('.dispatches')] + '.gulps', 0.0)
            if v > 0 and g > 0:
                best_gpd = max(best_gpd, g / v)
        if disp_total <= 0 or best_gpd <= 0:
            return None
        return {'dispatch_rate': disp_total, 'gpd': best_gpd}

    def triggered(self, sig):
        cur = self.read()
        # batching must actually be engaging at the current K (within
        # 2x — partial tail batches round the ratio down), and there
        # must be real dispatch traffic left to amortize
        return sig['gpd'] >= max(cur, 1) * 0.5 and \
            sig['dispatch_rate'] > 1.0

    def engaged(self, snap):
        # a K step lands at the NEXT sequence: hold judgment until the
        # best per-block amortization tracks the new value
        sig = self.signal(snap)
        return sig is not None and sig['gpd'] >= self.read() * 0.5

    def step(self, value):
        nxt = min(max(value, 1) * 2, self.tuner.max_gulp_batch)
        return nxt if nxt > value else None

    def guard(self, value):
        return self.tuner._verifier_allows('_gulp_batch', value)


class _SyncDepthKnob(_Knob):
    """Dispatch-ahead depth: raise while hard host waits per device
    gulp stay above the trigger — each doubling halves the steady-state
    sync rate (``pipeline.sync_waits`` / ``pipeline.gulps_device``).
    Applies at the next gulp (``resolve_sync_depth`` reads per gulp)."""

    name = 'sync_depth'

    def read(self):
        from .pipeline import resolve_sync_depth
        return resolve_sync_depth(self.tuner.pipeline)

    def write(self, value):
        # 0 is legal (zero run-ahead — resolve_sync_depth): a revert
        # from an operator-set 0 must restore 0, not 1
        self.tuner.pipeline._sync_depth = max(int(value), 0)

    def signal(self, snap):
        rates = snap.get('rates', {}).get('counters', {})
        gulps = rates.get('pipeline.gulps_device', 0.0)
        if gulps <= 0:
            return None
        # hard host waits: explicit sync-point drains plus the transfer
        # engine's depth-bound stalls (xfer.depth_waits) — both fall as
        # the dispatch-ahead window widens
        waits = rates.get('pipeline.sync_waits', 0.0) + \
            rates.get('xfer.depth_waits', 0.0)
        return waits / gulps

    def triggered(self, sig):
        return sig > self.tuner.sync_wait_trigger

    def step(self, value):
        nxt = min(max(value, 1) * 2, self.tuner.max_sync_depth)
        return nxt if nxt > value else None

    # no guard override: no static check constrains sync_depth (it
    # bounds in-flight device work, not ring geometry), so running the
    # verifier here would diff the baseline against itself — pure cost


class _BridgeWindowKnob(_Knob):
    """One BridgeSink's credit window: widen while the send-stall
    histogram keeps accruing (the sender spends a real fraction of
    wall time blocked on credit).  Converged = the stall histogram has
    flattened (rate under the trigger)."""

    def __init__(self, tuner, block):
        super(_BridgeWindowKnob, self).__init__(tuner)
        self.block = block
        self.name = 'bridge_window.%s' % block.name

    def read(self):
        return int(self.block.window)

    def write(self, value):
        self.block.retune_window(int(value))

    def signal(self, snap):
        hrates = snap.get('rates', {}).get('histograms', {})
        h = hrates.get('bridge.%s.send_stall_s' % self.block.name)
        if h is None:
            return None
        return h['sum_per_s']        # stall seconds per wall second

    def triggered(self, sig):
        return sig > self.tuner.stall_frac_trigger

    def step(self, value):
        nxt = min(max(value, 1) * 2, self.tuner.max_window)
        return nxt if nxt > value else None

    def guard(self, value):
        return self.tuner._verifier_allows_window(self.block, value)


class _BridgeStreamsKnob(_Knob):
    """One BridgeSink's connection-stripe count (the
    ``BF_BRIDGE_STREAMS`` dial, retuned live — the other "remaining
    knob" from the macro-tuning round).  Trigger: the sender still
    spends a real fraction of wall time credit-stalled AFTER its
    window knob has converged — a wide-enough window has covered the
    link latency, so what remains is single-connection throughput,
    and another TCP stream (its own congestion window) is the next
    lever.  A step restripes via a drained planned redial at a span
    boundary (``RingSender.retune_streams``), so stepping is cheap
    but not free; the shared evaluate/revert machinery keeps the
    extra stripes only when the objective says they pay (loopback
    links typically revert — striping is a DCN win)."""

    def __init__(self, tuner, block, window_knob=None):
        super(_BridgeStreamsKnob, self).__init__(tuner)
        self.block = block
        self.window_knob = window_knob
        self.name = 'bridge_streams.%s' % block.name

    def read(self):
        return int(self.block.nstreams)

    def write(self, value):
        self.block.retune_streams(int(value))

    def signal(self, snap):
        hrates = snap.get('rates', {}).get('histograms', {})
        h = hrates.get('bridge.%s.send_stall_s' % self.block.name)
        if h is None:
            return None
        return h['sum_per_s']

    def triggered(self, sig):
        # sequenced after the window knob: both knobs read the same
        # stall signal, and stepping them concurrently would make the
        # objective attribution meaningless
        if self.window_knob is not None and \
                not self.window_knob.converged:
            return False
        return sig > self.tuner.stall_frac_trigger

    def engaged(self, snap):
        # a restripe is applied by the PUMP thread at a span boundary
        # (and a backlogged link defers it): hold judgment until the
        # live sender actually runs the new stripe count — otherwise
        # the evaluate window opens against the old wiring and the
        # step is judged on noise
        sender = getattr(self.block, '_sender', None)
        if sender is None:
            return True
        return getattr(sender, '_restripe_pending', None) is None \
            and len(sender.socks) == self.read()

    def step(self, value):
        nxt = min(max(value, 1) * 2, self.tuner.max_streams)
        return nxt if nxt > value else None

    def guard(self, value):
        return self.tuner._verifier_allows_aux('bridge_streams',
                                               self.block, value)


class _SegmentSplitKnob(_Knob):
    """One compiled segment's split count
    (:mod:`bifrost_tpu_torch.segments`).  The fully-fused call (split
    0) is the default; this knob probes whether splitting the segment
    at a member boundary runs better (one large call can lose to two
    smaller ones), keeps the split only when the windowed objective
    improves, and RE-FUSES by the ordinary revert otherwise.  A split
    changes dispatch count only, never ring geometry (the interior
    rings stay elided either way); it still rides the same
    verifier-gated retune protocol as every other knob.  Applies at
    the next sequence, like macro-K.  Trigger: THIS segment's own
    dispatch rate (``block.<segment>.dispatches``), and — with
    several compiled segments — sequenced after the previous
    segment's knob converges, so two probes never share one
    evaluate window against the single pipeline objective."""

    def __init__(self, tuner, block, prev_knob=None):
        super(_SegmentSplitKnob, self).__init__(tuner)
        self.block = block
        self.prev_knob = prev_knob
        self.name = 'segment_split.%s' % block.name

    def read(self):
        try:
            return int(self.block._segment_split)
        except (TypeError, ValueError):
            return 0

    def write(self, value):
        from . import segments as _segments
        _segments.retune_split(self.block, value)

    def signal(self, snap):
        rate = snap.get('rates', {}).get('counters', {}).get(
            'block.%s.dispatches' % self.block.name, 0.0)
        return rate if rate > 0 else None

    def triggered(self, sig):
        if self.prev_knob is not None and \
                not self.prev_knob.converged:
            return False
        return sig > 0

    def engaged(self, snap):
        # a split lands at the NEXT sequence (_resolve_splits)
        return getattr(self.block, '_splits_active', 0) == self.read()

    def step(self, value):
        nxt = value + 1
        ceiling = max(len(getattr(self.block, '_members', [])) - 1, 0)
        return nxt if nxt <= ceiling else None

    def guard(self, value):
        return self.tuner._verifier_allows_aux('segment_split',
                                               self.block, value)


class _RingCapacityKnob(_Knob):
    """One ring's total capacity: grow (never shrink — the BF-E101
    floor is a hard lower bound by construction) while the ring sits
    pegged near 100% occupancy with writers measurably blocked in
    reserve.  Growth routes through the deferred-resize protocol, so
    it lands at span quiescence without stalling anyone."""

    reversible = False               # request_resize only grows

    def __init__(self, tuner, ring):
        super(_RingCapacityKnob, self).__init__(tuner)
        self.ring = ring
        self.name = 'ring_bytes.%s' % ring.name

    def read(self):
        return int(self.ring.total_span)

    def write(self, value):
        floor = self.tuner.ring_floor_bytes(self.ring.name)
        target = max(int(value), floor or 0)
        self.ring.request_resize(max(self.ring._ghost, 1), target)

    def signal(self, snap):
        d = snap.get('rings', {}).get(self.ring.name)
        if not d or 'fill' not in d:
            return None
        # the WINDOWED stall fraction, not the lifetime histogram: a
        # single warm-up reserve wait must not satisfy the trigger
        # forever once the ring runs wait-free
        h = snap.get('rates', {}).get('histograms', {}).get(
            'ring.%s.reserve_s' % self.ring.name)
        stall = h['sum_per_s'] if h else 0.0
        return {'fill': d['fill'], 'reserve_stall': stall}

    def triggered(self, sig):
        return sig['fill'] >= self.tuner.occupancy_trigger and \
            sig['reserve_stall'] > self.tuner.reserve_wait_trigger

    def step(self, value):
        cur = max(value, 1)
        nxt = min(cur * 2, self.tuner.max_ring_bytes)
        return nxt if nxt > cur else None


# ---------------------------------------------------------------------------
# the controller
# ---------------------------------------------------------------------------

class AutoTuner(threading.Thread):
    """The closed-loop controller thread (module docstring has the
    model).  Public state for tests/benches: ``knob_values()`` (the
    live config), ``converged`` (every knob pinned), ``retunes``
    (decisions applied)."""

    def __init__(self, pipeline, mode='on', interval=None):
        super(AutoTuner, self).__init__(name='bf-autotune', daemon=True)
        self.pipeline = pipeline
        self.mode = mode
        self.interval = max(float(
            interval if interval is not None
            else _env_float('BF_AUTOTUNE_INTERVAL', DEFAULT_INTERVAL)),
            0.02)
        self.cooldown_ticks = max(
            _env_int('BF_AUTOTUNE_COOLDOWN', DEFAULT_COOLDOWN), 0)
        self.min_gain = _env_float('BF_AUTOTUNE_MIN_GAIN',
                                   DEFAULT_MIN_GAIN)
        self.max_gulp_batch = _env_int('BF_AUTOTUNE_MAX_BATCH',
                                       MAX_GULP_BATCH)
        self.max_sync_depth = _env_int('BF_AUTOTUNE_MAX_DEPTH',
                                       MAX_SYNC_DEPTH)
        self.max_window = _env_int('BF_AUTOTUNE_MAX_WINDOW', MAX_WINDOW)
        self.max_streams = _env_int('BF_AUTOTUNE_MAX_STREAMS',
                                    MAX_STREAMS)
        self.max_ring_bytes = _env_int('BF_AUTOTUNE_MAX_RING_BYTES',
                                       MAX_RING_BYTES)
        #: ticks a pending step may wait for engagement (a macro-K
        #: change lands at the next sequence) before being judged
        #: anyway — bounds the hold when batching can never engage
        self.max_hold_ticks = DEFAULT_MAX_HOLD
        self.sync_wait_trigger = SYNC_WAIT_TRIGGER
        self.stall_frac_trigger = STALL_FRAC_TRIGGER
        self.occupancy_trigger = OCCUPANCY_TRIGGER
        self.reserve_wait_trigger = RESERVE_WAIT_TRIGGER

        from collections import deque
        from .telemetry.exporter import RateTracker
        self._rates = RateTracker()
        #: sliding (monotonic, cumulative pipeline.gulps) window the
        #: objective is computed over — macro batching makes the
        #: instantaneous per-tick gulp rate violently bursty (a K-gulp
        #: commit lands K gulps inside ONE tick window), so judging
        #: steps against single-tick rates would revert good steps on
        #: noise; the windowed average is what the knobs see
        self._obj_window = deque(maxlen=6)
        self._stop_event = threading.Event()
        self._proclog = None
        self.ticks = 0
        self.retunes = 0
        self.converged = False
        self.converged_at = None
        self.profile_dumped = None
        self._frozen = False
        self._counter_shadow = {}
        #: baseline verifier findings: pre-existing errors must not
        #: block tuning (verify.new_errors_vs)
        self._baseline_diags = None
        self._floors = None

        # warm start: an existing profile is the last converged
        # config — gated through the same verifier check every live
        # retune passes (a stale profile from another topology or a
        # shared cwd must not warm-start THIS pipeline into the
        # BF-E101 deadlock configuration the controller itself could
        # never tune into)
        prof = load_profile()
        self._warm_started = False
        if prof is not None and self._profile_safe(prof):
            try:
                apply_profile(pipeline, prof)
                self._warm_started = True
            except Exception:
                pass

        self.knobs = self._build_knobs()

    # -- knob discovery ----------------------------------------------------
    def _build_knobs(self):
        knobs = [_GulpBatchKnob(self), _SyncDepthKnob(self)]
        try:
            from .blocks.bridge import BridgeSink
            for b in self.pipeline.blocks:
                if isinstance(b, BridgeSink):
                    wk = _BridgeWindowKnob(self, b)
                    knobs.append(wk)
                    # stripe count sequences AFTER the window knob
                    # (same trigger signal, disjoint stepping); the
                    # v1 wire has no striping, so no knob there —
                    # retune_streams would set a value the sender
                    # can never apply
                    if getattr(b, 'protocol', None) != 1:
                        knobs.append(_BridgeStreamsKnob(
                            self, b, window_knob=wk))
        except Exception:
            pass
        # compiled segments (segments.py): the split/re-fuse
        # boundary knob — mesh segments never split (_resolve_splits
        # pins 0 there), so no knob is built for them; multiple
        # segments' knobs chain so only one probes at a time
        prev_seg_knob = None
        for seg in getattr(self.pipeline, '_segments', []) or []:
            if getattr(seg, 'mesh', None) is None and \
                    len(getattr(seg, '_members', [])) > 1:
                prev_seg_knob = _SegmentSplitKnob(
                    self, seg, prev_knob=prev_seg_knob)
                knobs.append(prev_seg_knob)
        for ring in _pipeline_rings(self.pipeline).values():
            knobs.append(_RingCapacityKnob(self, ring))
        return knobs

    # -- safety gates ------------------------------------------------------
    def _baseline(self):
        if self._baseline_diags is None:
            from .analysis import verify
            try:
                self._baseline_diags = verify.verify_pipeline(
                    self.pipeline)
            except Exception:
                self._baseline_diags = []
        return self._baseline_diags

    def _profile_safe(self, prof):
        """Would applying the profile's geometry knobs introduce a
        BF-E the configured pipeline does not already have?  Same
        ``scope_overrides`` + ``new_errors_vs`` gate as a live
        retune; rejections are counted (``autotune.rejected``) and
        the pipeline simply cold-starts.  Ring capacities are not
        checked: ``apply_profile`` routes them through
        ``request_resize``, whose growth-only MAX semantics cannot
        go below the BF-E101 floor."""
        from .analysis import verify
        knobs = (prof or {}).get('knobs', {})
        overrides = {}
        if 'gulp_batch' in knobs:
            try:
                overrides['gulp_batch'] = int(knobs['gulp_batch'])
            except (TypeError, ValueError):
                pass
        windows = knobs.get('bridge_window') or {}
        if isinstance(windows, dict) and windows:
            # v2 profiles key by structural key — translate to the
            # LIVE block names the verifier's checks match against
            try:
                _sig, bmap, _rmap = topology_signature(self.pipeline)
                live = {v: k for k, v in bmap.items()}
            except Exception:
                live = {}
            overrides['bridge_window'] = {
                live.get(key, key): w for key, w in windows.items()}
        if not overrides:
            return True
        try:
            with verify.scope_overrides(overrides):
                cand = verify.verify_pipeline(self.pipeline)
        except Exception:
            return True              # never let the gate kill startup
        if verify.new_errors_vs(self._baseline(), cand):
            self._count('autotune.rejected')
            return False
        return True

    def _verifier_allows(self, attr, value):
        """Would setting ``pipeline.<attr> = value`` introduce a BF-E
        the static analyzer rejects (BF-E101 ring sizing above all)?
        Evaluated by re-running the verifier with the candidate
        supplied through ``verify.scope_overrides`` — a thread-local
        seam, so the live pipeline is never mutated while block
        threads concurrently resolve the same tunables — and diffing
        against the baseline."""
        from .analysis import verify
        overrides = {attr.lstrip('_'): value}
        try:
            with verify.scope_overrides(overrides):
                cand = verify.verify_pipeline(self.pipeline)
        except Exception:
            return True              # never let the gate kill tuning
        return not verify.new_errors_vs(self._baseline(), cand)

    def _verifier_allows_window(self, block, value):
        return self._verifier_allows_aux('bridge_window', block, value)

    def _verifier_allows_aux(self, key, block, value):
        """Per-block candidate gate: re-run the verifier with
        ``{key: {block name: value}}`` supplied through the
        thread-local override seam and refuse any step that would
        INTRODUCE a BF-E.  ``bridge_streams`` / ``segment_split``
        have no static constraint today (they change connection or
        dispatch count, never ring geometry) — they still ride this
        gate so every knob follows one retune protocol."""
        from .analysis import verify
        overrides = {key: {block.name: value}}
        try:
            with verify.scope_overrides(overrides):
                cand = verify.verify_pipeline(self.pipeline)
        except Exception:
            return True
        return not verify.new_errors_vs(self._baseline(), cand)

    def ring_floor_bytes(self, ring_name):
        """The BF-E101 deadlock bound for ``ring_name`` in bytes (the
        controller's hard floor), or None when unprovable."""
        if self._floors is None:
            from .analysis import verify
            try:
                self._floors = verify.ring_capacity_floors(
                    self.pipeline)
            except Exception:
                self._floors = {}
        entry = self._floors.get(ring_name)
        return entry.get('bytes') if entry else None

    # -- publication -------------------------------------------------------
    def _count(self, name, n=1):
        from .telemetry import counters
        counters.inc(name, n)

    def _publish_value(self, knob, value):
        """Keep ``autotune.<knob>`` equal to the knob's current value
        (delta-incremented: counters are monotonic storage, not the
        values themselves)."""
        if not isinstance(value, (int, float)):
            return
        from .telemetry import counters
        key = 'autotune.%s' % knob.name
        prev = self._counter_shadow.get(key)
        if prev is None:
            # a previous run's controller in this process may have
            # left the counter at its final knob value: delta from
            # the COUNTER, not from 0, or the second run publishes
            # old+new and breaks the counter==value contract
            prev = counters.get(key)
        delta = int(value) - prev
        if delta:
            counters.inc(key, delta)
            self._counter_shadow[key] = int(value)

    def _apply(self, knob, value, kind='retune', signal=None):
        """The single choke point every knob change goes through:
        applies, counts, spans, and proclogs the decision."""
        from .telemetry import spans
        t0 = spans.now_us() if spans.enabled() else None
        knob.write(value)
        self.retunes += 1
        self._count('autotune.retunes')
        if kind == 'revert':
            self._count('autotune.reverts')
        self._publish_value(knob, knob.read())
        if t0 is not None:
            args = {'knob': knob.name, 'to': value, 'kind': kind}
            if isinstance(signal, (int, float)):
                args['signal'] = round(float(signal), 6)
            spans.record('autotune.retune', 'autotune', t0,
                         spans.now_us() - t0, args)
        self._publish_panel(last='%s %s -> %s'
                            % (kind, knob.name, value))

    def knob_values(self):
        """{knob_name: current value} for every controlled knob."""
        out = {}
        for k in self.knobs:
            try:
                out[k.name] = k.read()
            except Exception:
                pass
        return out

    def _publish_panel(self, last=None):
        """The ``analysis/autotune`` ProcLog: live knob values +
        controller state (rendered by
        :mod:`bifrost_tpu_torch.tools.like_top` as the knob panel)."""
        try:
            if self._proclog is None:
                from .proclog import ProcLog
                self._proclog = ProcLog('analysis/autotune')
            entry = {'mode': self.mode, 'ticks': self.ticks,
                     'retunes': self.retunes,
                     'converged': int(self.converged),
                     'frozen': int(self._frozen)}
            for name, value in sorted(self.knob_values().items()):
                entry['knob.%s' % name] = value
            if last:
                entry['last'] = last
            self._proclog.update(entry, force=True)
        except Exception:
            pass

    # -- profile dump ------------------------------------------------------
    def _dump_profile(self):
        from .blocks.bridge import BridgeSink
        knobs = {}
        values = self.knob_values()
        if 'gulp_batch' in values:
            knobs['gulp_batch'] = values['gulp_batch']
        if 'sync_depth' in values:
            knobs['sync_depth'] = values['sync_depth']
        # version 2: per-block/per-ring knobs key by STRUCTURAL key
        # (topology_signature) — a renamed ring or block no longer
        # invalidates its entry; apply_profile translates back
        try:
            sig, bmap, rmap = topology_signature(self.pipeline)
        except Exception:
            sig, bmap, rmap = None, {}, {}
        windows, streams = {}, {}
        for b in self.pipeline.blocks:
            if isinstance(b, BridgeSink):
                key = bmap.get(b.name, b.name)
                windows[key] = int(b.window)
                streams[key] = int(b.nstreams)
        if windows:
            knobs['bridge_window'] = windows
            knobs['bridge_streams'] = streams
        splits = {bmap.get(s.name, s.name):
                  int(getattr(s, '_segment_split', 0) or 0)
                  for s in getattr(self.pipeline, '_segments', [])}
        if splits:
            knobs['segment_split'] = splits
        ring_bytes = {rmap.get(name, name): int(r.total_span)
                      for name, r in
                      _pipeline_rings(self.pipeline).items()}
        if ring_bytes:
            knobs['ring_total_bytes'] = ring_bytes
        prof = {'version': 2, 'pipeline': self.pipeline.name,
                'topology': sig,
                'ticks': self.ticks, 'retunes': self.retunes,
                'knobs': knobs}
        path = profile_path()
        try:
            # thread ident too: the controller's final-tick dump and
            # stop()'s fallback dump may run concurrently (join
            # timeout) — distinct tmp files keep os.replace atomic
            tmp = '%s.tmp%d.%d' % (path, os.getpid(),
                                   threading.get_ident())
            with open(tmp, 'w') as f:
                json.dump(prof, f, indent=1, sort_keys=True)
                f.write('\n')
            os.replace(tmp, path)
            self.profile_dumped = path
        except OSError:
            pass
        return prof

    # -- main loop ---------------------------------------------------------
    def run(self):
        # let the pipeline reach steady state before the first reading
        _t0 = time.perf_counter()
        self._publish_panel(last='started (%s)' % self.mode)
        for knob in self.knobs:
            try:
                self._publish_value(knob, knob.read())
            except Exception:
                pass
        self._count('autotune.tick_busy_us',
                    int((time.perf_counter() - _t0) * 1e6))
        while not self._stop_event.wait(self.interval):
            try:
                self.tick()
            except Exception:
                pass                 # never take the pipeline down
        # one final reading on the way out: short pipelines (and the
        # freeze dump) still get at least one controller pass
        try:
            self.tick()
        except Exception:
            pass

    def tick(self):
        """One controller pass (public for deterministic tests).
        Meters its own busy time into ``autotune.tick_busy_us`` —
        the controller's directly-accounted cost (wall time inside
        controller passes: a conservative upper bound that includes
        the thread's own GIL waits; thread-CPU clocks quantize at
        ~10ms on some CI kernels and under-read sub-ms ticks).  The
        convergence gate's overhead criterion divides it by the
        pipeline wall — an A/B wall-clock comparison cannot certify
        a 2% bound on a shared CI host whose run-to-run spread is
        +-10%."""
        _t0 = time.perf_counter()
        try:
            self._tick_inner()
        finally:
            self._count('autotune.tick_busy_us',
                        int((time.perf_counter() - _t0) * 1e6))

    def _tick_inner(self):
        from .telemetry import snapshot
        self.ticks += 1
        self._count('autotune.ticks')
        snap = snapshot(self.pipeline, rates=self._rates)
        rates = snap.get('rates', {})
        if rates.get('dt') is None:
            return                   # first reading: baseline only
        objective = self._windowed_objective(snap)
        if not self._frozen:
            for knob in self.knobs:
                knob.tick(snap, objective)
        if not self.converged and all(k.converged for k in self.knobs):
            self.converged = True
            self.converged_at = time.monotonic()
            self._count('autotune.converged')
            if self.mode == 'freeze':
                self._dump_profile()
                self._frozen = True
            self._publish_panel(last='converged')
        elif self.ticks % 10 == 0:
            self._publish_panel()

    def _windowed_objective(self, snap):
        """Logical pipeline gulps/s averaged over the sliding tick
        window (None until two observations exist; 0.0 during a
        traffic lull — knobs hold judgment rather than judging a
        pause)."""
        self._obj_window.append(
            (time.monotonic(),
             snap.get('counters', {}).get('pipeline.gulps', 0)))
        if len(self._obj_window) < 2:
            return None
        t0, g0 = self._obj_window[0]
        t1, g1 = self._obj_window[-1]
        if t1 <= t0:
            return None
        return max(g1 - g0, 0) / (t1 - t0)

    def stop(self, wait=True):
        """Stop the loop; publishes the final knob panel (and, in
        freeze mode, dumps the profile even if convergence was not
        reached — the partial tune is still a better warm start than
        nothing)."""
        self._stop_event.set()
        if wait and self.is_alive():
            self.join(self.interval + 2.0)
        if self.mode == 'freeze' and self.profile_dumped is None:
            try:
                self._dump_profile()
            except Exception:
                pass
        self._publish_panel(last='stopped')
