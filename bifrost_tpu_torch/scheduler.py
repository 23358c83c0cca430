"""The elastic control plane (the counterpart of
``bifrost_tpu/scheduler.py``): cross-host tenant placement, live
migration and re-placement on host death.

The service tier (:mod:`bifrost_tpu_torch.service`) runs N isolated
tenant pipelines in one process; the fabric
(:mod:`bifrost_tpu_torch.fabric`) runs one pipeline across N hosts.
This module places :class:`~bifrost_tpu_torch.service.TenantSpec` s
across a :class:`~bifrost_tpu_torch.fabric.FabricSpec`'s hosts and keeps
them running when hosts die.

- :func:`plan_placement` packs tenants onto hosts (priority-ordered
  worst-fit on declared cores, with pinning and exclusion for
  re-placement), and
  :func:`~bifrost_tpu_torch.analysis.verify.verify_placement` refuses an
  infeasible plan with the BF-E22x codes before anything launches.
- :class:`Scheduler` applies placements through per-host
  :class:`~bifrost_tpu_torch.service.JobManager` s, migrates tenants
  live (a warm start on the target, resumed from the durable
  :class:`~bifrost_tpu_torch.fabric.AckLedger` frontier) and re-places
  a dead host's tenants onto the survivors when
  :class:`~bifrost_tpu_torch.fabric.Membership` declares it dead:
  bounded, counted loss, and priority decides who is displaced when the
  survivors are oversubscribed.
- :meth:`Scheduler.arbitrate` moves quota from a low-priority donor to
  an SLO violator (``QuotaGate.retune``) and shrinks the donor's
  macro-batch through the verifier-gated
  :func:`~bifrost_tpu_torch.autotune.gated_retune`.

Everything is observable: ``scheduler.*`` counters, the
``sched/placements`` ProcLog pane (``[sched]`` in ``tools/like_top``),
:func:`telemetry_section` in ``telemetry.snapshot()``, and
:func:`joined_rollup`, the per-host x per-tenant table that the
``bf_fabric``, ``bf_serve`` and ``bf_sched`` tools print.
"""

from collections import OrderedDict
import threading
import time

from .supervision import _env_float, _env_int, jittered_backoff
from .telemetry import counters

__all__ = ['SchedulerError', 'PlacementError', 'Placement',
           'plan_placement', 'Scheduler', 'ledger_frontier',
           'joined_rollup', 'format_rollup', 'telemetry_section']


def _rebalance_secs():
    return max(_env_float('BF_SCHED_REBALANCE_SECS', 1.0), 0.05)


def _displace_frac():
    return min(max(_env_float('BF_SCHED_DISPLACE_QUOTA_FRAC', 0.5),
                   0.0), 1.0)


def _max_replacements():
    return max(_env_int('BF_SCHED_MAX_REPLACEMENTS', 8), 0)


def _arbiter_frac():
    return min(max(_env_float('BF_SCHED_ARBITER_FRAC', 0.5), 0.0),
               1.0)


class SchedulerError(RuntimeError):
    """Control-plane failure (placement, migration, re-placement)."""


class PlacementError(SchedulerError):
    """An infeasible placement, carrying the verifier's BF-E22x
    diagnostics on ``.diagnostics``."""

    def __init__(self, diagnostics):
        self.diagnostics = list(diagnostics)
        super(PlacementError, self).__init__(
            '; '.join('%s: %s' % (d.code, d.message)
                      for d in self.diagnostics) or
            'infeasible placement')


def host_capacity(spec):
    """{host: schedulable cores} over the fabric spec — a host that
    declares ``cores`` is schedulable at their count; one that does
    not still runs tenants (on shared cores) at capacity 1."""
    return {name: (len(h.cores) if h.cores else 1)
            for name, h in spec.hosts.items()}


class Placement(object):
    """One concrete placement: ``assignments`` ``{tenant_id: host}``,
    the capacity/demand maps it was packed against, the tenants that
    land displaced (sharing cores on an oversubscribed host, quota
    scaled by ``BF_SCHED_DISPLACE_QUOTA_FRAC``), and the verifier
    diagnostics that admitted it."""

    def __init__(self, assignments, capacity, demand, displaced,
                 diagnostics=None):
        self.assignments = OrderedDict(assignments)
        self.capacity = dict(capacity)
        self.demand = dict(demand)
        self.displaced = list(displaced)
        self.diagnostics = list(diagnostics or [])

    def tenants_on(self, host):
        return [tid for tid, h in self.assignments.items()
                if h == host]

    def as_dict(self):
        return {'assignments': dict(self.assignments),
                'capacity': dict(self.capacity),
                'demand': dict(self.demand),
                'displaced': list(self.displaced)}

    def __repr__(self):
        return 'Placement(%r, displaced=%r)' % (
            dict(self.assignments), self.displaced)


def plan_placement(spec, tenants, pinned=None, exclude=(),
                   best_effort=False):
    """Bin-pack ``tenants`` onto ``spec``'s schedulable hosts.

    Priority-ordered worst-fit: tenants sort by (priority desc,
    ncores desc, id) and each lands on the host with the most free
    cores — high-priority tenants get the emptiest hosts, and ties
    break deterministically by host name.  ``pinned``
    (``{tenant_id: host}``) short-circuits the packer for those
    tenants; ``exclude`` removes hosts (the dead set) from
    consideration.  Oversubscription is allowed — ``partition_cores``
    shares cores rather than deadlocking — but the over-capacity,
    lowest-priority tenants on each such host are reported as
    DISPLACED (the scheduler scales their quotas down).

    Raises :class:`PlacementError` (BF-E220/BF-E221) when a tenant
    fits no schedulable host or is pinned somewhere unknown.
    ``best_effort`` (the re-placement path) waives the per-tenant
    BF-E220 capacity check: a dead host's tenants land on whatever
    survivors exist — displaced and shedding by policy — rather than
    being refused (bounded loss beats an orphaned tenant)."""
    from .fabric import FabricSpec
    from .service import TenantSpec
    from .analysis.verify import Diagnostic
    if isinstance(spec, dict):
        spec = FabricSpec.from_dict(spec)
    tenants = [TenantSpec.coerce(t) for t in tenants]
    pinned = dict(pinned or {})
    capacity = {h: c for h, c in host_capacity(spec).items()
                if h not in set(exclude)}
    bad = []
    if not capacity:
        bad.append(Diagnostic(
            'BF-E220', 'no schedulable hosts remain (all %d are '
            'excluded/dead)' % len(spec.hosts)))
        raise PlacementError(bad)
    max_cap = max(capacity.values())
    for t in tenants:
        if not best_effort and max(t.ncores, 1) > max_cap:
            bad.append(Diagnostic(
                'BF-E220',
                'tenant %r requests %d core(s) but the largest '
                'schedulable host offers %d'
                % (t.id, max(t.ncores, 1), max_cap),
                block='tenant:%s' % t.id))
    for tid, host in pinned.items():
        if host not in capacity:
            bad.append(Diagnostic(
                'BF-E221',
                'tenant %r is pinned to host %r, which is not '
                'schedulable (known: %s)'
                % (tid, host, ', '.join(sorted(capacity))),
                block='tenant:%s' % tid))
    if bad:
        raise PlacementError(bad)

    free = dict(capacity)
    assignments = OrderedDict()
    order = sorted(tenants, key=lambda t: (-t.priority,
                                           -max(t.ncores, 1), t.id))
    for t in order:
        want = max(t.ncores, 1)
        host = pinned.get(t.id)
        if host is None:
            # worst-fit: the emptiest host takes the next tenant
            # (deterministic name tie-break)
            host = min(free, key=lambda h: (-free[h], h))
        assignments[t.id] = host
        free[host] -= want
    demand = {h: capacity[h] - free[h] for h in capacity}

    # over-capacity hosts displace their LOWEST-priority tenants:
    # walk each host's tenants best-first and mark everyone past the
    # core budget
    by_id = {t.id: t for t in tenants}
    displaced = []
    for host in sorted(capacity):
        if demand[host] <= capacity[host]:
            continue
        used = 0
        ranked = sorted(
            (by_id[tid] for tid in assignments
             if assignments[tid] == host),
            key=lambda t: (-t.priority, t.id))
        for t in ranked:
            used += max(t.ncores, 1)
            if used > capacity[host]:
                displaced.append(t.id)
    # stable tenant-submission order for the assignments map
    ordered = OrderedDict((t.id, assignments[t.id]) for t in tenants)
    return Placement(ordered, capacity, demand, displaced)


def ledger_frontier(fabric_name, host, link, seq_name=None):
    """The durable acked-frame frontier of ``host``'s sender ledger
    on ``link`` (``BF_FABRIC_STATE/<fabric>/<host>.<link>.json``) —
    what a migrated tenant may SKIP because the downstream side
    already committed it.  ``seq_name`` selects one sequence; the
    default is the max frontier across all of them.  Returns 0 when
    the ledger has no history (cold start == replay from frame 0)."""
    from .fabric import AckLedger
    led = AckLedger(fabric_name, host, link)
    acked = led.acked or {}
    if seq_name is not None:
        return int(acked.get(seq_name, 0))
    return int(max(acked.values())) if acked else 0


#: weakrefs to recently-built Scheduler instances (newest last) and
#: the most recent replacement record — telemetry_section() surfaces
#: both so the fleet rollup / incident bundles carry live placements
_live_schedulers = []
_last_replacement = {}


class Scheduler(object):
    """The control plane: owns the current :class:`Placement`, the
    per-host :class:`~bifrost_tpu_torch.service.JobManager` handles it
    submits through, and the death-watch that re-places tenants off
    hosts :class:`~bifrost_tpu_torch.fabric.Membership` declares dead.

    ``managers`` maps host names to the JobManagers this process
    controls (a host without an entry is placed but not launched from
    here — its own ``bf_serve``/``bf_sched`` agent applies the same
    plan).  ``membership`` (optional) powers :meth:`check` /
    :meth:`watch`; ``resume_of`` (optional,
    ``(tenant_id, dead_host) -> frame | None``) supplies the replay
    frontier for re-placed tenants — :func:`ledger_frontier` is the
    usual implementation.  ``exclude`` names hosts NEVER scheduled
    (control-plane/collector nodes that are fabric members but run no
    tenants) — it composes with the dead set on re-placement."""

    def __init__(self, spec, managers=None, membership=None,
                 strict=True, resume_of=None, exclude=()):
        from .fabric import FabricSpec
        if isinstance(spec, dict):
            spec = FabricSpec.from_dict(spec)
        self.spec = spec
        self.managers = dict(managers or {})
        self.membership = membership
        self.strict = strict
        self.resume_of = resume_of
        self.exclude = frozenset(exclude or ())
        self.placement = None
        self.tenants = OrderedDict()     # tid -> TenantSpec
        self._builds = {}                # tid -> build callable
        self._handled_dead = set()
        self._replacement_events = 0
        self._lock = threading.Lock()
        self._proclog = None
        self._stop = threading.Event()
        self._thread = None
        # live-instance registry: telemetry_section() (and through it
        # the fleet plane's per-host scheduler rollup) reports this
        # process's current assignments + last replacement record
        import weakref
        _live_schedulers.append(weakref.ref(self))
        del _live_schedulers[:-4]

    # -- placement ---------------------------------------------------------
    def place(self, tenants, pinned=None, exclude=()):
        """Plan a placement for ``tenants`` and run the joint
        :func:`~bifrost_tpu_torch.analysis.verify.verify_placement`
        pre-gate over it.  ``strict`` refuses any BF-E (raising
        :class:`PlacementError` with the diagnostics); warnings
        (BF-W224 oversubscription) pass through onto
        ``placement.diagnostics``.  Counts
        ``scheduler.placements``."""
        from .service import TenantSpec
        from .analysis import verify
        tenants = [TenantSpec.coerce(t) for t in tenants]
        placement = plan_placement(self.spec, tenants, pinned=pinned,
                                   exclude=set(exclude) | self.exclude)
        diags = verify.verify_placement(self.spec, tenants,
                                        placement.assignments)
        placement.diagnostics = diags
        errs = [d for d in diags if d.is_error]
        if errs and self.strict:
            raise PlacementError(errs)
        with self._lock:
            for t in tenants:
                self.tenants[t.id] = t
            self.placement = placement
        counters.inc('scheduler.placements')
        self._publish()
        return placement

    def apply(self, placement=None, build=None, start=True):
        """Submit every placed tenant to its host's JobManager (hosts
        without a local manager are skipped — a remote agent applies
        them) and scale DISPLACED tenants' quotas by
        ``BF_SCHED_DISPLACE_QUOTA_FRAC`` (counted loss instead of
        core-starved deadlock).  ``build`` is one callable for every
        tenant or a ``{tenant_id: callable}`` map.  Returns
        ``{tenant_id: Job}``."""
        placement = placement or self.placement
        if placement is None:
            raise SchedulerError('no placement to apply (call '
                                 'place() first)')
        jobs = {}
        for tid, host in placement.assignments.items():
            mgr = self.managers.get(host)
            if mgr is None:
                continue
            spec = self.tenants[tid]
            b = build.get(tid) if isinstance(build, dict) else build
            job = mgr.submit(spec, build=b)
            self._builds[tid] = b
            jobs[tid] = job
            if tid in placement.displaced:
                self._displace(job, spec)
        if start:
            for tid, job in jobs.items():
                self.managers[placement.assignments[tid]].start(tid)
        self._publish()
        return jobs

    def set_build(self, tenant_id, build):
        """Register the build callable a later submit/migrate of
        ``tenant_id`` uses — e.g. a tenant currently placed on a
        REMOTE host, which :meth:`apply` never submitted locally but
        a re-placement may migrate here."""
        self._builds[tenant_id] = build

    def _displace(self, job, spec):
        """Scale a displaced tenant's quota: it keeps running on
        shared cores, sheds by policy, and every shed byte is
        counted — bounded loss, never deadlock."""
        frac = _displace_frac()
        if spec.quota_bytes_per_s > 0 and frac < 1.0:
            gate = self._quota_gate(job)
            if gate is not None:
                gate.retune(spec.quota_bytes_per_s * frac)
        counters.inc('scheduler.displaced')

    @staticmethod
    def _quota_gate(job):
        from .service import QuotaGate
        for b in (job.pipeline.blocks if job.pipeline else []):
            if isinstance(b, QuotaGate):
                return b
        return None

    # -- live migration ----------------------------------------------------
    def migrate(self, tenant_id, target, resume_frame=None,
                start=True, stop_timeout=5.0):
        """Move one tenant to ``target``: stop its current job (if
        this process runs it), then submit it on the target's manager
        — a warm start when the topology was harvested there
        (plan-depot replay, zero recompiles) — resuming its synthetic
        source at ``resume_frame`` (the AckLedger frontier) so only
        unacked frames replay.  Skipped frames count on
        ``scheduler.resume.skipped_frames``; the move counts on
        ``scheduler.migrations``.  Returns the new Job."""
        with self._lock:
            spec = self.tenants.get(tenant_id)
            placement = self.placement
        if spec is None:
            raise SchedulerError('unknown tenant %r' % tenant_id)
        if target not in self.spec.hosts:
            raise SchedulerError('unknown target host %r' % target)
        mgr = self.managers.get(target)
        if mgr is None:
            raise SchedulerError('no local JobManager for host %r'
                                 % target)
        old_host = placement.assignments.get(tenant_id) \
            if placement else None
        old_mgr = self.managers.get(old_host) if old_host else None
        if old_mgr is not None:
            job = old_mgr.job(tenant_id)
            if job is not None and job.state in ('PENDING',
                                                 'RUNNING'):
                job.stop(stop_timeout)
        spec = self._respec_resume(spec, resume_frame)
        with self._lock:
            self.tenants[tenant_id] = spec
            if placement is not None:
                placement.assignments[tenant_id] = target
        new_job = mgr.submit(spec, build=self._builds.get(tenant_id))
        counters.inc('scheduler.migrations')
        if resume_frame:
            counters.inc('scheduler.resume.skipped_frames',
                         int(resume_frame))
        if start:
            mgr.start(tenant_id)
        self._publish()
        return new_job

    @staticmethod
    def _respec_resume(spec, resume_frame):
        """A copy of ``spec`` whose synthetic source resumes at
        ``resume_frame`` (other source kinds resume by their own
        means — replay/file sources are idempotent, udp is live)."""
        if not resume_frame:
            return spec
        from .service import TenantSpec
        d = spec.as_dict()
        src = dict(d.get('source') or {})
        if src.get('kind') == 'synthetic':
            src['start_frame'] = int(resume_frame)
            d['source'] = src
        return TenantSpec.coerce(d)

    # -- health-triggered re-placement -------------------------------------
    def handle_host_death(self, dead_host):
        """Re-place every tenant of ``dead_host`` onto the survivors:
        surviving tenants keep their hosts (pinned), the orphans
        re-pack worst-fit, each migrates with its durable resume
        frontier (``resume_of``), and tenants displaced on an
        oversubscribed survivor shed by scaled quota.  Bounded by
        ``BF_SCHED_MAX_REPLACEMENTS`` re-placement events; counts
        ``scheduler.replacements`` per tenant moved.  Returns
        ``{tenant_id: Job}`` for the moves this process performed."""
        with self._lock:
            if self.placement is None:
                return {}
            self._handled_dead.add(dead_host)
            dead = set(self._handled_dead)
            orphans = [tid for tid, h in
                       self.placement.assignments.items()
                       if h == dead_host]
            if not orphans:
                return {}
            if self._replacement_events >= _max_replacements():
                counters.inc('scheduler.replacements.refused')
                return {}
            self._replacement_events += 1
            pinned = {tid: h for tid, h in
                      self.placement.assignments.items()
                      if h not in dead}
            tenants = list(self.tenants.values())
        placement = plan_placement(self.spec, tenants, pinned=pinned,
                                   exclude=dead | self.exclude,
                                   best_effort=True)
        with self._lock:
            placement.diagnostics = self.placement.diagnostics
            self.placement = placement
        moved = {}
        for tid in orphans:
            target = placement.assignments[tid]
            resume = None
            if self.resume_of is not None:
                try:
                    resume = self.resume_of(tid, dead_host)
                except Exception:
                    resume = None
            try:
                moved[tid] = self.migrate(tid, target,
                                          resume_frame=resume)
            except SchedulerError:
                # no local manager for the target: the plan stands,
                # a remote agent launches it
                continue
            counters.inc('scheduler.replacements')
            # the replacement record the incident bundle archives:
            # who moved, from which dead host, to where, when
            _last_replacement.update({
                'tenant': tid, 'from': dead_host, 'to': target,
                'wall': round(time.time(), 3)})
            job = moved[tid]
            if tid in placement.displaced:
                self._displace(job, self.tenants[tid])
        # newly-displaced survivors (they did not move, but the
        # re-pack put their host over capacity) shed by policy too
        for tid in placement.displaced:
            if tid in moved or tid in orphans:
                continue
            host = placement.assignments[tid]
            mgr = self.managers.get(host)
            job = mgr.job(tid) if mgr is not None else None
            if job is not None:
                self._displace(job, self.tenants[tid])
        self._publish()
        return moved

    def check(self):
        """One death-watch tick: ask Membership for dead hosts and
        re-place any not yet handled.  Returns the handled hosts."""
        if self.membership is None:
            return []
        dead = self.membership.counts().get('dead') or []
        handled = []
        for host in dead:
            if host in self._handled_dead or \
                    host not in self.spec.hosts:
                continue
            self.handle_host_death(host)
            handled.append(host)
        return handled

    def watch(self, poll_s=None):
        """Start the background death-watch loop (one daemon thread
        polling :meth:`check` every ``BF_SCHED_REBALANCE_SECS``,
        backing off on control-plane failures)."""
        if self._thread is not None and self._thread.is_alive():
            return self
        interval = poll_s if poll_s is not None else _rebalance_secs()
        self._stop.clear()

        def loop():
            failures = 0
            while not self._stop.wait(interval):
                try:
                    self.check()
                    failures = 0
                except Exception:
                    failures += 1
                    time.sleep(jittered_backoff(failures,
                                                base=interval,
                                                jitter=0.1))
        self._thread = threading.Thread(target=loop,
                                        name='bf-sched-watch',
                                        daemon=True)
        self._thread.start()
        return self

    def stop_watch(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    # -- cross-tenant autotune arbiter -------------------------------------
    def arbitrate(self, frac=None):
        """One arbiter pass: for each RUNNING tenant violating its
        SLO budget, take ``BF_SCHED_ARBITER_FRAC`` of the lowest-
        priority quota-holding donor's rate and hand it to the
        violator (live ``QuotaGate.retune``), then shrink the donor's
        macro-batch through the verifier-gated
        :func:`~bifrost_tpu_torch.autotune.gated_retune` (the donor pays in
        both bandwidth and batching budget; the verifier still
        refuses any knob that would introduce a BF-E).  Counts
        ``scheduler.arbiter.retunes`` / ``.refused``; returns the
        transfers performed as ``[(violator, donor, bytes_per_s)]``."""
        frac = _arbiter_frac() if frac is None else frac
        jobs = {}
        for mgr in self.managers.values():
            for job in mgr.jobs():
                if job.state == 'RUNNING':
                    jobs[job.spec.id] = job
        violators = []
        for tid, job in jobs.items():
            slo = job.slo_rollup()
            if slo.get('ok') is False:
                violators.append((jobs[tid].spec.priority, tid))
        violators.sort(reverse=True)   # highest priority first
        transfers = []
        for _prio, vid in violators:
            vjob = jobs[vid]
            vgate = self._quota_gate(vjob)
            donors = []
            for tid, j in jobs.items():
                if tid == vid or \
                        j.spec.priority >= vjob.spec.priority:
                    continue
                g = self._quota_gate(j)
                if g is not None and g.quota_bytes_per_s > 0:
                    donors.append((j.spec.priority, tid, g, j))
            donors.sort(key=lambda d: (d[0], d[1]))
            if not donors or vgate is None:
                counters.inc('scheduler.arbiter.refused')
                continue
            _dprio, did, dgate, djob = donors[0]
            delta = dgate.quota_bytes_per_s * frac
            if delta <= 0:
                counters.inc('scheduler.arbiter.refused')
                continue
            dgate.retune(dgate.quota_bytes_per_s - delta)
            if vgate.quota_bytes_per_s > 0:
                vgate.retune(vgate.quota_bytes_per_s + delta)
            # shrink the donor's macro-batch too — verifier-gated, so
            # a refusal leaves the donor's geometry untouched
            try:
                from .macro import resolve_gulp_batch
                from .autotune import gated_retune
                k = resolve_gulp_batch(djob.pipeline)
                if k > 1 and not gated_retune(
                        djob.pipeline, {'gulp_batch': max(k // 2, 1)}):
                    counters.inc('scheduler.arbiter.refused')
            except Exception:
                pass
            counters.inc('scheduler.arbiter.retunes')
            transfers.append((vid, did, delta))
        if transfers:
            self._publish()
        return transfers

    # -- publication -------------------------------------------------------
    def _publish(self):
        """The ``sched/placements`` ProcLog pane: one row set per
        tenant (host, displaced flag) plus the control-plane event
        counters — ``tools/like_top.py`` renders it as ``[sched]``."""
        try:
            from .proclog import ProcLog
            if self._proclog is None:
                self._proclog = ProcLog('sched/placements')
            with self._lock:
                placement = self.placement
                entry = {'fabric': self.spec.name,
                         'ntenants': len(self.tenants),
                         'replacement_events':
                             self._replacement_events,
                         'dead_hosts':
                             ','.join(sorted(self._handled_dead))
                             or 'none'}
                if placement is not None:
                    for tid, host in placement.assignments.items():
                        entry['p.%s.host' % tid] = host
                        entry['p.%s.displaced' % tid] = int(
                            tid in placement.displaced)
            self._proclog.update(entry, force=True)
        except Exception:
            pass

    def shutdown(self, timeout=5.0):
        """Stop the watch loop and every local manager's tenants."""
        self.stop_watch()
        for mgr in self.managers.values():
            try:
                mgr.shutdown(timeout)
            except Exception:
                pass


# ---------------------------------------------------------------------------
# observability shared by the CLIs (bf_sched / bf_fabric / bf_serve /
# like_top)
# ---------------------------------------------------------------------------

def telemetry_section():
    """The ``scheduler`` section of ``telemetry.snapshot()``: the
    control-plane event counters (placements, migrations,
    replacements, displacements, arbiter activity, resume skips),
    plus — when a Scheduler lives in this process — its current
    ``assignments``/``displaced`` and the most recent replacement
    record (what the fleet incident bundle archives as the
    post-mortem's 'where did the tenant land' answer)."""
    out = {
        'placements': counters.get('scheduler.placements'),
        'migrations': counters.get('scheduler.migrations'),
        'replacements': counters.get('scheduler.replacements'),
        'replacements_refused':
            counters.get('scheduler.replacements.refused'),
        'displaced': counters.get('scheduler.displaced'),
        'arbiter_retunes': counters.get('scheduler.arbiter.retunes'),
        'arbiter_refused': counters.get('scheduler.arbiter.refused'),
        'resume_skipped_frames':
            counters.get('scheduler.resume.skipped_frames'),
    }
    for ref in reversed(_live_schedulers):
        sched = ref()
        if sched is None or sched.placement is None:
            continue
        try:
            out['assignments'] = dict(sched.placement.assignments)
            out['displaced_tenants'] = sorted(
                sched.placement.displaced)
        except Exception:
            pass
        break
    if _last_replacement:
        out['last_replacement'] = dict(_last_replacement)
    return out


def joined_rollup(pids=None):
    """The per-host × per-tenant health rollup: every local proclog
    process's ``fabric/health`` row joined with its
    ``service/tenants`` and ``sched/placements`` rows — one dict per
    process with nested per-tenant stats.  This single walk backs
    ``bf_fabric.py status``, ``bf_serve.py`` summaries,
    ``bf_sched.py status``, and like_top's ``[sched]`` pane."""
    from . import proclog
    if pids is None:
        from .monitor_utils import list_pipelines
        pids = list_pipelines()
    rows = []
    for pid in pids:
        try:
            contents = proclog.load_by_pid(pid)
        except Exception:
            continue
        fab = contents.get('fabric', {}).get('health') or {}
        svc = contents.get('service', {}).get('tenants') or {}
        sched = contents.get('sched', {}).get('placements') or {}
        if not fab and not svc and not sched:
            continue
        tenants = {}
        for key, val in svc.items():
            if not key.startswith('t.'):
                continue
            _t, tid, field = key.split('.', 2)
            tenants.setdefault(tid, {})[field] = val
        for key, val in sched.items():
            if not key.startswith('p.'):
                continue
            _p, tid, field = key.split('.', 2)
            tenants.setdefault(tid, {})[field] = val
        rows.append({
            'pid': pid,
            'host': fab.get('host') or sched.get('fabric') or '-',
            'role': fab.get('role', '-'),
            'state': fab.get('state', '-'),
            'peers_alive': fab.get('peers_alive'),
            'peers_total': fab.get('peers_total'),
            'ntenants': svc.get('ntenants', len(tenants)),
            'dead_hosts': sched.get('dead_hosts'),
            'tenants': tenants,
        })
    return rows


def format_rollup(rows):
    """Render :func:`joined_rollup` rows as the shared status table:
    one host line, then one indented line per tenant."""
    if not rows:
        return '  (no fabric/service processes in the proclog tree)'
    out = []
    for row in rows:
        peers = ''
        if row['peers_total'] not in (None, ''):
            peers = ' peers %s/%s' % (row['peers_alive'],
                                      row['peers_total'])
        dead = ''
        if row.get('dead_hosts') not in (None, '', 'none'):
            dead = ' dead=%s' % row['dead_hosts']
        out.append('%-24s host %-12s role %-8s state %-9s '
                   'tenants %s%s%s'
                   % (row['pid'], row['host'], row['role'],
                      row['state'], row['ntenants'], peers, dead))
        for tid, t in sorted(row['tenants'].items()):
            bits = ['  %-22s' % tid]
            for field in ('host', 'state', 'health', 'gulps',
                          'q_shed', 'warm', 'displaced', 'age99_ms'):
                if t.get(field) not in (None, ''):
                    bits.append('%s=%s' % (field, t[field]))
            out.append(' '.join(bits))
    return '\n'.join(out)
