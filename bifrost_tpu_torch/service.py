"""The multi-tenant service tier (the counterpart of
``bifrost_tpu/service.py``; same spec format, counters and panes).

A :class:`JobManager` runs N concurrent tenant pipelines in one process
from declarative :class:`TenantSpec`\\ s:

- **admission and fair sharing**: a capacity check at submit time
  (``BF_SERVE_MAX_TENANTS``), a token-bucket quota at each tenant's
  ingest (the bridge sender's ``_TokenBucket``, with the counted
  shedding of the overload layer), and priority-weighted core shares
  through :func:`bifrost_tpu_torch.affinity.partition_cores`;
- **blast-radius isolation**: each tenant is its own
  :class:`~bifrost_tpu_torch.pipeline.Pipeline` with its own supervisor
  and health monitor, its rings named under the ``tenant.<id>`` scope
  and its own service thread, so one tenant's poison, restart storm or
  shedding never touches another tenant's rings or health.  The tenants
  share the process's CUDA context, its default stream and its
  transfer engine: a device fault that leaves the context broken (an
  illegal address, say) fails every tenant of the process, and each
  tenant's SLO age includes the device work the others queued;
- **warm starts**: a job whose structural topology hash
  (:func:`bifrost_tpu_torch.autotune.topology_signature`) matches a
  finished job's adopts that job's plan depot (its FusedBlocks fetch
  their plans instead of building them, counted on
  ``fused.plan_depot_hits``) and its harvested knobs
  (:func:`bifrost_tpu_torch.autotune.adopt_profile`).  A hash match
  whose per-block plan signatures differ is rejected as stale
  (``service.warm.rejected_stale``) and the job starts cold.  A plan
  here is a closure over a bound kernel, so a warm start skips the
  plan build and the probe, not a compile;
- **per-tenant observability**: ``telemetry.snapshot()`` carries a
  ``tenants`` section (:func:`telemetry_section`), the exporter writes
  tenant-labelled Prometheus series, ``tools/like_top`` renders the
  ``service/tenants`` ProcLog pane as ``[tenants]``, and
  ``analysis.verify.verify_service`` checks whole service specs
  (BF-E210/E211/W212/W230/W231).

Source kinds:

- ``replay``     a recording replayed by ``blocks/serialize.py``'s
                 ``DeserializeBlock`` (looped, renumbered and
                 restamped each pass);
- ``file``       flat binary files (``blocks/binary_io.py``);
- ``synthetic``  a paced deterministic stream (:class:`SyntheticSource`);
- ``udp``        live UDP capture (``io/packet_capture.py``): the
                 service owns the capture pump thread and the tenant
                 chain reads its ring;
- ``ring``       a ring the operator supplies.

Counters:

- ``service.submitted`` / ``service.admission.rejected``
- ``service.<id>.admitted_gulps`` / ``service.<id>.admitted_bytes``
- ``service.<id>.quota_shed_gulps`` / ``service.<id>.quota_shed_bytes``
- ``service.warm.hits`` / ``service.warm.rejected_stale``
- ``service.affinity.applied`` / ``service.affinity.skipped``
"""

from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict

import numpy as np

from . import affinity
from .pipeline import Pipeline, SourceBlock, TransformBlock, SinkBlock
from .proclog import ProcLog
from .telemetry import counters, histograms

__all__ = ['TenantSpec', 'Job', 'JobManager', 'QuotaGate',
           'SyntheticSource', 'DiscardSink', 'ServiceError',
           'ServiceAdmissionError', 'ServiceSpecError', 'live_jobs',
           'telemetry_section', 'reset_warm_registry']

#: tenant job lifecycle states
JOB_STATES = ('PENDING', 'RUNNING', 'DONE', 'FAILED', 'CANCELLED')

#: recognized declarative source kinds
SOURCE_KINDS = ('replay', 'file', 'synthetic', 'udp', 'ring')

#: quota enforcement policies: 'shed' refuses gulps the bucket cannot
#: cover (counted loss, the drop-policy analogue), 'pace' admits every
#: gulp but sleeps the bucket debt (rate limiting, never loss)
QUOTA_POLICIES = ('shed', 'pace')


from .supervision import _env_float, _env_int  # noqa: E402  (shared)


class ServiceError(RuntimeError):
    pass


class ServiceAdmissionError(ServiceError):
    """Submit-time admission refusal (capacity, duplicate tenant)."""


class ServiceSpecError(ServiceError):
    """A tenant/service spec failed static validation (the BF-E21x
    diagnostics from ``analysis.verify.verify_service``)."""

    def __init__(self, diagnostics):
        self.diagnostics = list(diagnostics)
        super(ServiceSpecError, self).__init__(
            'service spec failed validation: %s'
            % '; '.join(repr(d) for d in self.diagnostics))


# ---------------------------------------------------------------------------
# tenant spec
# ---------------------------------------------------------------------------

class TenantSpec(object):
    """One tenant job, declaratively.

    Fields: ``id`` (``[A-Za-z0-9_-]+``), ``source`` (a dict with a
    ``kind`` from :data:`SOURCE_KINDS`), ``priority`` (>= 1; weights
    the core partition), ``ncores`` (requested cores; the capacity
    check sums these), ``quota_bytes_per_s`` (0 = unlimited),
    ``quota_policy`` ('shed' | 'pace'), ``overload_policy`` (applied
    as the tenant pipeline's scope tunable), ``slo_ms`` (per-tenant
    capture-to-exit budget, rolled up in the ``tenants`` telemetry
    section), ``gulp_nframe``, ``gulp_nbyte`` (the declared span size
    the BF-E211 quota check needs), ``on_failure`` /
    ``max_restarts`` (supervision policy for the tenant's blocks),
    ``sink`` ('discard' default; bf_serve's declarative workloads).
    """

    _FIELDS = ('id', 'source', 'priority', 'ncores',
               'quota_bytes_per_s', 'quota_policy', 'overload_policy',
               'slo_ms', 'gulp_nframe', 'gulp_nbyte', 'on_failure',
               'max_restarts', 'sink')

    def __init__(self, id, source=None, priority=1, ncores=1,
                 quota_bytes_per_s=0, quota_policy='shed',
                 overload_policy=None, slo_ms=None, gulp_nframe=None,
                 gulp_nbyte=None, on_failure=None, max_restarts=None,
                 sink='discard'):
        self.id = str(id)
        if not self.id or not all(c.isalnum() or c in '_-'
                                  for c in self.id):
            raise ValueError("tenant id %r must be non-empty "
                             "[A-Za-z0-9_-]+" % (id,))
        self.source = dict(source or {})
        self.priority = max(int(priority or 1), 1)
        self.ncores = max(int(ncores or 1), 1)
        self.quota_bytes_per_s = max(float(quota_bytes_per_s or 0), 0.0)
        if quota_policy not in QUOTA_POLICIES:
            raise ValueError("unknown quota_policy %r (expected %s)"
                             % (quota_policy, '/'.join(QUOTA_POLICIES)))
        self.quota_policy = quota_policy
        self.overload_policy = overload_policy
        self.slo_ms = float(slo_ms) if slo_ms is not None else None
        self.gulp_nframe = int(gulp_nframe) if gulp_nframe else None
        self.gulp_nbyte = int(gulp_nbyte) if gulp_nbyte else None
        self.on_failure = on_failure
        self.max_restarts = max_restarts
        self.sink = sink
        kind = self.source.get('kind')
        if kind is not None and kind not in SOURCE_KINDS:
            raise ValueError("unknown source kind %r (expected one of "
                             "%s)" % (kind, ', '.join(SOURCE_KINDS)))

    @classmethod
    def coerce(cls, spec):
        if isinstance(spec, cls):
            return spec
        if isinstance(spec, dict):
            unknown = set(spec) - set(cls._FIELDS)
            if unknown:
                raise ValueError("unknown tenant spec field(s): %s"
                                 % ', '.join(sorted(unknown)))
            return cls(**spec)
        raise TypeError("tenant spec must be a TenantSpec or dict, "
                        "got %s" % type(spec).__name__)

    def as_dict(self):
        out = {}
        for f in self._FIELDS:
            v = getattr(self, f)
            if v not in (None, {}, 0, 0.0) or f in ('id', 'priority',
                                                    'ncores'):
                out[f] = v
        return out

    def __repr__(self):
        return 'TenantSpec(%s)' % ', '.join(
            '%s=%r' % (k, v) for k, v in sorted(self.as_dict().items()))


# ---------------------------------------------------------------------------
# service blocks
# ---------------------------------------------------------------------------

class SyntheticSource(SourceBlock):
    """Paced deterministic f32 stream — the 'synthetic' tenant source
    (load generation, chaos drills, tests).  ``tick_s`` seconds of
    sleep per gulp pace the stream like a live capture; ``seed`` makes
    the payload reproducible so sinks can assert byte-correctness."""

    def __init__(self, nframe_total, gulp_nframe, nchan=16, seed=0,
                 tick_s=0.0, start_frame=0, tsamp=None,
                 name_prefix='synthetic', *args, **kwargs):
        super(SyntheticSource, self).__init__(
            [name_prefix], gulp_nframe, *args, **kwargs)
        self.nframe_total = int(nframe_total)
        self.nchan = int(nchan)
        self.seed = int(seed)
        self.tick_s = float(tick_s)
        #: declared real-time frame cadence (seconds/frame).  The SLO
        #: age math extrapolates a frame's capture instant from the
        #: header tsamp, so a stream that MEANS "100 frames/s" must
        #: say so or a quota-paced consumer looks progressively stale
        #: against the sequence origin (the scheduler's arbiter).
        self.tsamp = None if tsamp is None else float(tsamp)
        #: resume support: a migrated tenant
        #: replays only the frames its downstream never committed —
        #: the scheduler sets this from the durable AckLedger frontier
        self.start_frame = max(int(start_frame), 0)

    @staticmethod
    def payload(nframe_total, nchan, seed):
        """The exact stream a (nframe_total, nchan, seed) source
        emits — sinks verify byte-correctness against this."""
        rng = np.random.RandomState(seed)
        return rng.randn(nframe_total, nchan).astype(np.float32)

    def create_reader(self, sourcename):
        class _R(object):
            def __enter__(self):
                return self

            def __exit__(self, *exc):
                return False
        return _R()

    def _header(self, sourcename):
        ts = self.tsamp if self.tsamp else 1e-6
        return {'name': sourcename,
                'tsamp': ts,
                '_tensor': {'shape': [-1, self.nchan], 'dtype': 'f32',
                            'labels': ['time', 'chan'],
                            'scales': [[0, ts], [0, 1]],
                            'units': ['s', None]}}

    def static_oheaders(self):
        return [self._header(self.sourcenames[0])]

    def on_sequence(self, reader, sourcename):
        self._data = self.payload(self.nframe_total, self.nchan,
                                  self.seed)
        self._pos = min(self.start_frame, self.nframe_total)
        return [self._header(sourcename)]

    def on_data(self, reader, ospans):
        if self._pos >= self.nframe_total:
            return [0]
        if self.tick_s > 0:
            # interruptible pacing: shutdown cancels the tick
            if self.shutdown_event.wait(self.tick_s):
                return [0]
        ospan = ospans[0]
        n = min(ospan.nframe, self.nframe_total - self._pos)
        ospan.data.as_numpy()[:n] = self._data[self._pos:self._pos + n]
        self._pos += n
        return [n]


class QuotaGate(TransformBlock):
    """Per-tenant admission control at the ingest boundary: a token
    bucket (the bridge sender's quota machinery, re-used at gulp
    granularity) refilling at ``quota_bytes_per_s``.

    - policy **'shed'**: a gulp the bucket cannot cover is refused —
      0 frames committed downstream, counted on
      ``service.<id>.quota_shed_gulps`` / ``.quota_shed_bytes`` (the
      tenant-level analogue of a ring drop policy's counted loss);
    - policy **'pace'**: every gulp passes but the gate sleeps the
      bucket debt first (rate limiting, never loss).

    With no quota the gate is a plain counted copy, which every tenant
    still routes through: ``service.<id>.admitted_gulps/bytes`` are
    the tenant's throughput ledger, and the gate stamps the job's
    first-data instant (the warm/cold start-latency measurement).
    The bucket's burst capacity is ``quota * BF_SERVE_QUOTA_BURST``
    seconds (default 0.1 — one short burst, so a measured rate
    converges on the quota within a few seconds)."""

    def __init__(self, iring, tenant_id, quota_bytes_per_s=0,
                 policy='shed', job=None, *args, **kwargs):
        super(QuotaGate, self).__init__(iring, *args, **kwargs)
        self.tenant_id = str(tenant_id)
        self.quota_bytes_per_s = max(float(quota_bytes_per_s or 0), 0.0)
        if policy not in QUOTA_POLICIES:
            raise ValueError("unknown quota policy %r" % (policy,))
        self.policy = policy
        self._job = job
        self._bucket = None

    def define_valid_input_spaces(self):
        return ('system',)

    def on_sequence(self, iseq):
        return dict(iseq.header)

    def retune(self, quota_bytes_per_s):
        """Live quota change (the scheduler's cross-tenant arbiter):
        the refill rate moves immediately; the burst capacity keeps
        its one-gulp floor so a 'shed' stream never deadlocks on its
        own span size.  Counted on ``service.<id>.quota_retunes``."""
        new = max(float(quota_bytes_per_s or 0), 0.0)
        self.quota_bytes_per_s = new
        bucket = self._bucket
        if bucket is not None:
            if new <= 0:
                self._bucket = None    # unlimited: plain counted copy
            else:
                burst = max(_env_float('BF_SERVE_QUOTA_BURST', 0.1),
                            1e-3)
                bucket.rate = new
                # _take restores the one-gulp capacity floor on the
                # next span, so a shrink cannot strand the stream
                bucket.capacity = max(new * burst, 1.0)
                bucket.tokens = min(bucket.tokens, bucket.capacity)
        counters.inc('service.%s.quota_retunes' % self.tenant_id)

    def _take(self, nbyte):
        """True when the gulp is admitted (sleeping the debt under
        'pace'); False when 'shed' refuses it."""
        if self.quota_bytes_per_s <= 0:
            return True
        if self._bucket is None:
            # lazily built at FIRST data so the burst window starts
            # with the stream, not at submit time.  Capacity is the
            # burst window OR one gulp, whichever is larger: a bucket
            # that can never hold one gulp would shed 100% of a
            # 'shed'-policy stream no matter how low the actual rate
            # is — with the floor, any gulp is admittable once the
            # bucket refills, and the sustained rate is still bounded
            # by the refill (the BF-E211 check guards the case where
            # even that refill takes over a second per gulp)
            from .io.bridge import _TokenBucket
            burst = max(_env_float('BF_SERVE_QUOTA_BURST', 0.1), 1e-3)
            self._bucket = _TokenBucket(
                self.quota_bytes_per_s,
                capacity=max(self.quota_bytes_per_s * burst, nbyte))
        elif self._bucket.capacity < nbyte:
            # gulp geometry grew mid-stream (a new sequence with a
            # larger gulp): keep the one-gulp floor or the 'shed'
            # policy would refuse every oversized gulp forever
            self._bucket.capacity = float(nbyte)
        if self.policy == 'pace':
            debt = self._bucket.take_with_debt(nbyte)
            while debt > 0 and not self.shutdown_event.is_set():
                step = min(debt, 0.05)
                time.sleep(step)
                debt -= step
            return True
        return self._bucket.admit(nbyte)

    def on_data(self, ispan, ospan):
        if self._job is not None:
            self._job.note_first_data()
        data = ispan.data.as_numpy()
        nbyte = data.nbytes
        if not self._take(nbyte):
            counters.inc('service.%s.quota_shed_gulps' % self.tenant_id)
            counters.inc('service.%s.quota_shed_bytes' % self.tenant_id,
                         nbyte)
            return 0
        _copy_host(ospan.data.as_numpy(), data)
        counters.inc('service.%s.admitted_gulps' % self.tenant_id)
        counters.inc('service.%s.admitted_bytes' % self.tenant_id,
                     nbyte)
        return None


def _copy_host(dst, src):
    """``dst[...] = src`` for host spans.  Contiguous spans copy as bytes:
    numpy copies structured types (``ci8``) element by element."""
    if dst.flags.c_contiguous and src.flags.c_contiguous and \
            dst.dtype == src.dtype and dst.shape == src.shape:
        dst.reshape(-1).view(np.uint8)[...] = \
            src.reshape(-1).view(np.uint8)
    else:
        np.copyto(dst, src)


class DiscardSink(SinkBlock):
    """Terminal sink for declarative tenant workloads: consumes (and
    counts) the stream.  The per-tenant SLO exit ages still record —
    SinkBlock's exit-age observation runs on every gulp."""

    def on_sequence(self, iseq):
        pass

    def on_data(self, ispan):
        pass


# ---------------------------------------------------------------------------
# source builders
# ---------------------------------------------------------------------------

class _UdpCapturePump(object):
    """Owns a UDP capture feeding a ring (io/packet_capture.py) plus
    the pump thread driving it — the service-side lifecycle for the
    'udp' source kind.  ``stop()`` ends the capture cleanly so the
    tenant pipeline drains and exits."""

    def __init__(self, src, tenant_id):
        from .ring import Ring
        from .io.udp_socket import Address, UDPSocket
        from .io.packet_capture import (UDPCapture, ShardedUDPCapture,
                                        PacketCaptureCallback)
        nsrc = int(src.get('nsrc', 1))
        payload = int(src.get('payload', 1024))
        buf_ntime = int(src.get('buffer_ntime', 64))
        # sharded wire-rate capture knobs:
        # capture_threads > 1 builds a ShardedUDPCapture with that many
        # REUSEPORT workers; capture_vlen sizes its recvmmsg batches
        nthreads = int(src.get('capture_threads', 1))
        vlen = src.get('capture_vlen')
        timeout = float(src.get('timeout_s', 0.25))
        addr = Address(src.get('address', '0.0.0.0'),
                       int(src.get('port', 0)))
        if nthreads > 1:
            self._sock = None
        else:
            self._sock = UDPSocket().bind(addr)
            self._sock.set_timeout(timeout)
        self.ring = Ring(space='system',
                         name='tenant.%s.capture' % tenant_id)

        def _hdr(_desc):
            return 0, {'name': 'tenant.%s.udp' % tenant_id,
                       '_tensor': {'shape': [-1, nsrc, payload],
                                   'dtype': 'u8',
                                   'labels': ['time', 'src', 'byte'],
                                   'scales': [[0, 1]] * 3,
                                   'units': [None] * 3}}
        cb = PacketCaptureCallback()
        cb.set_chips(_hdr)
        if nthreads > 1:
            self._capture = ShardedUDPCapture(
                src.get('format', 'chips'), addr, self.ring, nsrc, 0,
                payload, buf_ntime, buf_ntime, cb, nthreads=nthreads,
                vlen=int(vlen) if vlen else None, timeout=timeout)
            self.port = \
                self._capture._socks[0].sock.getsockname()[1]
        else:
            self._capture = UDPCapture(src.get('format', 'chips'),
                                       self._sock, self.ring, nsrc, 0,
                                       payload, buf_ntime, buf_ntime, cb)
            self.port = self._sock.sock.getsockname()[1]
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._pump, name='bf-serve-udp-%s' % tenant_id,
            daemon=True)

    def _pump(self):
        # NO_DATA / INTERRUPTED are socket timeouts (before / inside a
        # sequence) — a LIVE capture keeps listening through gaps; only
        # stop() ends the stream (capture.end flushes + EODs the ring)
        try:
            while not self._stop.is_set():
                self._capture.recv()
        finally:
            try:
                self._capture.end()
            except Exception:
                pass

    def start(self):
        self._thread.start()

    def stop(self, timeout=5.0):
        """Safe at ANY lifecycle point: before start() (a cancelled
        PENDING job, bf_serve --validate teardown) it just ends the
        capture and releases the bound port."""
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout)
        else:
            try:
                self._capture.end()
            except Exception:
                pass
        if self._sock is not None:
            try:
                self._sock.close()
            except Exception:
                pass


def _build_source(spec, job):
    """Materialize the spec's declarative source inside the tenant
    pipeline scope.  Returns ``(block_or_ring, pump_or_None)``."""
    src = dict(spec.source)
    kind = src.pop('kind', None)
    if kind == 'replay':
        from .blocks.serialize import DeserializeBlock
        return DeserializeBlock(
            list(src.get('basenames') or src.get('filenames') or []),
            int(src.get('gulp_nframe') or spec.gulp_nframe or 1),
            loop=int(src.get('loop', 1)),
            restamp=bool(src.get('restamp', True))), None
    if kind == 'file':
        from .blocks.binary_io import BinaryFileReadBlock
        return BinaryFileReadBlock(
            list(src.get('paths') or src.get('filenames') or []),
            int(src['gulp_size']),
            int(src.get('gulp_nframe') or spec.gulp_nframe or 1),
            src.get('dtype', 'u8')), None
    if kind == 'synthetic':
        return SyntheticSource(
            int(src.get('nframe_total', 1024)),
            int(src.get('gulp_nframe') or spec.gulp_nframe or 64),
            nchan=int(src.get('nchan', 16)),
            seed=int(src.get('seed', 0)),
            tick_s=float(src.get('tick_s', 0.0)),
            start_frame=int(src.get('start_frame', 0)),
            tsamp=src.get('tsamp')), None
    if kind == 'udp':
        pump = _UdpCapturePump(src, spec.id)
        return pump.ring, pump
    if kind == 'ring':
        ring = src.get('ring')
        if ring is None:
            raise ValueError("source kind 'ring' needs a 'ring' entry "
                             "(tenant %s)" % spec.id)
        return ring, None
    raise ValueError("tenant %s: source kind %r is not buildable "
                     "(expected one of %s)"
                     % (spec.id, kind, ', '.join(SOURCE_KINDS)))


# ---------------------------------------------------------------------------
# warm-start registry
# ---------------------------------------------------------------------------

#: topology hash -> {'plan_sigs': {bkey: sig}, 'depots': {bkey: dict},
#: 'knobs': {...}} — process-local warm state harvested from finished
#: jobs
_WARM = {}
_warm_lock = threading.Lock()


def reset_warm_registry():
    """Drop all harvested warm state (tests)."""
    with _warm_lock:
        _WARM.clear()


def _plan_signatures(pipeline, bmap):
    """{structural block key: plan signature} over every plan-caching
    block (FusedBlock today).  A None signature marks a block whose
    stage math carries non-scalar state — its plans are never shared
    across jobs."""
    out = {}
    for b in pipeline.blocks:
        sig_fn = getattr(b, 'plan_signature', None)
        if sig_fn is None:
            continue
        out[bmap.get(b.name, b.name)] = sig_fn()
    return out


def _harvest_knobs(pipeline):
    """The converged/hand-set tuning knobs of a finished pipeline, in
    ``autotune.apply_profile``'s knob format — what a warm start pins
    so the next identical job skips convergence."""
    from .pipeline import resolve_sync_depth
    from .macro import resolve_gulp_batch
    return {'sync_depth': resolve_sync_depth(pipeline),
            'gulp_batch': resolve_gulp_batch(pipeline)}


def _warm_floors_violate(pipeline, knobs):
    """Would adopting a harvested profile's geometry knobs push a
    ring-capacity floor past THIS build's verifier bound?  Matching
    plan signatures prove the topology is identical, but the TARGET
    host may declare smaller rings than the harvest host did (a
    migration lands on whatever the survivor provisioned) — a warm
    start must not import a gulp_batch/window the local verifier
    rejects (BF-E101 and friends).  Same ``scope_overrides`` +
    ``new_errors_vs`` gate as ``autotune._profile_safe``."""
    from .analysis import verify
    overrides = {}
    try:
        gb = (knobs or {}).get('gulp_batch')
        if gb is not None and int(gb) > 1:
            overrides['gulp_batch'] = int(gb)
    except (TypeError, ValueError):
        pass
    windows = (knobs or {}).get('bridge_window') or {}
    if isinstance(windows, dict) and windows:
        # v2 profiles key by structural key — translate to the LIVE
        # block names the verifier's checks match against
        try:
            from .autotune import topology_signature
            _sig, bmap, _rmap = topology_signature(pipeline)
            live = {v: k for k, v in bmap.items()}
        except Exception:
            live = {}
        overrides['bridge_window'] = {
            live.get(key, key): w for key, w in windows.items()}
    if not overrides:
        return False
    try:
        baseline = verify.verify_pipeline(pipeline)
        with verify.scope_overrides(overrides):
            cand = verify.verify_pipeline(pipeline)
    except Exception:
        return False              # never let the gate kill admission
    return bool(verify.new_errors_vs(baseline, cand))


# ---------------------------------------------------------------------------
# jobs
# ---------------------------------------------------------------------------

class Job(object):
    """One submitted tenant pipeline and its service-side lifecycle.

    ``state`` walks PENDING -> RUNNING -> DONE | FAILED | CANCELLED;
    a fatal tenant failure lands on ``error`` (the
    PipelineRuntimeError) and NEVER propagates to other jobs — the
    blast radius is this job's own rings and supervisor."""

    def __init__(self, spec, manager):
        self.spec = spec
        self.manager = manager
        self.state = 'PENDING'
        self.error = None
        self.warm = False
        self.warm_rejected = False
        self.pipeline = None
        self.cores = []
        self.topology_hash = None
        self._plan_sigs = {}
        self._depots = {}
        self._pump = None
        self._thread = None
        self._lock = threading.Lock()
        self.submitted_at = time.time()
        self.run_started_at = None
        self.first_data_at = None
        self.finished_at = None

    # -- construction ------------------------------------------------------
    def _build(self, build):
        spec = self.spec
        kwargs = {}
        if spec.gulp_nframe:
            kwargs['gulp_nframe'] = spec.gulp_nframe
        if spec.overload_policy:
            kwargs['overload_policy'] = spec.overload_policy
        if spec.on_failure:
            kwargs['on_failure'] = spec.on_failure
        if spec.max_restarts is not None:
            kwargs['max_restarts'] = spec.max_restarts
        p = Pipeline(name='tenant.%s' % spec.id, **kwargs)
        with p:
            src, self._pump = _build_source(spec, self)
            gate = QuotaGate(src, spec.id,
                             quota_bytes_per_s=spec.quota_bytes_per_s,
                             policy=spec.quota_policy, job=self)
            if build is not None:
                build(gate)
            elif spec.sink == 'serialize':
                from .blocks.serialize import SerializeBlock
                SerializeBlock(gate, path=spec.source.get('out_path',
                                                          ''))
            else:
                DiscardSink(gate)
        self.pipeline = p
        return p

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        with self._lock:
            if self._thread is not None or self.state != 'PENDING' \
                    or self.pipeline is None:
                return self
            self._thread = threading.Thread(
                target=self._run, name='bf-serve-%s' % self.spec.id,
                daemon=True)
            self.state = 'RUNNING'
            self._thread.start()
        return self

    def _run(self):
        self.run_started_at = time.monotonic()
        self._note_fleet('RUNNING')
        if self._pump is not None:
            self._pump.start()
        try:
            # autotune stays OFF unless the environment asks: tenant
            # convergence comes from the warm profile, and a per-job
            # controller would fight its siblings over global signals
            self.pipeline.run(autotune=False)
        except BaseException as exc:    # noqa: BLE001 — full isolation
            self.error = exc
            self.state = 'FAILED'
        else:
            self.state = 'DONE'
        finally:
            self.finished_at = time.monotonic()
            self._note_fleet(self.state)
            try:
                self.manager._job_finished(self)
            except Exception:
                pass

    def _note_fleet(self, state):
        """Tenant state transitions ride the fleet event side-channel
        (telemetry.fleet) so the collector's rollup — and absence
        alerts on this tenant — react within a tick instead of a
        snapshot interval.  No-op outside a fleet-armed process."""
        try:
            from .telemetry import fleet
            fleet.note_event('tenant', {'tenant': self.spec.id,
                                        'state': state})
        except Exception:
            pass

    def note_first_data(self):
        if self.first_data_at is None:
            self.first_data_at = time.monotonic()

    @property
    def start_latency_s(self):
        """Run-start to first admitted gulp — the warm-vs-cold start
        metric (compile + convergence are what a warm start skips)."""
        if self.run_started_at is None or self.first_data_at is None:
            return None
        return self.first_data_at - self.run_started_at

    def wait(self, timeout=None):
        t = self._thread
        if t is not None:
            t.join(timeout)
        return self.state

    def stop(self, timeout=5.0):
        """Wind the tenant down: stop its capture pump (if any) and
        shut its pipeline's blocks down.  Never touches other jobs."""
        if self._pump is not None:
            self._pump.stop(timeout)
        if self.pipeline is not None and self.state == 'RUNNING':
            try:
                self.pipeline.shutdown()
            except Exception:
                pass
        if self.state == 'PENDING':
            self.state = 'CANCELLED'
        self.wait(timeout)
        return self.state

    # -- observability -----------------------------------------------------
    def health(self):
        if self.pipeline is None:
            return {'state': 'OK', 'blocks': {}, 'transitions': []}
        return self.pipeline.health()

    def rings(self):
        out = {}
        for b in self.pipeline.blocks if self.pipeline else []:
            for r in (list(getattr(b, 'orings', ()) or ()) +
                      list(getattr(b, 'irings', ()) or ())):
                base = getattr(r, '_base_ring', r)
                out[base.name] = base
        return out

    def trace_ids(self):
        """Stream trace ids live in this tenant's blocks — the keys
        the per-tenant SLO rollup joins on."""
        ids = []
        for b in self.pipeline.blocks if self.pipeline else []:
            ctx = getattr(b, '_trace_ctx', None)
            if isinstance(ctx, dict) and ctx.get('id') and \
                    ctx['id'] not in ids:
                ids.append(ctx['id'])
        return ids

    def slo_rollup(self):
        """Per-tenant SLO view: the worst sink exit-age p99 across
        this tenant's blocks, its violation total, the tenant budget,
        and whether the rollup currently meets it."""
        p99 = None
        violations = 0
        for b in self.pipeline.blocks if self.pipeline else []:
            violations += counters.get('slo.%s.violations' % b.name)
            h = histograms.get('slo.%s.exit_age_s' % b.name)
            if h is not None and h.count:
                v = h.percentile(99)
                p99 = v if p99 is None else max(p99, v)
        out = {'exit_age_p99_s': p99, 'violations': violations,
               'budget_ms': self.spec.slo_ms,
               'trace_ids': self.trace_ids()}
        if self.spec.slo_ms is not None and p99 is not None:
            out['ok'] = bool(p99 * 1e3 <= self.spec.slo_ms)
        return out

    def stats(self):
        tid = self.spec.id
        shed_gulps = shed_bytes = 0
        poisoned = 0
        for name, ring in self.rings().items():
            s = ring.shed_stats()
            shed_gulps += s.get('shed_gulps', 0)
            shed_bytes += s.get('shed_bytes', 0)
            try:
                poisoned += int(bool(ring.poisoned))
            except Exception:
                pass
        health = self.health()
        out = {
            'state': self.state,
            'health': health.get('state', '?'),
            'priority': self.spec.priority,
            'cores': list(self.cores),
            'warm': int(self.warm),
            'warm_rejected': int(self.warm_rejected),
            'gulps': counters.get('service.%s.admitted_gulps' % tid),
            'bytes': counters.get('service.%s.admitted_bytes' % tid),
            'quota_bytes_per_s': self.spec.quota_bytes_per_s,
            'quota_shed_gulps':
                counters.get('service.%s.quota_shed_gulps' % tid),
            'quota_shed_bytes':
                counters.get('service.%s.quota_shed_bytes' % tid),
            'ring_shed_gulps': shed_gulps,
            'ring_shed_bytes': shed_bytes,
            'rings_poisoned': poisoned,
            'slo': self.slo_rollup(),
        }
        if self.start_latency_s is not None:
            out['start_latency_s'] = round(self.start_latency_s, 6)
        if self.error is not None:
            out['error'] = '%s: %s' % (type(self.error).__name__,
                                       self.error)
        return out


# ---------------------------------------------------------------------------
# the manager
# ---------------------------------------------------------------------------

#: process-wide registry the telemetry snapshot reads (live AND
#: finished jobs of every manager, insertion-ordered)
_REGISTRY = OrderedDict()
_registry_lock = threading.Lock()
#: finished (DONE/FAILED/CANCELLED) jobs retained for post-mortem
#: reading; beyond this the oldest finished jobs are evicted so a
#: long-running service does not pin every dead tenant's pipeline
#: (rings and their buffers) for the life of the process.  The warm
#: registry is unaffected — harvested plan depots outlive the Job.
REGISTRY_KEEP_FINISHED = 64


def _register(job):
    with _registry_lock:
        _REGISTRY[job.spec.id] = job
        finished = [tid for tid, j in _REGISTRY.items()
                    if j.state not in ('PENDING', 'RUNNING')]
        for tid in finished[:max(len(finished)
                                 - REGISTRY_KEEP_FINISHED, 0)]:
            del _REGISTRY[tid]


def live_jobs():
    """All registered tenant jobs, submit-ordered ({tenant_id: Job})."""
    with _registry_lock:
        return OrderedDict(_REGISTRY)


def reset_registry():
    """Drop the process-wide job registry (tests)."""
    with _registry_lock:
        _REGISTRY.clear()


def telemetry_section():
    """The ``tenants`` section of ``telemetry.snapshot()``: one stats
    dict per registered tenant (state, health, admitted/shed ledgers,
    SLO rollup keyed by trace ids, warm-start latency)."""
    out = {}
    for tid, job in live_jobs().items():
        try:
            out[tid] = job.stats()
        except Exception:
            out[tid] = {'state': job.state}
    return out


class JobManager(object):
    """Runs N concurrent tenant pipelines on this host.

    ``max_tenants`` bounds concurrently admitted (unfinished) jobs
    (``BF_SERVE_MAX_TENANTS``, default 8); ``cores`` is the core pool
    partitioned across tenants (default: this process's affinity
    mask); ``warm`` enables the warm-start registry
    (``BF_SERVE_WARM`` != '0').  ``strict`` (default True) refuses
    submissions whose combined spec fails ``verify_service`` with a
    BF-E diagnostic."""

    def __init__(self, max_tenants=None, cores=None, warm=None,
                 strict=True):
        self.max_tenants = max_tenants if max_tenants is not None \
            else _env_int('BF_SERVE_MAX_TENANTS', 8)
        if cores is None:
            cores = affinity.available_cores()
        self.cores = list(cores)
        self.warm_enabled = (os.environ.get('BF_SERVE_WARM', '1')
                             != '0') if warm is None else bool(warm)
        self.strict = strict
        self._jobs = OrderedDict()
        self._lock = threading.Lock()
        self._proclog = None
        self._ticker = None
        self._stop_ticker = threading.Event()

    # -- admission ---------------------------------------------------------
    def _active_jobs(self):
        return [j for j in self._jobs.values()
                if j.state in ('PENDING', 'RUNNING')]

    def submit(self, spec, build=None):
        """Admit and BUILD a tenant job (it does not run until
        :meth:`start`).  ``build(gate)`` extends the tenant chain past
        the quota gate and must terminate it (attach a sink); without
        it the spec's declarative ``sink`` applies.

        Raises :class:`ServiceAdmissionError` on duplicate id or
        capacity, :class:`ServiceSpecError` when the combined service
        spec fails static validation (BF-E210/BF-E211)."""
        spec = TenantSpec.coerce(spec)
        job = Job(spec, self)
        # reserve the tenant slot ATOMICALLY with the duplicate and
        # capacity checks: a concurrent submit must not slip past
        # either while this one is still building (the build itself
        # runs outside the lock — it calls user code)
        with self._lock:
            prev = self._jobs.get(spec.id)
            if prev is None:
                # tenant ids are unique per PROCESS, not per manager:
                # the counter namespaces, the [tenants] pane, and the
                # job registry are all process-wide, so another live
                # manager's tenant blocks the id too
                with _registry_lock:
                    prev = _REGISTRY.get(spec.id)
            if prev is not None and prev.state in ('PENDING',
                                                   'RUNNING'):
                counters.inc('service.admission.rejected')
                raise ServiceAdmissionError(
                    "tenant %r is already admitted (BF-E210: tenant "
                    "ids are unique per service)" % spec.id)
            nactive = len(self._active_jobs())
            if nactive >= self.max_tenants:
                counters.inc('service.admission.rejected')
                raise ServiceAdmissionError(
                    "capacity: %d tenant(s) active, max_tenants=%d "
                    "(BF_SERVE_MAX_TENANTS)"
                    % (nactive, self.max_tenants))
            # PENDING placeholders in BOTH maps: the slow build below
            # runs unlocked, and a concurrent submit (this manager or
            # another in the process) must already see the id taken
            self._jobs[spec.id] = job
            with _registry_lock:
                _REGISTRY[spec.id] = job
        try:
            # static spec check over the WHOLE service (the
            # submit-time capacity/quota lint, BF-E21x)
            from .analysis.verify import verify_service
            with self._lock:
                specs = [j.spec for j in self._active_jobs()]
            diags = verify_service(specs, ncores=len(self.cores))
            errs = [d for d in diags if d.is_error]
            if errs and self.strict:
                counters.inc('service.admission.rejected')
                raise ServiceSpecError(errs)
            for d in diags:
                if not d.is_error:
                    import sys
                    sys.stderr.write('bf_serve: %r\n' % d)
            job._build(build)
        except BaseException:
            with self._lock:
                if self._jobs.get(spec.id) is job:
                    del self._jobs[spec.id]
                with _registry_lock:
                    if _REGISTRY.get(spec.id) is job:
                        del _REGISTRY[spec.id]
            raise
        counters.inc('service.submitted')
        self._partition_cores()
        self._attach_warm(job)
        _register(job)
        self._publish()
        return job

    # -- scheduling --------------------------------------------------------
    def _partition_cores(self):
        """(Re)partition the host core pool across unfinished tenants,
        priority-weighted (affinity.partition_cores), and spread each
        tenant's share round-robin over its blocks.  Counted on
        ``service.affinity.applied`` / ``.skipped``.

        Only PENDING jobs receive new pins: a RUNNING tenant's block
        threads pinned themselves at thread start (``Block.run``) and
        re-writing their ``core`` tunables would change the reported
        share without moving any thread — running jobs keep the share
        they launched with (still weighed in the partition, so new
        tenants are placed around them) until they restart."""
        with self._lock:
            jobs = self._active_jobs()
        jobs = [j for j in jobs if j.pipeline is not None]
        if not jobs:
            return {}
        weights = OrderedDict((j.spec.id,
                               j.spec.priority * max(j.spec.ncores, 1))
                              for j in jobs)
        shares = affinity.partition_cores(weights, cores=self.cores)
        for j in jobs:
            if j.state != 'PENDING':
                continue
            share = shares.get(j.spec.id) or []
            j.cores = list(share)
            for i, b in enumerate(j.pipeline.blocks):
                # an explicit core= tunable set by the tenant's build
                # callable outranks the partition (the operator pinned
                # that block deliberately); only service-assigned pins
                # (marked _svc_core) are re-writable on repartition
                if b.__dict__.get('_core') is not None and \
                        not getattr(b, '_svc_core', False):
                    counters.inc('service.affinity.skipped')
                    continue
                if share:
                    b._core = share[i % len(share)]
                    b._svc_core = True
                    counters.inc('service.affinity.applied')
                else:
                    counters.inc('service.affinity.skipped')
        return shares

    # -- warm start --------------------------------------------------------
    def _attach_warm(self, job):
        from .autotune import topology_signature
        sig, bmap, _rmap = topology_signature(job.pipeline)
        job.topology_hash = sig
        job._plan_sigs = _plan_signatures(job.pipeline, bmap)
        if not self.warm_enabled:
            return
        # always attach depots (a cold job DEPOSITS what it compiles;
        # a warm job replays a previous job's deposits)
        with _warm_lock:
            ws = _WARM.get(sig)
        if ws is not None:
            stale = (ws['plan_sigs'] != job._plan_sigs or
                     any(v is None for v in job._plan_sigs.values()))
            # signatures alone are not sufficient: the profile's
            # geometry knobs must also clear THIS host's ring-capacity
            # floors (a migration target may provision smaller rings
            # than the harvest host)
            if not stale and _warm_floors_violate(job.pipeline,
                                                  ws.get('knobs')):
                stale = True
            if stale:
                job.warm_rejected = True
                counters.inc('service.warm.rejected_stale')
                ws = None
        job._depots = dict(ws['depots']) if ws else {}
        for b in job.pipeline.blocks:
            if not hasattr(b, 'plan_signature'):
                continue
            bkey = bmap.get(b.name, b.name)
            depot = job._depots.setdefault(bkey, {})
            b._plan_depot = depot
        if ws is not None:
            job.warm = True
            counters.inc('service.warm.hits')
            knobs = ws.get('knobs')
            if knobs:
                from .autotune import adopt_profile
                try:
                    adopt_profile(job.pipeline, knobs)
                except Exception:
                    # plans are still warm; the knob half failed — do
                    # not report a clean adoption (profile_adoptions
                    # only counts successes), and leave an audit trail
                    counters.inc('service.warm.adopt_errors')

    def _job_finished(self, job):
        """Run-thread exit hook: harvest warm state from a clean run
        (plan depots + tuned knobs, keyed by topology hash) and
        refresh the published pane."""
        if self.warm_enabled and job.state == 'DONE' and \
                job.topology_hash and \
                not any(v is None for v in job._plan_sigs.values()):
            with _warm_lock:
                _WARM[job.topology_hash] = {
                    'plan_sigs': dict(job._plan_sigs),
                    'depots': dict(job._depots),
                    'knobs': _harvest_knobs(job.pipeline),
                }
        self._publish()

    # -- lifecycle ---------------------------------------------------------
    def start(self, tenant_id=None):
        """Start one PENDING job (or all of them) and the service
        status ticker."""
        with self._lock:
            jobs = [self._jobs[tenant_id]] if tenant_id is not None \
                else list(self._jobs.values())
        for j in jobs:
            if j.state == 'PENDING':
                j.start()
        self._start_ticker()
        return jobs

    def wait(self, timeout=None):
        """Join every started job; returns {tenant_id: state}."""
        deadline = None if timeout is None else \
            time.monotonic() + timeout
        for j in list(self._jobs.values()):
            t = None if deadline is None else \
                max(deadline - time.monotonic(), 0)
            j.wait(t)
        self._publish()
        return {tid: j.state for tid, j in self._jobs.items()}

    def shutdown(self, timeout=5.0):
        """Stop every tenant (pumps first, then pipelines) and the
        ticker.  Jobs keep their final states/ledgers for reading."""
        for j in list(self._jobs.values()):
            try:
                j.stop(timeout)
            except Exception:
                pass
        self._stop_ticker.set()
        if self._ticker is not None:
            self._ticker.join(timeout)
            self._ticker = None
        self._publish()

    def jobs(self):
        with self._lock:
            return list(self._jobs.values())

    def job(self, tenant_id):
        with self._lock:
            return self._jobs.get(tenant_id)

    # -- publication -------------------------------------------------------
    def _start_ticker(self):
        if self._ticker is not None and self._ticker.is_alive():
            return
        interval = max(_env_float('BF_SERVE_PUBLISH_INTERVAL', 1.0),
                       0.1)
        self._stop_ticker.clear()

        def loop():
            while not self._stop_ticker.wait(interval):
                self._publish()
                # idle auto-stop: once nothing is pending/running the
                # final row set is on disk — a ticker outliving its
                # jobs would only burn a thread (start() re-arms it)
                if not any(j.state in ('PENDING', 'RUNNING')
                           for j in live_jobs().values()):
                    return
        self._ticker = threading.Thread(target=loop,
                                        name='bf-serve-publish',
                                        daemon=True)
        self._ticker.start()

    def _publish(self):
        """The ``service/tenants`` ProcLog pane ``tools/like_top.py``
        renders: one flattened row set per tenant.  Publishes the
        PROCESS-WIDE job registry (not just this manager's jobs) — the
        pane file is per process, so concurrent managers must write
        the union instead of clobbering each other."""
        try:
            if self._proclog is None:
                self._proclog = ProcLog('service/tenants')
            jobs = live_jobs()
            entry = {'ntenants': len(jobs)}
            for tid, job in jobs.items():
                try:
                    s = job.stats()
                except Exception:
                    s = {'state': job.state}
                entry['t.%s.state' % tid] = s.get('state', '?')
                entry['t.%s.health' % tid] = s.get('health', '?')
                entry['t.%s.gulps' % tid] = s.get('gulps', 0)
                entry['t.%s.q_shed' % tid] = s.get('quota_shed_gulps',
                                                   0)
                entry['t.%s.warm' % tid] = s.get('warm', 0)
                p99 = (s.get('slo') or {}).get('exit_age_p99_s')
                if p99 is not None:
                    entry['t.%s.age99_ms' % tid] = round(p99 * 1e3, 3)
            self._proclog.update(entry, force=True)
        except Exception:
            pass
