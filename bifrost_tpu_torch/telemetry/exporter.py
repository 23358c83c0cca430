"""Unified metrics snapshot and its exporters (the JAX package's
``bifrost_tpu/telemetry/exporter.py``).

:func:`snapshot` merges the counters, the log2 histograms, the rings'
occupancy, the cards' memory and the mesh counters into one plain dict,
and two exporters publish it:

- **ProcLog**: :class:`MetricsPublisher` (started by ``Pipeline.run``)
  writes ``telemetry/metrics`` (flat counters and histogram percentiles),
  one ``rings_flow/<name>`` entry a ring (occupancy %, gulps, gulps/s,
  wait percentiles) and one ``devices/<index>`` entry a card, every
  ``BF_METRICS_INTERVAL`` seconds (default 5) and once more at the end.
- **Prometheus textfile**: with ``BF_METRICS_FILE=/path/metrics.prom``
  each publish also writes the snapshot in the Prometheus text format
  (counters as ``bifrost_tpu_counter_total{name=...}``, histograms as
  cumulative ``_bucket{le=...}`` / ``_sum`` / ``_count``, ring occupancy
  and card memory as gauges), under the JAX package's metric names.

The JAX package's tenant and scheduler sections wait for the port's
service and scheduler tiers.  A publisher failure never reaches the
pipeline.
"""
from __future__ import annotations

import os
import threading

from . import counters, histograms, spans

__all__ = ['snapshot', 'write_prometheus', 'prometheus_text',
           'MetricsPublisher', 'RateTracker']

DEFAULT_INTERVAL = 5.0


class RateTracker(object):
    """Derives per-second rates from the deltas between successive
    snapshots (docs/autotune.md; the closed-loop auto-tuner's signal
    source, and what the metrics publisher's ``gulps_per_s`` columns
    are computed from instead of ad-hoc last-value bookkeeping).

    Each caller that needs an independent cadence owns its own
    tracker (``snapshot(rates=my_tracker)``); ``snapshot(rates=True)``
    uses a shared module-level one, fine for a single consumer.  The
    first observation has no baseline and reports empty rates.
    Counter resets (``counters.reset()``) produce negative deltas,
    which are clamped to 0 rather than reported as nonsense."""

    def __init__(self):
        self._last = None            # (monotonic, counts, hist_state)

    def observe(self, counts, hists=None):
        """Per-second rates since the previous observe::

            {'dt': seconds_or_None,
             'counters':   {name: per_second},
             'histograms': {name: {'count_per_s': ..,
                                   'sum_per_s': ..}}}

        ``counts`` is a counters.snapshot() dict; ``hists`` an optional
        histograms.snapshot() dict (count/sum deltas — e.g. the
        send-stall seconds accrued per wall second)."""
        import time
        now = time.monotonic()
        out = {'dt': None, 'counters': {}, 'histograms': {}}
        hstate = {name: (h.get('count', 0), h.get('sum', 0.0))
                  for name, h in (hists or {}).items()}
        if self._last is not None:
            t0, prev, prev_h = self._last
            dt = now - t0
            if dt > 0:
                out['dt'] = dt
                for name, v in counts.items():
                    out['counters'][name] = \
                        max(v - prev.get(name, 0), 0) / dt
                for name, (cnt, tot) in hstate.items():
                    pc, ps = prev_h.get(name, (0, 0.0))
                    out['histograms'][name] = {
                        'count_per_s': max(cnt - pc, 0) / dt,
                        'sum_per_s': max(tot - ps, 0.0) / dt}
        self._last = (now, counts, hstate)
        return out


#: shared tracker behind ``snapshot(rates=True)``
_global_rates = RateTracker()


def _ring_occupancy(pipeline=None):
    """{ring_name: occupancy dict (+ 'fill' fraction)}: the pipeline's
    rings when given, else every ring alive in the process
    (ring.live_rings)."""
    if pipeline is not None:
        from ..supervision import ring_occupancies
        occ = ring_occupancies(pipeline)
    else:
        from ..ring import live_rings
        occ = {}
        for r in live_rings():
            try:
                occ[r.name] = r.occupancy()
            except Exception:
                pass
    out = {}
    for name, d in occ.items():
        d = dict(d)
        size = d.get('size') or 0
        if size and 'head' in d and 'tail' in d:
            frac = (d['head'] - d['tail']) / float(size)
            d['fill'] = max(0.0, min(1.0, frac))
        out[name] = d
    return out


def _device_stats():
    """The memory of each card in use, from torch's caching allocator:
    ``{index: {platform: 'cuda', bytes_in_use (memory_allocated),
    bytes_reserved (memory_reserved), peak_bytes_in_use
    (max_memory_allocated), bytes_free and bytes_limit (mem_get_info)}}``
    under the JAX package's keys.  A card is in use when the allocator
    holds memory on it or it is the current card.  Empty where CUDA was
    never initialised in this process (a snapshot must not create a
    context) or with ``BF_DEVICE_METRICS=0``."""
    import sys
    if os.environ.get('BF_DEVICE_METRICS', '1') == '0':
        return {}
    torch = sys.modules.get('torch')
    if torch is None:
        return {}
    out = {}
    try:
        if not torch.cuda.is_initialized():
            return {}
        current = torch.cuda.current_device()
        for i in range(torch.cuda.device_count()):
            reserved = torch.cuda.memory_reserved(i)
            if i != current and not reserved:
                continue
            free, total = torch.cuda.mem_get_info(i)
            out[i] = {'platform': 'cuda',
                      'bytes_in_use': int(torch.cuda.memory_allocated(i)),
                      'bytes_reserved': int(reserved),
                      'peak_bytes_in_use':
                          int(torch.cuda.max_memory_allocated(i)),
                      'bytes_free': int(free),
                      'bytes_limit': int(total)}
    except Exception:
        return {}
    return out


#: mesh counter prefixes folded into the snapshot's 'mesh' summary
_MESH_KEYS = ('mesh.reshards', 'mesh.reshard_bytes',
              'mesh.sharded_commits', 'mesh.layout_mismatch',
              'mesh.plans_analyzed', 'mesh.plans_collective_free',
              'mesh.frame_local_fallback')


def _mesh_summary(counts):
    """The mesh counters regrouped into one section (they stay in
    'counters' too), with ``mesh.collectives.<kind>`` folded into a
    sub-dict: the port's collectives count there
    (``parallel.ops.collectives``)."""
    out = {k.split('.', 1)[1]: counts[k] for k in _MESH_KEYS
           if k in counts}
    coll = {k.split('.', 2)[2]: v for k, v in counts.items()
            if k.startswith('mesh.collectives.')}
    if coll:
        out['collectives'] = coll
    return out


def snapshot(pipeline=None, rates=False):
    """The unified metrics snapshot::

        {'counters':   {name: int},
         'histograms': {name: {count,sum,min,max,p50,p90,p99,buckets}},
         'rings':      {name: {tail,head,size,...,fill}},
         'devices':    {index: {platform,bytes_in_use,bytes_limit,...}},
         'mesh':       {reshards,sharded_commits,collectives,...},
         'identity':   {hostname, pid},
         'rates':      {dt, counters: {name: per_s},
                        histograms: {name: {count_per_s, sum_per_s}}}}

    ``pipeline`` narrows the ring section to one pipeline's rings;
    without it every live ring in the process is reported.  The
    'counters' section includes the live ``trace.dropped_spans`` total
    (per-thread span-buffer overflow — docs/observability.md); the SLO
    age histograms/violation counters (telemetry.slo) appear under
    their ``slo.*`` names in 'histograms'/'counters'.

    ``rates`` adds derived per-second rates from the counter and
    histogram deltas since this tracker's PREVIOUS snapshot: ``True``
    uses a shared module tracker (one consumer), or pass your own
    :class:`RateTracker` for an independent cadence (the closed-loop
    auto-tuner and the metrics publisher each own one).  The first
    snapshot has no baseline and reports empty rate dicts.
    """
    counts = counters.snapshot()
    dropped = spans.dropped_spans()
    if dropped:
        counts['trace.dropped_spans'] = \
            counts.get('trace.dropped_spans', 0) + dropped
    hists = histograms.snapshot()
    import socket
    snap = {
        'counters': counts,
        'histograms': hists,
        'rings': _ring_occupancy(pipeline),
        'devices': _device_stats(),
        'mesh': _mesh_summary(counts),
        'identity': {'hostname': socket.gethostname(),
                     'pid': os.getpid()},
    }
    if rates:
        tracker = rates if isinstance(rates, RateTracker) \
            else _global_rates
        snap['rates'] = tracker.observe(counts, hists)
    return snap


# ---------------------------------------------------------------------------
# Prometheus textfile export
# ---------------------------------------------------------------------------

def _esc(value):
    return str(value).replace('\\', r'\\').replace('"', r'\"') \
                     .replace('\n', r'\n')


def prometheus_text(snap=None):
    """Render a snapshot in Prometheus text exposition format."""
    if snap is None:
        snap = snapshot()
    lines = ['# bifrost_tpu metrics (telemetry.exporter)']
    lines.append('# TYPE bifrost_tpu_counter_total counter')
    for name in sorted(snap.get('counters', {})):
        lines.append('bifrost_tpu_counter_total{name="%s"} %d'
                     % (_esc(name), snap['counters'][name]))
    hists = snap.get('histograms', {})
    if hists:
        lines.append('# TYPE bifrost_tpu_hist histogram')
    for name in sorted(hists):
        h = hists[name]
        label = _esc(name)
        cum = 0
        for exp in sorted(h.get('buckets', {})):
            cum += h['buckets'][exp]
            lines.append('bifrost_tpu_hist_bucket{name="%s",le="%g"} %d'
                         % (label, 2.0 ** exp, cum))
        lines.append('bifrost_tpu_hist_bucket{name="%s",le="+Inf"} %d'
                     % (label, h['count']))
        lines.append('bifrost_tpu_hist_sum{name="%s"} %g'
                     % (label, h['sum']))
        lines.append('bifrost_tpu_hist_count{name="%s"} %d'
                     % (label, h['count']))
    rings = snap.get('rings', {})
    if rings:
        lines.append('# TYPE bifrost_tpu_ring_fill_ratio gauge')
        lines.append('# TYPE bifrost_tpu_ring_bytes gauge')
    for name in sorted(rings):
        d = rings[name]
        label = _esc(name)
        if 'fill' in d:
            lines.append('bifrost_tpu_ring_fill_ratio{ring="%s"} %g'
                         % (label, d['fill']))
        for key in ('tail', 'head', 'size'):
            if key in d:
                lines.append('bifrost_tpu_ring_bytes{ring="%s",'
                             'kind="%s"} %d' % (label, key, d[key]))
    devices = snap.get('devices', {})
    if devices:
        lines.append('# TYPE bifrost_tpu_device_bytes gauge')
    for idx in sorted(devices):
        d = devices[idx]
        for key, kind in (('bytes_in_use', 'in_use'),
                          ('bytes_reserved', 'reserved'),
                          ('bytes_free', 'free'),
                          ('bytes_limit', 'limit'),
                          ('peak_bytes_in_use', 'peak'),
                          ('largest_alloc', 'largest_alloc'),
                          ('watermark_bytes', 'watermark')):
            if key in d:
                lines.append('bifrost_tpu_device_bytes{device="%s",'
                             'kind="%s"} %d' % (_esc(idx), kind,
                                                d[key]))
    return '\n'.join(lines) + '\n'


def write_prometheus(path, snap=None):
    """Atomically write the snapshot as a Prometheus textfile."""
    text = prometheus_text(snap)
    # pid AND thread ident: concurrent pipelines each run their own
    # publisher thread against the same BF_METRICS_FILE
    tmp = '%s.tmp%d.%d' % (path, os.getpid(),
                           threading.get_ident())
    with open(tmp, 'w') as f:
        f.write(text)
    os.replace(tmp, path)
    return path


# ---------------------------------------------------------------------------
# periodic publisher (ProcLog + Prometheus)
# ---------------------------------------------------------------------------

class MetricsPublisher(threading.Thread):
    """Daemon thread publishing the unified snapshot periodically:
    ``telemetry/metrics`` + ``rings_flow/<name>`` ProcLogs always, the
    ``BF_METRICS_FILE`` Prometheus textfile when configured.  A final
    publish runs on :meth:`stop` so short pipelines still leave a
    complete last snapshot behind."""

    def __init__(self, pipeline=None, interval=None):
        super(MetricsPublisher, self).__init__(
            name='bf-metrics', daemon=True)
        if interval is None:
            try:
                interval = float(os.environ.get('BF_METRICS_INTERVAL',
                                                '') or DEFAULT_INTERVAL)
            except ValueError:
                interval = DEFAULT_INTERVAL
        self.interval = max(float(interval), 0.1)
        self.pipeline = pipeline
        self._stop_event = threading.Event()
        self._proclogs = {}
        #: per-second rate derivation between publishes (shared
        #: RateTracker machinery — no more ad-hoc last-value dicts)
        self._rates = RateTracker()
        #: per-device HBM watermark: the highest bytes_in_use this
        #: publisher has SAMPLED (coarser than the allocator's own
        #: peak_bytes_in_use where available, but live on every
        #: backend and reset-free across allocator stat resets)
        self._hbm_watermark = {}
        #: fleet streaming (telemetry.fleet): with BF_FLEET_COLLECTOR
        #: set, hold the process-shared FleetPublisher for this
        #: pipeline's lifetime, so that pipelines in one process share
        #: one stream; the last stop() sends the final full snapshot
        from . import fleet as _fleet
        self._fleet = _fleet.acquire_publisher()

    def stop(self, wait=True):
        """Stop the loop; publishes one final snapshot first."""
        self._stop_event.set()
        if wait and self.is_alive():
            self.join(self.interval + 2.0)
        if self._fleet is not None:
            from . import fleet as _fleet
            _fleet.release_publisher(self._fleet)
            self._fleet = None

    def run(self):
        while not self._stop_event.wait(self.interval):
            self.publish()
        self.publish()               # final snapshot at shutdown

    # -- publishing --------------------------------------------------------
    def _proclog(self, name):
        log = self._proclogs.get(name)
        if log is None:
            from ..proclog import ProcLog
            log = self._proclogs[name] = ProcLog(name)
        return log

    def publish(self):
        try:
            snap = snapshot(self.pipeline, rates=self._rates)
            self._note_watermarks(snap)
            self._publish_proclog(snap)
            path = os.environ.get('BF_METRICS_FILE')
            if path:
                write_prometheus(path, snap)
        except Exception:
            pass                     # never take the pipeline down

    def _note_watermarks(self, snap):
        """Fold the publisher's sampled HBM watermark into the
        snapshot's device entries (and keep it across publishes)."""
        for idx, d in snap.get('devices', {}).items():
            in_use = d.get('bytes_in_use')
            if in_use is None:
                continue
            mark = max(self._hbm_watermark.get(idx, 0), in_use)
            self._hbm_watermark[idx] = mark
            d['watermark_bytes'] = mark

    def _publish_proclog(self, snap):
        flat = {}
        for name, value in sorted(snap['counters'].items()):
            flat['c.' + name] = value
        for name, h in sorted(snap['histograms'].items()):
            flat['h.%s.count' % name] = h['count']
            flat['h.%s.p50' % name] = '%g' % h['p50']
            flat['h.%s.p99' % name] = '%g' % h['p99']
        self._proclog('telemetry/metrics').update(flat, force=True)

        crates = snap.get('rates', {}).get('counters', {})
        hists = snap['histograms']
        for name, d in sorted(snap['rings'].items()):
            gulps = snap['counters'].get('ring.%s.gulps' % name, 0)
            rate = crates.get('ring.%s.gulps' % name, 0.0)
            entry = {
                'occupancy_pct': round(100.0 * d.get('fill', 0.0), 1),
                'gulps': gulps,
                'gulps_per_s': round(rate, 3),
                'poisoned': int(bool(d.get('poisoned'))),
            }
            for kind in ('reserve', 'acquire'):
                h = hists.get('ring.%s.%s_s' % (name, kind))
                if h and h['count']:
                    entry['%s_wait_p99_ms' % kind] = \
                        round(h['p99'] * 1e3, 3)
            self._proclog('rings_flow/%s' % name).update(entry,
                                                         force=True)
        # per-device HBM telemetry (mesh observability): one proclog
        # entry per local device with in-use/limit/peak/watermark
        for idx, d in sorted(snap.get('devices', {}).items()):
            entry = {k: v for k, v in d.items() if k != 'platform'}
            if not entry:
                continue
            entry['platform'] = d.get('platform', '?')
            self._proclog('devices/%s' % idx).update(entry, force=True)
