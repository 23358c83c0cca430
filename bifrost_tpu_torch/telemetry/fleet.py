"""The fleet plane: one live view over the telemetry of many processes
(the counterpart of ``bifrost_tpu/telemetry/fleet.py``; the wire format,
rollup, alert rules and incident bundles are the JAX package's, so a
publisher of either package feeds a collector of the other).

- :class:`FleetPublisher`: a per-process daemon thread that pushes
  periodic deltas of this process's telemetry (counters, histogram
  digests, rings, health, host identity) over UDP to a collector.
  Counter values on the wire are cumulative (last-value semantics) and
  a full snapshot goes out every ``BF_FLEET_FULL_EVERY`` publishes, so a
  restarted collector re-adopts a live publisher without counting
  anything twice.  Full snapshots also carry the card memory section
  that the exporter reads from torch's caching allocator, where CUDA is
  in use.  The publisher arms the span flight recorder while it runs
  and answers two collector requests on its own socket: ``need_full``
  (resync) and ``flight_request`` (incident capture).  The ``tenants``
  and ``scheduler`` sections carry the service tier's and the control
  plane's rollups where those modules run in the process.

- :class:`FleetCollector`: binds one UDP port, keeps a per-host rollup
  with staleness marking (its own deadline and the dead verdicts of an
  optional membership object), evaluates :class:`AlertEngine` rules
  each tick and exports the merged view: the ``fleet/rollup`` and
  ``alerts/active`` ProcLogs, a JSON rollup file
  (``BF_FLEET_ROLLUP_FILE``, rendered by
  ``bifrost_tpu_torch.tools.like_top --fleet``) and a host-labelled
  Prometheus textfile (``BF_FLEET_PROM_FILE``).

- :class:`IncidentRecorder`: the black box.  On a health escalation
  (SHEDDING/STALLED/FAILED, through the supervision escalation watch), a
  dead-host verdict or an ``incident: true`` alert, it writes a
  cross-host bundle (flight-recorder timelines as Chrome traces, the
  last snapshots, ring occupancy, active alerts) under
  ``BF_FLEET_INCIDENT_DIR``.

Wire format: each datagram is ``b'BFT1' + msgid(u32) + idx(u16) +
n(u16)`` followed by a zlib-compressed JSON fragment; messages larger
than one datagram are chunked and reassembled.
"""

import fnmatch
import json
import os
import socket as socket_mod
import struct
import threading
import time
import zlib

from . import counters
from . import spans

__all__ = ['FleetPublisher', 'FleetCollector', 'AlertEngine',
           'AlertRuleError', 'IncidentRecorder', 'load_rules',
           'parse_collector_addr', 'acquire_publisher',
           'release_publisher', 'note_event']

#: wire header: magic, message id, chunk index, chunk count
_MAGIC = b'BFT1'
_HEADER = struct.Struct('>4sIHH')
#: payload bytes per datagram chunk (well under any loopback MTU cap)
_CHUNK = 60000

DEFAULT_INTERVAL = 1.0
DEFAULT_FULL_EVERY = 10
DEFAULT_DEADLINE = 5.0
DEFAULT_HISTORY = 8


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


def parse_collector_addr(value=None):
    """``host:port`` (``BF_FLEET_COLLECTOR`` when value is None) ->
    (host, port) tuple, or None when unset/unparseable."""
    if value is None:
        value = os.environ.get('BF_FLEET_COLLECTOR', '')
    if not value:
        return None
    host, sep, port = value.rpartition(':')
    if not sep:
        return None
    try:
        return (host or '127.0.0.1', int(port))
    except ValueError:
        return None


def _encode(msg, msgid):
    """One message -> list of wire datagrams (chunked when large)."""
    blob = zlib.compress(json.dumps(msg, separators=(',', ':'))
                         .encode('utf-8'))
    chunks = [blob[i:i + _CHUNK] for i in range(0, len(blob), _CHUNK)] \
        or [b'']
    n = len(chunks)
    return [_HEADER.pack(_MAGIC, msgid & 0xffffffff, i, n) + c
            for i, c in enumerate(chunks)]


class _Reassembler(object):
    """Collects chunked datagrams back into messages (per source
    address, bounded, stale fragments dropped)."""

    def __init__(self, max_age_s=10.0):
        self._parts = {}         # (addr, msgid) -> {idx: bytes}
        self._first = {}         # (addr, msgid) -> monotonic
        self.max_age_s = max_age_s

    def feed(self, data, addr):
        """Returns the decoded message dict when ``data`` completes
        one, else None.  Raises ValueError on a corrupt frame."""
        if len(data) < _HEADER.size:
            raise ValueError('short frame')
        magic, msgid, idx, n = _HEADER.unpack_from(data)
        if magic != _MAGIC or n == 0 or idx >= n:
            raise ValueError('bad header')
        payload = data[_HEADER.size:]
        if n == 1:
            blob = payload
        else:
            key = (addr, msgid)
            parts = self._parts.setdefault(key, {})
            if not parts:
                self._first[key] = time.monotonic()
            parts[idx] = payload
            if len(parts) < n:
                self._gc()
                return None
            blob = b''.join(parts[i] for i in range(n))
            self._parts.pop(key, None)
            self._first.pop(key, None)
        return json.loads(zlib.decompress(blob).decode('utf-8'))

    def _gc(self):
        now = time.monotonic()
        for key, t0 in list(self._first.items()):
            if now - t0 > self.max_age_s:
                self._parts.pop(key, None)
                self._first.pop(key, None)


def _hist_digest(h):
    """Histogram snapshot -> compact wire digest (no buckets)."""
    return {k: h[k] for k in ('count', 'sum', 'min', 'max',
                              'p50', 'p90', 'p99') if k in h}


def _health_section():
    """{pipeline: health snapshot} from supervision's live monitors,
    or {} when the supervision layer is not in play here."""
    import sys
    if '%s.supervision' % __name__.split('.')[0] not in sys.modules:
        return {}
    try:
        from .. import supervision
        return supervision.live_health()
    except Exception:
        return {}


# ---------------------------------------------------------------------------
# publisher
# ---------------------------------------------------------------------------

class FleetPublisher(threading.Thread):
    """Daemon thread streaming this process's telemetry to a
    :class:`FleetCollector`.  ``collector`` is a (host, port) tuple
    (default: parsed from ``BF_FLEET_COLLECTOR``); ``host`` is the
    identity the fleet rollup files this process under (default:
    ``BF_FLEET_HOST``, else the proclog fabric identity, else the OS
    hostname).  Deltas carry only counters/histograms that CHANGED
    since the previous send — always with cumulative values — and the
    small sections (rings, health, tenants, scheduler) whole; every
    ``full_every`` sends (or on a collector ``need_full`` request) a
    full snapshot goes out, with the flight-recorder span tail
    attached so a host that dies between fulls still leaves a usable
    black-box record behind."""

    def __init__(self, collector=None, interval=None, host=None,
                 full_every=None):
        super(FleetPublisher, self).__init__(name='bf-fleet-pub',
                                             daemon=True)
        self.collector = collector or parse_collector_addr()
        if self.collector is None:
            raise ValueError('no collector address (BF_FLEET_COLLECTOR'
                             ' unset and none passed)')
        if host is None:
            host = os.environ.get('BF_FLEET_HOST') or None
        if host is None:
            try:
                from ..proclog import get_identity
                ident = get_identity()
                host = ident[0] if ident else None
            except Exception:
                host = None
        self.host = host or socket_mod.gethostname()
        self.interval = max(interval if interval is not None
                            else _env_float('BF_FLEET_INTERVAL',
                                            DEFAULT_INTERVAL), 0.05)
        self.full_every = max(full_every if full_every is not None
                              else _env_int('BF_FLEET_FULL_EVERY',
                                            DEFAULT_FULL_EVERY), 1)
        self.session = '%d.%x' % (os.getpid(),
                                  int(time.time() * 1e3) & 0xffffff)
        self._sock = socket_mod.socket(socket_mod.AF_INET,
                                       socket_mod.SOCK_DGRAM)
        self._sock.bind(('0.0.0.0', 0))
        self._sock.settimeout(self.interval / 2.0)
        self._stop_event = threading.Event()
        self._send_lock = threading.Lock()
        self._seq = 0
        self._msgid = int(time.time() * 1e3) & 0x7fffffff
        self._last_counters = {}
        self._last_hist_counts = {}
        self._need_full = True
        self._flight_armed = False

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        # the fleet plane wants a flight record from every member, so
        # publishing arms the span recorder (refcounted — paired in
        # stop(); a configured BF_TRACE_FILE keeps its own hold)
        spans.enable_flight_recorder()
        self._flight_armed = True
        # health escalations stream as immediate out-of-band events
        # (the collector's incident trigger), not at snapshot cadence
        try:
            from .. import supervision
            supervision.add_escalation_watch(self._on_escalation)
            self._escalation_watch = True
        except Exception:
            self._escalation_watch = False
        super(FleetPublisher, self).start()
        return self

    def _on_escalation(self, pipeline_name, from_state, to_state,
                       reason):
        self.send_event('health', {'pipeline': pipeline_name,
                                   'from': from_state,
                                   'to': to_state, 'reason': reason})

    def stop(self, wait=True):
        """Stop the loop; sends one final FULL snapshot first."""
        if self._stop_event.is_set():
            return
        self._stop_event.set()
        if wait and self.is_alive():
            self.join(self.interval + 2.0)
        try:
            self.publish(full=True, final=True)
        except Exception:
            pass
        if self._flight_armed:
            self._flight_armed = False
            spans.disable_flight_recorder()
        if getattr(self, '_escalation_watch', False):
            try:
                from .. import supervision
                supervision.remove_escalation_watch(
                    self._on_escalation)
            except Exception:
                pass
        try:
            self._sock.close()
        except OSError:
            pass

    def run(self):
        next_pub = time.monotonic()
        while not self._stop_event.is_set():
            now = time.monotonic()
            if now >= next_pub:
                try:
                    self.publish()
                except Exception:
                    counters.inc('fleet.pub.errors')
                next_pub = now + self.interval
            try:
                data, addr = self._sock.recvfrom(65535)
            except socket_mod.timeout:
                continue
            except OSError:
                if self._stop_event.is_set():
                    return
                continue
            try:
                self._handle_request(json.loads(
                    zlib.decompress(data).decode('utf-8')))
            except Exception:
                counters.inc('fleet.pub.errors')

    # -- requests from the collector ---------------------------------------
    def _handle_request(self, req):
        kind = req.get('t')
        if kind == 'need_full':
            counters.inc('fleet.pub.full_requests')
            self._need_full = True
        elif kind == 'flight_request':
            counters.inc('fleet.pub.flight_replies')
            wall_ns = time.time_ns()
            mono_us = spans.now_us()
            self._send({'t': 'flight', 'host': self.host,
                        'session': self.session,
                        'incident': req.get('incident'),
                        'wall_ns': wall_ns, 'mono_us': mono_us,
                        'clock': spans.clock_info(),
                        'events': self._flight_events()})

    # -- event side-channel ------------------------------------------------
    def send_event(self, kind, payload):
        """Push one out-of-band event (health escalation, tenant state
        change) to the collector immediately, outside the snapshot
        cadence."""
        msg = {'t': 'event', 'host': self.host,
               'session': self.session, 'kind': kind,
               'wall_ns': time.time_ns()}
        msg.update(payload)
        counters.inc('fleet.pub.events')
        self._send(msg)

    # -- publishing --------------------------------------------------------
    @staticmethod
    def _flight_events(per_thread=64):
        return spans.flight_events(per_thread)

    @staticmethod
    def _identity():
        """Host identity for full snapshots (mirrors the identity
        section of exporter.snapshot)."""
        from ..proclog import get_identity
        identity = {'hostname': socket_mod.gethostname(),
                    'pid': os.getpid()}
        ident = get_identity()
        if ident is not None:
            identity['fabric_host'] = ident[0]
            identity['fabric_role'] = ident[1]
        return identity

    def publish(self, full=False, final=False):
        """Build and send one snapshot message; meters its own busy
        time on ``fleet.pub.busy_us``.

        Gathers only the sections the wire format carries, not
        ``exporter.snapshot()``; the card memory section (allocator
        counters and ``mem_get_info``) rides full snapshots only.

        Busy is metered as THREAD CPU time, not wall: against a hot
        pipeline ~80% of a publish's wall-clock is this thread parked
        waiting for the GIL — time the pipeline was productively
        computing, so charging it to the publisher would double-count
        it.  thread_time is the processor cost the stream actually
        steals (the A/B arm comparison in obs_overhead cross-checks
        the wall side)."""
        clock = getattr(time, 'thread_time', time.perf_counter)
        t0 = clock()
        from . import exporter, histograms
        full = full or self._need_full or \
            (self._seq % self.full_every == 0)
        self._need_full = False
        self._seq += 1
        msg = {'t': 'full' if full else 'delta',
               'host': self.host, 'session': self.session,
               'seq': self._seq, 'wall_ns': time.time_ns(),
               'mono_us': spans.now_us(),
               'rings': exporter._ring_occupancy(None),
               'health': _health_section(),
               'tenants': exporter._tenant_section(),
               'scheduler': exporter._scheduler_section()}
        if final:
            msg['final'] = True
        counts = counters.snapshot()
        dropped = spans.dropped_spans()
        if dropped:
            counts['trace.dropped_spans'] = \
                counts.get('trace.dropped_spans', 0) + dropped
        hists = histograms.snapshot()
        if full:
            msg['counters'] = counts
            msg['histograms'] = {k: _hist_digest(h)
                                 for k, h in hists.items()}
            msg['identity'] = self._identity()
            msg['flight'] = self._flight_events()
            devices = exporter._device_stats()
            if devices:
                msg['devices'] = {str(k): v for k, v in devices.items()}
        else:
            msg['counters'] = {
                k: v for k, v in counts.items()
                if self._last_counters.get(k) != v}
            msg['histograms'] = {
                k: _hist_digest(h) for k, h in hists.items()
                if self._last_hist_counts.get(k) != h.get('count')}
        self._last_counters = counts
        self._last_hist_counts = {k: h.get('count')
                                  for k, h in hists.items()}
        self._send(msg)
        counters.inc('fleet.pub.msgs')
        counters.inc('fleet.pub.busy_us', int((clock() - t0) * 1e6))

    def _send(self, msg):
        self._msgid += 1
        try:
            with self._send_lock:
                for frame in _encode(msg, self._msgid):
                    self._sock.sendto(frame, self.collector)
                    counters.inc('fleet.pub.bytes', len(frame))
        except OSError:
            counters.inc('fleet.pub.errors')


# -- process-wide singleton (MetricsPublisher wiring) -----------------------

_singleton_lock = threading.Lock()
_singleton = None
_singleton_refs = 0


def acquire_publisher():
    """Refcounted process-wide publisher, armed only when
    ``BF_FLEET_COLLECTOR`` is set (else None).  Every
    ``MetricsPublisher`` acquires on construction and releases on
    stop, so N tenant pipelines in one process share ONE fleet
    stream; the last release sends the final full snapshot."""
    global _singleton, _singleton_refs
    if parse_collector_addr() is None:
        return None
    with _singleton_lock:
        if _singleton is None or not _singleton.is_alive():
            try:
                _singleton = FleetPublisher().start()
            except (ValueError, OSError):
                counters.inc('fleet.pub.errors')
                return None
            _singleton_refs = 0
        _singleton_refs += 1
        return _singleton


def release_publisher(pub):
    """Drop one hold on the shared publisher; stops it at zero."""
    global _singleton, _singleton_refs
    if pub is None:
        return
    stop = None
    with _singleton_lock:
        if pub is not _singleton:
            stop = pub               # a privately built publisher
        else:
            _singleton_refs -= 1
            if _singleton_refs <= 0:
                stop, _singleton = _singleton, None
    if stop is not None:
        stop.stop()


def note_event(kind, payload):
    """Forward one event through the live shared publisher, if any (a
    no-op outside a fleet-armed process)."""
    pub = _singleton
    if pub is not None and not pub._stop_event.is_set():
        try:
            pub.send_event(kind, payload)
        except Exception:
            counters.inc('fleet.pub.errors')


# ---------------------------------------------------------------------------
# alert rules
# ---------------------------------------------------------------------------

class AlertRuleError(ValueError):
    """A declarative alert rule failed validation."""


_RULE_KINDS = ('threshold', 'delta', 'rate', 'absence')
_OPS = {
    '>': lambda a, b: a > b, '>=': lambda a, b: a >= b,
    '<': lambda a, b: a < b, '<=': lambda a, b: a <= b,
    '==': lambda a, b: a == b, '!=': lambda a, b: a != b,
}


class AlertRule(object):
    """One validated rule.  Kinds:

    - ``threshold``: fire while ``metric <op> value``.
    - ``delta``: fire while the metric's change over the trailing
      ``window_s`` seconds satisfies ``<op> value``.
    - ``rate``: same, per second.
    - ``absence``: fire while a previously-seen ``host`` (glob) is
      stale/dead, or a previously-seen ``tenant`` (glob) is missing
      from every fresh host.  A literal host/tenant the collector has
      NEVER seen is UNKNOWN, not absent — it never fires (mirroring
      Membership's never-seen-is-not-dead semantics).

    ``metric`` is a dot-path glob into a host's flattened sections
    (e.g. ``counters.slo.violations``, ``rings.*.fill``); ``scope:
    fleet`` evaluates against the summed fleet counters instead.
    Escalation needs ``for_ticks`` consecutive bad ticks, resolution
    ``clear_ticks`` consecutive good ones (hysteresis).  ``incident:
    true`` makes a firing trip the black-box recorder."""

    _FIELDS = ('name', 'kind', 'metric', 'op', 'value', 'window_s',
               'scope', 'host', 'tenant', 'for_ticks', 'clear_ticks',
               'severity', 'incident')

    def __init__(self, spec):
        if not isinstance(spec, dict):
            raise AlertRuleError('rule must be a dict: %r' % (spec,))
        unknown = sorted(set(spec) - set(self._FIELDS))
        if unknown:
            raise AlertRuleError('rule %r: unknown field(s) %s'
                                 % (spec.get('name'),
                                    ', '.join(unknown)))
        self.name = spec.get('name')
        if not self.name:
            raise AlertRuleError('rule needs a name: %r' % (spec,))
        self.kind = spec.get('kind', 'threshold')
        if self.kind not in _RULE_KINDS:
            raise AlertRuleError('rule %s: kind must be one of %s'
                                 % (self.name, '/'.join(_RULE_KINDS)))
        self.metric = spec.get('metric')
        self.op = spec.get('op', '>')
        if self.op not in _OPS:
            raise AlertRuleError('rule %s: bad op %r'
                                 % (self.name, self.op))
        self.value = spec.get('value', 0)
        self.window_s = float(spec.get('window_s', 10.0))
        self.scope = spec.get('scope', 'host')
        self.host = spec.get('host', '*')
        self.tenant = spec.get('tenant')
        self.for_ticks = max(int(spec.get('for_ticks', 1)), 1)
        self.clear_ticks = max(int(spec.get('clear_ticks', 1)), 1)
        self.severity = spec.get('severity', 'warn')
        self.incident = bool(spec.get('incident', False))
        if self.kind == 'absence':
            if self.tenant is None and spec.get('host') is None:
                raise AlertRuleError('rule %s: absence needs a host '
                                     'or tenant pattern' % self.name)
        elif not self.metric:
            raise AlertRuleError('rule %s: %s needs a metric path'
                                 % (self.name, self.kind))


def load_rules(source=None):
    """Rules from a JSON file path, a list of dicts, or (default) the
    ``BF_ALERT_RULES`` file; accepts a bare list or ``{"rules":
    [...]}``.  Returns [] when nothing is configured."""
    if source is None:
        source = os.environ.get('BF_ALERT_RULES') or None
    if source is None:
        return []
    if isinstance(source, str):
        with open(source) as f:
            source = json.load(f)
    if isinstance(source, dict):
        source = source.get('rules', [])
    return [r if isinstance(r, AlertRule) else AlertRule(r)
            for r in source]


def _flatten(obj, prefix=''):
    out = {}
    if isinstance(obj, dict):
        for k, v in obj.items():
            out.update(_flatten(v, '%s.%s' % (prefix, k) if prefix
                                else str(k)))
    elif isinstance(obj, (int, float)) and not isinstance(obj, bool):
        out[prefix] = float(obj)
    return out


class AlertEngine(object):
    """Evaluates :class:`AlertRule`\\ s against the fleet rollup each
    collector tick.  Per (rule, instance) state machine::

        ok --cond for_ticks--> FIRING --clear clear_ticks--> RESOLVED

    with dedup while firing (repeat triggers count
    ``alerts.suppressed``, not a re-fire).  Transitions are appended
    to a bounded history, counted on ``alerts.fired`` /
    ``alerts.resolved``, and pushed to the configured sinks: a
    JSON-lines file (``BF_ALERT_LOG``) and a webhook
    (``BF_ALERT_WEBHOOK``, POSTed the transition dict; failures count
    ``alerts.sink_errors``, never raise)."""

    def __init__(self, rules=None, log_path=None, webhook=None):
        self.rules = list(rules or [])
        self.log_path = log_path if log_path is not None \
            else (os.environ.get('BF_ALERT_LOG') or None)
        self.webhook = webhook if webhook is not None \
            else (os.environ.get('BF_ALERT_WEBHOOK') or None)
        self._state = {}             # (rule.name, instance) -> dict
        self._window = {}            # (rule.name, instance) -> samples
        self.history = []            # bounded transition list
        self._new_firings = []       # drained by the collector

    # -- evaluation --------------------------------------------------------
    def evaluate(self, rollup, now=None):
        """One tick: walk every rule over ``rollup`` (the
        FleetCollector.rollup() dict), advance the state machines,
        emit transitions.  Returns the list of NEWLY-FIRING
        (rule, instance, value) tuples for the incident hook."""
        now = time.time() if now is None else now
        self._new_firings = []
        for rule in self.rules:
            for instance, cond, value in self._conditions(rule,
                                                          rollup, now):
                self._advance(rule, instance, cond, value, now)
        return list(self._new_firings)

    def _conditions(self, rule, rollup, now):
        """Yield (instance, condition, value) per rule instance.
        condition None = UNKNOWN (never-seen target): the state
        machine treats it as clear but the status surfaces as
        'unknown'."""
        hosts = rollup.get('hosts', {})
        if rule.kind == 'absence':
            if rule.tenant is not None:
                seen = rollup.get('tenants_seen', {})
                names = [t for t in seen
                         if fnmatch.fnmatch(t, rule.tenant)]
                if not names and not _has_glob(rule.tenant):
                    yield ('tenant:%s' % rule.tenant, None, None)
                live = set()
                for h, entry in hosts.items():
                    if entry.get('fresh'):
                        live.update(entry.get('tenants') or ())
                for t in names:
                    yield ('tenant:%s' % t, t not in live, None)
            else:
                names = [h for h in hosts
                         if fnmatch.fnmatch(h, rule.host)]
                if not names and not _has_glob(rule.host):
                    yield ('host:%s' % rule.host, None, None)
                for h in names:
                    entry = hosts[h]
                    yield ('host:%s' % h,
                           bool(entry.get('stale')
                                or entry.get('dead')), None)
            return
        if rule.scope == 'fleet':
            flat = _flatten({'counters': rollup.get('counters', {})})
            targets = [('fleet', flat)]
        else:
            targets = []
            for h, entry in hosts.items():
                if not fnmatch.fnmatch(h, rule.host):
                    continue
                targets.append((h, _flatten({
                    k: entry.get(k) or {}
                    for k in ('counters', 'histograms', 'rings')})))
        for where, flat in targets:
            for path, value in flat.items():
                if not fnmatch.fnmatch(path, rule.metric):
                    continue
                instance = '%s:%s' % (where, path)
                if rule.kind == 'threshold':
                    yield (instance,
                           _OPS[rule.op](value, rule.value), value)
                    continue
                win = self._window.setdefault(
                    (rule.name, instance), [])
                win.append((now, value))
                while win and now - win[0][0] > rule.window_s:
                    win.pop(0)
                delta = value - win[0][1]
                if rule.kind == 'rate':
                    dt = now - win[0][0]
                    delta = delta / dt if dt > 0 else 0.0
                yield (instance, _OPS[rule.op](delta, rule.value),
                       round(delta, 6))

    def _advance(self, rule, instance, cond, value, now):
        key = (rule.name, instance)
        st = self._state.setdefault(
            key, {'state': 'ok', 'bad': 0, 'good': 0, 'since': now,
                  'value': None})
        st['value'] = value
        if cond is None:
            st['state'] = 'unknown' if st['state'] in ('ok', 'unknown') \
                else st['state']
            return
        if cond:
            st['bad'] += 1
            st['good'] = 0
            if st['state'] == 'firing':
                counters.inc('alerts.suppressed')
            elif st['bad'] >= rule.for_ticks:
                st['state'] = 'firing'
                st['since'] = now
                counters.inc('alerts.fired')
                self._emit(rule, instance, 'FIRING', value, now)
                self._new_firings.append((rule, instance, value))
            elif st['state'] == 'unknown':
                st['state'] = 'ok'   # now observed; pending normally
        else:
            st['bad'] = 0
            st['good'] += 1
            if st['state'] == 'firing' and \
                    st['good'] >= rule.clear_ticks:
                st['state'] = 'ok'
                st['since'] = now
                counters.inc('alerts.resolved')
                self._emit(rule, instance, 'RESOLVED', value, now)
            elif st['state'] == 'unknown':
                st['state'] = 'ok'

    # -- reporting ---------------------------------------------------------
    def active(self):
        """Currently-firing alerts, newest first."""
        out = []
        for (name, instance), st in self._state.items():
            if st['state'] == 'firing':
                rule = next((r for r in self.rules
                             if r.name == name), None)
                out.append({'name': name, 'instance': instance,
                            'since': st['since'],
                            'value': st['value'],
                            'severity': getattr(rule, 'severity',
                                                'warn')})
        out.sort(key=lambda a: -a['since'])
        return out

    def status(self):
        """{rule@instance: state} including 'unknown' instances —
        what the unknown-vs-dead tests read."""
        return {'%s@%s' % k: st['state']
                for k, st in self._state.items()}

    def _emit(self, rule, instance, event, value, now):
        entry = {'wall': round(now, 3), 'name': rule.name,
                 'instance': instance, 'event': event,
                 'value': value, 'severity': rule.severity,
                 'kind': rule.kind}
        self.history.append(entry)
        del self.history[:-128]
        if self.log_path:
            try:
                with open(self.log_path, 'a') as f:
                    f.write(json.dumps(entry, sort_keys=True) + '\n')
            except OSError:
                counters.inc('alerts.sink_errors')
        if self.webhook:
            try:
                import urllib.request
                req = urllib.request.Request(
                    self.webhook,
                    data=json.dumps(entry).encode('utf-8'),
                    headers={'Content-Type': 'application/json'})
                urllib.request.urlopen(req, timeout=2.0).close()
            except Exception:
                counters.inc('alerts.sink_errors')


def _has_glob(pattern):
    return any(c in pattern for c in '*?[')


# ---------------------------------------------------------------------------
# incident black-box recorder
# ---------------------------------------------------------------------------

class IncidentRecorder(object):
    """Archives a cross-host post-mortem bundle when something
    escalates.  Bundle layout (the JAX package's)::

        <dir>/incident_<n>_<reason>/
            meta.json            # reason, per-host clock origins,
                                 # active alerts, scheduler sections
            rollup.json          # the merged fleet rollup at trigger
            alerts.json          # engine history + active set
            hosts/<host>/flight.json     # Chrome-trace span timeline
            hosts/<host>/snapshots.json  # last-N received snapshots
            post/rollup.json     # the rollup ``settle_s`` later
                                 # (captures e.g. the scheduler's
                                 # replacement record)

    Per-reason-key cooldown (``BF_FLEET_INCIDENT_COOLDOWN``) bounds
    bundle churn during a flap storm (suppressions counted on
    ``incident.suppressed``); bundles count on ``incident.bundles``.
    """

    def __init__(self, collector, outdir=None, cooldown=None,
                 settle=None):
        self.collector = collector
        self.outdir = outdir if outdir is not None \
            else (os.environ.get('BF_FLEET_INCIDENT_DIR') or None)
        self.cooldown = cooldown if cooldown is not None \
            else _env_float('BF_FLEET_INCIDENT_COOLDOWN', 30.0)
        self.settle = settle if settle is not None \
            else _env_float('BF_FLEET_SETTLE', 5.0)
        self._last = {}              # reason key -> monotonic
        self._nth = 0
        self._pending = []           # (path, deadline) awaiting post/
        self.bundles = []            # paths written (newest last)

    def trigger(self, reason, detail=None):
        """Archive one bundle now (respecting the cooldown); returns
        the bundle path or None."""
        if not self.outdir:
            return None
        now = time.monotonic()
        if now - self._last.get(reason, -1e18) < self.cooldown:
            counters.inc('incident.suppressed')
            return None
        self._last[reason] = now
        self._nth += 1
        slug = ''.join(c if c.isalnum() or c in '-_' else '-'
                       for c in reason)[:48]
        path = os.path.join(self.outdir,
                            'incident_%03d_%s' % (self._nth, slug))
        try:
            self._write(path, reason, detail)
        except Exception:
            counters.inc('incident.errors')
            return None
        counters.inc('incident.bundles')
        self._pending.append((path, now + self.settle))
        self.bundles.append(path)
        # fresh flight tails from every live publisher land in the
        # bundle as the replies come back (collector _handle 'flight')
        self.collector.request_flights(self._nth)
        return path

    def _write(self, path, reason, detail):
        col = self.collector
        rollup = col.rollup()
        os.makedirs(path, exist_ok=True)
        hosts_meta = {}
        for hname, hstate in col.hosts_snapshot().items():
            hdir = os.path.join(path, 'hosts', hname)
            os.makedirs(hdir, exist_ok=True)
            _write_json(os.path.join(hdir, 'snapshots.json'),
                        hstate['history'])
            _write_json(os.path.join(hdir, 'flight.json'),
                        _chrome_trace(hname, hstate))
            hosts_meta[hname] = {
                'session': hstate['session'],
                'stale': hstate['stale'], 'dead': hstate['dead'],
                'seq': hstate['seq'],
                # wall-clock origin of the host's span clock: what
                # trace_merge.py shifts each timeline by
                'span_origin_wall_ns': hstate['span_origin_wall_ns'],
                'age_s': hstate['age_s'],
            }
        _write_json(os.path.join(path, 'meta.json'), {
            'bundle_format': 1,
            'incident': self._nth, 'reason': reason,
            'detail': detail, 'wall_ns': time.time_ns(),
            'hosts': hosts_meta,
            'alerts_active': col.engine.active(),
            'scheduler': {h: e.get('scheduler') or {}
                          for h, e in rollup['hosts'].items()},
        })
        _write_json(os.path.join(path, 'rollup.json'), rollup)
        _write_json(os.path.join(path, 'alerts.json'),
                    {'active': col.engine.active(),
                     'history': col.engine.history})

    def note_flight(self, host, msg):
        """A flight_request reply arrived — refresh the newest
        pending/recent bundle's per-host flight record."""
        if not self.bundles:
            return
        path = self.bundles[-1]
        hdir = os.path.join(path, 'hosts', host)
        try:
            os.makedirs(hdir, exist_ok=True)
            _write_json(os.path.join(hdir, 'flight.json'),
                        _chrome_trace(host, {
                            'flight': msg.get('events') or [],
                            'span_origin_wall_ns':
                                _origin_ns(msg), 'pid': 0}))
        except Exception:
            counters.inc('incident.errors')

    def poll(self, now=None):
        """Write the post-incident epilogue for bundles past their
        settle window (the rollup AFTER e.g. a re-placement landed)."""
        now = time.monotonic() if now is None else now
        keep = []
        for path, deadline in self._pending:
            if now < deadline:
                keep.append((path, deadline))
                continue
            try:
                post = os.path.join(path, 'post')
                os.makedirs(post, exist_ok=True)
                _write_json(os.path.join(post, 'rollup.json'),
                            self.collector.rollup())
            except Exception:
                counters.inc('incident.errors')
        self._pending = keep


def _origin_ns(msg):
    """wall_ns at span-clock zero, from a message's paired clocks."""
    return int(msg.get('wall_ns', 0)
               - float(msg.get('mono_us', 0.0)) * 1e3)


def _chrome_trace(host, hstate):
    """A host's flight-event tail as a Chrome trace dict (same shape
    as spans.export writes, so Perfetto loads it)."""
    events = []
    tids = {}
    pid = hstate.get('pid') or 0
    for ev in hstate.get('flight') or []:
        tname, name, cat, ts, dur, args = ev
        tid = tids.setdefault(tname, len(tids) + 1)
        entry = {'name': name, 'cat': cat, 'ph': 'X', 'pid': pid,
                 'tid': tid, 'ts': ts, 'dur': dur}
        if args:
            entry['args'] = args
        events.append(entry)
    for tname, tid in tids.items():
        events.insert(0, {'ph': 'M', 'name': 'thread_name',
                          'pid': pid, 'tid': tid,
                          'args': {'name': tname}})
    return {'traceEvents': events, 'displayTimeUnit': 'ms',
            'otherData': {'bf_host': host,
                          'bf_span_origin_wall_ns':
                              hstate.get('span_origin_wall_ns'),
                          'bf_clock': hstate.get('clock')
                          or {'host': host, 'pid': pid,
                              'sessions': {}}}}


def _write_json(path, obj):
    tmp = '%s.tmp%d' % (path, os.getpid())
    with open(tmp, 'w') as f:
        json.dump(obj, f, indent=1, sort_keys=True, default=str)
        f.write('\n')
    os.replace(tmp, path)


# ---------------------------------------------------------------------------
# collector
# ---------------------------------------------------------------------------

class _HostState(object):
    __slots__ = ('session', 'addr', 'seq', 'last_seen', 'wall_ns',
                 'mono_us', 'counters', 'histograms', 'rings',
                 'health', 'tenants', 'scheduler', 'identity',
                 'flight', 'clock', 'history', 'ever_live', 'stale',
                 'dead', 'final', 'devices')

    def __init__(self, session, addr):
        self.session = session
        self.addr = addr
        self.seq = 0
        self.last_seen = time.monotonic()
        self.wall_ns = 0
        self.mono_us = 0.0
        self.counters = {}
        self.histograms = {}
        self.rings = {}
        self.health = {}
        self.tenants = {}
        self.scheduler = {}
        self.identity = {}
        self.flight = []
        self.clock = None
        self.history = []
        self.ever_live = False
        self.stale = False
        self.dead = False
        self.final = False
        self.devices = {}


class FleetCollector(object):
    """The fleet-side terminus: binds ``bind`` (host, port — port 0
    picks one, read back from :attr:`port`), adopts publishers as
    their messages arrive, and ticks every ``interval`` seconds:
    staleness marking (own ``deadline`` + the attached Membership's
    verdicts), alert evaluation, rollup/Prometheus export, incident
    settling.  ``membership`` is optional: any object with
    ``is_dead(host)``, such as the fabric's
    :class:`bifrost_tpu_torch.fabric.Membership`."""

    def __init__(self, bind=('127.0.0.1', 0), membership=None,
                 rules=None, interval=None, deadline=None,
                 incident_dir=None, history=None, rollup_file=None,
                 prom_file=None):
        self.interval = max(interval if interval is not None
                            else _env_float('BF_FLEET_INTERVAL',
                                            DEFAULT_INTERVAL), 0.05)
        self.deadline = deadline if deadline is not None \
            else _env_float('BF_FLEET_DEADLINE', DEFAULT_DEADLINE)
        self.history_n = max(history if history is not None
                             else _env_int('BF_FLEET_HISTORY',
                                           DEFAULT_HISTORY), 1)
        self.rollup_file = rollup_file if rollup_file is not None \
            else (os.environ.get('BF_FLEET_ROLLUP_FILE') or None)
        self.prom_file = prom_file if prom_file is not None \
            else (os.environ.get('BF_FLEET_PROM_FILE') or None)
        self.membership = membership
        self.engine = AlertEngine(rules if rules is not None
                                  else load_rules())
        self.recorder = IncidentRecorder(self, incident_dir)
        self._sock = socket_mod.socket(socket_mod.AF_INET,
                                       socket_mod.SOCK_DGRAM)
        self._sock.setsockopt(socket_mod.SOL_SOCKET,
                              socket_mod.SO_REUSEADDR, 1)
        self._sock.bind(bind)
        self.bind_host = self._sock.getsockname()[0]
        self.port = self._sock.getsockname()[1]
        self._sock.settimeout(min(self.interval / 2.0, 0.25))
        self._reasm = _Reassembler()
        self._hosts = {}
        self._lock = threading.Lock()
        self._stop_event = threading.Event()
        self._thread = None
        self._proclogs = {}
        self._live_count = 0
        self._dead_seen = set()
        self._escalated = set()      # (host, pipeline, state) seen

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        self._thread = threading.Thread(target=self._loop,
                                        name='bf-fleet-collector',
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop_event.set()
        try:
            self._sock.close()
        except OSError:
            pass
        if self._thread is not None:
            self._thread.join(timeout=self.interval + 2.0)

    def _loop(self):
        next_tick = time.monotonic()
        while not self._stop_event.is_set():
            now = time.monotonic()
            if now >= next_tick:
                try:
                    self.tick()
                except Exception:
                    counters.inc('fleet.tick_errors')
                next_tick = now + self.interval
            try:
                data, addr = self._sock.recvfrom(65535)
            except socket_mod.timeout:
                continue
            except OSError:
                if self._stop_event.is_set():
                    return
                continue
            try:
                msg = self._reasm.feed(data, addr)
            except (ValueError, zlib.error):
                counters.inc('fleet.decode_errors')
                continue
            if msg is not None:
                try:
                    self._handle(msg, addr)
                except Exception:
                    counters.inc('fleet.decode_errors')

    # -- ingest ------------------------------------------------------------
    def _handle(self, msg, addr):
        kind = msg.get('t')
        host = msg.get('host')
        if not host:
            counters.inc('fleet.decode_errors')
            return
        counters.inc('fleet.msgs_rx')
        if kind == 'flight':
            with self._lock:
                st = self._hosts.get(host)
                if st is not None:
                    st.flight = msg.get('events') or []
                    st.clock = msg.get('clock') or st.clock
            self.recorder.note_flight(host, msg)
            return
        if kind == 'event':
            counters.inc('fleet.events_rx')
            self._on_event(host, msg)
            return
        if kind not in ('full', 'delta'):
            counters.inc('fleet.decode_errors')
            return
        session = msg.get('session')
        with self._lock:
            st = self._hosts.get(host)
            adopted = False
            if st is None or st.session != session:
                if kind != 'full':
                    # unknown/restarted publisher mid-delta (or a
                    # collector restart re-adopting a live fleet):
                    # ask for a full — cumulative wire values make
                    # the resync double-count-proof
                    self._request(addr, {'t': 'need_full'})
                    counters.inc('fleet.need_full_tx')
                    return
                st = self._hosts[host] = _HostState(session, addr)
                adopted = True
            st.addr = addr
            seq = int(msg.get('seq', 0))
            gap = kind == 'delta' and seq != st.seq + 1
            st.seq = seq
            st.last_seen = time.monotonic()
            st.wall_ns = int(msg.get('wall_ns', st.wall_ns))
            st.mono_us = float(msg.get('mono_us', st.mono_us))
            if kind == 'full':
                st.counters = dict(msg.get('counters', {}))
                st.histograms = dict(msg.get('histograms', {}))
                st.identity = msg.get('identity', st.identity)
                st.flight = msg.get('flight') or st.flight
                st.devices = dict(msg.get('devices') or {})
                counters.inc('fleet.fulls_rx')
            else:
                st.counters.update(msg.get('counters', {}))
                st.histograms.update(msg.get('histograms', {}))
                counters.inc('fleet.deltas_rx')
            for sect in ('rings', 'health', 'tenants', 'scheduler'):
                if sect in msg:
                    setattr(st, sect, msg[sect])
            st.final = bool(msg.get('final', st.final))
            st.ever_live = True
            st.history.append({
                'wall_ns': st.wall_ns, 'seq': seq, 'type': kind,
                'counters': dict(st.counters), 'rings': st.rings,
                'health': st.health, 'tenants': st.tenants})
            del st.history[:-self.history_n]
        if adopted:
            counters.inc('fleet.hosts_adopted')
        if gap:
            self._request(addr, {'t': 'need_full'})
            counters.inc('fleet.need_full_tx')

    def _on_event(self, host, msg):
        kind = msg.get('kind')
        if kind == 'health':
            state = msg.get('to')
            if state in ('SHEDDING', 'STALLED', 'FAILED'):
                key = (host, msg.get('pipeline'), state)
                if key not in self._escalated:
                    self._escalated.add(key)
                    self.recorder.trigger(
                        'health-%s-%s' % (host, state),
                        {'event': msg.get('kind'), 'host': host,
                         'pipeline': msg.get('pipeline'),
                         'from': msg.get('from'), 'to': state,
                         'reason': msg.get('reason')})

    def _request(self, addr, req):
        try:
            self._sock.sendto(zlib.compress(
                json.dumps(req).encode('utf-8')), addr)
        except OSError:
            pass

    def request_flights(self, incident):
        """Ask every fresh publisher for its current span tail (the
        incident recorder's cross-host capture)."""
        with self._lock:
            addrs = [st.addr for st in self._hosts.values()
                     if not (st.stale or st.dead)]
        for addr in addrs:
            self._request(addr, {'t': 'flight_request',
                                 'incident': incident})

    # -- the periodic tick -------------------------------------------------
    def tick(self, now=None):
        """Staleness + membership verdicts, the hosts_live level,
        alert evaluation, export, incident settling.  Runs on the
        collector thread; callable directly in tests."""
        now = time.monotonic() if now is None else now
        newly_dead = []
        with self._lock:
            live = 0
            for host, st in self._hosts.items():
                st.stale = (now - st.last_seen) > self.deadline
                dead = bool(st.stale and st.final)
                if self.membership is not None:
                    try:
                        dead = dead or self.membership.is_dead(host)
                    except Exception:
                        pass
                if dead and not st.dead:
                    newly_dead.append(host)
                st.dead = dead
                if st.stale and not st.dead:
                    counters.inc('fleet.hosts_stale_ticks')
                if not st.stale and not st.dead:
                    live += 1
            delta = live - self._live_count
            self._live_count = live
        if delta:
            # a LEVEL kept as a counter: inc by the signed change
            counters.inc('fleet.hosts_live', delta)
        for host in newly_dead:
            if host not in self._dead_seen:
                self._dead_seen.add(host)
                counters.inc('fleet.hosts_dead')
                self.recorder.trigger('dead-host-%s' % host,
                                      {'host': host,
                                       'verdict': 'membership'
                                       if self.membership is not None
                                       else 'final+stale'})
        rollup = self.rollup()
        for rule, instance, value in self.engine.evaluate(
                rollup, now=time.time()):
            if rule.incident:
                self.recorder.trigger(
                    'alert-%s' % rule.name,
                    {'rule': rule.name, 'instance': instance,
                     'value': value})
        self.recorder.poll(now)
        self._publish(rollup)

    # -- views -------------------------------------------------------------
    def hosts_snapshot(self):
        """{host: plain-dict state} for the incident writer."""
        out = {}
        with self._lock:
            for host, st in self._hosts.items():
                out[host] = {
                    'session': st.session, 'seq': st.seq,
                    'stale': st.stale, 'dead': st.dead,
                    'age_s': round(time.monotonic() - st.last_seen,
                                   3),
                    'span_origin_wall_ns':
                        int(st.wall_ns - st.mono_us * 1e3),
                    'pid': (st.identity or {}).get('pid') or 0,
                    'flight': list(st.flight),
                    'clock': st.clock,
                    'history': list(st.history),
                }
        return out

    def rollup(self):
        """The merged live fleet view."""
        now = time.monotonic()
        hosts = {}
        tenants = {}
        tenants_seen = {}
        summed = {}
        with self._lock:
            for host, st in sorted(self._hosts.items()):
                fresh = not st.stale and not st.dead
                hosts[host] = {
                    'fresh': fresh, 'stale': st.stale,
                    'dead': st.dead, 'final': st.final,
                    'session': st.session, 'seq': st.seq,
                    'age_s': round(now - st.last_seen, 3),
                    'identity': st.identity,
                    'counters': dict(st.counters),
                    'histograms': dict(st.histograms),
                    'rings': st.rings, 'health': st.health,
                    'tenants': st.tenants,
                    'scheduler': st.scheduler,
                }
                if st.devices:
                    hosts[host]['devices'] = st.devices
                for k, v in st.counters.items():
                    if isinstance(v, (int, float)):
                        summed[k] = summed.get(k, 0) + v
                for tid, entry in (st.tenants or {}).items():
                    tenants_seen[tid] = host
                    if fresh or tid not in tenants:
                        d = dict(entry) if isinstance(entry, dict) \
                            else {'value': entry}
                        d['host'] = host
                        d['host_fresh'] = fresh
                        if fresh:
                            tenants[tid] = d
                        else:
                            tenants.setdefault(tid, d)
            live = self._live_count
        return {
            'wall_ns': time.time_ns(),
            'hosts': hosts,
            'tenants': tenants,
            'tenants_seen': tenants_seen,
            'counters': summed,
            'fleet': {
                'hosts_seen': len(hosts),
                'hosts_live': live,
                'hosts_stale': sorted(h for h, e in hosts.items()
                                      if e['stale'] and not e['dead']),
                'hosts_dead': sorted(h for h, e in hosts.items()
                                     if e['dead']),
            },
            'alerts': {
                'active': self.engine.active(),
                'history': self.engine.history[-32:],
                'counters': {
                    'fired': counters.get('alerts.fired'),
                    'resolved': counters.get('alerts.resolved'),
                    'suppressed': counters.get('alerts.suppressed'),
                },
            },
        }

    def prometheus_text(self, rollup=None):
        """The MERGED fleet view in Prometheus exposition format:
        every per-host counter labeled {host,name}, tenant series
        labeled {host,tenant,kind}, host liveness and the firing
        alerts as gauges."""
        if rollup is None:
            rollup = self.rollup()
        esc = _prom_esc
        lines = ['# bifrost_tpu fleet rollup (telemetry.fleet)']
        lines.append('# TYPE bifrost_tpu_fleet_up gauge')
        for host, e in sorted(rollup['hosts'].items()):
            lines.append('bifrost_tpu_fleet_up{host="%s"} %d'
                         % (esc(host), 1 if e['fresh'] else 0))
        lines.append('# TYPE bifrost_tpu_fleet_counter_total counter')
        for host, e in sorted(rollup['hosts'].items()):
            for name in sorted(e['counters']):
                lines.append(
                    'bifrost_tpu_fleet_counter_total{host="%s",'
                    'name="%s"} %d' % (esc(host), esc(name),
                                       int(e['counters'][name])))
        lines.append('# TYPE bifrost_tpu_fleet_hist gauge')
        for host, e in sorted(rollup['hosts'].items()):
            for name, h in sorted(e['histograms'].items()):
                for q in ('p50', 'p99'):
                    if q in h:
                        lines.append(
                            'bifrost_tpu_fleet_hist{host="%s",'
                            'name="%s",q="%s"} %g'
                            % (esc(host), esc(name), q, h[q]))
        lines.append('# TYPE bifrost_tpu_fleet_tenant gauge')
        for tid, e in sorted(rollup['tenants'].items()):
            for key in ('gulps', 'bytes', 'quota_shed_gulps',
                        'ring_shed_gulps'):
                v = e.get(key)
                if isinstance(v, (int, float)):
                    lines.append(
                        'bifrost_tpu_fleet_tenant{host="%s",'
                        'tenant="%s",kind="%s"} %d'
                        % (esc(e.get('host', '?')), esc(tid),
                           esc(key), int(v)))
        lines.append('# TYPE bifrost_tpu_fleet_hosts gauge')
        f = rollup['fleet']
        for state, v in (('seen', f['hosts_seen']),
                         ('live', f['hosts_live']),
                         ('stale', len(f['hosts_stale'])),
                         ('dead', len(f['hosts_dead']))):
            lines.append('bifrost_tpu_fleet_hosts{state="%s"} %d'
                         % (state, v))
        lines.append('# TYPE bifrost_tpu_fleet_alert gauge')
        for a in rollup['alerts']['active']:
            lines.append('bifrost_tpu_fleet_alert{name="%s",'
                         'instance="%s",severity="%s"} 1'
                         % (esc(a['name']), esc(a['instance']),
                            esc(a['severity'])))
        return '\n'.join(lines) + '\n'

    # -- export ------------------------------------------------------------
    def _proclog(self, name):
        log = self._proclogs.get(name)
        if log is None:
            from ..proclog import ProcLog
            log = self._proclogs[name] = ProcLog(name)
        return log

    def _publish(self, rollup):
        try:
            f = rollup['fleet']
            self._proclog('fleet/rollup').update({
                'hosts': f['hosts_seen'], 'live': f['hosts_live'],
                'stale': ','.join(f['hosts_stale']) or '-',
                'dead': ','.join(f['hosts_dead']) or '-',
                'tenants': len(rollup['tenants']),
                'alerts_firing': len(rollup['alerts']['active']),
            }, force=True)
            act = rollup['alerts']['active']
            self._proclog('alerts/active').update({
                'active': len(act),
                'firing': ';'.join('%s@%s' % (a['name'],
                                              a['instance'])
                                   for a in act[:8]) or '-',
                'fired': counters.get('alerts.fired'),
                'resolved': counters.get('alerts.resolved'),
                'suppressed': counters.get('alerts.suppressed'),
            }, force=True)
        except Exception:
            pass
        if self.rollup_file:
            try:
                _write_json(self.rollup_file, rollup)
            except OSError:
                pass
        if self.prom_file:
            try:
                text = self.prometheus_text(rollup)
                tmp = '%s.tmp%d' % (self.prom_file, os.getpid())
                with open(tmp, 'w') as fh:
                    fh.write(text)
                os.replace(tmp, self.prom_file)
            except OSError:
                pass


def _prom_esc(value):
    return str(value).replace('\\', r'\\').replace('"', r'\"') \
                     .replace('\n', r'\n')
