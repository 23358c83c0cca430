"""The port's fleet plane (``bifrost_tpu_torch.telemetry.fleet``) against
the JAX package's (``bifrost_tpu.telemetry.fleet``).

- The JAX package's own fleet tests (``tests/test_fleet.py``) run against
  the port's modules (:func:`rehome`), but for the two that drive JAX
  tools the port does not have (``trace_merge``, ``telemetry_diff``);
  the ``like_top --fleet`` test runs against the port's monitor.
- The ``BFT1`` wire: both packages write the same datagrams for the same
  message, chunked or not, and each reassembles the other's in any order.
- A JAX publisher feeds a port collector and the reverse: the rollups
  equal the same-package rollups, apart from host identity, sessions,
  timestamps and each package's own fleet counters.
- The same rules and rollup sequence make both alert engines fire and
  clear the same events; the same messages make both collectors ask for
  the same resyncs and flights; an incident bundle has the JAX layout.
- Real loopback UDP both ways, and the exporter's hook under
  ``BF_FLEET_COLLECTOR``.

Tolerance: exact (bytes, decisions, events, keys).  Alert and staleness
clocks are driven with explicit ``now`` values; the loopback cases wait
for a datagram, bounded, and assert no interval or order.
"""

import inspect
import json
import os
import random
import sys
import threading
import time

import numpy as np
import pytest

from bifrost_tpu.telemetry import counters as jcounters
from bifrost_tpu.telemetry import fleet as JF
from bifrost_tpu.telemetry import histograms as jhistograms
from bifrost_tpu.telemetry import spans as jspans

import bifrost_tpu_torch as bt
from bifrost_tpu_torch import device
from bifrost_tpu_torch.telemetry import counters as tcounters
from bifrost_tpu_torch.telemetry import exporter as texporter
from bifrost_tpu_torch.telemetry import fleet as TF
from bifrost_tpu_torch.telemetry import histograms as thistograms
from bifrost_tpu_torch.telemetry import spans as tspans
from bifrost_tpu_torch.tools import like_top as tlike_top

from tests import test_fleet as JT
from tests.test_torch_bounded import run_bounded
from tests.test_torch_supervision import TorchGatherSink, TorchNumpySourceBlock
from tests.test_torch_wire_formats import rehome
from tests.util import simple_header

#: seconds a loopback case may wait for its datagrams
TIMEOUT = 20.

FLEET_MAP = {'bifrost_tpu.telemetry': bt.telemetry,
             'bifrost_tpu.telemetry.counters': tcounters,
             'bifrost_tpu.telemetry.histograms': thistograms,
             'bifrost_tpu.telemetry.fleet': TF,
             'like_top': tlike_top}

PKG = {'port': (TF, tcounters, thistograms, tspans),
       'jax': (JF, jcounters, jhistograms, jspans)}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    device.set_device('cpu')
    # the JAX publisher's tenant and scheduler sections as they are when
    # its service tier is not imported (another test in this process may
    # have imported it); the port's stay empty until item 13b
    from bifrost_tpu.telemetry import exporter as jexporter
    monkeypatch.setattr(jexporter, '_tenant_section', lambda: {})
    monkeypatch.setattr(jexporter, '_scheduler_section', lambda: {})
    for var in ('BF_FLEET_COLLECTOR', 'BF_FLEET_HOST', 'BF_FLEET_INTERVAL',
                'BF_FLEET_FULL_EVERY', 'BF_FLEET_DEADLINE',
                'BF_FLEET_HISTORY', 'BF_FLEET_ROLLUP_FILE',
                'BF_FLEET_PROM_FILE', 'BF_FLEET_INCIDENT_DIR',
                'BF_FLEET_INCIDENT_COOLDOWN', 'BF_FLEET_SETTLE',
                'BF_ALERT_RULES', 'BF_ALERT_LOG', 'BF_ALERT_WEBHOOK'):
        monkeypatch.delenv(var, raising=False)
    for mod in (tcounters, jcounters, thistograms, jhistograms):
        mod.reset()
    yield
    for mod in (tcounters, jcounters, thistograms, jhistograms):
        mod.reset()


# ---------------------------------------------------------------------------
# the JAX package's fleet tests, on the port
# ---------------------------------------------------------------------------

JT_TESTS = sorted(n for n in dir(JT) if n.startswith('test_') and n not in
                  ('test_trace_merge_consumes_bundle',
                   'test_telemetry_diff_watches_fleet_counters'))


@pytest.mark.parametrize('name', JT_TESTS)
def test_jax_fleet_test_on_the_port(name, monkeypatch, tmp_path):
    fn = getattr(JT, name)
    fixtures = {'monkeypatch': monkeypatch, 'tmp_path': tmp_path}
    args = [fixtures[a] for a in inspect.signature(fn).parameters]
    rehome(fn, FLEET_MAP)(*args)


def test_rehome_reaches_the_port_fleet():
    coll = rehome(JT.make_collector, FLEET_MAP)()
    try:
        assert isinstance(coll, TF.FleetCollector)
    finally:
        coll._sock.close()


# ---------------------------------------------------------------------------
# the wire
# ---------------------------------------------------------------------------

def _big_message(seed=5, n=12000):
    """A message whose compressed JSON spans several chunks."""
    rng = random.Random(seed)
    cnts = {'c.%08x' % rng.getrandbits(32): rng.getrandbits(40)
            for _ in range(n)}
    return {'t': 'full', 'host': 'h1', 'session': 's1', 'seq': 1,
            'counters': cnts}


@pytest.mark.parametrize('msg', [{'t': 'full', 'host': 'h1', 'n': 3},
                                 _big_message()], ids=['one', 'chunked'])
def test_frames_equal_and_each_reassembles_the_other(msg):
    assert TF._MAGIC == JF._MAGIC and TF._CHUNK == JF._CHUNK
    assert TF._HEADER.format == JF._HEADER.format
    frames = TF._encode(msg, 77)
    assert frames == JF._encode(msg, 77)
    for src, dst in ((TF, JF), (JF, TF)):
        order = list(src._encode(msg, 78))
        random.Random(1).shuffle(order)
        r = dst._Reassembler()
        outs = [r.feed(f, ('127.0.0.1', 9)) for f in order]
        assert outs[:-1] == [None] * (len(order) - 1)
        assert outs[-1] == msg
    if len(frames) > 1:
        assert len(frames) >= 3


def test_corrupt_frames_rejected_alike():
    good = TF._encode({'t': 'full', 'host': 'h'}, 3)[0]
    for bad in (b'xx', b'XXXX' + good[4:], good[:10] + b'\x00\x00' +
                good[12:], good[:8] + b'\x00\x05' + good[10:]):
        for mod in (TF, JF):
            with pytest.raises(ValueError):
                mod._Reassembler().feed(bad, ('127.0.0.1', 1))


# ---------------------------------------------------------------------------
# publishers into either collector
# ---------------------------------------------------------------------------

def _seed(pkg, step):
    """The same counters and histogram samples in ``pkg``'s registries."""
    _F, counters, histograms, _s = PKG[pkg]
    counters.inc('block.src.gulps', 5 + step)
    counters.inc('kernel.fused_spectrometer.launches', 3)
    if step:
        counters.inc('pipeline.sync_waits', 2)
    for v in (1e-3, 2e-3, 4e-3 * (step + 1)):
        histograms.observe('ring.r.reserve_s', v)


def _wire_feed(pub_mod, coll):
    """Send each of a publisher's messages through the wire encoder of
    its own package into ``coll``'s reassembler and handler."""
    addr = ('127.0.0.1', 40000)

    def send(msg):
        for frame in pub_mod._encode(msg, 1):
            out = coll._reasm.feed(frame, addr)
            if out is not None:
                coll._handle(out, addr)
    return send


def _volatile(name):
    return name.split('.')[0] in ('fleet', 'alerts', 'incident', 'trace')


def _normal(rollup):
    """A rollup without what differs by process, clock or package: host
    identity, sessions, ages, timestamps, ring and health sections and
    each package's own fleet/alert counters."""
    out = {}
    for host, e in rollup['hosts'].items():
        e = dict(e)
        for k in ('identity', 'session', 'age_s', 'rings', 'health'):
            e.pop(k)
        e['counters'] = {k: v for k, v in e['counters'].items()
                         if not _volatile(k)}
        e['histograms'] = {k: v for k, v in e['histograms'].items()
                           if not _volatile(k)}
        out[host] = e
    summed = {k: v for k, v in rollup['counters'].items()
              if not _volatile(k)}
    fleet = dict(rollup['fleet'])
    return {'hosts': out, 'counters': summed, 'fleet': fleet,
            'tenants': rollup['tenants'],
            'tenants_seen': rollup['tenants_seen'],
            'alerts': {k: v for k, v in rollup['alerts'].items()
                       if k != 'counters'}}


def _roll(pub_pkg, coll_pkg):
    for mod in (tcounters, jcounters, thistograms, jhistograms):
        mod.reset()
    PF = PKG[pub_pkg][0]
    CF = PKG[coll_pkg][0]
    coll = CF.FleetCollector(rules=[], interval=0.1, deadline=5.0)
    pub = PF.FleetPublisher(collector=('127.0.0.1', coll.port), host='h1',
                            interval=0.1, full_every=10)
    try:
        pub._send = _wire_feed(PF, coll)
        _seed(pub_pkg, 0)
        pub.publish()                       # full (first publish)
        _seed(pub_pkg, 1)
        pub.publish()                       # delta
        pub.publish(full=True, final=True)
        coll.tick(now=coll._hosts['h1'].last_seen)
        return coll.rollup(), coll
    finally:
        pub._sock.close()
        coll._sock.close()


@pytest.mark.parametrize('pub_pkg,coll_pkg', [('jax', 'port'),
                                              ('port', 'jax')])
def test_publisher_feeds_the_other_packages_collector(pub_pkg, coll_pkg):
    cross, coll = _roll(pub_pkg, coll_pkg)
    same, _ = _roll(pub_pkg, pub_pkg)
    assert _normal(cross) == _normal(same)
    host = cross['hosts']['h1']
    assert host['final'] and host['fresh'] and host['seq'] == 3
    assert host['counters']['kernel.fused_spectrometer.launches'] == 6
    assert host['histograms']['ring.r.reserve_s']['count'] == 6
    assert host['tenants'] == {} and host['scheduler'] == {}


def test_both_publishers_give_equal_rollups():
    """Port and JAX publishers with the same telemetry produce the same
    rollup in either collector."""
    for coll_pkg in ('port', 'jax'):
        a, _ = _roll('port', coll_pkg)
        b, _ = _roll('jax', coll_pkg)
        assert _normal(a) == _normal(b)


def test_full_snapshot_carries_the_card_memory_section(monkeypatch):
    """Where CUDA is in use, a full snapshot carries the exporter's
    device section; the port's collector keeps it per host, the JAX
    collector ignores it.  (Here the section is faked: no card.)"""
    fake = {0: {'platform': 'cuda', 'bytes_in_use': 123,
                'bytes_limit': 80 << 30}}
    monkeypatch.setattr(texporter, '_device_stats', lambda: fake)
    got = {}
    for coll_pkg in ('port', 'jax'):
        rollup, _ = _roll('port', coll_pkg)
        got[coll_pkg] = rollup['hosts']['h1'].get('devices')
    assert got == {'port': {'0': fake[0]}, 'jax': None}
    monkeypatch.setattr(texporter, '_device_stats', lambda: {})
    rollup, _ = _roll('port', 'port')
    assert 'devices' not in rollup['hosts']['h1']


# ---------------------------------------------------------------------------
# resync and flight requests
# ---------------------------------------------------------------------------

def _request_log(pkg):
    F, counters, _h, _s = PKG[pkg]
    counters.reset()
    coll = F.FleetCollector(rules=[], interval=0.1, deadline=5.0)
    log = []
    coll._request = lambda addr, req: log.append((addr, dict(req)))
    a, b = ('127.0.0.1', 50100), ('127.0.0.1', 50101)
    try:
        coll._handle(JT.delta_msg(host='h9'), a)       # unknown: resync
        coll._handle(JT.full_msg(cnts={'x': 1}), a)
        coll._handle(JT.delta_msg(seq=2, cnts={'x': 2}), a)
        coll._handle(JT.delta_msg(seq=4, cnts={'x': 4}), a)   # gap
        coll._handle(JT.delta_msg(session='s2', seq=5), a)    # restart
        coll._handle(JT.full_msg(host='h2', session='z'), b)
        coll.request_flights(3)
        coll.tick(now=coll._hosts['h1'].last_seen + 10.0)     # all stale
        coll.request_flights(4)
        snap = counters.snapshot()
        return log, {k: v for k, v in snap.items()
                     if k.startswith('fleet.')}
    finally:
        coll._sock.close()


def test_resync_and_flight_requests_equal_jax():
    port, jax = _request_log('port'), _request_log('jax')
    assert port == jax
    log, cnts = port
    kinds = [req['t'] for _a, req in log]
    assert kinds == ['need_full', 'need_full', 'need_full',
                     'flight_request', 'flight_request']
    assert cnts['fleet.need_full_tx'] == 3


def test_flight_reply_equal_jax():
    """A publisher answers ``flight_request`` with its span tail
    (``spans.flight_events``) in the same message shape."""
    replies = {}
    for pkg in ('port', 'jax'):
        F, counters, _h, spans = PKG[pkg]
        spans.reset()
        spans.enable_flight_recorder()
        try:
            spans.record('on_data', 'blocks', 100.0, 5.0, {'n': 1})
            spans.record('reserve', 'ring', 90.0, 2.0)
            assert spans.flight_events() == \
                [[threading.current_thread().name, 'reserve', 'ring',
                  90.0, 2.0, None],
                 [threading.current_thread().name, 'on_data', 'blocks',
                  100.0, 5.0, {'n': 1}]]
            pub = F.FleetPublisher(collector=('127.0.0.1', 9), host='h',
                                   interval=0.1)
            sent = []
            pub._send = sent.append
            pub._handle_request({'t': 'flight_request', 'incident': 7})
            pub._handle_request({'t': 'need_full'})
            pub._sock.close()
        finally:
            spans.disable_flight_recorder()
            spans.reset()
        msg = dict(sent[0])
        for k in ('session', 'wall_ns', 'mono_us', 'clock'):
            assert k in msg
            msg.pop(k)
        replies[pkg] = (msg, pub._need_full,
                        counters.get('fleet.pub.flight_replies'),
                        counters.get('fleet.pub.full_requests'))
    assert replies['port'] == replies['jax']
    assert replies['port'][0]['incident'] == 7


# ---------------------------------------------------------------------------
# alert engines
# ---------------------------------------------------------------------------

RULES = [
    {'name': 'hot', 'kind': 'threshold', 'metric': 'counters.errors',
     'op': '>', 'value': 2, 'for_ticks': 2, 'clear_ticks': 2},
    {'name': 'fill', 'kind': 'threshold', 'metric': 'rings.*.fill',
     'op': '>=', 'value': 0.9},
    {'name': 'grow', 'kind': 'delta', 'metric': 'counters.gulps',
     'op': '<', 'value': 1, 'window_s': 3.0, 'for_ticks': 2},
    {'name': 'rate', 'kind': 'rate', 'metric': 'counters.gulps',
     'op': '>', 'value': 4, 'window_s': 2.0},
    {'name': 'fleet', 'kind': 'threshold', 'scope': 'fleet',
     'metric': 'counters.errors', 'op': '>=', 'value': 5},
    {'name': 'gone', 'kind': 'absence', 'host': 'h*', 'incident': True},
    {'name': 'ghost', 'kind': 'absence', 'host': 'never'},
    {'name': 'tenant', 'kind': 'absence', 'tenant': 'vic'},
]


def _rollups():
    """(now, rollup) steps over two hosts: errors climb and fall, a ring
    fills, gulps stall, h2 goes stale and comes back, a tenant moves."""
    steps = []
    for i in range(12):
        h1 = {'fresh': True, 'stale': False, 'dead': False,
              'counters': {'errors': [0, 3, 4, 4, 1, 0, 0, 3, 3, 0, 0,
                                      0][i],
                           'gulps': [0, 5, 10, 10, 10, 10, 10, 10, 30,
                                     31, 32, 40][i]},
              'histograms': {}, 'rings': {'r0': {'fill': 0.95 if i in
                                                 (2, 3, 8) else 0.1}},
              'tenants': {'vic': {}} if i < 6 else {}}
        stale = i in (4, 5, 6)
        h2 = {'fresh': not stale, 'stale': stale, 'dead': False,
              'counters': {'errors': 2}, 'histograms': {}, 'rings': {},
              'tenants': {'vic': {}} if i >= 9 else {}}
        hosts = {'h1': h1, 'h2': h2}
        steps.append((1000.0 + i, {
            'hosts': hosts,
            'counters': {'errors': h1['counters']['errors'] + 2},
            'tenants_seen': {'vic': 'h1'}}))
    return steps


def _alerts(pkg, tmp_path):
    F, counters, _h, _s = PKG[pkg]
    counters.reset()
    log = tmp_path / ('%s.log' % pkg)
    eng = F.AlertEngine(F.load_rules(RULES), log_path=str(log))
    fired = []
    for now, rollup in _rollups():
        fired.append([(r.name, inst, v)
                      for r, inst, v in eng.evaluate(rollup, now=now)])
    lines = [json.loads(x) for x in log.read_text().splitlines()]
    return (eng.history, eng.status(), eng.active(), fired, lines,
            {k: counters.get('alerts.' + k)
             for k in ('fired', 'resolved', 'suppressed')})


def test_alert_engines_fire_and_clear_the_same_events(tmp_path):
    port, jax = _alerts('port', tmp_path), _alerts('jax', tmp_path)
    assert port == jax
    history = port[0]
    events = {(e['name'], e['event']) for e in history}
    for name in ('hot', 'fill', 'grow', 'gone'):
        assert (name, 'FIRING') in events and (name, 'RESOLVED') in events
    assert port[1]['ghost@host:never'] == 'unknown'


def test_rule_validation_equal_jax():
    bad = [{'kind': 'threshold'}, {'name': 'x', 'kind': 'nope'},
           {'name': 'x', 'op': '~'}, {'name': 'x', 'kind': 'absence'},
           {'name': 'x'}, {'name': 'x', 'metric': 'm', 'extra': 1}]
    for spec in bad:
        msgs = []
        for F in (TF, JF):
            with pytest.raises(F.AlertRuleError) as err:
                F.load_rules([spec])
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]


# ---------------------------------------------------------------------------
# incident bundles
# ---------------------------------------------------------------------------

def _tree(path):
    out = {}
    for dirpath, _dirs, files in os.walk(path):
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), path)
            with open(os.path.join(dirpath, f)) as fh:
                out[rel] = json.load(fh)
    return out


def _keys(obj):
    if isinstance(obj, dict):
        return {k: _keys(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_keys(v) for v in obj[:1]]
    return type(obj).__name__


def _bundle(pkg, tmp_path):
    F, counters, _h, _s = PKG[pkg]
    counters.reset()
    coll = F.FleetCollector(rules=F.load_rules(RULES[:2]), interval=0.1,
                            deadline=5.0,
                            incident_dir=str(tmp_path / pkg))
    coll._request = lambda addr, req: None
    try:
        coll.recorder.settle = 0.0
        coll._handle(JT.full_msg(cnts={'errors': 4}, flight=JT._flight()),
                     ('127.0.0.1', 50200))
        coll._handle(JT.full_msg(host='h2', session='s2', flight=JT._flight(
            2), wall_ns=1000002000000), ('127.0.0.1', 50201))
        coll.tick(now=coll._hosts['h1'].last_seen)
        path = coll.recorder.trigger('drill', {'why': 'test'})
        coll.recorder.note_flight('h2', {'events': JT._flight(1),
                                         'wall_ns': 5, 'mono_us': 0.0})
        coll.recorder.poll(now=float('inf'))
        return os.path.basename(path), _tree(path)
    finally:
        coll._sock.close()


def test_incident_bundle_has_the_jax_layout(tmp_path):
    (pname, port), (jname, jax) = (_bundle('port', tmp_path),
                                   _bundle('jax', tmp_path))
    assert pname == jname == 'incident_001_drill'
    assert sorted(port) == sorted(jax) == sorted([
        'meta.json', 'rollup.json', 'alerts.json', 'post/rollup.json',
        'hosts/h1/flight.json', 'hosts/h1/snapshots.json',
        'hosts/h2/flight.json', 'hosts/h2/snapshots.json'])
    for rel in port:
        assert _keys(port[rel]) == _keys(jax[rel]), rel
    for rel in ('hosts/h1/flight.json', 'hosts/h2/flight.json',
                'hosts/h1/snapshots.json', 'alerts.json'):
        assert port[rel] == jax[rel], rel
    pm, jm = dict(port['meta.json']), dict(jax['meta.json'])
    for m in (pm, jm):
        m.pop('wall_ns')
        for h in m['hosts'].values():
            h.pop('age_s')
    assert pm == jm


# ---------------------------------------------------------------------------
# loopback UDP and the exporter's hook
# ---------------------------------------------------------------------------

def _wait(pred, timeout=TIMEOUT):
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.01)
    return True


@pytest.mark.parametrize('pub_pkg,coll_pkg', [('jax', 'port'),
                                              ('port', 'jax')])
def test_loopback_publisher_into_the_other_collector(pub_pkg, coll_pkg):
    PF, pcounters, _h, _s = PKG[pub_pkg]
    CF = PKG[coll_pkg][0]
    coll = CF.FleetCollector(rules=[], interval=0.05, deadline=30.0)
    coll.start()
    pub = PF.FleetPublisher(collector=('127.0.0.1', coll.port),
                            host='loop-%s' % pub_pkg, interval=0.05)
    try:
        pcounters.inc('block.src.gulps', 11)
        pub.start()
        assert _wait(lambda: coll.rollup()['hosts'].get(
            'loop-%s' % pub_pkg, {}).get('counters', {}).get(
                'block.src.gulps') == 11)
    finally:
        pub.stop()
        coll.stop()
    assert not pub.is_alive()


def test_metrics_publisher_streams_a_pipeline_to_the_collector(
        monkeypatch):
    """``BF_FLEET_COLLECTOR`` arms the shared publisher for the run of a
    port pipeline (``MetricsPublisher`` acquires and releases it); the
    collector sees the pipeline's block counters and the final full
    snapshot."""
    coll = TF.FleetCollector(rules=[], interval=0.05, deadline=30.0)
    coll.start()
    monkeypatch.setenv('BF_FLEET_COLLECTOR', '127.0.0.1:%d' % coll.port)
    monkeypatch.setenv('BF_FLEET_HOST', 'pipe-host')
    monkeypatch.setenv('BF_FLEET_INTERVAL', '0.05')
    try:
        hdr = simple_header([-1, 4], 'f32', labels=['time', 'freq'])
        gulps = [np.full((8, 4), k, np.float32) for k in range(6)]
        with bt.Pipeline() as p:
            src = TorchNumpySourceBlock(gulps, hdr, gulp_nframe=8)
            TorchGatherSink(bt.blocks.copy(src, space='system'))
        run_bounded(p)
        assert TF._singleton is None            # released after run()

        def final():
            e = coll.rollup()['hosts'].get('pipe-host', {})
            return e.get('final') and any(
                k.startswith('block.') and k.endswith('.gulps')
                for k in e.get('counters', {}))
        assert _wait(final)
    finally:
        coll.stop()
    assert tcounters.get('fleet.pub.msgs') >= 1
    assert tcounters.get('fleet.pub.busy_us') >= 0


def test_like_top_fleet_once_renders_the_rollup_file(tmp_path):
    """``python -m bifrost_tpu_torch.tools.like_top --fleet PATH --once``
    prints the collector's rollup file."""
    import subprocess
    path = tmp_path / 'rollup.json'
    coll = TF.FleetCollector(rules=[], interval=0.1, deadline=5.0,
                             rollup_file=str(path))
    try:
        coll._handle(JT.full_msg(host='edge-1'), ('127.0.0.1', 50300))
        coll.tick()
    finally:
        coll._sock.close()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root, CUDA_VISIBLE_DEVICES='')
    res = subprocess.run([sys.executable, '-m',
                          'bifrost_tpu_torch.tools.like_top', '--fleet',
                          str(path), '--once'], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert '1 live' in res.stdout and 'edge-1' in res.stdout
