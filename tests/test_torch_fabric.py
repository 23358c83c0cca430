"""The port's multi-host fabric (``bifrost_tpu_torch.fabric``) against the
JAX package's (``bifrost_tpu.fabric``), over loopback.

- The JAX package's own fabric tests (``tests/test_fabric.py``) run
  against the port's modules (:func:`rehome_method`), with the port's
  twins of its two source classes; the verify-topology test, which reads
  the JAX benchmark suite, has a counterpart through both packages below.
- Interop on one FabricSpec: a JAX ``stations`` host feeding a port
  ``xhost`` and the reverse (the FX examples' chains; the data frames
  equal the source byte for byte and the visibilities the single-host
  run's), heartbeats of one package heard by the other's Membership, an
  AckLedger journal written by one package and read by the other (the
  files equal byte for byte), and a rejoin across the packages that
  replays only the unacked frames.
- Through both packages: spec round trips, the verifier's codes and
  messages, the re-striping drill's stripes and ``fabric.*`` counters.
- The port's ``bf_fabric`` tool: lint, up (two host processes) and
  status.

Membership death is driven by stopping a member's beats or by a stub;
receiver rings are read by a pipeline from their first sequence; every
run, join and wait is bounded, and no test asserts a rate.
"""

import importlib.util
import inspect
import json
import os
import socket
import subprocess
import sys
import threading
import time
import types

import numpy as np
import pytest

import bifrost_tpu as bf
from bifrost_tpu import fabric as JF
from bifrost_tpu import proclog as JP
from bifrost_tpu.analysis import verify as JV
from bifrost_tpu.io import bridge as JB
from bifrost_tpu import ring as JR
from bifrost_tpu.telemetry import counters as jcounters

import bifrost_tpu_torch as bt
from bifrost_tpu_torch import device
from bifrost_tpu_torch import fabric as TF
from bifrost_tpu_torch import proclog as TP
from bifrost_tpu_torch import ring as TR
from bifrost_tpu_torch.analysis import verify as TV
from bifrost_tpu_torch.io import bridge as TB
from bifrost_tpu_torch.telemetry import counters as tcounters
from bifrost_tpu_torch.telemetry import histograms as thistograms

from tests import test_fabric as JT
from tests.test_torch_bridge import StaticNumpySource, bounded
from tests.test_torch_supervision import TorchGatherSink, _Reader
from tests.test_torch_wire_formats import rehome_method
from tests.util import GatherSink as JGatherSink
from tests.util import NumpySourceBlock as JNumpySource
from tests.util import simple_header

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 60.
NT, NC = JT.NT, JT.NC


class PortReader(_Reader):
    """``tests/util.py:_NumpyReader`` for the port's numpy source."""

    def __init__(self, arrays):
        super(PortReader, self).__init__(arrays)
        self.pos = 0


class PortMultiSeqSource(StaticNumpySource):
    """``tests/test_fabric.py:_MultiSeqSource`` on the port: NSEQ short
    sequences of 4 gulps each."""

    def __init__(self, nseq, hdr, **kwargs):
        StaticNumpySource.__init__(self, [], hdr, NT,
                                   names=['s%d' % i for i in range(nseq)],
                                   **kwargs)

    def create_reader(self, name):
        return PortReader(JT._gulps(int(name[1:]), 4))

    def on_sequence(self, reader, name):
        reader.pos = 0
        hdr = dict(self._header)
        hdr['name'] = name
        return [hdr]


class PortStallingSource(StaticNumpySource):
    """``tests/test_fabric.py:_StallingSource`` on the port: one sequence
    whose gulps stall for ``stall_secs`` after ``stall_after`` gulps."""

    def __init__(self, gulps, hdr, stall_after, stall_secs, **kw):
        StaticNumpySource.__init__(self, gulps, hdr, NT, **kw)
        self._n = 0
        self._stall_after = stall_after
        self._stall_secs = stall_secs

    def on_data(self, reader, ospans):
        self._n += 1
        if self._n == self._stall_after + 1:
            time.sleep(self._stall_secs)
        return StaticNumpySource.on_data(self, reader, ospans)


_util = types.ModuleType('tests.util')
_util.simple_header = simple_header
_util.NumpySourceBlock = StaticNumpySource
_util.GatherSink = TorchGatherSink
_util._NumpyReader = PortReader

FABRIC_MAP = {'bifrost_tpu': bt,
              'bifrost_tpu.fabric': TF,
              'bifrost_tpu.proclog': TP,
              'bifrost_tpu.ring': TR,
              'bifrost_tpu.io.bridge': TB,
              'bifrost_tpu.analysis': bt.analysis,
              'bifrost_tpu.analysis.verify': TV,
              'bifrost_tpu.telemetry': bt.telemetry,
              'bifrost_tpu.telemetry.counters': tcounters,
              'bifrost_tpu.telemetry.histograms': thistograms,
              'util': _util, 'tests.util': _util}

PKG = {'jax': types.SimpleNamespace(bf=bf, fabric=JF, bridge=JB, ring=JR,
                                    counters=jcounters, Gather=JGatherSink,
                                    Source=JNumpySource,
                                    MultiSeq=JT._MultiSeqSource),
       'port': types.SimpleNamespace(bf=bt, fabric=TF, bridge=TB, ring=TR,
                                     counters=tcounters,
                                     Gather=TorchGatherSink,
                                     Source=StaticNumpySource,
                                     MultiSeq=PortMultiSeqSource)}
OTHER = {'jax': 'port', 'port': 'jax'}


@pytest.fixture(autouse=True)
def _fabric_env(tmp_path, monkeypatch):
    """JAX's fixture: durable fabric state per test, snappy membership
    timers; and the CPU device."""
    device.set_device('cpu')
    monkeypatch.setenv('BF_FABRIC_STATE', str(tmp_path / 'state'))
    monkeypatch.setenv('BF_FABRIC_HEARTBEAT_SECS', '0.05')
    monkeypatch.setenv('BF_FABRIC_DEADLINE_SECS', '0.4')
    monkeypatch.setenv('BF_FABRIC_REJOIN_CAP', '0.05')
    yield
    TP.set_identity(None)
    JP.set_identity(None)


# ---------------------------------------------------------------------------
# the JAX package's fabric tests, on the port
# ---------------------------------------------------------------------------

JT_CASES = sorted(
    (cls.__name__, name) for cls in (
        JT.TestFabricSpec, JT.TestVerifyFabric, JT.TestFanOutLoopback,
        JT.TestFanIn, JT.TestRejoin, JT.TestMembership,
        JT.TestAffinityAndIdentity, JT.TestIntegration)
    for name in vars(cls) if name.startswith('test_') and
    # reads the JAX benchmark suite; test_verify_topology_clean_* below
    name != 'test_verify_topology_clean')


@pytest.mark.parametrize('case', JT_CASES, ids=['::'.join(c)
                                                for c in JT_CASES])
def test_jax_fabric_test_on_the_port(case, request):
    cls, name = getattr(JT, case[0]), case[1]
    fn = getattr(cls, name)
    args = [request.getfixturevalue(a)
            for a in list(inspect.signature(fn).parameters)[1:]]
    bounded(rehome_method(cls, name, FABRIC_MAP,
                          _MultiSeqSource=PortMultiSeqSource,
                          _StallingSource=PortStallingSource), *args,
            timeout=120)


def test_rehome_reaches_the_port_fabric():
    spec = rehome_method(JT.TestFanOutLoopback, '_spec', FABRIC_MAP)(2)
    assert isinstance(spec, TF.FabricSpec)


def test_state_dir_defaults_to_the_port_home(monkeypatch):
    monkeypatch.delenv('BF_FABRIC_STATE')
    assert TF.fabric_state_dir() == os.path.join(
        os.path.expanduser('~'), '.bifrost_tpu_torch', 'fabric')
    monkeypatch.setenv('BF_FABRIC_STATE', '/x/y')
    assert TF.fabric_state_dir() == JF.fabric_state_dir() == '/x/y'


# ---------------------------------------------------------------------------
# specs and the verifier through both packages
# ---------------------------------------------------------------------------

SPECS = {
    'roundtrip': {'name': 't', 'hosts': {
        'a': {'address': '10.0.0.1', 'control_port': 7000,
              'cores': [0, 1], 'role': 'capture'},
        'b': {'address': '10.0.0.2', 'control_port': 7001,
              'bind_address': '10.0.0.2'}},
        'links': {'l': {'kind': 'pipe', 'src': 'a', 'dst': 'b',
                        'port': 7100, 'window': 4, 'quota_mbps': 10.0,
                        'crc': True, 'streams': 2, 'quota_gulps': 3.0,
                        'connect': {'b': ['10.9.9.9', 7200]}}}},
    'fans': {'name': 't', 'hosts': {'c0': {}, 'c1': {}, 'r': {},
                                    'l0': {}, 'l1': {}},
             'links': {
                 'in': {'kind': 'fanin', 'src': ['c0', 'c1'], 'dst': 'r',
                        'port': 7100},
                 'out': {'kind': 'fanout', 'src': 'r', 'dst': ['l0', 'l1'],
                         'port': 7200, 'buffer_spans': 3, 'window': 4}}},
    'broken': {'name': 't',
               'hosts': {'a': {}, 'c': {}, 'b': {'control_port': 7101}},
               'links': {
                   'l': {'kind': 'fanin', 'src': ['a', 'c'], 'dst': 'b',
                         'port': 7100},
                   'g': {'kind': 'pipe', 'src': 'a', 'dst': 'ghost',
                         'port': 7300, 'window': 0, 'streams': 0},
                   's': {'kind': 'pipe', 'src': 'a', 'dst': 'a',
                         'port': 7400},
                   'one': {'kind': 'fanin', 'src': ['a'], 'dst': 'b',
                           'port': 7500, 'quota_mbps': 0.0001,
                           'gulp_nbyte': 1 << 20}}},
}


@pytest.mark.parametrize('case', sorted(SPECS))
def test_spec_round_trip_and_verifier_equal(case, tmp_path):
    d = SPECS[case]
    t, j = TF.FabricSpec.from_dict(d), JF.FabricSpec.from_dict(d)
    assert t.to_dict() == j.to_dict()
    # each package loads the other's file
    t.save(str(tmp_path / 't.json'))
    j.save(str(tmp_path / 'j.json'))
    assert (tmp_path / 't.json').read_bytes() == \
        (tmp_path / 'j.json').read_bytes()
    assert JF.FabricSpec.load(str(tmp_path / 't.json')).to_dict() == \
        TF.FabricSpec.load(str(tmp_path / 'j.json')).to_dict()
    for host in sorted(t.hosts):
        assert t.peers_of(host) == j.peers_of(host)
        assert [(l.name, o) for l, o in t.inbound_links(host)] == \
            [(l.name, o) for l, o in j.inbound_links(host)]
    tv, jv = TV.verify_fabric(d), JV.verify_fabric(d)
    assert [x.as_dict() for x in tv] == [x.as_dict() for x in jv]
    assert bool(tv) == (case != 'roundtrip')


def _config17(pkg, ports):
    """The benchmark suite's verify topology for the fabric (four hosts,
    a 2-origin fan-in and a one-leg fan-out) built by ``pkg``: the spec's
    diagnostics and each host pipeline's."""
    P = PKG[pkg]
    spec = P.fabric.FabricSpec('verify17', hosts={
        'cap0': {'address': '127.0.0.1', 'role': 'capture'},
        'cap1': {'address': '127.0.0.1', 'role': 'capture'},
        'reduce': {'address': '127.0.0.1', 'role': 'reduce'},
        'leg0': {'address': '127.0.0.1', 'role': 'leg'},
    }, links={
        'capture': {'kind': 'fanin', 'src': ['cap0', 'cap1'],
                    'dst': 'reduce', 'port': ports[0], 'window': 2,
                    'gulp_nbyte': NT * 16 * 4},
        'spectra': {'kind': 'fanout', 'src': 'reduce', 'dst': ['leg0'],
                    'port': ports[1], 'window': 2, 'buffer_spans': 8,
                    'gulp_nbyte': NT * 16 * 4},
    })
    raw = np.zeros((NT, 16), np.float32)
    hdr = simple_header([-1, 16], 'f32', gulp_nframe=NT)

    def build_cap(ctx):
        ctx.sink('capture', P.Source([raw.copy()], hdr, NT))

    def build_reduce(ctx):
        ctx.sink('spectra', ctx.source('capture'))

    def build_leg(ctx):
        P.Gather(ctx.source('spectra'))

    out = {'spec': [d.code for d in spec.validate()]}
    for host, builder in (('leg0', build_leg), ('reduce', build_reduce),
                          ('cap0', build_cap), ('cap1', build_cap)):
        fh = P.fabric.FabricHost(spec, host, builder, jitter=False)
        out[host] = sorted(d.code for d in fh.build().validate())
    return out


def test_verify_topology_clean_in_both_packages():
    """``tests/test_fabric.py::TestIntegration::test_verify_topology_clean``
    through both packages: the spec and every host pipeline lint without
    a BF-E, with the same codes."""
    out = {}
    for pkg in ('port', 'jax'):
        base = JT._port_block(2)
        spectra = [p for p in JT._free_ports(3)
                   if p not in (base, base + 1)][0]
        out[pkg] = bounded(_config17, pkg, (base, spectra))
    assert out['port'] == out['jax']
    for host, codes in out['port'].items():
        assert not [c for c in codes if c.startswith('BF-E')], (host, codes)


def _fanout_drill(pkg):
    """The re-striping drill (one of two legs dead by a stub membership)
    built by ``pkg``: each leg's stripes, the frames and the fabric.*
    counters."""
    P = PKG[pkg]
    before = P.counters.snapshot()
    spec = rehome_method(JT.TestFanOutLoopback, '_spec', FABRIC_MAP)(2)
    spec = P.fabric.FabricSpec.from_dict(spec.to_dict())
    sinks = {}
    hdr = simple_header([-1, NC], 'f32', name='stream', gulp_nframe=NT)

    def build_src(ctx):
        ctx.sink('out', P.MultiSeq(6, hdr))

    def build_leg(leg):
        def b(ctx):
            sinks[leg] = P.Gather(ctx.source('out'))
        return b

    hosts = {}
    for leg in ('leg0', 'leg1'):
        hosts[leg] = P.fabric.FabricHost(spec, leg, build_leg(leg))
        hosts[leg].build()
    hosts['src'] = P.fabric.FabricHost(spec, 'src', build_src)
    hosts['src'].build()
    fanout = [b for b in hosts['src'].pipeline.blocks
              if isinstance(b, P.fabric.FanOutBlock)][0]
    fanout.membership = JT._StubMembership(['leg1'])
    _run_hosts(hosts)
    after = P.counters.snapshot()
    fab = {k: after[k] - before.get(k, 0) for k in after
           if k.startswith('fabric.fanout.')}
    stripes = {leg: [h['_fabric']['stripe'] for h in s.headers]
               for leg, s in sinks.items()}
    frames = np.concatenate([np.asarray(g) for s in sinks.values()
                             for g in s.gulps])
    return stripes, fab, frames


def _run_hosts(hosts, timeout=TIMEOUT):
    errors = {}

    def run(name, fh):
        try:
            fh.run(install_signals=False)
        except BaseException as exc:
            errors[name] = exc
    threads = [threading.Thread(target=run, args=item, daemon=True)
               for item in hosts.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    assert not any(t.is_alive() for t in threads), 'fabric deadlocked'
    assert not errors, errors


def test_restripe_drill_equal_across_packages():
    """One leg of two dead by a stub membership: both packages re-stripe
    every sequence onto the survivor with the same stripes and
    ``fabric.fanout.*`` counters; the port's survivor holds the sent
    stream byte for byte."""
    t = bounded(_fanout_drill, 'port')
    j = bounded(_fanout_drill, 'jax')
    assert t[0] == j[0] == {'leg0': list(range(6)), 'leg1': []}
    assert t[1] == j[1] == {'fabric.fanout.restripes': 3,
                            'fabric.fanout.sequences': 6}
    # the stream itself is held to what the source sent: the JAX leg's
    # bridge source may lose the head of a burst (ROADMAP queue 3, weak
    # spots), so its bytes are not the reference
    want = np.concatenate([g for i in range(6) for g in JT._gulps(i, 4)])
    assert t[2].tobytes() == want.tobytes()
    # the legs recorded the cross-host SLO age; the fabric/health pane
    # reads it
    health = TP.load_by_pid(TP.instance_name())['fabric']['health']
    assert health['fabric_exit_age_p99_ms'] >= 0
    assert health['restripes'] >= 3


# ---------------------------------------------------------------------------
# interop on one FabricSpec
# ---------------------------------------------------------------------------

def _example(name):
    spec = importlib.util.spec_from_file_location(
        'ex_%s' % name, os.path.join(ROOT, 'examples', name + '.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope='module')
def fx_examples():
    return {'port': _example('fx_correlator_torch'),
            'jax': _example('fx_correlator')}


def _fx_single(pkg, ex):
    P = PKG[pkg]
    with P.bf.Pipeline() as p:
        src = ex.StationSource()
        raw = P.Gather(src)
        vis = P.Gather(ex.build_xchain(src))
    p.run()
    return raw.result(), vis.result()


@pytest.mark.parametrize('stations', ['jax', 'port'])
def test_stations_feed_an_xhost_of_the_other_package(stations, fx_examples):
    """One FabricSpec, two packages: ``stations`` ships the FX example's
    ci8 voltages to ``xhost`` of the other package, whose data frames
    equal the sender's gulps byte for byte and whose visibilities equal
    its package's single-host run."""
    xhost = OTHER[stations]
    spec = {'name': 'fx_interop', 'hosts': {
        'stations': {'address': '127.0.0.1', 'role': 'capture'},
        'xhost': {'address': '127.0.0.1', 'role': 'reduce'}},
        'links': {'voltages': {'kind': 'pipe', 'src': 'stations',
                               'dst': 'xhost', 'port': JT._free_ports(1)[0],
                               'window': 2}}}
    got = {}

    def build_xhost(ctx):
        src = ctx.source('voltages')
        got['raw'] = PKG[xhost].Gather(src)
        got['vis'] = PKG[xhost].Gather(fx_examples[xhost].build_xchain(src))

    def build_stations(ctx):
        ctx.sink('voltages', fx_examples[stations].StationSource())

    hosts = {'xhost': PKG[xhost].fabric.FabricHost(spec, 'xhost',
                                                   build_xhost,
                                                   jitter=False)}
    hosts['xhost'].build()
    # the receiver ring holds the whole stream (the JAX bridge source can
    # lose the head of a burst its readers have not opened yet: ROADMAP
    # queue 3, weak spots)
    hosts['xhost']._sources['voltages'].orings[0].resize(1 << 16, 1 << 20)
    hosts['stations'] = PKG[stations].fabric.FabricHost(
        spec, 'stations', build_stations, jitter=False)
    hosts['stations'].build()
    bounded(_run_hosts, hosts, timeout=120)
    raw_s, _vis_s = bounded(_fx_single, stations, fx_examples[stations])
    _raw_x, vis_x = bounded(_fx_single, xhost, fx_examples[xhost])
    assert got['raw'].result().tobytes() == raw_s.tobytes()
    assert np.asarray(got['vis'].result()).tobytes() == \
        np.asarray(vis_x).tobytes()
    assert len(got['vis'].gulps) == 4


def _beat_spec():
    ports = JT._free_ports(3)
    return {'name': 'm', 'hosts': {
        'a': {'address': '127.0.0.1', 'control_port': ports[0]},
        'b': {'address': '127.0.0.1', 'control_port': ports[1]},
        'probe': {'address': '127.0.0.1', 'control_port': ports[2]}},
        'links': {'l': {'kind': 'pipe', 'src': 'a', 'dst': 'b', 'port': 1},
                  'p': {'kind': 'fanin', 'src': ['a', 'b'], 'dst': 'probe',
                        'port': 2}}}


def _poll(fn, timeout=10.):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if fn():
            return True
        time.sleep(0.02)
    return False


@pytest.mark.parametrize('watcher', ['jax', 'port'])
def test_membership_beats_across_packages(watcher):
    """Host ``a`` of one package watches host ``b`` of the other: alive,
    dead once its beats stop, rejoined under a new session; both send the
    same beat keys (read off a raw socket on the probe host's port)."""
    spec = _beat_spec()
    A, B = PKG[watcher].fabric, PKG[OTHER[watcher]].fabric
    probe = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    probe.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    probe.bind(('127.0.0.1', spec['hosts']['probe']['control_port']))
    probe.settimeout(5)
    c = PKG[watcher].counters
    before = c.snapshot()
    ma = A.Membership(A.FabricSpec.from_dict(spec), 'a').start()
    mb = B.Membership(B.FabricSpec.from_dict(spec), 'b').start()
    try:
        beats = {}
        while len(beats) < 2:
            data, _src = probe.recvfrom(4096)
            beat = json.loads(data.decode())
            beats[beat['host']] = beat
        assert sorted(beats['a']) == sorted(beats['b']) == \
            ['host', 'role', 'session', 'state']
        assert _poll(lambda: ma.peers_snapshot()['b']['alive'])
        assert _poll(lambda: mb.peers_snapshot()['a']['alive'])
        mb.stop()
        # the probe host never beats: watch b's own death event
        assert _poll(lambda: 'b' in ma._dead)
        assert ma.is_dead('b') and 'b' in ma.counts()['dead']
        mb = B.Membership(B.FabricSpec.from_dict(spec), 'b').start()
        assert _poll(lambda: c.get('fabric.peers.rejoined') -
                     before.get('fabric.peers.rejoined', 0) >= 1)
        assert not ma.is_dead('b')
        assert ma.counts()['rejoin_events'] == 1
    finally:
        probe.close()
        ma.stop()
        mb.stop()


LEDGER_SCRIPT = (('acked', 's0', 0, 16, 1024), ('acked', 's0', 16, 16, 1024),
                 ('acked', 's0', 0, 16, 1024), ('shed', 2, 512),
                 ('acked', 's1', 0, 32, 2048))


def _write_ledger(mod, host):
    led = mod.AckLedger('fab', host, 'l')
    for step in LEDGER_SCRIPT:
        if step[0] == 'acked':
            led.note_acked(*step[1:])
        else:
            led.note_shed(*step[1:])
    led.save(force=True)
    return led


def test_ack_ledger_journal_across_packages():
    state = TF.fabric_state_dir()
    assert state == JF.fabric_state_dir()
    _write_ledger(TF, 'hport')
    _write_ledger(JF, 'hjax')
    files = [os.path.join(state, 'fab', '%s.l.json' % h)
             for h in ('hport', 'hjax')]
    blobs = [open(f, 'rb').read() for f in files]
    assert blobs[0] == blobs[1]
    for reader, host in ((JF, 'hport'), (TF, 'hjax')):
        led = reader.AckLedger('fab', host, 'l')
        assert led.has_history
        assert led.acked == {'s0': 32, 's1': 32}
        assert (led.acked_bytes, led.shed_gulps, led.shed_bytes) == \
            (4096, 2, 512)


def _send_gulps(P, port, gulps, hdr, end, landed=None):
    """A ``P`` RingSender over a fresh ring: ``gulps`` then MSG_END, or,
    once ``landed()`` is true, a poison without MSG_END (a dead host).
    Returns its errors."""
    ring = P.ring.Ring(space='system', name=None)
    errors = []

    def pump():
        s = P.bridge.RingSender(
            ring, dial=lambda: [P.bridge.connect('127.0.0.1', port)])
        try:
            s.run()
        except Exception as exc:
            errors.append(exc)
    t = threading.Thread(target=pump, daemon=True)
    writer = P.ring.RingWriter(ring)
    wseq = writer.begin_sequence(dict(hdr), NT, buf_nframe=8 * NT)
    t.start()
    for g in gulps:
        span = wseq.reserve(NT)
        span.data.as_numpy()[:] = g
        span.commit(NT)
        span.close()
    if end:
        wseq.end()
        ring.end_writing()
    else:
        assert _poll(landed, TIMEOUT)
        ring.poison(RuntimeError('host died'))
    t.join(TIMEOUT)
    assert not t.is_alive()
    return errors


@pytest.mark.parametrize('sender', ['jax', 'port'])
def test_rejoin_across_packages_replays_only_unacked(sender):
    """A sender of one package dies after 3 of 6 gulps without MSG_END;
    a new sender probes the other package's receiver for its committed
    frontier and replays only the rest: the receiver adopts the session
    and holds every frame once, equal to the sent gulps byte for byte."""
    R, S = PKG[OTHER[sender]], PKG[sender]
    before = R.counters.snapshot()
    with R.bf.Pipeline() as prx:
        bsrc = R.bf.blocks.bridge_source('127.0.0.1', 0, adopt_sessions=True)
        sink = R.Gather(bsrc)
    # a ring that holds the whole stream (see the interop test above)
    bsrc.orings[0].resize(1 << 16, 1 << 20)
    rx = threading.Thread(target=prx.run, daemon=True)
    rx.start()
    try:
        gulps = JT._gulps(7, 6)
        hdr = simple_header([-1, NC], 'f32', name='stream0', gulp_nframe=NT)
        errs = bounded(_send_gulps, S, bsrc.port, gulps[:3], hdr, False,
                       lambda: len(sink.gulps) >= 3)
        assert errs, 'the first sender should have died unclean'
        frontier = S.bridge.query_resume('127.0.0.1', bsrc.port,
                                         timeout=10.0)
        assert frontier == {'stream0': 3 * NT}
        assert not bounded(_send_gulps, S, bsrc.port,
                           gulps[frontier['stream0'] // NT:], hdr, True)
        rx.join(TIMEOUT)
        assert not rx.is_alive()
    finally:
        if rx.is_alive():
            prx.shutdown()
            rx.join(10)
    frames = np.concatenate([np.asarray(g) for g in sink.gulps])
    assert frames.tobytes() == np.concatenate(gulps).tobytes()
    assert R.counters.get('bridge.rx.sessions_adopted') - \
        before.get('bridge.rx.sessions_adopted', 0) == 1


# ---------------------------------------------------------------------------
# the port's bf_fabric tool
# ---------------------------------------------------------------------------

BUILDER = '''
import numpy as np
import bifrost_tpu_torch as bt

NT, NC = 4, 8


class Source(bt.SourceBlock):
    def __init__(self):
        super(Source, self).__init__(['fab'], NT)
        self.n = 0

    def create_reader(self, name):
        import contextlib
        return contextlib.nullcontext()

    def on_sequence(self, reader, name):
        return [{'name': 'fab', 'time_tag': 0, 'gulp_nframe': NT,
                 '_tensor': {'shape': [-1, NC], 'dtype': 'f32',
                             'labels': ['time', 'chan'],
                             'scales': [[0, 1]] * 2, 'units': [None] * 2}}]

    def on_data(self, reader, ospans):
        if self.n == 5:
            return [0]
        ospans[0].data.as_numpy()[...] = self.n
        self.n += 1
        return [NT]


class Sum(bt.SinkBlock):
    def on_sequence(self, iseq):
        self.total = 0.

    def on_data(self, ispan):
        self.total += float(np.asarray(ispan.data.as_numpy()).sum())
        print('SUM', self.total, flush=True)


def build(ctx):
    if ctx.host == 'tx':
        ctx.sink('l', Source())
    else:
        Sum(ctx.source('l'))
'''


def test_bf_fabric_tool_lint_up_and_status(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES='',
               BF_PROCLOG_DIR=str(tmp_path / 'proclog'))
    cmd = [sys.executable, '-m', 'bifrost_tpu_torch.tools.bf_fabric']

    def tool(*args):
        return subprocess.run(cmd + list(args), capture_output=True,
                              text=True, env=env, cwd=str(tmp_path),
                              timeout=120)
    ports = JT._free_ports(3)
    spec = {'name': 'cli', 'hosts': {
        'tx': {'address': '127.0.0.1', 'control_port': ports[0]},
        'rx': {'address': '127.0.0.1', 'control_port': ports[1]}},
        'links': {'l': {'kind': 'pipe', 'src': 'tx', 'dst': 'rx',
                        'port': ports[2], 'window': 2}}}
    (tmp_path / 'spec.json').write_text(json.dumps(spec))
    out = tool('lint', 'spec.json')
    assert out.returncode == 0, out.stdout + out.stderr
    assert '(clean)' in out.stdout
    bad = dict(spec, links={'l': dict(spec['links']['l'], dst='ghost')})
    (tmp_path / 'bad.json').write_text(json.dumps(bad))
    out = tool('lint', 'bad.json')
    assert out.returncode == 3 and 'BF-E200' in out.stdout
    assert tool('lint', 'missing.json').returncode == 2
    (tmp_path / 'fabbuild.py').write_text(BUILDER)
    out = tool('up', 'spec.json', '--builder', 'fabbuild:build',
               '--device', 'cpu')
    assert out.returncode == 0, out.stdout + out.stderr
    # 4 x 8 frames of 0 .. 4
    assert 'SUM %s' % float(NT * NC * sum(range(5))) in out.stdout
    assert "host 'tx' exited rc=0" in out.stdout
    assert "host 'rx' exited rc=0" in out.stdout
    out = tool('status')
    assert out.returncode == 0, out.stdout + out.stderr


def test_fleet_collector_takes_a_fabric_membership(tmp_path):
    """The fleet collector's ``membership`` is the fabric's Membership: a
    host that fresh messages keep live is marked dead (and counted, its
    dead-host bundle written) once its beats stop, as the JAX collector
    does with the JAX Membership."""
    from bifrost_tpu_torch.telemetry import fleet
    spec = TF.FabricSpec.from_dict(_beat_spec())
    ma = TF.Membership(spec, 'a').start()
    mb = TF.Membership(spec, 'b').start()
    coll = fleet.FleetCollector(membership=ma, rules=[], interval=60,
                                deadline=60,
                                incident_dir=str(tmp_path / 'inc'))
    coll.recorder.settle = 0
    try:
        coll._handle({'t': 'full', 'host': 'b', 'session': 's', 'seq': 1,
                      'counters': {}, 'histograms': {}}, ('127.0.0.1', 9))
        assert _poll(lambda: ma.peers_snapshot()['b']['alive'])
        coll.tick()
        assert coll.rollup()['hosts']['b']['dead'] is False
        before = tcounters.get('fleet.hosts_dead')
        mb.stop()
        assert _poll(lambda: ma.is_dead('b'))
        coll.tick()
        assert coll.rollup()['hosts']['b']['dead'] is True
        assert tcounters.get('fleet.hosts_dead') == before + 1
    finally:
        coll._sock.close()
        ma.stop()
        mb.stop()
