"""The port's multi-tenant service tier (``bifrost_tpu_torch.service``)
against the JAX package's (``bifrost_tpu.service``).

- The JAX package's own service tests (``tests/test_service.py``) run
  against the port's modules (:func:`rehome`), but for the gate wiring
  (the gate is benchmark machinery, not ported) and the ``bf_serve``
  CLI, which has a counterpart below on the port's tool.  The two
  tests whose device chain names the JAX device space run with the
  port's ``cuda`` space (on the CPU device here).
- Through both packages in one process: spec round trips, the verifier's
  codes and messages, ``partition_cores``, the deterministic stream
  bytes, a resumed stream byte for byte, the ``service.*`` counters of
  one admission script, two concurrent tenants on the small
  ``fused[FFT, Detect('stokes'), Reduce]`` chain of a recorded ci8 stream
  (within 1e-5, the JAX gate's tolerance), and warm starts (hits, depot
  hits, stale rejection).
- The exporter's and the fleet publisher's tenant sections.

Every pipeline run, join and ``Job.wait`` is bounded; no test asserts a
rate.
"""

import importlib
import inspect
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest

import bifrost_tpu as bf
from bifrost_tpu import affinity as JA
from bifrost_tpu import service as JS
from bifrost_tpu import stages as JST
from bifrost_tpu.analysis import verify as JV
from bifrost_tpu.telemetry import counters as jcounters
from bifrost_tpu.testing import faults as jfaults

import bifrost_tpu_torch as bt
from bifrost_tpu_torch import affinity as TA
from bifrost_tpu_torch import device
from bifrost_tpu_torch import proclog as TP
from bifrost_tpu_torch import service as TS
from bifrost_tpu_torch import stages as TST
from bifrost_tpu_torch.analysis import verify as TV
from bifrost_tpu_torch.io import packet_writer as TPW
from bifrost_tpu_torch.io import udp_socket as TUS
from bifrost_tpu_torch.telemetry import counters as tcounters
from bifrost_tpu_torch.telemetry import exporter as texporter
from bifrost_tpu_torch.telemetry import fleet as tfleet
from bifrost_tpu_torch.testing import faults as tfaults
from bifrost_tpu_torch.tools import like_top as tlike_top

from tests import test_service as JT
from tests.test_torch_bridge import StaticNumpySource, bounded
from tests.test_torch_supervision import TorchGatherSink
from tests.test_torch_wire_formats import rehome
from tests.util import GatherSink as JGatherSink
from tests.util import simple_header

#: the module (``bifrost_tpu_torch.blocks.serialize`` the attribute is the
#: block function)
TSER = importlib.import_module('bifrost_tpu_torch.blocks.serialize')

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: seconds a test's threads may take before the test fails
TIMEOUT = 60.

_util = types.ModuleType('tests.util')
_util.simple_header = simple_header
_util.NumpySourceBlock = StaticNumpySource
_util.GatherSink = TorchGatherSink

SERVICE_MAP = {'bifrost_tpu': bt,
               'bifrost_tpu.service': TS,
               'bifrost_tpu.affinity': TA,
               'bifrost_tpu.stages': TST,
               'bifrost_tpu.proclog': TP,
               'bifrost_tpu.analysis': bt.analysis,
               'bifrost_tpu.analysis.verify': TV,
               'bifrost_tpu.blocks.serialize': TSER,
               'bifrost_tpu.io.packet_writer': TPW,
               'bifrost_tpu.io.udp_socket': TUS,
               'bifrost_tpu.telemetry': bt.telemetry,
               'bifrost_tpu.telemetry.counters': tcounters,
               'bifrost_tpu.telemetry.exporter': texporter,
               'bifrost_tpu.testing.faults': tfaults,
               'util': _util, 'tests.util': _util,
               'like_top': tlike_top}

PKG = {'jax': types.SimpleNamespace(bf=bf, service=JS, stages=JST,
                                    counters=jcounters, Gather=JGatherSink,
                                    space='tpu'),
       'port': types.SimpleNamespace(bf=bt, service=TS, stages=TST,
                                     counters=tcounters,
                                     Gather=TorchGatherSink, space='cuda')}


def _reset():
    for mod in (TS, JS):
        mod.reset_registry()
        mod.reset_warm_registry()
    for mod in (tcounters, jcounters):
        mod.reset()
    for mod in (tfaults, jfaults):
        mod.clear()


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    device.set_device('cpu')
    monkeypatch.delenv('BF_SERVE_WARM', raising=False)
    monkeypatch.delenv('BF_SERVE_MAX_TENANTS', raising=False)
    _reset()
    yield
    _reset()


# ---------------------------------------------------------------------------
# the JAX package's service tests, on the port
# ---------------------------------------------------------------------------

def port_device_build(sinks):
    """``tests/test_service.py:_device_build`` on the port's device space."""
    def build(gate):
        b = bt.blocks.copy(gate, space='cuda')
        fbk = bt.blocks.fused(
            b, [TST.FftStage('chan', axis_labels='freq'),
                TST.DetectStage('scalar'), TST.ReduceStage('freq', 3)])
        sinks.append(TorchGatherSink(bt.blocks.copy(fbk, space='system')))
    return build


JT_TESTS = sorted(n for n in dir(JT) if n.startswith('test_') and n not in (
    # the gate is benchmark machinery, not ported
    'test_service_gate_wired',
    # runs the JAX tool; test_bf_serve_validate_cli_on_the_port below
    'test_bf_serve_validate_cli',
    # its build names the JAX device space inline; ported below
    'test_warm_stale_mismatch_rejected'))


@pytest.mark.parametrize('name', JT_TESTS)
def test_jax_service_test_on_the_port(name, request):
    fn = getattr(JT, name)
    args = [request.getfixturevalue(a)
            for a in inspect.signature(fn).parameters]
    bounded(rehome(fn, SERVICE_MAP, _device_build=port_device_build),
            *args)


def test_rehome_reaches_the_port_service():
    probe = rehome(JT.synth_spec, SERVICE_MAP)('probe')
    assert isinstance(probe, TS.TenantSpec)


def test_warm_stale_mismatch_rejected():
    """``tests/test_service.py::test_warm_stale_mismatch_rejected`` on the
    port's device space: the same structural topology with a different
    reduce factor is refused as stale and runs cold."""
    def run():
        sinks = []
        mgr = TS.JobManager(max_tenants=4)
        cold = mgr.submit(JT.synth_spec('stale0', nframe=96, gulp=32,
                                        nchan=64, seed=1).as_dict(),
                          port_device_build(sinks))
        cold.start()
        assert cold.wait(TIMEOUT) == 'DONE'

        def build_other(gate):
            b = bt.blocks.copy(gate, space='cuda')
            fbk = bt.blocks.fused(
                b, [TST.FftStage('chan', axis_labels='freq'),
                    TST.DetectStage('scalar'), TST.ReduceStage('freq', 11)])
            sinks.append(TorchGatherSink(bt.blocks.copy(fbk,
                                                        space='system')))
        before = tcounters.get('service.warm.rejected_stale')
        other = mgr.submit(JT.synth_spec('stale1', nframe=96, gulp=32,
                                         nchan=64, seed=1).as_dict(),
                           build_other)
        assert other.topology_hash == cold.topology_hash
        assert not other.warm and other.warm_rejected
        assert tcounters.get('service.warm.rejected_stale') == before + 1
        other.start()
        assert other.wait(TIMEOUT) == 'DONE'
    bounded(run)


def test_bf_serve_validate_cli_on_the_port(tmp_path):
    """``python -m bifrost_tpu_torch.tools.bf_serve spec --validate``:
    PASS on a clean spec, exit 3 with BF-E210 on a duplicate id (the JAX
    tool's test, on the port's tool)."""
    spec = {'tenants': [
        {'id': 'synth0',
         'source': {'kind': 'synthetic', 'nframe_total': 64,
                    'gulp_nframe': 16, 'nchan': 8}},
        {'id': 'synth1', 'quota_bytes_per_s': 1e6, 'quota_policy': 'pace',
         'gulp_nframe': 16,
         'source': {'kind': 'synthetic', 'nframe_total': 64,
                    'gulp_nframe': 16, 'nchan': 8}}]}
    path = str(tmp_path / 'svc.json')
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES='',
               BF_PROCLOG_DIR=str(tmp_path / 'proclog'))

    def run():
        with open(path, 'w') as f:
            json.dump(spec, f)
        return subprocess.run(
            [sys.executable, '-m', 'bifrost_tpu_torch.tools.bf_serve', path,
             '--validate'], capture_output=True, text=True, env=env,
            cwd=ROOT, timeout=120)
    out = run()
    assert out.returncode == 0, out.stdout + out.stderr
    assert 'validate PASS (2 tenant(s), 0 error(s))' in out.stdout
    spec['tenants'][1]['id'] = 'synth0'
    out = run()
    assert out.returncode == 3, out.stdout + out.stderr
    assert 'BF-E210' in out.stdout


def test_bf_serve_runs_a_service_on_the_cpu(tmp_path):
    """The tool runs a two-tenant service to the end (``--device cpu``)
    and prints the tenants' rollup."""
    spec = {'tenants': [
        {'id': 's%d' % i, 'source': {'kind': 'synthetic', 'nframe_total': 64,
                                     'gulp_nframe': 16, 'nchan': 8}}
        for i in range(2)]}
    path = str(tmp_path / 'svc.json')
    with open(path, 'w') as f:
        json.dump(spec, f)
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES='',
               BF_PROCLOG_DIR=str(tmp_path / 'proclog'))
    out = subprocess.run(
        [sys.executable, '-m', 'bifrost_tpu_torch.tools.bf_serve', path,
         '--device', 'cpu'], capture_output=True, text=True, env=env,
        cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    rollup = json.loads(out.stdout[out.stdout.index('{'):
                                   out.stdout.rindex('}') + 1])
    assert {t: (d['state'], d['gulps'], d['bytes'])
            for t, d in rollup.items()} == {
        's0': ('DONE', 4, 2048), 's1': ('DONE', 4, 2048)}


# ---------------------------------------------------------------------------
# specs, verifier and core shares through both packages
# ---------------------------------------------------------------------------

SPECS = [
    {'id': 'a-1', 'source': {'kind': 'synthetic'}, 'priority': 3,
     'ncores': 2, 'quota_bytes_per_s': 1e6, 'quota_policy': 'pace',
     'slo_ms': 250, 'gulp_nframe': 64},
    {'id': 'b', 'source': {'kind': 'replay', 'basenames': ['x'],
                           'loop': 4}, 'gulp_nbyte': 4096,
     'overload_policy': 'drop_oldest', 'on_failure': 'restart',
     'max_restarts': 2, 'sink': 'serialize'},
    {'id': 'c', 'source': {'kind': 'udp', 'port': 0}},
]


@pytest.mark.parametrize('d', SPECS, ids=[s['id'] for s in SPECS])
def test_spec_round_trip_equal(d):
    t, j = TS.TenantSpec.coerce(d), JS.TenantSpec.coerce(d)
    assert t.as_dict() == j.as_dict()
    assert repr(t) == repr(j)
    assert TS.TenantSpec.coerce(t.as_dict()).as_dict() == t.as_dict()
    for bad in ({'id': 'bad id!'}, {'id': 'x', 'source': {'kind': 'nope'}},
                {'id': 'x', 'quota_policy': 'drop'},
                {'id': 'x', 'bogus_field': 1}):
        errs = []
        for mod in (TS, JS):
            with pytest.raises(ValueError) as ei:
                mod.TenantSpec.coerce(bad)
            errs.append(str(ei.value))
        assert errs[0] == errs[1]


VERIFY_CASES = {
    'duplicate': ([{'id': 'a'}, {'id': 'a'}, {'id': 'a'}], 64),
    'quota_below_gulp': ([{'id': 'a', 'quota_bytes_per_s': 100,
                           'gulp_nbyte': 4096}], 64),
    'pace_exempt': ([{'id': 'a', 'quota_bytes_per_s': 100,
                      'gulp_nbyte': 4096, 'quota_policy': 'pace'}], 64),
    'oversubscribed': ([{'id': 'a', 'ncores': 3}, {'id': 'b', 'ncores': 2}],
                       4),
    'capture_ring': ([{'id': 'u', 'quota_bytes_per_s': 1000,
                       'source': {'kind': 'udp', 'buffer_ntime': 64,
                                  'ring_nframe': 100,
                                  'ingest_bytes_per_s': 5000}}], 64),
    'everything': ([{'id': 'a', 'ncores': 9, 'quota_bytes_per_s': 10,
                     'gulp_nbyte': 11}, {'id': 'a'},
                    {'id': 'u', 'source': {'kind': 'udp', 'ring_nframe': 1}}],
                   8),
}


@pytest.mark.parametrize('case', sorted(VERIFY_CASES))
def test_verify_service_equal(case):
    specs, ncores = VERIFY_CASES[case]
    t = TV.verify_service(specs, ncores=ncores)
    j = JV.verify_service(specs, ncores=ncores)
    assert [d.as_dict() for d in t] == [d.as_dict() for d in j]
    assert t or case == 'pace_exempt'


@pytest.mark.parametrize('weights,cores', [
    ({'a': 3, 'b': 1}, list(range(8))),
    ({'a': 100, 'b': 1}, [0, 1]),
    ({'a': 1, 'b': 1, 'c': 1}, list(range(6))),
    ({'a': 1, 'b': 1, 'c': 1}, [4, 5]),
    ({'a': 3.0, 'b': 2.0, 'c': 1.0}, [4, 5]),
    ({'x': 5, 'y': 2, 'z': 2, 'w': 1}, list(range(3, 16))),
    ({}, [0]), ({'a': 1}, [])])
def test_partition_cores_equal(weights, cores):
    assert TA.partition_cores(weights, cores=cores) == \
        JA.partition_cores(weights, cores=cores)


def test_synthetic_payload_equal():
    for args in ((48, 8, 9), (192, 8, 5), (7, 3, 0)):
        t = TS.SyntheticSource.payload(*args)
        assert t.tobytes() == JS.SyntheticSource.payload(*args).tobytes()


# ---------------------------------------------------------------------------
# the tiers through both packages
# ---------------------------------------------------------------------------

def _synth(pkg, tid, nframe=64, gulp=16, nchan=8, seed=3, start=0, **kw):
    return PKG[pkg].service.TenantSpec(tid, source={
        'kind': 'synthetic', 'nframe_total': nframe, 'gulp_nframe': gulp,
        'nchan': nchan, 'seed': seed, 'start_frame': start}, **kw)


def _gather(pkg, store, tid):
    def build(gate):
        store[tid] = PKG[pkg].Gather(gate)
    return build


def _counters(pkg, prefixes=('service.',)):
    snap = PKG[pkg].counters.snapshot()
    return {k: v for k, v in snap.items() if k.startswith(prefixes)}


def _admission_script(pkg):
    """Admission, rejection, two tenants (one resumed at frame 16) to
    the end: the stores and the service.* counters."""
    S = PKG[pkg].service
    store = {}
    mgr = S.JobManager(max_tenants=2, cores=[0, 1, 2], warm=False)
    mgr.submit(_synth(pkg, 'full', nframe=48, seed=9),
               _gather(pkg, store, 'full'))
    mgr.submit(_synth(pkg, 'tail', nframe=48, seed=9, start=16, priority=2),
               _gather(pkg, store, 'tail'))
    rejected = []
    for spec in (_synth(pkg, 'full'), _synth(pkg, 'third')):
        try:
            mgr.submit(spec, _gather(pkg, store, 'x'))
        except S.ServiceAdmissionError as exc:
            rejected.append(str(exc))
    try:
        S.JobManager(max_tenants=4, warm=False).submit(S.TenantSpec(
            'badq', source={'kind': 'synthetic'}, quota_bytes_per_s=10,
            gulp_nbyte=4096))
    except S.ServiceSpecError as exc:
        rejected.append([d.code for d in exc.diagnostics])
    cores = {j.spec.id: j.cores for j in mgr.jobs()}
    mgr.start()
    states = mgr.wait(TIMEOUT)
    return store, states, rejected, cores, _counters(pkg)


def test_admission_script_counters_and_bytes_equal():
    out = {pkg: bounded(_admission_script, pkg) for pkg in PKG}
    t, j = out['port'], out['jax']
    assert t[1] == j[1] == {'full': 'DONE', 'tail': 'DONE'}
    assert t[2] == j[2] and len(t[2]) == 3
    assert t[3] == j[3]
    assert t[4] == j[4]
    want = TS.SyntheticSource.payload(48, 8, 9)
    for pkg in PKG:
        store = out[pkg][0]
        assert store['full'].result().tobytes() == want.tobytes()
        # the resumed tenant delivers the stream from frame 16 on
        assert store['tail'].result().tobytes() == want[16:].tobytes()


NT, NPOL, NFINE, R = 16, 2, 64, 4


def _record_ci8(tmpdir, ngulp=6):
    """A ci8 (time, pol, fine_time) stream recorded by the port's
    serialize, and its int8 (re, im) samples."""
    rng = np.random.RandomState(23)
    raw = rng.randint(-128, 128, (ngulp * NT, NPOL, NFINE, 2)) \
        .astype(np.int8)
    ci8 = raw.view([('re', 'i1'), ('im', 'i1')]).reshape(raw.shape[:3])
    hdr = {'name': 'volts', 'time_tag': 0, 'gulp_nframe': NT,
           '_tensor': {'shape': [-1, NPOL, NFINE], 'dtype': 'ci8',
                       'labels': ['time', 'pol', 'fine_time'],
                       'scales': [[0, 1]] * 3, 'units': [None] * 3}}
    with bt.Pipeline() as p:
        src = StaticNumpySource([ci8[i:i + NT] for i in
                                 range(0, ngulp * NT, NT)], hdr, NT)
        bt.blocks.serialize(src, path=tmpdir)
    bounded(p.run)
    return os.path.join(tmpdir, 'volts')


def _spectrometer_build(pkg, sinks, tid, rfactor=R):
    P = PKG[pkg]

    def build(gate):
        b = P.bf.blocks.copy(gate, space=P.space)
        fbk = P.bf.blocks.fused(
            b, [P.stages.FftStage('fine_time', axis_labels='freq'),
                P.stages.DetectStage('stokes', axis='pol'),
                P.stages.ReduceStage('freq', rfactor)])
        sinks[tid] = P.Gather(P.bf.blocks.copy(fbk, space='system'))
    return build


def _replay_spec(pkg, tid, base, **kw):
    return PKG[pkg].service.TenantSpec(tid, gulp_nframe=NT, source={
        'kind': 'replay', 'basenames': [base], 'gulp_nframe': NT}, **kw)


def _two_tenants(pkg, base):
    S = PKG[pkg].service
    sinks = {}
    mgr = S.JobManager(max_tenants=4, warm=False)
    mgr.submit(_replay_spec(pkg, 'ta', base, priority=2),
               _spectrometer_build(pkg, sinks, 'ta'))
    mgr.submit(_replay_spec(pkg, 'tb', base),
               _spectrometer_build(pkg, sinks, 'tb'))
    mgr.start()
    states = mgr.wait(TIMEOUT)
    stats = {tid: {k: v for k, v in j.stats().items()
                   if k in ('gulps', 'bytes', 'quota_shed_gulps')}
             for tid, j in ((j.spec.id, j) for j in mgr.jobs())}
    return states, {t: s.result() for t, s in sinks.items()}, stats


def test_two_tenants_spectrometer_chain_equal_jax(tmp_path):
    base = _record_ci8(str(tmp_path))
    t = bounded(_two_tenants, 'port', base)
    j = bounded(_two_tenants, 'jax', base)
    assert t[0] == j[0] == {'ta': 'DONE', 'tb': 'DONE'}
    assert t[2] == j[2]
    assert t[2]['ta']['gulps'] == 6
    for tid in ('ta', 'tb'):
        got, want = t[1][tid], np.asarray(j[1][tid])
        assert got.shape == want.shape == (6 * NT, 4, NFINE // R)
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err < 1e-5, (tid, err)
    # the tenants' outputs are the same stream
    assert t[1]['ta'].tobytes() == t[1]['tb'].tobytes()


def _warm_script(pkg, base):
    """A cold tenant, a warm one of the same topology and a stale one
    (another reduce factor): their flags, the warm counters and the
    outputs."""
    S = PKG[pkg].service
    sinks = {}
    mgr = S.JobManager(max_tenants=4)
    out = {}
    for tid, rf in (('cold', R), ('warm', R), ('stale', 8)):
        job = mgr.submit(_replay_spec(pkg, tid, base),
                         _spectrometer_build(pkg, sinks, tid, rf))
        out[tid] = (job.warm, job.warm_rejected)
        job.start()
        assert job.wait(TIMEOUT) == 'DONE'
    c = PKG[pkg].counters
    keys = ('service.warm.hits', 'service.warm.rejected_stale',
            'autotune.profile_adoptions')
    out['counters'] = {k: c.get(k) for k in keys}
    out['depot_hits'] = c.get('fused.plan_depot_hits')
    out['outputs'] = {t: np.asarray(s.result()) for t, s in sinks.items()}
    return out


def test_warm_start_through_both_packages(tmp_path):
    base = _record_ci8(str(tmp_path), ngulp=2)
    t = bounded(_warm_script, 'port', base)
    j = bounded(_warm_script, 'jax', base)
    for k in ('cold', 'warm', 'stale', 'counters'):
        assert t[k] == j[k], k
    assert t['warm'] == (True, False) and t['stale'] == (False, True)
    assert t['counters']['service.warm.hits'] == 1
    assert t['depot_hits'] >= 1 and j['depot_hits'] >= 1
    # a warm start changes no byte
    assert t['outputs']['warm'].tobytes() == t['outputs']['cold'].tobytes()
    for tid in ('cold', 'stale'):
        want = t['outputs'][tid]
        err = np.abs(want - j['outputs'][tid]).max() / np.abs(want).max()
        assert err < 1e-5, (tid, err)


# ---------------------------------------------------------------------------
# telemetry surfaces
# ---------------------------------------------------------------------------

def test_snapshot_and_fleet_carry_the_tenants_section():
    def run():
        store = {}
        mgr = TS.JobManager(max_tenants=2, warm=False)
        mgr.submit(_synth('port', 'tele', slo_ms=60000),
                   _gather('port', store, 'tele'))
        mgr.start()
        assert mgr.wait(TIMEOUT)['tele'] == 'DONE'
    bounded(run)
    snap = texporter.snapshot()
    assert snap['tenants']['tele']['gulps'] == 4
    assert texporter._tenant_section() == TS.telemetry_section()
    pub = tfleet.FleetPublisher(('127.0.0.1', 9), host='h', interval=60)
    sent = []
    pub._send = sent.append
    try:
        pub.publish(full=True)
    finally:
        pub._sock.close()
    msg = sent[0]
    assert msg['tenants']['tele']['state'] == 'DONE'
    assert msg['tenants']['tele']['bytes'] == 4 * 16 * 8 * 4


def test_snapshot_leaves_the_service_unimported():
    code = ("import sys, bifrost_tpu_torch as bt\n"
            "snap = bt.telemetry.snapshot()\n"
            "print(snap['tenants'], snap['scheduler'], "
            "'bifrost_tpu_torch.service' in sys.modules)\n")
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES='')
    p = subprocess.run([sys.executable, '-c', code], capture_output=True,
                       text=True, env=env, cwd=ROOT, timeout=120)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == '{} {} False'


# ---------------------------------------------------------------------------
# by design: the tenants of one process share its device
# ---------------------------------------------------------------------------

def _sticky_cuda_error(site, name):
    return RuntimeError('CUDA error: an illegal memory access was '
                        'encountered (%s)' % name)


def test_device_fault_fails_every_tenant_and_is_reported():
    """The tenants of one JobManager share the process's CUDA context: a
    sticky device error (an illegal address, a launch that breaks the
    context) fails every tenant's next device call, and no tenant can be
    kept apart from it.  The service reports every such failure and
    returns; it does not hang.  The drill raises torch's error from each
    tenant's fused device block, as a sticky error would."""
    tfaults.inject('block.on_data', exc=_sticky_cuda_error,
                   match='FusedBlock', count=3)

    def run():
        sinks = []
        mgr = TS.JobManager(max_tenants=4, warm=False)
        for i in range(3):
            mgr.submit(_synth('port', 'dev%d' % i, nframe=96, gulp=32,
                              nchan=64), port_device_build(sinks))
        mgr.start()
        return mgr.wait(TIMEOUT), mgr
    states, mgr = bounded(run)
    assert states == {'dev0': 'FAILED', 'dev1': 'FAILED', 'dev2': 'FAILED'}
    section = TS.telemetry_section()
    for tid in states:
        assert 'illegal memory access' in section[tid]['error']
        assert section[tid]['state'] == 'FAILED'
        assert isinstance(mgr.job(tid).error, bt.PipelineRuntimeError)
