"""The port's control plane (``bifrost_tpu_torch.scheduler``) against the
JAX package's (``bifrost_tpu.scheduler``).

- The JAX package's own scheduler tests (``tests/test_scheduler.py``)
  run against the port's modules (:func:`rehome` and
  :func:`rehome_method`; the arbiter's gate stub is set on the port's
  Scheduler).
- Through both packages: ``plan_placement`` assignments, demand and
  displacement on seeded random tenant sets, ``verify_placement`` codes
  and messages, ``ledger_frontier`` over a journal written by either
  package, and one control-plane script (place, apply with a displaced
  tenant, migrate with a resume frame, host death, arbiter) whose
  ``scheduler.*`` and ``service.*`` counters and delivered bytes are
  equal.
- The port's ``bf_sched`` tool: plan, lint and status.

Membership is a stub or explicit beats; every run, join and wait is
bounded; no test asserts a rate.
"""

import inspect
import json
import os
import random
import subprocess
import sys
import types

import numpy as np
import pytest

from bifrost_tpu import fabric as JF
from bifrost_tpu import scheduler as JSch
from bifrost_tpu import service as JS
from bifrost_tpu.analysis import verify as JV
from bifrost_tpu.telemetry import counters as jcounters

from bifrost_tpu_torch import affinity as TA
from bifrost_tpu_torch import device
from bifrost_tpu_torch import fabric as TF
from bifrost_tpu_torch import proclog as TP
from bifrost_tpu_torch import scheduler as TSch
from bifrost_tpu_torch import service as TS
from bifrost_tpu_torch.analysis import verify as TV
from bifrost_tpu_torch.telemetry import counters as tcounters
from bifrost_tpu_torch.tools import like_top as tlike_top

from tests import test_scheduler as JT
from tests.test_torch_bridge import bounded
from tests.test_torch_service import SERVICE_MAP
from tests.test_torch_supervision import TorchGatherSink
from tests.test_torch_wire_formats import rehome, rehome_method
from tests.util import GatherSink as JGatherSink

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 60.

SCHED_MAP = dict(SERVICE_MAP, **{
    'bifrost_tpu.fabric': TF,
    'bifrost_tpu.scheduler': TSch,
    'bifrost_tpu.affinity': TA,
    'bifrost_tpu.proclog': TP,
    'like_top': tlike_top})

PKG = {'jax': types.SimpleNamespace(fabric=JF, service=JS, scheduler=JSch,
                                    verify=JV, counters=jcounters,
                                    Gather=JGatherSink),
       'port': types.SimpleNamespace(fabric=TF, service=TS, scheduler=TSch,
                                     verify=TV, counters=tcounters,
                                     Gather=TorchGatherSink)}

ENV = ('BF_SCHED_REBALANCE_SECS', 'BF_SCHED_DISPLACE_QUOTA_FRAC',
       'BF_SCHED_MAX_REPLACEMENTS', 'BF_SCHED_ARBITER_FRAC', 'BF_GULP_BATCH',
       'BF_SEGMENTS', 'BF_SERVE_WARM')


def _reset():
    for mod in (TS, JS):
        mod.reset_registry()
        mod.reset_warm_registry()
    for mod in (tcounters, jcounters):
        mod.reset()


@pytest.fixture(autouse=True)
def _sched_env(tmp_path, monkeypatch):
    """JAX's fixture: durable fabric state per test, snappy membership
    timers, no ambient control-plane knobs; and the CPU device."""
    device.set_device('cpu')
    monkeypatch.setenv('BF_FABRIC_STATE', str(tmp_path / 'state'))
    monkeypatch.setenv('BF_FABRIC_HEARTBEAT_SECS', '0.05')
    monkeypatch.setenv('BF_FABRIC_DEADLINE_SECS', '0.4')
    for var in ENV:
        monkeypatch.delenv(var, raising=False)
    _reset()
    yield
    _reset()
    TP.set_identity(None)


# ---------------------------------------------------------------------------
# the JAX package's scheduler tests, on the port
# ---------------------------------------------------------------------------

JT_FUNCS = sorted(n for n in dir(JT) if n.startswith('test_') and
                  inspect.isfunction(getattr(JT, n)))
JT_CLASSES = (JT.TestPlanPlacement, JT.TestVerifyPlacement,
              JT.TestPartitionCores, JT.TestSchedulerApply,
              JT.TestMigration, JT.TestReplacement, JT.TestArbiter,
              JT.TestSessionHoldDown, JT.TestWarmFloors)
JT_METHODS = sorted((cls.__name__, name) for cls in JT_CLASSES
                    for name in vars(cls) if name.startswith('test_'))


def _args(fn, request, skip=0):
    return [request.getfixturevalue(a)
            for a in list(inspect.signature(fn).parameters)[skip:]]


@pytest.mark.parametrize('name', JT_FUNCS)
def test_jax_scheduler_function_on_the_port(name, request):
    fn = getattr(JT, name)
    bounded(rehome(fn, SCHED_MAP), *_args(fn, request))


@pytest.mark.parametrize('case', JT_METHODS,
                         ids=['::'.join(c) for c in JT_METHODS])
def test_jax_scheduler_test_on_the_port(case, request, monkeypatch):
    cls, name = getattr(JT, case[0]), case[1]
    if cls is JT.TestArbiter:
        # the class's autouse fixture, on the port's Scheduler
        monkeypatch.setattr(TSch.Scheduler, '_quota_gate',
                            staticmethod(lambda job: job.gate))
    fn = getattr(cls, name)
    bounded(rehome_method(cls, name, SCHED_MAP),
            *_args(fn, request, skip=1))


def test_rehome_reaches_the_port_scheduler():
    spec = rehome(JT.mesh, SCHED_MAP)({'a': [0]})
    assert isinstance(spec, TF.FabricSpec)
    assert isinstance(rehome(JT.synth_spec, SCHED_MAP)('t'), TS.TenantSpec)


# ---------------------------------------------------------------------------
# placement and its verifier through both packages
# ---------------------------------------------------------------------------

def _random_case(seed):
    rng = random.Random(seed)
    hosts = {}
    for i in range(rng.randint(1, 4)):
        n = rng.choice([0, 1, 2, 4])
        hosts['h%d' % i] = list(range(n)) or None
    tenants = [{'id': 't%02d' % k, 'priority': rng.randint(1, 3),
                'ncores': rng.randint(1, 3)}
               for k in range(rng.randint(1, 7))]
    pinned = {}
    if rng.random() < 0.4:
        pinned[tenants[0]['id']] = rng.choice(sorted(hosts) + ['ghost'])
    exclude = [h for h in sorted(hosts) if rng.random() < 0.2]
    return hosts, tenants, pinned, exclude


def _place(pkg, case):
    P = PKG[pkg]
    hosts, tenants, pinned, exclude = case
    spec = P.fabric.FabricSpec('rnd', hosts={
        h: ({'control_port': 7001 + i, 'cores': c} if c else
            {'control_port': 7001 + i})
        for i, (h, c) in enumerate(sorted(hosts.items()))})
    out = {}
    for best_effort in (False, True):
        try:
            p = P.scheduler.plan_placement(spec, tenants, pinned=pinned,
                                           exclude=exclude,
                                           best_effort=best_effort)
        except P.scheduler.PlacementError as exc:
            out[best_effort] = ('error', str(exc),
                                [d.as_dict() for d in exc.diagnostics])
            continue
        out[best_effort] = (p.as_dict(), list(p.assignments),
                            [d.as_dict() for d in P.verify.verify_placement(
                                spec, tenants, p.assignments)])
    return out


@pytest.mark.parametrize('seed', range(24))
def test_plan_and_verify_placement_equal(seed):
    case = _random_case(seed)
    assert _place('port', case) == _place('jax', case)


def test_verify_placement_passes_fabric_and_service_codes_equal():
    spec = {'name': 't',
            'hosts': {'a': {'control_port': 7001, 'cores': [0, 1]},
                      'b': {'control_port': 7002}},
            'links': {'l': {'kind': 'pipe', 'src': 'a', 'dst': 'ghost',
                            'port': 7100, 'window': 0}}}
    tenants = [{'id': 'bad', 'quota_bytes_per_s': 100, 'gulp_nbyte': 4096},
               {'id': 'ok', 'ncores': 3}, {'id': 'ok2', 'priority': 2},
               {'id': 'lost'}]
    assign = {'bad': 'a', 'ok': 'b', 'ok2': 'b', 'lost': 'nowhere'}
    t = [d.as_dict() for d in TV.verify_placement(spec, tenants, assign)]
    j = [d.as_dict() for d in JV.verify_placement(spec, tenants, assign)]
    assert t == j
    assert {d['code'] for d in t} >= {'BF-E200', 'BF-E150', 'BF-E222',
                                      'BF-E211', 'BF-E223', 'BF-E220',
                                      'BF-E221', 'BF-W224'}


@pytest.mark.parametrize('writer', ['jax', 'port'])
def test_ledger_frontier_across_packages(writer):
    led = PKG[writer].fabric.AckLedger('fab', 'h1', 'stream')
    led.note_acked('s0', 0, 16, 1024)
    led.note_acked('s1', 0, 32, 2048)
    led.save(force=True)
    for mod in (TSch, JSch):
        assert mod.ledger_frontier('fab', 'h1', 'stream') == 32
        assert mod.ledger_frontier('fab', 'h1', 'stream', 's0') == 16
        assert mod.ledger_frontier('fab', 'ghost', 'stream') == 0


# ---------------------------------------------------------------------------
# one control-plane script through both packages
# ---------------------------------------------------------------------------

def _synth(pkg, tid, nframe=48, seed=9, **kw):
    return PKG[pkg].service.TenantSpec(tid, source={
        'kind': 'synthetic', 'nframe_total': nframe, 'gulp_nframe': 16,
        'nchan': 8, 'seed': seed}, **kw)


def _control_script(pkg):
    """Place three tenants on two hosts (one displaced), apply, migrate
    one with a resume frame, lose a host, then one arbiter pass with a
    stubbed SLO violation: the counters, assignments and the bytes each
    tenant delivered."""
    P = PKG[pkg]
    S, Sch = P.service, P.scheduler
    spec = P.fabric.FabricSpec('ctl', hosts={
        'h1': {'control_port': 7001, 'cores': [0, 1]},
        'h2': {'control_port': 7002, 'cores': [2]}})
    mgrs = {h: S.JobManager(max_tenants=4, warm=False) for h in spec.hosts}
    sched = Sch.Scheduler(spec, managers=mgrs,
                          resume_of=lambda tid, dead: 32)
    store = {}

    def build(tid):
        def b(gate):
            store.setdefault(tid, []).append(P.Gather(gate))
        return b
    tenants = [_synth(pkg, 'hi', priority=3, ncores=2),
               _synth(pkg, 'mid', priority=2, quota_bytes_per_s=1e9),
               _synth(pkg, 'lo', priority=1, quota_bytes_per_s=1e9)]
    out = {'placed': sched.place(tenants).as_dict()}
    jobs = sched.apply(build={t.id: build(t.id) for t in tenants},
                       start=False)
    out['gates'] = {tid: Sch.Scheduler._quota_gate(j).quota_bytes_per_s
                    for tid, j in sorted(jobs.items())}
    for host, mgr in mgrs.items():
        mgr.start()
        mgr.wait(TIMEOUT)
    # migrate 'mid' onto h1, resuming at frame 16
    job = sched.migrate('mid', 'h1', resume_frame=16)
    assert job.wait(TIMEOUT) == 'DONE'
    # h1 dies: its tenants re-place onto h2 at the resume frame 32
    moved = sched.handle_host_death('h1')
    for j in moved.values():
        assert j.wait(TIMEOUT) == 'DONE'
    out['moved'] = sorted(moved)
    out['assignments'] = dict(sched.placement.assignments)
    out['displaced'] = list(sched.placement.displaced)
    # one arbiter pass over two fake running jobs
    gates = {}

    class Gate(object):
        def __init__(self, rate):
            self.quota_bytes_per_s = rate

        def retune(self, new):
            self.quota_bytes_per_s = new

    class Job(object):
        def __init__(self, tid, prio, rate, ok):
            self.spec = S.TenantSpec(tid, priority=prio)
            self.state = 'RUNNING'
            self.pipeline = None
            gates[tid] = self.gate = Gate(rate)
            self._ok = ok

        def slo_rollup(self):
            return {} if self._ok is None else {'ok': self._ok}

    class Mgr(object):
        def jobs(self):
            return [Job('v', 3, 200., False), Job('d', 1, 1000., None)]
    arb = Sch.Scheduler(spec, managers={'x': Mgr()})
    arb._quota_gate = lambda job: job.gate
    out['arbiter'] = arb.arbitrate(frac=0.5)
    out['arbiter_gates'] = {k: g.quota_bytes_per_s for k, g in gates.items()}
    sched.shutdown()
    out['counters'] = {k: v for k, v in P.counters.snapshot().items()
                       if k.startswith(('scheduler.', 'service.'))}
    out['section'] = {k: v for k, v in Sch.telemetry_section().items()
                      if k != 'last_replacement'}
    out['bytes'] = {tid: [np.asarray(g.result()).tobytes() for g in sinks]
                    for tid, sinks in sorted(store.items())}
    return out


def test_control_plane_script_equal_across_packages():
    t = bounded(_control_script, 'port')
    j = bounded(_control_script, 'jax')
    for key in ('placed', 'gates', 'moved', 'assignments', 'displaced',
                'arbiter', 'arbiter_gates', 'counters', 'section', 'bytes'):
        assert t[key] == j[key], key
    want = TS.SyntheticSource.payload(48, 8, 9)
    # every tenant's first run whole; 'mid' resumed at 16 on h1, then all
    # three h1 tenants resumed at 32 on h2 (displaced there: 3 on 1 core)
    for tid in ('hi', 'lo'):
        assert t['bytes'][tid] == [want.tobytes(), want[32:].tobytes()]
    assert t['bytes']['mid'] == [want.tobytes(), want[16:].tobytes(),
                                 want[32:].tobytes()]
    assert t['moved'] == ['hi', 'lo', 'mid']
    assert t['placed']['displaced'] == ['lo']
    assert t['gates']['lo'] == 0.5e9
    assert t['counters']['scheduler.migrations'] == 4
    assert t['counters']['scheduler.replacements'] == 3
    assert t['counters']['scheduler.resume.skipped_frames'] == 16 + 3 * 32
    assert t['arbiter'] == [('v', 'd', 500.0)]


# ---------------------------------------------------------------------------
# the port's bf_sched tool
# ---------------------------------------------------------------------------

def test_bf_sched_tool_plan_lint_and_status(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES='',
               BF_PROCLOG_DIR=str(tmp_path / 'proclog'))

    def tool(*args):
        return subprocess.run(
            [sys.executable, '-m', 'bifrost_tpu_torch.tools.bf_sched'] +
            list(args), capture_output=True, text=True, env=env,
            cwd=str(tmp_path), timeout=120)
    fab = {'name': 'cli', 'hosts': {'a': {'control_port': 7001,
                                          'cores': [0, 1]},
                                    'b': {'control_port': 7002}}}
    svc = {'tenants': [{'id': 'hi', 'priority': 3, 'ncores': 2},
                       {'id': 'lo'}, {'id': 'lo2'}]}
    (tmp_path / 'fab.json').write_text(json.dumps(fab))
    (tmp_path / 'svc.json').write_text(json.dumps(svc))
    out = tool('plan', 'fab.json', 'svc.json')
    assert out.returncode == 0, out.stdout + out.stderr
    assert 'host a            cores=2 demand=3  hi lo2  OVERSUBSCRIBED' \
        in out.stdout
    assert 'host b            cores=1 demand=1  lo' in out.stdout
    assert 'displaced (quota-scaled, shed by policy): lo2' in out.stdout
    assert 'plan PASS' in out.stdout
    out = tool('lint', 'fab.json', 'svc.json')
    assert out.returncode == 0, out.stdout + out.stderr
    assert 'BF-W224' in out.stdout
    # without host a no host offers 'hi' its two cores
    out = tool('lint', 'fab.json', 'svc.json', '--exclude', 'a')
    assert out.returncode == 3 and 'BF-E220' in out.stdout
    svc['tenants'].append({'id': 'fat', 'ncores': 5})
    (tmp_path / 'svc.json').write_text(json.dumps(svc))
    out = tool('plan', 'fab.json', 'svc.json')
    assert out.returncode == 3 and 'BF-E220' in out.stdout
    assert tool('plan', 'fab.json', 'missing.json').returncode == 2
    out = tool('status')
    assert out.returncode == 0 and '(no fabric/service processes' in \
        out.stdout
