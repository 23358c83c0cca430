"""The port's last seven tools (``bifrost_tpu_torch/tools/{like_bmon,
like_pmap, bf_console, trace_merge, telemetry_diff, bf_lint,
mprobe_report}.py``) against the JAX package's (``tools/``).

- The JAX package's own tests of these tools (``tests/test_tools.py``,
  ``tests/test_observability.py``) run against the port's tools
  (:func:`rehome`, with ``TOOLS`` pointing at launchers of the port's
  modules and the pipelines built from the port's blocks).
- Each port tool and its JAX twin read the same ProcLog tree, trace files,
  snapshot pair or mprobe cache: the outputs are equal (less the pids,
  ports and paths that differ by construction) and so are the exit codes.
- ``trace_merge`` joins a JAX-host trace and a port-host trace of one
  bridged stream (a JAX sender into a port receiver).

Tolerance: exact text.  Every subprocess is bounded.
"""

import json
import os
import re
import subprocess
import sys
import threading

import numpy as np
import pytest

import bifrost_tpu as bf

import bifrost_tpu_torch as bt
from bifrost_tpu_torch import device
from bifrost_tpu_torch.ops import mprobe as tmprobe
from bifrost_tpu_torch.tools import telemetry_diff as ttelemetry_diff

from tests import test_observability as JO
from tests import test_tools as JT
from tests.test_torch_bridge import _two_pipelines
from tests.test_torch_supervision import TorchGatherSink, TorchNumpySourceBlock
from tests.test_torch_wire_formats import rehome
from tests.util import NumpySourceBlock as JNumpySource, simple_header

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TOOLS = os.path.join(ROOT, 'tools')
TOOL_NAMES = ('like_bmon', 'like_pmap', 'bf_console', 'trace_merge',
              'telemetry_diff', 'bf_lint', 'mprobe_report')
#: seconds a tool's subprocess may take
TIMEOUT = 120


@pytest.fixture(autouse=True)
def _cpu():
    device.set_device('cpu')


def port_tools_dir(base):
    """A ``tools/`` directory of launchers, one for each port tool under
    the JAX tool's file name, so a JAX test that runs ``TOOLS/<name>.py``
    runs the port's module; ``examples/your_first_block.py`` beside it
    runs the port's example."""
    tools = os.path.join(str(base), 'tools')
    os.makedirs(tools, exist_ok=True)
    for name in TOOL_NAMES:
        with open(os.path.join(tools, name + '.py'), 'w') as f:
            f.write("import runpy, sys\nsys.path.insert(0, %r)\n"
                    "runpy.run_module('bifrost_tpu_torch.tools.%s', "
                    "run_name='__main__', alter_sys=True)\n" % (ROOT, name))
    ex = os.path.join(str(base), 'examples')
    os.makedirs(ex, exist_ok=True)
    with open(os.path.join(ex, 'your_first_block.py'), 'w') as f:
        f.write("import runpy\nrunpy.run_path(%r, run_name='__main__')\n"
                % os.path.join(ROOT, 'examples', 'your_first_block_torch.py'))
    return tools


def run_tool(pkg, name, *args, env=None):
    """One tool of ``pkg`` ('jax' or 'port') as a subprocess."""
    if pkg == 'jax':
        cmd = [sys.executable, os.path.join(JAX_TOOLS, name + '.py')]
    else:
        cmd = [sys.executable, '-m', 'bifrost_tpu_torch.tools.' + name]
    return subprocess.run(cmd + [str(a) for a in args], capture_output=True,
                          text=True, cwd=ROOT, timeout=TIMEOUT,
                          env=dict(os.environ, **(env or {})))


# ---------------------------------------------------------------------------
# the JAX package's tool tests, on the port
# ---------------------------------------------------------------------------

TOOL_TESTS = ['test_like_bmon_once', 'test_like_bmon_rates_from_capture',
              'test_like_pmap', 'test_bf_lint_script_mode',
              'test_bf_lint_codes_catalog',
              'test_mprobe_report_dump_and_clear']
OBS_TESTS = ['test_trace_merge_shifts_clocks',
             'test_telemetry_diff_flags_regressions']


@pytest.mark.parametrize('name', TOOL_TESTS)
def test_jax_tool_test_on_the_port(name, tmp_path, monkeypatch):
    fn = getattr(JT, name)
    fixtures = {'tmp_path': tmp_path, 'monkeypatch': monkeypatch}
    args = [fixtures[a] for a in fn.__code__.co_varnames[
        :fn.__code__.co_argcount]]
    rehome(fn, {'bifrost_tpu': bt}, TOOLS=port_tools_dir(tmp_path / 'p'),
           NumpySourceBlock=TorchNumpySourceBlock,
           GatherSink=TorchGatherSink)(*args)


@pytest.mark.parametrize('name', OBS_TESTS)
def test_jax_observability_tool_test_on_the_port(name, tmp_path):
    rehome(getattr(JO, name), {}, TOOLS=port_tools_dir(tmp_path / 'p'))(
        tmp_path)


# ---------------------------------------------------------------------------
# each tool beside its JAX twin, on the same input
# ---------------------------------------------------------------------------

def _capture_tree(base, pid):
    """A ProcLog tree of a capture, a transmitter and a bridge pair."""
    def put(block, text):
        d = os.path.join(str(base), str(pid), block)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, 'stats'), 'w') as f:
            f.write(text)
    put('rx_capture', 'ngood_bytes : 8192\nnmissing_bytes : 1024\n'
        'ninvalid : 3\nnignored : 1\nnpackets : 128\n'
        'worker0_npackets : 100\nworker0_nbytes : 6400\n'
        'worker0_zero_copy : 1\n')
    put('chips_transmit_1', 'npackets : 64\nnbytes : 4096\n')
    put('link_bridge_transmit', 'npackets : 12\nnbytes : 49152\n')
    put('link_bridge_capture', 'ngood_bytes : 49152\nnmissing_bytes : 0\n'
        'ninvalid : 0\nnignored : 2\nnpackets : 12\n')


def test_like_bmon_equals_the_jax_tool(tmp_path):
    _capture_tree(tmp_path, os.getpid())
    env = {'BF_PROCLOG_DIR': str(tmp_path)}
    jax, port = (run_tool(p, 'like_bmon', '--once', env=env)
                 for p in ('jax', 'port'))
    assert jax.returncode == port.returncode == 0, port.stderr
    assert '[bridge]' in port.stdout and 'rx_capture' in port.stdout
    assert port.stdout == jax.stdout


def _ring_tree(base, pid):
    d = os.path.join(str(base), str(pid), 'rings', 'ring_a')
    os.makedirs(d)
    with open(os.path.join(d, 'geometry'), 'w') as f:
        f.write('space : system\nspan : 4096\nstride : 4096\n'
                'nringlet : 1\n')


def test_like_pmap_equals_the_jax_tool(tmp_path):
    """Both tools map the same ring tree onto the same live process (a
    child that sleeps, so its address space stays put)."""
    child = subprocess.Popen([sys.executable, '-c',
                              'import time; time.sleep(60)'])
    try:
        _ring_tree(tmp_path, child.pid)
        env = {'BF_PROCLOG_DIR': str(tmp_path)}
        jax, port = (run_tool(p, 'like_pmap', child.pid, env=env)
                     for p in ('jax', 'port'))
        missing = run_tool('port', 'like_pmap', 1 << 30, env=env)
        jmissing = run_tool('jax', 'like_pmap', 1 << 30, env=env)
    finally:
        child.kill()
        child.wait()
    assert jax.returncode == port.returncode == 0, port.stderr
    assert 'Ring Mappings:' in port.stdout
    assert port.stdout == jax.stdout
    assert missing.returncode == jmissing.returncode
    assert missing.stdout == jmissing.stdout


def _mask_console(text):
    return re.sub(r'(:|<this-host>:)\d{2,5}\b', r'\1PORT', text)


def test_bf_console_equals_the_jax_tool():
    jax, port = (run_tool(p, 'bf_console', '--once', '--interval', '0.2')
                 for p in ('jax', 'port'))
    assert jax.returncode == port.returncode == 0, port.stderr
    assert 'fleet - 0 host(s)' in port.stdout
    assert _mask_console(port.stdout) == _mask_console(jax.stdout)
    jax, port = (run_tool(p, 'bf_console', '--fabric', 'x.json')
                 for p in ('jax', 'port'))
    assert jax.returncode == port.returncode == 2
    assert port.stderr == jax.stderr


def _bf_clock_traces(tmp_path):
    ev = {'ph': 'X', 'name': 'x.on_data', 'cat': 'compute', 'pid': 1,
          'tid': 1, 'dur': 5.0, 'args': {'trace': 'abc', 'seq': 0,
                                         'gulp': 0}}
    paths = []
    for host, ts, sess in (('hostA', 1000.0, {'role': 'tx',
                                              'offset_us': 500.0,
                                              'rtt_us': 10.0}),
                           ('hostB', 1600.0, {'role': 'rx'}),
                           ('hostC', 90.0, {})):
        path = tmp_path / ('%s.json' % host)
        JO._synthetic_trace(path, host, [dict(ev, ts=ts)],
                            {'sess1': sess} if sess else {})
        paths.append(str(path))
    return paths


def test_trace_merge_equals_the_jax_tool(tmp_path):
    """Linked, chained and unlinked inputs: the same merged JSON and the
    same report on stderr, but for the output path."""
    paths = _bf_clock_traces(tmp_path)
    out = {}
    for pkg in ('jax', 'port'):
        dst = tmp_path / ('merged_%s.json' % pkg)
        res = run_tool(pkg, 'trace_merge', '-o', dst, *paths)
        assert res.returncode == 0, res.stderr
        out[pkg] = (json.loads(dst.read_text()),
                    res.stdout.replace(str(dst), 'OUT'),
                    res.stderr.replace(str(dst), 'OUT'))
    assert out['port'] == out['jax']
    bad = [run_tool(p, 'trace_merge', '-o', tmp_path / 'x.json',
                    tmp_path / 'missing.json') for p in ('jax', 'port')]
    assert bad[0].returncode == bad[1].returncode != 0


def test_telemetry_diff_equals_the_jax_tool(tmp_path):
    base = {'value': 10.0, 'gulps_per_s': 100.0, 'wait_p99_ms': 4.0,
            'occupancy_pct': 10.0, 'capture': {'pps': 1e6},
            'counters': {'slo.violations': 0, 'fleet.hosts_live': 2,
                         'segment.elided_rings': 3,
                         'kernel.fused_spectrometer.launches': 64}}
    cur = {'value': 10.0, 'gulps_per_s': 80.0, 'wait_p99_ms': 9.0,
           'occupancy_pct': 45.0, 'capture': {'pps': 8e5},
           'counters': {'slo.violations': 3, 'fleet.hosts_live': 1,
                        'segment.elided_rings': 2,
                        'kernel.fused_spectrometer.launches': 64}}
    b, c = tmp_path / 'b.json', tmp_path / 'c.json'
    b.write_text(json.dumps(base))
    c.write_text(json.dumps(cur))
    for args in ([b, c], [b, c, '--strict'], [c, b, '--strict'],
                 [b, b, '--strict'], [b, tmp_path / 'none.json']):
        res = {}
        for pkg in ('jax', 'port'):
            rep = tmp_path / ('rep_%s.json' % pkg)
            r = run_tool(pkg, 'telemetry_diff', *(args + ['--out', rep]))
            res[pkg] = (r.returncode, r.stdout.replace(str(rep), 'OUT'),
                        r.stderr, rep.read_text() if rep.exists() else None)
            if rep.exists():
                rep.unlink()
        assert res['port'] == res['jax'], args
    assert ttelemetry_diff.compare(base, cur) == \
        _jax_telemetry_diff().compare(base, cur)


def _jax_telemetry_diff():
    sys.path.insert(0, JAX_TOOLS)
    try:
        import telemetry_diff
    finally:
        sys.path.remove(JAX_TOOLS)
    assert telemetry_diff is not ttelemetry_diff
    return telemetry_diff


@pytest.mark.parametrize('script', ['your_first_block_torch.py',
                                    'your_first_block.py',
                                    'fdmt_search_torch.py'])
def test_bf_lint_equals_the_jax_tool(script):
    """Script mode drives the script's own package under ``BF_LINT=1``:
    the JAX tool and the port's give the same report on the same script,
    in advisory and strict mode."""
    path = os.path.join(ROOT, 'examples', script)
    for args in ([path], ['--strict', path], ['--strict', '--show-info',
                                              path]):
        jax, port = (run_tool(p, 'bf_lint', *args) for p in ('jax', 'port'))
        assert port.returncode == jax.returncode == 0, port.stderr
        assert port.stdout == jax.stdout


def test_bf_lint_exit_codes_equal_the_jax_tool(tmp_path):
    """A script that builds no pipeline exits 2 in both; a script whose
    pipeline has a BF-E exits 3 under --strict and 0 without it."""
    none = tmp_path / 'none.py'
    none.write_text('print("no pipeline")\n')
    jax, port = (run_tool(p, 'bf_lint', none) for p in ('jax', 'port'))
    assert jax.returncode == port.returncode == 2
    bad = tmp_path / 'bad.py'
    bad.write_text(
        "import sys\nsys.path.insert(0, %r)\n"
        "import bifrost_tpu_torch as bt\n"
        "from bifrost_tpu_torch import device\n"
        "from tests.test_torch_verify import _chain\n"
        "device.set_device('cpu')\n"
        "p, fb = _chain(bt, lambda F, D, R: [R('freq', 4)])\n"
        "p.run()\n" % ROOT)
    for strict, want in (([], 0), (['--strict'], 3)):
        jax, port = (run_tool(p, 'bf_lint', *(strict + [bad]))
                     for p in ('jax', 'port'))
        assert jax.returncode == port.returncode == want, port.stderr
        assert 'BF-E' in port.stdout
        assert port.stdout == jax.stdout
    jax, port = (run_tool(p, 'bf_lint', '--topology', 'nope')
                 for p in ('jax', 'port'))
    assert jax.returncode == port.returncode == 2


def test_bf_lint_codes_equal_the_jax_tool():
    jax, port = (run_tool(p, 'bf_lint', '--codes') for p in ('jax', 'port'))
    assert jax.returncode == port.returncode == 0
    assert port.stdout == jax.stdout


def _winner_cache(cache):
    cache.mkdir()
    (cache / 'beamform.json').write_text(json.dumps({
        'torch-cpu:cpu:v0|acc=int8 w=(1,4,8) v=(8,2,1,8) int8': {
            'winner': 'int8_wide', 'ms': {'int8_wide': 1.0, 'xla': 5.0}},
        'torch-cpu:cpu:v0|acc=f32 w=(1,4,8) v=(8,2,1,8) float32': {
            'winner': 'planar', 'ms': {'planar': 1.00, 'xla': 1.01}}}))
    (cache / 'fdmt.json').write_text(json.dumps({
        'torch-cpu:cpu:v0|k': {'winner': 'rolls',
                               'ms': {'rolls': 2.0}}}))
    (cache / 'xengine.json').write_text('{not json')
    (cache / 'telemetry_usage.json').write_text(
        json.dumps({'counters.inc': [12, 3, 0.5]}))


def test_mprobe_report_equals_the_jax_tool(tmp_path):
    """The same cache directory rendered, dumped and cleared by both."""
    for args in ([], ['--json'], ['--family', 'beamform'],
                 ['--json', '--family', 'fdmt'], ['--clear', '--family',
                                                  'beamform'], ['--clear']):
        res = {}
        for pkg in ('jax', 'port'):
            cache = tmp_path / pkg / '-'.join(args or ['plain'])
            cache.parent.mkdir(exist_ok=True)
            _winner_cache(cache)
            r = run_tool(pkg, 'mprobe_report', *args,
                         env={'BF_CACHE_DIR': str(cache)})
            res[pkg] = (r.returncode, r.stdout.replace(str(cache), 'DIR'),
                        sorted(os.listdir(str(cache))))
        assert res['port'] == res['jax'], args
    for pkg in ('jax', 'port'):
        r = run_tool(pkg, 'mprobe_report',
                     env={'BF_CACHE_DIR': str(tmp_path / 'absent')})
        assert r.returncode == 2


def test_mprobe_report_sees_the_port_race_in_process(tmp_path, monkeypatch):
    """Embedded in a process, the report merges the port's in-process
    race (its winner not yet on disk) with the disk caches."""
    from bifrost_tpu_torch.tools import mprobe_report
    monkeypatch.setenv('BF_CACHE_DIR', str(tmp_path))
    monkeypatch.setattr(tmprobe, '_cache', {})
    calls = []

    def cand(name, ms):
        def run(x):
            calls.append(name)
            return x
        return run
    winner = tmprobe.select('drill', 'k1', {'a': cand('a', 1),
                                            'b': cand('b', 1)},
                            lambda: (np.zeros(4),), n_reps=1, noise=1e9)[0]
    rep = mprobe_report.report()
    key = '%s|k1' % tmprobe.backend_tag()
    assert rep['drill'][key]['winner'] == winner
    assert rep['drill'][key]['persisted'] is False
    assert any('in-process only' in line
               for line in mprobe_report.render(rep))


# ---------------------------------------------------------------------------
# trace_merge over a JAX-host trace and a port-host trace of one stream
# ---------------------------------------------------------------------------

def test_trace_merge_joins_a_jax_host_and_a_port_host(tmp_path,
                                                      monkeypatch):
    """A JAX sender pipeline streams into a port receiver pipeline over a
    loopback bridge, both with span tracing on; each package exports its
    own trace.  The port's trace_merge links them by the bridge session
    (the JAX tx side carries the offset), and the compute spans of both
    hosts share (trace, seq, gulp) identities."""
    monkeypatch.setenv('BF_TRACE_FILE', str(tmp_path / 'unused.json'))
    teles = (bt.telemetry, bf.telemetry)
    for tele in teles:
        tele.spans.reconfigure()
        tele.spans.reset()
    gulps = [np.random.RandomState(7).randn(8, 4).astype(np.float32)
             for _ in range(4)]
    hdr = simple_header([-1, 4], 'f32', name='mixed', gulp_nframe=8)
    try:
        def build_rx():
            bsrc = bt.blocks.bridge_source('127.0.0.1', 0)
            return bsrc, TorchGatherSink(bt.blocks.copy(bsrc))

        def build_tx(rx):
            src = JNumpySource(gulps, hdr, gulp_nframe=8)
            return bf.blocks.bridge_sink(bf.blocks.copy(src), '127.0.0.1',
                                         rx[0].port)
        (bsrc, sink), _tx = _two_pipelines(bt, bf, build_rx, build_tx)
        np.testing.assert_array_equal(sink.result(), np.concatenate(gulps))
        jpath, ppath = str(tmp_path / 'jax.json'), str(tmp_path / 'port.json')
        bf.telemetry.spans.export(jpath)
        bt.telemetry.spans.export(ppath)
    finally:
        monkeypatch.delenv('BF_TRACE_FILE')
        for tele in teles:
            tele.spans.reconfigure()
            tele.spans.reset()
    out = tmp_path / 'merged.json'
    res = run_tool('port', 'trace_merge', '-o', out, jpath, ppath)
    assert res.returncode == 0, res.stderr
    merged = json.loads(out.read_text())
    info = merged['otherData']['bf_merged_from']
    assert len(info) == 2
    # linked by the bridge session: no zero-shift warning, and the port
    # file shifted onto the JAX file's clock
    assert 'WARNING' not in res.stderr, res.stderr
    assert info[jpath]['shift_us'] == 0.0
    assert info[ppath]['shift_us'] != 0.0, info
    ident = {}
    for e in merged['traceEvents']:
        a = e.get('args') or {}
        if e.get('ph') == 'X' and 'trace' in a and 'gulp' in a:
            ident.setdefault(e['pid'], set()).add(
                (a['trace'], a.get('seq'), a['gulp']))
    assert len(ident) == 2, sorted(ident)
    shared = set.intersection(*ident.values())
    assert len(shared) == 4, ident


def test_port_tools_run_as_scripts_from_a_launcher(tmp_path):
    """The launchers the rehomed tests run reach the port's modules."""
    tools = port_tools_dir(tmp_path)
    for name in TOOL_NAMES:
        r = subprocess.run([sys.executable, os.path.join(tools, name + '.py'),
                            '--help'], capture_output=True, text=True,
                           timeout=TIMEOUT)
        assert r.returncode == 0, (name, r.stderr)
        assert r.stdout.startswith('usage:'), name
