"""The port's top-level surface, its remaining examples and its monitors
against the JAX package's.

- ``bifrost_tpu_torch`` exports every name ``bifrost_tpu/__init__.py``
  binds, less the JAX-only ones, plus the port's own modules.
- ``asarray``, ``zeros``, ``empty_like``, ``zeros_like``, ``Space`` and
  ``EnvVars`` against their JAX counterparts.
- ``examples/{your_first_block,file_roundtrip,serialize_replay,
  fdmt_search}_torch.py`` at their own (small) sizes against their JAX
  twins' chains: file bytes and headers exactly, detected floats within
  1e-6 of the largest value, decisions (peaks, counts) exactly.
- ``monitor_utils``, ``like_ps``, ``pipeline2dot``, ``like_top`` and the
  ``cli`` entry points render a live CPU pipeline's ProcLog tree.
"""

import ast
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import bifrost_tpu as bf
import bifrost_tpu.monitor_utils as JMU
import bifrost_tpu.space as JS
import bifrost_tpu.utils as JU

import bifrost_tpu_torch as bt
import bifrost_tpu_torch.monitor_utils as TMU
import bifrost_tpu_torch.space as TSP
import bifrost_tpu_torch.utils as TU
from bifrost_tpu_torch import cli, device, proclog
from bifrost_tpu_torch.io import sigproc as TIO
from bifrost_tpu_torch.tools import like_ps, like_top, pipeline2dot

from tests.test_torch_bounded import join_bounded, run_bounded
from tests.test_torch_supervision import TorchGatherSink, TorchNumpySourceBlock
from tests.util import simple_header

#: the ndarray modules (each package's ``ndarray`` attribute is the class)
JN = importlib.import_module('bifrost_tpu.ndarray')
TN = importlib.import_module('bifrost_tpu_torch.ndarray')

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: names the JAX package exports that have no meaning in the port
JAX_ONLY = {'enable_compilation_cache'}
#: the port's modules that the JAX package's __init__ does not bind
PORT_ONLY = {'affinity', 'macro', 'segments', 'xfer'}
#: detected floats: |port - JAX| / max|JAX|
GATE = 1e-6


@pytest.fixture(autouse=True)
def _cpu():
    device.set_device('cpu')


# ---------------------------------------------------------------------------
# the exported names
# ---------------------------------------------------------------------------

def _jax_exports():
    """Every public name ``bifrost_tpu/__init__.py`` binds by import."""
    with open(os.path.join(ROOT, 'bifrost_tpu', '__init__.py')) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and node.level == 1:
            for a in node.names:
                names.add(a.asname or a.name)
    return {n for n in names if not n.startswith('_')}


def test_exports_equal_the_jax_package_less_its_jax_only_names():
    jax = _jax_exports()
    assert JAX_ONLY <= jax and len(jax) > 50
    assert set(bt.__all__) == (jax - JAX_ONLY) | PORT_ONLY
    assert len(bt.__all__) == len(set(bt.__all__))
    for name in bt.__all__:
        assert getattr(bt, name) is not None, name
        assert hasattr(bf, name) or name in PORT_ONLY, name
    assert bt.autotune.AutoTuner and bt.telemetry.fleet.FleetCollector
    assert bt.address is bt.io.udp_socket.Address
    assert bt.reduce is bt.ops.reduce.reduce


# ---------------------------------------------------------------------------
# ndarray constructors, Space, EnvVars
# ---------------------------------------------------------------------------

def _host(a):
    return np.array(a.as_numpy(), copy=True)


@pytest.mark.parametrize('dtype', ['f32', 'cf32', 'ci8', 'i16', 'u8'])
def test_zeros_and_likes_equal_jax(dtype):
    for space in ('system', 'cuda_host'):
        t = TN.zeros((3, 5), dtype, space=space)
        j = JN.zeros((3, 5), dtype, space='system')
        assert t.shape == j.shape == (3, 5)
        assert str(t.dtype) == str(j.dtype)
        assert _host(t).tobytes() == np.asarray(j).tobytes()
        assert t.space == space
        for like in (TN.zeros_like, TN.empty_like):
            o = like(t)
            assert (o.shape, str(o.dtype), o.space) == (t.shape,
                                                        str(t.dtype), space)
            assert like(t, space='system').space == 'system'
        assert _host(TN.zeros_like(t)).tobytes() == \
            np.asarray(JN.zeros_like(j)).tobytes()


def test_device_constructors_give_the_device_representation():
    d = TN.zeros((4, 6), 'ci8', space='cuda')
    assert tuple(d.shape) == (4, 6, 2) and not d.any()
    assert TN.empty_like(d).shape == d.shape
    assert not TN.zeros_like(d).any()
    with pytest.raises(TypeError):
        TN.zeros_like(d, space='system')
    assert tuple(TN.empty((4, 6), 'cf32', 'cuda').shape) == (4, 6)


@pytest.mark.parametrize('case', ['list', 'f64_as_f32', 'ci8_bytes',
                                  'packed_u4', 'ndarray'])
def test_asarray_equal_jax(case):
    rng = np.random.RandomState(3)
    if case == 'list':
        obj, dtype = [[1.5, 2.5], [3.5, 4.5]], None
    elif case == 'f64_as_f32':
        obj, dtype = rng.randn(3, 4), 'f32'
    elif case == 'ci8_bytes':
        obj, dtype = rng.randint(0, 256, (3, 8)).astype(np.uint8), 'ci8'
    elif case == 'packed_u4':
        obj, dtype = rng.randint(0, 256, (2, 3)).astype(np.uint8), 'u4'
    else:
        obj, dtype = None, None
    if case == 'ndarray':
        t_in = TN.asarray(rng.randn(2, 3).astype(np.float32))
        j_in = JN.asarray(np.array(t_in.as_numpy()))
        t, j = TN.asarray(t_in), JN.asarray(j_in)
        assert t is t_in and j is j_in
        t2, j2 = TN.asarray(t_in, space='cuda_host'), \
            JN.asarray(j_in, space='tpu_host')
    else:
        t2, j2 = TN.asarray(obj, dtype=dtype), JN.asarray(obj, dtype=dtype)
    assert t2.shape == j2.shape
    assert str(t2.dtype) == str(j2.dtype)
    assert _host(t2).tobytes() == np.asarray(j2).tobytes()
    # the device round trip keeps every byte
    back = TN.asarray(TN.asarray(t2, space='cuda'), space='system',
                      dtype=t2.dtype)
    assert back.shape == t2.shape and str(back.dtype) == str(t2.dtype)
    assert _host(back).tobytes() == _host(t2).tobytes()


def test_space_equal_jax_over_the_port_spaces():
    assert TSP.SPACES == ('system', 'cuda_host', 'cuda')
    for name, jname in (('system', 'system'), ('cuda_host', 'tpu_host'),
                        ('cuda', 'tpu'), ('pinned', 'tpu_host'),
                        ('cuda_managed', 'tpu')):
        t, j = TSP.Space(name), JS.Space(name)
        assert (t.is_device, t.is_host) == (j.is_device, j.is_host)
        assert str(j) == jname
        assert TSP.Space(t) == t and t == name and hash(t) == \
            hash(TSP.Space(str(t)))
        assert repr(t) == 'Space(%r)' % str(t)
    for bad in ('tpu', 'gpu', ''):
        with pytest.raises(ValueError):
            TSP.Space(bad)
    with pytest.raises(ValueError):
        JS.Space('gpu')
    assert TSP.canonical(TSP.Space('pinned')) == 'cuda_host'


def test_envvars_equal_jax(monkeypatch):
    for E in (TU.EnvVars, JU.EnvVars):
        E.clear()
    monkeypatch.setenv('BF_SURFACE_PROBE', 'one')
    got = [E.get('BF_SURFACE_PROBE') for E in (TU.EnvVars, JU.EnvVars)]
    monkeypatch.setenv('BF_SURFACE_PROBE', 'two')
    got += [E.get('BF_SURFACE_PROBE') for E in (TU.EnvVars, JU.EnvVars)]
    got += [E.get('BF_SURFACE_ABSENT', 'd') for E in (TU.EnvVars,
                                                      JU.EnvVars)]
    for E in (TU.EnvVars, JU.EnvVars):
        E.clear()
    got += [E.get('BF_SURFACE_PROBE') for E in (TU.EnvVars, JU.EnvVars)]
    assert got == ['one', 'one', 'one', 'one', 'd', 'd', 'two', 'two']


# ---------------------------------------------------------------------------
# the examples against their JAX twins
# ---------------------------------------------------------------------------

NEW_EXAMPLES = ('your_first_block', 'file_roundtrip', 'serialize_replay',
                'fdmt_search')


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, 'examples', name + '.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_your_first_block_equals_jax():
    tex, jex = _load('your_first_block_torch'), _load('your_first_block')
    p, stats = tex.build(quiet=True)
    run_bounded(p)

    class Means(jex.PrintStats):
        def on_sequence(self, iseq):
            self.means = []

        def on_data(self, ispan):
            self.means.append(float(ispan.data.as_numpy().mean()))

    with bf.Pipeline() as p:
        src = jex.CountingSource(['demo'], gulp_nframe=8)
        b = bf.blocks.copy(src, space='tpu')
        b = bf.blocks.copy(jex.UselessAdd(b), space='system')
        jstats = Means(b)
    run_bounded(p)
    assert stats.means == jstats.means == [1001.0, 1002.0, 1003.0, 1004.0]


def _jax_file_roundtrip(jex, workdir):
    """examples/file_roundtrip.py's three hops, each in its own
    pipeline (its main() runs hop 2 in the default pipeline)."""
    os.makedirs(workdir)
    os.chdir(workdir)
    with bf.Pipeline() as p:
        bf.blocks.binary_write(jex.SynthSource(['synth'], gulp_nframe=16),
                               file_ext='out')
    run_bounded(p)
    with bf.Pipeline() as p:
        bc = bf.BlockChainer()
        bc.blocks.binary_read(['synth.out'], gulp_size=jex.NPOL * jex.NCHAN,
                              gulp_nframe=16, dtype='cf32')
        bc.views.split_axis('sample', jex.NCHAN, label='freq')
        bc.views.rename_axis('sample', 'pol')
        bc.blocks.copy(space='tpu')
        bc.blocks.detect(mode='stokes_i', axis='pol')
        bc.blocks.reduce('freq', jex.RF)
        bc.blocks.copy(space='system')
        bc.blocks.transpose(['time', 'pol', 'freq'])
        bc.blocks.write_sigproc(path='.')
    run_bounded(p)


def test_file_roundtrip_equals_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    tex, jex = _load('file_roundtrip_torch'), _load('file_roundtrip')
    fil = tex.main(str(tmp_path / 'port'), run=run_bounded)
    _jax_file_roundtrip(jex, str(tmp_path / 'jax'))
    port_dir, jax_dir = tmp_path / 'port', tmp_path / 'jax'
    assert (port_dir / 'synth.out').read_bytes() == \
        (jax_dir / 'synth.out').read_bytes()
    with TIO.SigprocFile(str(port_dir / fil)) as f:
        ph, pdata = f.header, f.read(1 << 20)
    with TIO.SigprocFile(str(jax_dir / fil)) as f:
        jh, jdata = f.header, f.read(1 << 20)
    assert ph == jh
    head = ph_size = TIO.SigprocFile(str(port_dir / fil)).header_size
    assert (port_dir / fil).read_bytes()[:head] == \
        (jax_dir / fil).read_bytes()[:ph_size]
    assert pdata.shape == jdata.shape
    assert np.abs(pdata - jdata).max() / np.abs(jdata).max() < GATE


def test_serialize_replay_equals_jax(tmp_path):
    tex, jex = _load('serialize_replay_torch'), _load('serialize_replay')
    live, replay = tex.main(str(tmp_path / 'port'), run=run_bounded)
    os.makedirs(str(tmp_path / 'jax'))
    with bf.Pipeline() as p:
        src = jex.PulseTrain(['pulses'], gulp_nframe=16)
        b = bf.blocks.copy(src, space='tpu')
        b = bf.blocks.detect(b, mode='scalar')
        b = bf.blocks.copy(b, space='system')
        jlive = jex.Gather(b)
        bf.blocks.serialize(b, path=str(tmp_path / 'jax'))
    run_bounded(p)
    got, want = live.result(), jlive.result()
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.abs(got - want).max() / np.abs(want).max() < GATE
    assert replay.result().tobytes() == got.tobytes()

    def header(d):
        with open(str(tmp_path / d / 'pulses.bf.json')) as f:
            h = json.load(f)
        h.pop('_trace', None)
        return h
    assert header('port') == header('jax')


def test_fdmt_search_equals_jax():
    tex, jex = _load('fdmt_search_torch'), _load('fdmt_search')
    p, peak = tex.build_single()
    run_bounded(p)
    with bf.Pipeline() as p:
        jpeak = jex.PeakFinder(jex.build_search_chain(
            jex.DispersedPulseSource()))
    run_bounded(p)
    snr, row, t = peak.best
    jsnr, jrow, jt = jpeak.best
    assert (row, t) == (jrow, jt)
    assert abs(snr - jsnr) / abs(jsnr) < GATE
    assert peak.ncandidates == jpeak.ncandidates
    assert peak.dm_step == jpeak.dm_step
    assert abs(row - tex.D_TRUE) <= 3 and abs(t - tex.T0) <= 4


def test_fdmt_search_fabric_waits_for_the_fabric_tier(capsys):
    tex = _load('fdmt_search_torch')
    assert tex.main(['fdmt_search_torch.py', '--fabric']) == 2
    assert 'fabric' in capsys.readouterr().err


@pytest.mark.parametrize('name', NEW_EXAMPLES)
def test_new_examples_import_no_jax_and_stop_without_a_card(name,
                                                            tmp_path):
    path = os.path.join(ROOT, 'examples', name + '_torch.py')
    with open(path) as f:
        tree = ast.parse(f.read())
    mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
            for a in n.names]
    mods += [n.module or '' for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom) and n.level == 0]
    assert 'bifrost_tpu_torch' in mods
    assert not [m for m in mods
                if m.split('.')[0] in ('jax', 'jaxlib', 'bifrost_tpu')]
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES='')
    res = subprocess.run([sys.executable, path, str(tmp_path / 'w')],
                         cwd=str(tmp_path), env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode != 0
    assert "set_device('cpu')" in res.stderr
    assert 'OK' not in res.stdout and 'candidate' not in res.stdout
    assert 'import jax' not in res.stderr


# ---------------------------------------------------------------------------
# the monitors over a live pipeline's ProcLog tree
# ---------------------------------------------------------------------------

@pytest.fixture
def live_pipeline(tmp_path, monkeypatch):
    """A port pipeline held mid-stream (its source waits on an event)
    with its ProcLog tree under ``tmp_path``; yields the pipeline."""
    monkeypatch.setenv('BF_PROCLOG_DIR', str(tmp_path / 'proclog'))
    monkeypatch.setenv('BF_PROCLOG_INTERVAL', '0')
    monkeypatch.setenv('BF_METRICS_INTERVAL', '0.1')
    release = threading.Event()
    hdr = simple_header([-1, 4], 'f32', labels=['time', 'freq'])

    class Held(TorchNumpySourceBlock):
        def on_data(self, reader, ospans):
            if reader.pos == 2:
                release.wait(60)
            return super(Held, self).on_data(reader, ospans)

    gulps = [np.full((8, 4), k, np.float32) for k in range(4)]
    with bt.Pipeline() as p:
        src = Held(gulps, hdr, gulp_nframe=8)
        b = bt.blocks.copy(src, space='cuda')
        TorchGatherSink(bt.blocks.copy(b, space='system'))
    box = {}

    def run():
        try:
            p.run()
        except BaseException as exc:
            box['exc'] = exc
    t = threading.Thread(target=run, daemon=True)
    t.start()
    pid = os.getpid()
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        c = proclog.load_by_pid(pid)
        if 'rings_flow' in {k.split(os.sep)[0] for k in c} and \
                any('perf' in logs for logs in c.values()):
            break
        time.sleep(0.02)
    try:
        yield p
    finally:
        release.set()
        join_bounded(t)
        assert 'exc' not in box, box


def test_monitor_utils_equal_jax_on_a_live_tree(live_pipeline):
    pid = os.getpid()
    contents = proclog.load_by_pid(pid)
    assert pid in TMU.list_pipelines()
    assert TMU.ring_geometry(contents) == JMU.ring_geometry(contents)
    names = {b.name for b in live_pipeline.blocks}
    for block, logs in contents.items():
        assert TMU.block_rings(logs) == JMU.block_rings(logs)
    assert names <= set(contents)
    for v in (0, 1023, 1 << 20, 5 << 30, 3 << 40):
        assert TMU.get_best_size(v) == JMU.get_best_size(v)
    assert TMU.get_command_line(pid) == JMU.get_command_line(pid)


def test_like_ps_pipeline2dot_like_top_render_a_live_tree(live_pipeline,
                                                          capsys):
    pid = os.getpid()
    names = [b.name for b in live_pipeline.blocks]
    text = '\n'.join(like_ps.describe_pid(pid))
    assert 'PID: %d' % pid in text and 'Rings:' in text
    for name in names:
        assert name in text
    dot = pipeline2dot.to_dot(pid, proclog.load_by_pid(pid))
    assert dot.startswith('digraph') and dot.rstrip().endswith('}')
    for name in names:
        assert name in dot
    rows = like_top.collect_blocks(pids=[pid])
    assert {r['name'] for r in rows.values()} >= set(names)
    lines = like_top.render_text(like_top.get_load_average(),
                                 like_top.get_processor_usage(),
                                 like_top.get_memory_swap_usage(), None,
                                 rows)
    assert lines[0].startswith('like_top')
    shown = [n.split('/')[-1][:24] for n in names]
    assert all(any(n in line for line in lines) for n in shown), \
        (shown, lines)
    assert cli.like_ps_main([str(pid)]) == 0
    assert cli.pipeline2dot_main([str(pid)]) == 0
    assert cli.like_top_main(['--once']) == 0
    out = capsys.readouterr().out
    assert 'PID: %d' % pid in out and 'digraph' in out
    assert 'like_top' in out


def test_console_scripts_name_the_port_cli():
    with open(os.path.join(ROOT, 'pyproject.toml')) as f:
        text = f.read()
    for script, fn in (('bf-torch-like-top', 'like_top_main'),
                       ('bf-torch-like-ps', 'like_ps_main'),
                       ('bf-torch-pipeline2dot', 'pipeline2dot_main')):
        assert '%s = "bifrost_tpu_torch.cli:%s"' % (script, fn) in text
        assert callable(getattr(cli, fn))
    assert 'bf-like-top = "bifrost_tpu.cli:like_top_main"' in text
