"""``examples/gpuspec_simple_torch.py``, the north star's chain through
the PyTorch/CUDA port, against ``examples/gpuspec_simple.py`` through the
JAX package on the same 4-channel, 256-sample demo ``.raw``: both write a
``.fil``; the two headers are byte-identical and the two data sections
agree within 1e-5 of the float64 oracle's largest magnitude.  The port's
example imports no jax and runs on the card by default: here its tests
call ``device.set_device('cpu')`` before ``build()``.
"""

import ast
import importlib.util
import io
import os
import subprocess
import sys

import numpy as np
import pytest

import bifrost_tpu as bf
from bifrost_tpu.ops.spectrometer import spectrometer_oracle

import bifrost_tpu_torch as bt
from bifrost_tpu_torch import device
from bifrost_tpu_torch.io import guppi as TG
from bifrost_tpu_torch.io import sigproc as TIO
from tests.test_torch_bounded import run_bounded

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(ROOT, 'examples', 'gpuspec_simple_torch.py')
GATE = 1e-5


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, 'examples', name + '.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope='module')
def outputs(tmp_path_factory):
    """Both examples over one demo .raw: {package: .fil path}, and the
    .raw's path."""
    device.set_device('cpu')
    tex, jex = _load('gpuspec_simple_torch'), _load('gpuspec_simple')
    base = tmp_path_factory.mktemp('gpuspec')
    raw = str(base / 'demo.raw')
    tex.make_demo_raw(raw)
    out = {}
    for pkg, ex in ((bt, tex), (bf, jex)):
        outdir = base / pkg.__name__
        outdir.mkdir()
        with pkg.Pipeline() as p:
            ex.build([raw], str(outdir))
            run_bounded(p)
        out[pkg] = str(outdir / 'demo.raw.fil')
    return out, raw


def _split(path):
    with TIO.SigprocFile(path) as f:
        nbyte = f.header_size
        hdr = f.header
    with open(path, 'rb') as f:
        blob = f.read()
    return blob[:nbyte], hdr, np.frombuffer(blob[nbyte:], np.float32)


def test_headers_byte_identical(outputs):
    (out, raw) = outputs
    thead, thdr, _ = _split(out[bt])
    jhead, jhdr, _ = _split(out[bf])
    assert thead == jhead
    assert thdr['nchans'] == 4 * 64 and thdr['nifs'] == 4
    assert thdr['nbits'] == 32 and thdr['source_name'] == 'TONE'


def test_data_within_oracle_gate(outputs):
    """Both data sections agree with each other and with the float64
    oracle (``spectrometer_oracle`` per coarse channel) within 1e-5 of
    the oracle's largest magnitude; the tone sits at fine bin 19 // 4."""
    (out, raw) = outputs
    _, hdr, tdata = _split(out[bt])
    _, _, jdata = _split(out[bf])
    nchan, ntime, npol, nblock, r = 4, 256, 2, 4, 4
    tdata = tdata.reshape(nblock, 4, nchan * ntime // r)
    jdata = jdata.reshape(tdata.shape)
    with open(raw, 'rb') as f:
        g = io.BytesIO(f.read())
    oracle = []
    for _ in range(nblock):
        h = TG.read_header(g)
        v = np.frombuffer(g.read(h['BLOCSIZE']), np.int8).reshape(
            nchan, ntime, npol, 2).transpose(0, 2, 1, 3)
        st = spectrometer_oracle(v, r)               # (nchan, 4, ntime/r)
        oracle.append(st.transpose(1, 0, 2).reshape(4, -1))
    oracle = np.stack(oracle)
    scale = np.abs(oracle).max()
    assert np.abs(tdata - jdata).max() / scale < GATE
    assert np.abs(tdata - oracle).max() / scale < GATE
    peaks = tdata[:, 0].reshape(nblock, nchan, -1).argmax(-1)
    assert (peaks == 19 // r).all()


def test_example_imports_no_jax():
    with open(EXAMPLE) as f:
        tree = ast.parse(f.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or '')
    assert 'bifrost_tpu_torch' in names
    assert not [n for n in names
                if n.split('.')[0] in ('jax', 'jaxlib', 'bifrost_tpu')]


def test_demo_without_a_card_stops_instead_of_using_the_cpu(tmp_path):
    """``--demo`` runs on cuda:0: with no card it fails with the device
    error and writes no data (there is no CPU fallback): at most the
    sink's header reaches the .fil."""
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES='')
    p = subprocess.run([sys.executable, EXAMPLE, '--demo', str(tmp_path)],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode != 0
    assert "set_device('cpu')" in p.stderr
    fil = tmp_path / 'demo.raw.fil'
    if fil.exists():
        with TIO.SigprocFile(str(fil)) as f:
            assert fil.stat().st_size == f.header_size
    assert 'import jax' not in p.stderr
