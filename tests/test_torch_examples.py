"""The port's examples against the JAX package's on the CPU:

- ``examples/gpuspec_simple_torch.py``, the north star's chain, against
  ``examples/gpuspec_simple.py`` on the same 4-channel, 256-sample demo
  ``.raw``: both write a ``.fil``; the two headers are byte-identical and
  the two data sections agree within 1e-5 of the float64 oracle's
  largest magnitude;
- ``examples/fx_correlator_torch.py`` against ``examples/fx_correlator.py``:
  the storage-format visibilities equal value for value (the int8 X
  engine is exact), and equal the numpy storage conversion of the int64
  oracle's visibilities;
- ``examples/romein_grid_torch.py`` against ``examples/romein_grid.py``:
  the accumulated grids agree within 1e-5 of the largest magnitude and
  the dirty image peaks at the injected source;
- ``examples/capture_spectrometer_torch.py`` (live CHIPS packets over
  loopback, the native capture and transmit engines) against
  ``examples/capture_spectrometer.py``: the detected spectra agree within
  1e-5 of the largest bin and both peak at the tone.

Each example imports no jax and runs on the card by default; without a
card it stops with the device error.  Here the tests call
``device.set_device('cpu')`` first.
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
EXAMPLES = [os.path.join(ROOT, 'examples', n + '_torch.py')
            for n in ('gpuspec_simple', 'fx_correlator', 'romein_grid',
                      'capture_spectrometer')]
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


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or '')
    return names


@pytest.mark.parametrize('path', EXAMPLES[1:], ids=os.path.basename)
def test_new_example_imports_no_jax(path):
    names = _imports(path)
    assert 'bifrost_tpu_torch' in names
    assert not [n for n in names
                if n.split('.')[0] in ('jax', 'jaxlib', 'bifrost_tpu')]


def test_example_imports_no_jax():
    names = _imports(EXAMPLE)
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


@pytest.mark.parametrize('path', EXAMPLES[1:], ids=os.path.basename)
def test_new_examples_stop_without_a_card(path, tmp_path):
    """The FX correlator and Romein examples run on cuda:0: with no card
    they exit non-zero with the device error and print no result."""
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES='')
    p = subprocess.run([sys.executable, path], cwd=str(tmp_path), env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert "set_device('cpu')" in p.stderr
    assert 'integration:' not in p.stdout and 'peak at' not in p.stdout
    assert 'import jax' not in p.stderr


def _storage_of(full):
    """numpy matrix -> storage conversion of full Hermitian visibilities
    (t, f, S, 2, S, 2)."""
    S = full.shape[2]
    bi = np.concatenate([np.full(i + 1, i) for i in range(S)])
    bj = np.concatenate([np.arange(i + 1) for i in range(S)])
    v = np.moveaxis(full[:, :, bi, :, bj, :], 0, 1)
    xx, xy, yx, yy = v[..., 0, 0], v[..., 0, 1], v[..., 1, 0], v[..., 1, 1]
    return np.stack([xx + yy, xx - yy, xy + yx, (xy - yx) * 1j], -1)


def test_fx_correlator_example_equals_jax_and_the_oracle():
    """The port's FX example's storage visibilities equal the JAX
    example's chain's, value for value, and the numpy storage conversion
    of the int64 oracle on the quantized spectra."""
    device.set_device('cpu')
    tex, jex = _load('fx_correlator_torch'), _load('fx_correlator')
    p, sink = tex.build_single(quiet=True)
    run_bounded(p)
    got = np.concatenate(sink.visibilities)

    class Keep(bf.SinkBlock):
        def on_sequence(self, iseq):
            self.out = []

        def on_data(self, ispan):
            self.out.append(np.array(ispan.data.as_numpy(), copy=True))

    with bf.Pipeline() as p:
        keep = Keep(jex.build_xchain(jex.StationSource()))
    run_bounded(p)
    want = np.concatenate(keep.out)
    nbl = tex.NS * (tex.NS + 1) // 2
    ngroup = tex.NGULP * tex.NT // (tex.R * tex.A)
    assert got.shape == (ngroup, nbl, tex.NW, 4)
    np.testing.assert_array_equal(got, want)
    # the oracle: F step and requantize in float64, int64 products
    g = tex.StationSource().gulp
    v = g['re'].astype(np.float64) + 1j * g['im']
    spec = np.fft.fft(v, axis=1) / tex.NW
    q = np.clip(np.round(spec.real), -128, 127) + \
        1j * np.clip(np.round(spec.imag), -128, 127)
    q = q.reshape(tex.NT // (tex.R * tex.A), tex.R * tex.A, tex.NW,
                  tex.NS * tex.NP)
    vis = np.einsum('gtfi,gtfj->gfij', q, np.conj(q))
    full = vis.reshape(-1, tex.NW, tex.NS, tex.NP, tex.NS, tex.NP)
    oracle = _storage_of(full).astype(np.complex64)
    for k in range(tex.NGULP):
        np.testing.assert_array_equal(got[k * len(oracle):
                                          (k + 1) * len(oracle)], oracle)
    peak = np.abs(got[0, 0, :, 0]).argmax()
    assert peak == tex.TONE_BIN


def test_romein_example_equals_jax_and_finds_the_source():
    device.set_device('cpu')
    tex, jex = _load('romein_grid_torch'), _load('romein_grid')
    p, imager = tex.build()
    run_bounded(p)
    with bf.Pipeline() as p:
        src = jex.SnapshotSource(['snapshots'], gulp_nframe=jex.GULP)
        b = bf.blocks.copy(src, space='tpu')
        b = bf.blocks.copy(jex.RomeinGridder(b), space='system')
        jimager = jex.DirtyImager(b)
    run_bounded(p)
    assert imager.nsnap == jimager.nsnap == tex.NTIME
    scale = np.abs(jimager.grid).max()
    assert np.abs(imager.grid - jimager.grid).max() / scale < GATE
    assert tex.peak_lm(imager.image()) == tex.SRC_LM


def test_capture_spectrometer_example_equals_jax():
    """examples/capture_spectrometer_torch.py (the native capture and
    transmit engines, fused FFT -> detect) against
    examples/capture_spectrometer.py through the JAX package: the
    detected spectra agree within 1e-5 of the largest bin, and both peak
    at the tone."""
    import types
    device.set_device('cpu')
    tex, jex = _load('capture_spectrometer_torch'), \
        _load('capture_spectrometer')
    got, engine = tex.run()
    assert engine == 'NativeUDPCapture'
    spectra = []

    class Recording(bf.SinkBlock):
        """Records what the JAX example's sink sums."""

        def __init_subclass__(cls, **kw):
            super().__init_subclass__(**kw)
            inner = cls.on_data

            def on_data(self, ispan):
                spectra.append(np.asarray(ispan.data.as_numpy())
                               .sum(axis=(0, 1)))
                return inner(self, ispan)
            cls.on_data = on_data

    class _CappedEvent(object):
        """The JAX example waits up to 30 s for its blocks' start-up,
        which they finish only once data flows: a timed wait here lasts
        at most 1 s (untimed waits are left alone)."""

        def __init__(self, event):
            self._event = event

        def __getattr__(self, name):
            return getattr(self._event, name)

        def wait(self, timeout=None):
            return self._event.wait(None if timeout is None
                                    else min(timeout, 1.0))

    pipelines = []

    class Pipeline(bf.Pipeline):
        def __init__(self, *args, **kwargs):
            super(Pipeline, self).__init__(*args, **kwargs)
            self.started = self.all_blocks_finished_initializing_event
            self.all_blocks_finished_initializing_event = _CappedEvent(
                self.started)
            pipelines.append(self)

    # The JAX example's transmitter and capture race its copy block: on
    # a loaded host the capture can take the whole stream in one batch
    # and lap the 4-span ring before the reader attaches.  The port's
    # example has a handshake; the same one is put around the JAX
    # example's objects here (its data path is untouched): the
    # transmitter waits after the first slot until the pipeline has
    # started, and the capture's idle returns do not end it before the
    # transmitter is done.
    import threading
    import time
    sent = threading.Event()

    def transmit(*args, **kwargs):
        tx = real_transmit(*args, **kwargs)
        send, calls = tx.send, []

        def gated_send(*a, **k):
            if len(calls) == 1:
                assert pipelines[-1].started.wait(60)
            calls.append(1)
            out = send(*a, **k)
            if len(calls) == jex.NSEQ + 2 * jex.BUF_NTIME:
                sent.set()
            return out
        tx.send = gated_send
        return tx

    def capture(*args, **kwargs):
        cap = real_capture(*args, **kwargs)
        recv = cap.recv

        def gated_recv():
            deadline = time.monotonic() + 60
            while True:
                status = recv()
                if status not in (jex.CAPTURE_NO_DATA,
                                  jex.CAPTURE_INTERRUPTED) or \
                        sent.is_set() or time.monotonic() > deadline:
                    return status
        cap.recv = gated_recv
        return cap

    real_capture, real_transmit = jex.UDPCapture, jex.UDPTransmit
    proxy = types.ModuleType('bifrost_tpu')
    proxy.__dict__.update(bf.__dict__)
    proxy.SinkBlock = Recording
    proxy.Pipeline = Pipeline
    jex.bf = proxy
    jex.UDPCapture, jex.UDPTransmit = capture, transmit
    out = io.StringIO()
    import contextlib
    with contextlib.redirect_stdout(out):
        jex.main()
    want = np.sum(spectra, axis=0)
    assert 'detected tone at fine bin %d' % jex.TONE_BIN in out.getvalue()
    assert got.shape == want.shape == (tex.NTIME,)
    assert int(np.argmax(got)) == int(np.argmax(want)) == tex.TONE_BIN
    assert np.abs(got - want).max() / np.abs(want).max() < GATE


def test_fx_correlator_fabric_equals_single_host_and_jax(capsys):
    """``examples/fx_correlator_torch.py --fabric`` (the two-host loopback
    fabric) delivers the single-host run's visibilities byte for byte,
    and prints what the JAX example's ``--fabric`` run prints."""
    from bifrost_tpu import proclog as jproclog
    from bifrost_tpu_torch import proclog as tproclog
    device.set_device('cpu')
    tex, jex = _load('fx_correlator_torch'), _load('fx_correlator')
    p, single = tex.build_single(quiet=True)
    run_bounded(p)
    capsys.readouterr()
    saved = sys.argv
    try:
        assert tex.main(['fx_correlator_torch.py', '--fabric']) == 0
        got = capsys.readouterr().out.splitlines()
        hosts, sinks = tex.build_fabric(quiet=True)
        tex.run_hosts(hosts)
        sys.argv = ['fx_correlator.py', '--fabric']
        jex.main()
    finally:
        sys.argv = saved
        # a fabric host names the process (proclog.set_identity)
        tproclog.set_identity(None)
        jproclog.set_identity(None)
    want = capsys.readouterr().out.splitlines()
    assert len(sinks[0].visibilities) == tex.NGULP
    for a, b in zip(sinks[0].visibilities, single.visibilities):
        assert a.tobytes() == b.tobytes()
    assert got == want and len(got) == 1 + tex.NGULP * tex.NT // (
        tex.R * tex.A)
