"""The port's native ring core (``ring_native.NativeRing`` over its own
``csrc/native/ring.cpp``, built by ``bifrost_tpu_torch.native``) against the
port's Python core and the JAX package's ``NativeRing``: the same script
of reserves, commits, acquires and releases gives the same bytes, offsets
and shed ledgers on all three; chains give the same bytes on both port
cores; the build is shared by concurrent processes and fails loudly.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import bifrost_tpu as bf
import bifrost_tpu.native as jnative
from bifrost_tpu.ring import EndOfDataStop as JEndOfDataStop

import bifrost_tpu_torch as bt
from bifrost_tpu_torch import device, native, xfer
from bifrost_tpu_torch.ring import Ring, EndOfDataStop
from bifrost_tpu_torch.ring_native import NativeRing
from tests.test_torch_bounded import run_bounded
from tests.test_torch_examples import _load

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    device.set_device('cpu')
    monkeypatch.delenv('BF_NO_NATIVE', raising=False)
    yield
    xfer.reset_engine()


def _port_ring(core, monkeypatch, name):
    if core == 'python':
        monkeypatch.setenv('BF_NO_NATIVE', '1')
    else:
        monkeypatch.delenv('BF_NO_NATIVE', raising=False)
    ring = Ring(space='system', name=name)
    assert isinstance(ring, NativeRing) == (core == 'native')
    return ring, EndOfDataStop


def _jax_native_ring(name):
    from bifrost_tpu.ring_native import NativeRing as JNativeRing
    if jnative.load() is None:
        raise RuntimeError('the JAX native core did not build')
    return JNativeRing(space='system', name=name), JEndOfDataStop


FB = 3 * 4              # a frame of one ringlet: 3 f32


def _script(ring, eod):
    """Reserve, commit, acquire and release across a wrap (the ghost), a
    blocking and a deferred resize, two ringlets, a second sequence and
    both shed policies, all on one thread; returns what a reader saw and
    the ring's ledger."""
    out = []
    data = np.random.RandomState(5).randn(2, 128, 3).astype(np.float32)
    pos = [0]

    def write(seq, n=4):
        with seq.reserve(n) as sp:
            sp.data.as_numpy()[...] = data[:, pos[0]:pos[0] + n]
            sp.commit(n)
        pos[0] += n

    def read(rd, off, n):
        with rd.acquire(off, n) as sp:
            out.append(('read', sp.frame_offset, sp.nframe,
                        sp.nframe_skipped,
                        np.array(sp.data.as_numpy()).tobytes()))
            return sp.frame_offset + sp.nframe

    hdr = {'name': 'a', 'gulp_nframe': 4,
           '_tensor': {'shape': [2, -1, 3], 'dtype': 'f32'}}
    with ring.begin_writing() as w:
        with w.begin_sequence(dict(hdr), 4, 12) as seq:
            rd = ring.open_earliest_sequence(guarantee=True)
            for _ in range(3):
                write(seq)
            out.append(('geom', ring.total_span, ring.ghost_span,
                        ring.nringlet))
            off = read(rd, 0, 6)
            # a deferred resize waits for the open span's release
            sp = rd.acquire(off, 4)
            applied = ring.request_resize(4 * FB, 24 * FB)
            out.append(('deferred', applied, ring.resize_pending))
            sp.release()
            out.append(('resized', ring.resize_pending, ring.total_span))
            off = 10
            for _ in range(2):
                write(seq)
            while off + 4 <= pos[0]:
                off = read(rd, off, 4)
            for _ in range(3):
                write(seq)                  # 20..32 wraps at 24
            off = read(rd, off, 4)          # 18..22
            off = read(rd, off, 4)          # 22..26 crosses the wrap
            off = read(rd, off, 4)
            ring.set_overload_policy('drop_oldest')
            for _ in range(6):
                write(seq)                  # sheds past the guarantee
            out.append(('drop_oldest', ring.shed_stats()))
            while off + 4 <= pos[0]:
                off = read(rd, off, 4)
            ring.set_overload_policy('drop_newest')
            for _ in range(8):
                write(seq)                  # the last two gulps are shed
            out.append(('drop_newest', ring.shed_stats()))
            while (off + 4) * FB <= ring.occupancy()['head']:
                off = read(rd, off, 4)
            ring.set_overload_policy('block')
        with w.begin_sequence(dict(hdr, name='b'), 4, 12) as seq:
            write(seq)
    rd.increment()
    out.append(('seq', rd.name, read(rd, 0, 4)))
    try:
        rd.acquire(4, 4)
        out.append(('no end',))
    except eod:
        out.append(('end',))
    rd.close()
    occ = ring.occupancy()
    out.append(('occupancy', occ['tail'], occ['head']))
    return out


def test_script_equal_on_both_port_cores_and_the_jax_native_ring(
        monkeypatch):
    want = _script(*_jax_native_ring('script_jax'))
    for core in ('native', 'python'):
        got = _script(*_port_ring(core, monkeypatch, 'script_' + core))
        assert got == want, core
    kinds = [r[0] for r in want]
    assert 'drop_oldest' in kinds and 'drop_newest' in kinds
    shed = dict((r[0], r[1]) for r in want if r[0].startswith('drop'))
    assert shed['drop_oldest']['shed_bytes'] > 0
    assert shed['drop_newest']['shed_gulps'] > 0


def test_chains_byte_identical_on_both_port_cores(monkeypatch, tmp_path):
    """The north star's Guppi chain (.fil bytes) and the FX correlator's
    chain (visibilities) on the native core and on the Python core."""
    tex, fex = _load('gpuspec_simple_torch'), _load('fx_correlator_torch')
    raw = str(tmp_path / 'demo.raw')
    tex.make_demo_raw(raw)
    fil, vis = {}, {}
    for core in ('native', 'python'):
        if core == 'python':
            monkeypatch.setenv('BF_NO_NATIVE', '1')
        outdir = tmp_path / core
        outdir.mkdir()
        with bt.Pipeline() as p:
            tex.build([raw], str(outdir))
        system = [r for b in p.blocks for r in b.orings
                  if r.space == 'system']
        assert system and all(isinstance(r, NativeRing) ==
                              (core == 'native') for r in system)
        run_bounded(p)
        fil[core] = (outdir / 'demo.raw.fil').read_bytes()
        p, sink = fex.build_single(quiet=True)
        run_bounded(p)
        vis[core] = np.concatenate(sink.visibilities)
    assert fil['native'] == fil['python'] and len(fil['native']) > 1000
    np.testing.assert_array_equal(vis['native'], vis['python'])


@pytest.mark.parametrize('core', ['native', 'python'])
def test_deferred_fill_that_wraps_the_buffer(core, monkeypatch):
    """Deferred D2H fills into a 20-frame ring: the third 8-frame span
    wraps, and its ghost is mirrored after the bytes land; a read across
    the wrap sees the data."""
    ring, _eod = _port_ring(core, monkeypatch, 'fill_wrap_' + core)
    data = np.random.RandomState(21).randn(24, 16).astype(np.float32)
    eng = xfer.TransferEngine(depth=16)
    hdr = {'name': 'f', 'gulp_nframe': 8,
           '_tensor': {'shape': [-1, 16], 'dtype': 'f32'}}
    with ring.begin_writing() as w:
        with w.begin_sequence(hdr, 8, 20) as seq:
            rd = ring.open_earliest_sequence(guarantee=False)
            fills = []
            for g0 in (0, 8, 16):
                dev = eng.to_device(data[g0:g0 + 8])
                with seq.reserve(8) as sp:
                    fill = eng.host_fill(dev, 'f32', sp.data.as_numpy())
                    sp.set_fill(fill)
                    sp.commit(8)
                fills.append(fill)
            with rd.acquire(14, 8) as span:
                got = np.array(span.data.as_numpy(), copy=True)
    eng.drain(block=True)
    assert all(f.done for f in fills)
    assert np.array_equal(got, data[14:22])


def test_cuda_host_and_cuda_rings_stay_off_the_native_core():
    assert isinstance(Ring(space='system'), NativeRing)
    assert type(Ring(space='cuda_host')) is Ring
    assert type(Ring(space='cuda')) is Ring


def test_no_native_gives_the_python_core(monkeypatch):
    monkeypatch.setenv('BF_NO_NATIVE', '1')
    assert not native.available() and native.load() is None
    assert type(Ring(space='system')) is Ring


def test_failed_build_raises(monkeypatch, tmp_path):
    """A source that does not compile raises NativeError with the
    compiler's message, from the build and from Ring(): no silent fall
    back to the Python core."""
    src = tmp_path / 'src'
    src.mkdir()
    for name in native.SOURCES:
        text = open(os.path.join(native._source_dir(), name)).read()
        if name == 'ring.cpp':
            text += '\nthis is not C++;\n'
        (src / name).write_text(text)
    monkeypatch.setattr(native, '_source_dir', lambda: str(src))
    monkeypatch.setattr(native, '_build_dir',
                        lambda: str(tmp_path / 'build'))
    monkeypatch.setattr(native, '_lib', None)
    with pytest.raises(native.NativeError) as ei:
        native.load()
    assert 'this is not C++' in str(ei.value)
    with pytest.raises(native.NativeError):
        Ring(space='system')
    assert not [f for f in os.listdir(tmp_path / 'build')
                if f.endswith('.so') or '.tmp' in f]


def test_two_processes_building_at_once_share_one_library(tmp_path):
    """Two processes start the build together into one empty directory:
    one library results, and both load it."""
    code = textwrap.dedent('''
        import sys
        from bifrost_tpu_torch import native
        native._build_dir = lambda: sys.argv[1]
        lib = native.load()
        print(lib._name)
    ''')
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop('BF_NO_NATIVE', None)
    procs = [subprocess.Popen([sys.executable, '-c', code,
                               str(tmp_path)], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    libs = sorted(f for f in os.listdir(tmp_path) if f.endswith('.so'))
    assert len(libs) == 1
    assert not [f for f in os.listdir(tmp_path) if '.tmp' in f]
    assert {o.strip() for o, _e in outs} == {str(tmp_path / libs[0])}
