"""The PyTorch/CUDA port stands alone: it imports nothing of JAX or of
the JAX package, and it never moves to the CPU on its own."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, 'bifrost_tpu_torch')
FORBIDDEN = ('jax', 'jaxlib', 'bifrost_tpu')


def _run(code):
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES='')
    return subprocess.run([sys.executable, '-c', code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)


def _sources():
    out = [os.path.join(ROOT, f) for f in ('chip_smoke.py',
                                            'chip_k1_variants.py',
                                            'chip_k6_variants.py',
                                            'chip_k8_variants.py',
                                            'examples/'
                                            'gpuspec_simple_torch.py',
                                            'examples/'
                                            'fx_correlator_torch.py',
                                            'examples/'
                                            'romein_grid_torch.py',
                                            'examples/'
                                            'your_first_block_torch.py',
                                            'examples/'
                                            'file_roundtrip_torch.py',
                                            'examples/'
                                            'serialize_replay_torch.py',
                                            'examples/'
                                            'fdmt_search_torch.py')]
    for dirpath, _, files in os.walk(PKG):
        out += [os.path.join(dirpath, f) for f in files
                if f.endswith('.py')]
    return out


def _top(name):
    return name.split('.')[0]


def test_import_leaves_jax_out_of_sys_modules():
    p = _run("import sys, bifrost_tpu_torch, bifrost_tpu_torch.stages, "
             "bifrost_tpu_torch.blocks, bifrost_tpu_torch.ops.spectrometer, "
             "bifrost_tpu_torch.ops.gpu_kernels, bifrost_tpu_torch._build, "
             "bifrost_tpu_torch.ops.beamform, bifrost_tpu_torch.ops.linalg, "
             "bifrost_tpu_torch.ops.mprobe, bifrost_tpu_torch.blocks.fft, "
             "bifrost_tpu_torch.blocks.beamform, "
             "bifrost_tpu_torch.ops.quantize, "
             "bifrost_tpu_torch.blocks.quantize, "
             "bifrost_tpu_torch.blocks.correlate, "
             "bifrost_tpu_torch.blocks.accumulate, "
             "bifrost_tpu_torch.units, bifrost_tpu_torch.io.sigproc, "
             "bifrost_tpu_torch.ops.common, bifrost_tpu_torch.ops.fdmt, "
             "bifrost_tpu_torch.ops.transpose, "
             "bifrost_tpu_torch.blocks.fdmt, "
             "bifrost_tpu_torch.blocks.sigproc, "
             "bifrost_tpu_torch.blocks.transpose, "
             "bifrost_tpu_torch.parallel, bifrost_tpu_torch.parallel.mesh, "
             "bifrost_tpu_torch.parallel.ops, "
             "bifrost_tpu_torch.parallel.corner_turn, "
             "bifrost_tpu_torch.parallel.scope, bifrost_tpu_torch.views, "
             "bifrost_tpu_torch.views.basic_views, "
             "bifrost_tpu_torch.block_chainer, bifrost_tpu_torch.io.guppi, "
             "bifrost_tpu_torch.blocks.guppi_raw, "
             "bifrost_tpu_torch.blocks.unpack, "
             "bifrost_tpu_torch.blocks.detect, "
             "bifrost_tpu_torch.blocks.reduce, "
             "bifrost_tpu_torch.blocks.fftshift, "
             "bifrost_tpu_torch.blocks.reverse, "
             "bifrost_tpu_torch.blocks.scrunch, "
             "bifrost_tpu_torch.blocks.print_header, "
             "bifrost_tpu_torch.ops.fft, bifrost_tpu_torch.ops.reduce, "
             "bifrost_tpu_torch.utils, bifrost_tpu_torch.ops.map, "
             "bifrost_tpu_torch.ops.map_lang, bifrost_tpu_torch.ops.fir, "
             "bifrost_tpu_torch.ops.romein, bifrost_tpu_torch.blocks.fir, "
             "bifrost_tpu_torch.blocks.convert_visibilities, "
             "bifrost_tpu_torch.blocks.binary_io, "
             "bifrost_tpu_torch.blocks.serialize, "
             "bifrost_tpu_torch.blocks.wav, bifrost_tpu_torch.xfer, "
             "bifrost_tpu_torch.telemetry, bifrost_tpu_torch.trace, "
             "bifrost_tpu_torch.testing.faults, "
             "bifrost_tpu_torch.supervision, bifrost_tpu_torch.affinity, "
             "bifrost_tpu_torch.temp_storage, "
             "bifrost_tpu_torch.header_standard, "
             "bifrost_tpu_torch.telemetry.slo, "
             "bifrost_tpu_torch.telemetry.exporter, "
             "bifrost_tpu_torch.telemetry.profiling, "
             "bifrost_tpu_torch.native, bifrost_tpu_torch.ring_native, "
             "bifrost_tpu_torch.memory, bifrost_tpu_torch.proclog, "
             "bifrost_tpu_torch.analysis.verify, "
             "bifrost_tpu_torch.analysis.ringcheck, "
             "bifrost_tpu_torch.io.udp_socket, "
             "bifrost_tpu_torch.io.packet_formats, "
             "bifrost_tpu_torch.io.packet_capture, "
             "bifrost_tpu_torch.io.packet_writer, "
             "bifrost_tpu_torch.io.dada_shm, bifrost_tpu_torch.io.portaudio, "
             "bifrost_tpu_torch.blocks.psrdada, "
             "bifrost_tpu_torch.blocks.audio, bifrost_tpu_torch.io.bridge, "
             "bifrost_tpu_torch.blocks.bridge, bifrost_tpu_torch.autotune, "
             "bifrost_tpu_torch.telemetry.fleet, "
             "bifrost_tpu_torch.monitor_utils, bifrost_tpu_torch.cli, "
             "bifrost_tpu_torch.tools, bifrost_tpu_torch.tools.like_top, "
             "bifrost_tpu_torch.tools.like_ps, "
             "bifrost_tpu_torch.tools.pipeline2dot\n"
             "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
             "%r)\nprint(bad)" % (FORBIDDEN,))
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == '[]'


@pytest.mark.parametrize('path', _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_import_in_source(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or '']
        else:
            continue
        for name in names:
            assert _top(name) not in FORBIDDEN, \
                '%s imports %s' % (os.path.relpath(path, ROOT), name)


def test_correlator_entry_points_import_without_a_device():
    """The FX correlator's entry points import, and the capability probe
    builds no kernel at import: no nvcc is started and no device is
    touched until a call asks for the card."""
    p = _run("import sys, bifrost_tpu_torch as bt\n"
             "assert callable(bt.ops.linalg.XEngine)\n"
             "assert callable(bt.ops.linalg.xcorr_int8)\n"
             "assert callable(bt.ops.gpu_kernels.available)\n"
             "for f in ('correlate', 'accumulate', 'fft', 'quantize'):\n"
             "    assert callable(getattr(bt.blocks, f))\n"
             "from bifrost_tpu_torch import _build\n"
             "print(sorted(_build._libs), 'probe' in _build.SOURCES, "
             "'xcorr' in _build.SOURCES)\n")
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == '[] True True'


def test_fdmt_entry_points_import_without_a_device():
    """The FDMT, SIGPROC and transpose entry points import, building no
    kernel and touching no device, and K3's source is in the build."""
    p = _run("import bifrost_tpu_torch as bt\n"
             "assert callable(bt.ops.fdmt.Fdmt)\n"
             "assert callable(bt.ops.gpu_kernels.fdmt_step)\n"
             "for f in ('read_sigproc', 'write_sigproc', 'transpose', "
             "'fdmt', 'fdmt_stage', 'matched_filter', 'threshold'):\n"
             "    assert callable(getattr(bt.blocks, f))\n"
             "from bifrost_tpu_torch import _build\n"
             "print(sorted(_build._libs), 'fdmt' in _build.SOURCES)\n")
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == '[] True'


def test_mesh_entry_points_import_without_a_device():
    """The mesh tier and the corner turn import, building no kernel and
    touching no device, and K9's source is in the build."""
    p = _run("import bifrost_tpu_torch as bt\n"
             "from bifrost_tpu_torch import parallel as par\n"
             "for f in ('create_mesh', 'local_mesh', 'corner_turn', "
             "'corner_turn_local', 'sharded_fdmt', 'shard_map', 'psum'):\n"
             "    assert callable(getattr(par, f))\n"
             "assert callable(bt.ops.gpu_kernels.ring_permute)\n"
             "assert 'mesh' in bt.BlockScope._TUNABLES\n"
             "from bifrost_tpu_torch import _build\n"
             "print(sorted(_build._libs), 'ring_permute' in _build.SOURCES)\n")
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == '[] True'


def test_runtime_entry_points_import_without_a_device():
    """The supervised runtime, the exporter, LinAlg and the new tunables
    import and build without a device: no kernel built, no CUDA context,
    and the telemetry snapshot reads no card memory."""
    p = _run("import torch, bifrost_tpu_torch as bt\n"
             "from bifrost_tpu_torch import supervision, affinity\n"
             "from bifrost_tpu_torch.telemetry import exporter, slo\n"
             "assert callable(bt.ops.LinAlg) and callable(bt.ops.matmul)\n"
             "assert supervision.POLICIES == ('abort', 'restart', "
             "'skip_sequence')\n"
             "for t in ('on_failure', 'max_restarts', 'restart_backoff', "
             "'overload_policy', 'shed_tolerant', 'core', "
             "'share_temp_storage'):\n"
             "    assert t in bt.BlockScope._TUNABLES, t\n"
             "snap = bt.telemetry.snapshot()\n"
             "from bifrost_tpu_torch import _build\n"
             "print(sorted(_build._libs), snap['devices'], "
             "torch.cuda.is_initialized())\n")
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == '[] {} False'


def test_io_entry_points_import_without_a_device():
    """The capture, transmit, DADA and audio tier imports and builds its
    objects without a device: no kernel built, no CUDA context, the
    exports the JAX package's io tier has."""
    p = _run("import torch, bifrost_tpu_torch as bt\n"
             "io = bt.io\n"
             "for n in ('UDPSocket', 'Address', 'UDPCapture', "
             "'NativeUDPCapture', 'ShardedUDPCapture', 'UDPSniffer', "
             "'DiskReader', 'UDPTransmit', 'NativeUDPTransmit', "
             "'DiskWriter', 'HeaderInfo', 'IpcRing', 'DadaHDU'):\n"
             "    assert hasattr(io, n), n\n"
             "print(sorted(io.FORMATS))\n"
             "for n in ('read_dada_file', 'read_psrdada_buffer', "
             "'read_audio', 'AudioSourceBlock'):\n"
             "    assert hasattr(bt.blocks, n), n\n"
             "io.PacketCaptureCallback().set_chips(lambda d: (0, {}))\n"
             "from bifrost_tpu_torch import _build\n"
             "print(sorted(_build._libs), torch.cuda.is_initialized())\n")
    assert p.returncode == 0, p.stderr
    assert p.stdout.split('\n')[0] == str(sorted(
        ['simple', 'chips', 'pbeam', 'tbn', 'drx', 'ibeam', 'cor', 'snap2',
         'vdif', 'tbf', 'drx8', 'vbeam']))
    assert p.stdout.strip().split('\n')[1] == '[] False'


def test_bridge_entry_points_import_without_a_device():
    """The ring bridge and its blocks import and build their objects
    without a device: no kernel built, no CUDA context, the exports of
    the JAX package's bridge tier, and a listener that binds and closes."""
    p = _run("import torch, bifrost_tpu_torch as bt\n"
             "for n in ('RingSender', 'RingReceiver', 'BridgeListener', "
             "'BridgeProtocolError', 'listen', 'connect', "
             "'connect_striped', 'query_resume', 'WIRE_VERSION'):\n"
             "    assert hasattr(bt.io, n), n\n"
             "for n in ('bridge_sink', 'bridge_source', 'BridgeSink', "
             "'BridgeSource', 'CircuitOpenError'):\n"
             "    assert hasattr(bt.blocks, n), n\n"
             "assert bt.blocks.bridge.bridge_sink is bt.blocks.bridge_sink\n"
             "lst = bt.io.BridgeListener('127.0.0.1', 0)\n"
             "lst.close()\n"
             "from bifrost_tpu_torch import _build\n"
             "print(bt.io.WIRE_VERSION, sorted(_build._libs), "
             "torch.cuda.is_initialized())\n")
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == '2 [] False'


def test_tuner_fleet_and_monitors_import_without_a_device():
    """The auto-tuner, the fleet plane, the monitors and the top-level
    surface import and build their objects without a device: no kernel
    built, no CUDA context, and a fleet collector that binds and
    closes."""
    p = _run("import torch, bifrost_tpu_torch as bt\n"
             "from bifrost_tpu_torch import autotune, cli, monitor_utils\n"
             "from bifrost_tpu_torch.telemetry import fleet\n"
             "from bifrost_tpu_torch.tools import like_top, like_ps, "
             "pipeline2dot\n"
             "for n in ('asarray', 'zeros', 'empty_like', 'zeros_like', "
             "'Space', 'EnvVars', 'autotune'):\n"
             "    assert hasattr(bt, n), n\n"
             "assert autotune.resolve_mode(None) == 'off'\n"
             "c = fleet.FleetCollector(rules=[])\n"
             "c._sock.close()\n"
             "assert fleet.acquire_publisher() is None\n"
             "from bifrost_tpu_torch import _build\n"
             "print(sorted(_build._libs), torch.cuda.is_initialized())\n")
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == '[] False'


def test_default_mesh_needs_the_card_or_a_cpu_request():
    """create_mesh() with no devices asks get_device(): without a card
    and without set_device('cpu') it raises, never builds a CPU mesh on
    its own."""
    p = _run("from bifrost_tpu_torch import parallel as par\n"
             "try:\n"
             "    par.create_mesh()\n"
             "except RuntimeError as e:\n"
             "    print('raised')\n"
             "from bifrost_tpu_torch import device\n"
             "device.set_device('cpu')\n"
             "print(par.create_mesh().size)\n")
    assert p.returncode == 0, p.stderr
    assert p.stdout.split() == ['raised', '8']


def test_get_device_raises_without_gpu_or_cpu_request():
    p = _run("import torch\n"
             "assert not torch.cuda.is_available()\n"
             "from bifrost_tpu_torch import device\n"
             "try:\n"
             "    device.get_device()\n"
             "except RuntimeError as e:\n"
             "    print('raised:', e)\n"
             "else:\n"
             "    print('returned')\n")
    assert p.returncode == 0, p.stderr
    assert p.stdout.startswith('raised:'), p.stdout
    assert "set_device('cpu')" in p.stdout
