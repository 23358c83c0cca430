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
                                            'romein_grid_torch.py')]
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
             "bifrost_tpu_torch.blocks.wav\n"
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
