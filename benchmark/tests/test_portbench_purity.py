"""No module the harness loads has the top-level name jax, jaxlib, flax
or bifrost_tpu (compared whole: bifrost_tpu_torch is another name), and
the references import nothing of the program."""

import ast
import os
import subprocess
import sys

from conftest import BENCH, ROOT, make_tiny

FORBIDDEN = {'jax', 'jaxlib', 'flax', 'bifrost_tpu'}


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split('.')[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split('.')[0]


def test_sources_import_no_forbidden_name():
    for dp, _, fs in os.walk(BENCH):
        for fn in fs:
            if fn.endswith('.py'):
                tops = set(_imports(os.path.join(dp, fn)))
                assert not tops & FORBIDDEN, (fn, tops & FORBIDDEN)


def test_references_import_nothing_of_the_program():
    rdir = os.path.join(BENCH, 'reference')
    for fn in os.listdir(rdir):
        if fn.endswith('.py'):
            tops = set(_imports(os.path.join(rdir, fn)))
            assert tops <= {'torch', 'numpy', 'math'}, (fn, tops)


def test_a_run_loads_no_forbidden_module(tmp_path):
    root = make_tiny(str(tmp_path))
    code = (
        'import sys; sys.path.insert(0, %r)\n'
        'from benchmark.portbench import harness\n'
        'res, _, _ = harness.run_cell("tiny_guppi", 7, 0.5, False, '
        'root=%r, device="cpu")\n'
        'assert res["correct"], res\n'
        'tops = {m.split(".")[0] for m in sys.modules}\n'
        'print(sorted(tops & %r))\n'
        'assert "bifrost_tpu_torch" in tops\n'
        'assert harness.forbidden_loaded() == []\n' % (
            ROOT, root, FORBIDDEN))
    p = subprocess.run([sys.executable, '-c', code], capture_output=True,
                       text=True, timeout=300, cwd=str(tmp_path))
    assert p.returncode == 0, p.stderr[-3000:]
    assert p.stdout.strip().endswith('[]')


def test_forbidden_names_compare_whole(monkeypatch):
    from benchmark.portbench import harness
    monkeypatch.setitem(sys.modules, 'bifrost_tpu_torchlike', sys)
    monkeypatch.setitem(sys.modules, 'jaxtyping', sys)
    assert 'bifrost_tpu' not in harness.forbidden_loaded()
    assert 'jax' not in harness.forbidden_loaded()
    monkeypatch.setitem(sys.modules, 'jax.numpy', sys)
    assert harness.forbidden_loaded() == ['jax']


def test_a_module_loaded_after_the_window_refuses_the_result(tiny_root,
                                                              run_tiny):
    """A metric reader (read after the window, the reference and the
    controls) that loads a forbidden module leaves no result."""
    import pytest
    path = os.path.join(tiny_root, 'metrics', 'test.lazy_flax.py')
    had = 'flax' in sys.modules
    with open(path, 'w') as f:
        f.write("import sys\nimport types\nNAME = 'test.lazy_flax'\n"
                "KIND = 'per_layer'\nUNIT = 's'\nBETTER = 'lower'\n"
                "SOURCE = 'host_clock'\nLAYER = 'test'\n"
                "MOVES = 'throughput_msps'\n\n\ndef read(ctx):\n"
                "    sys.modules.setdefault('flax', "
                "types.ModuleType('flax'))\n    return None\n")
    try:
        with pytest.raises(RuntimeError, match='flax'):
            run_tiny('tiny_guppi', trace=True)
    finally:
        os.remove(path)
        if not had:
            sys.modules.pop('flax', None)
