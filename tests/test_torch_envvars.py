"""The port's env-var lint (``bifrost_tpu_torch/tools/lint_envvars.py``):
the tree is clean, and on a copy of the package an undocumented read or
a documented name that nothing reads exits 3, while a read in a
``chip_*.py`` or ``examples/*_torch.py`` script beside the package
counts for a documented name.
"""

import os
import re
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join('bifrost_tpu_torch', 'tools', 'lint_envvars.py')


def _lint(top, *args):
    return subprocess.run([sys.executable, os.path.join(str(top), TOOL)]
                          + list(args), capture_output=True, text=True,
                          timeout=120)


def test_the_tree_is_clean():
    res = _lint(ROOT)
    assert res.returncode == 0, res.stdout + res.stderr
    assert '0 undocumented, 0 phantom' in res.stdout


def test_every_read_is_documented_once():
    """ENVVARS.md names each variable the package reads in one table
    row, and names no other."""
    from bifrost_tpu_torch.tools import lint_envvars
    with open(lint_envvars.DOC) as f:
        rows = re.findall(r'^\| `(BF_[A-Z0-9_]+)` \|', f.read(), re.M)
    assert sorted(rows) == sorted(set(rows))
    assert set(rows) == set(lint_envvars.package_reads())
    assert 'BF_TORCH_PROFILE' in rows and len(rows) >= 109


def _copy(tmp_path):
    shutil.copytree(os.path.join(ROOT, 'bifrost_tpu_torch'),
                    tmp_path / 'bifrost_tpu_torch',
                    ignore=shutil.ignore_patterns('_build', '__pycache__'))
    return tmp_path / 'bifrost_tpu_torch'


def _append(path, text):
    with open(path, 'a') as f:
        f.write(text)


@pytest.mark.parametrize('plant, rc, line', [
    ('none', 0, None),
    ('undocumented', 3, 'UNDOCUMENTED BF_FAKE_X'),
    ('phantom', 3, 'PHANTOM      BF_FAKE_Y'),
    ('chip_script', 0, None),
    ('example', 0, None),
    ('other_script', 3, 'PHANTOM      BF_FAKE_Z'),
])
def test_planted_violations(tmp_path, plant, rc, line):
    pkg = _copy(tmp_path)
    doc = pkg / 'ENVVARS.md'
    if plant == 'undocumented':
        _append(pkg / 'utils.py', "\n_PLANTED = 'BF_FAKE_X'\n")
    elif plant == 'phantom':
        _append(doc, '| `BF_FAKE_Y` | `1` | read by nothing |\n')
    elif plant in ('chip_script', 'example', 'other_script'):
        _append(doc, '| `BF_FAKE_Z` | `1` | read beside the package |\n')
        script = {'chip_script': tmp_path / 'chip_fake.py',
                  'example': tmp_path / 'examples' / 'fake_torch.py',
                  'other_script': tmp_path / 'examples' / 'fake.py'}[plant]
        script.parent.mkdir(exist_ok=True)
        script.write_text("import os\nos.environ.get('BF_FAKE_Z')\n")
    res = _lint(tmp_path)
    assert res.returncode == rc, res.stdout + res.stderr
    if line is not None:
        assert line in res.stdout, res.stdout
