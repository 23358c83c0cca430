"""The shipped cells on the card: one short run each through the
command, correct and complete.  They skip without a CUDA card; on the
chip machine run them with
``python -m pytest -m cuda benchmark/tests/test_portbench_card.py``."""

import json
import os
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT


@pytest.mark.cuda
@pytest.mark.parametrize('cell', ['guppi_nfft1024', 'fx256_int16',
                                  'guppi_nfft1m'])
def test_cell_runs_correct_on_the_card(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    p = subprocess.run([sys.executable, os.path.join(BENCH, 'run.py'),
                        '--workload', cell, '--seed', str(2 ** 31 + 99),
                        '--seconds', '3', '--trace', '0'], cwd=ROOT,
                       capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-4000:]
    line = json.loads(p.stdout.strip().split('\n')[-1])
    assert line['correct'] is True, line
    assert line['device']['platform'] == 'gpu'
