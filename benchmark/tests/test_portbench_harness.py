"""The harness end to end on the CPU at tiny geometries: the result line
has the contract's keys, and without a card the command prints none."""

import json
import os
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT, TINY_END_TO_END

KEYS = {'correct', 'attempted', 'failed', 'metrics', 'device', 'check'}


@pytest.mark.parametrize('cell', ['tiny_guppi', 'tiny_fx'])
def test_last_line_has_the_contract_keys(run_tiny, cell):
    from benchmark import run
    result, info, _ = run_tiny(cell)
    out, err = _Lines(), _Lines()
    run.report(result, info, out=out, err=err)
    line = json.loads(out.lines[-1])
    assert set(line) == KEYS
    assert list(line)[-1] == 'check'
    assert line['correct'] is True and line['failed'] == 0
    assert line['attempted'] >= 2
    assert set(line['metrics']) == set(TINY_END_TO_END[cell])
    for m in line['metrics'].values():
        assert set(m) == {'value', 'unit'} and m['value'] > 0
    assert set(line['device']) == {'platform', 'kind', 'count',
                                   'memory_peak_bytes'}
    # the numbers compared are the last lines of standard error
    for k, c in line['check'].items():
        assert any(ln.startswith('check %s ' % k) for ln in err.lines[-2:])
        assert c['value'] <= c['limit']


@pytest.mark.parametrize('cell', ['tiny_guppi', 'tiny_fx'])
def test_traced_run_reports_the_per_layer_metrics(run_tiny, cell):
    result, _, _ = run_tiny(cell, trace=True)
    assert set(result) == KEYS | {'breakdown'}
    assert result['correct'] is True
    names = set(result['metrics'])
    # counters and the benchmark's clocks read on the CPU too
    assert {'source.blocked_share', 'h2d.gbps', 'd2h.gbps',
            'pipeline.sync_waits_per_gulp', 'sink.wait_share'} <= names
    assert 'throughput_msps' not in names
    assert {'busy_s', 'window_s'} <= set(result['device'])
    assert set(result['breakdown']) == {'device_ops', 'idle_gaps'}
    # no roofline share without device time: the readers stay silent
    assert not any('roofline' in n for n in names)


def test_no_card_no_result():
    if _has_cuda():
        pytest.skip('a CUDA card is present')
    p = subprocess.run([sys.executable, os.path.join(BENCH, 'run.py'),
                        '--workload', 'guppi_nfft1024', '--seed', '1',
                        '--seconds', '1', '--trace', '0'],
                       cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode != 0
    assert p.stdout.strip() == ''


def _has_cuda():
    import torch
    return torch.cuda.is_available()


class _Lines(object):
    def __init__(self):
        self.buf = ''

    def write(self, s):
        self.buf += s

    def flush(self):
        pass

    @property
    def lines(self):
        return self.buf.rstrip('\n').split('\n')
