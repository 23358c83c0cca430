"""Fixtures of the benchmark's CPU tests: a copy of the benchmark's
folder with tiny cells of both chains added as files, run through the
whole harness on the CPU device."""

import json
import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY_LIMITS = {'tiny_guppi': {'spec_err': 1e-4},
               'tiny_fx': {'vis_outside': 0}}
TINY_END_TO_END = {'tiny_guppi': ['throughput_msps', 'setup_s'],
                   'tiny_fx': ['throughput_msps', 'dump_interval_ms',
                               'setup_s']}


def _write(root, kind, name, obj):
    with open(os.path.join(root, kind, name + '.json'), 'w') as f:
        json.dump(obj, f)


def make_tiny(dst):
    """A copy of the benchmark under ``dst`` with two tiny cells: the
    spectrometer at nfft 64 and the FX correlator at 4 stands x 32
    channels, each written as new files only."""
    root = os.path.join(dst, 'benchmark')
    shutil.copytree(BENCH, root, ignore=shutil.ignore_patterns(
        '_cache', '__pycache__', 'tests'))
    with open(os.path.join(root, 'configs',
                           'guppi_spectrometer.json')) as f:
        g = json.load(f)
    g['block_bytes'] = 16384
    _write(root, 'configs', 'tiny_guppi', g)
    with open(os.path.join(root, 'configs',
                           'fx_correlator_256.json')) as f:
        fx = json.load(f)
    fx.update(nstand=4, nchan=32, ntime_per_gulp=16, nframe_per_vis=16,
              nvis_per_dump=2)
    _write(root, 'configs', 'tiny_fx', fx)
    _write(root, 'traffic', 'tiny_spec', {
        'nslot': 3, 'nfft': 64,
        'warmup_outputs': 4, 'check_samples': 3})
    _write(root, 'traffic', 'tiny_fx', {
        'nslot': 3, 'warmup_outputs': 2, 'check_samples': 2})
    for cell, cfg, traffic in (('tiny_guppi', 'tiny_guppi', 'tiny_spec'),
                               ('tiny_fx', 'tiny_fx', 'tiny_fx')):
        _write(root, 'workloads', cell, {
            'config': cfg, 'traffic': traffic, 'chips': 1,
            'end_to_end': TINY_END_TO_END[cell],
            'limits': TINY_LIMITS[cell], 'why': 'a CPU test cell'})
    return root


@pytest.fixture(scope='session')
def tiny_root(tmp_path_factory):
    return make_tiny(str(tmp_path_factory.mktemp('portbench')))


@pytest.fixture
def run_tiny(tiny_root):
    """run_tiny(cell, trace=False, controls=()) -> (result, info, ctl)
    through the harness on the CPU device."""
    from benchmark.portbench import harness

    def run(cell, trace=False, controls=(), seed=2 ** 31 + 12345,
            seconds=1.0):
        return harness.run_cell(cell, seed, seconds, trace,
                                root=tiny_root, device='cpu',
                                controls=controls)
    return run
