"""What a later change adds as files is found by name, with no edit to a
file that is there: a cell (workload, configuration, traffic) and a
per-layer metric dropped into a copy of the benchmark."""

import json
import os

from conftest import BENCH


def test_the_shipped_cells_and_metrics_are_found():
    from benchmark.portbench import registry
    for cell in ('guppi_nfft1024', 'fx256_int16', 'guppi_nfft1m'):
        spec = registry.cell(cell)
        g = spec['chain'].geometry(spec['config'], spec['traffic'])
        assert g['gulp_nframe'] > 0
    names = set(registry.metrics())
    assert {'throughput_msps', 'latency_p95_ms', 'setup_s',
            'spectro_roofline', 'device.idle_share'} <= names


def test_added_cell_and_metric_are_picked_up(tiny_root, tmp_path,
                                             run_tiny):
    from benchmark.portbench import registry
    before = {p: os.path.getmtime(os.path.join(dp, p))
              for dp, _, fs in os.walk(tiny_root) for p in fs}
    # a new traffic mix and cell of an existing configuration
    with open(os.path.join(tiny_root, 'traffic', 'tiny_spec2.json'),
              'w') as f:
        json.dump({'nslot': 2, 'nfft': 32,
                   'warmup_outputs': 3, 'check_samples': 2}, f)
    with open(os.path.join(tiny_root, 'workloads', 'tiny_added.json'),
              'w') as f:
        json.dump({'config': 'tiny_guppi', 'traffic': 'tiny_spec2',
                   'chips': 1, 'end_to_end': ['throughput_msps',
                                              'setup_s'],
                   'limits': {'spec_err': 1e-4}, 'why': 'added'}, f)
    # a new per-layer metric reading a counter of the port
    with open(os.path.join(tiny_root, 'metrics',
                           'test.added_gulps.py'), 'w') as f:
        f.write("NAME = 'test.added_gulps'\nKIND = 'per_layer'\n"
                "UNIT = 'gulps'\nBETTER = 'higher'\n"
                "SOURCE = 'program_counter'\nLAYER = 'test'\n"
                "MOVES = 'throughput_msps'\n\n\ndef read(ctx):\n"
                "    return ctx.counter_delta('pipeline.gulps')\n")
    try:
        assert 'test.added_gulps' in registry.metrics(tiny_root)
        result, _, _ = run_tiny('tiny_added', trace=True)
        assert result['correct'] is True
        assert result['metrics']['test.added_gulps']['value'] > 0
        after = {p: os.path.getmtime(os.path.join(dp, p))
                 for dp, _, fs in os.walk(tiny_root) for p in fs
                 if p in before}
        assert after == before        # nothing that was there changed
    finally:
        os.remove(os.path.join(tiny_root, 'metrics',
                               'test.added_gulps.py'))


def test_benchmark_json_matches_the_files():
    from benchmark.portbench import registry
    with open(os.path.join(os.path.dirname(BENCH),
                           'BENCHMARK.json')) as f:
        b = json.load(f)
    assert b['command'] == ['python3', 'benchmark/run.py']
    assert b['paths'] == ['benchmark']
    mods = registry.metrics()
    e2e = {m['name'] for m in b['end_to_end']}
    for m in b['end_to_end'] + b['per_layer']:
        mod = mods[m['name']]
        assert (mod.UNIT, mod.BETTER, mod.SOURCE) == \
            (m['unit'], m['better'], m['source'])
        assert mod.KIND == ('end_to_end' if m['name'] in e2e
                            else 'per_layer')
    for m in b['per_layer']:
        mod = mods[m['name']]
        assert (mod.LAYER, mod.MOVES) == (m['layer'], m['moves'])
    for c in b['configs']:
        with open(os.path.join(os.path.dirname(BENCH), c['file'])) as f:
            cfg = json.load(f)
        assert (cfg['name'], cfg['source'], cfg['reduced']) == \
            (c['name'], c['source'], c['reduced'])
    for w in b['workloads']:
        wl = registry.cell(w['name'])['workload']
        for k in ('config', 'traffic', 'chips', 'why'):
            assert wl[k] == w[k]
        listed = {m['name'] for m in b['end_to_end']
                  if w['name'] in m.get('workloads', [w['name']])}
        assert set(wl['end_to_end']) == listed
        assert set(wl['limits']) == set(
            registry.cell(w['name'])['chain'].CHECK)
