"""The trace reduction on a small Chrome trace written by hand, as the
profiler writes one on the card: busy time by kind, kernels attributed to
the stage whose thread launched them, idle gaps named by the CUDA call in
flight."""

import json
import threading

import pytest

from benchmark.portbench import trace


def _ev(cat, name, ts, dur, **args):
    e = {'ph': 'X', 'cat': cat, 'name': name, 'ts': ts, 'dur': dur,
         'pid': 1, 'tid': args.pop('tid', 7)}
    e['args'] = args
    return e


def test_reduce_a_hand_written_trace(tmp_path):
    ev = [
        _ev('user_annotation', trace.SUBWINDOW, 1000.0, 1000.0, tid=1),
        # two launches from the F thread (tid 11), one from X (tid -12)
        _ev('cuda_runtime', 'cudaLaunchKernel', 990.0, 5.0, tid=11,
            correlation=1),
        _ev('cuda_runtime', 'cudaLaunchKernel', 1100.0, 5.0, tid=11,
            correlation=2),
        _ev('cuda_driver', 'cuLaunchKernel', 1200.0, 5.0, tid=12,
            correlation=3),
        _ev('cuda_runtime', 'cudaEventSynchronize', 1500.0, 300.0,
            tid=12, correlation=4),
        _ev('kernel', 'fft', 950.0, 150.0, correlation=1),     # clipped
        _ev('kernel', 'quant', 1150.0, 100.0, correlation=2),
        _ev('kernel', 'xcorr', 1250.0, 200.0, correlation=3),
        _ev('gpu_memcpy', 'Memcpy HtoD (Pinned -> Device)', 1100.0,
            300.0, correlation=5),
        _ev('gpu_memcpy', 'Memcpy DtoH (Device -> Pinned)', 1850.0,
            400.0, correlation=6),
    ]
    path = tmp_path / 't.json'
    path.write_text(json.dumps({'traceEvents': ev}))
    r = trace.reduce_trace(str(path), {11: 'P/FftBlock_0', 12: 'P/X_0'},
                           {'P/FftBlock_0': 'fx_f', 'P/X_0': 'fx_x'})
    assert r['window_s'] == pytest.approx(1e-3)
    assert r['by_kind_s']['h2d'] == pytest.approx(300e-6)
    assert r['by_kind_s']['d2h'] == pytest.approx(150e-6)
    # kernels: [1000,1100] + [1150,1250] + [1250,1450]
    assert r['by_kind_s']['kernel'] == pytest.approx(400e-6)
    assert r['stage_kernel_s'] == pytest.approx({'fx_f': 200e-6,
                                                 'fx_x': 200e-6})
    assert r['unattributed_kernel_s'] == 0
    # busy: [1000,1450] and [1850,2000]; idle [1450,1850] is the gap
    assert r['busy_s'] == pytest.approx(600e-6)
    assert r['idle_gaps'][0] == ['X_0: cudaEventSynchronize',
                                 pytest.approx(400e-6)]
    assert [n for n, _ in r['device_ops']][:2] == \
        ['Memcpy HtoD (Pinned -> Device)', 'xcorr']


def test_thread_ids_of_the_trace():
    t = threading.current_thread()
    ids = trace._trace_ids(t)
    low = t.ident & 0xFFFFFFFF
    assert {t.native_id, t.ident, low} <= ids
    signed = low - (1 << 32) if low >= 1 << 31 else low
    assert abs(signed) in ids
