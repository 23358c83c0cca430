"""The port's telemetry (counters, histograms, spans), fault seams and
trace scopes, held against the JAX package's on the same calls: the
same counter operations give the same snapshots, the same observations
the same buckets and percentiles, the same recorded spans the same
Chrome-trace names, categories and argument keys, the same armed faults
the same firing pattern (``count``, ``after``, ``match``, ``delay`` and
``BF_FAULTS`` parsing), and the pipelines' per-gulp telemetry the same
counts.  Exact equality throughout, apart from the span timestamps."""

import contextlib
import json
import time
from copy import deepcopy

import numpy as np
import pytest

import bifrost_tpu as bf
from bifrost_tpu import trace as jtrace
from bifrost_tpu.telemetry import counters as jcounters
from bifrost_tpu.telemetry import histograms as jhistograms
from bifrost_tpu.telemetry import spans as jspans
from bifrost_tpu.testing import faults as jfaults
from tests.util import NumpySourceBlock, GatherSink, simple_header

import bifrost_tpu_torch as bt
from bifrost_tpu_torch import device, telemetry, trace, xfer
from bifrost_tpu_torch.telemetry import counters, histograms, spans
from bifrost_tpu_torch.testing import faults
from tests.test_torch_bounded import run_bounded

BOTH = [('port', counters, histograms, spans, faults),
        ('jax', jcounters, jhistograms, jspans, jfaults)]


@pytest.fixture(autouse=True)
def _reset(monkeypatch):
    device.set_device('cpu')
    monkeypatch.delenv('BF_TRACE_FILE', raising=False)
    monkeypatch.delenv('BF_FAULTS', raising=False)
    for _, c, h, s, f in BOTH:
        c.reset()
        h.reset()
        s.reset()
        f.clear()
        s.reconfigure()
    yield
    for _, c, h, s, f in BOTH:
        f.clear()
        s.reset()
        s.reconfigure()
    xfer.reset_engine()


def test_counters_agree():
    out = {}
    for name, c, _, _, _ in BOTH:
        c.inc('a')
        c.inc('a', 4)
        c.inc('b.c', 7)
        first = (c.get('a'), c.get('b.c'), c.get('never'), c.snapshot())
        c.reset()
        out[name] = first + (c.snapshot(), c.get('a'))
    assert out['port'] == out['jax']
    assert out['port'][0] == 5 and out['port'][2] == 0


def test_histograms_agree():
    rng = np.random.RandomState(1)
    values = np.concatenate([rng.lognormal(-8, 3, 500), [0.0, -1.0, 1e30,
                                                          2.0 ** -30]])
    snaps = {}
    for name, _, h, _, _ in BOTH:
        for v in values:
            h.observe('x.s', float(v))
        hist = h.get_or_create('x.s')
        assert hist is h.get('x.s')
        snaps[name] = (h.snapshot(), [hist.percentile(p)
                                      for p in (0, 10, 50, 99, 100)],
                       [h.bucket_upper(i) for i in (0, 10, 63)])
        assert h.get('missing') is None
    assert snaps['port'] == snaps['jax']


def _trace_events(path):
    with open(path) as f:
        doc = json.load(f)
    return [(e['name'], e['cat'], sorted((e.get('args') or {}).keys()))
            for e in doc['traceEvents'] if e['ph'] == 'X']


def test_spans_export_the_same_events(tmp_path, monkeypatch):
    events = {}
    for name, _, _, s, _ in BOTH:
        path = str(tmp_path / ('%s.json' % name))
        monkeypatch.setenv('BF_TRACE_FILE', path)
        s.reconfigure()
        assert s.enabled() and s.trace_file() == path
        s.record_elapsed('h2d', 'xfer', 0.002, bytes=64)
        with s.span('blk.on_data', 'compute', seq=0, gulp=3):
            time.sleep(0.001)
        t = s.now_us()
        s.record('custom', 'ring', t, 5.0, {'k': 1})
        s.record('noargs', '', t, 1.0)
        assert s.export_if_configured() == path
        events[name] = _trace_events(path)
        assert len(s.events()) == 4
        assert 'blk.on_data' in s.flight_record()
    assert events['port'] == events['jax']
    assert ('blk.on_data', 'compute', ['gulp', 'seq']) in events['port']


def test_spans_are_off_without_a_trace_file():
    for _, _, _, s, _ in BOTH:
        assert not s.enabled()
        s.record_elapsed('h2d', 'xfer', 0.001)
        with s.span('x', 'compute'):
            pass
        assert s.events() == [] and s.export_if_configured() is None


def test_flight_recorder_records_without_a_trace_file():
    """The flight recorder turns recording on without a trace file,
    keeps the recent tail per thread, and stops with its last hold."""
    got = {}
    for name, _, _, s, _ in BOTH:
        s.enable_flight_recorder()
        s.enable_flight_recorder()
        for i in range(300):
            s.record_elapsed('e%d' % i, 'x', 1e-6)
        s.disable_flight_recorder()
        on = s.enabled()
        s.disable_flight_recorder()
        rec = s.flight_record(per_thread=4)
        got[name] = (on, s.enabled(), len(s.events()), s.dropped_spans(),
                     [ln.split(']')[-1].split()[-1]
                      for ln in rec.splitlines()[2:-1]],
                     s.export_if_configured())
    assert got['port'] == got['jax']
    assert got['port'][:4] == (True, False, s.FLIGHT_BUFFER,
                               300 - s.FLIGHT_BUFFER)
    assert got['port'][4] == ['e296', 'e297', 'e298', 'e299']


def test_span_buffer_overflow_counts_dropped_spans(tmp_path, monkeypatch):
    monkeypatch.setenv('BF_SPAN_BUFFER', '16')
    got = {}
    for name, _, _, s, _ in BOTH:
        monkeypatch.setenv('BF_TRACE_FILE', str(tmp_path / name))
        s.reconfigure()
        for i in range(40):
            s.record_elapsed('e%d' % i, 'x', 1e-6)
        got[name] = (s.dropped_spans(), len(s.events()))
    assert got['port'] == got['jax'] == (24, 16)
    assert telemetry.snapshot()['counters']['trace.dropped_spans'] == 24


def _fire_pattern(f, site, names):
    out = []
    for n in names:
        try:
            f.fire(site, n)
            out.append('.')
        except f.FaultInjected:
            out.append('X')
    return ''.join(out)


def test_fault_semantics_agree():
    names = ['fft', 'copy', 'fft', 'fft', 'fft', 'other', 'fft']
    got = {}
    for name, _, _, _, f in BOTH:
        assert not f.active()
        pats = []
        with f.injected('ring.acquire', match='fft', count=2, after=1) as flt:
            assert f.active()
            pats.append(_fire_pattern(f, 'ring.acquire', names))
            pats.append(flt.fired)
            pats.append(_fire_pattern(f, 'ring.reserve', names))
        assert not f.active()
        with f.injected('xfer.d2h', exc=None, delay=0.01):
            t0 = time.perf_counter()
            f.fire('xfer.d2h')
            pats.append(time.perf_counter() - t0 >= 0.01)
        with f.injected('xfer.h2d', exc=KeyError):
            with pytest.raises(KeyError):
                f.fire('xfer.h2d')
        flt = f.inject('ring.corrupt.x', count=1)
        pats.append((f.armed('ring.corrupt.x'), f.armed('ring.corrupt.x'),
                     f.fired('ring.corrupt.x'), flt.fired))
        f.clear()
        got[name] = pats
    assert got['port'] == got['jax']
    assert got['port'][0] == '..XX...'


def test_bf_faults_parsing_agrees():
    spec = 'xfer.result:ring_3:2:1:0; ring.reserve::1'
    got = {}
    for name, _, _, _, f in BOTH:
        f.arm_from_env(spec)
        f.arm_from_env('xfer.h2d')          # armed once per process
        got[name] = (_fire_pattern(f, 'xfer.result',
                                   ['ring_3', 'ring_3', 'x', 'ring_3',
                                    'ring_3']),
                     _fire_pattern(f, 'ring.reserve', ['a', 'b']),
                     _fire_pattern(f, 'xfer.h2d', ['a']))
        f.clear()
        with pytest.raises(ValueError):
            f.arm_from_env('xfer.d2h:x:notanint')
        f.clear()
    assert got['port'] == got['jax'] == ('.X.X.', 'X.', '.')


def test_trace_scopes_are_inert_on_the_cpu(monkeypatch):
    """Under BF_TRACE=1 a scope on the CPU device times and opens no NVTX
    range; JAX's annotates the CPU profiler, both time."""
    import torch
    monkeypatch.setenv('BF_TRACE', '1')

    def boom(*a):
        raise AssertionError('NVTX range opened on the CPU')

    monkeypatch.setattr(torch.cuda.nvtx, 'range_push', boom)
    monkeypatch.setattr(torch.cuda.nvtx, 'range_pop', boom)
    for mod in (trace, jtrace):
        mod.reset()
        assert mod.tracing_enabled()
        with mod.trace_scope('blk/on_data') as t:
            time.sleep(0.001)
        assert t.name == 'blk/on_data' and t.elapsed >= 0.001
    monkeypatch.setenv('BF_TRACE', '0')
    for mod in (trace, jtrace):
        mod.reset()
        assert not mod.tracing_enabled()


def test_trace_scope_opens_an_nvtx_range_on_the_card(monkeypatch):
    """Where the port runs on the card, a BF_TRACE=1 scope pushes and
    pops one NVTX range named after it (checked with the device reported
    as cuda; the calls are recorded, not made)."""
    import torch
    from bifrost_tpu_torch import device as dev_mod
    monkeypatch.setenv('BF_TRACE', '1')
    calls = []
    monkeypatch.setattr(torch.cuda.nvtx, 'range_push',
                        lambda n: calls.append(('push', n)))
    monkeypatch.setattr(torch.cuda.nvtx, 'range_pop',
                        lambda: calls.append(('pop',)))
    monkeypatch.setattr(dev_mod, 'on_cuda', lambda: True)
    trace.reset()
    with trace.ScopedTracer('fft/on_data'):
        pass
    trace.reset()
    assert calls == [('push', 'fft/on_data'), ('pop',)]


def test_profile_writes_a_chrome_trace(tmp_path):
    import torch
    logdir = trace.start_profile(str(tmp_path / 'prof'))
    torch.ones(8).sum()
    path = trace.stop_profile()
    assert path.startswith(logdir)
    with open(path) as f:
        assert 'traceEvents' in json.load(f)


# ---------------------------------------------------------------------------
# the pipelines' per-gulp telemetry
# ---------------------------------------------------------------------------

class _Source(bt.SourceBlock):
    def __init__(self, gulps, header):
        super(_Source, self).__init__(['numpy'], 8, space='system')
        self._gulps = gulps
        self._header = header

    def create_reader(self, sourcename):
        return contextlib.nullcontext(iter(self._gulps))

    def on_sequence(self, reader, sourcename):
        return [deepcopy(self._header)]

    def on_data(self, reader, ospans):
        arr = next(reader, None)
        if arr is None:
            return [0]
        ospans[0].data.as_numpy()[...] = arr
        return [arr.shape[0]]


class _Gather(bt.SinkBlock):
    def __init__(self, iring):
        super(_Gather, self).__init__(iring)
        self.gulps = []

    def on_sequence(self, iseq):
        pass

    def on_data(self, ispan):
        self.gulps.append(np.array(ispan.data.as_numpy(), copy=True))


def _block_totals(snap):
    out = {}
    for k, v in snap.items():
        if k.startswith('block.'):
            kind = k.rsplit('.', 1)[1]
            out[kind] = out.get(kind, 0) + v
    return out


def test_pipeline_telemetry_counts_agree(tmp_path, monkeypatch):
    """source -> copy('cuda') -> copy('system') -> sink through both
    pipelines: the same pipeline.* totals, the same dispatches and gulps
    summed over blocks, a gulp_s histogram per block, one compute span
    per block per gulp in the trace file, and equal outputs."""
    rng = np.random.RandomState(2)
    gulps = [rng.randn(8, 16).astype(np.float32) for _ in range(5)]
    hdr = simple_header([-1, 16], 'f32')
    monkeypatch.setenv('BF_TRACE_FILE', str(tmp_path / 'port.json'))
    with bt.Pipeline() as p:
        b = bt.blocks.copy(_Source(gulps, hdr), space='cuda')
        sink = _Gather(bt.blocks.copy(b, space='system'))
        run_bounded(p)
    snap = telemetry.snapshot(p)
    monkeypatch.setenv('BF_TRACE_FILE', str(tmp_path / 'jax.json'))
    with bf.Pipeline() as jp:
        jb = bf.blocks.copy(NumpySourceBlock(gulps, hdr, gulp_nframe=8),
                            space='tpu')
        jsink = GatherSink(bf.blocks.copy(jb, space='system'))
        run_bounded(jp)
    jsnap = jcounters.snapshot()
    assert np.array_equal(np.concatenate(sink.gulps), jsink.result())
    for k in ('pipeline.gulps', 'pipeline.gulps_device', 'xfer.d2h_async',
              'xfer.h2d_issued', 'xfer.d2h_issued'):
        assert snap['counters'].get(k, 0) == jsnap.get(k, 0), k
    assert _block_totals(snap['counters']) == _block_totals(jsnap)
    for blk in p.blocks:
        h = snap['histograms']['block.%s.gulp_s' % blk.name]
        assert h['count'] == blk.perf_totals['ngulp']
    assert set(snap['rings']) == {r.name for blk in p.blocks
                                  for r in blk.orings}
    port_ev = _trace_events(str(tmp_path / 'port.json'))
    jax_ev = _trace_events(str(tmp_path / 'jax.json'))
    # the JAX spans also carry the stream's trace-context id
    assert all(e[2] == ['gulp', 'seq'] for e in port_ev
               if e[1] == 'compute')
    assert all({'gulp', 'seq'} <= set(e[2]) for e in jax_ev
               if e[1] == 'compute')
    # one a gulp a block, and the source's last call that ends the
    # sequence, in both packages
    ncompute = len([e for e in port_ev if e[1] == 'compute'])
    assert ncompute == sum(blk.perf_totals['ngulp']
                           for blk in p.blocks) + 1
    assert ncompute == len([e for e in jax_ev if e[1] == 'compute'])
    assert {e[0] for e in port_ev if e[1] == 'xfer'} == {'h2d', 'd2h'}
    assert {e[0] for e in port_ev if e[1] == 'xfer'} == \
        {e[0] for e in jax_ev if e[1] == 'xfer'}
