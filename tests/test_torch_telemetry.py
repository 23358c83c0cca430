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
    # BF_SLO_MS is cached: the next test's observations re-read it
    from bifrost_tpu.telemetry import slo as jslo_
    from bifrost_tpu_torch.telemetry import slo as slo_
    slo_.reset_budget()
    jslo_.reset_budget()


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


def _compute_trace_ids(path):
    with open(path) as f:
        doc = json.load(f)
    return {e['args']['trace'] for e in doc['traceEvents']
            if e['ph'] == 'X' and e['cat'] == 'compute'}


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
    # both packages' compute spans carry (seq, gulp) and the stream's
    # trace-context id
    assert all(e[2] == ['gulp', 'seq', 'trace'] for e in port_ev
               if e[1] == 'compute')
    assert all(e[2] == ['gulp', 'seq', 'trace'] for e in jax_ev
               if e[1] == 'compute')
    assert _compute_trace_ids(str(tmp_path / 'port.json')) == \
        {p.blocks[0]._trace_ctx['id']}
    # one a gulp a block, and the source's last call that ends the
    # sequence, in both packages
    ncompute = len([e for e in port_ev if e[1] == 'compute'])
    assert ncompute == sum(blk.perf_totals['ngulp']
                           for blk in p.blocks) + 1
    assert ncompute == len([e for e in jax_ev if e[1] == 'compute'])
    assert {e[0] for e in port_ev if e[1] == 'xfer'} == {'h2d', 'd2h'}
    assert {e[0] for e in port_ev if e[1] == 'xfer'} == \
        {e[0] for e in jax_ev if e[1] == 'xfer'}


# ---------------------------------------------------------------------------
# exporter, SLO ages and trace context (the JAX package's
# telemetry/exporter.py, telemetry/slo.py, header_standard.py:84-145)
# ---------------------------------------------------------------------------

from bifrost_tpu import header_standard as jhs  # noqa: E402
from bifrost_tpu.telemetry import exporter as jexporter  # noqa: E402
from bifrost_tpu.telemetry import slo as jslo  # noqa: E402
from bifrost_tpu_torch import header_standard as ths  # noqa: E402
from bifrost_tpu_torch.telemetry import exporter, slo  # noqa: E402

SLO = [('port', counters, histograms, slo, ths),
       ('jax', jcounters, jhistograms, jslo, jhs)]


def test_prometheus_text_equals_jax():
    """The same counters and histograms render to the same Prometheus
    text in both packages (the device section aside: it reads each
    package's own runtime)."""
    rng = np.random.RandomState(4)
    values = rng.lognormal(-6, 2, 200)
    texts = {}
    for name, c, h, _s, _f in BOTH:
        c.inc('pipeline.gulps', 17)
        c.inc('ring.r0.shed_gulps', 3)
        c.inc('odd "name"\\x', 2)
        for v in values:
            h.observe('slo.exit_age_s', float(v))
        h.observe('ring.r0.reserve_s', 0.25)
        snap = {'counters': c.snapshot(), 'histograms': h.snapshot(),
                'rings': {'r0': {'tail': 0, 'head': 96, 'size': 384,
                                 'fill': 0.25}}}
        mod = exporter if name == 'port' else jexporter
        texts[name] = mod.prometheus_text(snap)
    assert texts['port'] == texts['jax']
    assert 'bifrost_tpu_counter_total{name="pipeline.gulps"} 17' in \
        texts['port']
    assert 'bifrost_tpu_hist_count{name="slo.exit_age_s"} 200' in \
        texts['port']


def test_prometheus_device_section_reads_torch_keys():
    """The device gauges take the JAX keys and the port's allocator
    keys (reserved, free)."""
    text = exporter.prometheus_text({'devices': {0: {
        'platform': 'cuda', 'bytes_in_use': 10, 'bytes_reserved': 20,
        'peak_bytes_in_use': 15, 'bytes_free': 70, 'bytes_limit': 100,
        'watermark_bytes': 12}}})
    for kind, v in (('in_use', 10), ('reserved', 20), ('peak', 15),
                    ('free', 70), ('limit', 100), ('watermark', 12)):
        assert 'bifrost_tpu_device_bytes{device="0",kind="%s"} %d' \
            % (kind, v) in text
    # no card was initialised here: the snapshot reads none
    assert exporter.snapshot()['devices'] == {}


def test_rate_tracker_agrees(monkeypatch):
    """RateTracker: no rates on the first observation, then per-second
    deltas (counter resets clamp to 0), the same in both packages."""
    clock = [100.0]
    monkeypatch.setattr(time, 'monotonic', lambda: clock[0])
    out = {}
    for name, mod in (('port', exporter), ('jax', jexporter)):
        clock[0] = 100.0
        rt = mod.RateTracker()
        first = rt.observe({'a': 5}, {'h': {'count': 2, 'sum': 1.0}})
        clock[0] = 102.0
        second = rt.observe({'a': 11, 'b': 4},
                            {'h': {'count': 6, 'sum': 3.0}})
        clock[0] = 103.0
        third = rt.observe({'a': 1})
        out[name] = (first, second, third)
    assert out['port'] == out['jax']
    assert out['port'][0]['dt'] is None
    assert out['port'][1]['counters'] == {'a': 3.0, 'b': 2.0}
    assert out['port'][2]['counters'] == {'a': 0.0}


def test_capture_age_and_budget_agree(monkeypatch):
    """capture_age_s (origin, tsamp extrapolation, skew) and the
    BF_SLO_MS violation counting agree with the JAX module."""
    hdr = {'_trace': {'id': 'abc', 'origin_ns': 10 ** 18}, 'tsamp': 0.5}
    skewed = {'_trace': {'id': 'abc', 'origin_ns': 10 ** 18,
                         'skew_ns': 2 * 10 ** 9}}
    now = 1e9 + 30.0
    monkeypatch.setenv('BF_SLO_MS', '1500')
    got = {}
    for name, c, h, s, _hs in SLO:
        s.reset_budget()
        ages = (s.capture_age_s(hdr, None, now),
                s.capture_age_s(hdr, 10, now),
                s.capture_age_s(skewed, None, now),
                s.capture_age_s({'tsamp': 1.0}, 3, now),
                s.capture_age_s(hdr, 100, now))
        s.observe_commit('blk', 1.0)
        s.observe_commit('blk', 2.0)
        s.observe_exit('snk', 3.0)
        s.observe_shed(9.0)
        got[name] = (ages, s.budget_s(), c.get('slo.violations'),
                     c.get('slo.blk.violations'),
                     c.get('slo.snk.violations'),
                     h.get('slo.exit_age_s').snapshot()['count'],
                     h.get('slo.shed_age_s').snapshot()['count'])
        s.reset_budget()
    assert got['port'] == got['jax']
    ages = got['port'][0]
    assert ages[3] is None and ages[4] == 0.0
    assert ages[:3] == pytest.approx((30.0, 25.0, 28.0), abs=1e-6)
    assert got['port'][2:] == (2, 1, 1, 1, 1)


def test_trace_context_functions_agree(monkeypatch):
    """ensure / propagate / trace_context and BF_TRACE_CONTEXT=0 behave
    as the JAX module's."""
    for name, _c, _h, _s, hs in SLO:
        hdr = {}
        ctx = hs.ensure_trace_context(hdr)
        assert hdr[hs.TRACE_CONTEXT_KEY] is ctx
        assert set(ctx) == {'id', 'origin_ns', 'host'}
        assert len(ctx['id']) == 16
        assert hs.ensure_trace_context(hdr) is ctx
        outs = [{}, {'_trace': {'id': 'mine'}}, 'not-a-dict']
        assert hs.propagate_trace_context(hdr, outs) is ctx
        assert outs[0]['_trace'] == ctx and outs[0]['_trace'] is not ctx
        assert outs[1]['_trace'] == {'id': 'mine'}
        assert hs.trace_context({'_trace': {'id': ''}}) is None
        assert hs.propagate_trace_context({}, [{}]) is None
        monkeypatch.setenv('BF_TRACE_CONTEXT', '0')
        assert hs.ensure_trace_context({}) is None
        monkeypatch.delenv('BF_TRACE_CONTEXT')
    assert ths.TRACE_CONTEXT_KEY == jhs.TRACE_CONTEXT_KEY


def _traced_run(mod, src_cls, sink_cls, gulps, hdr):
    with mod.Pipeline() as p:
        src = src_cls(gulps, hdr)
        sink = sink_cls(mod.blocks.copy(src, space='system'))
        run_bounded(p)
    return p, src, sink


class _HdrGather(_Gather):
    """``_Gather`` that keeps each sequence header."""

    def __init__(self, iring):
        super(_HdrGather, self).__init__(iring)
        self.headers = []

    def on_sequence(self, iseq):
        self.headers.append(iseq.header)


def test_pipeline_stamps_propagates_and_ages(monkeypatch):
    """Both pipelines stamp one trace context at the source, carry it to
    every downstream header, record one commit age per committed gulp of
    each ring owner and one exit age per sink gulp, and count the same
    violations under a budget every age exceeds."""
    monkeypatch.setenv('BF_SLO_MS', '0.000001')
    rng = np.random.RandomState(3)
    gulps = [rng.randn(8, 4).astype(np.float32) for _ in range(3)]
    hdr = simple_header([-1, 4], 'f32')
    got = {}
    for name, mod, src_cls, sink_cls in (
            ('port', bt, lambda g, h: _Source(g, h), _HdrGather),
            ('jax', bf, lambda g, h: NumpySourceBlock(g, h, gulp_nframe=8),
             GatherSink)):
        c, h = (counters, histograms) if name == 'port' else \
            (jcounters, jhistograms)
        p, src, sink = _traced_run(mod, src_cls, sink_cls, gulps, hdr)
        ctx = sink.headers[0]['_trace']
        copy_blk = p.blocks[1]

        def count(n):
            hist = h.get(n)
            return hist.snapshot()['count'] if hist else 0
        got[name] = {
            'ids': len({ctx['id'], src._trace_ctx['id'],
                        copy_blk._trace_ctx['id']}),
            'src_commits': count('slo.%s.commit_age_s' % src.name),
            'copy_commits': count('slo.%s.commit_age_s' % copy_blk.name),
            'exits': count('slo.exit_age_s'),
            'sink_exits': count('slo.%s.exit_age_s' % sink.name),
            'violations': c.get('slo.violations'),
            'ring_gulps': c.get('ring.%s.gulps' % src.orings[0].name)}
    assert got['port'] == got['jax']
    assert got['port'] == {'ids': 1, 'src_commits': 3, 'copy_commits': 3,
                           'exits': 3, 'sink_exits': 3, 'violations': 9,
                           'ring_gulps': 3}


def test_trace_context_off_stamps_nothing(monkeypatch):
    monkeypatch.setenv('BF_TRACE_CONTEXT', '0')
    gulps = [np.zeros((8, 4), np.float32)]
    p, src, sink = _traced_run(bt, lambda g, h: _Source(g, h), _HdrGather,
                               gulps, simple_header([-1, 4], 'f32'))
    assert '_trace' not in sink.headers[0]
    assert histograms.get('slo.exit_age_s') is None


def test_metrics_file_written_at_the_end_of_a_run(tmp_path, monkeypatch):
    """BF_METRICS_FILE gets a Prometheus textfile from the publisher's
    last snapshot: the pipeline's counters, its rings and the SLO
    histograms; the rings_flow proclogs name each ring."""
    path = str(tmp_path / 'metrics.prom')
    monkeypatch.setenv('BF_METRICS_FILE', path)
    monkeypatch.setenv('BF_PROCLOG_DIR', str(tmp_path / 'proclog'))
    gulps = [np.zeros((8, 4), np.float32)] * 2
    p, src, sink = _traced_run(bt, lambda g, h: _Source(g, h), _Gather,
                               gulps, simple_header([-1, 4], 'f32'))
    with open(path) as f:
        text = f.read()
    assert 'bifrost_tpu_counter_total{name="pipeline.gulps"} %d' % \
        counters.get('pipeline.gulps') in text
    assert 'bifrost_tpu_hist_count{name="slo.exit_age_s"} 2' in text
    ring = src.orings[0].name
    assert 'bifrost_tpu_ring_bytes{ring="%s",kind="size"}' % ring in text
    import glob
    import os
    flows = glob.glob(os.path.join(str(tmp_path / 'proclog'), '*',
                                   'rings_flow', '*'))
    assert ring in {os.path.basename(f) for f in flows}


# ---------------------------------------------------------------------------
# the one-shot profiler capture, the usage tracker and the memory helpers
# ---------------------------------------------------------------------------

def _fused_chain(ngulp=3):
    from bifrost_tpu_torch.stages import DetectStage
    from tests.test_torch_supervision import (TorchGatherSink,
                                              TorchNumpySourceBlock)
    hdr = simple_header([-1, 2, 8], 'cf32', labels=['time', 'pol', 'freq'])
    rng = np.random.RandomState(4)
    gulps = [(rng.randn(4, 2, 8) + 1j * rng.randn(4, 2, 8))
             .astype(np.complex64) for _ in range(ngulp)]
    with bt.Pipeline() as p:
        b = bt.blocks.copy(TorchNumpySourceBlock(gulps, hdr, 4),
                           space='cuda')
        b = bt.blocks.fused(b, [DetectStage('stokes', axis='pol')])
        sink = TorchGatherSink(bt.blocks.copy(b, space='system'))
    return p, sink


def test_profiler_captures_one_dispatch_and_reset_rearms(monkeypatch,
                                                         tmp_path):
    """BF_TORCH_PROFILE: the first fused dispatch of the process runs in
    one torch.profiler capture (one Chrome trace, one count); later
    dispatches are not captured until reset()."""
    import os
    from bifrost_tpu_torch.telemetry import profiling
    monkeypatch.setenv('BF_TORCH_PROFILE', str(tmp_path))
    profiling.reset()
    try:
        for run in (1, 2):
            p, sink = _fused_chain()
            run_bounded(p)
            assert sink.result().shape[0] == 12
            assert counters.get('torchprof.captures') == 1
        trace = profiling.last_trace()
        assert trace == str(tmp_path / ('torchprof-%d.json' % os.getpid()))
        assert os.listdir(tmp_path) == [os.path.basename(trace)]
        with open(trace) as f:
            events = json.load(f)['traceEvents']
        assert events
        profiling.reset()
        p, _sink = _fused_chain()
        run_bounded(p)
        assert counters.get('torchprof.captures') == 2
    finally:
        profiling.reset()
    # unarmed: no capture
    monkeypatch.delenv('BF_TORCH_PROFILE')
    p, _sink = _fused_chain()
    run_bounded(p)
    assert counters.get('torchprof.captures') == 2


def test_usage_file_keys_and_format_equal_the_jax_tracker(monkeypatch,
                                                          tmp_path):
    """The same tracked calls give the same usage file (the package
    prefix of the surfaced counters aside) and the same state file."""
    import bifrost_tpu.telemetry as jtel
    files = {}
    for name, tel, c in (('port', telemetry, counters),
                         ('jax', jtel, jcounters)):
        monkeypatch.setenv('BF_CACHE_DIR', str(tmp_path / name))
        monkeypatch.setattr(tel, '_client', tel._LocalClient())
        monkeypatch.setattr(tel, '_surfaced_totals', {})
        assert not tel.is_active()
        tel.enable()

        @tel.track_function
        def counted(x):
            return x + 1

        @tel.track_function_timed
        def timed(x):
            return x * 2

        class Thing(object):
            @tel.track_method
            def poke(self):
                return 1

            @tel.track_method_timed
            def prod(self):
                return 2

        for i in range(3):
            counted(i)
        timed(1)
        Thing().poke()
        Thing().prod()
        Thing().prod()
        tel.track_module()
        c.inc('block_failures', 2)
        snap = tel.flush()
        assert snap['block_failures'] == 2
        with open(tel.usage_path()) as f:
            usage = json.load(f)
        with open(tel._state_path()) as f:
            state = f.read()
        tel.disable()
        assert not tel.is_active()
        files[name] = (usage, state)
    port, jax = files['port'], files['jax']
    assert port[1] == jax[1] == 'enabled'
    rename = {k.replace('bifrost_tpu.counters.',
                        'bifrost_tpu_torch.counters.'): v
              for k, v in jax[0].items()}
    assert sorted(port[0]) == sorted(rename)
    for k, v in port[0].items():
        assert v[:2] == rename[k][:2] and len(v) == 3
    assert port[0]['bifrost_tpu_torch.counters.block_failures'][0] == 2


def test_telemetry_cli_status(monkeypatch, tmp_path):
    import os
    import subprocess
    import sys
    env = dict(os.environ, BF_CACHE_DIR=str(tmp_path),
               PYTHONPATH=os.path.dirname(os.path.dirname(
                   os.path.abspath(__file__))))
    p = subprocess.run([sys.executable, '-m', 'bifrost_tpu_torch.telemetry',
                        '--enable', '--status'], env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    assert p.stdout.startswith('bifrost_tpu_torch local telemetry is '
                               'active (file: %s' % tmp_path)
    assert 'no usage recorded' in p.stdout
    assert (tmp_path / 'telemetry_state').read_text() == 'enabled'


@pytest.mark.parametrize('size', [1, 100, 4096, 12345])
def test_memory_helpers_equal_jax(size, monkeypatch):
    from bifrost_tpu import memory as jmemory
    from bifrost_tpu_torch import memory
    for mod in (memory, jmemory):
        buf = mod.raw_malloc(size)
        assert buf.dtype == np.uint8 and buf.shape == (size,)
        assert buf.ctypes.data % mod.ALIGNMENT == 0
    assert memory.ALIGNMENT == jmemory.ALIGNMENT
    host = memory.raw_malloc(size, 'cuda_host')
    assert host.ctypes.data % memory.ALIGNMENT == 0
    src = np.arange(size, dtype=np.uint64).astype(np.uint8)
    a, b = memory.raw_malloc(size), jmemory.raw_malloc(size)
    memory.memcpy(a, src)
    jmemory.memcpy(b, src)
    assert np.array_equal(a, b) and np.array_equal(a, src)
    memory.memset(a, 7)
    jmemory.memset(b, 7)
    assert np.array_equal(a, b) and (a == 7).all()
    with pytest.raises(ValueError):
        memory.raw_malloc(size, 'cuda')
    with pytest.raises(ValueError):
        jmemory.raw_malloc(size, 'tpu')
    for env in ('4096', '64', 'junk'):
        monkeypatch.setenv('BF_ALIGNMENT', env)
        assert memory._alignment_from_env() == \
            jmemory._alignment_from_env()
