"""One run of one cell: set-up, the measured window, the metrics, the
check of the window's outputs against the plain reference."""

import gc
import os
import random
import sys
import threading
import time

from . import registry
from . import trace as _trace

#: top-level module names that no run may load, compared whole
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'bifrost_tpu')


def forbidden_loaded():
    """The forbidden top-level names present in ``sys.modules``."""
    tops = {name.split('.', 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


class Context(object):
    """What a metric reader reads: the window, the outputs, the source's
    and the sink's clocks, the port's counters at the window's ends and
    the trace summary (None without ``--trace 1``)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def counter_delta(self, name):
        return self.counters_close.get(name, 0) - \
            self.counters_open.get(name, 0)

    def window_share(self, intervals):
        """The share of the window covered by ``intervals``, in %."""
        a0, a1 = self.t_open, self.t_close
        cov = sum(max(0.0, min(b, a1) - max(a, a0)) for a, b in intervals)
        return 100.0 * cov / (a1 - a0)

    def window_outputs(self):
        """(receipt time, frame offset, nframe) of the window's outputs:
        the one that opened it to the last before it closed."""
        return self.outputs[self.i_open:self.i_close]

    def stage_roofline(self, stage):
        """% of the card's bound that ``stage``'s kernels reached in the
        traced sub-window, or None where the stage is not in the chain
        or the trace saw none of its kernels."""
        if self.trace is None or stage not in self.stages:
            return None
        mod = registry.roofline_module(stage, self.root)
        t = self.trace['stage_kernel_s'].get(stage, 0.0)
        first = self.stages[stage][0]
        n = self.trace_c1.get('block.%s.gulps' % first, 0) - \
            self.trace_c0.get('block.%s.gulps' % first, 0)
        if mod is None or t <= 0 or n <= 0:
            return None
        return 100.0 * mod.work(self.geom)['bound_s'] * n / t


def sample_fractions(seed, k):
    """``k`` points of the window drawn from the seed, one in each k-th
    of it, away from its edges."""
    rng = random.Random(int(seed) * 7919 + 17)
    return [(i + rng.uniform(0.1, 0.9)) / k for i in range(k)]


def run_cell(name, seed, seconds, trace, *, root=registry.HERE,
             device=None, t_process=None, controls=(), keep_trace=None):
    """Run cell ``name`` once.  Returns (the result line's dict, what the
    run found besides it, the controls' readings).  ``device='cpu'`` runs the whole chain on the
    CPU (tests); otherwise the card must be there."""
    t_process = time.perf_counter() if t_process is None else t_process
    spec = registry.cell(name, root)
    wl, cfg, traffic = spec['workload'], spec['config'], spec['traffic']
    chain, ref = spec['chain'], spec['reference']
    import torch
    import bifrost_tpu_torch as bt
    from bifrost_tpu_torch import device as bdev
    from bifrost_tpu_torch.telemetry import counters
    on_card = device != 'cpu'
    t_import = time.perf_counter()
    if on_card:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < int(wl['chips']):
            raise SystemExit('portbench: the cell asks for %d card(s), '
                             '%d found' % (int(wl['chips']),
                                           torch.cuda.device_count()
                                           if torch.cuda.is_available()
                                           else 0))
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        bdev.set_device('cpu')
    dev = bdev.get_device()
    geom = chain.geometry(cfg, traffic)
    nslot = int(traffic['nslot'])
    if trace and on_card:
        _trace.warm_profiler()

    def make(slot):
        return chain.make_gulp(geom, seed, slot, dev)

    marks = {}

    def perf_totals():
        return {b.name.split('/')[-1]: dict(b.perf_totals)
                for b in p.blocks}

    def on_open():
        marks['c_open'] = counters.snapshot()
        marks['perf_open'] = perf_totals()
        if on_card:
            torch.cuda.reset_peak_memory_stats()

    def on_close():
        marks['c_close'] = counters.snapshot()
        marks['perf_close'] = perf_totals()
        if on_card:
            marks['peak'] = torch.cuda.max_memory_allocated()

    fracs = sample_fractions(seed, int(traffic['check_samples']))
    with bt.Pipeline() as p:
        src = _blocks().make_source(bt, chain.header(geom), geom, make,
                                    nslot)
        stages, last = chain.build(bt, src, geom, cfg, nslot)
        sink = _blocks().make_sink(
            bt, last, warmup_outputs=int(traffic['warmup_outputs']),
            seconds=float(seconds), sample_at=fracs,
            sample_nbyte=chain.output_nbyte(geom), source=src,
            on_open=on_open, on_close=on_close)
    t_built = time.perf_counter()
    stage_names = {st: [b.name for b in blks]
                   for st, blks in stages.items()}
    capture = None
    if trace:
        length = min(2.0, 0.25 * float(seconds))
        capture = _trace.Capture(sink, 0.4 * float(seconds), length,
                                 counters)
    failure = []

    def runner():
        try:
            p.run()
        except BaseException as exc:
            failure.append(exc)

    th = threading.Thread(target=runner, name='portbench-pipeline',
                          daemon=True)
    th.start()
    deadline_open = time.perf_counter() + 900
    while th.is_alive() and not sink.opened.is_set():
        if time.perf_counter() > deadline_open:
            break
        sink.opened.wait(0.5)
    if th.is_alive() and sink.opened.is_set():
        if capture is not None:
            capture.run()
        sink.closed.wait(float(seconds) + 120)
    th.join(60)
    if th.is_alive():
        p.shutdown()
        th.join(30)
        raise RuntimeError('the pipeline did not end (window open: %s, '
                           'closed: %s)' % (sink.opened.is_set(),
                                            sink.closed.is_set()))
    if failure:
        raise RuntimeError('the pipeline failed: %r' % (failure[0],)) \
            from failure[0]
    if not sink.closed.is_set():
        raise RuntimeError('the window never closed: %d outputs'
                           % len(sink.outputs))
    peak = marks.get('peak', 0)
    setup_marks = {k: (v - t_process if v is not None else None)
                   for k, v in (('imported', t_import),
                                ('built', t_built),
                                ('first_gulp', src.t_first),
                                ('slots_filled', src.t_filled),
                                ('first_output', sink.outputs[0][0]),
                                ('window_open', sink.t_open))}
    ctx = Context(
        geom=geom, root=root, stages=stage_names, seconds=float(seconds),
        t_open=sink.t_open, t_close=sink.t_close, i_open=sink.i_open,
        i_close=sink.i_close, outputs=list(sink.outputs),
        stamps=list(src.stamps), source_reserves=list(src.reserves),
        sink_waits=list(sink.waits), counters_open=marks['c_open'],
        counters_close=marks['c_close'], setup_s=sink.t_open - t_process,
        trace=None, trace_c0=None, trace_c1=None)
    samples = [(off * geom['in_frames_per_out_frame'] //
                geom['gulp_nframe'], buf) for off, buf in sink.samples]
    gaps = _gaps(sink.outputs)
    trace_path = None
    if capture is not None:
        trace_path = os.path.join(keep_trace or os.path.join(
            root, '_cache', 'trace'), 'trace-%s-%d.json' % (name, seed))
        block_stage = {b: st for st, bl in stage_names.items() for b in bl}
        if _trace.export(capture, trace_path):
            ctx.trace = _trace.reduce_trace(trace_path, capture.threads,
                                            block_stage)
            ctx.trace_c0, ctx.trace_c1 = capture.c0, capture.c1
            if keep_trace is None:
                os.remove(trace_path)
            else:
                with open(trace_path + '.threads', 'w') as f:
                    f.write(repr(capture.threads))
        capture.prof = None
    # the window's numbers are read; the program's state goes before the
    # reference runs on the same card
    del p, stages, last, src, sink, capture
    gc.collect()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    t_check = time.perf_counter()

    def gulp_of(g):
        """Gulp ``g`` as the program got it: its slot's seeded bytes
        with its index stamp."""
        t = make(g % nslot)
        t.view(-1)[:8] = torch.from_numpy(
            _blocks().index_stamp(g).copy()).to(t.device)
        return t

    got = chain.check(samples, gulp_of, geom, ref)
    ctl = {}
    for prec in controls:
        ctl[prec] = chain.check(samples, gulp_of, geom, ref, prec)
    check_s = time.perf_counter() - t_check
    limits = wl.get('limits', {})
    compared = {k: (got[k], limits.get(k)) for k in chain.CHECK}
    ok = all(lim is not None and val <= lim
             for val, lim in compared.values())
    nsample = len(samples)
    ok = ok and nsample == int(traffic['check_samples']) and not gaps
    metrics = {}
    kind = 'per_layer' if trace else 'end_to_end'
    for mname, mod in registry.metrics(root).items():
        if mod.KIND != kind:
            continue
        if kind == 'end_to_end' and mname not in wl['end_to_end']:
            continue
        val = mod.read(ctx)
        if val is None:
            if kind == 'end_to_end':
                raise RuntimeError('%s: nothing to read' % mname)
            continue
        metrics[mname] = {'value': val, 'unit': mod.UNIT}
    nout = len(ctx.window_outputs())
    result = {
        'correct': bool(ok),
        'attempted': nout,
        'failed': gaps + (0 if ok else max(nsample, 1)),
        'metrics': metrics,
        'device': _device(torch, on_card, int(wl['chips']), peak),
    }
    if ctx.trace is not None:
        result['device']['busy_s'] = ctx.trace['busy_s']
        result['device']['window_s'] = ctx.trace['window_s']
        result['breakdown'] = {'device_ops': ctx.trace['device_ops'],
                               'idle_gaps': ctx.trace['idle_gaps']}
    info = {'outputs_in_window': nout, 'samples_checked': nsample,
            'missing_frames': gaps, 'check_s': check_s,
            'setup_s': ctx.setup_s, 'setup_marks_s': setup_marks}
    info['host_s_in_window'] = {
        b: {k: round(v - marks['perf_open'][b].get(k, 0), 4)
            for k, v in tot.items()}
        for b, tot in marks['perf_close'].items()}
    info['per_second'] = _per_second(ctx)
    if ctx.trace is not None:
        info['trace'] = {k: ctx.trace[k] for k in
                         ('by_kind_s', 'stage_kernel_s',
                          'unattributed_kernel_s')}
    for k, v in got.items():
        if k not in compared:
            info[k] = v
    result['check'] = {k: {'value': v, 'limit': lim}
                       for k, (v, lim) in compared.items()}
    # last, once the reference, the controls and every metric reader
    # have run: no result leaves a process that holds a forbidden module
    forbidden = forbidden_loaded()
    if forbidden:
        raise RuntimeError('loaded in this process: %s' % forbidden)
    return result, info, ctl


def _per_second(ctx):
    """Outputs and input gulps a second of the window, one entry a
    whole second: whether the rate holds across the window."""
    outs = ctx.window_outputs()
    n = int(ctx.seconds)
    cnt = [0] * max(n, 1)
    for t, _, _ in outs:
        k = int(t - ctx.t_open)
        if k < len(cnt):
            cnt[k] += 1
    return cnt


def _blocks():
    from . import blocks
    return blocks


def _gaps(outputs):
    """Frames missing between consecutive outputs (0 when every output
    follows the one before)."""
    missing = 0
    for (_, o0, n0), (_, o1, _) in zip(outputs, outputs[1:]):
        if o1 != o0 + n0:
            missing += abs(o1 - (o0 + n0))
    return missing


def _device(torch, on_card, chips, peak):
    if not on_card:
        return {'platform': 'cpu', 'kind': 'cpu', 'count': 1,
                'memory_peak_bytes': 0}
    return {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
            'count': chips, 'memory_peak_bytes': int(peak)}
