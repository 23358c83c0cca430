"""The traced run's device picture: a ``torch.profiler`` capture over a
steady sub-window of the measured window, reduced to busy time by kind,
device time by stage, the heaviest device operations and the longest
idle gaps.

The sub-window is a ``record_function`` range in the profiling thread,
so its bounds sit on the trace's own clock.  A kernel belongs to the
stage whose block thread made the CUDA call that launched it (the
runtime or driver event with the kernel's correlation id).
"""

import json
import os
import threading
import time

SUBWINDOW = 'portbench.subwindow'

_H2D, _D2H, _KERNEL = 'h2d', 'd2h', 'kernel'


def warm_profiler():
    """Start and stop the profiler once, so that its first start (the
    CUPTI set-up) is paid in set-up and not inside the window."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.zeros(1, device='cuda').add_(1)
        torch.cuda.synchronize()


class Capture(object):
    """Runs the profiler from ``start`` seconds into the window for
    ``length`` seconds, reading the port's counters at the sub-window's
    ends.  :meth:`run` is called from the thread that warmed the
    profiler, once the window is open."""

    def __init__(self, sink, start, length, counters):
        self.sink, self.start, self.length = sink, start, length
        self._counters = counters
        self.prof = None
        self.c0 = self.c1 = None
        self.threads = {}

    def run(self):
        import torch
        from torch.profiler import ProfilerActivity, profile, \
            record_function
        delay = self.sink.t_open + self.start - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        if self.sink.closed.is_set():
            return
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            with record_function(SUBWINDOW):
                self.c0 = self._counters.snapshot()
                time.sleep(self.length)
                self.c1 = self._counters.snapshot()
        for t in threading.enumerate():
            for tid in _trace_ids(t):
                self.threads[tid] = t.name
        self.prof = prof


def _trace_ids(thread):
    """The ids a Chrome trace of the profiler may give ``thread``: its
    kernel thread id, and its pthread id cut to 32 bits, as unsigned,
    as signed and as the magnitude of the signed value (the runtime
    events carry the last)."""
    ids = {thread.native_id, thread.ident}
    low = thread.ident & 0xFFFFFFFF
    signed = low - (1 << 32) if low >= (1 << 31) else low
    ids.update((low, signed, abs(signed)))
    return ids


def _merged(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _union(intervals):
    return sum(b - a for a, b in _merged(intervals))


def _kind(ev):
    name = ev.get('name', '')
    if ev.get('cat') == 'gpu_memcpy':
        if 'HtoD' in name:
            return _H2D
        if 'DtoH' in name:
            return _D2H
    return _KERNEL


def reduce_trace(path, thread_names, block_stage):
    """The sub-window's device picture from a Chrome trace the profiler
    wrote: ``thread_names`` maps the trace's thread ids to thread names,
    ``block_stage`` block (thread) names to stages."""
    with open(path) as f:
        events = json.load(f)['traceEvents']
    sub = [e for e in events if e.get('name') == SUBWINDOW and
           e.get('ph') == 'X']
    if not sub:
        raise RuntimeError('the trace has no %s range' % SUBWINDOW)
    w0 = float(sub[0]['ts'])
    w1 = w0 + float(sub[0]['dur'])
    launches = {}
    calls = []
    device = []
    for e in events:
        if e.get('ph') != 'X':
            continue
        cat = e.get('cat', '')
        args = e.get('args') or {}
        if cat in ('cuda_runtime', 'cuda_driver'):
            corr = args.get('correlation')
            tid = e.get('tid')
            if isinstance(tid, str) and tid.lstrip('-').isdigit():
                tid = int(tid)
            name = thread_names.get(tid)
            if corr is not None:
                launches[corr] = name
            a, b = float(e['ts']), float(e['ts']) + float(e.get('dur', 0))
            if b > w0 and a < w1:
                calls.append((a, b, name, e.get('name', '')))
        elif cat in ('kernel', 'gpu_memcpy', 'gpu_memset'):
            a = max(float(e['ts']), w0)
            b = min(float(e['ts']) + float(e.get('dur', 0)), w1)
            if b > a:
                device.append((a, b, _kind(e), e.get('name', ''),
                               args.get('correlation')))
    span = (w1 - w0) * 1e-6
    by_kind = {k: _union([(a, b) for a, b, kd, _, _ in device if kd == k])
               * 1e-6 for k in (_H2D, _D2H, _KERNEL)}
    busy = _union([(a, b) for a, b, _, _, _ in device]) * 1e-6
    stage_s = {}
    unattributed = 0.0
    ops = {}
    for a, b, kd, name, corr in device:
        ops[name] = ops.get(name, 0.0) + (b - a) * 1e-6
        if kd != _KERNEL:
            continue
        stage = block_stage.get(launches.get(corr))
        if stage is None:
            unattributed += (b - a) * 1e-6
        else:
            stage_s[stage] = stage_s.get(stage, 0.0) + (b - a) * 1e-6
    busy_iv = _merged([(a, b) for a, b, _, _, _ in device])
    gaps = []
    prev = w0
    for a, b in busy_iv + [[w1, w1]]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    named = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        best, label = 0.0, 'no CUDA call in flight'
        for ca, cb, who, api in calls:
            ov = min(b, cb) - max(a, ca)
            if ov > best:
                best = ov
                label = '%s: %s' % ((who or 'thread ?').split('/')[-1], api)
        named.append([label, (b - a) * 1e-6])
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    return {'window_s': span, 'busy_s': busy, 'by_kind_s': by_kind,
            'stage_kernel_s': stage_s, 'unattributed_kernel_s':
            unattributed,
            'device_ops': [[n[:160], s] for n, s in top],
            'idle_gaps': named}


def export(capture, path):
    """Write the capture's Chrome trace to ``path``; False if nothing
    was captured."""
    if capture.prof is None:
        return False
    os.makedirs(os.path.dirname(path), exist_ok=True)
    capture.prof.export_chrome_trace(path)
    return True
