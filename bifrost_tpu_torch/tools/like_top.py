"""top-style monitor of running bifrost_tpu_torch pipelines (the port's
counterpart of ``tools/like_top.py``).

Panes (matching the reference's information set):
  * load average + process counts (/proc/loadavg)
  * aggregate + per-core CPU usage deltas (/proc/stat)
  * memory / swap usage (/proc/meminfo)
  * optional card memory line (--devices: ``nvidia-smi`` in a
    subprocess with a time limit, so the monitor never opens a CUDA
    context of its own)
  * per-block rows across ALL pipeline PIDs: PID, block, core, %CPU of
    that core, total/acquire/process/reserve perf times, gulp-latency
    p50/p99 and ring-wait p99 (ms, from the telemetry histograms each
    block publishes into its perf ProcLog),
    Age99 = capture-to-commit age p99 (ms; how OLD the data is when
    this block commits/exits it — the SLO column, telemetry.slo,
    needs a trace-context origin in the stream),
    G/D = logical gulps per dispatch (1.0 unbatched; ~K when
    macro-gulp execution is amortizing dispatch; a
    '+'-prefixed block is a compiled-segment member whose row is
    synthesized by its segment, so fusion never reads as a dead
    block),
    Shd = mesh width of the executing plan (1 single-device; N when
    the block runs sharded over an N-chip mesh),
    GOP/s = GEMM-class throughput (declared real ops per gulp over
    the median gulp time; beamform/correlate blocks publish it;
    0.0 for other blocks),
    command line

Interactive curses UI with the reference's sort keys (i=pid, b=name,
c=core, t=total, a=acquire, p=process, r=reserve, plus l=p99 gulp
latency, w=p99 ring wait, e=age99, g=gulps-per-dispatch, s=shards,
and o=GOP/s; pressing the active key again reverses; q quits).
``--once`` prints one plain-text snapshot instead (usable in
pipes/tests).
"""

import argparse
import os
import socket
import sys
import time

from .. import proclog
from ..monitor_utils import (list_pipelines, get_command_line)


def get_load_average():
    """1/5/10-minute load + process counts (/proc/loadavg;
    reference: like_top.py:52-74)."""
    data = {'1min': 0.0, '5min': 0.0, '10min': 0.0,
            'procTotal': 0, 'procRunning': 0, 'lastPID': 0}
    try:
        with open('/proc/loadavg') as fh:
            fields = fh.read().split(None, 4)
        running, total = fields[3].split('/', 1)
        data.update({'1min': float(fields[0]), '5min': float(fields[1]),
                     '10min': float(fields[2]),
                     'procRunning': int(running), 'procTotal': int(total),
                     'lastPID': int(fields[4])})
    except (OSError, ValueError, IndexError):
        pass
    return data


_CPU_STATE = {}


def get_processor_usage():
    """Per-CPU usage fractions since the previous call (/proc/stat
    deltas; reference: like_top.py:76-132).  Keys: 'avg' and one per
    core id; values: user/nice/sys/idle/wait/irq/sirq/steal/total."""
    zero = {'user': 0.0, 'nice': 0.0, 'sys': 0.0, 'idle': 0.0,
            'wait': 0.0, 'irq': 0.0, 'sirq': 0.0, 'steal': 0.0,
            'total': 0.0}
    data = {'avg': dict(zero)}
    try:
        with open('/proc/stat') as fh:
            lines = fh.read().split('\n')
    except OSError:
        return data
    for line in lines:
        if not line.startswith('cpu'):
            break
        fields = line.split(None, 10)
        try:
            cid = int(fields[0][3:], 10)
        except ValueError:
            cid = 'avg'
        try:
            us, ni, sy, idl, wa, hi, si, st = \
                (float(v) for v in fields[1:9])
        except (ValueError, IndexError):
            continue
        prev = _CPU_STATE.get(cid)
        _CPU_STATE[cid] = {'us': us, 'ni': ni, 'sy': sy, 'id': idl,
                           'wa': wa, 'hi': hi, 'si': si, 'st': st}
        if prev is not None:
            us -= prev['us']; ni -= prev['ni']; sy -= prev['sy']
            idl -= prev['id']; wa -= prev['wa']; hi -= prev['hi']
            si -= prev['si']; st -= prev['st']
        t = us + ni + sy + idl + wa + hi + si + st
        if t <= 0:
            data[cid] = dict(zero)
            continue
        data[cid] = {'user': us / t, 'nice': ni / t, 'sys': sy / t,
                     'idle': idl / t, 'wait': wa / t, 'irq': hi / t,
                     'sirq': si / t, 'steal': st / t,
                     'total': (us + ni + sy) / t}
    return data


def get_memory_swap_usage():
    """Memory and swap from /proc/meminfo (kB;
    reference: like_top.py:134-166)."""
    data = {'memTotal': 0, 'memUsed': 0, 'memFree': 0, 'swapTotal': 0,
            'swapUsed': 0, 'swapFree': 0, 'buffers': 0, 'cached': 0}
    keymap = {'MemTotal:': 'memTotal', 'MemFree:': 'memFree',
              'Buffers:': 'buffers', 'Cached:': 'cached',
              'SwapTotal:': 'swapTotal', 'SwapFree:': 'swapFree'}
    try:
        with open('/proc/meminfo') as fh:
            for line in fh:
                fields = line.split(None, 2)
                if fields and fields[0] in keymap:
                    data[keymap[fields[0]]] = int(fields[1], 10)
    except (OSError, ValueError):
        pass
    data['memUsed'] = data['memTotal'] - data['memFree']
    data['swapUsed'] = data['swapTotal'] - data['swapFree']
    return data


_DEV_CACHE = {'t': 0.0, 'data': None}
_DEV_REFRESH_SECS = 30.0


def get_device_memory_usage(timeout=10.0):
    """Card memory from ``nvidia-smi --query-gpu=memory.total,
    memory.used`` (MiB), run in a subprocess with a time limit, so that
    a hung driver cannot hang the monitor and the monitor opens no CUDA
    context of its own.  The result is cached for _DEV_REFRESH_SECS
    seconds.  Without ``nvidia-smi`` it reports no card."""
    now = time.monotonic()
    if _DEV_CACHE['data'] is not None and \
            now - _DEV_CACHE['t'] < _DEV_REFRESH_SECS:
        return _DEV_CACHE['data']
    import subprocess
    data = {'devCount': 0, 'memTotal': 0, 'memUsed': 0, 'memFree': 0}
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=memory.total,memory.used',
             '--format=csv,noheader,nounits'],
            capture_output=True, text=True, timeout=timeout)
        tot = used = n = 0
        for line in out.stdout.strip().splitlines():
            t, u = (int(v) for v in line.split(','))
            tot += t
            used += u
            n += 1
        data.update({'devCount': n, 'memTotal': tot * 1024,
                     'memUsed': used * 1024,
                     'memFree': (tot - used) * 1024})
    except Exception:
        pass
    _DEV_CACHE.update(t=now, data=data)
    return data


def collect_blocks(pids=None, autotune=None, health=None, fabric=None,
                   tenants=None, sched=None, captures=None):
    """Per-block rows across pipelines: pid/name/cmd/core and the perf
    times (reference: like_top.py:305-330).  Pass a dict as
    ``autotune`` to collect each process's ``analysis/autotune`` knob
    panel — as ``health`` its ``pipeline/health`` state row
    — as ``fabric`` its ``fabric/health``
    membership/end-to-end row — as ``tenants``
    its ``service/tenants`` multi-tenant pane —
    as ``sched`` its ``sched/placements`` control-plane row
    — and as ``captures`` the per-worker counters
    of any sharded capture engine (``workerN_npackets`` keys in a
    capture stats block) —
    from the SAME proclog walk (a separate collect pass would
    re-parse every proclog file per refresh).
    ``pids`` entries may be bare PIDs or fabric instance strings
    (``<pid>@<host>.<role>``)."""
    rows = {}
    for pid in (pids if pids is not None else list_pipelines()):
        contents = proclog.load_by_pid(pid)
        if autotune is not None:
            panel = contents.get('analysis', {}).get('autotune')
            if panel:
                autotune[pid] = panel
        if health is not None:
            hrow = contents.get('pipeline', {}).get('health')
            if hrow:
                health[pid] = hrow
        if fabric is not None:
            frow = contents.get('fabric', {}).get('health')
            if frow:
                fabric[pid] = frow
        if tenants is not None:
            trow = contents.get('service', {}).get('tenants')
            if trow:
                tenants[pid] = trow
        if sched is not None:
            srow = contents.get('sched', {}).get('placements')
            if srow:
                sched[pid] = srow
        cmd = get_command_line(pid)
        for block, logs in contents.items():
            if block == 'rings':
                continue
            st = logs.get('stats')
            if captures is not None and st and \
                    'worker0_npackets' in st:
                workers, i = [], 0
                while ('worker%d_npackets' % i) in st:
                    workers.append(
                        {'npackets': _num(st['worker%d_npackets' % i]),
                         'nbytes':
                             _num(st.get('worker%d_nbytes' % i, 0)),
                         'zero_copy':
                             _num(st.get('worker%d_zero_copy' % i,
                                         0))})
                    i += 1
                captures.setdefault(pid, []).append(
                    {'name': block, 'workers': workers,
                     'npackets': _num(st.get('npackets', 0)),
                     'ngood_bytes': _num(st.get('ngood_bytes', 0)),
                     'nlate': _num(st.get('nlate', 0)),
                     'nalien': _num(st.get('nalien', 0))})
            core = logs.get('bind', {}).get('core0', -1)
            perf = logs.get('perf', {})
            if not perf and 'bind' not in logs:
                continue
            ac = max(0.0, _num(perf.get('acquire_time')))
            pr = max(0.0, _num(perf.get('process_time')))
            re = max(0.0, _num(perf.get('reserve_time')))
            rows['%s-%s' % (pid, block)] = {
                'pid': proclog.entry_pid(pid) or 0, 'name': block,
                'cmd': cmd, 'core': core,
                'acquire': ac, 'process': pr, 'reserve': re,
                'total': ac + pr + re,
                # latency-histogram columns (seconds; rendered as ms)
                'p50': max(0.0, _num(perf.get('gulp_p50'))),
                'p99': max(0.0, _num(perf.get('gulp_p99'))),
                'wait99': max(0.0, _num(perf.get('ring_wait_p99'))),
                # macro-gulp amortization: logical gulps per dispatch
                # (1.0 unbatched; K when macro-gulp execution engaged)
                'gpd': max(0.0, _num(perf.get('gulps_per_dispatch'))),
                # capture-to-commit age p99 (seconds; rendered as ms):
                # the SLO column — how OLD the data is when this block
                # commits/exits it (telemetry.slo; needs trace context)
                'age99': max(0.0, _num(perf.get('commit_age_p99'))),
                # mesh width of the executing plan (;
                # 1 = single device, N = sharded over N chips)
                'shards': max(1.0, _num(perf.get('shards')) or 1.0),
                # GEMM-class throughput ( beamformer
                # section): declared real ops per gulp over the median
                # gulp time, in Gop/s (0 = not a GEMM-class block)
                'gops': max(0.0, _num(perf.get('gemm_gops_per_s'))),
                # compiled-segment membership (bifrost_tpu_torch.segments):
                # a fused member block's row is SYNTHESIZED by its
                # segment — the G/D column then shows
                # the segment's amortization, so fusion never reads
                # as a dead block
                'seg': str(perf.get('in_segment') or '')}
    return rows


def _num(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return 0.0


def collect_autotune(pids=None):
    """{pid: panel dict} from each process's ``analysis/autotune``
    ProcLog — the closed-loop auto-tuner's live knob panel
   .  Empty when no controller is running."""
    out = {}
    for pid in (pids if pids is not None else list_pipelines()):
        log = proclog.load_by_pid(pid).get('analysis', {}) \
            .get('autotune')
        if log:
            out[pid] = log
    return out


def render_text(load, cpu, mem, dev, rows, tuners=None,
                sort_key='process', sort_rev=True, width=140,
                health=None, fabric=None, tenants=None, sched=None,
                captures=None):
    """Render the full display as text lines (shared by --once and the
    curses loop)."""
    host = socket.gethostname()
    out = []
    out.append('like_top - %s - load average: %.2f, %.2f, %.2f'
               % (host, load['1min'], load['5min'], load['10min']))
    out.append('Processes: %s total, %s running'
               % (load['procTotal'], load['procRunning']))
    c = cpu.get('avg', {})
    out.append('CPU(s):%5.1f%%us,%5.1f%%sy,%5.1f%%ni,%5.1f%%id,'
               '%5.1f%%wa,%5.1f%%hi,%5.1f%%si,%5.1f%%st'
               % tuple(100.0 * c.get(k, 0.0)
                       for k in ('user', 'sys', 'nice', 'idle', 'wait',
                                 'irq', 'sirq', 'steal')))
    out.append('Mem:  %9ik total, %9ik used, %9ik free, %9ik buffers'
               % (mem['memTotal'], mem['memUsed'], mem['memFree'],
                  mem['buffers']))
    out.append('Swap: %9ik total, %9ik used, %9ik free, %9ik cached'
               % (mem['swapTotal'], mem['swapUsed'], mem['swapFree'],
                  mem['cached']))
    if dev and dev.get('devCount'):
        out.append('Dev(s): %9ik total, %9ik used, %9ik free, '
                   '%i device(s)'
                   % (dev['memTotal'], dev['memUsed'], dev['memFree'],
                      dev['devCount']))
    out.append('')
    hdr = '%6s  %-24s  %4s  %5s  %8s  %8s  %8s  %8s  %8s  %8s  %8s' \
          '  %8s  %5s  %3s  %7s  Cmd' \
        % ('PID', 'Block', 'Core', '%CPU', 'Total', 'Acquire',
           'Process', 'Reserve', 'p50(ms)', 'p99(ms)', 'Wait99',
           'Age99', 'G/D', 'Shd', 'GOP/s')
    out.append(hdr)
    order = sorted(rows, key=lambda k: rows[k][sort_key],
                   reverse=sort_rev)
    any_seg = False
    for key in order:
        d = rows[key]
        try:
            pct = '%5.1f' % (100.0 * cpu[d['core']]['total'])
        except (KeyError, TypeError):
            pct = '%5s' % ' '
        name = d['name'].split('/')[-1][:24]
        if d.get('seg'):
            # fused into a compiled segment: synthesized row
            any_seg = True
            name = ('+' + name)[:24]
        out.append('%6i  %-24s  %4s  %5s  %8.3f  %8.3f  %8.3f  %8.3f'
                   '  %8.2f  %8.2f  %8.2f  %8.2f  %5.1f  %3i  %7.1f'
                   '  %s'
                   % (d['pid'], name, d['core'], pct, d['total'],
                      d['acquire'], d['process'], d['reserve'],
                      d['p50'] * 1e3, d['p99'] * 1e3,
                      d['wait99'] * 1e3, d['age99'] * 1e3, d['gpd'],
                      int(d['shards']), d['gops'],
                      d['cmd'][:max(width - 157, 0)]))
    if any_seg:
        out.append("('+' = fused into a compiled segment: the row is "
                   'synthesized by the segment, G/D shows its '
                   'amortization)')
    # pipeline health state machine (pipeline/health ProcLog —
    #)
    for pid in sorted(health or {}, key=str):
        h = health[pid]
        out.append('')
        out.append('[health] pid %s  state %s  transitions %s  %s'
                   % (pid, h.get('state', '?'),
                      h.get('transitions', '?'),
                      ('blocks: %s' % h['blocks'])[:max(width - 40, 0)]
                      if h.get('blocks') else ''))
    # fabric membership + cross-host end-to-end SLO (fabric/health
    # ProcLog): one row per launcher process showing
    # its fabric state, live/dead peers, and the capture-to-sink age
    # p99 measured against the ORIGIN host's clock
    for pid in sorted(fabric or {}, key=str):
        f = fabric[pid]
        e2e = f.get('fabric_exit_age_p99_ms')
        out.append('')
        out.append('[fabric] pid %s  host %s  role %s  state %s  '
                   'peers %s/%s%s%s'
                   % (pid, f.get('host', '?'), f.get('role', '?'),
                      f.get('state', '?'), f.get('peers_alive', '?'),
                      f.get('peers_total', '?'),
                      ('  dead: %s' % f['peers_dead'])
                      if f.get('peers_dead') not in (None, '', 'none')
                      else '',
                      ('  e2e_age_p99 %.1fms' % _num(e2e))
                      if e2e not in (None, '') else ''))
    # multi-tenant service pane (service/tenants ProcLog, published by
    # the JobManager): one row per tenant job with
    # its state, health, admitted gulps, quota sheds, warm-start flag
    # and exit-age p99
    for pid in sorted(tenants or {}, key=str):
        t = tenants[pid]
        ids = sorted({k.split('.', 2)[1] for k in t
                      if k.startswith('t.') and k.count('.') >= 2})
        out.append('')
        out.append('[tenants] pid %s  %s tenant(s)'
                   % (pid, t.get('ntenants', len(ids))))
        if ids:
            out.append('   %-16s %-9s %-9s %8s  %8s  %4s  %9s'
                       % ('tenant', 'state', 'health', 'gulps',
                          'q_shed', 'warm', 'age99(ms)'))
        for tid in ids:
            def f(field, default=''):
                return t.get('t.%s.%s' % (tid, field), default)
            age = f('age99_ms', None)
            out.append('   %-16s %-9s %-9s %8s  %8s  %4s  %9s'
                       % (tid[:16], f('state', '?'), f('health', '?'),
                          f('gulps', 0), f('q_shed', 0),
                          'yes' if _num(f('warm', 0)) else 'no',
                          ('%.1f' % _num(age)) if age not in
                          (None, '') else '-'))
    # elastic control-plane placements pane (sched/placements
    # ProcLog, published by the cross-host Scheduler —
    #): which host each tenant landed on, whether
    # it was displaced by bin-packing, and how many dead-host
    # re-placement events have fired
    for pid in sorted(sched or {}, key=str):
        s = sched[pid]
        tids = sorted({k.split('.', 2)[1] for k in s
                       if k.startswith('p.') and k.count('.') >= 2})
        out.append('')
        out.append('[sched] pid %s  fabric %s  %s tenant(s)  '
                   'replacements %s%s'
                   % (pid, s.get('fabric', '?'),
                      s.get('ntenants', len(tids)),
                      s.get('replacement_events', 0),
                      ('  dead: %s' % s['dead_hosts'])
                      if s.get('dead_hosts') not in
                      (None, '', 'none') else ''))
        if tids:
            placed = []
            for tid in tids:
                hostname = s.get('p.%s.host' % tid, '?')
                disp = _num(s.get('p.%s.displaced' % tid, 0))
                placed.append('%s->%s%s' % (tid, hostname,
                                            '(displaced)' if disp
                                            else ''))
            out.append('   ' + '  '.join(placed)
                       [:max(width - 3, 0)])
    # sharded capture worker pane (capture stats ProcLog with
    # workerN_* counters):
    # one row per worker with its packet/byte share and what fraction
    # of its packets took the zero-copy scatter path — a zero-copy
    # share collapsing toward 0%% on a fixed-frame format means the
    # engaged fast path silently disengaged (every packet then pays
    # the staging copy again)
    for pid in sorted(captures or {}, key=str):
        for cb in captures[pid]:
            out.append('')
            out.append('[capture] pid %s  %s  %d worker(s)  '
                       '%d pkts  late %d  alien %d'
                       % (pid, cb['name'].split('/')[-1][:28],
                          len(cb['workers']), int(cb['npackets']),
                          int(cb['nlate']), int(cb['nalien'])))
            for i, w in enumerate(cb['workers']):
                zc_pct = (100.0 * w['zero_copy'] / w['npackets']) \
                    if w['npackets'] else 0.0
                out.append('   worker%-2d %12d pkts %14d bytes  '
                           'zero-copy %5.1f%%'
                           % (i, int(w['npackets']), int(w['nbytes']),
                              zc_pct))
    # live auto-tuner knob panel (analysis/autotune ProcLog, fed by
    # the autotune.* counters)
    for pid in sorted(tuners or {}, key=str):
        t = tuners[pid]
        out.append('')
        out.append('[autotune] pid %s  mode %s  ticks %s  retunes %s'
                   '  converged %s%s'
                   % (pid, t.get('mode', '?'), t.get('ticks', '?'),
                      t.get('retunes', '?'),
                      'yes' if _num(t.get('converged')) else 'no',
                      '  FROZEN' if _num(t.get('frozen')) else ''))
        knobs = sorted((k[len('knob.'):], v) for k, v in t.items()
                       if k.startswith('knob.'))
        if knobs:
            out.append('           ' + '  '.join(
                '%s=%s' % kv for kv in knobs)[:max(width - 11, 0)])
        if t.get('last'):
            out.append('           last: %s' % t['last'])
    return out


def load_fleet_rollup(path):
    """Parse the collector's rollup JSON (BF_FLEET_ROLLUP_FILE);
    None when the file is missing/partial (the collector replaces it
    atomically, so partial reads only happen on dead paths)."""
    import json
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def render_fleet(rollup, width=140, path=None):
    """Render the fleet collector's merged rollup as text lines:
    per-host liveness rows, the cross-host tenant pane, and the
    active-alert pane.  Shared
    by ``--fleet --once`` and the curses loop."""
    out = []
    if rollup is None:
        out.append('like_top --fleet: no rollup%s — is a FleetCollector'
                   ' running with BF_FLEET_ROLLUP_FILE set?'
                   % ((' at %s' % path) if path else ''))
        return out
    fleet = rollup.get('fleet', {})
    age_s = max(0.0, (time.time_ns() - rollup.get('wall_ns', 0)) / 1e9)
    out.append('fleet - %s host(s): %s live, %s stale, %s dead'
               '  (rollup age %.1fs)'
               % (fleet.get('hosts_seen', 0),
                  fleet.get('hosts_live', 0),
                  len(fleet.get('hosts_stale', ())),
                  len(fleet.get('hosts_dead', ())), age_s))
    out.append('')
    out.append('%-16s %-6s %7s %7s  %-14s %7s %4s %5s  %s'
               % ('Host', 'State', 'Age(s)', 'Seq', 'Session', 'Pid',
                  'Ten', 'Rings', 'Health'))
    for host in sorted(rollup.get('hosts', {})):
        e = rollup['hosts'][host]
        state = 'DEAD' if e.get('dead') else \
            'FINAL' if e.get('final') else \
            'STALE' if e.get('stale') else 'live'
        health = e.get('health') or {}
        bad = sorted('%s:%s' % (p, (h or {}).get('state', '?'))
                     for p, h in health.items()
                     if (h or {}).get('state') not in (None, 'NOMINAL'))
        ident = e.get('identity') or {}
        out.append('%-16s %-6s %7.1f %7s  %-14s %7s %4s %5s  %s'
                   % (host[:16], state, _num(e.get('age_s')),
                      e.get('seq', '?'),
                      str(e.get('session', '?'))[:14],
                      ident.get('pid', '?'),
                      len(e.get('tenants') or ()),
                      len(e.get('rings') or ()),
                      (', '.join(bad) if bad else
                       ('ok' if health else '-'))[:max(width - 72, 0)]))
    tenants = rollup.get('tenants', {})
    if tenants:
        out.append('')
        out.append('%-16s %-12s %-9s %-9s %8s %6s  %s'
                   % ('Tenant', 'Host', 'State', 'Health', 'Gulps',
                      'Warm', 'Age99(ms)'))
        for tid in sorted(tenants):
            d = tenants[tid]
            slo = d.get('slo') or {}
            p99 = slo.get('exit_age_p99_s')
            out.append('%-16s %-12s %-9s %-9s %8s %6s  %s'
                       % (tid[:16],
                          ('%s%s' % (d.get('host', '?'),
                                     '' if d.get('host_fresh', True)
                                     else '(stale)'))[:12],
                          str(d.get('state', '?'))[:9],
                          str(d.get('health', '?'))[:9],
                          d.get('gulps', 0),
                          'yes' if _num(d.get('warm', 0)) else 'no',
                          ('%.1f' % (_num(p99) * 1e3))
                          if p99 is not None else '-'))
    alerts = rollup.get('alerts', {})
    active = alerts.get('active') or []
    ac = alerts.get('counters', {})
    out.append('')
    out.append('[alerts] %s firing  (fired %s  resolved %s  '
               'suppressed %s)'
               % (len(active), ac.get('fired', 0),
                  ac.get('resolved', 0), ac.get('suppressed', 0)))
    for a in active:
        out.append('   FIRING %-8s %s@%s  value=%s'
                   % (str(a.get('severity', 'warn'))[:8],
                      a.get('name', '?'), a.get('instance', '?'),
                      a.get('value')))
    for entry in (alerts.get('history') or [])[-5:]:
        out.append('   %-8s %s@%s  value=%s'
                   % (entry.get('event', '?'), entry.get('name', '?'),
                      entry.get('instance', '?'), entry.get('value')))
    return out


_SORT_KEYS = {'i': 'pid', 'b': 'name', 'c': 'core', 't': 'total',
              'a': 'acquire', 'p': 'process', 'r': 'reserve',
              'l': 'p99', 'w': 'wait99', 'g': 'gpd', 's': 'shards',
              'e': 'age99', 'o': 'gops'}


def run_curses(args):
    import curses

    def fleet_loop(scr):
        curses.use_default_colors()
        scr.nodelay(1)
        t_last, lines = 0.0, []
        while True:
            ch = scr.getch()
            curses.flushinp()
            if ch == ord('q'):
                break
            now = time.time()
            maxy, maxx = scr.getmaxyx()
            if now - t_last > args.interval or not lines:
                lines = render_fleet(load_fleet_rollup(args.fleet),
                                     width=maxx, path=args.fleet)
                t_last = now
            for y, line in enumerate(lines[:maxy - 1]):
                attr = curses.A_REVERSE if line.startswith('Host') \
                    else curses.A_NORMAL
                try:
                    scr.addstr(y, 0, line[:maxx - 1], attr)
                    scr.clrtoeol()
                except curses.error:
                    break
            scr.clrtobot()
            scr.refresh()
            time.sleep(0.2)

    def loop(scr):
        curses.use_default_colors()
        scr.nodelay(1)
        sort_key, sort_rev = args.sort, True
        t_last, state = 0.0, None
        while True:
            ch = scr.getch()
            curses.flushinp()
            if ch == ord('q'):
                break
            if 0 <= ch < 256 and chr(ch) in _SORT_KEYS:
                new_key = _SORT_KEYS[chr(ch)]
                sort_rev = not sort_rev if new_key == sort_key else True
                sort_key = new_key
            now = time.time()
            if now - t_last > args.interval or state is None:
                tuners, health, fab, tens, schd = {}, {}, {}, {}, {}
                caps = {}
                state = (get_load_average(), get_processor_usage(),
                         get_memory_swap_usage(),
                         get_device_memory_usage() if args.devices
                         else None,
                         collect_blocks(autotune=tuners,
                                        health=health, fabric=fab,
                                        tenants=tens, sched=schd,
                                        captures=caps),
                         tuners, health, fab, tens, schd, caps)
                t_last = now
            maxy, maxx = scr.getmaxyx()
            lines = render_text(*state[:6], sort_key=sort_key,
                                sort_rev=sort_rev, width=maxx,
                                health=state[6], fabric=state[7],
                                tenants=state[8], sched=state[9],
                                captures=state[10])
            for y, line in enumerate(lines[:maxy - 1]):
                attr = curses.A_REVERSE if line.startswith('   PID') \
                    else curses.A_NORMAL
                try:
                    scr.addstr(y, 0, line[:maxx - 1], attr)
                    scr.clrtoeol()
                except curses.error:
                    break
            scr.clrtobot()
            scr.refresh()
            time.sleep(0.2)

    curses.wrapper(fleet_loop if getattr(args, 'fleet', None)
                   else loop)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument('--once', action='store_true',
                    help='print one plain-text snapshot and exit')
    ap.add_argument('--interval', type=float, default=1.0,
                    help='poll interval in seconds')
    ap.add_argument('--devices', action='store_true',
                    help='also query card memory through nvidia-smi')
    ap.add_argument('--sort', default='process',
                    choices=sorted(set(_SORT_KEYS.values())))
    ap.add_argument('--fleet', nargs='?', metavar='ROLLUP_JSON',
                    const=os.environ.get('BF_FLEET_ROLLUP_FILE', ''),
                    default=None,
                    help='render the fleet collector rollup instead '
                         'of local pipelines; optional path to the '
                         'rollup JSON (default: BF_FLEET_ROLLUP_FILE)')
    args = ap.parse_args(argv)

    if args.fleet is not None:
        if not args.fleet:
            print('like_top: --fleet needs a rollup path (argument or '
                  'BF_FLEET_ROLLUP_FILE)', file=sys.stderr)
            return 2
        if args.once:
            print('\n'.join(render_fleet(load_fleet_rollup(args.fleet),
                                         path=args.fleet)))
            return 0
        run_curses(args)
        return 0

    if args.once:
        get_processor_usage()        # prime the delta state
        time.sleep(0.05)
        tuners, health, fab, tens, schd = {}, {}, {}, {}, {}
        caps = {}
        lines = render_text(
            get_load_average(), get_processor_usage(),
            get_memory_swap_usage(),
            get_device_memory_usage() if args.devices else None,
            collect_blocks(autotune=tuners, health=health, fabric=fab,
                           tenants=tens, sched=schd, captures=caps),
            tuners, sort_key=args.sort, health=health, fabric=fab,
            tenants=tens, sched=schd, captures=caps)
        print('\n'.join(lines))
        return 0
    run_curses(args)
    return 0


if __name__ == '__main__':
    sys.exit(main())
