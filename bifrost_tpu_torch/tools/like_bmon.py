"""bmon-style monitor of packet capture/transmit statistics of
bifrost_tpu_torch pipelines (the port's counterpart of
``tools/like_bmon.py``).

Information set matching the reference:
  * per-PID summary: RX rate (B/s), RX packets/s, TX rate, TX pkt/s
  * per-block detail for the selected PID: good/missing/invalid/ignored
    byte totals, global and current loss percentages (gloss/closs)
  * rolling rate history rendered as an ASCII bar graph per direction

Rates come from deltas of successive ProcLog samples of the capture
engines' ``*_capture/stats`` entries (ngood_bytes/nmissing_bytes/
ninvalid/nignored/npackets) and the writers' ``*_transmit_*/stats``
(nbytes/npackets).  Ring-bridge endpoints (io/bridge.py) publish the
same stats shapes under ``*_bridge_transmit`` / ``*_bridge_capture``
and show up as rows tagged ``[bridge]`` — for a bridge, ``invalid``
counts CRC failures and ``ignored`` counts duplicate frames dropped
after a reconnect.  Curses UI: up/down select PID, q quits; ``--once``
prints a plain-text snapshot of every PID.
"""

import argparse
import os
import socket
import sys
import time


from .. import proclog
from ..monitor_utils import list_pipelines

_HISTORY = 60


def get_transmit_receive():
    """Snapshot all capture (RX) and transmit (TX) stats blocks across
    pipelines (reference: like_bmon.py:51-88)."""
    now = time.time()
    found = {}
    for pid in list_pipelines():
        contents = proclog.load_by_pid(pid)
        for block, logs in contents.items():
            st = logs.get('stats')
            if not st:
                continue
            if 'ngood_bytes' in st:
                kind = 'rx'
                entry = {'good': st.get('ngood_bytes', 0),
                         'missing': st.get('nmissing_bytes', 0),
                         'invalid': st.get('ninvalid', 0),
                         'ignored': st.get('nignored', 0),
                         'npackets': st.get('npackets', 0)}
                # sharded capture engines publish per-worker counters
                # (workerN_npackets/_nbytes/_zero_copy)
                workers, i = [], 0
                while ('worker%d_npackets' % i) in st:
                    workers.append({
                        'npackets': st['worker%d_npackets' % i],
                        'nbytes': st.get('worker%d_nbytes' % i, 0),
                        'zero_copy':
                            st.get('worker%d_zero_copy' % i, 0)})
                    i += 1
                if workers:
                    entry['workers'] = workers
            elif 'nbytes' in st:
                kind = 'tx'
                entry = {'good': st.get('nbytes', 0), 'missing': 0,
                         'invalid': 0, 'ignored': 0,
                         'npackets': st.get('npackets', 0)}
            else:
                continue
            entry.update({'pid': pid, 'name': block, 'kind': kind,
                          'time': now,
                          'bridge': '_bridge_' in block})
            found['%s-%s' % (pid, block)] = entry
    return found


def get_statistics(curr_list, prev_list):
    """Per-PID aggregated rates and loss percentages from two snapshots
    (reference: like_bmon.py:108-188)."""
    out = {}
    for key, curr in curr_list.items():
        pid, kind = curr['pid'], curr['kind']
        prev = prev_list.get(key)
        drate = prate = 0.0
        if prev is not None and curr['time'] > prev['time']:
            dt = curr['time'] - prev['time']
            drate = (curr['good'] - prev['good']) / dt
            prate = (curr['npackets'] - prev['npackets']) / dt
        gloss = closs = 0.0
        denom = curr['good'] + curr['missing']
        if denom > 0:
            gloss = 100.0 * curr['missing'] / denom
        if prev is not None:
            dmiss = curr['missing'] - prev['missing']
            dgood = curr['good'] - prev['good']
            if dmiss + dgood > 0:
                closs = 100.0 * dmiss / (dmiss + dgood)
        if pid not in out:
            out[pid] = {d: {'good': 0, 'missing': 0, 'invalid': 0,
                            'ignored': 0, 'drate': 0.0, 'prate': 0.0,
                            'gloss': 0.0, 'closs': 0.0, 'blocks': []}
                        for d in ('rx', 'tx')}
        agg = out[pid][kind]
        for k in ('good', 'missing', 'invalid', 'ignored'):
            agg[k] += curr[k]
        agg['drate'] += max(0.0, drate)
        agg['prate'] += max(0.0, prate)
        agg['gloss'] = max(agg['gloss'], gloss)
        agg['closs'] = max(agg['closs'], closs)
        workers = []
        for i, w in enumerate(curr.get('workers', [])):
            wprev = (prev or {}).get('workers', [])
            wrate = 0.0
            if i < len(wprev) and prev is not None and \
                    curr['time'] > prev['time']:
                wrate = (w['npackets'] - wprev[i]['npackets']) / \
                    (curr['time'] - prev['time'])
            workers.append(dict(w, prate=max(0.0, wrate)))
        agg['blocks'].append({
            'name': curr['name'], 'good': curr['good'],
            'missing': curr['missing'], 'invalid': curr['invalid'],
            'ignored': curr['ignored'], 'drate': max(0.0, drate),
            'prate': max(0.0, prate), 'gloss': gloss, 'closs': closs,
            'bridge': curr.get('bridge', False), 'workers': workers})
    return out


def set_units(value):
    """Human units for a B/s rate (reference: like_bmon.py:190-207)."""
    for mag, unit in ((1024.0 ** 3, 'GB/s'), (1024.0 ** 2, 'MB/s'),
                      (1024.0, 'kB/s')):
        if value >= mag:
            return value / mag, unit
    return value, 'B/s'


def bar_graph(history, width=60, height=4):
    """ASCII bar graph of a rate history (the reference's graphical
    pane analogue)."""
    hist = list(history)[-width:]
    peak = max(hist) if hist and max(hist) > 0 else 1.0
    rows = []
    for level in range(height, 0, -1):
        thresh = peak * (level - 0.5) / height
        rows.append(''.join('#' if v >= thresh else ' ' for v in hist))
    pv, pu = set_units(peak)
    rows[0] += '  peak %.1f %s' % (pv, pu)
    return rows


def render_pid(pid, stats, history, width=78):
    """Detail pane for one PID: totals + per-block table + history
    graphs."""
    out = []
    st = stats.get(pid)
    if st is None:
        return ['(no capture/transmit stats for pid %s)' % pid]
    for kind, label in (('rx', 'RX'), ('tx', 'TX')):
        agg = st[kind]
        if not agg['blocks']:
            continue
        dv, du = set_units(agg['drate'])
        out.append('%s: %8.2f %-5s %8.1f pkt/s   loss %5.1f%% now, '
                   '%5.1f%% total'
                   % (label, dv, du, agg['prate'], agg['closs'],
                      agg['gloss']))
        out.append('  %-28s %12s %12s %9s %9s %7s'
                   % ('block', 'good_bytes', 'missing', 'invalid',
                      'ignored', 'rate'))
        for b in sorted(agg['blocks'], key=lambda b: b['name']):
            bv, bu = set_units(b['drate'])
            tag = ' [bridge]' if b.get('bridge') else ''
            out.append('  %-28s %12d %12d %9d %9d %5.1f%s%s'
                       % (b['name'][:28], b['good'], b['missing'],
                          b['invalid'], b['ignored'], bv, bu[0], tag))
            for i, w in enumerate(b.get('workers', [])):
                zc_pct = 100.0 * w['zero_copy'] / w['npackets'] \
                    if w['npackets'] else 0.0
                wv, wu = set_units(w['nbytes'])
                out.append('    worker%-2d %10d pkts %8.1f %-4s '
                           '%8.1f pkt/s  zero-copy %5.1f%%'
                           % (i, w['npackets'], wv, wu.rstrip('/s'),
                              w['prate'], zc_pct))
        hist = history.get((pid, kind))
        if hist:
            out.append('  history (%ds):' % len(hist))
            out.extend('  ' + r for r in bar_graph(hist, width - 4))
    return out


def render_summary(stats):
    out = ['%7s  %11s %10s  %11s %10s'
           % ('PID', 'RX Rate', 'RX pkt/s', 'TX Rate', 'TX pkt/s')]
    for pid in sorted(stats, key=str):
        rx, tx = stats[pid]['rx'], stats[pid]['tx']
        rv, ru = set_units(rx['drate'])
        tv, tu = set_units(tx['drate'])
        out.append('%7s  %6.1f %-4s %10.1f  %6.1f %-4s %10.1f'
                   % (pid, rv, ru, rx['prate'], tv, tu, tx['prate']))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument('--once', action='store_true',
                    help='print one plain-text snapshot and exit')
    ap.add_argument('--interval', type=float, default=1.0)
    args = ap.parse_args(argv)

    host = socket.gethostname()
    prev = get_transmit_receive()
    history = {}

    def poll():
        nonlocal prev
        time.sleep(0.2 if args.once else 0)
        curr = get_transmit_receive()
        stats = get_statistics(curr, prev)
        prev = curr
        for pid, st in stats.items():
            for kind in ('rx', 'tx'):
                history.setdefault((pid, kind), []).append(
                    st[kind]['drate'])
                del history[(pid, kind)][:-_HISTORY]
        return stats

    if args.once:
        stats = poll()
        print('like_bmon - %s' % host)
        for line in render_summary(stats):
            print(line)
        for pid in sorted(stats, key=str):
            print()
            print('PID %s:' % pid)
            for line in render_pid(pid, stats, history):
                print(line)
        return 0

    import curses

    def loop(scr):
        curses.use_default_colors()
        scr.nodelay(1)
        sel, t_last, stats = 0, 0.0, {}
        while True:
            ch = scr.getch()
            curses.flushinp()
            if ch == ord('q'):
                break
            if ch == curses.KEY_UP:
                sel -= 1
            elif ch == curses.KEY_DOWN:
                sel += 1
            if time.time() - t_last > args.interval:
                stats = poll()
                t_last = time.time()
            pids = sorted(stats, key=str)
            sel = min(max(sel, 0), max(len(pids) - 1, 0))
            maxy, maxx = scr.getmaxyx()
            lines = ['like_bmon - %s   (up/down: select pid, q: quit)'
                     % host, '']
            lines += render_summary(stats)
            lines.append('')
            if pids:
                lines.append('--- PID %s ---' % pids[sel])
                lines += render_pid(pids[sel], stats, history,
                                    width=maxx)
            for y, line in enumerate(lines[:maxy - 1]):
                try:
                    scr.addstr(y, 0, line[:maxx - 1])
                    scr.clrtoeol()
                except curses.error:
                    break
            scr.clrtobot()
            scr.refresh()
            time.sleep(0.2)

    curses.wrapper(loop)
    return 0


if __name__ == '__main__':
    sys.exit(main())
