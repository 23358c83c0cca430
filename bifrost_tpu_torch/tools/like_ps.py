"""ps-style listing of running bifrost_tpu_torch pipelines (the port's
counterpart of ``tools/like_ps.py``).

For every pipeline PID: command line, user, CPU%, memory%, elapsed
time, thread count (via ``ps``), the rings it uses (name, space, size
from the rings/<name> ProcLog geometry entries), and each block with
its read/write ring indices, core binding, and available logs.
"""

import argparse
import os
import subprocess
import sys

from .. import proclog
from ..monitor_utils import (list_pipelines, get_command_line, get_best_size,
                             ring_geometry, block_rings)


def get_process_details(pid):
    """user/CPU%/mem%/etime/threads via ``ps``
    (reference: like_ps.py:45-77).  Accepts a bare PID or a fabric
    instance entry (``<pid>@<host>.<role>``)."""
    data = {'user': '', 'cpu': 0.0, 'mem': 0.0, 'etime': '00:00',
            'threads': 0}
    try:
        out = subprocess.check_output(
            ['ps', 'o', 'user,pcpu,pmem,etime,nlwp',
             str(proclog.entry_pid(pid) or pid)],
            stderr=subprocess.DEVNULL).decode()
        fields = out.split('\n')[1].split(None, 4)
        data.update({'user': fields[0], 'cpu': float(fields[1]),
                     'mem': float(fields[2]),
                     'etime': fields[3].replace('-', 'd '),
                     'threads': int(fields[4], 10)})
    except (subprocess.CalledProcessError, IndexError, ValueError,
            OSError):
        pass
    return data






def describe_pid(pid):
    """Text description of one pipeline
    (reference: like_ps.py:120-196)."""
    contents = proclog.load_by_pid(pid)
    details = get_process_details(pid)
    cmd = get_command_line(pid)
    if not cmd and not details['user'] and not contents:
        return []
    out = ['PID: %s' % pid,
           '  Command: %s' % cmd,
           '  User: %s' % details['user'],
           '  CPU Usage: %.1f%%' % details['cpu'],
           '  Memory Usage: %.1f%%' % details['mem'],
           '  Elapsed Time: %s' % details['etime'],
           '  Thread Count: %i' % details['threads']]

    geometry = ring_geometry(contents)
    rings = []
    for block, logs in sorted(contents.items()):
        if block.replace(os.sep, '/').startswith('rings'):
            continue
        for ring in sum(block_rings(logs), []):
            if ring not in rings:
                rings.append(ring)

    out.append('  Rings:')
    for i, ring in enumerate(rings):
        dtl = geometry.get(str(ring))
        if dtl and 'stride' in dtl:
            sz, un = get_best_size(
                float(dtl['stride']) *
                max(int(dtl.get('nringlet', 1)), 1))
            out.append('    %i: %s on %s of size %.1f %s'
                       % (i, ring, dtl.get('space', '?'), sz, un))
        else:
            out.append('    %i: %s' % (i, ring))

    out.append('  Blocks:')
    for block, logs in sorted(contents.items()):
        if block.replace(os.sep, '/').startswith('rings'):
            continue
        rins, routs = block_rings(logs)
        core = logs.get('bind', {}).get('core0', None)
        out.append('    %s%s' % (block, '' if core is None
                                 else ' (core %s)' % core))
        if rins:
            out.append('      -> read ring(s): %s'
                       % ' '.join('%i' % rings.index(v) for v in rins
                                  if v in rings))
        if routs:
            out.append('      -> write ring(s): %s'
                       % ' '.join('%i' % rings.index(v) for v in routs
                                  if v in rings))
        if logs:
            out.append('      -> log(s): %s' % ' '.join(sorted(logs)))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument('pid', nargs='*', type=int,
                    help='pipeline PIDs (default: all found)')
    args = ap.parse_args(argv)
    pids = args.pid or list_pipelines()
    if not pids:
        print('No running pipelines found under %s'
              % proclog.proclog_dir())
        return 1
    for pid in pids:
        for line in describe_pid(pid):
            print(line)
    return 0


if __name__ == '__main__':
    sys.exit(main())
