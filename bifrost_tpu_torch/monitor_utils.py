"""Shared helpers of the port's pipeline monitors
(:mod:`bifrost_tpu_torch.tools`: ``like_top``, ``like_ps``,
``pipeline2dot``): the ProcLog-tree navigation and formatting they all
use (the counterpart of ``bifrost_tpu/monitor_utils.py``)."""

from __future__ import annotations

import os

from . import proclog

__all__ = ['list_pipelines', 'get_command_line', 'get_best_size',
           'ring_geometry', 'block_rings']


def list_pipelines():
    """Proclog instance entries with a ProcLog tree, sorted by PID.
    Entries are bare PIDs (int) or fabric-identity strings
    (``<pid>@<host>.<role>``, see :mod:`.proclog`); both forms
    feed straight into ``proclog.load_by_pid``."""
    base = proclog.proclog_dir()
    if not os.path.isdir(base):
        return []
    out = []
    for entry in os.listdir(base):
        pid = proclog.entry_pid(entry)
        if pid is None:
            continue
        out.append(pid if entry.isdigit() else entry)
    return sorted(out, key=lambda e: (proclog.entry_pid(e), str(e)))


def get_command_line(pid):
    """Full command line of ``pid`` (reference: like_top.py:210-224).
    Accepts a bare PID or a fabric instance entry."""
    pid = proclog.entry_pid(pid)
    if pid is None:
        return ''
    try:
        with open('/proc/%d/cmdline' % pid) as fh:
            return fh.read().replace('\0', ' ').strip()
    except OSError:
        return ''


def get_best_size(value):
    """Human-readable (value, unit) for a byte count
    (reference: like_ps.py:97-117)."""
    for mag, unit in ((1024.0 ** 4, 'TB'), (1024.0 ** 3, 'GB'),
                      (1024.0 ** 2, 'MB'), (1024.0, 'kB')):
        if value >= mag:
            return value / mag, unit
    return float(value), 'B'


def ring_geometry(contents):
    """rings/<name> geometry ProcLogs -> {ring_name: fields} (written
    by Ring._write_ring_proclog)."""
    out = {}
    for block, logs in contents.items():
        norm = block.replace(os.sep, '/')
        if norm == 'rings':
            out.update({k: dict(v) for k, v in logs.items()})
        elif norm.startswith('rings/'):
            name = norm.split('/', 1)[1]
            for fields in logs.values():
                out[name] = dict(fields)
    return out


def block_rings(logs):
    """([in rings], [out rings]) recorded by a block's in/out
    ProcLogs."""
    rins, routs = [], []
    for log, dest in (('in', rins), ('out', routs)):
        d = logs.get(log, {})
        for key in sorted(d):
            if key.startswith('ring') and d[key] not in dest:
                dest.append(d[key])
    return rins, routs
