"""ProcLog: filesystem status files for runtime monitoring (the port of
``bifrost_tpu/proclog.py``).

Every block publishes small ``key : value`` files under
``<BF_PROCLOG_DIR>/<instance>/<block>/<log>`` (reference:
src/proclog.cpp:45-147, python/bifrost/proclog.py:40-143).  The default
directory lies under the process's temporary directory.  ``<instance>``
is the bare PID, or ``<pid>@<hostname>.<role>`` once a host identity is
stamped (:func:`set_identity` or ``BF_FABRIC_IDENTITY=hostname.role``),
so processes of several hosts sharing one filesystem never collide.  The
first ProcLog of a process removes the trees of dead local processes
(never those stamped with another host).  Writes are rate limited per
log (``BF_PROCLOG_INTERVAL`` seconds, default 0.1), and a failed write
never disturbs the pipeline.  :func:`load_by_filename` and
:func:`load_by_pid` read the files back.
"""

from __future__ import annotations

import os
import shutil
import socket as socket_mod
import tempfile
import threading
import time

__all__ = ['ProcLog', 'proclog_dir', 'load_by_pid', 'load_by_filename',
           'set_identity', 'get_identity', 'instance_name']

_lock = threading.Lock()
_gc_done = False

#: (hostname, role) stamped into this process's instance directory;
#: None for the bare-PID layout
_identity = None


def proclog_dir():
    return os.environ.get('BF_PROCLOG_DIR') or os.path.join(
        tempfile.gettempdir(), 'bifrost_tpu_torch_proclog')


def set_identity(host=None, role=None):
    """Stamp this process's proclog tree with a host identity: later
    ProcLogs land under ``<pid>@<host>.<role>``.  ``None`` / ``None``
    clears the stamp.  Separators are taken out of the parts so that the
    instance name stays one path component."""
    global _identity
    if host is None and role is None:
        _identity = None
        return None

    def _clean(part, fallback, dots=True):
        part = str(part or fallback)
        part = part.replace(os.sep, '-').replace('@', '-')
        if not dots:
            # the role is the last dot-separated token of the entry
            part = part.replace('.', '-')
        return part or fallback
    _identity = (_clean(host, socket_mod.gethostname() or 'host'),
                 _clean(role, 'worker', dots=False))
    return _identity


def get_identity():
    """The (hostname, role) stamp in effect, or None; read once from
    ``BF_FABRIC_IDENTITY`` when nothing was set programmatically."""
    if _identity is None:
        env = os.environ.get('BF_FABRIC_IDENTITY', '').strip()
        if env:
            host, _, role = env.partition('.')
            set_identity(host or None, role or 'worker')
    return _identity


def instance_name(pid=None):
    """This process's instance directory entry: ``<pid>``, or
    ``<pid>@<host>.<role>`` under an identity."""
    pid = os.getpid() if pid is None else int(pid)
    ident = get_identity()
    if ident is None:
        return str(pid)
    return '%d@%s.%s' % (pid, ident[0], ident[1])


def entry_pid(entry):
    """The PID of an instance entry (bare or stamped), or None for a
    foreign file."""
    head = str(entry).split('@', 1)[0]
    return int(head) if head.isdigit() else None


def entry_host(entry):
    """The hostname stamped into an instance entry, or None."""
    if '@' not in str(entry):
        return None
    tail = str(entry).split('@', 1)[1]
    return tail.rsplit('.', 1)[0] if '.' in tail else tail


def _pid_exists(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


def _gc_stale():
    """Remove the trees of dead local processes (reference: proclog.cpp,
    ProcLogMgr); another host's entries are left alone."""
    base = proclog_dir()
    if not os.path.isdir(base):
        return
    local = socket_mod.gethostname()
    for entry in os.listdir(base):
        pid = entry_pid(entry)
        if pid is None:
            continue
        host = entry_host(entry)
        if host is not None and host != local:
            continue
        if not _pid_exists(pid):
            shutil.rmtree(os.path.join(base, entry), ignore_errors=True)


class ProcLog(object):
    #: minimum seconds between two unforced writes of one log
    #: (``BF_PROCLOG_INTERVAL``; 0 writes every update)
    MIN_INTERVAL = None

    def __init__(self, name):
        global _gc_done
        self.name = name
        self.path = os.path.join(proclog_dir(), instance_name(), name)
        if ProcLog.MIN_INTERVAL is None:
            try:
                ProcLog.MIN_INTERVAL = float(
                    os.environ.get('BF_PROCLOG_INTERVAL', '0.1'))
            except ValueError:
                ProcLog.MIN_INTERVAL = 0.1
        self._last_write = 0.0
        with _lock:
            if not _gc_done:
                try:
                    _gc_stale()
                except OSError:
                    pass
                _gc_done = True
        try:
            os.makedirs(os.path.dirname(self.path), exist_ok=True)
        except OSError:
            pass

    def ready(self):
        """Whether the next unforced :meth:`update` would write."""
        if not ProcLog.MIN_INTERVAL:
            return True
        return time.monotonic() - self._last_write >= ProcLog.MIN_INTERVAL

    def update(self, contents, force=False):
        """Write ``key : value`` lines (dict) or a raw string; at most
        once per MIN_INTERVAL unless ``force``."""
        now = time.monotonic()
        if not force and ProcLog.MIN_INTERVAL and \
                now - self._last_write < ProcLog.MIN_INTERVAL:
            return
        self._last_write = now
        if isinstance(contents, dict):
            text = ''.join('%s : %s\n' % kv for kv in contents.items())
        else:
            text = str(contents)
        try:
            tmp = self.path + '.tmp'
            with open(tmp, 'w') as f:
                f.write(text)
            os.replace(tmp, self.path)
        except OSError:
            pass

    def close(self):
        pass


def _parse_value(v):
    v = v.strip()
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            continue
    return v


def load_by_filename(path):
    """One proclog file as a dict (reference: proclog.py:69-91)."""
    out = {}
    with open(path, 'r') as f:
        for line in f:
            if ':' not in line:
                continue
            k, _, v = line.partition(':')
            out[k.strip()] = _parse_value(v)
    return out


def _resolve_instance(pid):
    """The instance entry of ``pid``: the bare PID directory when it
    exists, else the first stamped entry with that PID; a full entry
    passes through."""
    base = proclog_dir()
    entry = str(pid)
    if '@' in entry or os.path.isdir(os.path.join(base, entry)):
        return entry
    try:
        for cand in sorted(os.listdir(base)):
            if entry_pid(cand) == int(entry):
                return cand
    except (OSError, ValueError):
        pass
    return entry


def load_by_pid(pid, include_rings=False):
    """Every proclog of a process as {block: {log: {key: value}}}
    (reference: proclog.py:93-143); ``pid`` may be a bare PID or a full
    ``<pid>@<host>.<role>`` entry.  ``include_rings`` is the reference's
    keyword and changes nothing, as in ``bifrost_tpu/proclog.py:250``:
    the rings' logs are entries of the walk like any block's."""
    root = os.path.join(proclog_dir(), _resolve_instance(pid))
    contents = {}
    for dirpath, _, filenames in os.walk(root):
        for fname in filenames:
            if fname.endswith('.tmp'):
                continue
            path = os.path.join(dirpath, fname)
            block = os.path.relpath(dirpath, root)
            try:
                parsed = load_by_filename(path)
            except (OSError, ValueError):
                continue
            contents.setdefault(block, {})[fname] = parsed
    return contents
