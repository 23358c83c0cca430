"""ProcLog: filesystem status files for runtime monitoring.

Every block publishes small ``key : value`` files under
``<BF_PROCLOG_DIR>/<pid>/<block>/<log>`` (reference:
src/proclog.cpp:45-147, python/bifrost/proclog.py:40-143).  The default
directory lies under the process's temporary directory.  Writes are
rate limited per log, and a failed write never disturbs the pipeline.
"""

from __future__ import annotations

import os
import tempfile
import time

__all__ = ['ProcLog', 'proclog_dir']

#: minimum seconds between two (unforced) writes of one log
MIN_INTERVAL = 0.1


def proclog_dir():
    return os.environ.get('BF_PROCLOG_DIR') or os.path.join(
        tempfile.gettempdir(), 'bifrost_tpu_torch_proclog')


class ProcLog(object):
    def __init__(self, name):
        self.name = name
        self.path = os.path.join(proclog_dir(), str(os.getpid()), name)
        self._last_write = 0.0
        try:
            os.makedirs(os.path.dirname(self.path), exist_ok=True)
        except OSError:
            pass

    def update(self, contents, force=False):
        """Write ``key : value`` lines (dict) or a raw string; at most
        once per MIN_INTERVAL unless ``force``."""
        now = time.monotonic()
        if not force and now - self._last_write < MIN_INTERVAL:
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
