"""Per-scope reusable scratch storage (the JAX package's
``bifrost_tpu/temp_storage.py``; reference:
python/bifrost/temp_storage.py:35-68): a block keeps an array across
gulps and gets it back while its shape and type hold.  Host spaces give
the port's :class:`~bifrost_tpu_torch.ndarray.ndarray`, ``cuda`` a
tensor in the device representation (``ndarray.empty``).
"""

from __future__ import annotations

import threading

from .ndarray import empty as _nd_empty

__all__ = ['TempStorage']


class TempStorage(object):
    def __init__(self, space):
        self.space = space
        self._lock = threading.Lock()
        self._buffers = {}   # key -> (shape, dtype, array)

    def allocate(self, key, shape, dtype):
        """The scratch array for (key, shape, dtype), allocated again
        when the shape or type changes."""
        with self._lock:
            cur = self._buffers.get(key)
            if cur is None or cur[0] != tuple(shape) or cur[1] != dtype:
                cur = (tuple(shape), dtype,
                       _nd_empty(shape, dtype, self.space))
                self._buffers[key] = cur
            return cur[2]

    class _Alloc(object):
        def __init__(self, parent, nbytes):
            self.parent, self.nbytes = parent, nbytes

        def __enter__(self):
            with self.parent._lock:
                cur = self.parent._buffers.get('__raw__')
                if cur is None or cur[0][0] < self.nbytes:
                    cur = ((self.nbytes,), 'u8',
                           _nd_empty((self.nbytes,), 'u8',
                                     self.parent.space))
                    self.parent._buffers['__raw__'] = cur
                return cur[2]

        def __exit__(self, *exc):
            return False

    def allocate_raw(self, nbytes):
        """Context manager yielding a raw byte scratch buffer."""
        return TempStorage._Alloc(self, nbytes)
