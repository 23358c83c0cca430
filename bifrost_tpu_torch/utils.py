"""Small shared utilities (the port of the part of
``bifrost_tpu/utils.py`` that the port needs so far: the bounded LRU
cache that ``ops.map`` keeps its parsed expressions in)."""

from __future__ import annotations

import threading
from collections import OrderedDict

__all__ = ['ObjectCache']


class ObjectCache(object):
    """Bounded LRU cache (reference: src/ObjectCache.hpp:1-94, used for
    the bfMap kernel cache)."""

    def __init__(self, capacity=128):
        self.capacity = capacity
        self._items = OrderedDict()
        self._lock = threading.Lock()

    def get(self, key, default=None):
        with self._lock:
            if key in self._items:
                self._items.move_to_end(key)
                return self._items[key]
            return default

    def put(self, key, value):
        with self._lock:
            self._items[key] = value
            self._items.move_to_end(key)
            while len(self._items) > self.capacity:
                self._items.popitem(last=False)
        return value

    def keys(self):
        with self._lock:
            return list(self._items.keys())

    def __contains__(self, key):
        with self._lock:
            return key in self._items

    def __len__(self):
        with self._lock:
            return len(self._items)

    def clear(self):
        with self._lock:
            self._items.clear()
