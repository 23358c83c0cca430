"""Small shared utilities (the port of ``bifrost_tpu/utils.py`` less its
XLA compilation cache): cached environment lookups and the bounded LRU
cache that ``ops.map`` keeps its parsed expressions in."""

from __future__ import annotations

import os
import threading
from collections import OrderedDict

__all__ = ['EnvVars', 'ObjectCache']


class EnvVars(object):
    """Cached environment lookups (reference: src/EnvVars.hpp:34-42):
    the first read of a name is kept until :meth:`clear`."""

    _cache = {}
    _lock = threading.Lock()

    @classmethod
    def get(cls, name, default=None):
        with cls._lock:
            if name not in cls._cache:
                cls._cache[name] = os.environ.get(name, default)
            return cls._cache[name]

    @classmethod
    def clear(cls):
        with cls._lock:
            cls._cache.clear()


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
