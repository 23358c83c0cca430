"""Memory helpers: the space lattice and the raw allocate, copy and set
primitives (the port of ``bifrost_tpu/memory.py``; reference:
python/bifrost/memory.py:37-101, src/memory.cpp:94-230).

:func:`raw_malloc` hands out host buffers aligned to ``BF_ALIGNMENT``
bytes (default 512, the reference's).  A ``cuda_host`` buffer is
page-locked when the port runs on a card, as the ``cuda_host`` rings'
buffers are.  Device memory belongs to torch's caching allocator, so a
raw ``cuda`` allocation raises (the JAX package raises for ``tpu``):
allocate with :func:`bifrost_tpu_torch.empty` instead.
"""

from __future__ import annotations

import os

import numpy as np

from .space import space_accessible, canonical, SPACES  # noqa: F401
from .ndarray import copy_array, memset_array  # noqa: F401

__all__ = ['ALIGNMENT', 'raw_malloc', 'memcpy', 'memset',
           'space_accessible', 'canonical', 'SPACES']


def _alignment_from_env():
    try:
        return max(int(os.environ.get('BF_ALIGNMENT', '512') or 512), 1)
    except ValueError:
        return 512


#: alignment of host allocations (reference: src/memory.cpp:334-351)
ALIGNMENT = _alignment_from_env()


def raw_malloc(size, space='system'):
    """``size`` bytes in a host space as a uint8 numpy array aligned to
    :data:`ALIGNMENT` (reference: bfMalloc, src/memory.cpp:110)."""
    space = canonical(space)
    if space == 'cuda':
        raise ValueError("Raw device allocation is managed by torch's "
                         "caching allocator; allocate with "
                         "bifrost_tpu_torch.empty(shape, dtype, "
                         "space='cuda')")
    if space == 'cuda_host':
        from .device import on_cuda
        if on_cuda():
            import torch
            # the array's base keeps the pinned tensor alive
            buf = torch.empty(size + ALIGNMENT, dtype=torch.uint8,
                              pin_memory=True).numpy()
        else:
            buf = np.empty(size + ALIGNMENT, dtype=np.uint8)
    else:
        buf = np.empty(size + ALIGNMENT, dtype=np.uint8)
    off = (-buf.ctypes.data) % ALIGNMENT
    return buf[off:off + size]


def memcpy(dst, src):
    """Byte copy between host buffers (reference: bfMemcpy,
    src/memory.cpp:163)."""
    dst[...] = src
    return dst


def memset(buf, value=0):
    buf[...] = value
    return buf
