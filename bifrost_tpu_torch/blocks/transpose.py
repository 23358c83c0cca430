"""Axis permutation block (the port of ``bifrost_tpu/blocks/transpose.py``;
reference: python/bifrost/blocks/transpose.py:41-83).

On a ``cuda`` ring the block runs :class:`~bifrost_tpu_torch.stages.
TransposeStage` (``permute`` and a contiguous copy); on a ``system`` ring
it takes the cache-blocked numpy path below, into the output ring's
host view.
"""

from __future__ import annotations

import numpy as np

from ..stages import TransposeStage
from .fft import _StageBlock

__all__ = ['TransposeBlock', 'transpose']


class TransposeBlock(_StageBlock):
    def __init__(self, iring, axes, *args, **kwargs):
        super(TransposeBlock, self).__init__(iring, TransposeStage(axes),
                                             *args, **kwargs)

    def define_valid_input_spaces(self):
        return ('cuda', 'system')

    def on_data(self, ispan, ospan):
        if ispan.ring.is_device:
            return super(TransposeBlock, self).on_data(ispan, ospan)
        _host_transpose(ospan.data.as_numpy(),
                        ispan.data.as_numpy(), self._stage.axes)


def _host_transpose(out, src, axes, tile=64):
    """out[...] = src.transpose(axes), cache-blocked.

    numpy's strided copy of a big transposed view reads in column order
    and thrashes the cache; tiling the two permuted axes into square
    blocks keeps both the read and the write stream resident.  Other
    permutations, small ones and an ``out`` that aliases ``src`` take the
    plain assignment."""
    view = src.transpose(axes)
    big = [i for i, n in enumerate(view.shape) if n > 1]
    if len(big) != 2 or view.shape[big[0]] < tile \
            or view.shape[big[1]] < tile \
            or np.shares_memory(out, src):
        out[...] = view
        return
    vt = np.squeeze(view)
    ot = np.squeeze(out)
    if vt.strides[0] >= vt.strides[1]:   # already row-major-ish
        out[...] = view
        return
    n0, n1 = vt.shape
    for i in range(0, n0, tile):
        for j in range(0, n1, tile):
            ot[i:i + tile, j:j + tile] = vt[i:i + tile, j:j + tile]


def transpose(iring, axes, *args, **kwargs):
    """Block: transpose (permute) axes of the data stream."""
    return TransposeBlock(iring, axes, *args, **kwargs)
