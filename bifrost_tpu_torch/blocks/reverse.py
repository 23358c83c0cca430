"""Axis-reversal block (reference: python/bifrost/blocks/reverse.py:36-75;
the port of ``bifrost_tpu/blocks/reverse.py``): the cyclic reversal
b(i) = a(-i) of the reference's map gather.  On a ``cuda`` ring the math
is :class:`bifrost_tpu_torch.stages.ReverseStage`; a ``system`` ring
takes numpy's flip and roll."""

from __future__ import annotations

import numpy as np

from ..stages import ReverseStage
from .fft import _StageBlock

__all__ = ['ReverseBlock', 'reverse']


class ReverseBlock(_StageBlock):
    def __init__(self, iring, axes, *args, **kwargs):
        super(ReverseBlock, self).__init__(iring, ReverseStage(axes),
                                           *args, **kwargs)

    def define_valid_input_spaces(self):
        return ('cuda', 'system')

    def on_data(self, ispan, ospan):
        if ispan.ring.is_device:
            return super(ReverseBlock, self).on_data(ispan, ospan)
        y = ispan.data.as_numpy()
        for ax in self._stage.axes:
            y = np.roll(np.flip(y, axis=ax), 1, axis=ax)
        ospan.data.as_numpy()[...] = y


def reverse(iring, axes, *args, **kwargs):
    """Block: reverse data along the given axes."""
    return ReverseBlock(iring, axes, *args, **kwargs)
