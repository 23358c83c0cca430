"""Time-scrunch block: average ``factor`` frames into one (reference:
python/bifrost/blocks/scrunch.py:38-66; the port of
``bifrost_tpu/blocks/scrunch.py``).  On a ``cuda`` ring the math is
:class:`bifrost_tpu_torch.stages.ScrunchStage`; a ``system`` ring takes
numpy's mean (integers averaged in float32 and cast back)."""

from __future__ import annotations

import numpy as np

from ..stages import ScrunchStage
from .fft import _StageBlock

__all__ = ['ScrunchBlock', 'scrunch']


class ScrunchBlock(_StageBlock):
    def __init__(self, iring, factor, *args, **kwargs):
        assert isinstance(factor, int)
        super(ScrunchBlock, self).__init__(iring, ScrunchStage(factor),
                                           *args, **kwargs)

    def define_valid_input_spaces(self):
        return ('cuda', 'system')

    def on_data(self, ispan, ospan):
        if ispan.ring.is_device:
            return super(ScrunchBlock, self).on_data(ispan, ospan)
        f = self._stage.factor
        taxis = self._stage.taxis
        x = ispan.data.as_numpy()
        nf = x.shape[taxis] // f
        shp = x.shape[:taxis] + (nf, f) + x.shape[taxis + 1:]
        acc = x.dtype if np.issubdtype(x.dtype, np.inexact) \
            else np.float32
        ospan.data.as_numpy()[...] = x.reshape(shp).mean(
            axis=taxis + 1, dtype=acc).astype(x.dtype)


def scrunch(iring, factor, *args, **kwargs):
    """Block: average every ``factor`` frames into one."""
    return ScrunchBlock(iring, factor, *args, **kwargs)
