"""FFT-shift block (reference: python/bifrost/blocks/fftshift.py:37-81;
the port of ``bifrost_tpu/blocks/fftshift.py``).  On a ``cuda`` ring the
math is :class:`bifrost_tpu_torch.stages.FftShiftStage`; a ``system``
ring takes numpy's shift."""

from __future__ import annotations

import numpy as np

from ..stages import FftShiftStage
from .fft import _StageBlock

__all__ = ['FftShiftBlock', 'fftshift']


class FftShiftBlock(_StageBlock):
    def __init__(self, iring, axes, inverse=False, *args, **kwargs):
        super(FftShiftBlock, self).__init__(
            iring, FftShiftStage(axes, inverse), *args, **kwargs)

    def define_valid_input_spaces(self):
        return ('cuda', 'system')

    def on_data(self, ispan, ospan):
        if ispan.ring.is_device:
            return super(FftShiftBlock, self).on_data(ispan, ospan)
        st = self._stage
        fn = np.fft.ifftshift if st.inverse else np.fft.fftshift
        ospan.data.as_numpy()[...] = fn(ispan.data.as_numpy(),
                                        axes=st.axes)


def fftshift(iring, axes, inverse=False, *args, **kwargs):
    """Block: shift the zero-frequency component to the array center."""
    return FftShiftBlock(iring, axes, inverse, *args, **kwargs)
