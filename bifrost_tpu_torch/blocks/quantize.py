"""Quantization block: float -> int with scale (the port of
``bifrost_tpu/blocks/quantize.py``; reference:
python/bifrost/blocks/quantize.py).

The device math lives in :class:`bifrost_tpu_torch.stages.QuantizeStage`:
in the FX-correlator chain the channelizer's cf32 spectra requantize to
ci8 between the F and X steps.  Host rings use
:func:`bifrost_tpu_torch.ops.quantize.quantize` (whole-byte types only:
packed outputs are not ported yet).
"""

from __future__ import annotations

from ..ops.quantize import quantize as _quantize
from ..stages import QuantizeStage
from .fft import _StageBlock

__all__ = ['QuantizeBlock', 'quantize']


class QuantizeBlock(_StageBlock):
    def __init__(self, iring, dtype, scale=1., *args, **kwargs):
        super(QuantizeBlock, self).__init__(
            iring, QuantizeStage(dtype, scale), *args, **kwargs)

    @property
    def dtype(self):
        return self._stage.dtype

    @property
    def scale(self):
        return self._stage.scale

    def define_valid_input_spaces(self):
        return ('cuda', 'system')

    def on_data(self, ispan, ospan):
        if ispan.ring.is_device:
            return super(QuantizeBlock, self).on_data(ispan, ospan)
        _quantize(ispan.data, ospan.data, self.scale)


def quantize(iring, dtype, scale=1., *args, **kwargs):
    """Block: quantize data to a smaller dtype."""
    return QuantizeBlock(iring, dtype, scale, *args, **kwargs)
