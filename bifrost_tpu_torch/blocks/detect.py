"""Polarization detection block: scalar / jones / stokes / stokes_i /
coherence (reference: python/bifrost/blocks/detect.py:40-159; the port
of ``bifrost_tpu/blocks/detect.py``).  The math is
:class:`bifrost_tpu_torch.stages.DetectStage`, which runs K2 for Stokes
on a (time, pol, freq) complex64 stream."""

from __future__ import annotations

from ..stages import DetectStage
from .fft import _StageBlock

__all__ = ['DetectBlock', 'detect']


class DetectBlock(_StageBlock):
    def __init__(self, iring, mode, axis=None, *args, **kwargs):
        super(DetectBlock, self).__init__(iring, DetectStage(mode, axis),
                                          *args, **kwargs)


def detect(iring, mode, axis=None, *args, **kwargs):
    """Block: square-law detection into polarization products
    (reference docstring: blocks/detect.py:141-159)."""
    return DetectBlock(iring, mode, axis, *args, **kwargs)
