"""Blocks of the PyTorch/CUDA port."""

from .copy import CopyBlock, copy
from .fused import FusedBlock, fused
from .beamform import BeamformBlock, beamform
from .fft import FftBlock, fft
from .quantize import QuantizeBlock, quantize
from .correlate import CorrelateBlock, CorrelateStageBlock, correlate
from .accumulate import AccumulateBlock, AccumulateStageBlock, accumulate

__all__ = ['CopyBlock', 'copy', 'FusedBlock', 'fused', 'BeamformBlock',
           'beamform', 'FftBlock', 'fft', 'QuantizeBlock', 'quantize',
           'CorrelateBlock', 'CorrelateStageBlock', 'correlate',
           'AccumulateBlock', 'AccumulateStageBlock', 'accumulate']
