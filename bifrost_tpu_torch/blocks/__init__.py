"""Blocks of the PyTorch/CUDA port."""

from .copy import CopyBlock, copy
from .fused import FusedBlock, fused
from .beamform import BeamformBlock, beamform
from .fft import FftBlock, fft
from .quantize import QuantizeBlock, quantize
from .correlate import CorrelateBlock, CorrelateStageBlock, correlate
from .accumulate import AccumulateBlock, AccumulateStageBlock, accumulate
from .transpose import TransposeBlock, transpose
from .sigproc import (SigprocSourceBlock, SigprocSinkBlock, read_sigproc,
                      write_sigproc)
from .fdmt import (FdmtBlock, fdmt, FdmtStageBlock, fdmt_stage,
                   MatchedFilterBlock, matched_filter, ThresholdBlock,
                   threshold)

__all__ = ['CopyBlock', 'copy', 'FusedBlock', 'fused', 'BeamformBlock',
           'beamform', 'FftBlock', 'fft', 'QuantizeBlock', 'quantize',
           'CorrelateBlock', 'CorrelateStageBlock', 'correlate',
           'AccumulateBlock', 'AccumulateStageBlock', 'accumulate',
           'TransposeBlock', 'transpose', 'SigprocSourceBlock',
           'SigprocSinkBlock', 'read_sigproc', 'write_sigproc',
           'FdmtBlock', 'fdmt', 'FdmtStageBlock', 'fdmt_stage',
           'MatchedFilterBlock', 'matched_filter', 'ThresholdBlock',
           'threshold']
