"""Blocks of the PyTorch/CUDA port."""

from .copy import CopyBlock, copy
from .fused import FusedBlock, fused
from .beamform import BeamformBlock, beamform
from .fft import FftBlock, fft
from .detect import DetectBlock, detect
from .reduce import ReduceBlock, reduce
from .fftshift import FftShiftBlock, fftshift
from .reverse import ReverseBlock, reverse
from .scrunch import ScrunchBlock, scrunch
from .unpack import UnpackBlock, unpack
from .print_header import PrintHeaderBlock, print_header
from .quantize import QuantizeBlock, quantize
from .correlate import CorrelateBlock, CorrelateStageBlock, correlate
from .accumulate import AccumulateBlock, AccumulateStageBlock, accumulate
from .transpose import TransposeBlock, transpose
from .guppi_raw import GuppiRawSourceBlock, read_guppi_raw
from .sigproc import (SigprocSourceBlock, SigprocSinkBlock, read_sigproc,
                      write_sigproc)
from .fdmt import (FdmtBlock, fdmt, FdmtStageBlock, fdmt_stage,
                   MatchedFilterBlock, matched_filter, ThresholdBlock,
                   threshold)
from .fir import FirBlock, fir
from .binary_io import (BinaryFileReadBlock, BinaryFileWriteBlock,
                        binary_read, binary_write)
from .serialize import (SerializeBlock, DeserializeBlock, serialize,
                        deserialize)
from .wav import WavSourceBlock, WavSinkBlock, read_wav, write_wav
from .convert_visibilities import (ConvertVisibilitiesBlock,
                                   convert_visibilities)

__all__ = ['CopyBlock', 'copy', 'FusedBlock', 'fused', 'BeamformBlock',
           'beamform', 'FftBlock', 'fft', 'DetectBlock', 'detect',
           'ReduceBlock', 'reduce', 'FftShiftBlock', 'fftshift',
           'ReverseBlock', 'reverse', 'ScrunchBlock', 'scrunch',
           'UnpackBlock', 'unpack', 'PrintHeaderBlock', 'print_header',
           'QuantizeBlock', 'quantize',
           'CorrelateBlock', 'CorrelateStageBlock', 'correlate',
           'AccumulateBlock', 'AccumulateStageBlock', 'accumulate',
           'TransposeBlock', 'transpose', 'GuppiRawSourceBlock',
           'read_guppi_raw', 'SigprocSourceBlock',
           'SigprocSinkBlock', 'read_sigproc', 'write_sigproc',
           'FdmtBlock', 'fdmt', 'FdmtStageBlock', 'fdmt_stage',
           'MatchedFilterBlock', 'matched_filter', 'ThresholdBlock',
           'threshold', 'FirBlock', 'fir', 'BinaryFileReadBlock',
           'BinaryFileWriteBlock', 'binary_read', 'binary_write',
           'SerializeBlock', 'DeserializeBlock', 'serialize', 'deserialize',
           'WavSourceBlock', 'WavSinkBlock', 'read_wav', 'write_wav',
           'ConvertVisibilitiesBlock', 'convert_visibilities']
