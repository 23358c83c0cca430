"""Blocks of the PyTorch/CUDA port."""

from .copy import CopyBlock, copy
from .fused import FusedBlock, fused
from .beamform import BeamformBlock, beamform

__all__ = ['CopyBlock', 'copy', 'FusedBlock', 'fused', 'BeamformBlock',
           'beamform']
