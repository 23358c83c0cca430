"""Blocks of the PyTorch/CUDA port."""

from .copy import CopyBlock, copy
from .fused import FusedBlock, fused

__all__ = ['CopyBlock', 'copy', 'FusedBlock', 'fused']
