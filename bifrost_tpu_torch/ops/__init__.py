"""Device ops of the PyTorch/CUDA port.  Modules import torch lazily and
build no kernel at import time."""

from . import fdmt, gpu_kernels, linalg, quantize, transpose

__all__ = ['fdmt', 'gpu_kernels', 'linalg', 'quantize', 'transpose']
