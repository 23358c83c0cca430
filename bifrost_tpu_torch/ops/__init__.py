"""Device ops of the PyTorch/CUDA port.  Modules import torch lazily and
build no kernel at import time."""

from . import gpu_kernels, linalg, quantize

__all__ = ['gpu_kernels', 'linalg', 'quantize']
