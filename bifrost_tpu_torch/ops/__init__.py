"""Device ops of the PyTorch/CUDA port.  Modules import torch lazily and
build no kernel at import time."""

from . import (common, fdmt, fft, gpu_kernels, linalg, quantize, reduce,
               transpose)

__all__ = ['common', 'fdmt', 'fft', 'gpu_kernels', 'linalg', 'quantize',
           'reduce', 'transpose']
