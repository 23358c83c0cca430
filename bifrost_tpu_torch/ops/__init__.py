"""Device ops of the PyTorch/CUDA port.  Modules import torch lazily and
build no kernel at import time."""

from . import (common, fdmt, fft, fir, gpu_kernels, linalg, map, map_lang,
               quantize, reduce, romein, transpose)
from .fft import Fft, dft_matmul_fft
from .fir import Fir
from .linalg import LinAlg, matmul
from .map import map_compute, clear_map_cache, list_map_cache, MapSyntaxError
from .quantize import quantize_tensor, unpack
from .romein import Romein

__all__ = ['common', 'fdmt', 'fft', 'fir', 'gpu_kernels', 'linalg', 'map',
           'map_lang', 'quantize', 'reduce', 'romein', 'transpose', 'Fft',
           'dft_matmul_fft', 'Fir', 'LinAlg', 'matmul', 'map_compute',
           'clear_map_cache', 'list_map_cache', 'MapSyntaxError',
           'quantize_tensor', 'unpack', 'Romein']
