"""bifrost_tpu_torch: the PyTorch/CUDA port of bifrost_tpu.

A stream-processing framework for radio astronomy: blocks connected by
ring buffers, one thread per block, device work on an NVIDIA H100
(``cuda`` space: ``torch.Tensor`` in device memory).  This package runs
beside the JAX package ``bifrost_tpu`` and imports nothing of it.  It
carries, so far, what the Guppi spectrometer chain, the quantized
coherent beamformer chain, the FX correlator and FDMT dedispersion
(from a SIGPROC filterbank, and in the FRB search) need, and the rest of
the DSP library (``map`` and ``stages.MapStage``, FIR, Romein gridding,
packed quantize outputs, ``convert_visibilities``, the serialize, binary
and WAV file blocks, the DFT-matmul FFT)::

    source -> copy('cuda') -> fused[FftStage -> DetectStage('stokes')
                                    -> ReduceStage('freq', r)]
           -> copy('system') -> sink

(from a Guppi RAW file, the north star's chain, file to file:
``read_guppi_raw`` -> ``copy('cuda')`` -> ``fused[...]`` ->
``copy('system')`` -> ``views.merge_axes`` -> ``transpose`` ->
``write_sigproc``, built by ``BlockChainer`` in
``examples/gpuspec_simple_torch.py``).

    source -> copy('cuda') -> fused[BeamformStage -> DetectStage('stokes')
                                    -> ReduceStage('time', r)]
           -> copy('system') -> sink

(or ``beamform(...)`` -> ``fused[DetectStage, ReduceStage]`` unfused).

    source -> copy('cuda') -> fft(fine -> freq) -> quantize('ci8')
           -> correlate(R, fusable=True) -> accumulate(A, fusable=True)
           -> convert_visibilities('storage') -> copy('system') -> sink

(or the stateful ``correlate(N)`` integrating across gulps).

    read_sigproc -> copy('cuda') -> transpose(['pol', 'freq', 'time'])
           -> fdmt(max_dm) -> copy('system') -> sink

    source [freq, time] -> copy('cuda') -> fdmt_stage(max_delay)
           -> matched_filter(ntap) -> threshold(thr) -> copy('system')
           -> candidate sink

The device is ``cuda:0`` unless the caller selects another with
:func:`bifrost_tpu_torch.device.set_device` (``set_device('cpu')`` runs
everything on the CPU, with each kernel's plain PyTorch version).
Importing the package touches no device and builds no kernel.
"""

from . import blocks, device, io, ops, parallel, stages, views
from .block_chainer import BlockChainer
from .dtype import DataType
from .pipeline import (Pipeline, BlockScope, Block, SourceBlock,
                       TransformBlock, SinkBlock, block_scope, block_view,
                       get_default_pipeline, PipelineInitError,
                       PipelineRuntimeError)
from .ring import Ring, EndOfDataStop
from .ops.map import map, clear_map_cache, list_map_cache

__version__ = '0.1.0'

__all__ = ['blocks', 'device', 'io', 'ops', 'parallel', 'stages', 'views',
           'BlockChainer', 'DataType', 'Pipeline', 'BlockScope', 'Block',
           'SourceBlock', 'TransformBlock', 'SinkBlock', 'block_scope',
           'block_view', 'get_default_pipeline',
           'PipelineInitError', 'PipelineRuntimeError', 'Ring',
           'EndOfDataStop', 'map', 'clear_map_cache', 'list_map_cache']
