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
Host <-> device transfers go through the transfer engine
(:mod:`bifrost_tpu_torch.xfer`: pinned staging, copy streams, deferred
ring fills), which reports into :mod:`bifrost_tpu_torch.telemetry`; the
ring and transfer seams of :mod:`bifrost_tpu_torch.testing.faults` and
the ``BF_TRACE`` scopes of :mod:`bifrost_tpu_torch.trace` sit beside it.
``Pipeline(gulp_batch=K)`` runs eligible blocks on K-gulp spans
(:mod:`bifrost_tpu_torch.macro`), ``Pipeline(segments='auto')`` fuses
chains of stage blocks into one call each
(:mod:`bifrost_tpu_torch.segments`), and ``donate=True`` lets stage
blocks take their input chunks out of the ring.
``Pipeline.run(autotune=True)`` (or ``BF_AUTOTUNE``) retunes those
knobs while the pipeline runs (:mod:`bifrost_tpu_torch.autotune`), and
``BF_FLEET_COLLECTOR`` streams the process's telemetry to a fleet
collector (:mod:`bifrost_tpu_torch.telemetry.fleet`).
Importing the package touches no device and builds no kernel.
"""

from . import (affinity, autotune, blocks, device, io, macro, memory, ops,
               parallel, proclog, segments, stages, supervision, telemetry,
               testing, trace, views, xfer)
from .block_chainer import BlockChainer
from .dtype import DataType
from .space import Space, SPACES
from .ndarray import (ndarray, asarray, empty, zeros, empty_like, zeros_like,
                      copy_array, memset_array)
from .ring import (Ring, EndOfDataStop, WouldBlock, RingPoisonedError,
                   split_shape, ring_view)
from .pipeline import (Pipeline, BlockScope, Block, SourceBlock,
                       MultiTransformBlock, TransformBlock, SinkBlock,
                       block_scope, block_view, get_default_pipeline,
                       get_current_block_scope, PipelineInitError,
                       PipelineRuntimeError, PipelineStallError)
from .ops.map import map, clear_map_cache, list_map_cache
from .ops.reduce import reduce
from .ops.transpose import transpose
from .ops.quantize import quantize, unpack
from .io import udp_socket
from .io.udp_socket import Address as address
from .utils import EnvVars, ObjectCache
from .header_standard import enforce_header_standard

__version__ = '0.1.0'

__all__ = ['affinity', 'autotune', 'blocks', 'device', 'io', 'macro',
           'memory', 'ops', 'parallel', 'proclog', 'segments', 'stages',
           'supervision', 'telemetry', 'testing', 'trace', 'views', 'xfer',
           'BlockChainer', 'DataType', 'Space', 'SPACES',
           'ndarray', 'asarray', 'empty', 'zeros', 'empty_like',
           'zeros_like', 'copy_array', 'memset_array',
           'Ring', 'EndOfDataStop', 'WouldBlock', 'RingPoisonedError',
           'split_shape', 'ring_view',
           'Pipeline', 'BlockScope', 'Block', 'SourceBlock',
           'MultiTransformBlock', 'TransformBlock', 'SinkBlock',
           'block_scope', 'block_view', 'get_default_pipeline',
           'get_current_block_scope', 'PipelineInitError',
           'PipelineRuntimeError', 'PipelineStallError',
           'map', 'clear_map_cache', 'list_map_cache', 'reduce',
           'transpose', 'quantize', 'unpack', 'udp_socket', 'address',
           'EnvVars', 'ObjectCache', 'enforce_header_standard']
