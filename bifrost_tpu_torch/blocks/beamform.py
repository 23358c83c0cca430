"""Coherent beamformer block (the port of ``bifrost_tpu/blocks/beamform.py``;
reference: the bfLinAlgMatMul beamform GEMM, src/linalg.cu:877-904).

The math and metadata live in :class:`bifrost_tpu_torch.stages
.BeamformStage`, so the same code runs standalone here or fused into a
chain (``blocks.fused([BeamformStage, DetectStage, ReduceStage])``,
where the whole-chain K6 substitution applies,
``stages.match_beamformer``).  Under a macro batch K the block runs its
stage on K-gulp spans, so the engine is prewarmed at T and at T * K
frames.  The JAX block's mesh branch (a per-shard prewarm) is not
ported.
"""

from __future__ import annotations

from ..dtype import DataType
from ..stages import BeamformStage
from .fft import _StageBlock

__all__ = ['BeamformBlock', 'beamform']


class BeamformBlock(_StageBlock):
    """Beamform a ['time', 'freq', 'station'[, 'pol']] voltage stream
    against a fixed weight set.  ``accuracy`` declares the class lossy
    candidates must stay inside to race ('f32' | 'bf16' | 'int8');
    ``impl`` / ``BF_BEAM_IMPL`` force one."""

    def __init__(self, iring, weights, accuracy='f32', impl=None,
                 *args, **kwargs):
        super(BeamformBlock, self).__init__(
            iring, BeamformStage(weights, accuracy=accuracy, impl=impl),
            *args, **kwargs)
        #: real ops of the beamform GEMM per gulp of the current sequence
        #: (8 per complex MAC), the GOP/s accounting unit
        self._gemm_ops = 0

    @property
    def engine(self):
        return self._stage.engine

    def on_sequence(self, iseq):
        ohdr = super(BeamformBlock, self).on_sequence(iseq)
        self._prewarm_engine(iseq.header)
        return ohdr

    def _prewarm_engine(self, ihdr):
        """Gate and race the engine's candidates at the shapes on_data
        will present, T and, under a macro batch K, T * K frames
        (``bifrost_tpu/blocks/beamform.py:60-75``), so the winner is
        chosen at sequence start and the probe cost never lands on a
        gulp."""
        from ..macro import resolve_gulp_batch
        t = ihdr['_tensor']
        gulp = self.gulp_nframe or ihdr.get('gulp_nframe')
        if not gulp:
            return
        stage = self._stage
        nfreq = t['shape'][1]
        dt = DataType(t['dtype'])
        int_input = dt.kind == 'ci' and dt.nbits == 8
        npol = stage.npol if stage.mode == 'perpol' else 1
        k = resolve_gulp_batch(self)
        for t_shape in ([int(gulp)] if k <= 1 else
                        [int(gulp), int(gulp) * k]):
            stage.engine.prewarm(t_shape, nfreq, npol=npol,
                                 int_input=int_input)
        self._gemm_ops = stage.engine.ops_per_frame(nfreq, npol) * \
            int(gulp)


def beamform(iring, weights, accuracy='f32', impl=None, *args,
             **kwargs):
    """Block: coherent beamform against ``weights`` through the
    quantized beamformer engine (ops.beamform; candidates gated and
    raced per the declared class)."""
    return BeamformBlock(iring, weights, accuracy, impl, *args,
                         **kwargs)
