"""FX-correlator X step: cross-multiply stations, integrate in time (the
port of ``bifrost_tpu/blocks/correlate.py``; reference:
python/bifrost/blocks/correlate.py:36-108, backed by the xGPU-style cherk
kernel in src/linalg.cu:210-226).

Per channel, x x^H runs through the raced X engine
(:class:`bifrost_tpu_torch.ops.linalg.XEngine`): ci8 voltages stay int8 on
exact int32 candidates (K7 among them on the card), float voltages race
the planar forms against the complex64 baseline, all gated per the
declared accuracy class.  The output matrix is fully filled (header
``matrix_fill_mode='full'``).

Two block forms:

- :class:`CorrelateBlock`, stateful: integrates ``nframe_per_integration``
  frames across gulps, one output frame per integration;
- :class:`CorrelateStageBlock`, stage-backed
  (:class:`bifrost_tpu_torch.stages.CorrelateStage`): integrates whole
  groups within each gulp.

Left out: the JAX block's mesh plans (``_cross_block``,
``_corner_turn_mode``, ``_mesh_geometry``, ``_select_mesh_plan``,
``_build_mesh``), which wait for the multi-GPU item, and its segment
protocol (``_collective_boundary``).
"""

from __future__ import annotations

from copy import deepcopy

from ..dtype import DataType
from ..pipeline import TransformBlock
from ..stages import CorrelateStage
from .fft import _StageBlock

__all__ = ['CorrelateBlock', 'CorrelateStageBlock', 'correlate']


def _int_input(itensor):
    dt = DataType(itensor['dtype'])
    return dt.kind == 'ci' and dt.nbits == 8


class CorrelateBlock(TransformBlock):
    def __init__(self, iring, nframe_per_integration, accuracy='f32',
                 impl=None, *args, **kwargs):
        super(CorrelateBlock, self).__init__(iring, *args, **kwargs)
        from ..ops.linalg import XEngine
        self.nframe_per_integration = nframe_per_integration
        self.engine = XEngine(accuracy=accuracy, impl=impl)
        self.accuracy = self.engine.accuracy
        #: real ops of the correlation product per gulp of the current
        #: sequence (8 per complex MAC), the GOP/s accounting unit
        self._gemm_ops = 0

    def define_valid_input_spaces(self):
        return ('cuda',)

    def define_output_nframes(self, input_nframe):
        return 1

    def on_sequence(self, iseq):
        self.nframe_integrated = 0
        self._acc = None
        ihdr = iseq.header
        itensor = ihdr['_tensor']
        if itensor['labels'] != ['time', 'freq', 'station', 'pol']:
            raise ValueError("correlate requires ['time', 'freq', "
                             "'station', 'pol'] input labels, got %r"
                             % (itensor['labels'],))
        ohdr = deepcopy(ihdr)
        otensor = ohdr['_tensor']
        otensor['dtype'] = 'cf32'
        for key in ('shape', 'labels', 'scales', 'units'):
            # deep-copy the per-axis entries so the doubled station/pol
            # axes alias neither each other nor the input header
            tv, fv, sv, pv = (deepcopy(v) for v in itensor[key])
            otensor[key] = [tv, fv, sv, pv,
                            deepcopy(sv) if key != 'labels' else sv + '_j',
                            deepcopy(pv) if key != 'labels' else pv + '_j']
        otensor['labels'][2] += '_i'
        otensor['labels'][3] += '_i'
        otensor['scales'][0][1] *= self.nframe_per_integration
        ohdr['matrix_fill_mode'] = 'full'
        # the engine reads gulps of the input header's gulp_nframe (or
        # this block's override); that is what must divide the integration
        gulp_actual = self.gulp_nframe or ihdr['gulp_nframe']
        if self.nframe_per_integration % gulp_actual != 0:
            raise ValueError(
                "gulp_nframe (%d) does not divide nframe_per_integration "
                "(%d)" % (gulp_actual, self.nframe_per_integration))
        ohdr['gulp_nframe'] = min(ihdr['gulp_nframe'],
                                  self.nframe_per_integration)
        # choose the engine's candidate now, so the probe cost never
        # lands on the first gulp
        _, f, s, p = itensor['shape'][:4]
        self.engine.prewarm(gulp_actual, f, s * p,
                            int_input=_int_input(itensor))
        self._gemm_ops = 8 * gulp_actual * f * (s * p) ** 2
        return ohdr

    def on_data(self, ispan, ospan):
        import torch
        x = ispan.data
        if ispan.dtype.kind == 'ci' and not x.is_complex():
            t, f, s, p = x.shape[:4]
            re = x[..., 0].reshape(t, f, s * p)
            im = x[..., 1].reshape(t, f, s * p)
        else:
            t, f, s, p = x.shape
            xm = x.reshape(t, f, s * p)
            re, im = xm.real, xm.imag
        vis = self.engine(re, im).reshape(f, s, p, s, p)
        if self._acc is None:
            self._acc = vis
        else:
            # in place: the sum is this block's own until it is published
            self._acc += vis
        self.nframe_integrated += ispan.nframe
        if self.nframe_integrated > self.nframe_per_integration:
            raise ValueError("correlate: %d frames integrated, more than "
                             "the %d of an integration"
                             % (self.nframe_integrated,
                                self.nframe_per_integration))
        if self.nframe_integrated == self.nframe_per_integration:
            self.nframe_integrated = 0
            out = self._acc[None]    # add the time axis
            self._acc = None
            ospan.set(out.to(torch.complex64))
            return 1
        return 0


class CorrelateStageBlock(_StageBlock):
    """Stage-backed X step (:class:`bifrost_tpu_torch.stages
    .CorrelateStage`): one visibility per ``nframe_per_vis`` frames
    within each gulp."""

    def __init__(self, iring, nframe_per_vis, accuracy='f32',
                 impl=None, *args, **kwargs):
        super(CorrelateStageBlock, self).__init__(
            iring, CorrelateStage(nframe_per_vis, accuracy=accuracy,
                                  impl=impl), *args, **kwargs)
        self._gemm_ops = 0

    @property
    def engine(self):
        return self._stage.engine

    def on_sequence(self, iseq):
        ohdr = super(CorrelateStageBlock, self).on_sequence(iseq)
        # prewarm at the per-group shape (r, f, n): the engine chooses by
        # that shape whatever the number of groups in a gulp
        itensor = iseq.header['_tensor']
        _, f, s, p = itensor['shape'][:4]
        self._stage.engine.prewarm(self._stage.nframe_per_vis, f, s * p,
                                   int_input=_int_input(itensor))
        gulp_actual = self.gulp_nframe or iseq.header['gulp_nframe']
        self._gemm_ops = 8 * gulp_actual * f * (s * p) ** 2
        return ohdr


def correlate(iring, nframe_per_integration, accuracy='f32', impl=None,
              fusable=False, *args, **kwargs):
    """Block: the X step of an FX correlator (reference docstring:
    blocks/correlate.py:106-136; xGPU reference arXiv:1107.4264).

    ``accuracy`` / ``impl`` configure the raced X engine
    (ops.linalg.XEngine).  ``fusable=True`` returns the stage-backed
    :class:`CorrelateStageBlock` (integration within each gulp); the
    default is the stateful :class:`CorrelateBlock` (integration across
    gulps)."""
    if fusable:
        return CorrelateStageBlock(iring, nframe_per_integration,
                                   accuracy, impl, *args, **kwargs)
    return CorrelateBlock(iring, nframe_per_integration, accuracy,
                          impl, *args, **kwargs)
