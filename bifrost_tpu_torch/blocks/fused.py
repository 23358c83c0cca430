"""FusedBlock: run a chain of device stages as one function per gulp.

The JAX package jits the composed chain into one XLA program per gulp
shape.  The port composes the same stages with
:func:`bifrost_tpu_torch.stages.compose_stages`, which substitutes the
hand-written whole-chain kernel where the chain matches it (the Guppi
spectrometer: FFT -> Stokes -> frequency reduce as one CUDA kernel), and
keeps one plan per gulp shape.  Macro-gulp batching, mesh placement and
buffer donation are not part of this block yet.
"""

from __future__ import annotations

from ..pipeline import TransformBlock
from ..proclog import ProcLog

__all__ = ['FusedBlock', 'fused']


class FusedBlock(TransformBlock):
    def __init__(self, iring, stages, *args, substitute=True, **kwargs):
        super(FusedBlock, self).__init__(iring, *args, **kwargs)
        self.stages = list(stages)
        self.substitute = substitute
        self._plans = {}        # (shape, dtype) -> (fn, info)
        #: configuration of the plan that ran last, published to the
        #: ``<name>/impl`` proclog so benchmarks read what ran
        self.impl_info = None
        self._impl_proclog = ProcLog(self.name + '/impl')

    def define_valid_input_spaces(self):
        return ('cuda',)

    def on_sequence(self, iseq):
        from ..stages import walk_headers
        self._headers = walk_headers(self.stages, iseq.header)
        self._plans = {}
        return self._headers[-1]

    def define_output_nframes(self, input_nframe):
        n = input_nframe
        for stage in self.stages:
            n = stage.output_nframe(n)
        return n

    def _plan(self, x):
        key = (tuple(x.shape), x.dtype)
        plan = self._plans.get(key)
        if plan is None:
            from ..stages import compose_stages
            plan = compose_stages(self.stages, self._headers, x.shape,
                                  x.dtype, substitute=self.substitute)
            self._plans[key] = plan
        if plan[1] != self.impl_info:
            self.impl_info = dict(plan[1])
            self._impl_proclog.update(self.impl_info, force=True)
        return plan[0]

    def on_data(self, ispan, ospan):
        x = ispan.data
        ospan.set(self._plan(x)(x))


def fused(iring, stages, *args, **kwargs):
    """Block: run ``stages`` (see bifrost_tpu_torch.stages) as one
    composed function per gulp."""
    return FusedBlock(iring, stages, *args, **kwargs)
