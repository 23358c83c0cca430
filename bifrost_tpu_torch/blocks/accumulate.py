"""Integrate gulps: b = b + a, committing every ``nframe`` inputs (the
port of ``bifrost_tpu/blocks/accumulate.py``; reference:
python/bifrost/blocks/accumulate.py:41-74).

:class:`AccumulateBlock` carries the sum in the block across gulps of one
frame each (a tensor on the ``cuda`` space, a numpy array on a host
ring); the output span is published only on the commit gulp.
:class:`AccumulateStageBlock` (``accumulate(..., fusable=True)``) is the
stateless form: it sums ``nframe``-frame groups within each gulp
(:class:`bifrost_tpu_torch.stages.AccumulateStage`), the FX correlator's
visibility integrator.
"""

from __future__ import annotations

from copy import deepcopy

from ..dtype import DataType
from ..pipeline import TransformBlock
from ..stages import AccumulateStage, _complexify_fn
from .fft import _StageBlock

__all__ = ['AccumulateBlock', 'AccumulateStageBlock', 'accumulate']


class AccumulateBlock(TransformBlock):
    def __init__(self, iring, nframe, dtype=None, gulp_nframe=1,
                 *args, **kwargs):
        if gulp_nframe != 1:
            raise ValueError("accumulate integrates one frame per gulp, "
                             "got gulp_nframe=%r" % (gulp_nframe,))
        super(AccumulateBlock, self).__init__(iring, gulp_nframe=1,
                                              *args, **kwargs)
        self.nframe = nframe
        self.dtype = dtype

    def define_valid_input_spaces(self):
        return ('cuda', 'system')

    def on_sequence(self, iseq):
        ihdr = iseq.header
        ohdr = deepcopy(ihdr)
        otensor = ohdr['_tensor']
        if 'scales' in otensor:
            frame_axis = otensor['shape'].index(-1)
            otensor['scales'][frame_axis][1] *= self.nframe
        if self.dtype is not None:
            otensor['dtype'] = str(self.dtype)
        self.frame_count = 0
        self._acc = None
        self.otype = DataType(otensor['dtype'])
        return ohdr

    def on_data(self, ispan, ospan):
        device = ispan.ring.is_device
        if device:
            x = _complexify_fn({'reim': ispan.dtype.kind == 'ci'})(ispan.data)
            x = x.to(self.otype.as_torch_dtype())
            if self.frame_count == 0 or self._acc is None:
                self._acc = x.clone()
            else:
                self._acc += x
        else:
            x = ispan.data.as_numpy()
            odt = self.otype.as_numpy_dtype()
            if self.frame_count == 0 or self._acc is None:
                self._acc = x.astype(odt) if odt.names is None else x.copy()
            else:
                self._acc = self._acc + x
        self.frame_count += 1
        if self.frame_count == self.nframe:
            if device:
                ospan.set(self._acc)
            else:
                ospan.data.as_numpy()[...] = self._acc
            self._acc = None
            self.frame_count = 0
            return 1
        return 0


class AccumulateStageBlock(_StageBlock):
    """Stage-backed integrator: sums ``nframe``-frame groups within each
    gulp (``nframe`` must divide the gulp)."""

    def __init__(self, iring, nframe, op='sum', *args, **kwargs):
        super(AccumulateStageBlock, self).__init__(
            iring, AccumulateStage(nframe, op=op), *args, **kwargs)


def accumulate(iring, nframe, dtype=None, fusable=False, *args,
               **kwargs):
    """Block: accumulate ``nframe`` frames before outputting one.
    ``fusable=True`` returns the stage-backed in-gulp integrator
    (:class:`AccumulateStageBlock`; ``dtype`` must be None: the stage
    keeps the input dtype)."""
    if fusable:
        if dtype is not None:
            raise ValueError('fusable accumulate keeps the input dtype')
        return AccumulateStageBlock(iring, nframe, *args, **kwargs)
    return AccumulateBlock(iring, nframe, dtype, *args, **kwargs)
