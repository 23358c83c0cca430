"""The FFT block and the single-stage device block (the port of
``bifrost_tpu/blocks/fft.py``; reference: blocks/fft.py:39-177).

A :class:`_StageBlock` runs one stage of ``bifrost_tpu_torch.stages`` as
a TransformBlock on the ``cuda`` space: the stage negotiates the header
once per sequence and builds one function per gulp shape; a stage's
lookahead (``overlap_nframe``) becomes the block's input overlap, so
successive spans share that many frames and the block commits the rest.
:class:`FftBlock` is the FFT stage as such a block (c2c forward or
inverse, r2c, c2r, optionally shifted; the FX correlator's F step).
Left out of this port: buffer donation, macro-gulp batching and mesh
sharding, which the port's pipeline does not have yet.
"""

from __future__ import annotations

from ..dtype import DataType
from ..pipeline import TransformBlock
from ..stages import FftStage

__all__ = ['_StageBlock', 'FftBlock', 'fft']


class _StageBlock(TransformBlock):
    """TransformBlock driven by a single Stage."""

    def __init__(self, iring, stage, *args, **kwargs):
        super(_StageBlock, self).__init__(iring, *args, **kwargs)
        self._stage = stage
        self._plans = {}   # (shape, dtype) -> the stage's gulp function

    def define_valid_input_spaces(self):
        return ('cuda',)

    def define_input_overlap_nframe(self, iseq):
        """The stage's lookahead (``Stage.overlap_nframe``) as the ring
        overlap between successive input spans."""
        return int(getattr(self._stage, 'overlap_nframe', 0) or 0)

    def on_sequence(self, iseq):
        self._ihdr = iseq.header
        self._plans = {}
        return self._stage.transform_header(iseq.header)

    def define_output_nframes(self, input_nframe):
        return self._stage.output_nframe(input_nframe)

    def _plan_for(self, x):
        key = (tuple(x.shape), x.dtype)
        fn = self._plans.get(key)
        if fn is None:
            idt = DataType(self._ihdr['_tensor']['dtype'])
            fn = self._plans[key] = self._stage.build(
                {'shape': list(x.shape), 'dtype': idt,
                 'reim': idt.kind == 'ci'})
        return fn

    def on_data(self, ispan, ospan):
        x = ispan.data
        ospan.set(self._plan_for(x)(x))


class FftBlock(_StageBlock):
    def __init__(self, iring, axes, inverse=False, real_output=False,
                 axis_labels=None, apply_fftshift=False, *args, **kwargs):
        super(FftBlock, self).__init__(
            iring, FftStage(axes, inverse, real_output, axis_labels,
                            apply_fftshift), *args, **kwargs)


def fft(iring, axes, inverse=False, real_output=False, axis_labels=None,
        apply_fftshift=False, *args, **kwargs):
    """Block: N-D FFT over any non-frame axes (reference docstring:
    blocks/fft.py:146-177)."""
    return FftBlock(iring, axes, inverse, real_output, axis_labels,
                    apply_fftshift, *args, **kwargs)
