"""The FFT block and the single-stage device block (the port of
``bifrost_tpu/blocks/fft.py``; reference: blocks/fft.py:39-177).

A :class:`_StageBlock` runs one stage of ``bifrost_tpu_torch.stages`` as
a TransformBlock on the ``cuda`` space: the stage negotiates the header
once per sequence and builds one function per gulp shape; a stage's
lookahead (``overlap_nframe``) becomes the block's input overlap, so
successive spans share that many frames and the block commits the rest.
:class:`FftBlock` is the FFT stage as such a block (c2c forward or
inverse, r2c, c2r, optionally shifted; the FX correlator's F step).

A stage block is macro-gulp eligible when its stage is time-concat
equivariant (``Stage.batch_safe``): its plan for the K-gulp shape takes
the stacked span in one call, and with a lookahead the span carries the
overlap once (the halo carry).  Under ``donate`` it claims its input
chunk out of the ring (``TransformBlock._take_donatable``) and drops it
once the stage has read it.  Mesh sharding of the stage blocks is not
ported (the JAX block's GSPMD plans).
"""

from __future__ import annotations

from ..dtype import DataType
from ..pipeline import TransformBlock
from ..stages import FftStage

__all__ = ['_StageBlock', 'FftBlock', 'fft']


class _StageBlock(TransformBlock):
    """TransformBlock driven by a single Stage."""

    _profile_eligible = True

    def __init__(self, iring, stage, *args, **kwargs):
        super(_StageBlock, self).__init__(iring, *args, **kwargs)
        self._stage = stage
        #: (shape, dtype, donate) -> the stage's function for that shape
        self._plans = {}

    def define_valid_input_spaces(self):
        return ('cuda',)

    def macro_gulp_safe(self):
        """Eligible when the stage is time-concat equivariant: the plan
        for the K-gulp shape then takes the stacked span as one gulp."""
        return bool(getattr(self._stage, 'batch_safe', False))

    def macro_overlap_safe(self):
        """The halo carry: an equivariant stage with a lookahead batches
        too, its span K * stride + overlap frames and the trailing ghost
        frames uncommitted."""
        return self.macro_gulp_safe()

    def define_input_overlap_nframe(self, iseq):
        """The stage's lookahead (``Stage.overlap_nframe``) as the ring
        overlap between successive input spans."""
        return int(getattr(self._stage, 'overlap_nframe', 0) or 0)

    def verify_header(self, ihdr):
        """The pure header half that the static verifier propagates
        through (``bifrost_tpu/blocks/fft.py:55``): the stage's
        ``transform_header``, so a contract break shows before gulp 0."""
        return self._stage.transform_header(ihdr)

    def on_sequence(self, iseq):
        self._ihdr = iseq.header
        self._plans = {}
        self._donate_on = None
        return self._stage.transform_header(iseq.header)

    def define_output_nframes(self, input_nframe):
        return self._stage.output_nframe(input_nframe)

    def _plan_for(self, x, donate=False):
        key = (tuple(x.shape), x.dtype, bool(donate))
        fn = self._plans.get(key)
        if fn is None:
            idt = DataType(self._ihdr['_tensor']['dtype'])
            fn = self._plans[key] = self._stage.build(
                {'shape': list(x.shape), 'dtype': idt,
                 'reim': idt.kind == 'ci'})
        return fn

    def on_data(self, ispan, ospan):
        x = self._take_donatable(ispan)
        donate = x is not None
        if not donate:
            x = ispan.data
        # a donated chunk's last reference is ``x``: it goes when this
        # call returns, after the stage has queued its work on it
        ospan.set(self._plan_for(x, donate)(x), owned=True)


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
