"""FIR filter block with decimation and inter-gulp state (the port of
``bifrost_tpu/blocks/fir.py``).

The reference exposes FIR as a plan op (src/fir.cu, python/bifrost/fir.py)
used directly by observatory pipelines; this block packages it with the
pipeline's streaming semantics: state carries across gulps inside the
plan (:class:`bifrost_tpu_torch.ops.fir.Fir`), so no input overlap is
needed.  Complex-integer input becomes cf32 and integer input f32.
"""

from __future__ import annotations

from copy import deepcopy

from ..ops.fir import Fir
from ..pipeline import TransformBlock

__all__ = ['FirBlock', 'fir']


class FirBlock(TransformBlock):
    def __init__(self, iring, coeffs, decim=1, *args, **kwargs):
        super(FirBlock, self).__init__(iring, *args, **kwargs)
        self._coeffs = coeffs
        self._decim = int(decim)
        self.fir = Fir()

    def define_valid_input_spaces(self):
        return ('cuda',)

    def define_output_nframes(self, input_nframe):
        # ceil: the final partial gulp still emits its decimated frames
        # (full gulps are validated to divide in on_sequence, so the
        # decimation phase stays aligned across gulps)
        return -(-input_nframe // self._decim)

    def on_sequence(self, iseq):
        gulp = self.gulp_nframe or iseq.header['gulp_nframe']
        if gulp % self._decim:
            raise ValueError("Decimation factor (%d) does not divide "
                             "gulp_nframe (%d)" % (self._decim, gulp))
        self.fir.init(self._coeffs, decim=self._decim, space='cuda',
                      mesh=self.mesh)
        ohdr = deepcopy(iseq.header)
        t = ohdr['_tensor']
        taxis = t['shape'].index(-1)
        t['scales'][taxis][1] *= self._decim
        itype = t['dtype']
        if itype.startswith(('i', 'u', 'ci')):
            t['dtype'] = 'cf32' if itype.startswith('ci') else 'f32'
        return ohdr

    def on_data(self, ispan, ospan):
        from ..ops.common import complexify
        x = complexify(ispan.data, ispan.tensor['dtype'])
        ospan.set(self.fir.execute(x))


def fir(iring, coeffs, decim=1, *args, **kwargs):
    """Block: multi-tap FIR filter along time with optional decimation."""
    return FirBlock(iring, coeffs, decim, *args, **kwargs)
