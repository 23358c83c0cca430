"""Unpack block: packed sub-byte / complex-integer data -> a wider type
(reference: python/bifrost/blocks/unpack.py; the port of
``bifrost_tpu/blocks/unpack.py``).

On a ``cuda`` ring the input is already in its device representation
(packed types unpacked by the H2D copy), so the block only widens it:
complex integers keep their (re, im) pairs at the new component width,
complex floats become complex64, real types are cast.  On a host ring
it runs :func:`bifrost_tpu_torch.ops.quantize.unpack`.
"""

from __future__ import annotations

from copy import deepcopy

from ..dtype import DataType
from ..ops.common import complexify
from ..ops.quantize import unpack as unpack_op
from ..pipeline import TransformBlock

__all__ = ['UnpackBlock', 'unpack']


class UnpackBlock(TransformBlock):
    def __init__(self, iring, dtype, *args, **kwargs):
        super(UnpackBlock, self).__init__(iring, *args, **kwargs)
        self.dtype = DataType(dtype)

    def on_sequence(self, iseq):
        ohdr = deepcopy(iseq.header)
        ohdr['_tensor']['dtype'] = str(self.dtype)
        return ohdr

    def on_data(self, ispan, ospan):
        if ispan.ring.is_device:
            x = ispan.data
            dt = self.dtype
            if dt.kind == 'cf':
                ospan.set(complexify(x, ispan.dtype).to(
                    dt.as_torch_dtype()))
            else:
                ospan.set(x.to(dt.as_torch_dtype()))
        else:
            unpack_op(ispan.data, ospan.data)


def unpack(iring, dtype, *args, **kwargs):
    """Block: unpack packed data to a wider dtype."""
    return UnpackBlock(iring, dtype, *args, **kwargs)
