"""Space <-> space mover: the host-to-device and device-to-host block
(reference: python/bifrost/blocks/copy.py:45-71).

Host to device stages the gulp through pinned memory and copies it with
a ``non_blocking`` transfer (:func:`bifrost_tpu_torch.xfer.to_device`).
Device to host copies into pinned memory and waits on the copy's event
before the host ring commits the span (:func:`xfer.to_host`): the bytes
a downstream reader sees are complete.  A device-to-device copy
republishes the same tensor, which is safe because no block writes into
a tensor it has put in a ring.
"""

from __future__ import annotations

from copy import deepcopy

from ..devrep import to_device_rep, from_device_rep
from ..ndarray import copy_array
from ..pipeline import TransformBlock

__all__ = ['CopyBlock', 'copy']


class CopyBlock(TransformBlock):
    """Copy data, possibly between spaces."""

    def __init__(self, iring, space=None, *args, **kwargs):
        super(CopyBlock, self).__init__(iring, *args, **kwargs)
        if space is None:
            space = self.irings[0].space
        self.orings = [self.create_ring(space=space)]

    def on_sequence(self, iseq):
        return deepcopy(iseq.header)

    def on_data(self, ispan, ospan):
        idev = ispan.ring.is_device
        odev = ospan.ring.is_device
        if odev and not idev:
            ospan.set(to_device_rep(ispan.data.as_numpy(), ispan.dtype))
        elif idev and not odev:
            from_device_rep(ispan.data, ospan.dtype, ospan.data.as_numpy())
        elif idev and odev:
            ospan.set(ispan.data)
        else:
            copy_array(ospan.data, ispan.data)


def copy(iring, space=None, *args, **kwargs):
    """Block: copy data, possibly to another space."""
    return CopyBlock(iring, space, *args, **kwargs)
