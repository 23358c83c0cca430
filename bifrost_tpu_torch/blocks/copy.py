"""Space <-> space mover: the host-to-device and device-to-host block
(reference: python/bifrost/blocks/copy.py:45-71; the JAX package's
``bifrost_tpu/blocks/copy.py``).

Both directions ride the transfer engine (:mod:`bifrost_tpu_torch.xfer`):

- host to device: the gulp's device representation is staged once into
  a pinned slot and copied on the engine's H2D stream.  From a pinned
  ``cuda_host`` ring the copy reads the span itself, with no staging
  copy, and the span is held until that copy completes (a released span
  may be overwritten by the writer).
- device to host: the output span is committed as a deferred fill
  (``xfer.HostFill``): the copy runs on the engine's D2H stream, and
  readers of the output ring land the bytes when they first touch them,
  so this block never waits on the transfer.  Into a contiguous span of
  a pinned ``cuda_host`` ring the copy lands directly; into a pageable
  ``system`` ring it lands in a pinned slot, and one host copy moves it
  into the span when the fill completes.

``sync_strict=True`` (scope tunable) or ``BF_SYNC_STRICT=1`` makes every
D2H complete before its span commits.

Under a mesh scope an H2D copy places each gulp per rank
(``xfer.TransferEngine.to_device_sharded``: each rank's frames staged
and copied to its rank's device, or copied straight from a pinned
``cuda_host`` span) and commits the per-rank value, advertised in the
output header's ``_sharding`` so that a mesh block downstream reads it
with no relayout (``bifrost_tpu/blocks/copy.py:66-104``).  A gulp whose
frame count does not divide the mesh lands whole.

A device-to-device copy republishes the same tensor, which is safe
because no block writes into a tensor it has put in a ring.

Macro-gulp execution (:mod:`bifrost_tpu_torch.macro`): a copy that
touches the device is eligible.  An H2D over a span of K whole gulps
stages them with one ``xfer.to_device_batch`` call (one staging copy,
one copy to the card), a D2H drains one deferred fill per K gulps, and
host-to-host copies stay at K = 1.  The tensor an H2D makes is this
ring's alone, so it is committed as owned (a donating consumer may claim
it).
"""

from __future__ import annotations

from copy import deepcopy

import numpy as np

from .. import xfer
from ..devrep import from_device_rep, to_device_plan
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

    def macro_gulp_safe(self):
        return self.irings[0].is_device or self.orings[0].is_device

    def verify_header(self, ihdr):
        """The static verifier's header half (``bifrost_tpu/blocks/
        copy.py:57``): a copy keeps the stream contract; a sharding
        advertisement does not survive it."""
        ohdr = deepcopy(ihdr)
        ohdr.pop('_sharding', None)
        return ohdr

    def on_sequence(self, iseq):
        ohdr = deepcopy(iseq.header)
        self._h2d_taxis = None
        if not self.orings[0].is_device:
            # host rings have no device layout: a D2H copy gathers
            ohdr.pop('_sharding', None)
        if self.mesh is not None and self.orings[0].is_device and \
                not self.irings[0].is_device:
            from ..parallel.scope import sharding_descriptor
            try:
                taxis = ohdr['_tensor']['shape'].index(-1)
            except (KeyError, ValueError):
                taxis = None
            if taxis is not None:
                self._h2d_taxis = taxis
                ohdr['_sharding'] = sharding_descriptor(self.mesh, taxis)
        return ohdr

    def _h2d_sharding(self, ispan, arr):
        """The time sharding of this gulp's device representation
        ``arr``, or None: no mesh, or a frame count that does not divide
        the mesh (the partial tail of a sequence lands whole)."""
        if self._h2d_taxis is None:
            return None
        from ..parallel.scope import time_axis_size, time_sharding
        if ispan.nframe % time_axis_size(self.mesh):
            return None
        return time_sharding(self.mesh, arr.ndim, self._h2d_taxis)

    def _d2h_strict(self):
        """Synchronous D2H required?  The scope's ``sync_strict`` wins;
        else the engine's switch (``BF_SYNC_STRICT`` / ``BF_XFER_ASYNC``)."""
        if self.sync_strict is not None:
            return bool(self.sync_strict)
        return not xfer.async_enabled()

    def _h2d(self, ispan):
        buf = ispan.data.as_numpy()
        arr, post = to_device_plan(buf, ispan.dtype)
        eng = xfer.engine()
        sharding = self._h2d_sharding(ispan, arr)
        if sharding is not None:
            return self._h2d_sharded(ispan, buf, arr, post, sharding)
        if ispan.ring._storage.pinned and arr.flags.c_contiguous and \
                np.may_share_memory(arr, buf):
            t, ev = eng.to_device_direct(arr)
            ispan.hold(ev)
        elif self._macro_gulps(ispan) > 1:
            # K whole gulps of a macro span: one staging pass, one copy
            t = eng.to_device_batch(np.split(arr, self._macro_gulps(ispan))
                                    ).reshape(arr.shape)
        else:
            t = eng.to_device(arr)
        return t if post is None else post(t)

    def _h2d_sharded(self, ispan, buf, arr, post, sharding):
        """The per-rank placement of one gulp (or macro span): straight
        from a pinned span whose frame axis leads, else staged per rank;
        a packed type is unpacked per rank on the device."""
        eng = xfer.engine()
        direct = ispan.ring._storage.pinned and arr.flags.c_contiguous \
            and np.may_share_memory(arr, buf) and self._h2d_taxis == 0
        if direct:
            out, events = eng.to_device_sharded(arr, sharding, direct=True)
            for ev in events:
                ispan.hold(ev)
        else:
            out = eng.to_device_sharded(arr, sharding)
        if post is not None:
            from ..parallel.scope import ShardedTensor
            out = ShardedTensor([post(t) for t in out.shards], out.mesh,
                                out.taxis)
        return out

    def _macro_gulps(self, ispan):
        """The whole gulps K of a macro span whose frame axis leads (no
        ringlet axis before it), else 1."""
        g = self._macro_gulp_in
        if self._gulp_batch_active <= 1 or not g or \
                ispan.tensor['ringlet_shape'] or ispan.nframe % g:
            return 1
        return ispan.nframe // g

    def on_data(self, ispan, ospan):
        idev = ispan.ring.is_device
        odev = ospan.ring.is_device
        if odev and not idev:
            ospan.set(self._h2d(ispan), owned=True)
        elif idev and not odev:
            out = ospan.data.as_numpy()
            if self._d2h_strict():
                from_device_rep(ispan.data, ospan.dtype, out)
            else:
                ospan.set_fill(xfer.engine().host_fill(ispan.data,
                                                       ospan.dtype, out))
        elif idev and odev:
            ospan.set(ispan.data)
        else:
            copy_array(ospan.data, ispan.data)


def copy(iring, space=None, *args, **kwargs):
    """Block: copy data, possibly to another space."""
    return CopyBlock(iring, space, *args, **kwargs)
