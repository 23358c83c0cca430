"""Pipeline <-> mesh glue: how ``BlockScope(mesh=...)`` becomes sharded
execution inside blocks (the part of ``bifrost_tpu/parallel/scope.py``
that the ported blocks read).

A block under a mesh scope runs its gulp function as one body per rank
over the mesh (:func:`bifrost_tpu_torch.parallel.ops.shard_map`), with the
gulp's frame (time) axis split over the mesh's time axis.

Axis-name conventions: the *time* axis of a mesh is ``'sp'`` if present,
else the first axis; the *station* axis is ``'tp'`` if present.

Left out until a later slice: the GSPMD plans (``frame_local_plan``),
the sharding descriptors of ring headers and the HLO collective stats
(the port counts collective calls in ``parallel.ops.collectives``).
"""

from __future__ import annotations

__all__ = ['time_axis_name', 'station_axis_name', 'time_axis_size',
           'shardable_nframe', 'shard_gulp', 'gather_local']


def time_axis_name(mesh):
    """The mesh axis that gulp frame/time axes shard over."""
    return 'sp' if 'sp' in mesh.axis_names else mesh.axis_names[0]


def station_axis_name(mesh):
    """The mesh axis for antenna/station sharding, or None."""
    return 'tp' if 'tp' in mesh.axis_names else None


def time_axis_size(mesh):
    return mesh.shape[time_axis_name(mesh)]


def shardable_nframe(mesh, nframe):
    """Whether a gulp of ``nframe`` frames divides over the time axis."""
    return nframe % time_axis_size(mesh) == 0


def shard_gulp(x, mesh, taxis):
    """Lay a gulp tensor out over the mesh, frame axis ``taxis`` split
    over the time axis: the per-rank list of blocks (views where the
    rank's device holds ``x``).  When the frame axis does not divide the
    mesh the gulp stays as it is and is returned unchanged, as in the JAX
    package."""
    from .ops import P, shard
    if x.shape[taxis] % time_axis_size(mesh):
        return x
    spec = [None] * x.dim()
    spec[taxis] = time_axis_name(mesh)
    return shard(x, mesh, P(*spec))


def gather_local(x):
    """Bring a tensor back to this process's device.  Blocks need this
    when they fall back from the sharded to the unsharded build
    mid-sequence (e.g. a partial final gulp) while carrying state that a
    mesh plan put on another card."""
    from ..device import get_device
    dev = get_device()
    return x if x.device == dev else x.to(dev)
