"""Pipeline <-> mesh glue: how ``BlockScope(mesh=...)`` becomes sharded
execution inside blocks (the part of ``bifrost_tpu/parallel/scope.py``
that the ported blocks read).

A block under a mesh scope runs its gulp function as one body per rank
over the mesh (:func:`bifrost_tpu_torch.parallel.ops.shard_map`), with the
gulp's frame (time) axis split over the mesh's time axis.

Axis-name conventions: the *time* axis of a mesh is ``'sp'`` if present,
else the first axis; the *station* axis is ``'tp'`` if present.

The header sharding descriptors (:func:`sharding_descriptor`,
:func:`meshes_equivalent`, :func:`descriptor_matches`,
:func:`check_descriptor`, ``bifrost_tpu/parallel/scope.py:88-153``) are
what the static verifier reads for its mesh checks (BF-W140 / BF-W141).

Left out until a later slice: the GSPMD plans (``frame_local_plan``) and
the HLO collective stats (the port counts collective calls in
``parallel.ops.collectives``).
"""

from __future__ import annotations

__all__ = ['time_axis_name', 'station_axis_name', 'time_axis_size',
           'shardable_nframe', 'shard_gulp', 'gather_local',
           'sharding_descriptor', 'meshes_equivalent',
           'descriptor_matches', 'check_descriptor']


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


def _axes(mesh):
    return {str(n): int(s) for n, s in zip(mesh.axis_names,
                                           mesh.devices.shape)}


def sharding_descriptor(mesh, taxis):
    """JSON-able record of a ring-resident gulp sharding for a sequence
    header's ``_sharding``: the mesh axes, the sharded tensor axis, and
    the mesh axis the frame axis shards over."""
    return {
        'mesh_axes': _axes(mesh),
        'taxis': int(taxis),
        'axis': time_axis_name(mesh),
        'nshards': int(time_axis_size(mesh)),
    }


def meshes_equivalent(mesh_a, mesh_b):
    """Whether two mesh scopes lay ring-resident gulps out alike (same
    axes, time axis and devices), so that a span committed under one is
    read by the other with no reshard.  None against a mesh is never
    equivalent (one side commits single-device spans)."""
    if mesh_a is None or mesh_b is None:
        return mesh_a is mesh_b
    if mesh_a is mesh_b:
        return True
    try:
        return (_axes(mesh_a) == _axes(mesh_b) and
                time_axis_name(mesh_a) == time_axis_name(mesh_b) and
                mesh_a.devices.tolist() == mesh_b.devices.tolist())
    except Exception:
        return False


def descriptor_matches(desc, mesh, taxis):
    """Whether a header's ``_sharding`` descriptor describes the layout
    this mesh gives a gulp with frame axis ``taxis``."""
    if not isinstance(desc, dict) or mesh is None:
        return False
    want = sharding_descriptor(mesh, taxis)
    return all(desc.get(k) == v for k, v in want.items())


def check_descriptor(ihdr, mesh, taxis):
    """Count a producer / consumer layout disagreement once a sequence on
    ``mesh.layout_mismatch``: the input header's ``_sharding`` (when the
    producer wrote one) against this consumer's mesh."""
    desc = ihdr.get('_sharding') if isinstance(ihdr, dict) else None
    if desc is None or mesh is None:
        return
    if not descriptor_matches(desc, mesh, taxis):
        from ..telemetry import counters
        counters.inc('mesh.layout_mismatch')
