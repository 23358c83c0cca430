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

Ring-resident layouts.  Where the JAX package commits a global
``jax.Array`` with a ``NamedSharding``, the port commits a
:class:`ShardedTensor`: the per-rank blocks of a gulp split over the
mesh's time axis, in rank order, each on its rank's device.  A device
ring keeps it per rank (``ring.<name>.sharded_gulps``), a mesh block
whose plan wants that layout reads the blocks themselves, and every
other reader gets the gathered tensor (``mesh.gathers``).

:func:`frame_local_plan` is the JAX package's plan of the same name: one
body per rank on its contiguous frame block, so no collective runs by
construction; the port has no GSPMD partitioner to fall back on, so a
plan that fails to build raises.  :func:`mesh_plan_or_gathered` is the
rule every mesh block follows: the frame-local plan where it applies,
else the whole-gulp plan on the gathered input.  In place of the HLO
collective stats the port counts collective calls
(``parallel.ops.collectives``): :func:`collective_counts` reads them, and
a mesh plan's first run records them (:func:`record_collectives`).
"""

from __future__ import annotations

import os

__all__ = ['time_axis_name', 'station_axis_name', 'time_axis_size',
           'time_sharding', 'replicated_sharding', 'NamedSharding',
           'ShardedTensor', 'shardable_nframe', 'shard_gulp',
           'as_layout', 'gather_local', 'sharding_descriptor',
           'meshes_equivalent', 'descriptor_matches', 'check_descriptor',
           'advertise_sharding', 'frame_local_plan',
           'mesh_plan_or_gathered', 'mesh_h2d_enabled', 'hlo_stats_enabled',
           'collective_counts', 'record_collectives']


def time_axis_name(mesh):
    """The mesh axis that gulp frame/time axes shard over."""
    return 'sp' if 'sp' in mesh.axis_names else mesh.axis_names[0]


def station_axis_name(mesh):
    """The mesh axis for antenna/station sharding, or None."""
    return 'tp' if 'tp' in mesh.axis_names else None


def time_axis_size(mesh):
    return mesh.shape[time_axis_name(mesh)]


class NamedSharding(object):
    """A mesh and a :class:`~.ops.PartitionSpec`: how a global tensor
    lies over the mesh (``jax.sharding.NamedSharding``)."""

    __slots__ = ('mesh', 'spec')

    def __init__(self, mesh, spec):
        from .ops import P
        self.mesh = mesh
        self.spec = P(*spec)

    def __eq__(self, other):
        return isinstance(other, NamedSharding) and \
            tuple(self.spec) == tuple(other.spec) and \
            meshes_equivalent(self.mesh, other.mesh)

    def __repr__(self):
        return 'NamedSharding(%r, %r)' % (self.mesh, tuple(self.spec))


def time_sharding(mesh, ndim, taxis):
    """The layout placing axis ``taxis`` of an ``ndim``-D tensor over the
    mesh's time axis (every other axis replicated)."""
    spec = [None] * ndim
    spec[taxis] = time_axis_name(mesh)
    return NamedSharding(mesh, spec)


def replicated_sharding(mesh):
    """The layout of a tensor every rank holds whole."""
    return NamedSharding(mesh, ())


class ShardedTensor(object):
    """A gulp laid out over a mesh's time axis: ``shards`` are the
    per-rank blocks in rank order (frame axis ``taxis`` split; ranks
    that differ along other mesh axes hold the same block).  ``shape``
    and ``dtype`` are the global tensor's.  Readers that do not take the
    layout call :meth:`gather`."""

    __slots__ = ('shards', 'mesh', 'taxis')

    def __init__(self, shards, mesh, taxis):
        if len(shards) != mesh.size:
            raise ValueError("%d blocks for a mesh of %d ranks"
                             % (len(shards), mesh.size))
        self.shards = list(shards)
        self.mesh = mesh
        self.taxis = int(taxis)

    @property
    def sharding(self):
        return time_sharding(self.mesh, self.shards[0].dim(), self.taxis)

    @property
    def shape(self):
        import torch
        s = list(self.shards[0].shape)
        s[self.taxis] *= time_axis_size(self.mesh)
        return torch.Size(s)

    @property
    def dtype(self):
        return self.shards[0].dtype

    @property
    def device(self):
        return self.shards[0].device

    @property
    def is_cuda(self):
        return self.shards[0].is_cuda

    def dim(self):
        return self.shards[0].dim()

    @property
    def nbytes(self):
        return self.shard_nbytes * time_axis_size(self.mesh)

    @property
    def shard_nbytes(self):
        t = self.shards[0]
        return t.numel() * t.element_size()

    def record_stream(self, stream):
        for t in self.shards:
            if t.is_cuda and t.device == stream.device:
                t.record_stream(stream)

    def gather(self, device=None):
        """The global tensor on ``device`` (rank 0's by default), counted
        on ``mesh.gathers`` / ``mesh.gather_bytes``."""
        from ..telemetry import counters
        from .ops import unshard
        counters.inc('mesh.gathers')
        counters.inc('mesh.gather_bytes', int(self.nbytes))
        return unshard(self.shards, self.mesh, self.sharding.spec,
                       device=device)

    def narrow(self, dim, start, length):
        return self.gather().narrow(dim, start, length)

    def __repr__(self):
        return 'ShardedTensor(shape=%s, dtype=%s, shards=%d, taxis=%d)' % (
            tuple(self.shape), self.dtype, len(self.shards), self.taxis)


def shardable_nframe(mesh, nframe):
    """Whether a gulp of ``nframe`` frames divides over the time axis."""
    return nframe % time_axis_size(mesh) == 0


def as_layout(x, mesh, taxis):
    """``x`` as a :class:`ShardedTensor` over ``mesh`` with frame axis
    ``taxis`` split: ``x`` itself when it already lies so, else ``x``
    (gathered first when it lies otherwise) cut into per-rank blocks,
    counted on ``mesh.reshards`` / ``mesh.reshard_bytes`` as the JAX
    package counts a relayout.  None when the frame axis does not divide
    the mesh."""
    if x.shape[taxis] % time_axis_size(mesh):
        return None
    if isinstance(x, ShardedTensor):
        if x.taxis == taxis and meshes_equivalent(x.mesh, mesh):
            return x
        x = x.gather()
    from ..telemetry import counters
    from .ops import shard
    counters.inc('mesh.reshards')
    counters.inc('mesh.reshard_bytes', int(x.numel() * x.element_size()))
    return ShardedTensor(shard(x, mesh, time_sharding(
        mesh, x.dim(), taxis).spec), mesh, taxis)


def shard_gulp(x, mesh, taxis):
    """Lay a gulp tensor out over the mesh, frame axis ``taxis`` split
    over the time axis: the per-rank list of blocks (views where the
    rank's device holds ``x``; a :class:`ShardedTensor` in that layout
    gives its own blocks).  When the frame axis does not divide the mesh
    the gulp stays as it is and is returned unchanged, as in the JAX
    package."""
    got = as_layout(x, mesh, taxis)
    return x if got is None else got.shards


def gather_local(x):
    """Bring a tensor back to this process's device.  Blocks need this
    when they fall back from the sharded to the unsharded build
    mid-sequence (e.g. a partial final gulp) while carrying state that a
    mesh plan put on another card."""
    from ..device import get_device
    if isinstance(x, ShardedTensor):
        x = x.gather()
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


def advertise_sharding(ihdr, ohdr, mesh):
    """A mesh block's output header: under a mesh the output spans are
    committed per rank over the output frame axis, which
    ``ohdr['_sharding']`` says (an input descriptor never passes
    through), and an input layout this mesh would have to move is counted
    on ``mesh.layout_mismatch``."""
    ohdr.pop('_sharding', None)
    if mesh is None:
        return
    try:
        check_descriptor(ihdr, mesh, ihdr['_tensor']['shape'].index(-1))
        ohdr['_sharding'] = sharding_descriptor(
            mesh, ohdr['_tensor']['shape'].index(-1))
    except (KeyError, ValueError):
        pass


def frame_local_plan(mesh, build_local, shape, dtype, taxis_in,
                     taxis_out):
    """The plan of a time-concat-equivariant gulp function over the
    mesh's time axis (``bifrost_tpu/parallel/scope.py:156``): each rank
    runs ``build_local(per_shard_shape)`` on its contiguous frame block,
    so the plan runs no collective by construction.  Equivariance is the
    ``Stage.batch_safe`` contract that macro-gulp execution relies on.

    The plan takes the gulp as a tensor or a :class:`ShardedTensor` (a
    ring-resident input in the plan's layout is used as it lies, any
    other is laid out and counted on ``mesh.reshards``) and returns a
    :class:`ShardedTensor` with frame axis ``taxis_out`` split, which the
    output ring keeps per rank.  ``dtype`` is not read (``build_local``
    knows its dtype); it stays so that calls written to the JAX
    signature run.

    Returns ``(plan, in_sharding, out_sharding)`` as the JAX function
    does, or None when the frame axis does not divide the mesh.  A body
    that fails to build raises, and so does a run whose output has no
    axis ``taxis_out``."""
    nsh = time_axis_size(mesh)
    if shape[taxis_in] % nsh:
        return None
    local = list(shape)
    local[taxis_in] //= nsh
    body = build_local(tuple(local))
    in_sh = time_sharding(mesh, len(shape), taxis_in)

    def plan(x):
        xs = as_layout(x, mesh, taxis_in)
        ys = [body(b) for b in xs.shards]
        if taxis_out >= ys[0].dim():
            raise ValueError("frame-local plan: output of %d axes has no "
                             "frame axis %d" % (ys[0].dim(), taxis_out))
        return ShardedTensor(ys, mesh, taxis_out)

    plan.mesh = mesh
    out_sh = time_sharding(mesh, len(shape), taxis_out) \
        if taxis_out < len(shape) else None
    return plan, in_sh, out_sh


def mesh_plan_or_gathered(mesh, build_local, build_whole, shape, taxis_in,
                          taxis_out, local_ok=True):
    """A mesh block's plan for an input of ``shape``: the frame-local plan
    (:func:`frame_local_plan` over ``build_local``) where ``local_ok``
    (the chain is time-concat equivariant and has no lookahead) and the
    frame axis divides the mesh; else ``build_whole()`` run on the
    gathered input, counted on ``mesh.whole_gulp_plans``.  Either plan has
    ``.mesh`` set.  Returns ``(plan, info)``, ``info`` the mesh entries of
    the block's ``impl_info`` (none for a whole-gulp plan)."""
    got = frame_local_plan(mesh, build_local, shape, None, taxis_in,
                           taxis_out) if local_ok else None
    if got is not None:
        nsh = time_axis_size(mesh)
        return got[0], {'mesh': 'shard_map[%d]' % nsh, 'shards': nsh}
    from ..telemetry import counters
    counters.inc('mesh.whole_gulp_plans')
    whole = build_whole()

    def plan(*args):
        return whole(*[a.gather() if isinstance(a, ShardedTensor) else a
                       for a in args])
    plan.mesh = mesh
    return plan, {}


def mesh_h2d_enabled():
    """Sharded H2D placement (per-rank staging in
    ``xfer.TransferEngine.to_device_sharded``); ``BF_MESH_H2D=0`` ships
    the whole gulp and cuts it on the device instead (counted on
    ``xfer.h2d_sharded_fallback``)."""
    return os.environ.get('BF_MESH_H2D', '1') != '0'


def hlo_stats_enabled():
    """Always True in the port.  The JAX package gates its collective
    stats (``BF_MESH_HLO_STATS``) because they compile a second copy of
    each plan; the port counts collective calls anyway, so every mesh
    plan's first run records them.  Kept because the JAX package exports
    it."""
    return True


def collective_counts(since=None):
    """Collective calls by kind (``parallel.ops.collectives``), or the
    calls made after the snapshot ``since`` (only kinds that moved).  The
    port's counterpart of reading the collectives out of compiled HLO
    text."""
    from .ops import collectives
    now = dict(collectives)
    if since is None:
        return now
    return {k: v - since.get(k, 0) for k, v in now.items()
            if v != since.get(k, 0)}


def record_collectives(since):
    """Record on the ``mesh.collectives.<kind>`` counters the collective
    calls made after the snapshot ``since`` (a plan's first run), with
    ``mesh.plans_analyzed`` and, when there were none,
    ``mesh.plans_collective_free``; returns the count dict."""
    from ..telemetry import counters
    counts = collective_counts(since)
    for kind, n in counts.items():
        counters.inc('mesh.collectives.%s' % kind, n)
    counters.inc('mesh.plans_analyzed')
    if not counts:
        counters.inc('mesh.plans_collective_free')
    return counts
