"""Device meshes (the port of ``bifrost_tpu/parallel/mesh.py``).

A block scales out by attaching a mesh to its scope
(``BlockScope(mesh=...)``); its gulp function then runs one body per rank
of the mesh, with the collectives of :mod:`bifrost_tpu_torch.parallel.ops`
between the bodies.  The JAX package's ``shard_map`` is single-controller,
and so is the port: one process, the ranks' work issued in rank order by
the block's thread.  ``torch.distributed`` is not used: it cannot put two
ranks on one card.

A :class:`Mesh` holds a numpy array of ``torch.device`` and the axis
names.  A device may repeat, and ranks that repeat a device share that
card: a mesh of D ranks all on ``cuda:0`` runs every collective at full
width on one card, as the JAX package's tests run their meshes on 8
logical devices of one CPU.
"""

from __future__ import annotations

import numpy as np

__all__ = ['Mesh', 'create_mesh', 'mesh_axes', 'local_mesh', 'CPU_RANKS']

#: ranks of the default mesh after ``set_device('cpu')``: the counterpart
#: of the JAX tests' ``--xla_force_host_platform_device_count=8``
CPU_RANKS = 8


class Mesh(object):
    """Ranks laid out on named axes.  ``devices`` is an array (any
    nesting of sequences) of ``torch.device``, one per rank, shaped by the
    axes; ``axis_names`` names its axes in order.  Ranks are numbered in
    row-major order of the array, the order of every sharded value's
    list."""

    def __init__(self, devices, axis_names):
        import torch
        shape = np.shape(np.asarray(devices, dtype=object))
        flat = [torch.device(d)
                for d in np.asarray(devices, dtype=object).reshape(-1)]
        arr = np.empty(len(flat), dtype=object)
        arr[:] = flat
        self.devices = arr.reshape(shape)
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != self.devices.ndim:
            raise ValueError("%d axis names for a %d-D device array"
                             % (len(self.axis_names), self.devices.ndim))
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError("axis names repeat: %r" % (self.axis_names,))

    @property
    def shape(self):
        """{axis name: size}, in axis order (``mesh.shape`` in JAX)."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self):
        return int(self.devices.size)

    @property
    def rank_devices(self):
        """The device of each rank, in rank order."""
        return list(self.devices.reshape(-1))

    def coords(self, rank):
        """The rank's index along each axis, in axis order."""
        return tuple(int(i) for i in np.unravel_index(rank,
                                                      self.devices.shape))

    def __repr__(self):
        return 'Mesh(%s, devices=%s)' % (
            ', '.join('%s=%d' % kv for kv in self.shape.items()),
            sorted(set(str(d) for d in self.rank_devices)))


def _default_devices():
    """One rank per visible card; eight CPU ranks after
    ``set_device('cpu')``."""
    import torch
    from ..device import get_device
    dev = get_device()
    if dev.type != 'cuda':
        return [torch.device(dev.type)] * CPU_RANKS
    return [torch.device('cuda', i)
            for i in range(torch.cuda.device_count())]


def create_mesh(axis_sizes=None, devices=None):
    """Build a Mesh.

    ``axis_sizes``: dict axis-name -> size, e.g. {'dp': 2, 'tp': 4}; or an
    int N for a 1-D ('dp',) mesh of N ranks; or None for all devices on a
    1-D mesh.  ``devices``: the ranks' devices in rank order (a device may
    repeat); by default one rank per visible card, or eight CPU ranks
    after ``set_device('cpu')``.
    """
    if devices is None:
        devices = _default_devices()
    devices = list(devices)
    if axis_sizes is None:
        axis_sizes = {'dp': len(devices)}
    elif isinstance(axis_sizes, int):
        axis_sizes = {'dp': axis_sizes}
    names = tuple(axis_sizes.keys())
    sizes = tuple(int(s) for s in axis_sizes.values())
    n = 1
    for s in sizes:
        n *= s
    if n > len(devices):
        raise ValueError("Mesh wants %d devices; %d available"
                         % (n, len(devices)))
    arr = np.empty(n, dtype=object)
    arr[:] = devices[:n]
    return Mesh(arr.reshape(sizes), names)


def mesh_axes(mesh):
    return tuple(mesh.axis_names)


def local_mesh(n=None, axis_sizes=None):
    """Mesh over the first n default devices (testing convenience)."""
    devs = _default_devices()
    if n is not None:
        devs = devs[:n]
    return create_mesh(axis_sizes if axis_sizes is not None else len(devs),
                       devices=devs)
