"""The correlator CORNER TURN as a collective over the mesh (the port of
``bifrost_tpu/parallel/corner_turn.py``).

An FX correlator's F-stage is time-major (each engine channelizes its
own time slice) while the X-stage is channel-major (each engine wants
EVERY station's voltages for its channels, over the whole integration).
The redistribution between them, time/station-major to channel-major, is
the classic corner turn, the bandwidth bottleneck of every large
correlator (reference: Bifrost moves it over UDP between servers,
python/bifrost/packet_writer.py).

The gulp is time-sharded (T/D, F, ...) per rank and must become
channel-sharded (T, F/D, ...).  Three interchangeable forms:

- ``impl='xla'``: one :func:`~bifrost_tpu_torch.parallel.ops.all_to_all`
  (split the channel axis, concatenate the time axis);
- ``impl='pallas'``: D-1 neighbour hops around the mesh ring, each hop
  one launch of K9
  (:func:`bifrost_tpu_torch.ops.gpu_kernels.ring_permute`, its plain
  version on the CPU), which moves every rank's whole block one rank to
  the right; each rank peels off the channel chunk addressed to it;
- ``impl='ring'``: the same schedule with each hop a
  :func:`~bifrost_tpu_torch.parallel.ops.ppermute` (the reference form).

All three are pure redistributions: byte-identical outputs, equal to the
transpose oracle ``x[:, d*F/D:(d+1)*F/D]`` for rank d.
"""

from __future__ import annotations

__all__ = ['corner_turn_local', 'corner_turn']

from .ops import (P as _P, shard_map, axis_size as _axis_size,
                  axis_index, axis_groups, ppermute, all_to_all, collectives)


def _ppermute_shift(mesh, x, axis_name, ndev):
    """Reference ring hop: rank i's block lands on (i+1) % D."""
    perm = [(i, (i + 1) % ndev) for i in range(ndev)]
    return ppermute(mesh, x, axis_name, perm)


def _pallas_shift(mesh, x, axis_name, ndev):
    """Ring hop as K9: one launch per group moves every rank's block to
    its right neighbour."""
    from ..ops.gpu_kernels import ring_permute
    collectives['ring_permute'] += 1
    out = [None] * len(x)
    for group in axis_groups(mesh, axis_name):
        moved = ring_permute([x[r].contiguous() for r in group])
        for r, y in zip(group, moved):
            out[r] = y
    return out


def _ring_corner_turn(mesh, x, axis_name, ndev, shift):
    """Corner turn composed from D-1 ring hops: after hop k rank i holds
    the block of rank (i-k); it peels off channel chunk #i (the chunk
    that source addressed to it) and finally orders the chunks by SOURCE
    rank, so the result equals the all_to_all/transpose oracle."""
    import torch
    idx = axis_index(mesh, axis_name)
    f = x[0].shape[1]
    fc = f // ndev

    def my_chunk(buf):
        return [b.narrow(1, i * fc, fc) for b, i in zip(buf, idx)]

    parts = [my_chunk(x)]
    buf = x
    for _ in range(ndev - 1):
        buf = shift(mesh, buf, axis_name, ndev)
        parts.append(my_chunk(buf))
    # parts[k] came from rank (i - k) mod D; slot s takes source s's
    # chunk, parts[(i - s) mod D], then the slots concatenate in time
    return [torch.cat([parts[(i - s) % ndev][r] for s in range(ndev)], dim=0)
            for r, i in enumerate(idx)]


def corner_turn_local(mesh, x, axis_name, impl='xla', ndev=None):
    """Per-rank corner turn over ``axis_name``: the per-rank blocks
    (T/D, F, ...) become (T, F/D, ...), i.e. the gulp goes from
    time-sharded to channel-sharded.  Requires D | F.  ``impl``: 'xla'
    (all_to_all), 'pallas' (K9 hops), 'ring' (ppermute hops)."""
    if impl in ('pallas', 'ring'):
        if ndev is None:
            ndev = _axis_size(mesh, axis_name)
        if not isinstance(ndev, int):
            raise ValueError('ring corner turn needs a static device '
                             'count; pass ndev=')
        if ndev != _axis_size(mesh, axis_name):
            raise ValueError('ndev=%d, but mesh axis %r has %d ranks'
                             % (ndev, axis_name,
                                _axis_size(mesh, axis_name)))
        shift = _pallas_shift if impl == 'pallas' else _ppermute_shift
        return _ring_corner_turn(mesh, x, axis_name, ndev, shift)
    if impl != 'xla':
        raise ValueError("corner turn impl %r not in "
                         "('xla', 'pallas', 'ring')" % (impl,))
    return all_to_all(mesh, x, axis_name, split_axis=1, concat_axis=0,
                      tiled=True)


def corner_turn(mesh, axis_name, impl='xla', stacked=False):
    """Host-level wrapper for tests/tools: returns fn(x) over a GLOBAL
    (T, F, ...) tensor, time-sharded in and channel-sharded out.
    Globally the corner turn is an identity (it only moves shards), so
    ``stacked=True`` instead returns (D, T, F/D, ...) with slot d = rank
    d's post-turn block, comparable against the transpose oracle
    ``x[:, d*F/D:(d+1)*F/D]``."""
    ndev = _axis_size(mesh, axis_name)

    def call(x):
        from ..ops.common import as_tensor
        x = as_tensor(x)
        in_spec = _P(*([axis_name] + [None] * (x.dim() - 1)))
        if stacked:
            out_spec = _P(*([axis_name] + [None] * x.dim()))

            def body(b):
                return [y[None] for y in corner_turn_local(
                    mesh, b, axis_name, impl=impl, ndev=ndev)]
        else:
            out_spec = _P(*([None, axis_name] + [None] * (x.dim() - 2)))

            def body(b):
                return corner_turn_local(mesh, b, axis_name, impl=impl,
                                         ndev=ndev)
        return shard_map(body, mesh, in_spec, out_spec)(x)
    return call
