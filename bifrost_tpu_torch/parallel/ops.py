"""Sharded hot ops over a device mesh (the port of
``bifrost_tpu/parallel/ops.py``).

The JAX package runs a per-shard body under ``shard_map`` and lets XLA
lower the collectives.  The port keeps the single-controller model: a
sharded value is the list of per-rank tensors in rank order (each on its
rank's device), the collectives are plain functions over those lists, and
:func:`shard_map` cuts global tensors into such lists, runs a body over
them and puts the result back together.  On a 2-D mesh a collective acts
within the groups of ranks along one named axis.  Ranks that share a
device share a collective's result tensor where the values are equal
(``psum``, ``all_gather``): treat results as read-only.

Parallelism mapping from the reference's model (SURVEY.md §2.9):

- pipeline (thread-per-block)      -> unchanged, host side ("pp")
- intra-op CUDA grid               -> one card's kernels
- multi-GPU per-block placement    -> shard the block's op over a Mesh:
    * time/gulp axis over 'sp' (data/sequence parallel; FIR history
      crosses shard boundaries via a ppermute halo exchange: the
      ring-attention-style neighbor pattern)
    * antenna axis over 'tp' (tensor parallel; beamforming GEMM partial
      sums meet in a psum, correlation all_gathers the antenna axis)

The ``_local_*`` functions are the per-shard bodies, each over the
mesh's lists; the ``sharded_*`` wrappers and :func:`spectrometer_step`
compose the same bodies, so the collective patterns live in one place.
Plain products stay ``torch.einsum``: the JAX package computes them
outside any Pallas kernel.  :data:`collectives` counts the collective
calls by kind, the port's form of ``scope.collective_counts``, which the
JAX package reads from compiled HLO text.
"""

from __future__ import annotations

import numpy as np

__all__ = ['PartitionSpec', 'P', 'shard', 'unshard', 'shard_map',
           'axis_size', 'axis_index', 'axis_groups', 'psum', 'ppermute',
           'all_gather', 'all_to_all', 'collectives',
           'sharded_spectrometer', 'sharded_beamform', 'sharded_correlate',
           'sharded_fdmt', 'sharded_fir', 'spectrometer_step']

#: collective calls by kind since import (or since a caller reset them);
#: ``ring_permute`` counts the corner turn's K9 hops
collectives = {'psum': 0, 'ppermute': 0, 'all_gather': 0, 'all_to_all': 0,
               'ring_permute': 0}


class PartitionSpec(tuple):
    """How a global tensor lies over a mesh: per tensor axis, the mesh
    axis name it is split over, or None (replicated); missing trailing
    entries are None (``jax.sharding.PartitionSpec``)."""

    def __new__(cls, *names):
        return tuple.__new__(cls, names)


P = PartitionSpec


def _padded_spec(spec, ndim):
    spec = tuple(spec)
    if len(spec) > ndim:
        raise ValueError("partition spec %r for a %d-D tensor" % (spec, ndim))
    return spec + (None,) * (ndim - len(spec))


def _axis_pos(mesh, name):
    try:
        return mesh.axis_names.index(name)
    except ValueError:
        raise ValueError("mesh axis %r not in %r" % (name, mesh.axis_names))


def shard(x, mesh, spec):
    """The per-rank blocks of global tensor ``x`` laid out by ``spec``:
    a list in rank order, block r on rank r's device.  A block of a tensor
    already on the rank's device is a view, not a copy."""
    spec = _padded_spec(spec, x.dim())
    for name in spec:
        if name is not None:
            _axis_pos(mesh, name)
    out = []
    for r, dev in enumerate(mesh.rank_devices):
        c = mesh.coords(r)
        idx = []
        for d, name in enumerate(spec):
            if name is None:
                idx.append(slice(None))
                continue
            n = mesh.shape[name]
            if x.shape[d] % n:
                raise ValueError("axis %d of %s does not divide over mesh "
                                 "axis %r of size %d"
                                 % (d, tuple(x.shape), name, n))
            m = x.shape[d] // n
            k = c[_axis_pos(mesh, name)]
            idx.append(slice(k * m, (k + 1) * m))
        out.append(x[tuple(idx)].to(dev))
    return out


def unshard(xs, mesh, spec, device=None):
    """The global tensor of the per-rank blocks ``xs`` laid out by
    ``spec``, on ``device`` (rank 0's by default).  Replicated axes are
    read from the ranks at index 0 along them; a fully replicated value
    is rank 0's block itself where it already lies on ``device``."""
    import torch
    if len(xs) != mesh.size:
        raise ValueError("%d blocks for a mesh of %d ranks"
                         % (len(xs), mesh.size))
    ref = xs[0]
    device = ref.device if device is None else torch.device(device)
    spec = _padded_spec(spec, ref.dim())
    named = {_axis_pos(mesh, n) for n in spec if n is not None}
    if not named:
        return ref.to(device)
    shape = [s * (mesh.shape[n] if n is not None else 1)
             for s, n in zip(ref.shape, spec)]
    out = torch.empty(shape, dtype=ref.dtype, device=device)
    for r, x in enumerate(xs):
        c = mesh.coords(r)
        if any(c[a] for a in range(len(c)) if a not in named):
            continue
        idx = tuple(slice(None) if n is None else
                    slice(c[_axis_pos(mesh, n)] * s,
                          (c[_axis_pos(mesh, n)] + 1) * s)
                    for s, n in zip(ref.shape, spec))
        out[idx] = x
    return out


def shard_map(body, mesh, in_specs, out_specs):
    """``fn(*global_args)``: each argument cut by its spec into per-rank
    lists, ``body(*lists)`` run once, its result (a list, or a tuple of
    lists under a tuple of specs) put back together on the first
    argument's device (``jax.shard_map`` for a single controller).  An
    argument that is not a tensor goes to the process's device first."""
    from ..ops.common import as_tensor
    single_in = isinstance(in_specs, PartitionSpec)
    single_out = isinstance(out_specs, PartitionSpec)

    def fn(*args):
        specs = (in_specs,) if single_in else tuple(in_specs)
        if len(specs) != len(args):
            raise ValueError("%d arguments for %d partition specs"
                             % (len(args), len(specs)))
        args = [as_tensor(a) for a in args]
        res = body(*[shard(a, mesh, s) for a, s in zip(args, specs)])
        dev = args[0].device
        if single_out:
            return unshard(res, mesh, out_specs, dev)
        return tuple(unshard(r, mesh, s, dev)
                     for r, s in zip(res, out_specs))
    return fn


# ---------------------------------------------------------------------------
# collectives over the per-rank lists
# ---------------------------------------------------------------------------

def axis_size(mesh, axis_name):
    """Size of a named mesh axis."""
    _axis_pos(mesh, axis_name)
    return int(mesh.shape[axis_name])


def axis_index(mesh, axis_name):
    """Each rank's index along ``axis_name``, in rank order."""
    a = _axis_pos(mesh, axis_name)
    return [mesh.coords(r)[a] for r in range(mesh.size)]


def axis_groups(mesh, axis_name):
    """The groups of ranks that differ only along ``axis_name``, each in
    order of its index along that axis."""
    a = _axis_pos(mesh, axis_name)
    shape = mesh.devices.shape
    ranks = np.moveaxis(np.arange(mesh.size).reshape(shape), a, -1)
    return [[int(r) for r in g] for g in ranks.reshape(-1, shape[a])]


def _check_ranks(mesh, xs):
    if len(xs) != mesh.size:
        raise ValueError("%d blocks for a mesh of %d ranks"
                         % (len(xs), mesh.size))


def _per_device(group, devices, make):
    """{device: make(device)} for the devices of ``group``'s ranks, made
    once per device."""
    made = {}
    for r in group:
        d = devices[r]
        if d not in made:
            made[d] = make(d)
    return made


def psum(mesh, xs, axis_name):
    """Sum over the ranks of each group along ``axis_name``, in index
    order; every rank of the group receives the sum.  A group of one rank
    returns its block."""
    _check_ranks(mesh, xs)
    collectives['psum'] += 1
    devices = mesh.rank_devices
    out = [None] * len(xs)
    for group in axis_groups(mesh, axis_name):
        dev0 = xs[group[0]].device
        total = xs[group[0]]
        if len(group) > 1:
            total = total + xs[group[1]].to(dev0)
            for r in group[2:]:
                total += xs[r].to(dev0)
        made = _per_device(group, devices, total.to)
        for r in group:
            out[r] = made[devices[r]]
    return out


def ppermute(mesh, xs, axis_name, perm):
    """Send the block of the rank at index s to the rank at index d of
    its group for each (s, d) of ``perm``; a rank that no pair names
    receives zeros shaped as its own block (``jax.lax.ppermute``)."""
    import torch
    _check_ranks(mesh, xs)
    src_of = {d: s for s, d in perm}
    if len(src_of) != len(perm) or len(set(src_of.values())) != len(perm):
        raise ValueError("ppermute: %r is not a permutation" % (perm,))
    collectives['ppermute'] += 1
    devices = mesh.rank_devices
    out = [None] * len(xs)
    for group in axis_groups(mesh, axis_name):
        for k, r in enumerate(group):
            s = src_of.get(k)
            if s is None:
                out[r] = torch.zeros_like(xs[r], device=devices[r])
            else:
                out[r] = xs[group[s]].to(devices[r])
    return out


def all_gather(mesh, xs, axis_name, axis=0, tiled=True):
    """Every rank of a group receives the group's blocks in index order,
    concatenated along ``axis`` (stacked on a new leading ``axis`` when
    not ``tiled``)."""
    import torch
    _check_ranks(mesh, xs)
    collectives['all_gather'] += 1
    devices = mesh.rank_devices
    out = [None] * len(xs)
    for group in axis_groups(mesh, axis_name):
        def gather(d, group=group):
            parts = [xs[r].to(d) for r in group]
            return torch.cat(parts, dim=axis) if tiled else \
                torch.stack(parts, dim=axis)
        made = _per_device(group, devices, gather)
        for r in group:
            out[r] = made[devices[r]]
    return out


def all_to_all(mesh, xs, axis_name, split_axis, concat_axis, tiled=True):
    """Each rank splits its block along ``split_axis`` into one chunk per
    rank of its group and sends chunk k to the rank at index k, which
    concatenates what it receives along ``concat_axis`` in order of the
    sender's index (``jax.lax.all_to_all`` with ``tiled=True``)."""
    import torch
    _check_ranks(mesh, xs)
    if not tiled:
        raise ValueError("all_to_all: only the tiled form is implemented")
    collectives['all_to_all'] += 1
    devices = mesh.rank_devices
    out = [None] * len(xs)
    for group in axis_groups(mesh, axis_name):
        n = len(group)
        size = xs[group[0]].shape[split_axis]
        if size % n:
            raise ValueError("all_to_all: axis %d of size %d does not split "
                             "over %d ranks" % (split_axis, size, n))
        m = size // n
        for k, r in enumerate(group):
            parts = [xs[s].narrow(split_axis, k * m, m).to(devices[r])
                     for s in group]
            out[r] = torch.cat(parts, dim=concat_axis)
    return out


# ---------------------------------------------------------------------------
# per-shard bodies (shared by the sharded_* wrappers and spectrometer_step)
# ---------------------------------------------------------------------------

def _local_fir_stateful(mesh, x, coeffs, state, axis_name, decim=1):
    """Causal FIR along the (sharded) leading time axis.  ``state`` holds
    the replicated inter-gulp history (the previous gulp's final ntap-1
    frames) consumed by shard 0; interior shard boundaries exchange halos
    via ppermute: the sequence-parallel pattern (reference op keeps
    inter-gulp state host-side: src/fir.cu:143-316).  Returns
    ``(y, new_state)``; ``new_state`` is this gulp's global final ntap-1
    frames, replicated to every shard."""
    import torch
    ntap = coeffs.shape[0]
    cs = [coeffs.to(xi.device) for xi in x]
    if ntap == 1:
        y = [c[0] * xi for c, xi in zip(cs, x)]
        return ([yi[::decim] for yi in y] if decim > 1 else y), state
    axis_size_ = axis_size(mesh, axis_name)
    halo = [xi[-(ntap - 1):] for xi in x]
    perm = [(i, (i + 1) % axis_size_) for i in range(axis_size_)]
    left = ppermute(mesh, halo, axis_name, perm)
    idx = axis_index(mesh, axis_name)
    left = [st.to(xi.device, xi.dtype) if i == 0 else lf
            for st, xi, lf, i in zip(state, x, left, idx)]
    out = []
    for c, lf, xi in zip(cs, left, x):
        xp = torch.cat([lf, xi], dim=0)
        o = torch.zeros_like(xi)
        for t in range(ntap):
            o = o + c[t] * xp[ntap - 1 - t: xp.shape[0] - t]
        out.append(o[::decim] if decim > 1 else o)
    # New state = the LAST shard's halo, as a masked psum (the JAX body's
    # form, which lets shard_map prove the result replicated).
    masked = [h * (1 if i == axis_size_ - 1 else 0)
              for h, i in zip(halo, idx)]
    new_state = psum(mesh, masked, axis_name)
    return out, new_state


def _local_fir(mesh, x, coeffs, axis_name):
    """Stateless wrapper over :func:`_local_fir_stateful` (zero initial
    history)."""
    import torch
    ntap = coeffs.shape[0]
    if ntap == 1:
        return [coeffs.to(xi.device)[0] * xi for xi in x]
    state = [torch.zeros((ntap - 1,) + tuple(xi.shape[1:]), dtype=xi.dtype,
                         device=xi.device) for xi in x]
    y, _ = _local_fir_stateful(mesh, x, coeffs, state, axis_name)
    return y


def _local_stokes(s):
    """(T, P=2, ...) complex -> (T, 4, ...) Stokes I,Q,U,V (one tensor:
    no collective)."""
    import torch
    x, y = s[:, 0], s[:, 1]
    xx = x.real ** 2 + x.imag ** 2
    yy = y.real ** 2 + y.imag ** 2
    xy = x * y.conj()
    return torch.stack([xx + yy, xx - yy, 2 * xy.real, -2 * xy.imag], dim=1)


def _local_beamform(mesh, w, v, ant_axis_name):
    """(B, A/tp) x (T, A/tp, F) -> (T, B, F) per rank: partial GEMM + psum
    (reference op: bfLinAlgMatMul beamform, src/linalg.cu:877)."""
    import torch
    part = [torch.einsum('ba,taf->tbf', wi, vi) for wi, vi in zip(w, v)]
    return psum(mesh, part, ant_axis_name)


def _local_correlate(mesh, v, ant_axis_name, time_axis_name):
    """(T/sp, A/tp, F) -> (F, A/tp, A) per rank: each rank computes its
    antenna-row block against the all_gathered antenna axis, integrated
    over time shards (reference op: bfLinAlgMatMul a·a^H,
    src/linalg.cu:877)."""
    import torch
    vfull = all_gather(mesh, v, ant_axis_name, axis=1, tiled=True)
    part = [torch.einsum('taf,tbf->fab', vi, vf.conj())
            for vi, vf in zip(v, vfull)]
    return psum(mesh, part, time_axis_name)


# ---------------------------------------------------------------------------
# shard_map wrappers: functions over global tensors
# ---------------------------------------------------------------------------

def sharded_spectrometer(mesh, time_axis_name='sp'):
    """FFT→Stokes-detect→integrate over gulps whose time axis is sharded
    across the mesh.  Input (T, P, F) complex; output (F', 4) f32 spectra
    integrated over all time shards (psum over the time axis)."""
    import torch

    def local_step(v):
        part = []
        for vi in v:
            s = torch.fft.fft(vi, dim=-1)
            part.append(torch.movedim(_local_stokes(s), 1, -1).sum(dim=0))
        return psum(mesh, part, time_axis_name)

    return shard_map(local_step, mesh, in_specs=P(time_axis_name, None, None),
                     out_specs=P(None, None))


def sharded_beamform(mesh, ant_axis_name='tp'):
    """Tensor-parallel beamforming GEMM over a sharded antenna axis."""
    def local_step(w, v):
        return _local_beamform(mesh, w, v, ant_axis_name)

    return shard_map(local_step, mesh,
                     in_specs=(P(None, ant_axis_name),
                               P(None, ant_axis_name, None)),
                     out_specs=P(None, None, None))


def sharded_correlate(mesh, ant_axis_name='tp', time_axis_name='sp'):
    """Cross-correlation (visibilities) with antennas and time sharded."""
    def local_step(v):
        return _local_correlate(mesh, v, ant_axis_name, time_axis_name)

    return shard_map(local_step, mesh,
                     in_specs=P(time_axis_name, ant_axis_name, None),
                     out_specs=P(None, ant_axis_name, None))


def sharded_fir(mesh, coeffs, time_axis_name='sp'):
    """FIR along a time axis sharded across ranks (halo via ppermute)."""
    import torch
    coeffs = torch.as_tensor(coeffs)

    def local_step(x):
        return _local_fir(mesh, x, coeffs, time_axis_name)

    return shard_map(local_step, mesh, in_specs=P(time_axis_name),
                     out_specs=P(time_axis_name))


def sharded_fdmt(mesh, plan, time_axis_name='sp',
                 negative_delays=False, core=None):
    """Time-sharded FDMT over the mesh (long-sequence dedispersion).

    FDMT output column t depends only on input columns [t, t + max_delay)
    for positive delays (the mirror window for negative), so each shard
    fetches a max_delay-wide halo from its time neighbor via ppermute
    (edge shards receive zeros, which is exactly the plan's out-of-range
    semantics), then runs the plan's core on its local window.  Input
    (nchan, T) sharded over ``time_axis_name``; output (max_delay, T)
    sharded the same way, bit-identical to the single-device core.

    ``core`` (a core of :class:`~bifrost_tpu_torch.ops.fdmt.Fdmt`, over
    (B, nchan, T)) defaults to the gather core; pass a measured winner
    (``Fdmt._pick_core``) for production.  Reference capability:
    bfFdmtExecute (src/fdmt.cu:718) on one GPU; the halo exchange is the
    scale-out this framework adds.
    """
    import torch
    H = int(plan.max_delay)
    n = int(mesh.shape[time_axis_name])
    if core is None:
        core = plan._core_jax(negative_delays)

    def local_step(x):
        # x: per-rank (nchan, T/n)
        if x[0].shape[1] < H:
            raise ValueError(
                "per-shard time %d < max_delay %d: the halo would need a "
                "non-adjacent neighbor; use fewer shards or longer gulps"
                % (x[0].shape[1], H))
        if negative_delays:
            halo = ppermute(mesh, [xi[:, -H:] for xi in x], time_axis_name,
                            [(i, i + 1) for i in range(n - 1)])
            return [core(torch.cat([h, xi], dim=1)[None])[0][:, H:]
                    for h, xi in zip(halo, x)]
        halo = ppermute(mesh, [xi[:, :H] for xi in x], time_axis_name,
                        [(i, i - 1) for i in range(1, n)])
        return [core(torch.cat([xi, h], dim=1)[None])[0][:, :xi.shape[1]]
                for h, xi in zip(halo, x)]

    return shard_map(local_step, mesh, in_specs=P(None, time_axis_name),
                     out_specs=P(None, time_axis_name))


def spectrometer_step(mesh):
    """The flagship full step, sharded over a ('sp', 'tp') mesh:

    int8 (re,im) voltages (T, A, F, 2)
      -> complexify -> FIR (halo over 'sp')
      -> FFT over F -> beamform (psum over 'tp')
      -> Stokes-power beams -> integrate (psum over 'sp')
      -> correlate (all_gather over 'tp', psum over 'sp')

    Returns (spectra (B, F), visibilities (F, A, A)); it composes the
    same per-shard bodies as the sharded_* wrappers above.
    """
    import torch

    def local_step(volt, weights, coeffs):
        # volt: (T/sp, A/tp, F, 2) int8;  weights: (B, A/tp) complex
        v = [torch.complex(vo[..., 0].float(), vo[..., 1].float())
             for vo in volt]
        # the taps are replicated: every rank's copy is the same
        vf = _local_fir(mesh, v, coeffs[0], 'sp')
        s = [torch.fft.fft(x, dim=-1) for x in vf]
        beams = _local_beamform(mesh, weights, s, 'tp')
        p = [(b.real ** 2 + b.imag ** 2).sum(dim=0) for b in beams]
        spectra = psum(mesh, p, 'sp')
        vis = _local_correlate(mesh, s, 'tp', 'sp')
        return spectra, vis

    return shard_map(
        local_step, mesh,
        in_specs=(P('sp', 'tp', None, None), P(None, 'tp'), P(None)),
        out_specs=(P(None, None), P(None, 'tp', None)))
