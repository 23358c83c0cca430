"""FIR filter with decimation and inter-gulp state (the port of
``bifrost_tpu/ops/fir.py``; reference: src/fir.cu:53-416, multi-tap FIR
across ant-pols carrying state between gulps; python/bifrost/fir.py).

The filter runs along the leading (time) axis.  Coefficients have shape
(ntap,), shared across channels, or (ntap, *tail_shape) matching the
per-sample tail dims for per-antpol filters (reference semantics).  State
(the last ntap-1 input frames) is carried in the plan object, so
streaming gulps are seamless, a final partial gulp included;
``reset_state`` zeroes it (reference: bfFirResetState).  Each gulp is
ntap multiply-adds of shifted views strided by the decimation, torch
ops on the input's device.
Under a mesh the time axis is sharded over the mesh's time axis and the
filter history crosses shard boundaries through
:func:`bifrost_tpu_torch.parallel.ops._local_fir_stateful`.
"""

from __future__ import annotations

from .common import as_tensor, writeback

__all__ = ['Fir']


class Fir(object):
    def __init__(self):
        self._coeffs = None
        self._decim = 1
        self._state = None
        self._mesh = None

    def init(self, coeffs, decim=1, space='cuda', mesh=None):
        """``coeffs``: (ntap,) or (ntap, *tail) taps; ``decim``: keep
        every decim-th output frame; ``mesh``: shard the time axis over
        the mesh's time axis."""
        self._coeffs = as_tensor(coeffs)
        self._decim = int(decim)
        self._state = None
        self._mesh = mesh
        return self

    def set_coeffs(self, coeffs):
        self._coeffs = as_tensor(coeffs)
        return self

    def reset_state(self):
        self._state = None
        return self

    @property
    def ntap(self):
        return self._coeffs.shape[0]

    def _coeffs_for(self, x):
        """The taps on ``x``'s device, real taps in ``x``'s real
        precision (complex taps in its complex type)."""
        import torch
        c = self._coeffs
        if c.is_complex():
            dt = x.dtype if x.is_complex() else torch.complex64
        else:
            dt = x.real.dtype
        if c.device != x.device or c.dtype != dt:
            c = self._coeffs = c.to(x.device, dt)
        return c

    def _filter(self, x, state):
        """(y, new_state) of one gulp ``x`` (T, ...) after history
        ``state`` (ntap-1, ...)."""
        import torch
        coeffs = self._coeffs_for(x)
        ntap, decim = self.ntap, self._decim
        xp = torch.cat([state, x], dim=0) if ntap > 1 else x
        acc = None
        for t in range(ntap):
            # only the frames that decimation keeps
            term = coeffs[t] * xp[ntap - 1 - t: xp.shape[0] - t: decim]
            acc = term if acc is None else acc + term
        new_state = xp[-(ntap - 1):].clone() if ntap > 1 else state
        return acc, new_state

    def _mesh_shardable(self, x):
        """The mesh path needs: T divides over the time axis; each shard
        holds at least the filter history; per-shard decimation stays
        aligned."""
        if self._mesh is None:
            return False
        from ..parallel.scope import time_axis_size
        n = time_axis_size(self._mesh)
        local = x.shape[0] // n if x.shape[0] % n == 0 else 0
        return (local > 0 and local >= self.ntap - 1 and
                local % self._decim == 0)

    def _filter_sharded(self, x, state):
        from ..parallel.ops import P, _local_fir_stateful, unshard
        from ..parallel.scope import shard_gulp, time_axis_name
        mesh = self._mesh
        tname = time_axis_name(mesh)
        xs = shard_gulp(x, mesh, 0)
        states = [state.to(d) for d in mesh.rank_devices]
        ys, new = _local_fir_stateful(mesh, xs, self._coeffs_for(x), states,
                                      tname, self._decim)
        return unshard(ys, mesh, P(tname), device=x.device), \
            new[0].to(x.device)

    def execute(self, idata, odata=None):
        """Filter one gulp ``idata`` (T, ...), carrying the state on;
        returns the (T / decim, ...) output, written into ``odata`` when
        given."""
        import torch
        x = as_tensor(idata)
        if not (x.is_floating_point() or x.is_complex()):
            x = x.to(torch.float32)
        if self._state is None or \
                tuple(self._state.shape[1:]) != tuple(x.shape[1:]) or \
                self._state.device != x.device:
            self._state = torch.zeros((max(self.ntap - 1, 1),) +
                                      tuple(x.shape[1:]), dtype=x.dtype,
                                      device=x.device)
        state = self._state.to(x.dtype)
        if self._mesh_shardable(x):
            y, self._state = self._filter_sharded(x, state)
        else:
            y, self._state = self._filter(x, state)
        return writeback(y, odata)
