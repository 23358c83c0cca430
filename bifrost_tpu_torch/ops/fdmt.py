"""Fast Dispersion Measure Transform (incoherent dedispersion): the port
of ``bifrost_tpu/ops/fdmt.py`` (reference: src/fdmt.cu:266-814,
python/bifrost/fdmt.py).

The plan is the JAX package's, computed on the host by the same code: one
(d1, d2) delay table per merge step of the Zackay & Ofek recursion,
generalised to a dispersion ``exponent``.  A gulp runs the init (a
running sum over ``nd_init`` delays) and then ~log2(nchan) merge steps,
each a gather and add over (subband, delay) rows with a per-row time
shift.  Time is the last axis, as in the ring layout ``[..., 'freq',
'time']`` of the fdmt blocks.

Three cores, with the JAX package's names (``BF_FDMT_IMPL`` forces one):

- ``xla``: the torch gather core, the JAX ``_core_jax``: each step is one
  advanced-indexing gather with (nout, nd_out, T) index tensors and one
  add;
- ``rolls``: the JAX ``_core_jax_rolls``: output rows sorted by shift on
  the host, each distinct shift one ``torch.roll`` of a row segment;
  dropped from the candidates when the plan has more than 2048 shift
  segments;
- ``pallas``: K3, :func:`bifrost_tpu_torch.ops.gpu_kernels.fdmt_step`, one
  launch per step (the CUDA kernel on the card, its plain version on a
  CPU tensor).

The JAX ``jax.vmap`` over leading axes is a batch axis here: every core
takes (B, nchan, T) and the K3 launches carry B inside.  There is no
``jax.jit``: the port runs eagerly, and ``_fn`` caches the per-shape gulp
function, so probing happens only in :meth:`Fdmt.warmup`,
:meth:`Fdmt._pick_core` or the first call at a shape.  ``pallas`` is a
candidate only where the data lies on a CUDA device on which the
capability probe (:func:`~bifrost_tpu_torch.ops.gpu_kernels.available`)
passes; probing is on by default there (``BF_FDMT_PROBE``), as the JAX
package probes on the TPU.  A K3 error, or K3 outside the gate, raises
instead of dropping it from the race.

Not carried over: ``SMEM_TABLE_BUDGET`` and the per-step fallback of the
Pallas core to the XLA gather (``ops/fdmt.py:27-29``, ``:315-317``).  K3
reads its tables from device memory, put there once per plan and device
(counted in :attr:`Fdmt.table_uploads`), and takes every step.
"""

from __future__ import annotations

import os
import time

import numpy as np

__all__ = ['Fdmt', 'fdmt_numpy', 'KDM', 'fdmt_gate_rtol']

#: dispersion constant, MHz^2 s / (pc cm^-3): delay(f) = KDM * DM * f^-2
#: for f in MHz (reference: python/bifrost/blocks/fdmt.py:41)
KDM = 4.148741601e3

#: default oracle-gate relative tolerance for the core race: a candidate
#: must land within this (relative to the largest magnitude) of the
#: float64 sequential numpy reference at the probe shape, or it is kept
#: out of the race.  Override with BF_FDMT_GATE_RTOL.
FDMT_GATE_RTOL = 1e-4

#: the hand-written kernel's candidate name: it races only where the
#: capability probe passed, so an error from it raises
_KERNEL_IMPLS = frozenset(['pallas'])


def fdmt_gate_rtol():
    """Active oracle-gate rtol: BF_FDMT_GATE_RTOL or FDMT_GATE_RTOL."""
    try:
        env = os.environ.get('BF_FDMT_GATE_RTOL', '').strip()
        return float(env) if env else FDMT_GATE_RTOL
    except ValueError:
        return FDMT_GATE_RTOL


def _cff(f1, f2, exponent):
    """Dispersion delay factor between band edges."""
    return abs(f1 ** exponent - f2 ** exponent)


def _init_state(x, nd_init, sgn):
    """(B, nchan, T) -> (B, nchan, nd_init, T): A[.., c, d, t] = the sum
    over i <= d of x[.., c, t + sgn*i], a term outside [0, T) zero, summed
    in order of i in the input's type, as the JAX cores' cumsum sums.
    (``torch.cumsum`` is not used: on the CPU it accumulates float32 in
    float64, on the card in float32.)"""
    import torch
    T = x.shape[-1]
    dev = x.device
    ti = torch.arange(T, device=dev)[None, :] + \
        sgn * torch.arange(nd_init, device=dev)[:, None]
    ok = (ti >= 0) & (ti <= T - 1)
    state = x[:, :, ti.clamp(0, T - 1)] * ok
    for d in range(1, nd_init):
        state[:, :, d] += state[:, :, d - 1]
    return state


def _torch_merge_step(state, tabs, sgn, T_logical):
    """One merge step as torch gathers (the JAX ``_xla_merge_step``):
    ``state`` (B, nchan_cur, nd_cur, T) -> (B, nout, nd_out, T).  The
    index tensors are (nout, nd_out, T); the masked term is ``b * ok``."""
    import torch
    T = state.shape[-1]
    dev = state.device
    d1, d2, pt = tabs['d1l'], tabs['d2l'], tabs['ptb']
    t = torch.arange(T, device=dev)
    lo = state[:, tabs['rows_lo']]
    hi = state[:, tabs['rows_hi']]
    rows = torch.arange(d1.shape[0], device=dev)[:, None, None]
    tshift = t[None, None, :] + sgn * d1[:, :, None]
    ok = (tshift >= 0) & (tshift <= T_logical - 1)
    tshift = tshift.clamp(0, T - 1)
    a = lo[:, rows, d1[:, :, None], t[None, None, :]]
    b = hi[:, rows, d2[:, :, None], tshift] * ok
    return torch.where(pt[:, None, None], a, a + b)


class _Step(object):
    __slots__ = ('rows_lo', 'rows_hi', 'd1', 'd2', 'nd_out', 'passthrough')


class Fdmt(object):
    """Plan-style FDMT (reference: python/bifrost/fdmt.py:38-90)."""

    def __init__(self):
        self._plan = None
        self._fn = {}
        #: name of the core last selected ('xla', 'rolls', 'pallas') and,
        #: when the race ran, its per-core milliseconds per call
        self.chosen_core = None
        self.core_probe_ms = None
        #: milliseconds the race's float64 numpy reference took
        self.gate_ms = None
        #: sets of step tables put on a device (one per plan and device)
        self.table_uploads = 0
        self._core_locked = None
        self._tables = {}

    # -- plan construction (host side) ------------------------------------
    def init(self, nchan, max_delay, f0, df, exponent=-2.0, space='cuda'):
        if nchan < 1 or max_delay < 1:
            raise ValueError("nchan and max_delay must be >= 1")
        fmin, fmax = f0, f0 + nchan * df
        band = _cff(fmin, fmax, exponent)

        def nd(fl, fh):
            if band == 0:
                return 1
            return int(np.ceil((max_delay - 1) *
                               _cff(fl, fh, exponent) / band)) + 1

        subs = [(f0 + c * df, f0 + (c + 1) * df) for c in range(nchan)]
        nd_init = max(nd(fl, fh) for fl, fh in subs)
        steps = []
        cur_nds = [nd(fl, fh) for fl, fh in subs]
        cur_nd_max = nd_init
        while len(subs) > 1:
            nout = (len(subs) + 1) // 2
            new_subs, new_nds = [], []
            nd_out_max = 0
            pairs = []
            for s in range(nout):
                if 2 * s + 1 < len(subs):
                    fl = subs[2 * s][0]
                    fm = subs[2 * s + 1][0]
                    fh = subs[2 * s + 1][1]
                    nd_out = nd(fl, fh)
                    pairs.append((fl, fm, fh, nd_out, False))
                    new_subs.append((fl, fh))
                else:
                    nd_out = cur_nds[2 * s]
                    pairs.append((None, None, None, nd_out, True))
                    new_subs.append(subs[2 * s])
                new_nds.append(nd_out)
                nd_out_max = max(nd_out_max, nd_out)
            step = _Step()
            step.nd_out = nd_out_max
            step.rows_lo = np.arange(nout, dtype=np.int32) * 2
            step.rows_hi = np.minimum(step.rows_lo + 1, len(subs) - 1)
            d1 = np.zeros((nout, nd_out_max), np.int32)
            d2 = np.zeros((nout, nd_out_max), np.int32)
            passthrough = np.zeros(nout, bool)
            for s, (fl, fm, fh, nd_out, pt) in enumerate(pairs):
                if pt:
                    passthrough[s] = True
                    d1[s] = np.minimum(np.arange(nd_out_max),
                                       cur_nds[2 * s] - 1)
                    continue
                ds = np.arange(nd_out_max)
                ratio = (_cff(fl, fm, exponent) /
                         _cff(fl, fh, exponent)) if _cff(fl, fh, exponent) \
                    else 0.0
                d1s = np.round(ds * ratio).astype(np.int64)
                d1s = np.clip(d1s, 0, cur_nds[2 * s] - 1)
                d2s = np.clip(ds - d1s, 0, cur_nds[2 * s + 1] - 1)
                d1[s] = np.minimum(d1s, cur_nd_max - 1)
                d2[s] = np.minimum(d2s, cur_nd_max - 1)
            step.d1, step.d2, step.passthrough = d1, d2, passthrough
            steps.append(step)
            subs, cur_nds = new_subs, new_nds
            cur_nd_max = max(new_nds)
        self._plan = {
            'nchan': nchan, 'max_delay': max_delay, 'nd_init': nd_init,
            'steps': steps, 'space': space,
        }
        self._fn = {}
        # the locked winner and the device tables are per plan
        self._core_locked = None
        self._tables = {}
        return self

    @property
    def max_delay(self):
        return self._plan['max_delay']

    def _device_tables(self, kind, device, build):
        """The plan's ``kind`` tables on ``device``, built and uploaded on
        the first request per plan and device."""
        key = (kind, str(device))
        tabs = self._tables.get(key)
        if tabs is None:
            tabs = self._tables[key] = build(device)
            self.table_uploads += 1
        return tabs

    def _step_tables(self, device):
        """Per step: the int32 tables K3 takes (``d1``, ``d2``, ``pt``)
        and the row and long index tensors of the gather core."""
        import torch

        def build(dev):
            out = []
            for step in self._plan['steps']:
                d1 = torch.from_numpy(step.d1).to(dev)
                d2 = torch.from_numpy(step.d2).to(dev)
                pt = torch.from_numpy(step.passthrough.astype(np.int32)) \
                    .to(dev)
                out.append({
                    'd1': d1, 'd2': d2, 'pt': pt,
                    'd1l': d1.long(), 'd2l': d2.long(), 'ptb': pt.bool(),
                    'rows_lo': torch.from_numpy(
                        step.rows_lo.astype(np.int64)).to(dev),
                    'rows_hi': torch.from_numpy(
                        step.rows_hi.astype(np.int64)).to(dev)})
            return out
        return self._device_tables('steps', device, build)

    # -- single-gulp cores: (B, nchan, T) -> (B, max_delay, T) -------------
    def _core_jax(self, negative_delays):
        """The torch gather core (``xla``)."""
        plan = self._plan
        nd_init, max_delay = plan['nd_init'], plan['max_delay']
        sgn = -1 if negative_delays else +1

        def core(x):
            tabs = self._step_tables(x.device)
            T = x.shape[-1]
            state = _init_state(x, nd_init, sgn)
            for t in tabs:
                state = _torch_merge_step(state, t, sgn, T)
            return state[:, 0, :max_delay, :]
        return core

    def _core_jax_rolls(self, negative_delays):
        """Merge steps as row takes and static rolls (``rolls``).

        The output slots of every step are sorted by time shift on the
        host, the sort permutation is composed into the next step's index
        tables (so it never materialises at run time), and each distinct
        shift becomes one ``torch.roll`` of a contiguous row segment.
        (Reference kernel this replaces: src/fdmt.cu:53-96.)"""
        import torch
        plan = self._plan
        nd_init = plan['nd_init']
        steps = plan['steps']
        max_delay = plan['max_delay']
        sgn = -1 if negative_delays else +1

        # host-side schedule: per step, physical row selections sorted by
        # shift, contiguous equal-shift segments, passthrough mask
        sched = []
        nd_in = nd_init
        in_pos = None               # logical flat idx -> physical row
        for step in steps:
            nout, nd_out = step.d1.shape
            la = (step.rows_lo[:, None] * nd_in + step.d1).ravel()
            lb = (step.rows_hi[:, None] * nd_in + step.d2).ravel()
            shift = step.d1.ravel().astype(np.int64)
            pt = np.repeat(step.passthrough, nd_out)
            if in_pos is not None:
                la = in_pos[la]
                lb = in_pos[lb]
            order = np.argsort(shift, kind='stable')
            sel_a = la[order].astype(np.int64)
            sel_b = lb[order].astype(np.int64)
            s_sorted = shift[order]
            segs = []
            i, n = 0, len(s_sorted)
            while i < n:
                j = i
                while j < n and s_sorted[j] == s_sorted[i]:
                    j += 1
                segs.append((i, j, int(s_sorted[i])))
                i = j
            out_pos = np.empty(n, np.int64)
            out_pos[order] = np.arange(n)
            sched.append((sel_a, sel_b, segs, pt[order].copy()))
            in_pos = out_pos
            nd_in = nd_out
        fin = (in_pos[np.arange(max_delay)] if in_pos is not None
               else np.arange(max_delay)).astype(np.int64)

        def build(dev):
            return ([(torch.from_numpy(a).to(dev),
                      torch.from_numpy(b).to(dev), segs,
                      torch.from_numpy(pt).to(dev))
                     for a, b, segs, pt in sched],
                    torch.from_numpy(fin).to(dev))

        def core(x):
            B, nchan, T = x.shape
            dsched, dfin = self._device_tables(
                'rolls%+d' % sgn, x.device, build)
            t = torch.arange(T, device=x.device)
            state = _init_state(x, nd_init, sgn).reshape(B, -1, T)
            for sel_a, sel_b, segs, pt in dsched:
                a = state.index_select(1, sel_a)
                b0 = state.index_select(1, sel_b)
                parts = []
                for (i, j, s) in segs:
                    seg = b0[:, i:j]
                    if s == 0:
                        parts.append(seg)
                        continue
                    r = torch.roll(seg, -sgn * s, dims=-1)
                    mask = (t <= T - 1 - s) if sgn > 0 else (t >= s)
                    parts.append(r * mask)
                b = torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]
                b = torch.where(pt[:, None], b.new_zeros(()), b)
                state = a + b
            return state.index_select(1, dfin)
        return core

    def _core_pallas(self, negative_delays):
        """K3 step pipeline: the init, then one
        :func:`~bifrost_tpu_torch.ops.gpu_kernels.fdmt_step` launch per
        merge step on the float32 state, tables from the per-device
        cache.  Select with BF_FDMT_IMPL=pallas."""
        from . import gpu_kernels
        plan = self._plan
        nd_init, max_delay = plan['nd_init'], plan['max_delay']
        sgn = -1 if negative_delays else +1

        def core(x):
            tabs = self._step_tables(x.device)
            state = _init_state(x, nd_init, sgn)
            for t in tabs:
                state = gpu_kernels.fdmt_step(state, t['d1'], t['d2'],
                                              t['pt'], sgn)
            return state[:, 0, :max_delay, :]
        return core

    def _candidate_cores(self, negative_delays, device=None):
        """name -> zero-arg factory for every core that can run at this
        plan on ``device`` (the process's device when None): ``pallas``
        only on a CUDA device where the capability probe passes."""
        cands = {'xla': lambda: self._core_jax(negative_delays)}
        # the static-roll core's program grows with the number of distinct
        # shifts: huge-max_delay plans leave it out
        if self._rolls_segments() <= 2048:
            cands['rolls'] = lambda: self._core_jax_rolls(negative_delays)
        from .gpu_kernels import available
        if available(device):
            cands['pallas'] = lambda: self._core_pallas(negative_delays)
        return cands

    @staticmethod
    def _on_card(device):
        if device is None:
            from ..device import get_device
            device = get_device()
        return str(device).startswith('cuda')

    def _pick_core(self, negative_delays, shape=None, device=None):
        """Select the per-gulp core.

        BF_FDMT_IMPL={xla,rolls,pallas} forces a core.  Otherwise, on the
        card (or with BF_FDMT_PROBE=1 anywhere; BF_FDMT_PROBE=0 never) the
        candidates are gated and measured once at the actual (nchan, T)
        shape and the winner is cached per (card, plan, shape), in process
        and on disk.  A winner already measured for this plan is reused
        at other shapes (the ragged final gulp).  Without a race: rolls
        when its program size is bounded, else xla."""
        impl = os.environ.get('BF_FDMT_IMPL', '').strip().lower()
        if impl in ('xla', 'rolls', 'pallas'):
            self.chosen_core = impl
            return {'xla': self._core_jax,
                    'rolls': self._core_jax_rolls,
                    'pallas': self._core_pallas}[impl](negative_delays)
        cands = self._candidate_cores(negative_delays, device)
        if self._core_locked in cands:
            self.chosen_core = self._core_locked
            return cands[self._core_locked]()
        probe_env = os.environ.get('BF_FDMT_PROBE', '').strip()
        want_probe = (probe_env == '1') or \
            (self._on_card(device) and probe_env != '0')
        if want_probe and shape is not None and len(cands) > 1:
            name = self._probe_cores(cands, shape, negative_delays, device)
            if name in cands:
                self._core_locked = name
                return cands[name]()
        self.chosen_core = 'rolls' if 'rolls' in cands else 'xla'
        return cands[self.chosen_core]()

    def _probe_key(self, shape, negative_delays):
        """Shape and plan signature for the mprobe 'fdmt' family (the
        card and version prefix is mprobe's)."""
        import zlib
        plan = self._plan
        # hash the delay tables: plans with the same (nchan, max_delay)
        # but another f0/df/exponent must not share a winner
        h = 0
        for step in plan['steps']:
            for arr in (step.d1, step.d2,
                        step.passthrough.astype(np.int32)):
                h = zlib.crc32(np.ascontiguousarray(arr).tobytes(), h)
        key = 'nchan=%d|md=%d|ndi=%d|T=%d|sgn=%d|tab=%08x' % (
            plan['nchan'], plan['max_delay'], plan['nd_init'],
            shape[-1], -1 if negative_delays else 1, h & 0xffffffff)
        rtol = fdmt_gate_rtol()
        if rtol != FDMT_GATE_RTOL:
            key += '|gate_rtol=%g' % rtol
        return key

    def _probe_cores(self, cands, shape, negative_delays, device=None):
        """Gate every candidate core at ``shape`` against the float64
        numpy reference (its time kept in :attr:`gate_ms`), race the
        survivors through mprobe (family ``fdmt``) and cache the winner.
        A candidate that raises or misses the gate is dropped, except K3,
        whose error or miss raises."""
        import torch
        from . import mprobe
        from ..device import get_device
        key = self._probe_key(shape, negative_delays)
        cached = mprobe.peek('fdmt', key)
        if cached is not None and cached[0] in cands:
            self.chosen_core, self.core_probe_ms = cached[0], cached[1]
            return cached[0]
        dev = get_device() if device is None else torch.device(device)
        nchan, T = int(shape[-2]), int(shape[-1])
        rng = np.random.RandomState(0)
        xn = rng.randn(nchan, T).astype(np.float32)
        xt = torch.from_numpy(xn).to(dev)[None]
        t0 = time.perf_counter()
        ref = self._core_numpy(xn.astype(np.float64), negative_delays)
        self.gate_ms = (time.perf_counter() - t0) * 1e3
        scale = float(np.max(np.abs(ref))) or 1.0
        rtol = fdmt_gate_rtol()
        fns = {}
        had_errors = False
        for name, factory in cands.items():
            try:
                fn = factory()
                y = fn(xt)[0].cpu().numpy()
            except Exception:
                if name in _KERNEL_IMPLS:
                    raise
                had_errors = True
                continue
            err = float(np.max(np.abs(y - ref))) / scale
            del y
            if err <= rtol:
                fns[name] = fn
            elif name in _KERNEL_IMPLS:
                raise RuntimeError(
                    "Fdmt: the CUDA kernel core deviates from the float64 "
                    "reference by %.3g of its maximum (gate %g)"
                    % (err, rtol))
        if not fns:
            return 'none'
        winner, ms, _err = mprobe.select('fdmt', key, fns, lambda: (xt,),
                                         persist=not had_errors,
                                         strict=_KERNEL_IMPLS)
        if winner is None:
            return 'none'
        self.chosen_core, self.core_probe_ms = winner, ms
        return winner

    def _rolls_segments(self):
        """Total distinct-shift segments the rolls core would emit."""
        return sum(len(np.unique(step.d1))
                   for step in self._plan['steps'])

    def _core_numpy(self, x, negative_delays=False):
        """Pure-numpy reference core (the test oracle), (nchan, T)."""
        plan = self._plan
        nd_init, steps = plan['nd_init'], plan['steps']
        sgn = -1 if negative_delays else +1
        nchan, T = x.shape
        state = np.zeros((nchan, nd_init, T), np.float64)
        for d in range(nd_init):
            ti = np.arange(T) + sgn * d
            ok = (ti >= 0) & (ti < T)
            term = np.zeros((nchan, T))
            term[:, ok] = x[:, ti[ok]]
            state[:, d] = term + (state[:, d - 1] if d else 0)
        for step in steps:
            nout, nd_out = step.d1.shape
            new = np.zeros((nout, nd_out, T))
            for s in range(nout):
                for d in range(nd_out):
                    a = state[step.rows_lo[s], step.d1[s, d]]
                    if step.passthrough[s]:
                        new[s, d] = a
                        continue
                    ti = np.arange(T) + sgn * step.d1[s, d]
                    ok = (ti >= 0) & (ti < T)
                    b = np.zeros(T)
                    b[ok] = state[step.rows_hi[s], step.d2[s, d]][ti[ok]]
                    new[s, d] = a + b
            state = new
        return state[0, :plan['max_delay'], :]

    # -- execution ----------------------------------------------------------
    def _get_fn(self, shape, dtype, negative_delays, device=None):
        """The per-(shape, dtype, device) gulp function; picks (and so may
        probe) the core on the first request."""
        key = (tuple(shape), str(dtype), bool(negative_delays), str(device))
        fn = self._fn.get(key)
        if fn is None:
            fn = self._fn[key] = self._gulp_fn(self._pick_core(
                negative_delays, shape=tuple(shape)[-2:], device=device))
        return fn

    @staticmethod
    def _gulp_fn(core):
        """The gulp function around a picked ``core``: non-float input is
        cast to f32, and leading axes ride the core's batch axis."""
        def fn(x):
            xs = x if x.is_floating_point() else x.float()
            out = core(xs.reshape((-1,) + tuple(xs.shape[-2:])))
            return out.reshape(tuple(xs.shape[:-2]) + tuple(out.shape[-2:]))
        return fn

    def warmup(self, shape, dtype='float32', negative_delays=False):
        """Pick (probe) the core and run the gulp function once on zeros
        of the expected gulp ``shape`` on the process's device, so the race
        happens at block init and not as first-gulp latency.  ``dtype`` (a
        torch dtype or its name) must be the dtype the gulps arrive with.
        Errors propagate."""
        import torch
        from ..device import get_device, stream_synchronize
        dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
        dev = get_device()
        fn = self._get_fn(shape, dt, negative_delays, dev)
        fn(torch.zeros(shape, dtype=dt, device=dev))
        stream_synchronize()

    def execute(self, idata, odata=None, negative_delays=False):
        """idata: (..., nchan, T) -> (..., max_delay, T) float32 (float64
        input stays float64 on the gather and rolls cores)."""
        from .common import as_tensor, writeback
        x = as_tensor(idata)
        fn = self._get_fn(x.shape, x.dtype, negative_delays, x.device)
        return writeback(fn(x), odata)

    def get_workspace_size(self, idata, odata):
        return 0    # torch's allocator owns scratch

    def execute_workspace(self, idata, odata, workspace_ptr=None,
                          workspace_size=None, negative_delays=False):
        return self.execute(idata, odata, negative_delays=negative_delays)


def fdmt_numpy(nchan, max_delay, f0, df, x, exponent=-2.0,
               negative_delays=False):
    """Convenience: numpy-only FDMT (test oracle)."""
    plan = Fdmt().init(nchan, max_delay, f0, df, exponent, space='system')
    return plan._core_numpy(np.asarray(x, np.float64), negative_delays)
