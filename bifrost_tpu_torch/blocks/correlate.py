"""FX-correlator X step: cross-multiply stations, integrate in time (the
port of ``bifrost_tpu/blocks/correlate.py``; reference:
python/bifrost/blocks/correlate.py:36-108, backed by the xGPU-style cherk
kernel in src/linalg.cu:210-226).

Per channel, x x^H runs through the raced X engine
(:class:`bifrost_tpu_torch.ops.linalg.XEngine`): ci8 voltages stay int8 on
exact int32 candidates (K7 among them on the card), float voltages race
the planar forms against the complex64 baseline, all gated per the
declared accuracy class.  The output matrix is fully filled (header
``matrix_fill_mode='full'``).

Two block forms:

- :class:`CorrelateBlock`, stateful: integrates ``nframe_per_integration``
  frames across gulps, one output frame per integration.  Under a mesh
  (``block_scope(mesh=...)``) it runs one of the JAX block's mesh plans:
  time-parallel partial visibilities met in a ``psum`` (on a 2-D mesh
  with a station axis, each rank's station-row block against the
  gathered stations, K8 on int8 planes), or the CORNER TURN,
  redistributing the voltages from time-sharded to channel-sharded
  (``all_to_all``, or D-1 ring hops of K9) and correlating each channel
  shard over the full gulp.  ``BF_XCORR_CORNER_TURN`` forces a plan; by
  default the plans race under ops.mprobe at ``on_sequence`` where
  probing is on, ``corner:pallas`` among them where the capability probe
  K0 passes on the card;
- :class:`CorrelateStageBlock`, stage-backed
  (:class:`bifrost_tpu_torch.stages.CorrelateStage`): integrates whole
  groups within each gulp; macro-gulp eligible and segment-fusable (the
  engine is prewarmed at the per-group shape, which is the same for
  every K).
"""

from __future__ import annotations

import os
from copy import deepcopy

from ..dtype import DataType
from ..pipeline import TransformBlock
from ..stages import CorrelateStage
from .fft import _StageBlock

__all__ = ['CorrelateBlock', 'CorrelateStageBlock', 'correlate']


def _int_input(itensor):
    dt = DataType(itensor['dtype'])
    return dt.kind == 'ci' and dt.nbits == 8


def _cross_block(x, xg, reim):
    """Cross-multiply a local station-row block against the full
    (gathered) station axis: x (T, F, Sr, P[,2]), xg (T, F, S, P[,2])
    -> (F, Sr, P, S, P).  On int8 planes through xcorr_int8's cross
    family (K8 on the card where raced or forced)."""
    import torch
    if reim:
        from ..ops.linalg import xcorr_int8
        t, f, sr, p = x.shape[:4]
        s = xg.shape[2]
        re_i = x[..., 0].reshape(t, f, sr * p)
        im_i = x[..., 1].reshape(t, f, sr * p)
        re_j = xg[..., 0].reshape(t, f, s * p)
        im_j = xg[..., 1].reshape(t, f, s * p)
        vis = xcorr_int8(re_i, im_i, re_j, im_j)
        return vis.reshape(f, sr, p, s, p)
    from ..ops.linalg import full_f32
    t, f, sr, p = x.shape
    s = xg.shape[2]
    xi = x.reshape(t, f, sr * p)
    xj = xg.reshape(t, f, s * p)
    with full_f32():
        vis = torch.einsum('tfi,tfj->fij', xi, xj.conj())
    return vis.reshape(f, sr, p, s, p)


def _corner_turn_mode():
    """BF_XCORR_CORNER_TURN: 'auto' (default: race the psum and
    corner-turn mesh plans at on_sequence where probing is on), 'off'
    (always the psum plan), 'xla' / 'pallas' (force the corner-turn plan
    with that redistribution primitive)."""
    v = os.environ.get('BF_XCORR_CORNER_TURN', 'auto').strip().lower()
    return v if v in ('auto', 'off', 'xla', 'pallas') else 'auto'


#: the corner-turn plan whose hops are the hand-written kernel K9: an
#: error from it in the race propagates
_KERNEL_PLANS = frozenset(['corner:pallas'])


class CorrelateBlock(TransformBlock):
    def __init__(self, iring, nframe_per_integration, accuracy='f32',
                 impl=None, *args, **kwargs):
        super(CorrelateBlock, self).__init__(iring, *args, **kwargs)
        from ..ops.linalg import XEngine
        self.nframe_per_integration = nframe_per_integration
        self.engine = XEngine(accuracy=accuracy, impl=impl)
        self.accuracy = self.engine.accuracy
        #: real ops of the correlation product per gulp of the current
        #: sequence (8 per complex MAC), the GOP/s accounting unit
        self._gemm_ops = 0
        self._fn = {}
        #: mesh plan chosen for the sequence ('psum', 'corner:xla' or
        #: 'corner:pallas') and, after a race, each plan's ms per call
        self._mesh_plan = 'psum'
        self.mesh_probe_ms = None

    def define_valid_input_spaces(self):
        return ('cuda',)

    @property
    def _collective_boundary(self):
        """Segment-planner protocol (as the JAX block's): under a mesh
        this block schedules its own collective (the corner turn or the
        psum meeting point), so its ring boundaries are no place to
        fuse."""
        return self.mesh is not None

    def define_output_nframes(self, input_nframe):
        return 1

    def on_sequence(self, iseq):
        self.nframe_integrated = 0
        self._acc = None
        self._fn = {}
        self.mesh_probe_ms = None
        ihdr = iseq.header
        itensor = ihdr['_tensor']
        if itensor['labels'] != ['time', 'freq', 'station', 'pol']:
            raise ValueError("correlate requires ['time', 'freq', "
                             "'station', 'pol'] input labels, got %r"
                             % (itensor['labels'],))
        ohdr = deepcopy(ihdr)
        otensor = ohdr['_tensor']
        otensor['dtype'] = 'cf32'
        for key in ('shape', 'labels', 'scales', 'units'):
            # deep-copy the per-axis entries so the doubled station/pol
            # axes alias neither each other nor the input header
            tv, fv, sv, pv = (deepcopy(v) for v in itensor[key])
            otensor[key] = [tv, fv, sv, pv,
                            deepcopy(sv) if key != 'labels' else sv + '_j',
                            deepcopy(pv) if key != 'labels' else pv + '_j']
        otensor['labels'][2] += '_i'
        otensor['labels'][3] += '_i'
        otensor['scales'][0][1] *= self.nframe_per_integration
        ohdr['matrix_fill_mode'] = 'full'
        # the engine reads gulps of the input header's gulp_nframe (or
        # this block's override); that is what must divide the integration
        gulp_actual = self.gulp_nframe or ihdr['gulp_nframe']
        if self.nframe_per_integration % gulp_actual != 0:
            raise ValueError(
                "gulp_nframe (%d) does not divide nframe_per_integration "
                "(%d)" % (gulp_actual, self.nframe_per_integration))
        ohdr['gulp_nframe'] = min(ihdr['gulp_nframe'],
                                  self.nframe_per_integration)
        self._prewarm_xcorr(itensor, gulp_actual)
        _, f, s, p = itensor['shape'][:4]
        self._gemm_ops = 8 * gulp_actual * f * (s * p) ** 2
        return ohdr

    # -- mesh plan selection --------------------------------------------

    def _corner_eligible(self, shape, ndev):
        """The corner-turn plan applies to a purely time-sharded mesh
        whose rank count divides BOTH the frame axis and the channel axis
        (the all_to_all swaps one for the other)."""
        return (shape[0] % ndev == 0 and shape[1] % ndev == 0
                and ndev > 1)

    def _mesh_geometry(self, shape):
        """(tname, ndev, shard_stations, sname) for this gulp shape, or
        None when the mesh cannot shard it."""
        from ..parallel.scope import (time_axis_name, station_axis_name,
                                      shardable_nframe)
        mesh = self.mesh
        if mesh is None or not shardable_nframe(mesh, shape[0]):
            return None
        sname = station_axis_name(mesh)
        shard_stations = (sname is not None and mesh.shape[sname] > 1
                          and shape[2] % mesh.shape[sname] == 0)
        tname = time_axis_name(mesh)
        return tname, mesh.shape[tname], shard_stations, sname

    def _select_mesh_plan(self, shape, dtype, reim):
        """Choose between the psum and corner-turn mesh plans for this
        sequence: an explicit BF_XCORR_CORNER_TURN wins; otherwise the
        plans race on synthetic data under the mprobe policy (family
        ``corner_turn``, at on_sequence, never as first-gulp latency),
        ``corner:pallas`` only where the capability probe K0 passes on
        the card.  The psum plan is the unmeasured default."""
        import torch
        geo = self._mesh_geometry(shape)
        if geo is None:
            return 'psum'
        tname, ndev, shard_stations, _ = geo
        if shard_stations or not self._corner_eligible(shape, ndev):
            return 'psum'
        mode = _corner_turn_mode()
        if mode == 'off':
            return 'psum'
        if mode in ('xla', 'pallas'):
            return 'corner:%s' % mode
        from ..ops.linalg import _probe_wanted
        if not _probe_wanted():
            return 'psum'
        from ..device import get_device
        from ..ops import gpu_kernels, mprobe
        dev = get_device()
        key = 'v=%s %s ndev=%d acc=%s' % (tuple(shape), dtype, ndev,
                                          self.accuracy)
        names = ['psum', 'corner:xla'] + \
            (['corner:pallas'] if gpu_kernels.available(dev) else [])
        cached = mprobe.peek('corner_turn', key)
        if cached is not None and cached[0] in names:
            self.mesh_probe_ms = cached[1]
            return cached[0]
        g = torch.Generator(device=dev).manual_seed(17)
        if reim:
            x = torch.randint(-64, 64, shape, dtype=torch.int8, device=dev,
                              generator=g)
        else:
            x = torch.complex(
                torch.randn(shape, device=dev, generator=g),
                torch.randn(shape, device=dev, generator=g))
        fns = {name: self._build_mesh(tuple(shape), dtype, reim, plan=name)
               for name in names}
        winner, ms, _err = mprobe.select('corner_turn', key, fns,
                                         lambda: (x,), strict=_KERNEL_PLANS)
        self.mesh_probe_ms = ms
        return winner or 'psum'

    def _prewarm_xcorr(self, itensor, gulp_nframe):
        """Choose the X-engine winner (and, under a mesh, the mesh plan)
        for this sequence's gulp shape now, so the probe cost never lands
        on the first gulp.  Errors propagate."""
        int_input = _int_input(itensor)
        _, f, s, p = itensor['shape'][:4]
        n = s * p
        shape = tuple([gulp_nframe] + list(itensor['shape'][1:4]) +
                      ([2] if int_input else []))
        dtype = 'int8' if int_input else 'complex64'
        t_eff, f_eff = gulp_nframe, f
        if self.mesh is not None:
            self._mesh_plan = self._select_mesh_plan(shape, dtype, int_input)
            geo = self._mesh_geometry(shape)
            if geo is not None:
                tname, ndev, shard_stations, sname = geo
                if self._mesh_plan.startswith('corner'):
                    # channel-sharded: full gulp, F/ndev channels
                    f_eff = f // ndev
                else:
                    t_eff = gulp_nframe // ndev
                if shard_stations:
                    # a station-row block against the gathered column
                    # axis rides the 4-operand xcorr race
                    from ..ops.linalg import xcorr_prewarm
                    sr = s // self.mesh.shape[sname]
                    xcorr_prewarm(t_eff, f, sr * p, n)
                    return
        self.engine.prewarm(t_eff, f_eff, n, int_input=int_input)

    def _local_vis_fn(self, reim):
        engine = self.engine

        def local_vis(x):
            if reim:
                t, f, s, p = x.shape[:4]
                re = x[..., 0].reshape(t, f, s * p)
                im = x[..., 1].reshape(t, f, s * p)
            else:
                t, f, s, p = x.shape
                xm = x.reshape(t, f, s * p)
                re, im = xm.real, xm.imag
            return engine(re, im).reshape(f, s, p, s, p)
        return local_vis

    def _build_mesh(self, shape, dtype, reim, plan):
        """One sharded mesh plan: 'psum' (time-parallel partial
        visibilities met in a psum; stations shard too on a 2-D mesh) or
        'corner:<impl>' (corner-turn the voltages time-sharded ->
        channel-sharded, correlate each channel shard over the full gulp,
        gather the channel axis once).  Returns mesh_fn(x) -> the gulp's
        visibilities on x's device, or raises when the plan cannot be
        built at this geometry."""
        from ..parallel.ops import P, shard_map, psum, all_gather
        local_vis = self._local_vis_fn(reim)
        mesh = self.mesh
        geo = self._mesh_geometry(shape)
        if geo is None:
            raise ValueError('mesh cannot shard gulp %r' % (shape,))
        tname, ndev, shard_stations, sname = geo
        spec = [None] * len(shape)
        spec[0] = tname
        if plan.startswith('corner'):
            if shard_stations or not self._corner_eligible(shape, ndev):
                raise ValueError('corner-turn plan ineligible at %r'
                                 % (shape,))
            ct_impl = plan.split(':', 1)[1]
            from ..parallel.corner_turn import corner_turn_local

            def local_fn(x):
                # (T/D, F, ...) -> (T, F/D, ...): the collective; then a
                # channel-local correlation over the FULL gulp with no
                # further collectives, and one gather of the finished
                # channel rows
                xc = corner_turn_local(mesh, x, tname, impl=ct_impl)
                vis = [local_vis(b) for b in xc]
                return all_gather(mesh, vis, tname, axis=0, tiled=True)
            out_spec = P()
        else:
            if shard_stations:
                spec[2] = sname

            def local_fn(x):
                if shard_stations:
                    # gather the antenna COLUMN axis; rows stay local
                    xg = all_gather(mesh, x, sname, axis=2, tiled=True)
                    vis = [_cross_block(a, b, reim) for a, b in zip(x, xg)]
                else:
                    vis = [local_vis(a) for a in x]
                return psum(mesh, vis, tname)
            # output (F, S_row, P, S, P): rows sharded over sname
            out_spec = P(None, sname, None, None, None) \
                if shard_stations else P()
        return shard_map(local_fn, mesh, in_specs=P(*spec),
                         out_specs=out_spec)

    def _build(self, shape, dtype, reim):
        """The gulp function x -> visibilities: the sequence's mesh plan
        where the mesh shards the gulp, else the single-device product
        (a partial gulp that does not divide the mesh falls back to it,
        as in the JAX block)."""
        local_vis = self._local_vis_fn(reim)
        mesh = self.mesh
        if mesh is not None and self._mesh_geometry(shape) is not None:
            return self._build_mesh(shape, dtype, reim, self._mesh_plan)
        if mesh is None:
            return local_vis

        def plain_fn(x):
            from ..parallel.scope import gather_local
            return local_vis(gather_local(x))
        return plain_fn

    def on_data(self, ispan, ospan):
        import torch
        x = ispan.data
        reim = ispan.dtype.kind == 'ci' and not x.is_complex()
        key = (tuple(x.shape), str(x.dtype))
        fn = self._fn.get(key)
        if fn is None:
            fn = self._fn[key] = self._build(tuple(x.shape), x.dtype, reim)
        vis = fn(x)
        if self._acc is None:
            self._acc = vis
        else:
            # in place: the sum is this block's own until it is published
            self._acc += vis
        self.nframe_integrated += ispan.nframe
        if self.nframe_integrated > self.nframe_per_integration:
            raise ValueError("correlate: %d frames integrated, more than "
                             "the %d of an integration"
                             % (self.nframe_integrated,
                                self.nframe_per_integration))
        if self.nframe_integrated == self.nframe_per_integration:
            self.nframe_integrated = 0
            out = self._acc[None]    # add the time axis
            self._acc = None
            ospan.set(out.to(torch.complex64))
            return 1
        return 0


class CorrelateStageBlock(_StageBlock):
    """Stage-backed X step (:class:`bifrost_tpu_torch.stages
    .CorrelateStage`): one visibility per ``nframe_per_vis`` frames
    within each gulp."""

    def __init__(self, iring, nframe_per_vis, accuracy='f32',
                 impl=None, *args, **kwargs):
        super(CorrelateStageBlock, self).__init__(
            iring, CorrelateStage(nframe_per_vis, accuracy=accuracy,
                                  impl=impl), *args, **kwargs)
        self._gemm_ops = 0

    @property
    def engine(self):
        return self._stage.engine

    def on_sequence(self, iseq):
        ohdr = super(CorrelateStageBlock, self).on_sequence(iseq)
        # prewarm at the per-group shape (r, f, n): the engine chooses by
        # that shape whatever the number of groups in a gulp, so one
        # prewarm covers every macro batch K
        itensor = iseq.header['_tensor']
        _, f, s, p = itensor['shape'][:4]
        self._stage.engine.prewarm(self._stage.nframe_per_vis, f, s * p,
                                   int_input=_int_input(itensor))
        gulp_actual = self.gulp_nframe or iseq.header['gulp_nframe']
        self._gemm_ops = 8 * gulp_actual * f * (s * p) ** 2
        return ohdr


def correlate(iring, nframe_per_integration, accuracy='f32', impl=None,
              fusable=False, *args, **kwargs):
    """Block: the X step of an FX correlator (reference docstring:
    blocks/correlate.py:106-136; xGPU reference arXiv:1107.4264).

    ``accuracy`` / ``impl`` configure the raced X engine
    (ops.linalg.XEngine).  ``fusable=True`` returns the stage-backed
    :class:`CorrelateStageBlock` (integration within each gulp); the
    default is the stateful :class:`CorrelateBlock` (integration across
    gulps)."""
    if fusable:
        return CorrelateStageBlock(iring, nframe_per_integration,
                                   accuracy, impl, *args, **kwargs)
    return CorrelateBlock(iring, nframe_per_integration, accuracy,
                          impl, *args, **kwargs)
