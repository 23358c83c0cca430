"""FDMT dedispersion and the FRB-search blocks (the port of
``bifrost_tpu/blocks/fdmt.py``; reference:
python/bifrost/blocks/fdmt.py:38-140).

Input layout ``[..., 'freq', 'time']``: time is the frame axis and is
last, so 'freq' rides the ring's ringlet dimension.  The blocks overlap
successive input spans by their lookahead (``max_delay`` frames for
FDMT, ``ntap - 1`` for the matched filter): each span after the first is
stitched on the card from two committed chunks, and the block commits
the frames whose lookahead the span holds.  Under a mesh scope
:class:`FdmtBlock` shards each span's time axis over the mesh
(``parallel.ops.sharded_fdmt``: a max_delay halo from the neighbour
rank, the engine's core on every shard).

The stage blocks (``fdmt_stage``, ``matched_filter``, ``threshold``) batch
with their overlap under a macro batch K, the halo carry: a span is K * G
+ overlap frames, the ghost history rides its head once and the trailing
ghost frames go uncommitted.  In a compiled segment
(:mod:`bifrost_tpu_torch.segments`) the interior overlaps are carried
inside the one call and their rings are elided.
"""

from __future__ import annotations

import math
from copy import deepcopy

from ..dtype import DataType
from ..pipeline import TransformBlock
from ..units import convert_units
from ..ops.fdmt import Fdmt, KDM
from ..stages import FdmtStage, MatchedFilterStage, ThresholdStage
from .fft import _StageBlock

__all__ = ['FdmtBlock', 'fdmt', 'FdmtStageBlock', 'fdmt_stage',
           'MatchedFilterBlock', 'matched_filter',
           'ThresholdBlock', 'threshold']


class FdmtBlock(TransformBlock):
    def __init__(self, iring, max_dm=None, max_delay=None,
                 max_diagonal=None, exponent=-2.0, negative_delays=False,
                 *args, **kwargs):
        super(FdmtBlock, self).__init__(iring, *args, **kwargs)
        if sum(m is not None
               for m in (max_dm, max_delay, max_diagonal)) != 1:
            raise ValueError("Must specify exactly one of: max_dm, "
                             "max_delay, max_diagonal")
        self.max_value = max_dm or max_delay or max_diagonal or 0.
        self.max_mode = ('dm' if max_dm is not None else
                         'delay' if max_delay is not None else 'diagonal')
        self.dm_units = 'pc cm^-3'
        self.exponent = exponent
        self.negative_delays = negative_delays
        self.fdmt = Fdmt()
        self._mesh_fns = {}

    def define_valid_input_spaces(self):
        return ('cuda',)

    def on_sequence(self, iseq):
        ihdr = iseq.header
        itensor = ihdr['_tensor']
        labels = itensor['labels']
        if labels[-1] != 'time' or labels[-2] != 'freq':
            raise KeyError("Expected axes [..., 'freq', 'time'], got %s"
                           % labels)
        nchan = itensor['shape'][-2]
        f0_, df_ = itensor['scales'][-2]
        t0_, dt_ = itensor['scales'][-1]
        f0 = convert_units(f0_, itensor['units'][-2], 'MHz')
        df = convert_units(df_, itensor['units'][-2], 'MHz')
        dt = convert_units(dt_, itensor['units'][-1], 's')
        max_mode, max_value = self.max_mode, self.max_value
        if max_mode == 'diagonal':
            max_mode, max_value = 'delay', int(
                math.ceil(nchan * self.max_value))
        if max_mode == 'dm':
            max_dm = max_value
            rel_delay = (KDM / dt * max_dm *
                         (f0 ** -2 - (f0 + nchan * df) ** -2))
            self.max_delay = int(math.ceil(abs(rel_delay)))
        else:
            self.max_delay = int(max_value)
            fac = f0 ** -2 - (f0 + nchan * df) ** -2
            max_dm = self.max_delay * dt / (KDM * abs(fac))
        if self.negative_delays:
            max_dm = -max_dm
        self.dm_step = max_dm / self.max_delay
        self.fdmt.init(nchan, self.max_delay, f0, df, self.exponent,
                       space='cuda')
        # cached mesh fns close over the previous sequence's plan
        self._mesh_fns = {}
        # Pre-warm at sequence start, before any gulp flows: the core
        # race (its float64 gate included) lands here and not inside the
        # first on_data.  The expected span is stride + overlap frames; a
        # shrunk final span reuses the locked winner.  Errors propagate.
        gulp = self.gulp_nframe or ihdr.get('gulp_nframe')
        if gulp:
            shape = tuple(int(s) if s != -1 else int(gulp) + self.max_delay
                          for s in itensor['shape'])
            mesh_fn = self._mesh_fn(shape)
            if mesh_fn is not None:
                # the mesh path serves every full span: warm it (the
                # single-device warmup would pick a core at a width the
                # steady state never runs)
                import torch
                from ..device import get_device, stream_synchronize
                mesh_fn(torch.zeros(shape, dtype=torch.float32,
                                    device=get_device()))
                stream_synchronize()
            else:
                self.fdmt.warmup(shape,
                                 DataType(itensor['dtype']).as_torch_dtype(),
                                 negative_delays=self.negative_delays)
        ohdr = deepcopy(ihdr)
        refdm = convert_units(ihdr['refdm'], ihdr['refdm_units'],
                              self.dm_units) if 'refdm' in ihdr else 0.
        ohdr['_tensor']['dtype'] = 'f32'
        ohdr['_tensor']['shape'][-2] = self.max_delay
        ohdr['_tensor']['labels'][-2] = 'dispersion'
        ohdr['_tensor']['scales'][-2] = [refdm, self.dm_step]
        ohdr['_tensor']['units'][-2] = self.dm_units
        ohdr['max_dm'] = max_dm
        ohdr['max_dm_units'] = self.dm_units
        ohdr['cfreq'] = f0_ + 0.5 * (nchan - 1) * df_
        ohdr['cfreq_units'] = itensor['units'][-2]
        ohdr['bw'] = nchan * df_
        ohdr['bw_units'] = itensor['units'][-2]
        return ohdr

    def define_input_overlap_nframe(self, iseq):
        """Dispersion needs max_delay frames of lookahead
        (reference: blocks/fdmt.py define_input_overlap_nframe)."""
        return self.max_delay

    def _mesh_fn(self, shape):
        """Time-sharded transform over the scope mesh when the span
        admits it (2-D (nchan, T) data, time divisible by the mesh's time
        axis, per-shard window >= max_delay for the adjacent-neighbour
        halo).  Bit-identical to the single-device core:
        parallel.ops.sharded_fdmt fetches a max_delay halo via ppermute,
        and a shrunk final span falls back.  Built once per shape; None
        caches negative decisions too."""
        key = tuple(shape)
        if key in self._mesh_fns:
            return self._mesh_fns[key]
        fn = None
        mesh = self.mesh
        if mesh is not None and len(shape) == 2:
            from ..parallel.scope import time_axis_name
            tname = time_axis_name(mesh)
            n = int(mesh.shape[tname])
            T = int(shape[-1])
            if n > 1 and T % n == 0 and T // n >= self.max_delay:
                from ..parallel.ops import sharded_fdmt
                # per-shard windows are (nchan, T/n + halo): pick the
                # core (race it on the card) at that width; the winner is
                # locked, so a ragged later shape reuses it
                core = self.fdmt._pick_core(
                    self.negative_delays,
                    shape=(int(shape[0]), T // n + self.max_delay))
                sharded = sharded_fdmt(mesh, self.fdmt, tname,
                                       negative_delays=self.negative_delays,
                                       core=core)

                def fn(x, _sh=sharded):
                    # as the JAX mesh path: the input computes (and
                    # publishes) as f32
                    return _sh(x.float())
        self._mesh_fns[key] = fn
        return fn

    def on_data(self, ispan, ospan):
        if ispan.nframe <= self.max_delay:
            return 0
        x = ispan.data
        fn = self._mesh_fn(tuple(x.shape))
        if fn is not None:
            ospan.set(fn(x))
            return
        ospan.set(self.fdmt.execute(x, negative_delays=self.negative_delays))


def fdmt(iring, max_dm=None, max_delay=None, max_diagonal=None,
         exponent=-2.0, negative_delays=False, *args, **kwargs):
    """Block: Fast Dispersion Measure Transform (incoherent dedispersion
    for pulsar/FRB searches; reference docstring: blocks/fdmt.py:129-178)."""
    return FdmtBlock(iring, max_dm, max_delay, max_diagonal, exponent,
                     negative_delays, *args, **kwargs)


class FdmtStageBlock(_StageBlock):
    """Stage-backed FDMT: the transform of :class:`FdmtBlock` driven by
    :class:`bifrost_tpu_torch.stages.FdmtStage`, with a fixed
    ``max_delay`` (the FRB-search chain fdmt_stage -> matched_filter ->
    threshold).  Its core is raced when the stage builds for the first
    gulp.  :class:`FdmtBlock` keeps the max_dm/max_diagonal sizing modes."""

    def __init__(self, iring, max_delay, exponent=-2.0,
                 *args, **kwargs):
        super(FdmtStageBlock, self).__init__(
            iring, FdmtStage(max_delay, exponent), *args, **kwargs)


def fdmt_stage(iring, max_delay, exponent=-2.0, *args, **kwargs):
    """Block: stage-backed FDMT (fixed ``max_delay`` sizing; see
    :class:`FdmtStageBlock`)."""
    return FdmtStageBlock(iring, max_delay, exponent, *args, **kwargs)


class MatchedFilterBlock(_StageBlock):
    """Boxcar matched filter along the time axis: output frame t is the
    fixed-order sum of input frames [t, t + ntap), the width-matched
    detection filter of dispersed-pulse searches.  Declares ``ntap - 1``
    frames of lookahead."""

    def __init__(self, iring, ntap, *args, **kwargs):
        super(MatchedFilterBlock, self).__init__(
            iring, MatchedFilterStage(ntap), *args, **kwargs)


def matched_filter(iring, ntap, *args, **kwargs):
    """Block: boxcar matched filter over ``ntap`` time frames (see
    :class:`MatchedFilterBlock`)."""
    return MatchedFilterBlock(iring, ntap, *args, **kwargs)


class ThresholdBlock(_StageBlock):
    """Peak detect: zero every sample below ``threshold``, keep the rest;
    the candidate sink reads the survivors off the ring."""

    def __init__(self, iring, threshold, *args, **kwargs):
        super(ThresholdBlock, self).__init__(
            iring, ThresholdStage(threshold), *args, **kwargs)


def threshold(iring, threshold, *args, **kwargs):
    """Block: peak detect against a fixed ``threshold`` (see
    :class:`ThresholdBlock`)."""
    return ThresholdBlock(iring, threshold, *args, **kwargs)
