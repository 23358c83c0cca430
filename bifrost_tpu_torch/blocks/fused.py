"""FusedBlock: run a chain of device stages as one function per gulp, or
per macro-gulp span (the port of ``bifrost_tpu/blocks/fused.py``).

The JAX package jits the composed chain into one XLA program per gulp
shape.  The port composes the same stages with
:func:`bifrost_tpu_torch.stages.compose_stages`, which substitutes the
hand-written whole-chain kernel where the chain matches it (the Guppi
spectrometer K1, the beamform-and-detect K6), and keeps one plan per
(shape, dtype, donate) and, for macro-gulp spans, per (part shapes,
dtype, donate, G, mode).

- **Prewarm**: at sequence start the block builds and runs its plan
  once on zeros of the gulp shape (and, under a macro batch, of the
  K-gulp shape plus the chain's overlap), so that plan building, cuFFT
  plans and engine races are not paid by the first gulp.  An error there
  raises, as kernel errors do in the port.
- **Macro-gulp spans** (:mod:`bifrost_tpu_torch.macro`): a 'block'-mode
  chain runs once on the stacked span (the substitutions still match at
  K * G frames); a 'sliced' chain runs per G-frame slice in one call.
  A chain with a lookahead carries its overlap once per span (the halo
  carry).
- **Donation**: under ``donate`` the block claims its input chunk out of
  the ring (or, on a macro span fed by a K = 1 producer, the chunks
  tiling it, joined by one ``torch.cat``) and drops it once the plan has
  read it; ``impl_info['donate_argnums']`` records it.

Mesh plans (the JAX block's ``frame_local_plan`` and GSPMD shardings)
are not ported.
"""

from __future__ import annotations

from ..pipeline import TransformBlock
from ..proclog import ProcLog
from ..telemetry import counters as _counters

__all__ = ['FusedBlock', 'fused', 'device_stages']


def device_stages(block):
    """The stage chain ``block`` runs as device math, or None when it is
    not stage-backed (host blocks, copies, sources and sinks): the
    segment compiler's eligibility primitive.  A FusedBlock gives its
    whole chain, a stage block its one stage."""
    from .fft import _StageBlock
    if isinstance(block, FusedBlock):
        return list(block.stages)
    if isinstance(block, _StageBlock):
        return [block._stage]
    return None


class FusedBlock(TransformBlock):
    _profile_eligible = True

    def __init__(self, iring, stages, *args, substitute=True, **kwargs):
        super(FusedBlock, self).__init__(iring, *args, **kwargs)
        self.stages = list(stages)
        self.substitute = substitute
        #: plans keyed by (shape, dtype, donate) for a gulp and by
        #: ('macro', part shapes, dtype, donate, G, mode) for a macro
        #: span; each a function, its info in ``_plan_impls``
        self._plans = {}
        self._plan_impls = {}
        #: a dict of plans shared between blocks of equal
        #: :meth:`plan_signature` (the JAX service tier's warm start);
        #: None, the default, turns it off.  Nothing in the port sets it
        #: until the service tier is ported
        self._plan_depot = None
        #: configuration of the plan that ran last, published to the
        #: ``<name>/impl`` proclog so benchmarks read what ran
        self.impl_info = None
        self._published_impl = None
        self._published_key = None
        self._last_built_impl = None
        #: plan runs made by :meth:`_prewarm` (each launches the chain's
        #: kernels once), so that a caller counting launches can tell
        #: them from the gulps'
        self.prewarm_runs = 0
        self._impl_proclog = ProcLog(self.name + '/impl')

    def define_valid_input_spaces(self):
        return ('cuda',)

    # -- plan sharing ------------------------------------------------------
    def plan_signature(self):
        """The identity of the math this block's plans run: the stages'
        types and scalar parameters.  Blocks with equal signatures build
        equal plans for equal keys; None when a stage holds anything but
        scalars (weights), whose plans are never shared."""
        chain = []
        for s in self.stages:
            items = []
            for k, v in sorted(vars(s).items()):
                if isinstance(v, (int, float, str, bool, bytes,
                                  type(None))):
                    items.append((k, v))
                elif isinstance(v, (tuple, list)) and all(
                        isinstance(x, (int, float, str, bool, type(None)))
                        for x in v):
                    items.append((k, tuple(v)))
                else:
                    return None
            chain.append((type(s).__name__, tuple(items)))
        return (type(self).__name__, tuple(chain))

    def _depot_fetch(self, key):
        """A plan for ``key`` from the depot, installed here, or None."""
        depot = self._plan_depot
        got = depot.get(key) if depot is not None else None
        if got is None:
            return None
        self._plans[key], self._plan_impls[key] = got
        _counters.inc('fused.plan_depot_hits')
        return got[0]

    def _depot_store(self, key):
        if self._plan_depot is not None:
            self._plan_depot[key] = (self._plans[key],
                                     self._plan_impls.get(key))

    def verify_header(self, ihdr):
        """The output header this chain advertises for ``ihdr``, from
        each stage's pure ``transform_header`` (the static verifier's
        propagation, ``bifrost_tpu/blocks/fused.py:114``): a stage that
        rejects the stream raises here, before gulp 0."""
        hdr = ihdr
        for stage in self.stages:
            hdr = stage.transform_header(hdr)
        return hdr

    # -- macro-gulp eligibility ----------------------------------------------
    def macro_gulp_safe(self):
        return True

    def macro_overlap_safe(self):
        """The halo carry: a 'block'-mode chain whose lookahead converts
        to whole input frames batches with its overlap, each committed
        output frame a fixed function of a bounded input window."""
        from ..macro import chain_batch_mode
        from ..stages import chain_overlap_nframe
        return chain_batch_mode(self.stages) == 'block' and \
            chain_overlap_nframe(self.stages) is not None

    def define_input_overlap_nframe(self, iseq):
        from ..stages import chain_overlap_nframe
        ov = chain_overlap_nframe(self.stages)
        if ov is None:
            raise ValueError('%s: the stage chain\'s lookahead does not '
                             'convert to a whole input-frame count'
                             % self.name)
        return ov

    def on_sequence(self, iseq):
        from ..stages import walk_headers
        self._headers = walk_headers(self.stages, iseq.header)
        self._plans = {}
        self._plan_impls = {}
        self._published_impl = None
        self._published_key = None
        self._donate_on = None
        self._prewarm(iseq.header)
        return self._headers[-1]

    def _prewarm(self, ihdr):
        """Build and run the plan once on zeros of the gulp's shape (a
        gulp plus the chain's overlap), and, when a macro batch K > 1 is
        set and no static fallback applies, of the K-gulp span's shape:
        the plan cache key is the hot path's, so the first gulp finds it
        built (``bifrost_tpu/blocks/fused.py:191-252``).  With donation
        on, the donating plans are built too (not run: in the port they
        are the same functions).  Unlike the JAX block, an error here
        raises."""
        t = ihdr.get('_tensor', {})
        gulp = self.gulp_nframe or ihdr.get('gulp_nframe')
        if not gulp or -1 not in t.get('shape', []):
            return
        from ..devrep import device_rep_zeros
        from ..macro import resolve_gulp_batch
        from ..stages import chain_overlap_nframe
        ov = chain_overlap_nframe(self.stages) or 0
        taxis = t['shape'].index(-1)
        shape = [int(gulp) + ov if s == -1 else int(s) for s in t['shape']]
        x = device_rep_zeros(shape, t['dtype'])
        self._execute_plan(x)
        self.prewarm_runs += 1
        if self._donation_on():
            self._plan_for(x, donate=True)
        k = resolve_gulp_batch(self)
        if k > 1 and self._macro_static_reason() is None and \
                (not ov or self.macro_overlap_safe()):
            shape[taxis] = int(gulp) * k + ov
            x = device_rep_zeros(shape, t['dtype'])
            self._execute_macro([x], False, int(gulp))
            self.prewarm_runs += 1
            if self._donation_on():
                self._macro_plan([x], True, int(gulp))

    def define_output_nframes(self, input_nframe):
        n = input_nframe
        for stage in self.stages:
            n = stage.output_nframe(n)
        return n

    # -- plans ---------------------------------------------------------------
    def _compose(self, shape, dtype):
        """The chain's function for one input shape and its info: the
        stages composed, with the whole-chain kernel substituted where
        it matches (``substitute``).  A SegmentBlock composes its
        members instead."""
        from ..stages import compose_stages
        return compose_stages(self.stages, self._headers, shape, dtype,
                              substitute=self.substitute)

    def _build_plan(self, shape, dtype, donate=False):
        # every plan build is counted (the JAX service tier's warm-start
        # gate reads it)
        _counters.inc('fused.plan_builds')
        fn, info = self._compose(shape, dtype)
        self._last_built_impl = dict(info, donate_argnums=[0]) \
            if donate else dict(info)
        return fn

    def _publish_impl(self, info, key):
        """Publish the configuration of the plan about to run, whenever
        the plan key or its info differs from the last published (donate
        toggling, a macro batch engaging, a new shape)."""
        self.impl_info = dict(info)
        if info == self._published_impl and key == self._published_key:
            return
        self._published_impl = dict(info)
        self._published_key = key
        self._impl_proclog.update(self.impl_info, force=True)

    def _plan_for(self, x, donate=False):
        key = (tuple(x.shape), x.dtype, bool(donate))
        plan = self._plans.get(key)
        if plan is None:
            plan = self._depot_fetch(key)
        if plan is None:
            plan = self._plans[key] = self._build_plan(x.shape, x.dtype,
                                                       donate)
            self._plan_impls[key] = self._last_built_impl
            self._depot_store(key)
        return key, plan

    def _execute_plan(self, x, donate=False):
        """Run the gulp plan for ``x``'s shape (built on a miss) and
        publish what ran; shared by on_data and _prewarm."""
        key, plan = self._plan_for(x, donate)
        self._publish_impl(self._plan_impls[key], key)
        return plan(x)

    def _macro_plan(self, parts, donate, gulp_nframe):
        """The macro-span plan for ``parts`` (built on a miss): the
        composed chain through :func:`bifrost_tpu_torch.macro.
        build_batched_fn`, its info carrying ``batch``, ``batch_mode``
        and, donating, ``donate_argnums`` (one per part)."""
        from ..macro import build_batched_fn, chain_batch_mode
        from ..stages import chain_overlap_nframe
        mode = chain_batch_mode(self.stages)
        part_shapes = tuple(tuple(p.shape) for p in parts)
        dtype = parts[0].dtype
        key = ('macro', part_shapes, dtype, bool(donate),
               int(gulp_nframe), mode)
        plan = self._plans.get(key)
        if plan is None:
            plan = self._depot_fetch(key)
        if plan is not None:
            return key, plan
        _counters.inc('fused.plan_builds')
        taxis_in = self._headers[0]['_tensor']['shape'].index(-1)
        taxis_out = self._headers[-1]['_tensor']['shape'].index(-1)
        info_box = {}

        def per_shape(shape):
            fn, info = self._compose(shape, dtype)
            info_box.update(info)
            return fn

        plan = build_batched_fn(per_shape, taxis_in, taxis_out,
                                int(gulp_nframe), part_shapes, mode)
        overlap = chain_overlap_nframe(self.stages) or 0
        nframe = sum(s[taxis_in] for s in part_shapes)
        info = dict(info_box, batch=-(-max(nframe - overlap, 1) //
                                      int(gulp_nframe)),
                    batch_mode=mode)
        if donate:
            info['donate_argnums'] = list(range(len(parts)))
        self._plans[key] = plan
        self._plan_impls[key] = info
        self._depot_store(key)
        return key, plan

    def _execute_macro(self, parts, donate, gulp_nframe):
        """Run one plan over a K-gulp span: ``parts`` is the span's input
        as one tensor or as the owned chunks tiling it (joined inside
        the plan)."""
        key, plan = self._macro_plan(parts, donate, gulp_nframe)
        self._publish_impl(self._plan_impls[key], key)
        return plan(*parts)

    def on_data(self, ispan, ospan):
        if self._gulp_batch_active > 1 and self._macro_gulp_in:
            x = self._take_donatable(ispan, allow_parts=True)
            if x is None:
                parts, donate = [ispan.data], False
            else:
                parts, donate = (x if isinstance(x, list) else [x]), True
            out = self._execute_macro(parts, donate, self._macro_gulp_in)
        else:
            x = self._take_donatable(ispan)
            donate = x is not None
            out = self._execute_plan(x if donate else ispan.data, donate)
        # a donated chunk's last references are the locals above: they go
        # when this call returns, after the plan has queued its work
        ospan.set(out, owned=True)


def fused(iring, stages, *args, **kwargs):
    """Block: run ``stages`` (see bifrost_tpu_torch.stages) as one
    composed function per gulp."""
    return FusedBlock(iring, stages, *args, **kwargs)
