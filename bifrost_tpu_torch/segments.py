"""Compiled pipeline segments: a chain of device stage blocks run as one
call from its head ring to its tail ring, the rings between them elided
(the port of ``bifrost_tpu/segments.py``).

Macro-gulp execution (:mod:`bifrost_tpu_torch.macro`) amortizes the
Python dispatch of each block; every block boundary still costs a
dispatch and a ring handoff (reserve, commit, acquire, release, the
tensor parked in a chunk map).  The segment compiler removes those: a
pass over the pipeline graph, run by ``Pipeline.run`` under
``BF_SEGMENTS`` / ``Pipeline(segments=...)``, finds maximal linear chains
of stage blocks (``FusedBlock`` and the ``_StageBlock`` family) whose
interior rings have one reader, no view, no overlap the chain cannot
carry, and no host, mesh or supervision boundary, and replaces each by
one :class:`SegmentBlock`.  The interior rings get no writer thread and
no span; rings remain only at the boundaries that did not fuse.

A SegmentBlock runs the members' own functions in stream order on the
tensor its head reads, each built for the shape it is given exactly as
the member block would build it (a FusedBlock member with its kernel
substitution, a stage block with its stage), so its output equals the
unfused chain's byte for byte: the same torch ops and kernels run in the
same order, only without the rings between them.  It is a FusedBlock,
so it batches macro-gulp spans, carries a lookahead halo ('block'-mode
chains) and donates like one.

The planner (:func:`plan`) gives one reason slug (:data:`REASONS`, the
JAX package's, treated as API) for every device-ring boundary that did
not fuse; the JAX static verifier's BF-I190 diagnostic reads the same
planner, and the port's will when ``analysis`` is ported, so ``plan``
depends on nothing but the blocks and rings it is given.

Modes (``BF_SEGMENTS`` / ``Pipeline(segments=...)``): ``off`` (default;
no planning), ``auto`` (fuse every provably safe chain of two or more
blocks), ``force`` (as ``auto``, but raise :class:`SegmentPlanError` when
no segment forms).

The members' telemetry survives fusion (:mod:`bifrost_tpu_torch.
telemetry.segments`): ``block.<member>.gulps``, synthesized compute
spans and SLO commit ages, and the members' perf proclogs; the
``block.*.dispatches`` counters count segments, not members.
:func:`retune_split` splits a segment into sequential parts at member
boundaries (the auto-tuner's knob; the tuner itself is not ported).
"""

from __future__ import annotations

import os

__all__ = ['MODES', 'REASONS', 'resolve_mode', 'plan',
           'compile_pipeline', 'SegmentBlock', 'retune_split',
           'SegmentPlanError']

MODES = ('off', 'auto', 'force')

#: fusion-breaking reason slugs, the JAX package's (tests compare them)
REASONS = {
    'multi_reader': 'interior ring has more than one reader',
    'tap': 'a block_view tap reads the interior ring through a view',
    'overlap': 'consumer declares overlap/ghost history across gulps '
               'that the chain cannot carry in-program (not a '
               "'block'-mode stage chain, or the declared overlap "
               'does not match the stage-derived lookahead)',
    'overlap_carried': 'consumer overlap/ghost history is carried '
                       'INSIDE the compiled segment (halo carry): the '
                       'boundary fused, the ghost frames ride the '
                       'span head once, and the interior ring is '
                       'elided',
    'host': 'one side is not a jit-backed device stage block',
    'bridge': 'one side is a cross-host bridge endpoint',
    'mesh_reshard': 'the boundary crosses inequivalent mesh scopes',
    'tunables': 'the blocks resolve different scope tunables',
    'supervision': 'a block pins its own failure policy (restart/skip '
                   'blast radius must stay per-block)',
    'unguaranteed': 'the consumer reads unguaranteed',
    'collective': 'the block owns a cross-device collective schedule '
                  '(e.g. the correlator corner turn): its dispatch '
                  'boundary is the collective\'s synchronization '
                  'point and cannot be folded into a neighbour\'s '
                  'program',
    'disabled': 'segment compilation is off (BF_SEGMENTS)',
}


class SegmentPlanError(RuntimeError):
    """Raised in ``force`` mode when no segment forms; the message lists
    every boundary's reason."""


def resolve_mode(arg=None):
    """The compiler's mode, 'off' | 'auto' | 'force': ``arg`` is the
    ``Pipeline(segments=...)`` value, None deferring to ``BF_SEGMENTS``
    (off by default)."""
    if arg is None:
        arg = os.environ.get('BF_SEGMENTS', '')
    if isinstance(arg, str):
        val = arg.strip().lower()
        if val in ('1', 'on', 'auto', 'true', 'yes'):
            return 'auto'
        if val == 'force':
            return 'force'
        return 'off'
    return 'auto' if arg else 'off'


# ---------------------------------------------------------------------------
# planning
# ---------------------------------------------------------------------------

def _base(ring):
    return getattr(ring, '_base_ring', ring)


def _stage_chain(block):
    from .blocks.fused import device_stages
    return device_stages(block)


def _eligible(block):
    """Whether ``block`` can be a segment member: stage-backed, one
    'cuda' input ring and one 'cuda' output ring, reading guaranteed."""
    if _stage_chain(block) is None:
        return False
    irings = getattr(block, 'irings', None) or []
    orings = getattr(block, 'orings', None) or []
    if len(irings) != 1 or len(orings) != 1:
        return False
    if _base(irings[0]).space != 'cuda' or _base(orings[0]).space != 'cuda':
        return False
    return bool(getattr(block, 'guarantee', True))


class _FakeSeq(object):
    """A header-less read sequence for the static overlap probe."""
    header = {}


def _static_overlap(block):
    """The consumer's declared input overlap, where it derives without a
    sequence; None (treated as overlap) when the probe raises."""
    try:
        seqs = [_FakeSeq() for _ in block.irings]
        ov = list(block._define_input_overlap_nframe(seqs))
        return max(ov) if ov else 0
    except Exception:
        return None


#: tunables carried from the chain head onto the SegmentBlock: the head's
#: own pins only, never scope-resolved values (those keep flowing from
#: the scope the segment is built under, so a later retune of the
#: pipeline's value still reaches it)
_CARRIED_TUNABLES = ('core', 'mesh', 'gulp_nframe', 'buffer_factor',
                     'buffer_nframe', 'sync_depth', 'sync_strict')
#: must resolve equal across the chain for it to fuse
_COMPAT_TUNABLES = _CARRIED_TUNABLES + ('donate', 'gulp_batch')


def _compatible(a, b):
    for t in _COMPAT_TUNABLES:
        va, vb = getattr(a, t), getattr(b, t)
        if va is not vb and va != vb:
            return False
    return True


def _pins_supervision(block):
    """Whether the block pins its own failure policy: fusing it would
    widen a per-block restart or skip to the whole segment."""
    d = block.__dict__
    return any(d.get('_' + k) is not None
               for k in ('on_failure', 'max_restarts', 'restart_backoff'))


def _meshes_ok(a, b):
    """Both blocks outside a mesh, or under meshes of the same axes and
    ranks (mesh boundaries beyond this wait for the mesh tier's segment
    plans)."""
    ma, mb = getattr(a, 'mesh', None), getattr(b, 'mesh', None)
    if ma is None or mb is None:
        return ma is mb
    if ma is mb:
        return True
    try:
        return (ma.axis_names == mb.axis_names and ma.shape == mb.shape
                and ma.devices.tolist() == mb.devices.tolist())
    except Exception:
        return False


def _is_bridge(block):
    """Whether ``block`` is a bridge endpoint: a cross-host boundary that
    never fuses."""
    from .blocks.bridge import BridgeSink, BridgeSource
    return isinstance(block, (BridgeSink, BridgeSource))


def _boundary_reason(producer, oring, consumers, mode):
    """Why the boundary at ``producer``'s output ring does not fuse, as a
    :data:`REASONS` slug, or None when it fuses ('overlap_carried' also
    fuses: the consumer's overlap is carried inside the segment)."""
    if _is_bridge(producer) or any(_is_bridge(c) for c in consumers):
        return 'bridge'
    if len(consumers) != 1:
        return 'multi_reader'
    c = consumers[0]
    if not any(r is oring for r in (getattr(c, 'irings', None) or [])):
        # the one consumer reads the ring through a view: fusion would
        # drop the view's header transform
        return 'tap'
    if not getattr(c, 'guarantee', True):
        return 'unguaranteed'
    if getattr(producer, '_collective_boundary', False) or \
            getattr(c, '_collective_boundary', False):
        return 'collective'
    if not _eligible(producer) or not _eligible(c):
        return 'host'
    ov = _static_overlap(c)
    if ov is None:
        return 'overlap'
    # the halo carry: the merged chain must be 'block' mode (any span
    # length computes with the same per-frame math), the consumer's
    # declared overlap must be its stages' lookahead, and the merged
    # lookahead must convert to whole head-input frames.  A zero-overlap
    # boundary behind a lookahead stage needs the same proof: its ghost
    # frames reach the consumer
    from .macro import chain_batch_mode
    from .stages import chain_overlap_nframe
    carried = False
    merged = (_stage_chain(producer) or []) + (_stage_chain(c) or [])
    merged_ov = chain_overlap_nframe(merged)
    if ov or merged_ov is None or merged_ov != 0:
        if merged_ov is None or chain_batch_mode(merged) != 'block' or \
                chain_overlap_nframe(_stage_chain(c) or []) != ov:
            return 'overlap'
        carried = bool(ov)
    if not _meshes_ok(producer, c):
        return 'mesh_reshard'
    if not _compatible(producer, c):
        return 'tunables'
    if _pins_supervision(producer) or _pins_supervision(c):
        return 'supervision'
    if mode == 'off':
        return 'disabled'
    return 'overlap_carried' if carried else None


def plan(pipeline, mode=None):
    """Walk ``pipeline``'s blocks and rings; return ``(chains,
    boundaries)``: the maximal fusable linear chains (lists of two or
    more blocks in stream order; none in 'off' mode), and one record
    ``{'ring', 'producer', 'consumer', 'reason'}`` for each device-ring
    boundary with a reason ('overlap_carried' records fuse).  The
    pipeline is not changed."""
    if mode is None:
        mode = resolve_mode(getattr(pipeline, 'segments', None))
    blocks = list(pipeline.blocks)
    consumers = {}
    for b in blocks:
        for r in getattr(b, 'irings', None) or []:
            consumers.setdefault(id(_base(r)), []).append(b)
    boundaries = []
    nxt, prev = {}, {}
    for p in blocks:
        for oring in getattr(p, 'orings', None) or []:
            base = _base(oring)
            cs = consumers.get(id(base), [])
            if not cs:
                continue
            # device rings are the candidates; a host ring is reported
            # only where a bridge endpoint sits on it
            if getattr(base, 'space', None) != 'cuda' and \
                    not (_is_bridge(p) or any(_is_bridge(c) for c in cs)):
                continue
            reason = _boundary_reason(p, oring, cs, mode)
            if reason is None or reason == 'overlap_carried':
                nxt[id(p)] = cs[0]
                prev[id(cs[0])] = p
            if reason is not None:
                boundaries.append({
                    'ring': getattr(base, 'name', '?'),
                    'producer': getattr(p, 'name', '?'),
                    'consumer': ','.join(getattr(c, 'name', '?')
                                         for c in cs),
                    'reason': reason})
    chains = []
    for b in blocks:
        if id(b) in nxt and id(b) not in prev:
            chain = [b]
            while id(chain[-1]) in nxt:
                chain.append(nxt[id(chain[-1])])
            chains.append(chain)
    return chains, boundaries


# ---------------------------------------------------------------------------
# the segment runner
# ---------------------------------------------------------------------------

#: the runner class, made on first use (blocks.fused imports the
#: pipeline, which imports this module)
SegmentBlock = None


def _segment_block_cls():
    global SegmentBlock
    if SegmentBlock is not None:
        return SegmentBlock
    from .blocks.fused import FusedBlock
    from .macro import build_batched_fn, chain_batch_mode, split_ranges
    from .proclog import ProcLog
    from .stages import compose_stages

    class _SegmentBlock(FusedBlock):
        """One call standing in for a fused chain of stage blocks: a
        FusedBlock whose plan runs the members' functions in turn
        (prewarm, macro spans, the halo carry and donation included),
        with the members' telemetry synthesized from its dispatches and
        the split knob of :func:`retune_split`."""

        def __init__(self, iring, stages, members, member_sizes,
                     member_substitute, elided_rings, *args, **kwargs):
            super(_SegmentBlock, self).__init__(iring, stages, *args,
                                                **kwargs)
            #: member block names, in stream order
            self._members = list(members)
            #: stages of each member (splits land on member boundaries)
            self._member_sizes = list(member_sizes)
            #: each member's kernel substitution (FusedBlock members)
            self._member_substitute = list(member_substitute)
            self._elided = list(elided_rings)
            #: perf proclogs of the replaced blocks, kept publishing
            self._member_proclogs = []
            #: the split knob (retune_split), read once a sequence
            self._segment_split = 0
            self._splits_active = 0
            self._split_plans = {}
            self._gulp_index = 0
            #: calls the last on_data made (splits + 1 when split)
            self._last_ndispatches = 1
            ProcLog(self.name + '/segment').update(
                {'nmembers': len(self._members),
                 'members': ','.join(self._members),
                 'elided': ','.join(self._elided), 'split': 0},
                force=True)

        # -- the members' functions --------------------------------------
        def _member_ranges(self):
            lo = 0
            for size, sub in zip(self._member_sizes,
                                 self._member_substitute):
                yield lo, lo + size, sub
                lo += size

        def _member_fn(self, lo, hi, substitute):
            """One member's function, built per input shape and dtype as
            the member block builds it."""
            cache = {}
            stages, headers = self.stages[lo:hi], self._headers[lo:hi + 1]

            def fn(x):
                key = (tuple(x.shape), x.dtype)
                f = cache.get(key)
                if f is None:
                    f = cache[key] = compose_stages(
                        stages, headers, x.shape, x.dtype,
                        substitute=substitute)[0]
                return f(x)
            return fn

        def _chain_fn(self, parts):
            """The members of ``parts`` (a list of (lo, hi, substitute))
            run in turn."""
            fns = [self._member_fn(lo, hi, sub) for lo, hi, sub in parts]

            def fn(x):
                for f in fns:
                    x = f(x)
                return x
            return fn

        def _compose(self, shape, dtype):
            """The FusedBlock hook: the whole segment as one function
            (the members' composition, not the merged chain's, so that
            no substitution spans a former block boundary)."""
            return self._chain_fn(list(self._member_ranges())), \
                {'impl': 'segment', 'members': len(self._members)}

        # -- sequencing ---------------------------------------------------
        def on_sequence(self, iseq):
            self._splits_active = self._resolve_splits()
            self._split_plans = {}
            ohdr = super(_SegmentBlock, self).on_sequence(iseq)
            self._gulp_index = 0
            ProcLog(self.name + '/segment').update(
                {'split': self._splits_active}, force=True)
            return ohdr

        def _prewarm(self, ihdr):
            # a split sequence never runs the whole-segment plan
            if not self._splits_active:
                super(_SegmentBlock, self)._prewarm(ihdr)

        def _resolve_splits(self):
            """The split count of the next sequence: the knob clamped to
            the member boundaries.  A split composes with a carried halo:
            every part is 'block' mode and computes the whole span, the
            ghost frames only reaching frames that go uncommitted."""
            try:
                n = int(self._segment_split)
            except (TypeError, ValueError):
                n = 0
            return max(0, min(n, len(self._members) - 1))

        def _split_plan(self, part, lo, hi, shape):
            """The function of one part (stages [lo, hi)) at ``shape``:
            its members in turn, under a macro batch cut at the part's
            own gulp (a frame-reducing member upstream shrinks it)."""
            key = (self._splits_active, part, tuple(shape))
            fn = self._split_plans.get(key)
            if fn is not None:
                return fn
            fn = self._chain_fn([m for m in self._member_ranges()
                                 if lo <= m[0] and m[1] <= hi])
            gulp = self._macro_gulp_in
            if self._gulp_batch_active > 1 and gulp:
                for st in self.stages[:lo]:
                    gulp = st.output_nframe(gulp)
                headers = self._headers[lo:hi + 1]
                fn = build_batched_fn(
                    lambda _shape, f=fn: f,
                    headers[0]['_tensor']['shape'].index(-1),
                    headers[-1]['_tensor']['shape'].index(-1), int(gulp),
                    (tuple(shape),), chain_batch_mode(self.stages[lo:hi]))
            self._split_plans[key] = fn
            return fn

        def _execute_split(self, x):
            """Run the parts in turn, each a call of its own over the
            whole span, the interior tensors passed straight on; returns
            the output and the call count."""
            ranges = split_ranges(self._member_sizes, self._splits_active)
            for part, (lo, hi) in enumerate(ranges):
                x = self._split_plan(part, lo, hi, x.shape)(x)
            return x, len(ranges)

        # -- the hot path -------------------------------------------------
        def on_data(self, ispan, ospan):
            import time
            from .telemetry import segments as _tseg
            from .telemetry import spans as _spans
            t0 = time.perf_counter()
            t0_us = _spans.now_us()
            if self._splits_active:
                x = self._take_donatable(ispan)
                out, ndisp = self._execute_split(
                    x if x is not None else ispan.data)
                ospan.set(out, owned=True)
            else:
                super(_SegmentBlock, self).on_data(ispan, ospan)
                ndisp = 1
            dur_s = time.perf_counter() - t0
            ngulps = 1
            if self._gulp_batch_active > 1 and self._macro_gulp_in:
                # a carried halo rides the span head once: history, not
                # a gulp
                ngulps = max(1, -(-(ispan.nframe - self._macro_overlap_in)
                                  // self._macro_gulp_in))
            _tseg.note_dispatch(
                self.name, self._members, ndispatches=ndisp,
                ngulps=ngulps, t0_us=t0_us, dur_us=dur_s * 1e6,
                seq=self._seq_count - 1, gulp=self._gulp_index,
                trace=(self._trace_ctx or {}).get('id'),
                header=self._headers[0] if self._headers else None,
                frame_end=ispan.frame_offset + ispan.nframe)
            self._gulp_index += ngulps
            self._last_ndispatches = ndisp
            share = dur_s / max(len(self._member_proclogs), 1)
            for _name, log in self._member_proclogs:
                _tseg.publish_member_perf(
                    log, self.name, share,
                    gulps_per_dispatch=ngulps / float(max(ndisp, 1)))

        def _observe_dispatch(self, ngulps):
            """A split sequence makes splits + 1 calls an on_data:
            ``block.<segment>.dispatches`` counts them, as
            ``segment.dispatches`` does."""
            extra = max(self._last_ndispatches - 1, 0)
            self._last_ndispatches = 1
            super(_SegmentBlock, self)._observe_dispatch(ngulps)
            if extra:
                from .telemetry import counters
                counters.inc('block.%s.dispatches' % self.name, extra)

    _SegmentBlock.__name__ = 'SegmentBlock'
    SegmentBlock = _SegmentBlock
    return SegmentBlock


def retune_split(block, nsplits):
    """Set a segment's split count (0: one call; N: N + 1 sequential
    calls at member boundaries) for its next sequence; the sequence in
    flight keeps its plan.  Returns the value set, clamped to the member
    boundaries."""
    n = max(int(nsplits), 0)
    n = min(n, max(len(getattr(block, '_members', [])) - 1, 0))
    block._segment_split = n
    return n


# ---------------------------------------------------------------------------
# application (Pipeline._prepare_graph)
# ---------------------------------------------------------------------------

def compile_pipeline(pipeline, mode=None):
    """Plan and apply fusion to ``pipeline``: each chain is replaced by
    one SegmentBlock reading the head's input ring and writing the tail's
    output ring; the interior rings are left unwritten and unread.
    Returns the segments made; 'force' raises :class:`SegmentPlanError`
    when none forms (and none was made before)."""
    mode = resolve_mode(getattr(pipeline, 'segments', None)) \
        if mode is None else mode
    if mode == 'off':
        return []
    chains, boundaries = plan(pipeline, mode)
    if mode == 'force' and not chains and \
            not getattr(pipeline, '_segments', []):
        detail = '; '.join(
            '%s->%s over ring %r: %s'
            % (b['producer'], b['consumer'], b['ring'], b['reason'])
            for b in boundaries) or 'no device-ring boundaries found'
        raise SegmentPlanError(
            'BF_SEGMENTS=force but no compiled segment formed (%s)'
            % detail)
    from . import pipeline as _pl
    from .blocks.fused import FusedBlock
    from .telemetry import counters
    cls = _segment_block_cls()
    segments = []
    for chain in chains:
        head, tail = chain[0], chain[-1]
        stages, members, sizes, subs = [], [], [], []
        for blk in chain:
            st = _stage_chain(blk)
            stages.extend(st)
            members.append(blk.name)
            sizes.append(len(st))
            subs.append(isinstance(blk, FusedBlock) and
                        getattr(blk, 'substitute', True))
        elided_rings = [_base(blk.orings[0]) for blk in chain[:-1]]
        elided = [r.name for r in elided_rings]
        # built under the head's scope, registered with this pipeline
        _pl._stacks.pipelines.append(pipeline)
        _pl._stacks.scopes.append(head._parent_scope or pipeline)
        try:
            seg = cls(head.irings[0], stages, members, sizes, subs, elided,
                      name='Segment_x%d_%s'
                           % (len(chain), head.name.split('/')[-1]),
                      **{t: head.__dict__.get('_' + t)
                         for t in _CARRIED_TUNABLES})
        finally:
            _pl._stacks.scopes.pop()
            _pl._stacks.pipelines.pop()
        # the tail's output ring becomes the segment's, and its owner
        # follows (commit ages are named after it); the ring the segment
        # made for itself stays unused
        seg.orings = [tail.orings[0]]
        tail.orings[0].owner = seg
        #: the interior rings themselves, which nothing writes or reads
        seg._elided_rings = elided_rings
        seg._member_proclogs = [(blk.name, blk.perf_proclog)
                                for blk in chain]
        for blk in chain:
            pipeline.blocks.remove(blk)
            parent = blk._parent_scope
            if parent is not None and blk in parent._children:
                parent._children.remove(blk)
        counters.inc('segment.compiled')
        counters.inc('segment.elided_rings', len(elided))
        carried = sum(1 for b in boundaries
                      if b['reason'] == 'overlap_carried'
                      and b['producer'] in members)
        if carried:
            counters.inc('segment.overlap_carried', carried)
        segments.append(seg)
    pipeline._segments = list(getattr(pipeline, '_segments', [])) + \
        segments
    return segments
