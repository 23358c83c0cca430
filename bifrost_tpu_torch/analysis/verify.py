"""Static pipeline verifier, the pipeline half of
``bifrost_tpu/analysis/verify.py``.

Walks a Pipeline's block and ring graph before ``run()`` and reports
stable-coded diagnostics for misconfigurations that would otherwise show
as stalls, gulp-0 exceptions or silently lost performance:

- ``Pipeline.validate()`` returns the diagnostic list;
- ``BF_VALIDATE={off,warn,strict}`` gates ``Pipeline.run()`` (default
  ``warn``: diagnostics go to stderr, the ``analysis.diagnostics.*``
  counters and the ``analysis/verify`` ProcLog; ``strict`` refuses to
  start on any ``BF-E``);
- ``BF_LINT=1`` makes ``Pipeline.run()`` validate, report (one JSON
  line a pipeline into ``BF_LINT_OUT`` when set) and return without
  running.

The codes are the JAX package's (:data:`CODES`, the same catalog).  The
checks: tensor contracts (BF-E120/E121, through the blocks' pure
``verify_header`` halves and the sources' ``static_oheaders``), ring
sizing (BF-E101/W102, and BF-W110 for a bridge sink's credit window),
donation (BF-E130/W131), mesh boundaries (BF-W140/W141), bridge sinks
(BF-E150/W151/W152), macro-gulp eligibility (BF-W160/I161), quantized
rings on a float path (BF-W170), drop policies on guaranteed rings
(BF-E180) and bridge quotas (BF-W181), and the segment boundaries that
did not fuse (BF-I190/I191/I192, from the segment planner itself).  The
fabric, service and placement checks come with the control tiers.

Everything is best effort: where propagation stops the verifier says so
(``BF-I17x``) instead of guessing, a check that fails internally reports
``BF-I199``, and ``gate_run`` never lets a verifier failure stop a
pipeline in ``warn`` mode.
"""

from __future__ import annotations

import json
import math
import os
import sys
import threading
from copy import deepcopy

__all__ = ['Diagnostic', 'PipelineValidationError', 'CODES',
           'verify_pipeline', 'errors', 'warnings_',
           'format_report', 'gate_run', 'lint_intercept',
           'validate_mode', 'ring_capacity_floors', 'new_errors_vs',
           'scope_overrides']

#: stable diagnostic-code catalog: code -> one-line title.
#: BF-Exxx = error (strict mode refuses to run), BF-Wxxx = warning,
#: BF-Ixxx = info.  The catalog is the JAX package's, code for code; the
#: fabric, service and placement codes come with their tiers.
CODES = {
    'BF-E101': 'ring sized below the deadlock-freedom bound',
    'BF-W102': 'buffer_factor below the deadlock-freedom bound',
    'BF-W110': 'bridge credit window exceeds source-ring capacity',
    'BF-E120': 'invalid _tensor header (frame layout unresolvable)',
    'BF-E121': 'shape/dtype contract break across a block edge',
    'BF-E130': 'donation requested on a multi-reader ring',
    'BF-W131': 'donation requested with an unguaranteed consumer',
    'BF-W140': 'mesh boundary forces a per-gulp reshard',
    'BF-W141': 'mesh scope cannot shard the gulp geometry',
    'BF-E150': 'bridge credit window < 1',
    'BF-W151': 'bridge CRC requested on the v1 wire (no CRC field)',
    'BF-W152': 'bridge window > 1 on the v1 wire (no credit flow)',
    'BF-W160': 'macro-gulp batch requested but statically ineligible',
    'BF-I161': 'macro-gulp batch falls back on a host/compute block',
    'BF-E180': 'drop overload policy on a ring with a guaranteed '
               'reader that did not declare shed tolerance '
               '(silent-loss hazard)',
    'BF-W181': 'bridge per-stream quota smaller than one (macro-)span',
    'BF-W170': 'float GEMM path on ring-declared quantized (ci8/ci4) '
               'data',
    'BF-I170': 'header propagation stops at this block',
    'BF-I171': 'gulp geometry unknown; ring sizing not proven',
    'BF-I190': 'device-ring boundary did not fuse into a compiled '
               'segment',
    'BF-I191': 'boundary kept by a cross-device collective schedule '
               '(correlator corner turn / psum meeting point)',
    'BF-I192': 'overlap boundary fused WITH in-program halo carry '
               '(ghost history rides the segment span head; the '
               'interior ring is elided)',
    'BF-E200': 'fabric link endpoint mismatch',
    'BF-E201': 'fabric port collision',
    'BF-W202': 'fabric link window/stripe sizing hazard',
    'BF-W203': 'fabric link quota smaller than one (macro-)span',
    'BF-E210': 'duplicate tenant id in a service spec',
    'BF-E211': 'tenant quota smaller than one gulp span',
    'BF-W212': 'tenant core requests oversubscribe the host',
    'BF-W230': 'capture ring sized below two capture spans',
    'BF-W231': 'tenant quota below its declared ingest rate',
    'BF-E220': 'tenant core demand exceeds every schedulable host',
    'BF-E221': 'placement pins a tenant to an unknown fabric host',
    'BF-E222': 'placement fabric pre-gate failed (verify_fabric '
               'errors)',
    'BF-E223': 'placement service pre-gate failed (verify_service '
               'errors)',
    'BF-W224': 'placement oversubscribes a host; lower-priority '
               'tenants are displaced onto shared cores',
    'BF-I199': 'verifier check failed internally (diagnostic only)',
}

_SEVERITY = {'E': 'error', 'W': 'warning', 'I': 'info'}


class Diagnostic(object):
    """One verifier finding, anchored to a block and/or ring."""

    __slots__ = ('code', 'message', 'block', 'ring')

    def __init__(self, code, message, block=None, ring=None):
        assert code in CODES, 'unknown diagnostic code %r' % code
        self.code = code
        self.message = message
        self.block = block
        self.ring = ring

    @property
    def severity(self):
        return _SEVERITY[self.code[3]]

    @property
    def is_error(self):
        return self.code[3] == 'E'

    def as_dict(self):
        return {'code': self.code, 'severity': self.severity,
                'message': self.message, 'block': self.block,
                'ring': self.ring}

    def __repr__(self):
        where = self.block or self.ring or '?'
        return '%s [%s] %s' % (self.code, where, self.message)


class PipelineValidationError(RuntimeError):
    """Raised by ``Pipeline.run()`` under ``BF_VALIDATE=strict`` when
    the verifier reports any ``BF-E`` diagnostic."""

    def __init__(self, diagnostics):
        self.diagnostics = list(diagnostics)
        errs = [d for d in self.diagnostics if d.is_error]
        super(PipelineValidationError, self).__init__(
            'pipeline validation failed (BF_VALIDATE=strict): '
            '%d error(s)\n%s' % (len(errs), format_report(errs)))


def errors(diags):
    return [d for d in diags if d.severity == 'error']


def warnings_(diags):
    return [d for d in diags if d.severity == 'warning']


def format_report(diags):
    """Human-readable multi-line report (the lint output format)."""
    lines = []
    order = {'error': 0, 'warning': 1, 'info': 2}
    for d in sorted(diags, key=lambda d: (order[d.severity], d.code)):
        where = d.block or ''
        if d.ring:
            where += ('@' if where else '') + 'ring:%s' % d.ring
        lines.append('%s %-9s %-38s %s'
                     % (d.code, d.severity, where, d.message))
    return '\n'.join(lines)


def validate_mode():
    """Effective BF_VALIDATE mode: 'off' | 'warn' | 'strict'
    (default 'warn'; unrecognized values mean 'warn' so a typo never
    silently disables validation)."""
    mode = os.environ.get('BF_VALIDATE', 'warn').strip().lower()
    if mode in ('off', '0', 'none', ''):
        return 'off'
    if mode == 'strict':
        return 'strict'
    return 'warn'


# ---------------------------------------------------------------------------
# candidate-tunable overrides
# ---------------------------------------------------------------------------

_overrides_tl = threading.local()


class scope_overrides(object):
    """Thread-local candidate-tunable overrides that the checks read: how
    a caller asks "what would the verifier say at <candidate>?" without
    changing the live pipeline while block threads resolve the same
    tunables.  The keys read here are ``gulp_batch`` (a pipeline-level
    macro K candidate; blocks that pin their own value below the root
    keep it) and ``bridge_window`` (``{bridge sink name: window}``).
    Overrides shape only the calling thread's verdict."""

    def __init__(self, overrides):
        self.overrides = dict(overrides or {})

    def __enter__(self):
        _overrides_tl.value = self.overrides
        return self

    def __exit__(self, *exc):
        _overrides_tl.value = None
        return False


def _overrides():
    return getattr(_overrides_tl, 'value', None) or {}


def _pins_below_root(block, attr):
    """Whether any scope from ``block`` up to (but excluding) the root
    pipeline sets ``attr`` itself — such a pin survives a root-level
    retune, so a root-level override must not replace it."""
    s = block
    while s is not None:
        parent = s.__dict__.get('_parent_scope')
        if parent is None:
            return False             # s is the root
        if s.__dict__.get('_' + attr) is not None:
            return True
        s = parent
    return False


def _static_k_requested(block):
    """``resolve_gulp_batch(block)`` with any ``gulp_batch`` candidate
    from :class:`scope_overrides` applied at the root."""
    from ..macro import resolve_gulp_batch
    ov = _overrides()
    if 'gulp_batch' in ov and not _pins_below_root(block,
                                                   'gulp_batch'):
        try:
            return max(int(ov['gulp_batch']), 1)
        except (TypeError, ValueError):
            pass
    return resolve_gulp_batch(block)


def _bridge_window(b):
    """Effective credit window of bridge sink ``b``, with any
    ``bridge_window`` candidate from :class:`scope_overrides`."""
    ov = _overrides().get('bridge_window') or {}
    w = ov.get(getattr(b, 'name', None))
    if w is None:
        w = getattr(b, 'window', 1)
    try:
        return int(w)
    except (TypeError, ValueError):
        return 1


# ---------------------------------------------------------------------------
# graph model
# ---------------------------------------------------------------------------

class _Stream(object):
    """Statically-derived knowledge about one ring's stream: the
    advertised logical gulp (frames) and, when propagation succeeded,
    the sequence header a consumer will see."""

    __slots__ = ('gulp', 'header', 'src')

    def __init__(self, gulp=None, header=None, src=None):
        self.gulp = gulp
        self.header = header
        self.src = src


class _FakeSeq(object):
    """Minimal ReadSequence stand-in for pure overlap negotiation."""

    def __init__(self, header):
        self.header = header if header is not None else {}


def _base(ring):
    return getattr(ring, '_base_ring', ring)


def _ring_name(ring):
    return getattr(ring, 'name', '?')


class _Graph(object):
    def __init__(self, pipeline):
        self.pipeline = pipeline
        self.blocks = list(pipeline.blocks)
        self.consumers = {}       # id(base ring) -> [block]
        self.producers = {}       # id(base ring) -> block
        self.rings = {}           # id(base ring) -> ring
        for b in self.blocks:
            for r in getattr(b, 'irings', ()) or ():
                br = _base(r)
                self.rings.setdefault(id(br), br)
                self.consumers.setdefault(id(br), []).append(b)
            for r in getattr(b, 'orings', ()) or ():
                br = _base(r)
                self.rings.setdefault(id(br), br)
                self.producers[id(br)] = b
        self.streams = {}         # id(base ring) -> _Stream


# ---------------------------------------------------------------------------
# macro-batch / donation resolution shared with the runtime
# ---------------------------------------------------------------------------

def _macro_static_k(block, overlap=None, igulp=None):
    """Effective macro-gulp K for ``block`` derivable statically: the
    requested K when no static fallback applies (the same conditions
    ``MultiTransformBlock._resolve_macro_batch`` tests at run time —
    block safety, topology, guarantee, plus overlap and nframe
    linearity when the verifier knows them), else 1.  Returns
    ``(k, reason)``; reason is None when batching engages."""
    from ..pipeline import MultiTransformBlock
    try:
        k = _static_k_requested(block)
    except Exception:
        return 1, None
    if k <= 1:
        return 1, None
    if not isinstance(block, MultiTransformBlock):
        return 1, 'block'
    reason = block._macro_static_reason()
    if reason is None and overlap:
        # halo carry: a block that declares macro_overlap_safe() batches
        # WITH its lookahead (the span is K*stride + overlap frames) —
        # same test _resolve_macro_batch applies at run time
        try:
            safe = bool(block.macro_overlap_safe())
        except Exception:
            safe = False
        if not safe:
            reason = 'overlap'
    if reason is None and igulp:
        try:
            per = block._define_output_nframes([igulp])
            mac = block._define_output_nframes([igulp * k])
            if mac != [o * k for o in per]:
                reason = 'nonlinear'
        except Exception:
            reason = 'nonlinear'
    if reason is not None:
        return 1, reason
    return k, None


# ---------------------------------------------------------------------------
# header / gulp propagation
# ---------------------------------------------------------------------------

def _propagate(g, diags):
    from ..pipeline import SourceBlock
    # seed at sources (blocks with no input rings)
    for b in g.blocks:
        if getattr(b, 'irings', None):
            continue
        orings = getattr(b, 'orings', ()) or ()
        headers = None
        if isinstance(b, SourceBlock):
            try:
                headers = b.static_oheaders()
            except Exception:
                headers = None
        gulp = getattr(b, 'gulp_nframe', None)
        for i, r in enumerate(orings):
            hdr = None
            if headers:
                try:
                    hdr = deepcopy(headers[i])
                except Exception:
                    hdr = None
            g.streams[id(_base(r))] = _Stream(gulp=gulp, header=hdr,
                                              src=b)
        if orings and gulp is None:
            diags.append(Diagnostic(
                'BF-I171',
                'source %r advertises no static gulp geometry; '
                'downstream ring sizing cannot be proven' % b.name,
                block=b.name))

    # propagate through transforms to a fixpoint
    remaining = [b for b in g.blocks if getattr(b, 'irings', None)]
    progress = True
    while progress and remaining:
        progress = False
        for b in list(remaining):
            ins = [g.streams.get(id(_base(r))) for r in b.irings]
            if any(s is None for s in ins):
                continue
            remaining.remove(b)
            progress = True
            _propagate_block(g, b, ins, diags)
    # blocks fed by rings with no in-pipeline producer never resolve
    for b in remaining:
        for r in getattr(b, 'orings', ()) or ():
            g.streams.setdefault(id(_base(r)), _Stream())


def _propagate_block(g, b, ins, diags):
    orings = getattr(b, 'orings', ()) or ()
    # logical input gulps: the block's own tunable, else the
    # producer-advertised gulp
    igulps = [b.gulp_nframe or s.gulp for s in ins]
    ogulps = [None] * len(orings)
    if all(gulp is not None for gulp in igulps):
        try:
            ogulps = list(b._define_output_nframes(list(igulps)))
        except Exception:
            ogulps = [None] * len(orings)
    # header propagation through the pure transform half, when the
    # block exposes one (verify_header)
    ohdr = None
    ihdr = ins[0].header if ins else None
    vh = getattr(b, 'verify_header', None)
    if ihdr is not None and vh is not None:
        try:
            ohdr = vh(deepcopy(ihdr))
        except Exception as exc:
            diags.append(Diagnostic(
                'BF-E121',
                'block %r rejects the upstream stream contract '
                '(%s: %s) — this would raise in on_sequence at '
                'gulp 0' % (b.name, type(exc).__name__, exc),
                block=b.name,
                ring=_ring_name(_base(b.irings[0]))))
            ohdr = None
    elif ihdr is not None and vh is None and orings:
        diags.append(Diagnostic(
            'BF-I170',
            'block %r has no static header transform; shape/dtype '
            'verification stops here' % b.name, block=b.name))
    if ohdr is not None and len(orings) > 1:
        # verify_header derives one output header; secondary output
        # streams get none — say so instead of silently skipping
        # their downstream contract checks
        diags.append(Diagnostic(
            'BF-I170',
            'block %r has %d output rings but its header transform '
            'covers only the first; shape/dtype verification stops '
            'at outputs 2..%d' % (b.name, len(orings), len(orings)),
            block=b.name))
    for i, r in enumerate(orings):
        hdr_i = ohdr if i == 0 else None
        g.streams[id(_base(r))] = _Stream(gulp=ogulps[i] if
                                          i < len(ogulps) else None,
                                          header=hdr_i, src=b)


# ---------------------------------------------------------------------------
# checks
# ---------------------------------------------------------------------------

def _check_tensor_contracts(g, diags):
    from ..ring import _tensor_info
    for rid, stream in g.streams.items():
        if stream.header is None:
            continue
        try:
            _tensor_info(stream.header)
        except Exception as exc:
            src = stream.src.name if stream.src is not None else None
            diags.append(Diagnostic(
                'BF-E120',
                'sequence header on ring %r has an unresolvable '
                '_tensor frame layout (%s: %s)'
                % (_ring_name(g.rings[rid]), type(exc).__name__, exc),
                block=src, ring=_ring_name(g.rings[rid])))


def _consumer_geometry(g, b, ring, stream, diags):
    """(span_frames, hold_frames, overlap) of consumer ``b`` on
    ``ring``, or (None, None, None) when the gulp is unknown.  span =
    one acquired span (incl. overlap and macro K); hold = frames this
    consumer's guarantee can pin at once (a bridge sink's window holds
    several spans)."""
    gin = b.gulp_nframe or stream.gulp
    if gin is None:
        return None, None, None
    overlap = 0
    try:
        idx = [id(_base(r)) for r in b.irings].index(id(ring))
        seqs = [_FakeSeq(g.streams.get(id(_base(r)),
                                       _Stream()).header)
                for r in b.irings]
        overlap = list(b._define_input_overlap_nframe(seqs))[idx]
    except Exception:
        overlap = 0
    k, _reason = _macro_static_k(b, overlap=overlap, igulp=gin)
    # the overlap history rides each span ONCE (at the head), whatever
    # the macro batch: K strides plus one halo, not K halos
    span = k * gin + overlap
    hold = span
    from ..blocks.bridge import BridgeSink
    if isinstance(b, BridgeSink):
        hold = span * max(_bridge_window(b), 1)
    return span, hold, overlap


def _check_ring_sizing(g, diags):
    """Certain-deadlock / capacity checks: writer-resident span depth
    (macro K·G, doubled per the begin_sequences writer-depth rule) plus
    the largest guaranteed-reader pin must fit in what the sizing
    negotiation will provide (``Ring.resize`` takes the MAX over all
    requests, a bridge sender's own ``window + 2`` among them).  When the
    negotiated capacity falls short, an explicit ``buffer_nframe`` below
    the bound is an ERROR (the declared capacity deadlocks the writer)
    and an explicit ``buffer_factor`` below it is a warning; a bridge
    window that cannot fit beside the writer's resident span is a
    warning (BF-W110: the window caps itself and pipelining is lost)."""
    from ..blocks.bridge import BridgeSink
    for rid, stream in g.streams.items():
        producer = g.producers.get(rid)
        if producer is None or stream.gulp is None:
            continue
        ring = g.rings[rid]
        g_out = stream.gulp
        kw, _r = _macro_static_k(producer)
        writer_span = kw * g_out
        writer_request = (2 if kw > 1 else 1) * writer_span
        pins = []
        requests = [writer_request]
        cons = []
        for b in g.consumers.get(rid, ()):
            span, hold, _o = _consumer_geometry(g, b, ring, stream,
                                                diags)
            if span is None:
                diags.append(Diagnostic(
                    'BF-I171',
                    'consumer %r of ring %r has unknown gulp '
                    'geometry; its sizing is not proven'
                    % (b.name, _ring_name(ring)),
                    block=b.name, ring=_ring_name(ring)))
                continue
            guaranteed = bool(getattr(b, 'guarantee', True))
            if guaranteed:
                pins.append((b, hold))
            bf = getattr(b, 'buffer_factor', None)
            bnf = getattr(b, 'buffer_nframe', None)
            req = bnf if bnf is not None \
                else int(math.ceil((bf if bf is not None else 3)
                                   * span))
            if isinstance(b, BridgeSink):
                # RingSender resizes the source ring itself at run time
                # (buffer_factor=window+2), so the negotiated capacity
                # is never below that
                req = max(req, (_bridge_window(b) + 2) * span)
            requests.append(req)
            cons.append((b, span, hold, bnf, bf, req))
        if not pins:
            continue
        max_pin_block, max_pin = max(pins, key=lambda p: p[1])
        required = writer_span + max_pin
        # the runtime negotiation takes the MAX over all sizing
        # requests (Ring.resize), so one generous reader covers an
        # undersized declaration elsewhere — only flag declarations
        # when the ring's actual negotiated capacity falls short
        provided = max(requests)
        for b, span, hold, bnf, bf, req in (
                cons if provided < required else ()):
            if bnf is not None and bnf < required:
                diags.append(Diagnostic(
                    'BF-E101',
                    'ring %r is explicitly sized to buffer_nframe=%d '
                    'frames but needs >= %d (writer-resident span '
                    '%d%s + guaranteed reader %r pinning %d): the '
                    'declared capacity deadlocks the writer against '
                    'the pinned read guarantee'
                    % (_ring_name(ring), bnf, required, writer_span,
                       ' [macro K=%d]' % kw if kw > 1 else '',
                       max_pin_block.name, max_pin),
                    block=b.name, ring=_ring_name(ring)))
            elif bf is not None and req < required:
                diags.append(Diagnostic(
                    'BF-W102',
                    'ring %r: explicit buffer_factor=%s provides %d '
                    'frames, below the deadlock-freedom bound of %d '
                    '(writer span %d + largest guaranteed pin %d)'
                    % (_ring_name(ring), bf, req, required,
                       writer_span, max_pin),
                    block=b.name, ring=_ring_name(ring)))
        # bridge window against the source ring: the sender pins
        # ``window`` spans unacked; a ring that cannot hold them beside
        # the writer's span caps the credit pipeline
        for b, span, hold, bnf, bf, req in cons:
            if isinstance(b, BridgeSink) and \
                    _bridge_window(b) > 1 and \
                    provided < hold + writer_span:
                diags.append(Diagnostic(
                    'BF-W110',
                    'bridge sink %r holds a window of %d spans '
                    '(%d frames) but ring %r provides only %d '
                    'frames: the credit window is capped at ~%d '
                    'span(s), losing pipelining — raise the ring '
                    'buffering or lower BF_BRIDGE_WINDOW'
                    % (b.name, _bridge_window(b), hold,
                       _ring_name(ring), provided,
                       max((provided - writer_span) // max(span, 1),
                           1)),
                    block=b.name, ring=_ring_name(ring)))


def _check_donation(g, diags):
    from ..pipeline import TransformBlock, resolve_donate
    for b in g.blocks:
        if not isinstance(b, TransformBlock):
            continue
        irings = getattr(b, 'irings', ()) or ()
        if not irings or _base(irings[0]).space != 'cuda':
            continue
        try:
            if not resolve_donate(b):
                continue
        except Exception:
            continue
        rid = id(_base(irings[0]))
        readers = g.consumers.get(rid, [])
        ring = _ring_name(g.rings.get(rid, irings[0]))
        if len(readers) > 1:
            diags.append(Diagnostic(
                'BF-E130',
                'block %r requests buffer donation but its input ring '
                '%r has %d readers (%s): exclusivity is disprovable — '
                'a donated chunk would zero-fill under the other '
                'reader(s).  Drop donate= on this scope or give the '
                'taps their own copy'
                % (b.name, ring, len(readers),
                   ', '.join(x.name for x in readers)),
                block=b.name, ring=ring))
        elif not getattr(b, 'guarantee', True):
            diags.append(Diagnostic(
                'BF-W131',
                'block %r requests buffer donation but reads '
                'unguaranteed: an overwrite can race the exclusivity '
                'claim, so donation will mostly miss (and the claim '
                'is only point-in-time safe)' % b.name,
                block=b.name, ring=ring))


def _device_mesh(block):
    """The mesh a device block will execute its plans under, or None.
    Only blocks that build device plans count (FusedBlock, the
    stage blocks, CopyBlock device movers)."""
    from ..blocks.fused import FusedBlock
    from ..blocks.fft import _StageBlock
    from ..blocks.copy import CopyBlock
    if isinstance(block, (FusedBlock, _StageBlock)):
        return block.mesh, True
    if isinstance(block, CopyBlock):
        spaces = (_base(block.irings[0]).space,
                  _base(block.orings[0]).space) \
            if block.irings and block.orings else ()
        return block.mesh, 'cuda' in spaces
    return None, False


def _check_mesh(g, diags):
    from ..parallel.scope import meshes_equivalent, time_axis_size
    for rid, stream in g.streams.items():
        ring = g.rings[rid]
        if getattr(ring, 'space', None) != 'cuda':
            continue
        producer = g.producers.get(rid)
        if producer is None:
            continue
        pmesh, p_is_dev = _device_mesh(producer)
        for b in g.consumers.get(rid, ()):
            cmesh, c_is_dev = _device_mesh(b)
            if not c_is_dev:
                continue
            if cmesh is not None and stream.gulp is not None:
                try:
                    nsh = time_axis_size(cmesh)
                except Exception:
                    nsh = 1
                gin = b.gulp_nframe or stream.gulp
                if nsh > 1 and gin % nsh:
                    diags.append(Diagnostic(
                        'BF-W141',
                        'block %r runs under a %d-way mesh but its '
                        'gulp of %d frames does not divide it: every '
                        'gulp falls back to single-device plans and '
                        'the mesh never engages'
                        % (b.name, nsh, gin),
                        block=b.name, ring=_ring_name(ring)))
                    continue
            if not p_is_dev:
                continue
            if cmesh is None and pmesh is None:
                continue
            try:
                ok = meshes_equivalent(pmesh, cmesh)
            except Exception:
                ok = True
            if not ok:
                diags.append(Diagnostic(
                    'BF-W140',
                    'ring %r crosses a mesh boundary: producer %r '
                    'commits spans laid out for %s but consumer %r '
                    'expects %s — every gulp of the sequence will pay '
                    'a reshard (mesh.reshards > 0 predicted).  Put '
                    'both blocks under one mesh scope or insert an '
                    'explicit repartition point'
                    % (_ring_name(ring), producer.name,
                       _mesh_desc(pmesh), b.name, _mesh_desc(cmesh)),
                    block=b.name, ring=_ring_name(ring)))


def _mesh_desc(mesh):
    if mesh is None:
        return 'a single device (no mesh)'
    try:
        axes = ','.join('%s=%d' % (n, s)
                        for n, s in zip(mesh.axis_names,
                                        mesh.devices.shape))
        return 'mesh[%s]' % axes
    except Exception:
        return 'a different mesh'


def _check_bridge(g, diags):
    from ..blocks.bridge import BridgeSink
    for b in g.blocks:
        if not isinstance(b, BridgeSink):
            continue
        ov_w = (_overrides().get('bridge_window') or {}).get(b.name)
        req_w = ov_w if ov_w is not None \
            else getattr(b, 'requested_window', None)
        if req_w is not None and int(req_w) < 1:
            diags.append(Diagnostic(
                'BF-E150',
                'bridge sink %r configured with window=%s: the credit '
                'window must be >= 1 span (1 = fully synchronous '
                'v1-pump semantics); 0 would never grant the first '
                'span credit' % (b.name, req_w),
                block=b.name))
        if getattr(b, 'protocol', None) == 1:
            if getattr(b, 'crc', False):
                diags.append(Diagnostic(
                    'BF-W151',
                    'bridge sink %r requests CRC on the v1 wire, '
                    'which has no integrity field: the stream will '
                    'ship unchecked' % b.name, block=b.name))
            if _bridge_window(b) > 1:
                diags.append(Diagnostic(
                    'BF-W152',
                    'bridge sink %r requests a %d-span credit window '
                    'on the v1 wire, which is strictly '
                    'send-and-wait: the window setting is ignored'
                    % (b.name, _bridge_window(b)), block=b.name))


def _check_macro(g, diags):
    from ..pipeline import MultiTransformBlock
    for b in g.blocks:
        if not isinstance(b, MultiTransformBlock):
            continue
        try:
            if _static_k_requested(b) <= 1:
                continue
        except Exception:
            continue
        irings = getattr(b, 'irings', ()) or ()
        stream = g.streams.get(id(_base(irings[0]))) if irings \
            else None
        gin = None
        overlap = 0
        if stream is not None:
            gin = b.gulp_nframe or stream.gulp
            if gin is not None:
                try:
                    seqs = [_FakeSeq(g.streams.get(
                        id(_base(r)), _Stream()).header)
                        for r in b.irings]
                    overlap = max(
                        list(b._define_input_overlap_nframe(seqs)))
                except Exception:
                    overlap = 0
        _k, reason = _macro_static_k(b, overlap=overlap, igulp=gin)
        if reason is None:
            continue
        if reason == 'block':
            diags.append(Diagnostic(
                'BF-I161',
                'block %r is a host/compute block: the requested '
                'macro-gulp batch falls back to K=1 here (normal for '
                'sources/sinks; the device blocks of the chain still '
                'batch)' % b.name, block=b.name))
        else:
            diags.append(Diagnostic(
                'BF-W160',
                'block %r requests a macro-gulp batch but is '
                'statically ineligible (reason: %s): it will silently '
                'run K=1 and the configured batching buys nothing '
                'here — today this is only visible as a '
                'macro.fallback.%s counter' % (b.name, reason, reason),
                block=b.name))


def _check_quantization(g, diags):
    """BF-W170: a beamform/correlate (GEMM-class) block consuming a
    ring the header declares as ci8/ci4 — int8 (re, im) planes on
    the card, the int8 tensor-core path (K4, K7, K8) — but configured
    so only FLOAT candidates can run: the quantization
    win is left on the table.  For a BEAMFORM engine two ways to get
    here: the accuracy class excludes the int8 candidates from the
    race ('f32'/'bf16'), or BF_BEAM_IMPL / ``impl=`` forces a float
    candidate.  For the correlator X-ENGINE the int candidates are
    EXACT (no weight quantization) and race under every class, so
    only a forced float impl (BF_XCORR_IMPL / ``impl=``) can disable
    them — that is the one X-engine misconfiguration flagged."""
    from ..ops import beamform as _beam
    from ..ops import linalg as _linalg
    for b in g.blocks:
        irings = getattr(b, 'irings', None)
        if not irings:
            continue
        stream = g.streams.get(id(_base(irings[0])))
        hdr = stream.header if stream is not None else None
        if hdr is None:
            continue
        try:
            dtype = str(hdr['_tensor']['dtype'])
        except Exception:
            continue
        if dtype not in ('ci4', 'ci8'):
            continue
        stages = list(getattr(b, 'stages', None) or ())
        if getattr(b, '_stage', None) is not None:
            stages.append(b._stage)
        engines = []
        for s in stages:
            eng = getattr(s, 'engine', None)
            if eng is not None and hasattr(eng, 'accuracy'):
                engines.append(eng)
        beng = getattr(b, 'engine', None)    # stateful CorrelateBlock
        if beng is not None and hasattr(beng, 'accuracy') and \
                beng not in engines:
            engines.append(beng)
        for eng in engines:
            forced = getattr(eng, '_force', None)
            if isinstance(eng, _linalg.XEngine):
                # exact-int candidates are in the race at EVERY
                # accuracy class; only a float force disables them
                if forced and forced not in _linalg._XENGINE_INT_IMPLS:
                    diags.append(Diagnostic(
                        'BF-W170',
                        'block %r X-engine is forced to the %r float '
                        'candidate on a ring declared %s: the EXACT '
                        'int32 correlation path (bit-identical to the '
                        'int64 oracle) never engages — '
                        'force an int candidate (int8_3mm/int8_wide/'
                        'pallas) or drop the override'
                        % (b.name, forced, dtype),
                        block=b.name,
                        ring=_ring_name(_base(irings[0]))))
                continue
            if forced in _beam._INT_IMPLS:
                continue
            if forced is not None:
                diags.append(Diagnostic(
                    'BF-W170',
                    'block %r is forced to the %r float candidate on '
                    'a ring declared %s: the int8 voltage planes will '
                    'be promoted to float and the int8 tensor-core '
                    'path never engages — force an '
                    'int candidate (int8_wide/pallas) or drop the '
                    'override' % (b.name, forced, dtype),
                    block=b.name, ring=_ring_name(_base(irings[0]))))
            elif _beam.beam_class_rtol(eng.accuracy) < \
                    _beam.BEAM_CLASSES['int8']:
                diags.append(Diagnostic(
                    'BF-W170',
                    'block %r will beamform ring-declared %s data on '
                    'a float path: its %r accuracy class excludes the '
                    'int8 candidates from the race, so the int8 '
                    'tensor-core path is left on the '
                    "table — declare accuracy='int8' (weight "
                    'quantization ~2^-7) if the science tolerates it'
                    % (b.name, dtype, eng.accuracy),
                    block=b.name, ring=_ring_name(_base(irings[0]))))


# ---------------------------------------------------------------------------
# runtime-facing sizing model
# ---------------------------------------------------------------------------

def ring_capacity_floors(pipeline):
    """The BF-E101 deadlock-freedom bound per ring, as a runtime-facing
    dict, the floor below which no online ring retune may go (the JAX
    package's auto-tuner reads it; the port's is not ported yet):

        {ring_name: {'frames':      required frames (writer-resident
                                    span + largest guaranteed pin),
                     'bytes':       the same in bytes, or None when the
                                    frame layout could not be derived,
                     'writer_span': frames the producer keeps resident
                                    (macro K * G),
                     'max_pin':     frames the largest guaranteed
                                    reader can pin at once,
                     'unproven':    True when some consumer's geometry
                                    was unknowable statically (the
                                    floor is then a lower bound)}}

    Uses the SAME model as the ``BF-E101``/``BF-W102`` checks — macro
    K resolved from the current scope tunables, bridge windows counted
    as multi-span holds — so a controller that never sizes a ring
    below this floor can never tune into a configuration
    ``verify_pipeline`` would reject for sizing.  Rings whose gulp
    geometry is entirely unknown are omitted (nothing is provable
    there, and the controller must not touch what it cannot bound)."""
    from ..ring import _tensor_info
    g = _Graph(pipeline)
    diags = []
    try:
        _propagate(g, diags)
    except Exception:
        return {}
    floors = {}
    for rid, stream in g.streams.items():
        producer = g.producers.get(rid)
        if producer is None or stream.gulp is None:
            continue
        ring = g.rings[rid]
        kw, _r = _macro_static_k(producer)
        writer_span = kw * stream.gulp
        max_pin = 0
        unproven = False
        for b in g.consumers.get(rid, ()):
            span, hold, _o = _consumer_geometry(g, b, ring, stream,
                                                diags)
            if span is None:
                unproven = True
                continue
            if bool(getattr(b, 'guarantee', True)):
                max_pin = max(max_pin, hold)
        required = writer_span + max_pin
        nbyte = None
        if stream.header is not None:
            try:
                nbyte = required * \
                    _tensor_info(stream.header)['frame_nbyte']
            except Exception:
                nbyte = None
        floors[_ring_name(ring)] = {
            'frames': required, 'bytes': nbyte,
            'writer_span': writer_span, 'max_pin': max_pin,
            'unproven': unproven}
    return floors


def new_errors_vs(baseline_diags, candidate_diags):
    """The BF-E diagnostics in ``candidate_diags`` not already present
    (by (code, block, ring) identity) in ``baseline_diags`` — how a
    retune controller asks "would this retune INTRODUCE a configuration the
    static analyzer rejects?" without being blocked by pre-existing
    errors the operator chose to run with (``BF_VALIDATE=warn``)."""
    seen = {(d.code, d.block, d.ring) for d in baseline_diags
            if d.is_error}
    return [d for d in candidate_diags
            if d.is_error and (d.code, d.block, d.ring) not in seen]


def _check_overload(g, diags):
    """Overload-policy misconfigurations:

    - **BF-E180** — a drop overload policy on a ring read by a
      GUARANTEED consumer that did not declare ``shed_tolerant``: the
      reader's guarantee says "I must see every frame", the policy
      says "frames may be dropped"; the contradiction is a silent-loss
      hazard (gaps surface only as zero-filled skips the consumer
      never asked to tolerate).  Either make the consumer
      shed-tolerant (it handles ``nframe_skipped``/the ``_overload``
      header stamp), read unguaranteed, or keep the ring on 'block'.
    - **BF-W181** — a bridge sender's per-stream quota bucket is
      smaller than ONE span at the sequence's (macro-)gulp geometry:
      every span exceeds the bucket, so under a drop policy the
      stream sheds to zero throughput (and under 'block' every span
      pays full refill time)."""
    from ..pipeline import resolve_overload_policy
    from ..blocks.bridge import BridgeSink
    for b in g.blocks:
        try:
            policy = resolve_overload_policy(b)
        except ValueError as exc:
            diags.append(Diagnostic(
                'BF-E180', 'block %r: %s' % (b.name, exc),
                block=b.name))
            continue
        if policy in ('drop_oldest', 'drop_newest'):
            for oring in getattr(b, 'orings', ()) or ():
                rid = id(_base(oring))
                for consumer in g.consumers.get(rid, ()):
                    if not getattr(consumer, 'guarantee', True):
                        continue       # unguaranteed: loss is its
                                       # declared contract already
                    if getattr(consumer, 'shed_tolerant', None):
                        continue
                    diags.append(Diagnostic(
                        'BF-E180',
                        'ring %r runs overload policy %r but its '
                        'guaranteed reader %r never declared '
                        'shed_tolerant: drops would surface as '
                        'silent zero-filled gaps in a stream the '
                        'reader contracted to see whole.  Mark the '
                        'consumer BlockScope(shed_tolerant=True) '
                        '(it must handle nframe_skipped / the '
                        '_overload header stamp), read '
                        'unguaranteed, or keep the ring on '
                        "'block'"
                        % (_ring_name(oring), policy, consumer.name),
                        block=consumer.name,
                        ring=_ring_name(oring)))
    for b in g.blocks:
        if not isinstance(b, BridgeSink):
            continue
        quota = getattr(b, 'quota_bytes_per_s', None)
        if quota is None:
            from ..io.bridge import bridge_quota_mbps
            quota = bridge_quota_mbps() * 1e6
        if not quota or quota <= 0:
            continue
        irings = getattr(b, 'irings', ()) or ()
        if not irings:
            continue
        stream = g.streams.get(id(_base(irings[0])))
        if stream is None or stream.header is None:
            continue
        try:
            from ..ring import _tensor_info
            fb = _tensor_info(stream.header)['frame_nbyte']
            gulp = b.gulp_nframe or stream.gulp or 1
            k = _static_k_requested(b) or 1
            span_nbyte = int(gulp) * int(k) * int(fb)
        except Exception:
            continue
        # bucket capacity = one second of quota (io.bridge._TokenBucket)
        if span_nbyte > quota:
            diags.append(Diagnostic(
                'BF-W181',
                'bridge sink %r per-stream quota (%.0f B/s) is '
                'smaller than one %s-frame span (%d bytes, '
                'gulp=%s x K=%s): every span overflows the token '
                'bucket — a drop policy sheds the stream to zero, '
                "'block' rate-limits every span by its full refill "
                'time.  Raise the quota above one span per second '
                'or shrink the macro batch'
                % (b.name, quota, gulp * k, span_nbyte, gulp, k),
                block=b.name, ring=_ring_name(irings[0])))


def _check_segments(g, diags):
    """BF-I190: why each device-ring boundary did NOT fuse into a
    compiled segment (:mod:`bifrost_tpu_torch.segments`).  The reasons come from the SAME planner the
    compiler runs, so a segment can never form across a boundary this
    check cannot prove safe — they are one computation.  Mirrors
    BF-W160's job for macro-gulp: the runtime's silent fusion
    fallback, surfaced at submit time WITH the reason.  Info-level by
    design: an unfused boundary is the pre-segment status quo, not a
    misconfiguration."""
    from .. import segments as _segments
    mode = _segments.resolve_mode(getattr(g.pipeline, 'segments',
                                          None))
    _chains, boundaries = _segments.plan(g.pipeline, mode)
    for b in boundaries:
        if b['reason'] == 'overlap_carried':
            # NOT an unfused boundary: the planner lifted the former
            # 'overlap' break — the ghost history is carried inside
            # the compiled program and the interior ring is elided.
            # Reported so an operator can see WHERE carry engaged
            # (tools/telemetry_diff.py watches the matching
            # segment.overlap_carried counter for silent disengage).
            diags.append(Diagnostic(
                'BF-I192',
                'ring %r boundary %s -> %s fused with in-program halo '
                'carry (%s)'
                % (b['ring'], b['producer'], b['consumer'],
                   _segments.REASONS.get(b['reason'], '?')),
                block=b['producer'], ring=b['ring']))
            continue
        # the collective reason gets its own code: it is not the
        # generic "one side is host math" story — the block IS device
        # math but owns a cross-device collective schedule (the
        # correlator corner turn), so the boundary is structural
        code = 'BF-I191' if b['reason'] == 'collective' else 'BF-I190'
        diags.append(Diagnostic(
            code,
            'ring %r boundary %s -> %s did not fuse into a compiled '
            'segment (reason: %s — %s)'
            % (b['ring'], b['producer'], b['consumer'], b['reason'],
               _segments.REASONS.get(b['reason'], '?')),
            block=b['producer'], ring=b['ring']))


_CHECKS = (_check_tensor_contracts, _check_ring_sizing,
           _check_donation, _check_mesh, _check_bridge, _check_macro,
           _check_quantization, _check_overload, _check_segments)


def verify_pipeline(pipeline):
    """Run every static check over ``pipeline``'s block/ring graph and
    return the list of :class:`Diagnostic`.  Never raises: a check
    that fails internally reports itself as ``BF-I199``."""
    diags = []
    g = _Graph(pipeline)
    try:
        _propagate(g, diags)
    except Exception as exc:
        diags.append(Diagnostic(
            'BF-I199', 'header/gulp propagation failed: %s: %s'
            % (type(exc).__name__, exc)))
    for check in _CHECKS:
        try:
            check(g, diags)
        except Exception as exc:
            diags.append(Diagnostic(
                'BF-I199', 'check %s failed: %s: %s'
                % (check.__name__, type(exc).__name__, exc)))
    return diags






# ---------------------------------------------------------------------------
# run() integration
# ---------------------------------------------------------------------------

def publish_diagnostics(pipeline, diags):
    """Publish diagnostics to the ``analysis/verify`` ProcLog so the
    monitor tools (tools/pipeline2dot.py) can overlay them on the live
    graph: red edges for BF-E, amber for BF-W, tooltip = code +
    message."""
    try:
        from ..proclog import ProcLog
        entry = {'n': len(diags),
                 'errors': sum(1 for d in diags if
                               d.severity == 'error'),
                 'warnings': sum(1 for d in diags if
                                 d.severity == 'warning'),
                 'pipeline': pipeline.name}
        for i, d in enumerate(diags):
            entry['diag%d' % i] = json.dumps(d.as_dict(),
                                             sort_keys=True)
        ProcLog('analysis/verify').update(entry, force=True)
    except Exception:
        pass


def _count(diags):
    try:
        from ..telemetry import counters
        for d in diags:
            counters.inc('analysis.diagnostics.%s' % d.severity)
    except Exception:
        pass


def gate_run(pipeline, mode):
    """The ``BF_VALIDATE`` gate ``Pipeline.run()`` calls before
    launching threads.  ``warn``: report + publish, never block.
    ``strict``: additionally refuse to start on any ``BF-E``."""
    try:
        diags = verify_pipeline(pipeline)
    except Exception as exc:
        if mode == 'strict':
            raise
        sys.stderr.write('bifrost_tpu_torch.analysis.verify: verifier '
                         'failed (%s); continuing\n' % exc)
        return []
    publish_diagnostics(pipeline, diags)
    _count(diags)
    visible = [d for d in diags if d.severity != 'info']
    if visible:
        sys.stderr.write(
            'bifrost_tpu_torch pipeline verifier (%s; BF_VALIDATE=%s):'
            '\n%s\n'
            % (pipeline.name, mode, format_report(visible)))
    if mode == 'strict' and errors(diags):
        raise PipelineValidationError(diags)
    return diags


def lint_intercept(pipeline):
    """The ``BF_LINT=1`` hook: validate, report, optionally append a
    JSON record to ``BF_LINT_OUT`` (one line per pipeline), and return
    WITHOUT running — ``tools/bf_lint.py`` drives whole scripts this
    way."""
    try:
        diags = verify_pipeline(pipeline)
    except Exception as exc:
        diags = [Diagnostic('BF-I199', 'verifier failed: %s' % exc)]
    sys.stderr.write(
        'bf_lint: pipeline %r: %d diagnostic(s)\n%s\n'
        % (pipeline.name, len(diags),
           format_report(diags) if diags else '  (clean)'))
    out = os.environ.get('BF_LINT_OUT', '')
    if out:
        try:
            with open(out, 'a') as f:
                f.write(json.dumps({
                    'pipeline': pipeline.name,
                    'nblocks': len(pipeline.blocks),
                    'diagnostics': [d.as_dict() for d in diags],
                }, sort_keys=True) + '\n')
        except OSError:
            pass
    return diags
