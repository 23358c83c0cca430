"""Macro-gulp execution: K gulps in one dispatch on the hot path (the
port of ``bifrost_tpu/macro.py``).

An eligible device block acquires and reserves K gulps of ring span in
one ring operation, runs its composed function once over the K-gulp
span, and commits all K gulps at once: K Python dispatches and K ring
lock cycles become one.  On the card the work inside the one call is the
same kernels at K times the frame count (the spectrometer substitution
still matches at K * G frames), so what batching saves is host time a
gulp, the port's limit on the spectrometer chains.

Two shapes of batch execution, chosen per stage chain
(:func:`chain_batch_mode`):

- **block**: every stage is time-concat equivariant
  (``Stage.batch_safe``; every built-in stage is), so the composed chain
  runs once on the stacked K-gulp span.  Each frame's math is unchanged,
  so the output equals K per-gulp calls byte for byte.
- **sliced**: a stage that is not provably concat-safe.  The span is cut
  into G-frame slices inside one Python call, the per-gulp function runs
  on each, and the results are joined with ``torch.cat`` along the
  output's time axis (the JAX package's ``lax.map``).

Eligibility (``MultiTransformBlock._resolve_macro_batch``) falls back to
K = 1, never to an error, for host blocks, unguaranteed readers, dynamic
gulp geometry and nframe-nonlinear blocks, each counted on
``macro.fallback.<reason>``.  An overlapped read (FIR or FDMT history)
falls back too unless the block declares ``macro_overlap_safe()``, the
in-segment halo carry: a 'block'-mode chain reads K * G + overlap frames
a span, the ghost history rides the span head once, and the trailing
ghost frames go uncommitted.  Input rings with several readers batch
(each reader's guarantee pins its own oldest open span); such sequences
count on ``macro.fallback.multi_reader_retired``.

Set by ``BF_GULP_BATCH`` or the ``gulp_batch`` scope tunable
(``Pipeline(gulp_batch=K)``); K = 1, the default, is the per-gulp
runtime.
"""

from __future__ import annotations

import os

__all__ = ['resolve_gulp_batch', 'retune_gulp_batch',
           'chain_batch_mode', 'build_batched_fn', 'fallback_reason',
           'split_ranges']


def resolve_gulp_batch(scope):
    """The macro-gulp batch K of ``scope``: the ``gulp_batch`` tunable
    where set in the scope chain, else ``BF_GULP_BATCH`` (1 = off).  A
    value that is not an integer reads as 1."""
    k = scope.gulp_batch
    if k is None:
        try:
            k = int(os.environ.get('BF_GULP_BATCH', '1') or 1)
        except ValueError:
            k = 1
    try:
        k = int(k)
    except (TypeError, ValueError):
        return 1
    return max(k, 1)


def retune_gulp_batch(scope, k):
    """Set the ``gulp_batch`` tunable of ``scope`` (normally the
    Pipeline, so blocks that pinned their own keep it); the next
    sequence's ``_resolve_macro_batch`` reads it, and a sequence in
    flight keeps its batch.  Returns the value set (at least 1)."""
    k = max(int(k), 1)
    scope._gulp_batch = k
    return k


def chain_batch_mode(stages):
    """'block' when every stage declares time-concat equivariance
    (``Stage.batch_safe``), else 'sliced'."""
    if all(getattr(s, 'batch_safe', False) for s in stages):
        return 'block'
    return 'sliced'


def fallback_reason(reason):
    """Count a macro-gulp K = 1 fallback on ``macro.fallback.<reason>``,
    so that an operator can see why batching did not engage."""
    from .telemetry import counters
    counters.inc('macro.fallback.%s' % reason)


def split_ranges(member_sizes, nsplits):
    """Stage-index ranges of a compiled segment split into ``nsplits +
    1`` sequential parts (:func:`bifrost_tpu_torch.segments.retune_split`).

    ``member_sizes`` is the stage count of each member block; a split
    lands only on a member boundary.  Members are divided into ``nsplits
    + 1`` contiguous groups as evenly as possible (as
    ``np.array_split``); returns half-open ``[(stage_lo, stage_hi),
    ...]`` ranges into the segment's flat stage list.  ``nsplits``
    clamps to the boundary count; 0 gives the whole chain."""
    sizes = [int(s) for s in member_sizes]
    nparts = max(min(int(nsplits), len(sizes) - 1), 0) + 1
    base, extra = divmod(len(sizes), nparts)
    ranges = []
    m0 = s0 = 0
    for part in range(nparts):
        count = base + (1 if part < extra else 0)
        s1 = s0 + sum(sizes[m0:m0 + count])
        ranges.append((s0, s1))
        m0 += count
        s0 = s1
    return ranges


def build_batched_fn(per_gulp_for_shape, taxis_in, taxis_out,
                     gulp_nframe, part_shapes, mode):
    """The one-call function over a macro span of a stage chain.

    ``per_gulp_for_shape(shape) -> fn`` builds the chain's function for
    one input shape (as the K = 1 path builds it); ``taxis_in`` and
    ``taxis_out`` are the time axes of the chain's input and output
    tensors; ``gulp_nframe`` the logical gulp G; ``part_shapes`` the
    shapes of the span's input parts (one normally; several when a
    donating consumer claimed the K per-gulp chunks of a K = 1 producer);
    ``mode`` 'block' or 'sliced' (:func:`chain_batch_mode`).

    Returns ``fn(*parts) -> tensor``:

    - the parts are joined with one ``torch.cat`` along ``taxis_in``
      (nothing for a single part);
    - 'block': the composed chain runs once on the whole span, which may
      carry a lookahead halo (K * G + overlap frames: only 'block'
      chains carry one);
    - 'sliced': the per-gulp function runs on each G-frame slice and on
      the partial tail at sequence end (with its own shape), and the
      results are joined along ``taxis_out``.
    """
    import torch

    nframe = sum(int(s[taxis_in]) for s in part_shapes)
    full_shape = list(part_shapes[0])
    full_shape[taxis_in] = nframe

    def join(parts):
        return parts[0] if len(parts) == 1 else \
            torch.cat(parts, dim=taxis_in)

    if mode == 'block':
        body = per_gulp_for_shape(tuple(full_shape))

        def fn(*parts):
            return body(join(parts))
        return fn

    G = int(gulp_nframe)
    k, rem = divmod(nframe, G)
    gulp_shape = list(full_shape)
    gulp_shape[taxis_in] = G
    body = per_gulp_for_shape(tuple(gulp_shape)) if k else None
    tail_shape = list(full_shape)
    tail_shape[taxis_in] = rem
    tail = per_gulp_for_shape(tuple(tail_shape)) if rem else None

    def fn(*parts):
        x = join(parts)
        outs = [body(x.narrow(taxis_in, i * G, G)) for i in range(k)]
        if rem:
            outs.append(tail(x.narrow(taxis_in, k * G, rem)))
        return outs[0] if len(outs) == 1 else \
            torch.cat(outs, dim=taxis_out)
    return fn
