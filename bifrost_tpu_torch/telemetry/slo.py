"""Capture-to-commit latency SLOs (the JAX package's
``bifrost_tpu/telemetry/slo.py``).

The stream-origin block stamps a wall-clock origin into the sequence
header (``header_standard.ensure_trace_context``); every ring commit
downstream records ``now - capture_time`` into a log2 histogram:

- ``slo.<block>.commit_age_s``   capture -> commit age, per committing
                                 block (ring owner), one observation per
                                 commit
- ``slo.<block>.exit_age_s``     capture -> pipeline-exit age, observed
                                 by sink blocks
- ``slo.exit_age_s``             all sinks merged: the pipeline-exit
                                 p50/p99
- ``slo.shed_age_s``             age of data a drop_* overload policy
                                 shed

``capture_time`` is the origin extrapolated by frame time when the
header has a numeric ``tsamp`` (seconds per frame): frame ``f`` was
captured at ``origin + f * tsamp``.  Without ``tsamp`` the age is taken
against the sequence origin.

``BF_SLO_MS=<ms>`` arms a budget: an observation above it counts on
``slo.violations`` and ``slo.<name>.violations``.  Everything is a no-op
for sequences without a trace context (``BF_TRACE_CONTEXT=0``).

:func:`observe_fabric_exit` records the cross-host age of streams that
crossed a bridge (``io.bridge`` stamps ``hops`` and ``skew_ns`` into the
trace context), on ``slo.fabric_exit_age_s``.
"""

from __future__ import annotations

import os
import time

from . import counters, histograms
from ..header_standard import trace_context

__all__ = ['budget_s', 'reset_budget', 'capture_age_s',
           'observe_commit', 'observe_exit', 'observe_shed',
           'observe_fabric_exit', 'reset_block_ages',
           'EXIT_HISTOGRAM', 'SHED_HISTOGRAM', 'FABRIC_EXIT_HISTOGRAM']

#: the merged pipeline-exit age histogram (all sink blocks)
EXIT_HISTOGRAM = 'slo.exit_age_s'
#: the cross-host capture-to-sink age (sinks behind >= 1 bridge hop)
FABRIC_EXIT_HISTOGRAM = 'slo.fabric_exit_age_s'
#: age of data at the moment a drop_* overload policy shed it
SHED_HISTOGRAM = 'slo.shed_age_s'

_budget = None          # cached 1-tuple (budget seconds or None)


def budget_s():
    """The ``BF_SLO_MS`` budget in seconds, or None when unset.  Cached;
    :func:`reset_budget` re-reads it."""
    global _budget
    if _budget is None:
        raw = os.environ.get('BF_SLO_MS', '').strip()
        val = None
        if raw:
            try:
                val = float(raw) * 1e-3
            except ValueError:
                val = None
        _budget = (val,)
    return _budget[0]


def reset_budget():
    """Drop the cached budget; the next observation re-reads
    ``BF_SLO_MS`` (``Pipeline.run`` calls it)."""
    global _budget
    _budget = None


def capture_age_s(header, frame_end=None, now=None):
    """Age of the data being committed (``now - capture_time``), or None
    when the header carries no trace-context origin.  ``frame_end`` (the
    committed span's last frame index in the sequence) extrapolates by a
    numeric ``tsamp`` > 0."""
    ctx = trace_context(header)
    if ctx is None:
        return None
    try:
        origin = float(ctx['origin_ns']) * 1e-9
    except (KeyError, TypeError, ValueError):
        return None
    skew = ctx.get('skew_ns')
    if isinstance(skew, (int, float)):
        origin += float(skew) * 1e-9
    if frame_end is not None:
        tsamp = header.get('tsamp')
        if isinstance(tsamp, (int, float)) and 0 < tsamp < 1e6:
            origin += frame_end * float(tsamp)
    if now is None:
        now = time.time()
    age = now - origin
    return age if age > 0.0 else 0.0


def _observe(hist_name, counter_name, age_s):
    histograms.observe(hist_name, age_s)
    b = budget_s()
    if b is not None and age_s > b:
        counters.inc('slo.violations')
        counters.inc(counter_name)


def observe_commit(name, age_s, ngulps=1):
    """Record a capture -> commit age for the block (or ring) ``name``:
    one observation per commit, whatever ``ngulps`` it covers."""
    _observe('slo.%s.commit_age_s' % name,
             'slo.%s.violations' % name, age_s)


def observe_exit(name, age_s):
    """Record a capture -> pipeline-exit age (sink blocks): the per-sink
    histogram and the merged ``slo.exit_age_s``."""
    histograms.observe(EXIT_HISTOGRAM, age_s)
    _observe('slo.%s.exit_age_s' % name,
             'slo.%s.violations' % name, age_s)


def observe_fabric_exit(name, age_s):
    """Record a cross-host capture -> sink age: sink blocks call it
    beside :func:`observe_exit` when their input's trace context shows
    one or more bridge hops.  The merged ``slo.fabric_exit_age_s`` and a
    per-sink histogram; ages above ``BF_SLO_MS`` count on the shared
    violation counters."""
    histograms.observe(FABRIC_EXIT_HISTOGRAM, age_s)
    _observe('slo.%s.fabric_exit_age_s' % name,
             'slo.%s.violations' % name, age_s)


def observe_shed(age_s):
    """Record the age of data a drop_* policy shed on
    ``slo.shed_age_s``.  Never a violation: shedding keeps the budget."""
    histograms.observe(SHED_HISTOGRAM, age_s)


def reset_block_ages(name):
    """Zero ``slo.<name>.commit_age_s`` and ``slo.<name>.exit_age_s`` in
    place (a skipped sequence's stale origin leaves the p99).  Violation
    counters are history and stay."""
    histograms.clear('slo.%s.commit_age_s' % name)
    histograms.clear('slo.%s.exit_age_s' % name)
