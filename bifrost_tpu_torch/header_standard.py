"""Standard sequence-header fields and validation
(reference: python/bifrost/header_standard.py), and the stream's trace
context (``bifrost_tpu/header_standard.py:84-145``).

A sequence header is a JSON-able dict with at minimum a ``_tensor``
block; this module documents and validates the recommended observation
fields so blocks can interoperate.

The trace context is a small dict under :data:`TRACE_CONTEXT_KEY`
(``_trace``): a stream-unique id, the wall-clock nanoseconds of the
stream's first commit and the origin host.  Source blocks stamp it
(:func:`ensure_trace_context`), transforms and sinks copy it to their
outputs (:func:`propagate_trace_context`), compute spans carry its id,
and ``telemetry.slo`` ages each commit against its origin.

:func:`serialize_header` / :func:`deserialize_header` are the JSON codec
of every wire transport (``io.bridge``): the bytes equal the JAX
package's for the same dict, so the two packages talk to each other.
"""

from __future__ import annotations

import json
import os
import socket
import time
import uuid

import numpy as np

__all__ = ['STANDARD_HEADER_FIELDS', 'enforce_header_standard',
           'serialize_header', 'deserialize_header', 'TRACE_CONTEXT_KEY',
           'trace_context_enabled', 'new_trace_context', 'trace_context', 'ensure_trace_context',
           'propagate_trace_context']

# field -> accepted type(s)
STANDARD_HEADER_FIELDS = {
    'nchans': (int,),
    'nifs': (int,),
    'nbits': (int,),
    'fch1': (int, float),
    'foff': (int, float),
    'tstart': (int, float),
    'tsamp': (int, float),
}

def _json_default(obj):
    """JSON coercions for the numpy values that header transforms and
    capture engines leave in sequence headers: scalars become Python
    numbers, arrays (nested) lists.  A bare ``json.dumps`` raises
    TypeError on them."""
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    raise TypeError("header value of type %s is not JSON-serializable"
                    % type(obj).__name__)


def serialize_header(header):
    """A sequence header as UTF-8 JSON bytes, numpy scalars and arrays
    coerced (the one serializer of the wire transports)."""
    return json.dumps(header, default=_json_default).encode()


def deserialize_header(payload):
    """Inverse of :func:`serialize_header` (bytes or str)."""
    if isinstance(payload, (bytes, bytearray, memoryview)):
        payload = bytes(payload).decode()
    return json.loads(payload)


#: header key carrying the stream's trace context (a plain JSON dict)
TRACE_CONTEXT_KEY = '_trace'


def trace_context_enabled():
    """Whether new streams get a trace context stamped
    (``BF_TRACE_CONTEXT`` != '0'; on by default: one small dict per
    sequence, not per gulp)."""
    return os.environ.get('BF_TRACE_CONTEXT', '1') != '0'


def new_trace_context():
    """A fresh trace context: ``{'id'``: 16 hex digits unique to the
    stream, ``'origin_ns'``: wall-clock nanoseconds of the stream's first
    commit (the instant SLO ages are measured from), ``'host'``: the
    origin host name}."""
    return {'id': uuid.uuid4().hex[:16],
            'origin_ns': time.time_ns(),
            'host': socket.gethostname()}


def trace_context(header):
    """The header's trace context dict, or None (absent or malformed)."""
    if not isinstance(header, dict):
        return None
    ctx = header.get(TRACE_CONTEXT_KEY)
    if isinstance(ctx, dict) and ctx.get('id'):
        return ctx
    return None


def ensure_trace_context(header):
    """Stamp a fresh trace context into ``header`` if it has none and
    stamping is enabled; returns the context in effect, or None.  Stream
    origins (source blocks) call it at first commit; transforms
    propagate instead."""
    ctx = trace_context(header)
    if ctx is not None:
        return ctx
    if not trace_context_enabled():
        return None
    ctx = new_trace_context()
    header[TRACE_CONTEXT_KEY] = ctx
    return ctx


def propagate_trace_context(iheader, oheaders):
    """Copy the input sequence's trace context into every output header
    that lacks one (the stream identity follows the data); returns the
    context, or None."""
    ctx = trace_context(iheader)
    if ctx is None:
        return None
    for ohdr in oheaders:
        if isinstance(ohdr, dict) and trace_context(ohdr) is None:
            ohdr[TRACE_CONTEXT_KEY] = dict(ctx)
    return ctx


def enforce_header_standard(header):
    """True if ``header`` carries the standard observation fields with
    acceptable types."""
    if not isinstance(header, dict):
        return False
    return all(key in header and isinstance(header[key], types)
               for key, types in STANDARD_HEADER_FIELDS.items())
