"""Standard sequence-header fields and validation
(reference: python/bifrost/header_standard.py).

A sequence header is a JSON-able dict with at minimum a ``_tensor``
block; this module documents and validates the recommended observation
fields so blocks can interoperate.
"""

from __future__ import annotations

__all__ = ['STANDARD_HEADER_FIELDS', 'enforce_header_standard']

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


def enforce_header_standard(header):
    """True if ``header`` carries the standard observation fields with
    acceptable types."""
    if not isinstance(header, dict):
        return False
    return all(key in header and isinstance(header[key], types)
               for key, types in STANDARD_HEADER_FIELDS.items())
