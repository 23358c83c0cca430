"""Axis units of Fourier-conjugate axes (reference:
python/bifrost/units.py:37-50), from a table of the units that appear in
radio-astronomy headers."""

from __future__ import annotations

__all__ = ['transform_units']

_RECIPROCALS = {
    's': 'Hz', 'Hz': 's', 'ms': 'kHz', 'kHz': 'ms', 'us': 'MHz',
    'MHz': 'us', 'ns': 'GHz', 'GHz': 'ns', '': '', None: None,
}


def transform_units(units, power):
    """Units of ``units**power`` (power=-1 for an FFT axis)."""
    if power == -1:
        return _RECIPROCALS.get(units, '1/%s' % units)
    if power == 1:
        return units
    return '%s^%d' % (units, power)
