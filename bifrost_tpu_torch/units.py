"""Axis units (reference: python/bifrost/units.py:37-50, which uses
pint), from tables of the units that appear in radio-astronomy headers.

:func:`transform_units` gives the units of a Fourier-conjugate axis;
:func:`convert_units` converts a value between two units of one family
(frequency, time or length) by the ``_SCALES``/``_FAMILY`` table of
``bifrost_tpu/units.py:37-57``.  The port does not use pint: a
conversion outside the table raises ValueError, as the JAX package's
does where pint is not installed.
"""

from __future__ import annotations

__all__ = ['transform_units', 'convert_units']

_RECIPROCALS = {
    's': 'Hz', 'Hz': 's', 'ms': 'kHz', 'kHz': 'ms', 'us': 'MHz',
    'MHz': 'us', 'ns': 'GHz', 'GHz': 'ns', '': '', None: None,
}

_SCALES = {
    'Hz': 1.0, 'kHz': 1e3, 'MHz': 1e6, 'GHz': 1e9, 'THz': 1e12,
    's': 1.0, 'ms': 1e-3, 'us': 1e-6, 'ns': 1e-9, 'ps': 1e-12,
    'm': 1.0, 'km': 1e3, 'cm': 1e-2, 'mm': 1e-3,
}

_FAMILY = {'Hz': 'f', 'kHz': 'f', 'MHz': 'f', 'GHz': 'f', 'THz': 'f',
           's': 't', 'ms': 't', 'us': 't', 'ns': 't', 'ps': 't',
           'm': 'l', 'km': 'l', 'cm': 'l', 'mm': 'l'}


def transform_units(units, power):
    """Units of ``units**power`` (power=-1 for an FFT axis)."""
    if power == -1:
        return _RECIPROCALS.get(units, '1/%s' % units)
    if power == 1:
        return units
    return '%s^%d' % (units, power)


def convert_units(value, from_units, to_units):
    """``value`` in ``from_units`` expressed in ``to_units``.  Equal units
    (or either None) return ``value`` unchanged."""
    if from_units == to_units or from_units is None or to_units is None:
        return value
    if from_units in _SCALES and to_units in _SCALES and \
            _FAMILY[from_units] == _FAMILY[to_units]:
        return value * _SCALES[from_units] / _SCALES[to_units]
    raise ValueError("Cannot convert %r -> %r without pint"
                     % (from_units, to_units))
