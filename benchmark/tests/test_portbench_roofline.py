"""Each stage's work count against its arithmetic done by hand, at the
cells' shapes."""

import math

import pytest

from benchmark.roofline import fx_f, fx_x, peaks, spectrometer


def test_peaks_are_the_data_sheet():
    assert (peaks.HBM_BYTES_S, peaks.FP32_FLOPS, peaks.INT8_OPS) == \
        (3.35e12, 67e12, 1979e12)


def test_spectrometer_nfft1024():
    w = spectrometer.work({'gulp_nframe': 65536, 'npol': 2,
                           'nfft': 1024, 'rfactor': 4})
    assert w['bytes'] == 268435456 + 65536 * 4 * 256 * 4
    flop = 65536 * 2 * 5 * 1024 * 10 + 65536 * 1024 * 16 + \
        65536 * 4 * 1024 * 3 / 4
    assert w['flop'] == pytest.approx(flop, rel=1e-12)
    # bytes bound it: 536.9 MB at 3.35 TB/s
    assert w['bound_s'] == pytest.approx(536870912 / 3.35e12, rel=1e-12)


def test_spectrometer_nfft1m_is_bound_by_flops():
    w = spectrometer.work({'gulp_nframe': 64, 'npol': 2,
                           'nfft': 1 << 20, 'rfactor': 4})
    flop = 64 * 2 * 5 * (1 << 20) * 20 + 64 * (1 << 20) * 16 + \
        64 * 4 * (1 << 20) * 3 / 4
    assert w['flop'] == pytest.approx(flop, rel=1e-12)
    assert w['bound_s'] == pytest.approx(flop / 67e12, rel=1e-12)
    assert w['bound_s'] > w['bytes'] / 3.35e12


def test_fx_f():
    w = fx_f.work({'gulp_nframe': 256, 'nchan': 1024, 'nstand': 256,
                   'npol': 2})
    n = 256 * 1024 * 256 * 2
    assert w['bytes'] == 4 * n
    assert w['flop'] == pytest.approx(n * 5 * 10 + 2 * n, rel=1e-12)
    assert w['bound_s'] == pytest.approx(4 * n / 3.35e12, rel=1e-12)


def test_fx_x():
    w = fx_x.work({'gulp_nframe': 256, 'nchan': 1024, 'nstand': 256,
                   'npol': 2, 'nframe_per_vis': 256, 'nvis_per_dump': 16})
    assert w['bytes'] == 256 * 1024 * 512 * 2 + 1024 * 512 * 512 * 8 / 16
    assert w['int8_op'] == 8 * 256 * 1024 * 512 * 513 / 2
    assert w['bound_s'] == pytest.approx(w['int8_op'] / 1979e12,
                                         rel=1e-12)
    assert math.isclose(w['bound_s'] * 1e3, 0.1392, rel_tol=1e-3)
