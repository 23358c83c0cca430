"""The port's own copies of the JAX package's substrate modules (dtype,
devrep, header_standard, space) against the JAX package, on the same
seeded numpy buffers and headers.  The device representations must be
identical arrays, element type included, and the port's round trip
through its device representation must give back the host bytes."""

import numpy as np
import pytest

import bifrost_tpu.devrep as jax_devrep
import bifrost_tpu.dtype as jax_dtype
import bifrost_tpu.header_standard as jax_hs
from bifrost_tpu_torch import device, devrep, dtype, header_standard, space

NAMES = ['i8', 'i16', 'i32', 'u8', 'f16', 'f32', 'f64', 'ci8', 'ci16',
         'ci32', 'cf16', 'cf32', 'cf64']

# the element types the JAX package keeps on its device at the default
# 32-bit precision (f64 and cf64 would narrow there)
DEVREP_NAMES = ['i8', 'i16', 'i32', 'u8', 'f16', 'f32', 'ci8', 'ci16',
                'ci32', 'cf16', 'cf32']


@pytest.fixture(autouse=True)
def _cpu():
    device.set_device('cpu')


@pytest.mark.parametrize('name', NAMES)
def test_datatype_matches_jax(name):
    got, want = dtype.DataType(name), jax_dtype.DataType(name)
    assert str(got) == str(want)
    assert got.itemsize_bits == want.itemsize_bits
    assert got.itemsize == want.itemsize
    assert got.is_complex == want.is_complex
    assert got.is_floating_point == want.is_floating_point
    assert got.as_numpy_dtype() == want.as_numpy_dtype()
    assert str(got.as_floating_point()) == str(want.as_floating_point())
    assert str(got.as_real()) == str(want.as_real())
    if got.kind != 'u':
        assert str(got.as_complex()) == str(want.as_complex())
    # constructed back from its numpy storage type
    assert dtype.DataType(got.as_numpy_dtype()) == got


def _host_buffer(name, shape, seed):
    """Seeded host storage of ``name`` in its numpy storage dtype."""
    rng = np.random.RandomState(seed)
    npt = dtype.DataType(name).as_numpy_dtype()
    buf = np.zeros(shape, dtype=npt)
    if npt.names is not None:
        for field in npt.names:
            buf[field] = rng.randint(-100, 100, size=shape)
    elif npt.kind == 'c':
        buf[...] = rng.randn(*shape) + 1j * rng.randn(*shape)
    elif npt.kind == 'f':
        buf[...] = rng.randn(*shape)
    else:
        buf[...] = rng.randint(0 if npt.kind == 'u' else -100, 100,
                               size=shape)
    return buf


@pytest.mark.parametrize('name', DEVREP_NAMES)
def test_devrep_matches_jax(name):
    shape = (3, 4, 5)
    buf = _host_buffer(name, shape, seed=len(name) + NAMES.index(name))
    got = devrep.to_device_rep(buf, name).numpy()
    want = np.asarray(jax_devrep.to_device_rep(buf, name))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert got.shape == devrep.device_rep_shape(shape, name)
    zeros = devrep.device_rep_zeros(shape, name).numpy()
    assert zeros.shape == got.shape and zeros.dtype == got.dtype
    assert not zeros.any()
    # bit-exact round trip back into host storage
    out = np.zeros_like(buf)
    devrep.from_device_rep(devrep.to_device_rep(buf, name), name, out)
    assert out.tobytes() == buf.tobytes()


_STANDARD = {'nchans': 64, 'nifs': 1, 'nbits': 32, 'fch1': 1400.0,
             'foff': -0.5, 'tstart': 60000.0, 'tsamp': 1e-3}


@pytest.mark.parametrize('header', [
    _STANDARD,
    dict(_STANDARD, tstart=60000),
    {k: v for k, v in _STANDARD.items() if k != 'tsamp'},
    dict(_STANDARD, nchans=64.0),
    dict(_STANDARD, name='guppi', _tensor={'shape': [-1, 2, 64]}),
    [],
], ids=['standard', 'int_tstart', 'missing_tsamp', 'float_nchans',
        'extra_fields', 'not_a_dict'])
def test_header_standard_matches_jax(header):
    assert header_standard.enforce_header_standard(header) == \
        jax_hs.enforce_header_standard(header)


def test_spaces():
    assert space.SPACES == ('system', 'cuda_host', 'cuda')
    assert space.canonical('pinned') == 'cuda_host'
    assert space.canonical('cuda_managed') == 'cuda'
    with pytest.raises(ValueError):
        space.canonical('tpu')
    assert space.space_accessible('cuda_host', ['system'])
    assert space.space_accessible('cuda', 'any')
    assert not space.space_accessible('cuda', ['system', 'cuda_host'])
    assert not space.space_accessible('system', ['cuda'])
