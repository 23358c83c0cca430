"""``bifrost_tpu_torch.ops.map`` (bf.map) and ``stages.MapStage`` against
the JAX package's ``bf.map`` and ``MapStage`` on the same seeded inputs:
one port case for each case of ``tests/test_map.py``, plus the cases the
port adds (negative-index wrap, out-of-range gathers and stores,
``unsigned`` wrap, ``double``, packed host outputs, the cache).  Integer results are exact; float32 results are
held within rtol 1e-6 (the JAX tests' own tolerance) or 1e-5 of the
largest magnitude; ``double`` expressions are held to JAX (which computes
them in float32) at float32 tolerance, 1e-5.  The port runs on the CPU
device here.
"""

from copy import deepcopy

import numpy as np
import pytest
import torch

import bifrost_tpu as bf
from bifrost_tpu import stages as JS

import bifrost_tpu_torch as bt
from bifrost_tpu_torch import device, stages as TS
from bifrost_tpu_torch.ndarray import ndarray
from bifrost_tpu_torch.ops import map as tmap
from tests.test_torch_bounded import run_bounded

RTOL = 1e-6          # tests/test_map.py's tolerance
F32_REL = 1e-5       # float32 results, relative to the largest magnitude

CI8 = np.dtype([('re', 'i1'), ('im', 'i1')])


@pytest.fixture(autouse=True)
def _cpu():
    device.set_device('cpu')


def _jax_run(funcstr, data, **kw):
    """bf.map through the JAX package on device copies of ``data``'s
    arrays; returns {name: numpy output}."""
    jdata = {k: bf.asarray(v, space='tpu') if isinstance(v, np.ndarray)
             else v for k, v in data.items()}
    bf.map(funcstr, jdata, **kw)
    return {k: np.asarray(v.data) for k, v in jdata.items()
            if isinstance(v, bf.ndarray)}


def _torch_run(funcstr, data, **kw):
    """The port's map on tensor copies of ``data``'s arrays."""
    tdata = {k: torch.from_numpy(v.copy()) if isinstance(v, np.ndarray)
             else v for k, v in data.items()}
    tmap.map(funcstr, tdata, **kw)
    return {k: v.numpy() for k, v in tdata.items()
            if isinstance(v, torch.Tensor)}


def _both(funcstr, data, out, **kw):
    j = _jax_run(funcstr, data, **kw)[out]
    t = _torch_run(funcstr, data, **kw)[out]
    return t, j


def run_simple(x, funcstr, func):
    data = {'x': np.asarray(x), 'y': np.zeros_like(np.asarray(x))}
    t, j = _both(funcstr, data, 'y')
    np.testing.assert_allclose(t, func(np.asarray(x)), rtol=RTOL)
    assert t.dtype == j.dtype
    np.testing.assert_allclose(t, j, rtol=RTOL)


def test_simple_elementwise():
    np.random.seed(1234)
    x = np.random.randint(256, size=100).astype(np.int32)
    run_simple(x, "y = x+1", lambda x: x + 1)
    run_simple(x, "y = x*3", lambda x: x * 3)
    run_simple(x, "auto tmp = x; y = tmp*tmp", lambda x: x * x)
    run_simple(x, "y = x; y += x", lambda x: x + x)


def test_simple_2d_3d():
    np.random.seed(0)
    for shape in [(9, 9), (5, 6, 7)]:
        x = np.random.randint(256, size=shape).astype(np.float32)
        run_simple(x, "y = x+1", lambda x: x + 1)


def test_rint_pow():
    x = np.arange(10).astype(np.float32)
    run_simple(x, "y = rint(pow(x, 2.f))", lambda x: x ** 2)


def test_broadcast():
    n = 89
    a = np.arange(n).astype(np.float32)
    data = {'a': a, 'b': a[:, None].copy(),
            'c': np.zeros((n, n), np.float32)}
    t, j = _both("c = a*b", data, 'c')
    np.testing.assert_allclose(t, a[None, :] * a[:, None])
    np.testing.assert_array_equal(t, j)


def test_scalar_int_division():
    """C semantics: integer division truncates toward zero (the JAX test's
    positive range, where both packages agree)."""
    x = np.random.RandomState(3).randint(1, 256, size=100)
    data = {'x': x.astype(np.int32), 'y': np.zeros(100, np.int32),
            'm': 1, 's': 3}
    t, j = _both("y = (x-m)/s", data, 'y')
    np.testing.assert_array_equal(t, np.trunc((x - 1) / 3).astype(np.int32))
    np.testing.assert_array_equal(t, j)
    t, j = _both("y = (x-m)%s", data, 'y')
    np.testing.assert_array_equal(t, np.fmod(x - 1, 3))
    np.testing.assert_array_equal(t, j)


def test_negative_integer_division_truncates_where_jax_floors():
    """With a negative dividend the port truncates toward zero, as C
    does.  The JAX package's ``_cdiv`` (``bifrost_tpu/ops/map.py:227``)
    tests the sign of the remainder instead of the dividend and floors:
    -103 / 3 gives -35 there, -34 here (ROADMAP queue 3, weak spots)."""
    x = np.arange(-20, 21, dtype=np.int32)
    data = {'x': x, 'y': np.zeros_like(x), 's': 3}
    t, j = _both("y = x/s", data, 'y')
    np.testing.assert_array_equal(t, np.trunc(x / 3).astype(np.int32))
    np.testing.assert_array_equal(j, np.floor_divide(x, 3))
    t, _ = _both("y = x%s", data, 'y')
    np.testing.assert_array_equal(t, np.fmod(x, 3))
    t, _ = _both("y = x/s", dict(data, s=-3), 'y')
    np.testing.assert_array_equal(t, np.trunc(x / -3).astype(np.int32))


def test_fftshift_index_vector():
    shape = (16, 10, 12)
    a = np.random.RandomState(1).randint(1 << 16, size=shape)
    a = a.astype(np.int32)
    data = {'a': a, 'b': np.zeros_like(a)}
    t, j = _both("b = a(_-a.shape()/2)", data, 'b')
    np.testing.assert_array_equal(t, np.fft.fftshift(a))
    np.testing.assert_array_equal(t, j)


def test_negative_index_wraps_along_one_axis():
    """``a(i, k - n/2)`` with named axes: the negative indices wrap, as
    the fftshift of one axis (chip_smoke's form on the 4096 axis)."""
    a = np.random.RandomState(4).randint(-99, 99, size=(6, 16)) \
        .astype(np.int32)
    data = {'a': a, 'b': np.zeros_like(a)}
    t, j = _both("b(i,k) = a(i,k-a.shape(1)/2)", data, 'b', shape=a.shape,
                 axis_names=('i', 'k'))
    np.testing.assert_array_equal(t, np.fft.fftshift(a, axes=1))
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize('expr, want', [
    # a gather past either end clamps to the axis (i-12 first adds 8)
    ("b(i) = a(i+3)", lambda a: a[np.minimum(np.arange(8) + 3, 7)]),
    ("b(i) = a(i-12)", lambda a: a[np.maximum(np.arange(8) - 4, 0)]),
    # a store past either end is dropped: b(0), b(7) keep their values
    ("b(i+1) = a(i)", lambda a: np.r_[-5, a[:7]]),
    ("b(i-9) = a(i)", lambda a: np.r_[a[1:], -5]),
    ("b(3+8) = a(0)", lambda a: np.full(8, -5)),
])
def test_out_of_range_index_clamps_gathers_and_drops_stores(expr, want):
    """Past the ends of an axis the port does what jnp does: a gather
    clamps to the axis, a store is dropped (a negative index counts once
    from the end first)."""
    a = np.random.RandomState(6).randint(-99, 99, size=8).astype(np.int32)
    data = {'a': a, 'b': np.full(8, -5, np.int32)}
    t, j = _both(expr, data, 'b', shape=(8,), axis_names=('i',))
    np.testing.assert_array_equal(t, want(a))
    np.testing.assert_array_equal(t, j)


def test_complex_float():
    n = 32
    rng = np.random.RandomState(5)
    x = (rng.randint(-127, 128, size=(n, n)) +
         1j * rng.randint(-127, 128, size=(n, n))).astype(np.complex64)
    run_simple(x, "y.assign(x.imag, x.real)",
               lambda x: x.imag + 1j * x.real)
    run_simple(x, "y = x*x.conj()", lambda x: x * x.conj())
    run_simple(x, "y = x.mag2()", lambda x: (x * x.conj()))
    run_simple(x, "y = 3*x", lambda x: 3 * x)


def test_explicit_indexing_transpose():
    shape = (5, 6, 7)
    a = np.random.RandomState(2).randint(100, size=shape).astype(np.int32)
    data = {'a': a, 'b': np.zeros((7, 5, 6), np.int32)}
    t, j = _both("b(i,j,k) = a(j,k,i)", data, 'b', shape=(7, 5, 6),
                 axis_names=('i', 'j', 'k'))
    np.testing.assert_array_equal(t, a.transpose([2, 0, 1]))
    np.testing.assert_array_equal(t, j)


def test_custom_shape_fixed_index():
    shape = (5, 6, 7)
    a = np.random.RandomState(2).randint(100, size=shape).astype(np.int32)
    data = {'a': a, 'b': np.zeros((5, 7), np.int32), 'j': 3}
    t, j = _both("b(i,k) = a(i,j,k)", data, 'b', shape=(5, 7),
                 axis_names=('i', 'k'))
    np.testing.assert_array_equal(t, a[:, 3, :])
    np.testing.assert_array_equal(t, j)


def _mag2(x):
    return x.real ** 2 + x.imag ** 2


POL_PRODUCTS = '''
    auto x = a(_,0);
    auto y = a(_,1);
    b(_,0).assign(x.mag2(), y.mag2());
    b(_,1) = x*y.conj();
    '''


def test_polarisation_products():
    """Every product of these integers is exact in float32: the port, JAX
    and numpy agree exactly."""
    n = 16
    rng = np.random.RandomState(7)
    a = (rng.randint(-127, 128, size=(n, 2)) +
         1j * rng.randint(-127, 128, size=(n, 2))).astype(np.complex64)
    data = {'a': a, 'b': np.zeros_like(a)}
    t, j = _both(POL_PRODUCTS, data, 'b', shape=(n,))
    np.testing.assert_array_equal(t[:, 0],
                                  _mag2(a[:, 0]) + 1j * _mag2(a[:, 1]))
    np.testing.assert_array_equal(t[:, 1], a[:, 0] * a[:, 1].conj())
    np.testing.assert_array_equal(t, j)


def test_vectorized_if():
    n = 8
    a = np.arange(n * n, dtype=np.float32).reshape(n, n)
    data = {'a': a, 'b': np.zeros((n, n), np.float32)}
    t, j = _both('''
    if( i > j ) {
        b(i,j) = a(i,j);
    } else {
        b(i,j) = -a(j,i);
    }
    ''', data, 'b', shape=(n, n), axis_names=('i', 'j'))
    expect = np.where(np.arange(n)[:, None] > np.arange(n)[None, :],
                      a, -a.T)
    np.testing.assert_array_equal(t, expect)
    np.testing.assert_array_equal(t, j)


def test_ternary_and_bool():
    x = np.arange(10).astype(np.float32)
    run_simple(x, "y = x > 5 ? x : -x", lambda x: np.where(x > 5, x, -x))
    run_simple(x, "y = (x > 2 && x < 7) ? 1.f : 0.f",
               lambda x: ((x > 2) & (x < 7)).astype(np.float32))


def test_define_macro():
    x = np.arange(1, 11).astype(np.int32)
    run_simple(x, """
    #define square(v) ((v)*(v))
    y = square(x);
    """, lambda x: x * x)


def test_complex_integer_ci8():
    """A host ci8 ndarray as input, a host cf32 output: the ci8 bytes go
    to the device and are unpacked there; the output is written back
    into the host buffer."""
    n = 64
    rng = np.random.RandomState(11)
    buf = np.zeros(n, CI8)
    buf['re'] = rng.randint(-128, 128, size=n)
    buf['im'] = rng.randint(-128, 128, size=n)
    out = np.zeros(n, np.complex64)
    tmap.map('b(i) = a(i)', {'a': ndarray(buf, dtype='ci8'),
                             'b': ndarray(out, dtype='cf32')},
             shape=(n,), axis_names=('i',))
    np.testing.assert_array_equal(
        out, buf['re'].astype(np.float32) + 1j * buf['im'])
    ja = bf.empty((n,), 'ci8', 'system')
    ja.as_numpy()[...] = buf
    jb = bf.empty((n,), 'cf32', 'system')
    bf.map('b(i) = a(i)', {'a': ja, 'b': jb}, shape=(n,),
           axis_names=('i',))
    np.testing.assert_array_equal(out, jb.as_numpy())


def test_host_writeback():
    x = np.arange(10, dtype=np.float32)
    y = np.zeros(10, dtype=np.float32)
    tmap.map("y = x*2", {'x': x, 'y': y})
    np.testing.assert_array_equal(y, x * 2)


@pytest.mark.parametrize('dtype', ['ci4', 'ci8', 'i4', 'u2', 'i8'])
def test_packed_and_complex_int_host_outputs(dtype):
    """Host outputs of packed and complex-integer types are written through
    the JAX package's conversions (rounded, packed LSB first): the port's
    bytes equal the JAX map's bytes, and for packed real types (which the
    JAX map's write-back does not pack) the bytes of the JAX package's
    ``ops.quantize._pack_into``."""
    from bifrost_tpu.ops.quantize import _pack_into
    n = 16
    rng = np.random.RandomState(12)
    dt = bt.DataType(dtype)
    if dt.kind == 'ci':
        x = (rng.randint(-8, 8, n) + 1j * rng.randint(-8, 8, n)) \
            .astype(np.complex64) * np.float32(0.9)
        expr = 'b = a'
    else:
        lo, hi = (-8, 8) if dt.kind == 'i' else (0, 4)
        x = rng.randint(lo, hi, n).astype(np.float32) * np.float32(0.9)
        expr = 'b = rint(a)'
    tb = bt.ops.common.astype(np.zeros(n, np.float32), dtype)
    tmap.map(expr, {'a': x, 'b': tb})
    jb = bf.empty((n,), dtype, 'system')
    if dt.is_packed and dt.kind != 'ci':
        _pack_into(np.round(x), bf.DataType(dtype), jb.as_numpy())
    else:
        bf.map(expr, {'a': x, 'b': jb})
    assert tb.as_numpy().tobytes() == jb.as_numpy().tobytes()


def test_unsigned_wraps_to_32_bits():
    """``unsigned`` casts wrap to 32 bits (the port computes them in
    int64); uint32 arrays keep their type."""
    x = np.array([0, 1, 5, 100], np.int32)
    data = {'x': x, 'y': np.zeros(4, np.uint32)}
    t, j = _both("y = (unsigned)(x - 3)", data, 'y')
    np.testing.assert_array_equal(t, (x - 3).astype(np.uint32))
    np.testing.assert_array_equal(t, j)
    u = np.array([0, 7, 0xFFFFFFFF], np.uint32)
    data = {'u': u, 'v': np.zeros(3, np.uint32)}
    t, j = _both("v = u + 1", data, 'v')
    np.testing.assert_array_equal(t, u + np.uint32(1))
    np.testing.assert_array_equal(t, j)


def test_double_computes_float64_held_to_jax_at_float32():
    """``double`` computes in float64 in the port (the JAX package, without
    x64, in float32): held to JAX within 1e-5 of the largest magnitude,
    and to a float64 numpy reference more tightly."""
    x = np.random.RandomState(13).rand(64).astype(np.float32) * 100
    data = {'x': x, 'y': np.zeros(64, np.float32)}
    expr = "double d = (double)x; y = sqrt(d * d + 1.0) / 3.0"
    t, j = _both(expr, data, 'y')
    want = (np.sqrt(x.astype(np.float64) ** 2 + 1.0) / 3.0) \
        .astype(np.float32)
    assert np.abs(t - j).max() / np.abs(j).max() < F32_REL
    np.testing.assert_array_equal(t, want)


def test_cache_key_equals_jax():
    """The cache holds the parsed expression under the JAX package's key."""
    import importlib
    jmap = importlib.import_module('bifrost_tpu.ops.map')
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    data = {'x': x, 'y': np.zeros_like(x), 's': 2}
    tmap.clear_map_cache()
    jmap.clear_map_cache()
    tmap.map("y = x*s", dict(data, y=np.zeros_like(x)))
    jmap.map("y = x*s", dict(data, y=np.zeros_like(x)))
    assert tmap.list_map_cache() == jmap.list_map_cache()
    assert len(tmap.list_map_cache()) == 1


def test_expression_is_parsed_only_on_a_cache_miss(monkeypatch):
    """A call with the expression and names of an earlier call takes the
    parsed body from the cache, whatever the shapes; new shapes add a key
    to ``list_map_cache`` as they do in the JAX package."""
    parses = []
    real = tmap.compile_map
    monkeypatch.setattr(tmap, 'compile_map',
                        lambda *a: parses.append(a) or real(*a))
    tmap.clear_map_cache()
    for n in (4, 4, 6):
        x = np.arange(n, dtype=np.float32)
        y = np.zeros_like(x)
        tmap.map("y = x*s", {'x': x, 'y': y, 's': 2})
        np.testing.assert_array_equal(y, 2 * x)
    assert len(parses) == 1
    assert len(tmap.list_map_cache()) == 2


def test_map_syntax_error():
    with pytest.raises(tmap.MapSyntaxError):
        tmap.map("y = nosuch + 1", {'x': np.zeros(3, np.float32),
                                    'y': np.zeros(3, np.float32)})


def test_output_tensor_updated_in_place_and_inputs_untouched():
    """The caller's output tensor is written in place; an input that is
    not an output keeps its values."""
    a = torch.arange(8, dtype=torch.float32)
    a0 = a.clone()
    b = torch.zeros(8)
    ptr = b.data_ptr()
    tmap.map("b(i) = a(7-i); a2 = 0", {'a': a, 'b': b, 'a2': 0},
             shape=(8,), axis_names=('i',))
    assert b.data_ptr() == ptr
    torch.testing.assert_close(b, a0.flip(0))
    torch.testing.assert_close(a, a0)


# ---------------------------------------------------------------------------
# MapStage
# ---------------------------------------------------------------------------

def _hdr(shape, dtype, labels):
    n = len(shape)
    return {'name': 's', 'time_tag': 0, 'gulp_nframe': 4, '_tensor': {
        'shape': list(shape), 'dtype': dtype, 'labels': list(labels),
        'scales': [[0.5 * i, 1.0 + i] for i in range(n)],
        'units': [None] * n}}


@pytest.mark.parametrize('expr,idtype,odtype,scalars', [
    ('b = a.mag2()', 'ci8', 'f32', None),
    ('b = a * k', 'cf32', None, {'k': 3}),
    ('b = a > t ? a : 0', 'f32', None, {'t': 0.5}),
])
def test_map_stage_equals_jax(expr, idtype, odtype, scalars):
    rng = np.random.RandomState(14)
    shape = (4, 2, 8)
    hdr = _hdr([-1, 2, 8], idtype, ['time', 'pol', 'fine'])
    if idtype == 'ci8':
        v = rng.randint(-100, 100, size=shape + (2,)).astype(np.int8)
        tx, jx = torch.from_numpy(v), v
    elif idtype == 'cf32':
        v = (rng.randn(*shape) + 1j * rng.randn(*shape)) \
            .astype(np.complex64)
        tx, jx = torch.from_numpy(v), v
    else:
        v = rng.rand(*shape).astype(np.float32)
        tx, jx = torch.from_numpy(v), v
    ts = TS.MapStage(expr, dtype=odtype, scalars=scalars)
    js = JS.MapStage(expr, dtype=odtype, scalars=scalars)
    th = ts.transform_header(deepcopy(hdr))
    jh = js.transform_header(deepcopy(hdr))
    assert th == jh
    meta = {'shape': list(tx.shape), 'reim': idtype == 'ci8'}
    got = ts.build(dict(meta, dtype=bt.DataType(idtype)))(tx).numpy()
    want = np.asarray(js.build(dict(meta, dtype=bf.DataType(idtype)))(jx))
    assert got.dtype == want.dtype and got.shape == want.shape
    if idtype == 'ci8':
        np.testing.assert_array_equal(got, want)
    else:
        assert np.abs(got - want).max() <= \
            F32_REL * max(np.abs(want).max(), 1)
    assert TS.MapStage.batch_safe


def _run_chain(gulps, hdr, stages_fn):
    from tests.test_torch_dsp_library import _Gather, _Source
    with bt.Pipeline() as p:
        b = bt.blocks.copy(_Source(gulps, hdr, gulps[0].shape[0]),
                           space='cuda')
        sink = _Gather(bt.blocks.copy(stages_fn(b), space='system'))
    run_bounded(p)
    return sink.result(), sink.headers[0]


def test_map_stage_fused_equals_unfused_and_oracle():
    """fused([FftStage, MapStage('b = a.mag2()'), ReduceStage('freq', 4)])
    equals the same stages run as one fused block each, and a float64
    |FFT|^2 summed by 4 within 1e-5."""
    from bifrost_tpu_torch.blocks.fused import fused
    rng = np.random.RandomState(15)
    gulps = [rng.randint(-60, 60, size=(4, 2, 32, 2)).astype(np.int8)
             for _ in range(2)]
    hdr = _hdr([-1, 2, 32], 'ci8', ['time', 'pol', 'fine_time'])

    def stages():
        return [TS.FftStage('fine_time', axis_labels='freq'),
                TS.MapStage('b = a.mag2()', dtype='f32'),
                TS.ReduceStage('freq', 4)]

    whole, h1 = _run_chain(gulps, hdr, lambda b: fused(b, stages()))

    def one_by_one(b):
        for s in stages():
            b = fused(b, [s])
        return b
    split, h2 = _run_chain(gulps, hdr, one_by_one)
    np.testing.assert_array_equal(whole, split)
    assert h1['_tensor'] == h2['_tensor']
    v = np.concatenate(gulps).astype(np.float64)
    spec = np.fft.fft(v[..., 0] + 1j * v[..., 1], axis=-1)
    want = (np.abs(spec) ** 2).reshape(8, 2, 8, 4).sum(-1)
    assert np.abs(whole - want).max() / np.abs(want).max() < F32_REL
    assert h1['_tensor']['dtype'] == 'f32'
