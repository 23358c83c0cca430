"""The port's ``LinAlg`` and ``matmul`` against the JAX package's
(``bifrost_tpu/ops/linalg.py:60-545``, ``:1030``; the cases of
``tests/test_linalg.py`` and ``tests/test_linalg_impls.py``): every
``_AB_IMPLS``, ``_AAH_IMPLS`` and ``_I8_IMPLS`` candidate against the JAX
candidate of the same name and the float64 / int64 oracle on the same
seeded inputs (f32, complex64, real x complex, and cf16 planes); the i8
family bit for bit, the float families within 1e-3 of the oracle's
maximum, ``planar_bf16`` within 8e-3.  Then ``LinAlg().matmul`` with beta
accumulation and a real ``c``, the accuracy gate, the environment
forcing and the negative-probe cache.  The port runs on the CPU device.
"""

import unittest.mock as mock

import numpy as np
import pytest

import bifrost_tpu as bf
from bifrost_tpu.ops import linalg as JL

import bifrost_tpu_torch as bt
from bifrost_tpu_torch import device
from bifrost_tpu_torch.ndarray import ndarray
from bifrost_tpu_torch.ops import linalg as L


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    device.set_device('cpu')
    for var in ('BF_LINALG_PROBE', 'BF_LINALG_AB_IMPL', 'BF_LINALG_AAH_IMPL',
                'BF_LINALG_I8_IMPL', 'BF_LINALG_GATE_RTOL'):
        monkeypatch.delenv(var, raising=False)


def _tol(impl):
    return 8e-3 if impl == 'planar_bf16' else 1e-3


def _rel(got, want):
    got = np.asarray(got).astype(np.complex128)
    want = np.asarray(want).astype(np.complex128)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _c64(rng, shape):
    return (rng.randn(*shape) + 1j * rng.randn(*shape)).astype(np.complex64)


def _cf16(rng, shape):
    """(port host ndarray, JAX host ndarray, complex128 values) of one
    cf16 array."""
    vr = rng.randn(*shape).astype(np.float16)
    vi = rng.randn(*shape).astype(np.float16)
    jx = bf.empty(shape, 'cf16', 'system')
    jb = jx.as_numpy()
    jb['re'], jb['im'] = vr, vi
    tx = ndarray(np.array(jb, copy=True), dtype='cf16')
    return tx, jx, vr.astype(np.complex128) + 1j * vi


def _ci8(rng, shape):
    """(port host ndarray, JAX host ndarray, int64 complex values)."""
    re = rng.randint(-128, 128, size=shape).astype(np.int8)
    im = rng.randint(-128, 128, size=shape).astype(np.int8)
    jx = bf.empty(shape, 'ci8', 'system')
    jb = jx.as_numpy()
    jb['re'], jb['im'] = re, im
    tx = ndarray(np.array(jb, copy=True), dtype='ci8')
    return tx, jx, re.astype(np.int64) + 1j * im.astype(np.int64)


def _ab_operands(kind, rng):
    """(port a, port b, JAX a, JAX b, complex128 oracle) for the a @ b
    cases."""
    if kind == 'f32':
        a = rng.randn(3, 8, 24).astype(np.float32)
        b = rng.randn(3, 24, 6).astype(np.float32)
        return a, b, a, b, a.astype(np.float64) @ b
    if kind == 'c64':
        a, b = _c64(rng, (3, 8, 24)), _c64(rng, (3, 24, 6))
        return a, b, a, b, a.astype(np.complex128) @ b
    if kind == 'real_x_complex':
        a, b = rng.randn(3, 8, 24).astype(np.float32), _c64(rng, (3, 24, 6))
        return a, b, a, b, a.astype(np.complex128) @ b
    if kind == 'complex_x_real':
        a, b = _c64(rng, (3, 8, 24)), rng.randn(3, 24, 6).astype(np.float32)
        return a, b, a, b, a.astype(np.complex128) @ b
    # cf16 voltages (T, A, F) under c64 weights (B, A): the beamform
    # contraction by matmul broadcasting
    w = _c64(rng, (8, 24))
    tv, jv, v = _cf16(rng, (12, 24, 16))
    return w, tv, w, jv, np.einsum('ba,taf->tbf', w.astype(np.complex128), v)


AB_KINDS = ['f32', 'c64', 'real_x_complex', 'complex_x_real', 'cf16']


@pytest.mark.parametrize('kind', AB_KINDS)
@pytest.mark.parametrize('impl', sorted(L._AB_IMPLS))
def test_ab_candidates_match_jax_and_oracle(impl, kind):
    rng = np.random.RandomState(10 + AB_KINDS.index(kind))
    ta, tb, ja, jb, oracle = _ab_operands(kind, rng)
    y = L.LinAlg(ab_impl=impl).matmul(1.0, ta, tb, 0.0, None)
    jy = JL.LinAlg(ab_impl=impl).matmul(1.0, ja, jb, 0.0, None)
    assert tuple(y.shape) == oracle.shape
    assert _rel(y.numpy(), oracle) <= _tol(impl)
    assert _rel(y.numpy(), jy) <= _tol(impl)


def _aah_operands(kind, rng):
    if kind == 'f32':
        a = rng.randn(3, 12, 32).astype(np.float32)
        return a, a, a.astype(np.float64) @ a.transpose(0, 2, 1)
    if kind == 'c64':
        a = _c64(rng, (3, 12, 32))
        ac = a.astype(np.complex128)
        return a, a, ac @ np.conj(ac.transpose(0, 2, 1))
    ta, ja, v = _cf16(rng, (12, 32))
    return ta, ja, v @ np.conj(v.T)


AAH_KINDS = ['f32', 'c64', 'cf16']


@pytest.mark.parametrize('kind', AAH_KINDS)
@pytest.mark.parametrize('impl', sorted(L._AAH_IMPLS))
def test_aah_candidates_match_jax_and_oracle(impl, kind):
    rng = np.random.RandomState(20 + AAH_KINDS.index(kind))
    ta, ja, oracle = _aah_operands(kind, rng)
    y = L.LinAlg(aah_impl=impl).matmul(1.0, ta, None, 0.0, None)
    jy = JL.LinAlg(aah_impl=impl).matmul(1.0, ja, None, 0.0, None)
    assert y.is_complex()
    assert _rel(y.numpy(), oracle) <= _tol(impl)
    assert _rel(y.numpy(), jy) <= _tol(impl)


@pytest.mark.parametrize('shape', [(16, 32), (3, 24, 40), (2, 17, 9)])
@pytest.mark.parametrize('impl', sorted(L._I8_IMPLS))
def test_i8_candidates_exact(impl, shape):
    """ci8 a @ a^H: int32 sums, bit for bit the int64 oracle and the JAX
    candidate, at the int8 extremes too."""
    rng = np.random.RandomState(30)
    ta, ja, z = _ci8(rng, shape)
    if shape == (2, 17, 9):
        ta.as_numpy()['re'][...] = -128
        ja.as_numpy()['re'][...] = -128
        z = -128 + 1j * z.imag
    oracle = z @ np.conj(np.swapaxes(z, -1, -2))
    y = L.LinAlg(i8_impl=impl).matmul(1.0, ta, None, 0.0, None)
    jy = JL.LinAlg(i8_impl=impl).matmul(1.0, ja, None, 0.0, None)
    np.testing.assert_array_equal(y.numpy(), oracle.astype(np.complex64))
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))


@pytest.mark.parametrize('impl', sorted(L._I8_IMPLS))
def test_i8_candidates_batched_beta(impl):
    rng = np.random.RandomState(31)
    ta, ja, z = _ci8(rng, (2, 8, 16))
    c0 = _c64(rng, (2, 8, 8))
    want = 2.0 * (z @ np.conj(np.swapaxes(z, -1, -2))) + 0.5 * c0
    tc, jc = c0.copy(), c0.copy()
    got = L.LinAlg(i8_impl=impl).matmul(2.0, ta, None, 0.5, tc)
    jy = JL.LinAlg(i8_impl=impl).matmul(2.0, ja, None, 0.5, jc)
    assert got is tc
    assert _rel(tc, want) < 1e-6
    assert _rel(tc, jy) < 1e-6


def test_cf16_karatsuba_no_overflow():
    """re + im of large in-range f16 values leaves the f16 range; the
    planar paths widen the Karatsuba addends first and stay finite."""
    rng = np.random.RandomState(12)
    shape = (4, 8, 8)
    jv = bf.empty(shape, 'cf16', 'system')
    jb = jv.as_numpy()
    jb['re'] = jb['im'] = np.float16(4.0e4)
    tv = ndarray(np.array(jb, copy=True), dtype='cf16')
    w = _c64(rng, (4, 8)) * 1e-4
    v = np.full(shape, 4.0e4 + 4.0e4j)
    oracle = np.einsum('ba,taf->tbf', w.astype(np.complex128), v)
    for impl in ('planar', 'planar_hilo'):
        y = L.LinAlg(ab_impl=impl).matmul(1.0, w, tv, 0.0, None).numpy()
        assert np.isfinite(y.view(np.float32)).all(), impl
        jy = JL.LinAlg(ab_impl=impl).matmul(1.0, w, jv, 0.0, None)
        assert _rel(y, oracle) <= 1e-3 and _rel(y, jy) <= 1e-3


def test_matmul_matches_jax_with_beta_and_c():
    """``LinAlg().matmul`` (the defaults) against the JAX one: a @ b and
    a @ a^H with beta accumulation into a complex c, and a real c that
    takes the real part (``bifrost_tpu/ops/linalg.py:529-537``)."""
    rng = np.random.RandomState(40)
    a, b = _c64(rng, (4, 8, 16)), _c64(rng, (4, 16, 8))
    for args in ((1.0, a, b), (1.0, a, None), (2.0 - 1.0j, a, b)):
        c0 = _c64(rng, (4, 8, 8))
        tc, jc = c0.copy(), c0.copy()
        alpha, ta, tb = args
        bt.ops.LinAlg().matmul(alpha, ta, tb, 3.0, tc)
        jy = JL.LinAlg().matmul(alpha, ta, tb, 3.0, jc)
        ac = a.astype(np.complex128)
        prod = ac @ (b if tb is not None
                     else np.conj(ac.transpose(0, 2, 1)))
        assert _rel(tc, alpha * prod + 3.0 * c0) < 1e-5
        assert _rel(tc, jy) < 1e-5
    # a real c: the real part of alpha a b + beta c, in c's type
    fa = rng.randn(8, 4).astype(np.float32)
    fb = rng.randn(4, 8).astype(np.float32)
    c0 = rng.randn(8, 8).astype(np.float32)
    tc, jc = c0.copy(), c0.copy()
    bt.ops.matmul(2.0, fa, fb, 3.0, tc)
    jy = JL.matmul(2.0, fa, fb, 3.0, jc)
    assert tc.dtype == np.float32
    np.testing.assert_allclose(tc, 2 * (fa.astype(np.float64) @ fb)
                               + 3 * c0, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tc, np.asarray(jy), rtol=1e-6, atol=1e-6)
    rc, jrc = np.zeros((8, 8), np.float32), np.zeros((8, 8), np.float32)
    ca = _c64(rng, (8, 4))
    bt.ops.matmul(1.0, ca, fb, 0.0, rc)
    jy = JL.matmul(1.0, ca, fb, 0.0, jrc)
    want = (ca.astype(np.complex128) @ fb).real
    np.testing.assert_allclose(rc, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(rc, np.asarray(jy), rtol=1e-6, atol=1e-6)


def test_matmul_without_c_returns_a_tensor_on_the_device():
    import torch
    rng = np.random.RandomState(41)
    a = _c64(rng, (2, 4, 8))
    y = bt.ops.matmul(1.0, a, None, 0.0, None)
    assert isinstance(y, torch.Tensor) and y.device.type == 'cpu'
    assert y.dtype == torch.complex64 and tuple(y.shape) == (2, 4, 4)
    # a tensor operand stays where it is
    ta = torch.from_numpy(a)
    np.testing.assert_allclose(bt.ops.matmul(1.0, ta, None, 0.0,
                                             None).numpy(), y.numpy())


def _gate_keep(mod, rtol_env, monkeypatch):
    if rtol_env is None:
        monkeypatch.delenv('BF_LINALG_GATE_RTOL', raising=False)
    else:
        monkeypatch.setenv('BF_LINALG_GATE_RTOL', rtol_env)
    rng = np.random.RandomState(50)
    a, b = _c64(rng, (2, 32, 64)), _c64(rng, (2, 64, 32))
    if mod is L:
        import torch
        ta, tb = torch.from_numpy(a), torch.from_numpy(b)
        fns = {n: (lambda f: lambda *x: f(*x, None, alpha=1.0, beta=0.0))(
            L.LinAlg._impl('ab', n)) for n in L._AB_IMPLS}
        keep, err = L.LinAlg._accuracy_gate(fns, lambda: (ta, tb))
    else:
        fns = {n: (lambda f: lambda *x: f(*x, None, 1.0, 0.0))(
            JL._AB_IMPLS[n]) for n in JL._AB_IMPLS}
        keep, err = JL.LinAlg._accuracy_gate(fns, lambda: (a, b))
    return sorted(keep), err


def test_gate_drops_bf16_at_default_and_admits_it_widened(monkeypatch):
    """At the default 1e-3 the gate keeps every f32-class candidate and
    drops ``planar_bf16``; under BF_LINALG_GATE_RTOL=1e-2 it admits it,
    in both packages."""
    for rtol_env, want in ((None, ['planar', 'planar_hilo', 'xla']),
                           ('1e-2', ['planar', 'planar_bf16', 'planar_hilo',
                                     'xla'])):
        got = _gate_keep(L, rtol_env, monkeypatch)
        assert got == _gate_keep(JL, rtol_env, monkeypatch)
        assert got == (want, False)
    assert L.LinAlg._GATE_RTOL == JL.LinAlg._GATE_RTOL == 1e-3
    assert L.LinAlg._LOSSY == JL.LinAlg._LOSSY


def test_gate_width_is_part_of_the_probe_key(monkeypatch, tmp_path):
    """A race under a widened gate is cached under its own key: the
    default-gate key and the widened key name different entries."""
    from bifrost_tpu_torch.ops import mprobe
    monkeypatch.setenv('BF_LINALG_PROBE', '1')
    monkeypatch.setenv('BF_CACHE_DIR', str(tmp_path))
    rng = np.random.RandomState(51)
    a, b = _c64(rng, (2, 16, 32)), _c64(rng, (2, 32, 16))
    la = L.LinAlg()
    la.matmul(1.0, a, b, 0.0, None)
    base = "a=(2, 16, 32) complex64 b=(2, 32, 16) complex64"
    assert mprobe.peek('linalg_ab', base) is not None
    monkeypatch.setenv('BF_LINALG_GATE_RTOL', '1e-2')
    la2 = L.LinAlg()
    la2.matmul(1.0, a, b, 0.0, None)
    assert mprobe.peek('linalg_ab', base + '|gate_rtol=0.01') is not None
    assert la2.chosen['ab'] in L._AB_IMPLS


def test_env_forcing(monkeypatch):
    """BF_LINALG_*_IMPL force a candidate in both packages (a bad name is
    ignored); a constructor argument forces too."""
    monkeypatch.setenv('BF_LINALG_AB_IMPL', 'planar_hilo')
    monkeypatch.setenv('BF_LINALG_AAH_IMPL', 'planar')
    monkeypatch.setenv('BF_LINALG_I8_IMPL', 'i8_gram')
    rng = np.random.RandomState(52)
    a, b = _c64(rng, (2, 8, 16)), _c64(rng, (2, 16, 8))
    ta, ja, _ = _ci8(rng, (8, 16))
    chosen = []
    for mod, ci in ((L, ta), (JL, ja)):
        la = mod.LinAlg()
        la.matmul(1.0, a, b, 0.0, None)
        la.matmul(1.0, a, None, 0.0, None)
        la.matmul(1.0, ci, None, 0.0, None)
        chosen.append(dict(la.chosen))
    assert chosen[0] == chosen[1] == {'ab': 'planar_hilo', 'aah': 'planar',
                                      'i8': 'i8_gram'}
    monkeypatch.setenv('BF_LINALG_AB_IMPL', 'no-such-impl')
    assert L.LinAlg()._force['ab'] is None
    assert L.LinAlg(ab_impl='planar')._force['ab'] == 'planar'


def test_negative_probe_cache_freezes_the_default(monkeypatch, tmp_path):
    """When every raced candidate fails, the default is frozen for the
    shape in-process, so later calls neither gate nor race again."""
    from bifrost_tpu_torch.ops import mprobe
    monkeypatch.setenv('BF_LINALG_PROBE', '1')
    monkeypatch.setenv('BF_CACHE_DIR', str(tmp_path))
    monkeypatch.setattr(L, '_NEG_PROBE_CACHE', {})
    calls = []

    def boom(*args, **kwargs):
        calls.append(1)
        raise RuntimeError('candidate failed')

    real = L._I8_IMPLS['i8_3mm']
    monkeypatch.setitem(L._I8_IMPLS, 'i8_gram', boom)
    monkeypatch.setitem(L._I8_IMPLS, 'i8_3mm', boom)
    rng = np.random.RandomState(53)
    ta, _ja, z = _ci8(rng, (8, 16))
    la = L.LinAlg()
    with pytest.raises(RuntimeError):
        la.matmul(1.0, ta, None, 0.0, None)     # the default runs, fails
    key = ('i8', 'shape=(8, 16)')
    assert L._NEG_PROBE_CACHE == {key: 'i8_3mm'}
    assert la.chosen['i8'] == 'i8_3mm'
    assert mprobe.peek('linalg_i8', 'shape=(8, 16)') is None
    n = len(calls)
    monkeypatch.setitem(L._I8_IMPLS, 'i8_3mm', real)
    y = L.LinAlg().matmul(1.0, ta, None, 0.0, None)
    assert len(calls) == n               # no second probe
    np.testing.assert_array_equal(y.numpy(), (z @ np.conj(z.T)).astype(
        np.complex64))


def test_probe_selects_and_records(monkeypatch, tmp_path):
    """With probing on off the card, a winner is raced, recorded in
    ``chosen`` / ``probe_ms``, and the result matches the oracle."""
    monkeypatch.setenv('BF_LINALG_PROBE', '1')
    monkeypatch.setenv('BF_CACHE_DIR', str(tmp_path))
    rng = np.random.RandomState(7)
    a, b = _c64(rng, (2, 16, 32)), _c64(rng, (2, 32, 16))
    la = L.LinAlg()
    y = la.matmul(1.0, a, b, 0.0, None).numpy()
    assert _rel(y, a.astype(np.complex128) @ b) < 1e-3
    assert la.chosen['ab'] in ('xla', 'planar', 'planar_hilo')
    assert la.probe_ms.get('ab')


def test_float_candidates_run_without_tf32():
    """Every float LinAlg candidate runs with TF32 off and restores the
    caller's setting."""
    import torch
    seen = []
    real = L._mm_f32

    def spy(a, b):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return real(a, b)

    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        rng = np.random.RandomState(54)
        a = torch.from_numpy(_c64(rng, (2, 4, 8)))
        with mock.patch.dict(L._AB_IMPLS,
                             planar=L._ab_planar_with(spy)):
            L.LinAlg(ab_impl='planar').matmul(1.0, a, a.transpose(-1, -2),
                                              0.0, None)
        assert seen and not any(seen)
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def test_ops_exports():
    """``bt.ops.LinAlg`` and ``bt.ops.matmul`` are the module's, as
    ``bifrost_tpu/ops/__init__.py:7`` exports them."""
    assert bt.ops.LinAlg is L.LinAlg and bt.ops.matmul is L.matmul
    assert bf.ops.LinAlg is JL.LinAlg
