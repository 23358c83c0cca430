"""The mesh tier of the PyTorch/CUDA port (bifrost_tpu_torch.parallel: the
mesh, the shard/unshard helpers, the collectives and the sharded ops)
against the JAX package on its 8-device CPU mesh (tests/conftest.py), on
the same seeded numpy inputs.  The port's mesh here is 8 CPU ranks, the
default after ``set_device('cpu')``.

Tolerances: integer results and every collective, bit for bit; float
sharded ops within 1e-5 of the JAX function relative to the largest
magnitude (sums taken in another order, and another FFT); sharded FDMT
within 1e-4 of the JAX function (the FDMT gate, tests/test_mesh_pipeline.py
:313-314) and bit for bit against the port's single-device core.
"""

import numpy as np
import pytest
import torch

import jax
from jax import lax

from bifrost_tpu import parallel as jpar
from bifrost_tpu.ops import fdmt as JF
from bifrost_tpu.parallel.ops import _shard_map as _jax_shard_map

import bifrost_tpu_torch as bt
from bifrost_tpu_torch import device
from bifrost_tpu_torch import parallel as par
from bifrost_tpu_torch.ops import fdmt as TF
from bifrost_tpu_torch.parallel import ops as pops

RTOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    device.set_device('cpu')
    for kind in pops.collectives:
        pops.collectives[kind] = 0


def _close(got, want, rtol=RTOL):
    got = np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.max(np.abs(got.astype(np.complex128) - want)) / \
        np.max(np.abs(want))
    assert err <= rtol, err


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------------------
# the mesh (tests/test_parallel.py:20)
# ---------------------------------------------------------------------------

def test_create_mesh_holds_eight_cpu_ranks_as_the_jax_tests_do():
    mesh = par.create_mesh()
    jmesh = jpar.create_mesh()
    assert mesh.devices.size == jmesh.devices.size == 8
    assert mesh.axis_names == jmesh.axis_names == ('dp',)
    assert all(d == torch.device('cpu') for d in mesh.rank_devices)
    mesh2 = par.create_mesh({'sp': 2, 'tp': 4})
    jmesh2 = jpar.create_mesh({'sp': 2, 'tp': 4})
    assert mesh2.axis_names == jmesh2.axis_names == ('sp', 'tp')
    assert mesh2.shape == dict(jmesh2.shape)
    assert par.mesh_axes(mesh2) == jpar.mesh_axes(jmesh2)
    assert dict(par.create_mesh(4).shape) == dict(jpar.create_mesh(4).shape)


def test_local_mesh_equals_jax():
    for n, axes in ((None, None), (4, None), (8, {'sp': 4, 'tp': 2})):
        m = par.local_mesh(n, axes)
        j = jpar.local_mesh(n, axes)
        assert m.axis_names == j.axis_names
        assert m.shape == dict(j.shape)


@pytest.mark.parametrize('axes', [{'sp': 16}, {'sp': 4, 'tp': 4}, 9])
def test_create_mesh_rejects_more_ranks_than_devices(axes):
    with pytest.raises(ValueError, match='Mesh wants'):
        par.create_mesh(axes)
    with pytest.raises(ValueError, match='Mesh wants'):
        jpar.create_mesh(axes)


def test_default_mesh_is_one_rank_per_card(monkeypatch):
    monkeypatch.setattr(device, '_device', torch.device('cuda', 0))
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 2)
    mesh = par.create_mesh()
    assert mesh.rank_devices == [torch.device('cuda', 0),
                                 torch.device('cuda', 1)]
    # ranks may repeat a card: D ranks on one card
    m4 = par.create_mesh({'sp': 4}, devices=['cuda:0'] * 4)
    assert m4.rank_devices == [torch.device('cuda', 0)] * 4


def test_mesh_refuses_mismatched_axis_names():
    with pytest.raises(ValueError):
        par.Mesh(np.array([torch.device('cpu')] * 4, dtype=object),
                 ('sp', 'tp'))


# ---------------------------------------------------------------------------
# shard / unshard
# ---------------------------------------------------------------------------

def test_shard_gives_views_of_a_tensor_on_the_ranks_device():
    mesh = par.create_mesh({'sp': 2, 'tp': 4})
    x = torch.arange(8 * 12 * 3).reshape(8, 12, 3)
    blocks = par.shard(x, mesh, par.PartitionSpec('sp', 'tp'))
    assert len(blocks) == 8
    for r, b in enumerate(blocks):
        sp, tp = mesh.coords(r)
        assert b.shape == (4, 3, 3)
        assert b.untyped_storage().data_ptr() == \
            x.untyped_storage().data_ptr()
        assert torch.equal(b, x[sp * 4:(sp + 1) * 4, tp * 3:(tp + 1) * 3])


@pytest.mark.parametrize('spec', [('sp',), ('sp', 'tp'), (None, 'tp'),
                                  ('tp', None, 'sp'), ()])
def test_unshard_inverts_shard(spec):
    mesh = par.create_mesh({'sp': 2, 'tp': 4})
    x = torch.from_numpy(np.random.RandomState(0).rand(8, 8, 4))
    got = par.unshard(par.shard(x, mesh, par.PartitionSpec(*spec)), mesh,
                      par.PartitionSpec(*spec))
    assert torch.equal(got, x)


def test_shard_rejects_an_axis_that_does_not_divide():
    mesh = par.create_mesh({'sp': 8})
    with pytest.raises(ValueError, match='does not divide'):
        par.shard(torch.zeros(12, 3), mesh, par.PartitionSpec('sp'))
    with pytest.raises(ValueError, match='not in'):
        par.shard(torch.zeros(8, 3), mesh, par.PartitionSpec('xx'))


def test_shard_gulp_and_gather_local():
    mesh = par.create_mesh({'sp': 4})
    x = torch.arange(16.).reshape(8, 2)
    blocks = par.shard_gulp(x, mesh, 0)
    assert [b.shape[0] for b in blocks] == [2] * 4
    assert par.shard_gulp(torch.zeros(6, 2), mesh, 0).shape == (6, 2)
    assert par.gather_local(x) is x


# ---------------------------------------------------------------------------
# collectives, each against the JAX lax collective on the same mesh
# ---------------------------------------------------------------------------

def _jax_collective(mesh, body, in_spec, out_spec, x):
    import inspect
    from jax.sharding import PartitionSpec as JP
    sm = _jax_shard_map()
    params = inspect.signature(sm).parameters
    kw = {}
    # the replication of a gathered or summed output is not inferred
    # through every collective: switch the check off (scope.py's idiom)
    for k in ('check_vma', 'check_rep'):
        if k in params:
            kw[k] = False
            break
    fn = sm(body, mesh=mesh, in_specs=JP(*in_spec), out_specs=JP(*out_spec),
            **kw)
    return np.asarray(jax.jit(fn)(x))


_RING = [(i, (i + 1) % 4) for i in range(4)]
_SHIFT = [(i, i - 1) for i in range(1, 4)]


@pytest.mark.parametrize('kind', ['psum', 'ppermute_ring', 'ppermute_shift',
                                  'all_gather', 'all_to_all'])
def test_collective_bit_identical_to_jax(kind):
    """On a {'sp': 2, 'tp': 4} mesh, each collective over 'tp' of int32
    blocks equals the JAX collective, bit for bit."""
    P = par.PartitionSpec
    mesh = par.create_mesh({'sp': 2, 'tp': 4})
    jmesh = jpar.create_mesh({'sp': 2, 'tp': 4})
    x = np.random.RandomState(3).randint(-1000, 1000, (8, 16, 3)) \
        .astype(np.int32)
    spec_in = ('sp', 'tp')
    if kind == 'psum':
        body = lambda b: pops.psum(mesh, b, 'tp')
        jbody = lambda b: lax.psum(b, 'tp')
        spec_out = ('sp', None)
    elif kind.startswith('ppermute'):
        perm = _RING if kind == 'ppermute_ring' else _SHIFT
        body = lambda b: pops.ppermute(mesh, b, 'tp', perm)
        jbody = lambda b: lax.ppermute(b, 'tp', perm)
        spec_out = spec_in
    elif kind == 'all_gather':
        body = lambda b: pops.all_gather(mesh, b, 'tp', axis=1)
        jbody = lambda b: lax.all_gather(b, 'tp', axis=1, tiled=True)
        spec_out = ('sp', None)
    else:
        body = lambda b: pops.all_to_all(mesh, b, 'tp', 0, 1)
        jbody = lambda b: lax.all_to_all(b, 'tp', split_axis=0,
                                         concat_axis=1, tiled=True)
        spec_out = spec_in
    got = par.shard_map(body, mesh, P(*spec_in), P(*spec_out))(_t(x))
    want = _jax_collective(jmesh, jbody, spec_in, spec_out, x)
    np.testing.assert_array_equal(got.numpy(), want)
    assert pops.collectives[kind.split('_')[0] if kind.startswith('pp')
                            else kind] == 1


def test_axis_index_and_groups_follow_the_mesh():
    mesh = par.create_mesh({'sp': 2, 'tp': 4})
    assert par.axis_index(mesh, 'tp') == [0, 1, 2, 3] * 2
    assert par.axis_index(mesh, 'sp') == [0] * 4 + [1] * 4
    assert pops.axis_groups(mesh, 'sp') == [[0, 4], [1, 5], [2, 6], [3, 7]]


def test_ppermute_refuses_a_non_permutation():
    mesh = par.create_mesh({'sp': 4})
    with pytest.raises(ValueError, match='permutation'):
        pops.ppermute(mesh, [torch.zeros(2)] * 4, 'sp', [(0, 1), (2, 1)])


# ---------------------------------------------------------------------------
# sharded ops (tests/test_parallel.py:27-95)
# ---------------------------------------------------------------------------

def test_sharded_spectrometer_matches_jax():
    rng = np.random.RandomState(0)
    v = (rng.randn(16, 2, 32) + 1j * rng.randn(16, 2, 32)).astype(
        np.complex64)
    got = par.sharded_spectrometer(par.create_mesh({'sp': 8}), 'sp')(_t(v))
    want = jax.jit(jpar.sharded_spectrometer(
        jpar.create_mesh({'sp': 8}), 'sp'))(v)
    assert got.dtype == torch.float32 and got.shape == (32, 4)
    _close(got.numpy(), np.asarray(want))
    assert pops.collectives['psum'] == 1


def test_sharded_beamform_matches_jax():
    rng = np.random.RandomState(1)
    w = (rng.randn(4, 16) + 1j * rng.randn(4, 16)).astype(np.complex64)
    v = (rng.randn(8, 16, 8) + 1j * rng.randn(8, 16, 8)).astype(
        np.complex64)
    got = par.sharded_beamform(par.create_mesh({'tp': 8}), 'tp')(_t(w), _t(v))
    want = jax.jit(jpar.sharded_beamform(jpar.create_mesh({'tp': 8}),
                                         'tp'))(w, v)
    _close(got.numpy(), np.asarray(want))


def test_sharded_correlate_matches_jax():
    rng = np.random.RandomState(2)
    v = (rng.randn(8, 8, 4) + 1j * rng.randn(8, 8, 4)).astype(np.complex64)
    got = par.sharded_correlate(par.create_mesh({'sp': 2, 'tp': 4}),
                                'tp', 'sp')(_t(v))
    want = jax.jit(jpar.sharded_correlate(
        jpar.create_mesh({'sp': 2, 'tp': 4}), 'tp', 'sp'))(v)
    _close(got.numpy(), np.asarray(want))
    _close(got.numpy(), np.einsum('taf,tbf->fab', v, v.conj()))
    assert pops.collectives['all_gather'] == 1
    assert pops.collectives['psum'] == 1


def test_sharded_correlate_integer_valued_is_exact():
    """Integer-valued voltages: every float sum is exact, so the port
    equals the JAX function bit for bit."""
    rng = np.random.RandomState(4)
    v = (rng.randint(-8, 8, (8, 8, 4)) +
         1j * rng.randint(-8, 8, (8, 8, 4))).astype(np.complex64)
    got = par.sharded_correlate(par.create_mesh({'sp': 2, 'tp': 4}),
                                'tp', 'sp')(_t(v))
    want = jax.jit(jpar.sharded_correlate(
        jpar.create_mesh({'sp': 2, 'tp': 4}), 'tp', 'sp'))(v)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize('coeffs', [[0.5, 0.3, 0.2], [0.7]])
def test_sharded_fir_halo_exchange_matches_jax(coeffs):
    coeffs = np.array(coeffs, np.float32)
    x = np.random.RandomState(5).randn(32, 3).astype(np.float32)
    got = par.sharded_fir(par.create_mesh({'sp': 8}), coeffs, 'sp')(_t(x))
    want = jax.jit(jpar.sharded_fir(jpar.create_mesh({'sp': 8}), coeffs,
                                    'sp'))(x)
    _close(got.numpy(), np.asarray(want))
    ntap = len(coeffs)
    xp = np.concatenate([np.zeros((ntap - 1, 3), np.float32), x])
    expect = sum(coeffs[t] * xp[ntap - 1 - t:ntap - 1 - t + 32]
                 for t in range(ntap))
    _close(got.numpy(), expect)


def test_fir_state_carries_the_last_shards_halo():
    mesh = par.create_mesh({'sp': 4})
    x = torch.arange(16.).reshape(16, 1)
    state = [torch.full((2, 1), 100.)] * 4
    coeffs = torch.tensor([1., 1., 1.])
    y, new = pops._local_fir_stateful(
        mesh, par.shard(x, mesh, par.PartitionSpec('sp')), coeffs, state,
        'sp')
    assert torch.equal(par.unshard(y, mesh, par.PartitionSpec('sp'))[:3, 0],
                       torch.tensor([200., 101., 3.]))
    assert all(torch.equal(s, x[-2:]) for s in new)


def _fdmt_plans(nchan, md):
    return (JF.Fdmt().init(nchan, md, 1400.0, -0.1),
            TF.Fdmt().init(nchan, md, 1400.0, -0.1, space='system'))


@pytest.mark.parametrize('negative', [False, True])
@pytest.mark.parametrize('core', ['xla', 'pallas'])
def test_sharded_fdmt_matches_jax_and_the_single_device_core(negative, core):
    """Time-sharded FDMT with its max_delay halo: within 1e-4 of the JAX
    function and of the float64 oracle, and bit for bit the port's
    single-device core (the gather core, and K3's plain version)."""
    jp, tp = _fdmt_plans(32, 8)
    x = np.random.RandomState(3).randn(32, 128).astype(np.float32)
    cores = {'xla': tp._core_jax, 'pallas': tp._core_pallas}
    c = cores[core](negative)
    got = par.sharded_fdmt(par.create_mesh({'sp': 8}), tp, 'sp',
                           negative_delays=negative, core=c)(_t(x))
    want = jax.jit(jpar.sharded_fdmt(jpar.create_mesh({'sp': 8}), jp, 'sp',
                                     negative_delays=negative))(x)
    _close(got.numpy(), np.asarray(want), rtol=1e-4)
    _close(got.numpy(), tp._core_numpy(x.astype(np.float64), negative),
           rtol=1e-4)
    single = c(_t(x)[None])[0]
    assert torch.equal(got, single)
    assert pops.collectives['ppermute'] == 1


def test_sharded_fdmt_default_core_is_the_gather_core():
    _, tp = _fdmt_plans(16, 8)
    x = np.random.RandomState(6).rand(16, 64).astype(np.float32)
    got = par.sharded_fdmt(par.create_mesh({'sp': 4}), tp, 'sp')(_t(x))
    assert torch.equal(got, tp._core_jax(False)(_t(x)[None])[0])


def test_sharded_fdmt_rejects_short_shards():
    _, tp = _fdmt_plans(32, 16)
    with pytest.raises(ValueError, match='max_delay'):
        par.sharded_fdmt(par.create_mesh({'sp': 8}), tp,
                         'sp')(torch.zeros(32, 64))


def test_spectrometer_step_matches_jax():
    """The flagship step on a {'sp': 2, 'tp': 4} mesh (the JAX
    dryrun_multichip geometry): FIR halo, FFT, beamform psum, Stokes
    power, integrate, correlate."""
    rng = np.random.RandomState(1)
    T, A, F, B = 8, 16, 16, 4
    volt = rng.randint(-8, 8, size=(T, A, F, 2)).astype(np.int8)
    w = (rng.rand(B, A) + 1j * rng.rand(B, A)).astype(np.complex64)
    coeffs = np.array([0.25, 0.5, 0.25], np.float32)
    spectra, vis = par.spectrometer_step(par.create_mesh(
        {'sp': 2, 'tp': 4}))(_t(volt), _t(w), _t(coeffs))
    jspec, jvis = jax.jit(jpar.spectrometer_step(jpar.create_mesh(
        {'sp': 2, 'tp': 4})))(volt, w, coeffs)
    assert spectra.shape == (B, F) and vis.shape == (F, A, A)
    _close(spectra.numpy(), np.asarray(jspec))
    _close(vis.numpy(), np.asarray(jvis))
