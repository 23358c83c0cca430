"""The flagship spectrometer chain through the PyTorch/CUDA port's
Pipeline, against the same chain through bifrost_tpu's Pipeline on the
same gulps and the same header, and against the float64 oracle:

    source (ci8) -> copy('cuda') -> fused[FftStage -> DetectStage('stokes')
    -> ReduceStage('freq', 4)] -> copy('system') -> sink

The port runs on the CPU device here (set_device('cpu')), so its 'cuda'
ring holds CPU tensors and each kernel wrapper runs its plain version.
Tolerance: 1e-5 relative to the maximum, the spectrometer gate."""

import contextlib
from copy import deepcopy

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import bifrost_tpu as bf
from bifrost_tpu.stages import (FftStage as JFft, DetectStage as JDetect,
                                ReduceStage as JReduce,
                                compose_stages as jcompose,
                                walk_headers as jwalk)
from tests.util import NumpySourceBlock, GatherSink, simple_header

import bifrost_tpu_torch as bt
from bifrost_tpu_torch import device
from bifrost_tpu_torch.ops import gpu_kernels
from bifrost_tpu_torch.ops import spectrometer as spec
from bifrost_tpu_torch.stages import (FftStage, DetectStage, ReduceStage,
                                      SpectrometerPlan, compose_stages,
                                      walk_headers)
from tests.test_torch_bounded import run_bounded

NT, NPOL, NFINE, RF, NGULP = 16, 2, 256, 4, 3
GATE = 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    device.set_device('cpu')


def _rel(got, want):
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


def _header():
    return simple_header([-1, NPOL, NFINE], 'ci8',
                         labels=['time', 'pol', 'fine_time'])


def _gulps(seed=7):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(NGULP):
        raw = np.zeros((NT, NPOL, NFINE), dtype=bf.dtype.ci8)
        raw['re'] = rng.randint(-64, 64, size=(NT, NPOL, NFINE))
        raw['im'] = rng.randint(-64, 64, size=(NT, NPOL, NFINE))
        out.append(raw)
    return out


def _volt(raw):
    return np.stack([raw['re'], raw['im']], axis=-1).astype(np.int8)


class _Source(bt.SourceBlock):
    def __init__(self, gulps, header):
        super(_Source, self).__init__(['numpy'], NT, space='system')
        self._gulps = gulps
        self._header = header

    def create_reader(self, sourcename):
        return contextlib.nullcontext(iter(self._gulps))

    def on_sequence(self, reader, sourcename):
        return [deepcopy(self._header)]

    def on_data(self, reader, ospans):
        arr = next(reader, None)
        if arr is None:
            return [0]
        ospans[0].data.as_numpy()[:arr.shape[0]] = arr
        return [arr.shape[0]]


class _Gather(bt.SinkBlock):
    def __init__(self, iring):
        super(_Gather, self).__init__(iring)
        self.headers, self.gulps = [], []

    def on_sequence(self, iseq):
        self.headers.append(iseq.header)

    def on_data(self, ispan):
        self.gulps.append(np.array(ispan.data.as_numpy(), copy=True))


def _run_port(gulps, substitute):
    with bt.Pipeline() as p:
        src = _Source(gulps, _header())
        b = bt.blocks.copy(src, space='cuda')
        fb = bt.blocks.fused(b, [FftStage('fine_time', axis_labels='freq'),
                                 DetectStage('stokes', axis='pol'),
                                 ReduceStage('freq', RF)],
                             substitute=substitute)
        b = bt.blocks.copy(fb, space='system')
        sink = _Gather(b)
        run_bounded(p)
    return np.concatenate(sink.gulps), sink.headers[0], fb.impl_info


def _run_jax(gulps):
    with bf.Pipeline() as p:
        src = NumpySourceBlock(gulps, _header(), gulp_nframe=NT)
        b = bf.blocks.copy(src, space='tpu')
        b = bf.blocks.fused(b, [JFft('fine_time', axis_labels='freq'),
                                JDetect('stokes', axis='pol'),
                                JReduce('freq', RF)])
        b = bf.blocks.copy(b, space='system')
        sink = GatherSink(b)
        run_bounded(p)
    return sink.result(), sink.headers[0]


@pytest.fixture(scope='module')
def jax_run():
    gulps = _gulps()
    out, hdr = _run_jax(gulps)
    return gulps, out, hdr


@pytest.mark.parametrize('substitute', [True, False])
def test_pipeline_matches_jax_pipeline(jax_run, monkeypatch, substitute):
    gulps, want, jhdr = jax_run
    calls = {'k1': 0, 'k2': 0}

    def counting(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(spec, 'fused_spectrometer',
                        counting('k1', spec.fused_spectrometer))
    monkeypatch.setattr(gpu_kernels, 'stokes_detect',
                        counting('k2', gpu_kernels.stokes_detect))
    got, hdr, info = _run_port(gulps, substitute)
    assert got.shape == want.shape == (NGULP * NT, 4, NFINE // RF)
    assert _rel(got, want) < GATE
    oracle = np.concatenate([spec.spectrometer_oracle(_volt(g), RF)
                             for g in gulps])
    assert _rel(got, oracle) < GATE
    # the same output stream contract as the JAX pipeline
    assert hdr['_tensor'] == jhdr['_tensor']
    assert hdr['gulp_nframe'] == jhdr['gulp_nframe'] == NT
    # the path that ran, as the block published it, and the wrapper it
    # went through once per gulp and once in the block's prewarm at
    # sequence start (the plain version, on the CPU)
    if substitute:
        assert info == {'impl': 'cuda-spectrometer', 'kernel': 'plain',
                        'nfft': NFINE, 'rfactor': RF}
        assert calls == {'k1': NGULP + 1, 'k2': 0}
    else:
        assert info == {'impl': 'torch-fused'}
        assert calls == {'k1': 0, 'k2': NGULP + 1}
    assert spec.launches == 0
    assert not any(gpu_kernels.launches.values())


@pytest.mark.parametrize('substitute', [True, False])
def test_compose_stages_matches_jax(substitute):
    """One gulp through the port's compose_stages and the JAX package's,
    from the same header and voltages."""
    volt = _volt(_gulps(seed=11)[0])
    hdr = _header()
    jstages = [JFft('fine_time', axis_labels='freq'),
               JDetect('stokes', axis='pol'), JReduce('freq', RF)]
    jfn, jinfo = jcompose(jstages, jwalk(jstages, deepcopy(hdr)),
                          volt.shape, 'int8')
    want = np.asarray(jfn(jnp.asarray(volt)))
    stages = [FftStage('fine_time', axis_labels='freq'),
              DetectStage('stokes', axis='pol'), ReduceStage('freq', RF)]
    headers = walk_headers(stages, deepcopy(hdr))
    fn, info = compose_stages(stages, headers, volt.shape, torch.int8,
                              substitute=substitute)
    assert isinstance(fn, SpectrometerPlan) == substitute
    assert info['impl'] == ('cuda-spectrometer' if substitute
                            else 'torch-fused')
    got = fn(torch.from_numpy(volt)).numpy()
    assert _rel(got, want) < GATE
    assert headers[-1]['_tensor'] == jwalk(jstages, deepcopy(hdr))[-1][
        '_tensor']


def test_matcher_rejects_non_matching_chains():
    from bifrost_tpu_torch.stages import match_spectrometer
    hdr = _header()
    shape = (NT, NPOL, NFINE, 2)
    # no reduce: not the spectrometer pattern
    stages = [FftStage('fine_time'), DetectStage('stokes', axis='pol')]
    assert match_spectrometer(stages, walk_headers(stages, hdr), shape,
                              torch.int8) is None
    # beyond the kernel's shared-memory limit
    big = (NT, NPOL, 2 * spec.MAX_NFFT, 2)
    bhdr = simple_header([-1, NPOL, 2 * spec.MAX_NFFT], 'ci8',
                         labels=['time', 'pol', 'fine_time'])
    stages = [FftStage('fine_time'), DetectStage('stokes', axis='pol'),
              ReduceStage('fine_time', RF)]
    assert match_spectrometer(stages, walk_headers(stages, bhdr), big,
                              torch.int8) is None


def test_failing_block_raises_from_run():
    """A block that raises aborts the pipeline: run() raises with the
    original error instead of hanging or returning."""
    class Boom(bt.TransformBlock):
        def on_sequence(self, iseq):
            return deepcopy(iseq.header)

        def on_data(self, ispan, ospan):
            raise ValueError('boom')

    with bt.Pipeline() as p:
        src = _Source(_gulps(), _header())
        b = Boom(src)
        _Gather(b)
        with pytest.raises(bt.PipelineRuntimeError, match='boom'):
            run_bounded(p)