"""The check catches what it must: with the timed path broken underneath
(the harness's look for a card skipped, the chain on the CPU at a tiny
geometry), ``correct`` comes out false for each fault a cell can have,
and the control (the reference one precision below the configuration's)
fails the cell's limit.  One chip, so no exchange between chips can be
left out."""

import pytest
import torch


def _alter_one(out):
    out = out.clone()
    flat = out.view(-1)
    flat[flat.numel() // 3] += 0.25 * flat.abs().max() + 1
    return out


def _spectrometer_fault(monkeypatch, kind):
    from bifrost_tpu_torch.ops import spectrometer as spec
    orig = spec.fused_spectrometer

    def altered(x, *a, **k):
        return _alter_one(orig(x, *a, **k))

    def half(x, *a, **k):
        out = orig(x, *a, **k)
        h = out.shape[0] // 2
        return torch.cat([out[:h], out[:h]])[:out.shape[0]]
    if kind in ('altered', 'half'):
        monkeypatch.setattr(spec, 'fused_spectrometer',
                            altered if kind == 'altered' else half)
    else:
        _stale_d2h(monkeypatch)


def _stale_d2h(monkeypatch):
    """The D2H copy stops landing its bytes after a few gulps: the output
    ring keeps what an earlier gulp left there (state unchanged)."""
    import importlib
    copy_mod = importlib.import_module('bifrost_tpu_torch.blocks.copy')
    orig = copy_mod.CopyBlock.on_data
    seen = {'n': 0}

    def stale(self, ispan, ospan):
        if ispan.ring.is_device and not ospan.ring.is_device:
            seen['n'] += 1
            if seen['n'] > 6:
                return None
        return orig(self, ispan, ospan)
    monkeypatch.setattr(copy_mod.CopyBlock, 'on_data', stale)


def _fx_fault(monkeypatch, kind):
    if kind == 'stale':
        import importlib
        acc_mod = importlib.import_module(
            'bifrost_tpu_torch.blocks.accumulate')
        orig = acc_mod.AccumulateBlock.on_data

        def unchanged(self, ispan, ospan):
            # the running sum never takes in the later gulps
            if self._acc is None or self.frame_count == 0:
                return orig(self, ispan, ospan)
            self.frame_count += 1
            if self.frame_count < self.nframe:
                return 0
            ospan.set(self._acc)
            self._acc, self.frame_count = None, 0
            return 1
        monkeypatch.setattr(acc_mod.AccumulateBlock, 'on_data', unchanged)
    elif kind == 'half':
        from bifrost_tpu_torch import stages
        orig = stages.CorrelateStage.build

        def build(self, in_meta):
            fn = orig(self, in_meta)

            def half(x):
                h = x.shape[0] // 2
                return fn(torch.cat([x[:h], x[:h]]))
            return half
        monkeypatch.setattr(stages.CorrelateStage, 'build', build)
    else:
        import importlib
        cv = importlib.import_module(
            'bifrost_tpu_torch.blocks.convert_visibilities')
        orig = cv.matrix_to_storage
        monkeypatch.setattr(cv, 'matrix_to_storage',
                            lambda *a: _alter_one(orig(*a)))


@pytest.mark.parametrize('kind', ['stale', 'half', 'altered'])
def test_spectrometer_faults_are_not_correct(run_tiny, monkeypatch, kind):
    _spectrometer_fault(monkeypatch, kind)
    result, _, _ = run_tiny('tiny_guppi')
    assert result['correct'] is False
    assert result['check']['spec_err']['value'] > \
        result['check']['spec_err']['limit']
    assert result['failed'] > 0


@pytest.mark.parametrize('kind', ['stale', 'half', 'altered'])
def test_fx_faults_are_not_correct(run_tiny, monkeypatch, kind):
    _fx_fault(monkeypatch, kind)
    result, _, _ = run_tiny('tiny_fx')
    assert result['correct'] is False
    assert result['check']['vis_outside']['value'] > 0


@pytest.mark.parametrize('cell,number', [('tiny_guppi', 'spec_err'),
                                         ('tiny_fx', 'vis_outside')])
def test_control_fails_the_limit(run_tiny, cell, number):
    result, _, ctl = run_tiny(cell, controls=('tf32',))
    assert result['correct'] is True
    limit = result['check'][number]['limit']
    assert result['check'][number]['value'] <= limit
    assert ctl['tf32'][number] > limit
