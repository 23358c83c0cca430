"""Static and dynamic correctness analysis of the port's pipelines (the
port of ``bifrost_tpu/analysis``).

- :mod:`bifrost_tpu_torch.analysis.verify` -- the static pipeline
  verifier: walks a Pipeline's block and ring graph before ``run()`` and
  reports stable-coded diagnostics (``BF-Exxx`` error, ``BF-Wxxx``
  warning, ``BF-Ixxx`` info).  ``Pipeline.validate()`` returns them,
  ``BF_VALIDATE={off,warn,strict}`` gates ``Pipeline.run()`` (default
  ``warn``), and ``BF_LINT=1`` makes ``run()`` validate and return.
- :mod:`bifrost_tpu_torch.analysis.ringcheck` -- the dynamic
  ring-protocol checker (``BF_RINGCHECK=1``).

Neither module imports the ring or the pipeline at import time: the
runtime imports the checker, and the verifier imports the runtime when
it runs.
"""

__all__ = ['ringcheck', 'verify']
