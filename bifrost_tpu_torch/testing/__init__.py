"""Test-support utilities shipped with the package (importable from
production code paths, inert unless armed).

- :mod:`bifrost_tpu_torch.testing.faults`: deterministic fault injection
  at the ring and transfer seams, so tests can drive failure
  propagation and ring poisoning on the CPU and on the card.
"""

from . import faults  # noqa: F401

__all__ = ['faults']
