"""Memory spaces of the PyTorch/CUDA port.

The reference framework names its spaces {system, cuda, cuda_host,
cuda_managed} (reference: src/memory.cpp:94-162, python/bifrost/Space.py).
The port keeps three of them:

- ``system``    : ordinary host memory (numpy-backed)
- ``cuda_host`` : page-locked host memory, the staging space for fast
                  asynchronous copies (numpy view of a pinned torch buffer
                  when the port runs on a card)
- ``cuda``      : device memory, held as ``torch.Tensor`` on the port's
                  device (:func:`bifrost_tpu_torch.device.get_device`)

``cuda_managed`` is accepted as an alias of ``cuda`` and ``pinned`` of
``cuda_host``.
"""

from __future__ import annotations

__all__ = ['Space', 'SPACES', 'canonical', 'space_accessible']

SPACES = ('system', 'cuda_host', 'cuda')

_ALIASES = {
    'cuda_managed': 'cuda',
    'pinned': 'cuda_host',
}

_HOST = ('system', 'cuda_host')


class Space(object):
    """Validated memory-space tag (reference:
    python/bifrost/Space.py:27-46; ``bifrost_tpu/space.py:31``), over the
    port's spaces and aliases."""

    def __init__(self, s):
        if isinstance(s, Space):
            s = s._space
        self._space = canonical(s)

    def as_string(self):
        return self._space

    def __str__(self):
        return self._space

    def __repr__(self):
        return "Space(%r)" % self._space

    def __eq__(self, other):
        return str(self) == str(Space(other))

    def __ne__(self, other):
        return not self == other

    def __hash__(self):
        return hash(self._space)

    @property
    def is_device(self):
        return self._space == 'cuda'

    @property
    def is_host(self):
        return self._space in _HOST


def canonical(space):
    """The canonical space string for ``space`` (aliases resolved);
    raises ValueError on an unknown name."""
    if isinstance(space, Space):
        return space._space
    s = _ALIASES.get(str(space), str(space))
    if s not in SPACES:
        raise ValueError("Invalid space: %r (valid: %s)"
                         % (space, list(SPACES)))
    return s


def space_accessible(space, from_spaces):
    """True if memory in ``space`` is directly accessible from any of
    ``from_spaces`` (reference: python/bifrost/memory.py:37-48): host
    spaces are mutually accessible, device memory only from 'cuda'."""
    if isinstance(from_spaces, str):
        from_spaces = [from_spaces]
    if 'any' in from_spaces:
        return True
    space = canonical(space)
    from_spaces = [canonical(s) for s in from_spaces]
    if space in from_spaces:
        return True
    if space in _HOST:
        return any(f in _HOST for f in from_spaces)
    return False
