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

SPACES = ('system', 'cuda_host', 'cuda')

_ALIASES = {
    'cuda_managed': 'cuda',
    'pinned': 'cuda_host',
}

_HOST = ('system', 'cuda_host')


def canonical(space):
    """The canonical space string for ``space`` (aliases resolved);
    raises ValueError on an unknown name."""
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
