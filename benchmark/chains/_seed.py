"""Generators made from the run's seed: one per gulp slot, so that any
slot can be made again alone, on the device, in a few large calls."""

import numpy as np


def slot_seed(seed, slot):
    """A 63-bit generator seed for ``slot`` of a run seeded ``seed``
    (any non-negative integer, however large)."""
    ss = np.random.SeedSequence([int(seed), int(slot)])
    return int(ss.generate_state(1, np.uint64)[0]) & ((1 << 63) - 1)


def generator(seed, slot, device):
    import torch
    g = torch.Generator(device=device)
    g.manual_seed(slot_seed(seed, slot))
    return g
