"""Seconds from the start of the process to the output that opens the
window: imports, CUDA, the kernels' build or load, the pinned rings, the
seeded inputs and the warm-up gulps."""

NAME = 'setup_s'
KIND = 'end_to_end'
UNIT = 's'
BETTER = 'lower'
SOURCE = 'host_clock'


def read(ctx):
    return ctx.setup_s
