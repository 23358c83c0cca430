"""Share of the window the capture source spent blocked in the ring's
reserve, waiting for the H2D copy to release a slot (benchmark clock)."""

NAME = 'source.blocked_share'
KIND = 'per_layer'
UNIT = '%'
BETTER = 'lower'
SOURCE = 'host_clock'
LAYER = "source: the benchmark's capture source -> ring.py pinned cuda_host ring"
MOVES = 'throughput_msps'


def read(ctx):
    return ctx.window_share(ctx.source_reserves)
