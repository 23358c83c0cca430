"""Host-to-device bytes over the window (the port's xfer.h2d_bytes)."""

NAME = 'h2d.gbps'
KIND = 'per_layer'
UNIT = 'GB/s'
BETTER = 'higher'
SOURCE = 'program_counter'
LAYER = 'H2D: blocks/copy.py -> xfer.TransferEngine.to_device_direct'
MOVES = 'throughput_msps'


def read(ctx):
    return ctx.counter_delta('xfer.h2d_bytes') / \
        (ctx.t_close - ctx.t_open) / 1e9
