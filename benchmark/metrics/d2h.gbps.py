"""Device-to-host bytes over the window (the port's xfer.d2h_bytes)."""

NAME = 'd2h.gbps'
KIND = 'per_layer'
UNIT = 'GB/s'
BETTER = 'higher'
SOURCE = 'program_counter'
LAYER = 'D2H: blocks/copy.py -> xfer.TransferEngine.host_fill'
MOVES = 'throughput_msps'


def read(ctx):
    return ctx.counter_delta('xfer.d2h_bytes') / \
        (ctx.t_close - ctx.t_open) / 1e9
