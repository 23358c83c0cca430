"""Share of the traced sub-window with neither a kernel nor a copy on
the card."""

NAME = 'device.idle_share'
KIND = 'per_layer'
UNIT = '%'
BETTER = 'lower'
SOURCE = 'device_trace'
LAYER = 'device'
MOVES = 'throughput_msps'


def read(ctx):
    if ctx.trace is None:
        return None
    return 100.0 * (1.0 - ctx.trace['busy_s'] / ctx.trace['window_s'])
