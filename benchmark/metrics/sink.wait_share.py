"""Share of the window the sink spent waiting for its next output (the
acquire, which completes the output's D2H), benchmark clock."""

NAME = 'sink.wait_share'
KIND = 'per_layer'
UNIT = '%'
BETTER = 'higher'
SOURCE = 'host_clock'
LAYER = "sink: the benchmark's windowed sink"
MOVES = 'throughput_msps'


def read(ctx):
    return ctx.window_share(ctx.sink_waits)
