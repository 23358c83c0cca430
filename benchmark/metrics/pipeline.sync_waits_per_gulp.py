"""Run-ahead drain waits per gulp over the window: the port's
pipeline.sync_waits over pipeline.gulps."""

NAME = 'pipeline.sync_waits_per_gulp'
KIND = 'per_layer'
UNIT = 'waits/gulp'
BETTER = 'lower'
SOURCE = 'program_counter'
LAYER = 'runtime: pipeline.py, ring.py'
MOVES = 'throughput_msps'


def read(ctx):
    gulps = ctx.counter_delta('pipeline.gulps')
    if gulps <= 0:
        return None
    return ctx.counter_delta('pipeline.sync_waits') / gulps
