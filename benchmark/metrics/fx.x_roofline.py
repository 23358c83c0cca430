"""The X stage's share of its roofline: one gulp's fixed work
(roofline/fx_x.py) times the gulps of the traced sub-window, over the
summed device time of the X blocks' kernels (K7 and the accumulation)."""

NAME = 'fx.x_roofline'
KIND = 'per_layer'
UNIT = '%'
BETTER = 'higher'
SOURCE = 'device_trace'
LAYER = ('X stage: blocks/correlate.py -> ops/linalg.py XEngine (K7), '
         'blocks/accumulate.py')
MOVES = 'throughput_msps'


def read(ctx):
    return ctx.stage_roofline('fx_x')
