"""The port's pipeline monitors, over its ProcLog tree: ``like_top``
(top-style, with the auto-tuner's knob panel and a ``--fleet`` view of
the fleet collector's rollup), ``like_ps`` (ps-style) and
``pipeline2dot`` (the block/ring graph as graphviz DOT).  Run one with
``python -m bifrost_tpu_torch.tools.like_top`` or through the
``bf-torch-*`` console scripts (:mod:`bifrost_tpu_torch.cli`)."""
