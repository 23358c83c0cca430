"""The port's tools, each ``python -m bifrost_tpu_torch.tools.<name>``:
the pipeline monitors over its ProcLog tree, ``like_top`` (top-style,
with the auto-tuner's knob panel and a ``--fleet`` view of the fleet
collector's rollup), ``like_ps`` (ps-style), ``like_bmon`` (capture,
transmit and bridge rates), ``like_pmap`` (ring memory map) and
``pipeline2dot`` (the block/ring graph as graphviz DOT); ``bf_console``
(a fleet collector with a live view), ``trace_merge`` (Chrome traces of
several hosts on one clock), ``telemetry_diff`` (regressions between two
snapshots), ``bf_lint`` (the static verifier over a pipeline script) and
``mprobe_report`` (the measured-probe winner caches); and the control
tiers' ``bf_serve``, ``bf_fabric`` and ``bf_sched``.  ``like_top``,
``like_ps`` and ``pipeline2dot`` are also the ``bf-torch-*`` console
scripts (:mod:`bifrost_tpu_torch.cli`)."""
