"""The harness of the benchmark: discovery of cells, configurations,
traffic and metrics by name, the capture-style source and the windowed
sink, the run, the trace reduction and the output check."""
