"""Plain PyTorch references of the benchmark's chains.  They import
nothing of the program and take nothing it made: the harness hands them
the same seeded inputs it fed the program."""
