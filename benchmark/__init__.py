"""The benchmark of bifrost_tpu_torch (see run.py)."""
