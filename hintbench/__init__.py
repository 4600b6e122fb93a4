"""The benchmark of hint_tpu_torch (see run.py)."""
