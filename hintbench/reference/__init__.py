"""The benchmark's plain reference: PyTorch alone, nothing of the measured
program."""
