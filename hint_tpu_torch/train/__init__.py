"""Checkpoints of the port (weights only; training waits for ROADMAP M5)."""
