"""Run-time utilities of the port (checkpoints)."""
