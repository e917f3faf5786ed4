"""The single-GPU fit program (init, fit, IRLS rounds)."""
