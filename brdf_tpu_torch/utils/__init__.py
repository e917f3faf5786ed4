"""Run-time utilities of the port: checkpoints, event logs, spans and counters."""
