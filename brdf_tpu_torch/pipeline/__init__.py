"""The per-texel fit driver."""
