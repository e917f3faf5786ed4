"""Shading models: angle channels, the ten lobes and the MODELS registry."""
