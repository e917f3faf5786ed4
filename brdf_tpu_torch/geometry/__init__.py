"""Procedural meshes (host numpy)."""
