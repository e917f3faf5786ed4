"""Light-rig geometry (host numpy)."""
