"""Ghost layers (the single-device halo)."""
