"""Joint multi-scene bundle adjustment (one device; the process group comes later)."""
