"""Data of the port (``repro.data`` in the reference): the deterministic
synthetic token pipeline."""
