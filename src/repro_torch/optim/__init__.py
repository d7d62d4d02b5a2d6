"""Optimizers of the port (``repro.optim`` in the reference): AdamW and
the single-device half of int8 error-feedback gradient compression."""
