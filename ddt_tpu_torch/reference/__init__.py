"""The NumPy oracle trainer (port of ddt_tpu/reference)."""
