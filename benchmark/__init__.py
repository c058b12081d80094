"""The port's benchmark: data-driven cells over `BatchDecoder` (run.py)."""
