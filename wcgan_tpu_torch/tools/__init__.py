"""Checkpoint interop helpers (the port's own copies)."""
