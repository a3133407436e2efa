"""Shared utilities: image grids (``images``), logs (``logging``); the
port's own copies of ``wcgan_tpu.utils``."""
