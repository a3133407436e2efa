"""Numerics of the port: whitening, K1 moments, spectral norm, losses."""
