"""Fixtures, timing, device helpers and conversion from the JAX package."""
