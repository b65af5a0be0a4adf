"""Utilities: weight import from the JAX package's Flax params."""
