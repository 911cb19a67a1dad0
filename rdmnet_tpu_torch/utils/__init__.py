"""Utilities: weight conversion from the JAX package's parameter tree."""
