"""Utilities: weight conversion to and from the JAX package's parameter tree
and its artifact's flat layout; host SE(3) helpers."""
