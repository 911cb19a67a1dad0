"""Utilities: weights and train states from the JAX package's trees, its
artifact's flat layout; upstream RDMNet checkpoints (``torch_convert``);
host SE(3) helpers and augmentation; numpy metrics."""
