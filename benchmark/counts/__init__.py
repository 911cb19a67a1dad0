"""Frozen arithmetic of the benchmark: the card's peaks, the kernels' bounds
and the model's FLOPs."""
