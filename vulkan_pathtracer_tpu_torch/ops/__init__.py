"""Device math: RNG, BRDF, intersection, traversal (PyTorch + CUDA)."""
