"""Device block-Jacobi assembly, inversion and apply."""
