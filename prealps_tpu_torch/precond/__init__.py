"""The two-level block-Jacobi preconditioner."""
