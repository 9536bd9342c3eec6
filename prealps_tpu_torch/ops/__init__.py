"""Stencil formats, the stencil SpMM kernel and its plain versions, double-float
arithmetic and small dense block operations."""
