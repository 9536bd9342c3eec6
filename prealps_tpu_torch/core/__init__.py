"""Host-side problem generators, scaling and row layouts (numpy/scipy)."""
