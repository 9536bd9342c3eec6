"""The DistributedECG driver (one GPU)."""
