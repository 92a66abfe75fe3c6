"""Tensor ops of the port: VQ assignment (plain version and CUDA kernel) and
k-means."""
