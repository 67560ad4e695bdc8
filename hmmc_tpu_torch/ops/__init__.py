"""Tensor ops of the port: attention (plain and fused), image
preprocessing, and the build of the CUDA kernels."""
