"""Operators of the PyTorch port: attention ops and their CUDA kernels."""
