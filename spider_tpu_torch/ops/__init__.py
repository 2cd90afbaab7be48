"""Kernels and tensor functions of the PyTorch port."""
