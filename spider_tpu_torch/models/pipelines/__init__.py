"""Diffusion pipelines of the PyTorch port."""
