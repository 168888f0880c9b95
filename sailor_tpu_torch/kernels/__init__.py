"""Shading, culling and post kernels with their plain PyTorch versions."""
