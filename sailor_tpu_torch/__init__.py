"""Sailor renderer ported to PyTorch and CUDA for NVIDIA Hopper.

The JAX package ``sailor_tpu`` beside it is the reference; this package
imports nothing of it. Entry points run on the CUDA device unless the
caller passes ``device="cpu"``, where every kernel takes its plain PyTorch
version. See README.md ("PyTorch/CUDA port").
"""
