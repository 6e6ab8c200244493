"""Operators of the port: plain PyTorch math and the hand-written CUDA
kernels that replace the JAX package's Pallas kernels."""
