"""Lookup ops of the port and their hand-written CUDA kernels."""
