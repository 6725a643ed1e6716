"""Resize operators and the hand-written CUDA kernels."""
