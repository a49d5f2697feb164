"""Histogram ops and the hand-written CUDA histogram kernels."""
