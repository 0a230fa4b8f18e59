"""Kernels and layer ops of the port."""
