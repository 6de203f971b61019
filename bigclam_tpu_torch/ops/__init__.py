"""Objective, line search, the CUDA edge kernels and the host ops."""
