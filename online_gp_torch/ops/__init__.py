"""Structured ops of the port: grid, interpolation, factorizations, root
and predictive-cache streams, and the CUDA kernel wrappers."""
