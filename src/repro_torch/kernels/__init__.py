"""Kernels of the port: hand-written CUDA (``csrc/``) behind ``ops``."""
