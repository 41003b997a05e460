"""Hand-written CUDA kernels of the port (``csrc/``), their builder and
their PyTorch wrappers."""
