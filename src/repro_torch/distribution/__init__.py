"""Tensor-parallel distribution of the port (``repro.distribution``)."""
