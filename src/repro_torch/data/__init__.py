"""Synthetic data pipeline of the port (``repro.data``)."""
