"""Pruning, packed containers and the load-time deployment of the port."""
