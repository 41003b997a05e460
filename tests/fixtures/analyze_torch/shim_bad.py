"""Seeded shim violation: a torch.distributed collective called outside
distribution/context.py (SHIM-IMPORT)."""
import torch.distributed as dist


def sum_over_ranks(t):
    dist.all_reduce(t)
    return t
