"""Clean twin of shim_bad.py: the collective reached through the
context's Mesh — zero findings."""
from repro_torch.distribution import context as dctx


def sum_over_ranks(t):
    return dctx.psum(t)
