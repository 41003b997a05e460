"""Seeded host syncs: each root below (the roots table of
tests/test_torch_analyze.py) carries exactly one deliberate host read
of a device tensor. Scanned only by that test (EXCLUDE_PARTS keeps it
out of repo runs)."""
import time

import torch


def branches_on_tensor(x, n):
    if x.sum() > 0:                     # TRACE-BRANCH: waits for the sum
        return x + n
    return x - n


def coerces_tensor(x):
    return float(x.max()) * 2.0         # TRACE-COERCE: host read


def reads_item(x):
    return x * x.mean().item()          # TRACE-COERCE: .item()


def host_clock(x):
    t = time.time()                     # TRACE-HOSTCALL: wall clock
    return x + t


def waits_for_device(x):
    y = x * 2
    torch.cuda.synchronize()            # TRACE-HOSTCALL: device wait
    return y


def helper_reads(x):
    return x.tolist()                   # TRACE-COERCE, reached by a call


def calls_helper(x):
    return helper_reads(x + 1)
