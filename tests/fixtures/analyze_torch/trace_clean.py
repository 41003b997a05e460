"""Clean twin of trace_bad.py: the same shapes of logic written without
a host sync — branches on metadata, torch.where selects, static
arguments — must produce ZERO findings."""
import torch


def branches_on_shape(x, n):
    if x.shape[0] > 1:                  # shape is host metadata: fine
        return x + n
    return x - n


def selects_on_device(x):
    return torch.where(x > 0, x * 2.0, x)   # a device select: fine


def static_branch(x, flag):
    if flag:                            # flag is a static parameter
        return x * 2
    return x


def reads_metadata(x):
    if x.dim() == 2 and x.is_contiguous() and x.device.type == "cuda":
        return x.reshape(-1)
    return x


def container_default(p, x):
    packed = p.get("packed") or {}      # a dict's default, not a tensor
    if "w" in packed and packed["w"].shape[0] > 1:
        return x * 2
    return x
