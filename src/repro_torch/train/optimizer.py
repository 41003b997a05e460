"""AdamW with optionally int8-quantized moments (``repro.train.optimizer``).

(init, update) functions over the param tree, as in the reference:

* fp32 moments, or **int8 moments** (``quantized=True``): m and v are
  stored int8 with one fp32 scale per 256-wide block of the last axis
  (8-bit-Adam style). Moments are dequantized, updated in fp32 and
  requantized each step.
* the update clips by the global gradient norm, corrects the moments'
  bias, and decays weights decoupled from the gradient, on leaves of two
  or more dims only (pruned SASP tiles get zero gradient but still decay).

``adamw_update`` writes the new params and moments into the given
tensors (the reference's launcher donates them to its jitted step), and
returns them. The ZeRO sharding helpers of the reference wait for the
port's TP slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.pruning import iter_leaves

Params = Any
QBLOCK = 256


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    quantized: bool = False       # int8 moments


class QMoment(NamedTuple):
    q: torch.Tensor               # int8, param shape
    scale: torch.Tensor           # fp32, shape[:-1] + (ceil(last/QBLOCK),)


class AdamWState(NamedTuple):
    step: torch.Tensor            # int32 scalar
    m: Params
    v: Params


def _quantize_moment(x: torch.Tensor) -> QMoment:
    """fp32 -> int8 per 256-wide block of the last axis: scale =
    max(amax, 1e-20) / 127, q = round-half-even(x / scale)."""
    shape = tuple(x.shape)
    last = shape[-1] if shape else 1
    nb = -(-last // QBLOCK)
    xf = x.to(torch.float32).reshape(*shape[:-1], last)
    xf = torch.nn.functional.pad(xf, (0, nb * QBLOCK - last))
    xb = xf.reshape(*shape[:-1], nb, QBLOCK)
    amax = torch.amax(torch.abs(xb), dim=-1)
    # divided by a tensor: a scalar divisor is a product with its
    # reciprocal on CUDA, one rounding away from the reference's scale
    scale = torch.clamp(amax, min=1e-20) / amax.new_tensor(127.0)
    q = torch.clamp(torch.round(xb / scale[..., None]), -127, 127
                    ).to(torch.int8)
    q = q.reshape(*shape[:-1], nb * QBLOCK)[..., :last].reshape(shape)
    return QMoment(q=q, scale=scale)


def _dequantize_moment(m: QMoment, shape) -> torch.Tensor:
    shape = tuple(shape)
    if not shape:
        return m.q.to(torch.float32) * m.scale.reshape(())
    last = shape[-1]
    nb = m.scale.shape[-1]
    q = torch.nn.functional.pad(m.q.to(torch.float32),
                                (0, nb * QBLOCK - last))
    x = q.reshape(*shape[:-1], nb, QBLOCK) * m.scale[..., None]
    return x.reshape(*shape[:-1], nb * QBLOCK)[..., :last]


def tree_map(fn, tree, *rest):
    """``fn`` over the tensor leaves of ``tree`` and the nodes of ``rest``
    at the same places (dicts, tuples and lists; a moment leaf may be a
    ``QMoment``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(tree, *rest)


def adamw_init(params: Params, cfg: AdamWConfig) -> AdamWState:
    def zero_like(p):
        z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return _quantize_moment(z) if cfg.quantized else z

    step = torch.zeros((), dtype=torch.int32,
                       device=next(iter_leaves(params))[1].device)
    return AdamWState(step=step, m=tree_map(zero_like, params),
                      v=tree_map(zero_like, params))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf, leaves in the
    reference's order (sorted dict keys), summed in fp32."""
    total = None
    for _, x in iter_leaves(tree):
        s = torch.sum(torch.square(x.to(torch.float32)))
        total = s if total is None else total + s
    return torch.sqrt(total)


def adamw_update(grads: Params, state: AdamWState, params: Params,
                 cfg: AdamWConfig, lr_scale=1.0,
                 gnorm: Optional[torch.Tensor] = None
                 ) -> Tuple[Params, AdamWState]:
    """One AdamW step; ``lr_scale`` is a number or a 0-d fp32 tensor;
    ``gnorm`` is ``global_norm(grads)`` where the caller has it already.
    Params and moments are updated in place (and returned); ``grads`` are
    left as they are."""
    step = state.step + 1
    if gnorm is None:
        gnorm = global_norm(grads)
    dev = step.device

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    # divisions by tensors: ``float / tensor`` is a reciprocal times the
    # float in torch, one rounding more than the reference
    clip = (torch.clamp(f32(cfg.grad_clip) / torch.clamp(gnorm, min=1e-9),
                        max=1.0) if cfg.grad_clip else 1.0)
    stepf = step.to(torch.float32)
    b1c = 1.0 - torch.pow(f32(cfg.b1), stepf)
    b2c = 1.0 - torch.pow(f32(cfg.b2), stepf)
    lr = cfg.lr * f32(lr_scale)

    def upd(p, g, m, v):
        g = g.to(torch.float32) * clip
        mf = _dequantize_moment(m, p.shape) if cfg.quantized else m
        vf = _dequantize_moment(v, p.shape) if cfg.quantized else v
        mf = mf.mul_(cfg.b1).add_((1.0 - cfg.b1) * g)
        vf = vf.mul_(cfg.b2).add_(torch.square(g).mul_(1.0 - cfg.b2))
        delta = (mf / b1c).div_(torch.sqrt(vf / b2c).add_(cfg.eps))
        if cfg.weight_decay and p.ndim >= 2:
            delta = delta.add_(cfg.weight_decay * p.to(torch.float32))
        new_p = (p.to(torch.float32) - lr * delta).to(p.dtype)
        p.copy_(new_p)
        if cfg.quantized:
            for old, new in ((m, _quantize_moment(mf)),
                             (v, _quantize_moment(vf))):
                old.q.copy_(new.q)
                old.scale.copy_(new.scale)

    with torch.no_grad():
        tree_map(upd, params, grads, state.m, state.v)
    return params, AdamWState(step=step, m=state.m, v=state.v)
