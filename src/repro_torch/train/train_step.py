"""Train-step factory of the port (``repro.train.train_step``): loss ->
grad -> AdamW, aware of the SASP overlay.

The overlay (SASP masks) is closed over and merged into a view of the
params inside the loss, so the masks apply straight through: gradients
reach the surviving tiles only. The step updates params and moments in
place and returns them (the reference's launcher donates both to its
jitted step).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.pruning import iter_leaves, map_leaves
from repro_torch.core.sasp import merge_overlay
from repro_torch.models import lm
from repro_torch.train.optimizer import (
    AdamWConfig,
    AdamWState,
    adamw_init,
    adamw_update,
    global_norm,
)


def value_and_grad(cfg: ModelConfig, params, batch: Dict,
                   overlay: Optional[Any] = None):
    """(loss, metrics, grads) of ``lm.loss_fn`` on the params viewed
    through ``overlay``; ``grads`` has the params' structure (zeros where
    a leaf is unused, as jax gives)."""
    flat = dict(iter_leaves(params))
    with torch.enable_grad():
        live = {k: p.detach().requires_grad_(True) for k, p in flat.items()}
        p = map_leaves(lambda path, _: live[path], params)
        pv = merge_overlay(p, overlay) if overlay is not None else p
        loss, metrics = lm.loss_fn(pv, cfg, batch)
        gs = torch.autograd.grad(loss, list(live.values()),
                                 allow_unused=True)
    grads = {k: torch.zeros_like(flat[k]) if g is None else g
             for k, g in zip(live, gs)}
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            map_leaves(lambda path, _: grads[path], params))


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    overlay: Optional[Any] = None,
                    lr_schedule: Optional[Callable] = None,
                    n_microbatches: int = 1,
                    accum_dtype=None):
    """Returns step(params, opt_state, batch) -> (params, opt_state,
    metrics {"ce", "aux", "loss", "grad_norm"}, 0-d tensors).

    ``n_microbatches > 1``: gradient accumulation over batch slices
    (rows [k B/K, (k+1) B/K) form micro-batch k), in ``accum_dtype``
    (default fp32); the activations held shrink by K at the cost of K
    sequential passes."""

    def step(params, opt_state: AdamWState, batch: Dict):
        if n_microbatches <= 1:
            loss, metrics, grads = value_and_grad(cfg, params, batch,
                                                  overlay)
        else:
            K = n_microbatches
            adt = accum_dtype or torch.float32
            grads = map_leaves(lambda _, p: torch.zeros(
                p.shape, dtype=adt, device=p.device), params)
            flat_acc = dict(iter_leaves(grads))
            loss = torch.zeros((), dtype=torch.float32,
                               device=opt_state.step.device)
            ms = []
            for k in range(K):
                mb = {n: v.reshape(K, v.shape[0] // K, *v.shape[1:])[k]
                      for n, v in batch.items()}
                lk, mk, gk = value_and_grad(cfg, params, mb, overlay)
                for path, g in iter_leaves(gk):
                    flat_acc[path].add_(g.to(adt))
                loss = loss + lk
                ms.append(mk)
            for g in flat_acc.values():
                g.div_(K)
            loss = loss / K
            metrics = {n: torch.stack([m[n] for m in ms]).mean()
                       for n in ms[0]}

        lr_scale = lr_schedule(opt_state.step) if lr_schedule else 1.0
        gnorm = global_norm(grads)
        new_params, new_opt = adamw_update(grads, opt_state, params,
                                           opt_cfg, lr_scale=lr_scale,
                                           gnorm=gnorm)
        out = dict(metrics)
        out["loss"] = loss
        out["grad_norm"] = gnorm
        return new_params, new_opt, out

    return step


def make_eval_step(cfg: ModelConfig, overlay: Optional[Any] = None):
    def step(params, batch):
        pv = merge_overlay(params, overlay) if overlay is not None \
            else params
        with torch.no_grad():
            loss, metrics = lm.loss_fn(pv, cfg, batch)
        return {**metrics, "loss": loss}

    return step


def init_train_state(cfg: ModelConfig, opt_cfg: AdamWConfig, *,
                     seed: int = 0, device="cuda"):
    params = lm.init_params(cfg, seed=seed, device=device)
    return params, adamw_init(params, opt_cfg)
