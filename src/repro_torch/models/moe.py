"""Top-k MoE with capacity-bounded sort-based dispatch (``repro.models.moe``),
single device.

Tokens are routed with a stable sort by expert id, gathered into a
capacity-padded (E, C, d) buffer, pushed through batched expert products
and combined with their gate weights. Overflow tokens are dropped (GShard
capacity); the residual stream carries them unchanged. Routing, dispatch
and the expert products are plain torch ops, as the reference leaves
them to XLA.

Ties follow the reference: ``jax.lax.top_k`` puts the lower expert first
among equal probabilities, which a stable descending sort reproduces
(``torch.topk`` promises no order). Dropped slots all write the scratch
row C of their expert, which is cut off; no kept slot shares an index.

SASP: expert weights are (E, din, dout) stacks; ``sasp_masks`` with a
leading E axis apply through ``apply_block_mask``. Packed deployment
leaves the expert grids masked-dense, as the reference does.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.pruning import apply_block_mask
from repro_torch.models.modules import act_fn, as_dtype


class Routing(NamedTuple):
    expert_idx: torch.Tensor     # (N, k) int64
    gate_w: torch.Tensor         # (N, k) normalised top-k gates
    aux_loss: torch.Tensor       # scalar load-balance loss
    sort_idx: torch.Tensor       # (N*k,) slots stably sorted by expert
    pos_in_expert: torch.Tensor  # (N*k,) position within expert, sorted


def moe_init(gen: torch.Generator, cfg: ModelConfig, *, layers: int,
             device, out_scale: float, d_ff: Optional[int] = None) -> Dict:
    """Layer-stacked (layers, …) MoE params: an fp32 router (d, E) and
    (E, din, dout) expert stacks at 0.02 (w2 at ``out_scale``), plus the
    ``shared`` FFN (w2 at ``out_scale`` too) when the config has shared
    experts."""
    dt = as_dtype(cfg.param_dtype)
    d, f = cfg.d_model, d_ff or cfg.d_ff
    E = cfg.moe.num_experts

    def normal(shape, scale, dtype=dt):
        return (torch.randn((layers,) + shape, generator=gen, device=device,
                            dtype=torch.float32) * scale).to(dtype)

    p = {"router": {"w": normal((d, E), 0.02, torch.float32)},
         "w1": {"w": normal((E, d, f), 0.02)},
         "w2": {"w": normal((E, f, d), out_scale)}}
    if cfg.ffn_gated:
        p["w3"] = {"w": normal((E, d, f), 0.02)}
    if cfg.moe.num_shared_experts:
        from repro_torch.models.ffn import ffn_init
        p["shared"] = ffn_init(gen, cfg, layers=layers, device=device,
                               out_scale=out_scale,
                               d_ff=f * cfg.moe.num_shared_experts)
    return p


def route(p: Dict, cfg: ModelConfig, x2: torch.Tensor) -> Routing:
    """x2 (N, d) -> the routing decision."""
    m = cfg.moe
    E, k = m.num_experts, m.top_k
    N = x2.shape[0]
    logits = torch.matmul(x2.to(torch.float32), p["router"]["w"])
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_w, expert_idx = vals[:, :k], idx[:, :k]
    gate_w = gate_w / torch.clamp(gate_w.sum(-1, keepdim=True), min=1e-9)

    # GShard aux loss: E * sum_e f_e * P_e
    flat_e = expert_idx.reshape(-1)
    counts = torch.bincount(flat_e, minlength=E)
    f_e = counts.to(torch.float32) / (N * k)
    P_e = probs.mean(dim=0)
    aux = E * torch.sum(f_e * P_e) * m.router_aux_weight

    sort_idx = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[sort_idx]
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(N * k, device=x2.device) - starts[sorted_e]
    return Routing(expert_idx, gate_w.to(x2.dtype), aux, sort_idx, pos)


def _expert_mm(p: Dict, name: str, h: torch.Tensor) -> torch.Tensor:
    """h (E, C, din) @ the stacked expert weights (E, din, dout): the
    weights rounded to h's type, the products summed in fp32 (cuBLAS
    accumulates bf16 products in fp32), the result in h's type."""
    w = p[name]["w"]
    masks = p.get("sasp_masks")
    if masks is not None and name in masks:
        w = apply_block_mask(w, masks[name])
    return torch.bmm(h, w.to(h.dtype))


def moe_ffn_local(p: Dict, cfg: ModelConfig, x: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (…, d) -> (y, aux_loss)."""
    *lead, d = x.shape
    x2 = x.reshape(-1, d)
    N = x2.shape[0]
    m = cfg.moe
    E, k = m.num_experts, m.top_k
    C = max(1, int(-(-N * k * m.capacity_factor // E)))      # ceil

    r = route(p, cfg, x2)
    token_of_slot = r.sort_idx // k
    sorted_e = r.expert_idx.reshape(-1)[r.sort_idx]
    # dropped slots write the scratch row C, which is cut off
    pos_c = torch.clamp(r.pos_in_expert, max=C)

    buf = torch.zeros((E, C + 1, d), dtype=x2.dtype, device=x2.device)
    buf = buf.index_put((sorted_e, pos_c), x2[token_of_slot])[:, :C]

    act = act_fn(cfg.act)
    h = _expert_mm(p, "w1", buf)
    if cfg.ffn_gated:
        h = act(h) * _expert_mm(p, "w3", buf)
    else:
        h = act(h)
    out = _expert_mm(p, "w2", h)                              # (E, C, d)

    # combine: expert rows back to the (N*k) slots, weighted and summed
    out_pad = torch.cat([out, out.new_zeros((E, 1, d))], dim=1)
    y_slots = out_pad[sorted_e, pos_c]                        # sorted order
    inv = torch.argsort(r.sort_idx, stable=True)
    y_flat = y_slots[inv].reshape(N, k, d)
    y = torch.sum(y_flat * r.gate_w[..., None].to(y_flat.dtype), dim=1)

    if "shared" in p:
        from repro_torch.models.ffn import ffn_apply
        y = y + ffn_apply(p["shared"], cfg, x2)
    return y.reshape(*lead, d).to(x.dtype), r.aux_loss
