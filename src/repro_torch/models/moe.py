"""Top-k MoE with capacity-bounded sort-based dispatch (``repro.models.moe``).

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

Experts under TP without EP (a DP = 1 mesh, a scheduler rank's TP group,
an engine replicated over 'data'): a rank holds its d_ff columns of every
expert's w1/w3 and its rows of w2 (the reference's ``expert_col`` /
``expert_row``), routes all of its tokens itself (the router is
replicated) and all-reduces its w2 partial over 'model' in fp32; the
shared experts go through the dense TP FFN. With no mesh, ``cfg.tp_shards``
runs the d_ff shards one after another and sums the partials in fp32 in
shard order (``models.ffn._sum_partials``), so the mesh equals its loop.
Expert parallelism (experts over 'data') is ``distribution.moe_ep``.
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


def moe_init(gen: Optional[torch.Generator], cfg: ModelConfig, *,
             layers: int, device, out_scale: float,
             d_ff: Optional[int] = None, draw=None,
             experts: Optional[Tuple[int, int]] = None) -> Dict:
    """Layer-stacked (layers, …) MoE params: an fp32 router (d, E) and
    (E, din, dout) expert stacks at 0.02 (w2 at ``out_scale``), plus the
    ``shared`` FFN (w2 at ``out_scale`` too) when the config has shared
    experts. With ``draw`` (``models.lm``'s per-layer draws) every layer
    of the router and the shared FFN, and every layer of each expert,
    comes from its own generator, and ``experts`` (lo, hi) draws only
    those experts (an expert-parallel rank's; (lo, lo): none); else
    every stack comes whole from ``gen``."""
    dt = as_dtype(cfg.param_dtype)
    d, f = cfg.d_model, d_ff or cfg.d_ff
    E = cfg.moe.num_experts
    shapes = {"w1": ((d, f), 0.02), "w2": ((f, d), out_scale)}
    if cfg.ffn_gated:
        shapes["w3"] = ((d, f), 0.02)
    if draw is None:
        def normal(shape, scale, dtype=dt):
            return (torch.randn((layers,) + shape, generator=gen,
                                device=device, dtype=torch.float32)
                    * scale).to(dtype)
        p = {"router": {"w": normal((d, E), 0.02, torch.float32)}}
        for n in ("w1", "w2", "w3"):
            if n in shapes:
                p[n] = {"w": normal((E,) + shapes[n][0], shapes[n][1])}
    else:
        lo, hi = experts or (0, E)
        p = {"router": {"w": draw("router", (d, E), 0.02,
                                  dtype=torch.float32)}}
        for n, (shape, scale) in shapes.items():
            w = torch.empty((layers, hi - lo) + shape, dtype=dt,
                            device=device)
            for e in range(lo, hi):
                w[:, e - lo] = draw(n, shape, scale, expert=e)
            p[n] = {"w": w}
    if cfg.moe.num_shared_experts:
        from repro_torch.models.ffn import ffn_init
        p["shared"] = ffn_init(gen, cfg, layers=layers, device=device,
                               out_scale=out_scale,
                               d_ff=f * cfg.moe.num_shared_experts,
                               draw=None if draw is None
                               else draw.under("shared"))
    return p


def expert_counts(flat_e: torch.Tensor, E: int) -> torch.Tensor:
    """Slots routed to each of the ``E`` experts (int64, (E,)):
    ``bincount(flat_e, minlength=E)`` with a shape that does not depend
    on the values, so that a fake-tensor trace (``launch/dryrun.py``)
    runs it; integer sums, so the counts are the same."""
    return torch.zeros(E, dtype=torch.int64, device=flat_e.device
                       ).scatter_add_(0, flat_e.to(torch.int64),
                                      torch.ones_like(flat_e,
                                                      dtype=torch.int64))


def route(p: Dict, cfg: ModelConfig, x2: torch.Tensor) -> Routing:
    """x2 (N, d) -> the routing decision."""
    return route_probs(p, cfg, x2)[0]


def route_probs(p: Dict, cfg: ModelConfig, x2: torch.Tensor):
    """x2 (N, d) -> (the routing decision, the router's fp32 probs (N,
    E))."""
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
    counts = expert_counts(flat_e, E)
    f_e = counts.to(torch.float32) / (N * k)
    P_e = probs.mean(dim=0)
    aux = E * torch.sum(f_e * P_e) * m.router_aux_weight

    sort_idx = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[sort_idx]
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(N * k, device=x2.device) - starts[sorted_e]
    return Routing(expert_idx, gate_w.to(x2.dtype), aux, sort_idx,
                   pos), probs


def _expert_mm(p: Dict, name: str, h: torch.Tensor) -> torch.Tensor:
    """h (E, C, din) @ the stacked expert weights (E, din, dout): the
    weights rounded to h's type, the products summed in fp32 (cuBLAS
    accumulates bf16 products in fp32), the result in h's type."""
    w = p[name]["w"]
    masks = p.get("sasp_masks")
    if masks is not None and name in masks:
        w = apply_block_mask(w, masks[name])
    return torch.bmm(h, w.to(h.dtype))


def experts_apply(p: Dict, cfg: ModelConfig, buf: torch.Tensor
                  ) -> torch.Tensor:
    """buf (E', C, d) through the expert stacks ``p`` holds (E' experts,
    their d_ff or a shard of it): ``act(buf @ w1) * (buf @ w3) @ w2``,
    the whole product or a d_ff shard's partial."""
    act = act_fn(cfg.act)
    h = _expert_mm(p, "w1", buf)
    if cfg.ffn_gated:
        h = act(h) * _expert_mm(p, "w3", buf)
    else:
        h = act(h)
    return _expert_mm(p, "w2", h)


def expert_shard(p: Dict, e0: int, e1: int, s: int, tp: int) -> Dict:
    """Experts [e0, e1) of the stacks, d_ff shard ``s`` of ``tp``, as a
    mesh rank holds them: w1/w3 columns, w2 rows, their block masks
    alike (contiguous copies)."""
    from repro_torch.models.ffn import shard_of
    dims = {"w1": -1, "w3": -1, "w2": -2}
    out: Dict = {n: {"w": shard_of(p[n]["w"][e0:e1], dims[n], s, tp)}
                 for n in dims if n in p}
    masks = p.get("sasp_masks")
    if masks is not None:
        out["sasp_masks"] = {n: shard_of(m[e0:e1], dims[n], s, tp)
                             for n, m in masks.items() if n in dims}
    return out


def experts_tp(p: Dict, cfg: ModelConfig, buf: torch.Tensor
               ) -> torch.Tensor:
    """``experts_apply`` over the d_ff shards of a TP deployment: on a
    mesh whose 'model' axis splits d_ff, this rank's partial all-reduced
    in fp32 (``buf`` enters the rank's columns through ``copy_to_model``:
    under autograd its gradient is the sum of the ranks' partials); with no mesh, ``cfg.tp_shards`` partials summed in fp32 in
    shard order; else the whole product."""
    from repro_torch.distribution import context as dctx
    from repro_torch.models.ffn import _sum_partials, tp_shards
    tp = tp_shards(cfg)
    if tp <= 1:
        return experts_apply(p, cfg, buf)
    if dctx.active_mesh() is not None:
        part = experts_apply(p, cfg, dctx.copy_to_model(buf))
        return dctx.psum(part.to(torch.float32)).to(part.dtype)
    E = buf.shape[0]
    return _sum_partials([experts_apply(expert_shard(p, 0, E, s, tp), cfg,
                                        buf) for s in range(tp)], buf.dtype)


def shared_apply(p: Dict, cfg: ModelConfig, x2: torch.Tensor
                 ) -> torch.Tensor:
    """The shared experts, a dense FFN of ``num_shared_experts`` d_ff
    (TP like the dense FFN)."""
    from repro_torch.models.ffn import ffn_apply
    return ffn_apply(p["shared"], cfg, x2,
                     d_ff=cfg.d_ff * cfg.moe.num_shared_experts)


def moe_ffn_local(p: Dict, cfg: ModelConfig, x: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (…, d) -> (y, aux_loss): every token routed here, the experts'
    products whole or over the d_ff shards of a TP deployment
    (``experts_tp``)."""
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

    out = experts_tp(p, cfg, buf)                             # (E, C, d)

    # combine: expert rows back to the (N*k) slots, weighted and summed
    out_pad = torch.cat([out, out.new_zeros((E, 1, d))], dim=1)
    y_slots = out_pad[sorted_e, pos_c]                        # sorted order
    inv = torch.argsort(r.sort_idx, stable=True)
    y_flat = y_slots[inv].reshape(N, k, d)
    y = torch.sum(y_flat * r.gate_w[..., None].to(y_flat.dtype), dim=1)

    if "shared" in p:
        y = y + shared_apply(p, cfg, x2)
    return y.reshape(*lead, d).to(x.dtype), r.aux_loss
