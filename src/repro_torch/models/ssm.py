"""Mamba-2 (SSD, arXiv:2405.21060) of the port (``repro.models.ssm``).

Train / prefill run the chunked SSD algorithm: a loop over chunks of
``chunk_size`` carrying the (B, H, P, N) inter-chunk state; within a
chunk the quadratic form (Q x Q decay-masked C·Bᵀ). Decode is the O(1)
recurrence on the same state, written into the cache in place.

Layer: RMSNorm -> in_z / in_xbc / in_dt -> causal depthwise conv(K) on
xBC -> SiLU -> split x, B, C -> SSD -> gated RMSNorm(y · SiLU(z)) ->
out_proj. The recurrence has no per-token position mask, so a left-padded
prompt would corrupt the state: the engine prefills hybrid and SSM stacks
one request at a time.

Heads over 'model' (TP). A rank holds ``H / tp`` heads (its local config's
``ssm.head_shards``): its heads' columns of ``in_z``, ``in_dt`` and the
x part of ``in_xbc`` / ``conv_w`` / ``conv_b``, the whole B and C columns
(``ngroups`` is 1: every head reads them), its heads' ``dt_bias``,
``A_log``, ``D`` and ``norm`` entries and its rows of ``out_proj``. The
reference pins x to heads over 'model' and B / C replicated and leaves
the rest to GSPMD. The gated RMSNorm normalises over all ``d_inner``
channels: a rank sums its channels' squares in fp32, the sums are
all-reduced over 'model', and only then does it scale. ``out_proj``'s
partials are all-reduced in fp32. The caches hold the rank's heads and
channels: state (B, H/tp, P, N), conv (B, K-1, d_inner/tp + 2 G N). With
no mesh, ``cfg.tp_shards`` runs every head shard in turn with the same
shapes and sums in shard order (``ssm_shard``), its caches in the whole
layout, so that a mesh rank equals the loop.

Training on a mesh (``train.train_step.mesh_layout``) holds in_xbc,
conv_w and conv_b whole on every model rank and cuts them inside the
layer (``_TakeXBC``): the B / C columns are replicated compute that each
rank consumes with its own heads only, so their gradient on a rank is
its heads' share; the cut's backward all-reduces the leaf's gradient
over 'model', which gives every rank the whole gradient, while xin's
gradient, through ``copy_to_model``, counts the B / C path once. The
gated norm's squares are summed by ``psum_ar``, whose backward is an
all-reduce too: each rank's ``rsqrt`` scales only its own channels.

The SSD runs as plain torch ops, as the reference leaves it to XLA. Mixed
operand types follow JAX's promotion (bf16 activations against fp32
weights give fp32 results). ``_segsum_decay`` keeps the reference's order,
``where`` after ``exp``: above the diagonal ``exp`` may overflow to inf,
which the forward masks out but the backward turns into NaN (0 · inf),
in both packages alike.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.modules import as_dtype, dense_apply, rmsnorm_apply


class SSMCache(NamedTuple):
    """state (B, H, P, N) fp32; conv (B, K-1, conv_dim): the trailing
    inputs of the causal conv. Layer stacks add a leading layer axis."""

    state: torch.Tensor
    conv: torch.Tensor


def _dims(cfg: ModelConfig):
    """(d, d_inner, H, G, N, P, K, conv_dim) of this config's heads (a TP
    rank's local config holds 1 / head_shards of them)."""
    s = cfg.ssm
    d = cfg.d_model
    di = s.d_inner(d) // s.head_shards
    H = s.num_heads(d) // s.head_shards
    G, N, P, K = s.ngroups, s.state_dim, s.head_dim, s.conv_kernel
    conv_dim = di + 2 * G * N
    return d, di, H, G, N, P, K, conv_dim


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype, device) -> SSMCache:
    _, di, H, G, N, P, K, conv_dim = _dims(cfg)
    return SSMCache(
        state=torch.zeros((batch, H, P, N), dtype=torch.float32,
                          device=device),
        conv=torch.zeros((batch, K - 1, conv_dim), dtype=dtype,
                         device=device))


def ssm_init(gen: Optional[torch.Generator], cfg: ModelConfig, *,
             layers: int, device, out_scale: float, draw=None) -> Dict:
    """Layer-stacked (layers, …) mixer params at the reference's scales:
    projections at 0.02 (out_proj at ``out_scale``), conv taps at
    1/sqrt(K), ``A_log = log(1..H)``, ``D = 1`` and ``dt_bias`` the
    inverse softplus of a log-uniform dt in [dt_min, dt_max] (the last
    three fp32 whatever the param type). With ``draw`` (``models.lm``'s
    per-layer draws) each layer of each drawn leaf comes from its own
    generator, else every stack whole from ``gen``."""
    dt = as_dtype(cfg.param_dtype)
    d, di, H, G, N, P, K, conv_dim = _dims(cfg)
    s = cfg.ssm
    f32 = torch.float32

    def normal(name, shape, scale):
        if draw is not None:
            return draw(name, shape, scale)
        return (torch.randn((layers,) + shape, generator=gen, device=device,
                            dtype=f32) * scale).to(dt)

    u = (draw.uniform("dt_bias", (H,)) if draw is not None else
         torch.rand((layers, H), generator=gen, device=device, dtype=f32))
    dt0 = torch.exp(u * (math.log(s.dt_max) - math.log(s.dt_min))
                    + math.log(s.dt_min))
    return {
        "in_z": {"w": normal("in_z", (d, di), 0.02)},
        "in_xbc": {"w": normal("in_xbc", (d, conv_dim), 0.02)},
        "in_dt": {"w": normal("in_dt", (d, H), 0.02)},
        "conv_w": normal("conv_w", (K, conv_dim), 1.0 / math.sqrt(K)),
        "conv_b": torch.zeros((layers, conv_dim), dtype=dt, device=device),
        "A_log": torch.log(torch.arange(1, H + 1, dtype=f32, device=device)
                           ).expand(layers, H).clone(),
        "D": torch.ones((layers, H), dtype=f32, device=device),
        "dt_bias": dt0 + torch.log(-torch.expm1(-dt0)),
        "norm": torch.ones((layers, di), dtype=dt, device=device),
        "out_proj": {"w": normal("out_proj", (di, d), out_scale)},
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0) at every x (``F.softplus``
    switches to x above its threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """xbc (B, S, C); w (K, C) depthwise causal. The K taps are summed in
    fp32 from zero, then the bias, as the reference orders them."""
    K = w.shape[0]
    S = xbc.shape[1]
    pad = F.pad(xbc, (0, 0, K - 1, 0))
    out = torch.zeros(xbc.shape, dtype=torch.float32, device=xbc.device)
    for i in range(K):
        out = out + pad[:, i:i + S].to(torch.float32) * \
            w[i].to(torch.float32)
    return (out + b.to(torch.float32)).to(xbc.dtype)


def _segsum_decay(a_cum: torch.Tensor) -> torch.Tensor:
    """a_cum (..., Q) inclusive cumsum of log-decay -> (..., Q, Q) with
    exp(cum[q] - cum[s]) for s <= q, else 0."""
    Q = a_cum.shape[-1]
    diff = a_cum[..., :, None] - a_cum[..., None, :]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                 device=a_cum.device))
    return torch.where(mask, torch.exp(diff), 0.0)


def ssd_chunked(x, dt, A, Bm, Cm, D, h0, chunk: int):
    """SSD scan. x (B, S, H, P); dt (B, S, H); A (H,) negative; Bm / Cm
    (B, S, G, N); D (H,); h0 (B, H, P, N). The chunk is the largest
    divisor of S up to ``chunk``. Returns (y (B, S, H, P) fp32, final
    state)."""
    f32 = torch.float32
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    Q = min(chunk, S)
    while S % Q:
        Q -= 1
    nc = S // Q

    xdt = x.to(f32) * dt.to(f32)[..., None]
    a = dt.to(f32) * A                                  # (B, S, H)

    def chunks(t):
        return t.reshape((Bsz, nc, Q) + tuple(t.shape[2:])).unbind(1)

    h = h0.to(f32)
    ys = []
    for xq, aq, bq, cq in zip(chunks(xdt), chunks(a), chunks(Bm.to(f32)),
                              chunks(Cm.to(f32))):
        cum = torch.cumsum(aq, dim=1)                   # (B, Q, H)
        # intra-chunk: quadratic within Q
        cb = torch.einsum("bqgn,bsgn->bgqs", cq, bq)     # (B, G, Q, Q)
        Lmat = _segsum_decay(cum.transpose(1, 2))       # (B, H, Q, Q)
        cb_h = cb.repeat_interleave(rep, dim=1)         # (B, H, Q, Q)
        y_intra = torch.einsum("bhqs,bshp->bqhp", cb_h * Lmat, xq)
        # inter-chunk: the carried state's contribution
        c_h = cq.repeat_interleave(rep, dim=2)          # (B, Q, H, N)
        decay_q = torch.exp(cum)
        y_inter = torch.einsum("bqhn,bhpn->bqhp", c_h * decay_q[..., None],
                               h)
        # state update
        decay_tail = torch.exp(cum[:, -1:, :] - cum)    # (B, Q, H)
        b_h = bq.repeat_interleave(rep, dim=2)
        s_new = torch.einsum("bqhp,bqhn->bhpn", xq * decay_tail[..., None],
                             b_h)
        h = h * torch.exp(cum[:, -1])[..., None, None] + s_new
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(Bsz, S, H, P)
    y = y + x.to(f32) * D[None, None, :, None]
    return y, h


def _full_core(p: Dict, cfg: ModelConfig, xin: torch.Tensor):
    """The layer up to the gated norm over this config's heads: (y (B,
    S, di) in x's type, z, the final cache)."""
    d, di, H, G, N, P, K, conv_dim = _dims(cfg)
    Bsz, S, _ = xin.shape
    p, xin = _rank_entry(p, cfg, xin)

    z = dense_apply(p["in_z"], xin)
    xbc = dense_apply(p["in_xbc"], xin)
    dt = dense_apply(p["in_dt"], xin)
    xbc_conv = F.silu(_causal_conv(xbc, p["conv_w"], p["conv_b"]))
    x, Bm, Cm = torch.split(xbc_conv, [di, G * N, G * N], dim=-1)
    x = x.reshape(Bsz, S, H, P)
    Bm = Bm.reshape(Bsz, S, G, N)
    Cm = Cm.reshape(Bsz, S, G, N)
    dt = softplus(dt.to(torch.float32) + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    h0 = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=xin.device)
    y, h_final = ssd_chunked(x, dt, A, Bm, Cm, p["D"], h0,
                             cfg.ssm.chunk_size)
    y = y.reshape(Bsz, S, di).to(xin.dtype)
    if S >= K - 1:
        conv_tail = xbc[:, S - (K - 1):]
    else:
        conv_tail = F.pad(xbc, (0, 0, K - 1, 0))[:, S:S + K - 1]
    return y, z, SSMCache(state=h_final, conv=conv_tail)


def ssm_apply_full(p: Dict, cfg: ModelConfig, xin: torch.Tensor
                   ) -> Tuple[torch.Tensor, SSMCache]:
    """Train / prefill. xin (B, S, d) -> (y, final cache): every head
    here, a rank's heads on a mesh, or every head shard in turn."""
    tp = head_shards(cfg)
    if tp > 1 and cfg.ssm.head_shards == 1:        # the shard loop
        shards = [ssm_shard(p, cfg, s, tp) for s in range(tp)]
        cores = [_full_core(ps, local_ssm(cfg, tp), xin) for ps in shards]
        out = _gated_out([(ps, y, z) for ps, (y, z, _) in
                          zip(shards, cores)], cfg)
        return out, _merge_caches([c for _, _, c in cores])
    y, z, cache = _full_core(p, cfg, xin)
    return _gated_out([(p, y, z)], cfg), cache


def _decode_core(p: Dict, cfg: ModelConfig, xin: torch.Tensor,
                 cache: SSMCache):
    """One token up to the gated norm over this config's heads: (y (B,
    1, di) in x's type, z (B, 1, di)); the new state and conv window are
    written into ``cache`` in place."""
    d, di, H, G, N, P, K, conv_dim = _dims(cfg)
    Bsz = xin.shape[0]
    f32 = torch.float32

    x0 = xin[:, 0]
    z = dense_apply(p["in_z"], x0)
    xbc = dense_apply(p["in_xbc"], x0)
    dt = dense_apply(p["in_dt"], x0)

    # the conv over [cached K-1 inputs, current]
    wdt = torch.promote_types(cache.conv.dtype, xbc.dtype)
    window = torch.cat([cache.conv.to(wdt), xbc[:, None, :].to(wdt)], dim=1)
    conv_out = torch.einsum("bkc,kc->bc", window.to(f32),
                            p["conv_w"].to(f32))
    xbc_conv = F.silu(conv_out + p["conv_b"].to(f32))
    x, Bm, Cm = torch.split(xbc_conv.to(xin.dtype), [di, G * N, G * N],
                            dim=-1)
    x = x.reshape(Bsz, H, P)
    rep = H // G

    dt1 = softplus(dt.to(f32) + p["dt_bias"])              # (B, H)
    A = -torch.exp(p["A_log"])
    decay = torch.exp(dt1 * A)
    b_h = Bm.reshape(Bsz, G, N).repeat_interleave(rep, dim=1).to(f32)
    c_h = Cm.reshape(Bsz, G, N).repeat_interleave(rep, dim=1).to(f32)
    xdt = x.to(f32) * dt1[..., None]                       # (B, H, P)

    state = cache.state * decay[..., None, None] + \
        torch.einsum("bhp,bhn->bhpn", xdt, b_h)
    y = torch.einsum("bhpn,bhn->bhp", state, c_h) + \
        x.to(f32) * p["D"][None, :, None]

    y = y.reshape(Bsz, 1, di).to(xin.dtype)
    cache.state.copy_(state)
    cache.conv.copy_(window[:, 1:].to(cache.conv.dtype))
    return y, z[:, None]


def ssm_apply_decode(p: Dict, cfg: ModelConfig, xin: torch.Tensor,
                     cache: SSMCache) -> Tuple[torch.Tensor, SSMCache]:
    """One token of the recurrence. xin (B, 1, d). Writes the new state
    and conv window into ``cache`` in place (the layer-stacked cache the
    decode walk holds views of) and returns it. The shard loop runs each
    head shard on its part of the whole cache and writes it back."""
    tp = head_shards(cfg)
    if tp > 1 and cfg.ssm.head_shards == 1:        # the shard loop
        di, gn = _dims(cfg)[1], _gn(cfg)
        H, dl = _dims(cfg)[2] // tp, di // tp
        scs = [SSMCache(state=cache.state[:, s * H:(s + 1) * H],
                        conv=xbc_shard(cache.conv, s, tp, di, gn))
               for s in range(tp)]
        parts = []
        for s, sc in enumerate(scs):
            ps = ssm_shard(p, cfg, s, tp)
            y, z = _decode_core(ps, local_ssm(cfg, tp), xin, sc)
            parts.append((ps, y, z))
        for s, sc in enumerate(scs):
            cache.conv[..., s * dl:(s + 1) * dl] = sc.conv[..., :dl]
        cache.conv[..., di:] = scs[0].conv[..., dl:]
        return _gated_out(parts, cfg), cache
    y, z = _decode_core(p, cfg, xin, cache)
    return _gated_out([(p, y, z)], cfg), cache


# ---------------------------------------------------------------------------
# Heads over 'model'
# ---------------------------------------------------------------------------


def head_shards(cfg: ModelConfig) -> int:
    """The head shards a layer runs in: a rank's config holds one of
    ``cfg.ssm.head_shards`` (the active mesh's 'model' axis); a TP
    deployment's whole config runs ``cfg.tp_shards`` in turn where the
    heads split; else 1."""
    if cfg.ssm.head_shards > 1:
        return cfg.ssm.head_shards
    from repro_torch.distribution import context as dctx
    if dctx.active_mesh() is not None or cfg.tp_shards <= 1:
        return 1
    return cfg.tp_shards if ssm_splits(cfg, cfg.tp_shards) else 1


def ssm_splits(cfg: ModelConfig, tp: int) -> bool:
    """Do the heads split over ``tp`` ranks (B and C whole on each:
    ``ngroups`` 1)?"""
    s = cfg.ssm
    return tp > 1 and s.num_heads(cfg.d_model) % tp == 0 and s.ngroups == 1


def local_ssm(cfg: ModelConfig, tp: int) -> ModelConfig:
    """``cfg`` holding one of ``tp`` head shards."""
    return dataclasses.replace(
        cfg, ssm=dataclasses.replace(cfg.ssm, head_shards=tp))


def _gn(cfg: ModelConfig) -> int:
    return cfg.ssm.ngroups * cfg.ssm.state_dim


def xbc_shard(t: torch.Tensor, s: int, tp: int, di: int, gn: int
              ) -> torch.Tensor:
    """Shard ``s`` of ``tp`` of a (…, di + 2 G N) leaf laid out [x | B |
    C] (``in_xbc``'s columns, ``conv_w``, ``conv_b``, the conv window):
    its heads' x channels and the whole B and C."""
    n = di // tp
    return torch.cat([t[..., s * n:(s + 1) * n], t[..., di:di + 2 * gn]],
                     dim=-1).contiguous()


class _TakeXBC(torch.autograd.Function):
    """A model rank's ``xbc_shard`` of a whole [x | B | C] leaf (training
    holds those leaves whole on every model rank). Backward: the rank's
    gradient put back at its columns (zeros elsewhere) and all-reduced
    over 'model' in fp32: every rank's x columns, and the B / C columns'
    partials (each rank's heads' share) summed, so the replicated leaf
    gets the same whole gradient on every rank."""
    @staticmethod
    def forward(ctx, t, mesh, di, gn):
        ctx.mesh, ctx.di, ctx.shape = mesh, di, t.shape
        return xbc_shard(t, mesh.model_rank, mesh.shape["model"], di, gn)

    @staticmethod
    def backward(ctx, g):
        mesh, di = ctx.mesh, ctx.di
        n = di // mesh.shape["model"]
        r = mesh.model_rank
        whole = g.new_zeros(ctx.shape, dtype=torch.float32)
        whole[..., r * n:(r + 1) * n] = g[..., :n]
        whole[..., di:] = g[..., n:]
        return mesh.allreduce(whole, "model").to(g.dtype), None, None, None


def _rank_entry(p: Dict, cfg: ModelConfig, xin: torch.Tensor):
    """On a mesh rank of ``cfg.ssm.head_shards`` heads: (the params with
    whole [x | B | C] leaves cut to the rank's by ``_TakeXBC``, xin
    through ``copy_to_model``: in_z, in_xbc and in_dt are column regions,
    so xin's gradient is the sum of the ranks', the B / C path counted
    once, as a partial on each rank). Leaves already cut (a serving
    rank's, ``distribution.sharding.local_params``) are used as they
    are: their B / C gradient would be partial, so autograd refuses
    them."""
    from repro_torch.distribution import context as dctx
    tp = cfg.ssm.head_shards
    mesh = dctx.active_mesh()
    if tp == 1 or mesh is None:
        return p, xin
    di, gn = _dims(cfg)[1] * tp, _gn(cfg)
    w = p["in_xbc"].get("w")          # an int8 serving path holds "qw"
    if w is not None and w.shape[-1] == di + 2 * gn:
        p = dict(p)
        p["in_xbc"] = {"w": _take_xbc(w, mesh, di, gn)}
        for k in ("conv_w", "conv_b"):
            p[k] = _take_xbc(p[k], mesh, di, gn)
    elif w is not None and torch.is_grad_enabled() and w.requires_grad:
        raise ValueError(
            "training an SSM on a mesh takes the whole in_xbc / conv_w / "
            "conv_b leaves on every model rank (train_step.mesh_layout), "
            "not a serving rank's cut: its B / C gradient is a partial")
    return p, mesh.copy_to_model(xin)


def _take_xbc(t: torch.Tensor, mesh, di: int, gn: int) -> torch.Tensor:
    if torch.is_grad_enabled() and t.requires_grad:
        return _TakeXBC.apply(t, mesh, di, gn)
    return xbc_shard(t, mesh.model_rank, mesh.shape["model"], di, gn)


def ssm_shard(p: Dict, cfg: ModelConfig, s: int, tp: int) -> Dict:
    """Head shard ``s`` of ``tp`` of a layer's mixer params, as a rank
    holds it (contiguous copies)."""
    from repro_torch.models.ffn import shard_of
    di, gn = cfg.ssm.d_inner(cfg.d_model), _gn(cfg)
    out = {}
    for k, v in p.items():
        if k in ("in_z", "in_dt"):
            out[k] = {"w": shard_of(v["w"], -1, s, tp)}
        elif k == "in_xbc":
            out[k] = {"w": xbc_shard(v["w"], s, tp, di, gn)}
        elif k in ("conv_w", "conv_b"):
            out[k] = xbc_shard(v, s, tp, di, gn)
        elif k in ("A_log", "D", "dt_bias", "norm"):
            out[k] = shard_of(v, -1, s, tp)
        elif k == "out_proj":
            out[k] = {"w": shard_of(v["w"], -2, s, tp)}
        else:
            out[k] = v
    return out


def _merge_caches(caches) -> SSMCache:
    """Head shards' caches in the whole layout: states by heads, conv
    windows [x_0 | x_1 | … | B C]."""
    gnw = caches[0].conv.shape[-1] - caches[0].state.shape[1] * \
        caches[0].state.shape[2]
    return SSMCache(
        state=torch.cat([c.state for c in caches], dim=1),
        conv=torch.cat([c.conv[..., :c.conv.shape[-1] - gnw]
                        for c in caches] + [caches[0].conv[..., -gnw:]],
                       dim=-1))


def _gated_out(parts, cfg: ModelConfig) -> torch.Tensor:
    """The gated RMSNorm over all d_inner channels, then ``out_proj``.
    ``parts``: (params, y, z) of each head shard here (one: every head,
    or a mesh rank's). A rank's squares and its ``out_proj`` partial are
    summed over 'model' in fp32; the loop sums its shards' in order."""
    eps = cfg.norm_eps
    if len(parts) == 1 and cfg.ssm.head_shards == 1:
        p, y, z = parts[0]
        y = rmsnorm_apply({"scale": p["norm"]}, y * F.silu(z), eps=eps)
        return dense_apply(p["out_proj"], y)
    from repro_torch.distribution import context as dctx
    from repro_torch.models.ffn import _sum_partials
    gs = [y * F.silu(z) for _, y, z in parts]
    ss = [torch.sum(torch.square(g.to(torch.float32)), dim=-1, keepdim=True)
          for g in gs]
    mesh = len(parts) == 1
    total = dctx.psum_ar(ss[0]) if mesh else _sum_partials(ss,
                                                          torch.float32)
    rs = torch.rsqrt(total / cfg.ssm.d_inner(cfg.d_model) + eps)
    outs = [dense_apply(p["out_proj"],
                        (g.to(torch.float32) * rs
                         * p["norm"].to(torch.float32)).to(g.dtype))
            for (p, _, _), g in zip(parts, gs)]
    if mesh:
        return dctx.psum(outs[0].to(torch.float32)).to(outs[0].dtype)
    return _sum_partials(outs, outs[0].dtype)
