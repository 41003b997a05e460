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

The SSD runs as plain torch ops, as the reference leaves it to XLA. Mixed
operand types follow JAX's promotion (bf16 activations against fp32
weights give fp32 results). ``_segsum_decay`` keeps the reference's order,
``where`` after ``exp``: above the diagonal ``exp`` may overflow to inf,
which the forward masks out but the backward turns into NaN (0 · inf),
in both packages alike.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

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
    s = cfg.ssm
    d = cfg.d_model
    di = s.d_inner(d)
    H = s.num_heads(d)
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


def ssm_init(gen: torch.Generator, cfg: ModelConfig, *, layers: int,
             device, out_scale: float) -> Dict:
    """Layer-stacked (layers, …) mixer params at the reference's scales:
    projections at 0.02 (out_proj at ``out_scale``), conv taps at
    1/sqrt(K), ``A_log = log(1..H)``, ``D = 1`` and ``dt_bias`` the
    inverse softplus of a log-uniform dt in [dt_min, dt_max] (the last
    three fp32 whatever the param type)."""
    dt = as_dtype(cfg.param_dtype)
    d, di, H, G, N, P, K, conv_dim = _dims(cfg)
    s = cfg.ssm
    f32 = torch.float32

    def normal(shape, scale):
        return (torch.randn((layers,) + shape, generator=gen, device=device,
                            dtype=f32) * scale).to(dt)

    u = torch.rand((layers, H), generator=gen, device=device, dtype=f32)
    dt0 = torch.exp(u * (math.log(s.dt_max) - math.log(s.dt_min))
                    + math.log(s.dt_min))
    return {
        "in_z": {"w": normal((d, di), 0.02)},
        "in_xbc": {"w": normal((d, conv_dim), 0.02)},
        "in_dt": {"w": normal((d, H), 0.02)},
        "conv_w": normal((K, conv_dim), 1.0 / math.sqrt(K)),
        "conv_b": torch.zeros((layers, conv_dim), dtype=dt, device=device),
        "A_log": torch.log(torch.arange(1, H + 1, dtype=f32, device=device)
                           ).expand(layers, H).clone(),
        "D": torch.ones((layers, H), dtype=f32, device=device),
        "dt_bias": dt0 + torch.log(-torch.expm1(-dt0)),
        "norm": torch.ones((layers, di), dtype=dt, device=device),
        "out_proj": {"w": normal((di, d), out_scale)},
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


def ssm_apply_full(p: Dict, cfg: ModelConfig, xin: torch.Tensor
                   ) -> Tuple[torch.Tensor, SSMCache]:
    """Train / prefill. xin (B, S, d) -> (y, final cache)."""
    d, di, H, G, N, P, K, conv_dim = _dims(cfg)
    Bsz, S, _ = xin.shape

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
    y = rmsnorm_apply({"scale": p["norm"]}, y * F.silu(z), eps=cfg.norm_eps)
    out = dense_apply(p["out_proj"], y)

    if S >= K - 1:
        conv_tail = xbc[:, S - (K - 1):]
    else:
        conv_tail = F.pad(xbc, (0, 0, K - 1, 0))[:, S:S + K - 1]
    return out, SSMCache(state=h_final, conv=conv_tail)


def ssm_apply_decode(p: Dict, cfg: ModelConfig, xin: torch.Tensor,
                     cache: SSMCache) -> Tuple[torch.Tensor, SSMCache]:
    """One token of the recurrence. xin (B, 1, d). Writes the new state
    and conv window into ``cache`` in place (the layer-stacked cache the
    decode walk holds views of) and returns it."""
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
    y = rmsnorm_apply({"scale": p["norm"]}, y * F.silu(z[:, None]),
                      eps=cfg.norm_eps)
    out = dense_apply(p["out_proj"], y)
    cache.state.copy_(state)
    cache.conv.copy_(window[:, 1:].to(cache.conv.dtype))
    return out, cache
