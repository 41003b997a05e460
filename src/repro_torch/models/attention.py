"""Attention of the port: GQA + RoPE + optional qk-norm / QKV bias /
sliding window, with a ring-buffer KV cache (``repro.models.attention``).

The reference computes attention in jnp (not Pallas), so it stays plain
torch here. Masked scores are ``NEG_INF = -1e30``; a key is visible iff
``0 <= q_pos - kv_pos < window`` and ``kv_pos >= 0`` (left-pad columns
and empty ring slots carry -1). Decode updates the cache in place.

On a mesh each rank runs attention over its own heads: its config
(``distribution.sharding.local_config``) holds ``num_heads / tp`` query
and ``num_kv_heads / tp`` KV heads, and so do its caches. Where the head
counts do not divide 'model' (``heads_replicated``), every rank holds
and runs every head, as the reference pins SDPA replicated over 'model':
q / k / v are all-gathered after the split projections, and wo's row
shard takes the rank's slice of the core's output. The shard
loop (no mesh; packed attention holding every TP shard, or dense
projections of a TP deployment, ``cfg.tp_shards``) runs the projections
and the attention core shard by shard over each shard's heads, the calls
a rank makes: the batched fp32 score and value products give other bits
for half the KV heads than for the same heads inside the whole call.

Under the sequence-parallel layout (``cfg.seq_*``; a ``RingCut`` from
``distribution.sharding.ring_cut``) a ring's capacity is cut into blocks
of contiguous slots: a mesh rank holds one (its int8 scales with it),
writes only the entries whose slots fall in it, and decode and the
suffix prefill combine their softmax over the blocks (the blocks' max
all-reduced, their fp32 sums gathered and added in rank order); the
meshless twin holds the whole ring and runs every block in turn. A ring
that is not cut keeps the plain softmax.

The int8 cache (``cfg.kv_quant``) stores k / v as int8 with one fp32
scale per (slot, head); reads dequantize. The paged pool's primitives
(``gather_kv_pages`` …) assemble ring caches from (R, P, L, …) page
leaves through block tables and write pages back.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.modules import (
    apply_rope,
    dense_apply,
    matmul,
    qknorm_apply,
    softcap,
)

NEG_INF = -1.0e30
Q_CHUNK = 512          # query rows per score block in attend_chunked


class KVCache(NamedTuple):
    """k, v: (B, C, KH, D); pos: (B, C) absolute position per ring slot,
    -1 if empty; kscale / vscale: (B, C, KH) fp32 scales of the int8
    cache, else None. Layer stacks add a leading layer axis."""

    k: torch.Tensor
    v: torch.Tensor
    pos: torch.Tensor
    kscale: Optional[torch.Tensor] = None
    vscale: Optional[torch.Tensor] = None


class RingCut(NamedTuple):
    """A ring's capacity cut into ``n`` blocks of ``capacity // n``
    contiguous slots over the mesh ``axes`` (the sequence-parallel
    layout, ``distribution.sharding.ring_cut``): a rank holds block
    ``index`` (slots ``[index c, (index + 1) c)``); ``index`` None is the
    meshless twin, which holds the whole ring and runs every block."""
    capacity: int
    n: int
    index: Optional[int]
    axes: Tuple[str, ...]

    @property
    def block(self) -> int:
        return self.capacity // self.n

    @property
    def local(self) -> bool:
        """Does this process hold one block only (a mesh rank)?"""
        return self.index is not None


def cache_map(fn, cache):
    """``fn`` over every present leaf of a cache (None stays None); the
    result has the cache's type (``KVCache`` or the SSM's ``SSMCache``)."""
    return type(cache)(*(None if a is None else fn(a) for a in cache))


def init_kv_cache(batch: int, capacity: int, num_kv_heads: int,
                  head_dim: int, dtype, device, quant: bool = False
                  ) -> KVCache:
    shape = (batch, capacity, num_kv_heads, head_dim)
    pos = torch.full((batch, capacity), -1, dtype=torch.int32,
                     device=device)
    if quant:
        return KVCache(
            k=torch.zeros(shape, dtype=torch.int8, device=device),
            v=torch.zeros(shape, dtype=torch.int8, device=device),
            pos=pos,
            kscale=torch.zeros(shape[:3], dtype=torch.float32,
                               device=device),
            vscale=torch.zeros(shape[:3], dtype=torch.float32,
                               device=device))
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        pos=pos)


def _quant_heads(x: torch.Tensor):
    """x (..., KH, D) -> int8 values and one scale per head (...). The
    fp32 division by the scale (not a product with its reciprocal) and
    round-half-to-even give the reference's bytes."""
    xf = x.to(torch.float32)
    amax = torch.amax(torch.abs(xf), dim=-1)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127
                    ).to(torch.int8)
    return q, scale


def _dequant(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    return (q.to(torch.float32) * scale[..., None]).to(dtype)


def _read_kv(cache: KVCache, dtype):
    """The cache's k, v in ``dtype`` (int8 caches dequantized)."""
    if cache.kscale is not None:
        return (_dequant(cache.k, cache.kscale, dtype),
                _dequant(cache.v, cache.vscale, dtype))
    return cache.k.to(dtype), cache.v.to(dtype)


def _heads_replicated(cfg: Optional[ModelConfig]) -> bool:
    """Does every model rank run the attention core on every head (the
    reference's replicated SDPA, where the head counts do not divide
    'model')? A mesh rank's config says so (``sharding.local_config``);
    the shard loop reads its head counts at ``cfg.tp_shards``."""
    if cfg is None:
        return False
    from repro_torch.distribution import context as dctx
    if dctx.active_mesh() is not None:
        return cfg.heads_replicated
    from repro_torch.distribution.sharding import heads_split
    return not heads_split(cfg, cfg.tp_shards)


def _split(p: Dict, name: str, cfg: Optional[ModelConfig]) -> bool:
    """Are the projection's columns (wo: its rows) split over the model
    ranks? A packed container by its shards; a dense matrix wherever the
    heads split, else where the axis divides its dim (``sharding``'s col
    / row rules)."""
    packed = p.get("sasp_packed")
    if packed is not None and name in packed:
        return packed[name].shards > 1
    from repro_torch.models.ffn import tp_shards
    tp = tp_shards(cfg)
    if tp == 1:
        return False
    if not _heads_replicated(cfg):
        return True
    heads = cfg.num_kv_heads if name in ("wk", "wv") else cfg.num_heads
    return heads * cfg.attn_head_dim % tp == 0


def _proj(p: Dict, name: str, x: torch.Tensor,
          cfg: Optional[ModelConfig] = None) -> torch.Tensor:
    """One projection, through the packed tile-skip kernel when a
    deployment container is attached (bias fused into its flush).
    TP-sharded containers run through ``ffn.packed_mm_sharded``: wq/wk/wv
    col shards give this rank's heads, wo's row shard a partial reduced
    over 'model'. Dense weights split over ``ffn.tp_shards`` the same
    way (``distribution.sharding``'s col / row rules): on a mesh a rank
    holds its columns of wq/wk/wv and its rows of wo, whose partial is
    reduced, then the bias added; with no mesh, the shard loop runs each
    shard's columns in turn (concatenated) and each shard's rows of wo
    (the partials summed in fp32 in shard order). Where the heads do not
    split (``_heads_replicated``), a rank's q / k / v columns are
    all-gathered (in fp32, exact) into every head, and wo takes the rank's
    rows' slice of the whole core's output (``Mesh.take_shard``); a matrix
    whose dim the axis does not divide is whole on every rank."""
    packed = p.get("sasp_packed")
    if packed is not None and name in packed:
        pw = packed[name]
        if pw.shards > 1:
            from repro_torch.models.ffn import packed_mm_sharded
            *lead, K = x.shape
            y = packed_mm_sharded(x.reshape(-1, K), pw, cfg)
            return y.reshape(*lead, y.shape[-1])
        from repro_torch.core.deploy import packed_matmul
        return packed_matmul(x, pw)
    from repro_torch.distribution import context as dctx
    from repro_torch.models.ffn import _sum_partials, _tp_reduce, shard_of, \
        tp_shards
    tp = tp_shards(cfg)
    if not _split(p, name, cfg):
        return dense_apply(p[name], x)
    mesh = dctx.active_mesh()
    if mesh is not None:
        if name != "wo":
            y = dense_apply(p[name], x)
            if _heads_replicated(cfg):
                y = mesh.all_gather(y.to(torch.float32), -1).to(y.dtype)
            return y
        if _heads_replicated(cfg):
            x = mesh.take_shard(x, -1)
        w = p["wo"]["w"]
        y = matmul(x, w)
        y = _tp_reduce(y.reshape(-1, w.shape[-1]), cfg, y.dtype)
        y = y.reshape(*x.shape[:-1], w.shape[-1])
    elif name != "wo":
        return torch.cat([dense_apply(
            {k: shard_of(v, -1, s, tp) for k, v in p[name].items()}, x)
            for s in range(tp)], dim=-1)
    else:
        w = p["wo"]["w"]
        parts = [matmul(shard_of(x, -1, s, tp), shard_of(w, -2, s, tp))
                 for s in range(tp)]
        y = _sum_partials(parts, parts[0].dtype)
    if "b" in p["wo"]:
        y = y + p["wo"]["b"].to(y.dtype)
    return y


def _project_qkv(p: Dict, cfg: ModelConfig, x: torch.Tensor, positions):
    """x (B, S, d) -> q (B,S,H,D), k/v (B,S,KH,D), qk-normed + RoPE'd.
    On a mesh under autograd, x and the replicated q/k norms enter the
    rank's heads through ``copy_to_model``: their gradients are the sum
    of every rank's partial. Where every rank runs every head, x enters
    only the split projections that way, and the norms act on the whole
    heads (their gradient is the same on every rank)."""
    from repro_torch.distribution.context import copy_to_model
    B, S, _ = x.shape
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.attn_head_dim
    dt = x.dtype
    rep = _heads_replicated(cfg)
    xc = copy_to_model(x)

    def entry(name):
        return xc if not rep or _split(p, name, cfg) else x
    q = _proj(p, "wq", entry("wq"), cfg).reshape(B, S, h, hd)
    k = _proj(p, "wk", entry("wk"), cfg).reshape(B, S, kvh, hd)
    v = _proj(p, "wv", entry("wv"), cfg).reshape(B, S, kvh, hd)
    if cfg.qk_norm:
        nq, nk = p["q_norm"], p["k_norm"]
        if not rep:
            nq, nk = copy_to_model(nq), copy_to_model(nk)
        q = qknorm_apply(nq, q, eps=cfg.norm_eps)
        k = qknorm_apply(nk, k, eps=cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q.to(dt), k.to(dt), v.to(dt)


def _loop_head_shards(p: Dict, cfg: ModelConfig) -> int:
    """The TP shards of the attention projections that this tree holds:
    all of them in the shard loop (a packed wq's, or the dense matrices'
    ``cfg.tp_shards``), one on a mesh rank or where every rank runs every
    head."""
    packed = p.get("sasp_packed") or {}
    if "wq" in packed:
        return packed["wq"].held
    from repro_torch.models.ffn import tp_shards
    from repro_torch.distribution import context as dctx
    if dctx.active_mesh() is not None or _heads_replicated(cfg):
        return 1
    return tp_shards(cfg)


def _by_head_shard(n: int, fn, tensors, dims, out_dim: int):
    """``fn(*tensors)``; with ``n`` head shards, ``fn`` on each shard's
    contiguous slice of every tensor (``dims``: its head axis), the
    outputs concatenated along ``out_dim``."""
    if n == 1:
        return fn(*tensors)
    outs = []
    for s in range(n):
        outs.append(fn(*(t.narrow(d, s * (t.shape[d] // n),
                                  t.shape[d] // n).contiguous()
                         for t, d in zip(tensors, dims))))
    return torch.cat(outs, dim=out_dim)


def attend_chunked(q, k, v, q_pos, kv_pos, *, window, cap: float = 0.0
                   ) -> torch.Tensor:
    """Causal (optionally windowed) attention.

    q (B, Sq, KH, G, D); k, v (B, Sk, KH, D); q_pos / kv_pos (S,) or
    (B, S). Queries run in chunks of ``Q_CHUNK`` against every key at
    once (the reference also chunks keys with an online softmax; one key
    chunk gives the same softmax). A fully masked query row returns 0.
    Returns (B, Sq, KH, G, D)."""
    B, Sq, KH, G, D = q.shape
    Sk = k.shape[1]
    scale = D ** -0.5
    q = q * scale
    q_pos = torch.broadcast_to(torch.atleast_2d(q_pos.to(torch.int32)),
                               (B, Sq))
    kv_pos = torch.broadcast_to(torch.atleast_2d(kv_pos.to(torch.int32)),
                                (B, Sk))
    kf = k.to(torch.float32)
    outs = []
    for s0 in range(0, Sq, Q_CHUNK):
        qb = q[:, s0:s0 + Q_CHUNK]
        qp = q_pos[:, s0:s0 + Q_CHUNK]
        s = torch.einsum("bqkgd,bskd->bkgqs", qb.to(torch.float32), kf)
        if cap:
            s = softcap(s, cap)
        delta = qp[:, :, None] - kv_pos[:, None, :]
        mask = (delta >= 0) & (delta < window) & (kv_pos[:, None, :] >= 0)
        mask = mask[:, None, None]
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m = torch.amax(s, dim=-1, keepdim=True)
        pr = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
        l = torch.sum(pr, dim=-1)
        pv = torch.einsum("bkgqs,bskd->bkgqd",
                          pr.to(v.dtype).to(torch.float32),
                          v.to(torch.float32))
        out = pv / torch.clamp(l, min=1e-20)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4))
    return torch.cat(outs, dim=1)


def attn_apply_full(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                    positions: torch.Tensor, window
                    ) -> Tuple[torch.Tensor, Tuple]:
    """Prefill / full-sequence path. Returns (y, (k, v))."""
    B, S, _ = x.shape
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.attn_head_dim
    pos2 = positions[None, :] if positions.ndim == 1 else positions
    q, k, v = _project_qkv(p, cfg, x, pos2)
    qg = q.reshape(B, S, kvh, h // kvh, hd)
    out = _by_head_shard(
        _loop_head_shards(p, cfg),
        lambda qs, ks, vs: attend_chunked(qs, ks, vs, positions, positions,
                                          window=window,
                                          cap=cfg.logit_softcap),
        (qg, k, v), (2, 2, 2), 2)
    out = out.reshape(B, S, h * hd).to(x.dtype)
    return _proj(p, "wo", out, cfg), (k, v)


def attn_apply_decode(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                      pos: torch.Tensor, cache: KVCache, window,
                      cut: Optional[RingCut] = None
                      ) -> Tuple[torch.Tensor, KVCache]:
    """x (B, 1, d); pos (B,) absolute position of the new token. Writes
    the new K/V into ``cache`` in place and returns it. ``cut``: the
    ring's capacity is cut into blocks (the sequence-parallel layout):
    a mesh rank holds one block of ``cache`` and writes the new entry
    only where its block holds slot ``pos % C``; the softmax is combined
    over the blocks (``_attend_decode_cut``)."""
    B = x.shape[0]
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.attn_head_dim
    C = cache.k.shape[1] if cut is None else cut.capacity
    q, k_new, v_new = _project_qkv(p, cfg, x, pos[:, None])
    slot = (pos % C).to(torch.int64)
    bidx = torch.arange(B, device=x.device)
    new = {"pos": pos.to(torch.int32)}
    if cache.kscale is not None:
        new["k"], new["kscale"] = _quant_heads(k_new[:, 0])
        new["v"], new["vscale"] = _quant_heads(v_new[:, 0])
    else:
        new["k"] = k_new[:, 0].to(cache.k.dtype)
        new["v"] = v_new[:, 0].to(cache.v.dtype)
    if cut is not None and cut.local:
        # only the rank whose block holds the slot writes it
        c = cut.block
        at = slot - cut.index * c
        mine = (at >= 0) & (at < c)
        at = at.clamp(0, c - 1)
        for name, val in new.items():
            leaf = getattr(cache, name)
            keep = mine.reshape((B,) + (1,) * (val.ndim - 1))
            leaf[bidx, at] = torch.where(keep, val, leaf[bidx, at])
    else:
        for name, val in new.items():
            getattr(cache, name)[bidx, slot] = val

    qg = q.reshape(B, kvh, h // kvh, hd) * (hd ** -0.5)
    k_read, v_read = _read_kv(cache, qg.dtype)
    delta = pos[:, None] - cache.pos
    mask = (cache.pos >= 0) & (delta >= 0) & (delta < window)

    def attend(qs, ks, vs):
        if cut is not None:
            return _attend_decode_cut(qs, ks, vs, mask, cfg.logit_softcap,
                                      cut)
        s = torch.einsum("bkgd,bckd->bkgc", qs.to(torch.float32),
                         ks.to(torch.float32))
        if cfg.logit_softcap:
            s = softcap(s, cfg.logit_softcap)
        s = torch.where(mask[:, None, None], s, torch.full_like(s, NEG_INF))
        w = torch.softmax(s, dim=-1)
        return torch.einsum("bkgc,bckd->bkgd",
                            w.to(qs.dtype).to(torch.float32),
                            vs.to(torch.float32))

    out = _by_head_shard(_loop_head_shards(p, cfg), attend,
                         (qg, k_read, v_read), (1, 2, 2), 1)
    out = out.reshape(B, 1, h * hd).to(x.dtype)
    return _proj(p, "wo", out, cfg), cache


def _ring_blocks(cut: RingCut, ts):
    """Each ring block's slices of the tensors ``ts`` (slot axis 1): a
    mesh rank's own block, or the meshless twin's ``cut.n`` blocks in
    order, each contiguous as a rank holds it."""
    if cut.local:
        return [[t.contiguous() for t in ts]]
    c = cut.block
    return [[t.narrow(1, b * c, c).contiguous() for t in ts]
            for b in range(cut.n)]


def _seq_mesh():
    from repro_torch.distribution import context as dctx
    mesh = dctx.active_mesh()
    if mesh is None:
        raise RuntimeError("a ring cut to one block needs the active mesh "
                           "(distribution.context.use_mesh)")
    return mesh


def _blocks_max(cut: RingCut, vals):
    """The max of every block's ``vals``: over the cut's axes on a mesh
    rank (an all-reduce), else over the twin's blocks."""
    if cut.local:
        return _seq_mesh().allreduce(vals[0], cut.axes, "max")
    m = vals[0]
    for v in vals[1:]:
        m = torch.maximum(m, v)
    return m


def _blocks_sum(cut: RingCut, vals):
    """The fp32 sum of every block's ``vals`` in block order: gathered
    over the cut's axes and summed in rank order on a mesh rank
    (``Mesh.ordered_sum``), else the twin's blocks summed in order."""
    if cut.local:
        return _seq_mesh().ordered_sum(vals[0], cut.axes)
    from repro_torch.distribution.context import sum_in_order
    return sum_in_order(vals)


def _attend_decode_cut(qs, ks, vs, mask, cap: float, cut: RingCut):
    """Decode attention over a cut ring, the reference's softmax split
    over its blocks: the max of the blocks' masked maxima, the ordered
    sum of their ``exp(s - m)``, each block's weights normalised by that
    sum in fp32 and cast to q's type, and the blocks' fp32 value
    products summed in order. A fully masked block gives zeros. Three
    collectives on a mesh rank: (B, KH, G), (B, KH, G), (B, KH, G, D)."""
    q32 = qs.to(torch.float32)
    scores = []
    for kb, vb, mb in _ring_blocks(cut, (ks, vs, mask)):
        s = torch.einsum("bkgd,bckd->bkgc", q32, kb.to(torch.float32))
        if cap:
            s = softcap(s, cap)
        mb = mb[:, None, None]
        scores.append((torch.where(mb, s, torch.full_like(s, NEG_INF)), mb,
                       vb))
    m = _blocks_max(cut, [torch.amax(s, dim=-1) for s, _, _ in scores])
    es = [torch.where(mb, torch.exp(s - m[..., None]), torch.zeros_like(s))
          for s, mb, _ in scores]
    lsum = _blocks_sum(cut, [e.sum(dim=-1) for e in es])[..., None]
    return _blocks_sum(cut, [
        torch.einsum("bkgc,bckd->bkgd",
                     (e / lsum).to(qs.dtype).to(torch.float32),
                     vb.to(torch.float32))
        for e, (_, _, vb) in zip(es, scores)])


def _attend_past_cut(q, k_past, v_past, past_pos, k_new, v_new, q_pos,
                     window, cap: float, cut: RingCut) -> torch.Tensor:
    """``attend_chunked`` of a suffix's queries q (B, Sq, KH, G, D) over
    a cut ring (``past``, its blocks) and the fresh suffix K/V, whose
    keys sit at the queries' positions ``q_pos`` (B, Sq) and every rank
    holds: each chunk's max over the blocks and the suffix, the blocks'
    ordered sums of the unnormalised weights and of their fp32 value
    products, the suffix's added after, then one division. Returns (B,
    Sq, KH, G, D)."""
    B, Sq, KH, G, D = q.shape
    q = q * D ** -0.5
    q_pos = q_pos.to(torch.int32)
    blocks = _ring_blocks(cut, (k_past, v_past, past_pos))
    kfs = [kb.to(torch.float32) for kb, _, _ in blocks]
    knf = k_new.to(torch.float32)
    vdt = v_new.dtype
    outs = []
    for s0 in range(0, Sq, Q_CHUNK):
        qb = q[:, s0:s0 + Q_CHUNK].to(torch.float32)
        qp = q_pos[:, s0:s0 + Q_CHUNK]

        def score(kf, kvp):
            s = torch.einsum("bqkgd,bskd->bkgqs", qb, kf)
            if cap:
                s = softcap(s, cap)
            delta = qp[:, :, None] - kvp[:, None, :]
            mask = ((delta >= 0) & (delta < window)
                    & (kvp[:, None, :] >= 0))[:, None, None]
            return torch.where(mask, s, torch.full_like(s, NEG_INF)), mask

        ring = [score(kf, pb) for kf, (_, _, pb) in zip(kfs, blocks)]
        sn, mn = score(knf, q_pos)
        m = torch.maximum(
            _blocks_max(cut, [torch.amax(s, dim=-1) for s, _ in ring]),
            torch.amax(sn, dim=-1))[..., None]

        def probs(s, mask):
            return torch.where(mask, torch.exp(s - m), torch.zeros_like(s))

        def pv(pr, v):
            return torch.einsum("bkgqs,bskd->bkgqd",
                                pr.to(vdt).to(torch.float32),
                                v.to(torch.float32))
        prs = [probs(s, mask) for s, mask in ring]
        prn = probs(sn, mn)
        lsum = _blocks_sum(cut, [pr.sum(dim=-1) for pr in prs]) \
            + prn.sum(dim=-1)
        acc = _blocks_sum(cut, [pv(pr, vb) for pr, (_, vb, _)
                                in zip(prs, blocks)]) + pv(prn, v_new)
        out = acc / torch.clamp(lsum, min=1e-20)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4))
    return torch.cat(outs, dim=1)


def _ring_write(cache: KVCache, idx, k, v, posv, quant: bool):
    """Write k / v (…, KH, D) and positions at ``idx`` of a fresh ring
    (int8 caches quantize per head first)."""
    cache.pos[idx] = posv
    if quant:
        kq, ks = _quant_heads(k)
        vq, vs = _quant_heads(v)
        cache.k[idx], cache.v[idx] = kq, vq
        cache.kscale[idx], cache.vscale[idx] = ks, vs
    else:
        cache.k[idx] = k.to(cache.k.dtype)
        cache.v[idx] = v.to(cache.v.dtype)


def _block_slots(slots: torch.Tensor, cut: Optional[RingCut]):
    """(the slots a write lands on, the ring's slots to allocate): the
    whole ring's ``slots``, or on a mesh rank its block's local slots,
    every slot outside the block sent to a sacrificial extra slot that
    is cut off (no host read picks the block's entries)."""
    if cut is None or not cut.local:
        return slots, None
    c = cut.block
    at = slots - cut.index * c
    return torch.where((at >= 0) & (at < c), at, torch.full_like(at, c)), c


def build_cache_from_prefill(k: torch.Tensor, v: torch.Tensor,
                             capacity: int,
                             positions: Optional[torch.Tensor] = None,
                             quant: bool = False,
                             cut: Optional[RingCut] = None) -> KVCache:
    """Arrange prefill K/V (B, S, KH, D) into a ring of ``capacity``.
    positions: optional per-batch (B, S) (left-padded prefill; pads < 0
    are zeroed and written with pos = -1). ``cut`` on a mesh rank: only
    its block of the ring, the entries whose slots fall in it."""
    B, S, KH, D = k.shape
    if positions is None:
        n = min(S, capacity)
        src = torch.arange(S - n, S, device=k.device)
        slots, c = _block_slots(src % capacity, cut)
        cache = init_kv_cache(B, capacity if c is None else c + 1, KH, D,
                              k.dtype, k.device, quant)
        _ring_write(cache, (slice(None), slots), k[:, src], v[:, src],
                    src.to(torch.int32).expand(B, n), quant)
        return cache if c is None else cache_map(lambda a: a[:, :c], cache)
    positions = positions.to(torch.int32)
    if S > capacity:
        k, v = k[:, -capacity:], v[:, -capacity:]
        positions = positions[:, -capacity:]
    valid = positions >= 0
    slots, c = _block_slots((positions % capacity).to(torch.int64), cut)
    cache = init_kv_cache(B, capacity if c is None else c + 1, KH, D,
                          k.dtype, k.device, quant)
    posv = torch.where(valid, positions, torch.full_like(positions, -1))
    kz = torch.where(valid[..., None, None], k, torch.zeros_like(k))
    vz = torch.where(valid[..., None, None], v, torch.zeros_like(v))
    bidx = torch.arange(B, device=k.device)[:, None]
    _ring_write(cache, (bidx, slots), kz, vz, posv, quant)
    return cache if c is None else cache_map(lambda a: a[:, :c], cache)


def build_cache_from_suffix(k: torch.Tensor, v: torch.Tensor,
                            capacity: int, positions: torch.Tensor,
                            quant: bool = False,
                            cut: Optional[RingCut] = None) -> KVCache:
    """A ring holding ONLY the freshly prefilled suffix tokens: pad
    columns (positions < 0) go to a sacrificial extra slot that is cut
    off, so no pad write lands on the resident prefix's slots; every
    other slot stays empty (zeros, pos = -1). ``cut`` on a mesh rank:
    its block of that ring (the other entries go to the extra slot)."""
    B, S, KH, D = k.shape
    positions = positions.to(torch.int32)
    if S > capacity:
        k, v = k[:, -capacity:], v[:, -capacity:]
        positions = positions[:, -capacity:]
    valid = positions >= 0
    slots = torch.where(valid, positions % capacity,
                        torch.full_like(positions, capacity)).to(torch.int64)
    slots, c = _block_slots(slots, cut)
    c = capacity if c is None else c
    cache = init_kv_cache(B, c + 1, KH, D, k.dtype, k.device, quant)
    posv = torch.where(valid, positions, torch.full_like(positions, -1))
    kz = torch.where(valid[..., None, None], k, torch.zeros_like(k))
    vz = torch.where(valid[..., None, None], v, torch.zeros_like(v))
    bidx = torch.arange(B, device=k.device)[:, None]
    _ring_write(cache, (bidx, slots), kz, vz, posv, quant)
    return cache_map(lambda a: a[:, :c], cache)


def attn_apply_prefill_past(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                            positions: torch.Tensor, past: KVCache, window,
                            cut: Optional[RingCut] = None
                            ) -> Tuple[torch.Tensor, KVCache]:
    """Prefill only a prompt's suffix against resident prefix K/V.

    x (B, S, d) suffix states; positions (B, S) absolute (pads < 0);
    past: each row's gathered ring holding the prefix (every other slot
    pos = -1). Keys are the ring followed by the fresh suffix K/V; the
    returned cache holds only the suffix (``build_cache_from_suffix``).
    ``cut``: the ring is cut into blocks (a mesh rank's ``past`` is its
    block), the softmax combined over them (``_attend_past_cut``)."""
    B, S, _ = x.shape
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.attn_head_dim
    q, k_new, v_new = _project_qkv(p, cfg, x, positions)
    k_past, v_past = _read_kv(past, k_new.dtype)
    qg = q.reshape(B, S, kvh, h // kvh, hd)
    if cut is None:
        k_all = torch.cat([k_past, k_new], dim=1)
        v_all = torch.cat([v_past, v_new], dim=1)
        kv_pos = torch.cat([past.pos, positions.to(torch.int32)], dim=1)
        out = _by_head_shard(
            _loop_head_shards(p, cfg),
            lambda qs, ks, vs: attend_chunked(qs, ks, vs, positions, kv_pos,
                                              window=window,
                                              cap=cfg.logit_softcap),
            (qg, k_all, v_all), (2, 2, 2), 2)
    else:
        out = _by_head_shard(
            _loop_head_shards(p, cfg),
            lambda qs, kp, vp, kn, vn: _attend_past_cut(
                qs, kp, vp, past.pos, kn, vn, positions, window,
                cfg.logit_softcap, cut),
            (qg, k_past, v_past, k_new, v_new), (2, 2, 2, 2, 2), 2)
    out = out.reshape(B, S, h * hd).to(x.dtype)
    cache = build_cache_from_suffix(
        k_new, v_new, past.k.shape[1] if cut is None else cut.capacity,
        positions, quant=cfg.kv_quant, cut=cut)
    return _proj(p, "wo", out, cfg), cache


# ---------------------------------------------------------------------------
# Paged KV primitives (serve/memory.py): a pool leaf stacks pages
# (R, P, L, …) — R layers of a segment slot, P physical pages of L
# tokens. A slot's ring of C = NB·L tokens is the gather of its NB pages.
# ---------------------------------------------------------------------------


def gather_kv_pages(leaf: torch.Tensor, bt: torch.Tensor) -> torch.Tensor:
    """leaf (R, P, L, …), block table bt (B, NB) -> rings (R, B, NB·L, …),
    the contiguous cache layout (a new tensor)."""
    R, _, L = leaf.shape[:3]
    B, NB = bt.shape
    g = leaf[:, bt.reshape(-1).to(torch.int64)]
    return g.reshape((R, B, NB * L) + tuple(leaf.shape[3:]))


def scatter_kv_written_page(leaf: torch.Tensor, new_leaf: torch.Tensor,
                            bt: torch.Tensor, page_idx: torch.Tensor):
    """Write back the one page per slot a decode step touched: logical
    page ``page_idx[i]`` of row i goes to ``bt[i, page_idx[i]]`` (idle
    rows' tables point at the trash page)."""
    R, _, L = leaf.shape[:3]
    B, NB = bt.shape
    r = new_leaf.reshape((R, B, NB, L) + tuple(new_leaf.shape[3:]))
    rows = torch.arange(B, device=leaf.device)
    pj = page_idx.to(torch.int64)
    leaf[:, bt[rows, pj].to(torch.int64)] = r[:, rows, pj].to(leaf.dtype)


def scatter_prefill_pages(leaf: torch.Tensor, new_leaf: torch.Tensor,
                          dests: torch.Tensor):
    """Scatter prefill rings (R, G, C, …) into the pool at ``dests``
    (G, NB): the trash page where a logical page is unallocated or the
    row is group padding."""
    R, G = new_leaf.shape[:2]
    NB = dests.shape[1]
    L = new_leaf.shape[2] // NB
    r = new_leaf.reshape((R, G * NB, L) + tuple(new_leaf.shape[3:]))
    leaf[:, dests.reshape(-1).to(torch.int64)] = r.to(leaf.dtype)
