"""Packed SASP deployment of the port (single device).

``deploy_packed`` walks a pruned param tree and attaches kernel-ready
containers, so that serving does no per-call repacking: a
``PackedFFN`` (``sasp_fused``) for every gated FFN, or per-matrix
``PackedSASPWeight``s (``sasp_packed``) for w1/w2/w3 with the
activation folded into w1's flush, and, for ``scope="all"``, packed
wq/wk/wv/wo. Layer stacks are packed per layer and padded to one shared
nnz / nv. Masks are recovered from the nonzero tiles of the pruned
weights. Packing runs in numpy (``kernels.sasp_gemm.pack``), exactly as
in the reference, so the containers are equal array for array; the
tensors then move to the device of the weights.

TP sharding (``tp > 1``) is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.quantization import dequantize_int8
from repro_torch.core.sparse import PackedFFN, PackedSASPWeight
from repro_torch.kernels.sasp_gemm import pack
from repro_torch.kernels.sasp_gemm.fused_ffn import fused_ffn
from repro_torch.kernels.sasp_gemm.gemm import sasp_gemm

Params = Dict[str, Any]

_ATTN_MATS = ("wq", "wk", "wv", "wo")
_FFN_MATS = ("w1", "w2", "w3")
_PACKED_OVERLAYS = ("sasp_packed", "sasp_fused", "sasp_bsr")


def _fit_block(dim: int, want: int) -> int:
    """Largest block <= ``want`` that divides ``dim``."""
    b = min(max(1, want), dim)
    while dim % b:
        b -= 1
    return b


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().to("cpu", torch.float32).numpy()
    return np.asarray(t, np.float32)


def _dense_weight(entry) -> Optional[np.ndarray]:
    """One matrix dict {w} | {qw} as dense fp32 numpy."""
    if not isinstance(entry, dict):
        return None
    if "w" in entry:
        return _np(entry["w"])
    if "qw" in entry:
        return _np(dequantize_int8(entry["qw"]))
    return None


def _no_tp(tp: int) -> None:
    if tp != 1:
        raise NotImplementedError("TP-sharded packing is not ported yet")


def pack_weight(w: np.ndarray, *, block_k: int, block_n: int,
                bias: Optional[np.ndarray] = None,
                act: Optional[str] = None, quantize: bool = False,
                tp: int = 1, device="cuda") -> PackedSASPWeight:
    """(K, N) or layer-stacked (L, K, N) pruned weight -> container."""
    _no_tp(tp)
    w = np.asarray(w, np.float32)
    squeeze = w.ndim == 2
    if squeeze:
        w = w[None]
        bias = None if bias is None else np.asarray(bias)[None]
    L, K, N = w.shape
    bk = _fit_block(K, block_k)
    bn = _fit_block(N, block_n)
    KB, NB = K // bk, N // bn
    packs = []
    for i in range(L):
        m = np.any(w[i].reshape(KB, bk, NB, bn), axis=(1, 3))
        packs.append(pack.build_kernel_weight(w[i], m, bk, bn,
                                              quantize=quantize))
    nnz = max(p[0].shape[0] for p in packs)
    padded = [pack.pad_block_list(v, kn, sc, nnz) for v, kn, sc in packs]

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    vals = dev(np.stack([p[0] for p in padded]))
    kn = dev(np.stack([p[1] for p in padded]))
    scale = None if padded[0][2] is None else dev(
        np.stack([p[2] for p in padded]).astype(np.float32))
    b = None if bias is None else dev(np.asarray(bias, np.float32))
    if squeeze:
        vals, kn = vals[0], kn[0]
        scale = None if scale is None else scale[0]
        b = None if b is None else b[0]
    return PackedSASPWeight(vals, kn, (K, N), (bk, bn), scale=scale,
                            bias=b, act=act)


def pack_ffn(w1: np.ndarray, w3: np.ndarray, w2: np.ndarray, *,
             block_f: int, act: str, b1=None, b3=None, b2=None,
             quantize: bool = False, tp: int = 1,
             device="cuda") -> PackedFFN:
    """Gated-FFN triple (each optionally layer-stacked) -> PackedFFN."""
    _no_tp(tp)
    w1 = np.asarray(w1, np.float32)
    squeeze = w1.ndim == 2

    def lift(a):
        if a is None:
            return None
        a = np.asarray(a, np.float32)
        return a[None] if squeeze else a

    w1 = lift(w1)
    w3, w2 = lift(w3), lift(w2)
    b1, b3, b2 = lift(b1), lift(b3), lift(b2)
    L, d, F = w1.shape
    bf = _fit_block(F, block_f)
    packs = []
    for i in range(L):
        pk = pack.build_fused_ffn(
            w1[i], w3[i], w2[i], block_f=bf,
            b1=None if b1 is None else b1[i],
            b3=None if b3 is None else b3[i],
            b2=None if b2 is None else b2[i],
            quantize=quantize, return_visits=True)
        packs.append(pk)
    nv = max(p[0].shape[0] for p in packs)

    def pad_visits(p):
        w1v, w3v, w2v, b1v, b3v, b2v, sc, jv = p
        n_pad = nv - w1v.shape[0]
        if n_pad:
            def z(a):
                return np.concatenate(
                    [a, np.zeros((n_pad,) + a.shape[1:], a.dtype)])
            w1v, w3v, w2v, b1v, b3v = (z(a) for a in
                                       (w1v, w3v, w2v, b1v, b3v))
            jv = np.concatenate([jv, np.full((n_pad,), -1, np.int32)])
            if sc is not None:
                sc = tuple(z(s) for s in sc)
        return w1v, w3v, w2v, b1v, b3v, b2v, sc, jv

    rows = [pad_visits(p) for p in packs]

    def stack(idx):
        a = torch.from_numpy(np.ascontiguousarray(
            np.stack([r[idx] for r in rows]))).to(device)
        return a[0] if squeeze else a

    scales = [None, None, None]
    if rows[0][6] is not None:
        for j in range(3):
            a = torch.from_numpy(np.stack([r[6][j] for r in rows])).to(device)
            scales[j] = a[0] if squeeze else a
    return PackedFFN(stack(0), stack(1), stack(2), stack(3), stack(4),
                     stack(5), d_model=d, d_ff=F, block_f=bf, act=act,
                     s1=scales[0], s3=scales[1], s2=scales[2],
                     jv=stack(7))


# ---------------------------------------------------------------------------
# Apply (serving hot path)
# ---------------------------------------------------------------------------


def packed_matmul(x: torch.Tensor, pw: PackedSASPWeight) -> torch.Tensor:
    """(…, K) @ packed weight -> (…, N) through the tile-skip kernel, bias
    and activation fused into the flush."""
    _no_tp(pw.shards)
    *lead, K = x.shape
    y = sasp_gemm(x.reshape(-1, K), pw.vals, pw.kn, pw.col_ptr,
                  pw.shape[1], scales=pw.scale, bias=pw.bias, act=pw.act)
    return y.reshape(*lead, pw.shape[1]).to(x.dtype)


def packed_ffn_apply(x: torch.Tensor, pf: PackedFFN) -> torch.Tensor:
    """Whole gated FFN in one fused kernel launch."""
    _no_tp(pf.shards)
    *lead, d = x.shape
    scales = None if pf.s1 is None else (pf.s1, pf.s3, pf.s2)
    y = fused_ffn(x.reshape(-1, d), pf.w1v, pf.w3v, pf.w2v, pf.b1, pf.b3,
                  pf.b2, act=pf.act, scales=scales)
    return y.reshape(*lead, d).to(x.dtype)


# ---------------------------------------------------------------------------
# deploy_packed — the load-time conversion entry point
# ---------------------------------------------------------------------------


def _pack_matrix_group(node: Params, names, cfg: ModelConfig,
                       quantize: bool, act_for: Dict[str, Optional[str]],
                       device) -> Optional[Dict[str, PackedSASPWeight]]:
    out = {}
    for name in names:
        entry = node.get(name)
        w = None if entry is None else _dense_weight(entry)
        if w is None:
            continue
        if w.ndim not in (2, 3):
            return None
        bias = _np(entry["b"]) if "b" in entry else None
        out[name] = pack_weight(
            w, block_k=cfg.sasp.block_k, block_n=cfg.sasp.block_n,
            bias=bias, act=act_for.get(name), quantize=quantize,
            device=device)
    return out or None


def _deploy_slot(slot: Params, cfg: ModelConfig, *, quantize: bool,
                 fuse_ffn: bool, attn: bool, device) -> Params:
    slot = dict(slot)
    ffn = slot.get("ffn")
    if (isinstance(ffn, dict) and "w1" in ffn and "w2" in ffn
            and "router" not in ffn):
        ffn = {k: v for k, v in ffn.items() if k != "sasp_bsr"}
        gated = "w3" in ffn
        w1 = _dense_weight(ffn.get("w1"))
        w2 = _dense_weight(ffn.get("w2"))
        w3 = _dense_weight(ffn.get("w3")) if gated else None
        # an empty FFN (d_ff = 0) has nothing to pack (the reference's
        # packer divides by its zero width)
        if (w1 is not None and w2 is not None and w1.ndim in (2, 3)
                and w1.size):
            def bias(name):
                e = ffn[name]
                return _np(e["b"]) if isinstance(e, dict) and "b" in e \
                    else None
            if gated and fuse_ffn and w3 is not None:
                ffn["sasp_fused"] = pack_ffn(
                    w1, w3, w2, block_f=cfg.sasp.block_n, act=cfg.act,
                    b1=bias("w1"), b3=bias("w3"), b2=bias("w2"),
                    quantize=quantize, device=device)
            else:
                packed = _pack_matrix_group(
                    ffn, _FFN_MATS, cfg, quantize, {"w1": cfg.act}, device)
                if packed is not None:
                    ffn["sasp_packed"] = packed
            slot["ffn"] = ffn
    mixer = slot.get("mixer")
    if attn and isinstance(mixer, dict) and all(
            m in mixer for m in _ATTN_MATS):
        mixer = dict(mixer)
        packed = _pack_matrix_group(mixer, _ATTN_MATS, cfg, quantize, {},
                                    device)
        if packed is not None:
            mixer["sasp_packed"] = packed
            slot["mixer"] = mixer
    return slot


def _param_device(params: Params):
    emb = params.get("embed", {}).get("emb")
    return emb.device if isinstance(emb, torch.Tensor) else "cuda"


def deploy_packed(params: Params, cfg: ModelConfig, *,
                  quantize: Optional[bool] = None, fuse_ffn: bool = True,
                  attn: Optional[bool] = None,
                  tp: Optional[int] = None) -> Tuple[Params, ModelConfig]:
    """Convert a pruned param tree into packed serving form. Returns
    ``(params', cfg')`` with containers attached next to the dense
    weights (which stay as the source of truth) and
    ``cfg'.sasp.path == "kernel"``."""
    _no_tp(1 if tp is None else tp)
    quantize = cfg.sasp.quantize if quantize is None else quantize
    attn = (cfg.sasp.scope == "all") if attn is None else attn
    device = _param_device(params)
    out = dict(params)
    out["segments"] = tuple(
        {name: _deploy_slot(slot, cfg, quantize=quantize,
                            fuse_ffn=fuse_ffn, attn=attn, device=device)
         for name, slot in seg.items()}
        for seg in params.get("segments", ()))
    cfg = dataclasses.replace(
        cfg, sasp=dataclasses.replace(cfg.sasp, enabled=True,
                                      path="kernel"))
    return out, cfg


def strip_packed(params: Params) -> Params:
    """Drop every deployment overlay, leaving the dense weights."""
    out = dict(params)
    segs = []
    for seg in params.get("segments", ()):
        new_seg = {}
        for name, slot in seg.items():
            slot = dict(slot)
            for part in ("ffn", "mixer"):
                sub = slot.get(part)
                if isinstance(sub, dict) and any(
                        k in sub for k in _PACKED_OVERLAYS):
                    slot[part] = {k: v for k, v in sub.items()
                                  if k not in _PACKED_OVERLAYS}
            new_seg[name] = slot
        segs.append(new_seg)
    out["segments"] = tuple(segs)
    return out


def draft_pack(params: Params, cfg: ModelConfig, *, sparsity: float,
               quantize: bool = False) -> Tuple[Params, ModelConfig]:
    """Self-speculation drafter on the sparsity ladder: the deployed
    weights re-pruned at a higher global tile ``sparsity`` and packed
    (int8 with per-block scales with ``quantize``). Same architecture,
    so the same cache geometry: drafter and target share one paged KV
    pool. Greedy exactness never rests on the drafter (every emitted
    token is a target argmax); its fidelity only moves the acceptance.
    Fp blocks are stored in the compute type, as the launcher stores
    the target's (the kernels round weights to it anyway)."""
    if not 0.0 < float(sparsity) < 1.0:
        raise ValueError(
            f"draft sparsity={sparsity} must lie in (0, 1)")
    from repro_torch.core.pruning import prune_params
    from repro_torch.models.modules import as_dtype
    dsasp = dataclasses.replace(
        cfg.sasp, enabled=True, sparsity=float(sparsity),
        quantize=bool(quantize))
    dcfg = dataclasses.replace(cfg, sasp=dsasp)
    pruned, _ = prune_params(strip_packed(params), dsasp)
    out, dcfg = deploy_packed(pruned, dcfg, quantize=bool(quantize))
    cdt = as_dtype(cfg.compute_dtype)
    if cdt != torch.float32:
        out = cast_packed_values(out, cdt)
    return out, dcfg


def cast_packed_values(params: Params, dtype: torch.dtype) -> Params:
    """Store the fp blocks of every container in ``dtype`` (the compute
    type): the kernels round each weight to x's type anyway, so results
    are unchanged and the weight bytes read per call halve for bf16.
    int8 containers are left as they are."""
    def fp(t):
        return t if t.dtype == torch.int8 else t.to(dtype)

    def walk(node):
        if isinstance(node, PackedSASPWeight):
            return dataclasses.replace(node, vals=fp(node.vals))
        if isinstance(node, PackedFFN):
            return dataclasses.replace(node, w1v=fp(node.w1v),
                                       w3v=fp(node.w3v), w2v=fp(node.w2v))
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            return type(node)(walk(v) for v in node)
        return node

    return walk(params)


def packed_summary(params: Params) -> Dict[str, float]:
    """Deployment report: container counts + compression vs dense fp32."""
    n_packed = n_fused = 0
    packed_bytes = dense_bytes = 0

    def visit(node):
        nonlocal n_packed, n_fused, packed_bytes, dense_bytes
        if isinstance(node, PackedSASPWeight):
            n_packed += 1
            packed_bytes += node.nbytes()
            K, N = node.shape
            lead = node.vals.shape[:-3]
            dense_bytes += int(np.prod(lead, dtype=np.int64)) * K * N * 4
        elif isinstance(node, PackedFFN):
            n_fused += 1
            for a in (node.w1v, node.w3v, node.w2v):
                packed_bytes += a.numel() * a.element_size()
            lead = node.w1v.shape[:-3]
            dense_bytes += int(np.prod(lead, dtype=np.int64)) \
                * 3 * node.d_model * node.d_ff * 4
        elif isinstance(node, dict):
            for v in node.values():
                visit(v)
        elif isinstance(node, (tuple, list)):
            for v in node:
                visit(v)

    visit(params)
    return {
        "n_packed_matrices": n_packed,
        "n_fused_ffns": n_fused,
        "packed_bytes": packed_bytes,
        "dense_bytes": dense_bytes,
        "compression": packed_bytes / max(dense_bytes, 1),
    }
