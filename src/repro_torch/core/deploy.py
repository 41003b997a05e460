"""Packed SASP deployment of the port (single device).

``deploy_packed`` walks a pruned param tree and attaches kernel-ready
containers, so that serving does no per-call repacking: a
``PackedFFN`` (``sasp_fused``) for every gated FFN, or per-matrix
``PackedSASPWeight``s (``sasp_packed``) for w1/w2/w3 with the
activation folded into w1's flush, and, for ``scope="all"``, packed
wq/wk/wv/wo. Layer stacks are packed per layer and padded to one shared
nnz / nv. Masks are recovered from the nonzero tiles of the pruned
weights. Packing runs in torch on the weights' device
(``kernels.sasp_gemm.pack``) with the reference packers' arithmetic, so
the containers are equal array for array.

TP sharding (``tp > 1``): every visit list splits into shard-local lists
by shard kind (``core.sparse``), each shard keeping only its own
surviving blocks; ``reshard_packed`` re-partitions existing containers to
another shard count, equal array for array to packing the dense weights
at that count.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.quantization import QuantizedWeight, dequantize_int8
from repro_torch.core.sparse import (BlockSparseWeight, PackedFFN,
                                     PackedSASPWeight)
from repro_torch.distribution.sharding import tp_config
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


def _f32(a, device) -> Optional[torch.Tensor]:
    """``a`` (numpy or tensor) as fp32 on ``device``, or None."""
    if a is None:
        return None
    return torch.as_tensor(a, dtype=torch.float32, device=device)


def _dense_weight(entry) -> Optional[torch.Tensor]:
    """One matrix dict {w} | {qw} as a dense fp32 tensor."""
    if not isinstance(entry, dict):
        return None
    if "w" in entry:
        return entry["w"].detach().to(torch.float32)
    if "qw" in entry:
        return dequantize_int8(entry["qw"]).to(torch.float32)
    return None


def pack_weight(w, *, block_k: int, block_n: int, bias=None,
                act: Optional[str] = None, quantize: bool = False,
                tp: int = 1, shard_kind: str = "col",
                device="cuda") -> PackedSASPWeight:
    """(K, N) or layer-stacked (L, K, N) pruned weight (numpy or tensor)
    -> container on ``device``.

    ``tp > 1`` packs ``tp`` shard-local visit lists per layer:
    ``shard_kind="col"`` slices the output-column blocks (bias per shard,
    fused), ``"row"`` the input-row blocks (partial outputs: no ``act``,
    bias whole, added after the reduction). Every (layer, shard) list is
    padded to one nnz."""
    w = _f32(w, device)
    bias = _f32(bias, device)
    squeeze = w.ndim == 2
    if squeeze:
        w = w[None]
        bias = None if bias is None else bias[None]
    L, K, N = w.shape
    bk = _fit_block(K, block_k)
    bn = _fit_block(N, block_n)
    assert shard_kind in ("col", "row"), shard_kind
    if tp > 1:
        assert _shard_blocks(shard_kind, K, N, bk, bn) % tp == 0, (
            shard_kind, K, N, tp)
        assert shard_kind == "col" or act is None, \
            "row-sharded outputs are partial; no nonlinear epilogue"

    def piece(wi, s):
        if tp == 1:
            return wi
        if shard_kind == "col":
            ns = N // tp
            return wi[:, s * ns:(s + 1) * ns]
        ks = K // tp
        return wi[s * ks:(s + 1) * ks, :]

    packs = []                          # [L][tp] of (vals, kn, scale)
    for i in range(L):
        row = []
        for s in range(tp):
            ws = piece(w[i], s)
            kb, nb = ws.shape[0] // bk, ws.shape[1] // bn
            m = (ws.reshape(kb, bk, nb, bn) != 0).any(dim=3).any(dim=1)
            row.append(pack.build_kernel_weight(ws, m, bk, bn,
                                                quantize=quantize))
        packs.append(row)
    nnz = max(p[0].shape[0] for row in packs for p in row)
    padded = [[pack.pad_block_list(v, kn, sc, nnz) for v, kn, sc in row]
              for row in packs]

    def stack(j):
        a = torch.stack([torch.stack([p[j] for p in row]) for row in padded])
        return a[:, 0] if tp == 1 else a

    vals, kn = stack(0), stack(1)
    scale = None if padded[0][0][2] is None else stack(2)
    b = bias
    if b is not None and tp > 1 and shard_kind == "col":
        b = b.reshape(L, tp, N // tp)       # fused per column shard
    if squeeze:
        vals, kn = vals[0], kn[0]
        scale = None if scale is None else scale[0]
        b = None if b is None else b[0]
    return PackedSASPWeight(vals, kn, (K, N), (bk, bn), scale=scale,
                            bias=b, act=act, shards=tp,
                            shard_kind=shard_kind if tp > 1 else None)


def pack_ffn(w1, w3, w2, *, block_f: int, act: str, b1=None, b3=None,
             b2=None, quantize: bool = False, tp: int = 1,
             device="cuda") -> PackedFFN:
    """Gated-FFN triple (each optionally layer-stacked; numpy or tensors)
    -> PackedFFN on ``device``.

    ``tp > 1`` splits the d_ff visits contiguously: shard s packs d_ff
    columns [s·F/tp, (s+1)·F/tp) of w1/w3 and the matching w2 rows, its
    ``jv`` global d_ff blocks. b2 is not folded into a shard (the shards'
    partials are summed); it stays whole, added once after the sum."""
    squeeze = w1.ndim == 2

    def lift(a):
        a = _f32(a, device)
        return a[None] if squeeze and a is not None else a

    w1, w3, w2 = lift(w1), lift(w3), lift(w2)
    b1, b3, b2 = lift(b1), lift(b3), lift(b2)
    L, d, F = w1.shape
    bf = _fit_block(F, block_f)
    if tp > 1:
        assert (F // bf) % tp == 0, (F, bf, tp)
    fs = F // tp

    def build(i, s):
        sl = slice(s * fs, (s + 1) * fs)
        pk = pack.build_fused_ffn(
            w1[i][:, sl], w3[i][:, sl], w2[i][sl, :], block_f=bf,
            b1=None if b1 is None else b1[i][sl],
            b3=None if b3 is None else b3[i][sl],
            b2=None if (b2 is None or tp > 1) else b2[i],
            quantize=quantize, return_visits=True)
        jv = pk[-1]
        if tp > 1:          # shard-local keep indices -> global d_ff blocks
            jv = torch.where(jv >= 0, jv + s * ((F // bf) // tp), -1)
        return pk[:-1] + (jv,)

    packs = [build(i, s) for i in range(L) for s in range(tp)]
    nv = max(p[0].shape[0] for p in packs)

    def pad_visits(p):
        w1v, w3v, w2v, b1v, b3v, b2v, sc, jv = p
        n_pad = nv - w1v.shape[0]
        if n_pad:
            def z(a):
                return torch.cat([a, a.new_zeros((n_pad,) + tuple(
                    a.shape[1:]))])
            w1v, w3v, w2v, b1v, b3v = (z(a) for a in
                                       (w1v, w3v, w2v, b1v, b3v))
            jv = torch.cat([jv, jv.new_full((n_pad,), -1)])
            if sc is not None:
                sc = tuple(z(s) for s in sc)
        return w1v, w3v, w2v, b1v, b3v, b2v, sc, jv

    rows = [pad_visits(p) for p in packs]

    def stack(get):
        a = torch.stack([get(r) for r in rows])
        if tp > 1:                          # (L·tp, …) -> (L, tp, …)
            a = a.reshape((L, tp) + tuple(a.shape[1:]))
        return a[0] if squeeze else a

    if tp > 1:
        # the shards carried zero b2 placeholders; the real bias stays
        # whole, added once after the shard reduction
        b2v = b2 if b2 is not None else w1.new_zeros((L, d))
        b2v = b2v[0] if squeeze else b2v
    else:
        b2v = stack(lambda r: r[5])
    scales = [None, None, None]
    if rows[0][6] is not None:
        scales = [stack(lambda r, j=j: r[6][j]) for j in range(3)]
    return PackedFFN(stack(lambda r: r[0]), stack(lambda r: r[1]),
                     stack(lambda r: r[2]), stack(lambda r: r[3]),
                     stack(lambda r: r[4]), b2v, d_model=d, d_ff=F,
                     block_f=bf, act=act, s1=scales[0], s3=scales[1],
                     s2=scales[2], shards=tp, jv=stack(lambda r: r[7]))


# ---------------------------------------------------------------------------
# Apply (serving hot path)
# ---------------------------------------------------------------------------


def _unsharded(node) -> None:
    if node.shards != 1:
        raise ValueError(
            "a TP-sharded container runs through models.ffn's TP paths "
            "(packed_mm_sharded, _packed_ffn_fused_sharded), shard by "
            "shard")


def packed_matmul(x: torch.Tensor, pw: PackedSASPWeight, *,
                  group_nb: Optional[int] = None) -> torch.Tensor:
    """(…, K) @ packed weight -> (…, N) through the tile-skip kernel, bias
    and activation fused into the flush. ``group_nb``: the column-blocks
    of the whole weight a col shard was cut from, whose grid fixes the
    kernel's visit groups (so the shard sums its columns in the whole
    weight's order)."""
    _unsharded(pw)
    *lead, K = x.shape
    y = sasp_gemm(x.reshape(-1, K), pw.vals, pw.kn, pw.col_ptr,
                  pw.shape[1], scales=pw.scale, bias=pw.bias, act=pw.act,
                  group_nb=group_nb)
    return y.reshape(*lead, pw.shape[1]).to(x.dtype)


def packed_ffn_apply(x: torch.Tensor, pf: PackedFFN) -> torch.Tensor:
    """Whole gated FFN in one fused kernel launch."""
    _unsharded(pf)
    *lead, d = x.shape
    scales = None if pf.s1 is None else (pf.s1, pf.s3, pf.s2)
    y = fused_ffn(x.reshape(-1, d), pf.w1v, pf.w3v, pf.w2v, pf.b1, pf.b3,
                  pf.b2, act=pf.act, scales=scales)
    return y.reshape(*lead, d).to(x.dtype)


# ---------------------------------------------------------------------------
# deploy_packed — the load-time conversion entry point
# ---------------------------------------------------------------------------

# TP-eligibility rules, shared by deploy_packed and reshard_packed so the
# two walks cannot part


def _shard_blocks(kind: str, K: int, N: int, bk: int, bn: int) -> int:
    """Block count along the dimension a shard kind partitions."""
    return (N // bn) if kind == "col" else (K // bk)


def _fused_tp(d_ff: int, block_f: int, tp: int) -> int:
    """Shards the fused d_ff visit schedule takes (1 = unsharded)."""
    return tp if tp > 1 and (d_ff // block_f) % tp == 0 else 1


def _attn_tp(cfg: ModelConfig, tp: int) -> int:
    """wq/wk/wv col shards must land on head boundaries."""
    return tp if (tp > 1 and cfg.num_heads % tp == 0
                  and cfg.num_kv_heads % tp == 0) else 1


def _tp_fits(w: torch.Tensor, kind: str, cfg: ModelConfig, tp: int) -> bool:
    """Does the matrix's block grid split evenly into ``tp`` shards?"""
    K, N = w.shape[-2:]
    bk = _fit_block(K, cfg.sasp.block_k)
    bn = _fit_block(N, cfg.sasp.block_n)
    return _shard_blocks(kind, K, N, bk, bn) % tp == 0


_FFN_KINDS = {"w1": "col", "w3": "col", "w2": "row"}
_ATTN_KINDS = {"wq": "col", "wk": "col", "wv": "col", "wo": "row"}


def _pack_matrix_group(node: Params, names, cfg: ModelConfig,
                       quantize: bool, act_for: Dict[str, Optional[str]],
                       device, tp: int = 1,
                       kinds: Optional[Dict[str, str]] = None
                       ) -> Optional[Dict[str, PackedSASPWeight]]:
    """Pack matrices that serve together; TP sharding is all or nothing
    across the group."""
    kinds = kinds or {}
    mats = []
    for name in names:
        entry = node.get(name)
        w = None if entry is None else _dense_weight(entry)
        if w is None:
            continue
        if w.ndim not in (2, 3):
            return None
        mats.append((name, w, entry.get("b")))
    if tp > 1 and any(not _tp_fits(w, kinds.get(n, "col"), cfg, tp)
                      for n, w, _ in mats):
        tp = 1
    out = {}
    for name, w, bias in mats:
        out[name] = pack_weight(
            w, block_k=cfg.sasp.block_k, block_n=cfg.sasp.block_n,
            bias=bias, act=act_for.get(name), quantize=quantize, tp=tp,
            shard_kind=kinds.get(name, "col"), device=device)
    return out or None


def _deploy_slot(slot: Params, cfg: ModelConfig, *, quantize: bool,
                 fuse_ffn: bool, attn: bool, device, tp: int = 1) -> Params:
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
                and w1.numel()):
            def bias(name):
                e = ffn[name]
                return e.get("b") if isinstance(e, dict) else None
            if gated and fuse_ffn and w3 is not None:
                F = w1.shape[-1]
                ffn["sasp_fused"] = pack_ffn(
                    w1, w3, w2, block_f=cfg.sasp.block_n, act=cfg.act,
                    b1=bias("w1"), b3=bias("w3"), b2=bias("w2"),
                    quantize=quantize, device=device,
                    tp=_fused_tp(F, _fit_block(F, cfg.sasp.block_n), tp))
            else:
                packed = _pack_matrix_group(
                    ffn, _FFN_MATS, cfg, quantize, {"w1": cfg.act}, device,
                    tp=tp, kinds=_FFN_KINDS)
                if packed is not None:
                    ffn["sasp_packed"] = packed
            slot["ffn"] = ffn
    mixer = slot.get("mixer")
    if attn and isinstance(mixer, dict) and all(
            m in mixer for m in _ATTN_MATS):
        mixer = dict(mixer)
        packed = _pack_matrix_group(mixer, _ATTN_MATS, cfg, quantize, {},
                                    device, tp=_attn_tp(cfg, tp),
                                    kinds=_ATTN_KINDS)
        if packed is not None:
            mixer["sasp_packed"] = packed
            slot["mixer"] = mixer
    return slot


def _param_device(params: Params):
    emb = params.get("embed", {}).get("emb")
    return emb.device if isinstance(emb, torch.Tensor) else "cuda"


def _mesh_tp(mesh, tp: Optional[int]) -> int:
    if tp is not None:
        return int(tp)
    return mesh.axis_size("model") if mesh is not None else 1


def deploy_packed(params: Params, cfg: ModelConfig, *,
                  quantize: Optional[bool] = None, fuse_ffn: bool = True,
                  attn: Optional[bool] = None, mesh=None,
                  tp: Optional[int] = None) -> Tuple[Params, ModelConfig]:
    """Convert a pruned param tree into packed serving form. Returns
    ``(params', cfg')`` with containers attached next to the dense
    weights (which stay as the source of truth) and
    ``cfg'.sasp.path == "kernel"``. ``tp`` (or the 'model' axis of
    ``mesh``): shard every visit list into ``tp`` shard-local lists
    (wq/wk/wv col on head boundaries, wo row; w1/w3 col, w2 row; the
    fused FFN by d_ff); a group whose block grid does not divide stays
    unsharded. ``cfg'.vocab_shards``: the embedding / head table's vocab
    split at ``tp``, and ``cfg'.tp_shards`` ``tp``
    (``distribution.sharding.tp_config``)."""
    tp = _mesh_tp(mesh, tp)
    quantize = cfg.sasp.quantize if quantize is None else quantize
    attn = (cfg.sasp.scope == "all") if attn is None else attn
    device = _param_device(params)
    out = dict(params)
    out["segments"] = tuple(
        {name: _deploy_slot(slot, cfg, quantize=quantize,
                            fuse_ffn=fuse_ffn, attn=attn, device=device,
                            tp=tp)
         for name, slot in seg.items()}
        for seg in params.get("segments", ()))
    cfg = dataclasses.replace(
        cfg, sasp=dataclasses.replace(cfg.sasp, enabled=True,
                                      path="kernel"))
    return out, tp_config(cfg, tp)


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
               quantize: bool = False, mesh=None, tp: Optional[int] = None
               ) -> Tuple[Params, ModelConfig]:
    """Self-speculation drafter on the sparsity ladder: the deployed
    weights re-pruned at a higher global tile ``sparsity`` and packed
    (int8 with per-block scales with ``quantize``). Same architecture,
    so the same cache geometry: drafter and target share one paged KV
    pool. Greedy exactness never rests on the drafter (every emitted
    token is a target argmax); its fidelity only moves the acceptance.
    Fp blocks are stored in the compute type, as the launcher stores
    the target's (the kernels round weights to it anyway). ``mesh`` /
    ``tp``: the drafter's visit lists in ``tp`` shards (or the 'model'
    axis of ``mesh``), sharded like a target packed at that count
    (``deploy_packed``)."""
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
    out, dcfg = deploy_packed(pruned, dcfg, quantize=bool(quantize),
                              mesh=mesh, tp=tp)
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


# the padded axis (dims from the end) and pad value of each container
# field, as the packers pad: None pads with copies of the last entry
_W_PAD = {"vals": (-3, 0.0), "kn": (-1, None), "scale": (-1, 0.0)}
_F_PAD = {**{f: (-3, 0.0) for f in ("w1v", "w3v", "w2v")},
          **{f: (-2, 0.0) for f in ("b1", "b3")},
          **{f: (-1, 0.0) for f in ("s1", "s3", "s2")}, "jv": (-1, -1)}


def _pad_fill(dst: torch.Tensor, dim: int, m: int, value) -> None:
    """Fill ``dst`` from index ``m`` on along ``dim`` with ``value``, or
    (None) with copies of its entry ``m - 1``."""
    n = dst.shape[dim]
    if n > m:
        pad = dst.narrow(dim, m, n - m)
        if value is None:
            pad.copy_(dst.narrow(dim, m - 1, 1).expand(pad.shape))
        else:
            pad.fill_(value)


class _Stacked:
    """A container's buffers in a :class:`LayerStack`: its first layer
    (the fields that are not tensors), the padded axis' length so far."""

    def __init__(self, first, n: int):
        self.first, self.n, self.bufs = first, n, {}


class LayerStack:
    """One layer-stacked tree from trees of one layer each (every leaf's
    leading layer axis of length 1), added one at a time: each leaf and
    container field is written into its layer-stacked buffer on
    ``device`` as its layer comes, so the parts never stand beside their
    stack. Containers are padded to one nnz / nv as the packers pad them
    (a visit list by its last visit repeated with zero blocks and
    scales, ``pack.pad_block_list``; a PackedFFN by zero visits with jv
    -1): the padded axis grows when a layer needs more than the layers
    before it. Stacking the layers of ``deploy_packed`` run layer by
    layer gives the containers of one run over every layer. BSR and int8
    ``qw`` containers take one shape every layer (a BSR's depth is the
    whole stack's ``k_max``) and stack field by field."""

    def __init__(self, n_layers: int, device):
        self.L, self.device, self.i = n_layers, device, 0
        self.root = None

    def add(self, part) -> None:
        if self.i >= self.L:
            raise IndexError(f"a stack of {self.L} layers is full")
        self.root = self._add(self.root, part)
        self.i += 1

    def _buffer(self, t: torch.Tensor, n=None, dim=None) -> torch.Tensor:
        shape = [self.L] + list(t.shape[1:])
        if n is not None:
            shape[dim % t.ndim] = n
        return torch.empty(shape, dtype=t.dtype, device=self.device)

    def _add(self, node, part):
        if isinstance(part, dict):
            node = {} if node is None else node
            for k, v in part.items():
                node[k] = self._add(node.get(k), v)
            return node
        if part is None:
            return None
        if isinstance(part, torch.Tensor):
            node = self._buffer(part) if node is None else node
            node[self.i:self.i + 1].copy_(part)
            return node
        if isinstance(part, PackedSASPWeight):
            pads, n = _W_PAD, part.nnz
        elif isinstance(part, PackedFFN):
            pads, n = _F_PAD, part.nv
        elif isinstance(part, (BlockSparseWeight, QuantizedWeight)):
            pads, n = {}, 0             # one shape every layer
        else:
            raise TypeError(f"LayerStack: {type(part).__name__}")
        if node is None:
            node = _Stacked(part, n)
        if n > node.n:                          # grow the padded axis
            for f, (dim, value) in pads.items():
                old = node.bufs.get(f)
                if old is None:
                    continue
                new = self._buffer(old, n, dim)
                done = new[:self.i]
                done.narrow(dim, 0, node.n).copy_(old[:self.i])
                _pad_fill(done, dim, node.n, value)
                node.bufs[f] = new
            node.n = n
        for fld in dataclasses.fields(part):
            t = getattr(part, fld.name)
            if not isinstance(t, torch.Tensor) or fld.name == "col_ptr":
                continue
            dim, value = pads.get(fld.name, (None, None))
            buf = node.bufs.get(fld.name)
            if buf is None:
                buf = node.bufs[fld.name] = (
                    self._buffer(t) if dim is None
                    else self._buffer(t, node.n, dim))
            dst = buf[self.i:self.i + 1]
            if dim is None:
                dst.copy_(t)
            else:
                dst.narrow(dim, 0, t.shape[dim]).copy_(t)
                _pad_fill(dst, dim, t.shape[dim], value)
        return node

    def result(self):
        """The stacked tree (every layer added)."""
        if self.i != self.L:
            raise ValueError(f"{self.i} of {self.L} layers added")
        return self._result(self.root)

    def _result(self, node):
        if isinstance(node, dict):
            return {k: self._result(v) for k, v in node.items()}
        if not isinstance(node, _Stacked):
            return node
        first = node.first
        kw = {f.name: node.bufs.get(f.name)
              for f in dataclasses.fields(first)
              if isinstance(getattr(first, f.name), torch.Tensor)}
        if isinstance(first, PackedSASPWeight):
            kw["col_ptr"] = None                # rebuilt from the stacked kn
        return dataclasses.replace(first, **kw)


# ---------------------------------------------------------------------------
# Elastic re-deploy: reshard existing containers
# ---------------------------------------------------------------------------


def _zero_block_scale() -> float:
    """int8 scale of an all-zero block, by the packers' own arithmetic
    (``pack.build_kernel_weight``), so resharded containers equal packs
    from scratch bit for bit."""
    amax = np.zeros((1,), np.float32)
    return float((np.maximum(amax, 1e-12) / 127.0).astype(np.float32)[0])


def _reshard_weight(pw: PackedSASPWeight, tp: int,
                    kind: str) -> PackedSASPWeight:
    """Slice and pad one packed matrix to ``tp`` shards on its own device:
    live visits (nonzero blocks) are re-binned by output-column (col) or
    input-row (row) block shard with shard-local coordinates, empty
    output columns get their zero flush visit, (n, k) order, and the
    (layer, shard) lists re-pad to one nnz. Equal to ``pack_weight`` on
    the sliced dense weight."""
    assert pw.held == pw.shards, "reshard a whole container, not a rank's"
    K, N = pw.shape
    bk, bn = pw.block
    KB, NB = K // bk, N // bn
    quant = pw.scale is not None
    assert kind in ("col", "row"), kind
    assert tp == 1 or kind == "col" or pw.act is None
    assert (NB if kind == "col" else KB) % tp == 0, (kind, pw.shape, tp)
    vals, kn, sc = pw.vals, pw.kn.to(torch.int64), pw.scale
    stacked = vals.ndim == (5 if pw.shards > 1 else 4)
    if not stacked:
        vals, kn = vals[None], kn[None]
        sc = None if sc is None else sc[None]
    if pw.shards == 1:
        vals, kn = vals[:, None], kn[:, None]
        sc = None if sc is None else sc[:, None]
    L, dev = vals.shape[0], vals.device
    NB_s = NB // tp if kind == "col" else NB
    KB_s = KB if kind == "col" else KB // tp
    zs = _zero_block_scale()
    packs = []                              # [L][tp] of (vals, kn, scale)
    for li in range(L):
        # 1) the layer's global live-visit list (padding and flush
        #    visits are zero blocks, rebuilt below)
        ks, ns, vs, ss = [], [], [], []
        for s in range(pw.shards):
            v = vals[li, s]
            live = (v != 0).flatten(1).any(1)
            k, n = kn[li, s, 0], kn[li, s, 1]
            if pw.shards > 1:
                if pw.shard_kind == "col":
                    n = n + s * (NB // pw.shards)
                else:
                    k = k + s * (KB // pw.shards)
            ks.append(k[live])
            ns.append(n[live])
            vs.append(v[live])
            if quant:
                ss.append(sc[li, s][live])
        ks, ns, vs = torch.cat(ks), torch.cat(ns), torch.cat(vs)
        ss = torch.cat(ss) if quant else None
        # 2) re-bin to the new shards as the packer bins a sliced weight
        row = []
        for s in range(tp):
            if kind == "col":
                sel = (ns >= s * NB_s) & (ns < (s + 1) * NB_s)
                k_loc, n_loc = ks[sel], ns[sel] - s * NB_s
            else:
                sel = (ks >= s * KB_s) & (ks < (s + 1) * KB_s)
                k_loc, n_loc = ks[sel] - s * KB_s, ns[sel]
            v_loc = vs[sel]
            s_loc = ss[sel] if quant else None
            seen = torch.zeros((NB_s,), dtype=torch.bool, device=dev)
            seen[n_loc] = True
            empty = torch.nonzero(~seen)[:, 0]
            if empty.numel():               # one zero flush visit each
                k_loc = torch.cat([k_loc, torch.zeros_like(empty)])
                n_loc = torch.cat([n_loc, empty])
                v_loc = torch.cat([v_loc, v_loc.new_zeros(
                    (empty.numel(), bk, bn))])
                if quant:
                    s_loc = torch.cat([s_loc, torch.full(
                        (empty.numel(),), zs, dtype=s_loc.dtype,
                        device=dev)])
            order = torch.argsort(n_loc * KB_s + k_loc)    # keys unique
            row.append((v_loc[order],
                        torch.stack([k_loc[order], n_loc[order]])
                        .to(torch.int32),
                        s_loc[order] if quant else None))
        packs.append(row)
    # 3) shared-nnz padding and stacking, as pack_weight
    nnz = max(p[0].shape[0] for row in packs for p in row)
    packs = [[pack.pad_block_list(*p, nnz) for p in row] for row in packs]

    def stack(j):
        a = torch.stack([torch.stack([p[j] for p in row]) for row in packs])
        a = a[:, 0] if tp == 1 else a
        return a if stacked else a[0]

    bias = pw.bias
    if bias is not None:
        if pw.shards > 1 and pw.shard_kind == "col":
            bias = bias.reshape(tuple(bias.shape[:-2]) + (-1,))
        if tp > 1 and kind == "col":
            bias = bias.reshape(tuple(bias.shape[:-1]) + (tp, N // tp))
        bias = bias.contiguous()
    return PackedSASPWeight(stack(0), stack(1), (K, N), (bk, bn),
                            scale=stack(2) if quant else None, bias=bias,
                            act=pw.act, shards=tp,
                            shard_kind=kind if tp > 1 else None)


_FFN_FIELDS = ("w1v", "w3v", "w2v", "b1", "b3", "jv")
_FFN_SCALES = ("s1", "s3", "s2")


def _reshard_ffn(pf: PackedFFN, tp: int) -> PackedFFN:
    """Slice and pad the fused FFN's schedule to ``tp`` d_ff shards by its
    global visit indices ``jv`` (no dense rebuild; equal to ``pack_ffn``
    on the sliced weights)."""
    assert pf.held == pf.shards, "reshard a whole container, not a rank's"
    assert pf.jv is not None, "container has no jv visit indices"
    d, bf = pf.d_model, pf.block_f
    FB = pf.d_ff // bf
    assert tp == 1 or FB % tp == 0, (pf.d_ff, bf, tp)
    quant = pf.s1 is not None
    names = _FFN_FIELDS + (_FFN_SCALES if quant else ())
    stacked = pf.w1v.ndim == 3 + (2 if pf.shards > 1 else 1)

    def norm(a):
        a = a if stacked else a[None]
        return a if pf.shards > 1 else a[:, None]

    A = {n: norm(getattr(pf, n)) for n in names}
    L = A["w1v"].shape[0]
    zs = _zero_block_scale()

    def zero_visit():
        z = {n: A[n].new_zeros((1,) + tuple(A[n].shape[3:]))
             for n in names}
        z["jv"] = torch.full_like(z["jv"], -1)
        for n in _FFN_SCALES if quant else ():
            z[n] = torch.full_like(z[n], zs)
        return z

    FBs = FB // tp
    packs = []                              # [L][tp] dicts
    for li in range(L):
        parts = {n: [] for n in names}
        for s in range(pf.shards):
            live = A["jv"][li, s] >= 0
            for n in names:
                parts[n].append(A[n][li, s][live])
        cat = {n: torch.cat(parts[n]) for n in names}
        order = torch.sort(cat["jv"], stable=True).indices
        cat = {n: a[order] for n, a in cat.items()}
        row = []
        for s in range(tp):
            sel = (cat["jv"] >= s * FBs) & (cat["jv"] < (s + 1) * FBs)
            # an all-pruned shard gets one zero visit: its partial is 0
            row.append({n: a[sel] for n, a in cat.items()}
                       if bool(sel.any()) else zero_visit())
        packs.append(row)
    nv = max(p["jv"].shape[0] for row in packs for p in row)

    def pad(p):
        n_pad = nv - p["jv"].shape[0]
        if not n_pad:
            return p
        out = {n: torch.cat([a, a.new_zeros((n_pad,) + tuple(a.shape[1:]))])
               for n, a in p.items()}
        out["jv"][-n_pad:] = -1
        return out

    packs = [[pad(p) for p in row] for row in packs]

    def stack(n):
        a = torch.stack([torch.stack([p[n] for p in row]) for row in packs])
        a = a[:, 0] if tp == 1 else a
        return a if stacked else a[0]

    return PackedFFN(
        stack("w1v"), stack("w3v"), stack("w2v"), stack("b1"), stack("b3"),
        pf.b2, d_model=d, d_ff=pf.d_ff, block_f=bf, act=pf.act,
        s1=stack("s1") if quant else None,
        s3=stack("s3") if quant else None,
        s2=stack("s2") if quant else None, shards=tp, jv=stack("jv"))


def reshard_packed(params: Params, cfg: ModelConfig, *, mesh=None,
                   tp: Optional[int] = None) -> Params:
    """Re-partition every packed container to ``tp`` shards (or the
    'model' axis of ``mesh``) by slicing and re-padding the existing
    visit lists, from any current shard count, on the containers' device:
    no dense rebuild, no mask recovery. Equal array for array to
    ``deploy_packed(pruned, cfg, tp=tp)`` of the same weights; a group
    whose block grid (or, for attention, head count) does not divide
    stays unsharded, by ``deploy_packed``'s rules."""
    tp = _mesh_tp(mesh, tp)

    def fits(pw: PackedSASPWeight, kind: str) -> bool:
        K, N = pw.shape
        bk, bn = pw.block
        return _shard_blocks(kind, K, N, bk, bn) % tp == 0

    def group(grp, kinds, tp_g):
        if not all(fits(w, kinds.get(n, "col")) for n, w in grp.items()):
            tp_g = 1
        return {n: _reshard_weight(w, tp_g, kinds.get(n, "col"))
                for n, w in grp.items()}

    if "segments" not in params:
        raise ValueError("reshard_packed expects a deployed param tree "
                         "with a 'segments' entry (see deploy_packed)")
    out = dict(params)
    segs = []
    for seg in params["segments"]:
        new_seg = {}
        for slot_name, slot in seg.items():
            slot = dict(slot)
            ffn = slot.get("ffn")
            if isinstance(ffn, dict):
                ffn = dict(ffn)
                pf = ffn.get("sasp_fused")
                if isinstance(pf, PackedFFN):
                    ffn["sasp_fused"] = _reshard_ffn(
                        pf, _fused_tp(pf.d_ff, pf.block_f, tp))
                if isinstance(ffn.get("sasp_packed"), dict):
                    ffn["sasp_packed"] = group(ffn["sasp_packed"],
                                               _FFN_KINDS, tp)
                slot["ffn"] = ffn
            mixer = slot.get("mixer")
            if isinstance(mixer, dict) and isinstance(
                    mixer.get("sasp_packed"), dict):
                mixer = dict(mixer)
                mixer["sasp_packed"] = group(mixer["sasp_packed"],
                                             _ATTN_KINDS, _attn_tp(cfg, tp))
                slot["mixer"] = mixer
            new_seg[slot_name] = slot
        segs.append(new_seg)
    out["segments"] = tuple(segs)
    return out


def packed_summary(params: Params) -> Dict[str, float]:
    """Deployment report: container counts + compression vs dense fp32
    (a sharded container stands for one dense matrix, a rank's local
    container for its 1/tp of one)."""
    n_packed = n_fused = 0
    packed_bytes = dense_bytes = 0

    def visit(node):
        nonlocal n_packed, n_fused, packed_bytes, dense_bytes
        if isinstance(node, PackedSASPWeight):
            n_packed += 1
            packed_bytes += node.nbytes()
            K, N = node.shape
            lead = node.vals.shape[:-3]
            dense_bytes += int(np.prod(lead, dtype=np.int64)) \
                * K * N * 4 // node.shards
        elif isinstance(node, PackedFFN):
            n_fused += 1
            for a in (node.w1v, node.w3v, node.w2v):
                packed_bytes += a.numel() * a.element_size()
            lead = node.w1v.shape[:-3]
            dense_bytes += int(np.prod(lead, dtype=np.int64)) \
                * 3 * node.d_model * node.d_ff * 4 // node.shards
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
