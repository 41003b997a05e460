"""Sharding rules of the port (``repro.distribution.sharding``): which
slice of each leaf a TP rank holds, and rank r's local tree.

Rules are the reference's attention rules (path pattern -> spec,
Megatron layout): wq/wk/wv col-sharded (output dim over 'model'), their
biases with them, wo row-sharded (input dim; its bias whole, added after
the reduction), norms replicated; a dim that does not divide the axis
stays whole. The FFN serves a mesh packed only, so its shards are its
containers'. A spec here is a tuple with one entry per dim: an
axis name or None. Packed containers shard along their shard axis
(``axis_at``): a rank holds one shard-local visit list of each.

Placement differs from the reference, the math does not. The reference
leaves activations and caches to GSPMD (``cache_shardings`` puts a
cache's capacity axis over 'model'). PyTorch has no GSPMD: each rank
here runs attention over its own heads — ``local_config`` gives it
``num_heads / tp`` query and ``num_kv_heads / tp`` KV heads, so its
caches and page pool hold only those heads and attention needs no
collective; the collectives are the reductions of the row-sharded
projections and the fused FFN's d_ff shards, and the vocab-sharded
embedding and head: the reference's ``vocab`` rule puts the table's rows
over 'model' (``cfg.vocab_shards``, ``vocab_config``), each rank gathers
the ids in its rows and the ranks' rows are summed, and each rank's
logits over its rows are all-gathered in vocab order (``models.lm``).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import MIXER_ATTN, ModelConfig
from repro_torch.core.sparse import PackedSASPWeight

Spec = Tuple[Optional[str], ...]
Params = Dict[str, Any]


def _maybe(dim: int, sizes: Dict[str, int], axis: str) -> Optional[str]:
    """``axis`` where it divides ``dim``, else None (replicate)."""
    return axis if dim % sizes.get(axis, 1) == 0 else None


def param_rules():
    """(regex on the leaf's path, spec builder fn(shape, sizes)); the
    first match wins. ``sizes`` maps axis names to their sizes. The
    reference's vocab and attention rules: the rest of a rank's tree is
    packed containers (``packed_sharding``) or replicated. Its expert,
    shared-FFN and SSM rules come with the slice that shards those leaves
    (ROADMAP Queue 1 item 6f)."""
    def col(shape, sizes):     # (..., d_in, d_out): d_out over 'model'
        return (None,) * (len(shape) - 1) + (
            _maybe(shape[-1], sizes, "model"),)

    def row(shape, sizes):     # (..., d_in, d_out): d_in over 'model'
        return (None,) * (len(shape) - 2) + (
            _maybe(shape[-2], sizes, "model"), None)

    def vocab(shape, sizes):   # (V, d) embedding / head table
        return (_maybe(shape[-2], sizes, "model"), None)

    def repl(shape, sizes):
        return (None,) * len(shape)

    return [
        (r"(embed|lm_head)/emb$", vocab),
        (r"mixer/(wq|wk|wv)/(w|b)$", col),
        (r"mixer/wo/w$", row),
        (r".*", repl),
    ]


def spec_for_param(path: Tuple, shape: Tuple[int, ...],
                   sizes: Dict[str, int]) -> Spec:
    """The spec of the leaf at ``path`` (keys joined by '/')."""
    s = "/".join(str(k) for k in path)
    for pat, fn in param_rules():
        if re.search(pat, s):
            return tuple(fn(shape, sizes))
    return (None,) * len(shape)


def vocab_config(cfg: ModelConfig, tp: int) -> ModelConfig:
    """``cfg`` with the vocab split of a TP deployment at ``tp``: the
    table's rows in ``tp`` shards where the ``vocab`` rule shards them
    (V divides), else whole. A meshless shard loop serving a tree packed
    at ``tp`` computes the head shard by shard, as the mesh's ranks do."""
    spec = spec_for_param(("embed", "emb"), (cfg.vocab_size, cfg.d_model),
                          {"model": tp})
    return dataclasses.replace(
        cfg, vocab_shards=tp if tp > 1 and spec[0] == "model" else 1)


def axis_at(rank: int, from_end: int, axis: str) -> Spec:
    """A spec with ``axis`` at dim rank - from_end, None elsewhere: the
    shard axis of a packed container sits ``from_end`` dims from the
    end."""
    spec = [None] * rank
    spec[rank - from_end] = axis
    return tuple(spec)


# shard-axis position (dims from the end) of each array field
_WEIGHT_AXES = {"vals": 4, "kn": 3, "scale": 2, "col_ptr": 2}
_FFN_AXES = {"w1v": 4, "w3v": 4, "w2v": 4, "b1": 3, "b3": 3, "s1": 2,
             "s3": 2, "s2": 2, "jv": 2}


def packed_sharding(node) -> Dict[str, Spec]:
    """Spec of every array field of a packed container: its shard axis
    over 'model' (a col shard's bias with it; a row shard's bias and a
    PackedFFN's b2 whole). An unsharded container is replicated."""
    axes = dict(_WEIGHT_AXES if isinstance(node, PackedSASPWeight)
                else _FFN_AXES)
    if isinstance(node, PackedSASPWeight) and node.shard_kind == "col":
        axes["bias"] = 2
    out = {}
    for f in dataclasses.fields(node):
        a = getattr(node, f.name)
        if not isinstance(a, torch.Tensor):
            continue
        out[f.name] = (axis_at(a.ndim, axes[f.name], "model")
                       if node.shards > 1 and f.name in axes
                       else (None,) * a.ndim)
    return out


def take_slice(t: torch.Tensor, spec: Spec, rank: int, tp: int
               ) -> torch.Tensor:
    """Model rank ``rank``'s slice of ``t`` under ``spec`` (a copy, so
    the whole leaf can be freed)."""
    for dim, ax in enumerate(spec):
        if ax == "model":
            n = t.shape[dim] // tp
            t = t.narrow(dim, rank * n, n)
    return t.contiguous().clone()


def _local_container(node, rank: Optional[int], tp: int):
    if node.shards != tp:
        raise ValueError(
            f"a container with {node.shards} shards on a mesh of model "
            f"size {tp}: reshard_packed it to {tp} first")
    if rank is None:
        return node
    return dataclasses.replace(node, **{
        f: take_slice(getattr(node, f), spec, rank, tp)
        for f, spec in packed_sharding(node).items()})


# the reference's placement profiles: "tp" runs data parallelism over the
# 'data' axis and TP over 'model'; "dp_only" runs it over every axis
PROFILES = ("tp", "dp_only")


def dp_size(shape: Dict[str, int], profile: str = "tp") -> int:
    """The number of DP ranks of a ``{"data": dp, "model": tp}`` mesh
    under ``profile``: the 'data' axis, or every axis (``dp_only``)."""
    if profile not in PROFILES:
        raise ValueError(f"profile={profile!r} not in {PROFILES}")
    return shape["data"] * (shape["model"] if profile == "dp_only" else 1)


def dp_mesh(mesh, profile: str = "tp"):
    """``mesh`` (``distribution.context.Mesh``) as the grid of
    ``profile``'s DP ranks: its 'data' axis the DP ranks, its 'model'
    axis each rank's TP group (``mesh`` itself, or ``mesh.flat()`` under
    ``dp_only``)."""
    return mesh.flat() if dp_size(mesh.shape, profile) > mesh.shape["data"] \
        else mesh


def dp_submeshes(mesh, profile: str = "tp") -> List[Tuple[int, Tuple[int,
                                                                   ...]]]:
    """One entry per DP rank, a scheduler rank each (the reference's
    ``dp_submeshes``): its data index and the world ranks of its
    processes, one TP group."""
    tp = mesh.shape["model"] if profile == "tp" else 1
    return [(d, tuple(range(d * tp, (d + 1) * tp)))
            for d in range(dp_size(mesh.shape, profile))]


def local_config(cfg: ModelConfig, tp: int) -> ModelConfig:
    """The config a model rank serves with: ``num_heads / tp`` query and
    ``num_kv_heads / tp`` KV heads (head_dim pinned), so its attention
    and its caches hold its own heads."""
    if cfg.num_heads % tp or cfg.num_kv_heads % tp:
        raise ValueError(f"heads {cfg.num_heads}/{cfg.num_kv_heads} do "
                         f"not split over {tp} model ranks")
    return dataclasses.replace(cfg, num_heads=cfg.num_heads // tp,
                               num_kv_heads=cfg.num_kv_heads // tp,
                               head_dim=cfg.attn_head_dim)


def _local_group(node: Params, group: str, names, rank: Optional[int],
                 tp: int, what: str) -> Params:
    """A mixer / FFN dict with its packed group localised and the dense
    matrices it replaces dropped."""
    grp = node[group]
    if isinstance(grp, dict):
        shards = {w.shards for w in grp.values()}
        local = {n: _local_container(w, rank, tp) if w.shards > 1 else w
                 for n, w in grp.items()}
    else:
        shards = {grp.shards}
        local = _local_container(grp, rank, tp) if grp.shards > 1 else grp
    if what == "attention" and shards != {tp}:
        raise ValueError(
            f"attention projections packed with {shards} shards on a mesh "
            f"of model size {tp}: their block grid must split into {tp}")
    out = {k: v for k, v in node.items() if k not in names}
    out[group] = local
    return out


def local_params(params: Params, cfg: ModelConfig, tp: int,
                 rank: Optional[int]) -> Params:
    """Model rank ``rank``'s tree of a packed deployment at ``tp``
    (``deploy_packed(..., tp=tp)`` or ``reshard_packed``): each sharded
    container keeps only shard ``rank`` (its shard axis at length 1),
    the dense matrices a container replaces are dropped, the other dense
    attention leaves are sliced by ``param_rules`` (scope ffn: wq/wk/wv
    by columns, wo by rows), the embedding and head table keeps the
    rank's V/tp rows where ``cfg.vocab_shards`` is tp (``vocab_config``),
    and the norms stay whole. Serve it with ``local_config(cfg, tp)``.
    ``rank`` None keeps every shard and the whole table (the shard loop's
    tree without the dense matrices)."""
    if cfg.moe is not None or any(k != MIXER_ATTN
                                  for k in cfg.layer_mixer_kinds()):
        raise ValueError(
            "MoE and SSM layers on a mesh (distribution/moe_ep.py, the "
            "SSD mesh pins) are not ported: ROADMAP Queue 1 item 6f")
    if tp > 1 and cfg.vocab_shards != vocab_config(cfg, tp).vocab_shards:
        raise ValueError(
            f"cfg.vocab_shards {cfg.vocab_shards} is not the vocab split at "
            f"tp={tp}: serve a config from deploy_packed(tp=) or "
            f"vocab_config")
    sizes = {"model": tp}
    segs = []
    for si, seg in enumerate(params["segments"]):
        new_seg = {}
        for name, slot in seg.items():
            slot = dict(slot)
            mixer, ffn = slot["mixer"], slot["ffn"]
            if "sasp_packed" in mixer:
                mixer = _local_group(mixer, "sasp_packed",
                                     ("wq", "wk", "wv", "wo"), rank, tp,
                                     "attention")
            else:
                mixer = {k: _slice_tree(v, ("segments", si, name, "mixer",
                                            k), sizes, rank, tp)
                         for k, v in mixer.items()}
            if "sasp_fused" in ffn:
                ffn = _local_group(ffn, "sasp_fused", ("w1", "w2", "w3"),
                                   rank, tp, "ffn")
            elif "sasp_packed" in ffn:
                ffn = _local_group(ffn, "sasp_packed", ("w1", "w2", "w3"),
                                   rank, tp, "ffn")
            else:
                raise ValueError(
                    "a dense FFN on a mesh (the reference's "
                    "_ffn_tp_rs_ag_int8) is not ported: ROADMAP Queue 1 "
                    "item 6e; serve --path packed")
            slot["mixer"], slot["ffn"] = mixer, ffn
            new_seg[name] = slot
        segs.append(new_seg)
    out = dict(params)
    out["segments"] = tuple(segs)
    if cfg.vocab_shards > 1:
        for top in ("embed", "lm_head"):
            if top in params:
                out[top] = _slice_tree(params[top], (top,), sizes, rank, tp)
    return out


def _slice_tree(node, path, sizes, rank, tp):
    if rank is None:
        return node
    if isinstance(node, dict):
        return {k: _slice_tree(v, path + (k,), sizes, rank, tp)
                for k, v in node.items()}
    if isinstance(node, torch.Tensor):
        return take_slice(node, spec_for_param(path, tuple(node.shape),
                                               sizes), rank, tp)
    return node
