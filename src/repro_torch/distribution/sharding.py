"""Sharding rules of the port (``repro.distribution.sharding``): which
slice of each leaf a TP rank holds, and rank r's local tree.

Rules are the reference's (path pattern -> spec, Megatron layout):
wq/wk/wv col-sharded (output dim over 'model'), their biases with them,
wo row-sharded (input dim; its bias whole, added after the reduction);
the dense FFN's w1/w3 col and w2 row; a ``BlockSparseWeight`` of the
bsr / kernel paths by its column blocks (``vals`` (L, k_max, NB, bk,
bn), ``idx`` and ``scale`` (L, k_max, NB): NB over 'model'); the
embedding / head table by rows; everything else replicated, by the
reference's fall-through ``.*`` rule. That includes the int8 ``qw``
leaves of the masked int8 path: every rank holds and multiplies the
whole int8 FFN, as under the reference's GSPMD. A dim that does not
divide the axis stays whole. A spec here is a tuple with one entry per
dim: an axis name or None. Packed containers shard along their shard
axis (``axis_at``): a rank holds one shard-local visit list of each.
No rule names 'pod' (nor do the reference's): on a ``(pod, data,
model)`` mesh every pod holds the same slices, and data parallelism runs
over ``dp_axes`` ('pod' and 'data').

MoE and SSM layers (``distribution.moe_ep``, ``models.ssm``): an expert
stack (L, E, din, dout) puts E over 'data' (expert parallelism, data
rank d holding experts [d E/ep, (d+1) E/ep) where ``ep`` > 1) and d_ff
over 'model' (the reference's ``expert_col`` / ``expert_row``); the
router stays whole; the shared experts are a dense FFN, col / row. The
rule of an FFN's w1/w2/w3 is chosen by the slot's FFN kind (a router
makes it an expert stack), not by the tensor's rank: the reference maps
a jamba dense-FFN slot onto ``expert_col`` by rank (``_rerank``), which
in the port's layer-stacked trees would split a dense (L, d, f) stack's
layer axis over 'data'. A Mamba-2 mixer splits by heads: in_z, in_dt
col, out_proj row, the (H,) and (d_inner,) vectors with the heads (the
reference replicates dt_bias, A_log and D), and in_xbc / conv_w / conv_b
by their x channels with B and C whole on every rank (``models.ssm.
xbc_shard``; the reference's ``col`` rule shards all of conv_dim, which
only GSPMD can honour).

Caches (``seq_axes``, the reference's ``cache_shardings``): where an
engine's batch splits over 'data' each data rank holds its slots' rows;
where it does not (B = 1, or B not divisible), the sequence-parallel
long-context layout cuts each KV ring's capacity over ``("data",
"model")`` where every model rank runs every head and D x T divides it,
else over 'data' where D divides it, else not at all (``seq_config``
gives a rank's config its place, ``ring_cut`` each ring's blocks). Where
the KV heads split over 'model' they stay there and only 'data' cuts
the capacity: C / D x KH / T a rank, the reference's C / (D T) x KH in
bytes, with no gather of q; where the batch splits, the reference cuts
the capacity over 'model' and the port the KV heads. SSM states keep
their heads over 'model' and are never cut by sequence.

Placement differs from the reference, the math does not. The reference
leaves activations and caches to GSPMD. PyTorch has no GSPMD: each rank
here runs attention over its own heads — ``local_config`` gives it
``num_heads / tp`` query and ``num_kv_heads / tp`` KV heads, and
``H / tp`` SSM heads, so its caches and page pool hold only those heads
and attention needs no collective. Where the head counts do not divide
'model' (``heads_split``), a rank holds every head, as the reference
pins SDPA replicated over 'model': its caches hold every KV head, its
q / k / v column slices are all-gathered and the whole core runs on
every rank, which then takes its rows' slice of the core's output into
wo's row shard. The other collectives are the reductions of
the row-sharded projections (wo, the dense FFN's w2, out_proj), the
fused FFN's d_ff shards and the experts' w2, the SSM's gated-norm
squares, the all-gather of a BSR matrix's output columns, the experts'
all-to-alls over 'data', and the vocab-sharded embedding and head: the
reference's ``vocab`` rule puts the table's rows over 'model'
(``cfg.vocab_shards``, ``vocab_config``), each rank gathers the ids in
its rows and the ranks' rows are summed, and each rank's logits over its
rows are all-gathered in vocab order (``models.lm``). A TP deployment's
config (``tp_config``) carries the shard counts, so that the meshless
shard loop runs the same shards in one process.

The paged KV pool (``pool_axes``, the reference's ``pool_shardings``):
its page axis over the DP axes where they divide it, its KV heads over
'model'; ``serve.engine`` serves such a pool with each data rank's
slots on its own block of pages (``pool_blocks``).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import MIXER_ATTN, ModelConfig
from repro_torch.core.sparse import BlockSparseWeight, PackedSASPWeight

Spec = Tuple[Optional[str], ...]
Params = Dict[str, Any]


def _maybe(dim: int, sizes: Dict[str, int], axis: str) -> Optional[str]:
    """``axis`` where it divides ``dim``, else None (replicate)."""
    return axis if dim % sizes.get(axis, 1) == 0 else None


def param_rules(expert: bool = False):
    """(regex on the leaf's path, spec builder fn(shape, sizes)); the
    first match wins. ``sizes`` maps axis names to their sizes; ``expert``
    picks the expert-stack rules for an FFN's w1/w2/w3 (a MoE slot). The
    reference's BSR, vocab, attention, dense-FFN, expert, shared-FFN and
    SSM rules; packed containers shard by ``packed_sharding``."""
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

    def bsr_vals(shape, sizes):   # (..., k_max, NB, bk, bn)
        return (None,) * (len(shape) - 3) + (
            _maybe(shape[-3], sizes, "model"), None, None)

    def bsr_idx(shape, sizes):    # (..., k_max, NB) idx / scale
        return (None,) * (len(shape) - 1) + (
            _maybe(shape[-1], sizes, "model"),)

    def expert_col(shape, sizes):  # (..., E, d_in, d_out)
        return (None,) * (len(shape) - 3) + (
            _maybe(shape[-3], sizes, "data"), None,
            _maybe(shape[-1], sizes, "model"))

    def expert_row(shape, sizes):
        return (None,) * (len(shape) - 3) + (
            _maybe(shape[-3], sizes, "data"),
            _maybe(shape[-2], sizes, "model"), None)

    ffn13, ffn2 = (expert_col, expert_row) if expert else (col, row)
    return [
        (r"sasp_bsr/w\d/vals$", bsr_vals),
        (r"sasp_bsr/w\d/(idx|scale)$", bsr_idx),
        (r"sasp_bsr/", repl),
        (r"(embed|lm_head)/emb$", vocab),
        (r"mixer/(wq|wk|wv)/(w|b)$", col),
        (r"mixer/wo/w$", row),
        (r"ffn/router/w$", repl),
        (r"ffn/shared/w(1|3)/w$", col),
        (r"ffn/shared/w2/w$", row),
        (r"ffn/w(1|3)/w$", ffn13),
        (r"ffn/w2/w$", ffn2),
        (r"ffn/sasp_masks/w(1|3)$", ffn13),
        (r"ffn/sasp_masks/w2$", ffn2),
        # mamba: x channels and heads over 'model' (in_xbc / conv split
        # [x | B | C] by xbc_shard)
        (r"mixer/(in_z|in_xbc|in_dt)/w$", col),
        (r"mixer/(conv_w|conv_b|norm|A_log|D|dt_bias)$", col),
        (r"mixer/out_proj/w$", row),
        (r".*", repl),
    ]


_XBC = re.compile(r"mixer/(in_xbc/w|conv_w|conv_b)$")


def spec_for_param(path: Tuple, shape: Tuple[int, ...],
                   sizes: Dict[str, int], expert: bool = False) -> Spec:
    """The spec of the leaf at ``path`` (keys joined by '/'); ``expert``:
    the leaf is in a MoE slot's FFN."""
    s = "/".join(str(k) for k in path)
    for pat, fn in param_rules(expert):
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


def tp_config(cfg: ModelConfig, tp: int, ep: int = 1) -> ModelConfig:
    """``cfg`` of a TP deployment at ``tp``: the vocab split
    (``vocab_config``), ``tp_shards``, the shard count of the dense and
    BSR matrices, the experts' d_ff and the SSM heads, which a mesh rank
    holds one of and the shard loop runs one after another, and
    ``ep_shards``, the expert stacks' shards over 'data' (1 for a
    config without experts)."""
    return dataclasses.replace(vocab_config(cfg, tp), tp_shards=int(tp),
                               ep_shards=int(ep) if cfg.moe else 1)


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


def take_slice(t: torch.Tensor, spec: Spec, rank: int, tp: int,
               data_rank: int = 0, ep: int = 1) -> torch.Tensor:
    """Model rank ``rank``'s (and data rank ``data_rank``'s, of ``ep``)
    slice of ``t`` under ``spec`` (a copy, so the whole leaf can be
    freed)."""
    for dim, ax in enumerate(spec):
        if ax in ("model", "data"):
            r, n = (rank, tp) if ax == "model" else (data_rank, ep)
            k = t.shape[dim] // n
            t = t.narrow(dim, r * k, k)
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
# DP axes ('pod' and 'data') and TP over 'model'; "dp_only" runs it over
# every axis
PROFILES = ("tp", "dp_only")

SERVE_POD = (
    "serving on a (pod, data, model) mesh is not ported: the reference's "
    "serve CLI builds (data, model) meshes only; train on pods "
    "(launch/train.py --mesh P,D,T), serve with --mesh DP,TP")


def dp_axes(shape: Dict[str, int], profile: str = "tp") -> Tuple[str, ...]:
    """The reference's ``dp_axes``: the axes of a mesh ``shape`` that
    data parallelism runs over, in mesh order: 'pod' and 'data', or
    every axis (``dp_only``)."""
    if profile not in PROFILES:
        raise ValueError(f"profile={profile!r} not in {PROFILES}")
    if profile == "dp_only":
        return tuple(shape)
    return tuple(a for a in shape if a in ("pod", "data"))


def dp_size(shape: Dict[str, int], profile: str = "tp") -> int:
    """The number of DP ranks of a ``{["pod": P,] "data": dp, "model":
    tp}`` mesh under ``profile``: the product of its ``dp_axes``."""
    n = 1
    for a in dp_axes(shape, profile):
        n *= shape[a]
    return n


def dp_mesh(mesh, profile: str = "tp"):
    """``mesh`` (``distribution.context.Mesh``) as the grid of
    ``profile``'s DP ranks: its 'data' axis the DP ranks, its 'model'
    axis each rank's TP group (``mesh`` itself, or ``mesh.flat()`` under
    ``dp_only``). A mesh of pods under "tp" has no such view here
    (``SERVE_POD``)."""
    if profile == "tp" and mesh.shape.get("pod", 1) > 1:
        raise ValueError(SERVE_POD)
    return mesh.flat() if dp_size(mesh.shape, profile) > mesh.shape["data"] \
        else mesh


def dp_submeshes(mesh, profile: str = "tp") -> List[Tuple[int, Tuple[int,
                                                                   ...]]]:
    """One entry per DP rank, a scheduler rank each (the reference's
    ``dp_submeshes``, which collapses every DP axis): its index over the
    DP axes (pod-major) and the world ranks of its processes, one TP
    group."""
    tp = mesh.shape["model"] if profile == "tp" else 1
    return [(d, tuple(range(d * tp, (d + 1) * tp)))
            for d in range(dp_size(mesh.shape, profile))]


def heads_split(cfg: ModelConfig, tp: int) -> bool:
    """Do the attention heads split over ``tp`` model ranks (query and KV
    head counts both divisible)? Where they do not, every model rank runs
    the attention core on every head, as the reference pins SDPA
    replicated over 'model' (``models/attention.py``); the projections
    still split wherever the axis divides their dim (``param_rules``)."""
    return tp <= 1 or (cfg.num_heads % tp == 0
                       and cfg.num_kv_heads % tp == 0)


def local_config(cfg: ModelConfig, tp: int) -> ModelConfig:
    """The config a model rank serves with: ``num_heads / tp`` query and
    ``num_kv_heads / tp`` KV heads (head_dim pinned) where the heads
    split (``heads_split``), else every head with ``heads_replicated``
    (its caches hold every KV head, its attention core runs every head),
    and ``H / tp`` SSM heads (``ssm.head_shards``), so its attention, its
    SSM and their caches hold its own heads."""
    if heads_split(cfg, tp):
        out = dataclasses.replace(cfg, num_heads=cfg.num_heads // tp,
                                  num_kv_heads=cfg.num_kv_heads // tp,
                                  head_dim=cfg.attn_head_dim)
    else:
        out = dataclasses.replace(cfg, head_dim=cfg.attn_head_dim,
                                  heads_replicated=True)
    if tp > 1 and _has_ssm(cfg):
        from repro_torch.models.ssm import local_ssm
        out = local_ssm(out, tp)
    return out


def _has_ssm(cfg: ModelConfig) -> bool:
    return any(k != MIXER_ATTN for k in cfg.layer_mixer_kinds())


def seq_axes(cfg: ModelConfig, mesh, batch: int, capacity: int
             ) -> Tuple[str, ...]:
    """The axes that cut a KV ring's capacity (the reference's
    ``cache_shardings``, the sequence-parallel long-context layout):
    none where the batch splits over the DP ranks (B divides, B > 1);
    else, where every model rank runs every head, ``("data", "model")``
    when ``capacity`` divides by D x T, else ``("data",)`` when it
    divides by D, else none (the reference's ``_fits`` fall-through);
    where the KV heads split over 'model' they stay there and only
    ``("data",)`` may cut (a rank holds C / D x KH / T, the reference's
    C / (D T) x KH in bytes). ``mesh``: a rank's ``Mesh`` (``cfg`` its
    local config, ``heads_replicated`` saying whether its heads split),
    or a ``{"data": D, "model": T}`` shape (``cfg`` the shard loop's
    config, whose heads split where they divide T)."""
    shape = mesh if isinstance(mesh, dict) else mesh.shape
    D, T = shape.get("data", 1), shape.get("model", 1)
    if batch > 1 and batch % dp_size(shape) == 0:
        return ()
    rep = (cfg.heads_replicated if not isinstance(mesh, dict)
           else not heads_split(cfg, T))
    if rep and capacity % (D * T) == 0:
        return ("data", "model")
    if capacity % D == 0:
        return ("data",)
    return ()


def seq_config(cfg: ModelConfig, mesh, batch: int, cache_len: int
               ) -> ModelConfig:
    """``cfg`` with the sequence-parallel layout of an engine of ``batch``
    rows and ``cache_len`` on ``mesh`` (a rank's ``Mesh``, or a shape:
    the meshless twin, ``seq_index`` -1), or ``cfg`` itself where the
    batch splits over the DP ranks or no axis of two or more ranks could
    cut a ring (``seq_axes``). Each ring is then cut by its own capacity
    (``ring_cut``)."""
    shape = mesh if isinstance(mesh, dict) else mesh.shape
    D, T = shape.get("data", 1), shape.get("model", 1)
    axes = seq_axes(cfg, mesh, batch, D * T)
    Ts = T if "model" in axes else 1
    if not axes or D * Ts == 1:
        return cfg
    index = -1 if isinstance(mesh, dict) else (
        mesh.data_rank * Ts + (mesh.model_rank if Ts > 1 else 0))
    return dataclasses.replace(cfg, seq_cache_len=int(cache_len),
                               seq_mesh=(D, Ts), seq_index=index)


def ring_cut(cfg: ModelConfig, capacity: int):
    """The cut of a ring of ``capacity`` slots under ``cfg``'s sequence
    layout (``seq_config``): an ``attention.RingCut`` of its blocks and
    this rank's (every block, the meshless twin), or None where no axis
    divides it and the ring stays whole."""
    if not cfg.seq_cache_len:
        return None
    from repro_torch.models.attention import RingCut
    D, T = cfg.seq_mesh
    axes = seq_axes(cfg, {"data": D, "model": T}, 1, capacity)
    n = D * (T if "model" in axes else 1) if axes else 1
    if n == 1:
        return None
    index = None if cfg.seq_index < 0 else (
        cfg.seq_index if "model" in axes else cfg.seq_index // T)
    return RingCut(int(capacity), n, index, axes)


def pool_axes(mesh, shape: Tuple[int, ...]) -> Tuple:
    """The reference's ``pool_shardings`` as a rule: the axes of each dim
    of a paged KV pool leaf ``(R, P, page_len, …)``. The physical page
    dim P goes over the DP axes (``dp_axes``, a tuple) when they hold
    two ranks or more and divide it; the KV-head dim (3, on k/v/scale
    leaves) over 'model' when it divides. ``mesh``: a ``Mesh`` or a
    ``{"data": D, "model": T}`` shape. On a scheduler rank's submesh DP
    collapses to 1, so the pool stays whole there."""
    sizes = mesh if isinstance(mesh, dict) else mesh.shape
    dp = dp_axes(sizes)
    spec: List = [None] * len(shape)
    n = dp_size(sizes)
    if n > 1 and shape[1] % n == 0:
        spec[1] = dp
    if len(shape) >= 4 and shape[3] % sizes.get("model", 1) == 0:
        spec[3] = "model"
    return tuple(spec)


def pool_blocks(mesh, pages: int) -> int:
    """How many blocks ``pool_axes`` cuts a pool of ``pages`` physical
    pages into over the DP axes: their size, or 1 (whole)."""
    if mesh is None:
        return 1
    sizes = mesh if isinstance(mesh, dict) else mesh.shape
    return dp_size(sizes) if pool_axes(sizes, (1, pages))[1] else 1


def check_placement(cfg: ModelConfig, tp: int, ep: int = 1) -> None:
    """Refuse, with a message, a mesh that cannot place ``cfg``: experts
    that do not split over ``ep`` data ranks, an expert d_ff or SSM heads
    that do not split over ``tp`` model ranks (nothing is quietly
    replicated)."""
    from repro_torch.models.ssm import ssm_splits
    if cfg.moe is not None:
        E = cfg.moe.num_experts
        if ep > 1 and E % ep:
            raise ValueError(f"{cfg.name}: {E} experts do not split over "
                             f"{ep} data ranks")
        if tp > 1 and cfg.d_ff % tp:
            raise ValueError(f"{cfg.name}: the experts' d_ff {cfg.d_ff} "
                             f"does not split over {tp} model ranks")
    elif ep > 1:
        raise ValueError(f"{cfg.name} has no experts to split over "
                         f"{ep} data ranks")
    if tp > 1 and _has_ssm(cfg) and not ssm_splits(cfg, tp):
        raise ValueError(
            f"{cfg.name}: {cfg.ssm.num_heads(cfg.d_model)} SSM heads "
            f"(ngroups {cfg.ssm.ngroups}) do not split over {tp} model "
            f"ranks")


def _local_group(node: Params, group: str, names, rank: Optional[int],
                 tp: int, what: str, cfg: ModelConfig) -> Params:
    """A mixer / FFN dict with its packed group localised and the dense
    matrices it replaces dropped (attention's group whole on every rank
    where the heads do not split)."""
    grp = node[group]
    if isinstance(grp, dict):
        shards = {w.shards for w in grp.values()}
        local = {n: _local_container(w, rank, tp) if w.shards > 1 else w
                 for n, w in grp.items()}
    else:
        shards = {grp.shards}
        local = _local_container(grp, rank, tp) if grp.shards > 1 else grp
    if what == "attention" and shards != {tp} and not (
            shards == {1} and not heads_split(cfg, tp)):
        raise ValueError(
            f"attention projections packed with {shards} shards on a mesh "
            f"of model size {tp}: their block grid must split into {tp}")
    out = {k: v for k, v in node.items() if k not in names}
    out[group] = local
    return out


def local_params(params: Params, cfg: ModelConfig, tp: int,
                 rank: Optional[int], ep: int = 1,
                 data_rank: int = 0) -> Params:
    """Model rank ``rank``'s (at data rank ``data_rank`` of ``ep`` expert
    shards) tree of a TP deployment at ``tp``, on any
    serving path: packed (``deploy_packed(..., tp=tp)`` or
    ``reshard_packed``), dense, masked (pruned in place), masked int8 and
    bsr / kernel. Each sharded container keeps only shard ``rank`` (its
    shard axis at length 1); every other leaf is sliced by
    ``param_rules``: wq/wk/wv by columns and wo by rows where attention
    is dense, the dense FFN's w1/w3 by columns and w2 by rows, a
    ``BlockSparseWeight`` by column blocks (its ``shape`` stays the whole
    matrix's), the embedding and head table to the rank's V/tp rows where
    ``cfg.vocab_shards`` is tp (``vocab_config``), an expert stack to the
    data rank's experts and the model rank's d_ff, a Mamba-2 mixer to the
    rank's heads; norms and int8 ``qw`` leaves stay whole. The dense
    matrices a container replaces are
    dropped: a packed group's, and the ``w`` of each matrix a BSR
    container replaces (the reference keeps that ``w`` but never reads
    it). Attention's BSR entries are dropped too: the reference's
    ``_proj`` reads only ``sasp_packed`` or ``w``, so on the bsr and
    kernel paths attention runs the pruned dense weights (so does a
    Mamba-2 mixer). Serve it with
    ``local_config(cfg, tp)``. ``rank`` None keeps every shard and every
    whole leaf (the shard loop's tree without the replaced matrices)."""
    check_placement(cfg, tp, ep)
    if tp > 1 and cfg.vocab_shards != vocab_config(cfg, tp).vocab_shards:
        raise ValueError(
            f"cfg.vocab_shards {cfg.vocab_shards} is not the vocab split at "
            f"tp={tp}: serve a config from a TP deployment (tp_config)")
    sizes = {"model": tp, "data": ep}
    cut = _Cut(cfg, rank, tp, data_rank, ep)
    segs = []
    for si, seg in enumerate(params["segments"]):
        new_seg = {}
        for name, slot in seg.items():
            slot = dict(slot)
            mixer, ffn = slot["mixer"], slot["ffn"]
            if "sasp_packed" in mixer:
                mixer = _local_group(mixer, "sasp_packed",
                                     ("wq", "wk", "wv", "wo"), rank, tp,
                                     "attention", cfg)
            else:
                mixer = {k: v for k, v in mixer.items() if k != "sasp_bsr"}
            if "sasp_fused" in ffn:
                ffn = _local_group(ffn, "sasp_fused", ("w1", "w2", "w3"),
                                   rank, tp, "ffn", cfg)
            elif "sasp_packed" in ffn:
                ffn = _local_group(ffn, "sasp_packed", ("w1", "w2", "w3"),
                                   rank, tp, "ffn", cfg)
            elif "sasp_bsr" in ffn:
                ffn = {k: ({kk: vv for kk, vv in v.items() if kk != "w"}
                           if k in ffn["sasp_bsr"] else v)
                       for k, v in ffn.items()}
            base = ("segments", si, name)
            slot["mixer"] = cut(mixer, base + ("mixer",), sizes, False)
            slot["ffn"] = cut(ffn, base + ("ffn",), sizes, "router" in ffn)
            new_seg[name] = slot
        segs.append(new_seg)
    out = dict(params)
    out["segments"] = tuple(segs)
    if cfg.vocab_shards > 1:
        for top in ("embed", "lm_head"):
            if top in params:
                out[top] = cut(params[top], (top,), sizes, False)
    return out


class _Cut:
    """``cut(node, path, sizes, expert)``: ``node`` with every tensor leaf
    cut to the rank's slice by ``param_rules`` (a BSR container's arrays
    too; an SSM's [x | B | C] leaves by ``xbc_shard``); packed
    containers, localised already, and int8 ``qw`` leaves pass whole."""

    def __init__(self, cfg: ModelConfig, rank, tp, data_rank, ep):
        self.cfg, self.rank, self.tp = cfg, rank, tp
        self.data_rank, self.ep = data_rank, ep

    def __call__(self, node, path, sizes, expert):
        if self.rank is None:
            return node
        if isinstance(node, dict):
            return {k: self(v, path + (k,), sizes, expert)
                    for k, v in node.items()}
        if isinstance(node, BlockSparseWeight):
            return dataclasses.replace(node, **{
                f: self(getattr(node, f), path + (f,), sizes, expert)
                for f in ("vals", "idx", "scale")})
        if not isinstance(node, torch.Tensor):
            return node
        if self.tp > 1 and _XBC.search("/".join(str(k) for k in path)):
            from repro_torch.models.ssm import xbc_shard
            s = self.cfg.ssm
            return xbc_shard(node, self.rank, self.tp,
                             s.d_inner(self.cfg.d_model),
                             s.ngroups * s.state_dim)
        return take_slice(node, spec_for_param(path, tuple(node.shape),
                                               sizes, expert),
                          self.rank, self.tp, self.data_rank, self.ep)
