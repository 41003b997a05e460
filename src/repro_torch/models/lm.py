"""Decoder-only LM of the port (``repro.models.lm``).

Params keep the reference layout: ``segments`` is a tuple following the
segment plan, each ``{"slot<j>": params}`` with a leading layer axis
(the reference's ``lax.scan`` layout); here a Python loop walks the
layers. A layer's mixer is attention or Mamba-2 (``models.ssm``) and its
FFN dense or MoE, as its ``LayerSpec`` says; a MoE layer dispatches as
the reference's ``_moe_dispatch`` does (``distribution.moe_ep.
moe_dispatch``: the dp_only profile, expert parallelism over 'data'
where ``cfg.ep_shards`` > 1, else ``models.moe.moe_ffn_local``). The
full walk sums the MoE aux loss. ``embeds`` replace the token embedding
(the audio / VLM stub frontends). Under an active mesh (``distribution.
context``) the walk is unchanged: the final norm is replicated on every
rank, the embedding and head follow ``cfg.vocab_shards`` (each rank
holds one row shard of the table: its ids gathered and summed over the
ranks, its logits all-gathered), the projections, FFNs, experts and SSM
heads route themselves by their shards (``models.ffn``, ``models.moe``,
``models.ssm``), and a data rank runs its own rows. An expert-parallel
mesh needs every data rank in every MoE call: ``moe_bystander`` walks a
rank with no rows through the MoE layers' collectives alone, and
``prefill_groups`` / ``prefill_with_past_groups`` / ``decode_step_groups``
are the meshless twins that run every data rank's rows in one process,
layer by layer in lock step.
Under the sequence-parallel layout (``cfg.seq_cache_len``) each ring is
cut by its own capacity (``ring_capacity``, ``sharding.ring_cut``):
``init_caches`` sizes a rank's rings at its block, and prefill, the
suffix prefill and decode pass the cut to attention; SSM states stay
whole.

Every layer of every layer-stacked leaf, and every expert of an expert
stack, is drawn from its own generator (``draw_layer``, ``draw_expert``),
so that a rank draws one layer, or its own experts, alone.

Training (``loss_fn``): under autograd each layer repeat runs through
``cfg.remat`` (``none``; ``full``: recomputed in backward; ``dots``:
recomputed except the matmul outputs, which are saved), and the chunked
cross-entropy recomputes each chunk's fp32 logits in backward instead of
keeping them.
"""
from __future__ import annotations

import functools
import math
import zlib
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.utils.checkpoint as torch_ckpt

from repro_torch.distribution import moe_ep

from repro_torch.configs.base import (
    ATTN_LOCAL,
    FFN_MOE,
    MIXER_ATTN,
    ModelConfig,
)
from repro_torch.core.quantization import QuantizedWeight
from repro_torch.core.sparse import (BlockSparseWeight, PackedFFN,
                                     PackedSASPWeight)
from repro_torch.models import attention as attn_mod
from repro_torch.models import ffn as ffn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.modules import (
    as_dtype,
    embedding_apply,
    matmul_f32,
    rmsnorm_apply,
    softcap,
)

LayerSpec = Tuple[int, int, int]            # (mixer, attn_kind, ffn_kind)
Segment = Tuple[Tuple[LayerSpec, ...], int]


def _lcm(a: int, b: int) -> int:
    return a * b // math.gcd(a, b)


def segment_plan(cfg: ModelConfig) -> List[Segment]:
    mixers = cfg.layer_mixer_kinds()
    attns = cfg.layer_attn_kinds()
    ffns = cfg.layer_ffn_kinds()
    specs = list(zip(mixers, attns, ffns))
    L = cfg.num_layers
    p = 1
    for per in (cfg.hybrid_attn_period, cfg.local_global_period,
                cfg.moe_period):
        if per:
            p = _lcm(p, per)
    p = min(p, L)
    segments: List[Segment] = []
    full = L // p
    if full:
        segments.append((tuple(specs[:p]), full))
    rem = specs[full * p:]
    if rem:
        if all(s == rem[0] for s in rem):
            segments.append(((rem[0],), len(rem)))
        else:
            segments.append((tuple(rem), 1))
    return segments


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def layer_seed(seed: int, path, layer: int) -> int:
    """The seed of layer ``layer`` of the stacked leaf at ``path``: a
    CRC-32 of ``seed/path/layer``, the same in every process (Python's
    ``hash`` of a string is salted per process, so spawned mesh ranks
    would draw different weights from it)."""
    key = "/".join(str(k) for k in path)
    return zlib.crc32(f"{seed}/{key}/{layer}".encode())


def draw_layer(path, layer: int, shape, scale: float, *, seed: int,
               device, dtype) -> torch.Tensor:
    """Layer ``layer`` of the stacked matrix at ``path``, drawn alone from
    its own generator (``layer_seed``): fp32 normals, times ``scale`` in
    place, cast to ``dtype``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(layer_seed(seed, path, layer))
    w = torch.randn(tuple(shape), generator=gen, device=device,
                    dtype=torch.float32)
    return w.mul_(scale).to(dtype)


class _Draws:
    """``draw(name, shape, scale)``: the (len(layers), *shape) stack of
    the matrix ``prefix + (name, "w")`` in ``dtype``, each layer drawn
    alone (``draw_layer``); ``expert=e`` draws expert e of an expert
    stack from its own generators too, ``uniform`` a stack of fp32
    U[0, 1) vectors alike, and ``under(name)`` the draws of a sub-dict."""

    def __init__(self, prefix, layers, *, seed: int, device, dtype):
        self.prefix, self.layers = tuple(prefix), list(layers)
        self.seed, self.device, self.dtype = seed, device, dtype

    def __call__(self, name, shape, scale, dtype=None, expert=None):
        path = self.prefix + (name, "w") + (() if expert is None
                                            else (expert,))
        dt = dtype or self.dtype
        out = torch.empty((len(self.layers),) + tuple(shape), dtype=dt,
                          device=self.device)
        for j, i in enumerate(self.layers):
            out[j] = draw_layer(path, i, shape, scale, seed=self.seed,
                                device=self.device, dtype=dt)
        return out

    def uniform(self, name, shape):
        out = torch.empty((len(self.layers),) + tuple(shape),
                          dtype=torch.float32, device=self.device)
        for j, i in enumerate(self.layers):
            gen = torch.Generator(device=self.device)
            gen.manual_seed(layer_seed(self.seed, self.prefix + (name,), i))
            out[j] = torch.rand(tuple(shape), generator=gen,
                                device=self.device, dtype=torch.float32)
        return out

    def under(self, name) -> "_Draws":
        return _Draws(self.prefix + (name,), self.layers, seed=self.seed,
                      device=self.device, dtype=self.dtype)


def draw_expert(cfg: ModelConfig, si: int, slot: int, name: str, i: int,
                e: int, *, seed: int = 0, device="cuda") -> torch.Tensor:
    """Expert ``e`` of layer ``i`` of the expert stack ``name`` (w1 / w2
    / w3) of segment ``si``'s slot ``slot``, drawn alone as
    :func:`init_params` draws it: a (d, f) or (f, d) matrix."""
    d, f = cfg.d_model, cfg.d_ff
    shape, scale = ((f, d), _out_scale(cfg)) if name == "w2" else \
        ((d, f), 0.02)
    return draw_layer(("segments", si, f"slot{slot}", "ffn", name, "w", e),
                      i, shape, scale, seed=seed, device=device,
                      dtype=as_dtype(cfg.param_dtype))


def _attn_init(cfg: ModelConfig, layers: int, device, out_scale: float,
               draw) -> Dict:
    """Layer-stacked attention params; ``draw(name, shape, scale)`` makes
    each projection's stack (``_Draws``)."""
    dt = as_dtype(cfg.param_dtype)
    d, h, kvh, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
        cfg.attn_head_dim

    def dense(name, d_in, d_out, scale=0.02, bias=False):
        p = {"w": draw(name, (d_in, d_out), scale)}
        if bias:
            p["b"] = torch.zeros((layers, d_out), dtype=dt, device=device)
        return p

    p = {"wq": dense("wq", d, h * hd, bias=cfg.qkv_bias),
         "wk": dense("wk", d, kvh * hd, bias=cfg.qkv_bias),
         "wv": dense("wv", d, kvh * hd, bias=cfg.qkv_bias),
         "wo": dense("wo", h * hd, d, scale=out_scale)}
    if cfg.qk_norm:
        for name in ("q_norm", "k_norm"):
            p[name] = torch.ones((layers, hd), dtype=dt, device=device)
    return p


def _out_scale(cfg: ModelConfig) -> float:
    return 0.02 / max(1.0, (2 * cfg.num_layers) ** 0.5)


def _init_top(cfg: ModelConfig, gen: torch.Generator, device) -> Dict:
    """The embedding, final norm and (untied) head, drawn first from
    ``gen``."""
    dt = as_dtype(cfg.param_dtype)
    d = cfg.d_model
    def table():
        return torch.randn((cfg.vocab_size, d), generator=gen,
                           device=device).mul_(0.02).to(dt)

    top: Dict[str, Any] = {
        "embed": {"emb": table()},
        "final_norm": {"scale": torch.ones((d,), dtype=dt, device=device)},
    }
    if not cfg.tie_embeddings:
        top["lm_head"] = {"emb": table()}
    return top


def _init_segment(cfg: ModelConfig, si: int, pattern, layers, seed: int,
                  device, experts=None, slots=None) -> Dict:
    """Segment ``si``'s slots (those of ``slots``, default all) at the
    layer indices ``layers`` (stacked in that order), every matrix and
    drawn vector layer by layer (and expert by expert) from its own
    generator (``draw_layer``); ``experts`` (lo, hi) keeps only those
    experts of each expert stack."""
    dt = as_dtype(cfg.param_dtype)
    d, n = cfg.d_model, len(layers)
    kw = dict(layers=n, device=device, out_scale=_out_scale(cfg))
    seg = {}
    for slot, (mixer, _, ffn_kind) in enumerate(pattern):
        if slots is not None and slot not in slots:
            continue
        prefix = ("segments", si, f"slot{slot}")
        draws = dict(seed=seed, device=device, dtype=dt)
        mdraw = _Draws(prefix + ("mixer",), layers, **draws)
        fdraw = _Draws(prefix + ("ffn",), layers, **draws)
        seg[f"slot{slot}"] = {
            "norm1": {"scale": torch.ones((n, d), dtype=dt, device=device)},
            "norm2": {"scale": torch.ones((n, d), dtype=dt, device=device)},
            "mixer": (_attn_init(cfg, n, device, kw["out_scale"], mdraw)
                      if mixer == MIXER_ATTN
                      else ssm_mod.ssm_init(None, cfg, draw=mdraw, **kw)),
            "ffn": (moe_mod.moe_init(None, cfg, draw=fdraw, experts=experts,
                                     **kw)
                    if ffn_kind == FFN_MOE
                    else ffn_mod.ffn_init(None, cfg, draw=fdraw, **kw)),
        }
    return seg


def init_params(cfg: ModelConfig, *, seed: int = 0,
                device="cuda") -> Dict:
    """Random params in the reference layout and at its scales (wo,
    out_proj and every w2 at 0.02 / sqrt(2 L), every other projection at
    0.02; the SSM's and the router's own leaves as the reference draws
    them) on ``device``. The embedding and head come from one
    ``torch.Generator`` seeded with ``seed``; each layer of every layer-
    stacked matrix (each expert of an expert stack apart) from its own
    (``draw_layer``), so that :func:`init_layer` can draw one layer, and
    :func:`draw_expert` one expert, alone. (The numbers differ from the
    reference's PRNG; tests bridge the reference's params instead.)"""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = _init_top(cfg, gen, device)
    params["segments"] = tuple(
        _init_segment(cfg, si, pattern, range(repeat), seed, device)
        for si, (pattern, repeat) in enumerate(segment_plan(cfg)))
    return params


def param_shapes(cfg: ModelConfig) -> Dict:
    """:func:`init_params`' tree with each leaf a ``meta`` tensor of its
    shape and dtype: drawn under a fake-tensor mode, so nothing is
    allocated (a mesh's placement reads the whole tree's shapes)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        tree = init_params(cfg, device="cpu")
    return _map_tensors(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                              device="meta"), tree)


def _map_tensors(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_tensors(fn, v) for v in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def init_top(cfg: ModelConfig, *, seed: int = 0, device="cuda") -> Dict:
    """:func:`init_params`' embedding, final norm and head alone."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return _init_top(cfg, gen, device)


def init_layer(cfg: ModelConfig, si: int, i: int, *, seed: int = 0,
               device="cuda", experts: Optional[Tuple[int, int]] = None,
               slots: Optional[Tuple[int, ...]] = None) -> Dict:
    """Layer ``i`` of segment ``si`` of :func:`init_params`' tree, drawn
    alone: the segment's slots (those of ``slots``, default all: a
    hybrid pattern's repeat holds several layers) with every leaf's
    layer axis of length 1. ``experts`` (lo, hi) draws only those experts
    of each expert stack (an expert-parallel rank's; (0, 0): none, for a
    build that takes the experts one at a time with
    :func:`draw_expert`)."""
    pattern, repeat = segment_plan(cfg)[si]
    if not 0 <= i < repeat:
        raise IndexError(f"segment {si} has {repeat} layers, not {i + 1}")
    return _init_segment(cfg, si, pattern, [i], seed, device, experts,
                         slots)


def expert_leaf(cfg: ModelConfig, path) -> bool:
    """Is ``path`` (keys from the root) an expert stack's matrix?"""
    if len(path) != 6 or path[0] != "segments" or path[3] != "ffn":
        return False
    pattern, _ = segment_plan(cfg)[path[1]]
    slot = int(str(path[2])[len("slot"):])
    return (pattern[slot][2] == FFN_MOE and path[4] in ("w1", "w2", "w3")
            and path[5] == "w")


def layer_params(tree, i: int):
    """Layer ``i`` of a layer-stacked param subtree."""
    if isinstance(tree, dict):
        return {k: layer_params(v, i) for k, v in tree.items()}
    if isinstance(tree, (PackedSASPWeight, PackedFFN, BlockSparseWeight,
                         QuantizedWeight)):
        return tree.layer(i)
    if isinstance(tree, torch.Tensor):
        return tree[i]
    return tree


def unstack_layers(tree, n: int) -> List:
    """The ``n`` layers of a layer-stacked param subtree, split at once.
    ``torch.unbind`` is one autograd node per leaf, whose backward stacks
    the layers' gradients; indexing layer by layer would instead add a
    zero-padded full-size gradient per layer, quadratic in depth."""
    if isinstance(tree, dict):
        per = {k: unstack_layers(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in per.items()} for i in range(n)]
    if isinstance(tree, torch.Tensor):
        return list(torch.unbind(tree))
    return [layer_params(tree, i) for i in range(n)]


# ---------------------------------------------------------------------------
# Apply
# ---------------------------------------------------------------------------


def _slot_window(cfg: ModelConfig, spec: LayerSpec, seq_len: int) -> int:
    if spec[1] == ATTN_LOCAL and cfg.sliding_window:
        return cfg.sliding_window
    return max(seq_len, 1) + 1


def ring_capacity(cfg: ModelConfig, spec: LayerSpec, cache_len: int,
                  uniform: bool = False) -> int:
    """The slots of an attention layer's whole ring: a windowed layer's
    window (at most ``cache_len``), a global layer's ``cache_len``; every
    layer ``cache_len`` with ``uniform`` (the paged pool)."""
    if uniform:
        return cache_len
    return min(_slot_window(cfg, spec, cache_len), cache_len)


def _ring_cut(cfg: ModelConfig, spec: LayerSpec,
              cache_len: Optional[int] = None):
    """The cut of the layer's ring under ``cfg``'s sequence-parallel
    layout (``sharding.ring_cut``), or None (no such layout, or no axis
    divides the ring). ``cache_len``, where the caller sizes the ring,
    must be the layout's."""
    if not cfg.seq_cache_len:
        return None
    if cache_len is not None and cache_len != cfg.seq_cache_len:
        raise ValueError(
            f"rings of cache_len {cache_len} under a sequence-parallel "
            f"layout sized for {cfg.seq_cache_len}")
    from repro_torch.distribution.sharding import ring_cut
    return ring_cut(cfg, ring_capacity(cfg, spec, cfg.seq_cache_len))


def _ffn(sp: Dict, spec: LayerSpec, cfg: ModelConfig, x: torch.Tensor):
    """The residual block's second half: (x + FFN(norm2(x)), the MoE aux
    loss, or None for a dense FFN)."""
    h2 = rmsnorm_apply(sp["norm2"], x, eps=cfg.norm_eps)
    if spec[2] == FFN_MOE:
        y2, aux = moe_ep.moe_dispatch(sp["ffn"], cfg, h2)
        return x + y2, aux
    return x + ffn_mod.ffn_apply(sp["ffn"], cfg, h2), None


def _mixer_full(sp: Dict, spec: LayerSpec, cfg: ModelConfig,
                x: torch.Tensor, positions: torch.Tensor, want_cache: bool,
                cache_len: int, uniform_cache: bool = False):
    """The residual block's first half over the whole sequence -> (x +
    mixer(norm1(x)), cache or None)."""
    S = x.shape[1]
    h = rmsnorm_apply(sp["norm1"], x, eps=cfg.norm_eps)
    cache = None
    if spec[0] == MIXER_ATTN:
        window = _slot_window(cfg, spec, S)
        y, (k, v) = attn_mod.attn_apply_full(sp["mixer"], cfg, h,
                                             positions, window)
        if want_cache:
            # uniform_cache: every layer's ring at the full cache_len
            # (the paged pool's one page geometry); the window mask
            # governs reads
            cap = ring_capacity(cfg, spec, cache_len, uniform_cache)
            cache = attn_mod.build_cache_from_prefill(
                k, v, cap,
                positions=positions if positions.ndim == 2 else None,
                quant=cfg.kv_quant,
                cut=None if uniform_cache else _ring_cut(cfg, spec,
                                                         cache_len))
    else:
        y, ssm_cache = ssm_mod.ssm_apply_full(sp["mixer"], cfg, h)
        if want_cache:
            cache = ssm_cache
    return x + y, cache


def _apply_slot_full(sp: Dict, spec: LayerSpec, cfg: ModelConfig,
                     x: torch.Tensor, positions: torch.Tensor,
                     want_cache: bool, cache_len: int,
                     uniform_cache: bool = False):
    """One layer over the whole sequence -> (x, aux or None, cache or
    None)."""
    x, cache = _mixer_full(sp, spec, cfg, x, positions, want_cache,
                           cache_len, uniform_cache)
    x, aux = _ffn(sp, spec, cfg, x)
    return x, aux, cache


def _mixer_decode(sp: Dict, spec: LayerSpec, cfg: ModelConfig,
                  x: torch.Tensor, pos: torch.Tensor, cache):
    """The first half of a decode step's layer; the cache is written in
    place."""
    h = rmsnorm_apply(sp["norm1"], x, eps=cfg.norm_eps)
    if spec[0] == MIXER_ATTN:
        window = _slot_window(cfg, spec, int(1e9) - 2)
        y, cache = attn_mod.attn_apply_decode(sp["mixer"], cfg, h, pos,
                                              cache, window,
                                              _ring_cut(cfg, spec))
    else:
        y, cache = ssm_mod.ssm_apply_decode(sp["mixer"], cfg, h, cache)
    return x + y, cache


def _apply_slot_decode(sp: Dict, spec: LayerSpec, cfg: ModelConfig,
                       x: torch.Tensor, pos: torch.Tensor, cache):
    """One layer of a decode step; the layer's cache is written in
    place."""
    x, cache = _mixer_decode(sp, spec, cfg, x, pos, cache)
    x, _ = _ffn(sp, spec, cfg, x)
    return x, cache


def _mixer_prefill_past(sp: Dict, spec: LayerSpec, cfg: ModelConfig,
                        x: torch.Tensor, positions: torch.Tensor,
                        cache: attn_mod.KVCache):
    """The first half of a layer of the suffix prefill: attention reads
    the resident prefix through ``cache``; the returned cache holds only
    the suffix. Global layers take window = C, the ring capacity:
    sequential decode never attends an entry C or more positions back,
    so masking those (old-lap entries of a wrapped ring) keeps this pass
    step-equivalent to decode, which the speculative verify relies on."""
    cut = _ring_cut(cfg, spec)
    C = cache.k.shape[1] if cut is None else cut.capacity
    h = rmsnorm_apply(sp["norm1"], x, eps=cfg.norm_eps)
    window = cfg.sliding_window if (
        spec[1] == ATTN_LOCAL and cfg.sliding_window) else C
    y, new_cache = attn_mod.attn_apply_prefill_past(
        sp["mixer"], cfg, h, positions, cache, window, cut)
    return x + y, new_cache


def _apply_slot_prefill_past(sp: Dict, spec: LayerSpec, cfg: ModelConfig,
                             x: torch.Tensor, positions: torch.Tensor,
                             cache: attn_mod.KVCache):
    """One layer of the suffix prefill (``_mixer_prefill_past``, then the
    FFN)."""
    x, new_cache = _mixer_prefill_past(sp, spec, cfg, x, positions, cache)
    x, _ = _ffn(sp, spec, cfg, x)
    return x, new_cache


def _stack_caches(caches: List):
    """Per-layer caches -> one cache of their type with a layer axis."""
    return type(caches[0])(*(None if f[0] is None else torch.stack(list(f))
                             for f in zip(*caches)))


def _layer_cache(c, r: int):
    """Layer ``r`` of a layer-stacked cache (views: writes land in c)."""
    return attn_mod.cache_map(lambda a: a[r], c)


# the products whose outputs "dots" keeps (jax's checkpoint_dots policy)
_DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
            torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default)


def _maybe_remat(fn, cfg: ModelConfig):
    """``fn(*args)`` under ``cfg.remat`` when autograd records: ``none``
    keeps every activation, ``full`` recomputes ``fn`` in backward,
    ``dots`` recomputes it except the matmul outputs, which are saved."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    kw = dict(use_reentrant=False, preserve_rng_state=False)
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            torch_ckpt.create_selective_checkpoint_contexts, list(_DOT_OPS))
    elif cfg.remat != "full":
        raise ValueError(f"remat {cfg.remat!r} not in none|full|dots")
    return lambda *args: torch_ckpt.checkpoint(fn, *args, **kw)


def _run_segments_full(params, cfg: ModelConfig, x, positions,
                       want_cache: bool, cache_len: int,
                       uniform_cache: bool = False):
    """The layer walk -> (x, the MoE aux loss summed over layers (fp32
    scalar), stacked caches or None)."""
    all_caches = []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for seg_params, (pattern, repeat) in zip(params["segments"],
                                             segment_plan(cfg)):
        names = [f"slot{s}" for s in range(len(pattern))]
        layers = {n: unstack_layers(seg_params[n], repeat) for n in names}
        per_slot: Dict[str, list] = {n: [] for n in names}
        for r in range(repeat):
            def body(xc, aux, r=r, names=names, pattern=pattern,
                     layers=layers):
                cs = []
                for name, spec in zip(names, pattern):
                    xc, a, c = _apply_slot_full(
                        layers[name][r], spec, cfg, xc, positions,
                        want_cache, cache_len, uniform_cache)
                    if a is not None:
                        aux = aux + a
                    cs.append(c)
                return xc, aux, cs
            # the reference's scan body, recomputed in backward
            x, aux, cs = (body if want_cache
                          else _maybe_remat(body, cfg))(x, aux)
            for name, c in zip(names, cs):
                per_slot[name].append(c)
        if want_cache:
            all_caches.append({n: _stack_caches(cs)
                               for n, cs in per_slot.items()})
    return x, aux, tuple(all_caches) if want_cache else None


def _run_segments_prefill_past(params, cfg: ModelConfig, x, positions,
                               past):
    new_caches = []
    for seg_params, seg_past, (pattern, repeat) in zip(
            params["segments"], past, segment_plan(cfg)):
        per_slot: Dict[str, list] = {f"slot{s}": [] for s in
                                     range(len(pattern))}
        for r in range(repeat):
            for slot, spec in enumerate(pattern):
                name = f"slot{slot}"
                x, c = _apply_slot_prefill_past(
                    layer_params(seg_params[name], r), spec, cfg, x,
                    positions, _layer_cache(seg_past[name], r))
                per_slot[name].append(c)
        new_caches.append({n: _stack_caches(cs)
                           for n, cs in per_slot.items()})
    return x, tuple(new_caches)


def _vocab_mesh(cfg: ModelConfig):
    """The active mesh where its 'model' ranks each hold one of
    ``cfg.vocab_shards`` row shards of the table, else None."""
    if cfg.vocab_shards == 1:
        return None
    from repro_torch.distribution import context as dctx
    mesh = dctx.active_mesh()
    if mesh is not None and mesh.axis_size("model") == cfg.vocab_shards:
        return mesh
    return None


def _embed_in(params, cfg: ModelConfig, tokens, embeds=None):
    """The token embedding in the compute type. On a vocab-sharded mesh
    each rank gathers the ids in its rows (zero rows elsewhere) and the
    ranks' rows are summed: one non-zero term an element, so the sum is
    the whole table's gather."""
    cdt = as_dtype(cfg.compute_dtype)
    if embeds is not None:
        return embeds.to(cdt)
    mesh = _vocab_mesh(cfg)
    if mesh is None:
        return embedding_apply(params["embed"], tokens, dtype=cdt)
    emb = params["embed"]["emb"]
    rows = emb.shape[0]
    ids = tokens.to(torch.int64) - mesh.model_rank * rows
    mine = (ids >= 0) & (ids < rows)
    x = emb[ids.clamp(0, rows - 1)].to(cdt)
    return mesh.psum(torch.where(mine[..., None], x, torch.zeros_like(x)))


def _head_table(params, cfg: ModelConfig):
    return (params["embed"]["emb"] if cfg.tie_embeddings
            else params["lm_head"]["emb"])


def logits_fn(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """(B, S, d) -> fp32 logits (B, S, V): the table is rounded to x's
    type, the product summed in fp32. A vocab-sharded table gives each
    shard's logits apart, in vocab order: all-gathered from the mesh's
    ranks, or shard by shard in one process (the shard loop), so both
    run the same products."""
    x = rmsnorm_apply(params["final_norm"], x, eps=cfg.norm_eps)
    table = _head_table(params, cfg)
    mesh = _vocab_mesh(cfg)
    if mesh is not None:
        return mesh.all_gather(matmul_f32(x, table.to(x.dtype).t()), dim=-1)
    n = cfg.vocab_shards
    rows = table.shape[0] // n
    return torch.cat([matmul_f32(x, table[s * rows:(s + 1) * rows]
                                 .to(x.dtype).t()) for s in range(n)],
                     dim=-1)


def forward(params, cfg: ModelConfig, tokens: Optional[torch.Tensor] = None,
            embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence forward -> logits (B, S, V); ``embeds`` (B, S, d), if
    given, replaces the token embedding."""
    x = _embed_in(params, cfg, tokens, embeds)
    S = x.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    x, _, _ = _run_segments_full(params, cfg, x, positions, False, 0)
    logits = logits_fn(params, cfg, x)
    return softcap(logits, cfg.logit_softcap)


# ---------------------------------------------------------------------------
# Loss (chunked cross-entropy: never holds (B, S, V) at once)
# ---------------------------------------------------------------------------


def _xent_chunk(x_chunk, targets, emb, cfg: ModelConfig) -> torch.Tensor:
    logits = matmul_f32(x_chunk, emb.t())
    logits = softcap(logits, cfg.logit_softcap)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, targets[..., None].to(torch.int64))
    return (lse - tgt[..., 0]).sum()


def _xent_chunk_vocab(cfg: ModelConfig, mesh, x_chunk, targets, *tables
                      ) -> torch.Tensor:
    """The chunk's cross-entropy over a vocab-sharded head, vocab-parallel
    (no rank holds a (B, c, V) logit block): each shard's fp32 logits,
    their max (no gradient: the log-sum-exp does not depend on the
    shift), the shards' sums of exp and their target logits (each target
    is in one shard's rows; zero elsewhere) summed. On ``mesh`` the rank
    holds one shard: x enters through ``copy_to_model``, the max is
    all-reduced and the sums ``psum``-ed over 'model'; with no mesh
    ``tables`` are every shard's rows and the sums run in shard order."""
    ids = targets.to(torch.int64)
    if mesh is not None:
        x_chunk = mesh.copy_to_model(x_chunk)
    rows = tables[0].shape[0]
    first = mesh.model_rank if mesh is not None else 0
    logits = [softcap(matmul_f32(x_chunk, t.t()), cfg.logit_softcap)
              for t in tables]
    m = logits[0].detach().amax(dim=-1)
    for lg in logits[1:]:
        m = torch.maximum(m, lg.detach().amax(dim=-1))
    if mesh is not None:
        m = mesh.allreduce(m, "model", "max")
    sums, tgts = [], []
    for s, lg in enumerate(logits):
        local = ids - (first + s) * rows
        mine = (local >= 0) & (local < rows)
        t = torch.gather(lg, -1, local.clamp(0, rows - 1)[..., None])[..., 0]
        tgts.append(torch.where(mine, t, torch.zeros_like(t)))
        sums.append(torch.exp(lg - m[..., None]).sum(dim=-1))
    if mesh is not None:
        total, tgt = mesh.psum(sums[0]), mesh.psum(tgts[0])
    else:
        total, tgt = sums[0], tgts[0]
        for a, b in zip(sums[1:], tgts[1:]):
            total, tgt = total + a, tgt + b
    return (torch.log(total) + m - tgt).sum()


def loss_fn(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            xent_chunk: int = 512):
    """batch: tokens (B, S) [+ embeds (B, S, d)]. Next-token CE + the
    MoE aux loss summed over layers (0 without MoE). Returns (loss,
    {"ce", "aux"}). Each chunk of positions is checkpointed: backward
    recomputes its (B, chunk, V) fp32 logits instead of keeping them
    (and, on a mesh, the chunk's collectives, in the same order on every
    rank). A vocab-sharded head (``cfg.vocab_shards``: a mesh rank's
    rows, or the shard loop's shards) scores through
    ``_xent_chunk_vocab``."""
    tokens = batch["tokens"]
    x = _embed_in(params, cfg, tokens, batch.get("embeds"))
    S = tokens.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    x, aux, _ = _run_segments_full(params, cfg, x, positions, False, 0)
    ce = _xent(params, cfg, x, tokens, xent_chunk)
    return ce + aux, {"ce": ce, "aux": aux}


def _xent(params, cfg: ModelConfig, x: torch.Tensor, tokens: torch.Tensor,
          xent_chunk: int) -> torch.Tensor:
    """``loss_fn``'s next-token cross-entropy of the last layer's ``x``
    (B, S, d): the final norm, then the chunked head."""
    B, S = tokens.shape
    x = rmsnorm_apply(params["final_norm"], x, eps=cfg.norm_eps)
    emb = _head_table(params, cfg).to(x.dtype)
    mesh = _vocab_mesh(cfg)
    if mesh is not None or cfg.vocab_shards > 1:
        n = 1 if mesh is not None else cfg.vocab_shards
        rows = emb.shape[0] // n
        tables = tuple(emb[s * rows:(s + 1) * rows] for s in range(n))
        fn = functools.partial(_xent_chunk_vocab, cfg, mesh)
    else:
        tables = (emb,)

        def fn(xc, tc, table):
            return _xent_chunk(xc, tc, table, cfg)

    def chunk(xc, tc):
        if torch.is_grad_enabled():
            return torch_ckpt.checkpoint(fn, xc, tc, *tables,
                                         use_reentrant=False,
                                         preserve_rng_state=False)
        return fn(xc, tc, *tables)
    n = S - 1
    c = min(xent_chunk, n)
    while n % c:
        c -= 1
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, n, c):
        total = total + chunk(x[:, i:i + c], tokens[:, i + 1:i + 1 + c])
    return total / (B * n)


def loss_fn_groups(params, cfg: ModelConfig, batches: List[Dict],
                   xent_chunk: int = 512):
    """The meshless twin of ``loss_fn`` on an expert-parallel mesh whose
    DP ranks hold the row groups ``batches`` (each a batch of the same
    rows; pod-major, ``cfg.ep_shards`` groups a pod): each group's
    embedding, mixers, dense FFNs and cross-entropy apart, at the mesh's
    shapes, each MoE layer over every group at once, pod by pod
    (``moe_ep.moe_ffn_groups``), each layer repeat under ``cfg.remat``.
    Returns each group's (loss, {"ce", "aux"}): what each DP rank's
    ``loss_fn`` gives on the mesh. The aux (the mean over the groups:
    each pod's, then the pods') carries every group's own aux gradient in
    equal shares, so the gradient of the groups' mean loss is the mean of
    the mesh ranks'."""
    xs = [_embed_in(params, cfg, b["tokens"], b.get("embeds"))
          for b in batches]
    S = batches[0]["tokens"].shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=xs[0].device)
    aux = torch.zeros((), dtype=torch.float32, device=xs[0].device)
    n = len(xs)
    for seg_params, (pattern, repeat) in zip(params["segments"],
                                             segment_plan(cfg)):
        names = [f"slot{s}" for s in range(len(pattern))]
        layers = {nm: unstack_layers(seg_params[nm], repeat)
                  for nm in names}
        for r in range(repeat):
            def body(*args, r=r, names=names, pattern=pattern,
                     layers=layers):
                xs, aux = list(args[:n]), args[n]
                for name, spec in zip(names, pattern):
                    sp = layers[name][r]
                    xs = [_mixer_full(sp, spec, cfg, x, positions, False,
                                      0)[0] for x in xs]
                    xs, a = _ffn_groups(sp, spec, cfg, xs)
                    if a is not None:
                        aux = aux + a
                return (*xs, aux)
            *xs, aux = _maybe_remat(body, cfg)(*xs, aux)
    out = []
    for b, x in zip(batches, xs):
        ce = _xent(params, cfg, x, b["tokens"], xent_chunk)
        out.append((ce + aux, {"ce": ce, "aux": aux}))
    return out


def prefill(params, cfg: ModelConfig, tokens: torch.Tensor,
            cache_len: Optional[int] = None,
            positions: Optional[torch.Tensor] = None,
            uniform_cache: bool = False):
    """Process prompts; returns (last-token logits (B, 1, V), caches).
    positions: optional per-batch (B, S) for the left-padded batched
    prefill (pad columns negative). uniform_cache: every layer's ring at
    the full cache_len (the paged pool)."""
    x = _embed_in(params, cfg, tokens)
    S = x.shape[1]
    cache_len = cache_len or S
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=x.device)
    else:
        positions = positions.to(torch.int32)
    x, _, caches = _run_segments_full(params, cfg, x, positions, True,
                                      cache_len, uniform_cache)
    logits = logits_fn(params, cfg, x[:, -1:])
    return softcap(logits, cfg.logit_softcap), caches


def prefill_with_past(params, cfg: ModelConfig, tokens: torch.Tensor,
                      positions: torch.Tensor, past,
                      all_logits: bool = False):
    """Suffix-only prefill (prefix sharing). tokens (B, S): each prompt's
    suffix, left-padded; positions (B, S) absolute (pads < 0); past:
    ring caches holding each row's matched prefix (every other slot
    pos = -1). Returns (logits, suffix-only caches); the logits are the
    last position's (B, 1, V), or every position's (B, S, V) with
    ``all_logits`` (the speculative verify)."""
    x = _embed_in(params, cfg, tokens)
    x, caches = _run_segments_prefill_past(params, cfg, x,
                                           positions.to(torch.int32), past)
    logits = logits_fn(params, cfg, x if all_logits else x[:, -1:])
    return softcap(logits, cfg.logit_softcap), caches


def decode_step(params, cfg: ModelConfig, tokens: torch.Tensor,
                pos: torch.Tensor, caches):
    """One decode step. tokens (B, 1); pos (B,). Updates ``caches`` in
    place (attention writes its ring views, the SSM its state and conv
    window); returns (logits (B, 1, V), caches)."""
    x = _embed_in(params, cfg, tokens)
    for seg_params, seg_caches, (pattern, repeat) in zip(
            params["segments"], caches, segment_plan(cfg)):
        for r in range(repeat):
            for slot, spec in enumerate(pattern):
                name = f"slot{slot}"
                x, _ = _apply_slot_decode(layer_params(seg_params[name], r),
                                          spec, cfg, x, pos,
                                          _layer_cache(seg_caches[name], r))
    logits = logits_fn(params, cfg, x)
    return softcap(logits, cfg.logit_softcap), caches


# ---------------------------------------------------------------------------
# Expert parallelism: the data ranks' row groups in one process, and a data
# rank with no rows on the mesh
# ---------------------------------------------------------------------------


def _ffn_groups(sp: Dict, spec: LayerSpec, cfg: ModelConfig, xs: List):
    """``_ffn`` over every group at once: a MoE layer's groups through
    ``moe_ep.moe_ffn_groups`` (the EP mesh's math), a dense FFN group by
    group; an empty group stays empty. Returns (xs, the MoE aux or
    None)."""
    hs = [rmsnorm_apply(sp["norm2"], x, eps=cfg.norm_eps) for x in xs]
    if spec[2] == FFN_MOE:
        ys, aux = moe_ep.moe_ffn_groups(sp["ffn"], cfg, hs)
        return [x + y for x, y in zip(xs, ys)], aux
    return [x + ffn_mod.ffn_apply(sp["ffn"], cfg, h) if x.shape[0] else x
            for x, h in zip(xs, hs)], None


def _walk_groups(params, cfg: ModelConfig, xs: List, mixer):
    """Every layer in order: ``mixer(sp, spec, g, x, seg_idx, name, r)``
    on each non-empty group, then the FFN over all groups at once."""
    for si, (seg_params, (pattern, repeat)) in enumerate(
            zip(params["segments"], segment_plan(cfg))):
        for r in range(repeat):
            for slot, spec in enumerate(pattern):
                name = f"slot{slot}"
                sp = layer_params(seg_params[name], r)
                xs = [mixer(sp, spec, g, x, si, name, r) if x.shape[0]
                      else x for g, x in enumerate(xs)]
                xs = _ffn_groups(sp, spec, cfg, xs)[0]
    return xs


def prefill_groups(params, cfg: ModelConfig, tokens: List, positions: List,
                   cache_len: int, uniform_cache: bool = False):
    """The meshless twin of a prefill on an expert-parallel mesh whose
    data ranks hold the row groups ``tokens`` (each (b_g, S), b_g may be
    0; ``positions`` each (b_g, S) or None): every layer's mixer group
    by group, each MoE layer over every group at once, at the mesh's
    shapes. Returns each group's (last-token logits, caches), None for
    an empty group. ``uniform_cache``: as ``prefill``'s."""
    xs = [_embed_in(params, cfg, t) for t in tokens]
    S = tokens[0].shape[1]
    poss = [torch.arange(S, dtype=torch.int32, device=x.device)
            if p is None else p.to(torch.int32)
            for x, p in zip(xs, positions)]
    got: List[Dict] = [{} for _ in xs]

    def mixer(sp, spec, g, x, si, name, r):
        x, c = _mixer_full(sp, spec, cfg, x, poss[g], True, cache_len,
                           uniform_cache)
        got[g].setdefault((si, name), []).append(c)
        return x

    xs = _walk_groups(params, cfg, xs, mixer)
    return _group_outputs(params, cfg, xs, got, False)


def prefill_with_past_groups(params, cfg: ModelConfig, tokens: List,
                             positions: List, pasts: List,
                             all_logits: bool = False):
    """``prefill_with_past`` of each row group (``tokens`` / ``positions``
    each (b_g, S), b_g may be 0; ``pasts`` each group's ring caches) in
    lock step, as ``prefill_groups``: the meshless twin of a suffix
    prefill, or a speculative verify, on a mesh whose data ranks hold
    the groups. Returns each group's (logits, suffix caches), None for
    an empty group."""
    xs = [_embed_in(params, cfg, t) for t in tokens]
    got: List[Dict] = [{} for _ in xs]

    def mixer(sp, spec, g, x, si, name, r):
        x, c = _mixer_prefill_past(sp, spec, cfg, x,
                                   positions[g].to(torch.int32),
                                   _layer_cache(pasts[g][si][name], r))
        got[g].setdefault((si, name), []).append(c)
        return x

    xs = _walk_groups(params, cfg, xs, mixer)
    return _group_outputs(params, cfg, xs, got, all_logits)


def _group_outputs(params, cfg: ModelConfig, xs: List, got: List,
                   all_logits: bool):
    """Each group's (logits, stacked caches), None for an empty group:
    the last position's logits, or every position's."""
    out = []
    for g, x in enumerate(xs):
        if not x.shape[0]:
            out.append(None)
            continue
        caches = tuple({f"slot{s}": _stack_caches(got[g][(si, f"slot{s}")])
                        for s in range(len(pattern))}
                       for si, (pattern, _) in enumerate(segment_plan(cfg)))
        logits = softcap(logits_fn(params, cfg,
                                   x if all_logits else x[:, -1:]),
                         cfg.logit_softcap)
        out.append((logits, caches))
    return out


def decode_step_groups(params, cfg: ModelConfig, tokens: torch.Tensor,
                       pos: torch.Tensor, caches, groups: int):
    """The meshless twin of a decode step on an expert-parallel mesh whose
    ``groups`` data ranks each hold an equal block of the batch's rows
    (and of ``caches``, updated in place): each block's mixers apart,
    each MoE layer over every block at once. Returns logits (B, 1, V)."""
    n = tokens.shape[0] // groups
    rows = [slice(g * n, (g + 1) * n) for g in range(groups)]
    xs = [_embed_in(params, cfg, tokens[r]) for r in rows]

    def mixer(sp, spec, g, x, si, name, r):
        c = attn_mod.cache_map(lambda a: a[r][rows[g]],
                               caches[si][name])
        return _mixer_decode(sp, spec, cfg, x, pos[rows[g]], c)[0]

    xs = _walk_groups(params, cfg, xs, mixer)
    return torch.cat([softcap(logits_fn(params, cfg, x), cfg.logit_softcap)
                      for x in xs], dim=0)


def moe_bystander(params, cfg: ModelConfig, S: int, device, dtype):
    """A data rank with no rows in a call on an expert-parallel mesh:
    it enters every MoE layer's collectives, in layer order, with zero
    rows (its experts still serve the other ranks' tokens) and runs
    nothing else."""
    x = torch.zeros((0, S, cfg.d_model), dtype=dtype, device=device)
    for seg_params, (pattern, repeat) in zip(params["segments"],
                                             segment_plan(cfg)):
        for r in range(repeat):
            for slot, spec in enumerate(pattern):
                if spec[2] == FFN_MOE:
                    moe_ep.moe_dispatch(
                        layer_params(seg_params[f"slot{slot}"]["ffn"], r),
                        cfg, x)


def init_caches(params, cfg: ModelConfig, batch: int, cache_len: int,
                device=None, uniform_cap: bool = False):
    """Zero caches matching the segment plan: attention rings (repeat, B,
    C, KH, D) (int8 with (repeat, B, C, KH) scales under
    ``cfg.kv_quant``), SSM states (repeat, B, H, P, N) and conv windows
    (repeat, B, K-1, conv_dim). uniform_cap: every ring at capacity
    cache_len (the paged pool's page geometry). Under a sequence-parallel
    layout (``cfg.seq_cache_len``) a mesh rank's ring holds its block,
    C / n slots (``sharding.ring_cut``); SSM leaves stay whole."""
    device = device or params["embed"]["emb"].device
    cdt = as_dtype(cfg.compute_dtype)
    caches = []
    for pattern, repeat in segment_plan(cfg):
        seg = {}
        for slot, spec in enumerate(pattern):
            if spec[0] == MIXER_ATTN:
                cap = ring_capacity(cfg, spec, cache_len, uniform_cap)
                cut = None if uniform_cap else _ring_cut(cfg, spec,
                                                         cache_len)
                if cut is not None and cut.local:
                    cap = cut.block
                c = attn_mod.init_kv_cache(
                    repeat * batch, cap, cfg.num_kv_heads,
                    cfg.attn_head_dim, cdt, device, quant=cfg.kv_quant)
            else:
                c = ssm_mod.init_ssm_cache(cfg, repeat * batch, cdt, device)
            seg[f"slot{slot}"] = attn_mod.cache_map(
                lambda a: a.reshape((repeat, batch) + tuple(a.shape[1:])), c)
        caches.append(seg)
    return tuple(caches)
