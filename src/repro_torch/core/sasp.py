"""SASP deployment views of the port (``repro.core.sasp``).

Three artifact kinds beside the packed containers of ``core.deploy``:

* ``sasp_masks`` overlays: bool (…, KB, NB) per weight, kept in a tree of
  their own and merged into a view of the params inside the loss
  (training: the masks are applied straight through, so pruned tiles get
  zero gradient), built by ``build_sasp_overlay``;
* int8 ``qw`` entries: ``quantize_params`` replaces ``{"w": dense}``
  with ``{"qw": QuantizedWeight}`` for every weight in scope (the masked
  path's weight-only int8);
* ``sasp_bsr`` overlays: ``bsr_overlay_from_masks`` builds a
  ``BlockSparseWeight`` per pruned matrix, attached next to the weights
  with ``merge_overlay`` (the ``bsr`` and ``kernel`` paths).

Leaves are walked in the reference's order (``core.pruning.iter_leaves``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import SASPConfig
from repro_torch.core.pruning import (compute_sasp_masks, iter_leaves,
                                     mask_shard, mask_sparsity,
                                     masks_from_scores, path_str,
                                     prunable_blocks, scope_predicate,
                                     tile_l1)
from repro_torch.core.quantization import quantize_int8
from repro_torch.core.sparse import bsr_from_mask, stack_bsr

Params = Dict[str, Any]

__all__ = ["bsr_overlay_from_masks", "build_sasp_overlay",
           "masks_to_overlay", "merge_overlay", "mesh_masks", "mesh_overlay",
           "quantize_params", "sasp_summary", "scope_predicate"]


def _path_keys(path: Tuple) -> Tuple[str, ...]:
    return tuple(str(k) for k in path)


def masks_to_overlay(masks: Dict[Tuple, Any]) -> Params:
    """{path-to-'w'-leaf: mask} -> nested overlay dict where each mask sits
    at (..., parent, 'sasp_masks', <matrix-name>): the mask of
    ``.../ffn/w1/w`` lands at ``.../ffn/sasp_masks/w1``."""
    overlay: Params = {}
    for path, mask in masks.items():
        keys = _path_keys(path)
        assert keys[-1] == "w", keys
        *parent, mat, _ = keys
        node = overlay
        for k in parent:
            node = node.setdefault(k, {})
        node.setdefault("sasp_masks", {})[mat] = mask
    return overlay


def merge_overlay(params: Params, overlay: Optional[Params]) -> Params:
    """Merge ``overlay`` into a shallow copy of ``params``. Tuples
    (segment lists) are merged element-wise by index key."""
    if overlay is None:
        return params
    if isinstance(params, tuple):
        out = list(params)
        for k, v in overlay.items():
            i = int(k)
            out[i] = merge_overlay(out[i], v)
        return tuple(out)
    if isinstance(params, dict):
        out = dict(params)
        for k, v in overlay.items():
            if k in out and isinstance(v, dict) and isinstance(
                    out[k], (dict, tuple)):
                out[k] = merge_overlay(out[k], v)
            else:
                out[k] = v
        return out
    return overlay


def build_sasp_overlay(params: Params, sasp: SASPConfig,
                       is_prunable: Optional[Callable] = None
                       ) -> Tuple[Params, float]:
    """Global-L1 tile selection on the live params -> (overlay, achieved
    sparsity). Attach with ``merge_overlay(params, overlay)`` inside the
    loss (training) or bake with ``prune_params`` (deploy). Only the FFN
    reads ``sasp_masks``: as in the reference, attention's projections
    ignore masks placed beside them under scope ``all``."""
    masks = compute_sasp_masks(params, sasp, is_prunable)
    return masks_to_overlay(masks), mask_sparsity(masks)


def mesh_overlay(params: Params, sasp: SASPConfig, mesh,
                 param_specs: Dict[Tuple, Tuple],
                 is_prunable: Optional[Callable] = None
                 ) -> Tuple[Params, float]:
    """``build_sasp_overlay`` on a mesh rank: the whole tree's masks, the
    rank's slice of each. ``params`` are the rank's TP slices, whose
    specs ``param_specs`` gives ({path: spec}, 'model' on a cut dim,
    'data' on an expert stack's experts under EP). Each rank scores the
    tiles of its slices; each leaf's grid is all-gathered over 'model'
    (and an EP-cut stack's over 'data') into the whole leaf's, the grids
    ranked in
    the whole tree's leaf order (the same stable sort on every rank), and
    each mask cut back to the rank's tiles (``pruning.mask_shard``: a
    tile may not straddle two ranks). Returns (the rank's overlay, the
    whole tree's sparsity)."""
    local, masks = mesh_masks(params, sasp, mesh, param_specs, is_prunable)
    return masks_to_overlay(local), mask_sparsity(masks)


def mesh_masks(params: Params, sasp: SASPConfig, mesh,
               param_specs: Dict[Tuple, Tuple],
               is_prunable: Optional[Callable] = None):
    """``mesh_overlay``'s masks: ({path: the rank's mask}, {path: the
    whole leaf's mask}), with no read of their values on the host (the
    dry run traces it on fake tensors)."""
    pred = is_prunable or scope_predicate(sasp)
    tp, dp = mesh.shape["model"], mesh.shape["data"]
    scores, cut = [], {}
    for path, leaf in iter_leaves(params):
        spec = param_specs[path]
        md = spec.index("model") if "model" in spec and tp > 1 else None
        dd = spec.index("data") if "data" in spec and dp > 1 else None
        shape = list(leaf.shape)
        if md is not None:
            shape[md] *= tp
        if dd is not None:
            shape[dd] *= dp
        blocks = prunable_blocks(path, torch.empty(shape, device="meta"),
                                 sasp, pred)
        if blocks is None:
            continue
        bk, bn = blocks
        if md is not None and leaf.shape[md] % (
                bk if md == leaf.ndim - 2 else bn):
            raise ValueError(
                f"SASP tiles of {path_str(path)}: a {bk}x{bn} tile "
                f"straddles two model ranks ({tuple(leaf.shape)} on each)")
        grid = tile_l1(leaf, bk, bn)
        cut[path] = []
        if md is not None:
            grid = mesh.gather(grid, "model", md)
            cut[path].append((md, mesh.model_rank, tp))
        if dd is not None:          # an expert stack's experts (EP)
            grid = mesh.gather(grid, "data", dd)
            cut[path].append((dd, mesh.data_rank, dp))
        scores.append((path, grid))
    masks = masks_from_scores(scores, sasp.sparsity)
    local = {}
    for path, m in masks.items():
        for dim, r, n in cut[path]:
            m = mask_shard(m, dim, r, n, path_str(path))
        local[path] = m
    return local, masks


def quantize_params(params: Params, sasp: SASPConfig,
                    is_quantizable: Optional[Callable] = None) -> Params:
    """Replace {'w': dense} with {'qw': QuantizedWeight} for every weight
    in scope. Biases, norms and embeddings stay fp."""
    pred = is_quantizable or scope_predicate(sasp)
    targets = {_path_keys(path[:-1]) for path, leaf in iter_leaves(params)
               if path[-1] == "w" and getattr(leaf, "ndim", 0) >= 2
               and pred(path)}

    def rebuild(node, prefix):
        if isinstance(node, tuple):
            return tuple(rebuild(v, prefix + (str(i),))
                         for i, v in enumerate(node))
        if isinstance(node, dict):
            out = {}
            for k, v in node.items():
                child = prefix + (k,)
                if isinstance(v, dict) and child in targets and "w" in v:
                    nv = {kk: vv for kk, vv in v.items() if kk != "w"}
                    nv["qw"] = quantize_int8(v["w"], sasp.block_k,
                                             sasp.block_n)
                    out[k] = nv
                else:
                    out[k] = rebuild(v, child)
            return out
        return node

    return rebuild(params, ())


def bsr_overlay_from_masks(params: Params, masks: Dict[Tuple, Any],
                           sasp: SASPConfig,
                           k_max: Optional[Dict[Tuple, int]] = None
                           ) -> Params:
    """{…, 'sasp_bsr': {matrix: BlockSparseWeight}} overlays, on the
    device of each weight. 2-D weights get one container; (L, K, N)
    layer stacks get per-layer BSRs padded to a shared k_max and stacked.
    Stacks of more dims (MoE expert grids) stay on the masked path.
    ``k_max`` (path -> depth), where given, pads a stack to that depth:
    a layer built alone takes its whole stack's."""
    flat = dict(iter_leaves(params))
    overlay: Params = {}
    for path, mask in masks.items():
        leaf = flat[path]
        w = leaf.detach().to("cpu", torch.float32).numpy()
        m = torch.as_tensor(mask).cpu().numpy()
        *parent, mat, _ = _path_keys(path)
        K, N = w.shape[-2:]
        KB, NB = m.shape[-2:]
        bk, bn = K // KB, N // NB
        if w.ndim == 2:
            bsr = bsr_from_mask(w, m, bk, bn, quantize=sasp.quantize,
                                device=leaf.device)
        elif w.ndim == 3:
            depth = (k_max or {}).get(path) or max(1, int(m.sum(axis=-2)
                                                          .max()))
            bsr = stack_bsr([
                bsr_from_mask(w[i], m[i], bk, bn, quantize=sasp.quantize,
                              k_max=depth, device=leaf.device)
                for i in range(w.shape[0])])
        else:
            continue                     # MoE expert stacks: masked path
        node = overlay
        for k in parent:
            node = node.setdefault(k, {})
        node.setdefault("sasp_bsr", {})[mat] = bsr
    return overlay


def sasp_summary(overlay: Params) -> Dict[str, float]:
    masks = []

    def collect(node):
        if isinstance(node, dict):
            for k, v in node.items():
                if k == "sasp_masks":
                    masks.extend(v.values())
                else:
                    collect(v)
        elif isinstance(node, tuple):
            for v in node:
                collect(v)

    collect(overlay)
    total = sum(m.numel() for m in masks)
    kept = sum(int(m.sum()) for m in masks)
    return {
        "n_masked_matrices": len(masks),
        "total_tiles": total,
        "kept_tiles": kept,
        "sparsity": 1.0 - kept / max(total, 1),
    }
