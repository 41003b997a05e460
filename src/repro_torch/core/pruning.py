"""SASP structured pruning: global tile-L1 selection (paper §3.1).

Weights are grids of (block_k × block_n) tiles; tiles are scored by L1
norm and the lowest ``floor(sparsity × total)`` are zeroed across the
whole model. Ties are broken by a stable sort over one flat score
vector whose order is the reference's leaf order: dict keys in SORTED
order, sequences in index order (what ``jax.tree_util`` flattening
gives), so the port selects the same tiles.

Params are nested dicts / tuples of tensors; a leaf's path is the tuple
of its dict keys and sequence indices.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import SASPConfig

Params = Dict[str, Any]
Path = Tuple


def iter_leaves(tree, path: Path = ()) -> Iterator[Tuple[Path, Any]]:
    """(path, leaf) pairs in the reference's flattening order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from iter_leaves(tree[k], path + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from iter_leaves(v, path + (i,))
    elif tree is not None:
        yield path, tree


def path_str(path: Path) -> str:
    return "/".join(str(k) for k in path)


def map_leaves(fn, tree, path: Path = ()):
    """Rebuild ``tree`` with ``fn(path, leaf)`` at every tensor leaf."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_leaves(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    if isinstance(tree, torch.Tensor):
        return fn(path, tree)
    return tree


def effective_blocks(shape: Tuple[int, int], bk: int, bn: int
                     ) -> Tuple[int, int]:
    K, N = shape
    return min(bk, K), min(bn, N)


def tile_l1(w: torch.Tensor, bk: int, bn: int) -> torch.Tensor:
    """L1 norm per (bk × bn) tile. w: (..., K, N) -> (..., KB, NB). Each
    (K, N) matrix is summed alone: a reduction's order may depend on the
    size of the batch it runs in, and a layer-stacked leaf must score as
    its layers scored one at a time do (``build_rank_params``), or a
    one-ulp difference could flip a near-tied tile."""
    *lead, K, N = w.shape
    KB, NB = K // bk, N // bn
    flat = w.detach().reshape(-1, K, N)
    out = torch.empty((flat.shape[0], KB, NB), dtype=torch.float32,
                      device=w.device)
    for i in range(flat.shape[0]):
        out[i] = flat[i].reshape(KB, bk, NB, bn).to(torch.float32).abs() \
            .sum(dim=(1, 3))
    return out.reshape(*lead, KB, NB)


def apply_block_mask(w: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """w: (..., K, N); mask: (..., KB, NB) bool -> w with pruned tiles
    zeroed."""
    *lead, K, N = w.shape
    KB, NB = mask.shape[-2], mask.shape[-1]
    bk, bn = K // KB, N // NB
    wb = w.reshape(*lead, KB, bk, NB, bn)
    wb = wb * mask[..., :, None, :, None].to(w.dtype)
    return wb.reshape(*lead, K, N)


def apply_block_mask_(w: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``apply_block_mask`` in place (the same bits); returns ``w``."""
    *lead, K, N = w.shape
    KB, NB = mask.shape[-2], mask.shape[-1]
    w.view(*lead, KB, K // KB, NB, N // NB).mul_(
        mask[..., :, None, :, None].to(w.dtype))
    return w


def mask_shard(mask: torch.Tensor, dim: int, s: int, tp: int,
               name: str = "") -> torch.Tensor:
    """Shard ``s`` of ``tp`` of a mask along its tile axis ``dim``: the
    tiles of a model rank's columns (w1/w3) or rows (w2), contiguous. A
    tile may not straddle two ranks: the cut dim over tp must be a
    multiple of the tile."""
    if mask.shape[dim] % tp:
        raise ValueError(
            f"SASP mask {name}: {mask.shape[dim]} tiles do not split over "
            f"{tp} model ranks (the cut dim over tp must be a multiple of "
            f"the tile)")
    k = mask.shape[dim] // tp
    return mask.narrow(dim, s * k, k).contiguous()


def default_ffn_predicate(path: Path) -> bool:
    """Paper scope: feed-forward GEMMs only."""
    keys = path_str(path)
    return ("ffn" in keys or "moe" in keys) and keys.endswith("/w")


def all_gemm_predicate(path: Path) -> bool:
    keys = path_str(path)
    if "emb" in keys or "norm" in keys or "router" in keys:
        return False
    return keys.endswith("/w") or any(
        keys.endswith(s) for s in ("wq/w", "wk/w", "wv/w", "wo/w"))


def scope_predicate(sasp: SASPConfig) -> Callable[[Path], bool]:
    return default_ffn_predicate if sasp.scope == "ffn" else \
        all_gemm_predicate


def prunable_blocks(path: Path, leaf, sasp: SASPConfig,
                    is_prunable: Callable[[Path], bool]
                    ) -> Optional[Tuple[int, int]]:
    """The (bk, bn) tiles of a prunable leaf, or None."""
    if not isinstance(leaf, torch.Tensor) or leaf.ndim < 2:
        return None
    if not is_prunable(path):
        return None
    K, N = leaf.shape[-2], leaf.shape[-1]
    if not K or not N:
        # an empty matrix (mamba2's d_ff = 0 FFN) holds no tiles; the
        # reference divides by its zero width here and raises
        return None
    bk, bn = effective_blocks((K, N), sasp.block_k, sasp.block_n)
    if K % bk or N % bn:
        return None
    return bk, bn


def find_prunable(params: Params, sasp: SASPConfig,
                  is_prunable: Callable[[Path], bool]
                  ) -> List[Tuple[Path, torch.Tensor, int, int]]:
    out = []
    for path, leaf in iter_leaves(params):
        blocks = prunable_blocks(path, leaf, sasp, is_prunable)
        if blocks is not None:
            out.append((path, leaf) + blocks)
    return out


def masks_from_scores(scores: List[Tuple[Path, torch.Tensor]],
                      sparsity: float) -> Dict[Path, torch.Tensor]:
    """{path: bool mask} from each prunable leaf's tile scores, in the
    reference's leaf order: the lowest ``floor(sparsity × total)`` tiles
    model-wide pruned, ties by a stable sort."""
    if not scores:
        return {}
    all_scores = torch.cat([s.reshape(-1) for _, s in scores])
    total = all_scores.numel()
    n_prune = int(np.floor(sparsity * total))
    keep = torch.ones((total,), dtype=torch.bool, device=all_scores.device)
    if n_prune:
        order = torch.argsort(all_scores, stable=True)
        keep[order[:n_prune]] = False
    masks: Dict[Path, torch.Tensor] = {}
    off = 0
    for path, s in scores:
        masks[path] = keep[off:off + s.numel()].reshape(s.shape)
        off += s.numel()
    return masks


def compute_sasp_masks(params: Params, sasp: SASPConfig,
                       is_prunable: Optional[Callable] = None
                       ) -> Dict[Path, torch.Tensor]:
    """{path: bool mask (..., KB, NB)} with exactly
    ``floor(sparsity × total_tiles)`` tiles pruned model-wide."""
    pred = is_prunable or scope_predicate(sasp)
    return masks_from_scores(
        [(path, tile_l1(w, bk, bn))
         for path, w, bk, bn in find_prunable(params, sasp, pred)],
        sasp.sparsity)


def prune_params(params: Params, sasp: SASPConfig,
                 is_prunable: Optional[Callable] = None
                 ) -> Tuple[Params, Dict[Path, torch.Tensor]]:
    """Zero the pruned tiles (masked-dense path) and return the masks."""
    masks = compute_sasp_masks(params, sasp, is_prunable)
    if not masks:
        return params, masks

    def maybe_prune(path, leaf):
        if path in masks:
            return apply_block_mask(leaf, masks[path])
        return leaf

    return map_leaves(maybe_prune, params), masks


def mask_sparsity(masks: Dict[Path, torch.Tensor]) -> float:
    total = sum(int(np.prod(tuple(m.shape))) for m in masks.values())
    kept = sum(int(torch.as_tensor(m).sum()) for m in masks.values())
    return 1.0 - kept / max(total, 1)


def per_matrix_sparsity(masks: Dict[Path, torch.Tensor]
                        ) -> Dict[str, float]:
    """Pruned share of each weight, named as the reference names it
    (dict keys as they are, sequence indices as ``[i]``)."""
    out = {}
    for path, m in masks.items():
        name = "/".join(f"[{k}]" if isinstance(k, int) else str(k)
                        for k in path)
        out[name] = 1.0 - float(torch.as_tensor(m).to(torch.float32)
                                .mean())
    return out


# ---------------------------------------------------------------------------
# Pruning schedule (gradual magnitude pruning for train-time SASP)
# ---------------------------------------------------------------------------


def cubic_sparsity_schedule(step: int, *, start_step: int, end_step: int,
                            final_sparsity: float) -> float:
    """Zhu & Gupta cubic ramp: s(t) = s_f (1 - (1 - t)^3)."""
    if step <= start_step:
        return 0.0
    if step >= end_step:
        return final_sparsity
    t = (step - start_step) / max(1, end_step - start_step)
    return final_sparsity * (1.0 - (1.0 - t) ** 3)
