"""Abstract SASP-BSR params for the dry run's ``--sasp`` / ``--quant``
variants (the reference's ``launch/sasp_abstract.py``).

Adds to each dense FFN of a fake params tree (``launch/specs.py``) a
``BlockSparseWeight`` of fake tensors per matrix whose depth ``k_max`` is
round((1 - sparsity) · KB): the traced step then carries the tile-skip
FLOP and byte savings of the ``bsr`` path (plain torch, ``core/sparse.py::
bsr_matmul``) with no real weights. With ``quantize`` the block values are
int8 with one fp32 scale per block (the paper's FP32_INT8 setting).
``distribution/sharding.py::local_params`` then cuts each container's
column blocks over 'model' and drops the dense ``w`` it replaces.

The trace runs on fake CPU tensors, so no CUDA kernel wrapper builds or
launches anything, and the kernels' own workspaces (visit lists, the
fused FFN's schedule, a repacked BSR) are not counted in the rank's
memory.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.sparse import BlockSparseWeight


def _abstract_bsr(shape: Tuple[int, ...], bk: int, bn: int,
                  sparsity: float, dtype) -> BlockSparseWeight:
    *lead, K, N = shape
    bk, bn = min(bk, K), min(bn, N)
    KB, NB = K // bk, N // bn
    k_max = max(1, round((1.0 - sparsity) * KB))
    return BlockSparseWeight(
        vals=torch.zeros((*lead, k_max, NB, bk, bn), dtype=dtype),
        idx=torch.zeros((*lead, k_max, NB), dtype=torch.int32),
        shape=(K, N), block=(bk, bn), scale=None)


def _pick_bn(N: int, model_size: int, prefer: int = 128) -> int:
    """Largest MXU-friendly block_n (multiple of 64, ≤ 2×prefer) whose
    block count divides the TP axis — otherwise the BSR value tensor
    can't shard over 'model' and replicates (the reference's rule, kept
    so that both dry runs place the same containers)."""
    for bn in (prefer, 256, 192, 64, 512, 320):
        if N % bn == 0 and (N // bn) % model_size == 0:
            return bn
    for bn in (prefer, 64):
        if N % bn == 0:
            return bn
    return N


def abstract_bsr_params(params: Any, cfg: ModelConfig, sparsity: float,
                        quantize: bool = False, model_axis: int = 16):
    """Returns (the fake tree with a ``sasp_bsr`` entry beside each dense
    FFN stack, cfg with sasp.path='bsr'); call it under the fake mode the
    tree was drawn in. Expert stacks keep their dense matrices, as in the
    reference."""
    sasp = dataclasses.replace(cfg.sasp, enabled=True, sparsity=sparsity,
                               path="bsr", quantize=quantize)
    cfg2 = dataclasses.replace(cfg, sasp=sasp)
    bk = sasp.block_k

    def rewrite(node):
        if isinstance(node, tuple):
            return tuple(rewrite(v) for v in node)
        if not isinstance(node, dict):
            return node
        if ("w1" in node and "w2" in node and "router" not in node
                and isinstance(node.get("w1"), dict)
                and getattr(node["w1"].get("w"), "ndim", 0) == 3):
            out = dict(node)
            bsr = {}
            for mat in ("w1", "w2", "w3"):
                if mat not in node:
                    continue
                w = node[mat]["w"]
                L, K, N = w.shape
                b = _abstract_bsr((L, K, N), bk,
                                  _pick_bn(N, model_axis, sasp.block_n),
                                  sparsity,
                                  torch.int8 if quantize else w.dtype)
                if quantize:
                    b = dataclasses.replace(b, scale=torch.zeros(
                        b.idx.shape, dtype=torch.float32))
                bsr[mat] = b
            out["sasp_bsr"] = bsr
            return out
        return {k: rewrite(v) for k, v in node.items()}

    return rewrite(params), cfg2
