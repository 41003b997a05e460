"""Bring the reference package's parameters into the port.

The caller converts a reference tree (from ``repro.models.lm.init_params``
or ``repro.core.deploy.deploy_packed``) to numpy first — e.g. with
``jax.tree.map(np.asarray, tree)`` — so this module never touches jax.
Dicts and tuples keep their structure (the stacked leading layer axis of
``segments[i]["slot<j>"]`` included); numpy arrays become tensors on
``device``; packed containers, recognised by their fields, become the
port's ``PackedSASPWeight`` / ``PackedFFN`` / ``BlockSparseWeight`` /
``QuantizedWeight`` (TP-sharded ones keep ``shards`` / ``shard_kind``);
the reference optimizer's ``AdamWState`` and
``QMoment``, recognised by their fields, become the port's.
``to_numpy`` goes the other way: port tree -> numpy arrays in the same
dicts, tuples and NamedTuples, which the reference's functions take as
they are (its ``adamw_update`` reads ``.step`` / ``.m`` / ``.v`` and
``.q`` / ``.scale``).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core.quantization import QuantizedWeight
from repro_torch.core.sparse import (BlockSparseWeight, PackedFFN,
                                     PackedSASPWeight)
from repro_torch.train.optimizer import AdamWState, QMoment


def to_tensor(a, device="cuda"):
    if a is None:
        return None
    return torch.from_numpy(np.array(a)).to(device)


def _is_packed_weight(node) -> bool:
    return all(hasattr(node, f) for f in ("vals", "kn", "shape", "block"))


def _is_packed_ffn(node) -> bool:
    return all(hasattr(node, f) for f in ("w1v", "w3v", "w2v", "block_f"))


def _is_bsr(node) -> bool:
    return all(hasattr(node, f) for f in ("vals", "idx", "shape", "block"))


def _is_quantized(node) -> bool:
    return all(hasattr(node, f) for f in ("q", "scale", "block"))


def _fields(node):
    return getattr(node, "_fields", None) if isinstance(node, tuple) \
        else None


def from_numpy(tree, device="cuda"):
    """Numpy-converted reference tree -> port tree on ``device``."""
    if isinstance(tree, dict):
        return {k: from_numpy(v, device) for k, v in tree.items()}
    if _fields(tree) == ("step", "m", "v"):
        return AdamWState(*(from_numpy(v, device) for v in tree))
    if _fields(tree) == ("q", "scale"):
        return QMoment(*(from_numpy(v, device) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(from_numpy(v, device) for v in tree)
    if _is_packed_weight(tree):
        t = functools.partial(to_tensor, device=device)
        return PackedSASPWeight(t(tree.vals), t(tree.kn), tuple(tree.shape),
                                tuple(tree.block), scale=t(tree.scale),
                                bias=t(tree.bias), act=tree.act,
                                shards=tree.shards,
                                shard_kind=tree.shard_kind)
    if _is_packed_ffn(tree):
        t = functools.partial(to_tensor, device=device)
        return PackedFFN(t(tree.w1v), t(tree.w3v), t(tree.w2v), t(tree.b1),
                         t(tree.b3), t(tree.b2), d_model=tree.d_model,
                         d_ff=tree.d_ff, block_f=tree.block_f, act=tree.act,
                         s1=t(tree.s1), s3=t(tree.s3), s2=t(tree.s2),
                         shards=tree.shards, jv=t(tree.jv))
    if _is_bsr(tree):
        t = functools.partial(to_tensor, device=device)
        return BlockSparseWeight(t(tree.vals), t(tree.idx), tuple(tree.shape),
                                 tuple(tree.block), scale=t(tree.scale))
    if _is_quantized(tree):
        return QuantizedWeight(to_tensor(tree.q, device),
                               to_tensor(tree.scale, device),
                               tuple(tree.block))
    if isinstance(tree, (np.ndarray, np.generic)):
        return to_tensor(tree, device)
    return tree


def to_numpy(tree):
    """Port tree of tensors -> the same structure of numpy arrays
    (bfloat16 widened to float32, exactly); packed containers keep their
    type and static fields (``shards``, ``shard_kind`` …) with numpy
    arrays in their array fields, which ``from_numpy`` reads back."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (PackedSASPWeight, PackedFFN)):
        return dataclasses.replace(tree, **{
            f.name: to_numpy(getattr(tree, f.name))
            for f in dataclasses.fields(tree)
            if isinstance(getattr(tree, f.name), torch.Tensor)})
    if _fields(tree):
        return type(tree)(*(to_numpy(v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.numpy()
    return tree
