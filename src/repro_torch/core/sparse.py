"""Packed serving containers of the port — the same visit-list format as
the reference (``repro.core.sparse``), held as plain dataclasses of
tensors.

``PackedSASPWeight`` stores the surviving (bk, bn) blocks of one (K, N)
matrix as visits sorted by (n, k): vals (…, nnz, bk, bn) fp32/bf16 or
int8 with per-visit ``scale`` (…, nnz); kn (…, 2, nnz) int32 [k; n]
block coordinates; optional ``bias`` (…, N) and ``act`` fused into the
flush. Every output column-block has at least one visit (an empty column
carries one zero block), and per-layer lists stacked on a leading layer
axis are padded to one nnz by repeating the last visit with zero
blocks. ``col_ptr`` (…, NB + 1) int32 is derived from ``kn`` at load
(``col_ptr[n]`` = first visit of column-block n): the CUDA kernel gives
each output tile to one thread block, which walks that column's visits.

``PackedFFN`` stores the surviving d_ff column-blocks of a gated FFN:
w1v/w3v (…, nv, d, bf), w2v (…, nv, bf, d), b1/b3 (…, nv, bf), b2
(…, d), optional int8 scales s1/s3/s2 (…, nv), and jv (…, nv) the d_ff
block index of each visit (-1 for padding, whose w2v is zero).

``BlockSparseWeight`` (BSR) is the container of the ``bsr`` and
``kernel`` paths: vals (…, k_max, NB, bk, bn) the surviving blocks of
each output column-block in ascending k order, padded with zero blocks
of idx 0 to one depth ``k_max``; idx (…, k_max, NB) int32 their k-block;
int8 vals carry a scale (…, k_max, NB) per (j, n) block. Built offline
in numpy (``bsr_from_mask``), so it equals the reference's arrays.

TP sharding (``shards > 1``, ``core.deploy`` with ``tp``): every array
of a container carries a shard axis right before its visit dims — vals
(…, tp, nnz, bk, bn), kn (…, tp, 2, nnz), scale (…, tp, nnz); PackedFFN
w1v (…, tp, nv, d, bf), b1 (…, tp, nv, bf), jv (…, tp, nv) — holding one
shard-local visit list per TP rank, all padded to one nnz / nv.
``shard_kind="col"`` splits by output-column block (kn n-coordinates
shard-local, bias (…, tp, N/tp) fused into each shard's flush, outputs
concatenate); ``"row"`` by input-row block (k-coordinates shard-local,
outputs partial: bias (…, N) stays whole, is added after the reduction,
and a row shard never carries ``act``). A PackedFFN shards its d_ff
visits contiguously (partials, b2 whole, added once). ``col_ptr`` is
per shard. A rank's local tree (``distribution.sharding``) keeps the
shard axis at length 1: ``held`` is the number of shards a container
holds, ``shard(s)`` the unsharded container of one of them. Every field
shared with the reference container holds exactly the reference's
values.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch


def col_ptr_from_kn(kn: torch.Tensor, nb: int) -> torch.Tensor:
    """(…, 2, nnz) visits sorted by n -> (…, nb + 1) int32 CSR offsets."""
    n = kn[..., 1, :].contiguous().to(torch.int64)
    bounds = torch.arange(nb + 1, device=kn.device, dtype=torch.int64)
    bounds = bounds.expand(*n.shape[:-1], nb + 1).contiguous()
    return torch.searchsorted(n, bounds).to(torch.int32)


def _pick(a: Optional[torch.Tensor], s: int, from_end: int):
    """Index ``s`` of the shard axis, ``from_end`` dims before the end."""
    return None if a is None else a.select(a.ndim - from_end, s)


@dataclasses.dataclass
class PackedSASPWeight:
    vals: torch.Tensor
    kn: torch.Tensor
    shape: Tuple[int, int]
    block: Tuple[int, int]
    scale: Optional[torch.Tensor] = None
    bias: Optional[torch.Tensor] = None
    act: Optional[str] = None
    shards: int = 1
    shard_kind: Optional[str] = None
    col_ptr: Optional[torch.Tensor] = None

    def __post_init__(self):
        if self.col_ptr is None:
            nb = self.shape[1] // self.block[1]
            if self.shard_kind == "col":
                nb //= self.shards
            self.col_ptr = col_ptr_from_kn(self.kn, nb)

    @property
    def nnz(self) -> int:
        return self.vals.shape[-3]

    def layer(self, i: int) -> "PackedSASPWeight":
        """The container of layer ``i`` of a layer-stacked pack."""
        return dataclasses.replace(
            self, vals=self.vals[i], kn=self.kn[i],
            scale=None if self.scale is None else self.scale[i],
            bias=None if self.bias is None else self.bias[i],
            col_ptr=self.col_ptr[i])

    @property
    def held(self) -> int:
        """Shards this container holds: ``shards``, or 1 in a rank's
        local tree."""
        return self.vals.shape[-4] if self.shards > 1 else 1

    def shard(self, s: int) -> "PackedSASPWeight":
        """The unsharded container of held shard ``s``: a col shard's
        (K, N/tp) columns with their bias and act; a row shard's
        (K/tp, N) rows, partial, with neither bias nor act."""
        K, N = self.shape
        tp = self.shards
        col = self.shard_kind == "col"
        return PackedSASPWeight(
            _pick(self.vals, s, 4), _pick(self.kn, s, 3),
            (K, N // tp) if col else (K // tp, N), self.block,
            scale=_pick(self.scale, s, 2),
            bias=_pick(self.bias, s, 2) if col else None,
            act=self.act if col else None,
            col_ptr=_pick(self.col_ptr, s, 2))

    def nbytes(self) -> int:
        b = self.vals.numel() * self.vals.element_size() + self.kn.numel() * 4
        if self.scale is not None:
            b += self.scale.numel() * 4
        if self.bias is not None:
            b += self.bias.numel() * 4
        return b


@dataclasses.dataclass
class PackedFFN:
    w1v: torch.Tensor
    w3v: torch.Tensor
    w2v: torch.Tensor
    b1: torch.Tensor
    b3: torch.Tensor
    b2: torch.Tensor
    d_model: int
    d_ff: int
    block_f: int
    act: str
    s1: Optional[torch.Tensor] = None
    s3: Optional[torch.Tensor] = None
    s2: Optional[torch.Tensor] = None
    shards: int = 1
    jv: Optional[torch.Tensor] = None

    @property
    def nv(self) -> int:
        return self.w1v.shape[-3]

    def layer(self, i: int) -> "PackedFFN":
        def pick(a):
            return None if a is None else a[i]
        return dataclasses.replace(
            self, w1v=self.w1v[i], w3v=self.w3v[i], w2v=self.w2v[i],
            b1=self.b1[i], b3=self.b3[i], b2=self.b2[i], s1=pick(self.s1),
            s3=pick(self.s3), s2=pick(self.s2), jv=pick(self.jv))

    @property
    def held(self) -> int:
        """Shards this container holds: ``shards``, or 1 in a rank's
        local tree."""
        return self.w1v.shape[-4] if self.shards > 1 else 1

    def shard(self, s: int) -> "PackedFFN":
        """The unsharded container of held d_ff shard ``s``, with a zero
        b2: its output is a partial, and b2 is added once after the
        reduction."""
        return dataclasses.replace(
            self, w1v=_pick(self.w1v, s, 4), w3v=_pick(self.w3v, s, 4),
            w2v=_pick(self.w2v, s, 4), b1=_pick(self.b1, s, 3),
            b3=_pick(self.b3, s, 3), b2=torch.zeros_like(self.b2),
            s1=_pick(self.s1, s, 2), s3=_pick(self.s3, s, 2),
            s2=_pick(self.s2, s, 2), jv=_pick(self.jv, s, 2), shards=1)


@dataclasses.dataclass
class BlockSparseWeight:
    vals: torch.Tensor
    idx: torch.Tensor
    shape: Tuple[int, int]
    block: Tuple[int, int]
    scale: Optional[torch.Tensor] = None

    @property
    def k_max(self) -> int:
        return self.vals.shape[-4]

    def layer(self, i: int) -> "BlockSparseWeight":
        """The container of layer ``i`` of a layer-stacked BSR."""
        return dataclasses.replace(
            self, vals=self.vals[i], idx=self.idx[i],
            scale=None if self.scale is None else self.scale[i])


def bsr_from_mask(w: np.ndarray, mask: np.ndarray, bk: int, bn: int, *,
                  quantize: bool = False, k_max: Optional[int] = None,
                  device="cuda") -> BlockSparseWeight:
    """Offline (numpy) BSR of one (K, N) weight with a (KB, NB) keep-mask,
    moved to ``device``: column n's kept k-blocks in ascending order at
    depths 0, 1, …, the rest zero blocks of idx 0. int8 rounds per (j, n)
    block. ``k_max`` forces the padded depth (layer stacks share one)."""
    K, N = w.shape
    KB, NB = K // bk, N // bn
    mask = np.asarray(mask, dtype=bool)
    assert mask.shape == (KB, NB), (mask.shape, (KB, NB))
    counts = mask.sum(axis=0)
    needed = int(counts.max()) if counts.size else 0
    k_max = max(needed, 1) if k_max is None else k_max
    assert k_max >= needed, (k_max, needed)

    ns, ks = np.nonzero(mask.T)                 # sorted by (n, k)
    start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    js = np.arange(ns.size) - start[ns]
    wb = np.asarray(w, dtype=np.float32).reshape(KB, bk, NB, bn)
    vals = np.zeros((k_max, NB, bk, bn), dtype=np.float32)
    idx = np.zeros((k_max, NB), dtype=np.int32)
    vals[js, ns] = wb[ks, :, ns, :]
    idx[js, ns] = ks

    scale = None
    if quantize:
        amax = np.abs(vals).max(axis=(2, 3))
        scale = np.maximum(amax, 1e-12) / 127.0
        vals = np.clip(np.round(vals / scale[:, :, None, None]),
                       -127, 127).astype(np.int8)

    def t(a):
        return None if a is None else torch.from_numpy(a).to(device)
    return BlockSparseWeight(t(vals), t(idx), (K, N), (bk, bn), t(scale))


def stack_bsr(bsrs: Sequence[BlockSparseWeight]) -> BlockSparseWeight:
    """Per-layer BSRs of one shape, block and k_max -> one container with
    a leading layer axis."""
    b0 = bsrs[0]
    return BlockSparseWeight(
        torch.stack([b.vals for b in bsrs]),
        torch.stack([b.idx for b in bsrs]), b0.shape, b0.block,
        None if b0.scale is None else torch.stack([b.scale for b in bsrs]))


def _bsr_float_vals(w: BlockSparseWeight) -> torch.Tensor:
    """vals with int8 blocks dequantized by their scales (fp32)."""
    if w.scale is None:
        return w.vals
    return w.vals.to(torch.float32) * w.scale[:, :, None, None]


def bsr_matmul(x: torch.Tensor, w: BlockSparseWeight) -> torch.Tensor:
    """x (M, K) @ BSR (K, N) -> (M, N) in x's type, skipping pruned tiles:
    for j = 0 … k_max-1 in order, gather one k-block of x per output
    column-block and add the batched (M, bk) @ (bk, bn) products in fp32
    (blocks rounded to x's type first)."""
    K, N = w.shape
    bk, bn = w.block
    KB, NB = K // bk, N // bn
    M = x.shape[0]
    xb = x.reshape(M, KB, bk).permute(1, 0, 2).to(torch.float32)
    vals = _bsr_float_vals(w).to(x.dtype).to(torch.float32)
    idx = w.idx.to(torch.int64)
    acc = torch.zeros((NB, M, bn), dtype=torch.float32, device=x.device)
    for j in range(w.k_max):
        acc = acc + torch.bmm(xb[idx[j]], vals[j])
    return acc.permute(1, 0, 2).reshape(M, N).to(x.dtype)


def bsr_to_dense(w: BlockSparseWeight) -> torch.Tensor:
    """The dense fp32 (K, N) a BSR stands for (padding adds zero)."""
    K, N = w.shape
    bk, bn = w.block
    KB, NB = K // bk, N // bn
    vals = _bsr_float_vals(w).to(torch.float32)
    dense = torch.zeros((KB, NB, bk, bn), dtype=torch.float32,
                        device=vals.device)
    nb = torch.arange(NB, device=vals.device)
    for j in range(w.k_max):
        dense.index_put_((w.idx[j].to(torch.int64), nb), vals[j],
                         accumulate=True)
    return dense.permute(0, 2, 1, 3).reshape(K, N)
