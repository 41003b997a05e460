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

The single-device port has ``shards == 1``; every field shared with the
reference container holds exactly the reference's values.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


def col_ptr_from_kn(kn: torch.Tensor, nb: int) -> torch.Tensor:
    """(…, 2, nnz) visits sorted by n -> (…, nb + 1) int32 CSR offsets."""
    n = kn[..., 1, :].contiguous().to(torch.int64)
    bounds = torch.arange(nb + 1, device=kn.device, dtype=torch.int64)
    bounds = bounds.expand(*n.shape[:-1], nb + 1).contiguous()
    return torch.searchsorted(n, bounds).to(torch.int32)


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
