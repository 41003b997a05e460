"""Offline (numpy) visit-list packers for the tile-skip GEMM and the
fused gated FFN — copies of the reference packers, returning numpy.

The visit-order convention, the empty-column flush visit and the
dup-last-visit padding are the container format (see
``repro_torch.core.sparse``); both packages build it with the same numpy
arithmetic, so their containers are equal array for array.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def flush_sorted_order(ks: np.ndarray, ns: np.ndarray, nb: int):
    """Append a k=0 flush entry for every output column in [0, nb) with
    no visit (so every output block initialises and flushes exactly
    once), then sort by (n, k). Returns (ks', ns', order, n_flush);
    callers append ``n_flush`` zero-valued blocks before applying
    ``order``."""
    empty = np.setdiff1d(np.arange(nb), np.unique(ns))
    if empty.size:
        ks = np.concatenate([ks, np.zeros_like(empty)])
        ns = np.concatenate([ns, empty])
    return ks, ns, np.lexsort((ks, ns)), int(empty.size)


def kernel_block_list(mask: np.ndarray) -> np.ndarray:
    """(2, nnz') visit list sorted by (n, k); empty output column-blocks
    get one zero-valued k=0 entry."""
    mask = np.asarray(mask, dtype=bool)
    KB, NB = mask.shape
    ks, ns = np.nonzero(mask)
    ks, ns, order, _ = flush_sorted_order(ks, ns, NB)
    return np.stack([ks[order], ns[order]]).astype(np.int32)


def build_kernel_weight(w: np.ndarray, mask: np.ndarray, bk: int, bn: int,
                        *, quantize: bool = False):
    """(vals (nnz, bk, bn), kn (2, nnz), scales (nnz,) or None). Flush
    visits of empty columns carry zero blocks."""
    w = np.asarray(w, np.float32)
    mask = np.asarray(mask, bool)
    K, N = w.shape
    KB, NB = K // bk, N // bn
    kn = kernel_block_list(mask)
    wb = w.reshape(KB, bk, NB, bn)
    vals = np.stack([
        wb[k, :, n, :] if mask[k, n] else np.zeros((bk, bn), np.float32)
        for k, n in kn.T
    ]) if kn.shape[1] else np.zeros((1, bk, bn), np.float32)
    if not quantize:
        return vals, kn, None
    amax = np.abs(vals).max(axis=(1, 2))
    scales = (np.maximum(amax, 1e-12) / 127.0).astype(np.float32)
    q = np.clip(np.round(vals / scales[:, None, None]), -127, 127
                ).astype(np.int8)
    return q, kn, scales


def pad_block_list(vals: np.ndarray, kn: np.ndarray,
                   scales: Optional[np.ndarray], nnz_to: int):
    """Pad a visit list to ``nnz_to`` entries by repeating the LAST
    visit's (k, n) with zero-valued blocks (and zero scales): the
    appended visits share the final n-block, so they add exactly
    nothing."""
    nnz = vals.shape[0]
    assert nnz_to >= nnz, (nnz_to, nnz)
    if nnz_to == nnz:
        return vals, kn, scales
    pad = nnz_to - nnz
    vals = np.concatenate(
        [vals, np.zeros((pad,) + vals.shape[1:], vals.dtype)])
    kn = np.concatenate([kn, np.repeat(kn[:, -1:], pad, axis=1)], axis=1)
    if scales is not None:
        scales = np.concatenate([scales, np.zeros((pad,), scales.dtype)])
    return vals, kn, scales


def build_fused_ffn(w1: np.ndarray, w3: np.ndarray, w2: np.ndarray, *,
                    block_f: int, b1=None, b3=None, b2=None,
                    quantize: bool = False, nv_pad: Optional[int] = None,
                    return_visits: bool = False):
    """Pack a gated FFN (pruned tiles already zeroed) for the fused
    kernel. A d_ff column-block j is visited iff its w2 row-block
    survives and both up-projection columns (or their biases) do.
    Returns (w1v, w3v, w2v, b1v, b3v, b2, scales[, jv]) — scales is None
    or per-visit (s1, s3, s2); jv is the d_ff block index of each visit
    (-1 for padding)."""
    w1 = np.asarray(w1, np.float32)
    w3 = np.asarray(w3, np.float32)
    w2 = np.asarray(w2, np.float32)
    d, F = w1.shape
    assert w3.shape == (d, F) and w2.shape == (F, d), (
        w1.shape, w3.shape, w2.shape)
    bf = block_f
    assert F % bf == 0, (F, bf)
    FB = F // bf
    b1 = np.zeros((F,), np.float32) if b1 is None else np.asarray(
        b1, np.float32)
    b3 = np.zeros((F,), np.float32) if b3 is None else np.asarray(
        b3, np.float32)
    b2 = np.zeros((d,), np.float32) if b2 is None else np.asarray(
        b2, np.float32)

    keep = []
    for j in range(FB):
        sl = slice(j * bf, (j + 1) * bf)
        if not np.any(w2[sl]):
            continue
        if not (np.any(w1[:, sl]) or np.any(b1[sl])):
            continue
        if not (np.any(w3[:, sl]) or np.any(b3[sl])):
            continue
        keep.append(j)

    jv = np.asarray(keep if keep else [-1], np.int32)
    if keep:
        w1v = np.stack([w1[:, j * bf:(j + 1) * bf] for j in keep])
        w3v = np.stack([w3[:, j * bf:(j + 1) * bf] for j in keep])
        w2v = np.stack([w2[j * bf:(j + 1) * bf] for j in keep])
        b1v = np.stack([b1[j * bf:(j + 1) * bf] for j in keep])
        b3v = np.stack([b3[j * bf:(j + 1) * bf] for j in keep])
    else:
        # all of d_ff pruned: one zero visit, so the output is exactly b2
        w1v = np.zeros((1, d, bf), np.float32)
        w3v = np.zeros((1, d, bf), np.float32)
        w2v = np.zeros((1, bf, d), np.float32)
        b1v = np.zeros((1, bf), np.float32)
        b3v = np.zeros((1, bf), np.float32)

    if nv_pad is not None:
        nv = w1v.shape[0]
        assert nv_pad >= nv, (nv_pad, nv)
        if nv_pad > nv:
            pad = nv_pad - nv
            w1v = np.concatenate([w1v, np.zeros((pad, d, bf), np.float32)])
            w3v = np.concatenate([w3v, np.zeros((pad, d, bf), np.float32)])
            w2v = np.concatenate([w2v, np.zeros((pad, bf, d), np.float32)])
            b1v = np.concatenate([b1v, np.zeros((pad, bf), np.float32)])
            b3v = np.concatenate([b3v, np.zeros((pad, bf), np.float32)])
            jv = np.concatenate([jv, np.full((pad,), -1, np.int32)])

    scales = None
    if quantize:
        def q(v):
            amax = np.abs(v).max(axis=tuple(range(1, v.ndim)))
            s = (np.maximum(amax, 1e-12) / 127.0).astype(np.float32)
            qv = np.clip(np.round(v / s.reshape((-1,) + (1,) * (v.ndim - 1))),
                         -127, 127).astype(np.int8)
            return qv, s
        w1v, s1 = q(w1v)
        w3v, s3 = q(w3v)
        w2v, s2 = q(w2v)
        scales = (s1, s3, s2)

    out = (w1v, w3v, w2v, b1v, b3v, b2, scales)
    if return_visits:
        out = out + (jv,)
    return out
