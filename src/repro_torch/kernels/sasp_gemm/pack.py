"""Offline visit-list packers for the tile-skip GEMM and the fused gated
FFN — the reference packers' arithmetic, in torch on the weights' device
(``core.deploy`` packs on the card). A caller that passes numpy arrays
gets numpy arrays back, as from the reference.

The visit-order convention, the empty-column flush visit and the
dup-last-visit padding are the container format (see
``repro_torch.core.sparse``); both packages build it with the same
arithmetic (gathers, and int8 scales and rounding by true fp32
division), so their containers are equal array for array.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch


def _numpy_io(fn):
    """Run ``fn`` on tensors; numpy in (its first argument), numpy out."""
    def conv(a, to_np):
        if isinstance(a, (tuple, list)):
            return type(a)(conv(x, to_np) for x in a)
        if to_np:
            return a.numpy() if isinstance(a, torch.Tensor) else a
        return torch.from_numpy(np.ascontiguousarray(a)) \
            if isinstance(a, np.ndarray) else a

    @functools.wraps(fn)
    def wrapped(*args, **kw):
        if not isinstance(args[0], np.ndarray):
            return fn(*args, **kw)
        out = fn(*conv(args, False),
                 **{k: conv(v, False) for k, v in kw.items()})
        return conv(out, True)
    return wrapped


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


def quantize_visits(v: torch.Tensor):
    """int8 per visit (dim 0): scale max(|v|, 1e-12) / 127, values
    rounded half to even and clipped to ±127. Every division is by a
    tensor: CUDA divides by a Python scalar through its reciprocal, which
    may differ in the last bit."""
    amax = v.abs().amax(dim=tuple(range(1, v.ndim)))
    s = amax.clamp_min(1e-12) / torch.full_like(amax, 127.0)
    q = torch.round(v / s.reshape((-1,) + (1,) * (v.ndim - 1)))
    return q.clamp_(-127, 127).to(torch.int8), s


@_numpy_io
def build_kernel_weight(w, mask, bk: int, bn: int, *,
                        quantize: bool = False):
    """(vals (nnz, bk, bn), kn (2, nnz) int32, scales (nnz,) or None) on
    w's device. Flush visits of empty columns carry zero blocks."""
    w = w.to(torch.float32)
    mask = mask.to(device=w.device, dtype=torch.bool)
    K, N = w.shape
    KB, NB = K // bk, N // bn
    kn = torch.from_numpy(kernel_block_list(mask.cpu().numpy())
                          ).to(w.device)
    if kn.shape[1]:
        ks, ns = kn.long()
        # the (k, n) blocks in visit order; flush visits carry zeros
        vals = w.reshape(KB, bk, NB, bn).permute(0, 2, 1, 3)[ks, ns]
        vals[~mask[ks, ns]] = 0.0
    else:
        vals = w.new_zeros((1, bk, bn))
    if not quantize:
        return vals, kn, None
    q, scales = quantize_visits(vals)
    return q, kn, scales


@_numpy_io
def pad_block_list(vals, kn, scales, nnz_to: int):
    """Pad a visit list to ``nnz_to`` entries by repeating the LAST
    visit's (k, n) with zero-valued blocks (and zero scales): the
    appended visits share the final n-block, so they add exactly
    nothing."""
    nnz = vals.shape[0]
    assert nnz_to >= nnz, (nnz_to, nnz)
    pad = nnz_to - nnz
    if not pad:
        return vals, kn, scales
    vals = torch.cat([vals, vals.new_zeros((pad,) + tuple(vals.shape[1:]))])
    kn = torch.cat([kn, kn[:, -1:].expand(2, pad)], dim=1)
    if scales is not None:
        scales = torch.cat([scales, scales.new_zeros((pad,))])
    return vals, kn, scales


@_numpy_io
def build_fused_ffn(w1, w3, w2, *, block_f: int, b1=None, b3=None,
                    b2=None, quantize: bool = False,
                    nv_pad: Optional[int] = None,
                    return_visits: bool = False):
    """Pack a gated FFN (pruned tiles already zeroed) for the fused
    kernel, on w1's device. A d_ff column-block j is visited iff its w2
    row-block survives and both up-projection columns (or their biases)
    do. Returns (w1v, w3v, w2v, b1v, b3v, b2, scales[, jv]) — scales is
    None or per-visit (s1, s3, s2); jv is the d_ff block index of each
    visit (-1 for padding)."""
    w1, w3, w2 = (a.to(torch.float32) for a in (w1, w3, w2))
    d, F = w1.shape
    assert w3.shape == (d, F) and w2.shape == (F, d), (
        w1.shape, w3.shape, w2.shape)
    bf = block_f
    assert F % bf == 0, (F, bf)
    FB = F // bf

    def vec(b, n):
        return w1.new_zeros((n,)) if b is None else \
            b.to(device=w1.device, dtype=torch.float32)

    b1, b3, b2 = vec(b1, F), vec(b3, F), vec(b2, d)
    # (FB, …) views of the d_ff blocks
    w1b = w1.reshape(d, FB, bf).permute(1, 0, 2)
    w3b = w3.reshape(d, FB, bf).permute(1, 0, 2)
    w2b = w2.reshape(FB, bf, d)
    b1b, b3b = b1.reshape(FB, bf), b3.reshape(FB, bf)
    live = ((w2b != 0).any(dim=(1, 2))
            & ((w1b != 0).any(dim=(1, 2)) | (b1b != 0).any(dim=1))
            & ((w3b != 0).any(dim=(1, 2)) | (b3b != 0).any(dim=1)))
    keep = torch.nonzero(live).flatten()

    if keep.numel():
        jv = keep.to(torch.int32)
        w1v, w3v, w2v, b1v, b3v = (a[keep] for a in (w1b, w3b, w2b, b1b,
                                                     b3b))
    else:
        # all of d_ff pruned: one zero visit, so the output is exactly b2
        jv = torch.full((1,), -1, dtype=torch.int32, device=w1.device)
        w1v = w1.new_zeros((1, d, bf))
        w3v = w1.new_zeros((1, d, bf))
        w2v = w1.new_zeros((1, bf, d))
        b1v = w1.new_zeros((1, bf))
        b3v = w1.new_zeros((1, bf))

    if nv_pad is not None:
        nv = w1v.shape[0]
        assert nv_pad >= nv, (nv_pad, nv)
        if nv_pad > nv:
            pad = nv_pad - nv

            def z(a):
                return torch.cat([a, a.new_zeros((pad,) + tuple(
                    a.shape[1:]))])
            w1v, w3v, w2v, b1v, b3v = (z(a) for a in (w1v, w3v, w2v, b1v,
                                                      b3v))
            jv = torch.cat([jv, jv.new_full((pad,), -1)])

    scales = None
    if quantize:
        (w1v, s1), (w3v, s3), (w2v, s2) = (quantize_visits(v)
                                           for v in (w1v, w3v, w2v))
        scales = (s1, s3, s2)

    out = (w1v, w3v, w2v, b1v, b3v, b2, scales)
    if return_visits:
        out = out + (jv,)
    return out
