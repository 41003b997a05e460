"""Feed-forward layers of the port (``repro.models.ffn``), single device.

Paths:
  * dense — no SASP;
  * masked — pruned tiles zeroed in the dense weights, or a
    ``sasp_masks`` overlay; with int8 weights (``qw``) each matrix is
    dequantized in plain torch and multiplied densely, as the reference
    does;
  * bsr — ``BlockSparseWeight`` containers (``sasp_bsr``) through the
    gathered block matmul ``bsr_matmul``;
  * kernel — the same containers through the tile-skip kernel
    (``sasp_matmul``), repacked into a visit list on every call;
  * packed — the whole-FFN fused kernel when a ``PackedFFN``
    (``sasp_fused``) is attached, else the per-matrix tile-skip GEMMs
    (``sasp_packed``) with the activation folded into w1's flush.

TP-sharded containers (``shards > 1``) run through the TP paths below:
under an active mesh whose 'model' size is ``shards``, each rank runs
its own shard-local visit list (col shards give the rank's columns, row
shards and the fused FFN's d_ff shards a partial that ``_tp_reduce``
sums over the 'model' group, then the bias once); with no such mesh, a
loop runs every shard in one process and concatenates or sums. Partials
are summed in fp32, in shard order in the loop (with two shards the
all-reduce adds the same two terms, so the mesh equals the loop bit for
bit), then cast to the activation type. ``cfg.tp_comm == "rs_ag_int8"``
reduces with a reduce-scatter and an int8 all-gather instead
(``_rs_ag_int8``, plain torch as the reference's is jnp). Not ported:
``_bsr_mm_sharded`` and the dense ``_ffn_tp_rs_ag_int8`` (ROADMAP Queue 1
item 6e).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.pruning import apply_block_mask
from repro_torch.core.quantization import dequantize_int8
from repro_torch.core.sparse import bsr_matmul
from repro_torch.kernels.sasp_gemm.gemm import sasp_matmul
from repro_torch.models.modules import act_fn, as_dtype


def ffn_init(gen: torch.Generator, cfg: ModelConfig, *, layers: int,
             device, out_scale: float, d_ff: Optional[int] = None,
             draw=None) -> Dict:
    """Layer-stacked (layers, …) gated-FFN params; w2 is drawn at
    ``out_scale``. ``draw(name, shape, scale)``, where given, makes each
    matrix's stack (``lm.init_params`` draws a dense FFN layer by layer);
    otherwise each stack comes whole from ``gen`` (the MoE shared
    FFN)."""
    dt = as_dtype(cfg.param_dtype)
    d, f = cfg.d_model, d_ff or cfg.d_ff

    def normal(name, shape, scale):
        if draw is not None:
            return {"w": draw(name, shape, scale)}
        return {"w": (torch.randn((layers,) + shape, generator=gen,
                                  device=device, dtype=torch.float32)
                      * scale).to(dt)}

    p = {"w1": normal("w1", (d, f), 0.02),
         "w2": normal("w2", (f, d), out_scale)}
    if cfg.ffn_gated:
        p["w3"] = normal("w3", (d, f), 0.02)
    return p


def _materialize(p: Dict, name: str, dtype) -> torch.Tensor:
    entry = p[name]
    w = dequantize_int8(entry["qw"]) if "qw" in entry else entry["w"]
    masks = p.get("sasp_masks")
    if masks is not None and name in masks:
        w = apply_block_mask(w, masks[name])
    return w.to(dtype)


def _mm(p: Dict, name: str, x2: torch.Tensor, cfg: ModelConfig
        ) -> torch.Tensor:
    """(M, K) @ weight[name] through whatever SASP view is attached."""
    bsr = p.get("sasp_bsr")
    if bsr is not None and name in bsr:
        if cfg.sasp.path == "kernel":
            return sasp_matmul(x2, bsr[name])
        return bsr_matmul(x2, bsr[name])
    return torch.matmul(x2, _materialize(p, name, x2.dtype))


def _rs_ag_int8(y_part: torch.Tensor, out_dtype) -> torch.Tensor:
    """TP reduction of a partial (M, d) as reduce-scatter (fp32) + int8
    all-gather of the reduced slices with one scale per row and slice:
    3 bytes an element on the wire where an all-reduce moves 4. The
    rounding comes after the reduction, so no error accumulates."""
    from repro_torch.distribution import context as dctx
    y_rs = dctx.psum_scatter(y_part.to(torch.float32), 1)   # (M, d/tp)
    amax = torch.amax(torch.abs(y_rs), dim=1, keepdim=True)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(y_rs / scale), -127, 127).to(torch.int8)
    qg = dctx.all_gather(q, 1)
    sg = dctx.all_gather(scale, 1)                          # (M, tp)
    seg = torch.repeat_interleave(sg, y_rs.shape[1], dim=1)
    return (qg.to(torch.float32) * seg).to(out_dtype)


def _tp_reduce(y_part: torch.Tensor, cfg: Optional[ModelConfig],
               out_dtype) -> torch.Tensor:
    """The cross-shard sum of a partial (M, d) over the 'model' group:
    rs + int8-ag where the config opts in and d splits, else an exact
    all-reduce in fp32."""
    from repro_torch.distribution import context as dctx
    if (cfg is not None and cfg.tp_comm == "rs_ag_int8"
            and y_part.shape[1] % dctx.axis_size("model") == 0):
        return _rs_ag_int8(y_part, out_dtype)
    return dctx.psum(y_part.to(torch.float32)).to(out_dtype)


def _sum_partials(parts, out_dtype) -> torch.Tensor:
    """The shard loop's reduction: fp32, in shard order."""
    y = parts[0].to(torch.float32)
    for p in parts[1:]:
        y = y + p.to(torch.float32)
    return y.to(out_dtype)


def _on_mesh(shards: int) -> bool:
    """A mesh whose 'model' axis carries these shards is active."""
    from repro_torch.distribution import context as dctx
    return dctx.active_mesh() is not None and \
        dctx.axis_size("model") == shards


def _rank_shard(node):
    """The unsharded container of the one shard a rank's local container
    holds."""
    if node.held != 1:
        raise ValueError("on a mesh each rank holds its own shard: serve "
                         "distribution.sharding.local_params' tree")
    return node.shard(0)


def packed_mm_sharded(x2: torch.Tensor, pw, cfg: Optional[ModelConfig]
                      ) -> torch.Tensor:
    """TP-sharded packed tile-skip matmul. On a mesh of the container's
    shard count, this rank's local container (one held shard): col
    shards give the rank's output columns (bias and act fused), row
    shards take the rank's input columns and give a partial, reduced
    over 'model', then the bias. Otherwise the shard loop."""
    from repro_torch.core.deploy import packed_matmul
    if not _on_mesh(pw.shards):
        return _packed_mm_shard_loop(x2, pw)
    if pw.shard_kind == "col":
        return packed_matmul(x2, _rank_shard(pw),
                             group_nb=pw.shape[1] // pw.block[1])
    y = _tp_reduce(packed_matmul(x2, _rank_shard(pw)), cfg, x2.dtype)
    if pw.bias is not None:
        y = y + pw.bias.to(y.dtype)
    return y


def _packed_mm_shard_loop(x2: torch.Tensor, pw) -> torch.Tensor:
    """Every shard's visit list in turn on one device: col outputs
    concatenate, row partials (each on its slice of x's columns) sum,
    then the bias."""
    from repro_torch.core.deploy import packed_matmul
    tp = pw.shards
    if pw.shard_kind == "col":
        return torch.cat([packed_matmul(x2, pw.shard(s),
                                        group_nb=pw.shape[1] // pw.block[1])
                          for s in range(tp)], dim=-1)
    ks = pw.shape[0] // tp
    y = _sum_partials([packed_matmul(x2[:, s * ks:(s + 1) * ks],
                                     pw.shard(s)) for s in range(tp)],
                      x2.dtype)
    if pw.bias is not None:
        y = y + pw.bias.to(y.dtype)
    return y


def _packed_ffn_fused_sharded(x2: torch.Tensor, pf,
                              cfg: ModelConfig) -> torch.Tensor:
    """TP-sharded fused gated FFN: each shard runs the fused kernel over
    its contiguous d_ff visits with a zero b2; the partials are summed
    (over 'model' on a mesh, in a loop otherwise), then b2 once."""
    from repro_torch.core.deploy import packed_ffn_apply
    if _on_mesh(pf.shards):
        y = _tp_reduce(packed_ffn_apply(x2, _rank_shard(pf)), cfg, x2.dtype)
    else:
        y = _sum_partials([packed_ffn_apply(x2, pf.shard(s))
                           for s in range(pf.shards)], x2.dtype)
    return y + pf.b2.to(y.dtype)


def _ffn_apply_packed(p: Dict, cfg: ModelConfig, x2: torch.Tensor
                      ) -> Optional[torch.Tensor]:
    """The fused whole-FFN kernel if a PackedFFN is attached, else the
    per-matrix packed GEMMs (w1's activation in its flush); TP-sharded
    containers through the TP paths above. None without a container."""
    from repro_torch.core.deploy import packed_ffn_apply, packed_matmul

    fused = p.get("sasp_fused")
    if fused is not None:
        if fused.shards > 1:
            return _packed_ffn_fused_sharded(x2, fused, cfg)
        return packed_ffn_apply(x2, fused)
    packed = p.get("sasp_packed")
    if packed is not None and "w1" in packed:
        if packed["w1"].shards > 1:
            def mm(x, name):
                return packed_mm_sharded(x, packed[name], cfg)
        else:
            def mm(x, name):
                return packed_matmul(x, packed[name])
        h = mm(x2, "w1")                             # act in the flush
        if cfg.ffn_gated and "w3" in packed:
            h = h * mm(x2, "w3")
        return mm(h, "w2")
    return None


def ffn_apply(p: Dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    *lead, d = x.shape
    x2 = x.reshape(-1, d)
    if "sasp_fused" in p or "sasp_packed" in p:
        y = _ffn_apply_packed(p, cfg, x2)
        if y is not None:
            return y.reshape(*lead, d).to(x.dtype)
    act = act_fn(cfg.act)
    h = _mm(p, "w1", x2, cfg)
    if cfg.ffn_gated:
        h = act(h) * _mm(p, "w3", x2, cfg)
    else:
        h = act(h)
    y = _mm(p, "w2", h, cfg)
    if "b" in p.get("w2", {}):
        y = y + p["w2"]["b"].to(y.dtype)
    return y.reshape(*lead, d).to(x.dtype)
