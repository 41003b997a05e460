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
(``_rs_ag_int8``, plain torch as the reference's is jnp).

The other paths shard the same way under a TP deployment
(``cfg.tp_shards``; ``distribution.sharding`` slices the leaves): the
dense and masked FFN runs a rank's w1/w3 columns and w2 rows and reduces
the partial (``_ffn_tp``; ``_ffn_tp_rs_ag_int8`` where the config opts
in), and a ``BlockSparseWeight`` of the bsr and kernel paths multiplies
the whole x by a rank's column blocks, whose outputs are all-gathered
(``_bsr_mm_sharded``). The int8 ``qw`` matrices of the masked path stay
whole on every rank, as under the reference's GSPMD. Each has its
meshless shard loop, the same products in one process.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.pruning import apply_block_mask, mask_shard
from repro_torch.core.quantization import dequantize_int8
from repro_torch.core.sparse import BlockSparseWeight, bsr_matmul
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
        return _bsr_mm_sharded(x2, bsr[name], cfg,
                               cfg.sasp.path == "kernel")
    return torch.matmul(x2, _materialize(p, name, x2.dtype))


def tp_shards(cfg: Optional[ModelConfig]) -> int:
    """The 'model' shards the dense and BSR matrices run in: the active
    mesh's (a rank holds one of each), else ``cfg.tp_shards`` (the shard
    loop holds them all and runs each in turn)."""
    from repro_torch.distribution import context as dctx
    if dctx.active_mesh() is not None:
        return dctx.axis_size("model")
    return 1 if cfg is None else cfg.tp_shards


def shard_of(t: torch.Tensor, dim: int, s: int, n: int) -> torch.Tensor:
    """Shard ``s`` of ``n`` along ``dim``, contiguous as a rank holds it
    (``sharding.take_slice``)."""
    k = t.shape[dim] // n
    return t.narrow(dim, s * k, k).contiguous()


def _bsr_shard(w: BlockSparseWeight, s: int, tp: int) -> BlockSparseWeight:
    """Column-block shard ``s`` of ``tp`` of a BSR: (K, N / tp)."""
    return BlockSparseWeight(
        shard_of(w.vals, -3, s, tp), shard_of(w.idx, -1, s, tp),
        (w.shape[0], w.shape[1] // tp), w.block,
        None if w.scale is None else shard_of(w.scale, -1, s, tp))


def _bsr_mm_sharded(x2: torch.Tensor, w: BlockSparseWeight,
                    cfg: Optional[ModelConfig], kernel: bool
                    ) -> torch.Tensor:
    """Block-sparse matmul over ``tp_shards`` column-block shards (the
    reference's ``shard_map`` over 'model'): on a mesh, a rank multiplies
    the whole x by its NB / tp column blocks (its slice of ``w``, whose
    ``shape`` stays the whole matrix's) and the ranks' columns are
    all-gathered in order (the reference's ``out_specs=P(bax, "model")``,
    which GSPMD gathers for the next op); with no mesh, every shard in
    turn, concatenated. Where NB does not split, every rank computes the
    whole product. The kernel path plans a shard's visit groups from the
    whole weight's block grid (``group_nb``), so a rank's columns equal
    the unsharded product's bit for bit."""
    from repro_torch.distribution import context as dctx
    nb = w.shape[1] // w.block[1]
    tp = tp_shards(cfg)

    def compute(ww):
        if kernel:
            return sasp_matmul(x2, ww, group_nb=nb)
        return bsr_matmul(x2, ww)

    if tp <= 1 or nb % tp:
        return compute(w)
    if dctx.active_mesh() is not None:
        local = dataclasses.replace(w, shape=(w.shape[0], w.shape[1] // tp))
        y = compute(local)
        return dctx.all_gather(y.to(torch.float32), 1).to(y.dtype)
    return torch.cat([compute(_bsr_shard(w, s, tp)) for s in range(tp)],
                     dim=-1)


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


def _ffn_body(p: Dict, cfg: ModelConfig, x2: torch.Tensor
              ) -> torch.Tensor:
    """``act(x @ w1) * (x @ w3) @ w2`` without w2's bias: the whole FFN's
    output, or, on a rank's columns of w1/w3 and rows of w2, its partial."""
    act = act_fn(cfg.act)
    h = _mm(p, "w1", x2, cfg)
    if cfg.ffn_gated:
        h = act(h) * _mm(p, "w3", x2, cfg)
    else:
        h = act(h)
    return _mm(p, "w2", h, cfg)


def _add_b2(p: Dict, y: torch.Tensor) -> torch.Tensor:
    if "b" in p.get("w2", {}):
        y = y + p["w2"]["b"].to(y.dtype)
    return y


def _dense_tp(p: Dict, tp: int, d_ff: int) -> bool:
    """A dense FFN of ``d_ff`` (masked: pruned in place, or under a
    ``sasp_masks`` overlay) that the rules split over ``tp`` 'model'
    shards: w1/w3 by columns, w2 by rows (d_ff divides; an empty FFN
    stays whole)."""
    return (tp > 1 and "sasp_bsr" not in p
            and d_ff > 0 and d_ff % tp == 0
            and all("w" in p[n] for n in ("w1", "w2", "w3") if n in p))


def _ffn_shard(p: Dict, s: int, tp: int) -> Dict:
    """Shard ``s`` of ``tp`` of a dense FFN, as a rank holds it: w1/w3's
    columns, w2's rows (its bias whole), and their overlay masks'
    tiles."""
    out = {n: {"w": shard_of(p[n]["w"], -1, s, tp)} for n in ("w1", "w3")
           if n in p}
    out["w2"] = {"w": shard_of(p["w2"]["w"], -2, s, tp)}
    masks = p.get("sasp_masks")
    if masks is not None:
        out["sasp_masks"] = {
            n: mask_shard(m, -2 if n == "w2" else -1, s, tp, n)
            for n, m in masks.items()}
    return out


def _can_rs_ag(p: Dict, cfg: ModelConfig, x2: torch.Tensor) -> bool:
    """The reference's gate of ``_ffn_tp_rs_ag_int8``: the config opts
    in, a mesh splits d_model and d_ff, and the FFN is dense."""
    from repro_torch.distribution import context as dctx
    if cfg.tp_comm != "rs_ag_int8" or cfg.moe is not None:
        return False
    if dctx.active_mesh() is None:
        return False
    tp = dctx.axis_size("model")
    return (tp > 1 and x2.shape[-1] % tp == 0 and cfg.d_ff % tp == 0
            and "sasp_bsr" not in p and "sasp_masks" not in p
            and "sasp_packed" not in p and "sasp_fused" not in p
            and isinstance(p["w1"], dict) and "w" in p["w1"])


def _ffn_tp_rs_ag_int8(p: Dict, cfg: ModelConfig, x2: torch.Tensor
                       ) -> torch.Tensor:
    """The dense FFN on a rank's shard with its partial reduced as a
    reduce-scatter and an int8 all-gather (``_rs_ag_int8``); as in the
    reference, w2's bias is not added."""
    return _rs_ag_int8(_ffn_body(p, cfg, x2), x2.dtype)


def _ffn_tp(p: Dict, cfg: ModelConfig, x2: torch.Tensor, tp: int
            ) -> torch.Tensor:
    """The dense FFN over ``tp`` 'model' shards: on a mesh, this rank's
    partial reduced (exactly in fp32, or rs + int8-ag where ``_can_rs_ag``),
    then w2's bias; with no mesh, every shard's partial in turn, summed in
    fp32 in shard order (``_sum_partials``), then the bias. Under
    autograd x enters the rank's columns through ``copy_to_model`` (its
    gradient summed over 'model'); the loop's shards, views of the whole
    weights and masks (``shard_of``), take their gradients directly."""
    from repro_torch.distribution import context as dctx
    if dctx.active_mesh() is not None:
        if _can_rs_ag(p, cfg, x2):
            return _ffn_tp_rs_ag_int8(p, cfg, x2)
        y = _tp_reduce(_ffn_body(p, cfg, dctx.copy_to_model(x2)), None,
                       x2.dtype)
    else:
        y = _sum_partials([_ffn_body(_ffn_shard(p, s, tp), cfg, x2)
                           for s in range(tp)], x2.dtype)
    return _add_b2(p, y)


def ffn_apply(p: Dict, cfg: ModelConfig, x: torch.Tensor,
              d_ff: Optional[int] = None) -> torch.Tensor:
    """The dense FFN of ``d_ff`` (default ``cfg.d_ff``; the MoE shared
    experts' is wider) on any path, TP where its deployment splits it."""
    *lead, d = x.shape
    x2 = x.reshape(-1, d)
    if "sasp_fused" in p or "sasp_packed" in p:
        y = _ffn_apply_packed(p, cfg, x2)
        if y is not None:
            return y.reshape(*lead, d).to(x.dtype)
    tp = tp_shards(cfg)
    if _dense_tp(p, tp, cfg.d_ff if d_ff is None else d_ff):
        y = _ffn_tp(p, cfg, x2, tp)
    else:
        y = _add_b2(p, _ffn_body(p, cfg, x2))
    return y.reshape(*lead, d).to(x.dtype)
