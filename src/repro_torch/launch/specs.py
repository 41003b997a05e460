"""Abstract params, state and inputs of one mesh rank for the dry run
(``launch/dryrun.py``; the reference's ``launch/specs.py``, which hands
``jax.ShapeDtypeStruct`` stand-ins to ``jit(...).lower``).

Every function here is called under a ``FakeTensorMode``: the tensors it
returns are fake CPU tensors (shapes, types, no storage), so a whole
production model costs no memory, and a step traced on them runs the
plain PyTorch path of every kernel wrapper (a wrapper launches its CUDA
kernel only for a CUDA tensor). The rank's view follows the port's
placement: ``models/lm.py::param_shapes``' tree cut to the rank by
``distribution/sharding.py::local_params`` at ``tp_config``, the ZeRO
slices of the AdamW moments (``train/optimizer.py::zero_adamw_init``),
and the rank's rows and cache slice of each input.

A MoE serving cell whose batch splits over the DP ranks, on a global
shape where the reference's ``can_use_ep`` holds (prefill_32k, B = 32;
decode_32k, B = 128, over 16 DP ranks), cuts its experts over 'data'
as the reference's ``moe_ffn_ep`` does (``serve_ep``), and its step
declares even rows (``use_mesh(even_rows=True)``: expert parallelism
with no host read). Where the batch does not split (``long_500k``, B =
1) the cell takes the reference's long-context layout: each KV ring's
capacity cut over (data, model) where it divides (``sharding.seq_axes``
/ ``seq_config``; a rank holds C / (D T) slots, or C / D where the KV
heads split over 'model'), and the experts still cut over 'data' (the
reference's ``expert_col`` / ``expert_row``) with the step declaring
replicated rows (``moe_ep.moe_ffn_replicated``: each data rank its own
experts' slots, the outputs summed over 'data'). Under the ``dp_only``
profile the mesh is its ``flat`` view: every process a DP rank holding
the whole tree, the rings cut over every axis where the batch does not
split.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distribution import sharding as shd
from repro_torch.models import lm
from repro_torch.train import train_step as ts
from repro_torch.train.optimizer import AdamWConfig, zero_adamw_init


def abstract_params(cfg: ModelConfig, mesh, ep: int = 1,
                    whole: Optional[Dict] = None):
    """(the rank's params, the TP deployment's config, the rank's
    config): the whole tree drawn as fake tensors (``lm.init_params``
    under the active fake mode, or ``whole``), cut to ``mesh``'s model
    (and data, for ``ep`` expert shards) rank."""
    tp = mesh.shape["model"]
    tcfg = shd.tp_config(cfg, tp, ep)
    if whole is None:
        whole = lm.init_params(cfg, device="cpu")
    params = shd.local_params(whole, tcfg, tp, mesh.model_rank, ep=ep,
                              data_rank=mesh.data_rank if ep > 1 else 0)
    return params, tcfg, shd.local_config(tcfg, tp)


def abstract_train_state(cfg: ModelConfig, opt_cfg: AdamWConfig, mesh,
                         whole: Dict, profile: str = "tp"):
    """(the rank's training params, its config, its ZeRO moments, the mesh
    layout) of a train cell: ``whole`` cut by the training layout
    (``train_step.mesh_layout`` / ``rank_slices``: an SSM's in_xbc /
    conv leaves whole on every model rank, the expert stacks over
    'data'), the rank's config at ``tp_config(cfg, tp, ep=dp)``; on a
    mesh of pods every pod's rank holds the same. ``profile="dp_only"``:
    the whole tree at tp 1, the moments cut over 'data'."""
    dp, tp = mesh.shape["data"], mesh.shape["model"]
    layout = ts.mesh_layout(cfg, dp, tp, opt_cfg, pod=mesh.pods,
                            profile=profile)
    params = ts.rank_slices(whole, layout, mesh)
    if profile == "dp_only":
        lcfg = shd.local_config(shd.tp_config(cfg, 1), 1)
    else:
        lcfg = shd.local_config(shd.tp_config(cfg, tp, ep=dp), tp)
    return (params, lcfg, zero_adamw_init(params, layout.zero, opt_cfg,
                                          mesh), layout)


def serve_ep(cfg: ModelConfig, shape: ShapeConfig, mesh) -> int:
    """The EP shards of a serving cell's experts: the 'data' ranks where
    the batch splits over the DP ranks (``batch_split``) and the
    reference's ``can_use_ep`` holds on the global shape, or where the
    batch does not split at all (the replicated mode); else 1 (every
    expert on every data rank: a split batch that ``can_use_ep``
    refuses, and always under ``dp_only``)."""
    from repro_torch.distribution.moe_ep import can_use_ep
    if cfg.moe is None or mesh.profile == "dp_only":
        return 1
    if not batch_split(shape, mesh.dp_total):
        return mesh.shape["data"]
    S = 1 if shape.kind == "decode" else shape.seq_len
    return mesh.shape["data"] if can_use_ep(
        cfg, (shape.global_batch, S), mesh.shape) else 1


def serve_config(lcfg: ModelConfig, shape: ShapeConfig, mesh
                 ) -> ModelConfig:
    """The rank's serving config of a prefill or decode cell: under the
    sequence-parallel layout where the batch does not split over the DP
    ranks (``sharding.seq_config`` at the cell's length), else
    ``lcfg``."""
    from repro_torch.distribution.sharding import seq_config
    if shape.kind == "train":
        return lcfg
    return seq_config(lcfg, mesh, shape.global_batch, shape.seq_len)


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """The global inputs of one step of the shape's kind.

    train:   {tokens (B, S) int32 [, embeds (B, S, d)]}
    prefill: {tokens (B, S) int32}
    decode:  {tokens (B, 1) int32, pos (B,) int32}; the caches are the
             rank's own (``input_shardings``).
    The port's prefill and decode take no ``embeds`` (a frontend's
    stand-in embeddings enter the loss only)."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return {"tokens": torch.zeros((B, 1), dtype=torch.int32),
                "pos": torch.full((B,), S - 1, dtype=torch.int32)}
    out = {"tokens": torch.zeros((B, S), dtype=torch.int32)}
    if shape.kind == "train" and cfg.frontend != "none":
        out["embeds"] = torch.zeros((B, S, cfg.d_model),
                                    dtype=_dtype(cfg.compute_dtype))
    return out


def batch_split(shape: ShapeConfig, dp: int) -> bool:
    """Are the batch's rows split over the ``dp`` DP ranks (pods x data
    ranks; the reference's rule: B divides and B > 1)? Otherwise every DP
    rank runs the whole batch."""
    B = shape.global_batch
    return dp > 1 and B > 1 and B % dp == 0


def input_shardings(cfg: ModelConfig, lcfg: ModelConfig, shape: ShapeConfig,
                    mesh, inputs: Dict[str, Any]) -> Dict[str, Any]:
    """The rank's inputs: a train step takes the global batch (the mesh
    step takes its DP rank's rows, ``train_step._rows``); prefill and
    decode take the rank's rows where the batch splits over the DP axes
    ('pod' and 'data', pod-major: ``dp_rank``; ``batch_split``), and
    decode the rank's caches, its rows of a cache of ``seq_len`` holding
    its own KV heads (or every head, ``heads_replicated``) and SSM
    heads; where the batch does not split, each ring holds the rank's
    block of its capacity (``lcfg`` from ``serve_config``)."""
    if shape.kind == "train":
        return dict(inputs)
    dp = mesh.dp_total
    n = shape.global_batch // dp if batch_split(shape, dp) else \
        shape.global_batch
    out = {k: v[mesh.dp_rank * n:(mesh.dp_rank + 1) * n]
           if batch_split(shape, dp) else v for k, v in inputs.items()}
    if shape.kind == "decode":
        out["caches"] = lm.init_caches(None, lcfg, n, shape.seq_len,
                                       device="cpu")
    return out


def make_step_fn(lcfg: ModelConfig, shape: ShapeConfig, mesh,
                 layout: Optional[ts.MeshLayout] = None,
                 opt_cfg: Optional[AdamWConfig] = None, overlay=None,
                 n_microbatches: int = 1, lr_schedule=None):
    """The step the dry run traces, on the rank's config ``lcfg``:

    train:   ``train_step.make_mesh_train_step`` (params, opt_state,
             batch) -> (params, opt_state, metrics);
    prefill: one prefill forward (params, batch) -> (greedy ids, caches);
    decode:  one decode step against the rank's cache of ``seq_len``
             (params, batch) -> (greedy ids, caches), as the reference's
             ``serve_step``.
    A serving step declares even rows where the batch splits over the
    DP ranks (``batch_split``), replicated rows where it does not and
    the experts are cut over 'data' (``lcfg.ep_shards``); ``mesh`` is
    the ``flat`` view under ``dp_only``."""
    from repro_torch.distribution.context import use_mesh
    if shape.kind == "train":
        return ts.make_mesh_train_step(
            lcfg, opt_cfg or AdamWConfig(quantized=True), mesh, layout,
            overlay=overlay, n_microbatches=n_microbatches,
            lr_schedule=lr_schedule)
    even = batch_split(shape, mesh.dp_total)
    rows = dict(even_rows=even, replicated_rows=not even and lcfg.moe
                is not None and lcfg.ep_shards > 1)

    if shape.kind == "prefill":
        def prefill_step(params, batch):
            with use_mesh(mesh, **rows), torch.no_grad():
                logits, caches = lm.prefill(params, lcfg, batch["tokens"],
                                            cache_len=shape.seq_len)
                return torch.argmax(logits, dim=-1), caches
        return prefill_step

    def serve_step(params, batch):
        with use_mesh(mesh, **rows), torch.no_grad():
            logits, caches = lm.decode_step(params, lcfg, batch["tokens"],
                                            batch["pos"], batch["caches"])
            return torch.argmax(logits, dim=-1), caches
    return serve_step


def _dtype(name: str):
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]
