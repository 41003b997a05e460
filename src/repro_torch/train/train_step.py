"""Train-step factory of the port (``repro.train.train_step``): loss ->
grad -> AdamW, aware of the SASP overlay.

The overlay (SASP masks) is closed over and merged into a view of the
params inside the loss, so the masks apply straight through: gradients
reach the surviving tiles only. The step updates params and moments in
place and returns them (the reference's launcher donates both to its
jitted step).

Under a (data, model) or (pod, data, model) mesh
(``make_mesh_train_step``) one process runs each rank: the reference's
GSPMD step splits the batch over its DP axes ('pod' and 'data'), reduces
the gradients over them implicitly and keeps the moments ZeRO-sharded
over 'data' by its shardings; here the step does both by hand
(``train.optimizer``'s ``reduce_grads`` and ``zero_*``), and
``make_train_step(data_shards=)`` with a TP config (``cfg.tp_shards``)
is its meshless twin, ``data_shards`` the DP ranks of every pod. The
mesh step gives every DP rank the same rows by construction and says
so (``use_mesh(even_rows=True)``): its MoE layers run expert
parallelism with no host read. Under the reference's ``dp_only``
profile (``mesh_layout(profile="dp_only")``) every process is a DP
rank holding whole params, and 'model' joins the gradient reduction.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.pruning import iter_leaves, map_leaves
from repro_torch.core.sasp import merge_overlay
from repro_torch.models import lm
from repro_torch.train.optimizer import (
    AdamWConfig,
    AdamWState,
    QMoment,
    ZeroSpecs,
    adamw_init,
    adamw_update,
    global_norm,
    opt_state_shardings,
    reduce_grads,
    zero_adamw_update,
    zero_global_norm,
)


def value_and_grad(cfg: ModelConfig, params, batch: Dict,
                   overlay: Optional[Any] = None):
    """(loss, metrics, grads) of ``lm.loss_fn`` on the params viewed
    through ``overlay``; ``grads`` has the params' structure (zeros where
    a leaf is unused, as jax gives)."""
    def fn(pv):
        loss, metrics = lm.loss_fn(pv, cfg, batch)
        return loss, (loss, metrics)
    _, (loss, metrics), grads = _value_and_grad(fn, params, overlay)
    return loss, metrics, grads


def _value_and_grad(fn, params, overlay):
    """(fn's objective, fn's aux, grads of the objective): ``fn(pv)`` on
    the params viewed through ``overlay`` returns (objective, aux), aux
    holding tensors to detach."""
    flat = dict(iter_leaves(params))
    with torch.enable_grad():
        live = {k: p.detach().requires_grad_(True) for k, p in flat.items()}
        p = map_leaves(lambda path, _: live[path], params)
        pv = merge_overlay(p, overlay) if overlay is not None else p
        obj, aux = fn(pv)
        gs = torch.autograd.grad(obj, list(live.values()),
                                 allow_unused=True)
    grads = {k: torch.zeros_like(flat[k]) if g is None else g
             for k, g in zip(live, gs)}
    return (obj.detach(), _detach(aux),
            map_leaves(lambda path, _: grads[path], params))


def _detach(tree):
    if isinstance(tree, dict):
        return {k: _detach(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_detach(v) for v in tree)
    return tree.detach()


def value_and_grad_groups(cfg: ModelConfig, params, batches: List[Dict],
                          overlay: Optional[Any] = None):
    """The meshless twin of an expert-parallel mesh's ``value_and_grad``
    (``lm.loss_fn_groups``, DP rank g's rows ``batches[g]``, pod-major):
    (each group's (loss, metrics), the gradient of the groups' mean loss:
    the mean over the DP axes of the mesh ranks' gradients)."""
    def fn(pv):
        parts = lm.loss_fn_groups(pv, cfg, batches)
        total = parts[0][0]
        for loss, _ in parts[1:]:
            total = total + loss
        return total / len(parts), parts
    _, parts, grads = _value_and_grad(fn, params, overlay)
    return parts, grads


def _grads(cfg: ModelConfig, params, batch: Dict, overlay,
           n_microbatches: int, accum_dtype):
    """(loss, metrics, grads) of one batch, accumulated over
    ``n_microbatches`` row slices (rows [k B/K, (k+1) B/K) form
    micro-batch k) in ``accum_dtype`` (default fp32), then averaged."""
    if n_microbatches <= 1:
        return value_and_grad(cfg, params, batch, overlay)
    K = n_microbatches
    adt = accum_dtype or torch.float32
    grads = map_leaves(lambda _, p: torch.zeros(
        p.shape, dtype=adt, device=p.device), params)
    flat_acc = dict(iter_leaves(grads))
    loss = torch.zeros((), dtype=torch.float32,
                       device=next(iter(flat_acc.values())).device)
    ms = []
    for k in range(K):
        mb = {n: v.reshape(K, v.shape[0] // K, *v.shape[1:])[k]
              for n, v in batch.items()}
        lk, mk, gk = value_and_grad(cfg, params, mb, overlay)
        for path, g in iter_leaves(gk):
            flat_acc[path].add_(g.to(adt))
        loss = loss + lk
        ms.append(mk)
    for g in flat_acc.values():
        g.div_(K)
    return loss / K, {n: torch.stack([m[n] for m in ms]).mean()
                      for n in ms[0]}, grads


def _rows(batch: Dict, d: int, n: int, k: int = 1) -> Dict:
    """DP rank ``d``'s rows of ``n`` under ``k`` micro-batches, in the
    reference's grouping (the global batch cut into k micro-batches,
    each sharded ``P(('pod', 'data'), None)``, pod-major: ``d`` is a
    mesh rank's ``dp_rank``): micro-batch j's rows [j B/k + d B/(k n), j
    B/k + (d+1) B/(k n)), for j in order, so that the rank's own
    micro-batch j is its rows of the global micro-batch j."""
    B = next(iter(batch.values())).shape[0]
    if B % (n * k):
        raise ValueError(f"a batch of {B} rows does not split over {n} "
                         f"data ranks of {k} micro-batches")
    b = B // (n * k)
    return {name: v.reshape((k, n, b) + tuple(v.shape[1:]))[:, d]
            .reshape((k * b,) + tuple(v.shape[1:]))
            for name, v in batch.items()}


def _grads_groups(cfg: ModelConfig, params, batch: Dict, overlay,
                  n_microbatches: int, accum_dtype, data_shards: int):
    """The meshless twin of an expert-parallel mesh step's gradients:
    each micro-batch's ``data_shards`` DP-rank groups (every pod's) in
    lock step (``value_and_grad_groups``), the gradients accumulated over
    the micro-batches in ``accum_dtype`` (default fp32) and averaged; the
    loss and metrics reduced as the mesh reduces them (each DP rank's
    micro-batches averaged, then the DP ranks, ``_dp_mean``). Returns
    (loss, metrics, grads)."""
    K, dp = n_microbatches, data_shards
    adt = accum_dtype or torch.float32
    ranks = [_rows(batch, d, dp, K) for d in range(dp)]
    per_rank = [[] for _ in range(dp)]
    grads = None
    for j in range(K):
        mbs = [{n: v.reshape((K, v.shape[0] // K) + tuple(v.shape[1:]))[j]
                for n, v in r.items()} for r in ranks]
        parts, g = value_and_grad_groups(cfg, params, mbs, overlay)
        for d, part in enumerate(parts):
            per_rank[d].append(part)
        if K == 1:
            grads = g
            continue
        if grads is None:
            grads = map_leaves(lambda _, p: torch.zeros(
                p.shape, dtype=adt, device=p.device), params)
            acc = dict(iter_leaves(grads))
        for path, x in iter_leaves(g):
            acc[path].add_(x.to(adt))
    if K > 1:
        for x in acc.values():
            x.div_(K)
    rows = []
    for parts in per_rank:                # each rank's _grads reduction
        if K == 1:
            loss, ms = parts[0]
        else:
            loss = torch.zeros((), dtype=torch.float32,
                               device=parts[0][0].device)
            for lk, _ in parts:
                loss = loss + lk
            loss = loss / K
            ms = {n: torch.stack([m[n] for _, m in parts]).mean()
                  for n in parts[0][1]}
        rows.append((loss, ms))
    names = sorted(rows[0][1])
    vals = _dp_mean(torch.stack([
        torch.stack([loss] + [ms[n] for n in names]) for loss, ms in rows]))
    return vals[0], {n: vals[i + 1] for i, n in enumerate(names)}, grads


def _dp_mean(rows: torch.Tensor) -> torch.Tensor:
    """The mean of (DP ranks, k) over its DP ranks, summed in DP-rank
    order: the mesh's metrics and the loop's, the same op on the same
    shape."""
    return rows.sum(dim=0) / rows.shape[0]


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    overlay: Optional[Any] = None,
                    lr_schedule: Optional[Callable] = None,
                    n_microbatches: int = 1,
                    accum_dtype=None, data_shards: int = 1,
                    on_grads: Optional[Callable] = None):
    """Returns step(params, opt_state, batch) -> (params, opt_state,
    metrics {"ce", "aux", "loss", "grad_norm"}, 0-d tensors).
    ``on_grads(grads)``, where given, sees each step's mean gradient (the
    params' structure) before the update.

    ``n_microbatches > 1``: gradient accumulation over batch slices
    (rows [k B/K, (k+1) B/K) form micro-batch k), in ``accum_dtype``
    (default fp32); the activations held shrink by K at the cost of K
    sequential passes. ``data_shards`` > 1 is the meshless twin of a
    mesh step's DP axes (``make_mesh_train_step``; pods x data ranks):
    each DP rank's rows in turn (their own micro-batches, ``_rows``), the
    gradients and metrics averaged in DP-rank order; with experts in
    ``cfg.ep_shards`` EP shards (``tp_config(..., ep=)``) the DP ranks'
    rows run in lock step instead, every MoE layer over all of them at
    once, each pod's ``cfg.ep_shards`` groups joined as its all-to-alls
    join them (``_grads_groups``)."""

    if cfg.ep_shards > 1 and data_shards % cfg.ep_shards:
        raise ValueError(f"experts in {cfg.ep_shards} EP shards: the loop "
                         f"runs pods of {cfg.ep_shards} data ranks, and "
                         f"data_shards={data_shards} is no whole number of "
                         f"them")

    def step(params, opt_state: AdamWState, batch: Dict):
        if cfg.ep_shards > 1:
            loss, metrics, grads = _grads_groups(
                cfg, params, batch, overlay, n_microbatches, accum_dtype,
                data_shards)
            parts = ()
        else:
            parts = [_grads(cfg, params, _rows(batch, d, data_shards,
                                               n_microbatches),
                            overlay, n_microbatches, accum_dtype)
                     for d in range(data_shards)]
            loss, metrics, grads = parts[0]
        if len(parts) > 1:
            acc = dict(iter_leaves(grads))
            for _, _, g in parts[1:]:
                for path, x in iter_leaves(g):
                    acc[path] = acc[path] + x
            grads = map_leaves(lambda path, _: acc[path] / data_shards,
                               grads)
            loss = torch.stack([p[0] for p in parts]).sum() / data_shards
            metrics = {n: torch.stack([p[1][n] for p in parts]).sum()
                       / data_shards for n in metrics}

        if on_grads is not None:
            on_grads(grads)
        lr_scale = lr_schedule(opt_state.step) if lr_schedule else 1.0
        gnorm = global_norm(grads)
        new_params, new_opt = adamw_update(grads, opt_state, params,
                                           opt_cfg, lr_scale=lr_scale,
                                           gnorm=gnorm)
        out = dict(metrics)
        out["loss"] = loss
        out["grad_norm"] = gnorm
        return new_params, new_opt, out

    return step


class MeshLayout(NamedTuple):
    """Where a mesh's ranks hold the training state: ``params`` {path:
    spec} (``train_spec``), ``opt`` the moments' specs
    (``optimizer.opt_state_shardings``), ``zero`` {path: the moment's
    spec} (q's with int8 moments: where a rank's slice sits), a
    ``ZeroSpecs`` whose ``ep`` names the EP-cut expert stacks;
    ``profile`` the reference's placement profile ("tp" or
    "dp_only")."""
    params: Dict
    opt: AdamWState
    zero: Dict
    profile: str = "tp"


def train_spec(cfg: ModelConfig, path, shape, sizes) -> tuple:
    """A training leaf's spec (``distribution.sharding.spec_for_param``):
    an expert stack by the expert rules (E over 'data', d_ff over
    'model'); an SSM's [x | B | C] leaves (in_xbc, conv_w, conv_b) whole
    on every rank of a TP mesh, cut inside the layer (``models.ssm.
    _TakeXBC``), so that their gradient, moments and checkpoint are the
    whole leaf's."""
    from repro_torch.distribution.sharding import _XBC, spec_for_param
    if sizes.get("model", 1) > 1 and _XBC.search(
            "/".join(str(k) for k in path)):
        return (None,) * len(shape)
    return spec_for_param(path, tuple(shape), sizes,
                          expert=lm.expert_leaf(cfg, path))


def mesh_layout(cfg: ModelConfig, dp: int, tp: int,
                opt_cfg: AdamWConfig, pod: int = 1,
                profile: str = "tp") -> MeshLayout:
    """The layout of ``cfg``'s training state on a (pod, dp, tp) mesh,
    from the whole tree's shapes (``lm.param_shapes``: nothing is
    allocated): each leaf's ``train_spec``, the moments' ZeRO specs (over
    'data' only: every pod holds the same slices), and ``zero`` a
    ``ZeroSpecs`` naming the EP-cut expert stacks. Refuses what cannot
    place (``sharding.check_placement``: experts that do not split over
    'data', an expert d_ff or SSM heads that do not split over
    'model'). ``profile="dp_only"``: every leaf whole on every rank (the
    reference's replicated specs), the moments cut over 'data' only."""
    from repro_torch.distribution.context import mesh_shape
    from repro_torch.distribution.sharding import PROFILES, check_placement
    if profile not in PROFILES:
        raise ValueError(f"profile={profile!r} not in {PROFILES}")
    sizes = mesh_shape(dp, tp, pod)
    dp_only = profile == "dp_only"
    if not dp_only:
        check_placement(cfg, tp, dp if cfg.moe is not None else 1)
    shapes = lm.param_shapes(cfg)
    pspecs = {path: (None,) * t.ndim if dp_only
              else train_spec(cfg, path, tuple(t.shape), sizes)
              for path, t in iter_leaves(shapes)}
    opt = opt_state_shardings(shapes, sizes, opt_cfg, pspecs)
    return MeshLayout(pspecs, opt, ZeroSpecs(
        {path: s.q if isinstance(s, QMoment) else s
         for path, s in opt.m.items()},
        ep=[path for path, spec in pspecs.items() if "data" in spec]),
        profile)


def rank_slices(params, layout: MeshLayout, mesh):
    """This rank's training slices (``layout.params``) of a whole tree:
    its model rank's cut of every leaf and its data rank's experts."""
    from repro_torch.distribution.sharding import take_slice
    return map_leaves(lambda path, t: take_slice(
        t, layout.params[path], mesh.model_rank, mesh.shape["model"],
        mesh.data_rank, mesh.shape["data"]), params)


def state_specs(params, layout: MeshLayout):
    """{"params", "opt"}'s structure (the checkpoint's state) with a
    ``checkpoint.Placed`` spec at each leaf."""
    from repro_torch.train.checkpoint import Placed

    def moment(path, _):
        s = layout.opt.m[path]
        return QMoment(Placed(s.q), Placed(s.scale)) \
            if isinstance(s, QMoment) else Placed(s)
    return {"params": map_leaves(lambda path, _: Placed(layout.params[path]),
                                 params),
            "opt": AdamWState(step=Placed(()), m=map_leaves(moment, params),
                              v=map_leaves(moment, params))}


def make_mesh_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, mesh,
                         layout: MeshLayout,
                         overlay: Optional[Any] = None,
                         lr_schedule: Optional[Callable] = None,
                         n_microbatches: int = 1, accum_dtype=None,
                         on_grads: Optional[Callable] = None):
    """The train step of one rank of a (data, model) or (pod, data,
    model) mesh: step(params, opt_state, batch) -> (params, opt_state,
    metrics), ``batch`` the global batch. ``cfg`` is the rank's config
    (``sharding.local_config`` of a ``tp_config``), ``params`` its TP
    slices, ``opt_state`` its ZeRO slices (``optimizer.zero_adamw_init``),
    ``overlay`` its masks (``core.sasp.mesh_overlay``). The rank takes its
    DP rank's rows of the batch (pod-major, ``_rows``), runs forward and
    backward under the mesh with even rows declared (and its
    micro-batches, accumulated locally), reduces the gradients to the
    mean over 'pod' and 'data' on its ZeRO slices (``reduce_grads``),
    clips by the global norm (``zero_global_norm``), runs AdamW on its
    slices and all-gathers the params over 'data'
    (``zero_adamw_update``). Metrics are the mean over the DP axes, on
    every rank: an all-reduce over 'data' with one pod, else the DP
    ranks' values gathered and summed in DP-rank order (``_dp_mean``, as
    the loop sums them).
    Under ``layout.profile == "dp_only"`` (``cfg`` whole, at tp 1) every
    process is a DP rank: its rows are those of its world rank, the
    forward runs under ``mesh.flat()`` (MoE through ``moe_ffn_dp``), the
    gradients are reduced over 'data' and then 'model'
    (``reduce_grads(over_model=True)``) and the metrics over every axis.
    ``on_grads(gs)``, where given, sees each step's reduced gradient
    slices ({path: the rank's ZeRO slice}) before the update."""
    from repro_torch.distribution.context import use_mesh
    dp, pods = mesh.shape["data"], mesh.pods
    dp_only = layout.profile == "dp_only"
    view = mesh.flat() if dp_only else mesh

    def step(params, opt_state: AdamWState, batch: Dict):
        mine = _rows(batch, view.dp_rank, view.dp_total, n_microbatches)
        with use_mesh(view, even_rows=True):
            loss, metrics, grads = _grads(cfg, params, mine, overlay,
                                          n_microbatches, accum_dtype)
            gs = reduce_grads(grads, layout.zero, mesh, over_model=dp_only)
            del grads
            if on_grads is not None:
                on_grads(gs)
            gnorm = zero_global_norm(gs, layout.params, layout.zero, mesh)
            lr_scale = lr_schedule(opt_state.step) if lr_schedule else 1.0
            params, opt_state = zero_adamw_update(
                gs, opt_state, params, layout.zero, opt_cfg, mesh,
                lr_scale=lr_scale, gnorm=gnorm)
        names = sorted(metrics)
        vals = torch.stack([loss] + [metrics[n] for n in names])
        if dp_only:
            vals = view.allreduce(vals, "data") / view.dp_total
        elif pods > 1:
            vals = _dp_mean(mesh.gather(vals[None], ("pod", "data"), 0))
        elif dp > 1:
            vals = mesh.allreduce(vals, "data") / dp
        out = {n: vals[i + 1] for i, n in enumerate(names)}
        out["loss"] = vals[0]
        out["grad_norm"] = gnorm
        return params, opt_state, out

    return step


def make_eval_step(cfg: ModelConfig, overlay: Optional[Any] = None):
    def step(params, batch):
        pv = merge_overlay(params, overlay) if overlay is not None \
            else params
        with torch.no_grad():
            loss, metrics = lm.loss_fn(pv, cfg, batch)
        return {**metrics, "loss": loss}

    return step


def init_train_state(cfg: ModelConfig, opt_cfg: AdamWConfig, *,
                     seed: int = 0, device="cuda"):
    params = lm.init_params(cfg, seed=seed, device=device)
    return params, adamw_init(params, opt_cfg)
