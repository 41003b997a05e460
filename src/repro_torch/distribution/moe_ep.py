"""Expert-parallel MoE of the port (``repro.distribution.moe_ep``).

Experts are sharded over the 'data' axis (EP: data rank d holds the
contiguous block of experts ``[d E/ep, (d+1) E/ep)``) and each expert's
d_ff over 'model' (TP: w1/w3 columns, w2 rows). Every process routes the
tokens of its data rank itself (the router is replicated; the model
ranks of one data rank route the same tokens), writes them into a
capacity-padded ``(E, C, d)`` buffer, and a pair of all-to-alls over
'data' (``Mesh.data_all_to_all``) carries the buffer's rows to their
experts' owners and the expert outputs back. Dropped slots write the
scratch row C, which is cut off; the gates are normalised in fp32.

A call runs in one of two modes:

* ``ep``: every data rank brings the same number of batch rows (the
  reference's ``can_use_ep`` on the call's global shape, the batch split
  evenly). Each rank's slots keep their positions in its own buffer,
  under the reference's per-source-shard capacity, integer arithmetic
  ``C = max(1, -(-n_local k int(100 cf) // (100 E)))``; an expert's
  owner multiplies the ep buffers' rows for it at once, ``(E/ep, ep C,
  d)``. The aux loss is the mean of the data ranks' (the reference's
  ``pmean``), summed on the device in data-rank order (``_mean``).
* ``local``: the rows fall unevenly (a per-request prefill of one row,
  an admission whose slots lie on some data ranks only, a data rank with
  no row at all). The call keeps the local path's semantics: its float
  ceil capacity over the call's N tokens, each slot's position in the
  call-wide expert order (the data ranks' tokens in data-rank order,
  each rank's in its own), and the whole call's aux. The experts stay
  placed by EP: each rank writes its slots at those positions, the
  all-to-all moves them, and an owner takes each buffer row from the one
  rank that wrote it, so no expert stack is ever gathered.

Who decides the mode:

* **Declared** (``context.use_mesh(mesh, even_rows=True)``: a train
  step, a serving step whose batch splits over the DP ranks). The call
  is ``ep`` by construction, as the reference's is: ``can_use_ep`` on
  the global shape (every DP rank's rows, ``pods x ep x b``) from x's
  own shape, the capacity from ``b S``, the buffers in x's type, the
  aux the mean of a device all-gather over 'data' of every rank's fp32
  aux. Nothing is read back to the host, so a fake-tensor trace
  (``launch/dryrun.py``) runs it. A declared call whose shape fails
  ``can_use_ep`` raises ``UnevenRows``; it never falls back to
  ``local``, which needs the host read.
* **Gathered** (no declaration: the serving ``Engine`` and scheduler,
  whose rows may fall unevenly). One small all-gather over 'data' of
  each rank's rows, tokens, activation type, per-expert slot counts,
  aux and router probs' sums, read back to the host (``_Infos``), gives
  the mode, the buffers' type, the capacity and the positions. Where it
  gives ``ep`` the call equals the declared one bit for bit.

The w2 partials of an expert's d_ff shards are summed over 'model' in
fp32 and then cast, in the shard loop's order (the reference sums them
in the compute type, ``moe_ep.py:122``). On pods, see ``moe_ffn_ep``.

Under autograd (training; ``ep`` mode only, ``local`` is refused with
the reason): both all-to-alls carry the gradient back
(``Mesh.data_all_to_all``), the buffer enters the experts' d_ff columns
through ``copy_to_model``, and the reported aux (the ``pmean``) carries
the gradient of the rank's own aux. So a rank's loss gradient is that of
the reference's single-device loss on its rows (in ``ep`` mode a shard's
capacity and slot positions are the local path's on those rows), and an
expert owner's gradient arrives whole: the sum over the data ranks of
each rank's loss gradient (``train.optimizer`` divides it by DP and
reduces it no further). The meshless loop gives every group's own aux
an equal share of the gradient, the mean the mesh step takes.

A third mode, ``replicated`` (``moe_ffn_replicated``), serves rows that
every data rank holds alike (an engine whose batch does not split over
'data', declared by ``context.use_mesh(replicated_rows=True)``): the
local path's routing and capacity on every rank, each data rank's own
experts' slots, the outputs summed over 'data' in fp32 in rank order;
no all-to-all and no host read. With no mesh it is its own meshless
twin.

``moe_ffn_groups`` is the meshless loop: the same math in one process
over a list of row groups, one per data rank, with the whole expert
stacks, expert shard by expert shard and d_ff shard by d_ff shard, at
the mesh's shapes, so that a mesh process equals it bit for bit (its
``ep`` aux is the declared call's op on the same shape and device). A
plain tensor under ``cfg.ep_shards`` splits evenly into groups where
``can_use_ep`` holds (the reference's batch split), else it is one
group (or pods of ``cfg.ep_shards`` groups). ``moe_ffn_dp`` is the
reference's ``dp_only`` profile: every process routes its own rows
through its own whole experts.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import moe as moe_mod


def _axis(shape: Dict[str, int], names) -> int:
    n = 1
    for a in names:
        n *= shape.get(a, 1)
    return n


def can_use_ep(cfg: ModelConfig, x_shape, shape: Optional[Dict[str, int]]
               ) -> bool:
    """The reference's gate of ``moe_ffn_ep`` on the call's global
    ``x_shape`` (B, S, …) and a mesh ``shape``: experts split over
    'data', the batch over the DP ranks ('pod', 'data'), d_ff 'model'."""
    if shape is None or cfg.moe is None or "data" not in shape:
        return False
    dp_total = _axis(shape, ("pod", "data"))
    ep = shape["data"]
    B, S = x_shape[0], x_shape[1]
    f_ok = cfg.d_ff % shape.get("model", 1) == 0
    return (ep > 1 and cfg.moe.num_experts % ep == 0
            and (B * S) % dp_total == 0 and B >= dp_total and f_ok)


def ep_capacity(cfg: ModelConfig, n_local: int) -> int:
    """The reference's per-source-shard capacity (``moe_ep.py:86``)."""
    m = cfg.moe
    return max(1, -(-n_local * m.top_k * int(100 * m.capacity_factor)
                    // (100 * m.num_experts)))


def local_capacity(cfg: ModelConfig, n: int) -> int:
    """The local path's capacity over ``n`` tokens (``models.moe``)."""
    m = cfg.moe
    return max(1, int(-(-n * m.top_k * m.capacity_factor // m.num_experts)))


# activation types by code, for the all-gather of a call's infos
_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64)


class _Routed:
    """One row group's routing: its tokens (N, d), the decision, the
    sorted slots' experts, per-expert slot counts and the fp32 probs'
    column sums."""

    def __init__(self, p: Dict, cfg: ModelConfig, x: torch.Tensor):
        d = x.shape[-1]
        self.shape = x.shape
        self.rows = x.shape[0] if x.ndim > 2 else 1
        self.x2 = x.reshape(-1, d)
        self.r, probs = moe_mod.route_probs(p, cfg, self.x2)
        E = cfg.moe.num_experts
        self.sorted_e = self.r.expert_idx.reshape(-1)[self.r.sort_idx]
        self.counts = moe_mod.expert_counts(self.r.expert_idx.reshape(-1),
                                            E)
        self.prob_sum = probs.sum(dim=0)

    @property
    def n(self) -> int:
        return self.x2.shape[0]

    def info(self) -> torch.Tensor:
        """[rows, tokens, activation type, counts (E), aux, probs' column
        sums (E)] in fp64 (which holds each exactly): what the mode, the
        buffers' type, the positions and the aux loss read of every data
        rank, in one all-gather."""
        f64 = torch.float64
        head = torch.tensor([self.rows, self.n,
                             _DTYPES.index(self.x2.dtype)], dtype=f64,
                            device=self.counts.device)
        return torch.cat([head, self.counts.to(f64),
                          self.r.aux_loss.reshape(1).to(f64),
                          self.prob_sum.to(f64)])

    def buffer(self, pos: torch.Tensor, E: int, C: int, k: int, dtype):
        """The (E, C, d) buffer of this group's kept slots at ``pos`` (the
        sorted slots' positions; dropped slots write row C, cut off), in
        ``dtype`` (the call's, ``_Infos.dtype``; its own where None)."""
        pos_c = torch.clamp(pos, max=C)
        tok = self.r.sort_idx // k
        d = self.x2.shape[-1]
        buf = torch.zeros((E, C + 1, d), dtype=dtype or self.x2.dtype,
                          device=self.x2.device)
        buf = buf.index_put((self.sorted_e, pos_c), self.x2[tok].to(
            buf.dtype))
        return buf[:, :C].contiguous(), pos_c

    def combine(self, out: torch.Tensor, pos_c: torch.Tensor, k: int
                ) -> torch.Tensor:
        """Expert rows (E, C, d) back to the tokens, weighted by the
        gates and summed (``models.moe.moe_ffn_local``'s combine)."""
        E, _, d = out.shape
        out_pad = torch.cat([out, out.new_zeros((E, 1, d))], dim=1)
        y_slots = out_pad[self.sorted_e, pos_c]
        inv = torch.argsort(self.r.sort_idx, stable=True)
        y_flat = y_slots[inv].reshape(self.n, k, d)
        return torch.sum(y_flat * self.r.gate_w[..., None].to(y_flat.dtype),
                         dim=1)


class _Infos:
    """Every data rank's ``_Routed.info``, (ep, 3 + 2 E + 1), read back
    in its own types. ``dtype``: the buffers' type, the activations' of
    the ranks that bring tokens (a rank without any adopts it: a layer
    before may have promoted the others' to fp32)."""

    def __init__(self, infos: torch.Tensor, E: int):
        infos = infos.cpu()
        self.rows = [int(v) for v in infos[:, 0]]
        self.tokens = [int(v) for v in infos[:, 1]]
        codes = [int(c) for n, c in zip(self.tokens, infos[:, 2]) if n]
        self.dtype = _DTYPES[codes[0]] if codes else None
        self.counts = infos[:, 3:3 + E].to(torch.int64)     # (ep, E)
        self.aux = [v.to(torch.float32) for v in infos[:, 3 + E]]
        self.prob_sums = infos[:, 4 + E:].to(torch.float32)  # (ep, E)


def _mode(cfg: ModelConfig, infos: "_Infos", shape: Dict[str, int]) -> str:
    """``ep`` where every data rank brings the same batch rows (> 0),
    else ``local``; the call's global batch is every pod's (pods x the
    pod's rows: each pod brings the same, ``_rows``)."""
    rows = infos.rows
    if rows[0] <= 0 or any(r != rows[0] for r in rows):
        return "local"
    S = infos.tokens[0] // rows[0]
    return "ep" if can_use_ep(cfg, (shape.get("pod", 1) * sum(rows), S),
                              shape) else "local"


def _positions(g: _Routed, mode: str, infos: "_Infos", src: int
               ) -> torch.Tensor:
    """Each sorted slot's position in its expert's buffer: its own
    group's in ``ep`` mode; in ``local`` mode offset by the slots of the
    lower data ranks (the call-wide order)."""
    if mode == "ep":
        return g.r.pos_in_expert
    off = infos.counts[:src].sum(dim=0).to(g.sorted_e.device)
    return g.r.pos_in_expert + off[g.sorted_e]


def _pick_rows(recv: torch.Tensor, infos: "_Infos", e0: int
               ) -> torch.Tensor:
    """``local`` mode at an owner: recv (ep, E_loc, C, d) holds every
    source's buffer rows of experts [e0, e0 + E_loc); row c of expert e
    was written by the source whose slot range holds c (rows past the
    last slot are zero everywhere)."""
    ep, El, C, _ = recv.shape
    cum = infos.counts[:, e0:e0 + El].cumsum(dim=0).to(recv.device)
    c = torch.arange(C, device=recv.device)
    src = (c[None, None, :] >= cum[:, :, None]).sum(dim=0).clamp(max=ep - 1)
    e = torch.arange(El, device=recv.device)[:, None].expand(El, C)
    return recv[src, e, c[None, :].expand(El, C)]


def _aux(cfg: ModelConfig, mode: str, infos: "_Infos", device
         ) -> torch.Tensor:
    """The call's aux on ``device``. ``ep``: the mean of the data ranks'
    aux losses (the reference's ``pmean``), the declared call's op on
    the same values (``_mean`` on the device); ``local``: the whole
    call's, from every rank's slot counts and probs sums."""
    if mode == "ep":
        return _mean(torch.stack(infos.aux).to(device))
    m = cfg.moe
    N = sum(infos.tokens)
    f_e = infos.counts.sum(dim=0).to(torch.float32) / max(N * m.top_k, 1)
    P_e = infos.prob_sums.sum(dim=0) / max(N, 1)
    return (m.num_experts * torch.sum(f_e * P_e)
            * m.router_aux_weight).to(device)


class UnevenRows(ValueError):
    """A call declared to bring every DP rank the same rows
    (``context.use_mesh(even_rows=True)``) whose global shape expert
    parallelism cannot split (``can_use_ep``)."""


def _declared_shape(cfg: ModelConfig, g: "_Routed", shape: Dict[str, int]
                    ) -> None:
    """Refuse a declared call whose global shape (every DP rank's rows:
    pods x ep x the rank's b, by the declaration) fails ``can_use_ep``."""
    dp_total = _axis(shape, ("pod", "data"))
    S = g.n // g.rows if g.rows else 0
    if not can_use_ep(cfg, (dp_total * g.rows, S), shape):
        raise UnevenRows(
            f"a MoE call declared even (every DP rank the same rows, "
            f"use_mesh(even_rows=True)) brings {g.rows} rows of {S} "
            f"tokens a rank, a global batch ({dp_total * g.rows}, {S}) "
            f"that expert parallelism over {shape} cannot split "
            f"(can_use_ep: at least a row a DP rank, tokens divisible by "
            f"the DP ranks, experts by 'data', d_ff by 'model'); a "
            f"declared call never falls back to the local mode, whose "
            f"call-wide capacity needs every rank's counts on the host")


LOCAL_TRAIN = (
    "a training call on an expert-parallel mesh runs in ep mode only: "
    "every data rank brings the same rows and the batch splits evenly "
    "(can_use_ep), so that each rank's capacity and aux are the "
    "reference's per-shard moe_ffn_ep; this call's rows fall unevenly "
    "(local mode: a call-wide capacity and aux), which the reference "
    "never trains")


class _AuxMean(torch.autograd.Function):
    """The ``ep`` aux (the mean of every DP rank's, read from the
    all-gathers) carrying the gradient of the mean of the aux losses
    computed here: a mesh rank's own (the step averages the DP ranks'
    gradients), or every group's in the meshless loop (each 1 / (pods x
    data ranks) of it)."""
    @staticmethod
    def forward(ctx, value, *owns):
        ctx.n = len(owns)
        return value.clone()

    @staticmethod
    def backward(ctx, g):
        return (None,) + tuple(g / ctx.n for _ in range(ctx.n))


def _mean(values: torch.Tensor) -> torch.Tensor:
    """The mean of ``ep`` aux values, summed in rank order: the data
    ranks' (gathered over 'data', or the loop's groups stacked) and the
    pods' (gathered over 'pod', or the loop's pods stacked); the mesh's
    and the loop's alike, one op on one shape."""
    v = values.reshape(-1)
    return v.sum() / v.shape[0]


def _aux_out(value: torch.Tensor, groups: List[_Routed], mode: str
             ) -> torch.Tensor:
    """The call's aux ``value`` (on the call's device; the pods' mean
    where there are pods); under autograd (``ep`` mode only:
    ``local`` is refused) it carries the gradient of its groups' own aux
    losses (``_AuxMean``)."""
    owns = [g.r.aux_loss for g in groups]
    if not (torch.is_grad_enabled() and any(a.requires_grad for a in owns)):
        return value
    if mode != "ep":
        raise ValueError(LOCAL_TRAIN)
    return _AuxMean.apply(value, *owns)


def _finish(p: Dict, cfg: ModelConfig, g: _Routed, y: torch.Tensor,
            dtype) -> torch.Tensor:
    """The shared experts on this group's tokens (none for an empty
    group), the output in x's shape and type."""
    if "shared" in p and g.n:
        y = y + moe_mod.shared_apply(p, cfg, g.x2)
    return y.reshape(g.shape).to(dtype)


# ---------------------------------------------------------------------------
# On a mesh: one process
# ---------------------------------------------------------------------------


def moe_ffn_ep(p: Dict, cfg: ModelConfig, x: torch.Tensor, mesh,
               even_rows: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """This process's MoE call on a mesh whose 'data' ranks hold the
    experts in EP (``p`` holds E / ep experts, its d_ff shard of each).
    x (b, S, d): this data rank's rows, b may be 0 (a rank with no row
    still enters every collective). ``even_rows``: the caller declared
    that every DP rank brings b rows (``ep`` mode from x's shape, no
    host read; ``UnevenRows`` where they cannot split); else the mode
    comes from the gathered infos. Returns (y, aux).

    On a (pod, data, model) mesh expert parallelism stays inside a pod,
    as in the reference: the experts are cut over 'data' only (each pod
    holds a replica, whose gradient ``train.optimizer.reduce_grads`` sums
    over 'pod'), both all-to-alls and the all-gather of the infos run
    over the pod's 'data' group, the tokens split over ('pod', 'data')
    (``can_use_ep`` and the capacity count every DP rank: a call's
    global batch is pods x the pod's rows), and the ``ep`` aux is the
    mean over both axes: each pod's mean over 'data', then the pods'
    means gathered over 'pod' and averaged in pod order (``_mean``;
    the reference's ``pmean`` over ``("pod", "data")``)."""
    m = cfg.moe
    E, k = m.num_experts, m.top_k
    ep = mesh.shape["data"]
    if E % ep:
        raise ValueError(f"{E} experts do not split over {ep} data ranks")
    El = E // ep
    d = x.shape[-1]
    g = _Routed(p, cfg, x)
    if even_rows:
        _declared_shape(cfg, g, mesh.shape)
        mode, infos, dtype = "ep", None, x.dtype
        value = _mean(mesh.data_all_gather(
            g.r.aux_loss.detach().to(torch.float32).reshape(1)))
    else:
        infos = _Infos(mesh.data_all_gather(g.info()), E)
        mode, dtype = _mode(cfg, infos, mesh.shape), infos.dtype
        value = _aux(cfg, mode, infos, x.device)
    if mode == "ep" and mesh.pods > 1:
        value = _mean(mesh.gather(value.reshape(1), "pod", 0))
    aux = _aux_out(value, [g], mode)
    if mode == "ep":
        C = ep_capacity(cfg, g.n)
    else:
        C = local_capacity(cfg, sum(infos.tokens))
    buf, pos_c = g.buffer(_positions(g, mode, infos, mesh.data_rank), E, C,
                          k, dtype)
    recv = mesh.data_all_to_all(buf.reshape(ep, El, C, d))
    if mode == "ep":
        xe = recv.transpose(0, 1).reshape(El, ep * C, d)
    else:
        xe = _pick_rows(recv, infos, mesh.data_rank * El)
    ye = moe_mod.experts_apply(p, cfg, mesh.copy_to_model(xe))
    if mesh.shape["model"] > 1:
        ye = mesh.psum(ye.to(torch.float32)).to(ye.dtype)
    if mode == "ep":
        back = ye.reshape(El, ep, C, d).transpose(0, 1)
    else:
        back = ye[None].expand(ep, El, C, d)
    out = mesh.data_all_to_all(back.contiguous()).reshape(E, C, d)
    y = g.combine(out, pos_c, k)
    return _finish(p, cfg, g, y, x.dtype), aux


def moe_ffn_dp(p: Dict, cfg: ModelConfig, x: torch.Tensor, mesh=None,
               shards: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``dp_only`` profile: every DP rank routes its own
    rows through its own whole experts (``moe_ffn_local``) and the aux
    loss is averaged over the ranks. On a mesh ``x`` is this process's
    rows, the mesh ``flat``'s view (its 'data' axis every axis, the
    reference's ``pmean`` over all of them), and the aux carries the
    gradient of the rank's own (the step averages the ranks'
    gradients); with none, x splits into ``shards`` row groups run in
    turn (x whole where its batch does not divide, as the reference
    falls back to ``moe_ffn_local``)."""
    if mesh is not None:
        y, aux = moe_mod.moe_ffn_local(p, cfg, x)
        value = _mean(mesh.data_all_gather(aux.detach().reshape(1)))
        if torch.is_grad_enabled() and aux.requires_grad:
            value = _AuxMean.apply(value, aux)
        return y, value
    if shards <= 1 or x.shape[0] % shards:
        return moe_mod.moe_ffn_local(p, cfg, x)
    outs = [moe_mod.moe_ffn_local(p, cfg, xs)
            for xs in torch.chunk(x, shards, dim=0)]
    aux = outs[0][1]
    for _, a in outs[1:]:
        aux = aux + a
    return torch.cat([y for y, _ in outs], dim=0), aux / shards


# ---------------------------------------------------------------------------
# The meshless loop
# ---------------------------------------------------------------------------


def moe_ffn_groups(p: Dict, cfg: ModelConfig, xs: List[torch.Tensor],
                   tp: Optional[int] = None
                   ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """The EP mesh's math in one process: ``xs`` holds each DP rank's
    rows, pod-major (``len(xs)`` = pods x ep, ep = ``cfg.ep_shards``, or
    ``len(xs)`` where that is 1; a group may be empty), ``p`` the whole
    expert stacks; ``tp`` d_ff shards (default ``cfg.tp_shards``). Each
    pod's groups in turn (``_pod_groups``); returns (each group's y, the
    aux: the pods' mean where there are pods, carrying every group's own
    aux gradient in equal shares)."""
    ep = cfg.ep_shards if cfg.ep_shards > 1 else len(xs)
    if len(xs) % ep:
        raise ValueError(f"{len(xs)} row groups are no whole number of "
                         f"pods of {ep} data ranks")
    pods = len(xs) // ep
    tp = cfg.tp_shards if tp is None else tp
    shape = ({"pod": pods} if pods > 1 else {}) | {"data": ep, "model": tp}
    runs = [_pod_groups(p, cfg, xs[i * ep:(i + 1) * ep], tp, shape)
            for i in range(pods)]
    _, value, mode, _ = runs[0]
    if mode == "ep" and pods > 1:
        value = _mean(torch.stack([r[1] for r in runs]))
    aux = _aux_out(value, [g for r in runs for g in r[3]], mode)
    return [y for r in runs for y in r[0]], aux


def _pod_groups(p: Dict, cfg: ModelConfig, xs: List[torch.Tensor], tp: int,
                shape: Dict[str, int]):
    """One pod's groups (the EP mesh's math of one pod): expert shard j
    multiplies what data rank j would receive, d_ff shard by d_ff shard
    (partials summed in fp32 in shard order). Returns (each group's y,
    the pod's aux value, the mode, the groups' routing)."""
    from repro_torch.models.ffn import _sum_partials
    m = cfg.moe
    E, k = m.num_experts, m.top_k
    ep = len(xs)
    if E % ep:
        raise ValueError(f"{E} experts do not split over {ep} data ranks")
    El = E // ep
    d = xs[0].shape[-1]
    groups = [_Routed(p, cfg, x) for x in xs]
    infos = _Infos(torch.stack([g.info() for g in groups]), E)
    mode = _mode(cfg, infos, shape)
    value = _aux(cfg, mode, infos, xs[0].device)
    if mode == "ep":
        C = ep_capacity(cfg, groups[0].n)
    else:
        C = local_capacity(cfg, sum(infos.tokens))
    bufs = [g.buffer(_positions(g, mode, infos, s), E, C, k, infos.dtype)
            for s, g in enumerate(groups)]
    outs = []
    for j in range(ep):
        recv = torch.stack([b.reshape(ep, El, C, d)[j] for b, _ in bufs])
        if mode == "ep":
            xe = recv.transpose(0, 1).reshape(El, ep * C, d)
        else:
            xe = _pick_rows(recv, infos, j * El)
        parts = [moe_mod.experts_apply(
            moe_mod.expert_shard(p, j * El, (j + 1) * El, s, tp), cfg, xe)
            for s in range(tp)]
        ye = parts[0] if tp == 1 else _sum_partials(parts, parts[0].dtype)
        outs.append(ye.reshape(El, ep, C, d) if mode == "ep" else ye)
    ys = []
    for s, (g, (_, pos_c)) in enumerate(zip(groups, bufs)):
        out = torch.cat([o[:, s] if mode == "ep" else o for o in outs],
                        dim=0)
        ys.append(_finish(p, cfg, g, g.combine(out, pos_c, k),
                          xs[s].dtype))
    return ys, value, mode, groups


def moe_ffn_loop(p: Dict, cfg: ModelConfig, x: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A whole call x (B, S, d) of a deployment with ``cfg.ep_shards``
    expert shards, meshless: its batch split evenly into the data ranks'
    groups where ``can_use_ep`` holds (the reference's batch split), else
    one group (the local path's semantics)."""
    ep = cfg.ep_shards
    shape = {"data": ep, "model": cfg.tp_shards}
    x3 = x if x.ndim == 3 else x.reshape((1,) + tuple(x.shape))
    if can_use_ep(cfg, x3.shape, shape):
        xs = list(torch.chunk(x3, ep, dim=0))
    else:
        xs = [x3] + [x3[:0]] * (ep - 1)
    ys, aux = moe_ffn_groups(p, cfg, xs)
    return torch.cat(ys, dim=0).reshape(x.shape), aux


# ---------------------------------------------------------------------------
# Replicated rows: every data rank brings the whole call
# ---------------------------------------------------------------------------


def moe_ffn_replicated(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                       mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """A MoE call whose rows every data rank holds alike (an engine whose
    batch does not split over 'data': the sequence-parallel layout, or a
    page pool replicated over 'data'), its experts cut over 'data'
    (``cfg.ep_shards``; the reference's ``expert_col`` / ``expert_row``
    at B = 1, where ``can_use_ep`` fails and ``moe_ffn_local`` runs on
    the cut stacks). The router runs on the rows as they are; the
    capacity and every slot's position are the local path's over the
    call's N tokens, equal on every rank by construction, so nothing is
    gathered to the host. Data rank j multiplies only its experts' slots
    ``[j E/ep, (j+1) E/ep)`` (d_ff over 'model' as ``models.moe.
    experts_tp``), combines them with their gates into an (N, d) partial
    in the experts' type, and the partials are summed over 'data' in
    fp32 in data-rank order (``Mesh.ordered_sum``), then cast; the
    shared experts follow. The aux is the local path's. With no ``mesh``
    this is the meshless twin: ``p`` holds every expert, and the ep
    shards' partials (each d_ff shard's partial summed in fp32 in shard
    order) run in turn."""
    from repro_torch.distribution.context import sum_in_order
    from repro_torch.models.ffn import _sum_partials
    m = cfg.moe
    E, k = m.num_experts, m.top_k
    ep = cfg.ep_shards
    if E % ep:
        raise ValueError(f"{E} experts do not split over {ep} data ranks")
    El = E // ep
    g = _Routed(p, cfg, x)
    C = local_capacity(cfg, g.n)
    buf, pos_c = g.buffer(g.r.pos_in_expert, E, C, k, None)

    def partial(j: int, ye: torch.Tensor) -> torch.Tensor:
        # the gates' combine of expert shard j's rows alone, in fp32
        out = ye.new_zeros((E,) + tuple(ye.shape[1:]))
        out[j * El:(j + 1) * El] = ye
        return g.combine(out, pos_c, k).to(torch.float32)

    if mesh is not None:
        j = mesh.data_rank
        y = mesh.ordered_sum(partial(j, moe_mod.experts_tp(
            p, cfg, buf[j * El:(j + 1) * El].contiguous())), "data")
    else:
        tp = cfg.tp_shards
        parts = []
        for j in range(ep):
            xe = buf[j * El:(j + 1) * El].contiguous()
            ys = [moe_mod.experts_apply(moe_mod.expert_shard(
                p, j * El, (j + 1) * El, s, tp), cfg, xe)
                for s in range(tp)]
            parts.append(partial(j, ys[0] if tp == 1
                                 else _sum_partials(ys, ys[0].dtype)))
        y = sum_in_order(parts)
    return _finish(p, cfg, g, y.to(buf.dtype), x.dtype), g.r.aux_loss


# ---------------------------------------------------------------------------
# Dispatch (the reference's ``models.lm._moe_dispatch``)
# ---------------------------------------------------------------------------


def moe_dispatch(p: Dict, cfg: ModelConfig, x: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MoE layer under whatever placement is active: the ``dp_only``
    profile's mesh -> ``moe_ffn_dp``; experts cut over 'data'
    (``cfg.ep_shards``) -> ``moe_ffn_replicated`` where the caller
    declared replicated rows (``use_mesh(replicated_rows=True)``, on the
    mesh or its meshless twin), else ``moe_ffn_ep`` on the mesh,
    ``moe_ffn_loop`` without one; else ``moe_ffn_local`` (every expert
    here, d_ff whole or over 'model'). Under ``use_mesh(even_rows=True)``
    the EP call is declared."""
    from repro_torch.distribution import context as dctx
    mesh = dctx.active_mesh()
    if mesh is not None and mesh.profile == "dp_only":
        return moe_ffn_dp(p, cfg, x, mesh)
    if cfg.ep_shards > 1:
        if mesh is not None and mesh.shape["data"] != cfg.ep_shards:
            raise ValueError(
                f"experts in {cfg.ep_shards} EP shards on a mesh of "
                f"{mesh.shape['data']} data ranks")
        if dctx.replicated_rows():
            return moe_ffn_replicated(p, cfg, x, mesh)
        if mesh is None:
            return moe_ffn_loop(p, cfg, x)
        return moe_ffn_ep(p, cfg, x, mesh, dctx.even_rows())
    return moe_mod.moe_ffn_local(p, cfg, x)
