"""Active-mesh context of the port (``repro.distribution.context``).

The reference runs one program over a ``(data, model)`` or ``(pod, data,
model)`` device mesh and wraps each TP kernel call in ``shard_map``. The
port runs one process per rank (SPMD), joined by ``torch.distributed``: a
:class:`Mesh` holds this process's place in the ``(pod, data, model)``
grid and the process groups of its axes, and each rank holds only its own
slice of every sharded leaf (``distribution.sharding.local_params``).
Model code reads the mesh from :func:`use_mesh` instead of taking it as an
argument, as in the reference: under an active mesh whose 'model' size
equals a container's ``shards``, the TP paths of ``models/ffn.py`` run the
rank's shard-local visit list and call the collective over the 'model'
group where the reference's ``shard_map`` body calls ``psum`` /
``psum_scatter`` / ``all_gather``; with no mesh, or another size, a
sequential loop over the shards runs the same math in one process.
There is no ``shard_map`` shim: a rank's code is the body itself.

The 'data' axis: each (pod, model) index has a 'data' group, the
processes at that model index of every data index of the pod. Data
parallelism runs one copy of the host state in every process
(``serve.engine`` / ``serve.scheduler``) and moves it in step with two
collectives over that group: an all-gather of what each data rank
computed, and a broadcast from data rank 0. ``submesh`` is one data
rank's mesh (its 'model' axis alone); ``flat`` is the mesh seen with
every process its own data rank (the reference's ``dp_only`` profile,
``profile``; its 'data' axis spans every axis of the mesh, and the
record names them, ``data_axis``: 'data,model'). Expert parallelism
adds a third collective over that group, ``data_all_to_all``: block j
of a rank's tensor goes to data rank j (``jax.lax.all_to_all`` over
'data'). A caller that gives every DP rank the same rows by
construction (a train step, a serving step whose batch splits) says so
once, ``use_mesh(mesh, even_rows=True)``: expert parallelism then takes
its mode, capacity and buffer type from the rank's own shape and reads
nothing back to the host (``distribution/moe_ep.py``).

The sequence-parallel layout (``sharding.seq_axes``) cuts a ring over
``("data",)`` or ``("data", "model")``; the latter is every process of
a pod, indexed data-major, recorded as 'data,model'. Its softmax combine
takes a max (``allreduce(op="max")``) and fp32 sums in rank order
(``ordered_sum``: an all-gather, then one add at a time, the meshless
twin's order; a ring all-reduce sums in an order of its own). A caller
whose data ranks bring the same rows, all of them (such an engine), says
so with ``use_mesh(mesh, replicated_rows=True)``: experts cut over
'data' then run ``moe_ep.moe_ffn_replicated``.

The 'pod' axis (the reference's ``MULTI_POD``, ``(2, 16, 16)``): P pods of
D x T processes, rank ``(p D + d) T + m``. A mesh of one pod has no 'pod'
key in its shape and creates no pod group, so that a two-axis mesh is
what it was. Each (data, model) index has a 'pod' group, the processes at
that index in every pod; each model index a DP group over ``("pod",
"data")``, the reference's ``dp_axes``, whose index is ``dp_rank = p D +
d``. Training splits the batch over the DP group and reduces gradients
over it (``train.optimizer.reduce_grads``: over 'data', then 'pod');
expert parallelism stays inside a pod.

Transport is named, never chosen silently: ``nccl`` where every rank has
its own card; ``gloo`` on the CPU; ``gloo (host-staged)`` where ranks
share one card: the mesh copies each CUDA tensor to the host, runs the
gloo collective there and copies the result back. On gloo a
``psum_scatter`` is an all-reduce followed by the rank's own slice, and
an ``all_gather`` a gather of host tensors: the same values.

Under autograd (training) the 'model' collectives have backward rules,
by the convention that the reference's ``shard_map`` bodies and GSPMD
imply: everything outside a TP region is computed identically on every
model rank, so the gradient of a replicated value is the same on every
rank. The sum that leaves a region (``psum``) is the identity in
backward; a sum that each rank consumes with its own channels
(``psum_ar``: the SSM's gated-norm squares) is an all-reduce in
backward; the entry to a column region (``copy_to_model``: identity
forward) sums the ranks' partial gradients; an ``all_gather`` followed
by replicated compute takes the rank's own slice of the gradient; a
``psum_scatter``'s backward is an ``all_gather``; ``take_shard`` (a
rank's slice of replicated compute, entering a row region) all-gathers
the slices' gradients. They apply only where
the input requires grad: the no-grad serving path runs exactly the
collectives above. The all-to-all over 'data' is its own backward
(expert parallelism's dispatch and return). ``allreduce`` / ``gather`` /
``reduce_scatter`` over 'data', 'pod', the DP axes ``("pod", "data")``
or the whole world (``axis="world"``) serve the optimizer (gradient
reduction, ZeRO, the global norm) and take no gradient.

Every collective that communicates is recorded on the mesh
(``Mesh.comms``): calls and bytes by kind (``all-reduce``,
``all-gather``, ``reduce-scatter``, ``all-to-all``, ``broadcast``) and
axis ('model', 'data', 'pod', 'pod,data', 'world'; the DP axes of a mesh
of one pod are 'data'; ``flat``'s 'data' is 'data,model'). The bytes
are those of the result on this rank, in the tensor's own type (the
reference's HLO count reads the
result shape the same way; gloo's fp32 widening of a 16-bit all-to-all
is transport, not counted). A mesh's ``submesh`` / ``flat`` views share
their parent's record. ``DryMesh`` is rank r's view of a mesh with no
process group (``dry_mesh``): each collective records itself exactly so
and returns zeros of its result's shape and type, so that a step traced
under ``FakeTensorMode`` (``launch/dryrun.py``) yields the collective record
of the real step without a process or a card. ``launch/mesh.py``
builds only real meshes (nccl or gloo).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass
class Mesh:
    """This process's place in a ``(pod, data, model)`` mesh of ``pod *
    dp * tp`` ranks: global rank ``rank`` sits at pod index ``rank // (dp
    tp)``, data index ``rank // tp % dp`` (within its pod) and model index
    ``rank % tp``; ``shape`` holds 'pod' only where there are two pods or
    more. ``model_group`` is the process group of its 'model' axis,
    ``data_group`` that of its 'data' axis (inside its pod),
    ``pod_group`` that of its 'pod' axis and ``dp_group`` that of the DP
    axes ``("pod", "data")`` (None with one pod: the 'data' group is
    it); ``host_staged`` runs gloo over host copies of CUDA tensors;
    ``profile`` is the reference's placement profile ("tp", or "dp_only"
    for ``flat``'s view); ``data_axis`` the record's name of the 'data'
    axis (the axes it spans: 'data,model' for ``flat``'s view)."""
    shape: Dict[str, int]
    rank: int
    backend: str
    device: torch.device
    model_group: Any = None
    host_staged: bool = False
    data_group: Any = None
    profile: str = "tp"
    # {kind: {axis: {"calls", "bytes"}}} of every collective this rank
    # ran (``record``); shared by ``submesh`` / ``flat`` views
    comms: Dict[str, Dict[str, Dict[str, int]]] = dataclasses.field(
        default_factory=dict)
    pod_group: Any = None
    dp_group: Any = None
    data_axis: str = "data"

    @property
    def model_rank(self) -> int:
        return self.rank % self.shape["model"]

    @property
    def data_rank(self) -> int:
        """The data index inside this process's pod."""
        return self.dp_rank % self.shape["data"]

    @property
    def pods(self) -> int:
        return self.shape.get("pod", 1)

    @property
    def pod_rank(self) -> int:
        return self.dp_rank // self.shape["data"] if self.pods > 1 else 0

    @property
    def dp_rank(self) -> int:
        """The index over the DP axes ``("pod", "data")``, pod-major:
        ``pod_rank * dp + data_rank``."""
        return self.rank // self.shape["model"]

    @property
    def dp_total(self) -> int:
        """The size of the DP axes: pods x data ranks."""
        return self.pods * self.shape["data"]

    @property
    def transport(self) -> str:
        return self.backend + (" (host-staged)" if self.host_staged else "")

    def axis_size(self, name) -> int:
        return self._axis(name)[1]

    def submesh(self) -> "Mesh":
        """This process's data rank alone: the 'model' axis and its group,
        a 'data' axis of one (the mesh of one data rank's engine)."""
        return dataclasses.replace(
            self, shape={"data": 1, "model": self.shape["model"]},
            data_group=None, pod_group=None, dp_group=None)

    def flat(self) -> "Mesh":
        """The mesh with every process a data rank of its own (the
        reference's ``dp_only`` profile): a 'data' axis of ``pod * dp *
        tp`` over the whole world, a 'model' axis of one."""
        return dataclasses.replace(
            self, shape={"data": self.axis_size("world"), "model": 1},
            model_group=None, data_group=dist.group.WORLD, pod_group=None,
            dp_group=None, profile="dp_only",
            data_axis=",".join(self.shape))

    # -- the record ------------------------------------------------------
    def _note(self, kind: str, axis: str, shape, dtype) -> None:
        n = 1
        for d in shape:
            n *= int(d)
        rec = self.comms.setdefault(kind, {}).setdefault(
            axis, {"calls": 0, "bytes": 0})
        rec["calls"] += 1
        rec["bytes"] += n * dtype.itemsize

    def record(self) -> Dict[str, Dict[str, Dict[str, int]]]:
        """A copy of the collective record: {kind: {axis: {"calls",
        "bytes"}}}."""
        return {k: {a: dict(v) for a, v in axes.items()}
                for k, axes in self.comms.items()}

    def reset_record(self) -> None:
        self.comms.clear()

    @property
    def a2a(self) -> Dict[str, int]:
        """The 'data' all-to-alls so far: calls and bytes."""
        return dict(self.comms.get("all-to-all", {}).get(
            self.data_axis, {"calls": 0, "bytes": 0}))

    # -- collectives over the 'model' axis -----------------------------
    def _run(self, x: torch.Tensor, op) -> torch.Tensor:
        """``op`` on a contiguous copy of x (on the host when staged),
        the result back on x's device."""
        y = x.detach().to("cpu" if self.host_staged else x.device,
                          copy=True).contiguous()
        y = op(y)
        return y.to(x.device)

    def _comm(self, kind: str, axis: str, x: torch.Tensor, shape,
              op) -> torch.Tensor:
        """Record one collective whose result on this rank has ``shape``
        (x's type), then run ``op`` through ``_run``."""
        self._note(kind, axis, shape, x.dtype)
        return self._run(x, op)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every model rank's ``x`` (identity in backward)."""
        if _traced(x):
            return _PSum.apply(x, self)
        return self.allreduce(x, "model")

    def psum_ar(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every model rank's ``x`` where each rank consumes
        the sum with its own channels (the SSM's gated-norm squares): the
        ranks' gradients differ, so the backward is an all-reduce too."""
        if _traced(x) and self.shape["model"] > 1:
            return _PSumAR.apply(x, self)
        return self.allreduce(x, "model")

    def psum_scatter(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's 1/tp slice along ``dim`` of the sum of every model
        rank's ``x`` (the reference's tiled ``psum_scatter``; an
        ``all_gather`` in backward)."""
        if _traced(x):
            return _ReduceScatter.apply(x, self, dim)
        return self.reduce_scatter(x, "model", dim)

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every model rank's ``x`` concatenated along ``dim``, in rank
        order (the reference's tiled ``all_gather``; the rank's own slice
        of the gradient in backward)."""
        if _traced(x):
            return _AllGather.apply(x, self, dim)
        return self.gather(x, "model", dim)

    def take_shard(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This model rank's 1/tp slice along ``dim`` of a replicated
        ``x`` (no communication); its gradient is every rank's slice's
        all-gathered, so that the replicated compute before it receives
        the same gradient on every rank."""
        if _traced(x) and self.shape["model"] > 1:
            return _TakeShard.apply(x, self, dim)
        n = x.shape[dim] // self.shape["model"]
        return x.narrow(dim, self.model_rank * n, n)

    def copy_to_model(self, x: torch.Tensor) -> torch.Tensor:
        """The entry to a column region: ``x`` itself, whose gradient is
        the sum of every model rank's (each rank's columns give a
        partial)."""
        if _traced(x) and self.shape["model"] > 1:
            return _CopyToModel.apply(x, self)
        return x

    # -- collectives over any axis, no gradient -------------------------
    def _axis(self, axis):
        """(group, size, this rank's index, the record's name) of
        'model', 'data', 'pod', the DP axes ``("pod", "data")`` (the
        reference's ``dp_axes``; 'data' itself with one pod) or 'world'
        (every process)."""
        if axis == "model":
            return (self.model_group, self.shape["model"], self.model_rank,
                    axis)
        if axis == "data":
            return (self.data_group, self.shape["data"], self.data_rank,
                    self.data_axis)
        if axis == "pod":
            return self.pod_group, self.pods, self.pod_rank, axis
        if tuple(axis) == ("pod", "data"):
            if self.pods == 1:
                return self._axis("data")
            return self.dp_group, self.dp_total, self.dp_rank, "pod,data"
        if tuple(axis) == ("data",):
            return self._axis("data")
        if tuple(axis) == ("data", "model"):
            n = self.shape["data"] * self.shape["model"]
            if self.pods > 1 and self.backend != "dry":
                raise ValueError("a collective over ('data', 'model') of a "
                                 "mesh of pods: serving on pods is not "
                                 "ported")
            return None, n, self.rank % n, "data,model"
        if axis == "world":
            return (None, self.dp_total * self.shape["model"], self.rank,
                    axis)
        raise ValueError(f"axis {axis!r} not in model|data|pod|"
                         f"('pod', 'data')|('data', 'model')|world")

    def axis_index(self, axis) -> int:
        return self._axis(axis)[2]

    def allreduce(self, x: torch.Tensor, axis="model",
                  op: str = "sum") -> torch.Tensor:
        """Every rank of ``axis``'s ``x`` reduced by ``op`` (sum or
        max)."""
        group, _, _, key = self._axis(axis)
        rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]

        def run(y):
            dist.all_reduce(y, op=rop, group=group)
            return y
        return self._comm("all-reduce", key, x, x.shape, run)

    def reduce_scatter(self, x: torch.Tensor, axis, dim: int
                       ) -> torch.Tensor:
        """This rank's slice along ``dim`` of the sum over ``axis``: a
        reduce-scatter on NCCL, an all-reduce and the slice on gloo."""
        group, n, idx, key = self._axis(axis)
        dim %= x.ndim
        k = x.shape[dim] // n
        shape = x.shape[:dim] + (k,) + x.shape[dim + 1:]

        def run(y):
            if self.backend == "nccl":
                out = y.new_empty(shape)
                dist.reduce_scatter(
                    out, [p.contiguous() for p in torch.chunk(y, n, dim)],
                    group=group)
                return out
            dist.all_reduce(y, group=group)
            return y.narrow(dim, idx * k, k).contiguous()
        return self._comm("reduce-scatter", key, x, shape, run)

    def gather(self, x: torch.Tensor, axis, dim: int) -> torch.Tensor:
        """Every rank of ``axis``'s ``x`` concatenated along ``dim`` in
        rank order (pod-major over the DP axes)."""
        group, n, _, key = self._axis(axis)
        dim %= x.ndim
        shape = x.shape[:dim] + (x.shape[dim] * n,) + x.shape[dim + 1:]

        def run(y):
            parts = [torch.empty_like(y) for _ in range(n)]
            dist.all_gather(parts, y, group=group)
            return torch.cat(parts, dim=dim)
        return self._comm("all-gather", key, x, shape, run)

    def ordered_sum(self, x: torch.Tensor, axis) -> torch.Tensor:
        """The sum over ``axis`` of every rank's ``x`` in rank order: an
        all-gather, then ``sum_in_order`` of the parts, the meshless
        twin's order (an NCCL or gloo all-reduce sums in an order of its
        own). Used in fp32 by the sequence-parallel attention combine and
        the replicated MoE's expert outputs."""
        parts = self.gather(x[None], axis, 0)
        return sum_in_order(list(parts.unbind(0)))

    def broadcast(self, x: torch.Tensor) -> torch.Tensor:
        """Model rank 0's ``x`` on every rank of the model group."""
        if self.shape["model"] == 1:
            return x
        src = self.rank - self.model_rank

        def op(y):
            dist.broadcast(y, src=src, group=self.model_group)
            return y
        return self._comm("broadcast", "model", x, x.shape, op)

    # -- collectives over the 'data' axis ------------------------------
    def data_all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every data rank's ``x`` at this model index, stacked along a
        new first dim in data-rank order."""
        if self.shape["data"] == 1:
            return x[None]

        def op(y):
            parts = [torch.empty_like(y) for _ in range(self.shape["data"])]
            dist.all_gather(parts, y, group=self.data_group)
            return torch.stack(parts)
        return self._comm("all-gather", self.data_axis, x,
                          (self.shape["data"],) + tuple(x.shape), op)

    def data_all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """x (dp, …): block j to data rank j at this model index; returns
        (dp, …) whose block i came from data rank i (the reference's
        ``jax.lax.all_to_all(x, "data", split_axis=0, concat_axis=0)``).
        On gloo a 16-bit tensor moves as fp32, which holds it exactly.
        Under autograd its backward is the same all-to-all of the
        gradient: block i goes back to data rank i."""
        if self.shape["data"] == 1:
            return x
        if _traced(x):
            return _AllToAll.apply(x, self)
        return self._all_to_all(x)

    def _all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        wide = self.backend == "gloo" and x.element_size() == 2

        def op(y):
            y = y.to(torch.float32) if wide else y
            out = torch.empty_like(y)
            dist.all_to_all_single(out, y, group=self.data_group)
            return out.to(x.dtype)
        return self._comm("all-to-all", self.data_axis, x, x.shape, op)

    def data_broadcast(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Data rank ``src``'s ``x`` on every data rank at this model
        index."""
        if self.shape["data"] == 1:
            return x
        g_src = ((self.pod_rank * self.shape["data"] + src)
                 * self.shape["model"] + self.model_rank)

        def op(y):
            dist.broadcast(y, src=g_src, group=self.data_group)
            return y
        return self._comm("broadcast", self.data_axis, x, x.shape, op)

    def world_value(self, x: torch.Tensor) -> torch.Tensor:
        """World rank 0's ``x`` on every process of the mesh (one
        broadcast over the default group)."""
        if self.axis_size("world") == 1:
            return x

        def op(y):
            dist.broadcast(y, src=0)
            return y
        return self._comm("broadcast", "world", x, x.shape, op)

    @property
    def host_device(self) -> torch.device:
        """Where host values go for a collective: the card under NCCL,
        else the host."""
        return self.device if self.backend == "nccl" else \
            torch.device("cpu")


@dataclasses.dataclass
class DryMesh(Mesh):
    """A mesh with no process group (``dry_mesh``): every collective is
    recorded as a real mesh records it and returns zeros of its result's
    shape and type. Nothing is sent."""

    def _comm(self, kind, axis, x, shape, op):
        self._note(kind, axis, shape, x.dtype)
        return x.new_zeros(tuple(shape))


def mesh_shape(dp: int, tp: int, pod: int = 1) -> Dict[str, int]:
    """A mesh's ``shape``: 'pod' only where there are two pods or
    more."""
    return ({"pod": pod} if pod > 1 else {}) | {"data": dp, "model": tp}


def dry_mesh(dp: int, tp: int, rank: int = 0,
             device: Optional[torch.device] = None, pod: int = 1
             ) -> DryMesh:
    """Rank ``rank``'s view of a ``(pod, dp, tp)`` mesh, with no process
    group (``launch/dryrun.py`` traces a step with one under
    ``FakeTensorMode``)."""
    if not 0 <= rank < pod * dp * tp:
        raise ValueError(f"rank {rank} not in a ({pod}, {dp}, {tp}) mesh")
    return DryMesh(mesh_shape(dp, tp, pod), rank, "dry",
                   device or torch.device("cpu"))


def sum_in_order(parts) -> torch.Tensor:
    """``parts[0] + parts[1] + …``, one add at a time, in list order."""
    y = parts[0]
    for p in parts[1:]:
        y = y + p
    return y


def _traced(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class _PSum(torch.autograd.Function):
    """psum: the sum that leaves a TP region; identity in backward."""
    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.allreduce(x, "model")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _PSumAR(torch.autograd.Function):
    """psum whose result each rank consumes with its own channels: an
    all-reduce of the gradient (fp32) in backward."""
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return mesh.allreduce(x, "model")

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.allreduce(g.to(torch.float32), "model").to(
            g.dtype), None


class _AllToAll(torch.autograd.Function):
    """The all-to-all over 'data'; the same all-to-all of the gradient in
    backward (it is its own inverse)."""
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return mesh._all_to_all(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh._all_to_all(g.contiguous()), None


class _CopyToModel(torch.autograd.Function):
    """The entry to a column region: identity forward, psum backward."""
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        # summed in fp32, as the forward reductions are, then cast
        return ctx.mesh.allreduce(g.to(torch.float32), "model").to(
            g.dtype), None


class _AllGather(torch.autograd.Function):
    """all_gather before replicated compute: the rank's own slice of the
    gradient in backward (a reduce-scatter would count it tp times)."""
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return mesh.gather(x, "model", dim)

    @staticmethod
    def backward(ctx, g):
        n = g.shape[ctx.dim] // ctx.mesh.shape["model"]
        return (g.narrow(ctx.dim, ctx.mesh.model_rank * n, n).contiguous(),
                None, None)


class _TakeShard(torch.autograd.Function):
    """A rank's slice of replicated compute (entering a row region); an
    all_gather of the slices' gradients in backward."""
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        n = x.shape[dim] // mesh.shape["model"]
        return x.narrow(dim, mesh.model_rank * n, n).contiguous()

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.gather(g.contiguous(), "model", ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    """psum_scatter; an all_gather in backward."""
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return mesh.reduce_scatter(x, "model", dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.gather(g, "model", ctx.dim), None, None


_ACTIVE_MESH: Optional[Mesh] = None
_EVEN_ROWS = False
_REPLICATED_ROWS = False


def active_mesh() -> Optional[Mesh]:
    return _ACTIVE_MESH


def even_rows() -> bool:
    """Did the caller of the active ``use_mesh`` declare that every DP
    rank brings the same rows (the batch split evenly by construction)?"""
    return _EVEN_ROWS


def replicated_rows() -> bool:
    """Did the caller of the active ``use_mesh`` declare that every data
    rank brings the same rows, all of them (an engine whose batch does
    not split over 'data')?"""
    return _REPLICATED_ROWS


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh], even_rows: bool = False,
             replicated_rows: bool = False):
    """``mesh`` active for the block. ``even_rows``: every DP rank brings
    the same rows to every call in it (a train step's ``_rows``, a
    serving step of a split batch), so that expert parallelism decides
    from the rank's own shape, with no host read (``moe_ep.moe_ffn_ep``;
    a call whose rows cannot split raises ``moe_ep.UnevenRows``).
    ``replicated_rows``: every data rank brings the whole batch (an
    engine of the sequence-parallel or the replicated layout), so that
    experts cut over 'data' run in the replicated mode
    (``moe_ep.moe_ffn_replicated``: each rank its own experts' slots, no
    host read); with no mesh, the meshless twin of such an engine."""
    global _ACTIVE_MESH, _EVEN_ROWS, _REPLICATED_ROWS
    if even_rows and replicated_rows:
        raise ValueError("a call's rows are split evenly or replicated, "
                         "not both")
    prev = _ACTIVE_MESH, _EVEN_ROWS, _REPLICATED_ROWS
    _ACTIVE_MESH, _EVEN_ROWS = mesh, bool(even_rows) and mesh is not None
    _REPLICATED_ROWS = bool(replicated_rows)
    try:
        yield mesh
    finally:
        _ACTIVE_MESH, _EVEN_ROWS, _REPLICATED_ROWS = prev


def axis_size(name: str) -> int:
    return 1 if _ACTIVE_MESH is None else _ACTIVE_MESH.axis_size(name)


def _model_mesh() -> Mesh:
    if _ACTIVE_MESH is None:
        raise RuntimeError("a 'model' collective needs an active mesh "
                           "(distribution.context.use_mesh)")
    return _ACTIVE_MESH


def psum(x: torch.Tensor) -> torch.Tensor:
    """``jax.lax.psum(x, 'model')``."""
    return _model_mesh().psum(x)


def psum_scatter(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``jax.lax.psum_scatter(x, 'model', scatter_dimension=dim,
    tiled=True)``."""
    return _model_mesh().psum_scatter(x, dim)


def psum_ar(x: torch.Tensor) -> torch.Tensor:
    """``Mesh.psum_ar`` under the active mesh."""
    return _model_mesh().psum_ar(x)


def all_gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``jax.lax.all_gather(x, 'model', axis=dim, tiled=True)``."""
    return _model_mesh().all_gather(x, dim)


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """``Mesh.copy_to_model`` under the active mesh; ``x`` itself with no
    mesh (the shard loop sums the shards' gradients itself)."""
    return x if _ACTIVE_MESH is None else _ACTIVE_MESH.copy_to_model(x)
