"""Process meshes of the port (``repro.launch.mesh``).

``make_mesh`` joins this process to a ``(pod, data, model)`` mesh of
``pod * dp * tp`` processes through ``torch.distributed`` and returns its
:class:`~repro_torch.distribution.context.Mesh`;
``make_production_mesh`` is the reference's production mesh, ``(16,
16)`` or, with ``multi_pod``, ``(2, 16, 16)`` (``production_shape``);
``make_test_mesh`` is the CPU (gloo) mesh of the tests; ``run_ranks``
spawns one process per rank and returns every rank's result.

Rendezvous is a file store (``init_method="file://…"``), so no TCP port
is opened. Processes start with the ``spawn`` method (``fork`` breaks
CUDA). Transport (``context`` module docstring): ``nccl`` when the
caller asks for it or, by default, where every rank has its own card;
gloo host-staged where CUDA ranks share a card; gloo on the CPU. An
NCCL request without enough cards is an error, not a fallback.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import queue
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.distribution.context import Mesh, mesh_shape


def choose_backend(world: int, device: str) -> str:
    """nccl where every one of ``world`` CUDA ranks has its own card,
    else gloo."""
    if device.startswith("cuda") and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def make_mesh(dp: int, tp: int, *, rank: int, init_file: str,
              backend: Optional[str] = None, device: str = "cuda",
              pod: int = 1) -> Mesh:
    """Initialise the default process group of ``pod * dp * tp`` ranks
    (this is ``rank``, at ``(p dp + d) tp + m``) over the file store
    ``init_file`` and build the mesh. Every rank creates every group, in
    one fixed order: one 'model' group per (pod, data) index, one 'data'
    group per (pod, model) index and, with two pods or more, one 'pod'
    group per (data, model) index and one DP group over ``("pod",
    "data")`` per model index."""
    world = pod * dp * tp
    cuda = device.startswith("cuda")
    backend = backend or choose_backend(world, device)
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r} not in (nccl, gloo)")
    if backend == "nccl" and (not cuda
                              or torch.cuda.device_count() < world):
        raise ValueError(
            f"nccl needs a card per rank: {world} ranks, "
            f"{torch.cuda.device_count() if cuda else 0} cards")
    if cuda:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    groups = {}
    for i in range(pod * dp):
        _join(groups, "model", range(i * tp, (i + 1) * tp), rank)
    for p in range(pod):
        for m in range(tp):
            _join(groups, "data", [(p * dp + d) * tp + m for d in range(dp)],
                  rank)
    if pod > 1:
        for d in range(dp):
            for m in range(tp):
                _join(groups, "pod", [(p * dp + d) * tp + m
                                      for p in range(pod)], rank)
        for m in range(tp):
            _join(groups, "dp", range(m, world, tp), rank)
    return Mesh(mesh_shape(dp, tp, pod), rank, backend, dev,
                model_group=groups["model"],
                host_staged=backend == "gloo" and cuda,
                data_group=groups["data"], pod_group=groups.get("pod"),
                dp_group=groups.get("dp"))


def _join(groups: dict, name: str, ranks, rank: int) -> None:
    """Create the group of ``ranks`` (every process calls, in the same
    order) and keep it as ``name`` where this rank is in it."""
    ranks = list(ranks)
    g = dist.new_group(ranks)
    if rank in ranks:
        groups[name] = g


def production_shape(multi_pod: bool = False) -> Tuple[int, int, int]:
    """(pod, data, model) of the reference's production mesh
    (``repro.launch.mesh.make_production_mesh``): ``configs.base``'s
    ``SINGLE_POD`` (16, 16) or ``MULTI_POD`` (2, 16, 16)."""
    from repro_torch.configs.base import MULTI_POD, SINGLE_POD
    return MULTI_POD.shape if multi_pod else (1,) + SINGLE_POD.shape


def make_production_mesh(*, rank: int, init_file: str,
                         multi_pod: bool = False,
                         backend: Optional[str] = None,
                         device: str = "cuda") -> Mesh:
    """This process's place in the reference's production mesh: ``(16,
    16)`` over (data, model), or ``(2, 16, 16)`` over (pod, data, model)
    with ``multi_pod`` (256 or 512 processes)."""
    pod, dp, tp = production_shape(multi_pod)
    return make_mesh(dp, tp, pod=pod, rank=rank, init_file=init_file,
                     backend=backend, device=device)


def make_test_mesh(tp: int, *, rank: int, init_file: str) -> Mesh:
    """A (1, tp) gloo mesh on the CPU."""
    return make_mesh(1, tp, rank=rank, init_file=init_file, backend="gloo",
                     device="cpu")


def close_mesh() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def _rank_main(fn, rank: int, args, out) -> None:
    try:
        out.put((rank, True, fn(rank, *args)))
    except BaseException:                # report it, then exit non-zero
        out.put((rank, False, traceback.format_exc()))
        raise
    finally:
        close_mesh()


def run_ranks(fn: Callable[..., Any], world: int, args: Sequence = (),
              timeout: float = 600.0) -> List[Any]:
    """Run ``fn(rank, *args)`` in ``world`` spawned processes and return
    their results in rank order. ``fn`` must be importable by name (a
    module-level function); it usually starts with ``make_mesh``. A rank
    that raises, or a run past ``timeout`` seconds, raises here and
    terminates every rank."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(fn, r, tuple(args), out),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    results: dict = {}
    deadline = time.monotonic() + timeout
    try:
        while len(results) < world:
            try:
                rank, ok, val = out.get(timeout=1.0)
            except queue.Empty:
                lost = [r for r, p in enumerate(procs)
                        if r not in results and p.exitcode is not None]
                if lost:
                    raise RuntimeError(f"ranks {lost} exited with codes "
                                       f"{[procs[r].exitcode for r in lost]}"
                                       f" and no result")
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"ranks {sorted(set(range(world)) - set(results))} "
                        f"gave no result within {timeout} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{val}")
            results[rank] = val
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    return [results[r] for r in range(world)]


def init_file_in(directory: str, name: str = "mesh_store") -> str:
    """A fresh file-store path under ``directory`` (created if absent;
    an old store file there is removed first)."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(os.path.abspath(directory), name)
    if os.path.exists(path):
        os.remove(path)
    return path
