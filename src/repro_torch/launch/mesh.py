"""Process meshes of the port (``repro.launch.mesh``).

``make_mesh`` joins this process to a ``(data, model)`` mesh of
``dp * tp`` processes through ``torch.distributed`` and returns its
:class:`~repro_torch.distribution.context.Mesh`; ``make_test_mesh`` is
the CPU (gloo) mesh of the tests; ``run_ranks`` spawns one process per
rank and returns every rank's result.

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
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.distribution.context import Mesh


def choose_backend(world: int, device: str) -> str:
    """nccl where every one of ``world`` CUDA ranks has its own card,
    else gloo."""
    if device.startswith("cuda") and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def make_mesh(dp: int, tp: int, *, rank: int, init_file: str,
              backend: Optional[str] = None, device: str = "cuda") -> Mesh:
    """Initialise the default process group of ``dp * tp`` ranks (this is
    ``rank``) over the file store ``init_file`` and build the mesh: one
    'model' group per data index, then one 'data' group per model
    index."""
    world = dp * tp
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
    model_group = data_group = None
    for d in range(dp):                 # every rank creates every group,
        g = dist.new_group(list(range(d * tp, (d + 1) * tp)))   # in order
        if rank // tp == d:
            model_group = g
    for m in range(tp):
        g = dist.new_group(list(range(m, world, tp)))
        if rank % tp == m:
            data_group = g
    return Mesh({"data": dp, "model": tp}, rank, backend, dev,
                model_group=model_group,
                host_staged=backend == "gloo" and cuda,
                data_group=data_group)


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
