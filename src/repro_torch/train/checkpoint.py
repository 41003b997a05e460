"""Fault-tolerant checkpoints in the reference's on-disk format
(``repro.train.checkpoint``), so that either package restores what the
other wrote.

Format: ``<dir>/step_<n:010d>/arrays.0.npz`` (arrays ``a0``, ``a1``, … in
leaf order) and ``manifest.json`` with the step, wall time, the caller's
``extra`` dict and, for every leaf, its name, array key, shape, dtype and
the CRC32 of its stored bytes.

* Leaf names follow the reference's ``tree_flatten_with_path``: dict keys
  in sorted order, sequence indices as digits, NamedTuple fields as
  ``.<field>`` (``opt/.m/embed/emb/.q``), joined with ``/``.
* bfloat16 and fp8 leaves (which numpy cannot hold) are stored as
  same-width unsigned views, with the true dtype in the manifest.
* Atomic: written to ``<dir>/tmp.<step>.<pid>`` then ``os.replace``d to
  ``step_<n>``, so a crash mid-save never corrupts the latest checkpoint.
* ``save_async`` copies every leaf to host memory synchronously (the
  training loop's only stall) and writes in a background thread; at most
  one write is outstanding. ``keep`` most recent checkpoints are kept.
* ``reader`` reads one leaf, or one layer of a layer-stacked leaf, at a
  time (:class:`CheckpointReader`), for a caller that cannot hold the
  whole tree (a mesh rank building its shards layer by layer).
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import threading
import time
import zipfile
import zlib
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

# dtype name -> (stored numpy type, a numpy and a torch type of its width
# that convert into each other, the true torch type)
_EXOTIC = {
    "bfloat16": (np.uint16, np.int16, torch.int16, torch.bfloat16),
    "float8_e4m3fn": (np.uint8, np.uint8, torch.uint8,
                      torch.float8_e4m3fn),
    "float8_e5m2": (np.uint8, np.uint8, torch.uint8, torch.float8_e5m2),
}
_EXOTIC_BY_TORCH = {e[3]: name for name, e in _EXOTIC.items()}

# (name, stored array, true dtype name)
HostLeaf = Tuple[str, np.ndarray, str]


def named_leaves(tree, prefix: Tuple[str, ...] = ()
                 ) -> Iterator[Tuple[str, Any]]:
    """(name, leaf) in the reference's flattening order and naming."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from named_leaves(tree[k], prefix + (str(k),))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from named_leaves(getattr(tree, f), prefix + ("." + f,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from named_leaves(v, prefix + (str(i),))
    elif tree is not None:
        yield "/".join(prefix), tree


def _rebuild(like, leaves: Iterator):
    """``like``'s structure with its leaves taken from ``leaves``, in
    ``named_leaves`` order."""
    if isinstance(like, dict):
        new = {k: _rebuild(like[k], leaves) for k in sorted(like)}
        return {k: new[k] for k in like}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_rebuild(getattr(like, f), leaves)
                            for f in like._fields))
    if isinstance(like, (tuple, list)):
        return type(like)(_rebuild(v, leaves) for v in like)
    if like is None:
        return None
    return next(leaves)


def _to_host(leaf) -> Tuple[np.ndarray, str]:
    """A copy of ``leaf`` in host memory as (stored array, dtype name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        name = _EXOTIC_BY_TORCH.get(t.dtype)
        if name is not None:
            stored, _, twin, _ = _EXOTIC[name]
            return t.view(twin).numpy().view(stored), name
        a = t.numpy()
    else:
        a = np.array(leaf)
    return a, str(a.dtype)


def _from_stored(a: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name in _EXOTIC:
        _, np_twin, _, true = _EXOTIC[dtype_name]
        return torch.from_numpy(a.view(np_twin)).view(true)
    return torch.from_numpy(a)


def _snapshot(state: Any) -> List[HostLeaf]:
    """Every leaf of ``state`` copied to host memory."""
    return [(n, *_to_host(leaf)) for n, leaf in named_leaves(state)]


def _crc(a: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(a).view(np.uint8))


@dataclasses.dataclass
class CheckpointManager:
    directory: str
    keep: int = 3

    def __post_init__(self):
        os.makedirs(self.directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------------
    def save(self, step: int, state: Any, extra: Optional[Dict] = None):
        """Synchronous atomic save of a tree of tensors."""
        self._write(step, _snapshot(state), extra or {})

    def save_async(self, step: int, state: Any,
                   extra: Optional[Dict] = None):
        """Snapshot synchronously (device -> host copy), write in the
        background. Joins any previous write first (at most one
        outstanding, which bounds host memory)."""
        self.wait()
        host = _snapshot(state)

        def work():
            try:
                self._write(step, host, extra or {})
            except BaseException as e:       # raised again by wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    # ------------------------------------------------------------------
    def _write(self, step: int, host, extra: Dict):
        """Write the leaves of ``host`` (an iterable of ``HostLeaf``,
        taken one at a time: a mesh's writer gathers each as it goes)."""
        tmp = os.path.join(self.directory, f"tmp.{step}.{os.getpid()}")
        final = os.path.join(self.directory, f"step_{step:010d}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        leaves = []
        # np.savez's layout: an uncompressed zip of a<i>.npy members
        with zipfile.ZipFile(os.path.join(tmp, "arrays.0.npz"), "w",
                             compression=zipfile.ZIP_STORED,
                             allowZip64=True) as zf:
            for i, (n, a, dt) in enumerate(host):
                a = np.asarray(a, order="C")      # keeps a 0-d leaf 0-d
                with zf.open(f"a{i}.npy", "w", force_zip64=True) as f:
                    np.lib.format.write_array(f, a, allow_pickle=False)
                leaves.append({"name": n, "key": f"a{i}",
                               "shape": list(a.shape), "dtype": dt,
                               "crc32": _crc(a)})
        manifest = {
            "step": step,
            "time": time.time(),
            "extra": extra,
            "leaves": leaves,
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:010d}"),
                          ignore_errors=True)

    # ------------------------------------------------------------------
    def all_steps(self) -> List[int]:
        out = []
        for d in os.listdir(self.directory):
            m = re.fullmatch(r"step_(\d+)", d)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _step_dir(self, step: Optional[int]) -> Tuple[int, str]:
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        return step, os.path.join(self.directory, f"step_{step:010d}")

    def reader(self, step: Optional[int] = None) -> "CheckpointReader":
        """The latest (or ``step``'s) checkpoint, read leaf by leaf."""
        return CheckpointReader(*self._step_dir(step))

    def restore(self, like: Any, step: Optional[int] = None,
                verify: bool = True) -> Tuple[Any, Dict]:
        """Restore into the structure of ``like`` (a tree of tensors):
        each leaf takes its ``like`` leaf's dtype and device. Returns
        (tree, the manifest's ``extra``)."""
        step, d = self._step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        by_name = {leaf["name"]: leaf for leaf in manifest["leaves"]}
        out = []
        with np.load(os.path.join(d, "arrays.0.npz")) as data:
            for name, ref in named_leaves(like):
                if name not in by_name:
                    raise KeyError(f"checkpoint missing leaf {name!r}")
                meta = by_name[name]
                a = data[meta["key"]]
                if verify and _crc(a) != meta["crc32"]:
                    raise IOError(f"CRC mismatch for {name!r} (corrupt "
                                  f"checkpoint step {step})")
                if tuple(a.shape) != tuple(ref.shape):
                    raise ValueError(
                        f"shape mismatch for {name!r}: ckpt {a.shape} vs "
                        f"model {tuple(ref.shape)}")
                out.append(_from_stored(a, meta["dtype"]).to(
                    device=ref.device, dtype=ref.dtype))
        return _rebuild(like, iter(out)), manifest["extra"]


class CheckpointReader:
    """One checkpoint's leaves, read one at a time: ``leaf(name)`` reads a
    leaf whole, ``layer(name, i)`` layer ``i`` of a layer-stacked leaf
    alone (a seek into its archive member, which both packages store
    uncompressed), so host memory holds one layer. A leaf's CRC-32 is
    checked when it is read whole, and once its layers have all been
    read in order."""

    def __init__(self, step: int, step_dir: str):
        self.step = step
        with open(os.path.join(step_dir, "manifest.json")) as f:
            manifest = json.load(f)
        self.extra = manifest["extra"]
        self.meta = {leaf["name"]: leaf for leaf in manifest["leaves"]}
        self._zip = zipfile.ZipFile(os.path.join(step_dir, "arrays.0.npz"))
        self._crc: Dict[str, Tuple[int, int]] = {}  # name -> (next, crc)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self) -> None:
        self._zip.close()

    def names(self) -> List[str]:
        return list(self.meta)

    def shape(self, name: str) -> Tuple[int, ...]:
        return tuple(self.meta[name]["shape"])

    def _check(self, name: str, crc: int) -> None:
        if crc != self.meta[name]["crc32"]:
            raise IOError(f"CRC mismatch for {name!r} (corrupt checkpoint "
                          f"step {self.step})")

    def leaf(self, name: str) -> torch.Tensor:
        """The whole leaf, on the host in its true dtype."""
        meta = self.meta[name]
        with self._zip.open(meta["key"] + ".npy") as f:
            a = np.lib.format.read_array(f)
        self._check(name, _crc(a))
        return _from_stored(a, meta["dtype"])

    def layer(self, name: str, i: int,
              rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        """Layer ``i`` of a layer-stacked leaf, shape (1, …), on the host
        in its true dtype; ``rows`` (lo, hi): only those entries of the
        layer's first axis (an expert-parallel rank's experts), (1, hi -
        lo, …), not CRC-checked."""
        meta = self.meta[name]
        with self._zip.open(meta["key"] + ".npy") as f:
            version = np.lib.format.read_magic(f)
            read_header = (np.lib.format.read_array_header_1_0
                           if version == (1, 0)
                           else np.lib.format.read_array_header_2_0)
            shape, fortran, dtype = read_header(f)
            if fortran:
                raise ValueError(f"{name!r} is stored in Fortran order")
            row = int(np.prod(shape[1:], dtype=np.int64)) * dtype.itemsize
            if rows is not None:
                sub = row // shape[1]
                f.seek(f.tell() + i * row + rows[0] * sub)
                buf = f.read((rows[1] - rows[0]) * sub)
                a = np.frombuffer(buf, dtype=dtype).reshape(
                    (1, rows[1] - rows[0]) + tuple(shape[2:]))
                return _from_stored(a.copy(), meta["dtype"])
            f.seek(f.tell() + i * row)
            buf = f.read(row)
        nxt, crc = self._crc.get(name, (0, 0))
        if nxt == i:                    # chain the CRC over in-order reads
            crc = zlib.crc32(buf, crc)
            self._crc[name] = (i + 1, crc)
            if i + 1 == shape[0]:
                self._check(name, crc)
        a = np.frombuffer(buf, dtype=dtype).reshape((1,) + tuple(shape[1:]))
        return _from_stored(a.copy(), meta["dtype"])


# ---------------------------------------------------------------------------
# checkpoints of a (data, model) mesh
# ---------------------------------------------------------------------------


class Placed:
    """A leaf of a spec tree: the spec of the state leaf at its place (a
    tuple with one entry per dim: 'model', 'data' or None). Wrapped, so
    that tree walks take it as one leaf."""

    def __init__(self, spec: Tuple):
        self.spec = tuple(spec)


def gather_whole(t: torch.Tensor, spec: Tuple, mesh) -> torch.Tensor:
    """The whole leaf of a rank's slice ``t``: gathered over every mesh
    axis that cuts it, on every rank (collectives: every rank calls)."""
    for dim, axis in enumerate(spec):
        if axis is not None and mesh.shape[axis] > 1:
            t = mesh.gather(t, axis, dim)
    return t


def save_on_mesh(mgr: CheckpointManager, step: int, state, specs, mesh,
                 extra: Optional[Dict] = None) -> None:
    """Save a mesh's state in the reference's format: each leaf gathered
    whole over 'model' and 'data' (``gather_whole``) by the ranks of pod
    0 (every pod holds the same slices, so the others gather nothing),
    one leaf at a time, and written by world rank 0 as it comes, so
    neither a card nor the host holds the whole tree. ``specs``:
    ``state``'s structure with a ``Placed`` at each leaf. Every rank
    calls; they leave together (a barrier over the whole world)."""
    if mesh.pod_rank:
        mesh.allreduce(torch.zeros((), device=mesh.host_device), "world")
        return

    def leaves():
        for (name, t), (_, placed) in zip(named_leaves(state),
                                          named_leaves(specs)):
            whole = gather_whole(t, placed.spec, mesh)
            if mesh.rank == 0:
                yield (name, *_to_host(whole))
    if mesh.rank == 0:
        mgr._write(step, leaves(), extra or {})
    else:
        for _ in leaves():
            pass
    mesh.allreduce(torch.zeros((), device=mesh.host_device), "world")


def restore_on_mesh(reader: CheckpointReader, like, specs, mesh):
    """This rank's slices of a checkpoint (either package's, written whole
    or by ``save_on_mesh``) in ``like``'s structure, dtypes and device
    (``like``: the rank's own state; ``specs`` as in ``save_on_mesh``;
    every pod reads the same slices: no spec names 'pod').
    A layer-stacked leaf (under ``segments``) is read one layer at a
    time (``CheckpointReader.layer``), only the rank's layers where its
    layer axis is cut, each cut before the next is read."""
    from repro_torch.distribution.sharding import take_slice
    ranks = dict(rank=mesh.model_rank, tp=mesh.shape["model"],
                 data_rank=mesh.data_rank, ep=mesh.shape["data"])
    out = []
    for (name, ref), (_, placed) in zip(named_leaves(like),
                                        named_leaves(specs)):
        spec = placed.spec
        if name not in reader.meta:
            raise KeyError(f"checkpoint missing leaf {name!r}")
        if "/segments/" in name and spec:
            n = reader.shape(name)[0]
            layers = range(n)
            if spec[0] is not None:
                k = n // mesh.shape[spec[0]]
                first = mesh.axis_index(spec[0]) * k
                layers = range(first, first + k)
            rest = (None,) + spec[1:]
            t = torch.cat([take_slice(reader.layer(name, i), rest, **ranks)
                           for i in layers])
        else:
            t = take_slice(reader.leaf(name), spec, **ranks)
        if tuple(t.shape) != tuple(ref.shape):
            raise ValueError(f"shape mismatch for {name!r}: checkpoint "
                             f"slice {tuple(t.shape)} vs rank "
                             f"{tuple(ref.shape)}")
        out.append(t.to(device=ref.device, dtype=ref.dtype))
    return _rebuild(like, iter(out))
