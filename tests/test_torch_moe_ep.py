"""Expert parallelism of the port (``repro_torch.distribution.moe_ep``)
against the reference's ``moe_ffn_ep`` on 8 forced CPU devices
(tests/torch_ep_reference.py in a subprocess, the workload of
tests/dist_worker.py's ``mode_moe_ep``): the reduced granite-moe's MoE
layer on (data, model) meshes (2, 1), (2, 2) and (4, 2), at drop-free
capacity (8.0) and the default 1.25. The port's gloo mesh (spawned
processes, each holding its experts and d_ff shard by
``distribution.sharding.local_params``) and its meshless loop
(``moe_ffn_loop``) give y within 1e-5 of max |y| and aux within 1e-6 of
the reference's, and the mesh is the loop bit for bit, in both modes:
gathered (the mode read from every rank's infos on the host) and
declared (``use_mesh(even_rows=True)``: from the rank's own shape, no
host read), which equal each other bit for bit. The declared mode runs
under ``FakeTensorMode`` on a dry mesh, where the gathered mode's host
read cannot; a declared call whose rows cannot split raises
``UnevenRows``. Experts under TP
alone (every expert, d_ff over 'model') match ``moe_ffn_local`` at tp 2
and 4; a call whose rows all sit on one data rank keeps the local path's
semantics with the experts still placed by EP; ``moe_ffn_dp`` matches
the reference's dp_only profile. Imports no jax: the reference runs in
its own process."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.distribution import context as dctx  # noqa: E402
from repro_torch.distribution import moe_ep  # noqa: E402
from repro_torch.distribution.sharding import (local_params,  # noqa: E402
                                               tp_config)
from repro_torch.launch.mesh import init_file_in, make_mesh  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402
from repro_torch.models import moe as t_moe  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
MESHES = ((2, 1), (2, 2), (4, 2))
FACTORS = (8.0, 1.25)
MODES = ("gathered", "declared")


def port_config(cf: float):
    cfg = reduced(get_config("granite-moe-1b-a400m"), layers=2, d_model=64,
                  vocab=128)
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))


def _params(ref) -> dict:
    return {k[2:]: {"w": torch.as_tensor(np.array(ref[k]))}
            for k in ref if k.startswith("p/")}


def _rel(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b)))
                 / (np.max(np.abs(np.asarray(b))) + 1e-12))


def _rank_ffn(p, cfg, tp, rank, ep, data_rank) -> dict:
    """The rank's MoE params through ``local_params`` of a one-layer
    tree."""
    tree = {"segments": ({"slot0": {"mixer": {}, "ffn": {
        k: {"w": v["w"][None]} for k, v in p.items()}}},)}
    loc = local_params(tree, cfg, tp, rank, ep, data_rank)
    return {k: {"w": v["w"][0]}
            for k, v in loc["segments"][0]["slot0"]["ffn"].items()}


def _rank(rank, shape, ref_file, store):
    """One process of a (dp, tp) gloo mesh: for each capacity factor,
    the EP layer on its data rank's rows; the TP-only experts on every
    row; the EP layer with every row on data rank 0."""
    dp, tp = shape
    torch.set_num_threads(1)
    mesh = make_mesh(dp, tp, rank=rank, init_file=store, backend="gloo",
                     device="cpu")
    ref = np.load(ref_file)
    p, x = _params(ref), torch.as_tensor(np.array(ref["x"]))
    out = {"model_rank": mesh.model_rank, "data_rank": mesh.data_rank}
    for cf in FACTORS:
        cfg = tp_config(port_config(cf), tp, dp)
        loc = _rank_ffn(p, cfg, tp, mesh.model_rank, dp, mesh.data_rank)
        assert loc["w1"]["w"].shape == (4 // dp, 64, 64 // tp)
        for mode in MODES:
            with dctx.use_mesh(mesh, even_rows=mode == "declared"):
                y, aux = moe_ep.moe_dispatch(loc, cfg,
                                             x.chunk(dp)[mesh.data_rank])
            out[f"ep/{mode}/{cf}"] = (y.numpy(), float(aux))
        with dctx.use_mesh(mesh):
            # a rank without rows brings the compute type (bf16) where
            # the owner's activations were promoted to fp32
            yo, auxo = moe_ep.moe_dispatch(
                loc, cfg, x if mesh.data_rank == 0 else
                x[:0].to(torch.bfloat16))
        out[f"owner/{cf}"] = (yo.float().numpy(), float(auxo))
        tcfg = tp_config(port_config(cf), tp)
        with dctx.use_mesh(mesh.submesh()):
            yt, _ = moe_ep.moe_dispatch(
                _rank_ffn(p, tcfg, tp, mesh.model_rank, 1, 0), tcfg, x)
        out[f"tp/{cf}"] = yt.numpy()
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("ep_ref") / "ref.npz"
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(HERE), "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    subprocess.run([sys.executable, os.path.join(HERE,
                                                 "torch_ep_reference.py"),
                    str(path)], env=env, check=True, timeout=300,
                   capture_output=True)
    d = np.load(path)
    return str(path), {k: d[k] for k in d.files}


@pytest.fixture(scope="module")
def mesh_runs(reference, tmp_path_factory):
    """Every mesh's processes, spawned once per shape."""
    ref_file, _ = reference
    runs = {}
    for shape in MESHES:
        store = init_file_in(str(tmp_path_factory.mktemp("ep_store")),
                             f"store_{shape[0]}x{shape[1]}")
        runs[shape] = run_ranks(_rank, shape[0] * shape[1],
                                (shape, ref_file, store), timeout=240)
    return runs


def _mesh_y(results, key):
    """The data ranks' outputs of model rank 0 in data-rank order; every
    model rank of a data rank holds the same bits."""
    by_data = {}
    for r in results:
        y = r[key][0] if isinstance(r[key], tuple) else r[key]
        if r["data_rank"] in by_data:
            assert np.array_equal(by_data[r["data_rank"]], y)
        by_data[r["data_rank"]] = y
    return [by_data[d] for d in sorted(by_data)]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_ep_mesh_and_loop_equal_reference_ep(reference, mesh_runs, shape,
                                             mode):
    """Each mode's mesh ranks against the reference's ``moe_ffn_ep``
    (1e-5 / 1e-6) and the loop (bit for bit); the declared mode equals
    the gathered mode bit for bit, y and aux."""
    _, ref = reference
    dp, tp = shape
    p, x = _params(ref), torch.as_tensor(ref["x"])
    for cf in FACTORS:
        want_y = ref[f"ep/{dp},{tp}/{cf}/y"]
        want_aux = float(ref[f"ep/{dp},{tp}/{cf}/aux"])
        y, aux = moe_ep.moe_ffn_loop(p, tp_config(port_config(cf), tp, dp),
                                     x)
        assert _rel(y.numpy(), want_y) <= 1e-5, cf
        assert abs(float(aux) - want_aux) <= 1e-6, cf
        key = f"ep/{mode}/{cf}"
        ys = _mesh_y(mesh_runs[shape], key)
        assert np.array_equal(np.concatenate(ys), y.numpy()), cf
        for r in mesh_runs[shape]:
            assert abs(r[key][1] - want_aux) <= 1e-6, cf
            assert r[key][1] == float(aux), cf
            other = r[f"ep/{MODES[0]}/{cf}"]
            assert np.array_equal(r[key][0], other[0]), cf
            assert r[key][1] == other[1], cf


def _dry_layer(cf: float, rank: int):
    """A dry (2, 2) mesh's rank, its MoE params (fake, under the caller's
    mode) and the reduced granite-moe's EP config."""
    cfg = tp_config(port_config(cf), 2, 2)
    mesh = dctx.dry_mesh(2, 2, rank)
    E, d, f = 4, 64, 64
    p = {"router": {"w": torch.zeros((d, E))},
         "w1": {"w": torch.zeros((E // 2, d, f // 2))},
         "w3": {"w": torch.zeros((E // 2, d, f // 2))},
         "w2": {"w": torch.zeros((E // 2, f // 2, d))}}
    return cfg, mesh, p


@pytest.mark.parametrize("rank", [0, 3])
def test_declared_mode_traces_under_fake_tensors(rank):
    """Under ``FakeTensorMode`` on a dry (2, 2) mesh the declared call
    runs (no host read: its record is one fp32 aux all-gather over 'data'
    and two all-to-alls), while the gathered call's read of the infos
    cannot."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        cfg, mesh, p = _dry_layer(1.25, rank)
        x = torch.zeros((4, 16, 64))
        with dctx.use_mesh(mesh, even_rows=True):
            y, aux = moe_ep.moe_dispatch(p, cfg, x)
        assert tuple(y.shape) == (4, 16, 64) and aux.shape == ()
        rec = mesh.record()
        assert rec["all-gather"]["data"] == {"calls": 1, "bytes": 2 * 4}
        assert rec["all-to-all"]["data"]["calls"] == 2
        with dctx.use_mesh(mesh), pytest.raises(Exception) as err:
            moe_ep.moe_dispatch(p, cfg, x)
        assert not isinstance(err.value, moe_ep.UnevenRows)


def test_declared_call_without_rows_raises_uneven_rows():
    """A declared call on a rank with no rows (the global batch cannot
    give every DP rank a row) raises ``UnevenRows``, never the local
    mode's host read."""
    cfg, mesh, p = _dry_layer(1.25, 0)
    with dctx.use_mesh(mesh, even_rows=True), \
            pytest.raises(moe_ep.UnevenRows, match="declared even"):
        moe_ep.moe_dispatch(p, cfg, torch.zeros((0, 16, 64)))
    assert not mesh.record(), "a refused call ran a collective"


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_experts_equal_reference_local(reference, mesh_runs, tp):
    """Every expert on every rank, d_ff over 'model': the shard loop at
    tp 2 and 4, and the gloo ranks of the (2, 2) and (4, 2) meshes (tp
    2), against ``moe_ffn_local``; the mesh is the loop bit for bit."""
    _, ref = reference
    p, x = _params(ref), torch.as_tensor(ref["x"])
    for cf in FACTORS:
        want = ref[f"local/{cf}/y"]
        y, aux = t_moe.moe_ffn_local(p, tp_config(port_config(cf), tp), x)
        assert _rel(y.numpy(), want) <= 1e-5, cf
        assert abs(float(aux) - float(ref[f"local/{cf}/aux"])) <= 1e-6
        if tp == 2:
            for shape in ((2, 2), (4, 2)):
                for r in mesh_runs[shape]:
                    assert np.array_equal(r[f"tp/{cf}"], y.numpy())


def test_rows_on_one_data_rank_keep_the_local_semantics(reference,
                                                        mesh_runs):
    """Every row on data rank 0, none on the others (a per-request
    prefill, the others bringing empty bf16 rows): the local path's
    capacity and order over the whole call in the owner's type, the
    experts still placed by EP; the meshless groups alike, bit for
    bit."""
    _, ref = reference
    p, x = _params(ref), torch.as_tensor(ref["x"])
    for shape in MESHES:
        dp, tp = shape
        for cf in FACTORS:
            cfg = tp_config(port_config(cf), tp, dp)
            ys, aux = moe_ep.moe_ffn_groups(
                p, cfg, [x] + [x[:0].to(torch.bfloat16)] * (dp - 1))
            assert _rel(ys[0].numpy(), ref[f"local/{cf}/y"]) <= 1e-5
            assert abs(float(aux) - float(ref[f"local/{cf}/aux"])) <= 1e-6
            got = _mesh_y(mesh_runs[shape], f"owner/{cf}")
            assert np.array_equal(got[0], ys[0].numpy())
            assert all(g.shape[0] == 0 for g in got[1:])
            for r in mesh_runs[shape]:
                assert r[f"owner/{cf}"][1] == float(aux)


def test_dp_only_profile_equals_reference(reference):
    """``moe_ffn_dp``: each of 8 DP ranks routes its own row through its
    own whole experts (the reference's (4, 2) mesh under dp_only)."""
    _, ref = reference
    p, x = _params(ref), torch.as_tensor(ref["x"])
    y, aux = moe_ep.moe_ffn_dp(p, port_config(1.25), x, shards=8)
    assert _rel(y.numpy(), ref["dp/y"]) <= 1e-5
    assert abs(float(aux) - float(ref["dp/aux"])) <= 1e-6


def test_capacity_and_gate_follow_the_reference():
    """The per-source-shard capacity is the reference's integer formula
    (not the local path's float ceil), and ``can_use_ep`` its gate on
    the call's global shape."""
    cfg = port_config(1.25)
    for n in (1, 2, 7, 16, 33, 128):
        k, E = cfg.moe.top_k, cfg.moe.num_experts
        assert moe_ep.ep_capacity(cfg, n) == max(
            1, -(-n * k * 125 // (100 * E)))
    odd = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=1.1))
    assert moe_ep.ep_capacity(odd, 10) == 6        # int(100 * 1.1) = 110
    shape = {"data": 2, "model": 2}
    assert moe_ep.can_use_ep(cfg, (4, 1), shape)
    assert not moe_ep.can_use_ep(cfg, (1, 8), shape)       # B < dp
    assert not moe_ep.can_use_ep(cfg, (3, 1), shape)       # B S % dp
    assert not moe_ep.can_use_ep(cfg, (4, 1), {"data": 3, "model": 1})
    assert not moe_ep.can_use_ep(cfg, (4, 1), {"data": 1, "model": 2})
    assert not moe_ep.can_use_ep(cfg, (4, 1), None)
