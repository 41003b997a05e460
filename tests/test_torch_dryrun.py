"""The dry run (``repro_torch.launch.dryrun``): one rank's step traced
under ``FakeTensorMode`` on a ``DryMesh``.

* **Records match**: the dry mesh's collective record of one train step
  and one decode step of the reduced qwen3 (2 layers, d 64, vocab 128)
  at meshes (1, 2) and (2, 2) equals, kind for kind and axis for axis,
  calls and bytes, the record of a real gloo mesh of processes running
  the same step, on every rank;
* **held bytes match**: the dry run's held bytes for a rank equal the
  bytes of the real rank's params and ZeRO state;
* **MoE steps match**: the reduced granite-moe's train step and decode
  step at (2, 2), experts cut over 'data' and even rows declared (expert
  parallelism with no host read), give each rank's real record and held
  bytes;
* **every cell ends in a row**: every reduced assigned arch × shape cell
  on a dry (2, 2) mesh, the MoE and hybrid train cells included;
* ``--profile dp_only``: a dense and a MoE train cell hold the whole
  tree, run only the gradient reduction over every axis, the moments'
  ZeRO traffic over 'data' and (MoE) ``moe_ffn_dp``'s aux mean;
* ``--multi-pod`` traces rank 0 of ``2x16x16``; the CLI prints a row of
  a full-size cell and of a granite-moe train cell."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import comms  # noqa: E402
from repro_torch.analysis.roofline import (LiveBytes, format_row,  # noqa
                                           tensors)
from repro_torch.configs import (ASSIGNED_ARCHS, ShapeConfig,  # noqa: E402
                                 get_config, reduced, shapes_for)
from repro_torch.distribution.context import dry_mesh, use_mesh  # noqa
from repro_torch.distribution.sharding import (local_config,  # noqa: E402
                                               local_params, tp_config)
from repro_torch.launch import dryrun, specs  # noqa: E402
from repro_torch.launch.mesh import init_file_in, make_mesh  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.train import train_step as ts  # noqa: E402
from repro_torch.train.optimizer import AdamWConfig  # noqa: E402
from repro_torch.train.optimizer import zero_adamw_init  # noqa: E402

MESHES = [(1, 2), (2, 2)]
TRAIN = ShapeConfig("t", "train", seq_len=16, global_batch=4)
DECODE = ShapeConfig("d", "decode", seq_len=32, global_batch=4)
OPT = AdamWConfig(lr=1e-3, quantized=True)


def model_config():
    return reduced(get_config("qwen3-32b"), layers=2, d_model=64,
                   vocab=128)


def moe_config():
    return reduced(get_config("granite-moe-1b-a400m"), layers=2,
                   d_model=64, vocab=128)


def _bytes(*trees) -> int:
    seen, n = set(), 0
    for t in tensors(trees):
        st = t.untyped_storage()
        if st._cdata not in seen:
            seen.add(st._cdata)
            n += st.nbytes()
    return n


def real_rank(rank: int, dp: int, tp: int, init_file: str) -> dict:
    """One rank of a real gloo mesh: the record of one train step and of
    one decode step, and the bytes of its params and ZeRO state."""
    torch.set_num_threads(1)
    mesh = make_mesh(dp, tp, rank=rank, init_file=init_file,
                     backend="gloo", device="cpu")
    cfg = model_config()
    tcfg = tp_config(cfg, tp)
    lcfg = local_config(tcfg, tp)
    whole = lm.init_params(cfg, device="cpu")
    params = local_params(whole, tcfg, tp, mesh.model_rank)
    layout = ts.mesh_layout(cfg, dp, tp, OPT)
    opt = zero_adamw_init(params, layout.zero, OPT, mesh)
    out = {"held": _bytes(params, opt)}
    step = ts.make_mesh_train_step(lcfg, OPT, mesh, layout)
    batch = {"tokens": torch.randint(0, 128, (TRAIN.global_batch,
                                               TRAIN.seq_len),
                                     generator=torch.Generator()
                                     .manual_seed(0), dtype=torch.int32)}
    mesh.reset_record()
    step(params, opt, batch)
    out["train"] = mesh.record()
    n = DECODE.global_batch // dp
    caches = lm.init_caches(None, lcfg, n, DECODE.seq_len, device="cpu")
    mesh.reset_record()
    with use_mesh(mesh), torch.no_grad():
        lm.decode_step(params, lcfg, torch.zeros((n, 1), dtype=torch.int32),
                       torch.full((n,), DECODE.seq_len - 1,
                                  dtype=torch.int32), caches)
    out["decode"] = mesh.record()
    return out


def real_moe_rank(rank: int, dp: int, tp: int, init_file: str) -> dict:
    """One rank of a real gloo mesh running the reduced granite-moe: the
    record and held bytes of one train step (its experts cut over 'data'
    by the training layout) and of one decode step (the serving tree at
    ``tp_config(ep=dp)``, the dry run's step function)."""
    torch.set_num_threads(1)
    mesh = make_mesh(dp, tp, rank=rank, init_file=init_file,
                     backend="gloo", device="cpu")
    cfg = moe_config()
    lcfg = local_config(tp_config(cfg, tp, ep=dp), tp)
    whole = lm.init_params(cfg, device="cpu")
    layout = ts.mesh_layout(cfg, dp, tp, OPT)
    params = ts.rank_slices(whole, layout, mesh)
    opt = zero_adamw_init(params, layout.zero, OPT, mesh)
    out = {"train_held": _bytes(params, opt)}
    step = ts.make_mesh_train_step(lcfg, OPT, mesh, layout)
    batch = {"tokens": torch.randint(0, 128, (TRAIN.global_batch,
                                               TRAIN.seq_len),
                                     generator=torch.Generator()
                                     .manual_seed(0), dtype=torch.int32)}
    mesh.reset_record()
    step(params, opt, batch)
    out["train"] = mesh.record()
    assert specs.serve_ep(cfg, DECODE, mesh) == dp
    sp = local_params(whole, tp_config(cfg, tp, ep=dp), tp, mesh.model_rank,
                      ep=dp, data_rank=mesh.data_rank)
    out["decode_held"] = _bytes(sp)
    inputs = specs.input_shardings(cfg, lcfg, DECODE, mesh,
                                   specs.input_specs(cfg, DECODE))
    mesh.reset_record()
    specs.make_step_fn(lcfg, DECODE, mesh)(sp, inputs)
    out["decode"] = mesh.record()
    # the dp_only profile: whole params, every process a DP rank
    lay = ts.mesh_layout(cfg, dp, tp, OPT, profile="dp_only")
    pw = ts.rank_slices(whole, lay, mesh)
    ow = zero_adamw_init(pw, lay.zero, OPT, mesh)
    out["dp_only_held"] = _bytes(pw, ow)
    step = ts.make_mesh_train_step(local_config(tp_config(cfg, 1), 1), OPT,
                                   mesh, lay, on_grads=lambda gs: out.update(
                                       dp_only_grads={p: g.numpy().copy()
                                                      for p, g in
                                                      gs.items()}))
    mesh.reset_record()
    _, _, m = step(pw, ow, batch)
    out["dp_only"] = mesh.record()
    out["dp_only_metrics"] = {k: float(v) for k, v in m.items()}
    return out


@pytest.fixture(scope="module")
def real_moe(tmp_path_factory):
    store = init_file_in(str(tmp_path_factory.mktemp("drymoe")))
    return run_ranks(real_moe_rank, 4, (2, 2, store), timeout=120)


@pytest.mark.parametrize("kind", ["train", "decode"])
def test_dry_moe_record_and_held_equal_real_mesh(real_moe, kind):
    """Expert parallelism declared even, traced with fake tensors: each
    rank's record (two all-to-alls a MoE layer and their backward, one
    fp32 aux all-gather over 'data') and held bytes equal the real
    gloo rank's."""
    shape = TRAIN if kind == "train" else DECODE
    for rank, got in enumerate(real_moe):
        dry = dryrun.trace_step(moe_config(), shape, 2, 2, rank,
                                opt_cfg=OPT)
        assert dry["record"] == got[kind], (rank, kind)
        assert dry["held"] == got[f"{kind}_held"], (rank, kind)
        assert dry["lcfg"].ep_shards == 2
        a2a, ag = got[kind]["all-to-all"]["data"], \
            got[kind]["all-gather"]["data"]
        n_moe = moe_config().num_layers
        assert a2a["calls"] >= 2 * n_moe and ag["calls"] >= n_moe


@pytest.fixture(scope="module", params=MESHES,
                ids=[f"mesh{d}x{t}" for d, t in MESHES])
def real(request, tmp_path_factory):
    dp, tp = request.param
    store = init_file_in(str(tmp_path_factory.mktemp(f"dry{dp}{tp}")))
    return dp, tp, run_ranks(real_rank, dp * tp, (dp, tp, store),
                             timeout=60)


@pytest.mark.parametrize("kind", ["train", "decode"])
def test_dry_record_equals_real_mesh(real, kind):
    dp, tp, ranks = real
    shape = TRAIN if kind == "train" else DECODE
    for rank, got in enumerate(ranks):
        dry = dryrun.trace_step(model_config(), shape, dp, tp, rank,
                                opt_cfg=OPT)
        assert dry["record"] == got[kind], (rank, kind)
        assert got[kind], "the step ran no collective"


def test_dry_held_bytes_equal_real_rank(real):
    dp, tp, ranks = real
    for rank, got in enumerate(ranks):
        dry = dryrun.trace_step(model_config(), TRAIN, dp, tp, rank,
                                opt_cfg=OPT)
        assert dry["held"] == got["held"], rank
        assert dry["peak"] > dry["held"]


def test_live_bytes_tracks_frees():
    live = LiveBytes()
    a = torch.zeros(1000)
    assert live.hold(a, {"x": a}) == 4000
    with live:
        b = torch.ones(500)
        c = b * 2
        del b, c
        d = torch.zeros(250, dtype=torch.float64)
    assert (live.peak, live.live) == (8000, 6000)
    del d


def test_comms_reads_a_record():
    mesh = dry_mesh(2, 4, 5)
    x = torch.ones(3, 8)
    mesh.psum(x)
    mesh.psum_scatter(x, 1)
    mesh.all_gather(x, -1)
    mesh.data_all_to_all(torch.ones(2, 3, dtype=torch.bfloat16))
    mesh.world_value(torch.ones(2))
    assert comms.collective_bytes(mesh.record()) == {
        "all-reduce": 96, "reduce-scatter": 24, "all-gather": 384,
        "all-to-all": 12, "broadcast": 8}
    assert comms.total_collective_bytes(mesh.record()) == 524
    assert comms.count_ops(mesh.record(), "all-gather", "broadcast",
                           "all-to-all") == {"all-gather": 1,
                                             "broadcast": 1,
                                             "all-to-all": 1}
    assert mesh.a2a == {"calls": 1, "bytes": 12}
    sub = mesh.submesh()
    sub.psum(x)
    assert mesh.record()["all-reduce"]["model"]["calls"] == 2


CELLS = [(a, s.name) for a in ASSIGNED_ARCHS
         for s in shapes_for(get_config(a))]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_every_reduced_cell_ends_in_a_row(arch, shape):
    rep = dryrun.run_cell(arch, shape, mesh=(2, 2), reduce=True,
                          verbose=False)
    if get_config(arch).moe is not None and shape != "long_500k":
        assert rep.coll_breakdown["all-to-all"] > 0, "experts not in EP"
    assert rep.flops > 0 and rep.bound_s > 0 and rep.chips == 4
    assert rep.peak_memory_per_device >= rep.held_memory_per_device > 0
    assert rep.counted_flops > 0
    assert format_row(rep).startswith(arch)


def test_multi_pod_cell_traces_rank_0_of_2x16x16(tmp_path, capsys):
    """``--multi-pod`` traces rank 0 of the reference's (2, 16, 16) mesh:
    the row names ``2x16x16``, the report 512 chips and 'pod' rows in the
    collective record."""
    assert dryrun.main(["--arch", "qwen3-32b", "--shape", "decode_32k",
                        "--multi-pod", "--out", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert out.startswith("qwen3-32b") and "2x16x16" in out
    (f,) = tmp_path.iterdir()
    assert f.name == "qwen3-32b_decode_32k_2x16x16.json"
    rep = dryrun.run_cell("qwen3-32b", "train_4k", multi_pod=True,
                          reduce=True, verbose=False)
    assert rep.mesh == "2x16x16" and rep.chips == 512
    assert rep.coll_axes["pod"] > 0


def test_cli_prints_a_family_train_row(tmp_path, capsys, monkeypatch):
    """A MoE train cell's row from the CLI on a dry (2, 2) mesh: its
    experts in EP over 'data', all-to-alls in the record (the reduced
    config at train_4k's shape, to keep the trace short)."""
    whole = dryrun.cell_config
    monkeypatch.setattr(dryrun, "cell_config",
                        lambda arch, **kw: whole(arch, **{**kw,
                                                          "reduce": True}))
    assert dryrun.main(["--arch", "granite-moe-1b-a400m", "--shape",
                        "train_4k", "--mesh", "2,2", "--out",
                        str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert out.startswith("granite-moe-1b-a400m") and "train_4k" in out
    assert "experts in 2 EP shard(s)" in out and "all-to-all" in out
    (f,) = tmp_path.iterdir()
    assert f.name == "granite-moe-1b-a400m_train_4k_2x2.json"


def test_dp_only_mesh_step_equals_the_loop_and_the_dry_rank(real_moe):
    """The granite step under ``dp_only`` on a real (2, 2) gloo mesh:
    each rank's reduced gradient slices equal the meshless loop's mean
    gradient over the 4 DP ranks (each routing its own row through its
    own whole experts, ``moe_ffn_dp``) within 1e-5 of the leaf's scale,
    the loss and aux its mean within 1e-6; the dry rank's record and held
    bytes equal the real rank's."""
    from repro_torch.core.pruning import iter_leaves
    from repro_torch.train.optimizer import _zero_dim, adamw_init, local_slice
    cfg = moe_config()
    lay = ts.mesh_layout(cfg, 2, 2, OPT, profile="dp_only")
    whole = lm.init_params(cfg, device="cpu")
    want = {}
    step = ts.make_train_step(tp_config(cfg, 1), OPT, data_shards=4,
                              on_grads=lambda g: want.update(
                                  dict(iter_leaves(g))))
    batch = {"tokens": torch.randint(0, 128, (TRAIN.global_batch,
                                               TRAIN.seq_len),
                                     generator=torch.Generator()
                                     .manual_seed(0), dtype=torch.int32)}
    _, _, m = step(whole, adamw_init(whole, OPT), batch)
    for rank, got in enumerate(real_moe):
        for k in ("loss", "aux", "ce"):
            assert abs(got["dp_only_metrics"][k] - float(m[k])) <= 1e-6 * (
                1 + abs(float(m[k]))), (rank, k)
        mesh = dry_mesh(2, 2, rank)
        for path, g in got["dp_only_grads"].items():
            w = local_slice(want[path], _zero_dim(lay.zero, path),
                            mesh).numpy()
            scale = float(want[path].abs().max()) + 1e-30
            assert float(abs(g - w).max()) <= 1e-5 * scale, (rank, path)
        dry = dryrun.trace_step(cfg, TRAIN, 2, 2, rank, opt_cfg=OPT,
                                profile="dp_only")
        assert dry["record"] == got["dp_only"], rank
        assert dry["held"] == got["dp_only_held"], rank


# (kind, axis) pairs a dp_only train step may record: the gradient
# reduction ('data' then 'model'), the moments' ZeRO traffic over 'data'
# (the params' all-gather, the int8 scales' max), the global norm
# ('world'), the metrics' and moe_ffn_dp's aux mean over every axis
DP_ONLY = {("reduce-scatter", "data"), ("all-reduce", "data"),
           ("all-reduce", "model"), ("all-gather", "data"),
           ("all-reduce", "world"), ("all-reduce", "data,model"),
           ("all-gather", "data,model")}


@pytest.mark.parametrize("arch", ["qwen3-32b", "granite-moe-1b-a400m"])
def test_dp_only_train_cell_holds_whole_params(arch, tmp_path):
    """``--profile dp_only`` on (2, 2): rank 3 holds the whole tree; the
    record is the gradient reduction over every axis, ZeRO over 'data'
    and (MoE) the aux all-gather over every axis, with no all-to-all;
    the tag ends in ``_dp_only``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = dryrun.cell_config(arch, reduce=True)
    shape = ShapeConfig("t", "train", seq_len=16, global_batch=8)
    tr = dryrun.trace_step(cfg, shape, 2, 2, 3, profile="dp_only")
    opt_cfg = AdamWConfig(quantized=True)
    with FakeTensorMode():
        whole = lm.init_params(cfg, device="cpu")
        lay = ts.mesh_layout(cfg, 2, 2, opt_cfg, profile="dp_only")
        held = _bytes(whole, zero_adamw_init(whole, lay.zero, opt_cfg,
                                             dry_mesh(2, 2, 3)))
    assert tr["held"] == held > _bytes(whole)
    assert tr["lcfg"].tp_shards == 1 and tr["lcfg"].ep_shards == 1
    rec = tr["record"]
    pairs = {(k, a) for k, axes in rec.items() for a in axes}
    assert pairs <= DP_ONLY, pairs - DP_ONLY
    assert {("reduce-scatter", "data"), ("all-reduce", "model"),
            ("all-gather", "data")} <= pairs
    assert (("all-gather", "data,model") in pairs) == (cfg.moe is not None)
    if cfg.moe is not None:
        ag = rec["all-gather"]["data,model"]
        assert ag["bytes"] == ag["calls"] * 4 * 4      # fp32, 4 ranks
    rep = dryrun.run_cell(arch, "train_4k", mesh=(2, 2), reduce=True,
                          profile="dp_only", out_dir=str(tmp_path),
                          verbose=False)
    assert rep.note.endswith("dp_only")
    (f,) = tmp_path.iterdir()
    assert f.name == f"{arch}_train_4k_2x2_dp_only.json"


def test_cli_prints_a_full_size_row(tmp_path, capsys):
    assert dryrun.main(["--arch", "qwen3-32b", "--shape", "decode_32k",
                        "--mesh", "2,2", "--out", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert out.startswith("qwen3-32b") and "fits=" in out
    (f,) = tmp_path.iterdir()
    assert f.name == "qwen3-32b_decode_32k_2x2.json"


def test_heads_replicated_cell_on_the_production_mesh_shape():
    """qwen3's 8 KV heads do not divide 16 model ranks: the rank runs
    every head (a reduced model with 8 KV heads on a (1, 16) mesh)."""
    cfg = dataclasses.replace(model_config(), num_heads=8, num_kv_heads=8,
                              head_dim=8)
    tr = dryrun.trace_step(cfg, DECODE, 1, 16, 3)
    assert tr["lcfg"].heads_replicated and tr["lcfg"].num_kv_heads == 8
    ag = tr["record"]["all-gather"]["model"]
    assert ag["calls"] == 3 * cfg.num_layers + 1


LONG = ShapeConfig("l", "decode", seq_len=128, global_batch=1)


def test_long_context_cell_cuts_rings_over_data_and_model():
    """A ``long_500k``-like cell (B = 1) of a reduced gemma3 with one KV
    head (which does not split over 2 model ranks) on a dry (2, 2) mesh:
    the rank's rings hold C / (D T) slots, windowed and global alike
    (``sharding.seq_axes``), and the decode step's record names the
    combine's collectives over 'data,model': one all-reduce (the max)
    and two all-gathers (the ordered sums) an attention layer."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.distribution.sharding import seq_config
    cfg = dataclasses.replace(
        dryrun.cell_config("gemma3-4b", reduce=True), num_kv_heads=1)
    tr = dryrun.trace_step(cfg, LONG, 2, 2, 3)
    lcfg = tr["lcfg"]
    assert lcfg.heads_replicated and lcfg.seq_mesh == (2, 2)
    assert lcfg.seq_cache_len == LONG.seq_len and lcfg.seq_index == 3
    L = cfg.num_layers
    assert tr["record"]["all-reduce"]["data,model"]["calls"] == L
    assert tr["record"]["all-gather"]["data,model"]["calls"] == 2 * L
    with FakeTensorMode():
        mesh = dry_mesh(2, 2, 3)
        caches = specs.input_shardings(
            cfg, seq_config(local_config(tp_config(cfg, 2), 2), mesh, 1,
                            LONG.seq_len),
            LONG, mesh, specs.input_specs(cfg, LONG))["caches"]
    caps = [lm.ring_capacity(cfg, spec, LONG.seq_len)
            for pattern, _ in lm.segment_plan(cfg) for spec in pattern]
    assert [int(c.k.shape[2]) for seg in caches for c in seg.values()] \
        == [c // 4 for c in caps]


def test_moe_cell_at_one_row_cuts_experts_over_data():
    """A MoE decode cell at B = 1 on a dry (2, 2) mesh: the experts stay
    cut over 'data' (E / D a rank), the step declares replicated rows
    (``moe_ep.moe_ffn_replicated``: no all-to-all, no host read under
    fake tensors) and its record names one ordered sum over 'data' a MoE
    layer beside the rings' combine."""
    cfg = dryrun.cell_config("granite-moe-1b-a400m", reduce=True)
    tr = dryrun.trace_step(cfg, LONG, 2, 2, 1)
    lcfg = tr["lcfg"]
    assert lcfg.ep_shards == 2 and lcfg.seq_mesh == (2, 1)
    rec = tr["record"]
    assert "all-to-all" not in rec
    L = cfg.num_layers
    # per layer: the MoE's sum, and the rings' two sums, over 'data'
    assert rec["all-gather"]["data"]["calls"] == 3 * L
    assert rec["all-reduce"]["data"]["calls"] == L
    dense = dryrun.trace_step(cfg, LONG, 1, 2, 1)
    assert dense["lcfg"].ep_shards == 1
    assert tr["held"] < dense["held"]
