"""The dry run (``repro_torch.launch.dryrun``): one rank's step traced
under ``FakeTensorMode`` on a ``DryMesh``.

* **Records match**: the dry mesh's collective record of one train step
  and one decode step of the reduced qwen3 (2 layers, d 64, vocab 128)
  at meshes (1, 2) and (2, 2) equals, kind for kind and axis for axis,
  calls and bytes, the record of a real gloo mesh of processes running
  the same step, on every rank;
* **held bytes match**: the dry run's held bytes for a rank equal the
  bytes of the real rank's params and ZeRO state;
* **every cell ends cleanly**: every reduced assigned arch × shape cell on
  a dry (2, 2) mesh ends in a row or in a named refusal (a MoE or
  hybrid train step with 'data' > 1: the expert-parallel path reads the
  routing counts on the host); mamba2's train cells trace;
* ``--multi-pod`` traces rank 0 of ``2x16x16``; the CLI prints a row of
  a full-size cell."""
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
from repro_torch.launch import dryrun  # noqa: E402
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
def test_every_reduced_cell_ends_in_a_row_or_a_refusal(arch, shape):
    try:
        rep = dryrun.run_cell(arch, shape, mesh=(2, 2), reduce=True,
                              verbose=False)
    except ValueError as e:
        assert dryrun.refused(e) and "moe_ep.py:178" in str(e)
        cfg = get_config(arch)
        assert shape == "train_4k" and cfg.family in ("moe", "hybrid")
        return
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


def test_family_train_cell_refused_by_the_cli():
    with pytest.raises(SystemExit, match="routing counts on the host"):
        dryrun.main(["--arch", "granite-moe-1b-a400m", "--shape",
                     "train_4k", "--mesh", "2,2"])


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
