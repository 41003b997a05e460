"""Training on a (data, model) mesh (``repro_torch.train.train_step.
make_mesh_train_step``), spawned gloo ranks on the CPU, the reduced qwen3
of ``torch_parity`` (2 layers, d 64, vocab 128, 16x16 tiles), at meshes
(1,2), (2,1) and (2,2), with and without the SASP overlay (25% of the
FFN tiles), 1 and 2 micro-batches, fp32 and int8 moments:

* against the reference's single-device ``make_train_step`` on bridged
  params: the loss within 1e-5 relative, the step's gradients (the mean
  over 'data', gathered from the ranks' ZeRO slices) within 1e-4 of each
  leaf's largest, the params after 1 and 3 steps within 1e-3 of each
  leaf's largest;
* against the port's meshless loop at the same shard counts
  (``make_train_step(data_shards=)`` on a ``tp_config``): losses within
  1e-6 relative, gradients within 1e-6 of each leaf's largest, the
  params after one step within 1e-4 of each leaf's largest: the TP ranks
  sum a gradient's partials in another order than the loop, and AdamW's
  m / (sqrt(v) + eps) turns a last bit into a visible share of the
  lr-sized update where |g| is small (the loop at tp 2 and one device
  part by 1e-4 of w2's largest after one step, on the CPU);
* every pruned tile's gradient exactly 0 on every rank, and the ranks'
  overlay masks, gathered, equal to the single-device overlay's;
* a mesh checkpoint saved at step 2 and restored on the mesh gives step
  3 bit for bit as the uninterrupted run, and the reference's
  ``CheckpointManager`` reads it (its leaves the ranks' state, gathered);
* the grad of a replicated input through a column region (attention's
  projections, the FFN) equals the shard loop's: a collective that
  detached under autograd would drop the other rank's partial;
* the launcher: ``--mesh 2,2`` end to end with ``--resume``, and its
  usage errors.

With int8 moments the params after 3 steps are not compared: one ulp of a
gradient moves a moment's ``q`` a step at a .5 tie, which m / (sqrt(v) +
eps) amplifies where v is small (``tests/test_torch_train.py``,
``test_ten_step_trajectory_equal``); their moments and params are held
after one step. The module imports no jax at its top: the spawned ranks
import it."""
import copy
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import bridge  # noqa: E402
from repro_torch.configs import SASPConfig, get_config, reduced  # noqa: E402
from repro_torch.core.pruning import iter_leaves  # noqa: E402
from repro_torch.core.sasp import build_sasp_overlay  # noqa: E402
from repro_torch.core.sasp import mesh_overlay  # noqa: E402
from repro_torch.data.pipeline import DataConfig, lm_batch  # noqa: E402
from repro_torch.distribution.context import use_mesh  # noqa: E402
from repro_torch.distribution.sharding import (local_config,  # noqa: E402
                                               local_params, tp_config)
from repro_torch.launch import train as t_launch  # noqa: E402
from repro_torch.launch.mesh import init_file_in  # noqa: E402
from repro_torch.launch.mesh import make_mesh, run_ranks  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models import ffn as t_ffn  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.train import train_step as t_step  # noqa: E402
from repro_torch.train.checkpoint import (CheckpointManager,  # noqa: E402
                                          gather_whole, named_leaves,
                                          restore_on_mesh, save_on_mesh)
from repro_torch.train.optimizer import (AdamWConfig, adamw_init,  # noqa
                                         reduce_grads, zero_adamw_init)

MESHES = [(1, 2), (2, 1), (2, 2)]
CASES = [(ov, k, q) for ov in (False, True) for k in (1, 2)
         for q in (False, True)]
LR, STEPS, BATCH, SEQ = 1e-3, 3, 4, 16
SASP = dict(enabled=True, block_k=16, block_n=16, sparsity=0.25,
            scope="ffn")


def case_id(case) -> str:
    ov, k, q = case
    return f"{'overlay' if ov else 'dense'}-mb{k}-{'int8' if q else 'fp32'}"


def port_config():
    return dataclasses.replace(
        reduced(get_config("qwen3-32b"), layers=2, d_model=64, vocab=128),
        sasp=SASPConfig(**SASP))


def batches():
    return [{k: torch.from_numpy(v) for k, v in lm_batch(
        DataConfig(128, SEQ, BATCH), s).items()} for s in range(STEPS)]


def _fresh(whole, cfg, tp, rank):
    """The rank's slices of a copy of ``whole`` (the steps update params
    in place, and ``local_params`` passes the leaves it does not cut)."""
    return local_params(copy.deepcopy(whole), tp_config(cfg, tp), tp, rank)


def _np(tree):
    return {n: t.detach().float().numpy().copy()
            for n, t in named_leaves(tree)}


def _gather_state(params, layout, mesh):
    """{name: whole param} from the ranks' TP slices."""
    return {n: gather_whole(t, layout.params[p], mesh).numpy().copy()
            for (p, t), (n, _) in zip(iter_leaves(params),
                                      named_leaves(params))}


def _pruned_grad_max(grads, overlay) -> float:
    """The largest |gradient| over the pruned tiles of the rank's masked
    matrices (its own tiles)."""
    worst = 0.0
    for si, seg in overlay["segments"].items():     # overlay keys: str
        for slot, node in seg.items():
            for name, m in node["ffn"]["sasp_masks"].items():
                g = grads["segments"][int(si)][slot]["ffn"][name]["w"]
                L, K, N = g.shape
                KB, NB = m.shape[-2:]
                tiles = g.reshape(L, KB, K // KB, NB, N // NB).abs().amax(
                    dim=(2, 4))
                if (~m).any():
                    worst = max(worst, float(tiles[~m].max()))
    return worst


def _gathered_masks(overlay, layout, mesh):
    out = {}
    for si, seg in overlay["segments"].items():
        for slot, node in seg.items():
            for name, m in node["ffn"]["sasp_masks"].items():
                spec = layout.params[("segments", int(si), slot, "ffn", name,
                                      "w")]
                out[f"{si}/{slot}/{name}"] = gather_whole(
                    m.to(torch.uint8), spec, mesh).bool().numpy()
    return out


def _run_case(mesh, whole, case):
    """One case on this rank: the step's gathered mean gradient (and the
    pruned tiles' largest local gradient), then STEPS mesh steps (losses,
    the gathered params after 1 and STEPS steps, the moments after 1)."""
    ov_on, K, q = case
    dp, tp = mesh.shape["data"], mesh.shape["model"]
    cfg = port_config()
    opt_cfg = AdamWConfig(lr=LR, quantized=q)
    layout = t_step.mesh_layout(cfg, dp, tp, opt_cfg)
    params = _fresh(whole, cfg, tp, mesh.model_rank)
    opt = zero_adamw_init(params, layout.zero, opt_cfg, mesh)
    lcfg = local_config(tp_config(cfg, tp), tp)
    out = {}
    ov = None
    if ov_on:
        ov, out["sparsity"] = mesh_overlay(params, cfg.sasp, mesh,
                                           layout.params)
        out["masks"] = _gathered_masks(ov, layout, mesh)
    bs = batches()
    with use_mesh(mesh):
        _, _, g = t_step._grads(lcfg, params, t_step._rows(
            bs[0], mesh.data_rank, dp), ov, K, None)
        if ov_on:
            out["pruned_grad_max"] = _pruned_grad_max(g, ov)
        gs = reduce_grads(g, layout.zero, mesh)
    out["grads"] = {n: gather_whole(gs[p], layout.zero[p], mesh).numpy()
                    .copy()
                    for (p, _), (n, _) in zip(iter_leaves(params),
                                              named_leaves(params))}
    step = t_step.make_mesh_train_step(lcfg, opt_cfg, mesh, layout,
                                       overlay=ov, n_microbatches=K)
    out["losses"] = []
    for i, b in enumerate(bs):
        params, opt, m = step(params, opt, b)
        out["losses"].append(float(m["loss"]))
        if i in (0, STEPS - 1):
            out[f"params{i + 1}"] = _gather_state(params, layout, mesh)
    return out


def _ckpt_case(mesh, whole, store_dir, quantized):
    """Steps 1-3 uninterrupted; a checkpoint at step 2, restored into a
    fresh state, step 3 again."""
    dp, tp = mesh.shape["data"], mesh.shape["model"]
    cfg = port_config()
    opt_cfg = AdamWConfig(lr=LR, quantized=quantized)
    layout = t_step.mesh_layout(cfg, dp, tp, opt_cfg)
    lcfg = local_config(tp_config(cfg, tp), tp)

    def fresh():
        p = _fresh(whole, cfg, tp, mesh.model_rank)
        return p, zero_adamw_init(p, layout.zero, opt_cfg, mesh)
    params, opt = fresh()
    specs = t_step.state_specs(params, layout)
    ov, _ = mesh_overlay(params, cfg.sasp, mesh, layout.params)
    step = t_step.make_mesh_train_step(lcfg, opt_cfg, mesh, layout,
                                       overlay=ov)
    bs = batches()
    mgr = CheckpointManager(store_dir)
    for i in range(2):
        params, opt, _ = step(params, opt, bs[i])
    save_on_mesh(mgr, 2, {"params": params, "opt": opt}, specs, mesh,
                 extra={"step": 2})
    saved = _gather_state(params, layout, mesh)
    params, opt, m = step(params, opt, bs[2])
    want = (float(m["loss"]), _np(params), _np(opt))
    p2, o2 = fresh()
    with mgr.reader() as reader:
        state = restore_on_mesh(reader, {"params": p2, "opt": o2}, specs,
                                mesh)
    p2, o2, m2 = step(state["params"], state["opt"], bs[2])
    return dict(saved=saved, equal=(float(m2["loss"]) == want[0]
                                    and _all_equal(_np(p2), want[1])
                                    and _all_equal(_np(o2), want[2])))


def _all_equal(a, b) -> bool:
    return a.keys() == b.keys() and all(np.array_equal(a[k], b[k])
                                        for k in a)


def _detach_case(mesh, whole):
    """d(sum(out * r))/dx of a replicated x through attention's column
    projections (q/k/v, then their heads' outputs concatenated over the
    ranks) and through the dense FFN, on this rank's shard."""
    tp = mesh.shape["model"]
    cfg = port_config()
    lcfg = local_config(tp_config(cfg, tp), tp)
    local = _fresh(whole, cfg, tp, mesh.model_rank)
    layer = lm.layer_params(local["segments"][0]["slot0"], 0)
    return {name: g.numpy() for name, g in
            _region_grads(layer, lcfg, mesh).items()}


def _region_grads(layer, cfg, mesh=None):
    gen = torch.Generator().manual_seed(3)
    x0 = torch.randn((2, 5, 64), generator=gen)
    r = torch.randn((2, 5, 64), generator=gen)
    rq = torch.randn((2, 5, 4, 16), generator=gen)
    out = {}
    with torch.enable_grad(), use_mesh(mesh):
        x = x0.clone().requires_grad_(True)
        q, k, v = t_attn._project_qkv(layer["mixer"], cfg, x,
                                      torch.arange(5))
        if mesh is not None:          # every rank's heads, in head order
            q, k, v = (mesh.all_gather(t, 2) for t in (q, k, v))
        (out["qkv"],) = torch.autograd.grad(
            (q * rq).sum() + (k * rq).sum() + v.square().mean(), x)
        x = x0.clone().requires_grad_(True)
        y = t_ffn.ffn_apply(layer["ffn"], cfg, x)
        (out["ffn"],) = torch.autograd.grad((y * r).sum(), x)
        # a partial (rank s: x (s + 1)) reduced as a reduce-scatter and an
        # all-gather (psum_scatter's backward an all-gather, all_gather's
        # the rank's slice, copy_to_model's a psum)
        x = x0.clone().requires_grad_(True)
        if mesh is not None:
            part = mesh.copy_to_model(x) * (mesh.model_rank + 1)
            y = mesh.all_gather(mesh.psum_scatter(part, 2), 2)
        else:
            y = sum(x * (s + 1) for s in range(cfg.tp_shards))
        (out["rs_ag"],) = torch.autograd.grad((y * r).sum(), x)
    return out


def mesh_rank(rank: int, dp: int, tp: int, init_file: str, params_np,
              store_dir: str) -> dict:
    torch.set_num_threads(1)
    mesh = make_mesh(dp, tp, rank=rank, init_file=init_file,
                     backend="gloo", device="cpu")
    whole = bridge.from_numpy(params_np, device="cpu")
    out = {case: _run_case(mesh, whole, case) for case in CASES}
    out["ckpt"] = {q: _ckpt_case(mesh, whole, f"{store_dir}/ckpt_{q}", q)
                   for q in (False, True)}
    out["detach"] = _detach_case(mesh, whole)
    out["remat"] = _remat_case(mesh, whole)
    return out


def _remat_case(mesh, whole):
    """The rank's loss and gradients under remat full and dots (each
    layer's forward collectives run again in backward, in the same order
    on every rank) against remat none: the largest difference over each
    leaf's largest."""
    tp = mesh.shape["model"]
    cfg = port_config()
    lcfg = local_config(tp_config(cfg, tp), tp)
    params = _fresh(whole, cfg, tp, mesh.model_rank)
    b = t_step._rows(batches()[0], mesh.data_rank, mesh.shape["data"])
    out = {}
    with use_mesh(mesh):
        base = t_step.value_and_grad(lcfg, params, b)
        for remat in ("full", "dots"):
            loss, _, g = t_step.value_and_grad(
                dataclasses.replace(lcfg, remat=remat), params, b)
            err = max(float((a - c).abs().max() / c.abs().max().clamp_min(
                1e-30)) for (_, a), (_, c) in zip(iter_leaves(g),
                                                  iter_leaves(base[2])))
            out[remat] = (abs(float(loss) - float(base[0])), err)
    return out


# ---------------------------------------------------------------------------
# oracles: the reference's single-device step and the port's meshless loop
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref_model():
    """(reference cfg, its params, their numpy copy)."""
    jax = pytest.importorskip("jax")
    from repro.configs import SASPConfig as RSASP
    from repro.configs import get_config as r_get_config
    from repro.configs import reduced as r_reduced
    from repro.models import lm as r_lm
    cfg = dataclasses.replace(
        r_reduced(r_get_config("qwen3-32b"), layers=2, d_model=64,
                  vocab=128), sasp=RSASP(**SASP))
    params = r_lm.init_params(jax.random.PRNGKey(0), cfg)
    return cfg, params, jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def reference(ref_model):
    """Every case through the reference's jitted single-device step:
    losses, the first step's gradients (of the whole batch), params after
    1 and STEPS steps."""
    import jax
    import jax.numpy as jnp
    from repro.core import sasp as r_sasp
    from repro.models import lm as r_lm
    from repro.train import optimizer as r_opt
    from repro.train.checkpoint import _flatten_with_names
    from repro.train.train_step import make_train_step
    cfg, params0, _ = ref_model
    ov_all, _ = r_sasp.build_sasp_overlay(params0, cfg.sasp)
    rb = [{k: jnp.asarray(v.numpy()) for k, v in b.items()}
          for b in batches()]

    def np_tree(t):
        return {n: np.asarray(x, np.float32) for n, x in
                _flatten_with_names(t)}
    out = {}
    for ov_on, K, q in CASES:
        ov = ov_all if ov_on else None
        if (ov_on, q) not in out:
            grads = jax.grad(lambda p: r_lm.loss_fn(
                r_sasp.merge_overlay(p, ov) if ov else p, cfg, rb[0])[0])(
                    params0)
            out[ov_on, q] = np_tree(grads)
        oc = r_opt.AdamWConfig(lr=LR, quantized=q)
        step = jax.jit(make_train_step(cfg, oc, overlay=ov,
                                       n_microbatches=K))
        p, s = params0, r_opt.adamw_init(params0, oc)
        res = {"losses": [], "grads": out[ov_on, q]}
        for i, b in enumerate(rb):
            p, s, m = step(p, s, b)
            res["losses"].append(float(m["loss"]))
            if i in (0, STEPS - 1):
                res[f"params{i + 1}"] = np_tree(p)
        out[ov_on, K, q] = res
    return out


def loop_case(params_np, dp, tp, case):
    """The port's meshless loop at (dp, tp): a TP config's shard loop,
    every data rank's rows in turn."""
    ov_on, K, q = case
    cfg = port_config()
    whole = bridge.from_numpy(params_np, device="cpu")
    tcfg = tp_config(cfg, tp)
    ov = build_sasp_overlay(whole, cfg.sasp)[0] if ov_on else None
    oc = AdamWConfig(lr=LR, quantized=q)
    bs = batches()
    parts = [t_step._grads(tcfg, whole, t_step._rows(bs[0], d, dp), ov, K,
                           None)[2] for d in range(dp)]
    grads = {n: sum(_np(p)[n] for p in parts[1:]) + _np(parts[0])[n]
             for n in _np(parts[0])}
    step = t_step.make_train_step(tcfg, oc, overlay=ov, n_microbatches=K,
                                  data_shards=dp)
    opt = adamw_init(whole, oc)
    out = {"losses": [], "grads": {n: g / dp for n, g in grads.items()},
           "overlay": ov}
    for i, b in enumerate(bs):
        whole, opt, m = step(whole, opt, b)
        out["losses"].append(float(m["loss"]))
        if i in (0, STEPS - 1):
            out[f"params{i + 1}"] = _np(whole)
    return out


@pytest.fixture(scope="module", params=MESHES,
                ids=[f"mesh{d}x{t}" for d, t in MESHES])
def mesh_run(request, ref_model, tmp_path_factory):
    dp, tp = request.param
    d = str(tmp_path_factory.mktemp(f"mesh{dp}{tp}"))
    res = run_ranks(mesh_rank, dp * tp,
                    (dp, tp, init_file_in(d), ref_model[2], d), timeout=300)
    loops = {case: loop_case(ref_model[2], dp, tp, case) for case in CASES}
    return dp, tp, res, loops, d


def _close(got: dict, want: dict, tol: float, what: str):
    """Every leaf within ``tol`` of that leaf's largest magnitude."""
    assert got.keys() == want.keys(), what
    for n in want:
        scale = max(float(np.abs(want[n]).max()), 1e-30)
        err = float(np.abs(got[n] - want[n]).max())
        assert err <= tol * scale, (what, n, err, scale)


@pytest.mark.parametrize("case", CASES, ids=[case_id(c) for c in CASES])
def test_mesh_step_matches_the_reference(mesh_run, reference, case):
    _, _, res, _, _ = mesh_run
    got, want = res[0][case], reference[case]
    np.testing.assert_allclose(got["losses"][0], want["losses"][0],
                               rtol=1e-5)
    _close(got["grads"], want["grads"], 1e-4, "grads")
    _close(got["params1"], want["params1"], 1e-3, "params after 1 step")
    if not case[2]:
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
        _close(got["params3"], want["params3"], 1e-3,
               f"params after {STEPS} steps")


@pytest.mark.parametrize("case", CASES, ids=[case_id(c) for c in CASES])
def test_mesh_step_equals_its_meshless_loop(mesh_run, case):
    _, _, res, loops, _ = mesh_run
    want = loops[case]
    for r in res:                          # every rank reports the same
        got = r[case]
        np.testing.assert_allclose(got["losses"][0], want["losses"][0],
                                   rtol=1e-6)
        if not case[2]:
            np.testing.assert_allclose(got["losses"], want["losses"],
                                       rtol=1e-6)
        _close(got["grads"], want["grads"], 1e-6, "grads")
        _close(got["params1"], want["params1"], 1e-4, "params after 1 step")


@pytest.mark.parametrize("case", [c for c in CASES if c[0]],
                         ids=[case_id(c) for c in CASES if c[0]])
def test_pruned_tiles_get_no_gradient_and_masks_are_single_device(mesh_run,
                                                                  case):
    _, _, res, loops, _ = mesh_run
    whole = loops[case]["overlay"]["segments"]
    for r in res:
        assert r[case]["pruned_grad_max"] == 0.0
        masks = r[case]["masks"]
        assert masks
        for key, m in masks.items():
            si, slot, name = key.split("/")
            np.testing.assert_array_equal(
                m, whole[si][slot]["ffn"]["sasp_masks"][name].numpy())
        assert r[case]["sparsity"] == pytest.approx(0.25, abs=0.02)


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
def test_mesh_checkpoint_resumes_bit_for_bit(mesh_run, ref_model,
                                             quantized):
    """Restored on the mesh, step 3 equals the uninterrupted step 3 bit
    for bit (loss, params, moments) on every rank; the reference's
    manager reads the checkpoint, its params the ranks' gathered ones."""
    jax = pytest.importorskip("jax")
    from repro.train import optimizer as r_opt
    from repro.train.checkpoint import CheckpointManager as RManager
    from repro.train.checkpoint import _flatten_with_names
    _, _, res, _, d = mesh_run
    assert all(r["ckpt"][quantized]["equal"] for r in res)
    params0 = ref_model[1]
    oc = r_opt.AdamWConfig(quantized=quantized)
    like = jax.eval_shape(lambda: {"params": params0,
                                   "opt": r_opt.adamw_init(params0, oc)})
    state, extra = RManager(f"{d}/ckpt_{quantized}").restore(like)
    assert extra == {"step": 2}
    assert int(state["opt"].step) == 2
    got = {n[len("params/"):]: np.asarray(x, np.float32) for n, x in
           _flatten_with_names(state) if n.startswith("params/")}
    want = res[0]["ckpt"][quantized]["saved"]
    assert got.keys() == want.keys()
    for n in want:
        np.testing.assert_array_equal(got[n], want[n])


def test_column_region_grads_equal_the_shard_loop(mesh_run, ref_model):
    """The grad of a replicated input through attention's column
    projections, through the dense FFN and through a partial reduced by
    a reduce-scatter and an all-gather, on each rank, equals the shard
    loop's at the mesh's model size (and the whole layer's within
    1e-5)."""
    _, tp, res, _, _ = mesh_run
    whole = bridge.from_numpy(ref_model[2], device="cpu")
    cfg = port_config()
    layer = lm.layer_params(whole["segments"][0]["slot0"], 0)
    loop = _region_grads(layer, tp_config(cfg, tp))
    one = _region_grads(layer, cfg)
    one["rs_ag"] = loop["rs_ag"]          # a partial per shard
    for r in res:
        assert r["detach"].keys() == loop.keys()
        for name, g in r["detach"].items():
            np.testing.assert_allclose(g, loop[name].numpy(), rtol=0,
                                       atol=1e-6 * float(
                                           loop[name].abs().max()))
            np.testing.assert_allclose(g, one[name].numpy(), rtol=0,
                                       atol=1e-5 * float(
                                           one[name].abs().max()))


def test_remat_recomputes_the_collectives_alike(mesh_run):
    """Remat full and dots on the mesh (forward collectives recomputed in
    backward) give remat none's loss and gradients within 1e-6."""
    _, _, res, _, _ = mesh_run
    for r in res:
        for remat, (dloss, err) in r["remat"].items():
            assert dloss <= 1e-6 and err <= 1e-6, (remat, dloss, err)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def test_launcher_trains_on_a_mesh_and_resumes(tmp_path, capfd):
    d = str(tmp_path / "ckpt")
    common = ["--mesh", "2,2", "--reduce", "--sasp", "0.5", "--device",
              "cpu", "--batch", "4", "--seq", "32", "--ckpt-every", "2",
              "--ckpt-dir", d]
    first = t_launch.main(common + ["--steps", "4"])
    assert [r["step"] for r in first] == [4] * 4
    assert all(r["losses"] == first[0]["losses"] for r in first)
    assert all(np.isfinite(first[0]["losses"]))
    again = t_launch.main(common + ["--steps", "6", "--resume"])
    assert [len(r["losses"]) for r in again] == [2] * 4
    out = capfd.readouterr().out
    assert "resumed from step 4" in out and "SASP masks: 50.0%" in out
    assert sorted(x for x in os.listdir(d) if x.startswith("step_")) == \
        ["step_0000000004", "step_0000000006"]


@pytest.mark.parametrize("argv,match", [
    (["--mesh", "multi", "--device", "cpu"],
     r"\(2, 16, 16\) mesh: it needs 512 ranks \(2 pod x 16 data x 16 model"),
    (["--mesh", "single", "--device", "cpu"], "needs 256 ranks"),
    (["--mesh", "3,1", "--arch", "granite-moe-1b-a400m"],
     "4 experts do not split over 3 data ranks"),
    (["--mesh", "1,3", "--arch", "mamba2-780m"],
     "16 SSM heads .* do not split over 3 model ranks"),
    (["--mesh", "1,3", "--arch", "jamba-1.5-large-398b"],
     "the experts' d_ff 128 does not split over 3 model ranks"),
    (["--mesh", "1,2", "--backend", "nccl", "--device", "cpu"],
     "nccl needs a card per rank"),
    (["--mesh", "3,1", "--batch", "8"], "does not split into 3"),
    (["--mesh", "2,x"], "expects local, single, multi or 'DP,TP'"),
    (["--mesh", "1,16"], "do not split over 16"),
])
def test_launcher_usage_errors(argv, match):
    with pytest.raises(SystemExit, match=match):
        t_launch.main(["--reduce", "--sasp", "0.5"] + argv)


def test_int8_tp_reduction_refused_in_training():
    with pytest.raises(ValueError, match="rs_ag_int8"):
        t_launch.check_mesh_config(dataclasses.replace(
            port_config(), tp_comm="rs_ag_int8"), 1, 2)
