"""MoE, SSM and hybrid families trained on a (data, model) mesh
(``repro_torch.train.train_step.make_mesh_train_step``): spawned gloo
ranks on the CPU, reduced granite-moe (2 layers, d 64, 4 experts top 2),
mamba2 (2 layers, d 64, 8 heads) and jamba (4 layers: SSM, attention,
MoE and dense-FFN slots), vocab 128, at meshes (1,2), (2,1) and (2,2).
With 'data' > 1 a MoE layer's experts are split over 'data' (expert
parallelism, ``moe_ffn_ep``); each expert's d_ff and the SSM heads over
'model'.

* against the reference: the oracle is the mean over the data shards of
  the reference's single-device ``value_and_grad`` of ``loss_fn`` on
  each shard's rows (shard r of micro-batch k: the reference's
  grouping), then its ``adamw_update``, on bridged params (in ``ep``
  mode a shard's capacity and slot positions are the local path's on
  its rows, and the reference's aux is the ``pmean`` of the shards'):
  the loss within 1e-5 relative, the step's gradients (the mean over
  'data', gathered) within 1e-4 of each leaf's largest, the params after
  one step within 1e-3 of each leaf's largest where the clipped gradient
  is at least 100 eps (below it AdamW's first step amplifies a
  gradient's last bits into a visible share of lr), and everywhere
  within 1e-5 of the reference's AdamW step of the mesh's gradient;
* against the port's meshless loop at the same shard counts
  (``make_train_step(data_shards=DP)`` on ``tp_config(cfg, TP, ep=DP)``:
  the data ranks' rows in lock step, each MoE layer over all of them):
  losses of both steps and gradients within 1e-6 (of each leaf's
  largest, or of 1e-3 times the step's largest gradient where that is
  larger: jamba's A_log and dt_bias gradients, 1e-5 beside leaves of
  1e-2, are cancellations that carry the rounding of their far larger
  terms, whose TP partials the mesh sums in another order), the params
  after one step within 1e-4 of each leaf's largest where AdamW's first
  step is well conditioned (as for the reference; the data ranks'
  gradients are summed in another order than the loop's autograd sums
  its groups', and AdamW's m / (sqrt(v) + eps) turns a last bit into a
  visible share of the lr-sized update where |g| is small, as in
  ``tests/test_torch_train_mesh.py``);
* cases: capacity binding (capacity factor 0.25: every shard drops
  tokens), 2 micro-batches, the SASP overlay (25% of the FFN tiles,
  expert stacks included; pruned tiles' gradients exactly 0 on every
  rank, the gathered masks the single-device overlay's), remat full on
  the hybrid stack;
* the autograd all-to-all: the input, router and expert gradients of a
  MoE layer on the EP mesh equal the loop's (``moe_ffn_groups``);
* the SSM's replicated B / C columns of in_xbc / conv_w / conv_b get
  the loop's gradient on every rank;
* a mesh checkpoint (EP-cut expert stacks, ZeRO moments) resumes bit for
  bit and the reference's ``CheckpointManager`` reads it;
* the launcher: ``--mesh 2,2 --reduce --arch granite-moe-1b-a400m`` to a
  checkpoint and ``--resume``, and mamba2 and jamba for two steps.

The module imports no jax at its top: the spawned ranks import it."""
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
from repro_torch.distribution import moe_ep  # noqa: E402
from repro_torch.distribution.context import use_mesh  # noqa: E402
from repro_torch.distribution.sharding import (local_config,  # noqa: E402
                                               tp_config)
from repro_torch.launch import train as t_launch  # noqa: E402
from repro_torch.launch.mesh import init_file_in  # noqa: E402
from repro_torch.launch.mesh import make_mesh, run_ranks  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.train import train_step as t_step  # noqa: E402
from repro_torch.train.checkpoint import (CheckpointManager,  # noqa: E402
                                          gather_whole, named_leaves,
                                          restore_on_mesh, save_on_mesh)
from repro_torch.train.optimizer import (AdamWConfig, adamw_init,  # noqa
                                         reduce_grads, zero_adamw_init)

MESHES = [(1, 2), (2, 1), (2, 2)]
LAYERS = {"granite-moe-1b-a400m": 2, "mamba2-780m": 2,
          "jamba-1.5-large-398b": 4}
# (name, capacity factor, micro-batches, overlay, remat)
CASES = {
    "granite-moe-1b-a400m": [("base", 1.25, 1, False, "none"),
                             ("drop", 0.25, 1, False, "none"),
                             ("mb2", 1.25, 2, False, "none"),
                             ("overlay", 1.25, 1, True, "none")],
    "mamba2-780m": [("base", None, 1, False, "none"),
                    ("mb2", None, 2, False, "none")],
    "jamba-1.5-large-398b": [("overlay-remat", 0.25, 1, True, "full"),
                             ("mb2", 1.25, 2, False, "none")],
}
ALL = [(a, c) for a in CASES for c in CASES[a]]
LR, STEPS, BATCH, SEQ = 1e-3, 2, 4, 16
SASP = dict(enabled=True, block_k=16, block_n=16, sparsity=0.25,
            scope="ffn")


def case_id(arch, case) -> str:
    return f"{arch.split('-')[0]}-{case[0]}"


def port_config(arch, case):
    _, cf, _, ov, remat = case
    cfg = reduced(get_config(arch), layers=LAYERS[arch], d_model=64,
                  vocab=128)
    if cf is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cf))
    if ov:
        cfg = dataclasses.replace(cfg, sasp=SASPConfig(**SASP))
    return dataclasses.replace(cfg, remat=remat)


def batches():
    return [{k: torch.from_numpy(v) for k, v in lm_batch(
        DataConfig(128, SEQ, BATCH), s).items()} for s in range(STEPS)]


def _np(tree):
    return {n: t.detach().float().numpy().copy()
            for n, t in named_leaves(tree)}


def _gathered(tree, specs, mesh):
    """{name: whole leaf} of the rank's slices under ``specs`` ({path:
    spec})."""
    return {n: gather_whole(t, specs[p], mesh).float().numpy().copy()
            for (p, t), (n, _) in zip(iter_leaves(tree), named_leaves(tree))}


def _setup(mesh, whole, arch, case, quantized=False):
    dp, tp = mesh.shape["data"], mesh.shape["model"]
    cfg = port_config(arch, case)
    oc = AdamWConfig(lr=LR, quantized=quantized)
    layout = t_step.mesh_layout(cfg, dp, tp, oc)
    params = t_step.rank_slices(copy.deepcopy(whole), layout, mesh)
    opt = zero_adamw_init(params, layout.zero, oc, mesh)
    lcfg = local_config(tp_config(cfg, tp, ep=dp), tp)
    return cfg, oc, layout, params, opt, lcfg


def _pruned_grad_max(grads, overlay) -> float:
    """The largest |gradient| over the pruned tiles of the rank's masked
    matrices (dense FFNs and expert stacks: (…, K, N))."""
    worst = 0.0
    for si, seg in overlay["segments"].items():
        for slot, node in seg.items():
            for name, m in node["ffn"]["sasp_masks"].items():
                if name == "router":     # ranked, never applied (as the
                    continue             # reference's)
                g = grads["segments"][int(si)][slot]["ffn"][name]["w"]
                *lead, K, N = g.shape
                KB, NB = m.shape[-2:]
                tiles = g.reshape(*lead, KB, K // KB, NB, N // NB).abs(
                    ).amax(dim=(-3, -1))
                if (~m).any():
                    worst = max(worst, float(tiles[~m].max()))
    return worst


def _run_case(mesh, whole, arch, case):
    """One case on this rank: the step's gathered mean gradient, the
    pruned tiles' largest local gradient and the gathered masks, then
    STEPS mesh steps (losses, aux, the gathered params after one)."""
    cfg, oc, layout, params, opt, lcfg = _setup(mesh, whole, arch, case)
    dp, K = mesh.shape["data"], case[2]
    out, ov = {}, None
    if case[3]:
        ov, out["sparsity"] = mesh_overlay(params, cfg.sasp, mesh,
                                           layout.params)
        out["masks"] = {
            f"{si}/{slot}/{name}": gather_whole(
                m.to(torch.uint8), layout.params[
                    ("segments", int(si), slot, "ffn", name, "w")],
                mesh).bool().numpy()
            for si, seg in ov["segments"].items()
            for slot, node in seg.items()
            for name, m in node["ffn"]["sasp_masks"].items()}
    bs = batches()
    with use_mesh(mesh):
        _, _, g = t_step._grads(lcfg, params, t_step._rows(
            bs[0], mesh.data_rank, dp, K), ov, K, None)
        if ov is not None:
            out["pruned_grad_max"] = _pruned_grad_max(g, ov)
        gs = reduce_grads(g, layout.zero, mesh)
    out["grads"] = _gathered(map_paths(gs, params), layout.zero, mesh)
    step = t_step.make_mesh_train_step(lcfg, oc, mesh, layout, overlay=ov,
                                       n_microbatches=K)
    out["losses"], out["aux"] = [], []
    for i, b in enumerate(bs):
        params, opt, m = step(params, opt, b)
        out["losses"].append(float(m["loss"]))
        out["aux"].append(float(m["aux"]))
        if i == 0:
            out["params1"] = _gathered(params, layout.params, mesh)
    return out


def map_paths(flat, like):
    """{path: tensor} -> ``like``'s structure."""
    from repro_torch.core.pruning import map_leaves
    return map_leaves(lambda path, _: flat[path], like)


def _ckpt_case(mesh, whole, store_dir):
    """granite-moe with the overlay and int8 moments: step 1, a
    checkpoint, step 2 uninterrupted; restored into a fresh state, step
    2 again."""
    arch, case = "granite-moe-1b-a400m", CASES["granite-moe-1b-a400m"][3]
    cfg, oc, layout, params, opt, lcfg = _setup(mesh, whole, arch, case,
                                                quantized=True)
    specs = t_step.state_specs(params, layout)
    ov, _ = mesh_overlay(params, cfg.sasp, mesh, layout.params)
    step = t_step.make_mesh_train_step(lcfg, oc, mesh, layout, overlay=ov)
    bs = batches()
    mgr = CheckpointManager(store_dir)
    params, opt, _ = step(params, opt, bs[0])
    save_on_mesh(mgr, 1, {"params": params, "opt": opt}, specs, mesh,
                 extra={"step": 1})
    saved = _gathered(params, layout.params, mesh)
    params, opt, m = step(params, opt, bs[1])
    want = (float(m["loss"]), _np(params), _np(opt))
    _, _, _, p2, o2, _ = _setup(mesh, whole, arch, case, quantized=True)
    with mgr.reader() as reader:
        state = restore_on_mesh(reader, {"params": p2, "opt": o2}, specs,
                                mesh)
    p2, o2, m2 = step(state["params"], state["opt"], bs[1])
    got = (float(m2["loss"]), _np(p2), _np(o2))
    equal = got[0] == want[0] and all(
        a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
        for a, b in zip(got[1:], want[1:]))
    return dict(saved=saved, equal=equal)


def _a2a_case(mesh, whole):
    """d/dx, d/drouter and d/dexperts of sum(y * r) + 3 aux through layer
    0's MoE on this rank (the EP path: both all-to-alls under
    autograd)."""
    arch, case = "granite-moe-1b-a400m", CASES["granite-moe-1b-a400m"][1]
    cfg, _, layout, params, _, lcfg = _setup(mesh, whole, arch, case)
    p = {k: v for k, v in lm.layer_params(
        params["segments"][0]["slot0"], 0)["ffn"].items()}
    x0, r = _a2a_inputs()
    d, dp = mesh.data_rank, mesh.shape["data"]
    n = x0.shape[0] // dp
    with torch.enable_grad(), use_mesh(mesh):
        x = x0[d * n:(d + 1) * n].clone().requires_grad_(True)
        live = {k: v["w"].detach().requires_grad_(True)
                for k, v in p.items()}
        y, aux = moe_ep.moe_dispatch({k: {"w": v} for k, v in live.items()},
                                     lcfg, x)
        loss = (y * r[d * n:(d + 1) * n]).sum() + 3.0 * aux
        gx, *gw = torch.autograd.grad(loss, [x] + list(live.values()))
    out = {"x": gx.numpy(), "aux": float(aux.detach())}
    for (k, _), g in zip(live.items(), gw):
        spec = layout.params[("segments", 0, "slot0", "ffn", k, "w")][1:]
        if k == "router" and dp > 1:   # every data rank's share, summed
            g = mesh.allreduce(g, "data")
        out[k] = gather_whole(g, spec, mesh).numpy()
    return out


def _a2a_inputs():
    gen = torch.Generator().manual_seed(5)
    return (torch.randn((4, 8, 64), generator=gen),
            torch.randn((4, 8, 64), generator=gen))


def mesh_rank(rank: int, dp: int, tp: int, init_file: str, params_np,
              store_dir: str) -> dict:
    torch.set_num_threads(1)
    mesh = make_mesh(dp, tp, rank=rank, init_file=init_file,
                     backend="gloo", device="cpu")
    out = {}
    for arch in CASES:
        whole = bridge.from_numpy(params_np[arch], device="cpu")
        for case in CASES[arch]:
            out[arch, case] = _run_case(mesh, whole, arch, case)
    whole = bridge.from_numpy(params_np["granite-moe-1b-a400m"],
                              device="cpu")
    out["ckpt"] = _ckpt_case(mesh, whole, f"{store_dir}/ckpt")
    out["a2a"] = _a2a_case(mesh, whole)
    return out


# ---------------------------------------------------------------------------
# oracles: the reference's single-device step and the port's meshless loop
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref_models():
    """{arch: (reference cfg, its params, their numpy copy)} (the
    reference's reduced configs: the cases' factors and overlay are
    applied per case)."""
    jax = pytest.importorskip("jax")
    from repro.configs import get_config as r_get_config
    from repro.configs import reduced as r_reduced
    from repro.models import lm as r_lm
    out = {}
    for arch in CASES:
        cfg = r_reduced(r_get_config(arch), layers=LAYERS[arch],
                        d_model=64, vocab=128)
        params = r_lm.init_params(jax.random.PRNGKey(0), cfg)
        out[arch] = (cfg, params, jax.tree.map(np.asarray, params))
    return out


def _ref_config(rcfg, case):
    from repro.configs import SASPConfig as RSASP
    _, cf, _, ov, remat = case
    if cf is not None:
        rcfg = dataclasses.replace(rcfg, moe=dataclasses.replace(
            rcfg.moe, capacity_factor=cf))
    if ov:
        rcfg = dataclasses.replace(rcfg, sasp=RSASP(**SASP))
    return dataclasses.replace(rcfg, remat=remat)


def reference_case(ref_models, arch, case, dp):
    """The mean over the data shards (and micro-batches) of the
    reference's single-device value_and_grad on each shard's rows, then
    its adamw_update: (loss, gradients, params after one step)."""
    import jax
    import jax.numpy as jnp
    from repro.core import sasp as r_sasp
    from repro.models import lm as r_lm
    rcfg0, params0, _ = ref_models[arch]
    rcfg = _ref_config(rcfg0, case)
    K = case[2]
    ov = r_sasp.build_sasp_overlay(params0, rcfg.sasp)[0] if case[3] \
        else None
    b = batches()[0]

    def loss_of(p, mb):
        pv = r_sasp.merge_overlay(p, ov) if ov is not None else p
        return r_lm.loss_fn(pv, rcfg, mb)[0]
    vg = jax.jit(jax.value_and_grad(loss_of))
    losses, grads = [], None
    for d in range(dp):
        rows = t_step._rows(b, d, dp, K)
        for j in range(K):
            mb = {k: jnp.asarray(v.numpy().reshape(
                (K, -1) + tuple(v.shape[1:]))[j]) for k, v in rows.items()}
            loss, g = vg(params0, mb)
            losses.append(float(loss))
            grads = g if grads is None else jax.tree.map(jnp.add, grads, g)
    n = dp * K
    grads = jax.tree.map(lambda g: g / n, grads)
    return dict(loss=sum(losses) / n, grads=_np_names(grads),
                params1=_ref_adamw(params0, grads))


def _np_names(tree):
    from repro.train.checkpoint import _flatten_with_names
    return {nm: np.asarray(x, np.float32)
            for nm, x in _flatten_with_names(tree)}


def _ref_adamw(params0, grads):
    """The reference's one AdamW step (fp32 moments) of ``grads`` (its
    tree, or {name: array} in its leaf order) from ``params0``."""
    import jax
    from repro.train import optimizer as r_opt
    if isinstance(grads, dict) and "segments" not in grads:
        leaves = [grads[nm] for nm in _np_names(params0)]
        grads = jax.tree.unflatten(jax.tree.structure(params0), leaves)
    oc = r_opt.AdamWConfig(lr=LR)
    p1, _ = r_opt.adamw_update(grads, r_opt.adamw_init(params0, oc),
                               params0, oc)
    return _np_names(p1)


def loop_case(params_np, arch, case, dp, tp):
    """The port's meshless loop at (dp, tp)."""
    cfg = port_config(arch, case)
    K = case[2]
    whole = bridge.from_numpy(params_np, device="cpu")
    tcfg = tp_config(cfg, tp, ep=dp)
    ov = build_sasp_overlay(whole, cfg.sasp)[0] if case[3] else None
    oc = AdamWConfig(lr=LR)
    bs = batches()
    if tcfg.ep_shards > 1:
        grads = t_step._grads_groups(tcfg, whole, bs[0], ov, K, None, dp)[2]
        grads = _np(grads)
    else:
        parts = [_np(t_step._grads(tcfg, whole, t_step._rows(
            bs[0], d, dp, K), ov, K, None)[2]) for d in range(dp)]
        grads = {n: sum(p[n] for p in parts) / dp for n in parts[0]}
    step = t_step.make_train_step(tcfg, oc, overlay=ov, n_microbatches=K,
                                  data_shards=dp)
    opt = adamw_init(whole, oc)
    out = {"losses": [], "aux": [], "grads": grads, "overlay": ov}
    for i, b in enumerate(bs):
        whole, opt, m = step(whole, opt, b)
        out["losses"].append(float(m["loss"]))
        out["aux"].append(float(m["aux"]))
        if i == 0:
            out["params1"] = _np(whole)
    return out


def a2a_loop(params_np, dp, tp):
    """``_a2a_case``'s gradients through the meshless loop: every data
    rank's rows in one ``moe_ffn_groups`` call, each group's own aux
    weighted as on its rank."""
    arch, case = "granite-moe-1b-a400m", CASES["granite-moe-1b-a400m"][1]
    cfg = tp_config(port_config(arch, case), tp, ep=dp)
    whole = bridge.from_numpy(params_np, device="cpu")
    p = lm.layer_params(whole["segments"][0]["slot0"], 0)["ffn"]
    x0, r = _a2a_inputs()
    with torch.enable_grad():
        x = x0.clone().requires_grad_(True)
        live = {k: v["w"].detach().requires_grad_(True)
                for k, v in p.items()}
        pl = {k: {"w": v} for k, v in live.items()}
        if dp > 1:
            ys, aux = moe_ep.moe_ffn_groups(pl, cfg, list(
                torch.chunk(x, dp, dim=0)))
            y = torch.cat(ys, dim=0)
        else:
            y, aux = moe_ep.moe_dispatch(pl, cfg, x)
        loss = (y * r).sum() + 3.0 * dp * aux
        gx, *gw = torch.autograd.grad(loss, [x] + list(live.values()))
    out = {"x": gx.numpy(), "aux": float(aux.detach())}
    out.update({k: g.numpy() for k, g in zip(live, gw)})
    return out


@pytest.fixture(scope="module", params=MESHES,
                ids=[f"mesh{d}x{t}" for d, t in MESHES])
def mesh_run(request, ref_models, tmp_path_factory):
    dp, tp = request.param
    d = str(tmp_path_factory.mktemp(f"fmesh{dp}{tp}"))
    params_np = {a: m[2] for a, m in ref_models.items()}
    res = run_ranks(mesh_rank, dp * tp,
                    (dp, tp, init_file_in(d), params_np, d), timeout=600)
    loops = {(a, c): loop_case(params_np[a], a, c, dp, tp) for a, c in ALL}
    return dp, tp, res, loops, d


def _well(got: dict, want: dict, grads: dict):
    """(got, want) with each element zeroed where AdamW's first step is
    ill conditioned: it moves an element by lr g' / (|g'| + eps), g' the
    clipped gradient, so where |g'| < 100 eps a gradient's last bits move
    it by a visible share of lr (the SSM's zero-init conv_b under
    clipping)."""
    gnorm = np.sqrt(sum(float(np.sum(np.square(g.astype(np.float64))))
                        for g in grads.values()))
    clip = min(1.0, 1.0 / gnorm)
    well = {n: np.abs(g) * clip >= 100 * 1e-8 for n, g in grads.items()}
    return ({n: np.where(well[n], p, 0) for n, p in got.items()},
            {n: np.where(well[n], p, 0) for n, p in want.items()})


def _close(got: dict, want: dict, tol: float, what: str,
           floor: float = 0.0):
    """Every leaf within ``tol`` of that leaf's largest magnitude (or of
    ``floor`` times the largest over every leaf, where that is larger)."""
    assert got.keys() == want.keys(), what
    top = max(float(np.abs(w).max()) for w in want.values() if w.size)
    for n in want:
        if not want[n].size:          # mamba2's empty d_ff = 0 FFN
            continue
        scale = max(float(np.abs(want[n]).max()), floor * top, 1e-30)
        err = float(np.abs(got[n] - want[n]).max())
        assert err <= tol * scale, (what, n, err, scale)


def test_capacity_formulas_agree_on_the_cases():
    """The EP path's per-shard capacity (the reference's integer form)
    equals the local path's float form on a shard's tokens for every
    factor the cases use, and 0.25 binds: every shard drops slots."""
    for arch, case in ALL:
        cfg = port_config(arch, case)
        if cfg.moe is None:
            continue
        for dp in (1, 2):
            for K in (1, 2):
                n = BATCH // (dp * K) * SEQ
                C = moe_ep.ep_capacity(cfg, n)
                assert C == moe_ep.local_capacity(cfg, n)
                if case[1] == 0.25:
                    assert cfg.moe.num_experts * C < n * cfg.moe.top_k


@pytest.fixture(scope="module")
def reference(ref_models):
    """``reference_case`` memoised by (arch, case, DP): meshes of one DP
    share the oracle."""
    memo = {}

    def get(arch, case, dp):
        if (arch, case, dp) not in memo:
            memo[arch, case, dp] = reference_case(ref_models, arch, case,
                                                  dp)
        return memo[arch, case, dp]
    return get


@pytest.mark.parametrize("arch,case", ALL,
                         ids=[case_id(a, c) for a, c in ALL])
def test_family_mesh_step_matches_the_reference(mesh_run, ref_models,
                                                reference, arch, case):
    dp, _, res, _, _ = mesh_run
    want = reference(arch, case, dp)
    got = res[0][arch, case]
    np.testing.assert_allclose(got["losses"][0], want["loss"], rtol=1e-5)
    _close(got["grads"], want["grads"], 1e-4, "grads")
    for g in got["grads"].values():
        assert np.isfinite(g).all()
    # the oracle's params where AdamW's first step is well conditioned
    # (``_well``), and everywhere the reference's AdamW of the mesh's own
    # gradient (within 1e-5)
    _close(*_well(got["params1"], want["params1"], want["grads"]), 1e-3,
           "params after 1 step")
    _close(got["params1"], _ref_adamw(ref_models[arch][1], got["grads"]),
           1e-5, "params after 1 step from the mesh's gradient")


@pytest.mark.parametrize("arch,case", ALL,
                         ids=[case_id(a, c) for a, c in ALL])
def test_family_mesh_step_equals_its_meshless_loop(mesh_run, arch, case):
    _, _, res, loops, _ = mesh_run
    want = loops[arch, case]
    for r in res:                          # every rank reports the same
        got = r[arch, case]
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   rtol=1e-6)
        np.testing.assert_allclose(got["aux"], want["aux"], rtol=1e-6,
                                   atol=1e-9)
        _close(got["grads"], want["grads"], 1e-6, "grads", floor=1e-3)
        _close(*_well(got["params1"], want["params1"], want["grads"]), 1e-4,
               "params after 1 step")


OVERLAID = [(a, c) for a, c in ALL if c[3]]


@pytest.mark.parametrize("arch,case", OVERLAID,
                         ids=[case_id(a, c) for a, c in OVERLAID])
def test_pruned_expert_tiles_get_no_gradient_and_masks_are_single_device(
        mesh_run, arch, case):
    _, _, res, loops, _ = mesh_run
    whole = loops[arch, case]["overlay"]["segments"]
    for r in res:
        got = r[arch, case]
        assert got["pruned_grad_max"] == 0.0
        masks = got["masks"]
        assert any(m.ndim == 4 for m in masks.values())   # expert stacks
        for key, m in masks.items():
            si, slot, name = key.split("/")
            np.testing.assert_array_equal(
                m, whole[si][slot]["ffn"]["sasp_masks"][name].numpy())
        assert got["sparsity"] == pytest.approx(0.25, abs=0.02)


def test_all_to_all_backward_equals_the_loop(mesh_run, ref_models):
    """The MoE layer's input gradient on each rank's rows, the router's
    gradient summed over 'data' and every expert's gradient, gathered,
    equal the meshless loop's (EP over 'data' where DP > 1)."""
    dp, tp, res, _, _ = mesh_run
    want = a2a_loop(ref_models["granite-moe-1b-a400m"][2], dp, tp)
    n = want["x"].shape[0] // dp
    for rank, r in enumerate(res):
        got = dict(r["a2a"])
        assert got.pop("aux") == pytest.approx(want["aux"], rel=1e-6)
        d = rank // tp                 # the rank's rows of the input
        got["x"] = np.concatenate([want["x"][:d * n], got["x"],
                                   want["x"][(d + 1) * n:]])
        _close(got, {k: v for k, v in want.items() if k != "aux"}, 1e-6,
               f"rank {rank}")


def test_ssm_bc_columns_get_the_loops_gradient(mesh_run):
    """in_xbc / conv_w / conv_b's B and C columns, replicated on every
    model rank and consumed by each rank's own heads, get the loop's
    whole gradient (the sum over the ranks' heads), as do the x
    columns."""
    _, _, res, loops, _ = mesh_run
    for arch in ("mamba2-780m", "jamba-1.5-large-398b"):
        case = CASES[arch][-1]
        cfg = port_config(arch, case)
        di = cfg.ssm.d_inner(cfg.d_model)
        want = loops[arch, case]["grads"]
        names = [n for n in want if n.endswith(("in_xbc/w", "conv_w",
                                                "conv_b"))]
        assert names
        for r in res:
            for n in names:
                g, w = r[arch, case]["grads"][n], want[n]
                scale = float(np.abs(w[..., di:]).max())
                assert scale > 0
                assert float(np.abs(g[..., di:] - w[..., di:]).max()) <= \
                    1e-6 * scale, n
                assert float(np.abs(g - w).max()) <= 1e-6 * float(
                    np.abs(w).max()), n


def test_family_mesh_checkpoint_resumes_bit_for_bit(mesh_run, ref_models):
    """Restored on the mesh (EP-cut expert stacks, int8 moments), step 2
    equals the uninterrupted step 2 bit for bit on every rank; the
    reference's manager reads the checkpoint, its params the ranks'
    gathered ones."""
    jax = pytest.importorskip("jax")
    from repro.train import optimizer as r_opt
    from repro.train.checkpoint import CheckpointManager as RManager
    from repro.train.checkpoint import _flatten_with_names
    _, _, res, _, d = mesh_run
    assert all(r["ckpt"]["equal"] for r in res)
    params0 = ref_models["granite-moe-1b-a400m"][1]
    oc = r_opt.AdamWConfig(quantized=True)
    like = jax.eval_shape(lambda: {"params": params0,
                                   "opt": r_opt.adamw_init(params0, oc)})
    state, extra = RManager(f"{d}/ckpt").restore(like)
    assert extra == {"step": 1}
    got = {n[len("params/"):]: np.asarray(x, np.float32) for n, x in
           _flatten_with_names(state) if n.startswith("params/")}
    want = res[0]["ckpt"]["saved"]
    assert got.keys() == want.keys()
    for n in want:
        np.testing.assert_array_equal(got[n], want[n])


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def test_launcher_trains_a_moe_on_a_mesh_and_resumes(tmp_path, capfd):
    d = str(tmp_path / "ckpt")
    common = ["--mesh", "2,2", "--reduce", "--arch", "granite-moe-1b-a400m",
              "--device", "cpu", "--batch", "4", "--seq", "32",
              "--ckpt-every", "2", "--ckpt-dir", d]
    first = t_launch.main(common + ["--steps", "4"])
    assert [r["step"] for r in first] == [4] * 4
    assert all(r["losses"] == first[0]["losses"] for r in first)
    assert all(np.isfinite(first[0]["losses"]))
    again = t_launch.main(common + ["--steps", "6", "--resume"])
    assert [len(r["losses"]) for r in again] == [2] * 4
    assert "resumed from step 4" in capfd.readouterr().out
    assert sorted(x for x in os.listdir(d) if x.startswith("step_")) == \
        ["step_0000000004", "step_0000000006"]


@pytest.mark.parametrize("arch", ["mamba2-780m", "jamba-1.5-large-398b"])
def test_launcher_trains_ssm_and_hybrid_on_a_mesh(tmp_path, arch):
    out = t_launch.main(["--mesh", "2,2", "--reduce", "--arch", arch,
                         "--device", "cpu", "--batch", "4", "--seq", "32",
                         "--steps", "2", "--ckpt-dir",
                         str(tmp_path / "ckpt")])
    assert all(r["losses"] == out[0]["losses"] for r in out)
    assert all(np.isfinite(out[0]["losses"] + out[0]["grad_norms"]))
