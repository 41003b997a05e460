"""Training on a (pod, data, model) mesh (``repro_torch.train.train_step.
make_mesh_train_step`` with ``launch.mesh.make_mesh(pod=)``): spawned
gloo ranks on the CPU.

* the reduced qwen3 (2 layers, d 128, vocab 512, SASP 0.25 of the FFN's
  16x16 tiles) at meshes (2,2,1), (2,1,2) and (2,2,2): against the
  reference's single-device ``make_train_step`` on the same global batch
  (loss within 1e-5 relative, the step's gradients, gathered, within
  1e-4 of each leaf's largest, the params after one step within 1e-3:
  AdamW's first step turns a gradient's last bits into a visible share
  of lr where |g| is small, as in ``tests/test_torch_train_mesh.py``)
  and against the port's lock-step loop over the pods x data ranks
  (``make_train_step(data_shards=P*D)``: losses 1e-6, gradients 1e-6,
  params after one step 1e-4); int8 moments with 2 micro-batches on
  (2,2,2), against the loop (its params after one step; later losses
  part at a .5 tie of a moment, as in ``tests/test_torch_train_mesh.py``);
* every pod's params and moments bit for bit equal after every step, the
  'pod' rows of ``Mesh.comms`` the bytes of the ZeRO slices (each
  all-reduced over 'pod'), and the step's record equal to a dry rank's
  (``launch.dryrun.trace_step(pod=)``);
* a two-axis mesh gives the same bits as the reduction without pods
  (over 'data' alone) and records no 'pod' row;
* a reduced MoE (granite, 4 experts top 2) on (2,2,1), experts in EP
  over each pod's 'data' ranks: the aux equals the mean over the four
  DP shards of each shard's single-device aux (the reference's), the
  loss the mean of the shards' losses, the loss and aux the loop's, and
  the expert gradients equal on both pods;
* ``compressed_psum`` over 'pod' on a (2, 4, 1) mesh against the
  reference's under ``jax.vmap(axis_name="pod")``;
* the launcher: ``--mesh 2,2,1`` to a checkpoint and ``--resume``;
* a multi-pod dry-run cell: ``2x16x16``, 512 chips, and rank 0 holds the
  params and moments of the single-pod rank.

The module imports no jax at its top: the spawned ranks import it."""
import copy
import dataclasses
import os
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import bridge  # noqa: E402
from repro_torch.configs import (SASPConfig, ShapeConfig,  # noqa: E402
                                 get_config, reduced)
from repro_torch.core.pruning import iter_leaves  # noqa: E402
from repro_torch.core.sasp import build_sasp_overlay  # noqa: E402
from repro_torch.core.sasp import mesh_overlay  # noqa: E402
from repro_torch.data.pipeline import DataConfig, lm_batch  # noqa: E402
from repro_torch.distribution.context import use_mesh  # noqa: E402
from repro_torch.distribution.sharding import (local_config,  # noqa: E402
                                               local_params, tp_config)
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import train as t_launch  # noqa: E402
from repro_torch.launch.mesh import init_file_in  # noqa: E402
from repro_torch.launch.mesh import make_mesh, run_ranks  # noqa: E402
from repro_torch.train import optimizer as t_opt  # noqa: E402
from repro_torch.train import train_step as t_step  # noqa: E402
from repro_torch.train.checkpoint import gather_whole  # noqa: E402
from repro_torch.train.checkpoint import named_leaves  # noqa: E402
from repro_torch.train.grad_compress import compressed_psum  # noqa: E402
from repro_torch.train.optimizer import (AdamWConfig, adamw_init,  # noqa
                                         reduce_grads, zero_adamw_init)

MESHES = [(2, 2, 1), (2, 1, 2), (2, 2, 2)]
# (name, int8 moments, micro-batches) by mesh
CASES = {(2, 2, 1): [("fp32", False, 1)], (2, 1, 2): [("fp32", False, 1)],
         (2, 2, 2): [("fp32", False, 1), ("int8-mb2", True, 2)]}
LR, STEPS, BATCH, SEQ = 1e-3, 2, 8, 16
SASP = dict(enabled=True, block_k=16, block_n=16, sparsity=0.25,
            scope="ffn")
MOE = "granite-moe-1b-a400m"


def port_config():
    return dataclasses.replace(
        reduced(get_config("qwen3-32b"), layers=2, d_model=128, vocab=512),
        sasp=SASPConfig(**SASP))


def moe_config():
    return reduced(get_config(MOE), layers=2, d_model=64, vocab=128)


def batches(vocab):
    return [{k: torch.from_numpy(v) for k, v in lm_batch(
        DataConfig(vocab, SEQ, BATCH), s).items()} for s in range(STEPS)]


def _np(tree):
    return {n: t.detach().float().numpy().copy()
            for n, t in named_leaves(tree)}


def _gathered(tree, specs, mesh):
    """{name: whole leaf} of the rank's slices under ``specs`` ({path:
    spec}), gathered inside its pod."""
    return {n: gather_whole(t, specs[p], mesh).float().numpy().copy()
            for (p, t), (n, _) in zip(iter_leaves(tree), named_leaves(tree))}


def _as_tree(flat, like):
    from repro_torch.core.pruning import map_leaves
    return map_leaves(lambda path, _: flat[path], like)


def _zero_bytes(params, layout, mesh) -> int:
    """Bytes of the rank's fp32 ZeRO gradient slices (each all-reduced
    over 'pod' once a step) and of its EP-cut expert stacks."""
    n = 0
    for path, p in iter_leaves(params):
        z = t_opt._zero_dim(layout.zero, path)
        if z is not None or t_opt._ep(layout.zero, path):
            n += t_opt.local_slice(p, z, mesh).numel() * 4
    return n


def _qwen_case(mesh, whole, case):
    """Step 1's gathered mean gradient, STEPS mesh steps (losses, the
    gathered params after one, the step's record and the rank's own
    params and moments after each step), the expected 'pod' bytes."""
    _, q, K = case
    P, D, T = mesh.pods, mesh.shape["data"], mesh.shape["model"]
    cfg = port_config()
    oc = AdamWConfig(lr=LR, quantized=q)
    layout = t_step.mesh_layout(cfg, D, T, oc, pod=P)
    params = local_params(copy.deepcopy(whole), tp_config(cfg, T), T,
                          mesh.model_rank)
    opt = zero_adamw_init(params, layout.zero, oc, mesh)
    lcfg = local_config(tp_config(cfg, T), T)
    ov, _ = mesh_overlay(params, cfg.sasp, mesh, layout.params)
    bs = batches(cfg.vocab_size)
    with use_mesh(mesh):
        _, _, g = t_step._grads(lcfg, params, t_step._rows(
            bs[0], mesh.dp_rank, mesh.dp_total, K), ov, K, None)
        gs = reduce_grads(g, layout.zero, mesh)
    out = {"grads": _gathered(_as_tree(gs, params), layout.zero, mesh),
           "pod_bytes": _zero_bytes(params, layout, mesh), "losses": [],
           "state": []}
    step = t_step.make_mesh_train_step(lcfg, oc, mesh, layout, overlay=ov,
                                       n_microbatches=K)
    for i, b in enumerate(bs):
        mesh.reset_record()
        params, opt, m = step(params, opt, b)
        out["losses"].append(float(m["loss"]))
        out["state"].append((_np(params), _np(opt)))
        if i == 0:
            out["record"] = mesh.record()
            out["params1"] = _gathered(params, layout.params, mesh)
    return out


def _moe_case(mesh, whole):
    """granite on the pod mesh: step 1's gathered mean gradient, the
    losses and aux of STEPS steps, the rank's expert gradients."""
    P, D, T = mesh.pods, mesh.shape["data"], mesh.shape["model"]
    cfg = moe_config()
    oc = AdamWConfig(lr=LR)
    layout = t_step.mesh_layout(cfg, D, T, oc, pod=P)
    params = t_step.rank_slices(copy.deepcopy(whole), layout, mesh)
    opt = zero_adamw_init(params, layout.zero, oc, mesh)
    lcfg = local_config(tp_config(cfg, T, ep=D), T)
    bs = batches(cfg.vocab_size)
    with use_mesh(mesh):
        _, _, g = t_step._grads(lcfg, params, t_step._rows(
            bs[0], mesh.dp_rank, mesh.dp_total), None, 1, None)
        gs = reduce_grads(g, layout.zero, mesh)
    out = {"grads": _gathered(_as_tree(gs, params), layout.zero, mesh),
           "experts": {path: x.numpy().copy() for path, x in gs.items()
                       if path in layout.zero.ep},
           "losses": [], "aux": []}
    step = t_step.make_mesh_train_step(lcfg, oc, mesh, layout)
    for i, b in enumerate(bs):
        mesh.reset_record()
        params, opt, m = step(params, opt, b)
        if i == 0:
            out["record"] = mesh.record()
        out["losses"].append(float(m["loss"]))
        out["aux"].append(float(m["aux"]))
    out["state"] = (_np(params), _np(opt))
    return out


def _load(path: str) -> dict:
    """The reference's params ({name: numpy tree}), from the file the
    parent wrote: passed by name, a spawned process starts without
    waiting for the parent to pipe it the weights."""
    with open(path, "rb") as f:
        return pickle.load(f)


def pod_rank(rank: int, init_file: str, shape, params_file: str) -> dict:
    torch.set_num_threads(1)
    P, D, T = shape
    mesh = make_mesh(D, T, pod=P, rank=rank, init_file=init_file,
                     backend="gloo", device="cpu")
    out = dict(pod=mesh.pod_rank, data=mesh.data_rank, model=mesh.model_rank)
    nps = _load(params_file)
    whole = bridge.from_numpy(nps["qwen"], device="cpu")
    for case in CASES[shape]:
        out[case] = _qwen_case(mesh, whole, case)
    if shape == (2, 2, 1):
        out["moe"] = _moe_case(mesh, bridge.from_numpy(nps["moe"],
                                                       device="cpu"))
    return out


# ---------------------------------------------------------------------------
# oracles: the reference's single-device step and the port's meshless loop
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref_models():
    """{"qwen": (cfg, params, numpy copy), "moe": ...} of the reference."""
    jax = pytest.importorskip("jax")
    from repro.configs import SASPConfig as RSASP
    from repro.configs import get_config as r_get_config
    from repro.configs import reduced as r_reduced
    from repro.models import lm as r_lm
    qcfg = dataclasses.replace(
        r_reduced(r_get_config("qwen3-32b"), layers=2, d_model=128,
                  vocab=512), sasp=RSASP(**SASP))
    mcfg = r_reduced(r_get_config(MOE), layers=2, d_model=64, vocab=128)
    out = {}
    for name, cfg in (("qwen", qcfg), ("moe", mcfg)):
        params = r_lm.init_params(jax.random.PRNGKey(0), cfg)
        out[name] = (cfg, params, jax.tree.map(np.asarray, params))
    return out


def _names(tree):
    from repro.train.checkpoint import _flatten_with_names
    return {n: np.asarray(x, np.float32) for n, x in
            _flatten_with_names(tree)}


@pytest.fixture(scope="module")
def params_file(ref_models, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("podparams") / "params.pkl")
    with open(path, "wb") as f:
        pickle.dump({k: m[2] for k, m in ref_models.items()}, f)
    return path


@pytest.fixture(scope="module")
def reference(ref_models):
    """The reference's jitted single-device step (fp32 moments, one
    micro-batch) on the global batch: losses, step 1's gradients, the
    params after one step."""
    import jax
    import jax.numpy as jnp
    from repro.core import sasp as r_sasp
    from repro.models import lm as r_lm
    from repro.train import optimizer as r_opt
    from repro.train.train_step import make_train_step
    cfg, params0, _ = ref_models["qwen"]
    ov, _ = r_sasp.build_sasp_overlay(params0, cfg.sasp)
    rb = [{k: jnp.asarray(v.numpy()) for k, v in b.items()}
          for b in batches(cfg.vocab_size)]
    grads = _names(jax.grad(lambda p: r_lm.loss_fn(
        r_sasp.merge_overlay(p, ov), cfg, rb[0])[0])(params0))
    oc = r_opt.AdamWConfig(lr=LR)
    step = jax.jit(make_train_step(cfg, oc, overlay=ov))
    p, s = params0, r_opt.adamw_init(params0, oc)
    out = {"losses": [], "grads": grads}
    for i, b in enumerate(rb):
        p, s, m = step(p, s, b)
        out["losses"].append(float(m["loss"]))
        if i == 0:
            out["params1"] = _names(p)
    return out


def loop_case(params_np, shape, case):
    """The port's meshless loop at a mesh ``shape``: the TP shard loop,
    every DP rank's rows (pods x data ranks) in turn."""
    _, q, K = case
    P, D, T = shape
    cfg = port_config()
    whole = bridge.from_numpy(params_np, device="cpu")
    tcfg = tp_config(cfg, T)
    ov = build_sasp_overlay(whole, cfg.sasp)[0]
    oc = AdamWConfig(lr=LR, quantized=q)
    bs = batches(cfg.vocab_size)
    n = P * D
    parts = [_np(t_step._grads(tcfg, whole, t_step._rows(bs[0], d, n, K),
                               ov, K, None)[2]) for d in range(n)]
    out = {"grads": {k: sum(p[k] for p in parts) / n for k in parts[0]},
           "losses": []}
    step = t_step.make_train_step(tcfg, oc, overlay=ov, n_microbatches=K,
                                  data_shards=n)
    opt = adamw_init(whole, oc)
    for i, b in enumerate(bs):
        whole, opt, m = step(whole, opt, b)
        out["losses"].append(float(m["loss"]))
        if i == 0:
            out["params1"] = _np(whole)
    return out


@pytest.fixture(scope="module")
def launched(params_file, tmp_path_factory):
    """Every spawned mesh of the module, two at a time (each a
    ``run_ranks`` on a thread, so that the processes overlap their
    start-up and the oracles run meanwhile, with at most 12 processes of
    one thread each at once): the pod meshes, the (2, 4, 1) mesh of
    ``compressed_psum`` and the two-axis (2, 1). {key: a future of its
    ranks' results}."""
    from concurrent.futures import ThreadPoolExecutor
    jobs = {shape: (pod_rank, int(np.prod(shape)), (shape, params_file))
            for shape in sorted(MESHES, key=lambda s: -int(np.prod(s)))}
    jobs["psum"] = (psum_rank, 8, ())
    jobs["two-axis"] = (two_axis_rank, 2, (params_file,))
    dirs = {key: str(tmp_path_factory.mktemp("spawn")) for key in jobs}

    def run(key):
        fn, world, args = jobs[key]
        return run_ranks(fn, world, (init_file_in(dirs[key]),) + args,
                         timeout=300)
    pool = ThreadPoolExecutor(2)
    yield {key: pool.submit(run, key) for key in jobs}
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def spawned(launched, reference):
    """``launched``'s results (the reference's oracle computed while the
    ranks run)."""
    return {key: f.result() for key, f in launched.items()}


@pytest.fixture(scope="module", params=MESHES,
                ids=["mesh" + "x".join(map(str, s)) for s in MESHES])
def mesh_run(request, ref_models, launched, spawned):
    shape = request.param
    loops = {c: loop_case(ref_models["qwen"][2], shape, c)
             for c in CASES[shape]}
    return shape, spawned[shape], loops


def _close(got: dict, want: dict, tol: float, what: str):
    """Every leaf within ``tol`` of that leaf's largest magnitude."""
    assert got.keys() == want.keys(), what
    for n in want:
        scale = max(float(np.abs(want[n]).max()), 1e-30)
        err = float(np.abs(got[n] - want[n]).max())
        assert err <= tol * scale, (what, n, err, scale)


def test_pod_step_matches_the_reference(mesh_run, reference):
    shape, res, _ = mesh_run
    want = reference
    for r in res:
        got = r[("fp32", False, 1)]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
        _close(got["grads"], want["grads"], 1e-4, "grads")
        _close(got["params1"], want["params1"], 1e-3, "params after 1 step")


def test_pod_step_equals_its_lock_step_loop(mesh_run):
    shape, res, loops = mesh_run
    for case in CASES[shape]:
        want = loops[case]
        n = len(want["losses"]) if not case[1] else 1
        for r in res:
            got = r[case]
            np.testing.assert_allclose(got["losses"][:n], want["losses"][:n],
                                       rtol=1e-6)
            _close(got["grads"], want["grads"], 1e-6, "grads")
            _close(got["params1"], want["params1"], 1e-4,
                   "params after 1 step")


def test_every_pod_holds_the_same_state(mesh_run):
    """After every step, each rank's params and moments equal bit for bit
    those of the rank at its (data, model) index in the other pod."""
    shape, res, _ = mesh_run
    by = {(r["pod"], r["data"], r["model"]): r for r in res}
    assert len(by) == len(res)
    for (p, d, m), r in by.items():
        if p == 0:
            continue
        other = by[0, d, m]
        for case in CASES[shape]:
            for (pa, oa), (pb, ob) in zip(r[case]["state"],
                                          other[case]["state"]):
                for a, b in ((pa, pb), (oa, ob)):
                    assert a.keys() == b.keys()
                    for k in a:
                        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_pod_rows_carry_the_zero_slices_and_match_a_dry_rank(mesh_run):
    """The step's 'pod' all-reduce bytes are the rank's ZeRO slices'
    (fp32 gradients), its metrics one gather over ('pod', 'data'), and a
    dry rank of the same mesh records the same collectives."""
    shape, res, _ = mesh_run
    P, D, T = shape
    case = CASES[shape][0]
    train = ShapeConfig("t", "train", seq_len=SEQ, global_batch=BATCH)
    for rank, r in enumerate(res):
        rec = r[case]["record"]
        assert rec["all-reduce"]["pod"]["bytes"] == r[case]["pod_bytes"] > 0
        assert rec["all-gather"]["pod,data"]["calls"] == 1
    rank = len(res) - 1                      # the last rank of pod 1
    dry = dryrun.trace_step(port_config(), train, D, T, rank,
                            opt_cfg=AdamWConfig(lr=LR), overlay=True, pod=P)
    assert dry["record"] == res[rank][case]["record"]


def test_moe_pod_step_matches_a_dry_rank(spawned):
    """granite's step on (2,2,1), its MoE layers declared even (expert
    parallelism with no host read): a dry rank of the same mesh, traced
    under fake tensors, records the same collectives (the all-to-alls
    inside a pod, the aux gathered over 'data' and then 'pod')."""
    res = spawned[2, 2, 1]
    train = ShapeConfig("t", "train", seq_len=SEQ, global_batch=BATCH)
    for rank in (0, len(res) - 1):
        dry = dryrun.trace_step(moe_config(), train, 2, 1, rank,
                                opt_cfg=AdamWConfig(lr=LR), pod=2)
        assert dry["record"] == res[rank]["moe"]["record"], rank
    rec = res[0]["moe"]["record"]
    assert rec["all-gather"]["pod"]["calls"] >= moe_config().num_layers
    assert rec["all-to-all"]["data"]["calls"] >= 2 * moe_config().num_layers


def test_moe_aux_is_the_mean_over_the_dp_shards(spawned, ref_models):
    """granite on (2,2,1): each rank's loss and aux equal the mean over
    the four DP shards of the reference's single-device loss_fn on each
    shard's rows (ep mode: a shard's capacity and positions are the
    local path's), and the lock-step loop's; step 1's gradients the mean
    of the shards' (1e-4)."""
    res = spawned[2, 2, 1]
    import jax
    import jax.numpy as jnp
    from repro.models import lm as r_lm
    rcfg, params0, params_np = ref_models["moe"]
    b = batches(rcfg.vocab_size)[0]
    vg = jax.jit(jax.value_and_grad(
        lambda p, mb: r_lm.loss_fn(p, rcfg, mb), has_aux=True))
    losses, auxes, grads = [], [], None
    for d in range(4):
        mb = {k: jnp.asarray(v.numpy()) for k, v in
              t_step._rows(b, d, 4).items()}
        (loss, metrics), g = vg(params0, mb)
        losses.append(float(loss))
        auxes.append(float(metrics["aux"]))
        grads = g if grads is None else jax.tree.map(jnp.add, grads, g)
    grads = _names(jax.tree.map(lambda g: g / 4, grads))
    cfg = moe_config()
    tcfg = tp_config(cfg, 1, ep=2)
    loop = t_step.make_train_step(tcfg, AdamWConfig(lr=LR), data_shards=4)
    whole = bridge.from_numpy(params_np, device="cpu")
    opt = adamw_init(whole, AdamWConfig(lr=LR))
    want = {"losses": [], "aux": []}
    for bt in batches(cfg.vocab_size):
        whole, opt, m = loop(whole, opt, bt)
        want["losses"].append(float(m["loss"]))
        want["aux"].append(float(m["aux"]))
    for r in res:
        got = r["moe"]
        assert got["aux"][0] == pytest.approx(np.mean(auxes), rel=1e-5)
        assert got["losses"][0] == pytest.approx(np.mean(losses), rel=1e-5)
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-6)
        np.testing.assert_allclose(got["aux"], want["aux"], rtol=1e-6)
        _close(got["grads"], grads, 1e-4, "moe grads")


def test_moe_expert_gradients_equal_on_both_pods(spawned):
    by = {(r["pod"], r["data"]): r["moe"] for r in spawned[2, 2, 1]}
    for d in range(2):
        a, b = by[0, d], by[1, d]
        assert a["experts"] and a["experts"].keys() == b["experts"].keys()
        for path in a["experts"]:
            np.testing.assert_array_equal(a["experts"][path],
                                          b["experts"][path])
        for x, y in zip(a["state"], b["state"]):
            for k in x:
                np.testing.assert_array_equal(x[k], y[k], err_msg=k)


# ---------------------------------------------------------------------------
# a two-axis mesh: the bits of the reduction without pods
# ---------------------------------------------------------------------------


def _reduce_without_pods(grads, zero_specs, mesh):
    """The reduction of a (data, model) mesh written over 'data' alone."""
    dp = mesh.shape["data"]
    out = {}
    for path, g in iter_leaves(grads):
        z = t_opt._zero_dim(zero_specs, path)
        if z is None:
            out[path] = mesh.allreduce(g, "data") / dp
        else:
            out[path] = mesh.reduce_scatter(g, "data", z) / dp
    return out


def two_axis_rank(rank: int, init_file: str, params_file: str) -> dict:
    torch.set_num_threads(1)
    mesh = make_mesh(2, 1, rank=rank, init_file=init_file, backend="gloo",
                     device="cpu")
    cfg = port_config()
    oc = AdamWConfig(lr=LR)
    layout = t_step.mesh_layout(cfg, 2, 1, oc)
    lcfg = local_config(tp_config(cfg, 1), 1)
    b = batches(cfg.vocab_size)[0]
    out = {}
    for name, reduce in (("step", None), ("without", _reduce_without_pods)):
        params = bridge.from_numpy(_load(params_file)["qwen"], device="cpu")
        opt = zero_adamw_init(params, layout.zero, oc, mesh)
        with use_mesh(mesh):
            _, _, g = t_step._grads(lcfg, params, t_step._rows(
                b, mesh.dp_rank, 2), None, 1, None)
            mesh.reset_record()
            gs = (reduce or reduce_grads)(g, layout.zero, mesh)
            rec = mesh.record()
            gn = t_opt.zero_global_norm(gs, layout.params, layout.zero, mesh)
            params, opt = t_opt.zero_adamw_update(gs, opt, params,
                                                  layout.zero, oc, mesh,
                                                  gnorm=gn)
        out[name] = (rec, _np(params), _np(opt))
    return out


def test_two_axis_mesh_keeps_its_bits(spawned):
    for r in spawned["two-axis"]:
        (rec, p, o), (rec0, p0, o0) = r["step"], r["without"]
        assert rec == rec0 and all("pod" not in a for axes in rec.values()
                                   for a in axes)
        for a, b in ((p, p0), (o, o0)):
            for k in b:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ---------------------------------------------------------------------------
# compressed_psum over 'pod', the launcher, the multi-pod dry run
# ---------------------------------------------------------------------------

N = 1000


def _psum_inputs():
    """x[d, p]: the gradient of data rank d in pod p."""
    rng = np.random.default_rng(7)
    scale = np.array([1.0, 3.0], np.float32)[None, :, None]
    return (rng.standard_normal((4, 2, N)) * scale).astype(np.float32)


def psum_rank(rank: int, init_file: str) -> dict:
    torch.set_num_threads(1)
    mesh = make_mesh(4, 1, pod=2, rank=rank, init_file=init_file,
                     backend="gloo", device="cpu")
    x = torch.from_numpy(_psum_inputs()[mesh.data_rank, mesh.pod_rank])
    y1, r1 = compressed_psum(x, mesh, "pod")
    y2, r2 = compressed_psum(x * 0.5, mesh, "pod", r1)
    return dict(pod=mesh.pod_rank, data=mesh.data_rank, record=mesh.record(),
                **{k: v.numpy() for k, v in
                   (("y1", y1), ("r1", r1), ("y2", y2), ("r2", r2))})


def test_compressed_psum_over_pod_equals_the_reference(spawned):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.train.grad_compress import compressed_psum as r_psum
    res = spawned["psum"]
    x = _psum_inputs()

    def two_steps(xl):
        y1, r1 = r_psum(xl, "pod", None)
        y2, r2 = r_psum(xl * 0.5, "pod", r1)
        return y1, r1, y2, r2
    for r in res:
        want = jax.vmap(two_steps, axis_name="pod")(jnp.asarray(x[r["data"]]))
        for key, w in zip(("y1", "r1", "y2", "r2"), want):
            np.testing.assert_array_max_ulp(r[key], np.asarray(w)[r["pod"]],
                                            maxulp=1)
        assert set(r["record"]["all-reduce"]) == {"pod"}


def test_launcher_trains_on_a_pod_mesh_and_resumes(tmp_path, capfd):
    d = str(tmp_path / "ckpt")
    common = ["--mesh", "2,2,1", "--reduce", "--device", "cpu", "--batch",
              "4", "--seq", "32", "--ckpt-every", "2", "--ckpt-dir", d]
    first = t_launch.main(common + ["--steps", "4"])
    assert [r["step"] for r in first] == [4] * 4
    assert all(r["losses"] == first[0]["losses"] for r in first)
    assert all(np.isfinite(first[0]["losses"]))
    again = t_launch.main(common + ["--steps", "6", "--resume"])
    assert [len(r["losses"]) for r in again] == [2] * 4
    out = capfd.readouterr().out
    assert "resumed from step 4" in out
    assert "4 processes (2 pods x 2 data x 1 model ranks)" in out
    assert sorted(x for x in os.listdir(d) if x.startswith("step_")) == \
        ["step_0000000004", "step_0000000006"]


def test_multi_pod_dry_cell_holds_the_single_pod_ranks_state():
    """``run_cell(multi_pod=True)`` reports ``2x16x16`` on 512 chips; a
    train step on the dry (2, 16, 16) mesh holds rank 0's params and
    moments of the (16, 16) mesh, and records 'pod' rows."""
    rep = dryrun.run_cell("qwen3-32b", "decode_32k", multi_pod=True,
                          reduce=True, verbose=False)
    assert rep.mesh == "2x16x16" and rep.chips == 512
    cfg = dryrun.cell_config("qwen3-32b", reduce=True)
    train = ShapeConfig("t", "train", seq_len=16, global_batch=32)
    one = dryrun.trace_step(cfg, train, 16, 16, 0)
    two = dryrun.trace_step(cfg, train, 16, 16, 0, pod=2)
    assert two["held"] == one["held"] > 0
    assert "pod" in two["record"]["all-reduce"]
    assert all("pod" not in a for axes in one["record"].values()
               for a in axes)
