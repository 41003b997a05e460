"""Attention whose head counts do not divide 'model' (the reference's rule,
``repro/models/attention.py``: SDPA replicated over 'model'). The reduced
qwen3 (2 layers, d 64, vocab 128) with 1 or 2 KV heads at tp 2, 4 and 8,
and at d 48 (head_dim 12) where wk / wv's 12 columns do not split over 8
ranks and stay whole:

* ``local_config`` keeps every head (``heads_replicated``) and the rank
  holds wq / wk / wv column slices and wo row slices wherever the axis
  divides the dim;
* the shard loop (``tp_config``) gives forward, prefill and decode logits
  within 1e-4 of the reference's meshless model on bridged weights, and
  one train step's loss within 1e-5 of the reference's single-device
  step;
* a 2-process gloo mesh at tp 2 with one KV head gives the loop's logits
  and engine streams (contiguous and paged, every decode step's logits)
  bit for bit, the loop's losses over 2 train steps, and the reference's
  logits (1e-4) and first loss (1e-5); its record holds the q / k / v
  all-gathers of every layer.

The module imports no jax at its top: the spawned ranks import it."""
import copy
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.data.pipeline import DataConfig, lm_batch  # noqa: E402
from repro_torch.distribution.context import use_mesh  # noqa: E402
from repro_torch.distribution.sharding import (heads_split,  # noqa: E402
                                               local_config, local_params,
                                               tp_config)
from repro_torch.launch.mesh import init_file_in, make_mesh  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serve.engine import Engine, Request  # noqa: E402
from repro_torch.train import train_step as t_step  # noqa: E402
from repro_torch.train.optimizer import AdamWConfig, adamw_init  # noqa
from repro_torch.train.optimizer import zero_adamw_init  # noqa: E402

TOKS = np.array([[3, 17, 5, 99, 42, 7, 61, 2, 11, 80]], np.int32)
LR, BATCH, SEQ = 1e-3, 4, 16
# (tp, KV heads, d_model)
LOOP_CASES = [(2, 1, 64), (4, 2, 64), (8, 2, 64), (8, 1, 48)]
MESH_TP, MESH_KVH = 2, 1
PAGED = dict(kv_pages=24, kv_page_len=8)


def case_id(case) -> str:
    tp, kvh, d = case
    return f"tp{tp}-kv{kvh}-d{d}"


def port_config(kvh: int, d: int = 64):
    return dataclasses.replace(
        reduced(get_config("qwen3-32b"), layers=2, d_model=d, vocab=128),
        num_kv_heads=kvh)


def batches(n: int = 2):
    return [{k: torch.from_numpy(v) for k, v in lm_batch(
        DataConfig(128, SEQ, BATCH), s).items()} for s in range(n)]


def _infer(params, cfg) -> dict:
    """Forward logits, prefill's last logits and one decode step's."""
    toks = torch.as_tensor(TOKS)
    with torch.no_grad():
        fwd = lm.forward(params, cfg, toks)
        pre, caches = lm.prefill(params, cfg, toks, cache_len=32)
        t = torch.argmax(pre[:, -1], dim=-1).to(torch.int32)[:, None]
        dec, _ = lm.decode_step(params, cfg, t, torch.tensor(
            [TOKS.shape[1]], dtype=torch.int32), caches)
    return {"forward": fwd.numpy(), "prefill": pre.numpy(),
            "decode": dec.numpy()}


def _requests():
    rng = np.random.default_rng(0)
    return [Request(rid=i, prompt=rng.integers(0, 128, size=(6 + 5 * i,))
                    .astype(np.int32), max_new_tokens=5) for i in range(3)]


def _serve(params, cfg, opts, mesh=None):
    """(streams, every decode step's logits)."""
    eng = Engine(params, cfg, batch_slots=2, cache_len=64, mesh=mesh,
                 **opts)
    steps = []

    def wrap(fn):
        def recorded(p, c, *a):
            out = fn(p, c, *a)
            steps.append(out.clone())
            return out
        return recorded
    eng._decode_step = wrap(eng._decode_step)
    eng._paged_decode_step = wrap(eng._paged_decode_step)
    for r in _requests():
        eng.submit(r)
    done = []
    while eng.has_work():
        done += eng.step()
    return ({r.rid: [int(t) for t in r.out_tokens] for r in done},
            [s.numpy() for s in steps])


def _train_loop(whole, cfg, tp, steps: int = 2):
    tcfg = tp_config(cfg, tp)
    oc = AdamWConfig(lr=LR)
    params = copy.deepcopy(whole)
    opt = adamw_init(params, oc)
    step = t_step.make_train_step(tcfg, oc)
    losses = []
    for b in batches(steps):
        params, opt, m = step(params, opt, b)
        losses.append(float(m["loss"]))
    return losses


def heads_rank(rank: int, init_file: str, params_np) -> dict:
    """One model rank of the (1, 2) gloo mesh: inference, the engine
    (contiguous, paged) and 2 train steps, and the collective record of
    the inference."""
    torch.set_num_threads(1)
    mesh = make_mesh(1, MESH_TP, rank=rank, init_file=init_file,
                     backend="gloo", device="cpu")
    cfg = port_config(MESH_KVH)
    tcfg = tp_config(cfg, MESH_TP)
    lcfg = local_config(tcfg, MESH_TP)
    whole = bridge.from_numpy(params_np, device="cpu")
    local = local_params(copy.deepcopy(whole), tcfg, MESH_TP, rank)
    out = {"shapes": {k: tuple(local["segments"][0]["slot0"]["mixer"][k]
                               ["w"].shape) for k in ("wq", "wk", "wv",
                                                      "wo")}}
    with use_mesh(mesh):
        out["infer"] = _infer(local, lcfg)
    out["record"] = mesh.record()
    out["contiguous"] = _serve(local, lcfg, {}, mesh)
    out["paged"] = _serve(local, lcfg, PAGED, mesh)
    oc = AdamWConfig(lr=LR)
    layout = t_step.mesh_layout(cfg, 1, MESH_TP, oc)
    params = local_params(copy.deepcopy(whole), tcfg, MESH_TP, rank)
    opt = zero_adamw_init(params, layout.zero, oc, mesh)
    step = t_step.make_mesh_train_step(lcfg, oc, mesh, layout)
    out["losses"] = []
    for b in batches():
        params, opt, m = step(params, opt, b)
        out["losses"].append(float(m["loss"]))
    return out


# ---------------------------------------------------------------------------
# the reference
# ---------------------------------------------------------------------------


def _ref(kvh: int, d: int):
    """(reference cfg, params, their numpy copy, its logits, its first
    train step's loss)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import get_config as r_get_config
    from repro.configs import reduced as r_reduced
    from repro.models import lm as r_lm
    from repro.train import optimizer as r_opt
    from repro.train.train_step import make_train_step
    cfg = dataclasses.replace(
        r_reduced(r_get_config("qwen3-32b"), layers=2, d_model=d,
                  vocab=128), num_kv_heads=kvh)
    params = r_lm.init_params(jax.random.PRNGKey(0), cfg)
    toks = jnp.asarray(TOKS)
    pre, caches = r_lm.prefill(params, cfg, toks, cache_len=32)
    t = jnp.argmax(pre[:, -1], axis=-1).astype(jnp.int32)[:, None]
    dec, _ = r_lm.decode_step(params, cfg, t, jnp.asarray(
        [TOKS.shape[1]], jnp.int32), caches)
    logits = {"forward": np.asarray(r_lm.forward(params, cfg, toks)),
              "prefill": np.asarray(pre), "decode": np.asarray(dec)}
    oc = r_opt.AdamWConfig(lr=LR)
    b = {k: jnp.asarray(v.numpy()) for k, v in batches(1)[0].items()}
    _, _, m = jax.jit(make_train_step(cfg, oc))(
        params, r_opt.adamw_init(params, oc), b)
    return cfg, params, jax.tree.map(np.asarray, params), logits, \
        float(m["loss"])


@pytest.fixture(scope="module")
def refs():
    cache = {}

    def get(kvh, d=64):
        if (kvh, d) not in cache:
            cache[kvh, d] = _ref(kvh, d)
        return cache[kvh, d]
    return get


def _close(got, want, tol=1e-4):
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=tol, atol=tol,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# placement and the shard loop
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", LOOP_CASES, ids=case_id)
def test_local_config_and_params_keep_every_head(case):
    tp, kvh, d = case
    cfg = tp_config(port_config(kvh, d), tp)
    assert not heads_split(cfg, tp)
    lcfg = local_config(cfg, tp)
    assert (lcfg.num_heads, lcfg.num_kv_heads, lcfg.heads_replicated) == \
        (cfg.num_heads, kvh, True)
    whole = lm.init_params(cfg, device="cpu")
    mixer = local_params(whole, cfg, tp, tp - 1)["segments"][0]["slot0"][
        "mixer"]
    hd = cfg.attn_head_dim
    for name, cols in (("wq", 4 * hd), ("wk", kvh * hd), ("wv", kvh * hd)):
        want = cols // tp if cols % tp == 0 else cols
        assert mixer[name]["w"].shape[-1] == want, name
    assert mixer["wo"]["w"].shape[-2] == 4 * hd // tp
    caches = lm.init_caches(None, lcfg, 2, 16, device="cpu")
    assert caches[0]["slot0"].k.shape[-2:] == (kvh, hd)


def test_heads_that_split_keep_the_rank_heads():
    cfg = tp_config(port_config(2), 2)
    lcfg = local_config(cfg, 2)
    assert (lcfg.num_heads, lcfg.num_kv_heads, lcfg.heads_replicated) == \
        (2, 1, False)


@pytest.mark.parametrize("case", LOOP_CASES, ids=case_id)
def test_shard_loop_matches_reference(refs, case):
    tp, kvh, d = case
    _, _, params_np, want, loss = refs(kvh, d)
    whole = bridge.from_numpy(params_np, device="cpu")
    cfg = port_config(kvh, d)
    _close(_infer(whole, tp_config(cfg, tp)), want)
    np.testing.assert_allclose(_train_loop(whole, cfg, tp, 1)[0], loss,
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# a gloo mesh
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mesh_run(refs, tmp_path_factory):
    params_np = refs(MESH_KVH)[2]
    store = init_file_in(str(tmp_path_factory.mktemp("heads")))
    ranks = run_ranks(heads_rank, MESH_TP, (store, params_np), timeout=120)
    whole = bridge.from_numpy(params_np, device="cpu")
    tcfg = tp_config(port_config(MESH_KVH), MESH_TP)
    loop = {"infer": _infer(whole, tcfg),
            "contiguous": _serve(whole, tcfg, {}),
            "paged": _serve(whole, tcfg, PAGED),
            "losses": _train_loop(whole, port_config(MESH_KVH), MESH_TP)}
    return ranks, loop


def test_mesh_ranks_hold_their_slices(mesh_run):
    ranks, _ = mesh_run
    hd = 16
    for r in ranks:
        assert r["shapes"] == {"wq": (2, 64, 4 * hd // 2),
                               "wk": (2, 64, hd // 2),
                               "wv": (2, 64, hd // 2),
                               "wo": (2, 4 * hd // 2, 64)}


def test_mesh_logits_equal_loop_and_reference(mesh_run, refs):
    ranks, loop = mesh_run
    want = refs(MESH_KVH)[3]
    for r in ranks:
        for k in loop["infer"]:
            np.testing.assert_array_equal(r["infer"][k], loop["infer"][k],
                                          err_msg=k)
        _close(r["infer"], want)


@pytest.mark.parametrize("mode", ["contiguous", "paged"])
def test_mesh_engine_equals_loop_bit_for_bit(mesh_run, mode):
    ranks, loop = mesh_run
    streams, steps = loop[mode]
    assert steps
    for r in ranks:
        assert r[mode][0] == streams
        assert len(r[mode][1]) == len(steps)
        for a, b in zip(r[mode][1], steps):
            np.testing.assert_array_equal(a, b)


def test_mesh_train_loss_matches_loop_and_reference(mesh_run, refs):
    ranks, loop = mesh_run
    for r in ranks:
        np.testing.assert_allclose(r["losses"], loop["losses"], rtol=1e-6)
        np.testing.assert_allclose(r["losses"][0], refs(MESH_KVH)[4],
                                   rtol=1e-5)


def test_mesh_record_gathers_qkv_every_layer(mesh_run):
    """Inference (forward, prefill, one decode step) on the rank: per
    layer the q / k / v all-gathers and wo's and the FFN's all-reduces,
    per call the vocab-sharded head's all-gather and the embedding's
    all-reduce."""
    ranks, _ = mesh_run
    rec = ranks[0]["record"]
    layers, calls = 2, 3
    assert rec["all-gather"]["model"]["calls"] == (3 * layers + 1) * calls
    assert rec["all-reduce"]["model"]["calls"] == (2 * layers + 1) * calls
    assert set(rec) == {"all-gather", "all-reduce"}
    assert ranks[1]["record"] == rec
