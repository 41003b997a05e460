"""A Mamba-2 layer with its heads over 'model' (``repro_torch.models.ssm``)
against the reference's meshless ``repro.models.ssm``, fp32, within 1e-5
of each output's scale: a 16-token prefill (``ssm_apply_full``) and 8
``ssm_apply_decode`` steps from its cache, at tp 2 and 4, as the shard
loop (``cfg.tp_shards``, caches in the whole layout) and on gloo meshes
of spawned processes (each rank its heads' columns, the whole B and C,
its rows of out_proj, the gated RMSNorm's squares and out_proj's
partials all-reduced; caches of its heads, put back together here). At
tp 2 the mesh is the loop bit for bit. Imports no jax at its top: the
ranks are spawned processes that import this module."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.distribution import context as dctx  # noqa: E402
from repro_torch.distribution.sharding import (local_config,  # noqa: E402
                                               local_params, tp_config)
from repro_torch.launch.mesh import init_file_in, make_mesh  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402
from repro_torch.models import ssm as t_ssm  # noqa: E402

S, STEPS = 16, 8


def port_config():
    cfg = reduced(get_config("mamba2-780m"), layers=1, d_model=32, vocab=64)
    return dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm,
                                                            chunk_size=8))


def _close(got, want, tol=1e-5):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= tol * scale, (err, scale)


@pytest.fixture(scope="module")
def reference():
    """The reference's layer (its init, perturbed off the constants so
    every leaf matters), the input, and its prefill and decode outputs
    and caches (numpy)."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as r_get, reduced as r_reduced
    from repro.models import ssm as r_ssm
    cfg = r_reduced(r_get("mamba2-780m"), layers=1, d_model=32, vocab=64)
    cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm,
                                                           chunk_size=8))
    p = jax.tree.map(np.asarray, r_ssm.ssm_init(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(0)
    p["conv_b"] = rng.normal(size=p["conv_b"].shape).astype(np.float32)
    p["norm"] = (1 + 0.1 * rng.normal(size=p["norm"].shape)).astype(
        np.float32)
    p["D"] = rng.normal(size=p["D"].shape).astype(np.float32)
    p["dt_bias"] = (p["dt_bias"] + 0.1 * rng.normal(
        size=p["dt_bias"].shape)).astype(np.float32)
    for k in ("in_z", "in_xbc", "in_dt", "out_proj"):
        p[k]["w"] = p[k]["w"] * 10
    x = np.random.default_rng(7).normal(size=(2, S + STEPS, 32)).astype(
        np.float32)
    rp = jax.tree.map(jnp.asarray, p)
    y, c = r_ssm.ssm_apply_full(rp, cfg, jnp.asarray(x[:, :S]))
    out = {"y": [np.asarray(y)], "state": [np.asarray(c.state)],
           "conv": [np.asarray(c.conv)]}
    for t in range(S, S + STEPS):
        y, c = r_ssm.ssm_apply_decode(rp, cfg, jnp.asarray(x[:, t:t + 1]), c)
        out["y"].append(np.asarray(y))
        out["state"].append(np.asarray(c.state))
        out["conv"].append(np.asarray(c.conv))
    return p, x, out


def _torch_params(p):
    return {k: ({kk: torch.as_tensor(np.array(vv)) for kk, vv in v.items()}
                if isinstance(v, dict) else torch.as_tensor(np.array(v)))
            for k, v in p.items()}


def _run(p, cfg, x, cache=None):
    """Prefill then STEPS decode steps: (outputs, states, conv windows)
    after each call, the cache written in place."""
    y, c = t_ssm.ssm_apply_full(p, cfg, torch.as_tensor(x[:, :S]))
    ys, states, convs = [y.numpy()], [c.state.numpy().copy()], \
        [c.conv.numpy().copy()]
    for t in range(S, S + STEPS):
        y, c = t_ssm.ssm_apply_decode(p, cfg, torch.as_tensor(x[:, t:t + 1]),
                                      c)
        ys.append(y.numpy())
        states.append(c.state.numpy().copy())
        convs.append(c.conv.numpy().copy())
    return ys, states, convs


def _rank(rank, tp, p, x, store):
    """One model rank: its heads (``local_params`` of a one-layer tree)
    under the mesh."""
    torch.set_num_threads(1)
    mesh = make_mesh(1, tp, rank=rank, init_file=store, backend="gloo",
                     device="cpu")
    cfg = tp_config(port_config(), tp)
    tree = {"segments": ({"slot0": {"ffn": {}, "mixer": {
        k: ({kk: vv[None] for kk, vv in v.items()} if isinstance(v, dict)
            else v[None]) for k, v in _torch_params(p).items()}}},)}
    loc = local_params(tree, cfg, tp, mesh.model_rank)
    mx = loc["segments"][0]["slot0"]["mixer"]
    mx = {k: ({kk: vv[0] for kk, vv in v.items()} if isinstance(v, dict)
              else v[0]) for k, v in mx.items()}
    with dctx.use_mesh(mesh):
        return _run(mx, local_config(cfg, tp), x)


def _whole(parts, di, gn):
    """The ranks' state / conv windows in the whole layout."""
    states = [np.concatenate([r[1][i] for r in parts], axis=1)
              for i in range(len(parts[0][1]))]
    convs = [np.concatenate([r[2][i][..., :-2 * gn] for r in parts]
                            + [parts[0][2][i][..., -2 * gn:]], axis=-1)
             for i in range(len(parts[0][2]))]
    return states, convs


def _check(ys, states, convs, want):
    for a, b in zip(ys, want["y"]):
        _close(a, b)
    for a, b in zip(states, want["state"]):
        _close(a, b)
    for a, b in zip(convs, want["conv"]):
        _close(a, b)


@pytest.mark.parametrize("tp", [2, 4])
def test_heads_shard_loop_matches_reference(reference, tp):
    p, x, want = reference
    ys, states, convs = _run(_torch_params(p), tp_config(port_config(), tp),
                             x)
    _check(ys, states, convs, want)
    assert states[0].shape == want["state"][0].shape


@pytest.mark.parametrize("tp", [2, 4])
def test_heads_on_a_mesh_match_reference_and_loop(reference, tp,
                                                  tmp_path):
    p, x, want = reference
    store = init_file_in(str(tmp_path), f"ssm_{tp}")
    parts = run_ranks(_rank, tp, (tp, p, x, store), timeout=120)
    cfg = port_config()
    H = cfg.ssm.num_heads(cfg.d_model)
    assert parts[0][1][0].shape[1] == H // tp
    for r in parts[1:]:                 # out_proj's sum on every rank
        assert all(np.array_equal(a, b) for a, b in zip(r[0], parts[0][0]))
    gn = cfg.ssm.ngroups * cfg.ssm.state_dim
    states, convs = _whole(parts, cfg.ssm.d_inner(cfg.d_model), gn)
    _check(parts[0][0], states, convs, want)
    if tp == 2:
        ys, lstates, lconvs = _run(_torch_params(p), tp_config(cfg, tp), x)
        for a, b in zip(parts[0][0] + states + convs,
                        ys + lstates + lconvs):
            assert np.array_equal(a, b)
