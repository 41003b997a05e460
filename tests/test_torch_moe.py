"""The port's MoE layer (``repro_torch.models.moe``) against the
reference's ``repro.models.moe`` on the same numpy-seeded inputs:
``route`` decides exactly as the reference does (expert ids, the stable
dispatch order and positions within experts), ties and capacity drops
included; ``moe_ffn_local`` and its aux loss within 1e-5, gated and not,
with shared experts, with SASP masks, and with a capacity that drops
tokens."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config, reduced  # noqa: E402
from repro.models import moe as r_moe  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.models import moe as t_moe  # noqa: E402

D = 32


def _cfgs(experts=8, top_k=2, capacity=1.25, gated=True, shared=0):
    out = []
    for get, red in ((get_config, reduced), (t_get_config, t_reduced)):
        cfg = red(get("granite-moe-1b-a400m"), layers=1, d_model=D,
                  vocab=64)
        cfg = dataclasses.replace(
            cfg, ffn_gated=gated, act="silu" if gated else "gelu",
            moe=dataclasses.replace(cfg.moe, num_experts=experts,
                                    top_k=top_k, capacity_factor=capacity,
                                    num_shared_experts=shared))
        out.append(cfg)
    return tuple(out)


def _params(cfg, seed=0, masks=False):
    """Numpy params of one MoE layer in the reference's layout."""
    rng = np.random.default_rng(seed)
    E, f = cfg.moe.num_experts, cfg.d_ff

    def n(*shape):
        return (rng.normal(size=shape) * 0.2).astype(np.float32)

    p = {"router": {"w": n(D, E)}, "w1": {"w": n(E, D, f)},
         "w2": {"w": n(E, f, D)}}
    if cfg.ffn_gated:
        p["w3"] = {"w": n(E, D, f)}
    if cfg.moe.num_shared_experts:
        p["shared"] = {"w1": {"w": n(D, f)}, "w2": {"w": n(f, D)},
                       "w3": {"w": n(D, f)}}
    if masks:
        p["sasp_masks"] = {k: rng.random((E, D // 8, f // 8)) > 0.5
                           for k in ("w1", "w2", "w3")}
    return p


def _both(np_tree):
    return (_jax(np_tree), bridge.from_numpy(np_tree, device="cpu"))


def _jax(tree):
    if isinstance(tree, dict):
        return {k: _jax(v) for k, v in tree.items()}
    return jnp.asarray(tree)


def _x(N, seed=1):
    return np.random.default_rng(seed).normal(size=(N, D)).astype(np.float32)


ROUTE_CASES = {
    "plain": lambda p, x: (p, x),
    # equal router columns: experts 0/1 and 4/5 tie for every token
    "tied-columns": lambda p, x: (
        {**p, "router": {"w": p["router"]["w"][:, [0, 0, 2, 3, 4, 4, 6, 7]]}},
        x),
    # zero rows route with uniform probabilities: every expert ties
    "uniform-rows": lambda p, x: (p, np.concatenate(
        [np.zeros((3, D), np.float32), x[3:]])),
}


@pytest.mark.parametrize("top_k", [2, 6])
@pytest.mark.parametrize("case", sorted(ROUTE_CASES))
def test_route_equals_reference(case, top_k):
    cfg, tcfg = _cfgs(top_k=top_k)
    p, x = ROUTE_CASES[case](_params(cfg), _x(40))
    rp, tp = _both(p)
    want = r_moe.route(rp, cfg, jnp.asarray(x))
    got = t_moe.route(tp, tcfg, torch.as_tensor(x))
    for f in ("expert_idx", "sort_idx", "pos_in_expert"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    np.testing.assert_allclose(got.gate_w.numpy(), np.asarray(want.gate_w),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(float(got.aux_loss), float(want.aux_loss),
                               rtol=1e-6)
    if case != "plain":
        # the tie is real: equal probabilities, lower expert first
        gw = got.gate_w.numpy()
        assert np.any(np.isclose(gw[:, 0], gw[:, 1], rtol=0, atol=0))


FFN_CASES = {
    "gated": dict(),
    "plain-gelu": dict(gated=False),
    "shared": dict(shared=1),
    "masked": dict(masks=True),
    # capacity 0.5 drops about half of the slots
    "drops": dict(capacity=0.5),
    "top6": dict(top_k=6, capacity=1.0),
}


@pytest.mark.parametrize("case", sorted(FFN_CASES))
def test_moe_ffn_local_matches_reference(case):
    kw = dict(FFN_CASES[case])
    masks = kw.pop("masks", False)
    cfg, tcfg = _cfgs(**kw)
    rp, tp = _both(_params(cfg, masks=masks))
    x = _x(2 * 13).reshape(2, 13, D)
    y0, aux0 = r_moe.moe_ffn_local(rp, cfg, jnp.asarray(x))
    y1, aux1 = t_moe.moe_ffn_local(tp, tcfg, torch.as_tensor(x))
    scale = float(np.abs(np.asarray(y0)).max())
    assert float(np.abs(y1.numpy() - np.asarray(y0)).max()) <= 1e-5 * scale
    np.testing.assert_allclose(float(aux1), float(aux0), rtol=1e-5)
    if case == "drops":
        r = t_moe.route(tp, tcfg, torch.as_tensor(x.reshape(-1, D)))
        C = -(-26 * 2 * 0.5 // 8)
        assert int((r.pos_in_expert >= C).sum()) > 0


def test_init_layout_matches_reference():
    """``moe_init`` builds the reference's leaves, shapes and types."""
    import jax
    cfg, tcfg = _cfgs(shared=1)
    ref = r_moe.moe_init(jax.random.PRNGKey(0), cfg)
    mine = t_moe.moe_init(torch.Generator().manual_seed(0), tcfg, layers=1,
                          device="cpu", out_scale=0.01)
    flat = jax.tree_util.tree_flatten_with_path(ref)[0]
    want = {jax.tree_util.keystr(k): (tuple(v.shape), str(v.dtype))
            for k, v in flat}
    got = {}

    def walk(t, key):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{key}['{k}']")
        else:
            got[key] = (tuple(t.shape[1:]), str(t.dtype).replace(
                "torch.", ""))
    walk(mine, "")
    assert got == want
