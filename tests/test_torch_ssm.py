"""The port's Mamba-2 mixer (``repro_torch.models.ssm``) against the
reference's ``repro.models.ssm`` on the same numpy-seeded inputs, in
fp32, within 1e-5 of each output's scale: the causal conv, the chunked
SSD scan (1 and 2 groups, S shorter than the conv, S not a multiple of
the chunk), the full layer with its returned cache, and decode steps
from that cache; ``cache_map`` keeps a cache's type.

It also pins a fault of the reference, which the port reproduces: at
mamba2-780m's own widths ``_segsum_decay`` overflows exp() above the
diagonal and the backward multiplies the masked zeros by inf, so both
packages give NaN gradients, in the same leaves."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config, reduced  # noqa: E402
from repro.models import lm as r_lm  # noqa: E402
from repro.models import ssm as r_ssm  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models import ssm as t_ssm  # noqa: E402
from repro_torch.train import train_step as t_step  # noqa: E402
from torch_parity import KEY, bridged, leaves_np  # noqa: E402


def _close(got, want, tol=1e-5):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got.detach().numpy() - want).max())
    assert err <= tol * scale, (err, scale)


def _cfgs(groups=1):
    out = []
    for get, red in ((get_config, reduced), (t_get_config, t_reduced)):
        cfg = red(get("mamba2-780m"), layers=1, d_model=32, vocab=64)
        out.append(dataclasses.replace(cfg, ssm=dataclasses.replace(
            cfg.ssm, ngroups=groups, chunk_size=8)))
    return tuple(out)


def _layer(cfg, seed=0):
    """One SSM layer's params (numpy; fp32), perturbed off the init's
    constants so every leaf matters."""
    p = jax.tree.map(np.asarray, r_ssm.ssm_init(KEY, cfg))
    rng = np.random.default_rng(seed)
    p["conv_b"] = rng.normal(size=p["conv_b"].shape).astype(np.float32)
    p["norm"] = (1 + 0.1 * rng.normal(size=p["norm"].shape)).astype(
        np.float32)
    p["D"] = rng.normal(size=p["D"].shape).astype(np.float32)
    for k in ("in_z", "in_xbc", "in_dt", "out_proj"):
        p[k]["w"] = p[k]["w"] * 10
    return p


def _pair(p):
    return (jax.tree.map(jnp.asarray, p),
            jax.tree.map(lambda a: torch.from_numpy(np.array(a)), p))


@pytest.mark.parametrize("S", [2, 9])
def test_causal_conv_matches_reference(S):
    rng = np.random.default_rng(S)
    x = rng.normal(size=(2, S, 12)).astype(np.float32)
    w = rng.normal(size=(4, 12)).astype(np.float32)
    b = rng.normal(size=(12,)).astype(np.float32)
    _close(t_ssm._causal_conv(*map(torch.as_tensor, (x, w, b))),
           r_ssm._causal_conv(*map(jnp.asarray, (x, w, b))))


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("S", [2, 16, 23, 40])
def test_ssd_chunked_matches_reference(S, groups):
    """Under chunk 16: S 2 and 16 are one chunk, S 23 (prime) 23 chunks
    of 1, S 40 four chunks of 10 (the largest divisor up to 16)."""
    rng = np.random.default_rng(S + groups)
    B, H, P, N = 2, 4, 3, 5
    x = rng.normal(size=(B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(B, S, H)))).astype(np.float32)
    A = -np.arange(1, H + 1, dtype=np.float32)
    Bm = rng.normal(size=(B, S, groups, N)).astype(np.float32)
    Cm = rng.normal(size=(B, S, groups, N)).astype(np.float32)
    D = rng.normal(size=(H,)).astype(np.float32)
    h0 = rng.normal(size=(B, H, P, N)).astype(np.float32)
    args = (x, dt, A, Bm, Cm, D, h0)
    y0, h0_ = r_ssm.ssd_chunked(*map(jnp.asarray, args), chunk=16)
    y1, h1 = t_ssm.ssd_chunked(*map(torch.as_tensor, args), chunk=16)
    _close(y1, y0)
    _close(h1, h0_)


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("S", [2, 13])
def test_layer_prefill_and_decode_match_reference(S, groups):
    """The full layer (S 2 < K - 1 exercises the padded conv tail), its
    cache, then 3 decode steps from that cache (the port's writes its
    cache in place)."""
    cfg, tcfg = _cfgs(groups)
    rp, tp = _pair(_layer(cfg))
    x = np.random.default_rng(7).normal(size=(2, S + 3, 32)).astype(
        np.float32)
    y0, c0 = r_ssm.ssm_apply_full(rp, cfg, jnp.asarray(x[:, :S]))
    y1, c1 = t_ssm.ssm_apply_full(tp, tcfg, torch.as_tensor(x[:, :S]))
    _close(y1, y0)
    _close(c1.state, c0.state)
    _close(c1.conv, c0.conv)
    cache = t_ssm.SSMCache(c1.state.clone(), c1.conv.clone())
    for t in range(S, S + 3):
        xt = x[:, t:t + 1]
        y0, c0 = r_ssm.ssm_apply_decode(rp, cfg, jnp.asarray(xt), c0)
        y1, back = t_ssm.ssm_apply_decode(tp, tcfg, torch.as_tensor(xt),
                                          cache)
        assert back is cache
        _close(y1, y0)
        _close(cache.state, c0.state)
        _close(cache.conv, c0.conv)


def test_cache_map_keeps_the_cache_type():
    _, tcfg = _cfgs()
    c = t_ssm.init_ssm_cache(tcfg, 3, torch.float32, "cpu")
    row = t_attn.cache_map(lambda a: a[1], c)
    assert isinstance(row, t_ssm.SSMCache)
    assert row.state.shape == c.state.shape[1:]
    kv = t_attn.init_kv_cache(2, 4, 1, 8, torch.float32, "cpu")
    assert isinstance(t_attn.cache_map(lambda a: a[:1], kv), t_attn.KVCache)


def test_ssd_backward_nan_fault_of_the_reference_is_reproduced():
    """mamba2-780m's own widths (48 heads, A down to -48), 1 layer, vocab
    256, a batch of 4 x 16 tokens, fp32: the loss is finite and agrees
    within 1e-5, and the gradients are NaN in the same leaves in both
    packages. (Whether an overflow occurs depends on the data: dt grows
    with |x @ in_dt|; this batch overflows, 1 x 16 of the same seed does
    not.)"""
    cfg = dataclasses.replace(get_config("mamba2-780m"), num_layers=1,
                              vocab_size=256, compute_dtype="float32",
                              remat="none")
    tcfg = dataclasses.replace(t_get_config("mamba2-780m"), num_layers=1,
                               vocab_size=256, compute_dtype="float32",
                               remat="none")
    params = r_lm.init_params(KEY, cfg)
    toks = np.random.default_rng(0).integers(0, 256, (4, 16)).astype(
        np.int32)
    want_loss, want = jax.value_and_grad(
        lambda p: r_lm.loss_fn(p, cfg, {"tokens": jnp.asarray(toks)})[0])(
        params)
    loss, _, got = t_step.value_and_grad(tcfg, bridged(params),
                                         {"tokens": torch.as_tensor(toks)})
    assert np.isfinite(float(want_loss))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    w, g = leaves_np(want), leaves_np(got)
    nan_w = {n for n, a in w.items() if np.isnan(a).any()}
    nan_g = {n for n, a in g.items() if np.isnan(a).any()}
    assert nan_w and nan_g == nan_w, (nan_w, nan_g)
