"""The port's decoder against the reference on the same weights, in fp32:
forward, prefill and decode logits within 1e-4 (the bound the reference
holds its own packed paths to) for the dense, masked and packed paths —
scope ffn and all, fused and per-matrix FFN — plus the left-padded
batched prefill and the int8 packed path (same int8 containers on both
sides: 1e-4; vs the fp32 masked model: the reference's 5e-2)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core.deploy import deploy_packed  # noqa: E402
from repro.core.pruning import prune_params  # noqa: E402
from repro.models import lm  # noqa: E402
from repro_torch.core import deploy as t_deploy  # noqa: E402
from repro_torch.core import pruning as t_pruning  # noqa: E402
from repro_torch.models import lm as t_lm  # noqa: E402
from torch_parity import bridged, model  # noqa: E402

TOKS = np.arange(1, 9, dtype=np.int32)[None]


def _close(got, ref, tol=1e-4):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=tol, atol=tol)


def _both(path, scope="all", fuse_ffn=True, quantize=False):
    """(ref params, ref cfg, port params, port cfg) along one path."""
    cfg, tcfg, params, tparams = model(scope=scope, sparsity=0.25)
    if path == "dense":
        return params, cfg, tparams, tcfg
    pruned, _ = prune_params(params, cfg.sasp)
    if path == "masked":
        return pruned, cfg, bridged(pruned), tcfg
    ref, rcfg = deploy_packed(pruned, cfg, fuse_ffn=fuse_ffn,
                              quantize=quantize)
    tpruned, _ = t_pruning.prune_params(tparams, tcfg.sasp)
    mine, mcfg = t_deploy.deploy_packed(tpruned, tcfg, fuse_ffn=fuse_ffn,
                                        quantize=quantize)
    return ref, rcfg, mine, mcfg


CASES = [("dense", "all", True), ("masked", "all", True),
         ("packed", "ffn", True), ("packed", "ffn", False),
         ("packed", "all", True), ("packed", "all", False)]


@pytest.mark.parametrize("path,scope,fuse_ffn", CASES)
def test_forward_prefill_decode_match_reference(path, scope, fuse_ffn):
    ref, rcfg, mine, mcfg = _both(path, scope, fuse_ffn)
    _close(t_lm.forward(mine, mcfg, torch.as_tensor(TOKS)),
           lm.forward(ref, rcfg, jnp.asarray(TOKS)))
    lg0, c0 = lm.prefill(ref, rcfg, jnp.asarray(TOKS), cache_len=32)
    lg1, c1 = t_lm.prefill(mine, mcfg, torch.as_tensor(TOKS), cache_len=32)
    _close(lg1, lg0)
    t = int(jnp.argmax(lg0[0, 0]))
    assert int(torch.argmax(lg1[0, 0])) == t
    d0, _ = lm.decode_step(ref, rcfg, jnp.asarray([[t]], jnp.int32),
                           jnp.asarray([8], jnp.int32), c0)
    d1, _ = t_lm.decode_step(mine, mcfg, torch.tensor([[t]]),
                             torch.tensor([8], dtype=torch.int32), c1)
    _close(d1, d0)


def test_left_padded_prefill_matches_reference():
    ref, rcfg, mine, mcfg = _both("packed", "all", True)
    toks = np.array([[0, 0, 0, 5, 6, 7, 8, 9], [1, 2, 3, 4, 5, 6, 7, 8]],
                    np.int32)
    pos = np.array([np.arange(8) - 3, np.arange(8)], np.int32)
    lg0, c0 = lm.prefill(ref, rcfg, jnp.asarray(toks), cache_len=16,
                         positions=jnp.asarray(pos))
    lg1, c1 = t_lm.prefill(mine, mcfg, torch.as_tensor(toks), cache_len=16,
                           positions=torch.as_tensor(pos))
    _close(lg1, lg0)
    r = c0[0]["slot0"]
    m = c1[0]["slot0"]
    np.testing.assert_array_equal(m.pos.numpy(), np.asarray(r.pos))
    _close(m.k, r.k)
    nxt = np.array(jnp.argmax(lg0[:, 0], axis=-1), np.int32)[:, None]
    step = np.array([5, 8], np.int32)
    d0, _ = lm.decode_step(ref, rcfg, jnp.asarray(nxt), jnp.asarray(step), c0)
    d1, _ = t_lm.decode_step(mine, mcfg, torch.as_tensor(nxt),
                             torch.as_tensor(step), c1)
    _close(d1, d0)


@pytest.mark.parametrize("fuse_ffn", [True, False])
def test_int8_packed_matches_reference(fuse_ffn):
    ref, rcfg, mine, mcfg = _both("packed", "all", fuse_ffn, quantize=True)
    got = t_lm.forward(mine, mcfg, torch.as_tensor(TOKS))
    _close(got, lm.forward(ref, rcfg, jnp.asarray(TOKS)))
    masked, mcfg0, tmasked, _ = _both("masked", "all")
    dense = np.asarray(lm.forward(masked, mcfg0, jnp.asarray(TOKS)))
    err = np.abs(got.numpy() - dense).max() / (np.abs(dense).max() + 1e-9)
    assert err < 5e-2


def test_port_init_params_layout():
    """The port's own initialiser builds the reference's tree layout."""
    cfg, tcfg, params, _ = model()
    mine = t_lm.init_params(tcfg, seed=0, device="cpu")
    ref = {"/".join(str(k) for k in p): np.asarray(v).shape
           for p, v in _flat(params)}
    got = {"/".join(str(k) for k in p): tuple(v.shape)
           for p, v in t_pruning.iter_leaves(mine)}
    assert got == ref


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], path + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _flat(v, path + (i,))
    else:
        yield path, tree
