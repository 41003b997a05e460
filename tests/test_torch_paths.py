"""The port's bsr, kernel and int8 masked serving paths against the
reference, on the reduced qwen3-32b test model with the same weights:

* the deployment containers — ``bsr_overlay_from_masks`` and
  ``quantize_params`` — equal the reference's array for array (2-D and
  layer-stacked);
* forward, prefill and decode logits agree within 1e-4 in fp32 (the bound
  the reference holds its own paths to) for bsr and kernel (scope ffn and
  all, fp32 and int8 blocks) and for masked with int8 weights, scope ffn;
* greedy engine streams equal the reference engine's on those paths;
* the launcher refuses ``--path masked --int8-weights --scope all``,
  which the reference cannot serve.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core.deploy import deploy_packed  # noqa: E402
from repro.core.pruning import prune_params  # noqa: E402
from repro.core.sasp import bsr_overlay_from_masks  # noqa: E402
from repro.core.sasp import quantize_params  # noqa: E402
from repro.launch.serve import build_serving_params  # noqa: E402
from repro.models import lm  # noqa: E402
from repro.serve.engine import Engine, Request  # noqa: E402
from repro_torch.core import deploy as t_deploy  # noqa: E402
from repro_torch.core import pruning as t_pruning  # noqa: E402
from repro_torch.core import sasp as t_sasp  # noqa: E402
from repro_torch.core.quantization import QuantizedWeight  # noqa: E402
from repro_torch.core.sparse import BlockSparseWeight  # noqa: E402
from repro_torch.kernels.sasp_gemm import gemm as t_gemm  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.models import lm as t_lm  # noqa: E402
from repro_torch.serve.engine import Engine as TEngine  # noqa: E402
from repro_torch.serve.engine import Request as TRequest  # noqa: E402
from torch_parity import bridged, mask_key, model, to_np  # noqa: E402

TOKS = np.arange(1, 9, dtype=np.int32)[None]
SPARSITY = 0.25          # the reduced tests' rate (wo/w2 survive it)


def _close(got, ref, tol=1e-4):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=tol, atol=tol)


def _leaves(tree, path=()):
    """(path, leaf) over dicts, tuples and both packages' containers."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    elif hasattr(tree, "idx") and hasattr(tree, "vals"):
        for f in ("vals", "idx", "scale"):
            yield path + (f,), getattr(tree, f)
        yield path + ("shape",), tuple(tree.shape)
        yield path + ("block",), tuple(tree.block)
    elif hasattr(tree, "q") and hasattr(tree, "scale"):
        for f in ("q", "scale"):
            yield path + (f,), getattr(tree, f)
        yield path + ("block",), tuple(tree.block)
    else:
        yield path, tree


def _assert_trees_equal(mine, ref):
    got = dict(_leaves(mine))
    want = dict(_leaves(to_np(ref)))
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        if isinstance(w, tuple) or w is None:
            assert g == w, k
            continue
        g = g.numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, (k, g.dtype,
                                                           w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=str(k))


@pytest.mark.parametrize("scope", ["ffn", "all"])
@pytest.mark.parametrize("quantize", [False, True])
def test_bsr_overlay_equals_reference(scope, quantize):
    cfg, tcfg, params, tparams = model(scope=scope, sparsity=SPARSITY,
                                       quantize=quantize)
    pruned, masks = prune_params(params, cfg.sasp)
    tpruned, tmasks = t_pruning.prune_params(tparams, tcfg.sasp)
    assert {mask_key(p) for p in masks} == set(tmasks)
    ref = bsr_overlay_from_masks(pruned, masks, cfg.sasp)
    mine = t_sasp.bsr_overlay_from_masks(tpruned, tmasks, tcfg.sasp)
    bsr = mine["segments"]["0"]["slot0"]["ffn"]["sasp_bsr"]["w1"]
    assert isinstance(bsr, BlockSparseWeight) and bsr.vals.ndim == 5
    _assert_trees_equal(mine, ref)
    # 2-D weights: one container without the layer axis
    flat = {mask_key(p): p for p in masks}
    path = ("segments", 0, "slot0", "ffn", "w1", "w")
    w0 = {"w1": {"w": tpruned["segments"][0]["slot0"]["ffn"]["w1"]["w"][0]}}
    m0 = {("w1", "w"): tmasks[path][0]}
    one = t_sasp.bsr_overlay_from_masks(w0, m0, tcfg.sasp)
    ref_one = bsr_overlay_from_masks(
        {"w1": {"w": pruned["segments"][0]["slot0"]["ffn"]["w1"]["w"][0]}},
        {flat[path][-2:]: masks[flat[path]][0]},
        cfg.sasp)
    _assert_trees_equal(one, ref_one)


@pytest.mark.parametrize("scope", ["ffn", "all"])
def test_quantize_params_equals_reference(scope):
    cfg, tcfg, params, tparams = model(scope=scope, sparsity=SPARSITY,
                                       quantize=True)
    pruned, _ = prune_params(params, cfg.sasp)
    tpruned, _ = t_pruning.prune_params(tparams, tcfg.sasp)
    mine = t_sasp.quantize_params(tpruned, tcfg.sasp)
    assert isinstance(mine["segments"][0]["slot0"]["ffn"]["w1"]["qw"],
                      QuantizedWeight)
    _assert_trees_equal(mine, quantize_params(pruned, cfg.sasp))
    # and through the bridge, as the parity tests hand trees over
    _assert_trees_equal(bridged(quantize_params(pruned, cfg.sasp)),
                        quantize_params(pruned, cfg.sasp))


def test_packing_int8_weights_matches_reference():
    """deploy_packed reads {qw} entries by dequantizing them, as the
    reference's does."""
    cfg, tcfg, params, tparams = model(scope="all", sparsity=SPARSITY,
                                       quantize=True)
    pruned, _ = prune_params(params, cfg.sasp)
    tpruned, _ = t_pruning.prune_params(tparams, tcfg.sasp)
    ref, rcfg = deploy_packed(quantize_params(pruned, cfg.sasp), cfg)
    mine, mcfg = t_deploy.deploy_packed(
        t_sasp.quantize_params(tpruned, tcfg.sasp), tcfg)
    _close(t_lm.forward(mine, mcfg, torch.as_tensor(TOKS)),
           lm.forward(ref, rcfg, jnp.asarray(TOKS)))


def _both(path, scope, int8):
    """(ref params, ref cfg, port params, port cfg) served along one path
    by each package's own launcher helper, from equal weights."""
    cfg, tcfg, params, tparams = model(scope=scope, sparsity=SPARSITY)
    kw = dict(path=path, sparsity=SPARSITY, int8_weights=int8,
              block_k=16, block_n=16, scope=scope, verbose=False)
    ref, rcfg = build_serving_params(params, cfg, **kw)
    mine, mcfg = t_serve.build_serving_params(tparams, tcfg, **kw)
    assert mcfg.sasp.path == rcfg.sasp.path
    return ref, rcfg, mine, mcfg


CASES = [(path, scope, int8) for path in ("bsr", "kernel")
         for scope in ("ffn", "all") for int8 in (False, True)] + \
    [("masked", "ffn", True)]


@pytest.mark.parametrize("path,scope,int8", CASES)
def test_paths_match_reference(path, scope, int8):
    ref, rcfg, mine, mcfg = _both(path, scope, int8)
    n0 = t_gemm.launches
    _close(t_lm.forward(mine, mcfg, torch.as_tensor(TOKS)),
           lm.forward(ref, rcfg, jnp.asarray(TOKS)))
    assert t_gemm.launches == n0             # CPU tensors: plain versions
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


def test_int8_bsr_close_to_fp32_masked():
    """int8 blocks stay within the reference's 5e-2 of the fp32 masked
    model."""
    _, _, mine, mcfg = _both("kernel", "all", True)
    _, _, masked, scfg = _both("masked", "all", False)
    got = t_lm.forward(mine, mcfg, torch.as_tensor(TOKS)).numpy()
    want = t_lm.forward(masked, scfg, torch.as_tensor(TOKS)).numpy()
    assert np.abs(got - want).max() / np.abs(want).max() < 5e-2


def _streams(eng_cls, req_cls, params, cfg, prompts):
    eng = eng_cls(params, cfg, batch_slots=2, cache_len=32)
    done = eng.run([req_cls(rid=i, prompt=p, max_new_tokens=5)
                    for i, p in enumerate(prompts)])
    return {r.rid: list(r.out_tokens) for r in done}


@pytest.mark.parametrize("path,scope,int8", [
    ("bsr", "all", False), ("kernel", "ffn", True), ("masked", "ffn", True)])
def test_engine_streams_equal_reference(path, scope, int8):
    ref, rcfg, mine, mcfg = _both(path, scope, int8)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 64, size=(n,)).astype(np.int32)
               for n in (6, 11, 4)]
    assert _streams(TEngine, TRequest, mine, mcfg, prompts) == \
        _streams(Engine, Request, ref, rcfg, prompts)


def test_launcher_refuses_masked_int8_scope_all(capsys):
    with pytest.raises(SystemExit, match="KeyError: 'w'"):
        t_serve.main(["--sasp", "0.5", "--path", "masked", "--int8-weights",
                      "--scope", "all", "--device", "cpu"])
    cfg, tcfg, _, tparams = model(scope="all", sparsity=SPARSITY)
    with pytest.raises(ValueError, match="not served"):
        t_serve.build_serving_params(tparams, tcfg, path="masked",
                                     sparsity=0.5, int8_weights=True,
                                     scope="all", verbose=False)
    # the new paths run end to end from the command line
    t_serve.main(["--sasp", "0.5", "--path", "kernel", "--scope", "all",
                  "--int8-weights", "--requests", "2", "--max-new", "3",
                  "--slots", "2", "--cache-len", "64", "--device", "cpu"])
    assert "2 requests, 6 tokens" in capsys.readouterr().out
