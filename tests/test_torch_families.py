"""The port's MoE, SSM and hybrid stacks and the stub-frontend models
against the reference on the same weights (reduced configs, fp32):

* forward, prefill and decode logits within 1e-4 on the dense, masked,
  bsr, kernel and packed paths (scope all) for granite-moe, moonshot
  (8 experts, top 6), mamba2 and jamba; the port's decode against its
  own forward within the reference's bounds (tests/test_models.py);
* ``loss_fn`` (the MoE aux loss included) within 1e-5 and every gradient
  within 1e-4 of its leaf's scale, under a scope-all SASP overlay;
* greedy ``Engine`` streams equal the reference engine's: contiguous,
  with keep-KV preemption both ways, and for MoE paged, shared and
  speculated;
* chameleon and musicgen forwards and losses with ``embeds``;
* what the SASP machinery does with these trees: global tile-L1 over
  4-D expert stacks, BSR overlays leaving them masked, packing only a
  hybrid stack's attention and dense FFN, mamba2's empty FFN (which the
  reference cannot prune) left out; the bridge and checkpoints of a
  jamba tree crossing the packages both ways;
* both launchers run the six architectures on the CPU.

The reference cannot prune or pack mamba2 (its d_ff = 0 FFN divides by
zero in ``find_prunable`` and the packer), so its side of mamba2's
pruned paths is built on the tree without that FFN, which holds no
weights, and the FFN is put back."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config, reduced  # noqa: E402
from repro.core import pruning as r_pruning  # noqa: E402
from repro.core import sasp as r_sasp  # noqa: E402
from repro.launch.serve import build_serving_params  # noqa: E402
from repro.models import lm  # noqa: E402
from repro.serve.engine import Engine, Request  # noqa: E402
from repro.train.checkpoint import CheckpointManager as RManager  # noqa
from repro.train.checkpoint import _flatten_with_names  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import SASPConfig as TSASPConfig  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.core import deploy as t_deploy  # noqa: E402
from repro_torch.core import pruning as t_pruning  # noqa: E402
from repro_torch.core import sasp as t_sasp  # noqa: E402
from repro_torch.core.sparse import PackedFFN, PackedSASPWeight  # noqa
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.launch import train as t_train  # noqa: E402
from repro_torch.models import lm as t_lm  # noqa: E402
from repro_torch.serve.engine import Engine as TEngine  # noqa: E402
from repro_torch.serve.engine import Request as TRequest  # noqa: E402
from repro_torch.train import train_step as t_step  # noqa: E402
from repro_torch.train.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.train.checkpoint import named_leaves  # noqa: E402
from torch_parity import (KEY, assert_leaves_close, bridged,  # noqa: E402
                          mask_key, to_np)

ARCHS = ["granite-moe-1b-a400m", "moonshot-v1-16b-a3b", "mamba2-780m",
         "jamba-1.5-large-398b"]
FRONTENDS = ["chameleon-34b", "musicgen-medium"]
VOCAB = 128
SPARSITY = 0.25
BLOCK = 16
TOKS = np.random.default_rng(0).integers(0, VOCAB, (2, 12)).astype(np.int32)


def _close(got, ref, tol=1e-4):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=tol, atol=tol)


def _cfgs(arch, layers=4):
    """(reference cfg, port cfg); moonshot keeps its top-6 routing over 8
    experts (``reduced`` would make it granite's 4 experts, top 2)."""
    out = []
    for get, red in ((get_config, reduced), (t_get_config, t_reduced)):
        cfg = red(get(arch), layers=layers, d_model=64, vocab=VOCAB)
        if arch == "moonshot-v1-16b-a3b":
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, num_experts=8, top_k=6))
        out.append(cfg)
    return tuple(out)


def _model(arch, scale=1.0, layers=4):
    """(ref cfg, port cfg, ref params, port params), equal weights;
    ``scale`` multiplies every weight (position-dependent greedy
    streams, as tests/test_scheduler.py does)."""
    cfg, tcfg = _cfgs(arch, layers)
    params = lm.init_params(KEY, cfg)
    if scale != 1.0:
        params = jax.tree.map(lambda a: a * scale, params)
    return cfg, tcfg, params, bridged(params)


def _split_empty_ffn(params):
    """(params without mamba2's empty FFN, a function putting it back)."""
    empty = {(i, n): s["ffn"] for i, seg in enumerate(params["segments"])
             for n, s in seg.items() if s["ffn"]["w1"]["w"].shape[-1] == 0}
    if not empty:
        return params, lambda p: p

    def strip(p, put=None):
        segs = []
        for i, seg in enumerate(p["segments"]):
            new = {}
            for n, s in seg.items():
                s = dict(s)
                if (i, n) in empty:
                    if put:
                        s["ffn"] = empty[(i, n)]
                    else:
                        s.pop("ffn")
                new[n] = s
            segs.append(new)
        return {**p, "segments": tuple(segs)}

    return strip(params), lambda p: strip(p, put=True)


def _ref_serving(params, cfg, path):
    bare, put_back = _split_empty_ffn(params)
    out, rcfg = build_serving_params(
        bare, cfg, path=path, sparsity=SPARSITY, block_k=BLOCK,
        block_n=BLOCK, scope="all", verbose=False)
    return put_back(out), rcfg


def _port_serving(tparams, tcfg, path):
    return t_serve.build_serving_params(
        tparams, tcfg, path=path, sparsity=SPARSITY, block_k=BLOCK,
        block_n=BLOCK, scope="all", verbose=False)


# ---------------------------------------------------------------------------
# the model along every serving path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("path", ["dense", "masked", "bsr", "kernel",
                                  "packed"])
@pytest.mark.parametrize("arch", ARCHS)
def test_paths_match_reference(arch, path):
    cfg, tcfg, params, tparams = _model(arch, layers=2)
    ref, rcfg = _ref_serving(params, cfg, path)
    mine, mcfg = _port_serving(tparams, tcfg, path)
    _close(t_lm.forward(mine, mcfg, torch.as_tensor(TOKS)),
           lm.forward(ref, rcfg, jnp.asarray(TOKS)))
    lg0, c0 = lm.prefill(ref, rcfg, jnp.asarray(TOKS[:, :8]), cache_len=16)
    lg1, c1 = t_lm.prefill(mine, mcfg, torch.as_tensor(TOKS[:, :8]),
                           cache_len=16)
    _close(lg1, lg0)
    for t in (8, 9):
        tok = TOKS[:, t:t + 1]
        lg0, c0 = lm.decode_step(ref, rcfg, jnp.asarray(tok),
                                 jnp.full((2,), t, jnp.int32), c0)
        lg1, c1 = t_lm.decode_step(mine, mcfg, torch.as_tensor(tok),
                                   torch.full((2,), t, dtype=torch.int32),
                                   c1)
        _close(lg1, lg0)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """The reference's tests/test_models.py check on the port: prefill 16
    tokens, decode 8, against the full forward (fp32: 5e-3; MoE 2.5e-2,
    since capacity drops depend on how many tokens are routed)."""
    _, tcfg, _, tparams = _model(arch)
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, VOCAB, (2, 24)).astype(np.int32))
    full = t_lm.forward(tparams, tcfg, toks)
    logits, caches = t_lm.prefill(tparams, tcfg, toks[:, :16], cache_len=24)
    errs = [float((logits[:, 0] - full[:, 15]).abs().max())]
    for t in range(16, 24):
        logits, caches = t_lm.decode_step(
            tparams, tcfg, toks[:, t:t + 1],
            torch.full((2,), t, dtype=torch.int32), caches)
        errs.append(float((logits[:, 0] - full[:, t]).abs().max()))
    assert max(errs) < (2.5e-2 if tcfg.moe is not None else 5e-3), errs


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(arch):
    cfg, tcfg, params, tparams = _model(arch)
    kw = dict(enabled=True, block_k=BLOCK, block_n=BLOCK,
              sparsity=SPARSITY, scope="all")
    cfg = dataclasses.replace(cfg, sasp=dataclasses.replace(cfg.sasp, **kw))
    tcfg = dataclasses.replace(tcfg, sasp=TSASPConfig(**kw))
    ov, _ = r_sasp.build_sasp_overlay(_split_empty_ffn(params)[0], cfg.sasp)
    tov, _ = t_sasp.build_sasp_overlay(tparams, tcfg.sasp)
    want = {n: np.asarray(m) for n, m in _flatten_with_names(ov)}
    assert {n: m.numpy() for n, m in named_leaves(tov)}.keys() == \
        want.keys()
    toks = np.random.default_rng(2).integers(0, VOCAB, (2, 32)).astype(
        np.int32)
    rb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.as_tensor(toks)}

    def ref_loss(p):
        return lm.loss_fn(r_sasp.merge_overlay(p, ov), cfg, rb)

    (wl, wm), wg = jax.value_and_grad(ref_loss, has_aux=True)(params)
    loss, metrics, grads = t_step.value_and_grad(tcfg, tparams, tb, tov)
    np.testing.assert_allclose(float(loss), float(wl), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["aux"]), float(wm["aux"]),
                               rtol=1e-5)
    assert (float(metrics["aux"]) > 0) == (cfg.moe is not None)
    assert_leaves_close(grads, wg, 1e-4)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

PROMPTS = [np.random.default_rng(3).integers(0, VOCAB, (n,)).astype(np.int32)
           for n in (7, 10, 7)]
PAGED = dict(kv_pages=24, kv_page_len=16)


def _run(eng, req_cls, preempt):
    reqs = [req_cls(rid=i, prompt=p.copy(), max_new_tokens=6)
            for i, p in enumerate(PROMPTS)]
    for r in reqs:
        eng.submit(r)
    done = []
    for _ in range(3):
        done += eng.step()
    if preempt is not None:
        slot = next(i for i, r in enumerate(eng.slot_req) if r is not None)
        eng.queue.insert(0, eng.preempt_slot(slot, keep_kv=preempt))
    while len(done) < len(reqs):
        done += eng.step()
    return {r.rid: [int(t) for t in r.out_tokens] for r in done}, eng


ENGINE_CASES = (
    [(a, m) for a in ARCHS for m in ("contiguous", "keep", "drop")]
    + [("granite-moe-1b-a400m", "paged"),
       ("moonshot-v1-16b-a3b", "paged-share-draft")])


@pytest.mark.parametrize("arch,mode", ENGINE_CASES)
def test_engine_streams_equal_reference(arch, mode):
    cfg, tcfg, params, tparams = _model(arch, scale=3.0, layers=2)
    kw = dict(batch_slots=2, cache_len=32)
    if mode.startswith("paged"):
        kw.update(PAGED)
    if mode == "paged-share-draft":
        kw.update(kv_share=True, draft_sparsity=0.75, draft_k=2)
        params, cfg = _ref_serving(params, cfg, "packed")
        tparams, tcfg = _port_serving(tparams, tcfg, "packed")
    preempt = {"keep": True, "drop": False}.get(mode)
    want, _ = _run(Engine(params, cfg, **kw), Request, preempt)
    got, eng = _run(TEngine(tparams, tcfg, **kw), TRequest, preempt)
    assert got == want
    assert eng.stats["preemptions"] == (preempt is not None)
    assert len({tuple(s) for s in got.values()}) > 1


def test_paged_pool_refuses_ssm_stacks():
    for arch in ("mamba2-780m", "jamba-1.5-large-398b"):
        _, tcfg, _, tparams = _model(arch, layers=2)
        with pytest.raises(ValueError, match="attention-only"):
            TEngine(tparams, tcfg, batch_slots=2, cache_len=32, **PAGED)


# ---------------------------------------------------------------------------
# stub frontends
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", FRONTENDS)
def test_frontend_embeds_match_reference(arch):
    cfg, tcfg, params, tparams = _model(arch, layers=2)
    emb = np.random.default_rng(4).normal(size=(2, 12, 64)).astype(
        np.float32)
    _close(t_lm.forward(tparams, tcfg, torch.as_tensor(TOKS),
                        embeds=torch.as_tensor(emb)),
           lm.forward(params, cfg, jnp.asarray(TOKS),
                      embeds=jnp.asarray(emb)))
    want, _ = lm.loss_fn(params, cfg, {"tokens": jnp.asarray(TOKS),
                                       "embeds": jnp.asarray(emb)})
    got, _ = t_lm.loss_fn(tparams, tcfg, {"tokens": torch.as_tensor(TOKS),
                                          "embeds": torch.as_tensor(emb)})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


# ---------------------------------------------------------------------------
# SASP machinery, bridge, checkpoints
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "mamba2-780m",
                                  "jamba-1.5-large-398b"])
def test_masks_and_overlays_match_reference(arch):
    cfg, tcfg, params, tparams = _model(arch)
    kw = dict(enabled=True, block_k=BLOCK, block_n=BLOCK,
              sparsity=SPARSITY, scope="all")
    sasp = dataclasses.replace(cfg.sasp, **kw)
    tsasp = TSASPConfig(**kw)
    bare, _ = _split_empty_ffn(params)
    if bare is not params:          # the reference divides by d_ff = 0
        with pytest.raises(ZeroDivisionError):
            r_pruning.compute_sasp_masks(params, sasp)
    masks = r_pruning.compute_sasp_masks(bare, sasp)
    tmasks = t_pruning.compute_sasp_masks(tparams, tsasp)
    assert {mask_key(p) for p in masks} == set(tmasks)
    for p, m in masks.items():
        np.testing.assert_array_equal(tmasks[mask_key(p)].numpy(),
                                      np.asarray(m))
    ndims = {len(m.shape) for m in tmasks.values()}
    assert (4 in ndims) == (cfg.moe is not None)   # (L, E, KB, NB) stacks
    assert not any("router" in p for p in tmasks)
    pruned, _ = t_pruning.prune_params(tparams, tsasp)
    ov = t_sasp.bsr_overlay_from_masks(pruned, tmasks, tsasp)
    ref_ov = r_sasp.bsr_overlay_from_masks(
        r_pruning.prune_params(bare, sasp)[0], masks, sasp)
    assert set(_containers(ov)) == set(_containers(ref_ov))
    # expert stacks stay on the masked path: no BSR under a MoE FFN
    for i, seg in enumerate(tparams["segments"]):
        for name, slot in seg.items():
            if "router" in slot["ffn"]:
                assert "ffn" not in ov["segments"][str(i)].get(name, {})


def _containers(tree, path=()):
    """Paths of an overlay's leaves, a container counting as one leaf."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _containers(v, path + (str(k),))
    elif isinstance(tree, (tuple, list)) and not hasattr(tree, "idx"):
        for i, v in enumerate(tree):
            yield from _containers(v, path + (str(i),))
    else:
        yield "/".join(path)


def test_deploy_packs_only_attention_and_dense_ffns():
    """Packed jamba: attention projections and dense FFNs get containers,
    MoE expert grids and the SSM projections stay masked-dense (as the
    reference deploys them)."""
    cfg, tcfg, params, tparams = _model("jamba-1.5-large-398b")
    ref, _ = _ref_serving(params, cfg, "packed")
    mine, mcfg = _port_serving(tparams, tcfg, "packed")
    assert mcfg.sasp.path == "kernel"
    for seg, rseg in zip(mine["segments"], ref["segments"]):
        for name, slot in seg.items():
            rslot = rseg[name]
            assert set(slot["mixer"]) == set(rslot["mixer"]), name
            assert set(slot["ffn"]) == set(rslot["ffn"]), name
            if "wq" in slot["mixer"]:
                assert isinstance(slot["mixer"]["sasp_packed"]["wq"],
                                  PackedSASPWeight)
            else:
                assert "sasp_packed" not in slot["mixer"]
            if "router" in slot["ffn"]:
                assert "sasp_fused" not in slot["ffn"]
            else:
                assert isinstance(slot["ffn"]["sasp_fused"], PackedFFN)
    s = t_deploy.packed_summary(mine)
    # slots 0 and 2 hold the dense FFNs, slot 3 the attention
    assert s["n_fused_ffns"] == 2 and s["n_packed_matrices"] == 4


def test_bridge_round_trips_moe_and_ssm_trees():
    for arch in ("granite-moe-1b-a400m", "jamba-1.5-large-398b"):
        _, _, params, tparams = _model(arch, layers=2)
        back = bridge.to_numpy(tparams)
        want = dict(_flatten_with_names(to_np(params)))
        got = dict(_flatten_with_names(back))
        assert got.keys() == want.keys()
        for n, a in want.items():
            assert got[n].dtype == a.dtype and got[n].shape == a.shape, n
            np.testing.assert_array_equal(got[n], a)


def test_jamba_checkpoint_crosses_packages(tmp_path):
    cfg, tcfg, params, tparams = _model("jamba-1.5-large-398b")
    RManager(str(tmp_path / "ref")).save(3, {"params": params})
    restored, _ = CheckpointManager(str(tmp_path / "ref")).restore(
        {"params": t_lm.init_params(tcfg, seed=1, device="cpu")})
    for (n, t), (m, a) in zip(named_leaves(restored),
                              _flatten_with_names({"params": params})):
        assert n == m
        np.testing.assert_array_equal(t.numpy(), np.asarray(a))
    CheckpointManager(str(tmp_path / "port")).save(5, {"params": tparams})
    back, _ = RManager(str(tmp_path / "port")).restore(
        jax.eval_shape(lambda: {"params": params}))
    for (n, a), (m, b) in zip(_flatten_with_names(back),
                              _flatten_with_names({"params": params})):
        assert n == m
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("arch", ARCHS + FRONTENDS)
def test_port_init_params_layout(arch):
    """The port's own initialiser builds the reference's leaves, shapes
    and types."""
    cfg, tcfg = _cfgs(arch, layers=2)
    want = {n: (np.asarray(a).shape, np.asarray(a).dtype.name) for n, a in
            _flatten_with_names(lm.init_params(KEY, cfg))}
    got = {n: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
           for n, t in named_leaves(t_lm.init_params(tcfg, device="cpu"))}
    assert got == want


# ---------------------------------------------------------------------------
# launchers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS + FRONTENDS)
def test_launchers_run_every_architecture(arch, tmp_path, capsys):
    t_serve.main(["--arch", arch, "--sasp", "0.5", "--path", "packed",
                  "--scope", "all", "--requests", "2", "--slots", "2",
                  "--max-new", "2", "--cache-len", "64", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "req 1:" in out, out
    t_train.main(["--arch", arch, "--reduce", "--steps", "2", "--batch",
                  "2", "--seq", "16", "--device", "cpu", "--ckpt-dir",
                  str(tmp_path / "ckpt")])
    assert "done" in capsys.readouterr().out
    # every architecture parses on a mesh; MoE and SSM layers build a
    # rank's slice (experts' d_ff and SSM heads over 'model')
    args = t_serve.parse_args(["--arch", arch, "--mesh", "1,2"])
    spec = t_serve.mesh_spec(args)
    assert spec["mesh"] == (1, 2)
    if arch in FRONTENDS:
        return
    with torch.no_grad():
        params, cfg, lcfg, _ = t_serve.build_rank_params(
            spec["cfg"], tp=2, rank=1, device="cpu", **spec["build"])
    assert cfg.tp_shards == 2
    slots = [sl for seg in params["segments"] for sl in seg.values()]
    if cfg.moe is not None:
        w1 = next(sl["ffn"]["w1"]["w"] for sl in slots
                  if "router" in sl["ffn"])
        assert w1.shape[-3:] == (cfg.moe.num_experts, cfg.d_model,
                                 cfg.d_ff // 2)
    if cfg.ssm is not None:
        assert lcfg.ssm.head_shards == 2
        mx = next(sl["mixer"] for sl in slots if "in_z" in sl["mixer"])
        assert mx["in_z"]["w"].shape[-1] == cfg.ssm.d_inner(
            cfg.d_model) // 2
