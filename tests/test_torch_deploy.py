"""Pruning and packed deployment of the port against the reference, on
the same weights: the global tile-L1 masks are equal, and every packed
container equals the reference's ``deploy_packed`` output array for
array (fp32 and int8, fused and per-matrix FFN, scope ffn and all). The
port's extra ``col_ptr`` is checked against the visit lists it is
derived from."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.deploy import deploy_packed, packed_summary  # noqa: E402
from repro.core.pruning import prune_params  # noqa: E402
from repro_torch.core import deploy as t_deploy  # noqa: E402
from repro_torch.core import pruning as t_pruning  # noqa: E402
from repro_torch.core.sparse import PackedFFN, PackedSASPWeight  # noqa: E402
from torch_parity import mask_key, model, to_np  # noqa: E402

W_FIELDS = ("vals", "kn", "scale", "bias")
F_FIELDS = ("w1v", "w3v", "w2v", "b1", "b3", "b2", "s1", "s3", "s2", "jv")


def _eq(a, b, what):
    if b is None:
        assert a is None, what
        return
    a = a.numpy()
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype,
                                                       b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=what)


def _check_weight(mine, ref, what):
    assert isinstance(mine, PackedSASPWeight), what
    assert mine.shape == tuple(ref.shape) and mine.block == tuple(ref.block)
    assert mine.act == ref.act and mine.shards == ref.shards == 1
    for f in W_FIELDS:
        _eq(getattr(mine, f), getattr(ref, f), f"{what}.{f}")
    # col_ptr[n] is the first visit of column-block n
    kn = mine.kn.numpy()
    cp = mine.col_ptr.numpy()
    for layer in range(kn.shape[0]):
        ns = kn[layer, 1]
        assert cp[layer, 0] == 0 and cp[layer, -1] == ns.size
        for n in range(cp.shape[1] - 1):
            assert (ns[cp[layer, n]:cp[layer, n + 1]] == n).all()


def _check_ffn(mine, ref, what):
    assert isinstance(mine, PackedFFN), what
    assert (mine.d_model, mine.d_ff, mine.block_f, mine.act) == (
        ref.d_model, ref.d_ff, ref.block_f, ref.act)
    for f in F_FIELDS:
        _eq(getattr(mine, f), getattr(ref, f), f"{what}.{f}")


def test_prune_masks_equal_reference():
    cfg, tcfg, params, tparams = model(scope="all", sparsity=0.5)
    _, masks = prune_params(params, cfg.sasp)
    _, tmasks = t_pruning.prune_params(tparams, tcfg.sasp)
    assert list(tmasks) == [mask_key(p) for p in masks]
    for p, m in masks.items():
        np.testing.assert_array_equal(tmasks[mask_key(p)].numpy(),
                                      np.asarray(m))


@pytest.mark.parametrize("scope", ["ffn", "all"])
@pytest.mark.parametrize("fuse_ffn", [True, False])
@pytest.mark.parametrize("quantize", [False, True])
def test_containers_equal_reference(scope, fuse_ffn, quantize):
    cfg, tcfg, params, tparams = model(scope=scope, sparsity=0.25)
    pruned, _ = prune_params(params, cfg.sasp)
    tpruned, _ = t_pruning.prune_params(tparams, tcfg.sasp)
    ref, rcfg = deploy_packed(pruned, cfg, quantize=quantize,
                              fuse_ffn=fuse_ffn)
    mine, mcfg = t_deploy.deploy_packed(tpruned, tcfg, quantize=quantize,
                                        fuse_ffn=fuse_ffn)
    assert mcfg.sasp.path == rcfg.sasp.path == "kernel"
    ref = to_np(ref)
    for si, (rseg, mseg) in enumerate(zip(ref["segments"],
                                          mine["segments"])):
        for slot in rseg:
            rs, ms = rseg[slot], mseg[slot]
            assert set(rs["ffn"]) == set(ms["ffn"])
            assert set(rs["mixer"]) == set(ms["mixer"])
            for k in ("w1", "w2", "w3"):
                _eq(ms["ffn"][k]["w"], rs["ffn"][k]["w"], f"{slot}.{k}")
            if fuse_ffn:
                _check_ffn(ms["ffn"]["sasp_fused"], rs["ffn"]["sasp_fused"],
                           f"seg{si}.{slot}.ffn")
            else:
                for k, pw in rs["ffn"]["sasp_packed"].items():
                    _check_weight(ms["ffn"]["sasp_packed"][k], pw,
                                  f"seg{si}.{slot}.ffn.{k}")
            if scope == "all":
                for k, pw in rs["mixer"]["sasp_packed"].items():
                    _check_weight(ms["mixer"]["sasp_packed"][k], pw,
                                  f"seg{si}.{slot}.mixer.{k}")


def test_summary_strip_and_cast():
    cfg, tcfg, params, tparams = model(scope="all", sparsity=0.5)
    pruned, _ = prune_params(params, cfg.sasp)
    tpruned, _ = t_pruning.prune_params(tparams, tcfg.sasp)
    ref = packed_summary(deploy_packed(pruned, cfg)[0])
    pp, _ = t_deploy.deploy_packed(tpruned, tcfg)
    assert t_deploy.packed_summary(pp) == ref
    stripped = t_deploy.strip_packed(pp)
    slot = stripped["segments"][0]["slot0"]
    assert "sasp_fused" not in slot["ffn"]
    assert "sasp_packed" not in slot["mixer"]
    cast = t_deploy.cast_packed_values(pp, torch.bfloat16)
    c = cast["segments"][0]["slot0"]
    assert c["ffn"]["sasp_fused"].w1v.dtype == torch.bfloat16
    assert c["mixer"]["sasp_packed"]["wq"].vals.dtype == torch.bfloat16
    assert c["ffn"]["sasp_fused"].b1.dtype == torch.float32


def test_tp_is_not_ported():
    """A sharded container does not run through the single-device entry
    points (only through the TP paths of models/ffn.py); an engine on a
    mesh takes a prebuilt drafter (a rank's tree holds no dense masters
    to re-prune) and serves with it: on a one-process mesh, the streams
    and speculation counters of the meshless engine that builds its
    own."""
    from repro_torch.distribution.context import Mesh
    from repro_torch.distribution.sharding import local_config, local_params
    from repro_torch.serve.engine import Engine, Request
    cfg, tcfg, params, tparams = model(scope="all", sparsity=0.25)
    tpruned, _ = t_pruning.prune_params(tparams, tcfg.sasp)
    pp, pcfg = t_deploy.deploy_packed(tpruned, tcfg, tp=2)
    slot = pp["segments"][0]["slot0"]
    x = torch.zeros((1, tcfg.d_model))
    with pytest.raises(ValueError, match="shard by shard"):
        t_deploy.packed_matmul(x, slot["mixer"]["sasp_packed"]["wq"])
    with pytest.raises(ValueError, match="shard by shard"):
        t_deploy.packed_ffn_apply(x, slot["ffn"]["sasp_fused"])
    mesh = Mesh({"data": 1, "model": 2}, 0, "gloo", torch.device("cpu"))
    with pytest.raises(ValueError, match="prebuilt"):
        Engine(pp, pcfg, cache_len=64, kv_pages=16, kv_page_len=16,
               draft_sparsity=0.75, mesh=mesh)
    p1, c1 = t_deploy.deploy_packed(tpruned, tcfg)
    d1, dc1 = t_deploy.draft_pack(p1, c1, sparsity=0.75, tp=1)
    one = Mesh({"data": 1, "model": 1}, 0, "gloo", torch.device("cpu"))
    kw = dict(batch_slots=2, cache_len=64, kv_pages=16, kv_page_len=16,
              draft_sparsity=0.75, draft_k=2)
    runs = []
    for eng in (Engine(p1, c1, **kw),
                Engine(local_params(p1, c1, 1, 0), local_config(c1, 1),
                       mesh=one, draft=(local_params(d1, dc1, 1, 0),
                                        local_config(dc1, 1)), **kw)):
        rng = np.random.default_rng(0)
        done = eng.run([Request(rid=i, prompt=rng.integers(
            0, tcfg.vocab_size, size=(5 + 4 * i,)).astype(np.int32),
            max_new_tokens=6) for i in range(3)])
        runs.append(({r.rid: r.out_tokens for r in done},
                     {k: eng.stats[k] for k in ("spec_rounds",
                                                "spec_accepted_tokens")}))
    assert runs[0] == runs[1] and runs[0][1]["spec_rounds"] > 0
