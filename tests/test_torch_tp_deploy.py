"""TP-sharded packing and the shard loop of the port against the
reference on the same weights: sharded containers (``pack_weight`` col /
row, ``deploy_packed`` fused and per-matrix, ``reshard_packed`` 1 -> 2 ->
1 and 2 -> 4; fp32 and int8) equal the reference's array for array
through ``bridge.to_numpy``; the shard-loop forward is within the
reference's 1e-5 of its meshless tp=2 forward; every decode step's logits
and the greedy streams of the port's ``Engine`` on a tp=2 tree equal the
reference ``Engine``'s with no mesh (contiguous and paged, the reduced
qwen3 of tests/dist_worker.py); the shard loop's attention runs once per
shard on that shard's heads, as a rank does; and a col shard's visit
groups come from the unsharded block grid (numpy)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import deploy as r_deploy  # noqa: E402
from repro.core.pruning import prune_params  # noqa: E402
from repro.models import lm as r_lm  # noqa: E402
from repro.serve.engine import Engine as REngine  # noqa: E402
from repro.serve.engine import Request as RRequest  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import deploy as t_deploy  # noqa: E402
from repro_torch.core import pruning as t_pruning  # noqa: E402
from repro_torch.kernels.sasp_gemm import gemm, schedule  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.models import lm as t_lm  # noqa: E402
from repro_torch.serve.engine import Engine as TEngine  # noqa: E402
from repro_torch.serve.engine import Request as TRequest  # noqa: E402
from test_torch_tp_mesh import record_decode_logits  # noqa: E402
from torch_parity import model, to_np  # noqa: E402

W_FIELDS = ("vals", "kn", "scale", "bias")
F_FIELDS = ("w1v", "w3v", "w2v", "b1", "b3", "b2", "s1", "s3", "s2", "jv")


def _assert_equal(mine, ref, path="tree"):
    """Port tree (through bridge.to_numpy) == reference tree, array for
    array, containers field for field (shards and kinds too)."""
    if isinstance(ref, dict):
        assert set(mine) == set(ref), (path, set(mine), set(ref))
        for k in ref:
            _assert_equal(mine[k], ref[k], f"{path}/{k}")
    elif isinstance(ref, (tuple, list)):
        assert len(mine) == len(ref), path
        for i, (a, b) in enumerate(zip(mine, ref)):
            _assert_equal(a, b, f"{path}/{i}")
    elif hasattr(ref, "vals") or hasattr(ref, "w1v"):
        weight = hasattr(ref, "vals")
        assert mine.shards == ref.shards, (path, mine.shards, ref.shards)
        if weight:
            assert (mine.shape, mine.block, mine.act, mine.shard_kind) == (
                tuple(ref.shape), tuple(ref.block), ref.act,
                ref.shard_kind), path
        for f in W_FIELDS if weight else F_FIELDS:
            a, b = getattr(mine, f), getattr(ref, f)
            if b is None:
                assert a is None, (path, f)
                continue
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape, (
                path, f, a.dtype, b.dtype, a.shape, b.shape)
            np.testing.assert_array_equal(a, b, err_msg=f"{path}.{f}")
    else:
        np.testing.assert_array_equal(np.asarray(mine), np.asarray(ref),
                                      err_msg=path)


@pytest.fixture(scope="module")
def pruned():
    """(ref cfg, port cfg, ref pruned tree, port pruned tree), 25% of the
    16x16 tiles of the reduced qwen3 (2 layers, d 64), scope all."""
    cfg, tcfg, params, tparams = model(scope="all", sparsity=0.25)
    return (cfg, tcfg, prune_params(params, cfg.sasp)[0],
            t_pruning.prune_params(tparams, tcfg.sasp)[0])


def _pack_case(pruned, kind, quantize, tp):
    cfg, _, rp, _ = pruned
    w = np.asarray(rp["segments"][0]["slot0"]["mixer"]["wo" if kind == "row"
                                                      else "wq"]["w"])
    kw = dict(block_k=16, block_n=16, quantize=quantize, tp=tp,
              shard_kind=kind)
    bias = np.linspace(-1, 1, w.shape[-1]).astype(np.float32)
    if kind == "col":
        kw.update(bias=np.broadcast_to(bias, w.shape[:1] + bias.shape),
                  act="silu")
    return (t_deploy.pack_weight(w, device="cpu", **kw),
            r_deploy.pack_weight(w, **kw))


def _deploy_case(pruned, fuse, quantize, steps):
    """Deploy at steps[0], then reshard through steps[1:], in both
    packages: (port segments, reference segments)."""
    cfg, tcfg, rp, tp_ = pruned
    r, _ = r_deploy.deploy_packed(rp, cfg, fuse_ffn=fuse, quantize=quantize,
                                  tp=steps[0])
    m, _ = t_deploy.deploy_packed(tp_, tcfg, fuse_ffn=fuse,
                                  quantize=quantize, tp=steps[0])
    for tp in steps[1:]:
        r = r_deploy.reshard_packed(r, cfg, tp=tp)
        m = t_deploy.reshard_packed(m, tcfg, tp=tp)
    return m["segments"], r["segments"]


CASES = {
    **{f"pack_weight-{k}-{'int8' if q else 'fp32'}":
       ("pack", k, q) for k in ("col", "row") for q in (False, True)},
    **{f"deploy-tp2-{'fused' if f else 'matrix'}-{'int8' if q else 'fp32'}":
       ("deploy", f, q, (2,)) for f in (True, False) for q in (False, True)},
    **{f"reshard-1-2-1-{'fused' if f else 'matrix'}-{'int8' if q else 'fp32'}":
       ("reshard", f, q, (1, 2, 1)) for f in (True, False)
       for q in (False, True)},
    "reshard-1-2-fused-fp32": ("reshard", True, False, (1, 2)),
    "reshard-2-4-fused-int8": ("reshard", True, True, (2, 4)),
    "reshard-2-4-matrix-fp32": ("reshard", False, False, (2, 4)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_containers_equal_reference(pruned, case):
    spec = CASES[case]
    if spec[0] == "pack":
        mine, ref = _pack_case(pruned, spec[1], spec[2], 2)
        assert ref.shards == 2
    else:
        mine, ref = _deploy_case(pruned, *spec[1:])
        if spec[0] == "reshard" and spec[3][-1] != 1:
            # a reshard equals the from-scratch deploy at the last tp
            _, scratch = _deploy_case(pruned, spec[1], spec[2],
                                      (spec[3][-1],))
            _assert_equal(bridge.to_numpy(mine), to_np(scratch))
        slot = ref[0]["slot0"]
        grp = slot["ffn"]["sasp_fused"] if spec[1] else \
            slot["ffn"]["sasp_packed"]["w1"]
        assert grp.shards == spec[3][-1]        # the sharding engaged
    _assert_equal(bridge.to_numpy(mine), to_np(ref))
    # and back through the bridge
    back = bridge.from_numpy(to_np(ref), device="cpu")
    _assert_equal(bridge.to_numpy(back), to_np(ref))


def test_summary_counts_one_matrix_per_sharded_container(pruned):
    cfg, tcfg, rp, tp_ = pruned
    r, _ = r_deploy.deploy_packed(rp, cfg, tp=2)
    m, _ = t_deploy.deploy_packed(tp_, tcfg, tp=2)
    assert t_deploy.packed_summary(m) == r_deploy.packed_summary(r)


@pytest.mark.parametrize("fuse", [True, False])
def test_shard_loop_forward_matches_reference(pruned, fuse):
    cfg, tcfg, rp, tp_ = pruned
    r, rcfg = r_deploy.deploy_packed(rp, cfg, fuse_ffn=fuse, tp=2)
    m, mcfg = t_deploy.deploy_packed(tp_, tcfg, fuse_ffn=fuse, tp=2)
    toks = np.arange(1, 9, dtype=np.int32)[None]
    want = np.asarray(r_lm.forward(r, rcfg, jnp.asarray(toks)))
    got = t_lm.forward(m, mcfg, torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# engines: the reduced qwen3 of tests/dist_worker.py (mode_packed_serve_mesh)
# ---------------------------------------------------------------------------

ENGINE_OPTS = {"contiguous": {}, "paged": dict(kv_pages=24, kv_page_len=8)}


@pytest.fixture(scope="module")
def worker_model():
    """(ref params, ref cfg, port params, port cfg) of the reference mesh
    worker's model (2 layers, d 64, vocab 128, 25% of the 8x8 tiles, scope
    all), deployed meshless at tp=2 by each package's launcher."""
    from repro.configs import get_config, reduced
    from repro.launch.serve import build_serving_params
    from repro_torch.configs import get_config as t_get_config
    from repro_torch.configs import reduced as t_reduced
    cfg0 = reduced(get_config("qwen3-32b"), layers=2, d_model=64, vocab=128)
    params0 = r_lm.init_params(jax.random.PRNGKey(0), cfg0)
    deploy = dict(path="packed", sparsity=0.25, block_k=8, block_n=8,
                  scope="all", verbose=False)
    rp, rcfg = build_serving_params(params0, cfg0, **deploy)
    rp = r_deploy.reshard_packed(rp, rcfg, tp=2)
    tcfg0 = t_reduced(t_get_config("qwen3-32b"), layers=2, d_model=64,
                      vocab=128)
    mp, mcfg = t_serve.build_serving_params(
        bridge.from_numpy(to_np(params0), device="cpu"), tcfg0, tp=2,
        **deploy)
    assert mp["segments"][0]["slot0"]["ffn"]["sasp_fused"].shards == 2
    return rp, rcfg, mp, mcfg


def _requests(cls):
    rng = np.random.default_rng(0)
    return [cls(rid=i, prompt=rng.integers(0, 128, size=(8 + 7 * i,))
                .astype(np.int32), max_new_tokens=6) for i in range(3)]


@pytest.mark.parametrize("kv", list(ENGINE_OPTS))
def test_shard_loop_engine_equals_reference_engine(worker_model, kv,
                                                   monkeypatch):
    """Every decode step's logits within 1e-5 of the logit scale and
    equal greedy streams. The streams repeat one token, so the logits
    carry the comparison."""
    rp, rcfg, mp, mcfg = worker_model
    ref_steps = []
    decode = r_lm.decode_step

    def recorded(params, cfg, *a):
        logits, caches = decode(params, cfg, *a)
        jax.debug.callback(lambda lg: ref_steps.append(np.asarray(lg)),
                           logits[:, 0], ordered=True)
        return logits, caches

    monkeypatch.setattr(r_lm, "decode_step", recorded)
    want = REngine(rp, rcfg, batch_slots=2, cache_len=64,
                   **ENGINE_OPTS[kv]).run(_requests(RRequest))
    eng = TEngine(mp, mcfg, batch_slots=2, cache_len=64, **ENGINE_OPTS[kv])
    steps = record_decode_logits(eng)
    got = eng.run(_requests(TRequest))
    assert {r.rid: list(map(int, r.out_tokens)) for r in got} == \
        {r.rid: list(map(int, r.out_tokens)) for r in want}
    assert len(steps) == len(ref_steps) > 0
    scale = max(float(np.abs(s).max()) for s in ref_steps)
    for a, b in zip(steps, ref_steps):
        assert float(np.abs(a.numpy() - b).max()) <= 1e-5 * scale


def test_shard_loop_attention_runs_each_shards_heads_alone(worker_model,
                                                          monkeypatch):
    """The shard loop (every TP shard held, no mesh) runs attention's
    score products once per shard, on that shard's KV heads alone and
    contiguous: the calls a mesh rank makes, so the loop and the mesh
    give the same bits (on the card a batched fp32 product over half the
    heads differs from the same heads inside the whole call)."""
    _, _, mp, mcfg = worker_model
    calls = []
    einsum = torch.einsum

    def recorded(eq, *ops):
        if eq in ("bkgd,bckd->bkgc", "bqkgd,bskd->bkgqs"):
            heads = ops[0].shape[1 if eq.startswith("bkgd") else 2]
            calls.append((eq, heads, ops[0].is_contiguous()))
        return einsum(eq, *ops)

    monkeypatch.setattr(torch, "einsum", recorded)
    TEngine(mp, mcfg, batch_slots=2, cache_len=64).run(
        _requests(TRequest)[:2])
    kinds = {eq for eq, _, _ in calls}
    assert kinds == {"bkgd,bckd->bkgc", "bqkgd,bskd->bkgqs"}
    assert all(h == mcfg.num_kv_heads // 2 and c for _, h, c in calls)
    assert len(calls) % 2 == 0


# ---------------------------------------------------------------------------
# the visit groups of a col shard (kernels/sasp_gemm/schedule.py)
# ---------------------------------------------------------------------------


def _grouped_sum(x, vals, kn, col_ptr, KB, G):
    """The tile-skip kernel's order of sums, in fp32 numpy: each column
    sums the visits of each k-block group in list order, then the groups
    in group order (csrc/sasp_gemm.cu, tile::reduce_groups)."""
    M = x.shape[0]
    bk, bn = vals.shape[1:]
    NB = col_ptr.shape[0] - 1
    spans = schedule.group_spans(kn[0], col_ptr, KB, G)
    out = np.zeros((M, NB * bn), np.float32)
    for n in range(NB):
        total = np.zeros((M, bn), np.float32)
        for g in range(G):
            acc = np.zeros((M, bn), np.float32)
            for v in range(spans[n, g], spans[n, g + 1]):
                k = kn[0, v]
                acc = acc + x[:, k * bk:(k + 1) * bk] @ vals[v]
            total = total + acc
        out[:, n * bn:(n + 1) * bn] = total
    return out


def test_col_shard_visit_groups_come_from_the_unsharded_grid():
    # qwen3-32b's wq: a tp=2 col shard's own grid would give other groups
    assert schedule.gemm_groups(160, 256) == 5
    assert schedule.gemm_groups(160, 128) == 9
    rng = np.random.default_rng(3)
    KB, NB, b, tp = 160, 256, 1, 2          # wq's block grid, 1x1 blocks
    w = rng.standard_normal((KB * b, NB * b)).astype(np.float32)
    keep = rng.random((KB, NB)) > 0.5
    w = w * np.kron(keep, np.ones((b, b), np.float32))
    x = rng.standard_normal((2, KB * b)).astype(np.float32)
    full = t_deploy.pack_weight(w, block_k=b, block_n=b, device="cpu")
    shards = t_deploy.pack_weight(w, block_k=b, block_n=b, tp=tp,
                                  shard_kind="col", device="cpu")
    G = schedule.gemm_groups(KB, NB)
    assert G != schedule.gemm_groups(KB, NB // tp) and G > 1
    # the wrapper plans a shard's groups from the whole grid when told it
    assert gemm._plan(torch.bfloat16, torch.bfloat16, KB * b, NB, b, b,
                      None)[2] == G
    want = _grouped_sum(x, full.vals.numpy(), full.kn.numpy(),
                        full.col_ptr.numpy(), KB, G)
    ns = NB * b // tp
    for s in range(tp):
        loc = shards.shard(s)
        got = _grouped_sum(x, loc.vals.numpy(), loc.kn.numpy(),
                           loc.col_ptr.numpy(), KB, G)
        np.testing.assert_array_equal(got, want[:, s * ns:(s + 1) * ns])
        # the shard's own grid would split its columns' sums otherwise
        own = _grouped_sum(x, loc.vals.numpy(), loc.kn.numpy(),
                           loc.col_ptr.numpy(), KB,
                           schedule.gemm_groups(KB, NB // tp))
        assert not np.array_equal(own, want[:, s * ns:(s + 1) * ns])
