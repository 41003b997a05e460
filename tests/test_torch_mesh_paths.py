"""Every serving path of the dense decoder on a 2-process gloo mesh (CPU):
dense (``--sasp 0``), masked, masked int8 (scope ffn), bsr and kernel
under TP, and the self-speculation drafter sharded like its packed
target. The reduced qwen3 of tests/dist_worker.py (2 layers, d 64, vocab
128, 8x8 tiles, 25%), its weights drawn by the reference's
``init_params`` and bridged through numpy. Held here:

* a rank's leaves on the dense, masked, masked int8 and bsr trees at tp 2
  and 4: the slice the reference's ``spec_for_param`` names; a rank's
  tree built layer by layer on every path, at tp 1, 2 and 4, equal to
  its slice of the whole build;
* ``_bsr_mm_sharded`` on the mesh (bsr and kernel; the kernel's plain
  version on the CPU) bit for bit the meshless product; the dense FFN on
  the mesh within 1e-5 of the meshless one; ``_ffn_tp_rs_ag_int8``
  within the reference's 2e-2 of the reference's meshless ``ffn_apply``;
* every path, contiguous and paged: every rank's streams and decode
  logits bit for bit the port's tp=2 shard loop, the streams equal to
  the reference's meshless engine and the logits within 1e-4;
* the drafter: a rank's tree from ``build_rank_params`` equal to
  ``local_params(draft_pack(target, tp=tp))`` at tp 1, 2 and 4, ``draft_pack`` at tp 1
  equal to the reference's, its selection's scores the pruned tree's;
  fp and int8 drafters on the mesh serving the reference's streams with
  a drafter, bit for bit the shard loop, the same speculation counters
  on every rank;
* the launcher's ``--mesh`` on the kernel path, and with a drafter under
  ``--mesh 1,2`` and ``--mesh 2,2 --scheduler``.

Imports no jax at its top (the ranks are spawned processes that import
this module)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import deploy as t_deploy  # noqa: E402
from repro_torch.distribution import context as dctx  # noqa: E402
from repro_torch.distribution.sharding import (local_config,  # noqa: E402
                                               local_params)
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.launch.mesh import init_file_in  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh, run_ranks  # noqa: E402
from repro_torch.models import ffn as ffn_mod  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serve.engine import Engine, Request  # noqa: E402
from test_torch_tp_mesh import record_decode_logits  # noqa: E402

TP = 2
BLOCK = 8
# name -> (path, sparsity, int8 weights, scope)
PATHS = {
    "dense": ("dense", 0.0, False, "ffn"),
    "masked": ("masked", 0.25, False, "all"),
    "masked-int8": ("masked", 0.25, True, "ffn"),
    "bsr": ("bsr", 0.25, False, "all"),
    "kernel": ("kernel", 0.25, False, "all"),
}
PAGED = dict(kv_pages=24, kv_page_len=8)
KV = {"contiguous": {}, "paged": PAGED}
# drafter name -> int8; a packed target at scope all, paged
DRAFTS = {"draft-fp": False, "draft-int8": True}
DRAFT = dict(draft_sparsity=0.75, draft_k=3)
SPEC_KEYS = t_serve.SPEC_KEYS


def port_config():
    return reduced(get_config("qwen3-32b"), layers=2, d_model=64, vocab=128)


def deployed(np_params, path, sparsity, int8, scope, tp=TP):
    """The port's deployment of the bridged weights on ``path`` at ``tp``
    (every shard and whole leaf: the shard loop's tree)."""
    with torch.no_grad():
        return t_serve.build_serving_params(
            bridge.from_numpy(np_params, device="cpu"), port_config(),
            path=path, sparsity=sparsity, int8_weights=int8, scope=scope,
            block_k=BLOCK, block_n=BLOCK, verbose=False, tp=tp)


def drafted(np_params, int8, tp=TP):
    """The packed target at ``tp`` and its drafter sharded like it."""
    whole, cfg = deployed(np_params, "packed", 0.25, False, "all", tp)
    with torch.no_grad():
        dwhole, dcfg = t_deploy.draft_pack(whole, cfg, quantize=int8, tp=tp,
                                           sparsity=DRAFT["draft_sparsity"])
    return whole, cfg, dwhole, dcfg


def requests():
    rng = np.random.default_rng(0)
    return [Request(rid=i, prompt=rng.integers(0, 128, size=(8 + 7 * i,))
                    .astype(np.int32), max_new_tokens=6) for i in range(3)]


def serve(params, cfg, opts, mesh=None, draft=None):
    """(streams, every target decode step's logits, spec counters, the
    rows of each step whose slot held a request)."""
    eng = Engine(params, cfg, batch_slots=2, cache_len=64, mesh=mesh,
                 draft=draft, **opts)
    steps = record_decode_logits(eng)
    rows = []

    def noted(fn):
        def decode(params, *a):
            if params is eng.params:
                rows.append([i for i, r in enumerate(eng.slot_req)
                             if r is not None])
            return fn(params, *a)
        return decode

    eng._decode_step = noted(eng._decode_step)
    eng._paged_decode_step = noted(eng._paged_decode_step)
    done = eng.run(requests())
    return ({r.rid: [int(t) for t in r.out_tokens] for r in done},
            [s.numpy().copy() for s in steps],
            {k: eng.stats[k] for k in SPEC_KEYS}, rows)


def _layer0_ffn(tree):
    return lm.layer_params(tree["segments"][0]["slot0"]["ffn"], 0)


def _x(d):
    return torch.randn((5, d), generator=torch.Generator().manual_seed(3))


def _ops(mesh, np_params) -> dict:
    """Layer 0's BSR products (w1 col blocks, w2's too) through
    ``_bsr_mm_sharded``, bsr and kernel; the dense FFN exactly and with
    rs + int8-ag; all on this rank's slices under the mesh."""
    out = {}
    for path in ("bsr", "kernel"):
        whole, cfg = deployed(np_params, path, 0.25, False, "all")
        local = local_params(whole, cfg, TP, mesh.model_rank)
        bsr = _layer0_ffn(local)["sasp_bsr"]
        lcfg = local_config(cfg, TP)
        with dctx.use_mesh(mesh):
            for name in ("w1", "w2"):
                x = _x(bsr[name].shape[0])
                out[f"{path}/{name}"] = ffn_mod._bsr_mm_sharded(
                    x, bsr[name], lcfg, path == "kernel").numpy()
    whole, cfg = deployed(np_params, "dense", 0.0, False, "ffn")
    p0 = _layer0_ffn(local_params(whole, cfg, TP, mesh.model_rank))
    lcfg = local_config(cfg, TP)
    x = _x(cfg.d_model)
    with dctx.use_mesh(mesh):
        out["ffn"] = ffn_mod.ffn_apply(p0, lcfg, x).numpy()
        out["ffn_rs_ag"] = ffn_mod.ffn_apply(
            p0, dataclasses.replace(lcfg, tp_comm="rs_ag_int8"), x).numpy()
    return out


def paths_rank(rank: int, init_file: str, np_params) -> dict:
    """One model rank: every path contiguous and paged, both drafters,
    and the op-level cases."""
    torch.set_num_threads(1)
    mesh = make_test_mesh(TP, rank=rank, init_file=init_file)
    out = {"ops": _ops(mesh, np_params)}
    for name, spec in PATHS.items():
        whole, cfg = deployed(np_params, *spec)
        local, lcfg = local_params(whole, cfg, TP, rank), local_config(cfg, TP)
        for kv, opts in KV.items():
            out[f"{name}/{kv}"] = serve(local, lcfg, opts, mesh)
    for name, int8 in DRAFTS.items():
        whole, cfg, dwhole, dcfg = drafted(np_params, int8)
        draft = (local_params(dwhole, dcfg, TP, rank),
                 local_config(dcfg, TP))
        out[name] = serve(local_params(whole, cfg, TP, rank),
                          local_config(cfg, TP), dict(PAGED, **DRAFT), mesh,
                          draft)
    return out


@pytest.fixture(scope="module")
def reference():
    """The reference's weights (times 3: streams that depend on the
    prompt) as numpy, and its meshless engine on every path (streams and
    decode logits) and with fp / int8 drafters (streams)."""
    jax = pytest.importorskip("jax")
    from repro.configs import get_config as r_get_config
    from repro.configs import reduced as r_reduced
    from repro.launch.serve import build_serving_params
    from repro.models import lm as r_lm
    from repro.serve.engine import Engine as REngine
    from repro.serve.engine import Request as RRequest

    cfg0 = r_reduced(r_get_config("qwen3-32b"), layers=2, d_model=64,
                     vocab=128)
    amp = jax.tree.map(lambda a: a * 3.0,
                       r_lm.init_params(jax.random.PRNGKey(0), cfg0))

    def rreqs():
        return [RRequest(rid=r.rid, prompt=r.prompt,
                         max_new_tokens=r.max_new_tokens) for r in requests()]

    def run(path, sparsity, int8, scope, **engine):
        p, c = build_serving_params(amp, cfg0, path=path, sparsity=sparsity,
                                    int8_weights=int8, block_k=BLOCK,
                                    block_n=BLOCK, scope=scope, verbose=False)
        steps = []
        decode = r_lm.decode_step

        def recorded(params, cfg, *a):
            logits, caches = decode(params, cfg, *a)
            jax.debug.callback(lambda lg: steps.append(np.asarray(lg)),
                               logits[:, 0], ordered=True)
            return logits, caches

        r_lm.decode_step = recorded
        try:
            done = REngine(p, c, batch_slots=2, cache_len=64,
                           **engine).run(rreqs())
        finally:
            r_lm.decode_step = decode
        return ({r.rid: [int(t) for t in r.out_tokens] for r in done}, steps)

    out = {"np": jax.tree.map(np.asarray, amp), "cfg": cfg0}
    for name, spec in PATHS.items():
        out[name] = run(*spec)
    for name, int8 in DRAFTS.items():
        out[name] = run("packed", 0.25, False, "all", draft_int8=int8,
                        **PAGED, **DRAFT)[0]
    return out


@pytest.fixture(scope="module")
def ranks(reference, tmp_path_factory):
    store = init_file_in(str(tmp_path_factory.mktemp("paths")))
    return run_ranks(paths_rank, TP, (store, reference["np"]), timeout=200)


# ---------------------------------------------------------------------------
# the rules: a rank's slices are the reference's specs
# ---------------------------------------------------------------------------


class StandInMesh:
    """What the reference's ``spec_for_param`` reads of a mesh."""

    def __init__(self, tp):
        self.shape = {"data": 1, "model": tp}
        self.axis_names = ("data", "model")


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name), path + (f.name,))
    else:
        yield path, tree


def _ref_slice(a: np.ndarray, spec, rank: int, tp: int) -> np.ndarray:
    for dim, ax in enumerate(tuple(spec)):
        if ax == "model":
            n = a.shape[dim] // tp
            a = np.take(a, np.arange(rank * n, (rank + 1) * n), axis=dim)
    return a


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("name", ["dense", "masked", "masked-int8", "bsr"])
def test_rank_leaves_are_the_reference_rules_slices(name, tp):
    """Every leaf a rank keeps is its slice, under the reference's
    ``param_rules`` (``spec_for_param`` on a stand-in mesh), of the whole
    deployment's leaf at the same path; the dense FFN's w1/w3 are cut by
    columns and w2 by rows, a BSR's blocks by columns, int8 ``qw`` whole;
    the ``w`` a BSR container replaces and attention's BSR entries are
    dropped."""
    jax = pytest.importorskip("jax")
    from repro.configs import get_config as r_get_config
    from repro.configs import reduced as r_reduced
    from repro.distribution.sharding import spec_for_param
    from repro.models import lm as r_lm
    rcfg = r_reduced(r_get_config("qwen3-32b"), layers=2, d_model=64,
                     vocab=128)
    np_params = jax.tree.map(np.asarray,
                             r_lm.init_params(jax.random.PRNGKey(0), rcfg))
    whole, cfg = deployed(np_params, *PATHS[name], tp=tp)
    want = dict(_leaves(whole))
    mesh = StandInMesh(tp)
    for rank in range(tp):
        local = local_params(whole, cfg, tp, rank)
        have = dict(_leaves(local))
        for path, leaf in have.items():
            if not isinstance(leaf, torch.Tensor):
                assert leaf == want[path], path
                continue
            full = want[path].numpy()
            spec = spec_for_param(rcfg, path, full.shape, mesh)
            np.testing.assert_array_equal(
                leaf.numpy(), _ref_slice(full, spec, rank, tp),
                err_msg="/".join(map(str, path)))
        ffn = local["segments"][0]["slot0"]["ffn"]
        f = cfg.d_ff
        if name in ("dense", "masked"):
            assert ffn["w1"]["w"].shape[-1] == f // tp
            assert ffn["w2"]["w"].shape[-2] == f // tp
        if name == "masked-int8":
            assert ffn["w1"]["qw"].q.shape[-1] == f
        if name == "bsr":
            assert "w" not in ffn["w1"]
            assert ffn["sasp_bsr"]["w1"].vals.shape[-3] == f // BLOCK // tp
            assert "sasp_bsr" not in local["segments"][0]["slot0"]["mixer"]


@pytest.mark.parametrize("tp", [1, 2, 4])
@pytest.mark.parametrize("name", list(PATHS))
def test_rank_build_equals_local_params_on_every_path(name, tp):
    """``build_rank_params(path=)`` (each layer drawn, deployed on the path
    and cut before the next) equals ``local_params`` of the whole
    ``build_serving_params(path=, tp=)`` on every rank, leaf for leaf and
    bit for bit, with its configs: the global tile selection, the int8
    weights, the BSR's stack-wide depth, the vocab-sharded table."""
    path, sparsity, int8, scope = PATHS[name]
    cfg = reduced(get_config("qwen3-32b"), layers=3, d_model=128, vocab=256)
    with torch.no_grad():
        whole, wcfg = t_serve.build_serving_params(
            lm.init_params(cfg, seed=0, device="cpu"), cfg, path=path,
            sparsity=sparsity, int8_weights=int8, scope=scope,
            verbose=False, tp=tp)
    assert wcfg.tp_shards == tp
    for rank in range(tp):
        got, gcfg, lcfg, draft = t_serve.build_rank_params(
            cfg, tp=tp, rank=rank, device="cpu", sparsity=sparsity,
            scope=scope, int8_weights=int8, path=path)
        assert gcfg == wcfg and lcfg == local_config(wcfg, tp)
        assert draft is None
        have = list(_leaves(got))
        want = list(_leaves(local_params(whole, wcfg, tp, rank)))
        assert [p for p, _ in have] == [p for p, _ in want]
        for (p, a), (_, b) in zip(have, want):
            if isinstance(b, torch.Tensor):
                assert a.dtype == b.dtype and torch.equal(a, b), p
            else:
                assert a == b, p


# ---------------------------------------------------------------------------
# the TP forms on the mesh, op by op
# ---------------------------------------------------------------------------


@pytest.mark.timeout(300)
@pytest.mark.parametrize("case", ["bsr/w1", "bsr/w2", "kernel/w1",
                                  "kernel/w2"])
def test_bsr_mm_sharded_equals_meshless_product(ranks, reference, case):
    """A rank's NB / tp column blocks times the whole x, all-gathered,
    bit for bit the meshless product of the whole container."""
    from repro_torch.core.sparse import bsr_matmul
    from repro_torch.kernels.sasp_gemm.gemm import sasp_matmul
    path, name = case.split("/")
    whole, _ = deployed(reference["np"], path, 0.25, False, "all")
    w = _layer0_ffn(whole)["sasp_bsr"][name]
    x = _x(w.shape[0])
    want = (sasp_matmul(x, w) if path == "kernel" else bsr_matmul(x, w))
    for r, res in enumerate(ranks):
        got = res["ops"][case]
        assert got.dtype == want.numpy().dtype
        assert np.array_equal(got, want.numpy()), r


@pytest.mark.timeout(300)
def test_dense_ffn_on_the_mesh(ranks, reference):
    """The dense FFN on the mesh (a rank's w1/w3 columns and w2 rows, the
    partial all-reduced in fp32) within 1e-5 of the meshless FFN; with
    ``tp_comm="rs_ag_int8"`` (``_ffn_tp_rs_ag_int8``) within the
    reference's 2e-2 of the reference's meshless ``ffn_apply``."""
    import jax.numpy as jnp
    from repro.models.ffn import ffn_apply as r_ffn_apply
    whole, cfg = deployed(reference["np"], "dense", 0.0, False, "ffn")
    p0 = _layer0_ffn(whole)
    x = _x(cfg.d_model)
    meshless = ffn_mod.ffn_apply(p0, dataclasses.replace(cfg, tp_shards=1),
                                 x).numpy()
    ref = np.asarray(r_ffn_apply(
        {k: {"w": jnp.asarray(v["w"].numpy())} for k, v in p0.items()},
        reference["cfg"], jnp.asarray(x.numpy())))
    scale = np.abs(meshless).max()
    for r, res in enumerate(ranks):
        got = res["ops"]["ffn"]
        assert np.abs(got - meshless).max() <= 1e-5 * scale, r
        err = np.abs(res["ops"]["ffn_rs_ag"] - ref).max() / np.abs(ref).max()
        assert 0 < err <= 2e-2, (r, err)


# ---------------------------------------------------------------------------
# every path served on the mesh
# ---------------------------------------------------------------------------


@pytest.mark.timeout(300)
@pytest.mark.parametrize("kv", list(KV))
@pytest.mark.parametrize("name", list(PATHS))
def test_mesh_path_equals_shard_loop_and_reference(ranks, reference, name,
                                                   kv):
    """Every rank's streams and decode logits bit for bit the port's tp=2
    shard loop (the same tree served meshless); the streams equal the
    reference's meshless engine's, the logits within 1e-4 of its logit
    scale."""
    whole, cfg = deployed(reference["np"], *PATHS[name])
    assert cfg.tp_shards == TP
    if name != "dense":
        assert cfg.sasp.enabled and cfg.sasp.path == PATHS[name][0].replace(
            "dense", "masked")
    streams, steps, _, rows = serve(whole, cfg, KV[kv])
    rstreams, rsteps = reference[name]
    assert len({tuple(s) for s in rstreams.values()}) > 1
    assert streams == rstreams
    assert len(steps) == len(rsteps) > 0
    scale = max(float(np.abs(s).max()) for s in rsteps)
    for a, b, live in zip(steps, rsteps, rows):   # rows holding a request
        assert float(np.abs(a[live] - b[live]).max()) <= 1e-4 * scale
    for r, res in enumerate(ranks):
        got_streams, got_steps, *_ = res[f"{name}/{kv}"]
        assert got_streams == streams, r
        assert len(got_steps) == len(steps)
        for a, b in zip(got_steps, steps):
            assert a.dtype == b.dtype and np.array_equal(a, b), r


# ---------------------------------------------------------------------------
# the drafter sharded like its target
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tp", [1, 2, 4])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("path", ["packed", "dense"])
def test_rank_built_drafter_equals_draft_pack(path, int8, tp):
    """``build_rank_params(draft_sparsity=...)``: every rank's drafter
    tree equals ``local_params(draft_pack(target, tp=tp))`` of the whole
    build, leaf for leaf and bit for bit, with its local config; the
    target's tree is unchanged by the drafter."""
    cfg = reduced(get_config("qwen3-32b"), layers=3, d_model=128, vocab=256)
    sparsity = 0.25 if path == "packed" else 0.0
    with torch.no_grad():
        whole, wcfg = t_serve.build_serving_params(
            lm.init_params(cfg, seed=0, device="cpu"), cfg, path=path,
            sparsity=sparsity, scope="all", verbose=False, tp=tp)
        dwhole, dcfg = t_deploy.draft_pack(whole, wcfg, sparsity=0.75,
                                           quantize=int8, tp=tp)
    for rank in range(tp):
        got, gcfg, lcfg, (dgot, dlcfg) = t_serve.build_rank_params(
            cfg, tp=tp, rank=rank, device="cpu", sparsity=sparsity,
            scope="all", path=path, draft_sparsity=0.75, draft_int8=int8)
        assert gcfg == wcfg and dlcfg == local_config(dcfg, tp)
        for mine, want in ((got, local_params(whole, wcfg, tp, rank)),
                           (dgot, local_params(dwhole, dcfg, tp, rank))):
            have, ref = list(_leaves(mine)), list(_leaves(want))
            assert [p for p, _ in have] == [p for p, _ in ref]
            for (p, a), (_, b) in zip(have, ref):
                if isinstance(b, torch.Tensor):
                    assert a.dtype == b.dtype and torch.equal(a, b), p
                else:
                    assert a == b, p
    pf = dwhole["segments"][0]["slot0"]["ffn"]["sasp_fused"]
    assert (pf.w1v.dtype == torch.int8) == int8
    # the dense target's drafter takes the config's 128-wide blocks
    blocks = cfg.d_ff // (32 if path == "packed" else 128)
    assert pf.shards == (tp if blocks % tp == 0 else 1)


def test_drafter_scores_are_the_pruned_trees():
    """The rank build's drafter selection reads the target's tile scores
    with its pruned tiles set to 0: ``tile_l1`` of the pruned weights
    that ``draft_pack`` re-prunes, equal bit for bit."""
    from repro_torch.configs import SASPConfig
    from repro_torch.core.pruning import (find_prunable, prune_params,
                                          scope_predicate, tile_l1)
    cfg = port_config()
    sasp = SASPConfig(enabled=True, block_k=BLOCK, block_n=BLOCK,
                      sparsity=0.25, scope="all")
    params = lm.init_params(cfg, seed=0, device="cpu")
    scores = {p: tile_l1(w, bk, bn) for p, w, bk, bn in
              find_prunable(params, sasp, scope_predicate(sasp))}
    pruned, masks = prune_params(params, sasp)
    found = find_prunable(pruned, sasp, scope_predicate(sasp))
    assert [p for p, *_ in found] == list(scores)
    for p, w, bk, bn in found:
        want = torch.where(masks[p], scores[p], torch.zeros_like(scores[p]))
        assert torch.equal(tile_l1(w, bk, bn), want), p


@pytest.mark.parametrize("int8", [False, True])
def test_draft_pack_tp1_equals_the_reference(reference, int8):
    """``draft_pack`` of the packed target (fp32 compute, no cast) equals
    the reference's array for array, at tp 1; at tp 2 its containers
    carry two shards."""
    from repro.core.deploy import draft_pack as r_draft_pack
    from repro.launch.serve import build_serving_params
    from test_torch_tp_deploy import _assert_equal, to_np
    import jax
    p, c = build_serving_params(
        jax.tree.map(jax.numpy.asarray, reference["np"]), reference["cfg"],
        path="packed", sparsity=0.25, block_k=BLOCK, block_n=BLOCK,
        scope="all", verbose=False)
    rd, _ = r_draft_pack(p, c, sparsity=0.75, quantize=int8)
    whole, cfg = deployed(reference["np"], "packed", 0.25, False, "all",
                          tp=None)
    with torch.no_grad():
        mine, mcfg = t_deploy.draft_pack(whole, cfg, sparsity=0.75,
                                         quantize=int8)
    assert mcfg.sasp.sparsity == 0.75 and mcfg.tp_shards == 1
    _assert_equal(bridge.to_numpy(mine), to_np(rd))


@pytest.mark.timeout(300)
@pytest.mark.parametrize("name", list(DRAFTS))
def test_mesh_drafter_serves_the_reference_streams(ranks, reference, name):
    """A drafter sharded like its packed target (fp, int8) on the mesh:
    every rank's streams and target decode logits bit for bit the shard
    loop with the same sharded drafter; the streams equal the reference's
    meshless engine with a drafter; every rank ran the same speculation
    rounds and accepted the same drafts (and as many as the loop)."""
    whole, cfg, dwhole, dcfg = drafted(reference["np"], DRAFTS[name])
    streams, steps, counts, _ = serve(whole, cfg, dict(PAGED, **DRAFT),
                                      draft=(dwhole, dcfg))
    assert streams == reference[name]
    assert counts["spec_rounds"] > 0
    for r, res in enumerate(ranks):
        got_streams, got_steps, got_counts, _ = res[name]
        assert got_streams == streams, r
        assert got_counts == counts == ranks[0][name][2], r
        assert len(got_steps) == len(steps)
        for a, b in zip(got_steps, steps):
            assert np.array_equal(a, b), r


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def _argv(*extra):
    return ["--device", "cpu", "--requests", "3", "--max-new", "4",
            "--slots", "2", "--cache-len", "64", *extra]


@pytest.mark.timeout(240)
@pytest.mark.parametrize("case", ["kernel", "draft-int8", "draft-2x2"])
def test_launcher_mesh_serves_paths_and_drafters(tmp_path, monkeypatch,
                                                 case):
    """``serve --mesh 1,2 --path kernel``, ``--mesh 1,2 --path packed
    --kv-pages 24 --draft-sparsity 0.75 --draft-int8`` and ``--mesh 2,2
    --scheduler`` with the drafter: every process builds its trees layer
    by layer and serves the streams of the launcher's own params served
    meshless at the mesh's TP (the shard loop; each engine its own
    drafter), with equal speculation counters on every process of a
    model group."""
    kv = ["--kv-pages", "24", "--kv-page-len", "32"]
    draft = kv + ["--draft-sparsity", "0.75", "--draft-k", "3"]
    argv = {"kernel": ["--mesh", "1,2", "--path", "kernel", "--sasp",
                       "0.5", "--scope", "all"],
            "draft-int8": ["--mesh", "1,2", "--path", "packed", "--sasp",
                           "0.5", "--scope", "all", "--draft-int8", *draft],
            "draft-2x2": ["--mesh", "2,2", "--scheduler", "--path",
                          "packed", "--sasp", "0.5", "--scope", "all",
                          *draft]}[case]
    args = t_serve.parse_args(_argv(*argv))
    spec = t_serve.mesh_spec(args)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")      # the ranks inherit it
    results = t_serve.serve_mesh(spec, store_dir=str(tmp_path), timeout=200)
    cfg = t_serve.model_config(args)
    with torch.no_grad():
        params, cfg = t_serve.build_serving_params(
            lm.init_params(cfg, seed=0, device="cpu"), cfg, path=args.path,
            sparsity=args.sasp, scope=args.scope, verbose=False,
            tp=spec["mesh"][1])
    opts = dict(batch_slots=2, cache_len=64)
    if case != "kernel":
        opts.update(kv_pages=24, kv_page_len=32, draft_sparsity=0.75,
                    draft_k=3, draft_int8=args.draft_int8)
    reqs = t_serve.synthetic_requests(3, cfg.vocab_size, 4)
    if case == "draft-2x2":
        from repro_torch.serve.scheduler import ShardedScheduler
        done = ShardedScheduler(params, cfg, ranks=2,
                                sched=t_serve.scheduler_config(args, None)
                                ).run(reqs)
    else:
        done = Engine(params, cfg, **opts).run(reqs)
    want = {r.rid: [int(t) for t in r.out_tokens] for r in done}
    for res in results:
        assert res["streams"] == want
    if case != "kernel":
        tp = spec["mesh"][1]
        for res in results:
            peer = results[res["rank"] - res["rank"] % tp]
            assert res["spec"] == peer["spec"]
        assert sum(r["spec"]["spec_rounds"] for r in results) > 0
