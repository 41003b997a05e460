"""Full-depth building of the port, at reduced sizes on the CPU: every
attention and dense-FFN stack of ``lm.init_params`` is the stack of its
layers drawn alone (``lm.draw_layer``, ``lm.init_layer``), with seeds
that spawned processes agree on; ``build_rank_params`` never draws more
than one layer of a matrix at a time and, at tp 1, equals the whole
packed build leaf for leaf; it restores a checkpoint layer by layer
(``CheckpointReader``) to the same tree as the whole restore; and the
launcher's one-card packed path serves what the whole build serves.
Imports no jax: the spawned processes import this module."""
import dataclasses
import hashlib
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core.pruning import iter_leaves, map_leaves  # noqa: E402
from repro_torch.distribution.sharding import local_params  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serve.engine import Engine  # noqa: E402
from repro_torch.train.checkpoint import CheckpointManager  # noqa: E402
from test_torch_tp_mesh import RANK_BUILDS, _leaves, _spread  # noqa: E402

# attention + dense-FFN archs: qk norms and a tied table (qwen3), qkv
# biases (qwen2.5), local:global slots in one segment (gemma3)
ARCHS = ("qwen3-32b", "qwen2.5-32b", "gemma3-4b")
MATRICES = ("wq", "wk", "wv", "wo", "w1", "w2", "w3")


def _cfg(arch="qwen3-32b", layers=3):
    return reduced(get_config(arch), layers=layers, d_model=128, vocab=256)


def _matrix_scale(cfg, name):
    return 0.02 / max(1.0, math.sqrt(2 * cfg.num_layers)) \
        if name in ("wo", "w2") else 0.02


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_is_the_stack_of_its_layer_draws(arch):
    """Every leaf of every segment equals the concatenation of
    ``init_layer``'s one-layer leaves, every matrix layer equals its
    ``draw_layer``, and the top leaves equal ``init_top``'s."""
    cfg = _cfg(arch, layers=7 if arch == "gemma3-4b" else 3)
    params = lm.init_params(cfg, seed=5, device="cpu")
    top = lm.init_top(cfg, seed=5, device="cpu")
    for k in top:
        for (p, a), (_, b) in zip(iter_leaves(params[k]),
                                  iter_leaves(top[k])):
            assert torch.equal(a, b), (k, p)
    n_mats = 0
    for si, (pattern, repeat) in enumerate(lm.segment_plan(cfg)):
        layers = [lm.init_layer(cfg, si, i, seed=5, device="cpu")
                  for i in range(repeat)]
        per = [dict(iter_leaves(t, ("segments", si))) for t in layers]
        for path, leaf in iter_leaves(params["segments"][si],
                                      ("segments", si)):
            assert leaf.shape[0] == repeat
            assert torch.equal(leaf, torch.cat([p[path] for p in per])), \
                path
            if path[-2] in MATRICES and path[-1] == "w":
                for i in range(repeat):
                    want = lm.draw_layer(
                        path, i, leaf.shape[1:],
                        _matrix_scale(cfg, path[-2]), seed=5,
                        device="cpu", dtype=leaf.dtype)
                    assert torch.equal(leaf[i], want), (path, i)
                    n_mats += 1
        # the layers differ, and so does another seed
        wq = ("segments", si, "slot0", "mixer", "wq", "w")
        if repeat > 1:
            assert not torch.equal(per[0][wq], per[1][wq])
        other = lm.init_layer(cfg, si, 0, seed=6, device="cpu")
        assert not torch.equal(other["slot0"]["mixer"]["wq"]["w"],
                               per[0][wq])
    assert n_mats == cfg.num_layers * len(MATRICES)


def _digests(rank: int, arch: str) -> dict:
    """sha256 of every leaf of layer 1 of segment 0 and of the top, and
    a few layer seeds, in a spawned process (its own string-hash
    salt)."""
    cfg = _cfg(arch)
    tree = {"top": lm.init_top(cfg, seed=3, device="cpu"),
            "layer": lm.init_layer(cfg, 0, 1, seed=3, device="cpu")}
    return {"leaves": {"/".join(map(str, p)): hashlib.sha256(
        t.numpy().tobytes()).hexdigest() for p, t in iter_leaves(tree)},
        "seeds": [lm.layer_seed(3, ("segments", 0, "slot0", "ffn", "w1",
                                    "w"), i) for i in range(3)]}


def test_spawned_processes_draw_equal_leaves():
    """Two spawned processes (each with its own salted ``hash``) and this
    one draw the same bits: the seeds come from a CRC of the path."""
    got = run_ranks(_digests, 2, ("qwen3-32b",), timeout=120)
    here = _digests(0, "qwen3-32b")
    for res in got:
        assert res["leaves"] == here["leaves"]
        assert res["seeds"] == here["seeds"]
    assert len(here["leaves"]) > 10


@pytest.mark.parametrize("tp", [1, 2])
def test_rank_build_draws_one_layer_at_a_time(monkeypatch, tp):
    """Every ``torch.randn`` of ``build_rank_params`` is the table or one
    layer of one matrix, and each matrix layer is drawn exactly twice
    (the scoring pass and the packing pass), where the whole build drew
    the model once per layer."""
    cfg = reduced(get_config("qwen3-32b"), layers=4, d_model=128,
                  vocab=512)
    layer = lm.init_layer(cfg, 0, 0, device="cpu")
    one = sorted(tuple(t.shape[1:]) for p, t in iter_leaves(layer)
                 if p[-2] in MATRICES and p[-1] == "w")
    table = (cfg.vocab_size, cfg.d_model)
    assert table not in one
    shapes = []
    randn = torch.randn

    def recording(*args, **kw):
        out = randn(*args, **kw)
        shapes.append(tuple(out.shape))
        return out

    monkeypatch.setattr(torch, "randn", recording)
    t_serve.build_rank_params(cfg, tp=tp, rank=0, device="cpu",
                              sparsity=0.5, scope="all")
    assert len(one) == len(MATRICES)
    mats = sorted(s for s in shapes if s != table)
    assert shapes.count(table) == 1
    assert mats == sorted(one * 2 * cfg.num_layers)
    assert all(len(s) == 2 for s in shapes)


@pytest.mark.parametrize("name", list(RANK_BUILDS))
def test_rank_build_tp1_equals_the_whole_packed_build(name):
    """``build_rank_params(tp=1, rank=0)``, the one-card launcher's packed
    build, equals ``build_serving_params(init_params(...),
    path="packed")`` leaf for leaf: every leaf it keeps is the whole
    build's at the same path, bit for bit, and the whole build's other
    leaves are the dense matrices the containers replace. At sparsity 0
    both are the dense params, as in the reference (held with ``tp=1``,
    whose config carries the shard counts): nothing is replaced."""
    from repro_torch.serve.host_worker import spread_output_scales
    scope, int8, compute, sparsity, spread = RANK_BUILDS[name]
    cfg = dataclasses.replace(_cfg(), compute_dtype=compute)
    got, gcfg, _, _ = t_serve.build_rank_params(
        cfg, tp=1, rank=0, device="cpu", sparsity=sparsity, scope=scope,
        int8_weights=int8, prepare=_spread(cfg) if spread else None)
    with torch.no_grad():
        params = lm.init_params(cfg, seed=0, device="cpu")
        if spread:
            params = spread_output_scales(params, cfg)
        whole, wcfg = t_serve.build_serving_params(
            params, cfg, path="packed", sparsity=sparsity, scope=scope,
            int8_weights=int8, verbose=False,
            tp=None if sparsity > 0 else 1)
    assert gcfg == wcfg
    want = dict(_leaves(whole))
    have = dict(_leaves(got))
    for path, a in have.items():
        b = want[path]
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), path
        else:
            assert a == b, path
    extra = {p[:-1] for p in set(want) - set(have)}
    replaced = {p for p in extra if p[-1] in MATRICES}
    assert extra == replaced and (replaced or sparsity == 0), extra
    if sparsity == 0:
        assert not extra and "sasp_fused" not in got["segments"][0][
            "slot0"]["ffn"]


def test_checkpoint_reader_reads_layers_and_checks_crcs(tmp_path):
    """``layer(name, i)`` equals the leaf's slice bit for bit (bf16 too);
    in-order reads check the CRC, and a corrupt member fails it."""
    tree = {"params": {"a": torch.randn(3, 4, 5),
                       "b": torch.randn(2, 6).to(torch.bfloat16),
                       "c": torch.randn(7)}}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(4, tree)
    with mgr.reader() as rd:
        assert rd.step == 4 and rd.names() == ["params/a", "params/b",
                                               "params/c"]
        for name, t in (("params/a", tree["params"]["a"]),
                        ("params/b", tree["params"]["b"])):
            for i in range(t.shape[0]):
                got = rd.layer(name, i)
                assert got.dtype == t.dtype and torch.equal(got, t[i:i + 1])
        assert torch.equal(rd.leaf("params/c"), tree["params"]["c"])
    with mgr.reader() as rd:
        rd.meta["params/a"]["crc32"] ^= 1
        rd.layer("params/a", 0)
        rd.layer("params/a", 1)
        with pytest.raises(IOError, match="CRC mismatch"):
            rd.layer("params/a", 2)


@pytest.mark.parametrize("tp", [1, 2])
def test_rank_build_from_a_checkpoint_equals_the_whole_restore(tmp_path,
                                                               tp):
    """Params written by the port's ``CheckpointManager`` (every weight
    times 3), restored layer by layer into each rank's tree, equal
    ``local_params`` of the whole restore's packed build."""
    cfg = _cfg()
    params = map_leaves(lambda p, t: t * 3.0,
                        lm.init_params(cfg, seed=2, device="cpu"))
    CheckpointManager(str(tmp_path)).save(7, {"params": params})
    restored = t_serve.restore_params(
        str(tmp_path), lm.init_params(cfg, seed=0, device="cpu"))
    whole, wcfg = t_serve.build_serving_params(
        restored, cfg, path="packed", sparsity=0.5, scope="all",
        verbose=False, tp=tp)
    for rank in range(tp):
        got, gcfg, _, _ = t_serve.build_rank_params(
            cfg, tp=tp, rank=rank, device="cpu", sparsity=0.5, scope="all",
            ckpt_dir=str(tmp_path))
        assert gcfg == wcfg
        want = list(_leaves(local_params(whole, wcfg, tp, rank)))
        have = list(_leaves(got))
        assert [p for p, _ in have] == [p for p, _ in want]
        for (path, a), (_, b) in zip(have, want):
            if isinstance(b, torch.Tensor):
                assert a.dtype == b.dtype and torch.equal(a, b), path
            else:
                assert a == b, path


def test_launcher_packed_path_serves_the_whole_build(capsys):
    """``serve --path packed --sasp 0.5`` (built layer by layer) prints
    the streams the engine serves on the whole build."""
    import re
    t_serve.main(["--sasp", "0.5", "--path", "packed", "--scope", "all",
                  "--requests", "3", "--max-new", "4", "--slots", "2",
                  "--cache-len", "64", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "packed one at a time" in out
    got = {int(m.group(1)): [int(t) for t in m.group(2).split(",")]
           for m in re.finditer(r"req (\d+): prompt\[\d+\] -> \[([^\]]*)\]",
                                out)}
    cfg = reduced(get_config("qwen3-32b"), layers=4, d_model=128, vocab=512)
    with torch.no_grad():
        params, scfg = t_serve.build_serving_params(
            lm.init_params(cfg, seed=0, device="cpu"), cfg, path="packed",
            sparsity=0.5, scope="all", verbose=False)
    done = Engine(params, scfg, batch_slots=2, cache_len=64).run(
        t_serve.synthetic_requests(3, cfg.vocab_size, 4))
    want = {r.rid: [int(t) for t in r.out_tokens] for r in done}
    assert got == want and len(got) == 3
    assert np.all([len(s) == 4 for s in got.values()])


def _tile_masked(rng, L, K, N, b, keep):
    """(L, K, N) normals with each layer's b×b tiles kept at its own
    rate ``keep[i]``."""
    w = rng.standard_normal((L, K, N)).astype(np.float32)
    for i in range(L):
        m = rng.random((K // b, N // b)) < keep[i]
        w[i] *= np.kron(m, np.ones((b, b), np.float32))
    return w


@pytest.mark.parametrize("tp", [1, 2])
@pytest.mark.parametrize("quantize", [False, True])
def test_layer_stack_equals_packing_every_layer_at_once(tp, quantize):
    """A ``LayerStack`` of one-layer packs, whose later layers need more
    visits than the first (the padded axis grows), equals packing the
    whole stack at once, field for field: padding by the last visit (kn),
    zero blocks and scales, jv -1."""
    from repro_torch.core import deploy as t_deploy
    rng = np.random.default_rng(8)
    L, d, f, b = 4, 64, 128, 16
    keep = (0.3, 0.7, 0.5, 0.9)
    w = _tile_masked(rng, L, d, f, b, keep)
    w1, w3 = _tile_masked(rng, L, d, f, b, keep), w
    w2 = _tile_masked(rng, L, f, d, b, keep)
    whole = {
        "col": t_deploy.pack_weight(w, block_k=b, block_n=b, act="silu",
                                    quantize=quantize, tp=tp,
                                    shard_kind="col", device="cpu"),
        "row": t_deploy.pack_weight(w2, block_k=b, block_n=b,
                                    quantize=quantize, tp=tp,
                                    shard_kind="row", device="cpu"),
        "ffn": t_deploy.pack_ffn(w1, w3, w2, block_f=b, act="silu",
                                 quantize=quantize, tp=tp, device="cpu"),
        "norm": torch.from_numpy(w[:, :, 0].copy())}
    stack = t_deploy.LayerStack(L, "cpu")
    for i in range(L):
        sl = slice(i, i + 1)
        stack.add({
            "col": t_deploy.pack_weight(w[sl], block_k=b, block_n=b,
                                        act="silu", quantize=quantize,
                                        tp=tp, shard_kind="col",
                                        device="cpu"),
            "row": t_deploy.pack_weight(w2[sl], block_k=b, block_n=b,
                                        quantize=quantize, tp=tp,
                                        shard_kind="row", device="cpu"),
            "ffn": t_deploy.pack_ffn(w1[sl], w3[sl], w2[sl], block_f=b,
                                     act="silu", quantize=quantize, tp=tp,
                                     device="cpu"),
            "norm": torch.from_numpy(w[sl, :, 0].copy())})
    got = stack.result()
    firsts = [t_deploy.pack_weight(w[:1], block_k=b, block_n=b,
                                   quantize=quantize, tp=tp,
                                   shard_kind="col", device="cpu").nnz,
              whole["col"].nnz]
    assert firsts[0] < firsts[1]                # the axis grew
    want, have = list(_leaves(whole)), list(_leaves(got))
    assert [p for p, _ in have] == [p for p, _ in want]
    for (path, a), (_, c) in zip(have, want):
        if isinstance(c, torch.Tensor):
            assert a.dtype == c.dtype and torch.equal(a, c), path
        else:
            assert a == c, path
