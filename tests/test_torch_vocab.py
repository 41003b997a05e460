"""The reference's vocab rule in the port: the embedding / head table's
rows over 'model' (``distribution.sharding``), a rank's V/tp rows
(``local_params``), the sharded gather (each rank's rows, summed over the
ranks) and head (each rank's logits, all-gathered) of ``models.lm``.
On a 2-process gloo mesh (CPU): the gather equals the replicated gather
bit for bit (fp32 and bf16), the head equals the shard loop's bit for
bit and the whole table's within 1e-5, and a mesh engine's decode
logits and streams equal the shard loop's bit for bit and are within
1e-5 of the reference's meshless tp=2 engine. The module imports no jax
at its top: the spawned ranks import it."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.distribution import context as dctx  # noqa: E402
from repro_torch.distribution.sharding import (local_config,  # noqa: E402
                                               local_params,
                                               spec_for_param,
                                               vocab_config)
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.launch.mesh import init_file_in  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh, run_ranks  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serve.engine import Engine, Request  # noqa: E402
from test_torch_tp_mesh import record_decode_logits  # noqa: E402

TP = 2
# the reduced qwen3 of the reference's mesh worker (tests/dist_worker.py)
DEPLOY = dict(path="packed", sparsity=0.25, block_k=8, block_n=8,
              scope="all", verbose=False)


def _cfg():
    return reduced(get_config("qwen3-32b"), layers=2, d_model=64, vocab=128)


def _tokens():
    """Ids in both ranks' rows, the first and last of each."""
    return torch.tensor([[0, 63, 64, 127, 5, 100, 64, 0]])


def _x(cfg):
    gen = torch.Generator().manual_seed(4)
    return torch.randn((2, 3, cfg.d_model), generator=gen)


def _port_tree(params_np):
    """The port's tp=2 packed tree (every shard, the whole table) of the
    reference's params."""
    return t_serve.build_serving_params(
        bridge.from_numpy(params_np, device="cpu"), _cfg(), tp=TP, **DEPLOY)


def _requests():
    rng = np.random.default_rng(0)
    return [Request(rid=i, prompt=rng.integers(0, 128, size=(8 + 7 * i,))
                    .astype(np.int32), max_new_tokens=6) for i in range(3)]


def _serve(params, cfg, mesh=None):
    eng = Engine(params, cfg, batch_slots=2, cache_len=64, mesh=mesh)
    steps = record_decode_logits(eng)
    done = eng.run(_requests())
    return ({r.rid: [int(t) for t in r.out_tokens] for r in done},
            [s.numpy().copy() for s in steps])


def vocab_rank(rank: int, init_file: str, params_np) -> dict:
    """One model rank: its local tree's gather (fp32 and bf16) and head
    under the mesh, and an engine serving the requests."""
    torch.set_num_threads(1)
    mesh = make_test_mesh(TP, rank=rank, init_file=init_file)
    params, cfg = _port_tree(params_np)
    local, lcfg = local_params(params, cfg, TP, rank), local_config(cfg, TP)
    out = {"rows": tuple(local["embed"]["emb"].shape)}
    with torch.no_grad(), dctx.use_mesh(mesh):
        for dt in ("float32", "bfloat16"):
            c = dataclasses.replace(lcfg, compute_dtype=dt)
            out[f"gather_{dt}"] = lm._embed_in(local, c, _tokens()).float() \
                .numpy()
        out["head"] = lm.logits_fn(local, lcfg, _x(lcfg)).numpy()
    out["streams"], out["steps"] = _serve(local, lcfg, mesh=mesh)
    return out


@pytest.fixture(scope="module")
def ref_model():
    """(numpy params, the reference's meshless tp=2 deployment and
    config) of the reduced qwen3."""
    jax = pytest.importorskip("jax")
    from repro.configs import get_config as r_get_config
    from repro.configs import reduced as r_reduced
    from repro.core import deploy as r_deploy
    from repro.launch.serve import build_serving_params
    from repro.models import lm as r_lm
    cfg0 = r_reduced(r_get_config("qwen3-32b"), layers=2, d_model=64,
                     vocab=128)
    params0 = r_lm.init_params(jax.random.PRNGKey(0), cfg0)
    rp, rcfg = build_serving_params(params0, cfg0, **DEPLOY)
    rp = r_deploy.reshard_packed(rp, rcfg, tp=TP)
    return jax.tree.map(np.asarray, params0), rp, rcfg


@pytest.fixture(scope="module")
def ranks(ref_model, tmp_path_factory):
    store = init_file_in(str(tmp_path_factory.mktemp("vocab")))
    return run_ranks(vocab_rank, TP, (store, ref_model[0]), timeout=110)


@pytest.mark.parametrize("tp", [1, 2, 3, 4])
@pytest.mark.parametrize("vocab", [128, 130])
def test_vocab_rule_matches_the_reference(tp, vocab):
    """``spec_for_param`` of embed/emb and lm_head/emb is the reference's
    ``param_rules`` spec (rows over 'model' where V divides, else
    whole), and ``vocab_config`` splits the table where it shards."""
    pytest.importorskip("jax")
    from types import SimpleNamespace

    from repro.configs import get_config as r_get_config
    from repro.distribution.sharding import spec_for_param as r_spec
    mesh = SimpleNamespace(shape={"data": 1, "model": tp},
                           axis_names=("data", "model"))
    shape = (vocab, 64)
    for path in (("embed", "emb"), ("lm_head", "emb")):
        want = tuple(r_spec(r_get_config("qwen3-32b"), path, shape, mesh))
        assert spec_for_param(path, shape, {"model": tp}) == want
        assert len(want) == 2 and want[1] is None
        assert (want[0] == "model") == (vocab % tp == 0)
    cfg = dataclasses.replace(_cfg(), vocab_size=vocab)
    shards = vocab_config(cfg, tp).vocab_shards
    assert shards == (tp if tp > 1 and vocab % tp == 0 else 1)


@pytest.mark.parametrize("tied", [True, False])
def test_local_params_cuts_the_table_rows(tied):
    """Rank r keeps rows [r V/tp, (r+1) V/tp) of the table (and of an
    untied head); ``rank`` None keeps it whole; a config whose vocab
    split is not the deployment's is refused."""
    cfg = dataclasses.replace(_cfg(), tie_embeddings=tied)
    params = lm.init_params(cfg, seed=0, device="cpu")
    tree, dcfg = t_serve.build_serving_params(params, cfg, tp=TP, **DEPLOY)
    assert dcfg.vocab_shards == TP
    rows = cfg.vocab_size // TP
    names = ("embed",) if tied else ("embed", "lm_head")
    for r in range(TP):
        loc = local_params(tree, dcfg, TP, r)
        for n in names:
            assert torch.equal(loc[n]["emb"],
                               params[n]["emb"][r * rows:(r + 1) * rows])
    whole = local_params(tree, dcfg, TP, None)
    for n in names:
        assert whole[n]["emb"] is tree[n]["emb"]
    with pytest.raises(ValueError, match="vocab split"):
        local_params(tree, dataclasses.replace(dcfg, vocab_shards=1), TP, 0)


@pytest.mark.timeout(120)
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_mesh_gather_equals_the_replicated_gather(ranks, ref_model, dt):
    params, cfg = _port_tree(ref_model[0])
    c = dataclasses.replace(cfg, compute_dtype=dt)
    want = lm._embed_in(params, dataclasses.replace(c, vocab_shards=1),
                        _tokens()).float().numpy()
    for r, res in enumerate(ranks):
        assert res["rows"] == (cfg.vocab_size // TP, cfg.d_model)
        got = res[f"gather_{dt}"]
        assert got.dtype == want.dtype and np.array_equal(got, want), r


@pytest.mark.timeout(120)
def test_mesh_head_equals_the_shard_loop(ranks, ref_model):
    """The all-gathered head equals the shard loop's shard-by-shard head
    bit for bit, and the whole table's product within 1e-5 of its
    scale."""
    params, cfg = _port_tree(ref_model[0])
    with torch.no_grad():
        loop = lm.logits_fn(params, cfg, _x(cfg)).numpy()
        whole = lm.logits_fn(params, dataclasses.replace(cfg, vocab_shards=1),
                             _x(cfg)).numpy()
    assert loop.shape == (2, 3, cfg.vocab_size)
    for res in ranks:
        assert np.array_equal(res["head"], loop)
    scale = float(np.abs(whole).max())
    assert float(np.abs(loop - whole).max()) <= 1e-5 * scale


@pytest.mark.timeout(120)
def test_mesh_engine_equals_shard_loop_and_reference(ranks, ref_model,
                                                     monkeypatch):
    """Every rank's streams and decode logits equal the shard loop's bit
    for bit (the vocab-sharded table on the mesh, shard by shard in the
    loop); the loop's are within 1e-5 of the logit scale of the
    reference's meshless tp=2 engine, with equal greedy streams."""
    jax = pytest.importorskip("jax")
    from repro.models import lm as r_lm
    from repro.serve.engine import Engine as REngine
    from repro.serve.engine import Request as RRequest
    params_np, rp, rcfg = ref_model
    params, cfg = _port_tree(params_np)
    streams, steps = _serve(params, cfg)
    for r, res in enumerate(ranks):
        assert res["streams"] == streams, r
        assert len(res["steps"]) == len(steps) > 0
        for a, b in zip(res["steps"], steps):
            assert a.dtype == b.dtype and np.array_equal(a, b), r
    ref_steps = []
    decode = r_lm.decode_step

    def recorded(p, c, *a):
        logits, caches = decode(p, c, *a)
        jax.debug.callback(lambda lg: ref_steps.append(np.asarray(lg)),
                           logits[:, 0], ordered=True)
        return logits, caches

    monkeypatch.setattr(r_lm, "decode_step", recorded)
    want = REngine(rp, rcfg, batch_slots=2, cache_len=64).run(
        [RRequest(rid=q.rid, prompt=q.prompt, max_new_tokens=6)
         for q in _requests()])
    assert {q.rid: [int(t) for t in q.out_tokens] for q in want} == streams
    assert len(ref_steps) == len(steps)
    scale = max(float(np.abs(s).max()) for s in ref_steps)
    for a, b in zip(steps, ref_steps):
        assert float(np.abs(a - b).max()) <= 1e-5 * scale
