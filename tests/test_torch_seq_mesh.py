"""The sequence-parallel KV layout of the port on gloo meshes of spawned
processes (CPU): one ``Engine`` of one slot, whose batch does not split
over 'data', on (2, 1), (2, 2) and (1, 2) meshes, each KV ring's
capacity cut by ``sharding.seq_axes`` (over 'data', and over 'model'
where the KV heads do not split: the (1, 2) mesh serves a config with
one KV head) and attention's softmax combined over the blocks.

* every process is bit for bit the meshless twin (``Engine(data_shards=
  D, seq_split=True)`` over the shard loop's config at T): streams and
  every decode step's logits, a kept-KV preemption and resume, and a
  verify pass (``lm.prefill_with_past`` with every position's logits,
  the self-speculative verify) over the cut rings;
* each rank holds exactly its block of every ring, and runs three
  collectives an attention layer a decode step over the cut's axes;
* greedy streams equal the reference's meshless engine, every decode
  step's fp32 logits within 1e-4 (and the verify logits);
* a global ring that no axis divides (cache_len 63 on D = 2) stays whole
  beside its windowed rings, which are cut;
* a reduced MoE (granite-moe, 4 experts) on (2, 1): each data rank holds
  E / 2 experts, runs the replicated mode with no ``_Infos`` gather (no
  host read), bit for bit its twin and within 1e-4 of the reference.

Reduced gemma3-4b: 4 layers (3 windowed of 16, 1 global), d_model 64,
vocab 128, the reference's weights times 3. Imports no jax at its top:
the ranks are spawned processes that import this module."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.distribution import moe_ep  # noqa: E402
from repro_torch.distribution.context import use_mesh  # noqa: E402
from repro_torch.distribution.sharding import (local_config,  # noqa: E402
                                               local_params, ring_cut,
                                               seq_axes, seq_config,
                                               tp_config)
from repro_torch.launch.mesh import init_file_in, make_mesh  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402
from repro_torch.launch.serve import expert_shards  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serve.engine import SEQ_LAYOUT, Engine, Request  # noqa

CACHE, ODD = 64, 63           # ODD: a global ring no axis of 2 divides
PROMPT, NEW, SUFFIX = 40, 12, 5
MESHES = {"2x1": (2, 1, None), "2x2": (2, 2, None), "1x2": (1, 2, 1)}


def gemma_config(kvh=None, pkg="port"):
    if pkg == "port":
        cfg = reduced(get_config("gemma3-4b"), layers=4, d_model=64,
                      vocab=128)
    else:
        from repro.configs import get_config as r_get
        from repro.configs import reduced as r_reduced
        cfg = r_reduced(r_get("gemma3-4b"), layers=4, d_model=64,
                        vocab=128)
    return cfg if kvh is None else dataclasses.replace(cfg,
                                                       num_kv_heads=kvh)


def moe_config(pkg="port"):
    if pkg == "port":
        return reduced(get_config("granite-moe-1b-a400m"), layers=2,
                       d_model=64, vocab=128)
    from repro.configs import get_config as r_get
    from repro.configs import reduced as r_reduced
    return r_reduced(r_get("granite-moe-1b-a400m"), layers=2, d_model=64,
                     vocab=128)


def prompt():
    return np.random.default_rng(0).integers(0, 128, size=(PROMPT,)
                                             ).astype(np.int32)


def suffix():
    return np.random.default_rng(1).integers(0, 128, size=(SUFFIX,)
                                             ).astype(np.int32)


def request(cls=Request):
    return cls(rid=0, prompt=prompt(), max_new_tokens=NEW)


def run(eng):
    """(the stream, every decode step's logits) of one request."""
    steps = []
    orig = eng._decode_step

    def rec(*a):
        out = orig(*a)
        steps.append(out.numpy().copy())
        return out
    eng._decode_step = rec
    (done,) = eng.run([request()])
    return [int(t) for t in done.out_tokens], steps


def resumed(eng):
    """The stream of one request preempted with its KV kept after three
    steps, then resumed from its snapshot."""
    req = request()
    eng.submit(req)
    for _ in range(3):
        eng.step()
    eng.queue.append(eng.preempt_slot(0, keep_kv=True))
    while eng.has_work():
        eng.step()
    assert eng.stats["resumes"] == 1
    return [int(t) for t in req.out_tokens]


def verify(params, cfg):
    """The verify pass over the rings of a prefilled prompt: every
    suffix position's logits (``prefill_with_past(all_logits=True)``)."""
    with torch.no_grad():
        _, caches = lm.prefill(params, cfg, torch.as_tensor(prompt()[None]),
                               cache_len=CACHE)
        pos = torch.arange(PROMPT, PROMPT + SUFFIX, dtype=torch.int32)[None]
        logits, _ = lm.prefill_with_past(params, cfg,
                                         torch.as_tensor(suffix()[None]),
                                         pos, caches, all_logits=True)
    return logits.numpy()


def kv_bytes(eng) -> int:
    return sum(leaf.nbytes for seg in eng.caches for c in seg.values()
               if hasattr(c, "k") for leaf in c if leaf is not None)


def ring_slots(eng):
    return [int(c.k.shape[2]) for seg in eng.caches for c in seg.values()]


def seq_rank(rank: int, spec: dict, init_file: str) -> dict:
    """One process of a (D, T) gloo mesh: every case of ``spec``."""
    torch.set_num_threads(1)
    D, T, kvh = spec["mesh"]
    mesh = make_mesh(D, T, rank=rank, init_file=init_file, backend="gloo",
                     device="cpu")
    cfg = gemma_config(kvh)
    tcfg = tp_config(cfg, T)
    params = local_params(bridge.from_numpy(spec["np"], device="cpu"),
                          tcfg, T, mesh.model_rank)
    lcfg = local_config(tcfg, T)
    out = {}
    eng = Engine(params, lcfg, batch_slots=1, cache_len=CACHE, mesh=mesh)
    mesh.reset_record()
    out["engine"] = run(eng)
    out["record"] = mesh.record()
    out["layout"], out["bytes"] = eng.layout, kv_bytes(eng)
    out["slots"] = ring_slots(eng)
    out["resumed"] = resumed(Engine(params, lcfg, batch_slots=1,
                                    cache_len=CACHE, mesh=mesh))
    with use_mesh(mesh):
        out["verify"] = verify(params, eng.cfg)
    if "odd" in spec["cases"]:
        eng = Engine(params, lcfg, batch_slots=1, cache_len=ODD, mesh=mesh)
        out["odd"] = run(eng)
        out["odd_slots"] = ring_slots(eng)
    if "moe" in spec["cases"]:
        mcfg = tp_config(moe_config(), T, ep=D)
        mp = local_params(bridge.from_numpy(spec["moe_np"], device="cpu"),
                          mcfg, T, mesh.model_rank, ep=D,
                          data_rank=mesh.data_rank)
        n = {"infos": 0}
        base = moe_ep._Infos

        class Counted(base):
            def __init__(self, *a, **k):
                n["infos"] += 1
                super().__init__(*a, **k)
        moe_ep._Infos = Counted
        try:
            eng = Engine(mp, local_config(mcfg, T), batch_slots=1,
                         cache_len=CACHE, mesh=mesh)
            out["moe"] = run(eng)
        finally:
            moe_ep._Infos = base
        out["moe_infos"] = n["infos"]
        out["moe_experts"] = int(mp["segments"][0]["slot0"]["ffn"]["w1"]
                                 ["w"].shape[1])
        out["moe_layout"] = eng.layout
    return out


# ---------------------------------------------------------------------------
# the reference's side and the port's meshless engines (the parent only)
# ---------------------------------------------------------------------------


def _ref_engine(params, cfg, cache_len=CACHE):
    """The reference's meshless engine of one slot: (stream, every decode
    step's logits)."""
    import jax
    from repro.models import lm as r_lm
    from repro.serve.engine import Engine as REngine
    from repro.serve.engine import Request as RRequest
    steps = []
    decode = r_lm.decode_step

    def recorded(p, c, *a):
        logits, caches = decode(p, c, *a)
        jax.debug.callback(lambda lg: steps.append(np.asarray(lg)),
                           logits[:, 0], ordered=True)
        return logits, caches
    r_lm.decode_step = recorded
    try:
        (done,) = REngine(params, cfg, batch_slots=1,
                          cache_len=cache_len).run([request(RRequest)])
    finally:
        r_lm.decode_step = decode
    return [int(t) for t in done.out_tokens], steps


def _ref_verify(params, cfg):
    import jax.numpy as jnp
    from repro.models import lm as r_lm
    _, caches = r_lm.prefill(params, cfg, jnp.asarray(prompt()[None]),
                             cache_len=CACHE)
    pos = jnp.arange(PROMPT, PROMPT + SUFFIX, dtype=jnp.int32)[None]
    logits, _ = r_lm.prefill_with_past(params, cfg,
                                       jnp.asarray(suffix()[None]), pos,
                                       caches, all_logits=True)
    return np.asarray(logits)


@pytest.fixture(scope="module")
def reference():
    """The reference's weights (times 3) as numpy for the two gemma
    configs and the MoE, and its meshless engines' streams, decode logits
    and verify logits."""
    jax = pytest.importorskip("jax")
    from repro.models import lm as r_lm
    out = {}
    for kvh in (None, 1):
        cfg = gemma_config(kvh, "ref")
        params = jax.tree.map(lambda a: a * 3.0, r_lm.init_params(
            jax.random.PRNGKey(0), cfg))
        out[kvh] = dict(np=jax.tree.map(np.asarray, params),
                        engine=_ref_engine(params, cfg),
                        verify=_ref_verify(params, cfg))
        if kvh is None:
            out[kvh]["odd"] = _ref_engine(params, cfg, ODD)
    cfg = moe_config("ref")
    params = jax.tree.map(lambda a: a * 3.0, r_lm.init_params(
        jax.random.PRNGKey(0), cfg))
    out["moe"] = dict(np=jax.tree.map(np.asarray, params),
                      engine=_ref_engine(params, cfg))
    return out


@pytest.fixture(scope="module")
def meshes(reference, tmp_path_factory):
    """Every mesh's processes' results, by mesh name."""
    res = {}
    for name, (D, T, kvh) in MESHES.items():
        spec = dict(mesh=(D, T, kvh), np=reference[kvh]["np"],
                    cases=("odd", "moe") if name == "2x1" else (),
                    moe_np=reference["moe"]["np"])
        store = init_file_in(str(tmp_path_factory.mktemp("seq")))
        res[name] = run_ranks(seq_rank, D * T, (spec, store), timeout=240)
    return res


def _twin(reference, name, cache_len=CACHE):
    """The port's meshless twin of mesh ``name``: (engine, its run)."""
    D, T, kvh = MESHES[name]
    params = bridge.from_numpy(reference[kvh]["np"], device="cpu")
    eng = Engine(params, tp_config(gemma_config(kvh), T), batch_slots=1,
                 cache_len=cache_len, data_shards=D, seq_split=True)
    return eng, params


def _close(got, want, tol=1e-4):
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert float(np.abs(a - b).max()) <= tol


# ---------------------------------------------------------------------------
# the placement rule
# ---------------------------------------------------------------------------


SEQ_CASES = [
    # (D, T, KV heads, batch, capacity) -> axes
    ((2, 2, 4, 4, 64), ()),                        # the batch splits
    ((2, 2, 4, 2, 64), ()),
    ((2, 2, 4, 1, 64), ("data",)),                 # heads split: 'data'
    ((2, 2, 4, 3, 64), ("data",)),
    ((2, 2, 4, 1, 63), ()),
    ((2, 2, 1, 1, 64), ("data", "model")),         # heads replicated
    ((2, 2, 1, 1, 6), ("data",)),                  # 6 % 4, 6 % 2 == 0
    ((2, 2, 1, 1, 63), ()),
    ((1, 2, 1, 1, 64), ("data", "model")),
    ((1, 2, 4, 1, 64), ("data",)),                 # an axis of one
    ((16, 16, 4, 1, 524288), ("data", "model")),
    ((16, 16, 4, 1, 1024), ("data", "model")),
    ((16, 16, 16, 1, 524288), ("data",)),
    ((3, 1, 4, 1, 64), ()),
]


@pytest.mark.parametrize("case,want", SEQ_CASES)
def test_seq_axes_follows_the_reference_rule(case, want):
    """``seq_axes``: no cut where the batch splits over 'data' (B divides,
    B > 1); else (data, model) where every model rank runs every head and
    D T divides the capacity, 'data' where D does, else none; where the
    KV heads split only 'data' may cut. ``seq_config`` / ``ring_cut``
    give a ring of that capacity the same blocks."""
    D, T, kvh, B, C = case
    cfg = dataclasses.replace(gemma_config(), num_heads=16,
                              num_kv_heads=kvh)
    shape = {"data": D, "model": T}
    assert seq_axes(cfg, shape, B, C) == want
    scfg = seq_config(cfg, shape, B, C)
    if B > 1 and B % D == 0:
        assert scfg is cfg
        return
    cut = ring_cut(scfg, C) if scfg is not cfg else None
    n = 1
    for a in want:
        n *= shape[a]
    if n > 1:
        assert (cut.n, cut.axes, cut.index) == (n, want, None)
    else:
        assert cut is None


# ---------------------------------------------------------------------------
# meshless engines against the reference
# ---------------------------------------------------------------------------


@pytest.mark.timeout(300)
def test_meshless_engine_equals_reference(reference):
    """The port's meshless engine of one slot: the reference's greedy
    stream, every decode step's logits within 1e-4."""
    params = bridge.from_numpy(reference[None]["np"], device="cpu")
    stream, steps = run(Engine(params, gemma_config(), batch_slots=1,
                               cache_len=CACHE))
    want_stream, want_steps = reference[None]["engine"]
    assert stream == want_stream
    _close(steps, want_steps)


@pytest.mark.timeout(300)
@pytest.mark.parametrize("name", list(MESHES))
def test_twin_equals_reference(reference, name):
    """The meshless twin of each mesh (every ring block in one process,
    combined in block order): the reference's stream and decode logits
    within 1e-4; its verify pass within 1e-4; the resume's stream."""
    eng, params = _twin(reference, name)
    assert eng.layout == SEQ_LAYOUT + " (meshless)"
    kvh = MESHES[name][2]
    stream, steps = run(eng)
    want_stream, want_steps = reference[kvh]["engine"]
    assert stream == want_stream
    _close(steps, want_steps)
    _close([verify(params, eng.cfg)], [reference[kvh]["verify"]])
    assert resumed(_twin(reference, name)[0]) == want_stream


# ---------------------------------------------------------------------------
# the mesh's processes
# ---------------------------------------------------------------------------


@pytest.mark.timeout(300)
@pytest.mark.parametrize("name", list(MESHES))
def test_mesh_equals_twin_bit_for_bit(reference, meshes, name):
    """Every process of the mesh: its stream and every decode step's
    logits, its verify logits and its kept-KV resume bit for bit the
    meshless twin's."""
    eng, params = _twin(reference, name)
    stream, steps = run(eng)
    ver = verify(params, eng.cfg)
    res = _twin(reference, name)[0]
    want_resumed = resumed(res)
    for r, out in enumerate(meshes[name]):
        got_stream, got_steps = out["engine"]
        assert out["layout"] == SEQ_LAYOUT
        assert got_stream == stream, r
        assert len(got_steps) == len(steps)
        for a, b in zip(got_steps, steps):
            assert np.array_equal(a, b), r
        assert np.array_equal(out["verify"], ver), r
        assert out["resumed"] == want_resumed == stream, r


@pytest.mark.timeout(300)
@pytest.mark.parametrize("name", list(MESHES))
def test_mesh_holds_its_ring_blocks(reference, meshes, name):
    """Each rank's rings hold ``C / n`` slots (n = D over 'data', D T
    over (data, model) on the (1, 2) mesh of one KV head): its KV bytes
    are exactly those of an engine of the same rank's heads whose rings
    are whole, over n."""
    D, T, kvh = MESHES[name]
    n = D * T if kvh == 1 else D
    cfg = gemma_config(kvh)
    params = bridge.from_numpy(reference[kvh]["np"], device="cpu")
    whole = Engine(local_params(params, tp_config(cfg, T), T, 0),
                   local_config(tp_config(cfg, T), T), batch_slots=1,
                   cache_len=CACHE)
    for out in meshes[name]:
        assert out["slots"] == [s // n for s in ring_slots(whole)]
        assert out["bytes"] * n == kv_bytes(whole)


@pytest.mark.timeout(300)
@pytest.mark.parametrize("name", list(MESHES))
def test_mesh_combines_with_three_collectives(meshes, name):
    """A decode step runs three collectives an attention layer over the
    cut's axes: the max (an all-reduce) and two ordered sums (all-gathers
    of the (B, KH, G) sums and the (B, KH, G, D) value products)."""
    D, T, kvh = MESHES[name]
    axis = "data,model" if kvh == 1 else "data"
    layers = gemma_config().num_layers
    for out in meshes[name]:
        steps = len(out["engine"][1])
        rec = out["record"]
        assert rec["all-reduce"][axis]["calls"] == layers * steps
        assert rec["all-gather"][axis]["calls"] == 2 * layers * steps


@pytest.mark.timeout(300)
def test_mesh_equals_reference(reference, meshes):
    """Every mesh's streams equal the reference's meshless engine, every
    decode step within 1e-4, the verify pass too."""
    for name, res in meshes.items():
        kvh = MESHES[name][2]
        want_stream, want_steps = reference[kvh]["engine"]
        for out in res:
            assert out["engine"][0] == want_stream, name
            _close(out["engine"][1], want_steps)
            _close([out["verify"]], [reference[kvh]["verify"]])


@pytest.mark.timeout(300)
def test_ring_that_no_axis_divides_stays_whole(reference, meshes):
    """cache_len 63 on D = 2: the global ring (63 slots) stays whole, the
    windowed rings (16) are cut; bit for bit the twin, the reference's
    stream within 1e-4."""
    eng, _ = _twin(reference, "2x1", ODD)
    stream, steps = run(eng)
    want_stream, want_steps = reference[None]["odd"]
    assert stream == want_stream
    _close(steps, want_steps)
    for out in meshes["2x1"]:
        assert out["odd_slots"] == [8, 8, 8, 63]
        assert out["odd"][0] == stream
        assert all(np.array_equal(a, b)
                   for a, b in zip(out["odd"][1], steps))


@pytest.mark.timeout(300)
def test_moe_replicated_mode_on_data(reference, meshes):
    """The reduced MoE on (2, 1) with one slot: each data rank holds E / 2
    experts and runs the replicated mode (no ``_Infos`` gather, so no
    host read), bit for bit its meshless twin and within 1e-4 of the
    reference's meshless engine."""
    cfg = moe_config()
    assert expert_shards(cfg, (2, 1), scheduler=False) == 2
    assert expert_shards(cfg, (2, 1), scheduler=True) == 1
    params = bridge.from_numpy(reference["moe"]["np"], device="cpu")
    twin = Engine(params, tp_config(cfg, 1, ep=2), batch_slots=1,
                  cache_len=CACHE, data_shards=2, seq_split=True)
    stream, steps = run(twin)
    want_stream, want_steps = reference["moe"]["engine"]
    assert stream == want_stream
    _close(steps, want_steps)
    for out in meshes["2x1"]:
        assert out["moe_layout"] == SEQ_LAYOUT
        assert out["moe_experts"] == cfg.moe.num_experts // 2
        assert out["moe_infos"] == 0
        assert out["moe"][0] == stream
        assert all(np.array_equal(a, b)
                   for a, b in zip(out["moe"][1], steps))


def test_seq_split_refuses_what_it_cannot_twin(reference):
    """``seq_split`` names the twin of an engine whose batch does not
    split and whose rings some axis could cut: a batch that splits, or a
    page pool, is refused with the reason."""
    params = bridge.from_numpy(reference[None]["np"], device="cpu")
    cfg = gemma_config()
    with pytest.raises(ValueError, match="seq_split"):
        Engine(params, cfg, batch_slots=2, cache_len=CACHE, data_shards=2,
               seq_split=True)
    with pytest.raises(ValueError, match="seq_split"):
        Engine(params, cfg, batch_slots=1, cache_len=CACHE, data_shards=2,
               seq_split=True, kv_pages=16, kv_page_len=8)
