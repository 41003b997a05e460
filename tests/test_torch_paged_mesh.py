"""The paged KV pool cut over 'data' as the reference places it, and a MoE
drafter on a mesh, on gloo meshes of spawned processes (CPU).

* the rule (``sharding.pool_axes``) against the reference's
  ``pool_shardings``, case by case: the page axis over the DP axes where
  they divide it, the KV heads over 'model';
* reduced qwen3-32b (2 layers, d_model 64, vocab 128, the reference's
  weights times 3), packed at 25% (scope all, 8 x 8 tiles), one
  ``Engine`` of 4 slots with ``kv_pages`` 24 (P = 26 pages of 8 tokens)
  on (2, 1) and (2, 2) meshes: "slots and pages split over data". Each
  rank's pool holds its block: 13 pages on data rank 0 (with the zero
  and trash pages), 13 + 2 local reserved pages on data rank 1. Every
  process's streams (and every decode step's logits) are bit for bit the
  meshless twin's (``Engine(data_shards=2)``, both blocks in one
  process), and equal the reference's meshless paged engine, with prefix
  sharing (a prefix shared by slots on both ranks, each rank mapping its
  own block's pages), a host spill and fault inside one block, a kept-KV
  preemption that resumes on the other data rank (its pages moved once),
  a drafter (``draft_k`` 3: drafted and accepted counts the twin's) and
  an admission that passes over a full block for a free slot of the
  other; a plain decode step moves only the sampled rows over 'data';
* reduced moonshot (2 layers, 4 experts, drop-free capacity) packed at
  50% with a drafter at 75%, built layer by layer and expert by expert
  from a reference checkpoint (``build_rank_params``), on (2, 1) (the
  experts in EP over 'data', the pool cut) and (1, 2) (d_ff over
  'model'): streams bit for bit the twin's and equal to the reference's
  meshless ``Engine(draft_sparsity=0.75)``; every rank's drafter expert
  masks are its slice of the reference's ``draft_pack``'s.

Imports no jax at its top: the ranks are spawned processes that import
this module."""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import deploy as t_deploy  # noqa: E402
from repro_torch.distribution.sharding import (local_config,  # noqa: E402
                                               local_params, pool_axes,
                                               pool_blocks)
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.launch.mesh import init_file_in, make_mesh  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402
from repro_torch.serve import memory as kvmem  # noqa: E402
from repro_torch.serve.engine import PAGED_LAYOUT, Engine  # noqa: E402
from repro_torch.serve.engine import Request  # noqa: E402

DEPLOY = dict(path="packed", sparsity=0.25, block_k=8, block_n=8,
              scope="all", verbose=False)
SLOTS, CACHE = 4, 64
KV = dict(kv_pages=24, kv_page_len=8)             # P = 26: 13 a block
SPILL = dict(kv_pages=18, kv_page_len=8, kv_host_pages=16)
MOE = dict(sparsity=0.5, scope="all", path="packed")
MOE_KV = dict(kv_pages=10, kv_page_len=32)        # P = 12: 6 a block
DRAFT = 0.75
# mesh shape -> the cases its processes run
SHAPES = {(2, 1): ("qwen", "moe"), (2, 2): ("qwen",), (1, 2): ("moe",)}
SCENARIOS = ("plain", "shared", "spilled", "moved", "drafted", "placed")


def port_config():
    return reduced(get_config("qwen3-32b"), layers=2, d_model=64, vocab=128)


def moe_config(pkg="port"):
    if pkg == "port":
        cfg = reduced(get_config("moonshot-v1-16b-a3b"), layers=2,
                      d_model=64, vocab=128)
    else:
        from repro.configs import get_config as r_get
        from repro.configs import reduced as r_reduced
        cfg = r_reduced(r_get("moonshot-v1-16b-a3b"), layers=2, d_model=64,
                        vocab=128)
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=8.0))


def deployed(np_params, tp: int):
    """The port's packed deployment of the bridged weights at ``tp`` (the
    shard loop's tree) and its drafter at ``DRAFT``."""
    with torch.no_grad():
        whole, wcfg = t_serve.build_serving_params(
            bridge.from_numpy(np_params, device="cpu"), port_config(),
            tp=tp, **DEPLOY)
        draft = t_deploy.draft_pack(whole, wcfg, sparsity=DRAFT, tp=tp)
    return whole, wcfg, draft


def streams(reqs):
    return {r.rid: [int(t) for t in r.out_tokens] for r in reqs}


def _prompt(rng, n):
    return rng.integers(0, 128, size=(n,)).astype(np.int32)


# ---------------------------------------------------------------------------
# the scenarios: each drives an engine made by ``make(**options)`` with
# requests of class ``Req`` (the port's or the reference's)
# ---------------------------------------------------------------------------


def plain_requests(Req):
    rng = np.random.default_rng(0)
    return [Req(rid=i, prompt=_prompt(rng, 6 + 7 * i), max_new_tokens=5 + i)
            for i in range(6)]


def run_plain(make, Req, mesh=None):
    """Six requests through four slots; the second step decodes every
    slot with nothing to admit, its collectives recorded."""
    eng = make(**KV)
    steps = []
    if isinstance(eng, Engine):
        orig = eng._paged_decode_step

        def rec(*a):
            out = orig(*a)
            steps.append(out.numpy().copy())
            return out
        eng._paged_decode_step = rec
    reqs = plain_requests(Req)
    for r in reqs[:4]:
        eng.submit(r)
    eng.step()
    if mesh is not None:
        mesh.reset_record()
    eng.step()
    record = None if mesh is None else mesh.record()
    for r in reqs[4:]:
        eng.submit(r)
    while eng.has_work():
        eng.step()
    out = dict(streams=streams(reqs), steps=steps, record=record)
    if isinstance(eng, Engine):
        pool = eng.pool
        out.update(layout=eng.layout, nbytes=pool.nbytes(),
                   pages={b: sorted({a.shape[1] for _, _, c in kvmem._caches(
                       pool.block_data(b)) for a in c if a is not None})
                          for b in pool.held})
    return out


def run_shared(make, Req, mesh=None):
    """Four prompts of one 24-token prefix (3 pages), admitted one a step
    into slots 0-3: slots 0 and 1 on data rank 0, 2 and 3 on rank 1."""
    eng = make(kv_share=True, **KV)
    rng = np.random.default_rng(2)
    prefix = _prompt(rng, 24)
    reqs = [Req(rid=i, prompt=np.concatenate([prefix, _prompt(rng, 5)]),
                max_new_tokens=6) for i in range(4)]
    for r in reqs:
        eng.submit(r)
        eng.step()
    while eng.has_work():
        eng.step()
    out = dict(streams=streams(reqs))
    if isinstance(eng, Engine):
        mem = eng.memory_stats()
        out.update(hits=mem.prefix_hits, reused=mem.prefix_pages_reused,
                   elsewhere=mem.prefix_pages_elsewhere,
                   skipped=eng.stats["prefill_tokens_skipped"])
        eng.pool.check()
    return out


def run_spilled(make, Req, mesh=None):
    """``kv_pages`` 18 (P = 20: 8 usable pages on data rank 0) with a host
    pool: request 0 in slot 0 is preempted with its KV kept, a 40-token
    prompt takes slot 0 and spills its pages to the host; it faults them
    back when a slot of rank 0 frees (slots 2 and 3 stay busy)."""
    eng = make(**SPILL)
    rng = np.random.default_rng(4)
    r0, x, y, z, r1 = (Req(rid=i, prompt=_prompt(rng, n), max_new_tokens=b)
                       for i, (n, b) in enumerate(
                           ((40, 10), (12, 3), (8, 20), (8, 20), (40, 6))))
    for r in (r0, x, y, z):
        eng.submit(r)
    eng.step()
    eng.step()
    pre = eng.preempt_slot(0, keep_kv=True)
    eng.submit(r1)
    eng.queue.append(pre)
    while eng.has_work():
        eng.step()
    out = dict(streams=streams([r0, x, y, z, r1]))
    if isinstance(eng, Engine):
        mem = eng.memory_stats()
        out.update(spills=mem.spills, faults=mem.faults, drops=mem.drops,
                   moved=mem.moved_pages, resumes=eng.stats["resumes"])
        eng.pool.check()
    return out


def run_moved(make, Req, mesh=None):
    """Request 0 preempted with its KV kept after two steps; a new request
    takes its slot, and it resumes in slot 2 (data rank 1's), freed
    first."""
    eng = make(**KV)
    rng = np.random.default_rng(6)
    reqs = [Req(rid=i, prompt=_prompt(rng, n), max_new_tokens=b)
            for i, (n, b) in enumerate(((30, 10), (9, 9), (14, 3), (11, 12),
                                        (7, 8)))]
    for r in reqs[:4]:
        eng.submit(r)
    eng.step()
    eng.step()
    pre = eng.preempt_slot(0, keep_kv=True)
    eng.submit(reqs[4])
    eng.queue.append(pre)
    slot = None
    while eng.has_work():
        eng.step()
        if slot is None and reqs[0] in eng.slot_req:
            slot = eng.slot_req.index(reqs[0])
    out = dict(streams=streams(reqs), slot=slot)
    if isinstance(eng, Engine):
        out.update(moved=eng.memory_stats().moved_pages,
                   resumes=eng.stats["resumes"])
        eng.pool.check()
    return out


def run_placed(make, Req, mesh=None):
    """``kv_pages`` 18 (P = 20: 8 usable pages on data rank 0), no host
    pool: request 0's 56-token prompt and its first decode fill rank 0's
    block from slot 0; request 1, submitted a step later, finds no room
    in the block of slot 1, the first free slot, and takes slot 2 on
    rank 1 (a whole pool of 18 pages takes it in slot 1)."""
    eng = make(kv_pages=18, kv_page_len=8)
    rng = np.random.default_rng(8)
    a = Req(rid=0, prompt=_prompt(rng, 56), max_new_tokens=8)
    b = Req(rid=1, prompt=_prompt(rng, 20), max_new_tokens=6)
    eng.submit(a)
    eng.step()
    eng.submit(b)
    eng.step()
    slot = eng.slot_req.index(b) if b in eng.slot_req else None
    while eng.has_work():
        eng.step()
    out = dict(streams=streams([a, b]), slot=slot)
    if isinstance(eng, Engine):
        eng.pool.check()
    return out


SPEC_KEYS = ("spec_rounds", "spec_draft_tokens", "spec_accepted_tokens",
             "spec_fallbacks")


def run_drafted(make, Req, mesh=None, kv=KV, reqs=None):
    """The plain requests with a drafter (``draft_k`` 3)."""
    eng = make(draft_k=3, **kv)
    reqs = reqs or plain_requests(Req)
    for r in reqs:
        eng.submit(r)
    while eng.has_work():
        eng.step()
    return dict(streams=streams(reqs), spec={k: eng.stats[k]
                                             for k in SPEC_KEYS})


RUNS = dict(plain=run_plain, shared=run_shared, spilled=run_spilled,
            moved=run_moved, drafted=run_drafted, placed=run_placed)


def moe_requests(Req):
    rng = np.random.default_rng(3)
    return [Req(rid=i, prompt=_prompt(rng, 5 + 3 * i), max_new_tokens=6)
            for i in range(5)]


def _moe_build(ckpt, tp, rank, ep, data_rank):
    with torch.no_grad():
        return t_serve.build_rank_params(
            moe_config(), tp=tp, rank=rank, device="cpu", ckpt_dir=ckpt,
            ep=ep, data_rank=data_rank, draft_sparsity=DRAFT, **MOE)


# ---------------------------------------------------------------------------
# the mesh's processes
# ---------------------------------------------------------------------------


def paged_rank(rank: int, spec: dict, init_file: str) -> dict:
    """One process of a (D, T) gloo mesh: every case of ``spec``."""
    torch.set_num_threads(1)
    D, T = spec["shape"]
    mesh = make_mesh(D, T, rank=rank, init_file=init_file, backend="gloo",
                     device="cpu")
    out = {"data_rank": mesh.data_rank}
    if "qwen" in spec["cases"]:
        whole, wcfg, (dwhole, dcfg) = deployed(spec["np"], T)
        params = local_params(whole, wcfg, T, mesh.model_rank)
        draft = (local_params(dwhole, dcfg, T, mesh.model_rank),
                 local_config(dcfg, T))

        def make(**kw):
            if "draft_k" in kw:
                kw["draft"] = draft
            return Engine(params, local_config(wcfg, T),
                          batch_slots=SLOTS, cache_len=CACHE, mesh=mesh,
                          **kw)
        for name, fn in RUNS.items():
            out[name] = fn(make, Request, mesh)
    if "moe" in spec["cases"]:
        ep = t_serve.expert_shards(moe_config(), (D, T), scheduler=False)
        params, _, lcfg, draft = _moe_build(spec["ckpt"], T,
                                            mesh.model_rank, ep,
                                            mesh.data_rank)
        eng = {}

        def make(**kw):
            eng["e"] = Engine(params, lcfg, batch_slots=SLOTS,
                              cache_len=CACHE, mesh=mesh, draft=draft, **kw)
            return eng["e"]
        out["moe"] = run_drafted(make, Request, kv=MOE_KV,
                                 reqs=moe_requests(Request))
        out["moe"]["layout"] = eng["e"].layout
        if D > 1:
            # one scheduler rank a data index, every expert on each
            from repro_torch.serve.scheduler import (SchedulerConfig,
                                                     ShardedScheduler)
            sp, _, scfg, sdraft = _moe_build(spec["ckpt"], T,
                                             mesh.model_rank, 1,
                                             mesh.data_rank)
            sched = ShardedScheduler(sp, scfg, mesh=mesh, draft=sdraft,
                                     sched=SchedulerConfig(
                                         slots_per_rank=2, cache_len=CACHE,
                                         draft_sparsity=DRAFT, draft_k=3,
                                         **MOE_KV))
            done = sched.run(moe_requests(Request))
            me = sched.shards[sched._me]
            out["moe_sched"] = dict(streams=streams(done),
                                    blocks=me.pool.blocks,
                                    rounds=me.stats["spec_rounds"])
    return out


# ---------------------------------------------------------------------------
# the reference's side, the twins and the meshes (the parent only)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's qwen3 weights (times 3) as numpy, its meshless
    paged engine's streams in every scenario; its moonshot weights
    (times 3) in a reference checkpoint, its meshless engine's streams
    with a drafter, and its ``draft_pack``'s expert tiles."""
    jax = pytest.importorskip("jax")
    from repro.configs import get_config as r_get
    from repro.configs import reduced as r_reduced
    from repro.core import deploy as r_deploy
    from repro.launch.serve import build_serving_params
    from repro.models import lm as r_lm
    from repro.serve.engine import Engine as REngine
    from repro.serve.engine import Request as RRequest
    from repro.train.checkpoint import CheckpointManager as RManager

    cfg = r_reduced(r_get("qwen3-32b"), layers=2, d_model=64, vocab=128)
    amp = jax.tree.map(lambda a: a * 3.0,
                       r_lm.init_params(jax.random.PRNGKey(0), cfg))
    sp, sc = build_serving_params(amp, cfg, **DEPLOY)

    def rmake(**kw):
        if "draft_k" in kw:
            kw["draft_sparsity"] = DRAFT
        return REngine(sp, sc, batch_slots=SLOTS, cache_len=CACHE, **kw)
    out = dict(np=jax.tree.map(np.asarray, amp),
               runs={n: fn(rmake, RRequest)["streams"]
                     for n, fn in RUNS.items()})
    mcfg = moe_config("ref")
    mp = jax.tree.map(lambda a: a * 3.0,
                      r_lm.init_params(jax.random.PRNGKey(0), mcfg))
    path = tmp_path_factory.mktemp("ckpt") / "moonshot"
    RManager(str(path)).save(1, {"params": mp})
    msp, msc = build_serving_params(mp, mcfg, verbose=False, **MOE)
    out["moe_ckpt"] = str(path)
    out["moe"] = run_drafted(
        lambda **kw: REngine(msp, msc, batch_slots=SLOTS, cache_len=CACHE,
                             draft_sparsity=DRAFT, **kw),
        RRequest, kv=MOE_KV, reqs=moe_requests(RRequest))["streams"]
    dp_, _ = r_deploy.draft_pack(msp, msc, sparsity=DRAFT)
    out["moe_draft"] = {n: np.asarray(dp_["segments"][0]["slot0"]["ffn"][n]
                                      ["w"]) for n in ("w1", "w2", "w3")}
    return out


@pytest.fixture(scope="module")
def twins(reference):
    """Each qwen3 scenario through the meshless twin at T = 1 and 2
    (``Engine(data_shards=2)``, its drafter ``draft_pack`` at T)."""
    out = {}
    for T in (1, 2):
        whole, wcfg, draft = deployed(reference["np"], T)

        def make(**kw):
            if "draft_k" in kw:
                kw["draft"] = draft
            return Engine(whole, wcfg, batch_slots=SLOTS, cache_len=CACHE,
                          data_shards=2, **kw)
        out[T] = {n: fn(make, Request) for n, fn in RUNS.items()}
    return out


@pytest.fixture(scope="module")
def meshes(reference, tmp_path_factory):
    """Every mesh shape's processes' results, by shape."""
    res = {}
    for shape, cases in SHAPES.items():
        spec = dict(shape=shape, cases=cases, np=reference["np"],
                    ckpt=reference["moe_ckpt"])
        store = init_file_in(str(tmp_path_factory.mktemp("paged")))
        res[shape] = run_ranks(paged_rank, shape[0] * shape[1],
                               (spec, store), timeout=400)
    return res


def qwen_meshes(meshes):
    return [(s, T, meshes[s]) for s, T in (((2, 1), 1), ((2, 2), 2))]


# ---------------------------------------------------------------------------
# the rule
# ---------------------------------------------------------------------------


POOL_CASES = [
    # (mesh shape, leaf shape) -> spec
    ({"data": 2, "model": 1}, (2, 26, 8, 8, 128),
     (None, ("data",), None, "model", None)),
    ({"data": 2, "model": 2}, (2, 26, 8, 8, 128),
     (None, ("data",), None, "model", None)),
    ({"data": 2, "model": 2}, (2, 25, 8, 8, 128),        # P odd: whole
     (None, None, None, "model", None)),
    ({"data": 2, "model": 2}, (2, 26, 8, 1, 128),        # one KV head
     (None, ("data",), None, None, None)),
    ({"data": 2, "model": 2}, (2, 26, 8), (None, ("data",), None)),  # pos
    ({"data": 1, "model": 2}, (2, 26, 8, 8, 128),        # D = 1
     (None, None, None, "model", None)),
    ({"data": 4, "model": 1}, (2, 4096, 32, 8, 128),
     (None, ("data",), None, "model", None)),
    ({"data": 4, "model": 1}, (2, 4094, 32, 8, 128),     # 4094 % 4
     (None, None, None, "model", None)),
    ({"data": 3, "model": 1}, (2, 26, 8, 8, 128),
     (None, None, None, "model", None)),
    ({"pod": 2, "data": 2, "model": 2}, (2, 24, 8, 8, 128),
     (None, ("pod", "data"), None, "model", None)),
    ({"pod": 2, "data": 2, "model": 2}, (2, 26, 8, 8, 128),
     (None, None, None, "model", None)),
]


@pytest.mark.parametrize("sizes,shape,want", POOL_CASES)
def test_pool_axes_follows_the_reference_rule(sizes, shape, want,
                                              monkeypatch):
    """``pool_axes``: the page axis over the DP axes where they hold two
    ranks or more and divide it, the KV-head axis over 'model' where it
    divides, as the case table says and as the reference's
    ``pool_shardings`` gives on a mesh of that shape (its
    ``NamedSharding`` read back as its spec); a scheduler rank's submesh
    (DP collapsed to 1) keeps the pool whole."""
    assert pool_axes(sizes, shape) == want
    D = sizes["data"] * sizes.get("pod", 1)
    assert pool_blocks(sizes, shape[1]) == (D if want[1] else 1)
    assert pool_axes(dict(sizes, data=1, pod=1), shape)[1] is None
    pytest.importorskip("jax")
    import jax
    from repro.distribution import sharding as r_shd
    monkeypatch.setattr(r_shd, "NamedSharding",
                        lambda mesh, spec: tuple(spec))
    fake = types.SimpleNamespace(axis_names=tuple(sizes), shape=sizes)
    got = r_shd.pool_shardings(None, fake, {
        "leaf": jax.ShapeDtypeStruct(shape, np.float32)})["leaf"]
    # a PartitionSpec writes an axis tuple of one as the axis
    assert tuple(_one(e) for e in got) == tuple(_one(e) for e in want)


def _one(e):
    return e[0] if isinstance(e, tuple) and len(e) == 1 else e


def test_block_allocators_count_per_block():
    """A pool of 24 pages cut into 2 blocks of 13: block 0 holds the zero
    and trash pages and 11 usable pages, block 1 13 (its tensors two
    local reserved pages more); watermark, host slots and headroom count
    per block, and global ids map onto each block's tensors."""
    cfg = dataclasses.replace(port_config(), num_layers=1)
    from repro_torch.models import lm
    params = lm.init_params(cfg, seed=0, device="cpu")
    pool = kvmem.PagedKVPool(params, cfg, cache_len=64, device_pages=24,
                             page_len=8, watermark=0.8, host_pages=5,
                             blocks=2)
    a0, a1 = pool.allocs
    assert (a0.n_device, a1.n_device) == (11, 13)
    assert (a0.cap, a1.cap) == (8, 10)
    assert (a0.n_host, a1.n_host) == (3, 2)
    assert sorted(a0.free_dev) == list(range(2, 13))
    assert sorted(a1.free_dev) == list(range(13, 26))
    assert [c.k.shape[1] for d in (pool.block_data(0), pool.block_data(1))
            for c in d[0].values()] == [13, 15]
    assert pool.local([0, 1, 13, 25], 1).tolist() == [0, 1, 2, 14]
    assert pool.local([0, 1, 2, 12], 0).tolist() == [0, 1, 2, 12]
    assert pool.admit(7, 8, block=1) and not pool.admit(8, 3, block=1)
    assert pool.admit(8, 3, block=0)
    assert pool.dev_pages(7)[0] >= 13 and pool.dev_pages(8)[0] < 13
    st = pool.stats()
    assert (st.blocks, st.device_pages, st.watermark, st.device_used) == \
        (2, 24, 18, 11)
    assert pool.admissible_requests() == a0.admissible_requests() + \
        a1.admissible_requests()
    pool.check()
    with pytest.raises(ValueError, match="does not cut"):
        kvmem.PagedKVPool(params, cfg, cache_len=64, device_pages=23,
                          page_len=8, blocks=2)


def test_twin_and_layouts_follow_the_rule(reference):
    """``Engine(data_shards=2)`` takes the cut layout where P = kv_pages +
    2 divides by 2, the slots split and each block's watermark cap holds
    one slot's ring; it refuses where the rule does not cut, the batch
    does not split or a block is too small (the mesh's engine is then
    replicated over 'data')."""
    whole, wcfg, _ = deployed(reference["np"], 1)
    eng = Engine(whole, wcfg, batch_slots=SLOTS, cache_len=CACHE,
                 data_shards=2, **KV)
    assert eng.layout == PAGED_LAYOUT + " (meshless)"
    assert eng.pool.blocks == 2 and eng.pool.held == (0, 1)
    # block 0's caps: 7 usable pages of 9 (P = 18), floor(11 x 0.6) = 6
    # of 13 at watermark 0.6; one slot's ring is 8 pages
    assert kvmem.block_caps(16, 2) == [7, 9]
    assert kvmem.block_caps(24, 2, 0.6) == [6, 7]
    for kw in (dict(batch_slots=SLOTS, kv_pages=23),
               dict(batch_slots=3, kv_pages=24),
               dict(batch_slots=SLOTS, kv_pages=16),
               dict(batch_slots=SLOTS, kv_pages=24, kv_watermark=0.6)):
        with pytest.raises(ValueError, match="data_shards=2"):
            Engine(whole, wcfg, cache_len=CACHE, data_shards=2,
                   kv_page_len=8, **kw)


# ---------------------------------------------------------------------------
# the cut pool on the meshes
# ---------------------------------------------------------------------------


@pytest.mark.timeout(600)
@pytest.mark.parametrize("shape", [(2, 1), (2, 2)], ids=["2x1", "2x2"])
def test_cut_pool_holds_its_block(reference, meshes, shape):
    """Each data rank's pool leaves hold P / D = 13 pages on their page
    axis, two local reserved pages more on data rank 1: its bytes are 13
    (15) 26ths of a whole pool of the rank's heads."""
    D, T = shape
    whole, wcfg, _ = deployed(reference["np"], T)
    pool = kvmem.PagedKVPool(local_params(whole, wcfg, T, 0),
                             local_config(wcfg, T), cache_len=CACHE,
                             device_pages=KV["kv_pages"],
                             page_len=KV["kv_page_len"])
    assert pool.nbytes() % 26 == 0
    for out in meshes[shape]:
        d = out["data_rank"]
        got = out["plain"]
        assert got["layout"] == PAGED_LAYOUT
        assert got["pages"] == {d: [13 + (2 if d else 0)]}
        assert got["nbytes"] == pool.nbytes() // 26 * (13 + (2 if d else 0))


@pytest.mark.timeout(600)
@pytest.mark.parametrize("name", SCENARIOS)
def test_cut_pool_bit_for_bit_twin_and_reference(reference, twins, meshes,
                                                 name):
    """Every scenario on (2, 1) and (2, 2): every process's streams (and
    counters) are the meshless twin's, and the streams the reference's
    meshless paged engine's; the plain run's decode logits bit for bit
    the twin's rows."""
    want = reference["runs"][name]
    for shape, T, res in qwen_meshes(meshes):
        twin = twins[T][name]
        assert twin["streams"] == want, (shape, name)
        for out in res:
            got = out[name]
            assert got["streams"] == want, (shape, name)
            for k in twin:
                if k in ("steps", "record", "layout", "pages", "nbytes"):
                    continue
                assert got[k] == twin[k], (shape, name, k)
        if name == "plain":
            for out in res:
                d = out["data_rank"]
                steps = out["plain"]["steps"]
                assert len(steps) == len(twin["steps"]) > 0
                for a, b in zip(steps, twin["steps"]):
                    assert np.array_equal(a, b[2 * d:2 * d + 2]), shape


@pytest.mark.timeout(600)
def test_prefix_shared_on_both_ranks(reference, twins, meshes):
    """A 3-page prefix shared by slots on both data ranks: each rank maps
    its own block's pages (the second request on each rank hits), the
    first request on rank 1 prefills it again and counts the 3 pages
    that rank 0 held (``prefix_pages_elsewhere``)."""
    for T in (1, 2):
        tw = twins[T]["shared"]
        assert (tw["hits"], tw["reused"], tw["elsewhere"], tw["skipped"]) \
            == (2, 6, 3, 48)


@pytest.mark.timeout(600)
def test_spill_and_fault_inside_a_block(reference, twins, meshes):
    """Data rank 0's 8 usable pages run out: request 0's kept pages spill
    to rank 0's host slots and fault back into rank 0's block, no page
    dropped or moved; the reference's meshless engine (one pool of 18)
    never spills, with the same streams."""
    for T in (1, 2):
        tw = twins[T]["spilled"]
        assert tw["spills"] >= 1 and tw["faults"] >= 1, tw
        assert tw["drops"] == 0 and tw["moved"] == 0 and tw["resumes"] == 1


@pytest.mark.timeout(600)
def test_kept_kv_resumes_on_the_other_rank(reference, twins, meshes):
    """Request 0, preempted with its KV kept in data rank 0's block,
    resumes in slot 2: its 4 pages move once to rank 1's block."""
    for T in (1, 2):
        tw = twins[T]["moved"]
        assert tw["slot"] == 2 and tw["moved"] == 4 and tw["resumes"] == 1


@pytest.mark.timeout(600)
def test_admission_passes_over_a_full_block(reference, twins, meshes):
    """Data rank 0's block full, rank 1's with room: the request goes to
    slot 2, the first free slot of a block that takes it, in the twin
    and in every process, in the step it is submitted."""
    for T in (1, 2):
        assert twins[T]["placed"]["slot"] == 2
    for _, _, res in qwen_meshes(meshes):
        assert [out["placed"]["slot"] for out in res] == [2] * len(res)


@pytest.mark.timeout(600)
def test_drafter_rounds_equal_the_twin(reference, twins, meshes):
    """``draft_k`` 3: each data rank drafts and verifies its own rows; the
    rounds, drafted and accepted counts are the twin's, in every
    process, and drafts are accepted."""
    for T in (1, 2):
        spec = twins[T]["drafted"]["spec"]
        assert spec["spec_rounds"] > 0 and spec["spec_accepted_tokens"] > 0


@pytest.mark.timeout(600)
@pytest.mark.parametrize("shape", [(2, 1), (2, 2)], ids=["2x1", "2x2"])
def test_plain_decode_moves_no_kv_over_data(meshes, shape):
    """A decode step with every slot busy and nothing to admit: the only
    collective over 'data' is the all-gather of the (B,) sampled ids, D
    x B int32; no KV byte crosses 'data'."""
    D, _ = shape
    for out in meshes[shape]:
        rec = out["plain"]["record"]
        over = {(k, a): v for k, axes in rec.items() for a, v in axes.items()
                if "data" in a}
        assert over == {("all-gather", "data"): {"calls": 1,
                                                 "bytes": D * SLOTS * 4}}


# ---------------------------------------------------------------------------
# a MoE drafter on a mesh
# ---------------------------------------------------------------------------


@pytest.mark.timeout(600)
@pytest.mark.parametrize("shape", [(2, 1), (1, 2)], ids=["2x1", "1x2"])
def test_moe_drafter_on_mesh_equals_reference(reference, meshes, shape):
    """Reduced moonshot with a drafter, built rank by rank: every process's
    streams and speculation counters are its meshless twin's
    (``build_rank_params(rank=None)``, ``Engine(data_shards=D)``), and
    the streams the reference's meshless ``Engine(draft_sparsity=0.75)``;
    on (2, 1) the pool is cut and the experts in EP over 'data'."""
    D, T = shape
    ep = t_serve.expert_shards(moe_config(), shape, scheduler=False)
    assert ep == D
    params, tcfg, _, draft = _moe_build(reference["moe_ckpt"], T, None, ep,
                                        0)
    assert draft[1].ep_shards == ep
    twin = run_drafted(
        lambda **kw: Engine(params, tcfg, batch_slots=SLOTS, cache_len=CACHE,
                            data_shards=D, draft=draft, **kw),
        Request, kv=MOE_KV, reqs=moe_requests(Request))
    assert twin["streams"] == reference["moe"]
    assert twin["spec"]["spec_rounds"] > 0
    for out in meshes[shape]:
        got = out["moe"]
        assert got["layout"] == (PAGED_LAYOUT if D > 1 else None)
        assert got["streams"] == twin["streams"]
        assert got["spec"] == twin["spec"]


@pytest.mark.timeout(600)
@pytest.mark.parametrize("shape", [(2, 1), (1, 2)], ids=["2x1", "1x2"])
def test_moe_drafter_expert_masks_equal_draft_pack(reference, shape):
    """Every (data, model) rank's drafter experts, built one at a time:
    their live 32 x 32 tiles are the rank's experts and d_ff slice of
    the reference's ``draft_pack`` on the deployed target."""
    D, T = shape
    E = moe_config().moe.num_experts
    for d in range(D):
        for m in range(T):
            _, _, _, (dparams, _) = _moe_build(reference["moe_ckpt"], T, m,
                                               D, d)
            for n, want in reference["moe_draft"].items():
                got = dparams["segments"][0]["slot0"]["ffn"][n]["w"]
                want = want[:, d * E // D:(d + 1) * E // D]
                cut = want.shape[-1 if n != "w2" else -2] // T
                want = (want[..., m * cut:(m + 1) * cut] if n != "w2"
                        else want[..., m * cut:(m + 1) * cut, :])
                assert tuple(got.shape) == want.shape, (n, d, m)
                assert np.array_equal(_tiles(got.float().numpy()),
                                      _tiles(want)), (n, d, m)


@pytest.mark.timeout(600)
def test_moe_drafter_on_a_mesh_scheduler(reference, meshes):
    """``ShardedScheduler(mesh=(2, 1))`` with the MoE drafter built for
    each scheduler rank (every expert, the pool whole on its submesh, as
    the rule says where DP collapses to 1): the reference's meshless
    streams, speculation on every rank."""
    for out in meshes[(2, 1)]:
        got = out["moe_sched"]
        assert got["blocks"] == 1 and got["rounds"] > 0
        assert got["streams"] == reference["moe"]


def _tiles(w, b=32):
    """The live (nonzero) b x b tiles of (…, din, dout) weights."""
    *lead, r, c = w.shape
    t = w.reshape(tuple(lead) + (r // b, b, c // b, b))
    return (t != 0).any(axis=(-3, -1))


def test_launcher_serves_a_moe_drafter_on_a_mesh():
    """``--mesh`` with ``--draft-sparsity`` for a MoE arch parses: the
    refusal is gone."""
    args = t_serve.parse_args(["--arch", "moonshot-v1-16b-a3b", "--mesh",
                               "2,1", "--sasp", "0.5", "--path", "packed",
                               "--kv-pages", "10", "--draft-sparsity",
                               "0.75", "--device", "cpu"])
    assert args.mesh == (2, 1)
