"""The port's paged KV memory (``repro_torch.serve.memory``) against the
reference's: the page allocator move for move on drawn operation
sequences, the tile-aligned page length, and paged / host-spill /
preempted / shared-prefix engine streams against the JAX engine with the
same options (greedy, fp32, the reduced qwen3-32b of the reference's
tests/test_memory.py), with the allocator's ``check()`` and no leaked
page."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:                      # the fixed twin below still runs
    HAVE_HYPOTHESIS = False

from repro.configs import SASPConfig  # noqa: E402
from repro.models import lm  # noqa: E402
from repro.serve import memory as ref_mem  # noqa: E402
from repro.serve.engine import Engine, Request  # noqa: E402
from repro_torch.configs import SASPConfig as TSASPConfig  # noqa: E402
from repro_torch.serve import memory as t_mem  # noqa: E402
from repro_torch.serve.engine import Engine as TEngine  # noqa: E402
from repro_torch.serve.engine import Request as TRequest  # noqa: E402
from torch_parity import KEY, bridged, configs  # noqa: E402

VOCAB = 64


@pytest.fixture(scope="module")
def amp():
    """(ref cfg, port cfg, ref params, port params): the reduced dense
    model with every weight times 3 (position-dependent streams, as in
    the reference's tests/test_memory.py)."""
    cfg, tcfg = configs()
    cfg = dataclasses.replace(cfg, sasp=SASPConfig())
    tcfg = dataclasses.replace(tcfg, sasp=TSASPConfig())
    params = jax.tree.map(lambda a: a * 3.0, lm.init_params(KEY, cfg))
    return cfg, tcfg, params, bridged(params)


def _reqs(cls, specs):
    """specs: (rid, prompt, max_new, extra kwargs) -> fresh requests."""
    return [cls(rid=rid, prompt=np.asarray(p, np.int32).copy(),
                max_new_tokens=n, **kw) for rid, p, n, kw in specs]


def _mk(n, seed, max_new=6, eos=False):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, VOCAB, size=(int(rng.integers(4, 30)),)),
             max_new, {"eos_id": int(rng.integers(0, VOCAB))} if eos
             else {}) for i in range(n)]


def _check_pool(eng):
    """The port's pool checks each block's allocator; the reference's
    has one, ``alloc``."""
    if isinstance(eng, TEngine):
        eng.pool.check()
    else:
        eng.pool.alloc.check()


def _drive(eng, reqs):
    for r in reqs:
        eng.submit(r)
    done = []
    while eng.has_work():
        done.extend(eng.step())
        if eng.pool is not None:
            _check_pool(eng)
    return {r.rid: list(r.out_tokens) for r in done}


def _both(amp, specs, **kw):
    """The same requests through the JAX engine and the port's, with
    the same options: (reference streams, port streams, port engine)."""
    cfg, tcfg, params, tparams = amp
    want = _drive(Engine(params, cfg, **kw), _reqs(Request, specs))
    eng = TEngine(tparams, tcfg, **kw)
    return want, _drive(eng, _reqs(TRequest, specs)), eng


def _no_leak(eng):
    mem = eng.memory_stats()
    assert mem.device_used == mem.cached_pages, mem.as_dict()
    assert mem.host_used == 0 and not eng.pool.allocs[0].rc, mem.as_dict()
    eng.pool.check()


# ---------------------------------------------------------------------------
# Page geometry
# ---------------------------------------------------------------------------


def test_tile_aligned_page_len_equals_reference():
    for block in (None, 8, 16, 32):
        for cache_len in (32, 64, 96, 256):
            for page_len in (None, 8, 12, 16, 24, 32, 64, 300):
                kw = {} if block is None else dict(
                    enabled=True, block_k=block, block_n=block,
                    sparsity=0.25)
                cfg, tcfg = configs()
                cfg = dataclasses.replace(cfg, sasp=SASPConfig(**kw))
                tcfg = dataclasses.replace(tcfg, sasp=TSASPConfig(**kw))
                try:
                    want = ref_mem.tile_aligned_page_len(cfg, cache_len,
                                                         page_len)
                except ValueError as e:
                    with pytest.raises(ValueError) as got:
                        t_mem.tile_aligned_page_len(tcfg, cache_len,
                                                    page_len)
                    assert str(got.value) == str(e)
                    continue
                assert t_mem.tile_aligned_page_len(
                    tcfg, cache_len, page_len) == want


# ---------------------------------------------------------------------------
# The allocator, move for move against the reference's
# ---------------------------------------------------------------------------

_CHAINS = tuple(tuple(bytes([c, j]) for j in range(4)) for c in range(3))
_OPS = ("admit", "ensure", "cow", "preempt", "resume", "free", "dedup",
        "scratch", "promote", "discard")


def _state(a):
    """Everything the allocator holds, in comparable form."""
    return dict(
        tables=a.tables, free_dev=a.free_dev, free_host=a.free_host,
        resident=sorted(a.resident), preempted=a.preempted, rc=a.rc,
        cached=a.cached, node_of=sorted(a._node_of), scratch=a.scratch,
        keys=a._keys, counts=(a.spills, a.faults, a.drops, a.prefix_hits,
                              a.prefix_pages_reused, a.cow, a.evictions,
                              a.dedup_merges),
        headroom=a.headroom())


def _apply(a, op, x, y, z):
    """One drawn operation; its picks are indices into sorted views, so
    allocators in equal states take equal operations."""
    def pick(seq):
        seq = sorted(seq)
        return seq[x % len(seq)] if seq else None

    if op == "admit":
        rid = 1000 + len(a.tables) + a.drops + x
        while a.has(rid):
            rid += 1
        keys = _CHAINS[y % 3][:1 + z % 4]
        out = a.admit_prefix(rid, 1 + z % 4, keys)
        if out[0]:
            a.register_prefix(rid, keys[:y % 5])
        return out
    if op == "dedup":
        return a.dedup_sweep()
    if op in ("preempt", "ensure", "cow", "scratch"):
        rid = pick(r for r in a.resident if r not in a.scratch)
        if rid is None:
            return None
        refs = a.tables[rid]
        if op == "preempt":
            return a.preempt(rid)
        if op == "ensure":
            js = [j for j, e in enumerate(refs) if e is None]
            return a.ensure(rid, js[y % len(js)]) if js else None
        if op == "cow":
            js = [j for j, e in enumerate(refs) if e is not None]
            return a.make_writable(rid, js[y % len(js)]) if js else None
        js = sorted({(y + t) % a.NB for t in range(1 + z % 2)})
        return a.alloc_scratch(rid, js)
    if op in ("promote", "discard"):
        rid = pick(a.scratch)
        if rid is None:
            return None
        if op == "discard":
            return a.discard_scratch(rid)
        return a.promote_scratch(rid, sorted(a.scratch[rid])[y % len(
            a.scratch[rid])])
    if op == "resume":
        rid = pick(a.preempted)
        return None if rid is None else a.resume(rid)
    rid = pick(r for r in a.tables if r not in a.scratch)
    return None if rid is None else a.free(rid)


def _run_pair(ops, share):
    args = (range(2, 14),)
    kw = dict(host_slots=5, watermark_cap=10, slot_pages=4, share=share)
    ref, mine = ref_mem.PageAllocator(*args, **kw), \
        t_mem.PageAllocator(*args, **kw)
    for op, x, y, z in ops:
        want = _apply(ref, op, x, y, z)
        got = _apply(mine, op, x, y, z)
        assert got == want, (op, got, want)
        assert _state(mine) == _state(ref), op
        ref.check()
        mine.check()


# a fixed sequence through every operation: admit, fork, COW, growth,
# scratch promote / discard, preempt, spill under pressure, fault back,
# dedup, free
_FIXED = [("admit", 0, 0, 1), ("admit", 0, 4, 1), ("admit", 1, 0, 3),
          ("cow", 0, 1, 0), ("ensure", 1, 0, 0), ("scratch", 0, 2, 1),
          ("promote", 0, 0, 0), ("discard", 0, 0, 0), ("preempt", 0, 0, 0),
          ("admit", 2, 1, 3), ("admit", 3, 2, 3), ("resume", 0, 0, 0),
          ("dedup", 0, 0, 0), ("free", 0, 0, 0), ("admit", 0, 0, 3),
          ("scratch", 1, 1, 0), ("free", 1, 0, 0), ("preempt", 1, 0, 0),
          ("resume", 0, 0, 0), ("free", 0, 0, 0), ("free", 0, 0, 0),
          ("free", 0, 0, 0), ("free", 0, 0, 0)]


@pytest.mark.parametrize("share", [False, True])
def test_allocator_fixed_sequence_matches_reference(share):
    _run_pair(_FIXED, share)


if HAVE_HYPOTHESIS:

    @pytest.mark.parametrize("share", [False, True])
    @settings(max_examples=60, deadline=None)
    @given(ops=st.lists(st.tuples(st.sampled_from(_OPS),
                                  st.integers(0, 7), st.integers(0, 7),
                                  st.integers(0, 7)), max_size=40))
    def test_allocator_matches_reference_move_for_move(share, ops):
        """Drawn sequences of admit (with shared prefixes), ensure,
        make_writable, scratch, preempt, resume, free and dedup: equal
        moves, equal state, and both ``check()`` after every step."""
        _run_pair(ops, share)


def test_pool_spill_and_fault_keep_the_data():
    """A failed admission still executes its partial spills: the
    victim's pages reach the host pool and fault back unchanged."""
    _, tcfg = configs()
    tcfg = dataclasses.replace(tcfg, sasp=TSASPConfig())
    from repro_torch.models import lm as tlm
    tparams = tlm.init_params(tcfg, seed=0, device="cpu")
    pool = t_mem.PagedKVPool(tparams, tcfg, cache_len=64, device_pages=4,
                             page_len=16, host_pages=4)
    assert pool.admit(0, 2) and pool.admit(1, 2)
    pages = [p for p in pool.dev_pages(1) if p is not None]
    for _, _, c in t_mem._caches(pool.block_data(0)):
        for a in c:
            if a is not None:
                a[:, pages] = 7
    pool.preempt(1)
    assert not pool.admit(2, 3)
    assert pool.stats().spills == 2 and pool.stats().host_used == 2
    assert pool.resume(1)
    got = pool._read([p for p in pool.dev_pages(1) if p is not None])
    for _, _, c in t_mem._caches(got):
        for a in c:
            if a is not None:
                assert bool((a == 7).all()), "spilled data lost"
    pool.check()


# ---------------------------------------------------------------------------
# Engine streams against the JAX engine with the same options
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv_pages,host", [(24, 0), (10, 8)])
def test_paged_streams_equal_reference_and_no_leak(amp, kv_pages, host):
    """An ample pool and an oversubscribed one (admission defers, slots
    refill as pages free), EOS on: streams equal the JAX engine's and
    the port's contiguous engine's; every page is free at the end."""
    specs = _mk(7, 0, eos=True)
    want, got, eng = _both(amp, specs, batch_slots=4, cache_len=64,
                           kv_pages=kv_pages, kv_page_len=8,
                           kv_host_pages=host)
    _, tcfg, _, tparams = amp
    contig = _drive(TEngine(tparams, tcfg, batch_slots=4, cache_len=64),
                    _reqs(TRequest, specs))
    assert got == want == contig
    _no_leak(eng)


def test_paged_bucketed_admission_equal_reference(amp):
    rng = np.random.default_rng(6)
    specs = [(i, rng.integers(0, VOCAB, size=(int(rng.integers(2, 60)),)),
              2, {}) for i in range(12)]
    want, got, eng = _both(amp, specs, batch_slots=2, cache_len=64,
                           buckets=(8, 16, 32, 64), kv_pages=16,
                           kv_page_len=8)
    assert got == want
    _no_leak(eng)


def test_paged_int8_kv_equal_reference_and_contiguous(amp):
    cfg, tcfg, params, tparams = amp
    q = (dataclasses.replace(cfg, kv_quant=True),
         dataclasses.replace(tcfg, kv_quant=True), params, tparams)
    specs = _mk(4, 2)
    want, got, eng = _both(q, specs, batch_slots=2, cache_len=64,
                           kv_pages=16, kv_page_len=8)
    contig = _drive(TEngine(tparams, q[1], batch_slots=2, cache_len=64),
                    _reqs(TRequest, specs))
    assert got == want == contig
    _no_leak(eng)


def _preempt_cycle(eng, first, second, steps=4):
    """Serve ``first`` alone for ``steps`` steps, preempt it (pages
    kept), put ``second`` ahead of it and drain."""
    eng.submit(first)
    for _ in range(steps):
        eng.step()
    victim = eng.preempt_slot(0, keep_kv=True)
    eng.queue[:0] = [second, victim]
    done = []
    while eng.has_work():
        done.extend(eng.step())
        if eng.pool is not None:
            _check_pool(eng)
    return {r.rid: list(r.out_tokens) for r in done}


@pytest.mark.parametrize("host", [8, 0])
def test_preempt_spill_fault_or_drop_equal_reference(amp, host):
    """A request is preempted (pages unmapped); a 40-token prompt then
    needs the room, so its pages spill to the host pool and fault back
    on resume (host 8), or are dropped and re-prefilled (host 0).
    Streams equal the JAX engine's on the same cycle and solo runs."""
    cfg, tcfg, params, tparams = amp
    rng = np.random.default_rng(4)
    specs = [(0, rng.integers(0, VOCAB, size=(18,)), 14, {}),
             (1, rng.integers(0, VOCAB, size=(40,)), 3, {})]
    kw = dict(batch_slots=1, cache_len=64, kv_pages=8, kv_page_len=8,
              kv_host_pages=host)
    want = _preempt_cycle(Engine(params, cfg, **kw), *_reqs(Request, specs))
    eng = TEngine(tparams, tcfg, **kw)
    got = _preempt_cycle(eng, *_reqs(TRequest, specs))
    solo = {s[0]: TEngine(tparams, tcfg, batch_slots=1, cache_len=64).run(
        _reqs(TRequest, [s]))[0].out_tokens for s in specs}
    assert got == want == solo
    mem = eng.memory_stats()
    if host:
        assert mem.spills >= 1 and mem.faults >= 1, mem.as_dict()
    else:
        assert mem.drops >= 1 and mem.spills == 0, mem.as_dict()
    _no_leak(eng)


def test_preempt_keep_kv_false_frees_pages(amp):
    _, tcfg, _, tparams = amp
    rng = np.random.default_rng(7)
    specs = [(0, rng.integers(0, VOCAB, size=(12,)), 8, {})]
    solo = TEngine(tparams, tcfg, batch_slots=1, cache_len=64).run(
        _reqs(TRequest, specs))[0].out_tokens
    eng = TEngine(tparams, tcfg, batch_slots=1, cache_len=64, kv_pages=8,
                  kv_page_len=8)
    (req,) = _reqs(TRequest, specs)
    eng.submit(req)
    for _ in range(3):
        eng.step()
    victim = eng.preempt_slot(0, keep_kv=False)
    assert eng.memory_stats().device_used == 0
    eng.submit(victim)
    assert _drive(eng, [])[0] == solo
    assert eng.stats["resumes"] == 1 and eng.stats["reprefill_tokens"] > 0


def test_admission_capacity_and_headroom_follow_the_pool(amp):
    _, tcfg, _, tparams = amp
    eng = TEngine(tparams, tcfg, batch_slots=4, cache_len=64, kv_pages=8,
                  kv_page_len=8)
    assert eng.admission_capacity() == 4
    assert eng.route_headroom_tokens() == 64
    rng = np.random.default_rng(8)
    eng.submit(TRequest(rid=0, prompt=rng.integers(0, VOCAB, size=(60,))
                        .astype(np.int32), max_new_tokens=4))
    eng.step()                                      # 8 of 8 pages held
    assert eng.n_free() == 3
    assert eng.admission_capacity() == 0 and eng.route_headroom_tokens() == 0
    contig = TEngine(tparams, tcfg, batch_slots=2, cache_len=64)
    assert contig.admission_capacity() == 2
    assert contig.route_headroom_tokens() is None
    assert contig.memory_stats() is None


# ---------------------------------------------------------------------------
# Prefix sharing
# ---------------------------------------------------------------------------

_SHARE = dict(cache_len=64, kv_pages=14, kv_page_len=8, kv_host_pages=8)


def test_share_fanout_equal_reference_and_leak_free(amp):
    """One prompt, six greedy requests through two slots: later arrivals
    map the first admission's pages. Streams equal the JAX sharing
    engine's and the port's sharing-off engine's."""
    _, tcfg, _, tparams = amp
    prompt = np.random.default_rng(21).integers(0, VOCAB, size=(25,))
    specs = [(i, prompt, 7, {}) for i in range(6)]
    want, got, eng = _both(amp, specs, batch_slots=2, kv_share=True,
                           **_SHARE)
    off = _drive(TEngine(tparams, tcfg, batch_slots=2, **_SHARE),
                 _reqs(TRequest, specs))
    assert got == want == off
    mem = eng.memory_stats()
    assert mem.prefix_hits > 0 and mem.prefix_pages_reused > 0
    assert eng.stats["prefill_tokens_skipped"] > 0
    _no_leak(eng)


@pytest.mark.parametrize("d", [0, 1, 7, 8])
def test_share_divergence_at_page_boundaries_equal_reference(amp, d):
    """Two prompts share 16 + d tokens: exactly (16 + d) // 8 pages are
    mapped shared, and streams equal the JAX engine's."""
    base = np.random.default_rng(22).integers(0, VOCAB, size=(25,))
    var = base.copy()
    var[16 + d] = (var[16 + d] + 1) % VOCAB
    specs = [(0, base, 6, {}), (1, var, 6, {})]
    want, got, eng = _both(amp, specs, batch_slots=1, kv_share=True,
                           **_SHARE)
    assert got == want
    assert eng.memory_stats().prefix_pages_reused == (16 + d) // 8
    _no_leak(eng)


def test_share_multi_turn_chat_equal_reference(amp):
    """Each turn's prompt is the whole conversation so far: sharing skips
    the resident prefix, and every turn equals the JAX engine's."""
    cfg, tcfg, params, tparams = amp
    rng = np.random.default_rng(23)
    sys_prompt = rng.integers(0, VOCAB, size=(9,)).astype(np.int32)
    turns = [rng.integers(0, VOCAB, size=(5,)).astype(np.int32)
             for _ in range(3)]

    def replay(eng, cls):
        history, streams = sys_prompt, []
        for t, turn in enumerate(turns):
            prompt = np.concatenate([history, turn]).astype(np.int32)
            out = eng.run([cls(rid=t, prompt=prompt, max_new_tokens=5)]
                          )[0].out_tokens
            streams.append(list(out))
            history = np.concatenate([prompt, np.asarray(out, np.int32)])
        return streams

    want = replay(Engine(params, cfg, batch_slots=2, kv_share=True,
                         **_SHARE), Request)
    eng = TEngine(tparams, tcfg, batch_slots=2, kv_share=True, **_SHARE)
    assert replay(eng, TRequest) == want
    assert eng.stats["prefill_tokens_skipped"] > 0
    assert eng.memory_stats().prefix_hits >= 2
    eng.pool.check()


def test_share_ring_wrap_cow_equal_reference(amp):
    """Decode past the ring's capacity wraps into the shared prompt
    pages, which are copy-on-written first."""
    sys_prompt = np.random.default_rng(24).integers(0, VOCAB, size=(24,))
    specs = [(i, np.concatenate([sys_prompt, [i + 1]]), 45, {})
             for i in range(4)]
    want, got, eng = _both(amp, specs, batch_slots=2, kv_share=True,
                           **_SHARE)
    assert got == want
    assert eng.memory_stats().cow_copies >= 1
    _no_leak(eng)


def test_share_preempt_spill_resume_equal_reference(amp):
    """Two requests fork a shared prompt; a long prompt preempts the
    running one, its private pages spill and fault back on resume."""
    cfg, tcfg, params, tparams = amp
    rng = np.random.default_rng(25)
    shared = rng.integers(0, VOCAB, size=(17,))
    specs = [(0, shared, 12, {}), (1, np.concatenate([shared, [3]]), 12, {}),
             (2, rng.integers(0, VOCAB, size=(40,)), 3, {})]
    kw = dict(batch_slots=1, cache_len=64, kv_pages=8, kv_page_len=8,
              kv_host_pages=10, kv_share=True)

    def cycle(eng, reqs):
        eng.submit(reqs[0])
        for _ in range(4):
            eng.step()
        eng.queue.insert(0, eng.preempt_slot(0))
        eng.submit(reqs[1])
        for _ in range(2):
            eng.step()
        eng.queue.insert(0, reqs[2])
        eng.queue.insert(1, eng.preempt_slot(0))
        done = []
        while eng.has_work():
            done.extend(eng.step())
            if eng.pool is not None:
                _check_pool(eng)
        return {r.rid: list(r.out_tokens) for r in done}

    want = cycle(Engine(params, cfg, **kw), _reqs(Request, specs))
    eng = TEngine(tparams, tcfg, **kw)
    got = cycle(eng, _reqs(TRequest, specs))
    assert got == want
    mem = eng.memory_stats()
    assert mem.spills >= 1 and mem.faults >= 1, mem.as_dict()
    _no_leak(eng)


def test_dedup_sweep_engine_streams_equal_reference(amp):
    """Same-prompt requests admitted in one group hold private twins;
    the sweep every step re-links them, streams unchanged."""
    prompt = np.random.default_rng(26).integers(0, VOCAB, size=(20,))
    specs = [(i, prompt, 6, {}) for i in range(3)]
    want, got, eng = _both(amp, specs, batch_slots=3, kv_share=True,
                           kv_dedup_every=1, **_SHARE)
    assert got == want
    assert eng.memory_stats().dedup_merges > 0
    _no_leak(eng)


def test_packed_paged_streams_equal_reference():
    """The packed SASP path (bridged containers, 16x16 tiles): paged and
    sharing streams with 16-token pages equal the JAX engine's."""
    from repro.core.deploy import deploy_packed
    from repro.core.pruning import prune_params
    from repro_torch.core import deploy as t_deploy
    from repro_torch.core import pruning as t_pruning
    cfg, tcfg = configs(scope="all", sparsity=0.25)
    params = lm.init_params(KEY, cfg)
    ref, rcfg = deploy_packed(prune_params(params, cfg.sasp)[0], cfg)
    mine, mcfg = t_deploy.deploy_packed(
        t_pruning.prune_params(bridged(params), tcfg.sasp)[0], tcfg)
    prompt = np.random.default_rng(27).integers(0, VOCAB, size=(35,))
    specs = [(0, prompt, 5, {}), (1, prompt[:33], 5, {}),
             (2, prompt[:20], 5, {})]
    kw = dict(batch_slots=2, cache_len=64, kv_pages=12, kv_share=True)
    want, got, eng = _both((rcfg, mcfg, ref, mine), specs, **kw)
    assert got == want
    assert eng.pool.page_len == 16
    _no_leak(eng)


def test_one_layer_pool_scrubs_and_copies_pages():
    """A one-layer stack (pool leaves (1, P, L, …)): decode growth
    scrubs recycled pages and the ring wrap copy-on-writes shared ones,
    with streams equal to the contiguous engine's."""
    _, tcfg = configs(layers=1)
    tcfg = dataclasses.replace(tcfg, sasp=TSASPConfig())
    from repro_torch.models import lm as tlm
    tparams = tlm.init_params(tcfg, seed=1, device="cpu")
    prompt = np.random.default_rng(28).integers(0, VOCAB, size=(20,))
    specs = [(i, np.concatenate([prompt, [i]]), 40, {}) for i in range(3)]
    def staggered(eng):
        reqs = _reqs(TRequest, specs)
        eng.submit(reqs[0])
        eng.step()                   # the first prompt's pages registered
        return _drive(eng, reqs[1:]) | {0: reqs[0].out_tokens}

    want = staggered(TEngine(tparams, tcfg, batch_slots=2, cache_len=32))
    eng = TEngine(tparams, tcfg, batch_slots=2, cache_len=32, kv_pages=9,
                  kv_page_len=8, kv_share=True)
    assert staggered(eng) == want
    assert eng.memory_stats().cow_copies >= 1
    _no_leak(eng)


def test_paged_local_window_stack_equal_reference():
    """gemma3's local:global layers: the pool gives every layer the full
    ring (local layers lose their window-sized cap), and the window mask
    keeps the streams equal to the JAX engine's, paged and shared."""
    from repro.configs import get_config, reduced
    from repro_torch.configs import get_config as t_get_config
    from repro_torch.configs import reduced as t_reduced
    cfg = reduced(get_config("gemma3-4b"), layers=2, d_model=64,
                  vocab=VOCAB)
    tcfg = t_reduced(t_get_config("gemma3-4b"), layers=2, d_model=64,
                     vocab=VOCAB)
    assert cfg.sliding_window and tcfg.sliding_window
    params = jax.tree.map(lambda a: a * 3.0, lm.init_params(KEY, cfg))
    g = (cfg, tcfg, params, bridged(params))
    specs = _mk(4, 3, max_new=8)
    want, got, eng = _both(g, specs, batch_slots=2, cache_len=64,
                           kv_pages=20, kv_page_len=8)
    assert got == want
    _no_leak(eng)
    eng = TEngine(g[3], tcfg, batch_slots=2, cache_len=64, kv_pages=20,
                  kv_page_len=8, kv_share=True)
    assert _drive(eng, _reqs(TRequest, specs)) == want
    _no_leak(eng)
