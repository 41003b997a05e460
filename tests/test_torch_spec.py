"""Self-speculative decoding in the port's engine: with a drafter (the
same weights re-packed higher on the sparsity ladder) every stream
equals the engine's without one, temperature > 0 included, and greedy
streams equal the JAX engine's (the reference's tests/test_spec_decode.py
scenarios, reduced qwen3-32b in fp32). Drafter stubs pin the acceptance
offset or propose garbage; scratch pages never outlive a round."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.configs import SASPConfig  # noqa: E402
from repro.models import lm  # noqa: E402
from repro.serve.engine import Engine, Request  # noqa: E402
from repro_torch.configs import SASPConfig as TSASPConfig  # noqa: E402
from repro_torch.core import deploy as t_deploy  # noqa: E402
from repro_torch.kernels.sasp_gemm import fused_ffn, gemm  # noqa: E402
from repro_torch.serve.engine import Engine as TEngine  # noqa: E402
from repro_torch.serve.engine import Request as TRequest  # noqa: E402
from torch_parity import KEY, bridged, configs  # noqa: E402

VOCAB = 64


@pytest.fixture(scope="module")
def amp():
    """The reduced dense model, every weight times 3 (as the reference's
    spec tests): (ref cfg, port cfg, ref params, port params)."""
    cfg, tcfg = configs()
    cfg = dataclasses.replace(cfg, sasp=SASPConfig())
    tcfg = dataclasses.replace(tcfg, sasp=TSASPConfig())
    params = jax.tree.map(lambda a: a * 3.0, lm.init_params(KEY, cfg))
    return cfg, tcfg, params, bridged(params)


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


def _engine(tparams, tcfg, draft=None, **kw):
    kw.setdefault("batch_slots", 2)
    kw.setdefault("cache_len", 64)
    kw.setdefault("kv_pages", 20)
    kw.setdefault("kv_page_len", 8)
    if draft is not None:
        kw.setdefault("draft_sparsity", draft)
    return TEngine(tparams, tcfg, **kw)


def _spec_clean(eng):
    assert not eng.pool.allocs[0].scratch, eng.pool.allocs[0].scratch
    assert eng.pool.stats().scratch_pages == 0
    eng.pool.check()


def _mixed(cls):
    """Greedy batch, greedy with EOS, interactive, temperature 0.8."""
    rng = np.random.default_rng(3)

    def p(n):
        return rng.integers(0, VOCAB, size=(n,)).astype(np.int32)
    return [cls(rid=0, prompt=p(11), max_new_tokens=9),
            cls(rid=1, prompt=p(7), max_new_tokens=12, eos_id=5),
            cls(rid=2, prompt=p(9), max_new_tokens=8, slo="interactive"),
            cls(rid=3, prompt=p(8), max_new_tokens=7, temperature=0.8)]


@pytest.fixture(scope="module")
def mixed_ref(amp):
    """The JAX paged engine's greedy streams of the mixed workload, and
    the port's streams without a drafter."""
    cfg, tcfg, params, tparams = amp
    want = _drive(Engine(params, cfg, batch_slots=4, cache_len=64,
                         kv_pages=20, kv_page_len=8), _mixed(Request))
    off = _drive(_engine(tparams, tcfg, batch_slots=4), _mixed(TRequest))
    return want, off


@pytest.mark.parametrize("k,int8", [(1, False), (2, False), (4, False),
                                    (4, True)])
def test_spec_fixed_twins_equal(amp, mixed_ref, k, int8):
    """The real 75% drafter (int8 too) at draft_k 1, 2, 4: every stream,
    the sampled one included, equals the port's engine without a
    drafter, and the greedy ones equal the JAX engine's."""
    _, tcfg, _, tparams = amp
    want, off = mixed_ref
    eng = _engine(tparams, tcfg, draft=0.75, draft_k=k, draft_int8=int8,
                  batch_slots=4)
    on = _drive(eng, _mixed(TRequest))
    assert on == off
    for rid in (0, 1, 2):
        assert on[rid] == want[rid]
    assert eng.stats["spec_rounds"] > 0
    assert eng.stats["spec_draft_tokens"] == k * eng.stats["spec_rounds"]
    _spec_clean(eng)


def test_draft_pack_int8_runs_the_int8_forms(amp):
    """``draft_pack(quantize=True)``: int8 containers at the drafter's
    sparsity, served through the int8 forms of the kernels' wrappers."""
    _, tcfg, _, tparams = amp
    dparams, dcfg = t_deploy.draft_pack(tparams, tcfg, sparsity=0.75,
                                        quantize=True)
    assert dcfg.sasp.enabled and dcfg.sasp.quantize
    assert dcfg.sasp.sparsity == 0.75 and dcfg.sasp.path == "kernel"
    pf = dparams["segments"][0]["slot0"]["ffn"]["sasp_fused"]
    assert pf.w1v.dtype == torch.int8 and pf.s1 is not None
    with pytest.raises(ValueError, match="draft sparsity"):
        t_deploy.draft_pack(tparams, tcfg, sparsity=1.0)


def _offset_drafter(eng, ref, m, k):
    """Drafter stub proposing the reference stream for the first ``m``
    positions of every round, then a wrong token: acceptance offset m."""
    state = {"calls": 0, "n": 0}

    def fake(toks, pos, bt):
        t = state["calls"] % k
        if t == 0:
            state["n"] = len(eng.slot_req[0].out_tokens)
        state["calls"] += 1
        idx = state["n"] + t
        if t < m and idx < len(ref):
            tok = int(ref[idx])
        else:
            tok = (int(ref[min(idx, len(ref) - 1)]) + 1) % VOCAB
        return torch.full((eng.B,), tok, dtype=torch.int32)

    return fake


@pytest.mark.parametrize("k,m", [(1, 0), (1, 1), (2, 0), (2, 1),
                                 (2, 2), (4, 0), (4, 3), (4, 4)])
def test_spec_acceptance_offsets_exact(amp, k, m):
    """Every round accepts exactly m drafts (spec_accepted_tokens = m ·
    rounds) and the stream equals the engine's without a drafter."""
    _, tcfg, _, tparams = amp
    prompt = np.random.default_rng(4).integers(0, VOCAB, size=(10,)
                                               ).astype(np.int32)
    max_new = 6 * (m + 1) + 2

    def mk():
        return [TRequest(rid=0, prompt=prompt.copy(),
                         max_new_tokens=max_new)]
    off = _drive(_engine(tparams, tcfg, batch_slots=1), mk())
    eng = _engine(tparams, tcfg, draft=0.75, draft_k=k, batch_slots=1)
    eng._draft_decode = _offset_drafter(eng, off[0], m, k)
    on = _drive(eng, mk())
    assert on == off
    st = eng.stats
    assert st["spec_rounds"] > 0
    assert st["spec_accepted_tokens"] == m * st["spec_rounds"], st
    _spec_clean(eng)


def test_spec_random_drafter_and_page_crossings(amp):
    """A drafter of seeded garbage over prompts whose rounds cross page
    boundaries and wrap the 32-token ring: streams still equal the
    engine's without a drafter, checked after every step."""
    _, tcfg, _, tparams = amp
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, VOCAB, size=(6 + 5 * i,)).astype(np.int32)
               for i in range(3)]

    def mk():
        return [TRequest(rid=i, prompt=p.copy(), max_new_tokens=30)
                for i, p in enumerate(prompts)]
    kw = dict(batch_slots=3, cache_len=32, kv_pages=16, kv_page_len=8)
    off = _drive(_engine(tparams, tcfg, **kw), mk())
    eng = _engine(tparams, tcfg, draft=0.75, draft_k=3, **kw)
    garbage = np.random.default_rng(7)
    eng._draft_decode = lambda toks, pos, bt: torch.as_tensor(
        garbage.integers(0, VOCAB, size=(eng.B,)), dtype=torch.int32)
    assert _drive(eng, mk()) == off
    assert eng.stats["spec_rounds"] > 0
    _spec_clean(eng)


def test_spec_with_sharing_and_pool_pressure(amp):
    """Speculation over shared prefix pages under a tight pool: rounds
    that find no scratch room fall back to plain decode, streams
    unchanged."""
    _, tcfg, _, tparams = amp
    base = np.random.default_rng(8).integers(0, VOCAB, size=(20,))

    def mk():
        return [TRequest(rid=i, prompt=np.concatenate([base, [i]]).astype(
            np.int32), max_new_tokens=10) for i in range(4)]
    kw = dict(batch_slots=3, cache_len=64, kv_pages=9, kv_page_len=8,
              kv_host_pages=4, kv_share=True)
    off = _drive(_engine(tparams, tcfg, **kw), mk())
    eng = _engine(tparams, tcfg, draft=0.75, draft_k=4, **kw)
    assert _drive(eng, mk()) == off
    assert eng.stats["spec_rounds"] > 0
    _spec_clean(eng)


def test_spec_engine_validation(amp):
    _, tcfg, _, tparams = amp
    with pytest.raises(ValueError, match="kv_pages"):
        TEngine(tparams, tcfg, batch_slots=1, cache_len=64,
                draft_sparsity=0.5)
    with pytest.raises(ValueError, match="draft_k"):
        _engine(tparams, tcfg, draft=0.5, draft_k=0)
    with pytest.raises(ValueError, match="cache_len"):
        _engine(tparams, tcfg, draft=0.5, draft_k=64, cache_len=32,
                kv_page_len=8, kv_pages=8)
    qcfg = dataclasses.replace(tcfg, kv_quant=True)
    with pytest.raises(ValueError, match="kv_quant"):
        TEngine(tparams, qcfg, batch_slots=1, cache_len=64, kv_pages=16,
                kv_page_len=8, draft_sparsity=0.5)
    with pytest.raises(ValueError, match="kv_dedup_every"):
        TEngine(tparams, tcfg, batch_slots=1, cache_len=64, kv_pages=16,
                kv_page_len=8, kv_dedup_every=4)
    with pytest.raises(ValueError, match="kv_share requires"):
        TEngine(tparams, tcfg, batch_slots=1, cache_len=64, kv_share=True)
    with pytest.raises(ValueError, match="kv_quant"):
        TEngine(tparams, qcfg, batch_slots=1, cache_len=64, kv_pages=16,
                kv_page_len=8, kv_share=True)


def test_packed_int8_drafter_counts_int8_launches(amp):
    """On the CPU the wrappers run their plain versions and count no
    launch; the drafter's containers are int8 and the target's are not,
    which is what the card's per-weight-type counts tell apart."""
    _, tcfg, _, tparams = amp
    before = (gemm.launches, fused_ffn.launches)
    eng = _engine(tparams, tcfg, draft=0.75, draft_int8=True, draft_k=2,
                  batch_slots=1)
    prompt = np.arange(3, 15, dtype=np.int32)
    eng.run([TRequest(rid=0, prompt=prompt, max_new_tokens=6)])
    assert (gemm.launches, fused_ffn.launches) == before
    dparams, _ = eng._draft
    assert dparams["segments"][0]["slot0"]["ffn"]["sasp_fused"].w1v.dtype \
        == torch.int8
