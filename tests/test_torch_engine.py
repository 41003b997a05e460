"""The port's serving engine against the reference ``Engine`` on the same
weights: greedy streams are equal for a solo request, for the
left-padded batched prefill of several prompts, and for continuous
refill with more requests than slots; EOS and length retirement;
prefill buckets, preemption in both modes, streaming, cancellation and
the int8 KV cache; and the launcher's flag handling."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core.deploy import deploy_packed  # noqa: E402
from repro.core.pruning import prune_params  # noqa: E402
from repro.models import attention as ref_attn  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro.serve.engine import Engine, Request  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models import lm as t_lm  # noqa: E402
from repro_torch.core import deploy as t_deploy  # noqa: E402
from repro_torch.core import pruning as t_pruning  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.serve.engine import Engine as TEngine  # noqa: E402
from repro_torch.serve.engine import Request as TRequest  # noqa: E402
from torch_parity import model  # noqa: E402


def _packed():
    cfg, tcfg, params, tparams = model(scope="all", sparsity=0.25)
    pruned, _ = prune_params(params, cfg.sasp)
    ref, rcfg = deploy_packed(pruned, cfg)
    tpruned, _ = t_pruning.prune_params(tparams, tcfg.sasp)
    mine, mcfg = t_deploy.deploy_packed(tpruned, tcfg)
    return ref, rcfg, mine, mcfg


def _prompts(n, seed=0, lo=4, hi=12):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 64, size=(int(rng.integers(lo, hi)),))
            .astype(np.int32) for _ in range(n)]


def _streams(eng_cls, req_cls, params, cfg, prompts, *, slots, max_new=6,
             eos=None):
    eng = eng_cls(params, cfg, batch_slots=slots, cache_len=32)
    budgets = max_new if isinstance(max_new, list) else \
        [max_new] * len(prompts)
    reqs = [req_cls(rid=i, prompt=p, max_new_tokens=b, eos_id=eos)
            for i, (p, b) in enumerate(zip(prompts, budgets))]
    done = eng.run(reqs)
    return {r.rid: list(r.out_tokens) for r in done}, eng


@pytest.mark.parametrize("n,slots", [(1, 2), (3, 3)])
def test_packed_streams_equal_reference(n, slots):
    ref, rcfg, mine, mcfg = _packed()
    prompts = _prompts(n)
    want, _ = _streams(Engine, Request, ref, rcfg, prompts, slots=slots)
    got, eng = _streams(TEngine, TRequest, mine, mcfg, prompts,
                        slots=slots)
    assert got == want
    assert eng.stats["admitted"] == n
    assert eng.stats["generated_tokens"] == n * 5


def test_continuous_refill_streams_equal_reference():
    cfg, tcfg, params, tparams = model()
    prompts = _prompts(5, seed=1)
    budgets = [3, 5, 4, 2, 6]
    want, _ = _streams(Engine, Request, params, cfg, prompts, slots=2,
                       max_new=budgets)
    got, eng = _streams(TEngine, TRequest, tparams, tcfg, prompts, slots=2,
                        max_new=budgets)
    assert got == want
    assert eng.stats["continuous_refills"] > 0


def test_eos_and_length_retirement():
    cfg, tcfg, params, tparams = model()
    prompts = _prompts(2, seed=2)
    free, _ = _streams(TEngine, TRequest, tparams, tcfg, prompts, slots=2)
    eos = free[0][2]
    want, _ = _streams(Engine, Request, params, cfg, prompts, slots=2,
                       eos=eos)
    got, _ = _streams(TEngine, TRequest, tparams, tcfg, prompts, slots=2,
                      eos=eos)
    assert got == want
    assert got[0][-1] == eos and len(got[0]) <= 3


def test_launcher_cpu_run_and_flags(capsys, tmp_path):
    t_serve.main(["--sasp", "0.5", "--path", "packed", "--scope", "all",
                  "--requests", "2", "--max-new", "3", "--slots", "2",
                  "--cache-len", "64", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "packed:" in out and "2 requests, 6 tokens" in out
    # --mesh DP,TP is ported (tests/test_torch_tp_mesh.py,
    # tests/test_torch_dp_mesh.py); with --hosts it is the reference's
    # usage error
    with pytest.raises(SystemExit, match="--hosts serves in-process hosts "
                       "without a mesh; drop --mesh"):
        t_serve.main(["--mesh", "2,1", "--hosts", "2", "--sasp", "0.5",
                      "--path", "packed"])
    # --ckpt-dir is ported (tests/test_torch_checkpoint.py): an empty
    # directory has nothing to restore
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        t_serve.main([f"--ckpt-dir={tmp_path}", "--device", "cpu"])


def test_reduce_flag_can_be_switched_off():
    """--no-reduce reaches the full config (the reference's --reduce is
    store_true with default True and never turns off)."""
    assert t_serve.parse_args([]).reduce is True
    assert t_serve.parse_args(["--no-reduce"]).reduce is False


def _streams_kw(params, cfg, prompts, max_new=6, **kw):
    eng = TEngine(params, cfg, **kw)
    done = eng.run([TRequest(rid=i, prompt=p, max_new_tokens=max_new)
                    for i, p in enumerate(prompts)])
    return {r.rid: list(r.out_tokens) for r in done}, eng


def test_buckets_streams_equal_reference():
    """Bucketed admission (groups padded to every slot, lengths to a
    bucket) keeps the reference's streams and the unbucketed ones."""
    cfg, tcfg, params, tparams = model()
    prompts = _prompts(6, seed=3, lo=2, hi=30)
    want = {r.rid: list(r.out_tokens) for r in Engine(
        params, cfg, batch_slots=3, cache_len=32, buckets=(8, 16, 32)).run(
        [Request(rid=i, prompt=p, max_new_tokens=4)
         for i, p in enumerate(prompts)])}
    got, eng = _streams_kw(tparams, tcfg, prompts, max_new=4, batch_slots=3,
                           cache_len=32, buckets=(8, 16, 32))
    plain, _ = _streams_kw(tparams, tcfg, prompts, max_new=4, batch_slots=3,
                           cache_len=32)
    assert got == want == plain
    assert eng.buckets == (8, 16, 32) and eng._bucket_len(9) == 16
    assert eng._bucket_len(40) == 40
    with pytest.raises(ValueError, match="prefill buckets"):
        TEngine(tparams, tcfg, batch_slots=1, cache_len=32, buckets=(64,))


@pytest.mark.parametrize("keep_kv", [True, False])
def test_preempt_resume_equal_undisturbed(keep_kv):
    """A request preempted mid-decode (its cache rows snapshotted, or
    dropped and re-prefilled) and resumed behind another one: both
    streams equal undisturbed runs and the reference's same cycle."""
    cfg, tcfg, params, tparams = model()
    prompts = _prompts(2, seed=4, lo=6, hi=14)

    def cycle(eng, cls):
        a = cls(rid=0, prompt=prompts[0], max_new_tokens=10)
        b = cls(rid=1, prompt=prompts[1], max_new_tokens=4)
        eng.submit(a)
        for _ in range(3):
            eng.step()
        victim = eng.preempt_slot(0, keep_kv=keep_kv)
        assert victim is a and victim.status == "queued"
        eng.queue[:0] = [b, victim]
        done = []
        while len(done) < 2:
            done.extend(eng.step())
        return {r.rid: list(r.out_tokens) for r in done}, eng

    want, _ = cycle(Engine(params, cfg, batch_slots=1, cache_len=32),
                    Request)
    got, eng = cycle(TEngine(tparams, tcfg, batch_slots=1, cache_len=32),
                     TRequest)
    solo = {i: _streams_kw(tparams, tcfg, [p], max_new=n, batch_slots=1,
                           cache_len=32)[0][0]
            for i, (p, n) in enumerate(zip(prompts, (10, 4)))}
    assert got == want == solo
    assert eng.stats["preemptions"] == 1 and eng.stats["resumes"] == 1
    assert (eng.stats["reprefill_tokens"] > 0) == (not keep_kv)


def test_stream_and_on_token_follow_sampling_order():
    _, tcfg, _, tparams = model()
    prompts = _prompts(3, seed=5)
    base, _ = _streams_kw(tparams, tcfg, prompts, batch_slots=2,
                          cache_len=32)
    eng = TEngine(tparams, tcfg, batch_slots=2, cache_len=32)
    reqs = [TRequest(rid=i, prompt=p, max_new_tokens=6)
            for i, p in enumerate(prompts)]
    events = list(eng.stream(reqs))
    per = {}
    for rid, tok in events:
        per.setdefault(rid, []).append(tok)
    assert per == base and eng.on_token is None
    seen = []
    TEngine(tparams, tcfg, batch_slots=2, cache_len=32).run(
        [TRequest(rid=i, prompt=p, max_new_tokens=6)
         for i, p in enumerate(prompts)],
        on_token=lambda req, tok: seen.append((req.rid, tok)))
    assert seen == events


@pytest.mark.parametrize("paged", [False, True])
def test_cancel_queued_and_running(paged):
    _, tcfg, _, tparams = model()
    kw = dict(kv_pages=8, kv_page_len=16) if paged else {}
    eng = TEngine(tparams, tcfg, batch_slots=1, cache_len=32, **kw)
    prompts = _prompts(3, seed=6)
    reqs = [TRequest(rid=i, prompt=p, max_new_tokens=8)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.step()
    assert eng.cancel(2) is reqs[2]                 # queued
    assert eng.cancel(0) is reqs[0]                 # decoding
    assert eng.cancel(9) is None
    assert eng.stats["cancelled"] == 2
    done = []
    while eng.has_work():
        done.extend(eng.step())
    assert [r.rid for r in done] == [1]
    if paged:
        assert eng.memory_stats().device_used == 0
        eng.pool.check()


def test_int8_kv_bytes_and_scales_equal_reference():
    """The same fp32 K/V through both packages' int8 quantization: equal
    int8 bytes and scales (fp32 division by the scale, round half to
    even), equal dequantized values; and the whole prefill cache's int8
    bytes equal the reference's."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 5, 2, 16)).astype(np.float32)
    x[0, 0, 0] = 0.0
    x[1, 1, 1, :4] = [0.5, -0.5, 1.5, 127.0 / 254.0]
    q_ref, s_ref = ref_attn._quant_heads(jnp.asarray(x))
    q, s = t_attn._quant_heads(torch.from_numpy(x))
    assert np.array_equal(np.asarray(q_ref), q.numpy())
    assert np.array_equal(np.asarray(s_ref), s.numpy())
    assert np.array_equal(
        np.asarray(ref_attn._dequant(q_ref, s_ref, jnp.float32)),
        t_attn._dequant(q, s, torch.float32).numpy())
    k, v = x, x[::-1].copy()
    pos = np.array([[-2, -1, 0, 1, 2], [0, 1, 2, 3, 4], [-4, -3, -2, -1, 0]],
                   np.int32)
    want = ref_attn.build_cache_from_prefill(
        jnp.asarray(k), jnp.asarray(v), 8, quant=True,
        positions=jnp.asarray(pos))
    got = t_attn.build_cache_from_prefill(
        torch.from_numpy(k), torch.from_numpy(v), 8,
        positions=torch.from_numpy(pos), quant=True)
    for f in ("k", "v", "pos", "kscale", "vscale"):
        assert np.array_equal(np.asarray(getattr(want, f)),
                              getattr(got, f).numpy()), f
    cfg, tcfg, params, tparams = model()
    cfg = dataclasses.replace(cfg, kv_quant=True)
    tcfg = dataclasses.replace(tcfg, kv_quant=True)
    prompt = np.arange(2, 12, dtype=np.int32)
    _, cw = ref_lm.prefill(params, cfg, jnp.asarray(prompt[None]),
                           cache_len=32)
    _, cg = t_lm.prefill(tparams, tcfg, torch.from_numpy(prompt[None]),
                         cache_len=32)
    for f in ("k", "v", "pos"):
        assert np.array_equal(np.asarray(getattr(cw[0]["slot0"], f)),
                              getattr(cg[0]["slot0"], f).numpy()), f
    np.testing.assert_allclose(np.asarray(cw[0]["slot0"].kscale),
                               cg[0]["slot0"].kscale.numpy(), rtol=1e-5)


def test_int8_kv_engine_greedy_equals_reference():
    cfg, tcfg, params, tparams = model()
    cfg = dataclasses.replace(cfg, kv_quant=True)
    tcfg = dataclasses.replace(tcfg, kv_quant=True)
    prompts = _prompts(3, seed=8)
    want = {r.rid: list(r.out_tokens) for r in Engine(
        params, cfg, batch_slots=2, cache_len=32).run(
        [Request(rid=i, prompt=p, max_new_tokens=8)
         for i, p in enumerate(prompts)])}
    got, eng = _streams_kw(tparams, tcfg, prompts, max_new=8,
                           batch_slots=2, cache_len=32)
    assert got == want
    assert eng.caches[0]["slot0"].k.dtype == torch.int8


def test_launcher_engine_flags(capsys):
    t_serve.main(["--sasp", "0.5", "--path", "packed", "--scope", "all",
                  "--requests", "3", "--max-new", "4", "--slots", "2",
                  "--cache-len", "64", "--device", "cpu", "--kv-pages", "8",
                  "--kv-share", "--draft-sparsity", "0.75", "--draft-int8",
                  "--buckets", "2", "--stream"])
    out = capsys.readouterr().out
    assert "speculative:" in out and "paged KV: 8 device pages" in out
    assert "prefix sharing:" in out and "stream: req" in out
    t_serve.main(["--requests", "2", "--max-new", "3", "--slots", "2",
                  "--cache-len", "64", "--device", "cpu", "--int8-kv"])
    assert "2 requests, 6 tokens" in capsys.readouterr().out
    assert t_serve.parse_buckets("3", 256) == (64, 128, 256)
    for argv, msg in (
            (["--kv-share"], "requires --kv-pages"),
            (["--kv-pages", "8", "--kv-share", "--int8-kv"], "incompatible"),
            (["--draft-sparsity", "0.5"], "requires --kv-pages"),
            (["--kv-pages", "8", "--draft-sparsity", "1.5"], r"\(0, 1\)"),
            (["--kv-pages", "8", "--draft-sparsity", "0.5", "--draft-k",
              "0"], "draft-k"),
            (["--draft-int8"], "add --draft-sparsity"),
            (["--kv-pages", "8", "--kv-dedup-every", "2"], "--kv-share"),
            (["--kv-watermark", "0"], "kv-watermark"),
            (["--kv-pages", "0"], "kv-pages"),
            (["--kv-share-min-pages", "0"], "min-pages"),
            (["--buckets", "64,512"], "must not exceed"),
            (["--buckets", "x"], "expects an int")):
        with pytest.raises(SystemExit, match=msg):
            t_serve.main(argv + ["--device", "cpu"])


@pytest.mark.parametrize("paged", [False, True])
def test_mark_resumable_moves_a_request_to_another_engine(paged):
    """A request cancelled mid-decode on one engine and marked resumable
    continues its stream exactly on another (re-prefill of prompt +
    out_tokens[:-1], nothing resampled)."""
    _, tcfg, _, tparams = model()
    prompt = _prompts(1, seed=9, lo=10, hi=14)[0]
    solo, _ = _streams_kw(tparams, tcfg, [prompt], max_new=9,
                          batch_slots=1, cache_len=32)
    kw = dict(kv_pages=8, kv_page_len=16) if paged else {}
    a = TEngine(tparams, tcfg, batch_slots=1, cache_len=32)
    req = TRequest(rid=0, prompt=prompt, max_new_tokens=9)
    a.submit(req)
    for _ in range(4):
        a.step()
    assert a.cancel(0) is req and len(req.out_tokens) == 5
    req.mark_resumable()
    b = TEngine(tparams, tcfg, batch_slots=2, cache_len=32, **kw)
    (done,) = b.run([req])
    assert done.out_tokens == solo[0]
    assert b.stats["reprefill_tokens"] == len(prompt) + 4
