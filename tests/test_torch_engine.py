"""The port's serving engine against the reference ``Engine`` on the same
weights: greedy streams are equal for a solo request, for the
left-padded batched prefill of several prompts, and for continuous
refill with more requests than slots; EOS and length retirement; and the
launcher's flag handling."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.deploy import deploy_packed  # noqa: E402
from repro.core.pruning import prune_params  # noqa: E402
from repro.serve.engine import Engine, Request  # noqa: E402
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


def test_launcher_cpu_run_and_flags(capsys):
    t_serve.main(["--sasp", "0.5", "--path", "packed", "--scope", "all",
                  "--requests", "2", "--max-new", "3", "--slots", "2",
                  "--cache-len", "64", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "packed:" in out and "2 requests, 6 tokens" in out
    for flag in (["--mesh", "1,2"], ["--scheduler"], ["--int8-kv"],
                 ["--kv-pages=8"]):
        with pytest.raises(SystemExit, match="not ported"):
            t_serve.main(flag)


def test_reduce_flag_can_be_switched_off():
    """--no-reduce reaches the full config (the reference's --reduce is
    store_true with default True and never turns off)."""
    assert t_serve.parse_args([]).reduce is True
    assert t_serve.parse_args(["--no-reduce"]).reduce is False
