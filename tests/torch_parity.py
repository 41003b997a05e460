"""Shared set-up of the JAX-vs-torch parity tests (tests/test_torch_*.py):
the reduced qwen3-32b config of tests/test_deploy_packed.py in both
packages, and the reference's params bridged into the port through
numpy."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.configs import SASPConfig, get_config, reduced  # noqa: E402
from repro.models import lm  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import SASPConfig as TSASPConfig  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402

KEY = jax.random.PRNGKey(0)
# the parity shapes are tiny: one torch thread per test worker keeps the
# suite's parallel workers from oversubscribing the cores
torch.set_num_threads(1)


def configs(scope="all", sparsity=0.5, layers=2, d_model=64, vocab=64,
            block=16, quantize=False):
    """(reference cfg, port cfg) of the reduced qwen3-32b test model."""
    kw = dict(enabled=True, block_k=block, block_n=block,
              sparsity=sparsity, scope=scope, quantize=quantize)
    cfg = dataclasses.replace(
        reduced(get_config("qwen3-32b"), layers=layers, d_model=d_model,
                vocab=vocab), sasp=SASPConfig(**kw))
    tcfg = dataclasses.replace(
        t_reduced(t_get_config("qwen3-32b"), layers=layers,
                  d_model=d_model, vocab=vocab), sasp=TSASPConfig(**kw))
    return cfg, tcfg


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def bridged(params):
    """Reference params -> port params (CPU tensors) through numpy."""
    return bridge.from_numpy(to_np(params), device="cpu")


def model(**kw):
    """(ref cfg, port cfg, ref params, port params) with equal weights."""
    cfg, tcfg = configs(**kw)
    params = lm.init_params(KEY, cfg)
    return cfg, tcfg, params, bridged(params)


def leaves_np(tree):
    """{name: fp32 numpy} of a reference or port tree, by checkpoint
    leaf name (the same in both packages)."""
    from repro.train.checkpoint import _flatten_with_names
    from repro_torch.train.checkpoint import named_leaves
    if any(isinstance(x, torch.Tensor) for _, x in named_leaves(tree)):
        return {n: np.asarray(x.detach().float().numpy())
                for n, x in named_leaves(tree)}
    return {n: np.asarray(x, np.float32)
            for n, x in _flatten_with_names(tree)}


def assert_leaves_close(got, want, tol):
    """Every leaf within ``tol`` of that leaf's largest magnitude."""
    g, w = leaves_np(got), leaves_np(want)
    assert g.keys() == w.keys()
    for n in w:
        assert g[n].shape == w[n].shape, (n, g[n].shape, w[n].shape)
        if not w[n].size:           # mamba2's empty (d_ff = 0) FFN
            continue
        scale = max(float(np.abs(w[n]).max()), 1e-30)
        err = float(np.abs(g[n] - w[n]).max())
        assert err <= tol * scale, (n, err, scale)


def mask_key(path):
    """jax key path -> the port's path tuple."""
    return tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)


def amp_model(packed=False):
    """(ref cfg, port cfg, ref params, port params) of the reduced dense
    model with every weight times 3 (position-dependent greedy streams,
    as in the reference's tests/test_scheduler.py); ``packed`` prunes 25%
    of its 8x8 tiles (scope all) and packs it, in each package."""
    from repro.configs import SASPConfig as RSASP
    from repro.core.deploy import deploy_packed
    from repro.core.pruning import prune_params
    from repro_torch.core import deploy as t_deploy
    from repro_torch.core import pruning as t_pruning

    cfg, tcfg = configs()
    cfg = dataclasses.replace(cfg, sasp=RSASP())
    tcfg = dataclasses.replace(tcfg, sasp=TSASPConfig())
    params = jax.tree.map(lambda a: a * 3.0, lm.init_params(KEY, cfg))
    tparams = bridged(params)
    if not packed:
        return cfg, tcfg, params, tparams
    kw = dict(enabled=True, block_k=8, block_n=8, sparsity=0.25,
              scope="all")
    cfg = dataclasses.replace(cfg, sasp=RSASP(**kw))
    tcfg = dataclasses.replace(tcfg, sasp=TSASPConfig(**kw))
    params, _ = prune_params(params, cfg.sasp)
    params, cfg = deploy_packed(params, cfg)
    tparams, _ = t_pruning.prune_params(tparams, tcfg.sasp)
    tparams, tcfg = t_deploy.deploy_packed(tparams, tcfg)
    return cfg, tcfg, params, tparams


class SoloOracle:
    """Greedy streams of each request alone through a single-slot engine,
    in both packages: ``stream(prompt, max_new, eos)`` runs the port's
    ``Engine(batch_slots=1)`` and the reference's, asserts they agree and
    returns the stream (memoised; one reference engine is reused, so each
    prompt length compiles its prefill once)."""

    def __init__(self, model, cache_len=64):
        from repro.serve.engine import Engine
        self.cfg, self.tcfg, self.params, self.tparams = model
        self.cache_len = cache_len
        self._ref = Engine(self.params, self.cfg, batch_slots=1,
                           cache_len=cache_len)
        self._memo = {}

    def stream(self, prompt, max_new, eos=None):
        from repro.serve.engine import Request
        from repro_torch.serve.engine import Engine as TEngine
        from repro_torch.serve.engine import Request as TRequest
        prompt = np.asarray(prompt, np.int32)
        key = (prompt.tobytes(), int(max_new), eos)
        if key not in self._memo:
            want = self._ref.run([Request(
                rid=0, prompt=prompt.copy(), max_new_tokens=max_new,
                eos_id=eos)])[0].out_tokens
            got = TEngine(self.tparams, self.tcfg, batch_slots=1,
                          cache_len=self.cache_len).run([TRequest(
                              rid=0, prompt=prompt.copy(),
                              max_new_tokens=max_new,
                              eos_id=eos)])[0].out_tokens
            assert list(got) == [int(t) for t in want], (got, want)
            self._memo[key] = list(got)
        return list(self._memo[key])

    def of(self, reqs):
        """{rid: solo stream} of port or reference requests."""
        return {r.rid: self.stream(r.prompt, r.max_new_tokens, r.eos_id)
                for r in reqs}
