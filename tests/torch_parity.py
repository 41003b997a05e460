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


def mask_key(path):
    """jax key path -> the port's path tuple."""
    return tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)
