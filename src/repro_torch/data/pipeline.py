"""Deterministic, resumable synthetic token pipeline of the port
(``repro.data.pipeline``), numpy only.

Every batch is a pure function of (seed, step): resuming after a failure
is "set step, continue"; the only pipeline state is one integer, kept in
a checkpoint manifest's ``extra`` dict. Per-host sharding slices the
global batch by host id. The batches are the reference's bit for bit
(the same numpy calls in the same order).

Two generators:
  * ``lm_batch`` — Zipf-ish tokens with copy structure (the second half of
    each 64-token period repeats the first), so a real LM can learn;
  * ``asr_batch`` — synthetic transcription: the inputs are a fixed random
    "acoustic" projection of the target tokens plus noise, the labels are
    the tokens (per-position error rate plays WER).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    num_hosts: int = 1
    host_id: int = 0

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.num_hosts == 0
        return self.global_batch // self.num_hosts


@dataclass
class DataState:
    step: int = 0

    def to_dict(self) -> Dict:
        return {"data_step": self.step}

    @staticmethod
    def from_dict(d: Dict) -> "DataState":
        return DataState(step=int(d.get("data_step", 0)))


def _rng_for(cfg: DataConfig, step: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, cfg.host_id]))


def lm_batch(cfg: DataConfig, step: int) -> Dict[str, np.ndarray]:
    """Zipf unigrams (exponent 1.1) with periodic copy patterns."""
    rng = _rng_for(cfg, step)
    B, S, V = cfg.host_batch, cfg.seq_len, cfg.vocab_size
    ranks = np.arange(1, V + 1)
    probs = 1.0 / ranks ** 1.1
    probs /= probs.sum()
    toks = rng.choice(V, size=(B, S), p=probs)
    period = min(64, S)
    half = period // 2
    for b in range(B):
        for start in range(0, S - period, period):
            toks[b, start + half:start + period] = \
                toks[b, start:start + half]
    return {"tokens": toks.astype(np.int32)}


def asr_batch(cfg: DataConfig, step: int, d_model: int,
              noise: float = 0.25) -> Dict[str, np.ndarray]:
    """Inputs: a fixed random projection of the target tokens plus noise;
    labels: the tokens. The projection (seed 4242) is the same for every
    DataConfig seed, so train and eval streams share one frontend."""
    rng = _rng_for(cfg, step)
    B, S, V = cfg.host_batch, cfg.seq_len, cfg.vocab_size
    toks = rng.integers(0, V, size=(B, S))
    proj_rng = np.random.default_rng(np.random.SeedSequence([4242]))
    table = proj_rng.normal(size=(V, d_model)).astype(np.float32)
    feats = table[toks] + noise * rng.normal(size=(B, S, d_model))
    return {"tokens": toks.astype(np.int32),
            "embeds": feats.astype(np.float32)}


class Pipeline:
    """Stateful iterator over the pure batch functions."""

    def __init__(self, cfg: DataConfig, kind: str = "lm",
                 d_model: int = 0, state: Optional[DataState] = None,
                 noise: float = 0.25):
        self.cfg = cfg
        self.kind = kind
        self.d_model = d_model
        self.noise = noise
        self.state = state or DataState()

    def next(self) -> Dict[str, np.ndarray]:
        if self.kind == "lm":
            b = lm_batch(self.cfg, self.state.step)
        else:
            b = asr_batch(self.cfg, self.state.step, self.d_model,
                          noise=self.noise)
        self.state.step += 1
        return b

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next()
