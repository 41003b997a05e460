"""Batched serving engine of the port (``repro.serve.engine``), with a
contiguous per-slot ring KV cache.

The engine keeps B slots; a slot holds one sequence (index i of every
cache tensor). Queued requests are admitted into free slots — several at
once in ONE left-padded prefill (row i of the positions is
[-(S - L_i) … -1, 0 … L_i - 1]; pad columns are masked out of attention
and written to the cache with pos = -1) — and every step decodes all B
slots together, idle slots masked. Sampling (greedy argmax, or
categorical at logits / temperature from the engine's
``torch.Generator``) and the EOS / length check run on the device; only
the (B,) sampled ids and done flags come back to the host.

Paged KV, preemption, speculation, bucketing and telemetry are not
ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.base import MIXER_ATTN, ModelConfig
from repro_torch.models import lm


@dataclass(eq=False)
class Request:
    rid: int
    prompt: np.ndarray              # (S,) int32
    max_new_tokens: int = 32
    temperature: float = 0.0        # 0 = greedy
    eos_id: Optional[int] = None
    out_tokens: List[int] = field(default_factory=list)
    done: bool = False
    status: str = "new"             # new | queued | running | done


# Engine counter keys (the reference engine's _STAT_KEYS).
_STAT_KEYS = ("decode_steps", "admitted",
              "prefill_tokens", "prefill_tokens_skipped",
              "reprefill_tokens", "generated_tokens",
              "continuous_refills", "preemptions",
              "resumes", "failed", "requeued",
              "cancelled", "deaths",
              "spec_rounds", "spec_draft_tokens",
              "spec_accepted_tokens", "spec_fallbacks")


def sample_tokens(logits: torch.Tensor, temps: torch.Tensor,
                  gen: torch.Generator) -> torch.Tensor:
    """logits (B, V) -> (B,) int32 on the device: greedy where temp <= 0,
    else categorical at logits / temp."""
    lg = logits.to(torch.float32)
    greedy = torch.argmax(lg, dim=-1).to(torch.int32)
    t = torch.clamp(temps, min=1e-6)[:, None]
    probs = torch.softmax(lg / t, dim=-1)
    samp = torch.multinomial(probs, 1, generator=gen)[:, 0].to(torch.int32)
    return torch.where(temps > 0, samp, greedy)


class Engine:
    def __init__(self, params, cfg: ModelConfig, *, batch_slots: int = 4,
                 cache_len: int = 512, rng_seed: int = 0):
        self.params = params
        self.cfg = cfg
        self.B = batch_slots
        self.cache_len = cache_len
        self.device = params["embed"]["emb"].device
        self._attn_only = all(m == MIXER_ATTN
                              for m in cfg.layer_mixer_kinds())
        self.caches = lm.init_caches(params, cfg, batch_slots, cache_len,
                                     device=self.device)
        self.pos = np.zeros((batch_slots,), np.int32)
        self.slot_req: List[Optional[Request]] = [None] * batch_slots
        self.queue: List[Request] = []
        self._finished_at_admission: List[Request] = []
        self.stats = {k: 0 for k in _STAT_KEYS}
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(rng_seed)

    # ------------------------------------------------------------------
    def submit(self, req: Request):
        req.status = "queued"
        self.queue.append(req)

    def _free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slot_req) if r is None]

    def _sample_host(self, logits: torch.Tensor, temps: List[float]
                     ) -> List[int]:
        t = torch.tensor(temps, dtype=torch.float32, device=self.device)
        return sample_tokens(logits, t, self._gen).cpu().tolist()

    def _write_rows(self, caches1, slots: List[int]):
        """Scatter freshly prefilled cache rows into the batch caches."""
        idx = torch.tensor(slots, dtype=torch.int64, device=self.device)
        for seg, new_seg in zip(self.caches, caches1):
            for name, c in seg.items():
                for leaf, new in zip(c, new_seg[name]):
                    leaf[:, idx] = new.to(leaf.dtype)

    def _run_prefill(self, toks: np.ndarray, poss: Optional[np.ndarray],
                     slots: List[int]) -> torch.Tensor:
        t = torch.as_tensor(toks, dtype=torch.int32, device=self.device)
        p = None if poss is None else torch.as_tensor(
            poss, dtype=torch.int32, device=self.device)
        logits, caches1 = lm.prefill(self.params, self.cfg, t,
                                     cache_len=self.cache_len, positions=p)
        self._write_rows(caches1, slots)
        return logits[:, 0]

    def _start_decoding(self, slot: int, req: Request, nxt: int,
                        length: int):
        assert self.slot_req[slot] is None, \
            f"prefill into occupied slot {slot}"
        self.pos[slot] = length
        req.out_tokens.append(nxt)
        if self._retired_at_admission(req):
            return
        req.status = "running"
        self.slot_req[slot] = req

    def _prefill_into_slot(self, slot: int, req: Request, seq: np.ndarray):
        """Single-sequence prefill (unpadded positions)."""
        logits_last = self._run_prefill(seq[None, :], None, [slot])
        (nxt,) = self._sample_host(logits_last, [req.temperature])
        self._start_decoding(slot, req, nxt, len(seq))

    def _prefill_group(self, slots: List[int], reqs: List[Request],
                       seqs: List[np.ndarray]):
        """Batched multi-slot prefill: one LEFT-padded forward pass."""
        G = len(reqs)
        lens = [len(s) for s in seqs]
        S = max(lens)
        toks = np.zeros((G, S), np.int32)
        poss = np.tile(np.arange(S, dtype=np.int32) - S, (G, 1))
        for g, seq in enumerate(seqs):
            pad = S - lens[g]
            toks[g, pad:] = seq
            poss[g] = np.arange(S) - pad
        logits_last = self._run_prefill(toks, poss, slots)
        nxts = self._sample_host(logits_last,
                                 [r.temperature for r in reqs])
        for slot, req, nxt, L in zip(slots, reqs, nxts, lens):
            self._start_decoding(slot, req, nxt, L)

    def _retired_at_admission(self, req: Request) -> bool:
        if ((req.eos_id is not None and req.out_tokens[-1] == req.eos_id)
                or len(req.out_tokens) >= req.max_new_tokens):
            req.done = True
            req.status = "done"
            self._finished_at_admission.append(req)
            return True
        return False

    def _admit(self):
        free = self._free_slots()
        take = min(len(free), len(self.queue))
        if not take:
            return
        reqs = [self.queue.pop(0) for _ in range(take)]
        slots = free[:take]
        if len(free) < self.B:
            self.stats["continuous_refills"] += take
        self.stats["admitted"] += take
        seqs = [np.asarray(r.prompt, np.int32) for r in reqs]
        self.stats["prefill_tokens"] += sum(len(s) for s in seqs)
        if (self._attn_only and max(len(s) for s in seqs) <= self.cache_len
                and len(reqs) > 1):
            self._prefill_group(slots, reqs, seqs)
        else:
            for slot, req, seq in zip(slots, reqs, seqs):
                self._prefill_into_slot(slot, req, seq)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def step(self) -> List[Request]:
        """Admit queued requests, run one decode step, retire finished.
        Returns completed requests."""
        self._admit()
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not active:
            finished = self._finished_at_admission
            self._finished_at_admission = []
            return finished
        last = np.zeros((self.B, 1), np.int32)
        temps = np.zeros((self.B,), np.float32)
        act = np.zeros((self.B,), bool)
        eos = np.full((self.B,), -1, np.int32)
        remaining = np.zeros((self.B,), np.int32)
        for i in active:
            req = self.slot_req[i]
            last[i, 0] = req.out_tokens[-1]
            temps[i] = req.temperature
            act[i] = True
            eos[i] = -1 if req.eos_id is None else req.eos_id
            remaining[i] = req.max_new_tokens - len(req.out_tokens)

        dev = self.device
        logits, self.caches = lm.decode_step(
            self.params, self.cfg, torch.as_tensor(last, device=dev),
            torch.as_tensor(self.pos, device=dev), self.caches)
        act_t = torch.as_tensor(act, device=dev)
        nxt = sample_tokens(logits[:, 0], torch.as_tensor(temps, device=dev),
                            self._gen)
        nxt = torch.where(act_t, nxt, torch.zeros_like(nxt))
        done = act_t & ((nxt == torch.as_tensor(eos, device=dev))
                        | (torch.as_tensor(remaining, device=dev) <= 1))
        nxt = nxt.cpu().numpy()                 # the only per-token
        done = done.cpu().numpy()               # host traffic

        self.stats["decode_steps"] += 1
        self.stats["generated_tokens"] += len(active)
        finished: List[Request] = []
        for i in active:
            req = self.slot_req[i]
            self.pos[i] += 1
            req.out_tokens.append(int(nxt[i]))
            if bool(done[i]):
                req.done = True
                req.status = "done"
                finished.append(req)
                self.slot_req[i] = None
        finished = self._finished_at_admission + finished
        self._finished_at_admission = []
        return finished

    def run(self, requests: List[Request]) -> List[Request]:
        for r in requests:
            self.submit(r)
        done: List[Request] = []
        while len(done) < len(requests):
            done.extend(self.step())
        return done
