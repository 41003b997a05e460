"""Batched serving engine of the port (``repro.serve.engine``).

The engine keeps B slots; a slot holds one sequence. Queued requests are
admitted into free slots — several at once in ONE left-padded prefill
(row i of the positions is [-(S - L_i) … -1, 0 … L_i - 1]; pad columns
are masked out of attention and written to the cache with pos = -1) —
and every step decodes all B slots together, idle slots masked. Sampling
(greedy argmax, or categorical at logits / temperature from the engine's
``torch.Generator``) and the EOS / length check run on the device; only
the (B,) sampled ids and done flags come back to the host.

* **Prefill buckets** — ``buckets=(…)`` pads every admission group to
  all B rows and its length up to the smallest bucket ≥ S; pad rows
  leave their slots' cache rows as they were.
* **Preemption** — :meth:`Engine.preempt_slot` moves a decoding request
  back to the queue: ``keep_kv=True`` keeps its KV (a snapshot of its
  cache rows, or its pages unmapped), ``keep_kv=False`` drops it and
  resume re-prefills ``prompt + out_tokens[:-1]``. Either way the
  stream continues exactly.
* **Paged KV** — ``kv_pages=N`` serves from a shared page pool with
  per-slot block tables (``serve/memory.py``): decode gathers each
  slot's pages into the contiguous ring layout, runs the same decode
  and writes back the one page it touched. Admission defers when the
  pool is exhausted; cold pages spill to a host pool
  (``kv_host_pages``) and fault back on resume.
* **Prefix sharing** — ``kv_share`` maps a prompt's full pages onto
  identical resident pages and prefills only the suffix
  (``lm.prefill_with_past``); shared pages are copy-on-written before a
  decode write; ``kv_dedup_every`` re-links identical resident pages.
* **Self-speculative decoding** — ``draft_sparsity`` packs the same
  weights pruned higher on the sparsity ladder (``core.deploy.
  draft_pack``, int8 with ``draft_int8``) as a drafter: it drafts
  ``draft_k`` tokens onto scratch pages, one target pass over them
  verifies, and the longest matching prefix is accepted. Every emitted
  token is a target argmax.
* **Streaming** — ``on_token`` is called with every token as it is
  sampled; :meth:`Engine.stream` yields ``(rid, token)``.
* **Admission modes** — ``admission="continuous"`` refills a slot freed
  by EOS / budget at the next step; ``"drain"`` admits only when every
  slot is free (the batch-inference baseline).
* **Telemetry** — ``stats`` is the per-rank :class:`~repro_torch.serve.
  telemetry.CounterView` of the engine's :class:`Telemetry`; the span
  tracer records submit / admit / prefill / token / preempt / resume /
  spec_round events and the pool's spills and faults on the host clock
  (no device read, no synchronise, no generator draw), TTFT goes to the
  per-class histogram, decode tokens to the per-path tok/s gauge.
* **Tensor parallelism** — ``mesh=`` (``distribution.context.Mesh``):
  this process is one model rank, ``params`` its local tree and ``cfg``
  its local config (``distribution.sharding``); every prefill and
  decode runs under the mesh, and model rank 0's sampled tokens are
  broadcast, so every rank's host state (slots, pages, EOS) moves in
  step. Every serving path of the dense decoder serves on a mesh
  (``distribution.sharding.local_params``). A rank's drafter comes
  prebuilt (``draft=``, its local tree and config: a rank holds no dense
  masters to re-prune); its drafts and the verify pass's predictions,
  argmaxes of all-gathered logits, are model rank 0's (and data rank
  0's), broadcast, so every rank accepts the same drafts.
* **Data parallelism** — a mesh with a 'data' axis of DP > 1: every
  process keeps the whole engine's host state (queue, slots, positions,
  pages, stats) and takes one of four layouts (``layout``). "slots
  split over data" (contiguous caches, ``batch_slots % DP == 0``): data
  rank d holds and computes only slots ``[d B/DP, (d+1) B/DP)``; each
  data rank draws the whole batch's sampling noise, samples its own rows
  (model rank 0, broadcast in its group), and the rows are all-gathered
  over 'data'; a kept-KV snapshot lives with its slot's data rank and is
  broadcast from it if the request resumes in another's slot.
  "slots and pages split over data" (``PAGED_LAYOUT``: a page pool whose
  P = kv_pages + 2 pages the reference's rule cuts over 'data',
  ``sharding.pool_axes``, and ``batch_slots % DP == 0``): the slots
  split as above, and data rank d holds only the pages of block d
  (``serve.memory.PagedKVPool``: P / DP pages, two local reserved pages
  more where d > 0). Every process keeps one allocator a block; a slot's
  pages (its own, its drafts' scratch pages, pages faulted back from the
  host) come from its data rank's block, so a decode step moves no KV
  over 'data', only the sampled rows. Each data rank drafts and verifies
  its own rows, and one all-gather a round gives every process every
  row's drafts and predictions, so the allocators decide alike. A
  kept-KV request that resumes in another data rank's slot has its pages
  moved once (a broadcast over 'data' from the block that held them);
  prefix sharing maps only the slot's block's pages (what another block
  held is prefilled again, and counted). A free slot whose block has no
  room for an admission is passed over for one of another block that
  has. Where the rule does not cut P, or the batch does not split, or a
  block's watermark cap (block 0: P / DP - 2 usable pages, times the
  watermark) is under one slot's ring (``kvmem.block_caps``), a paged
  engine takes "replicated over data" below: the reference places its
  pool by the rule alone and allocates from the whole of it, so the port
  differs from it in the last two cases.
  "sequence split over data" (contiguous caches whose batch does not
  split: ``batch_slots % DP != 0``, or one slot; on a DP = 1 mesh too
  where every model rank runs every head): the reference's long-context
  layout (``distribution.sharding.seq_axes``). Every data rank runs the
  whole engine and its rows, and data rank 0's tokens are broadcast, but
  each KV ring's capacity is cut over 'data' (and over 'model' where the
  heads do not split and the ring divides D x T): a rank holds one
  contiguous block of slots (``cfg.seq_*``, ``lm.init_caches``), writes
  only the entries that fall in it and combines attention's softmax
  over the blocks (``models.attention``); SSM states stay whole over
  'data'; a kept-KV snapshot is the rank's block. "replicated over data"
  (a paged pool the rule does not cut, whose batch does not split, or
  whose blocks could not hold a slot's ring):
  every data rank runs the whole engine on the whole pool and data rank
  0's tokens are broadcast. Experts in EP over 'data' (``cfg.ep_shards``
  = DP) serve every layout: a split engine's data rank with no rows in
  an admission still enters every MoE layer's collectives
  (``lm.moe_bystander``); the other two layouts declare replicated rows
  and run ``moe_ep.moe_ffn_replicated`` (each data rank its own experts'
  slots, no host read). ``data_shards`` with no mesh is the meshless
  twin of a split engine (with a page pool, of one whose pool is cut:
  every block in one process): every data rank's rows in one process,
  layer by layer in lock step (``lm.prefill_groups``,
  ``lm.prefill_with_past_groups``, ``lm.decode_step_groups``), bit for
  bit the mesh's processes; with
  ``seq_split`` it is the twin of a sequence-parallel engine of
  ``data_shards`` x ``cfg.tp_shards`` ranks: whole rings, every block
  run in turn and combined in block order.
* **Failure hand-off** — ``dead`` is set by the scheduler when a step
  raises; :meth:`Engine.evacuate_inflight` re-arms in-flight requests
  for an exact re-prefill resume elsewhere, :meth:`Engine.fail_inflight`
  fails them.

The generator draws one (B, vocab) block of noise per decode step
whether or not slots speculate, so sampled streams do not depend on the
drafter. Every device op of :meth:`Engine.step` and
:meth:`Engine.preempt_slot` runs on the stream the engine was built on,
whichever thread calls it (torch's current stream is per thread).
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import MIXER_ATTN, ModelConfig
from repro_torch.distribution import sharding
from repro_torch.models import lm
from repro_torch.models.attention import cache_map
from repro_torch.models.modules import as_dtype
from repro_torch.serve import memory as kvmem
from repro_torch.serve.telemetry import Telemetry

ADMISSION_MODES = ("continuous", "drain")
# the layout of a contiguous engine whose batch does not split over
# 'data' (``Engine.layout``)
SEQ_LAYOUT = "sequence split over data"
# the layout of a paged engine whose page pool the reference's rule cuts
# over 'data' and whose slots split there too (``Engine.layout``)
PAGED_LAYOUT = "slots and pages split over data"
SLO_CLASSES = ("interactive", "batch")
# request lifecycle states surfaced on Request.status
STATUSES = ("new", "queued", "running", "done", "failed", "rejected")


@dataclass(eq=False)
class Request:
    rid: int
    prompt: np.ndarray              # (S,) int32
    max_new_tokens: int = 32
    temperature: float = 0.0        # 0 = greedy
    eos_id: Optional[int] = None
    # QoS: SLO class and latency target. ``deadline`` is relative seconds
    # from submission (None = the scheduler's default for the class);
    # the scheduler stamps the absolute ``t_deadline``.
    slo: str = "batch"              # "interactive" | "batch"
    deadline: Optional[float] = None
    out_tokens: List[int] = field(default_factory=list)
    done: bool = False
    status: str = "new"             # see STATUSES
    error: Optional[str] = None     # set when status == "failed"
    # serving metadata (filled by Engine / ShardedScheduler / frontend)
    rank: Optional[int] = None      # engine shard that served the request
    t_submit: Optional[float] = None   # time.monotonic() at submission
    t_first: Optional[float] = None    # first token sampled (prefill)
    t_done: Optional[float] = None     # retired
    t_deadline: Optional[float] = None  # absolute monotonic deadline
    preemptions: int = 0            # times preempted back to the queue
    requeues: int = 0               # times evacuated off a dead rank
    attempts: int = 0               # frontend retry count
    # resume state (set by preempt_slot): the slot's position, and its
    # cache rows' snapshot for a contiguous keep_kv resume
    _resume_pos: Optional[int] = field(default=None, repr=False)
    _kv: Optional[object] = field(default=None, repr=False)

    @property
    def latency(self) -> Optional[float]:
        """Submit-to-retire seconds (None until both stamps exist)."""
        if self.t_submit is None or self.t_done is None:
            return None
        return self.t_done - self.t_submit

    def cost_estimate(self) -> int:
        """Admission-policy key: tokens this request still needs (prompt
        prefill + remaining decode budget)."""
        return len(self.prompt) + self.max_new_tokens - len(self.out_tokens)

    def mark_resumable(self):
        """Arm the re-prefill resume from the emitted tokens: the next
        admission prefills ``prompt + out_tokens[:-1]`` and decode goes
        on from the last token, none resampled. Any KV snapshot is
        dropped. No-op while nothing was emitted."""
        self._kv = None
        self._resume_pos = (len(self.prompt) + len(self.out_tokens) - 1
                            if self.out_tokens else None)


@dataclass
class _SplitKV:
    """A kept-KV snapshot of an engine whose slots are split over 'data':
    the data rank that holds it and, on that rank, the slot's cache rows
    (None on the others)."""
    src: int
    rows: Optional[tuple]


# Engine counter keys, declared (declare-if-absent) into the telemetry
# registry scope of the engine's rank.
_STAT_KEYS = ("decode_steps", "admitted",
              "prefill_tokens", "prefill_tokens_skipped",
              "reprefill_tokens", "generated_tokens",
              "continuous_refills", "preemptions",
              "resumes", "failed", "requeued",
              "cancelled", "deaths",
              "spec_rounds", "spec_draft_tokens",
              "spec_accepted_tokens", "spec_fallbacks")


def _exec_path_label(params, cfg: ModelConfig) -> str:
    """The execution path an engine's decode tokens are credited to
    (the per-path tok/s gauges): dense / masked / bsr / kernel / packed
    / int8. A host-side walk of the param tree for the packed
    containers (``deploy_packed`` sets path="kernel" and adds
    ``sasp_packed`` / ``sasp_fused``)."""
    s = cfg.sasp
    if not getattr(s, "enabled", False):
        return "dense"
    if getattr(s, "quantize", False):
        return "int8"

    if s.path == "kernel" and _has_packed(params):
        return "packed"
    return s.path


def _has_packed(p) -> bool:
    """Does the tree carry a packed container (``sasp_packed`` /
    ``sasp_fused``)?"""
    if isinstance(p, dict):
        return ("sasp_packed" in p or "sasp_fused" in p
                or any(_has_packed(v) for v in p.values()))
    if isinstance(p, (list, tuple)):
        return any(_has_packed(v) for v in p)
    return False


def sample_tokens(logits: torch.Tensor, temps: torch.Tensor,
                  gen: Optional[torch.Generator],
                  q: Optional[torch.Tensor] = None) -> torch.Tensor:
    """logits (B, V) -> (B,) int32 on the device: greedy where temp <= 0,
    else categorical at logits / temp (argmax of probs / q, q ~ Exp(1):
    what ``torch.multinomial`` draws for one sample). Draws one (B, V)
    block of the generator's noise, unless the caller gives it (``q``)."""
    lg = logits.to(torch.float32)
    greedy = torch.argmax(lg, dim=-1).to(torch.int32)
    t = torch.clamp(temps, min=1e-6)[:, None]
    probs = torch.softmax(lg / t, dim=-1)
    if q is None:
        q = torch.empty_like(probs).exponential_(1.0, generator=gen)
    samp = torch.argmax(probs / q, dim=-1).to(torch.int32)
    return torch.where(temps > 0, samp, greedy)


class Engine:
    def __init__(self, params, cfg: ModelConfig, *, batch_slots: int = 4,
                 cache_len: int = 512, rng_seed: int = 0,
                 buckets: Optional[Sequence[int]] = None,
                 kv_pages: Optional[int] = None,
                 kv_page_len: Optional[int] = None,
                 kv_watermark: float = 1.0,
                 kv_host_pages: int = 0,
                 kv_share: bool = False,
                 kv_share_min_pages: int = 1,
                 draft_sparsity: Optional[float] = None,
                 draft_k: int = 4,
                 draft_int8: bool = False,
                 draft_interactive: bool = False,
                 kv_dedup_every: int = 0,
                 admission: str = "continuous",
                 rank: int = 0,
                 telemetry: Optional[Telemetry] = None,
                 mesh=None, draft=None, data_shards: int = 1,
                 seq_split: bool = False):
        if admission not in ADMISSION_MODES:
            raise ValueError(f"admission={admission!r} not in "
                             f"{ADMISSION_MODES}")
        self.admission = admission
        self.rank = rank
        self.dead = False               # set by the scheduler on a raise
        # counters live in the registry's per-rank scope (declare-if-
        # absent keeps them across a revive_rank rebuild against a shared
        # Telemetry); a private default (tracing off) keeps solo engines
        # zero-config
        self.telemetry = telemetry if telemetry is not None \
            else Telemetry()
        self._trace = self.telemetry.tracer
        self.stats = self.telemetry.engine_stats(rank).declare(_STAT_KEYS)
        self.params = params
        self.cfg = cfg
        self.mesh = mesh
        if mesh is not None and draft_sparsity is not None and draft is None:
            raise ValueError(
                "a mesh rank's drafter comes prebuilt (draft=(params, cfg), "
                "e.g. from launch.serve.build_rank_params): its tree holds "
                "no dense masters to re-prune")
        self.B = batch_slots
        self.cache_len = cache_len
        self.device = params["embed"]["emb"].device
        # data parallelism: None, or the layout over the 'data' axis;
        # split engines hold slots [_lo, _lo + _per); the meshless twin
        # of a split engine (_groups data ranks) computes every rank's
        # block in one process; the sequence-parallel layout cuts the
        # rings (cfg.seq_*)
        dp = 1 if mesh is None else mesh.shape["data"]
        ep = cfg.ep_shards if cfg.moe is not None else 1
        self.layout: Optional[str] = None
        self._per: Optional[int] = None
        self._groups: Optional[int] = None
        groups = data_shards if mesh is None else dp
        rings = any(m == MIXER_ATTN for m in cfg.layer_mixer_kinds())
        # a page pool whose page axis the reference's rule cuts over the
        # data ranks (``sharding.pool_axes``), served where the slots
        # split over them too and every block's watermark cap holds one
        # slot's ring (block 0 has two usable pages fewer)
        self._cut = bool(kv_pages) and groups > 1 \
            and batch_slots % groups == 0 and sharding.pool_blocks(
                {"data": groups}, kv_pages + kvmem.RESERVED_PAGES) > 1 \
            and min(kvmem.block_caps(kv_pages, groups, kv_watermark)) \
            >= cache_len // kvmem.tile_aligned_page_len(cfg, cache_len,
                                                        kv_page_len)
        if mesh is None and seq_split:
            seq = sharding.seq_config(
                cfg, {"data": groups, "model": cfg.tp_shards}, batch_slots,
                cache_len)
            if kv_pages or seq is cfg or not rings:
                raise ValueError(
                    f"seq_split: the meshless twin of a sequence-parallel "
                    f"engine (contiguous rings, batch_slots "
                    f"{batch_slots} not split over data_shards={groups}, "
                    f"a ring that {groups} x {cfg.tp_shards} ranks could "
                    f"cut)")
            cfg = self.cfg = seq
            self.layout = SEQ_LAYOUT + " (meshless)"
        elif mesh is not None:
            if dp > 1 and batch_slots % dp == 0 and (not kv_pages
                                                      or self._cut):
                self.layout = (PAGED_LAYOUT if kv_pages
                               else "slots split over data")
                self._per = batch_slots // dp
                self._lo = mesh.data_rank * self._per
            elif not kv_pages and rings and (seq := sharding.seq_config(
                    cfg, mesh, batch_slots, cache_len)) is not cfg:
                cfg = self.cfg = seq
                self.layout = SEQ_LAYOUT
            elif dp > 1:
                self.layout = "replicated over data"
        elif groups > 1 and (batch_slots % groups
                             or (kv_pages and not self._cut)):
            raise ValueError(
                f"data_shards={groups}: the meshless twin of an engine "
                f"whose slots split over {groups} data ranks (batch_slots "
                f"% {groups} == 0; with a page pool, kv_pages + "
                f"{kvmem.RESERVED_PAGES} divisible by {groups} and every "
                f"block's watermark cap at least one slot's ring), or "
                f"with seq_split of one whose batch does not split")
        if ep > 1 and ep != groups:
            raise ValueError(
                f"experts in {ep} EP shards serve one engine over {ep} "
                f"data ranks (its mesh's 'data' axis, or data_shards={ep} "
                f"for the meshless twin); build the experts whole on "
                f"every data rank otherwise")
        if mesh is None and groups > 1 and self.layout is None:
            self.layout = (PAGED_LAYOUT if kv_pages else
                           "slots split over data") + " (meshless)"
            self._groups, self._per, self._lo = (groups,
                                                 batch_slots // groups, 0)
        # experts cut over 'data' on rows every data rank holds alike
        self._replicated_moe = ep > 1 and self._per is None
        # the stream every device op of step() runs on, whichever thread
        # holds the caller's lock
        self._stream = (torch.cuda.current_stream(self.device)
                        if self.device.type == "cuda" else None)
        # prefill length buckets (sorted, <= cache_len); None = exact
        self.buckets: Optional[Tuple[int, ...]] = None
        if buckets:
            bs = tuple(sorted({int(b) for b in buckets}))
            if bs[0] < 1 or bs[-1] > cache_len:
                raise ValueError(
                    f"prefill buckets must lie in [1, cache_len="
                    f"{cache_len}], got {bs} — a bucket beyond the "
                    f"cache can never admit")
            self.buckets = bs
        self._attn_only = all(m == MIXER_ATTN
                              for m in cfg.layer_mixer_kinds())
        self.pool = None
        if kv_share and not kv_pages:
            raise ValueError(
                "kv_share requires the paged KV pool (kv_pages) — "
                "contiguous rings have no pages to share")
        self.kv_share_min_pages = max(1, int(kv_share_min_pages))
        # rid -> prefix tokens matched at admission (prefill skips them)
        self._shared_tokens: dict = {}
        if kv_pages:
            self.pool = kvmem.PagedKVPool(
                params, cfg, cache_len=cache_len, device_pages=kv_pages,
                page_len=kv_page_len, watermark=kv_watermark,
                host_pages=kv_host_pages, share=kv_share,
                device=self.device, telemetry=self.telemetry,
                blocks=groups if self._cut else 1,
                block=(mesh.data_rank if self._cut and mesh is not None
                       else None),
                mesh=mesh if self._cut else None)
            self.caches = None
        else:
            self.caches = lm.init_caches(
                params, cfg, batch_slots if self._groups else
                self._per or batch_slots, cache_len, device=self.device)
        self.pos = np.zeros((batch_slots,), np.int32)
        self.slot_req: List[Optional[Request]] = [None] * batch_slots
        self.queue: List[Request] = []
        self._finished_at_admission: List[Request] = []
        self.on_token: Optional[Callable[[Request, int], None]] = None
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(rng_seed)
        self.draft_sparsity = draft_sparsity
        self.draft_k = int(draft_k)
        self.draft_interactive = bool(draft_interactive)
        self._draft = None
        if draft_sparsity is not None or draft is not None:
            if self.pool is None:
                raise ValueError(
                    "speculative decoding (draft_sparsity) requires "
                    "the paged KV pool (kv_pages) — draft tokens live "
                    "on scratch pages")
            if getattr(cfg, "kv_quant", False):
                raise ValueError(
                    "speculative decoding is incompatible with "
                    "kv_quant: the verify pass attends fresh fp "
                    "suffix K/V while sequential decode attends "
                    "dequantized int8 entries, breaking the "
                    "bit-identity contract")
            if self.draft_k < 1:
                raise ValueError(f"draft_k={draft_k} must be >= 1")
            if self.draft_k + 1 > cache_len:
                raise ValueError(
                    f"draft_k={draft_k} needs k+1 <= cache_len="
                    f"{cache_len}: a round's write range must fit the "
                    f"ring without self-overlap")
            if draft is not None:
                self._draft = tuple(draft)
            else:
                from repro_torch.core.deploy import draft_pack
                with torch.no_grad():
                    self._draft = draft_pack(
                        self.params, cfg, sparsity=float(draft_sparsity),
                        quantize=bool(draft_int8))
        self.kv_dedup_every = max(0, int(kv_dedup_every))
        if self.kv_dedup_every and (self.pool is None
                                    or not self.pool.share):
            raise ValueError(
                "kv_dedup_every requires the sharing page pool "
                "(kv_pages + kv_share) — without the radix index "
                "there is no content evidence to merge on")
        self.path_label = _exec_path_label(self.params, cfg)
        if self.pool is not None:
            # export-time memory gauges, keyed so a revive_rank rebuild
            # replaces its predecessor's collector
            self.telemetry.registry.register_collector(
                self._memory_metrics, key=("kv_pool", rank))

    def _memory_metrics(self):
        """Prometheus lines of the page pool's MemoryStats (host
        counters, no device read)."""
        out = {}
        for k, v in self.pool.stats().as_dict().items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                out[f'serve_kv_{k}{{rank="{self.rank}"}}'] = v
        return out

    def _on_stream(self):
        """Run on the engine's stream (a no-op on the CPU)."""
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def _mesh_ctx(self):
        """The engine's mesh as the active one (a no-op without one, or
        where the mesh is one process), declaring replicated rows where
        experts cut over 'data' serve a batch that does not split (and
        in the meshless twin of such an engine)."""
        from repro_torch.distribution import context as dctx
        if self.mesh is None or (self.mesh.shape["model"] == 1
                                 and self.mesh.shape["data"] == 1):
            if self._replicated_moe:
                return dctx.use_mesh(None, replicated_rows=True)
            return contextlib.nullcontext()
        return dctx.use_mesh(self.mesh,
                             replicated_rows=self._replicated_moe)

    def _sample(self, logits: Optional[torch.Tensor], temps: torch.Tensor,
                slots: Optional[Sequence[int]] = None) -> torch.Tensor:
        """``sample_tokens`` on this rank; on a mesh, model rank 0's
        tokens on every rank, so the ranks cannot part even where
        sampling is not greedy; over 'data', data rank 0's tokens, or,
        with the slots split, every row from the data rank that holds its
        slot (``slots``: row i's slot, default i; ``logits``: this data
        rank's rows only, None when it holds none)."""
        if self._per is None:
            nxt = sample_tokens(logits, temps, self._gen)
            if self.mesh is not None:
                nxt = self.mesh.data_broadcast(self.mesh.broadcast(nxt))
            return nxt
        slots = range(len(temps)) if slots is None else slots
        mine = self._own_rows(slots)
        # the whole batch's noise, so that every row samples as it would
        # in one engine
        q = torch.empty((len(temps), self.cfg.vocab_size),
                        dtype=torch.float32, device=self.device
                        ).exponential_(1.0, generator=self._gen)
        nxt = torch.zeros((len(temps),), dtype=torch.int32,
                          device=self.device)
        if self._groups:                # every data rank's rows, here
            for g in range(self._groups):
                idx = self._t(self._own_rows(slots, g), torch.int64)
                if len(idx):
                    nxt[idx] = sample_tokens(logits[idx], temps[idx], None,
                                             q=q[idx])
            return nxt
        if mine:
            idx = self._t(mine, torch.int64)
            nxt[idx] = sample_tokens(logits, temps[idx], None, q=q[idx])
        rows = self.mesh.data_all_gather(self.mesh.broadcast(nxt))
        owner = self._t([s // self._per for s in slots], torch.int64)
        return rows.gather(0, owner[None])[0]

    def _agree(self, toks: torch.Tensor) -> torch.Tensor:
        """Greedy tokens every rank computed from the same all-gathered
        logits, taken from model rank 0 (and data rank 0, unless each
        data rank computed rows of its own) on a mesh, so that every
        rank's host state moves on the same tokens."""
        if self.mesh is None:
            return toks
        toks = self.mesh.broadcast(toks)
        return toks if self._per is not None else \
            self.mesh.data_broadcast(toks)

    def _to_batch(self, rows: torch.Tensor) -> torch.Tensor:
        """A mesh rank's own rows of a cut pool's pass in their slots of
        the whole batch (0 elsewhere); the rows as they are otherwise."""
        if not self._cut or self._groups:
            return rows
        out = rows.new_zeros((self.B,) + tuple(rows.shape[1:]))
        out[self._lo:self._lo + self._per] = rows
        return out

    def _share_round(self, drafts: np.ndarray, pred: np.ndarray):
        """A speculative round's drafts (k, B) and the target's
        predictions (B, k+1) of every row in every process: on a mesh
        rank of a cut pool each data rank has its own rows, shared by one
        all-gather over 'data'."""
        if not self._cut or self._groups:
            return drafts, pred
        k, rows = len(drafts), slice(self._lo, self._lo + self._per)
        mine = np.concatenate([drafts[:, rows].T, pred[rows]], axis=1)
        both = self.mesh.data_all_gather(self._t(mine)).cpu().numpy()
        both = both.reshape(self.B, 2 * k + 1)
        return np.ascontiguousarray(both[:, :k].T), both[:, k:]

    def _block(self, slot: int) -> int:
        """The page block of ``slot``: its data rank's where the pool is
        cut, else 0."""
        return slot // self._per if self._cut else 0

    def _row_groups(self, slots: Sequence[int]
                    ) -> List[Tuple[int, List[int]]]:
        """The page blocks this process computes rows of, each with its
        rows (indices into ``slots``): where the pool is cut, every data
        rank's (the twin) or this data rank's (a mesh rank); else block 0
        with every row."""
        if not self._cut:
            return [(0, list(range(len(slots))))]
        gs = range(self._groups) if self._groups else (self.mesh.data_rank,)
        return [(g, self._own_rows(slots, g)) for g in gs]

    def _bystander(self, S: int):
        """A mesh rank with no rows in a prefill still enters the MoE
        layers' collectives where experts split over 'data' (its experts
        serve the other data ranks' tokens)."""
        if self.cfg.moe is not None and self.cfg.ep_shards > 1:
            lm.moe_bystander(self.params, self.cfg, S, self.device,
                             as_dtype(self.cfg.compute_dtype))

    def _own_rows(self, slots: Sequence[int], g: Optional[int] = None
                  ) -> Optional[List[int]]:
        """With the slots split: the rows (indices into ``slots``) whose
        slot this data rank (or data rank ``g``) holds; None otherwise
        (every row)."""
        if self._per is None:
            return None
        lo = self._lo if g is None else g * self._per
        return [i for i, s in enumerate(slots) if lo <= s < lo + self._per]

    # -- device passes -------------------------------------------------
    def _t(self, a, dtype=torch.int32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype,
                               device=self.device)

    def _decode_step(self, params, cfg, toks, pos):
        """One decode forward of every slot over the contiguous caches
        (updated in place): (B, V) logits; with the slots split, this
        data rank's (B / DP, V)."""
        if self._groups:
            return lm.decode_step_groups(params, cfg, toks, pos,
                                         self.caches, self._groups)[:, 0]
        if self._per is not None:
            rows = slice(self._lo, self._lo + self._per)
            toks, pos = toks[rows], pos[rows]
        logits, self.caches = lm.decode_step(params, cfg, toks, pos,
                                             self.caches)
        return logits[:, 0]

    def _block_tables(self, bt: np.ndarray
                      ) -> List[Tuple[int, slice, torch.Tensor]]:
        """A decode block table (B, NB) of global page ids as the device
        tables this process gathers with: (block, its rows, the rows'
        ids into the block's tensors), one a block it computes rows of;
        a whole pool's table goes to the device as it is."""
        if self.pool.blocks == 1:
            return [(0, slice(0, self.B), self._t(bt))]
        out = []
        for g, rows in self._row_groups(range(self.B)):
            r = slice(rows[0], rows[-1] + 1)
            out.append((g, r, self._t(self.pool.local(bt[r], g))))
        return out

    def _paged_decode_step(self, params, cfg, toks, pos, bt, tabs=None):
        """The paged twin of ``_decode_step``: gather each slot's pages
        (block table ``bt``: (B, NB) global page ids, numpy; ``tabs``
        its ``_block_tables`` where the caller made them already) into
        the contiguous ring layout, run the same decode, write back the
        one page each slot touched. (B, V) logits. Where the pool is
        cut, each data rank's rows read and write its own block: a mesh
        rank computes its own rows only ((B / DP, V) logits), the twin
        every rank's in lock step (``lm.decode_step_groups``)."""
        pool = self.pool
        if tabs is None:
            tabs = self._block_tables(bt)
        groups = [g for g, _, _ in tabs]
        spans = [r for _, r, _ in tabs]
        tabs = [t for _, _, t in tabs]
        caches = [kvmem.gather_block_tables(pool.block_data(g), t)
                  for g, t in zip(groups, tabs)]
        if self._groups:
            whole = kvmem.cat_rows(caches)
            logits = lm.decode_step_groups(params, cfg, toks, pos, whole,
                                           self._groups)
            caches = [kvmem.rows_of(whole, r.start, r.stop) for r in spans]
        else:
            logits, caches[0] = lm.decode_step(params, cfg, toks[spans[0]],
                                               pos[spans[0]], caches[0])
        for g, r, t, c in zip(groups, spans, tabs, caches):
            kvmem.scatter_written_pages(pool.block_data(g), c, t, pos[r],
                                        pool.NB, pool.page_len)
        return logits[:, 0]

    def _draft_decode(self, toks, pos, tabs) -> torch.Tensor:
        """One drafter step (greedy, the generator untouched) against the
        round's ``_block_tables`` -> (B,); a mesh rank of a cut pool
        drafts its own rows (0 elsewhere)."""
        dparams, dcfg = self._draft
        logits = self._paged_decode_step(dparams, dcfg, toks, pos, None,
                                         tabs)
        return self._to_batch(self._agree(
            torch.argmax(logits.to(torch.float32), dim=-1)
            .to(torch.int32)))

    def _paged_spec_verify(self, toks, poss, past_bt, dests
                           ) -> torch.Tensor:
        """One target pass over [x0, d1..dk] at positions P..P+k against
        each slot's real pages: the target's greedy token after every
        position (B, k+1); a mesh rank of a cut pool verifies its own
        rows (0 elsewhere). Its fresh K/V merges into the round's scratch
        pages (``dests``), only where the suffix holds an entry."""
        logits = self._paged_rows(range(self.B), toks, poss, past_bt, dests,
                                  "verify")
        return self._to_batch(self._agree(
            torch.argmax(logits.to(torch.float32), dim=-1)
            .to(torch.int32)))

    def _paged_rows(self, slots, toks, poss, past, dests, kind):
        """One paged pass of the target over rows (row i that of slot
        ``slots[i]``): ``kind`` "prefill" (the prompts; the new pages
        scattered at ``dests``, the trash page taking unallocated logical
        pages and padding), "past" (prefix sharing: each row's suffix
        against its matched prefix pages ``past``, the rest reading the
        zero page; fresh pages at ``dests``, which route shared pages to
        trash) or "verify" (every position's logits against ``past``;
        the suffix's entries merged into the scratch pages ``dests``).
        ``past`` / ``dests``: (rows, NB) global page ids, numpy.
        Where the pool is cut each data rank's rows go against its block:
        the twin runs every rank's in lock step (``lm.prefill_groups``,
        ``lm.prefill_with_past_groups``), a mesh rank its own (a
        bystander in the MoE layers where it has none). Returns the
        logits of the rows computed here in the call's order: every row,
        or a mesh rank's own (None where it has none)."""
        pool, params, cfg = self.pool, self.params, self.cfg
        parts = []
        for g, rows in self._row_groups(slots):
            sel = self._t(rows, torch.int64)
            pst = None if past is None else kvmem.gather_block_tables(
                pool.block_data(g), self._t(pool.local(past[rows], g)))
            parts.append((g, sel, toks[sel],
                          None if poss is None else poss[sel], pst,
                          self._t(pool.local(dests[rows], g))))
        if self._groups:
            if kind == "prefill":
                outs = lm.prefill_groups(params, cfg, [p[2] for p in parts],
                                         [p[3] for p in parts],
                                         self.cache_len, uniform_cache=True)
            else:
                outs = lm.prefill_with_past_groups(
                    params, cfg, [p[2] for p in parts], [p[3] for p in parts],
                    [p[4] for p in parts], all_logits=kind == "verify")
        elif not len(parts[0][1]):
            self._bystander(toks.shape[1])
            return None
        elif kind == "prefill":
            outs = [lm.prefill(params, cfg, parts[0][2],
                               cache_len=self.cache_len,
                               positions=parts[0][3], uniform_cache=True)]
        else:
            outs = [lm.prefill_with_past(params, cfg, parts[0][2],
                                         parts[0][3], parts[0][4],
                                         all_logits=kind == "verify")]
        scatter = (kvmem.masked_scatter_pages if kind == "verify"
                   else kvmem.scatter_prefill_pages)
        logits = None
        for (g, sel, *_, dst), out in zip(parts, outs):
            if out is None:
                continue
            lg, caches1 = out
            scatter(pool.block_data(g), caches1, dst)
            if not self._groups:
                return lg
            if logits is None:
                logits = lg.new_zeros((len(slots),) + tuple(lg.shape[1:]))
            logits[sel] = lg
        return logits

    def _prefill_and_write(self, toks, poss, all_slots, valid):
        """Contiguous admission: prompt prefill, then the new cache rows
        written into the batch caches at ``all_slots``. ``valid`` (G,)
        masks bucketed pad rows, which rewrite their slot's own rows.
        With the slots split, only the rows of this data rank's slots
        (None when it holds none)."""
        if self._groups:
            return self._prefill_groups(toks, poss, all_slots, valid)
        rows = self._own_rows(all_slots)
        if rows is not None:
            if not rows:
                self._bystander(toks.shape[1])
                return None
            sel = self._t(rows, torch.int64)
            toks = toks[sel]
            poss = None if poss is None else poss[sel]
            valid = None if valid is None else valid[sel]
            all_slots = [all_slots[i] - self._lo for i in rows]
        logits, caches1 = lm.prefill(self.params, self.cfg, toks,
                                     cache_len=self.cache_len,
                                     positions=poss)
        self._write_rows(caches1, all_slots, valid)
        return logits[:, 0]

    def _prefill_groups(self, toks, poss, all_slots, valid):
        """The meshless twin of a split engine's admission: each data
        rank's rows (those of its slots) as its own group, in lock step
        (``lm.prefill_groups``), written into the whole caches; the
        last-token logits of every row, in the call's order."""
        rows = [self._own_rows(all_slots, g) for g in range(self._groups)]
        sels = [self._t(r, torch.int64) for r in rows]
        outs = lm.prefill_groups(
            self.params, self.cfg, [toks[s] for s in sels],
            [None if poss is None else poss[s] for s in sels],
            self.cache_len)
        logits = None
        for r, sel, out in zip(rows, sels, outs):
            if out is None:
                continue
            lg, caches1 = out
            if logits is None:
                logits = lg.new_zeros((len(all_slots),) + lg.shape[1:])
            logits[sel] = lg
            self._write_rows(caches1, [all_slots[i] for i in r],
                             None if valid is None else valid[sel])
        return logits[:, 0]

    def _write_rows(self, caches1, all_slots, valid):
        """Prefilled cache rows into the batch caches at ``all_slots``
        (local slot indices); ``valid`` masks pad rows, which keep their
        slot's rows."""
        idx = self._t(all_slots, torch.int64)
        for seg, new_seg in zip(self.caches, caches1):
            for name, c in seg.items():
                for leaf, new in zip(c, new_seg[name]):
                    if leaf is None:
                        continue
                    new = new.to(leaf.dtype)
                    if valid is not None:
                        vm = valid.reshape((1, -1) + (1,) * (new.ndim - 2))
                        new = torch.where(vm, new, leaf[:, idx])
                    leaf[:, idx] = new

    def _run_prefill(self, toks, poss, all_slots, reqs, valid):
        """One admission pass; returns the last-token logits (G, V).
        Paged engines scatter pages at each request's allocated pages
        (pad rows write the trash page). The ``prefill`` span times the
        host around the launches."""
        t0 = self._trace.t0()
        rows, S = np.shape(toks)
        toks = self._t(toks)
        poss = None if poss is None else self._t(poss)
        if self.pool is None:
            out = self._prefill_and_write(toks, poss, all_slots, valid)
        else:
            out = self._paged_rows(all_slots, toks, poss, None,
                                   self.pool.dest_table(
                                       [r.rid for r in reqs], rows),
                                   "prefill")
            out = None if out is None else out[:, 0]
        self._trace.complete("prefill", t0, tid=self.rank,
                             rids=[r.rid for r in reqs], rows=int(rows),
                             S=int(S))
        return out

    # ------------------------------------------------------------------
    def submit(self, req: Request):
        """Enqueue a request (FCFS append; a scheduler imposes its own
        order by re-sorting the queue before each step)."""
        if req.t_submit is None:
            req.t_submit = time.monotonic()
        req.rank = self.rank
        req.status = "queued"
        self.queue.append(req)
        self._trace.instant("submit", tid=self.rank, rid=req.rid,
                            queue=len(self.queue))

    def _free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slot_req) if r is None]

    def slot_states(self) -> List[str]:
        """Per-slot state: 'free' or 'decode' (prefill is transient
        inside the step that admits)."""
        return ["free" if r is None else "decode" for r in self.slot_req]

    def outstanding_tokens(self, slo: Optional[str] = None) -> int:
        """Load metric for routing: queued work (prompt to prefill +
        decode budget) plus the remaining decode budget of every occupied
        slot; ``slo`` restricts the sum to one SLO class."""
        return (sum(r.cost_estimate() for r in self.queue
                    if slo is None or r.slo == slo)
                + sum(r.max_new_tokens - len(r.out_tokens)
                      for r in self.slot_req
                      if r is not None and (slo is None or r.slo == slo)))

    def n_free(self) -> int:
        return len(self._free_slots())

    def has_work(self) -> bool:
        return bool(self.queue) or any(r is not None
                                       for r in self.slot_req)

    def admission_capacity(self) -> int:
        """Requests this engine could admit now: free slots, capped by
        the page pool's headroom when KV is paged."""
        free = self.n_free()
        if self.pool is None:
            return free
        return min(free, self.pool.admissible_requests())

    def memory_stats(self):
        """The page pool's accounting (None when KV is contiguous)."""
        return None if self.pool is None else self.pool.stats()

    def route_headroom_tokens(self) -> Optional[int]:
        """Tokens of cache this engine can allocate before it spills:
        free pages under the watermark plus cached (rc 0) prefix pages,
        times the page length. None for contiguous engines."""
        if self.pool is None:
            return None
        st = self.pool.stats()
        free = max(0, st.watermark - st.device_used) + st.cached_pages
        return free * self.pool.page_len

    def _emit(self, req: Request, tok: int):
        req.out_tokens.append(tok)
        self._trace.instant("token", tid=self.rank, rid=req.rid)
        if self.on_token is not None:
            self.on_token(req, tok)

    def _sample_host(self, logits: Optional[torch.Tensor],
                     temps: Sequence[float],
                     slots: Optional[Sequence[int]] = None) -> List[int]:
        t = torch.tensor(list(temps), dtype=torch.float32,
                         device=self.device)
        return self._sample(logits, t, slots).cpu().tolist()

    # -- preemption ----------------------------------------------------
    def preempt_slot(self, slot: int, *, keep_kv: bool = True) -> Request:
        """Move the request decoding in ``slot`` back to QUEUED and free
        the slot; the caller re-queues it. ``keep_kv=True`` keeps its KV
        (a snapshot of the slot's cache rows; paged: its pages stay
        allocated, turn cold and may spill), ``keep_kv=False`` drops it
        and resume re-prefills ``prompt + out_tokens[:-1]``."""
        req = self.slot_req[slot]
        assert req is not None, f"preempting free slot {slot}"
        if self.pool is not None:
            if keep_kv:
                self.pool.preempt(req.rid)
            else:
                self.pool.free(req.rid)
        elif keep_kv:
            req._kv = self._snapshot(slot)
        req._resume_pos = int(self.pos[slot])
        req.preemptions += 1
        req.status = "queued"
        self.slot_req[slot] = None
        self.stats["preemptions"] += 1
        self._trace.instant("preempt", tid=self.rank, rid=req.rid,
                            kept_kv=bool(keep_kv))
        return req

    def _finish_resume(self, slot: int, req: Request):
        req._resume_pos = None
        req._kv = None
        req.status = "running"
        self.slot_req[slot] = req
        self.stats["resumes"] += 1
        self._trace.instant("resume", tid=self.rank, rid=req.rid)

    def _snapshot(self, slot: int):
        """A clone of ``slot``'s cache rows. With the slots split, a
        ``_SplitKV``: the rows on the data rank that holds the slot."""
        local = slot
        if self._per is not None:
            src = slot // self._per
            if src != self.mesh.data_rank:
                return _SplitKV(src, None)
            local = slot - self._lo
        with self._on_stream():
            rows = tuple({name: cache_map(lambda a: a[:, local].clone(), c)
                          for name, c in seg.items()} for seg in self.caches)
        return rows if self._per is None else _SplitKV(src, rows)

    def _restore_slot(self, slot: int, req: Request):
        """Snapshot resume: the saved cache rows go back, no forward.
        With the slots split, the rows go from the data rank that saved
        them to the one that holds ``slot`` (a broadcast over 'data' when
        the two differ)."""
        assert self.slot_req[slot] is None, \
            f"resume into occupied slot {slot}"
        saved, local = req._kv, slot
        if self._per is not None:
            saved = self._moved_rows(req._kv, slot // self._per)
            local = slot - self._lo
        if saved is not None:
            for seg, rows in zip(self.caches, saved):
                for name, c in seg.items():
                    for leaf, s in zip(c, rows[name]):
                        if leaf is not None:
                            leaf[:, local] = s
        self.pos[slot] = req._resume_pos
        self._finish_resume(slot, req)

    def _moved_rows(self, kv: "_SplitKV", dst: int):
        """A split snapshot's rows on data rank ``dst`` (None elsewhere):
        broadcast over 'data' from the data rank that saved them when
        that is another, every data rank taking part."""
        if kv.src == dst:
            return kv.rows              # None on every other data rank

        def moved(si, name, li, leaf):
            buf = torch.empty_like(leaf[:, 0]) if kv.rows is None \
                else kv.rows[si][name][li]
            return self.mesh.data_broadcast(buf, kv.src)

        with self._on_stream():
            out = tuple(
                {name: type(c)(*(None if leaf is None
                                 else moved(si, name, li, leaf)
                                 for li, leaf in enumerate(c)))
                 for name, c in seg.items()}
                for si, seg in enumerate(self.caches))
        return out if self.mesh.data_rank == dst else None

    def _attach_paged_resume(self, slot: int, req: Request):
        """Paged resume: the pages were just pinned resident (spilled
        ones faulted back); only the block table changes."""
        assert self.slot_req[slot] is None, \
            f"resume into occupied slot {slot}"
        self.pos[slot] = req._resume_pos
        self._finish_resume(slot, req)

    def _page_keys(self, seq: np.ndarray) -> Tuple[bytes, ...]:
        """Radix keys: one per FULL page of ``seq`` (the trailing partial
        page is private). Empty when sharing is off or the sequence
        overflows the ring."""
        if self.pool is None or not self.pool.share:
            return ()
        if len(seq) > self.cache_len:
            return ()
        L = self.pool.page_len
        a = np.ascontiguousarray(np.asarray(seq, np.int32))
        return tuple(a[j * L:(j + 1) * L].tobytes()
                     for j in range(len(seq) // L))

    def _paged_reserve(self, req: Request, slot: int) -> Tuple[bool, str]:
        """Acquire an admission's pages, in ``slot``'s block: (ok,
        'resume') re-attached a preempted request's live pages (moved
        from another block where the pool is cut and it held them
        there), (ok, 'prefill') allocated pages to prefill. Sharing maps
        matched prefix pages instead, leaving at least one token to
        prefill (the first sampled token comes from the suffix's last
        logits). Not ok: the block is exhausted."""
        block = self._block(slot)
        if req._resume_pos is not None and self.pool.has_pages(req.rid):
            return self.pool.resume(req.rid, block), "resume"
        seq = self._prefill_tokens(req)
        n = self.pool.pages_for(len(seq))
        keys = self._page_keys(seq)
        if keys:
            keys = keys[:(len(seq) - 1) // self.pool.page_len]
        ok, m = self.pool.admit_prefix(
            req.rid, n, keys, min_pages=self.kv_share_min_pages, block=block)
        if ok and m:
            self._shared_tokens[req.rid] = m * self.pool.page_len
        return ok, "prefill"

    def _paged_place(self, req: Request, free: Sequence[int]
                     ) -> Tuple[Optional[int], Optional[str]]:
        """The first of the ``free`` slots whose page block takes
        ``req``, and how (``_paged_reserve``'s mode); each block is
        asked once. (None, None): no block has room. A whole pool has one
        block: the first free slot or none."""
        asked = set()
        for slot in free:
            block = self._block(slot)
            if block in asked:
                continue
            asked.add(block)
            ok, mode = self._paged_reserve(req, slot)
            if ok:
                return slot, mode
        return None, None

    def _prefill_tokens(self, req: Request) -> np.ndarray:
        """The prompt, or for a re-prefill resume the prompt and every
        generated token but the last (the next decode input)."""
        if req._resume_pos is None:
            return np.asarray(req.prompt, np.int32)
        return np.concatenate([
            np.asarray(req.prompt, np.int32),
            np.asarray(req.out_tokens[:-1], np.int32)])

    def _bucket_len(self, S: int) -> int:
        """Smallest bucket >= S; S itself past every bucket."""
        for b in self.buckets:
            if b >= S:
                return b
        return S

    def _started(self, slot: int, req: Request, nxt: int, length: int):
        """A prefilled request enters decode with its first token (a
        re-prefill resume discards the sampled one: its last token was
        emitted before the preemption)."""
        assert self.slot_req[slot] is None, \
            f"prefill into occupied slot {slot}"
        self.pos[slot] = length
        if req._resume_pos is not None:
            self._finish_resume(slot, req)
            return
        self._emit(req, nxt)
        req.t_first = time.monotonic()
        self._observe_ttft(req)
        if self._retired_at_admission(req):
            return
        req.status = "running"
        self.slot_req[slot] = req

    def _prefill_into_slot(self, slot: int, req: Request, seq: np.ndarray):
        """Single-sequence prefill (unpadded positions)."""
        logits_last = self._run_prefill(seq[None, :], None, [slot], [req],
                                        None)
        self._register_prompt([req], [seq])
        (nxt,) = self._sample_host(logits_last, [req.temperature], [slot])
        self._started(slot, req, nxt, len(seq))

    def _prefill_group(self, slots: List[int], reqs: List[Request],
                       seqs: List[np.ndarray]):
        """Batched multi-slot prefill: one LEFT-padded forward pass. With
        ``buckets`` the group is padded to all B rows and S to a bucket;
        pad rows leave their slots untouched."""
        G = len(reqs)
        lens = [len(s) for s in seqs]
        S = max(lens)
        valid = None
        all_slots = list(slots)
        if self.buckets:
            S = self._bucket_len(S)
            all_slots += [i for i in range(self.B) if i not in slots]
            valid = self._t(np.arange(len(all_slots)) < G, torch.bool)
        Gp = len(all_slots)
        toks = np.zeros((Gp, S), np.int32)
        poss = np.tile(np.arange(S, dtype=np.int32) - S, (Gp, 1))
        for g, seq in enumerate(seqs):
            pad = S - lens[g]
            toks[g, pad:] = seq
            poss[g] = np.arange(S) - pad
        logits_last = self._run_prefill(toks, poss, all_slots, reqs, valid)
        self._register_prompt(reqs, seqs)
        temps = np.zeros((Gp,), np.float32)
        for g, r in enumerate(reqs):
            temps[g] = r.temperature
        nxts = self._sample_host(logits_last, temps, all_slots)[:G]
        for slot, req, nxt, L in zip(slots, reqs, nxts, lens):
            self._started(slot, req, nxt, L)

    def _observe_ttft(self, req: Request):
        """Time to first token into the per-SLO-class histogram, when
        ``t_first`` is stamped."""
        if req.t_submit is not None and req.t_first is not None:
            self.telemetry.observe_ttft(req.slo,
                                        req.t_first - req.t_submit)

    def _register_prompt(self, reqs: List[Request],
                         seqs: List[np.ndarray]):
        """Publish freshly prefilled full prompt pages into the radix
        index, before any retire-at-admission free (a prompt that ends
        at once still seeds the cache)."""
        if self.pool is None or not self.pool.share:
            return
        for r, s in zip(reqs, seqs):
            self.pool.register_prefix(r.rid, self._page_keys(s))

    def _prefill_group_shared(self, slots: List[int],
                              reqs: List[Request],
                              seqs: List[np.ndarray]):
        """Suffix-only batched prefill of admissions whose prompts
        matched shared prefix pages: row g holds ``seq[skip_g:]``
        left-padded at absolute positions (pads -1); each row's matched
        pages are gathered as its past ring and only the fresh suffix
        pages are written (shared pages never are)."""
        L = self.pool.page_len
        skips = [self._shared_tokens[r.rid] for r in reqs]
        sufs = [np.asarray(s[m:], np.int32) for s, m in zip(seqs, skips)]
        lens = [len(s) for s in sufs]
        G = len(reqs)
        S = max(lens)
        nrows = G
        if self.buckets:
            S = self._bucket_len(S)
            nrows = self.B
        # pad rows take the free slots' places
        all_slots = list(slots) + [i for i in range(self.B)
                                   if i not in slots][:nrows - G]
        toks = np.zeros((nrows, S), np.int32)
        poss = np.full((nrows, S), -1, np.int32)
        for g, suf in enumerate(sufs):
            pad = S - lens[g]
            toks[g, pad:] = suf
            poss[g, pad:] = np.arange(skips[g], skips[g] + lens[g])
        rids = [r.rid for r in reqs]
        skip_pages = [m // L for m in skips]
        t0 = self._trace.t0()
        logits = self._paged_rows(
            all_slots, self._t(toks), self._t(poss),
            self.pool.prefix_table(rids, skip_pages, nrows),
            self.pool.dest_table(rids, nrows, skip_pages=skip_pages),
            "past")
        logits = None if logits is None else logits[:, 0]
        self._trace.complete("prefill", t0, tid=self.rank, rids=rids,
                             rows=int(nrows), S=int(S), shared=True)
        self._register_prompt(reqs, seqs)
        temps = np.zeros((nrows,), np.float32)
        for g, r in enumerate(reqs):
            temps[g] = r.temperature
        nxts = self._sample_host(logits, temps, all_slots)[:G]
        for slot, req, nxt, seq in zip(slots, reqs, nxts, seqs):
            self._started(slot, req, nxt, len(seq))

    def _retired_at_admission(self, req: Request) -> bool:
        """EOS / budget check on the prefill-sampled token."""
        if ((req.eos_id is not None and req.out_tokens[-1] == req.eos_id)
                or len(req.out_tokens) >= req.max_new_tokens):
            req.done = True
            req.status = "done"
            req.t_done = time.monotonic()
            if self.pool is not None:
                self.pool.free(req.rid)
            self._finished_at_admission.append(req)
            return True
        return False

    def _admit(self):
        free = self._free_slots()
        if self.admission == "drain" and len(free) < self.B:
            return                  # the drain baseline waits for all
        take = min(len(free), len(self.queue))
        if not take:
            return
        popped = [self.queue.pop(0) for _ in range(take)]
        open_slots = list(free)
        try:
            # snapshot / page resumes restore directly; paged admissions
            # take their pages first, in the first free slot whose block
            # has room, and defer (back to the queue, in order) once no
            # block has
            pending = []
            for k, req in enumerate(popped):
                slot, mode = open_slots[0], None
                if self.pool is not None:
                    slot, mode = self._paged_place(req, open_slots)
                    if slot is None:
                        self.queue[:0] = popped[k:]
                        popped = popped[:k]
                        break
                open_slots.remove(slot)
                if mode == "resume":
                    self._attach_paged_resume(slot, req)
                    continue
                if req._resume_pos is not None and req._kv is not None:
                    self._restore_slot(slot, req)
                else:
                    pending.append((slot, req))
            if len(free) < self.B:
                self.stats["continuous_refills"] += len(popped)
            self.stats["admitted"] += len(popped)
            if self._trace.enabled:
                for req in popped:
                    self._trace.instant("admit", tid=self.rank,
                                        rid=req.rid)
            if not pending:
                return
            # sharing admissions take the suffix prefill, the others the
            # unchanged path
            shared, normal = [], []
            for slot, req in pending:
                seq = self._prefill_tokens(req)
                skip = self._shared_tokens.get(req.rid, 0)
                if req._resume_pos is None:
                    self.stats["prefill_tokens"] += len(seq) - skip
                    self.stats["prefill_tokens_skipped"] += skip
                else:
                    self.stats["reprefill_tokens"] += len(seq) - skip
                (shared if skip else normal).append((slot, req, seq))
            if shared:
                self._prefill_group_shared(
                    [s for s, _, _ in shared], [r for _, r, _ in shared],
                    [q for _, _, q in shared])
            if normal:
                slots = [s for s, _, _ in normal]
                reqs = [r for _, r, _ in normal]
                seqs = [q for _, _, q in normal]
                if (self._attn_only
                        and max(len(s) for s in seqs) <= self.cache_len
                        and (len(reqs) > 1 or self.buckets)):
                    self._prefill_group(slots, reqs, seqs)
                else:
                    for slot, req, seq in zip(slots, reqs, seqs):
                        self._prefill_into_slot(slot, req, seq)
            for _, req in pending:
                self._shared_tokens.pop(req.rid, None)
        except BaseException:
            # a raising admission loses no request: what is not slotted
            # (or retired) goes back to the queue front, and its pages
            # are released (un-prefilled) or turn cold again (resumes)
            placed = {id(r) for r in self.slot_req if r is not None}
            placed |= {id(r) for r in self._finished_at_admission}
            back = [r for r in popped if id(r) not in placed]
            for r in popped:
                self._shared_tokens.pop(r.rid, None)
            if self.pool is not None:
                for r in back:
                    if not self.pool.has_pages(r.rid):
                        continue
                    if r._resume_pos is not None:
                        self.pool.mark_preempted(r.rid)
                    else:
                        self.pool.free(r.rid)
            self.queue[:0] = back
            raise

    # ------------------------------------------------------------------
    def step(self) -> List[Request]:
        """Admit queued requests, run one decode step (and the slots'
        speculative rounds), retire finished. Returns completed
        requests."""
        with torch.no_grad(), self._on_stream(), self._mesh_ctx():
            return self._step_inner()

    def _step_inner(self) -> List[Request]:
        self._admit()
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        # speculating slots are claimed first: their writes land on
        # scratch pages, so they skip the write-rule guard below
        specs = self._collect_specs(active) if active else []
        if self.pool is not None and active:
            # decode growth + write rule: the page of this step's write
            # position must be resident and writable (rc 1, unregistered)
            # before the step; a slot that cannot get it is preempted
            # with its pages kept
            C, L = self.cache_len, self.pool.page_len
            for i in list(active):
                req = self.slot_req[i]
                if not self.pool.ensure_writable(
                        req.rid, (int(self.pos[i]) % C) // L):
                    self.queue.insert(0, self.preempt_slot(i))
                    active.remove(i)
        if not active and not specs:
            finished = self._finished_at_admission
            self._finished_at_admission = []
            if self.pool is not None:
                self.stats["memory"] = self.pool.stats().as_dict()
            return finished
        finished: List[Request] = []
        if active:
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
            toks, pos = self._t(last), self._t(self.pos)
            if self.pool is None:
                logits = self._decode_step(self.params, self.cfg, toks, pos)
            else:
                # speculating slots read and write the trash page here
                bt = self.pool.block_table(
                    [r.rid if (r is not None and i in active) else None
                     for i, r in enumerate(self.slot_req)])
                logits = self._paged_decode_step(self.params, self.cfg,
                                                 toks, pos, bt)
            act_t = self._t(act, torch.bool)
            nxt = self._sample(logits, self._t(temps, torch.float32))
            nxt = torch.where(act_t, nxt, torch.zeros_like(nxt))
            done = act_t & ((nxt == self._t(eos))
                            | (self._t(remaining) <= 1))
            nxt = nxt.cpu().numpy()                 # the only per-token
            done = done.cpu().numpy()               # host traffic
        else:
            # every live slot speculates: draw the step's noise all the
            # same, so later sampled tokens do not depend on the drafter
            torch.empty((self.B, self.cfg.vocab_size), device=self.device
                        ).exponential_(1.0, generator=self._gen)
        self.stats["decode_steps"] += 1
        self.stats["generated_tokens"] += len(active)
        self.telemetry.note_tokens(self.path_label, len(active))
        for i in active:
            req = self.slot_req[i]
            self.pos[i] += 1
            self._emit(req, int(nxt[i]))
            if bool(done[i]):
                req.done = True
                req.status = "done"
                req.t_done = time.monotonic()
                if self.pool is not None:
                    self.pool.free(req.rid)
                finished.append(req)
                self.slot_req[i] = None
        if specs:
            finished += self._run_spec_round(specs)
        if (self.kv_dedup_every
                and self.stats["decode_steps"] % self.kv_dedup_every == 0):
            self.pool.dedup_sweep()
        finished = self._finished_at_admission + finished
        self._finished_at_admission = []
        if self.pool is not None:
            self.stats["memory"] = self.pool.stats().as_dict()
        return finished

    # -- speculative decoding ------------------------------------------
    def _collect_specs(self, active: List[int]
                       ) -> List[Tuple[int, Request, dict]]:
        """Claim this step's speculating slots (removed from ``active``):
        greedy requests (interactive ones only with draft_interactive)
        with at least two tokens of budget left whose round gets its
        scratch pages; under pool pressure a slot decodes normally."""
        if self._draft is None:
            return []
        C, L = self.cache_len, self.pool.page_len
        k = self.draft_k
        specs = []
        for i in list(active):
            req = self.slot_req[i]
            if req.temperature > 0:
                continue
            if req.slo == "interactive" and not self.draft_interactive:
                continue
            if req.max_new_tokens - len(req.out_tokens) < 2:
                continue
            P = int(self.pos[i])
            js = sorted({((P + t) % C) // L for t in range(k + 1)})
            got = self.pool.begin_scratch(req.rid, js)
            if got is None:
                self.stats["spec_fallbacks"] += 1
                continue
            specs.append((i, req, got))
            active.remove(i)
        return specs

    def _run_spec_round(self, specs: List[Tuple[int, Request, dict]]
                        ) -> List[Request]:
        """Draft-k / verify-1 over the claimed slots, batched.

        The drafter decodes k steps through block tables whose
        write-range pages are the round's scratch pages (it reads the
        real prefix; its K/V lands on scratch only). One target pass
        over [x0, d1..dk] against the real pages then overwrites the
        drafter's entries on the scratch pages with target K/V. With a
        the longest prefix of drafts equal to the target's predictions,
        t_pred[0..a] are emitted (a+1 target argmaxes); scratch pages
        inside the accepted range are promoted, the boundary page
        merges the accepted entries, the rest are discarded. If a merge
        finds no room, the slot falls back to an exact re-prefill
        resume."""
        k = self.draft_k
        C, L, NB = self.cache_len, self.pool.page_len, self.pool.NB
        B = self.B
        finished: List[Request] = []
        t_round = self._trace.t0()
        emitted = 0
        try:
            slot_rids: List[Optional[int]] = [None] * B
            for i, req, _ in specs:
                slot_rids[i] = req.rid
            dbt = self.pool.block_table(slot_rids)
            for i, req, got in specs:
                for j, s in got.items():
                    dbt[i, j] = s
            cur = np.zeros((B, 1), np.int32)
            act = np.zeros((B,), bool)
            for i, req, _ in specs:
                cur[i, 0] = req.out_tokens[-1]
                act[i] = True
            dtabs = self._block_tables(dbt)     # once for the k steps
            pos_d = self.pos.astype(np.int32).copy()
            drafts = np.zeros((k, B), np.int32)
            for t in range(k):
                nxt = self._draft_decode(self._t(cur), self._t(pos_d),
                                         dtabs)
                drafts[t] = np.where(act, nxt.cpu().numpy(), 0)
                cur = drafts[t].reshape(B, 1)
                pos_d += 1
            toks = np.zeros((B, k + 1), np.int32)
            poss = np.full((B, k + 1), -1, np.int32)
            verify_bt = np.full((B, NB), kvmem.ZERO_PAGE, np.int32)
            dests = np.full((B, NB), kvmem.TRASH_PAGE, np.int32)
            for i, req, got in specs:
                P = int(self.pos[i])
                toks[i, 0] = req.out_tokens[-1]
                toks[i, 1:] = drafts[:, i]
                poss[i] = np.arange(P, P + k + 1)
                for j, p in enumerate(self.pool.dev_pages(req.rid)):
                    if p is not None:
                        verify_bt[i, j] = p
                for j, s in got.items():
                    dests[i, j] = s
            pred = self._paged_spec_verify(
                self._t(toks), self._t(poss), verify_bt, dests)
            # (B, k+1); every row's in every process
            drafts, pred = self._share_round(drafts,
                                             pred.cpu().numpy())
            for i, req, got in specs:
                P = int(self.pos[i])
                a = 0
                while a < k and drafts[a, i] == pred[i, a]:
                    a += 1
                self.stats["spec_rounds"] += 1
                self.stats["spec_draft_tokens"] += k
                self.stats["spec_accepted_tokens"] += a
                self.telemetry.note_spec_round(a, k)
                done = False
                for t in range(a + 1):
                    tok = int(pred[i, t])
                    self._emit(req, tok)
                    self.stats["generated_tokens"] += 1
                    emitted += 1
                    if ((req.eos_id is not None and tok == req.eos_id)
                            or len(req.out_tokens) >= req.max_new_tokens):
                        done = True
                        break
                if done:
                    self.pool.discard_scratch(req.rid)
                    req.done = True
                    req.status = "done"
                    req.t_done = time.monotonic()
                    self.pool.free(req.rid)
                    finished.append(req)
                    self.slot_req[i] = None
                    continue
                # keep K/V for positions P..P+a: a real page never holds
                # entries past the slot's last written position
                hi = P + a
                ok = True
                for j in sorted(got):
                    wj = [p for p in range(P, P + k + 1)
                          if (p % C) // L == j]
                    kj = [p for p in wj if p <= hi]
                    if not kj:
                        continue
                    if len(kj) == len(wj):
                        self.pool.promote_scratch(req.rid, j)
                    else:
                        if not self.pool.ensure_writable(req.rid, j):
                            ok = False
                            break
                        dst = self.pool.dev_pages(req.rid)[j]
                        self.pool.merge_scratch_slots(got[j], dst, P, hi)
                self.pool.discard_scratch(req.rid)
                if not ok:
                    self.stats["spec_fallbacks"] += 1
                    self.queue.insert(
                        0, self.preempt_slot(i, keep_kv=False))
                    continue
                self.pos[i] = P + a + 1
        finally:
            # a raise mid-round must not leak scratch pages
            for _, req, _ in specs:
                self.pool.discard_scratch(req.rid)
        if emitted:
            self.telemetry.note_tokens("draft", emitted)
        self._trace.complete("spec_round", t_round, tid=self.rank,
                             slots=len(specs), emitted=emitted)
        return finished

    # -- failure containment and cancellation --------------------------
    def _release_slot(self, slot: int) -> Request:
        """Detach the request in ``slot`` (pages freed, slot free)
        without deciding its fate: the caller fails, requeues or cancels
        it."""
        req = self.slot_req[slot]
        assert req is not None, f"releasing free slot {slot}"
        if self.pool is not None and self.pool.has_pages(req.rid):
            self.pool.free(req.rid)
        self.slot_req[slot] = None
        return req

    def evacuate_inflight(self) -> List[Request]:
        """Pull every slot-occupying request off this engine with its
        emitted tokens armed for an exact re-prefill resume elsewhere
        (:meth:`Request.mark_resumable`); the scheduler's requeue-on-
        failure path re-routes them to live ranks."""
        evacuated = []
        for i, req in enumerate(self.slot_req):
            if req is None:
                continue
            self._release_slot(i)
            req.mark_resumable()
            evacuated.append(req)
        return evacuated

    def fail_inflight(self, err) -> List[Request]:
        """Mark every slot-occupying request failed and free its slot
        (the scheduler's containment when requeueing is off); queued
        requests are left to the caller to re-route."""
        failed = []
        now = time.monotonic()
        for i, req in enumerate(self.slot_req):
            if req is None:
                continue
            self._release_slot(i)
            req.status = "failed"
            req.error = f"{type(err).__name__}: {err}"
            req.t_done = now
            self.stats["failed"] += 1
            failed.append(req)
        return failed

    def cancel(self, rid: int) -> Optional[Request]:
        """Remove a request wherever it is (queued or decoding), with its
        pages and any KV snapshot. Returns it (status untouched), or None
        if ``rid`` is not here."""
        for i, req in enumerate(self.queue):
            if req.rid == rid:
                self.queue.pop(i)
                if self.pool is not None and self.pool.has_pages(rid):
                    self.pool.free(rid)
                req._kv = None
                self.stats["cancelled"] += 1
                return req
        for i, req in enumerate(self.slot_req):
            if req is not None and req.rid == rid:
                self._release_slot(i)
                req._kv = None
                self.stats["cancelled"] += 1
                return req
        return None

    def run(self, requests: List[Request],
            on_token: Optional[Callable[[Request, int], None]] = None
            ) -> List[Request]:
        prev = self.on_token
        if on_token is not None:
            self.on_token = on_token
        try:
            for r in requests:
                self.submit(r)
            done: List[Request] = []
            while len(done) < len(requests):
                done.extend(self.step())
            return done
        finally:
            self.on_token = prev

    def stream(self, requests: List[Request]
               ) -> Iterator[Tuple[int, int]]:
        """Yield ``(rid, token)`` in sampling order as steps retire."""
        buf: List[Tuple[int, int]] = []
        prev = self.on_token
        self.on_token = lambda req, tok: buf.append((req.rid, tok))
        try:
            for r in requests:
                self.submit(r)
            ndone = 0
            while ndone < len(requests):
                ndone += len(self.step())
                while buf:
                    yield buf.pop(0)
        finally:
            self.on_token = prev
