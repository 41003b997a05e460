"""Paged KV-cache memory of the port (``repro.serve.memory``).

A shared device page pool plus per-slot block tables replaces the
per-slot contiguous ring. The page length is a multiple of the SASP
pruning tile (the systolic-array tile), so paging granularity composes
with the packed kernels' tiling.

Layout. One page holds ``page_len`` consecutive ring positions of every
attention layer at once: pool leaves are ``(R, P, page_len, …)``, built
by ``models.lm.init_caches(..., uniform_cap=True)``. A slot's ring of
``cache_len = NB · page_len`` tokens is the gather of its NB pages
through a block table, the same tensor as the contiguous ring, so the
prefill / decode math runs unchanged. Two pages are reserved:
``ZERO_PAGE`` (zeros, pos = -1: read by unallocated logical pages, never
written) and ``TRASH_PAGE`` (written by idle rows and group padding,
never read by a live slot).

On a mesh the pool is built on a rank's local config, so its pages hold
that rank's KV heads; every allocator decision is host-side and reads no
device value, so it is the same on every rank. Where the reference's
rule cuts the page axis over 'data' (``distribution.sharding.
pool_axes``) the pool falls into one block a data rank, each with an
allocator of its own (:class:`PagedKVPool`, ``blocks``).

Policy. Pages are allocated at admission (the prompt's pages) and one at
a time as decode crosses a page boundary, and freed at EOS. A
high-watermark cap bounds the resident pages; room is made by evicting
cached prefix pages, then spilling cold (preempted) requests' private
pages to a host pool, then dropping preempted requests to re-prefill.
With ``share=True`` full prompt pages are registered in a radix index
keyed by their exact token bytes, refcounted, and copy-on-written before
a decode write (a page is written only while rc == 1 and unregistered).

:class:`PageAllocator` is the host-side state machine (a copy of the
reference's, with its ``check()``); it returns moves, and
:class:`PagedKVPool` owns the tensors and executes them.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import MIXER_ATTN, ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import lm
from repro_torch.serve.telemetry import SpanTracer, Telemetry

ZERO_PAGE = 0
TRASH_PAGE = 1
RESERVED_PAGES = 2


def systolic_tile(cfg: ModelConfig) -> int:
    """The tile the page size must align to: the SASP pruning block
    (paper: the systolic-array dimension) when SASP is deployed, else 1
    (no tiling constraint to compose with)."""
    if cfg.sasp.enabled:
        return max(int(cfg.sasp.block_k), int(cfg.sasp.block_n))
    return 1


def tile_aligned_page_len(cfg: ModelConfig, cache_len: int,
                          page_len: Optional[int] = None) -> int:
    """Resolve the page length in tokens: a multiple of the systolic
    tile that divides ``cache_len`` (so NB = cache_len / page_len is
    whole and paging granularity composes with the packed-kernel
    tiling). Default: one tile when SASP is deployed (clamped to the
    cache), else cache_len / 8-ish."""
    tile = systolic_tile(cfg)
    if page_len is None:
        page_len = min(tile, cache_len) if cfg.sasp.enabled \
            else max(1, cache_len // 8)
        # grow to the nearest divisor of cache_len (tile already divides
        # cache_len or we fail below with the explicit-arg message)
        while cache_len % page_len:
            page_len += 1
    page_len = int(page_len)
    if page_len < 1 or page_len > cache_len:
        raise ValueError(
            f"kv page_len={page_len} must lie in [1, cache_len="
            f"{cache_len}]")
    if page_len % tile:
        raise ValueError(
            f"kv page_len={page_len} must be a multiple of the SASP "
            f"tile {tile} (block_k/block_n) so paging granularity "
            f"composes with the packed-kernel tiling")
    if cache_len % page_len:
        raise ValueError(
            f"cache_len={cache_len} must be a multiple of kv "
            f"page_len={page_len} (whole pages per ring)")
    return page_len


def block_ids(device_pages: int, blocks: int, b: int) -> range:
    """The usable global page ids of block ``b`` of a pool of
    ``device_pages`` + 2 pages cut into ``blocks``: block 0 gives up the
    zero and the trash page."""
    Pb = (int(device_pages) + RESERVED_PAGES) // blocks
    return range(max(b * Pb, RESERVED_PAGES), (b + 1) * Pb)


def block_caps(device_pages: int, blocks: int,
               watermark: float = 1.0) -> List[int]:
    """Each block's watermark cap in pages (its usable pages times the
    watermark, at least 1): a block whose cap is under one slot's ring
    could never hold a slot's pages (``PageAllocator`` refuses it)."""
    return [max(1, int(math.floor(len(block_ids(device_pages, blocks, b))
                                  * watermark))) for b in range(blocks)]


@dataclass
class MemoryStats:
    """Per-pool accounting, surfaced through ``Engine.stats['memory']``."""
    device_pages: int        # allocatable device pages (excl. reserved)
    host_pages: int          # host-RAM spill pool capacity
    watermark: int           # resident-page cap (high-watermark policy)
    device_used: int
    host_used: int
    preempted_resident: int  # device pages pinned by preempted requests
    spills: int              # pages spilled device -> host (cumulative)
    faults: int              # pages faulted host -> device (cumulative)
    drops: int               # preempted requests dropped to re-prefill
    # prefix sharing (DESIGN.md §16) — all zero when share is off
    shared_pages: int = 0    # physical pages with refcount > 1
    cached_pages: int = 0    # rc == 0 pages retained in the radix index
    prefix_hits: int = 0     # admissions that matched >= 1 prefix page
    prefix_pages_reused: int = 0  # pages mapped instead of allocated
    cow_copies: int = 0      # shared pages copied before a write
    cache_evictions: int = 0  # cached pages reclaimed by room-making
    # speculative decoding (DESIGN.md §17) / cross-request dedup
    scratch_pages: int = 0   # pages held by in-flight draft rounds
    dedup_merges: int = 0    # resident duplicate pages re-linked
    # a pool cut over 'data' (PagedKVPool, blocks > 1)
    blocks: int = 1          # blocks of the page pool, one a data rank
    prefix_pages_elsewhere: int = 0  # prefix pages only another block held
    moved_pages: int = 0     # pages moved to another block on resume

    @property
    def device_free(self) -> int:
        return self.device_pages - self.device_used

    @property
    def residency(self) -> float:
        """Fraction of the device pool resident."""
        return self.device_used / max(1, self.device_pages)

    def as_dict(self) -> Dict:
        import dataclasses
        return dict(dataclasses.asdict(self),
                    device_free=self.device_free,
                    residency=round(self.residency, 4))


# page-table entries: ("dev", page_id) | ("host", host_slot) | None
_Move = Tuple  # ("spill", rid, j, dev, host) | ("fault", rid, j, host, dev)


class _RadixNode:
    """One full page of prompt tokens in the prefix index. Children are
    keyed by the NEXT page's exact token bytes; depth pins the absolute
    position range, so equal keys at equal depth == equal whole prefix.
    ``page`` is the resident device page holding this node's KV (None =
    evicted hole; a prefix walk stops there — descendants are
    unreachable until re-registered, which keeps matches contiguous)."""

    __slots__ = ("children", "page")

    def __init__(self):
        self.children: Dict[bytes, "_RadixNode"] = {}
        self.page: Optional[int] = None


class PageAllocator:
    """Host-side page bookkeeping — no tensors.

    Tracks per-request page tables, the device/host free lists, the
    resident/preempted split, per-page refcounts + the radix prefix
    index (``share=True``), and the high-watermark cap. Mutating ops
    return the ordered data-movement *moves* the pool must execute (or
    None when the operation cannot be satisfied). Invariants (checked
    by :meth:`check`, held move for move against the reference's allocator in
    tests/test_torch_memory.py):

    * every device page is free, cached (rc 0 + registered), or owned;
    * refcount of an owned page == its block-table reference count;
    * every host slot is free or owned by exactly one request;
    * non-free device pages never exceed the watermark cap;
    * a request is resident XOR preempted; resident requests hold no
      host (spilled) pages;
    * spilled (host) pages are never shared and never registered.
    """

    def __init__(self, device_ids: Sequence[int], host_slots: int,
                 watermark_cap: int, slot_pages: int,
                 share: bool = False):
        self._all_dev = sorted(int(p) for p in device_ids)
        self.free_dev: List[int] = list(self._all_dev)
        self.n_device = len(self.free_dev)
        self.cap = int(watermark_cap)
        self.NB = int(slot_pages)          # logical pages per slot
        if self.cap < self.NB:
            raise ValueError(
                f"watermark cap {self.cap} pages < one slot's ring "
                f"({self.NB} pages): a single slot could never be "
                f"fully resident — raise kv_pages / kv_watermark")
        self.free_host: List[int] = list(range(int(host_slots)))
        self.n_host = int(host_slots)
        self.tables: Dict[int, List[Optional[Tuple]]] = {}
        self.resident: set = set()
        self.preempted: List[int] = []     # oldest (coldest) first
        self.spills = 0
        self.faults = 0
        self.drops = 0
        # prefix sharing (DESIGN.md §16). rc is maintained even with
        # share off (every owned page at rc 1) so the invariants and
        # the property-test machine are uniform across modes.
        self.share = bool(share)
        self.rc: Dict[int, int] = {}       # owned page -> #table refs
        self.cached: List[int] = []        # rc-0 registered pages, LRU
        self._radix = _RadixNode()         # root (empty prefix)
        self._node_of: Dict[int, _RadixNode] = {}  # page -> its node
        self.prefix_hits = 0
        self.prefix_pages_reused = 0
        self.cow = 0
        self.evictions = 0
        # speculative-decode scratch (DESIGN.md §17): rid -> {logical
        # page j -> physical page} for an IN-FLIGHT verify round. A
        # scratch page sits outside the free list and every block
        # table: no refcount, never registered, invisible to
        # room-making — promote_scratch/discard_scratch resolve it.
        self.scratch: Dict[int, Dict[int, int]] = {}
        # per-request page content keys (the prompt's full-page token
        # bytes), kept while the page is still byte-identical to what
        # was prefilled — the cross-request dedup sweep's evidence. A
        # write (COW/unregister path) invalidates the page's key.
        self._keys: Dict[int, List[Optional[bytes]]] = {}
        self.dedup_merges = 0

    # -- views ---------------------------------------------------------
    @property
    def used_dev(self) -> int:
        return self.n_device - len(self.free_dev)

    @property
    def used_host(self) -> int:
        return self.n_host - len(self.free_host)

    def has(self, rid: int) -> bool:
        return rid in self.tables

    def dev_pages(self, rid: int) -> List[Optional[int]]:
        """Per-logical-page device ids (None = unallocated). Only valid
        for resident requests (no host entries)."""
        out = []
        for e in self.tables[rid]:
            assert e is None or e[0] == "dev", (rid, e)
            out.append(None if e is None else e[1])
        return out

    def preempted_dev_pages(self) -> int:
        """Distinct physical device pages held by preempted requests
        (a page shared across requests counts once)."""
        return len({e[1] for rid in self.preempted
                    for e in self.tables[rid] if e and e[0] == "dev"})

    def _room(self) -> int:
        """Device pages allocatable right now without spilling."""
        return min(len(self.free_dev), self.cap - self.used_dev)

    def reclaimable_pages(self) -> int:
        """Device pages room-making could release: the cached prefix
        pages (rc 0, regenerable) plus cold (preempted) pages not
        co-owned by a resident request — each physical page counted
        once (the *effective* headroom view: shared residency is paid
        for once, so it is only reclaimable once)."""
        resident_held = {e[1] for rid in self.resident
                         for e in self.tables[rid] if e and e[0] == "dev"}
        cold = {e[1] for rid in self.preempted
                for e in self.tables[rid] if e and e[0] == "dev"}
        return len(self.cached) + len(cold - resident_held)

    def headroom(self) -> int:
        """Device pages allocatable after evicting the prefix cache and
        spilling/dropping every cold (preempted) page — the
        admission-control view of the pool."""
        return self._room() + self.reclaimable_pages()

    def admissible_requests(self, pages_per_req: int = 2) -> int:
        """Rough admission headroom in requests (prompt page + growth
        page); the scheduler consults this instead of raw slot count."""
        return self.headroom() // max(1, pages_per_req)

    # -- refcount / radix internals ------------------------------------
    def _ref(self, p: int):
        """Add a table reference to page ``p`` (promoting a cached page
        back to owned)."""
        if p in self.cached:
            self.cached.remove(p)
            self.rc[p] = 1
        else:
            self.rc[p] = self.rc.get(p, 0) + 1

    def _unref(self, p: int):
        """Drop one table reference: the last one demotes the page to
        cached (still matchable) when registered, else frees it."""
        self.rc[p] -= 1
        if self.rc[p] == 0:
            del self.rc[p]
            if p in self._node_of:
                self.cached.append(p)      # newest -> LRU tail
            else:
                self.free_dev.append(p)

    def _unregister(self, p: int):
        """Detach an OWNED page from the prefix index (write path /
        spill path). The trie node stays as a hole so deeper matches
        stop there."""
        node = self._node_of.pop(p, None)
        if node is not None:
            node.page = None

    def _evict_cached_lru(self):
        p = self.cached.pop(0)
        node = self._node_of.pop(p)
        node.page = None
        self.free_dev.append(p)
        self.evictions += 1

    def match_prefix(self, keys: Sequence[bytes]) -> List[int]:
        """Longest resident prefix of ``keys`` in the radix index —
        the device pages a new prompt can map instead of prefilling.
        Read-only (no refs taken)."""
        out: List[int] = []
        node = self._radix
        for key in keys:
            node = node.children.get(key)
            if node is None or node.page is None:
                break
            out.append(node.page)
        return out

    def register_prefix(self, rid: int, keys: Sequence[bytes]):
        """Publish ``rid``'s first ``len(keys)`` pages (all freshly
        prefilled or matched FULL pages) into the prefix index. First
        registration wins per node; pages spilled, COW'd or unwritable
        at that depth are skipped without disturbing the walk."""
        if not self.share:
            return
        # remember the content keys: pages stay byte-identical to what
        # was prefilled until a write invalidates them (make_writable /
        # promote_scratch), which is the dedup sweep's evidence
        self._keys[rid] = list(keys)
        node = self._radix
        for j, key in enumerate(keys):
            e = self.tables[rid][j]
            if e is None or e[0] != "dev":
                break                       # spilled mid-prefix: stop
            node = node.children.setdefault(key, _RadixNode())
            if node.page is None and e[1] not in self._node_of:
                node.page = e[1]
                self._node_of[e[1]] = node

    def _stale_key(self, rid: int, j: int):
        """A write is about to land on logical page ``j``: its content
        no longer matches the prefilled prompt bytes, so it must stop
        participating in dedup matching."""
        ks = self._keys.get(rid)
        if ks and j < len(ks):
            ks[j] = None

    # -- room making (evict-cached, spill-private, then-drop policy) ---
    def _spill_victim(self, protect) -> Optional[int]:
        """Oldest preempted request with a *private* (rc == 1) device
        page — shared pages never spill (a co-owner may be resident
        and mid-decode on them)."""
        for rid in self.preempted:          # oldest preempt first
            if rid == protect:
                continue
            if any(e and e[0] == "dev" and self.rc[e[1]] == 1
                   for e in self.tables[rid]):
                return rid
        return None

    def _drop(self, rid: int):
        """Release ALL of a preempted request's pages (device + host):
        it will resume by re-prefill instead of page fault. Shared
        device pages survive with their other owners; this request's
        refs are simply dropped."""
        for e in self.tables.pop(rid):
            if e is None:
                continue
            if e[0] == "dev":
                self._unref(e[1])
            else:
                self.free_host.append(e[1])
        self.free_dev.extend(self.scratch.pop(rid, {}).values())
        self._keys.pop(rid, None)
        self.preempted.remove(rid)
        self.drops += 1

    def _make_room(self, n: int, moves: List[_Move],
                   protect=None) -> bool:
        """Free device pages until ``n`` are allocatable, cheapest
        reclamation first: (1) evict cached prefix pages (rc 0 — their
        KV regenerates from a prefill, nothing to move); (2) spill cold
        *private* pages (preempted requests, oldest first) to host;
        (3) drop whole preempted requests to re-prefill once the host
        pool is full — or when all their device pages are shared
        (unspillable), since dropping releases the refs and any page
        that reaches rc 0 turns cached and is evicted by (1). False =
        nothing cold left to reclaim."""
        while self._room() < n:
            if self.cached:
                self._evict_cached_lru()
                continue
            victim = self._spill_victim(protect)
            if victim is not None:
                refs = self.tables[victim]
                if self.free_host:
                    j = max(j for j, e in enumerate(refs)
                            if e and e[0] == "dev"
                            and self.rc[e[1]] == 1)
                    dev = refs[j][1]
                    self._unregister(dev)   # host copies never match
                    host = self.free_host.pop()
                    moves.append(("spill", victim, j, dev, host))
                    refs[j] = ("host", host)
                    del self.rc[dev]
                    self.free_dev.append(dev)
                    self.spills += 1
                else:
                    self._drop(victim)
                continue
            # no privately-spillable page anywhere: drop the oldest
            # cold request whose device pages are all SHARED (its refs
            # may cascade pages into the cache, which the next
            # iteration evicts). Host-only holders are left alone —
            # dropping them gains no device room.
            drop = next(
                (r for r in self.preempted if r != protect
                 and any(e and e[0] == "dev" for e in self.tables[r])),
                None)
            if drop is None:
                return False
            self._drop(drop)
        return True

    # -- lifecycle ops -------------------------------------------------
    #
    # Every op returns (ok, moves). The moves list MUST be executed by
    # the caller even when ok is False: _make_room commits spills to
    # the bookkeeping as it goes, so a failed allocation may still have
    # moved cold pages to "host" state — dropping those moves would
    # leave the host pool without the data and a later resume would
    # fault back zeros (silent KV corruption). Spilling cold pages is
    # never wrong, so partial room-making simply stands.

    def admit(self, rid: int, n: int) -> Tuple[bool, List[_Move]]:
        """Allocate the first ``n`` logical pages for a new (or
        re-prefilling) request. not ok = pool exhausted (caller
        defers; any partial spill moves still execute)."""
        ok, moves, _ = self.admit_prefix(rid, n, ())
        return ok, moves

    def admit_prefix(self, rid: int, n: int,
                     keys: Sequence[bytes] = (), min_pages: int = 1
                     ) -> Tuple[bool, List[_Move], int]:
        """Admission with prefix matching: walk ``keys`` (one exact
        token-bytes key per FULL prompt page) down the radix index and
        map every hit (refcount++, cached pages promoted) instead of
        allocating; pages [len(hit)..n) are allocated fresh. Returns
        (ok, moves, matched_pages) — the engine skips ``matched ·
        page_len`` prefill tokens. Matches shorter than ``min_pages``
        are ignored (not worth splitting the prefill batch for). A
        failed admission unwinds the matched refs exactly (no leaks;
        partial spill moves still execute)."""
        assert rid not in self.tables, f"rid {rid} already has pages"
        assert 1 <= n <= self.NB, (rid, n)
        matched: List[int] = []
        if self.share and keys:
            matched = self.match_prefix(keys[:n])
            if len(matched) < max(1, int(min_pages)):
                matched = []
        # take the refs BEFORE room-making: a matched cached page
        # leaves the eviction pool the moment this prompt claims it
        for p in matched:
            self._ref(p)
        m = len(matched)
        moves: List[_Move] = []
        if not self._make_room(n - m, moves):
            for p in matched:               # unwind: no leaked refs
                self._unref(p)
            return False, moves, 0
        refs: List[Optional[Tuple]] = [None] * self.NB
        for j, p in enumerate(matched):
            refs[j] = ("dev", p)
        for j in range(m, n):
            p = self.free_dev.pop()
            refs[j] = ("dev", p)
            self.rc[p] = 1
        self.tables[rid] = refs
        self.resident.add(rid)
        if m:
            self.prefix_hits += 1
            self.prefix_pages_reused += m
        return True, moves, m

    def ensure(self, rid: int, j: int) -> Tuple[bool, List[_Move]]:
        """Decode growth: allocate logical page ``j`` if absent. not
        ok = no room (caller preempts the slot)."""
        refs = self.tables[rid]
        assert rid in self.resident, f"growing non-resident rid {rid}"
        if refs[j] is not None:
            assert refs[j][0] == "dev", (rid, j, refs[j])
            return True, []
        moves: List[_Move] = []
        if not self._make_room(1, moves, protect=rid):
            return False, moves
        p = self.free_dev.pop()
        refs[j] = ("dev", p)
        self.rc[p] = 1
        return True, moves

    def make_writable(self, rid: int, j: int
                      ) -> Tuple[bool, List[_Move],
                                 Optional[Tuple[int, int]]]:
        """Enforce the write rule on logical page ``j`` before a decode
        scatter: a page may only be written while rc == 1 AND
        unregistered. Shared (rc > 1) pages copy-on-write to a fresh
        page — returns ``(src, dst)`` for the pool's device copy;
        private registered pages just unregister (the write would
        invalidate the indexed content). not ok = COW needed but no
        room (caller preempts the slot; moves still execute)."""
        refs = self.tables[rid]
        e = refs[j]
        assert e is not None and e[0] == "dev", (rid, j, e)
        p = e[1]
        self._stale_key(rid, j)
        if self.rc[p] == 1:
            self._unregister(p)
            return True, [], None
        moves: List[_Move] = []
        if not self._make_room(1, moves, protect=rid):
            return False, moves, None
        q = self.free_dev.pop()
        self.rc[q] = 1
        refs[j] = ("dev", q)
        self._unref(p)
        self.cow += 1
        return True, moves, (p, q)

    def free(self, rid: int):
        """EOS / failure: drop every table reference. Private device
        pages return to the free list — unless registered in the
        prefix index, in which case they turn *cached* (rc 0, still
        matchable, evicted LRU under pressure); shared pages live on
        with their co-owners."""
        assert rid in self.tables, f"double free of rid {rid}"
        self.resident.discard(rid)
        if rid in self.preempted:
            self.preempted.remove(rid)
        for e in self.tables.pop(rid):
            if e is None:
                continue
            if e[0] == "dev":
                self._unref(e[1])
            else:
                self.free_host.append(e[1])
        # a request can die mid-draft-round (engine containment):
        # defensively reclaim any scratch it still holds
        self.free_dev.extend(self.scratch.pop(rid, {}).values())
        self._keys.pop(rid, None)

    def preempt(self, rid: int):
        """Unmap from its slot: pages stay allocated but become cold
        (spillable). No data moves — this is the paged replacement for
        the KV-snapshot copy."""
        assert rid not in self.scratch, \
            f"rid {rid} preempted mid-draft-round (scratch leak)"
        self.resident.remove(rid)
        self.preempted.append(rid)

    def mark_preempted(self, rid: int):
        """Idempotent preempt (admission-failure unwind path)."""
        if rid in self.resident:
            self.preempt(rid)

    def adopt(self, rid: int, js: Sequence[int]
              ) -> Tuple[bool, List[_Move], Dict[int, int]]:
        """Fresh private pages at logical pages ``js`` for a request
        moving in from another block of a cut pool (its kept KV is
        copied onto them), resident at once. Returns (ok, moves, {j:
        page}); not ok = no room (partial spill moves still execute)."""
        assert rid not in self.tables, f"rid {rid} already has pages"
        moves: List[_Move] = []
        if not self._make_room(len(js), moves):
            return False, moves, {}
        refs: List[Optional[Tuple]] = [None] * self.NB
        got = {}
        for j in js:
            p = self.free_dev.pop()
            refs[j] = ("dev", p)
            self.rc[p] = 1
            got[int(j)] = p
        self.tables[rid] = refs
        self.resident.add(rid)
        return True, moves, got

    def resume(self, rid: int) -> Tuple[bool, List[_Move]]:
        """Fault a preempted request's spilled pages back and pin it
        resident. not ok = no room yet (caller retries later) — the
        request keeps its preempted position, partial spill moves of
        OTHER requests still execute. Callers must check :meth:`has`
        first (dropped requests re-prefill)."""
        refs = self.tables[rid]
        need = sum(1 for e in refs if e and e[0] == "host")
        moves: List[_Move] = []
        if not self._make_room(need, moves, protect=rid):
            return False, moves
        for j, e in enumerate(refs):
            if e and e[0] == "host":
                dev = self.free_dev.pop()
                moves.append(("fault", rid, j, e[1], dev))
                self.free_host.append(e[1])
                refs[j] = ("dev", dev)
                self.rc[dev] = 1
                self.faults += 1
        self.preempted.remove(rid)
        self.resident.add(rid)
        return True, moves

    # -- speculative-decode scratch (DESIGN.md §17) --------------------
    def alloc_scratch(self, rid: int, js: Sequence[int]
                      ) -> Tuple[bool, List[_Move], Dict[int, int]]:
        """Reserve one scratch page per logical page in ``js`` for a
        draft/verify round. Scratch pages leave the free list (they
        count toward the watermark) but take NO table reference: they
        are invisible to sharing, spill and room-making until the
        round resolves them via promote/discard. not ok = pool
        pressure — the caller decodes this slot non-speculatively this
        step (partial spill moves still execute)."""
        assert rid in self.resident, f"scratch for non-resident {rid}"
        assert rid not in self.scratch, f"rid {rid} already drafting"
        moves: List[_Move] = []
        if not self._make_room(len(js), moves, protect=rid):
            return False, moves, {}
        got = {int(j): self.free_dev.pop() for j in js}
        self.scratch[rid] = got
        return True, moves, dict(got)

    def promote_scratch(self, rid: int, j: int) -> int:
        """Accept a FULLY-verified scratch page: swap it into the block
        table at logical page ``j`` (rc 1, unregistered) and drop the
        ref on the old page — co-owners keep it, a registered private
        page turns cached. Pure bookkeeping: rollback-by-unmap, never
        a copy. Returns the promoted physical page."""
        s = self.scratch[rid].pop(j)
        refs = self.tables[rid]
        old = refs[j]
        refs[j] = ("dev", s)
        self.rc[s] = 1
        self._stale_key(rid, j)   # speculated content != prompt bytes
        if old is not None:
            assert old[0] == "dev", (rid, j, old)
            self._unref(old[1])
        if not self.scratch[rid]:
            del self.scratch[rid]
        return s

    def discard_scratch(self, rid: int):
        """Reject (or finish) a draft round: every scratch page still
        held returns to the free list. Idempotent."""
        self.free_dev.extend(self.scratch.pop(rid, {}).values())

    # -- cross-request dedup sweep -------------------------------------
    def dedup_sweep(self) -> int:
        """Re-link identical ALREADY-RESIDENT pages: requests admitted
        before the radix index knew their content (e.g. simultaneous
        same-prompt admissions in one bucket group, or pages whose
        canonical twin was registered later) hold private duplicates.
        Walk each resident request's stored content keys down the trie;
        where the canonical page differs from ours, move our table ref
        onto the canonical page and drop ours (freed, or kept by
        co-owners). Holes met on the way are repaired by publishing our
        page. Exactness: both pages hold KV from a deterministic
        prefill of the same tokens at the same absolute positions —
        the same argument admission-time prefix sharing rests on
        (DESIGN.md §16). Returns pages merged; no data moves."""
        if not self.share:
            return 0
        merged = 0
        for rid in sorted(self.resident):
            keys = self._keys.get(rid)
            if not keys or rid in self.scratch:
                continue
            refs = self.tables[rid]
            node = self._radix
            for j, key in enumerate(keys):
                if key is None:
                    break      # written since prefill: content unknown
                node = node.children.get(key)
                if node is None:
                    break
                e = refs[j]
                if e is None or e[0] != "dev":
                    break
                p = e[1]
                if node.page is None:
                    if p not in self._node_of:
                        node.page = p       # repair the eviction hole
                        self._node_of[p] = node
                    continue
                q = node.page
                if q == p or p in self._node_of:
                    continue
                self._ref(q)
                refs[j] = ("dev", q)
                self._unref(p)
                merged += 1
        self.dedup_merges += merged
        return merged

    # -- invariants ----------------------------------------------------
    def check(self):
        ref_count: Dict[int, int] = {}
        owned_host = []
        for rid, refs in self.tables.items():
            for e in refs:
                if e is None:
                    continue
                if e[0] == "dev":
                    ref_count[e[1]] = ref_count.get(e[1], 0) + 1
                else:
                    owned_host.append(e[1])
        assert ref_count == self.rc, \
            (f"refcount != block-table references: rc={self.rc} "
             f"vs tables={ref_count}")
        owned_dev = sorted(ref_count)
        scratch_pages = [p for d in self.scratch.values()
                         for p in d.values()]
        assert sorted(owned_dev + self.free_dev + self.cached
                      + scratch_pages) \
            == self._all_dev, "device pages leaked or double-owned"
        assert sorted(owned_host + self.free_host) == \
            list(range(self.n_host)), "host slots leaked or double-owned"
        assert len(set(owned_host)) == len(owned_host)
        assert self.used_dev <= self.cap, \
            f"watermark breached: {self.used_dev} > {self.cap}"
        assert set(self.preempted).isdisjoint(self.resident)
        assert set(self.tables) == self.resident | set(self.preempted)
        for rid in self.resident:
            assert all(e is None or e[0] == "dev"
                       for e in self.tables[rid]), \
                f"resident rid {rid} holds spilled pages"
        # prefix-index consistency: every cached page is registered;
        # every registered page is resident on device (owned or
        # cached) and its node points back at it; holes carry no page
        assert len(set(self.cached)) == len(self.cached)
        for p in self.cached:
            assert p in self._node_of, f"cached page {p} unregistered"
        for p, node in self._node_of.items():
            assert node.page == p, (p, node.page)
            assert p in self.rc or p in self.cached, \
                f"registered page {p} neither owned nor cached"
        # speculative scratch: only resident requests draft, scratch
        # pages carry no refcount and are never registered
        for rid, d in self.scratch.items():
            assert rid in self.resident, \
                f"scratch held by non-resident rid {rid}"
            for p in d.values():
                assert p not in self.rc and p not in self._node_of, \
                    f"scratch page {p} owned or registered"
        assert set(self._keys) <= set(self.tables), \
            "content keys for departed requests"
        if not self.share:
            assert not self._node_of and not self.cached
            assert all(c == 1 for c in self.rc.values())



# ---------------------------------------------------------------------------
# The pool: tensors and their movement on top of the allocator
# ---------------------------------------------------------------------------


def _caches(data):
    """(segment, slot name, KVCache) of a cache tree."""
    for si, seg in enumerate(data):
        for name in sorted(seg):
            yield si, name, seg[name]


def _rebuild(data, fn):
    """A new cache tree with ``fn(segment, name, cache)`` per cache."""
    return tuple({name: fn(si, name, c) for name, c in seg.items()}
                 for si, seg in enumerate(data))


def gather_block_tables(data, bt: torch.Tensor):
    """Pool tree + (B, NB) block table -> ring caches (R, B, C, …)."""
    return _rebuild(data, lambda si, n, c: attn_mod.cache_map(
        lambda a: attn_mod.gather_kv_pages(a, bt), c))


def scatter_written_pages(data, caches, bt: torch.Tensor,
                          pos: torch.Tensor, NB: int, L: int):
    """Write back, in place, the one page per slot a decode step touched
    (the page holding ring position ``pos % C``)."""
    pj = (pos.to(torch.int64) % (NB * L)) // L
    for si, name, c in _caches(data):
        new = caches[si][name]
        for a, v in zip(c, new):
            if a is not None:
                attn_mod.scatter_kv_written_page(a, v, bt, pj)


def scatter_prefill_pages(data, caches, dests: torch.Tensor):
    """Scatter prefill rings into the pool at ``dests`` (G, NB), in
    place (the trash page where unallocated or padding)."""
    for si, name, c in _caches(data):
        for a, v in zip(c, caches[si][name]):
            if a is not None:
                attn_mod.scatter_prefill_pages(a, v, dests)


def masked_scatter_pages(data, caches, dests: torch.Tensor):
    """Merge suffix rings (R, G, C, …), whose untouched slots hold
    pos = -1, into the pool at ``dests`` (G, NB): only the slots the
    suffix holds are written, every other slot keeps the pool's content
    (the speculative verify's scatter onto scratch pages seeded from the
    real pages). The destination pages are read first and written
    after; rows routed to the trash page may repeat it, and which of
    their writes lands there is unspecified, which is harmless since no
    live slot reads it."""
    G, NB = dests.shape
    idx = dests.reshape(-1).to(torch.int64)
    for si, name, c in _caches(data):
        new = caches[si][name]
        L = c.pos.shape[2]
        m = (new.pos >= 0).reshape(new.pos.shape[0], G * NB, L)
        for a, v in zip(c, new):
            if a is None:
                continue
            r = v.reshape((v.shape[0], G * NB, L) + tuple(v.shape[3:]))
            mm = m.reshape(tuple(m.shape) + (1,) * (a.ndim - 3))
            cur = a[:, idx]
            a[:, idx] = torch.where(mm, r.to(a.dtype), cur)


def merge_page_slots(data, src: int, dst: int, lo: int, hi: int):
    """Copy, in place, the ring slots of page ``src`` whose position lies
    in [lo, hi] onto page ``dst``, every layer at once (the boundary page
    of a partly accepted draft); dst's other slots stay."""
    for _, _, c in _caches(data):
        m = (c.pos[:, src] >= lo) & (c.pos[:, src] <= hi)       # (R, L)
        for a in c:
            if a is None:
                continue
            mm = m.reshape(tuple(m.shape) + (1,) * (a.ndim - 3))
            a[:, dst] = torch.where(mm, a[:, src], a[:, dst])


def cat_rows(trees):
    """Cache trees (R, b_g, C, …) -> one tree of their rows in order."""
    return _rebuild(trees[0], lambda si, n, c: type(c)(*(
        None if a is None else torch.cat([t[si][n][i] for t in trees], 1)
        for i, a in enumerate(c))))


def rows_of(data, lo: int, hi: int):
    """Rows [lo, hi) of a cache tree (views)."""
    return _rebuild(data, lambda si, n, c: attn_mod.cache_map(
        lambda a: a[:, lo:hi], c))


class PagedKVPool:
    """Shared device page pool + host spill pool for one Engine.

    ``block_data(b)`` is block ``b``'s cache tree (leaves (R, P, L, …),
    P = device_pages + 2 reserved for a whole pool, one block) on the
    engine's device; the engine reads and writes it through block
    tables. The host pool has the same structure on the CPU (pinned
    where the pool is on a card). Spills and faults copy synchronously,
    so a host page is never overwritten while a copy from or to it is
    still in flight. All policy lives in the embedded
    :class:`PageAllocator` of each block (``allocs``), reached through
    the pool's methods.

    Cut over 'data' (``blocks`` = D > 1: ``distribution.sharding.
    pool_axes`` cuts the page axis, and the engine's slots split over
    'data'). The P physical pages fall into D blocks of P / D, block d
    holding the global ids [d P/D, (d+1) P/D), and each block has an
    allocator of its own over its ids (``block_ids``, ``block_caps``):
    every request's pages come from the block of its slot's data rank
    (``admit_prefix(block=)``), and its growth, copies-on-write, scratch
    pages, spills and faults stay there, so the watermark, the headroom
    and room-making count per block. Block tables hold global ids; a
    block's tensors are indexed by ``local``. Reserved pages: block 0
    holds the zero and the trash page (global 0 and 1); every other
    block's tensors carry two local reserved pages of their own at local
    0 and 1, which ``ZERO_PAGE`` / ``TRASH_PAGE`` in a table mean there.
    So block 0 has P/D - 2 usable pages and its tensors P/D pages, every
    other block P/D usable pages and P/D + 2 in its tensors. This
    process holds the tensors of ``block`` (a mesh rank's data rank), or
    of every block (None: the meshless twin); the bookkeeping of every
    block is kept everywhere and reads no device value, so every process
    decides alike. The host pool is cut likewise (block d has
    ``host_pages // D`` slots, the first ``host_pages % D`` blocks one
    more), written only where its block's tensors live. Prefix sharing
    is per block: an admission maps only its block's pages; the pages
    that another block's index held beyond them are counted
    (``MemoryStats.prefix_pages_elsewhere``) and prefilled again, never
    copied. A preempted request that resumes in another block's slot
    moves its pages once (``resume(block=)``): read where they lie
    (device or host), broadcast over 'data' from their block's rank and
    written onto fresh pages of the new block (``moved_pages``)."""

    def __init__(self, params, cfg: ModelConfig, *, cache_len: int,
                 device_pages: int, page_len: Optional[int] = None,
                 watermark: float = 1.0, host_pages: int = 0,
                 share: bool = False, device=None,
                 telemetry: Optional[Telemetry] = None,
                 blocks: int = 1, block: Optional[int] = None, mesh=None):
        if any(m != MIXER_ATTN for m in cfg.layer_mixer_kinds()):
            raise ValueError(
                "paged KV requires an attention-only stack (SSM/hybrid "
                "recurrent state has no ring to page)")
        if device_pages < 1:
            raise ValueError(f"device_pages={device_pages} must be >= 1")
        if not 0.0 < watermark <= 1.0:
            raise ValueError(
                f"kv watermark={watermark} must lie in (0, 1]")
        if share and cfg.kv_quant:
            raise ValueError(
                "kv_share is incompatible with kv_quant: suffix prefill "
                "attends DEQUANTIZED int8 prefix KV, which breaks the "
                "bit-identity contract vs the solo/contiguous engine")
        self.telemetry = telemetry
        self._trace = (telemetry.tracer if telemetry is not None
                       else SpanTracer(enabled=False))
        self.cfg = cfg
        self.cache_len = int(cache_len)
        self.page_len = tile_aligned_page_len(cfg, cache_len, page_len)
        self.NB = self.cache_len // self.page_len
        self.n_device = int(device_pages)
        self.share = bool(share)
        P = self.n_device + RESERVED_PAGES
        if blocks < 1 or P % blocks or P // blocks <= RESERVED_PAGES:
            raise ValueError(f"a pool of {P} pages does not cut into "
                             f"{blocks} blocks of more than "
                             f"{RESERVED_PAGES} pages")
        self.blocks, self.mesh = int(blocks), mesh
        self.block_pages = Pb = P // self.blocks
        self.allocs = [PageAllocator(
            block_ids(self.n_device, self.blocks, b),
            host_pages // self.blocks + (b < host_pages % self.blocks), cap,
            self.NB, share=self.share) for b, cap in enumerate(
                block_caps(self.n_device, self.blocks, watermark))]
        self._of: Dict[int, int] = {}       # rid -> its block (cut pools)
        self.elsewhere = 0
        self.moved = 0
        self.held = (tuple(range(self.blocks)) if block is None
                     else (int(block),))
        self._data = {b: lm.init_caches(
            params, cfg, Pb + (RESERVED_PAGES if b else 0), self.page_len,
            device=device, uniform_cap=True) for b in self.held}
        self.device = self._data[self.held[0]][0]["slot0"].k.device
        pin = self.device.type == "cuda"
        self._hosts = {}
        for b in self.held:
            h = self.allocs[b].n_host
            if h > 0:
                self._hosts[b] = _rebuild(
                    self._data[b], lambda si, n, c: attn_mod.cache_map(
                        lambda a: torch.zeros(
                            (a.shape[0], h) + tuple(a.shape[2:]),
                            dtype=a.dtype, pin_memory=pin), c))

    # -- blocks ----------------------------------------------------------
    def block_data(self, b: int):
        """Block ``b``'s cache tree (held here)."""
        return self._data[b]

    def _blk(self, rid: int) -> int:
        return self._of.get(rid, 0)

    def _a(self, rid: int) -> PageAllocator:
        return self.allocs[self._blk(rid)]

    def local(self, ids, b: int) -> np.ndarray:
        """Global page ids (a table of them) as indices into block
        ``b``'s tensors: the reserved ids are the block's own."""
        ids = np.asarray(ids)
        lo = b * self.block_pages
        real = ids >= RESERVED_PAGES
        assert np.all(~real | ((ids >= lo) & (ids < lo + self.block_pages))
                      ), (b, ids)
        off = lo - (RESERVED_PAGES if b else 0)
        return np.where(real, ids - off, ids).astype(ids.dtype)

    def _ids(self, ids, b: int) -> torch.Tensor:
        return torch.as_tensor(self.local(np.asarray(ids, np.int64), b),
                               device=self.device)

    def _read(self, ids, b: int = 0):
        """Pages ``ids`` of every leaf of block ``b``: a tree of (R, n,
        L, …) tensors."""
        t = self._ids(ids, b)
        return _rebuild(self._data[b], lambda si, n, c:
                        attn_mod.cache_map(lambda a: a[:, t], c))

    def _write(self, ids, vals, b: int = 0):
        """Write a tree of (R, n, L, …) tensors onto pages ``ids`` of
        block ``b``."""
        t = self._ids(ids, b)
        for si, name, c in _caches(self._data[b]):
            for a, v in zip(c, vals[si][name]):
                if a is not None:
                    a[:, t] = v.to(device=a.device, dtype=a.dtype)

    def _scrub(self, ids, b: int = 0):
        """Reset recycled pages to the zero page (zeros, pos = -1): a
        decode-growth page gets one token written, and the rest of it
        must not carry the previous owner's positions."""
        if b not in self._data:
            return
        t = self._ids(ids, b)
        for _, _, c in _caches(self._data[b]):
            for a in c:
                if a is not None:
                    a[:, t] = a[:, ZERO_PAGE].clone()[:, None]

    def _copy(self, src: Sequence[int], dst: Sequence[int], b: int):
        """Pages ``src`` onto pages ``dst`` within block ``b``."""
        if src and b in self._data:
            self._write(dst, self._read(src, b), b)

    # -- sizing --------------------------------------------------------
    def pages_for(self, n_tokens: int) -> int:
        """Logical pages a prefill of ``n_tokens`` writes (the ring
        keeps at most cache_len of them)."""
        n = min(int(n_tokens), self.cache_len)
        return max(1, -(-n // self.page_len))

    def nbytes(self) -> int:
        """Bytes of the device tensors this process holds."""
        return sum(a.nbytes for d in self._data.values()
                   for _, _, c in _caches(d) for a in c if a is not None)

    # -- lifecycle (delegates to the allocator, executes moves) --------
    # the allocator's moves execute even when the op fails: partial
    # spills committed by its room-making must reach the host pool, or
    # a later resume would fault back never-written zeros

    def admit(self, rid: int, n_pages: int, block: int = 0) -> bool:
        return self.admit_prefix(rid, n_pages, block=block)[0]

    def admit_prefix(self, rid: int, n_pages: int,
                     keys: Sequence[bytes] = (), min_pages: int = 1,
                     block: int = 0) -> Tuple[bool, int]:
        """Sharing-aware admission into ``block``: (ok, matched pages);
        the engine prefills only the suffix beyond the matched pages."""
        ok, moves, m = self.allocs[block].admit_prefix(
            rid, n_pages, keys, min_pages=min_pages)
        self._execute(moves, block)
        if ok and self.blocks > 1:
            self._of[rid] = block
            if self.share and keys:
                best = max(len(a.match_prefix(keys[:n_pages]))
                           for b, a in enumerate(self.allocs) if b != block)
                if best >= max(1, int(min_pages)):
                    self.elsewhere += max(0, best - m)
        return ok, m

    def register_prefix(self, rid: int, keys: Sequence[bytes]):
        if self.share and keys:
            self._a(rid).register_prefix(rid, keys)

    def ensure_page(self, rid: int, j: int) -> bool:
        a, b = self._a(rid), self._blk(rid)
        fresh = a.tables[rid][j] is None
        ok, moves = a.ensure(rid, j)
        self._execute(moves, b)
        if ok and fresh:
            self._scrub([a.tables[rid][j][1]], b)
        return ok

    def ensure_writable(self, rid: int, j: int) -> bool:
        """Decode pre-step guard: page ``j`` must exist and satisfy the
        write rule (rc == 1, unregistered). Absent pages allocate and
        scrub; shared pages copy-on-write; private registered pages
        unregister."""
        a, b = self._a(rid), self._blk(rid)
        if a.tables[rid][j] is None:
            return self.ensure_page(rid, j)
        ok, moves, copy = a.make_writable(rid, j)
        self._execute(moves, b)
        if ok and copy is not None:                 # copy-on-write
            self._copy([copy[0]], [copy[1]], b)
        return ok

    def resume(self, rid: int, block: Optional[int] = None) -> bool:
        """Pin a preempted request resident again, faulting its spilled
        pages back; into ``block`` where that is another than its own
        (a cut pool), by moving its pages there."""
        b = self._blk(rid)
        if block is not None and block != b:
            return self._move(rid, block)
        ok, moves = self.allocs[b].resume(rid)
        self._execute(moves, b)
        return ok

    def _move(self, rid: int, dst: int) -> bool:
        """A preempted request's pages from its block onto fresh pages of
        block ``dst``: one broadcast over 'data' a leaf from the source
        block's rank (a copy where one process holds both)."""
        src = self._blk(rid)
        refs = self.allocs[src].tables[rid]
        js = [j for j, e in enumerate(refs) if e is not None]
        ok, moves, got = self.allocs[dst].adopt(rid, js)
        self._execute(moves, dst)
        if not ok:
            return False
        vals = self._entries(src, [refs[j] for j in js]) \
            if src in self._data else None
        if self.mesh is not None:
            mesh = self.mesh

            def sent(si, n, i, a):
                t = torch.empty((a.shape[0], len(js)) + tuple(a.shape[2:]),
                                dtype=a.dtype, device=a.device) \
                    if vals is None else vals[si][n][i]
                # gloo moves a 16-bit tensor as fp32, which holds it
                wide = mesh.backend == "gloo" and t.element_size() == 2
                out = mesh.data_broadcast(
                    (t.float() if wide else t).contiguous(), src)
                return out.to(a.dtype)
            vals = _rebuild(self._data[self.held[0]], lambda si, n, c: type(c)(
                *(None if a is None else sent(si, n, i, a)
                  for i, a in enumerate(c))))
        if dst in self._data:
            self._write([got[j] for j in js], vals, dst)
        self.allocs[src].free(rid)
        self._of[rid] = dst
        self.moved += len(js)
        return True

    def _entries(self, b: int, entries):
        """The pages of ``entries`` (("dev", id) / ("host", slot)) of
        block ``b``, device or host, as a tree of (R, n, L, …) on the
        device, in order."""
        dev = [i for i, e in enumerate(entries) if e[0] == "dev"]
        host = [i for i, e in enumerate(entries) if e[0] == "host"]
        dv = self._read([entries[i][1] for i in dev], b) if dev else None
        hs = torch.as_tensor([entries[i][1] for i in host], dtype=torch.int64)

        def leaf(si, n, i, a):
            out = torch.empty((a.shape[0], len(entries)) + tuple(a.shape[2:]),
                              dtype=a.dtype, device=a.device)
            if dev:
                out[:, dev] = dv[si][n][i]
            if host:
                out[:, host] = self._hosts[b][si][n][i][:, hs].to(a.device)
            return out
        return _rebuild(self._data[b], lambda si, n, c: type(c)(*(
            None if a is None else leaf(si, n, i, a)
            for i, a in enumerate(c))))

    # -- speculative-decode scratch ------------------------------------
    def begin_scratch(self, rid: int, js: Sequence[int]
                      ) -> Optional[Dict[int, int]]:
        """Open a draft round: one scratch page per logical page in
        ``js``, seeded with the real page's content (scrubbed where the
        logical page is unallocated), so entries before the range and
        old-lap entries survive the round. None under pool pressure."""
        a, b = self._a(rid), self._blk(rid)
        ok, moves, got = a.alloc_scratch(rid, list(js))
        self._execute(moves, b)
        if not ok:
            return None
        pages = a.dev_pages(rid)
        fresh = [s for j, s in got.items() if pages[j] is None]
        if fresh:
            self._scrub(fresh, b)
        seeded = [(pages[j], s) for j, s in got.items()
                  if pages[j] is not None]
        self._copy([p for p, _ in seeded], [s for _, s in seeded], b)
        return got

    def promote_scratch(self, rid: int, j: int) -> int:
        """Fully accepted page: a bookkeeping swap, never a copy."""
        return self._a(rid).promote_scratch(rid, j)

    def discard_scratch(self, rid: int):
        self._a(rid).discard_scratch(rid)

    def merge_scratch_slots(self, src: int, dst: int, lo: int, hi: int):
        """Boundary page of a partial acceptance: entries with positions
        in [lo, hi] move from scratch page ``src`` onto real page
        ``dst`` (which already satisfies the write rule); both lie in
        one block."""
        b = src // self.block_pages
        if b in self._data:
            s, d = self.local([src, dst], b)
            merge_page_slots(self._data[b], int(s), int(d), lo, hi)

    def dedup_sweep(self) -> int:
        return sum(a.dedup_sweep() for a in self.allocs)

    def free(self, rid: int):
        self._a(rid).free(rid)
        self._of.pop(rid, None)

    def preempt(self, rid: int):
        self._a(rid).preempt(rid)

    def mark_preempted(self, rid: int):
        self._a(rid).mark_preempted(rid)

    def has_pages(self, rid: int) -> bool:
        return self._a(rid).has(rid)

    def dev_pages(self, rid: int) -> List[Optional[int]]:
        return self._a(rid).dev_pages(rid)

    def admissible_requests(self) -> int:
        return sum(a.admissible_requests() for a in self.allocs)

    def check(self):
        """Every block's allocator invariants, and each request in the
        block it is mapped to."""
        for b, a in enumerate(self.allocs):
            a.check()
            for rid in a.tables:
                assert self._blk(rid) == b, (rid, b)

    # -- tables --------------------------------------------------------
    def block_table(self, slot_rids: Sequence[Optional[int]]
                    ) -> np.ndarray:
        """(B, NB) physical pages for the decode gather: occupied slots
        map their pages (the zero page where unallocated), free slots
        the trash page."""
        B = len(slot_rids)
        bt = np.full((B, self.NB), TRASH_PAGE, np.int32)
        for i, rid in enumerate(slot_rids):
            if rid is None:
                continue
            for j, p in enumerate(self.dev_pages(rid)):
                bt[i, j] = ZERO_PAGE if p is None else p
        return bt

    def dest_table(self, rids: Sequence[int], n_rows: int,
                   skip_pages: Optional[Sequence[int]] = None
                   ) -> np.ndarray:
        """(n_rows, NB) prefill write destinations: each request's
        allocated pages, the trash page elsewhere; ``skip_pages[i]``
        routes request i's first pages (its shared prefix) to trash."""
        dests = np.full((n_rows, self.NB), TRASH_PAGE, np.int32)
        for i, rid in enumerate(rids):
            skip = 0 if skip_pages is None else int(skip_pages[i])
            for j, p in enumerate(self.dev_pages(rid)):
                if p is not None and j >= skip:
                    dests[i, j] = p
        return dests

    def prefix_table(self, rids: Sequence[int],
                     shared_pages: Sequence[int],
                     n_rows: int) -> np.ndarray:
        """(n_rows, NB) read table of the suffix prefill: only the
        matched prefix pages are mapped, everything else reads the zero
        page."""
        bt = np.full((n_rows, self.NB), ZERO_PAGE, np.int32)
        for i, (rid, m) in enumerate(zip(rids, shared_pages)):
            pages = self.dev_pages(rid)
            for j in range(int(m)):
                assert pages[j] is not None, (rid, j, m)
                bt[i, j] = pages[j]
        return bt

    # -- data movement -------------------------------------------------
    def _execute(self, moves: List[_Move], b: int = 0):
        """Run block ``b``'s allocator's spill / fault moves where its
        tensors live: one gather to the host per call, one scatter from
        it. The ``spill`` / ``fault`` spans time the host around the
        copies."""
        if b not in self._data:
            return
        spills = [(m[3], m[4]) for m in moves if m[0] == "spill"]
        faults = [(m[3], m[4]) for m in moves if m[0] == "fault"]
        t0 = self._trace.t0()
        if spills:
            vals = self._read([d for d, _ in spills], b)
            hs = torch.as_tensor([h for _, h in spills], dtype=torch.int64)
            for si, name, hc in _caches(self._hosts[b]):
                for h, v in zip(hc, vals[si][name]):
                    if h is not None:
                        h[:, hs] = v.cpu()
            self._trace.complete("spill", t0, cat="kv", pages=len(spills))
        if faults:
            hs = torch.as_tensor([h for h, _ in faults], dtype=torch.int64)
            self._write([d for _, d in faults], _rebuild(
                self._hosts[b], lambda si, n, c: attn_mod.cache_map(
                    lambda a: a[:, hs], c)), b)
            self._trace.complete("fault", t0, cat="kv", pages=len(faults))

    # -- accounting ----------------------------------------------------
    def stats(self) -> MemoryStats:
        """The pool's accounting, summed over its blocks."""
        def total(fn):
            return sum(fn(a) for a in self.allocs)
        return MemoryStats(
            device_pages=total(lambda a: a.n_device),
            host_pages=total(lambda a: a.n_host),
            watermark=total(lambda a: a.cap),
            device_used=total(lambda a: a.used_dev),
            host_used=total(lambda a: a.used_host),
            preempted_resident=total(lambda a: a.preempted_dev_pages()),
            spills=total(lambda a: a.spills),
            faults=total(lambda a: a.faults),
            drops=total(lambda a: a.drops),
            shared_pages=total(lambda a: sum(1 for c in a.rc.values()
                                             if c > 1)),
            cached_pages=total(lambda a: len(a.cached)),
            prefix_hits=total(lambda a: a.prefix_hits),
            prefix_pages_reused=total(lambda a: a.prefix_pages_reused),
            cow_copies=total(lambda a: a.cow),
            cache_evictions=total(lambda a: a.evictions),
            scratch_pages=total(lambda a: sum(len(d)
                                              for d in a.scratch.values())),
            dedup_merges=total(lambda a: a.dedup_merges),
            blocks=self.blocks, prefix_pages_elsewhere=self.elsewhere,
            moved_pages=self.moved)
