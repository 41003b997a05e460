"""Paged-KV refcount invariant helper for the port (the reference's
``tools/analyze/pages.py``, DESIGN.md §16).

Validation of a live ``repro_torch.serve.memory.PageAllocator``, or of
a ``PagedKVPool`` and every block of it, that reads host bookkeeping
only (no tensor, no device). Tests and the smoke run it after adversarial
events (preempt storms, forced spills, speculative rounds, a pool cut
over 'data'). Like the reference's helper it is not a registered pass:
its subject is a runtime object. ``check_page_refcounts`` returns a list
of error strings (empty = healthy) instead of asserting:

    errs = check_page_refcounts(engine.pool)
    assert not errs, errs

Invariants (the prose form of ``PageAllocator.check``), per allocator:

* refcount == number of block-table references, for every owned page
* device pages partition exactly into {owned} ∪ {free} ∪ {cached} ∪
  {scratch} — no leaks, no double-frees
* host slots partition into {spilled refs} ∪ {free}
* high watermark respected (``used_dev <= cap``)
* a request is resident XOR preempted, and has a table iff it is one of
  them; resident requests hold no spilled pages
* every cached (rc-0, LRU-evictable) page is registered in the radix
  index, every registered page is device-resident, nodes point back
  at their page
* share disabled ⇒ no radix state and every refcount is exactly 1
* speculative scratch pages (DESIGN.md §17) are held only by resident
  requests, carry no refcount, and are never registered — they join
  the device-page partition but stay invisible to sharing
* content keys (the dedup sweep's evidence) only for requests with a
  table

and for a pool cut into blocks (``PagedKVPool.allocs``): each block's
allocator owns exactly its block's page ids (``memory.block_ids``), and
each request with a table in a block is one the pool maps to that block.
"""

from __future__ import annotations

from typing import Dict, List


def _check_alloc(a, ids=None) -> List[str]:
    errs: List[str] = []
    ref_count: Dict[int, int] = {}
    owned_host: List[int] = []
    for rid, refs in a.tables.items():
        for e in refs:
            if e is None:
                continue
            if e[0] == "dev":
                ref_count[e[1]] = ref_count.get(e[1], 0) + 1
            else:
                owned_host.append(e[1])

    if ref_count != a.rc:
        errs.append(f"refcount != block-table references: "
                    f"rc={a.rc} vs tables={ref_count}")
    scratch_pages = [p for d in a.scratch.values() for p in d.values()]
    seen = sorted(list(ref_count) + list(a.free_dev) + list(a.cached)
                  + scratch_pages)
    if seen != a._all_dev:
        errs.append(f"device pages leaked or double-owned: "
                    f"owned+free+cached+scratch={seen} "
                    f"vs all={a._all_dev}")
    if ids is not None and a._all_dev != sorted(ids):
        errs.append(f"allocator pages {a._all_dev} are not its block's "
                    f"{sorted(ids)}")
    for rid, d in a.scratch.items():
        if rid not in a.resident:
            errs.append(f"scratch held by non-resident rid {rid}")
        for p in d.values():
            if p in a.rc or p in a._node_of:
                errs.append(f"scratch page {p} owned or registered")
    if sorted(owned_host + list(a.free_host)) != list(range(a.n_host)):
        errs.append(f"host slots leaked or double-owned: "
                    f"owned={sorted(owned_host)} free={a.free_host}")
    if len(set(owned_host)) != len(owned_host):
        errs.append(f"host slot double-referenced: {sorted(owned_host)}")
    if a.used_dev > a.cap:
        errs.append(f"watermark breached: {a.used_dev} > cap {a.cap}")
    if not set(a.preempted).isdisjoint(a.resident):
        errs.append("request both resident and preempted: "
                    f"{set(a.preempted) & a.resident}")
    if set(a.tables) != a.resident | set(a.preempted):
        errs.append("table set != resident ∪ preempted")
    for rid in a.resident:
        if any(e is not None and e[0] != "dev"
               for e in a.tables.get(rid, ())):
            errs.append(f"resident rid {rid} holds spilled pages")
    if len(set(a.cached)) != len(a.cached):
        errs.append(f"cached LRU holds duplicates: {a.cached}")
    for p in a.cached:
        if p not in a._node_of:
            errs.append(f"cached page {p} not in the radix index")
    for p, node in a._node_of.items():
        if node.page != p:
            errs.append(f"radix node for page {p} points at "
                        f"{node.page}")
        if p not in a.rc and p not in a.cached:
            errs.append(f"registered page {p} neither owned nor cached")
    if not set(a._keys) <= set(a.tables):
        errs.append("content keys for departed requests: "
                    f"{sorted(set(a._keys) - set(a.tables))}")
    if not a.share:
        if a._node_of or a.cached:
            errs.append("share disabled but radix state exists")
        bad = {p: c for p, c in a.rc.items() if c != 1}
        if bad:
            errs.append(f"share disabled but refcounts != 1: {bad}")
    return errs


def check_page_refcounts(pool_or_alloc) -> List[str]:
    """Validate refcount/partition invariants. Returns error strings
    (empty list = all invariants hold). Accepts a ``PagedKVPool`` (every
    block: its errors prefixed ``block b:``), a bare ``PageAllocator``,
    or ``None`` (contiguous engine — nothing to check)."""
    if pool_or_alloc is None:
        return []
    allocs = getattr(pool_or_alloc, "allocs", None)
    if allocs is None:
        return _check_alloc(pool_or_alloc)
    from repro_torch.serve.memory import block_ids

    pool = pool_or_alloc
    errs: List[str] = []
    for b, a in enumerate(allocs):
        ids = block_ids(pool.n_device, pool.blocks, b)
        errs.extend(f"block {b}: {e}" for e in _check_alloc(a, ids))
        for rid in a.tables:
            if pool._of.get(rid, 0) != b:
                errs.append(f"block {b}: rid {rid} has a table here but "
                            f"the pool maps it to block "
                            f"{pool._of.get(rid, 0)}")
    return errs
