"""Pass 5 — packed-format invariant checker, over the port's containers.

Validation of the serving containers built by
``repro_torch.core.deploy`` (format spec: ``core/sparse.py``'s
docstring), check for check the reference's ``tools/analyze/packed.py``:

* ``PackedSASPWeight``: kn int32 (k, n) visit lists sorted n-major,
  every output-column block visited, dup-last-visit nnz padding
  zero-valued, shard-local coordinates in range, shard_kind/act/bias
  consistency, no double-counted (nonzero) visit within or across
  shards; and the port's ``col_ptr``: int32, the CSR offsets of kn.
* ``PackedFFN``: jv int32 global d_ff block indices, live prefix
  strictly increasing with a ``-1`` zero-``w2v`` padding suffix,
  contiguous shard partitioning with no duplicated live visit, whole
  (unsharded) b2.

The validators run in torch on the tensors' own device (the card's for
a served tree): every check is a reduction over whole visit lists, and
only its small result (a flag per list, the coordinates of a
double-counted block) reaches the host, never the weight values.
Containers are whole (``held == shards``): a mesh rank's local container
is not their subject. ``validate_packed_weight`` / ``validate_packed_ffn``
/ ``validate_params_tree`` are importable by tests and the smoke. The
analyzer pass (:func:`run`) exercises the ``core/deploy.py`` call sites:
it builds a small pruned model on ``device``, deploys it at several
(tp, quantize, fuse_ffn) points, reshards it, and validates every
container plus cross-deployment visit-count conservation.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

from .common import Finding, REPO_ROOT
from .rules import PACK_CONSERVE, PACK_DTYPE, PACK_KIND, PACK_PAD

DEPLOY_REL = "src/repro_torch/core/deploy.py"


# ---------------------------------------------------------------------------
# runtime validators (on the containers' device)
# ---------------------------------------------------------------------------

def _flat_lists(t, list_ndim: int):
    """Collapse any leading (layer/shard) axes: (..., *list_dims) ->
    (prod(leading), *list_dims)."""
    lead = 1
    for d in t.shape[: t.ndim - list_ndim]:
        lead *= int(d)
    return t.reshape((lead,) + tuple(t.shape[t.ndim - list_ndim:]))


def _lists(mask) -> List[int]:
    """The list indices where a (G,) bool tensor is set."""
    return [int(g) for g in mask.nonzero().flatten().tolist()]


def _dups(keys, mask):
    """Keys (G, n) int64 that occur more than once among ``mask``: the
    repeated values, sorted."""
    import torch
    v, c = torch.unique(keys[mask], return_counts=True)
    return v[c > 1]


def validate_packed_weight(pw, name: str = "weight") -> List[Tuple[str, str]]:
    """Validate one PackedSASPWeight. Returns [(rule_id, message)]."""
    import torch
    errs: List[Tuple[str, str]] = []

    def err(rule: str, msg: str) -> None:
        errs.append((rule, "%s: %s" % (name, msg)))

    vals, kn = pw.vals, pw.kn
    K, N = pw.shape
    bk, bn = pw.block
    tp = int(pw.shards)

    # -- dtypes -------------------------------------------------------------
    if kn.dtype != torch.int32:
        err(PACK_DTYPE, "kn block table dtype %s, want int32" % kn.dtype)
    if pw.col_ptr is not None and pw.col_ptr.dtype != torch.int32:
        err(PACK_DTYPE, "col_ptr dtype %s, want int32" % pw.col_ptr.dtype)
    if pw.scale is not None and pw.scale.dtype != torch.float32:
        err(PACK_DTYPE, "scale dtype %s, want float32" % pw.scale.dtype)
    if pw.bias is not None and pw.bias.dtype != torch.float32:
        err(PACK_DTYPE, "bias dtype %s, want float32" % pw.bias.dtype)

    # -- structural / shard-kind consistency --------------------------------
    if tp > 1 and pw.shard_kind not in ("col", "row"):
        err(PACK_KIND, "shards=%d but shard_kind=%r (want 'col'/'row')"
            % (tp, pw.shard_kind))
        return errs
    if tp == 1 and pw.shard_kind is not None:
        err(PACK_KIND, "shards=1 but shard_kind=%r (want None)"
            % (pw.shard_kind,))
    if tp > 1 and pw.shard_kind == "row" and pw.act is not None:
        err(PACK_KIND, "row-sharded container carries act=%r "
            "(nonlinear epilogue on partial sums)" % (pw.act,))
    if vals.ndim != kn.ndim + 1:
        err(PACK_KIND, "vals ndim %d inconsistent with kn ndim %d"
            % (vals.ndim, kn.ndim))
        return errs
    if tuple(vals.shape[-2:]) != (bk, bn):
        err(PACK_KIND, "vals block dims %s != declared block %s"
            % (tuple(vals.shape[-2:]), (bk, bn)))
        return errs
    if kn.shape[-2] != 2 or kn.shape[-1] != vals.shape[-3]:
        err(PACK_KIND, "kn shape %s inconsistent with vals %s"
            % (tuple(kn.shape), tuple(vals.shape)))
        return errs
    if tp > 1 and (vals.ndim < 4 or vals.shape[-4] != tp):
        err(PACK_KIND, "shards=%d but vals shard axis is %s"
            % (tp, tuple(vals.shape)))
        return errs
    if pw.bias is not None:
        b = pw.bias
        if tp > 1 and pw.shard_kind == "col":
            if tuple(b.shape[-2:]) != (tp, N // tp):
                err(PACK_KIND, "col-sharded bias shape %s, want "
                    "(..., %d, %d)" % (tuple(b.shape), tp, N // tp))
        elif b.shape[-1] != N:
            err(PACK_KIND, "bias shape %s, want (..., %d)"
                % (tuple(b.shape), N))

    # -- per-(layer, shard) visit lists -------------------------------------
    KB, NB = K // bk, N // bn
    if tp > 1 and pw.shard_kind == "col":
        KB_l, NB_l = KB, NB // tp
    elif tp > 1:
        KB_l, NB_l = KB // tp, NB
    else:
        KB_l, NB_l = KB, NB

    if pw.col_ptr is not None:
        from repro_torch.core.sparse import col_ptr_from_kn
        want = col_ptr_from_kn(kn, NB_l)
        if tuple(pw.col_ptr.shape) != tuple(want.shape) or not bool(
                torch.equal(pw.col_ptr.to(torch.int32), want)):
            err(PACK_KIND, "col_ptr is not the CSR offsets of kn's "
                "n coordinates")

    flat_kn = _flat_lists(kn, 2).to(torch.int64)     # (G, 2, nnz)
    flat_v = _flat_lists(vals, 3)                    # (G, nnz, bk, bn)
    G, nnz = flat_kn.shape[0], flat_kn.shape[-1]
    if G == 0 or nnz == 0:
        return errs
    ks, ns = flat_kn[:, 0], flat_kn[:, 1]
    nonzero = (flat_v != 0).flatten(2).any(-1)       # (G, nnz)
    k_bad = (ks < 0).any(-1) | (ks >= KB_l).any(-1)
    n_bad = ~k_bad & ((ns < 0).any(-1) | (ns >= NB_l).any(-1))
    for g in _lists(k_bad):
        err(PACK_PAD, "list %d: k coords outside [0, %d)" % (g, KB_l))
    for g in _lists(n_bad):
        err(PACK_PAD, "list %d: n coords outside [0, %d)" % (g, NB_l))
    ok = ~(k_bad | n_bad)                            # (G,)
    if not bool(ok.any()):
        return errs
    ks = torch.where(ok[:, None], ks, 0)
    ns = torch.where(ok[:, None], ns, 0)
    # n-major sort: (n, k) lexicographically non-decreasing
    key = ns * (KB_l + 1) + ks
    for g in _lists(ok & (key.diff(dim=-1) < 0).any(-1)):
        err(PACK_PAD, "list %d: visits not sorted n-major by (n, k)" % g)
    seen = torch.zeros((G, NB_l), dtype=torch.bool, device=ns.device)
    seen.scatter_(1, ns, True)
    for g in _lists(ok & ~seen.all(-1)):
        err(PACK_PAD, "list %d: output blocks without a visit "
            "(flush coverage broken)" % g)
    # dup-last-visit padding: a visit repeating its predecessor's
    # coords must be zero-valued
    dup = (ks.diff(dim=-1) == 0) & (ns.diff(dim=-1) == 0)
    for g in _lists(ok & (dup & nonzero[:, 1:]).any(-1)):
        err(PACK_PAD, "list %d: duplicate-coordinate visit carries "
            "nonzero values (padding must be zero)" % g)
    # conservation within a list: each (k, n) at most one nonzero block
    span = (NB_l + 1) * (KB_l + 1)
    lists = torch.arange(G, device=ns.device)[:, None]
    live = nonzero & ok[:, None]
    for v in _dups(lists * span + key, live).tolist():
        err(PACK_CONSERVE, "list %d: (k, n) block double-counted within "
            "a visit list" % (v // span))
    # global coordinates for cross-shard conservation
    s = lists % tp if tp > 1 else torch.zeros_like(lists)
    layer = lists // tp if tp > 1 else lists
    if tp > 1 and pw.shard_kind == "col":
        gk, gn = ks, ns + s * NB_l
    elif tp > 1:
        gk, gn = ks + s * KB_l, ns
    else:
        gk, gn = ks, ns
    gkey = (layer * KB + gk) * NB + gn
    for v in _dups(gkey, live).tolist():
        li, rest = divmod(v, KB * NB)
        err(PACK_CONSERVE, "layer %d: block (k=%d, n=%d) appears "
            "nonzero in more than one visit" % (li, rest // NB, rest % NB))
    return errs


def live_visit_sets(pw) -> Dict[int, set]:
    """Per-layer set of GLOBAL (k, n) coordinates of nonzero visits —
    the conserved quantity across shardings of the same weight."""
    import torch
    tp = int(pw.shards)
    K, N = pw.shape
    bk, bn = pw.block
    KB, NB = K // bk, N // bn
    flat_kn = _flat_lists(pw.kn, 2).to(torch.int64)
    nonzero = (_flat_lists(pw.vals, 3) != 0).flatten(2).any(-1)
    G = flat_kn.shape[0]
    lists = torch.arange(G, device=flat_kn.device)[:, None]
    ks, ns = flat_kn[:, 0], flat_kn[:, 1]
    if tp > 1 and pw.shard_kind == "col":
        ns = ns + (lists % tp) * (NB // tp)
    elif tp > 1:
        ks = ks + (lists % tp) * (KB // tp)
    layer = (lists // tp if tp > 1 else lists).expand_as(ks)
    out: Dict[int, set] = {}
    for li, k_, n_ in zip(layer[nonzero].tolist(), ks[nonzero].tolist(),
                          ns[nonzero].tolist()):
        out.setdefault(li, set()).add((k_, n_))
    for li in range(G // tp if tp > 1 else G):
        out.setdefault(li, set())
    return out


def validate_packed_ffn(pf, name: str = "ffn") -> List[Tuple[str, str]]:
    """Validate one PackedFFN. Returns [(rule_id, message)]."""
    import torch
    errs: List[Tuple[str, str]] = []

    def err(rule: str, msg: str) -> None:
        errs.append((rule, "%s: %s" % (name, msg)))

    w1v, w2v = pf.w1v, pf.w2v
    tp = int(pf.shards)
    FB = pf.d_ff // pf.block_f

    if pf.jv is None:
        err(PACK_DTYPE, "jv global-visit-index table missing")
        return errs
    jv = pf.jv
    if jv.dtype != torch.int32:
        err(PACK_DTYPE, "jv dtype %s, want int32" % jv.dtype)
    for sname in ("s1", "s3", "s2"):
        s = getattr(pf, sname)
        if s is not None and s.dtype != torch.float32:
            err(PACK_DTYPE, "%s dtype %s, want float32" % (sname, s.dtype))

    has_shard = tp > 1
    layer_axes = w1v.ndim - 3 - (1 if has_shard else 0)
    if layer_axes not in (0, 1):
        err(PACK_KIND, "w1v ndim %d inconsistent with shards=%d"
            % (w1v.ndim, tp))
        return errs
    if has_shard and w1v.shape[layer_axes] != tp:
        err(PACK_KIND, "shards=%d but w1v shard axis is %s"
            % (tp, tuple(w1v.shape)))
        return errs
    b2 = pf.b2
    if b2.ndim != layer_axes + 1 or b2.shape[-1] != pf.d_model:
        err(PACK_KIND, "b2 shape %s, want whole (unsharded) "
            "(..., %d) added once after the reduction"
            % (tuple(b2.shape), pf.d_model))
    if tuple(jv.shape) != tuple(w1v.shape[:-2]):
        err(PACK_KIND, "jv shape %s inconsistent with w1v %s"
            % (tuple(jv.shape), tuple(w1v.shape)))
        return errs

    flat_jv = _flat_lists(jv, 1).to(torch.int64)     # (G, nv)
    G, nv = flat_jv.shape
    if G == 0 or nv == 0:
        return errs
    flat_w2 = _flat_lists(w2v, 3)                    # (G, nv, bf, d)
    bad_range = (flat_jv < -1).any(-1) | (flat_jv >= FB).any(-1)
    for g in _lists(bad_range):
        err(PACK_PAD, "list %d: jv outside [-1, %d)" % (g, FB))
    ok = ~bad_range
    live = flat_jv >= 0
    # -1 entries are padding and must form a suffix
    after_pad = torch.cummax((~live).to(torch.int8), dim=-1).values.bool()
    for g in _lists(ok & (live & after_pad).any(-1)):
        err(PACK_PAD, "list %d: live visit after jv=-1 padding" % g)
    # strictly increasing over the live entries: each above the largest
    # live entry before it
    run_max = torch.cummax(torch.where(live, flat_jv, -2), dim=-1).values
    before = torch.cat([torch.full_like(run_max[:, :1], -2),
                        run_max[:, :-1]], dim=-1)
    for g in _lists(ok & (live & (flat_jv <= before)).any(-1)):
        err(PACK_PAD, "list %d: live jv not strictly increasing" % g)
    pad_nonzero = ((flat_w2 != 0).flatten(2).any(-1) & ~live).any(-1)
    for g in _lists(ok & pad_nonzero):
        err(PACK_PAD, "list %d: jv=-1 padding visit has nonzero w2v "
            "(would contribute to the output)" % g)
    if has_shard:
        fs = FB // tp
        lo = (torch.arange(G, device=flat_jv.device) % tp)[:, None] * fs
        out = live & ((flat_jv < lo) | (flat_jv >= lo + fs))
        for g in _lists(ok & out.any(-1)):
            err(PACK_CONSERVE, "list %d: shard %d carries d_ff blocks "
                "outside its contiguous range [%d, %d)"
                % (g, g % tp, (g % tp) * fs, (g % tp + 1) * fs))
        # cross-shard conservation: a d_ff block visited by 2 shards
        # would be down-projected twice
        layer = torch.arange(G, device=flat_jv.device)[:, None] // tp
        for v in _dups(layer * (FB + 1) + flat_jv, live).tolist():
            err(PACK_CONSERVE, "layer %d: d_ff block %d visited by more "
                "than one shard" % divmod(v, FB + 1))
    return errs


def live_ffn_sets(pf) -> Dict[int, set]:
    """Per-layer set of live global d_ff block indices."""
    tp = int(pf.shards)
    flat = _flat_lists(pf.jv, 1)
    out: Dict[int, set] = {}
    for g, row in enumerate(flat.tolist()):
        out.setdefault(g // tp if tp > 1 else g, set()).update(
            v for v in row if v >= 0)
    return out


def packed_leaves(tree, path: str = ""):
    """(key path, container) of every packed container of a param tree,
    the path in ``jax.tree_util.keystr``'s form (``['segments'][0]…``)."""
    from repro_torch.core.sparse import PackedFFN, PackedSASPWeight
    if isinstance(tree, (PackedSASPWeight, PackedFFN)):
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from packed_leaves(v, "%s[%r]" % (path, k))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from packed_leaves(v, "%s[%d]" % (path, i))


def validate_params_tree(params) -> List[Tuple[str, str, str]]:
    """Walk a deployed param tree; validate every packed container.
    Returns [(keypath, rule_id, message)]."""
    from repro_torch.core.sparse import PackedSASPWeight
    out: List[Tuple[str, str, str]] = []
    for key, leaf in packed_leaves(params):
        if isinstance(leaf, PackedSASPWeight):
            errs = validate_packed_weight(leaf, name=key)
        else:
            errs = validate_packed_ffn(leaf, name=key)
        out.extend((key, rule, msg) for rule, msg in errs)
    return out


# ---------------------------------------------------------------------------
# analyzer pass: exercise core/deploy.py call sites
# ---------------------------------------------------------------------------

def _deploy_line(root: str, pattern: str = "def deploy_packed") -> int:
    path = os.path.join(root, DEPLOY_REL)
    try:
        with open(path, "r", encoding="utf-8") as fh:
            for i, line in enumerate(fh, 1):
                if line.startswith(pattern):
                    return i
    except OSError:
        pass
    return 1


def resolve_device(device: Optional[str]) -> str:
    """``device`` as given, "cuda" by default; a CUDA device with no card
    is an error (the pass does not carry on on the CPU)."""
    import torch
    device = device or "cuda"
    if device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError("the packed pass runs on the card by default "
                           "and torch.cuda.is_available() is false; pass "
                           "--device cpu to run it on the CPU")
    return device


def run(root: str = REPO_ROOT, device: Optional[str] = None
        ) -> List[Finding]:
    import dataclasses

    from repro_torch.configs import SASPConfig, get_config, reduced
    from repro_torch.core.deploy import deploy_packed, reshard_packed
    from repro_torch.core.pruning import prune_params
    from repro_torch.core.sparse import PackedSASPWeight
    from repro_torch.models import lm

    device = resolve_device(device)
    line = _deploy_line(root)
    findings: List[Finding] = []

    def emit(rule: str, msg: str) -> None:
        findings.append(Finding(rule, DEPLOY_REL, line, msg))

    sasp = SASPConfig(enabled=True, block_k=16, block_n=16,
                      sparsity=0.5, scope="all")
    cfg = dataclasses.replace(
        reduced(get_config("qwen3-32b"), layers=2, d_model=64, vocab=64),
        sasp=sasp)
    params = lm.init_params(cfg, seed=0, device=device)
    pruned, _ = prune_params(params, sasp)

    deploys = {
        "tp=1": deploy_packed(pruned, cfg, fuse_ffn=True)[0],
        "tp=2": deploy_packed(pruned, cfg, fuse_ffn=True, tp=2)[0],
        "tp=2,unfused": deploy_packed(pruned, cfg, fuse_ffn=False,
                                      tp=2)[0],
        "tp=1,int8": deploy_packed(pruned, cfg, quantize=True)[0],
    }
    deploys["reshard 1->2"] = reshard_packed(deploys["tp=1"], cfg, tp=2)
    deploys["reshard 2->1"] = reshard_packed(deploys["tp=2"], cfg, tp=1)

    for tag, tree in deploys.items():
        for key, rule, msg in validate_params_tree(tree):
            emit(rule, "[deploy %s] %s %s" % (tag, key, msg))

    # cross-deployment visit-count conservation (fp32 deploys): the set
    # of live (k, n) / d_ff blocks per layer must be identical however
    # the schedule is sharded.
    ref = dict(packed_leaves(deploys["tp=1"]))
    for tag in ("tp=2", "reshard 1->2", "reshard 2->1"):
        other = dict(packed_leaves(deploys[tag]))
        for key, leaf in ref.items():
            if key not in other:
                emit(PACK_CONSERVE, "[deploy %s] container %s missing "
                     "vs tp=1 deploy" % (tag, key))
                continue
            if isinstance(leaf, PackedSASPWeight):
                a, b = live_visit_sets(leaf), live_visit_sets(other[key])
            else:
                a, b = live_ffn_sets(leaf), live_ffn_sets(other[key])
            if a != b:
                lost = {k: sorted(v - b.get(k, set()))[:4]
                        for k, v in a.items() if v - b.get(k, set())}
                extra = {k: sorted(b.get(k, set()) - v)[:4]
                         for k, v in a.items() if b.get(k, set()) - v}
                emit(PACK_CONSERVE,
                     "[deploy %s] %s live visits not conserved vs tp=1 "
                     "(lost=%s extra=%s)" % (tag, key, lost, extra))
    return findings
