"""AdamW with optionally int8-quantized moments (``repro.train.optimizer``).

(init, update) functions over the param tree, as in the reference:

* fp32 moments, or **int8 moments** (``quantized=True``): m and v are
  stored int8 with one fp32 scale per 256-wide block of the last axis
  (8-bit-Adam style). Moments are dequantized, updated in fp32 and
  requantized each step.
* the update clips by the global gradient norm, corrects the moments'
  bias, and decays weights decoupled from the gradient, on leaves of two
  or more dims only (pruned SASP tiles get zero gradient but still decay).

``adamw_update`` writes the new params and moments into the given
tensors (the reference's launcher donates them to its jitted step), and
returns them. The reference's ZeRO helpers (``zero_spec_from_param_spec``,
``opt_state_shardings``) place the moments of a mesh's ranks; the
``zero_*`` functions run the update on a rank's slices.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.pruning import iter_leaves, map_leaves

Params = Any
QBLOCK = 256


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    quantized: bool = False       # int8 moments


class QMoment(NamedTuple):
    q: torch.Tensor               # int8, param shape
    scale: torch.Tensor           # fp32, shape[:-1] + (ceil(last/QBLOCK),)


class AdamWState(NamedTuple):
    step: torch.Tensor            # int32 scalar
    m: Params
    v: Params


def _quantize_moment(x: torch.Tensor, lo: int = 0, nb: Optional[int] = None,
                     amax_reduce=None) -> QMoment:
    """fp32 -> int8 per 256-wide block of the last axis: scale =
    max(amax, 1e-20) / 127, q = round-half-even(x / scale). ``x`` may be
    the columns [lo, lo + n) of a leaf of ``nb`` blocks (a ZeRO or TP
    slice): the blocks are the whole leaf's, the scale (…, nb) covers
    them all, and ``amax_reduce`` takes the max over the ranks holding
    the leaf's other columns, so q and the scale equal the whole leaf's
    at every place."""
    shape = tuple(x.shape)
    lead, last = shape[:-1], (shape[-1] if shape else 1)
    b0, pre = divmod(lo, QBLOCK)
    nblk = -(-(pre + last) // QBLOCK)
    nb = b0 + nblk if nb is None else nb
    xf = x.to(torch.float32).reshape(*lead, last)
    xf = torch.nn.functional.pad(xf, (pre, nblk * QBLOCK - pre - last))
    xb = xf.reshape(*lead, nblk, QBLOCK)
    amax = torch.amax(torch.abs(xb), dim=-1)
    if nb != nblk or amax_reduce is not None:
        whole = amax.new_zeros(lead + (nb,))
        whole[..., b0:b0 + nblk] = amax
        amax = whole if amax_reduce is None else amax_reduce(whole)
    # divided by a tensor: a scalar divisor is a product with its
    # reciprocal on CUDA, one rounding away from the reference's scale
    scale = torch.clamp(amax, min=1e-20) / amax.new_tensor(127.0)
    q = torch.clamp(torch.round(xb / scale[..., b0:b0 + nblk, None]),
                    -127, 127).to(torch.int8)
    q = q.reshape(*lead, nblk * QBLOCK)[..., pre:pre + last].reshape(shape)
    return QMoment(q=q, scale=scale)


def _dequantize_moment(m: QMoment, shape, lo: int = 0) -> torch.Tensor:
    """The fp32 moment of ``m``; ``lo``: q holds the columns [lo, lo +
    n) of its leaf, whose every block ``m.scale`` holds."""
    shape = tuple(shape)
    if not shape:
        return m.q.to(torch.float32) * m.scale.reshape(())
    last = shape[-1]
    b0, pre = divmod(lo, QBLOCK)
    nblk = -(-(pre + last) // QBLOCK)
    q = torch.nn.functional.pad(m.q.to(torch.float32),
                                (pre, nblk * QBLOCK - pre - last))
    x = q.reshape(*shape[:-1], nblk, QBLOCK) * \
        m.scale[..., b0:b0 + nblk, None]
    return x.reshape(*shape[:-1], nblk * QBLOCK)[..., pre:pre + last]


def tree_map(fn, tree, *rest):
    """``fn`` over the tensor leaves of ``tree`` and the nodes of ``rest``
    at the same places (dicts, tuples and lists; a moment leaf may be a
    ``QMoment``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(tree, *rest)


def adamw_init(params: Params, cfg: AdamWConfig) -> AdamWState:
    def zero_like(p):
        z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return _quantize_moment(z) if cfg.quantized else z

    step = torch.zeros((), dtype=torch.int32,
                       device=next(iter_leaves(params))[1].device)
    return AdamWState(step=step, m=tree_map(zero_like, params),
                      v=tree_map(zero_like, params))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf, leaves in the
    reference's order (sorted dict keys), summed in fp32."""
    total = None
    for _, x in iter_leaves(tree):
        s = torch.sum(torch.square(x.to(torch.float32)))
        total = s if total is None else total + s
    return torch.sqrt(total)


def _step_scalars(state: AdamWState, gnorm, cfg: AdamWConfig, lr_scale):
    """(step + 1, clip, b1c, b2c, lr) of one update."""
    step = state.step + 1
    dev = step.device

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    # divisions by tensors: ``float / tensor`` is a reciprocal times the
    # float in torch, one rounding more than the reference
    clip = (torch.clamp(f32(cfg.grad_clip) / torch.clamp(gnorm, min=1e-9),
                        max=1.0) if cfg.grad_clip else 1.0)
    stepf = step.to(torch.float32)
    b1c = 1.0 - torch.pow(f32(cfg.b1), stepf)
    b2c = 1.0 - torch.pow(f32(cfg.b2), stepf)
    return step, clip, b1c, b2c, cfg.lr * f32(lr_scale)


def _adamw_leaf(p, g, mf, vf, cfg: AdamWConfig, scalars, decay: bool):
    """The new value of ``p`` (its dtype); the fp32 moments ``mf`` and
    ``vf`` are updated in place. ``decay``: the whole leaf has two or
    more dims."""
    _, clip, b1c, b2c, lr = scalars
    g = g.to(torch.float32) * clip
    mf = mf.mul_(cfg.b1).add_((1.0 - cfg.b1) * g)
    vf = vf.mul_(cfg.b2).add_(torch.square(g).mul_(1.0 - cfg.b2))
    delta = (mf / b1c).div_(torch.sqrt(vf / b2c).add_(cfg.eps))
    if cfg.weight_decay and decay:
        delta = delta.add_(cfg.weight_decay * p.to(torch.float32))
    return (p.to(torch.float32) - lr * delta).to(p.dtype)


def _store(old: QMoment, new: QMoment) -> None:
    old.q.copy_(new.q)
    old.scale.copy_(new.scale)


def adamw_update(grads: Params, state: AdamWState, params: Params,
                 cfg: AdamWConfig, lr_scale=1.0,
                 gnorm: Optional[torch.Tensor] = None
                 ) -> Tuple[Params, AdamWState]:
    """One AdamW step; ``lr_scale`` is a number or a 0-d fp32 tensor;
    ``gnorm`` is ``global_norm(grads)`` where the caller has it already.
    Params and moments are updated in place (and returned); ``grads`` are
    left as they are."""
    if gnorm is None:
        gnorm = global_norm(grads)
    scalars = _step_scalars(state, gnorm, cfg, lr_scale)

    def upd(p, g, m, v):
        mf = _dequantize_moment(m, p.shape) if cfg.quantized else m
        vf = _dequantize_moment(v, p.shape) if cfg.quantized else v
        p.copy_(_adamw_leaf(p, g, mf, vf, cfg, scalars, p.ndim >= 2))
        if cfg.quantized:
            _store(m, _quantize_moment(mf))
            _store(v, _quantize_moment(vf))

    with torch.no_grad():
        tree_map(upd, params, grads, state.m, state.v)
    return params, AdamWState(step=scalars[0], m=state.m, v=state.v)


# ---------------------------------------------------------------------------
# ZeRO over 'data' (the reference's ZeRO sharding helpers)
# ---------------------------------------------------------------------------
#
# A spec is a tuple with one entry per dim: 'model', 'data' or None
# (``distribution.sharding``). On a (data, model) mesh a rank holds its
# TP slice of every param (replicated over 'data') and its ZeRO slice of
# every moment: the param's TP slice cut again over 'data' on the dim
# ``zero_spec_from_param_spec`` picks. On a (pod, data, model) mesh the
# moments are cut over 'data' only (the reference's ZeRO specs name no
# 'pod'), so every pod holds the same slices and runs the same update.
# Int8 moments keep the whole leaf's 256-wide blocks: q is cut like an
# fp32 moment, the scale on its dims before the last only (the
# reference's placement); where the last dim is cut, each rank holds
# every block's scale, taken as the max over the ranks that share the
# block (``_quantize_moment``), so the state equals the single-device
# state at every place.

Spec = Tuple[Optional[str], ...]


def zero_spec_from_param_spec(spec: Spec, shape, sizes: Dict[str, int]
                              ) -> Spec:
    """The param's spec plus a 'data' shard on the largest dim not
    already sharded that 'data' divides (the first such dim on a tie;
    ZeRO-1)."""
    axes = list(spec) + [None] * (len(shape) - len(spec))
    if "data" in axes:
        return tuple(axes)
    dsz = sizes.get("data", 1)
    for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if axes[i] is None and shape[i] % dsz == 0:
            axes[i] = "data"
            break
    return tuple(axes)


def opt_state_shardings(params, sizes: Dict[str, int], opt_cfg: AdamWConfig,
                        param_specs: Dict[Tuple, Spec]) -> AdamWState:
    """Specs of ``adamw_init``'s output for the whole tree ``params``
    (tensors, or shapes' stand-ins: only ``.shape`` is read) whose param
    specs are ``param_specs`` ({path: spec}): the step replicated, and
    ``m`` / ``v`` as {path: spec}, a ``QMoment`` of specs with int8
    moments (q the moment's spec, the scale without a shard on its last
    dim)."""
    def one(path, leaf):
        spec = zero_spec_from_param_spec(param_specs[path],
                                         tuple(leaf.shape), sizes)
        if not opt_cfg.quantized:
            return spec
        return QMoment(q=spec, scale=spec[:-1] + (None,))

    moments = {path: one(path, leaf) for path, leaf in iter_leaves(params)}
    return AdamWState(step=(), m=moments, v=moments)


def _dim_of(spec: Spec, axis: str) -> Optional[int]:
    return spec.index(axis) if axis in spec else None


class ZeroSpecs(dict):
    """{path: a moment's spec} (``opt_state_shardings``' q under int8
    moments) and ``ep``: the paths whose param is cut over 'data' already
    (an expert stack under expert parallelism, the reference's
    ``expert_col`` / ``expert_row``). Such a leaf's moment keeps the
    param's cut and no more (``zero_spec_from_param_spec`` leaves a spec
    that holds 'data'), its gradient arrives whole on its data rank (the
    all-to-all's backward sums every data rank's contribution), so it is
    divided by DP and not reduced, and its update needs no all-gather.
    A plain dict has no such path."""

    def __init__(self, specs=(), ep=()):
        super().__init__(specs)
        self.ep = frozenset(ep)


def _zero_dim(zero_specs: Dict, path) -> Optional[int]:
    """The dim of the rank's param slice that ZeRO cuts over 'data'; None
    where the moment is whole over 'data' or the param is EP-cut."""
    if path in getattr(zero_specs, "ep", ()):
        return None
    return _dim_of(zero_specs[path], "data")


def _ep(zero_specs: Dict, path) -> bool:
    return path in getattr(zero_specs, "ep", ())


def local_slice(t: torch.Tensor, z: Optional[int], mesh) -> torch.Tensor:
    """The view of ``t`` (a rank's param slice) that this rank's data
    index holds when ZeRO cuts dim ``z`` over 'data' (``_zero_dim``; None:
    ``t`` itself)."""
    if z is None:
        return t
    k = t.shape[z] // mesh.shape["data"]
    return t.narrow(z, mesh.data_rank * k, k)


def _last_cut(spec: Spec, n: int, mesh):
    """(lo, amax_reduce) of a moment slice of width ``n`` along the last
    dim: its first column in the whole leaf and the max over the axis
    that cuts the last dim (None where it is whole)."""
    axis = spec[-1] if spec else None
    if axis is None or mesh.shape[axis] == 1:
        return 0, None
    return (mesh.axis_index(axis) * n,
            lambda a: mesh.allreduce(a, axis, "max"))


def zero_adamw_init(params, zero_specs: Dict, cfg: AdamWConfig, mesh
                    ) -> AdamWState:
    """``adamw_init`` of a rank's ZeRO slices: zero moments of each TP
    slice in ``params`` cut over 'data' by ``zero_specs`` ({path: the
    moment's spec}, ``opt_state_shardings``' q under int8 moments); int8
    scales hold every block of a cut last dim."""
    def zero(path, p):
        spec = zero_specs[path]
        z = torch.zeros(local_slice(p, _zero_dim(zero_specs, path),
                                    mesh).shape,
                        dtype=torch.float32, device=p.device)
        if not cfg.quantized:
            return z
        lo, _ = _last_cut(spec, z.shape[-1] if z.ndim else 1, mesh)
        width = (z.shape[-1] if z.ndim else 1) * (
            mesh.shape[spec[-1]] if spec and spec[-1] else 1)
        return _quantize_moment(z, lo, -(-width // QBLOCK))

    step = torch.zeros((), dtype=torch.int32,
                       device=next(iter_leaves(params))[1].device)
    return AdamWState(step=step, m=map_leaves(zero, params),
                      v=map_leaves(zero, params))


def reduce_grads(grads, zero_specs: Dict, mesh, over_model: bool = False):
    """{path: this rank's ZeRO slice of the mean over the DP axes ('pod'
    and 'data')} of a rank's TP-slice gradients: a reduce-scatter over
    'data' on the ZeRO dim, then an all-reduce of the slice over 'pod';
    an all-reduce over ``("pod", "data")`` where the moment is whole
    over 'data'; an EP-cut leaf's gradient (``ZeroSpecs.ep``), whole in
    its pod already, all-reduced over 'pod'. Each is divided by pods x
    data ranks. Every pod ends with the same slices (the reference's
    GSPMD reduces exactly over both axes; ``grad_compress`` is not
    used). ``over_model`` (the ``dp_only`` profile: whole params, a DP
    rank on every process): 'model' is a DP axis too, each slice then
    all-reduced over it and divided by every process (the moments stay
    cut over 'data' only, replicated over 'model', the reference's
    ``zero_spec_from_param_spec`` of a replicated spec)."""
    dp, pods = mesh.shape["data"], mesh.pods
    tp = mesh.shape["model"] if over_model else 1
    n = dp * pods * tp
    out = {}
    for path, g in iter_leaves(grads):
        z = _zero_dim(zero_specs, path)
        if n == 1:
            out[path] = g
            continue
        if _ep(zero_specs, path):
            s = g
        elif z is None:
            s = mesh.allreduce(g, ("pod", "data"))
        elif dp > 1:
            s = mesh.reduce_scatter(g, "data", z)
        else:
            s = g
        if pods > 1 and (z is not None or _ep(zero_specs, path)):
            s = mesh.allreduce(s, "pod")
        if tp > 1:
            s = mesh.allreduce(s, "model")
        out[path] = s / n
    return out


def zero_global_norm(grads: Dict, param_specs: Dict, zero_specs: Dict,
                     mesh) -> torch.Tensor:
    """The global gradient norm from every rank's ZeRO slices: each
    slice's squares summed in fp32, a leaf whole over 'model' counted on
    model rank 0 and one whole over 'data' on data rank 0 (an EP-cut
    expert stack, whose moments hold 'data', on every data rank: each
    holds its own experts), every slice on pod 0 only (each pod holds
    the same), then summed over the world."""
    total = None
    for path, g in grads.items():
        if ("model" not in param_specs[path] and mesh.model_rank) or \
                ("data" not in zero_specs[path] and mesh.data_rank) or \
                mesh.pod_rank:
            continue
        s = torch.sum(torch.square(g.to(torch.float32)))
        total = s if total is None else total + s
    if total is None:
        total = torch.zeros((), dtype=torch.float32, device=mesh.device)
    return torch.sqrt(mesh.allreduce(total, "world"))


def zero_adamw_update(grads: Dict, state: AdamWState, params,
                      zero_specs: Dict, cfg: AdamWConfig, mesh,
                      lr_scale=1.0, gnorm: Optional[torch.Tensor] = None):
    """AdamW on this rank's ZeRO slices (``grads`` from ``reduce_grads``,
    clipped by ``gnorm`` from ``zero_global_norm``), then each updated
    param slice all-gathered over 'data' into the rank's TP slice
    (in place; every pod runs the same update on the same slices). Weight
    decay keys on the whole leaf's rank, which every slice keeps."""
    scalars = _step_scalars(state, gnorm, cfg, lr_scale)
    with torch.no_grad():
        for path, p in iter_leaves(params):
            spec = zero_specs[path]
            z = _zero_dim(zero_specs, path)
            ps = local_slice(p, z, mesh)
            m, v = _leaf_at(state.m, path), _leaf_at(state.v, path)
            if cfg.quantized:
                lo, red = _last_cut(spec, ps.shape[-1] if ps.ndim else 1,
                                    mesh)
                mf = _dequantize_moment(m, ps.shape, lo)
                vf = _dequantize_moment(v, ps.shape, lo)
            else:
                mf, vf = m, v
            new = _adamw_leaf(ps, grads[path], mf, vf, cfg, scalars,
                              p.ndim >= 2)
            if cfg.quantized:
                nb = m.scale.shape[-1] if m.scale.ndim else 1
                _store(m, _quantize_moment(mf, lo, nb, red))
                _store(v, _quantize_moment(vf, lo, nb, red))
            if z is None or mesh.shape["data"] == 1:
                p.copy_(new)
            else:
                p.copy_(mesh.gather(new, "data", z))
    return params, AdamWState(step=scalars[0], m=state.m, v=state.v)


def _leaf_at(tree, path):
    """The node at ``path`` (a moment: a tensor, or a ``QMoment``)."""
    for k in path:
        tree = tree[k]
    return tree
