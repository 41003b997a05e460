#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # all phases, one card

Phases, each reported on its own lines; any failure exits non-zero:
  1. build    — compile every CUDA kernel from src/repro_torch/kernels/csrc
                with nvcc for sm_90a (one nvcc per source, in parallel).
  2. kernels  — every kernel variant against its plain PyTorch version on
                the card, at the shapes of the main path (qwen3-32b width:
                wq 5120->8192, wk/wv 5120->1024, wo 8192->5120 and the
                5120/25600 gated FFN, decode and prefill rows, fp32 and
                bf16), with kernel / plain / library times and the
                least time the card could take (bound).
  3. serve    — the main path: qwen3-32b at full width, depth cut to 4
                layers, random weights from seed 0 (wo and w2 rescaled
                to the 0.02 of the other projections), pruned to 50% tiles
                (scope all), packed, bf16 compute, Engine(4 slots,
                cache 256) serving 4 requests of 16 new tokens, after
                one untimed run of the same prompts (the cold start).
                Both kernels must launch on it.
  4. profile  — the prefill step and three decode steps of the same
                model under torch.profiler: device time by kernel and
                the device's busy share of the wall time (traces in
                build/chip_smoke/).
  5. parity   — fp32 packed vs masked (plain matmuls on the same pruned
                weights): prefill logits and the first decode step.
  6. int8     — --int8-weights at full width, 1 layer: both int8 kernel
                variants on the path, within 5e-2 of the fp32 masked model.
The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.

Needs only this checkout (it imports ``repro_torch`` from ``src/``), a
CUDA card and nvcc; it never imports jax or the ``repro`` package.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
# full results (chip_smoke.json) and profiler traces; gitignored
OUT_DIR = os.path.join(ROOT, "build", "chip_smoke")

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and FLOP/s by type.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
N_LAYERS = 4
SPARSITY = 0.5
DEVICE = "cuda"
# slice shapes at qwen3-32b width, 32x32 tiles: the attention projections
# (K, N) (wk and wv share one shape) and the gated FFN (d, d_ff)
GEMM_SHAPES = (("wq", 5120, 8192), ("wk/wv", 5120, 1024),
               ("wo", 8192, 5120))
FFN_SHAPE = (5120, 25600)
BLOCK = 32


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else "nvidia-smi unavailable"


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


class Timer:
    """Mean device time of ``fn`` over ``reps`` launches, each timed with
    CUDA events and preceded by a write of a 256 MB buffer so that the
    weights come from device memory as they do on the serving path (the
    50 MB L2 would otherwise hold a whole matrix)."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32,
                                 device=DEVICE)

    def ms(self, fn, reps: int = 10) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        total = 0.0
        for _ in range(reps):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            total += start.elapsed_time(end)
        return total / reps


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def bound_ms(n_bytes: int, ops):
    """Least time: the larger of the bytes over the memory rate and the
    operations over their type's peak. ``ops`` is a list of (FLOPs, type):
    a product runs at the bf16 peak where both operands are exact in bf16
    (bf16 x with bf16 or int8 weights; fp32 accumulation), else at fp32."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = sum(f / PEAK_FLOPS[kind] for f, kind in ops) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def rel_err(got, want) -> float:
    g, w = got.float(), want.float()
    return float((g - w).abs().max() / w.abs().max().clamp_min(1e-9))


def gemm_checks(torch, timer, rows):
    """Tile-skip GEMM at every attention projection's shape (32x32 tiles,
    half the tiles pruned), every variant, decode and prefill rows."""
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(1)
    results = []
    for shape in GEMM_SHAPES:
        results += _gemm_checks_at(torch, timer, rows, gen, *shape)
    return results


def _gemm_checks_at(torch, timer, rows, gen, proj: str, K: int, N: int):
    from repro_torch.core.sparse import col_ptr_from_kn
    from repro_torch.kernels.sasp_gemm import gemm, pack

    bk = bn = BLOCK
    w = torch.randn((K, N), generator=gen, device=DEVICE) * 0.02
    mask = torch.rand((K // bk, N // bn), generator=gen, device=DEVICE) \
        > SPARSITY
    w_np, m_np = w.cpu().numpy(), mask.cpu().numpy()
    packs = {q: pack.build_kernel_weight(w_np, m_np, bk, bn, quantize=q)
             for q in (False, True)}
    bias = torch.randn((N,), generator=gen, device=DEVICE)
    live = int(m_np.sum())
    results = []
    for variant, quant, with_bias, act in (
            ("fp", False, False, None), ("fp+bias", False, True, "silu"),
            ("int8", True, False, None), ("int8+bias", True, True, "silu")):
        vals, kn, sc = packs[quant]
        kn_t = torch.from_numpy(kn).to(DEVICE)
        cp = col_ptr_from_kn(kn_t, N // bn)
        st = None if sc is None else torch.from_numpy(sc).to(DEVICE)
        bt = bias if with_bias else None
        for xdt in ("float32", "bfloat16"):
            v_t = torch.from_numpy(vals).to(DEVICE)
            if not quant:
                v_t = v_t.to(getattr(torch, xdt))
            for M in rows:
                x = torch.randn((M, K), generator=gen, device=DEVICE
                                ).to(getattr(torch, xdt))
                got = gemm.sasp_gemm(x, v_t, kn_t, cp, N, scales=st,
                                     bias=bt, act=act)
                want = gemm.sasp_gemm_plain(x, v_t, kn_t, N, st, bt, act)
                torch.cuda.synchronize()
                err = rel_err(got, want)
                tol = 1e-4 if xdt == "float32" else 1e-2
                check(err <= tol, f"sasp_gemm {proj} {variant} {xdt} M={M}: "
                      f"error {err:.3g} > {tol}")
                k_ms = timer.ms(lambda: gemm.sasp_gemm(
                    x, v_t, kn_t, cp, N, scales=st, bias=bt, act=act))
                p_ms = timer.ms(lambda: gemm.sasp_gemm_plain(
                    x, v_t, kn_t, N, st, bt, act), reps=3)
                lib_ms = None
                if not with_bias:
                    wd = (w * mask.repeat_interleave(bk, 0)
                          .repeat_interleave(bn, 1)).to(x.dtype)
                    lib_ms = timer.ms(lambda: torch.matmul(x, wd))
                    del wd
                n_b = nbytes(x, v_t, kn_t, cp, st, bt, got)
                b_ms, b_by = bound_ms(n_b, [(2.0 * M * bk * bn * live, xdt)])
                results.append(dict(
                    proj=proj, K=K, N=N, variant=variant, x=xdt,
                    w=str(v_t.dtype)[6:], M=M,
                    rel_err=err, max_abs_err=float(
                        (got.float() - want.float()).abs().max()),
                    tol=tol, ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
                    bound_ms=b_ms, bound_by=b_by))
                log("  sasp_gemm " + json.dumps(results[-1]))
    return results


def ffn_checks(torch, timer, rows):
    """Fused gated FFN at the slice shape (d 5120, d_ff 25600, bf 32,
    half the 32x32 tiles of w1/w3/w2 pruned)."""
    from repro_torch.kernels.sasp_gemm import fused_ffn, pack

    (d, F), b = FFN_SHAPE, BLOCK
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(2)

    def pruned(shape, scale):
        w = torch.randn(shape, generator=gen, device=DEVICE) * scale
        m = torch.rand((shape[0] // b, shape[1] // b), generator=gen,
                       device=DEVICE) > SPARSITY
        return (w * m.repeat_interleave(b, 0).repeat_interleave(b, 1)
                ).cpu().numpy()

    w1, w3, w2 = pruned((d, F), 0.02), pruned((d, F), 0.02), \
        pruned((F, d), 0.02)
    results = []
    for variant, quant in (("fp", False), ("int8", True)):
        w1v, w3v, w2v, b1, b3, b2, sc = pack.build_fused_ffn(
            w1, w3, w2, block_f=b, quantize=quant)
        nv = w1v.shape[0]
        bs = [torch.from_numpy(a).to(DEVICE) for a in (b1, b3, b2)]
        st = None if sc is None else tuple(torch.from_numpy(s).to(DEVICE)
                                           for s in sc)
        for xdt in ("float32", "bfloat16"):
            ws = [torch.from_numpy(a).to(DEVICE) for a in (w1v, w3v, w2v)]
            if not quant:
                ws = [a.to(getattr(torch, xdt)) for a in ws]
            # x@W1v and x@W3v run in x's type; h@W2v too, except that
            # the int8 variant keeps h in fp32
            down = "float32" if quant else xdt
            for M in rows:
                x = torch.randn((M, d), generator=gen, device=DEVICE
                                ).to(getattr(torch, xdt))
                got = fused_ffn.fused_ffn(x, *ws, *bs, act="silu",
                                          scales=st)
                want = fused_ffn.fused_ffn_plain(x, *ws, *bs, act="silu",
                                                 scales=st)
                torch.cuda.synchronize()
                err = rel_err(got, want)
                tol = 1e-4 if xdt == "float32" else 1e-2
                check(err <= tol, f"sasp_fused_ffn {variant} {xdt} M={M}: "
                      f"error {err:.3g} > {tol}")
                k_ms = timer.ms(lambda: fused_ffn.fused_ffn(
                    x, *ws, *bs, act="silu", scales=st))
                p_ms = timer.ms(lambda: fused_ffn.fused_ffn_plain(
                    x, *ws, *bs, act="silu", scales=st), reps=3)
                n_b = nbytes(x, *ws, *bs, got, *(st or ()))
                flops = 2.0 * M * d * b * nv
                b_ms, b_by = bound_ms(n_b, [(2 * flops, xdt), (flops, down)])
                results.append(dict(
                    variant=variant, x=xdt, w=str(ws[0].dtype)[6:], M=M,
                    nv=nv, rel_err=err, max_abs_err=float(
                        (got.float() - want.float()).abs().max()),
                    tol=tol, ms=k_ms, plain_ms=p_ms, library_ms=None,
                    bound_ms=b_ms, bound_by=b_by))
                log("  sasp_fused_ffn " + json.dumps(results[-1]))
        del ws
    return results


# ---------------------------------------------------------------------------
# phases 3-5: the port's main path
# ---------------------------------------------------------------------------


def spread_output_scales(params, cfg):
    """Smoke-only weights: wo and w2 times sqrt(2 L), which puts every
    projection at 0.02. With the reference's init (wo and w2 at
    0.02 / sqrt(2 L)) tile L1 separates by scale so sharply that 50%
    global pruning removes every tile of wo and w2 first, and the kernels
    would run on empty visit lists."""
    f = max(1.0, (2 * cfg.num_layers) ** 0.5)
    for seg in params["segments"]:
        for slot in seg.values():
            slot["mixer"]["wo"]["w"].mul_(f)
            slot["ffn"]["w2"]["w"].mul_(f)
    return params


def main_config(layers: int, compute: str):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("qwen3-32b"), num_layers=layers,
                               compute_dtype=compute)


def serve_phase(torch, counters):
    from repro_torch.launch.serve import build_serving_params, \
        synthetic_requests
    from repro_torch.models import lm
    from repro_torch.serve.engine import Engine

    cfg = main_config(N_LAYERS, "bfloat16")
    log(f"  qwen3-32b at full width: d_model {cfg.d_model}, heads "
        f"{cfg.num_heads}/{cfg.num_kv_heads}, head_dim {cfg.head_dim}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; depth cut 64 -> "
        f"{cfg.num_layers} layers (64 layers of fp32 master weights are "
        f"about 128 GB, more than one 80 GB card holds)")
    t0 = time.time()
    params, cfg = build_serving_params(
        spread_output_scales(lm.init_params(cfg, seed=0, device=DEVICE), cfg),
        cfg, path="packed", sparsity=SPARSITY, scope="all")
    torch.cuda.synchronize()
    slot = params["segments"][0]["slot0"]
    kept = {}
    for n, pw in slot["mixer"]["sasp_packed"].items():
        blocks = (pw.shape[0] // pw.block[0]) * (pw.shape[1] // pw.block[1])
        kept[n] = f"{pw.nnz}/{blocks}"
    pf = slot["ffn"]["sasp_fused"]
    log(f"  visits per layer (padded nnz / blocks): {kept}, fused FFN "
        f"nv {pf.nv}/{pf.d_ff // pf.block_f}; wo and w2 rescaled to "
        f"0.02 like every other projection")
    log(f"  init + prune + pack: {time.time() - t0:.1f} s, device memory "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB")
    reqs = synthetic_requests(4, cfg.vocab_size, 16)
    # The first launch of each PyTorch kernel in a process loads its
    # module. One untimed run of the same prompts (prefill + one decode
    # step) keeps that out of the timed prefill; it is reported apart.
    t = time.perf_counter()
    Engine(params, cfg, batch_slots=4, cache_len=256).run(
        synthetic_requests(4, cfg.vocab_size, 2))
    torch.cuda.synchronize()
    cold_ms = (time.perf_counter() - t) * 1e3
    log(f"  cold start (untimed run of the same prompts, prefill + one "
        f"decode step): {cold_ms:.1f} ms")
    eng = Engine(params, cfg, batch_slots=4, cache_len=256)
    for r in reqs:
        eng.submit(r)
    for c in counters:
        setattr(c, "launches", 0)
    step_ms, done = [], []
    while len(done) < len(reqs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        done += eng.step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
    launches = {c.__name__.rsplit(".", 1)[-1]: c.launches for c in counters}
    decode_ms = sum(step_ms[1:]) / max(1, len(step_ms) - 1)
    prefill_ms = step_ms[0] - decode_ms
    toks = sum(len(r.out_tokens) for r in done)
    tok_s = toks / (sum(step_ms) / 1e3)
    M_prefill = len(reqs) * max(len(r.prompt) for r in reqs)
    log(f"  served {len(done)} requests, {toks} tokens in "
        f"{len(step_ms)} steps: prefill {prefill_ms:.1f} ms "
        f"({M_prefill} padded rows), decode {decode_ms:.2f} ms/step "
        f"(4 tokens), {tok_s:.1f} tok/s; launches {launches}")
    check(len(done) == 4 and all(len(r.out_tokens) == 16 for r in done),
          "not every request produced its 16 tokens")
    check(all(0 <= t < cfg.vocab_size for r in done for t in r.out_tokens),
          "token id out of the vocabulary")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} never launched on the main path")
    for r in sorted(done, key=lambda r: r.rid):
        log(f"  req {r.rid}: prompt[{len(r.prompt)}] -> {r.out_tokens}")
    return params, cfg, launches, dict(prefill_ms=prefill_ms,
                                       decode_ms_per_step=decode_ms,
                                       tok_s=tok_s, prefill_rows=M_prefill,
                                       cold_start_ms=cold_ms)


def _profiled(torch, step, n: int, name: str):
    """Device time by kernel over ``n`` calls of ``step`` under
    torch.profiler, and the share of the wall time the device was busy
    (sum of kernel self times; kernels of one stream do not overlap).
    The trace goes to build/chip_smoke/<name>_trace.json."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or \
            getattr(e, "self_cuda_time_total", 0)

    events = [e for e in prof.key_averages()
              if "CUDA" in str(getattr(e, "device_type", "")) and dev_us(e)]
    busy_us = sum(dev_us(e) for e in events)
    os.makedirs(OUT_DIR, exist_ok=True)
    prof.export_chrome_trace(os.path.join(OUT_DIR, f"{name}_trace.json"))
    if not events:
        log(f"  {name}: device time not measured (the profiler saw no "
            f"device activity)")
        return dict(wall_ms_per_step=wall_us / n / 1e3, busy_share=None,
                    kernels=[])
    log(f"  {name}, {n} step(s): {wall_us / n / 1e3:.2f} ms/step wall, "
        f"device busy {busy_us / n / 1e3:.2f} ms/step "
        f"({busy_us / wall_us:.1%} of wall)")
    rows = []
    for e in sorted(events, key=dev_us, reverse=True)[:12]:
        rows.append(dict(name=e.key[:90], calls=e.count,
                         ms_per_step=dev_us(e) / n / 1e3))
        log(f"    {dev_us(e) / n / 1e3:8.3f} ms/step  {e.count / n:6.1f} "
            f"calls/step  {e.key[:90]}")
    return dict(wall_ms_per_step=wall_us / n / 1e3,
                busy_ms_per_step=busy_us / n / 1e3,
                busy_share=busy_us / wall_us, kernels=rows)


def profile_phase(torch, params, cfg):
    """The main path's model (4 slots) under torch.profiler: the
    admission step (left-padded prefill of 4 prompts, then the first
    decode step), then three decode steps."""
    from repro_torch.launch.serve import synthetic_requests
    from repro_torch.serve.engine import Engine

    eng = Engine(params, cfg, batch_slots=4, cache_len=256)
    for r in synthetic_requests(4, cfg.vocab_size, 8):
        eng.submit(r)
    torch.cuda.synchronize()
    return dict(prefill=_profiled(torch, eng.step, 1, "prefill"),
                decode=_profiled(torch, eng.step, 3, "decode"))


def parity_phase(torch, params):
    """fp32 compute: packed vs masked on the main path's pruned weights."""
    from repro_torch.core.deploy import deploy_packed, strip_packed
    from repro_torch.models import lm

    cfg = main_config(N_LAYERS, "float32")
    dense = strip_packed(params)
    masked_cfg = dataclasses.replace(cfg, sasp=dataclasses.replace(
        cfg.sasp, enabled=True, block_k=32, block_n=32, sparsity=SPARSITY,
        scope="all", path="masked"))
    t0 = time.time()
    packed, pcfg = deploy_packed(dense, masked_cfg)
    log(f"  fp32 re-pack: {time.time() - t0:.1f} s")
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (2, 24), generator=gen,
                         device=DEVICE)
    with torch.no_grad():
        lg_m, c_m = lm.prefill(dense, masked_cfg, toks, cache_len=32)
        lg_p, c_p = lm.prefill(packed, pcfg, toks, cache_len=32)
        nxt = torch.argmax(lg_m[:, 0], dim=-1, keepdim=True)
        pos = torch.full((2,), 24, dtype=torch.int32, device=DEVICE)
        d_m, _ = lm.decode_step(dense, masked_cfg, nxt, pos, c_m)
        d_p, _ = lm.decode_step(packed, pcfg, nxt, pos, c_p)
    e_pre, e_dec = rel_err(lg_p, lg_m), rel_err(d_p, d_m)
    log(f"  packed vs masked (fp32, TF32 off): prefill rel err {e_pre:.3g}, "
        f"decode rel err {e_dec:.3g} (tolerance 1e-4 of the logit scale)")
    check(e_pre < 1e-4 and e_dec < 1e-4, "packed path disagrees with masked")
    check(bool(torch.isfinite(lg_p).all() and torch.isfinite(d_p).all()),
          "non-finite logits")
    return dict(prefill_rel_err=e_pre, decode_rel_err=e_dec)


def int8_phase(torch, counters):
    from repro_torch.core.deploy import strip_packed
    from repro_torch.launch.serve import build_serving_params
    from repro_torch.models import lm

    cfg = main_config(1, "float32")
    params, pcfg = build_serving_params(
        spread_output_scales(lm.init_params(cfg, seed=1, device=DEVICE), cfg),
        cfg, path="packed", sparsity=SPARSITY, scope="all",
        int8_weights=True, verbose=False)
    dense = strip_packed(params)
    mcfg = dataclasses.replace(pcfg, sasp=dataclasses.replace(
        pcfg.sasp, path="masked", quantize=False))
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(4)
    toks = torch.randint(0, cfg.vocab_size, (1, 16), generator=gen,
                         device=DEVICE)
    for c in counters:
        setattr(c, "launches", 0)
    with torch.no_grad():
        got = lm.forward(params, pcfg, toks)
        launches = {c.__name__.rsplit(".", 1)[-1]: c.launches
                    for c in counters}
        ref = lm.forward(dense, mcfg, toks)
    err = rel_err(got, ref)
    log(f"  int8 packed vs fp32 masked, 1 layer: rel err {err:.3g} "
        f"(bound 5e-2); int8 launches {launches}")
    check(err < 5e-2, "int8 path outside the 5e-2 bound")
    for name, n in launches.items():
        check(n > 0, f"int8 variant of {name} never launched")
    return dict(rel_err=err, launches=launches)


def kernels_line(gemm_res, ffn_res, launches):
    """One entry per kernel, read at its most frequent main-path launch:
    a decode step (4 rows, bf16), for sasp_gemm at wq's shape."""
    def pick(res):
        return next(r for r in res if r["variant"] == "fp"
                    and r["x"] == "bfloat16" and r["M"] == 4
                    and r.get("proj") in (None, "wq"))
    out = []
    for name, res, src, repl in (
            ("sasp_gemm", gemm_res,
             "src/repro_torch/kernels/csrc/sasp_gemm.cu",
             "src/repro/kernels/sasp_gemm/kernel.py:142"),
            ("sasp_fused_ffn", ffn_res,
             "src/repro_torch/kernels/csrc/fused_ffn.cu",
             "src/repro/kernels/sasp_gemm/kernel.py:254")):
        r = pick(res)
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": repl, "launches": launches[
                        "gemm" if name == "sasp_gemm" else "fused_ffn"],
                    "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                    "bound_by": r["bound_by"],
                    "library_ms": r["library_ms"]})
    return {"kernels": out}


def main() -> int:
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke.py: src/repro_torch not found beside this script "
              "(run it from a checkout of the repository)", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import build
    from repro_torch.kernels.sasp_gemm import fused_ffn, gemm

    t_start = time.time()
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    log("[1] build")
    t0 = time.time()
    libs = build.build_all()
    for name, path in libs.items():
        log(f"  {name}: {os.path.relpath(path, ROOT)}")
        for line in build.BUILD_LOG.get(name, "").splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"    {line.strip()}")
    log(f"  built in {time.time() - t0:.1f} s")

    from repro_torch.launch.serve import synthetic_requests
    reqs = synthetic_requests(4, 151_936, 16)
    rows = [4, len(reqs) * max(len(r.prompt) for r in reqs)]
    timer = Timer(torch)
    log(f"[2] kernels vs plain versions (rows {rows}; tolerance: 1e-4 of "
        f"the output scale with fp32 activations, 1e-2 with bf16)")
    gemm_res = gemm_checks(torch, timer, rows)
    ffn_res = ffn_checks(torch, timer, rows)
    del timer
    torch.cuda.empty_cache()

    log("[3] serve: packed qwen3-32b, bf16, 4 layers")
    counters = (gemm, fused_ffn)
    params, cfg, launches, e2e = serve_phase(torch, counters)

    log("[4] profile: the prefill step and 3 decode steps under "
        "torch.profiler")
    prof = profile_phase(torch, params, cfg)

    log("[5] parity: packed vs masked, fp32")
    parity = parity_phase(torch, params)
    del params
    torch.cuda.empty_cache()

    log("[6] int8 weights, 1 layer")
    int8 = int8_phase(torch, counters)

    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w",
              encoding="utf-8") as fh:
        json.dump(dict(card=card, gemm=gemm_res, fused_ffn=ffn_res,
                       serve=e2e, launches=launches, profile=prof,
                       parity=parity,
                       int8=int8, seconds=time.time() - t_start), fh,
                  indent=1)
    log(f"total {time.time() - t_start:.1f} s")
    print(card)
    print(json.dumps(kernels_line(gemm_res, ffn_res, launches)))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
