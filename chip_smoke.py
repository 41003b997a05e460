#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # all phases, one card

Phases, each reported on its own lines; any failure exits non-zero:
  1. build    — compile every CUDA kernel from src/repro_torch/kernels/csrc
                with nvcc for sm_90a (one nvcc per source, in parallel).
  2. kernels  — every kernel variant against its plain PyTorch version on
                the card, at the shapes of the main path (qwen3-32b width:
                the tile-skip GEMM at all five projection shapes, wq
                5120->8192, wk/wv 5120->1024, wo 8192->5120, w1/w3
                5120->25600, w2 25600->5120, and the 5120/25600 gated
                FFN, decode and prefill rows, fp32 and bf16), with
                kernel / plain / library times, the least time the card
                could take (bound) and the variant that ran (tensor-core
                "mma" or fp32 "fma", read from the wrapper's per-variant
                launch counts). Then the three
                ablation kernels: the masked-grid GEMM (timed beside the
                tile-skip GEMM over BSR on the same weights and mask: the
                paper's skip-vs-predicate contrast) and the dense int8
                GEMM at every projection shape (w1/w3 5120->25600, w2
                25600->5120 too), and flash attention at 64/8 heads,
                head_dim 128, batch 4 (42 and 256 causal, 1 query against
                256 and against 4096 keys, 4096 causal, 4096 with window
                1024). Also the new shapes of phase 9's tp=8 shards: a
                wk/wv col shard 5120->128 (its visit groups from the
                whole wk's grid), a wo row shard 1024->5120 and a fused
                FFN d_ff shard 3200 wide. Every bf16 case of the int8
                GEMM and of flash attention must run the tensor-core
                variant, every masked grid case the variant its plan
                names (bf16 "tma", fp32 "fma"), and a masked grid decode
                call may not take less than reading its dense weight
                (dense_w_read_ms).
  3. serve    — the main path: qwen3-32b at full width, depth cut to 4
                layers, random weights from seed 0 (wo and w2 rescaled
                to the 0.02 of the other projections), pruned to 50% tiles
                (scope all), packed, bf16 compute, Engine(4 slots,
                cache 256) serving 4 requests of 16 new tokens, after
                one untimed run of the same prompts (the cold start).
                Both kernels must launch on it, in bf16 on their
                tensor-core variants.
  3b. paths   — (run after 5, once the packed model is freed) the other
                serving paths at full width, bf16, the packed phase's seed
                and rescaling, the same 4 requests: kernel (BSR through
                the tile-skip GEMM, repacked per call; scope all, 4
                layers), bsr (gathered block matmul, plain torch; scope
                all, 2 layers) and masked with int8 weights (scope ffn, 2
                layers). The kernel path must launch the tile-skip GEMM.
  3c. paged   — the same packed model (4 layers, bf16, cache 256) served
                from the paged KV pool (tile-aligned 32-token pages, 8 a
                ring): (a) phase 3's 4 requests with pages for every
                slot, streams and the logits of every step bit for bit
                equal to the contiguous engine's; (b) 8 requests sharing a
                96-token prefix (3 full pages) plus distinct suffixes
                through 4 slots with prefix sharing, an 18-page pool and a
                host spill pool, one request preempted with its pages
                kept (it spills and faults back); (c) run (b) with an int8
                drafter at 75% tile sparsity, draft_k 4; (d) run (b) with
                a bf16 drafter at the target's own 50% (the same weights,
                so drafts are accepted). (b), (c) and (d) hold
                their greedy streams to the contiguous engine's on the
                same requests (a divergence passes only where the
                contiguous run's top-2 logit margin at that token is under
                1e-2 of the logit scale, and is printed), run the
                allocator's check() after every step and leak no page.
                Times beside the contiguous runs; launches by kernel,
                variant and weight type (the drafter's int8 forms apart).
                At (c)'s and (d)'s first near-tie (or token 1 of a
                request, if none) the step is run both ways from the
                same KV, sequential decode (1 row) and the verify pass
                (k+1 rows), and the first op whose bits differ is
                printed (projections, attention output, norms, FFN,
                final norm, lm-head).
  3d. sched   — the same packed model (4 layers, bf16, cache 256) behind
                the serving tier: (a) ShardedScheduler(2 ranks x 4
                slots, one params tree), EDF, aging 0.05, preemption (KV
                kept), 16 of the launcher's prompts, every second one
                interactive with 8 new tokens (submitted after two
                steps, so they preempt), the others batch with 16, one
                batch request with an EOS that fires mid-decode; run
                traced and untraced (streams and every decode step's
                logits bit for bit equal), then the drain baseline (more
                decode steps); (b) (a) with rank 0's 4th Engine.step
                raising: every request completes on rank 1, then
                revive_rank(0) serves one more; (c) ClusterFrontend over
                2 in-process hosts (1 rank, paged sharing pools of 18 +
                8 host pages) on 3c (b)'s 8 requests, chaos
                kill:0@4,seed:3, retries 2: no token twice, drain clean,
                pools checked, the Chrome trace written to
                build/chip_smoke/frontend_trace.json and read back; (d)
                2 host_worker processes (packed, full width, 1 layer)
                serving 6 requests, host 0 SIGKILLed mid-load. Every run
                is held to each request alone through
                Engine(batch_slots=1) (3c's near-tie rule); (c) to an
                undisturbed 1-host run and (d) to a 1-worker run too.
                Prints tok/s, decode ms/step per rank, TTFT p50/p95 per
                class, deadline attainment, preemptions, refills,
                requeues, retries, the scheduler's own host ms per step
                and launches by kernel and variant.
  4. profile  — the prefill step and three decode steps of the same
                model under torch.profiler: device time by kernel and
                the device's busy share of the wall time (traces in
                build/chip_smoke/).
  5. parity   — fp32 packed vs masked and kernel vs masked (plain
                matmuls on the same pruned weights): prefill logits and
                the first decode step.
  5b. ablation path — the three ablation kernels through their entry
                points (masked_matmul, int8_matmul, mha) on one fp32 layer
                of the served model: its pruned w1 and mask, the int8 w1
                the masked int8 path holds, and layer 0's q/k/v of a causal
                prefill; held against the served paths' own products
                (torch.matmul, dequantize + torch.matmul, attend_chunked).
                All three run again on the same tensors in bf16, the
                served model's compute type (tensor-core variants: the
                masked grid's TMA-fed "tma", the others' "mma"; tolerance
                1e-2); each must run both its variants here. These calls
                are those kernels' path: their launches are counted here.
                Also sasp_matmul over the layer's BSR.
  6. int8     — --int8-weights at full width, 1 layer: both int8 kernel
                variants on the path, within 5e-2 of the fp32 masked model.
  7. train    — (last, once every serving model is freed) (a) qwen3-32b at
                full width, 4 layers, fp32 master weights, bf16 compute,
                every layer recomputed in backward, the SASP overlay at 50%
                of the 32x32 FFN tiles (built at step 0, as
                launch/train.py builds it), AdamW 3e-4 under
                warmup_cosine(3, 20), lm_batch 4 x 256: 20 timed steps
                after one untimed, each as the train step's two halves
                (forward + backward and optimizer ms with CUDA events, the
                host time a step waits for its batch), then 3 steps of
                make_train_step (step ms, tokens/s, model utilization),
                peak GiB, and one step under torch.profiler; the loss
                finite at every step and falling, every pruned tile's
                gradient exactly 0 at each of the 21 split steps, the
                overlay within one tile of 50%. (b) 1
                full-width layer with int8 moments: 6 steps, save_async at
                step 3 (the stall, the write's seconds and bytes),
                restore into a fresh state and run steps 4-6 again
                (losses and params within 1e-3 of the uninterrupted
                run's); the checkpoint served packed (50%, scope all,
                bf16) through the serve launcher's --ckpt-dir code path,
                both main-path kernels on their tensor-core variants, and
                phase 5's fp32 packed-vs-masked check on these weights;
                the files under build/chip_smoke/train_ckpt are removed
                after. (c) one train step on the card against the CPU,
                fp32, 2 layers, d 256, with 1 and 2 micro-batches.
  8. families — (after 7) the other layer kinds, each part served like
                phase 3 (the launcher's 4 prompts, 16 new tokens,
                Engine(4 slots, cache 256), one untimed run first;
                prefill ms, decode ms/step, tok/s, peak GiB, launches by
                kernel and variant): (a) moonshot-v1-16b-a3b at full width
                (d_model 2048, 16/16 heads of 128, 64 experts top 6,
                capacity 1.25, d_ff 1408, vocab 163840), depth cut from 48
                to 8 layers (4.9 B parameters; 48 layers of fp32 masters
                are 108 GB), random weights from seed 0, output
                projections spread as in phase 3, 50% of the 32x32 tiles
                pruned with scope all, packed, bf16: the tile-skip GEMM on
                mma, 4 projections x 8 layers a forward; a second run
                gives the same streams and decode logits bit for bit (MoE
                capacity is shared by a step's rows, so no solo run is an
                oracle); fp32 packed vs masked at 2 layers (1e-4 of the
                logit scale). (b) mamba2-780m whole (48 layers, d_model
                1536, 48 heads of 64, state 128, chunk 256, vocab 50280),
                50% scope all, nothing packs (the SSM serves masked-dense),
                bf16, per-request prefill, one request preempted with its
                KV kept and one with it dropped: streams greedy-equal to
                each request alone (phase 3c's near-tie rule); fp32 at 2
                layers, prefill 16 tokens and decode 8 against the forward
                (5e-3, the reference's bound). (c) jamba-1.5-large's
                hybrid super-block, reduced to 8 layers at d_model 1024,
                vocab 65536 (7 mamba + 1 attention layer, MoE of 4 experts
                top 2 on odd layers, dense FFNs on even ones), weights and
                compute bf16: both main-path kernels on mma, the (a)
                determinism check, fp32 packed vs masked (1e-4). (d) one
                train step card vs CPU as 7 (c), loss and aux loss too,
                on reduced granite-moe-1b-a400m and jamba (4 layers, d
                256).
  9. tp       — tensor-parallel packed serving of phase 3's model (seed
                0, output projections spread, 50% of the 32x32 tiles,
                scope all, bf16, 4 layers, the same 4 requests of 16
                tokens): (a) (after phase 5, on phase 3's served tree)
                the shard loop on one card, ``reshard_packed`` to tp 2,
                4 and 8:
                every layer's wq / wk / wv col-shard outputs bit for bit
                their columns of the unsharded kernel (decode and
                prefill rows), launches tp times tp=1's (16·tp tile-skip
                GEMMs and 4·tp fused FFNs a forward, all mma), streams
                greedy-equal to tp=1 (3c's near-tie rule), decode ms/step
                and container GiB beside tp=1; (b) ``--mesh 1,2``
                through the serve launcher's ``serve_mesh`` with this
                script's rank function (``_mesh_rank``): 2 spawned ranks
                over gloo (host-staged when they share a card), each
                building its tree layer by layer from the seed with the
                launcher's ``build_rank_params`` (wo and w2 spread as
                drawn); contiguous then paged, every rank's streams and
                every decode step's logits bit for bit (a)'s tp=2 (last,
                every earlier model freed); half (a)'s launches a rank;
                rs+int8-ag
                within 2e-2 of the exact reduction; transport, per-rank
                GiB (building, serving) and decode ms/step printed;
                again over NCCL where
                the machine has a card per rank, else ``nccl: not run``.
                ``tools/tp_phase.py`` runs it alone.
  10. depth   — (last, every earlier model freed) qwen3-32b at full width
                and all 64 layers (seed 0, wo and w2 spread as drawn, 50%
                of the 32x32 tiles, scope all, bf16, phase 3's 4 requests
                of 16 tokens on Engine(4 slots, cache 256)), every tree
                built layer by layer (``build_rank_params``: each layer
                drawn alone, scored; drawn again, pruned, packed, cut and
                cast): (a) one card at tp 1, the launcher's packed build:
                build s, peak GiB building, GiB held serving, prefill ms,
                decode ms/step; 256 tile-skip GEMMs and 64 fused FFNs a
                forward, all mma; the first prefill again through the
                plain versions of both kernels (logit error printed,
                greedy tokens equal but at printed near-ties); (b) the
                shard loop at tp 2 (every shard, the table split into 2
                vocab shards) on this card, then ``--mesh 1,2`` through
                ``serve_mesh`` (2 ranks sharing the card over gloo,
                host-staged; each builds its own shard and V/2 table
                rows): every rank's streams and every decode step's
                logits bit for bit the loop's; a rank's build s, held and
                peak GiB; (c) ``--mesh 1,4`` over NCCL where the machine
                has a card per rank, else ``nccl: not run``; (d) phase
                3's model cut to 2 layers, saved by the port's
                ``CheckpointManager``, restored through ``--mesh 1,2
                --ckpt-dir --stream --trace-out --metrics-dump`` by the
                launcher's ``serve_rank`` (each rank reading one layer at
                a time): streams equal the shard loop's tp 2 built from
                the whole restore; (e) one trace and one Prometheus text
                (every engine counter), both written by rank 0.
                ``tools/depth_phase.py`` runs it alone.
  11-14.      — dp, mesh paths, families on a mesh, training on a mesh
                (each phase's function and its ``tools/*_phase.py``
                describe it).
  15. analysis — (last, every earlier model freed) (a) FlopCounterMode
                over one full-width qwen3-32b layer's forward (dense,
                bf16, phase 3's prompts left-padded) within 0.65-1.55 of
                ``analysis.counters``; (b) the H100 roofline
                (``core/h100_model.py``) of phase 3's decode step and
                prefill beside their measured times, at most 1.05 of
                them; (c) phase 14 (a)'s configuration traced on a dry
                1,2 mesh (``launch/dryrun.py::trace_step``): a rank's
                held GiB within 10% of (a)'s measured, peak printed with
                its ratio, the step's collective record equal to the real
                rank's; (d) phase 3's packed model at 2 layers served by
                the shard loop at tp 8 and 16 (16: every KV head on every
                shard), greedy-equal to tp 1 up to printed near-ties; the
                card's ``total_memory`` equal to
                ``h100_model.HBM_BYTES``. ``tools/analysis_phase.py`` runs
                it alone.
  16. family train — (last) MoE, SSM and hybrid families trained on a
                (data, model) mesh: (a) moonshot-v1-16b-a3b at full
                width (1 layer; fp32 masters, bf16 compute, remat full,
                the 50% FFN overlay on the expert stacks too, batch 4 x
                256, 3 steps) on ``--mesh 2,2`` (4 gloo processes on this
                card, host-staged; experts in EP over 'data', their d_ff
                over 'model'), held to the meshless loop at the same
                shard counts run first (step 1's loss bit for bit, later
                losses and aux 1e-3, gradient slices 5e-2, params after
                step 1 within 2.5 lr); (b) jamba's reduced stack (8
                layers, d 256, attention / SSM / MoE / dense-FFN slots)
                on 2,2 and mamba2's (4 layers) on 1,2 at widths whose SSD
                gradients are finite (asserted), each its loop's within
                1e-5; (c) (a)'s checkpoint served packed on one card
                (its sasp_gemm launches join the ``kernels`` line); (d)
                four NCCL cards: moonshot, 8 layers, on 2,2 and 4,1.
                ``tools/train_family_mesh_phase.py`` runs it alone.
  17. pod train — (last) training on a (pod, data, model) mesh: (a)
                phase 16 (a)'s moonshot (1 layer: 8 ranks of 2 layers
                do not fit the card) on ``--mesh 2,2,2`` (8 gloo
                processes on this card; experts in EP over each pod's
                'data' ranks, a replica in each pod), held to the
                lock-step loop over the 4 DP groups with phase 16's
                bounds, both pods' params and moments equal after every
                step (every leaf's bit-pattern sums); (b) phase 14 (b)'s
                narrow qwen3 on 2,2,2 (fp32 moments with 2 micro-batches;
                int8 moments) and 2,1,2, each its loop's within 1e-5, the
                2,1,2 checkpoint resumed bit for bit; (c) (b)'s
                checkpoint served packed on one card (its sasp_gemm and
                sasp_fused_ffn launches join the ``kernels`` line); (d)
                (a)'s MoE step traced on a dry 2,2,2 mesh at ranks 0 and
                7 (expert parallelism declared even, no host read;
                record equal to the real rank's, held GiB within 10% of
                (a)'s) and (b)'s step traced there (record equal to the
                real rank's); (e) four NCCL cards: moonshot, 8 layers, on
                2,2,1. ``tools/pod_mesh_phase.py`` runs it alone.
  18. seq mesh — (last) the reference's long-context layout on a mesh,
                one slot (the batch does not split over 'data'): (a)
                gemma3-4b at full width, 6 layers (5 windowed, 1 global),
                50% of the tiles packed (scope all), bf16, cache 32768, a
                512-token prompt and 16 new tokens, on ``--mesh 2,1`` (2
                gloo processes on this card): each ring's capacity cut
                over 'data'; (b) moonshot-v1-16b-a3b at full width, 1
                layer, on ``--mesh 2,1``: experts cut 32 / 32, the
                replicated MoE mode with no ``_Infos`` gather; (c) gemma3
                at d_model 512 with one KV head on ``--mesh 1,2``: rings
                cut over 'model'. Every process bit for bit its meshless
                twin (``Engine(data_shards=D, seq_split=True)``: streams,
                every decode step's logits), its KV (and expert) bytes
                the whole model's over the cut, three collectives an
                attention layer a decode step in ``Mesh.record``; (a)'s
                twin within 2e-2 of the logit scale of the one-card
                engine. ``tools/seq_mesh_phase.py`` runs it alone, and
                with four cards gemma3-4b at full depth with the
                long_500k ring on 4,1 and 2,2 and jamba's block on 4,1.
  19. paged mesh — (last) the paged KV pool cut over 'data' as the
                reference places it (``sharding.pool_axes``) and a MoE
                drafter on a mesh, on ``--mesh 2,1`` (2 gloo processes on
                this card): (a) qwen3-32b at full width, 1 layer, and (b)
                moonshot-v1-16b-a3b at full width, 1 layer (its experts
                and its drafter's in EP over 'data'), 50% of the tiles
                packed (scope all), bf16, a drafter at 75% (draft_k 3),
                Engine(4 slots, cache 256, kv_pages 30 of 32 tokens: P =
                32, 16 a data rank), prefix sharing, 3c (b)'s first 4
                requests submitted one a step. Every process bit for bit
                its meshless twin (``Engine(data_shards=2)``: streams,
                every decode step's logits, speculation and prefix
                counters), its pool half the whole pool's bytes (two
                local reserved pages more on data rank 1), no broadcast
                over 'data' in ``Mesh.record``; each twin's first prefill
                through both kernels within 1e-2 of their plain
                versions'. ``tools/paged_mesh_phase.py`` runs it alone,
                and with four cards qwen3-32b at 16 layers with an 8 GiB
                pool on 4,1 and 2,2 against one card.
  20. analyze — (last, in this process) the port's static analyzer
                (``tools/analyze_torch``): every pass, the packed pass's
                deployments on this card, under ``--strict`` against its
                ``baseline.json``; ``validate_params_tree`` over phase
                3's full-width packed containers on the card (run as
                soon as phase 3 has built them, while they are held);
                ``check_page_refcounts`` on phase 3c's paged engines
                after their runs and on phase 19's cut pools (every
                block, in the twin and in each rank's process). One line
                gives its seconds and the findings by rule; a finding
                outside the baseline, a container error or a page error
                fails the run.
The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.

Needs only this checkout (it imports ``repro_torch`` from ``src/``), a
CUDA card and nvcc; it never imports jax or the ``repro`` package.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
# full results (chip_smoke.json) and profiler traces; gitignored
OUT_DIR = os.path.join(ROOT, "build", "chip_smoke")


def h100():
    """The card's peaks (bytes/s, FLOP/s by type, NVIDIA data sheet,
    dense): ``repro_torch.core.h100_model``, the one source of them."""
    from repro_torch.core import h100_model
    return h100_model


N_LAYERS = 4
SPARSITY = 0.5
DEVICE = "cuda"
# slice shapes at qwen3-32b width, 32x32 tiles: the attention projections
# (K, N) (wk and wv share one shape) and the gated FFN (d, d_ff)
GEMM_SHAPES = (("wq", 5120, 8192), ("wk/wv", 5120, 1024),
               ("wo", 8192, 5120))
# every projection of the layer (wk and wv, w1 and w3 share a shape)
PROJ_SHAPES = GEMM_SHAPES + (("w1/w3", 5120, 25600), ("w2", 25600, 5120))
FFN_SHAPE = (5120, 25600)
# new shapes of phase 9's shards at tp 8: a wk/wv col shard (4 column
# blocks; its visit groups from the whole wk's 32), a wo row shard, and a
# fused FFN d_ff shard (3200 wide)
TP_SHAPES = (("wk/wv tp8 col shard", 5120, 128, 1024 // 32),
             ("wo tp8 row shard", 1024, 5120, None))
FFN_TP_SHAPE = (5120, 3200)
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
    t_bytes = n_bytes / h100().HBM_BW * 1e3
    t_ops = sum(f / h100().PEAK_FLOPS[kind] for f, kind in ops) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def rel_err(got, want) -> float:
    g, w = got.float(), want.float()
    return float((g - w).abs().max() / w.abs().max().clamp_min(1e-9))


def row_rel_err(got, want) -> float:
    """Largest error of a row of the last axis over that row's largest
    value: an attention output row averages its visible keys, so rows
    differ in scale by far more than the tolerance (a row that sees one
    key copies it; one that sees thousands is near 0). A row of zeros
    (no visible key) must come out exactly 0."""
    g, w = got.float(), want.float()
    err = (g - w).abs().amax(dim=-1)
    return float((err / w.abs().amax(dim=-1).clamp_min(1e-30)).max())


def ran_variant(mod, fn):
    """Call fn; return its result and the variant the wrapper's
    per-variant launch count shows it launched."""
    before = dict(mod.variant_launches)
    out = fn()
    ran = [k for k, n in mod.variant_launches.items() if n != before.get(k, 0)]
    check(len(ran) == 1, f"no single variant launched: {ran}")
    return out, ran[0]


def gemm_checks(torch, timer, rows):
    """Tile-skip GEMM at every projection's shape (32x32 tiles, half the
    tiles pruned), every variant, decode and prefill rows."""
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(1)
    results = []
    for shape in PROJ_SHAPES + TP_SHAPES:
        results += _gemm_checks_at(torch, timer, rows, gen, *shape)
    return results


def _gemm_checks_at(torch, timer, rows, gen, proj: str, K: int, N: int,
                    group_nb=None):
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
                got, ran = ran_variant(gemm, lambda: gemm.sasp_gemm(
                    x, v_t, kn_t, cp, N, scales=st, bias=bt, act=act,
                    group_nb=group_nb))
                want = gemm.sasp_gemm_plain(x, v_t, kn_t, N, st, bt, act)
                torch.cuda.synchronize()
                err = rel_err(got, want)
                tol = 1e-4 if xdt == "float32" else 1e-2
                check(err <= tol, f"sasp_gemm {proj} {variant} {xdt} M={M}: "
                      f"error {err:.3g} > {tol}")
                k_ms = timer.ms(lambda: gemm.sasp_gemm(
                    x, v_t, kn_t, cp, N, scales=st, bias=bt, act=act,
                    group_nb=group_nb))
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
                    w=str(v_t.dtype)[6:], M=M, ran=ran,
                    rel_err=err, max_abs_err=float(
                        (got.float() - want.float()).abs().max()),
                    tol=tol, ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
                    bound_ms=b_ms, bound_by=b_by))
                log("  sasp_gemm " + json.dumps(results[-1]))
    return results


def ffn_checks(torch, timer, rows):
    """Fused gated FFN at the slice shape (d 5120, d_ff 25600, bf 32,
    half the 32x32 tiles of w1/w3/w2 pruned), and at a tp=8 d_ff shard's
    (d_ff 3200)."""
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(2)
    return (_ffn_checks_at(torch, timer, rows, gen, FFN_SHAPE)
            + _ffn_checks_at(torch, timer, rows, gen, FFN_TP_SHAPE))


def _ffn_checks_at(torch, timer, rows, gen, shape):
    from repro_torch.kernels.sasp_gemm import fused_ffn, pack

    (d, F), b = shape, BLOCK

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
                got, ran = ran_variant(fused_ffn, lambda: fused_ffn.fused_ffn(
                    x, *ws, *bs, act="silu", scales=st))
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
                    d=d, d_ff=F, nv=nv, ran=ran, rel_err=err,
                    max_abs_err=float((got.float() - want.float()).abs()
                                      .max()),
                    tol=tol, ms=k_ms, plain_ms=p_ms, library_ms=None,
                    bound_ms=b_ms, bound_by=b_by))
                log("  sasp_fused_ffn " + json.dumps(results[-1]))
        del ws
    return results


# flash attention cases: (Sq, Sk, window); None = causal (window Sk + 1)
ATTN = dict(B=4, H=64, KH=8, D=128)
ATTN_CASES = ((42, 42, None), (256, 256, None), (1, 256, None),
              (1, 4096, None), (4096, 4096, None), (4096, 4096, 1024))


def masked_variant(M, K, N, typ):
    """The variant the masked grid's plan names for these shapes."""
    from repro_torch.kernels.sasp_gemm import schedule
    return schedule.masked_plan(M, K, N, K // BLOCK, N // BLOCK, typ,
                                typ).variant


def masked_checks(torch, timer, rows):
    """Masked-grid GEMM at every projection shape (32x32 tiles, half
    pruned), against its plain version; timed beside the tile-skip GEMM
    over the BSR of the same weights and mask (sasp_matmul, its per-call
    repack included) and a dense torch.matmul on the masked weight. Both
    kernels share one bound (the function's); ``dense_w_read_ms`` is the
    time the masked grid's design needs to read the whole dense W, and a
    decode call (M <= 16) may never take less. ``ran`` is the variant the
    wrapper's per-variant count shows (bf16: "tma", fp32: "fma"), and it
    must be the one its plan names; ``pruned_ms`` times the same call
    with every tile pruned (the bytes alone)."""
    from repro_torch.core.sparse import bsr_from_mask
    from repro_torch.kernels.sasp_gemm import gemm, masked

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(5)
    bk = bn = BLOCK
    results = []
    for proj, K, N in PROJ_SHAPES:
        w = torch.randn((K, N), generator=gen, device=DEVICE) * 0.02
        mask = torch.rand((K // bk, N // bn), generator=gen,
                          device=DEVICE) > SPARSITY
        mask_i = mask.to(torch.int32)
        no_tiles = torch.zeros_like(mask_i)
        live = int(mask.sum())
        bsr32 = bsr_from_mask(w.cpu().numpy(), mask.cpu().numpy(), bk, bn,
                              device=DEVICE)
        for xdt in ("float32", "bfloat16"):
            typ = getattr(torch, xdt)
            wt = w.to(typ)
            bsr = dataclasses.replace(bsr32, vals=bsr32.vals.to(typ))
            wd = wt * mask.repeat_interleave(bk, 0).repeat_interleave(
                bn, 1).to(typ)
            for M in rows:
                x = torch.randn((M, K), generator=gen, device=DEVICE).to(typ)
                got, ran = ran_variant(masked, lambda: masked.masked_matmul(
                    x, wt, mask_i))
                want_ran = masked_variant(M, K, N, typ)
                check(ran == want_ran, f"sasp_gemm_masked {proj} {xdt} M={M} "
                      f"ran {ran}, its plan {want_ran}")
                want = masked.sasp_gemm_masked_plain(x, wt, mask_i)
                skip = gemm.sasp_matmul(x, bsr)
                torch.cuda.synchronize()
                err = rel_err(got, want)
                tol = 1e-4 if xdt == "float32" else 1e-2
                check(err <= tol, f"sasp_gemm_masked {proj} {xdt} M={M}: "
                      f"error {err:.3g} > {tol}")
                skip_err = rel_err(skip, want)
                check(skip_err <= tol, f"sasp_matmul {proj} {xdt} M={M}: "
                      f"error {skip_err:.3g} > {tol}")
                k_ms = timer.ms(lambda: masked.masked_matmul(x, wt, mask_i))
                s_ms = timer.ms(lambda: gemm.sasp_matmul(x, bsr))
                p_ms = timer.ms(lambda: masked.sasp_gemm_masked_plain(
                    x, wt, mask_i), reps=3)
                lib_ms = timer.ms(lambda: torch.matmul(x, wd))
                # both kernels compute x @ (W * mask): the function needs
                # x, the live tiles, the mask and the output
                b_ms, b_by = bound_ms(
                    nbytes(x, mask_i, got) + live * bk * bn
                    * wt.element_size(), [(2.0 * M * bk * bn * live, xdt)])
                # what the masked grid's design reads: every byte of W
                dense_read_ms = bound_ms(nbytes(x, wt, mask_i, got), [])[0]
                if M <= 16:
                    check(k_ms >= dense_read_ms,
                          f"sasp_gemm_masked {proj} {xdt} M={M}: {k_ms:.4f} ms "
                          f"is under the dense-W read, {dense_read_ms:.4f} ms")
                # the same call with every tile pruned: the bytes moved and
                # no MMA or FMA at all
                pruned_ms = timer.ms(lambda: masked.masked_matmul(
                    x, wt, no_tiles))
                results.append(dict(
                    proj=proj, K=K, N=N, variant="fp", x=xdt, M=M, ran=ran,
                    live_tiles=live, rel_err=err, max_abs_err=float(
                        (got.float() - want.float()).abs().max()),
                    tile_skip_rel_err=skip_err,
                    tile_skip_equal=bool(torch.equal(skip, got)),
                    tol=tol, ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
                    bound_ms=b_ms, bound_by=b_by, dense_w_read_ms=dense_read_ms,
                    tile_skip_ms=s_ms, pruned_ms=pruned_ms))
                log("  sasp_gemm_masked " + json.dumps(results[-1]))
            del wd, bsr
        del w, bsr32
    return results


def int8_checks(torch, timer, rows):
    """Dense weight-only int8 GEMM (32x32 quant blocks) at every
    projection shape, against its plain version (the kernel's own
    arithmetic); the dequantize-then-matmul oracle rounds differently and
    is recorded, not bounded; library: torch.matmul on the dequantized
    weight in x's type."""
    from repro_torch.core.quantization import dequantize_int8, quantize_int8
    from repro_torch.kernels.int8_gemm import gemm as int8

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(6)
    results = []
    for proj, K, N in PROJ_SHAPES:
        qw = quantize_int8(torch.randn((K, N), generator=gen, device=DEVICE)
                           * 0.02, BLOCK, BLOCK)
        for xdt in ("float32", "bfloat16"):
            typ = getattr(torch, xdt)
            wd = dequantize_int8(qw, typ)
            for M in rows:
                x = torch.randn((M, K), generator=gen, device=DEVICE).to(typ)
                got, ran = ran_variant(int8, lambda: int8.int8_matmul(x, qw))
                check(ran == ("mma" if xdt == "bfloat16" else "fma"),
                      f"int8_gemm {proj} {xdt} M={M} ran {ran}")
                want = int8.int8_gemm_plain(x, qw.q, qw.scale)
                ref = int8.int8_gemm_ref(x, qw.q, qw.scale)
                torch.cuda.synchronize()
                err = rel_err(got, want)
                tol = 1e-4 if xdt == "float32" else 1e-2
                check(err <= tol, f"int8_gemm {proj} {xdt} M={M}: "
                      f"error {err:.3g} > {tol}")
                k_ms = timer.ms(lambda: int8.int8_matmul(x, qw))
                p_ms = timer.ms(lambda: int8.int8_gemm_plain(
                    x, qw.q, qw.scale), reps=3)
                lib_ms = timer.ms(lambda: torch.matmul(x, wd))
                b_ms, b_by = bound_ms(nbytes(x, qw.q, qw.scale, got),
                                      [(2.0 * M * K * N, xdt)])
                results.append(dict(
                    proj=proj, K=K, N=N, variant="fp", x=xdt, w="int8", M=M,
                    ran=ran, rel_err=err, ref_rel_err=rel_err(got, ref),
                    max_abs_err=float((got.float() - want.float()).abs()
                                      .max()),
                    tol=tol, ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
                    bound_ms=b_ms, bound_by=b_by))
                log("  int8_gemm " + json.dumps(results[-1]))
            del wd
        del qw
    return results


def _fold(t):
    """(B, S, H, D) -> (B·H, S, D), the kernel's layout (ops.mha)."""
    B, S, H, D = t.shape
    return t.permute(0, 2, 1, 3).reshape(B * H, S, D)


def flash_checks(torch, timer):
    """mha (flash attention with the GQA fold) against the plain online
    softmax on the same folded tensors; library:
    F.scaled_dot_product_attention with enable_gqa, is_causal for a
    square causal case, else the visibility as an explicit mask. The
    error is taken per output row (row_rel_err)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attn import kernel as flash
    from repro_torch.kernels.flash_attn.ops import mha

    B, H, KH, D = ATTN["B"], ATTN["H"], ATTN["KH"], ATTN["D"]
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(7)
    results = []
    for Sq, Sk, window in ATTN_CASES:
        win = Sk + 1 if window is None else window
        qp = torch.arange(Sk - Sq, Sk, device=DEVICE, dtype=torch.int32)
        kp = torch.arange(Sk, device=DEVICE, dtype=torch.int32)
        delta = qp[:, None] - kp[None, :]
        vis = (delta >= 0) & (delta < win)
        pairs = int(vis.sum())
        causal = Sq == Sk and window is None
        full = bool(vis.all())
        reps = 3 if Sq * Sk > 1 << 20 else 10
        for xdt in ("float32", "bfloat16"):
            typ = getattr(torch, xdt)
            q = torch.randn((B, Sq, H, D), generator=gen, device=DEVICE
                            ).to(typ)
            k = torch.randn((B, Sk, KH, D), generator=gen, device=DEVICE
                            ).to(typ)
            v = torch.randn((B, Sk, KH, D), generator=gen, device=DEVICE
                            ).to(typ)
            got, ran = ran_variant(flash, lambda: mha(q, k, v, qp, kp,
                                                      window=win))
            check(ran == ("mma" if xdt == "bfloat16" else "fma"),
                  f"flash_attention Sq={Sq} Sk={Sk} {xdt} ran {ran}")
            want = flash.flash_attention_plain(_fold(q), _fold(k), _fold(v),
                                               qp, kp, window=win)
            want = want.reshape(B, H, Sq, D).permute(0, 2, 1, 3)
            torch.cuda.synchronize()
            err = row_rel_err(got, want)
            tol = 1e-4 if xdt == "float32" else 1e-2
            check(err <= tol, f"flash_attention Sq={Sq} Sk={Sk} "
                  f"window={window} {xdt}: error {err:.3g} > {tol}")
            k_ms = timer.ms(lambda: mha(q, k, v, qp, kp, window=win), reps)
            p_ms = timer.ms(lambda: flash.flash_attention_plain(
                _fold(q), _fold(k), _fold(v), qp, kp, window=win), reps=3)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            mask = None if causal or full else vis
            lib_ms = timer.ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, is_causal=causal,
                enable_gqa=True), reps)
            b_ms, b_by = bound_ms(nbytes(q, k, v, qp, kp, got),
                                  [(4.0 * D * pairs * B * H, xdt)])
            results.append(dict(
                Sq=Sq, Sk=Sk, window=window, B=B, H=H, KH=KH, D=D, x=xdt,
                variant="fp", ran=ran, M=Sq, visible_pairs=pairs,
                row_rel_err=err,
                rel_err=rel_err(got, want),
                max_abs_err=float((got.float() - want.float()).abs().max()),
                tol=tol, ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
                bound_ms=b_ms, bound_by=b_by))
            log("  flash_attention " + json.dumps(results[-1]))
            del q, k, v, got, want
    return results


# ---------------------------------------------------------------------------
# phases 3-5: the port's main path
# ---------------------------------------------------------------------------


def spread_output_scales(params, cfg):
    """Smoke-only weights: wo and w2 times sqrt(2 L), so that 50% global
    pruning does not remove every tile of wo and w2 first (the
    ``host_worker`` spec's option of the same name)."""
    from repro_torch.serve.host_worker import spread_output_scales as f
    return f(params, cfg)


def main_config(layers: int, compute: str):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("qwen3-32b"), num_layers=layers,
                               compute_dtype=compute)


def serve_phase(torch, counters):
    from repro_torch.launch.serve import build_serving_params
    from repro_torch.models import lm

    cfg = main_config(N_LAYERS, "bfloat16")
    log(f"  qwen3-32b at full width: d_model {cfg.d_model}, heads "
        f"{cfg.num_heads}/{cfg.num_kv_heads}, head_dim {cfg.head_dim}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; depth cut 64 -> "
        f"{cfg.num_layers} layers (drawn whole: phase 10 builds all 64 "
        f"layer by layer)")
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
    launches, e2e = _serve(torch, params, cfg, counters)
    for name in MAIN_PATH:
        check(launches[name] > 0,
              f"kernel {name} never launched on the main path")
    want = {"sasp_gemm": "mma", "sasp_fused_ffn": "mma/mma"}
    for name, ran in e2e["variants"].items():
        check(set(ran) == {want[name]},
              f"{name} ran {ran} on the bf16 main path, not only "
              f"{want[name]}")
    return params, cfg, launches, e2e


def _serve(torch, params, cfg, counters):
    """Serve the launcher's 4 requests of 16 new tokens (4 slots, cache
    256) after one untimed run of the same prompts; the launch counts of
    ``counters`` are set to 0 just before the timed run and read just
    after it."""
    from repro_torch.launch.serve import synthetic_requests
    from repro_torch.serve.engine import Engine

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
    reset(counters)
    step_ms, done = [], []
    while len(done) < len(reqs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        done += eng.step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
    launches = read(counters)
    variants = {name: dict(m.variant_launches)
                for name, m in counters.items()
                if hasattr(m, "variant_launches") and m.launches}
    decode_ms = sum(step_ms[1:]) / max(1, len(step_ms) - 1)
    prefill_ms = step_ms[0] - decode_ms
    toks = sum(len(r.out_tokens) for r in done)
    tok_s = toks / (sum(step_ms) / 1e3)
    M_prefill = len(reqs) * max(len(r.prompt) for r in reqs)
    mem_gib = torch.cuda.memory_allocated() / 2**30
    log(f"  served {len(done)} requests, {toks} tokens in "
        f"{len(step_ms)} steps: prefill {prefill_ms:.1f} ms "
        f"({M_prefill} padded rows), decode {decode_ms:.2f} ms/step "
        f"(4 tokens), {tok_s:.1f} tok/s; launches {launches}, by "
        f"variant {variants} "
        f"({ {k: n / len(step_ms) for k, n in launches.items()} } per "
        f"step); device memory {mem_gib:.1f} GiB")
    check(len(done) == 4 and all(len(r.out_tokens) == 16 for r in done),
          "not every request produced its 16 tokens")
    check(all(0 <= t < cfg.vocab_size for r in done for t in r.out_tokens),
          "token id out of the vocabulary")
    for r in sorted(done, key=lambda r: r.rid):
        log(f"  req {r.rid}: prompt[{len(r.prompt)}] -> {r.out_tokens}")
    return launches, dict(prefill_ms=prefill_ms, decode_ms_per_step=decode_ms,
                          tok_s=tok_s, prefill_rows=M_prefill,
                          cold_start_ms=cold_ms, steps=len(step_ms),
                          device_memory_gib=mem_gib, variants=variants,
                          streams={r.rid: r.out_tokens for r in done})


# ---------------------------------------------------------------------------
# phase 3c: the paged KV pool, prefix sharing, preemption, speculation
# ---------------------------------------------------------------------------

PAGED = dict(cache_len=256, shared_pages=18, host_pages=8, prefix=96,
             n_shared=8, draft_sparsity=0.75, draft_k=4, preempt_at=3)


def shared_prefix_requests(vocab: int):
    """Run (b)'s 8 requests: one 96-token prefix (3 full 32-token pages)
    and a distinct 8-31-token suffix each, 16 new tokens. Lengths come
    from their own seeded draw, so they do not depend on the vocabulary."""
    import numpy as np
    from repro_torch.serve.engine import Request

    lens = np.random.default_rng(5).integers(8, 32, size=PAGED["n_shared"])
    rng = np.random.default_rng(6)
    prefix = rng.integers(0, vocab, size=(PAGED["prefix"],))
    return [Request(rid=i, prompt=np.concatenate(
        [prefix, rng.integers(0, vocab, size=(int(n),))]).astype(np.int32),
        max_new_tokens=16) for i, n in enumerate(lens)]


def _recording(eng):
    """Keep every decode step's logits rows, and each request's top-2
    logit margin, both tokens and logit scale at every token it is given
    (prefill and decode), keyed (rid, token index)."""
    torch = sys.modules["torch"]
    rec = dict(steps=[], margins={})

    def note(reqs, logits):
        top = torch.topk(logits.float(), 2, dim=-1)
        scale = logits.float().abs().amax(dim=-1)
        for row, req in reqs:
            rec["margins"][(req.rid, len(req.out_tokens))] = (
                float(top.values[row, 0] - top.values[row, 1]),
                float(scale[row]), int(top.indices[row, 0]),
                int(top.indices[row, 1]))

    def decode(step):
        def recorded(params, cfg, *args):
            out = step(params, cfg, *args)
            if params is eng.params:            # not the drafter's steps
                rec["steps"].append(out.clone())
                note([(i, r) for i, r in enumerate(eng.slot_req)
                      if r is not None], out)
            return out
        return recorded

    pre = eng._run_prefill

    def run_prefill(toks, poss, all_slots, reqs, valid):
        out = pre(toks, poss, all_slots, reqs, valid)
        note(list(enumerate(reqs)), out)
        return out

    eng._decode_step = decode(eng._decode_step)
    eng._paged_decode_step = decode(eng._paged_decode_step)
    eng._run_prefill = run_prefill
    return rec


def _drive_timed(torch, eng, reqs, preempts=(), check_pool=True):
    """Serve ``reqs`` step by step, timing each step with the device
    synchronised; ``preempts`` maps a step number to ``keep_kv``: after
    that step the first occupied slot is preempted (its KV kept or
    dropped) and queued behind the others. Returns the streams and
    per-step (ms, admitted, tokens emitted)."""
    for r in reqs:
        eng.submit(r)
    steps, n = [], 0
    while eng.has_work():
        adm = eng.stats["admitted"]
        toks = sum(len(r.out_tokens) for r in reqs)
        torch.cuda.synchronize()
        t = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        steps.append(((time.perf_counter() - t) * 1e3,
                      eng.stats["admitted"] - adm,
                      sum(len(r.out_tokens) for r in reqs) - toks))
        if check_pool and eng.pool is not None:
            eng.pool.check()
        n += 1
        if n in preempts:
            slot = next(i for i, r in enumerate(eng.slot_req)
                        if r is not None)
            eng.queue.append(eng.preempt_slot(slot,
                                              keep_kv=preempts[n]))
    return {r.rid: list(r.out_tokens) for r in reqs}, steps


def _step_times(steps):
    """Mean ms of steps that admitted nothing (decode, and speculative
    rounds), of steps that admitted (prefill + decode), the prefill's
    share of those (admission step less a decode step), tokens a decode
    step emitted, and tokens per second over the run."""
    dec = [ms for ms, adm, _ in steps if not adm]
    pre = [ms for ms, adm, _ in steps if adm]
    toks = sum(t for _, _, t in steps)
    dec_ms = sum(dec) / max(1, len(dec))
    adm_ms = sum(pre) / max(1, len(pre))
    return dict(steps=len(steps), decode_ms_per_step=dec_ms,
                admission_step_ms=adm_ms, prefill_ms=adm_ms - dec_ms,
                tokens_per_decode_step=sum(t for _, a, t in steps if not a)
                / max(1, len(dec)),
                tok_s=toks / (sum(ms for ms, _, _ in steps) / 1e3))


def _greedy_equal(name, got, want, margins, ref="the contiguous run"):
    """Streams equal ``ref``'s (``want``), or first diverge where the
    top-2 logit margin of the run that recorded ``margins`` is under 1e-2
    of the logit scale (printed)."""
    ties = []
    for rid, want_s in want.items():
        out = got[rid]
        t = next((i for i, (a, b) in enumerate(zip(out, want_s))
                  if a != b), None)
        if t is None:
            check(len(out) == len(want_s), f"{name}: request {rid} emitted "
                  f"{len(out)} tokens, {ref} {len(want_s)}")
            continue
        margin, scale, top1, top2 = margins[(rid, t)]
        log(f"  {name}: request {rid} diverges at token {t}: {out[t]} "
            f"against {ref}'s {want_s[t]}; its top-2 margin "
            f"there {margin:.4g} (tokens {top1}, {top2}), logit scale "
            f"{scale:.4g}")
        check(margin < 1e-2 * scale, f"{name}: request {rid} diverges at "
              f"token {t} where {ref} is no near-tie")
        ties.append(dict(rid=rid, token=t, margin=margin, scale=scale,
                         got=out[t], want=want_s[t]))
    return ties


def _no_leak(name, eng):
    mem = eng.memory_stats()
    check(mem.device_used == mem.cached_pages and mem.host_used == 0
          and not eng.pool.allocs[0].rc and not eng.pool.allocs[0].scratch,
          f"{name}: pages leaked: {mem.as_dict()}")
    eng.pool.check()
    return mem.as_dict()


def _page_errors(eng):
    """``tools.analyze_torch.check_page_refcounts`` over every block of
    ``eng``'s pool (phase 20 reads them)."""
    from tools.analyze_torch import check_page_refcounts
    return check_page_refcounts(eng.pool)


def _launch_counts(counters):
    return {n: dict(total=m.launches, variant=dict(m.variant_launches),
                    weight=dict(m.weight_launches))
            for n, m in counters.items() if n in MAIN_PATH}


def paged_phase(torch, params, cfg, counters):
    """Runs (a) to (d) on the served packed model."""
    from repro_torch.launch.serve import synthetic_requests
    from repro_torch.serve.engine import Engine

    C, B = PAGED["cache_len"], 4
    out = {}
    # (a) paged only, pages for every slot, against contiguous
    runs = {}
    for name, kw in (("contiguous", {}), ("paged", dict(kv_pages=B * 8))):
        eng = Engine(params, cfg, batch_slots=B, cache_len=C, **kw)
        rec = _recording(eng)
        reset(counters)
        streams, steps = _drive_timed(
            torch, eng, synthetic_requests(4, cfg.vocab_size, 16))
        runs[name] = dict(streams=streams, rec=rec, eng=eng,
                          times=_step_times(steps),
                          launches=_launch_counts(counters))
    a, c = runs["paged"], runs["contiguous"]
    check(a["eng"].pool.page_len == 32 and a["eng"].pool.NB == 8,
          f"page_len {a['eng'].pool.page_len}, not the 32-token tile")
    check(a["streams"] == c["streams"],
          "(a) paged streams differ from the contiguous engine's")
    check(len(a["rec"]["steps"]) == len(c["rec"]["steps"]) and all(
        torch.equal(x, y) for x, y in zip(a["rec"]["steps"],
                                          c["rec"]["steps"])),
          "(a) paged decode logits are not bit for bit the contiguous ones")
    out["a"] = dict(paged=a["times"], contiguous=c["times"],
                    launches=a["launches"],
                    memory=_no_leak("(a)", a["eng"]),
                    page_errors=_page_errors(a["eng"]),
                    bit_identical_steps=len(a["rec"]["steps"]))
    log(f"  (a) paged, {B * 8} pages of 32 tokens: streams and all "
        f"{len(a['rec']['steps'])} decode steps' logits bit for bit equal "
        f"to contiguous; decode {a['times']['decode_ms_per_step']:.2f} "
        f"ms/step (contiguous {c['times']['decode_ms_per_step']:.2f}), "
        f"prefill {a['times']['prefill_ms']:.1f} ms "
        f"({c['times']['prefill_ms']:.1f}); launches "
        f"{a['launches']}")
    del runs
    log("  (a) under torch.profiler (phase 4's steps, paged): the page "
        "gather and write-back by kernel")
    out["a"]["profile"] = profile_phase(torch, params, cfg, "paged_",
                                        kv_pages=B * 8)
    # the contiguous engine on run (b)'s requests: the streams to hold
    # (b) to (d) to, with its margins
    eng = Engine(params, cfg, batch_slots=B, cache_len=C)
    rec = _recording(eng)
    want, steps = _drive_timed(torch, eng,
                               shared_prefix_requests(cfg.vocab_size))
    out["contiguous_shared"] = _step_times(steps)
    log(f"  contiguous, run (b)'s 8 requests: {out['contiguous_shared']}")
    draft = dict(draft_sparsity=PAGED["draft_sparsity"], draft_int8=True,
                 draft_k=PAGED["draft_k"])
    # (d): a bf16 drafter at the target's own sparsity (the same masks,
    # so the same weights): drafts are accepted, which (c)'s drafter on
    # random weights rarely is, and promotion and merges run
    same = dict(draft_sparsity=SPARSITY, draft_k=PAGED["draft_k"])
    for name, kw in (("b", {}), ("c", draft), ("d", same)):
        t0 = time.time()
        eng = Engine(params, cfg, batch_slots=B, cache_len=C,
                     kv_pages=PAGED["shared_pages"],
                     kv_host_pages=PAGED["host_pages"], kv_share=True, **kw)
        torch.cuda.synchronize()
        setup_s = time.time() - t0
        reset(counters)
        got, steps = _drive_timed(torch, eng,
                                  shared_prefix_requests(cfg.vocab_size),
                                  preempts={PAGED["preempt_at"]: True})
        launches = _launch_counts(counters)
        ties = _greedy_equal(f"({name})", got, want, rec["margins"])
        st = {k: eng.stats[k] for k in (
            "prefill_tokens", "prefill_tokens_skipped", "reprefill_tokens",
            "preemptions", "resumes", "spec_rounds", "spec_draft_tokens",
            "spec_accepted_tokens", "spec_fallbacks", "generated_tokens")}
        mem = _no_leak(f"({name})", eng)
        res = dict(times=_step_times(steps), stats=st, memory=mem,
                   launches=launches, near_ties=ties, setup_s=setup_s,
                   page_errors=_page_errors(eng))
        out[name] = res
        drafter = {"b": "", "c": ", int8 drafter at 75%, k 4",
                   "d": ", bf16 drafter at the target's 50%, k 4"}[name]
        log(f"  ({name}) sharing, {PAGED['shared_pages']} pages + "
            f"{PAGED['host_pages']} host{drafter}: {res['times']}; "
            f"prefill tokens {st['prefill_tokens']}, "
            f"skipped {st['prefill_tokens_skipped']}, re-prefilled "
            f"{st['reprefill_tokens']}; spills {mem['spills']}, faults "
            f"{mem['faults']}, drops {mem['drops']}, prefix hits "
            f"{mem['prefix_hits']}, COW {mem['cow_copies']}; preemptions "
            f"{st['preemptions']}, resumes {st['resumes']}; spec rounds "
            f"{st['spec_rounds']}, drafted {st['spec_draft_tokens']}, "
            f"accepted {st['spec_accepted_tokens']}, fallbacks "
            f"{st['spec_fallbacks']}; launches {launches}; set-up "
            f"{setup_s:.1f} s; near-ties {len(ties)}")
        check(st["prefill_tokens_skipped"] > 0,
              f"({name}) skipped no prefill token")
        check(st["preemptions"] >= 1 and st["resumes"] >= 1,
              f"({name}) no preempt / resume")
        for n in MAIN_PATH:
            check(launches[n]["weight"].get("bfloat16", 0) > 0,
                  f"({name}) the target never launched {n}")
        if name == "b":
            check(mem["spills"] >= 1 and mem["faults"] >= 1,
                  f"(b) no spill and fault: {mem}")
        else:
            check(st["spec_rounds"] >= 1, f"({name}) no speculative round")
        if name == "c":
            for n in MAIN_PATH:
                check(launches[n]["weight"].get("int8", 0) > 0,
                      f"(c) the int8 drafter never launched {n}")
        if name == "d":
            check(st["spec_accepted_tokens"] > 0,
                  "(d) the target's own weights drafted, none accepted")
        if name in ("c", "d"):
            res["near_tie_op"] = _near_tie_probe(
                torch, params, cfg, f"({name})", ties,
                shared_prefix_requests(cfg.vocab_size), want)
        del eng
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 3c, (c) and (d): which op first differs at a near-tie
# ---------------------------------------------------------------------------


def _sync(torch):
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def locate_near_tie_op(torch, params, cfg, prompt, stream, t, k):
    """At token ``t`` of ``stream`` (``prompt``'s greedy stream), run the
    same step both ways from the same KV: sequential decode (one row:
    token t-1 at position P = len(prompt) + t - 1) and the speculative
    verify pass (k+1 rows from P, ``prefill_with_past``). The past is a
    solo engine's cache after it emitted t tokens. Every projection
    (wq, wk, wv, wo), each layer's attention output (wo's input), each
    norm, each FFN, the final norm and the lm-head product are recorded
    in call order; returns the first whose row P differs, bit for bit,
    with the count of differing ops."""
    import numpy as np
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import ffn as ffn_mod
    from repro_torch.models import lm
    from repro_torch.serve.engine import Engine, Request

    t = max(1, t)               # the verify pass emits tokens 1 on
    eng = Engine(params, cfg, batch_slots=1, cache_len=PAGED["cache_len"])
    eng.run([Request(rid=0, prompt=np.asarray(prompt, np.int32),
                     max_new_tokens=t)])
    P = len(prompt) + t - 1
    past = eng.caches

    def clone():
        from repro_torch.models.attention import cache_map
        return tuple({n: cache_map(lambda a: a.clone(), c)
                      for n, c in seg.items()} for seg in past)

    rec = []
    orig = (attn_mod._proj, lm.rmsnorm_apply, ffn_mod.ffn_apply,
            lm.matmul_f32)
    count = {"layer": 0, "norm": 0}

    def proj(p, name, x, cfg=None):
        if name == "wo":
            rec.append((f"L{count['layer']}.attention", x))
        y = orig[0](p, name, x, cfg)
        rec.append((f"L{count['layer']}.{name}", y))
        return y

    def norm(p, x, *, eps):
        y = orig[1](p, x, eps=eps)
        count["norm"] += 1
        rec.append(("final_norm" if count["layer"] == cfg.num_layers
                    else f"L{count['layer']}.norm{count['norm']}", y))
        return y

    def ffn(p, c, x):
        y = orig[2](p, c, x)
        rec.append((f"L{count['layer']}.ffn", y))
        count["layer"] += 1
        count["norm"] = 0
        return y

    def head(a, b):
        y = orig[3](a, b)
        rec.append(("lm_head", y))
        return y

    def run(fn):
        rec.clear()
        count.update(layer=0, norm=0)
        attn_mod._proj, lm.rmsnorm_apply = proj, norm
        ffn_mod.ffn_apply, lm.matmul_f32 = ffn, head
        try:
            with torch.no_grad():
                fn()
        finally:
            (attn_mod._proj, lm.rmsnorm_apply, ffn_mod.ffn_apply,
             lm.matmul_f32) = orig
        return [(n, v[0, 0].clone()) for n, v in rec]

    dev = params["embed"]["emb"].device
    toks = [stream[t - 1]] + list(stream[t:t + k])
    toks += [stream[t - 1]] * (k + 1 - len(toks))
    dec = run(lambda: lm.decode_step(
        params, cfg, torch.tensor([[stream[t - 1]]], dtype=torch.int32,
                                  device=dev),
        torch.tensor([P], dtype=torch.int32, device=dev), clone()))
    ver = run(lambda: lm.prefill_with_past(
        params, cfg, torch.tensor([toks], dtype=torch.int32, device=dev),
        torch.arange(P, P + k + 1, dtype=torch.int32,
                     device=dev)[None], clone(), all_logits=True))
    if [n for n, _ in dec] != [n for n, _ in ver]:
        return dict(error="the two passes recorded different ops")
    diff = [(n, float((a.float() - b.float()).abs().max()))
            for (n, a), (_, b) in zip(dec, ver) if not torch.equal(a, b)]
    dl, vl = dec[-1][1].float(), ver[-1][1].float()
    return dict(rid_token=t, position=P, ops=len(dec),
                first_differing=diff[0][0] if diff else None,
                first_max_abs_diff=diff[0][1] if diff else 0.0,
                differing=len(diff), names=[n for n, _ in diff][:8],
                logits_max_abs_diff=float((dl - vl).abs().max()),
                argmax_decode=int(dl.argmax()), argmax_verify=int(vl.argmax()))


def _near_tie_probe(torch, params, cfg, name, ties, reqs, want):
    """Locate the op at ``name``'s first near-tie, or at token 1 of
    request 0 when the run diverged nowhere."""
    first = min(ties, key=lambda d: (d["rid"], d["token"])) if ties \
        else dict(rid=reqs[0].rid, token=1)
    req = next(r for r in reqs if r.rid == first["rid"])
    tok = max(1, first["token"])
    out = locate_near_tie_op(torch, params, cfg, req.prompt,
                             want[req.rid], tok, PAGED["draft_k"])
    where = "its first near-tie" if ties else "no divergence; probed"
    log(f"  {name} near-tie op probe ({where}: request {req.rid}, token "
        f"{first['token']}): decode (1 row) vs verify ({PAGED['draft_k'] + 1}"
        f" rows) from the same KV: first op whose bits differ "
        f"{out.get('first_differing')} (max |diff| "
        f"{out.get('first_max_abs_diff', 0):.3g}); {out.get('differing')} "
        f"of {out.get('ops')} ops differ {out.get('names')}; logits max "
        f"|diff| {out.get('logits_max_abs_diff', 0):.3g}, argmax "
        f"{out.get('argmax_decode')} vs {out.get('argmax_verify')}")
    return out


# ---------------------------------------------------------------------------
# phase 3d: the QoS scheduler, rank failure, the cluster frontend
# ---------------------------------------------------------------------------

SCHED = dict(cache_len=256, ranks=2, slots=4, requests=16, interactive_new=8,
             batch_new=16, aging=0.05, fault_step=4, subprocess_layers=1,
             subprocess_requests=6, subprocess_new=12, kill_tick=3)


def _solo_oracle(torch, params, cfg, reqs):
    """Each request alone through ``Engine(batch_slots=1)``: streams, and
    the top-2 margins at every token (``_recording``)."""
    from repro_torch.serve.engine import Engine, Request

    streams, margins = {}, {}
    for r in reqs:
        eng = Engine(params, cfg, batch_slots=1, cache_len=SCHED["cache_len"])
        rec = _recording(eng)
        done = eng.run([Request(rid=r.rid, prompt=r.prompt,
                                max_new_tokens=r.max_new_tokens,
                                eos_id=r.eos_id)])
        streams[r.rid] = list(done[0].out_tokens)
        margins.update(rec["margins"])
    _sync(torch)
    return streams, margins


def qos_requests(vocab: int):
    """Run (a)'s traffic: the launcher's 16 prompts (seed 0); every
    second request interactive with 8 new tokens, the others batch with
    16."""
    from repro_torch.launch.serve import synthetic_requests

    reqs = synthetic_requests(SCHED["requests"], vocab, SCHED["batch_new"],
                              interactive_every=2)
    for r in reqs:
        if r.slo == "interactive":
            r.max_new_tokens = SCHED["interactive_new"]
    return reqs


def _fresh_req(reqs):
    """Copies of ``reqs`` with nothing emitted (same prompts, budgets,
    classes and EOS)."""
    from repro_torch.serve.engine import Request
    return [Request(rid=r.rid, prompt=r.prompt,
                    max_new_tokens=r.max_new_tokens, slo=r.slo,
                    eos_id=r.eos_id) for r in reqs]


def _pick_eos(reqs, solo):
    """One batch request gets an EOS that fires mid-decode: the first
    token of its solo stream, at index 4 or later (index 1 or later if
    none), that did not occur before. Fails if no batch stream has one."""
    for lo in (4, 1):
        for r in reqs:
            s = solo[r.rid]
            if r.slo != "batch":
                continue
            at = next((i for i in range(lo, len(s) - 1)
                       if s[i] not in s[:i]), None)
            if at is not None:
                r.eos_id = int(s[at])
                solo[r.rid] = s[:at + 1]
                return r.rid, at
    fail("(a) no batch request's solo stream has a fresh token after "
         "position 0: no EOS can fire mid-decode")


def _timed_engines(torch, sched, log_ms, fault_rank=None):
    """Wrap every rank's ``Engine.step``: the device is synchronised at
    its end and (rank, ms, admitted) noted; ``fault_rank``'s 4th step
    raises a Python RuntimeError instead."""
    for eng in sched.shards:
        inner, calls = eng.step, {"n": 0}

        def step(eng=eng, inner=inner, calls=calls):
            calls["n"] += 1
            if eng.rank == fault_rank and calls["n"] == SCHED["fault_step"]:
                raise RuntimeError("injected rank fault (phase 3d (b))")
            adm = eng.stats["admitted"]
            t = time.perf_counter()
            try:
                return inner()
            finally:
                _sync(torch)
                log_ms.append((eng.rank, (time.perf_counter() - t) * 1e3,
                               eng.stats["admitted"] - adm))
        eng.step = step


def _timed_scheduler(torch, sched, rows):
    """Wrap a host's ``ShardedScheduler.step`` (and its engines', as
    ``_timed_engines``): ``rows`` gets (step ms, its engines' ms) per step;
    returns the engine rows."""
    eng_ms = []
    _timed_engines(torch, sched, eng_ms)
    inner = sched.step

    def step():
        k = len(eng_ms)
        _sync(torch)
        t = time.perf_counter()
        out = inner()
        _sync(torch)
        rows.append(((time.perf_counter() - t) * 1e3,
                     sum(ms for _, ms, _ in eng_ms[k:])))
        return out
    sched.step = step
    return eng_ms


def _decode_ms(eng_ms):
    """Mean ms of engine steps that admitted nothing, by rank."""
    dec = {}
    for rank, ms, adm in eng_ms:
        if not adm:
            dec.setdefault(rank, []).append(ms)
    return {r: sum(v) / len(v) for r, v in sorted(dec.items())}


def _attainment(reqs):
    """Share of each class's requests retired by their absolute
    deadline."""
    return {c: sum(1 for r in reqs if r.slo == c and r.t_done is not None
                   and r.t_deadline is not None and r.t_done <= r.t_deadline)
            / sum(1 for r in reqs if r.slo == c)
            for c in sorted({r.slo for r in reqs})}


def _drive_qos(torch, sched, reqs, fault_rank=None):
    """Batch requests first, two scheduler steps, then the interactive
    ones (so that they find every slot busy and preempt), then steps to
    the end. Returns (finished, per-step rows, engine rows)."""
    eng_ms, rows, finished = [], [], []
    _timed_engines(torch, sched, eng_ms, fault_rank)
    later = [r for r in reqs if r.slo == "interactive"]
    for r in reqs:
        if r.slo != "interactive":
            check(sched.submit(r), f"request {r.rid} rejected")
    n = 0
    while later or sched.has_work():
        if n == 2:
            for r in later:
                check(sched.submit(r), f"request {r.rid} rejected")
            later = []
        k = len(eng_ms)
        _sync(torch)
        t = time.perf_counter()
        done = sched.step()
        _sync(torch)
        wall = (time.perf_counter() - t) * 1e3
        finished += done
        rows.append((wall, sum(ms for _, ms, _ in eng_ms[k:]),
                     sum(len(r.out_tokens) for r in reqs)))
        n += 1
    return finished, rows, eng_ms


def _qos_report(name, sched, reqs, rows, eng_ms):
    """tok/s, decode ms/step per rank, TTFT per class (the Telemetry
    histogram's bucket bounds, and nearest-rank from the requests'
    stamps), deadline attainment, preemptions / refills / requeues, the
    scheduler's own host ms per step."""
    from repro_torch.serve.telemetry import pcts_ms

    st = sched.stats()
    wall = sum(w for w, _, _ in rows)
    toks = sum(len(r.out_tokens) for r in reqs)
    dec_ms = _decode_ms(eng_ms)
    own = [w - e for w, e, _ in rows]
    att = _attainment(reqs)
    per = st["per_rank"]
    exact = {}
    for c in ("interactive", "batch"):
        lat = sorted(r.t_first - r.t_submit for r in reqs
                     if r.slo == c and r.t_first is not None)
        if lat:
            exact[c] = pcts_ms(lat)
    res = dict(steps=len(rows), tok_s=toks / (wall / 1e3),
               decode_ms_per_step_by_rank=dec_ms,
               sched_host_ms_per_step=sum(own) / len(own),
               ttft=st["ttft"], ttft_exact_p50_p95_ms=exact,
               deadline_attainment=att,
               preemptions=st["preemptions"],
               resumes=sum(p["resumes"] for p in per),
               refills=sum(p["continuous_refills"] for p in per),
               requeued=st["requeued"],
               decode_steps=sum(p["decode_steps"] for p in per),
               admitted_by_rank=[p["admitted"] for p in per])
    ttft = {c: f"{d['p50_ms']:.1f}/{d['p95_ms']:.1f}"
            for c, d in sorted(st["ttft"].items())}
    log(f"  {name}: {len(rows)} steps, {res['tok_s']:.1f} tok/s; decode "
        f"ms/step by rank { {r: round(v, 2) for r, v in dec_ms.items()} }; "
        f"TTFT p50/p95 ms {ttft} (histogram bounds; from the stamps "
        f"{ {c: tuple(round(x, 1) for x in v) for c, v in exact.items()} }"
        f"); deadline attainment {att}; preemptions "
        f"{res['preemptions']}, resumes {res['resumes']}, refills "
        f"{res['refills']}, requeues {res['requeued']}; scheduler host "
        f"{res['sched_host_ms_per_step']:.3f} ms/step beyond its engines'")
    return res


def sched_phase(torch, params, cfg, counters):
    """Runs (a) to (d) on the served packed model."""
    from repro_torch.serve.engine import Request
    from repro_torch.serve.scheduler import SchedulerConfig, ShardedScheduler
    from repro_torch.serve.telemetry import Telemetry

    t_phase = time.time()
    out = {}
    reqs = qos_requests(cfg.vocab_size)
    solo, margins = _solo_oracle(torch, params, cfg, reqs)
    eos_rid, eos_at = _pick_eos(reqs, solo)
    log(f"  solo oracle (Engine(batch_slots=1), each request alone): "
        f"{len(reqs)} requests; request {eos_rid} gets EOS "
        f"{reqs[eos_rid].eos_id} at its token {eos_at}")

    def sched_cfg(**kw):
        return SchedulerConfig(slots_per_rank=SCHED["slots"],
                               cache_len=SCHED["cache_len"], policy="edf",
                               aging=SCHED["aging"], preempt=True,
                               preempt_mode="kv", **kw)

    # (a) traced and untraced, bit for bit; then the drain baseline
    runs = {}
    for trace in (True, False):
        sched = ShardedScheduler(params, cfg, ranks=SCHED["ranks"],
                                 sched=sched_cfg(),
                                 telemetry=Telemetry(trace=trace))
        recs = [_recording(e) for e in sched.shards]
        batch = _fresh_req(reqs)
        reset(counters)
        done, rows, eng_ms = _drive_qos(torch, sched, batch)
        launches = _launch_counts(counters)
        runs[trace] = dict(sched=sched, recs=recs, reqs=batch,
                           streams={r.rid: list(r.out_tokens) for r in done},
                           report=_qos_report(
                               f"(a) {'traced' if trace else 'untraced'}",
                               sched, batch, rows, eng_ms),
                           launches=launches)
    a, u = runs[True], runs[False]
    check(len(a["streams"]) == len(reqs), "(a) not every request completed")
    ties = _greedy_equal("(a)", a["streams"], solo, margins,
                         ref="the solo oracle")
    check(a["streams"] == u["streams"],
          "(a) streams differ with tracing on and off")
    same = all(len(x["steps"]) == len(y["steps"]) and all(
        torch.equal(p, q) for p, q in zip(x["steps"], y["steps"]))
        for x, y in zip(a["recs"], u["recs"]))
    check(same, "(a) decode logits differ with tracing on and off")
    rep = a["report"]
    check(all(n > 0 for n in rep["admitted_by_rank"]),
          f"(a) a rank admitted nothing: {rep['admitted_by_rank']}")
    check(rep["preemptions"] >= 1 and rep["resumes"] >= 1,
          "(a) no preemption and resume")
    check(rep["refills"] >= 1, "(a) no continuous refill")
    for n in MAIN_PATH:
        check(a["launches"][n]["total"] > 0, f"(a) never launched {n}")
    want_v = {"sasp_gemm": "mma", "sasp_fused_ffn": "mma/mma"}
    for n, v in a["launches"].items():
        check(set(v["variant"]) == {want_v[n]},
              f"(a) {n} ran {v['variant']}, not only {want_v[n]}")
    names = {e["name"] for e in a["sched"].telemetry.tracer.events()}
    check({"submit", "admit", "prefill", "token", "preempt", "resume"}
          <= names, f"(a) trace lacks events: {sorted(names)}")
    log(f"  (a) streams equal the solo oracle ({len(ties)} near-ties), "
        f"bit for bit equal with tracing off (streams and "
        f"{sum(len(x['steps']) for x in a['recs'])} decode steps' logits); "
        f"launches {a['launches']}")
    drain = ShardedScheduler(params, cfg, ranks=SCHED["ranks"],
                             sched=sched_cfg(drain=True))
    batch = _fresh_req(reqs)
    d_done, d_rows, d_ms = _drive_qos(torch, drain, batch)
    d_rep = _qos_report("(a) drain baseline", drain, batch, d_rows, d_ms)
    _greedy_equal("(a) drain", {r.rid: list(r.out_tokens) for r in d_done},
                  solo, margins, ref="the solo oracle")
    check(d_rep["decode_steps"] > rep["decode_steps"],
          f"(a) drain took {d_rep['decode_steps']} decode steps, continuous "
          f"{rep['decode_steps']}")
    out["a"] = dict(traced=rep, untraced=u["report"], drain=d_rep,
                    launches=a["launches"], near_ties=ties,
                    bit_identical_steps=sum(len(x["steps"])
                                            for x in a["recs"]))
    del runs, a, u, drain

    # (b) rank 0's 4th Engine.step raises; then revive_rank(0)
    sched = ShardedScheduler(params, cfg, ranks=SCHED["ranks"],
                             sched=sched_cfg())
    batch = _fresh_req(reqs)
    reset(counters)
    done, rows, eng_ms = _drive_qos(torch, sched, batch, fault_rank=0)
    b_launches = _launch_counts(counters)
    b_rep = _qos_report("(b) rank 0 fails at its step "
                        f"{SCHED['fault_step']}", sched, batch, rows, eng_ms)
    check(sched.shards[0].dead and len(done) == len(reqs)
          and all(r.status == "done" for r in batch),
          "(b) not every request completed after the rank fault")
    check(all(r.rank == 1 for r in done), "(b) a request completed on the "
          f"dead rank: {[(r.rid, r.rank) for r in done]}")
    check(b_rep["requeued"] >= 1, "(b) nothing requeued")
    b_ties = _greedy_equal("(b)", {r.rid: list(r.out_tokens) for r in done},
                           solo, margins, ref="the solo oracle")
    sched.revive_rank(0)
    extra = qos_requests(cfg.vocab_size)[0]
    extra.rid = 100
    x_solo, x_margins = _solo_oracle(torch, params, cfg, [extra])
    got = sched.run([_fresh_req([extra])[0]])
    check(len(got) == 1 and got[0].rank == 0,
          "(b) the revived rank 0 did not serve the next request")
    _greedy_equal("(b) revived", {100: list(got[0].out_tokens)}, x_solo,
                  x_margins, ref="the solo oracle")
    log(f"  (b) every request completed on rank 1 ({b_rep['requeued']} "
        f"requeued), streams equal the solo oracle ({len(b_ties)} "
        f"near-ties); revive_rank(0) served request 100 on rank 0; "
        f"launches {b_launches}")
    out["b"] = dict(b_rep, near_ties=b_ties, launches=b_launches)
    del sched

    out["c"] = _frontend_run(torch, params, cfg, counters)
    out["d"] = _subprocess_run(torch)
    out["seconds"] = time.time() - t_phase
    log(f"  phase 3d: {out['seconds']:.1f} s")
    return out


def _frontend_run(torch, params, cfg, counters):
    """(c): two in-process hosts (1 rank each, paged KV with sharing),
    chaos kill:0@4,seed:3, retries 2, against an undisturbed 1-host run
    and the solo oracle."""
    from repro_torch.serve.chaos import ChaosMonkey, parse_chaos_spec
    from repro_torch.serve.frontend import (ClusterFrontend, FrontendConfig,
                                            make_local_hosts)
    from repro_torch.serve.scheduler import SchedulerConfig

    reqs = shared_prefix_requests(cfg.vocab_size)
    solo, margins = _solo_oracle(torch, params, cfg, reqs)
    sc = SchedulerConfig(slots_per_rank=SCHED["slots"],
                         cache_len=SCHED["cache_len"],
                         kv_pages=PAGED["shared_pages"],
                         kv_host_pages=PAGED["host_pages"], kv_share=True)

    def serve(n_hosts, chaos):
        hosts = make_local_hosts(params, cfg, hosts=n_hosts, sched=sc,
                                 chaos=chaos, trace=True)
        delivered = {}
        fe = ClusterFrontend(hosts, FrontendConfig(retries=2,
                                                   backoff_base=0.001),
                             on_token=lambda r, t: delivered.setdefault(
                                 r.rid, []).append(t))
        rows = {h.host_id: [] for h in hosts}
        eng_ms = {h.host_id: _timed_scheduler(torch, h.sched, rows[h.host_id])
                  for h in hosts}
        batch = _fresh_req(reqs)
        _sync(torch)
        t = time.perf_counter()
        done = fe.run(batch)
        drained, clean = fe.drain()
        _sync(torch)
        wall = time.perf_counter() - t
        return fe, hosts, done + drained, clean, delivered, wall, dict(
            rows=rows, eng_ms=eng_ms, reqs=batch)

    fe1, _, done1, _, _, _, _ = serve(1, None)
    one = {r.rid: list(r.out_tokens) for r in done1}
    fe1.close()
    chaos = parse_chaos_spec("kill:0@4,seed:3")
    reset(counters)
    fe, hosts, done, clean, delivered, wall, tm = serve(2,
                                                        ChaosMonkey(chaos))
    launches = _launch_counts(counters)
    got = {r.rid: list(r.out_tokens) for r in done}
    st = fe.stats()
    check(len(got) == len(reqs) and not fe.failed and not fe.rejected,
          f"(c) not every request completed: {st}")
    check(fe.n_retries >= 1 and hosts[0].killed, "(c) no kill and retry")
    check(delivered == got, "(c) a token was streamed twice or lost")
    check(clean, "(c) drain was not clean")
    ties = _greedy_equal("(c)", got, solo, margins, ref="the solo oracle")
    ties1 = _greedy_equal("(c) undisturbed 1 host", one, solo, margins,
                          ref="the solo oracle")
    _greedy_equal("(c) vs the undisturbed 1-host run", got, one, margins,
                  ref="the 1-host run")
    mems = [_no_leak(f"(c) host {h.host_id}", h.sched.shards[0])
            for h in hosts]
    path = os.path.join(OUT_DIR, "frontend_trace.json")
    os.makedirs(OUT_DIR, exist_ok=True)
    n_ev = fe.write_trace(path)
    with open(path, encoding="utf-8") as fh:
        trace = json.load(fh)
    names = {e["name"] for e in trace["traceEvents"]}
    check(len(trace["traceEvents"]) == n_ev and {
        "submit", "prefill", "token", "host_kill", "host_dead", "retry"}
        <= names, f"(c) trace lacks events: {sorted(names)}")
    text, host_text = fe.prometheus(), hosts[1].telemetry.prometheus()
    check('serve_admitted_total{host="1"}' in text
          and "serve_frontend_retries_total" in text
          and 'serve_admitted_total{rank="0"}' in host_text
          and 'serve_kv_device_used{rank="0"}' in host_text,
          "(c) Prometheus text lacks per-rank counters or serve_kv_* gauges")
    for n in MAIN_PATH:
        check(launches[n]["total"] > 0, f"(c) never launched {n}")
    toks = sum(len(v) for v in got.values())
    ttft = {c: f"{d['p50_ms']:.1f}/{d['p95_ms']:.1f}"
            for c, d in sorted(st["ttft"].items())}
    dec_ms = {h: round(_decode_ms(m).get(0, float("nan")), 2)
              for h, m in tm["eng_ms"].items()}
    own = [w - e for rows in tm["rows"].values() for w, e in rows]
    per = [h.sched.stats()["per_rank"][0] for h in hosts]
    res = dict(tok_s=toks / wall, wall_s=wall, retries=fe.n_retries,
               deduped=fe.n_deduped, ttft=st["ttft"], near_ties=ties,
               near_ties_one_host=ties1, trace_events=n_ev,
               memory=mems, launches=launches,
               decode_ms_per_step_by_host=dec_ms,
               sched_host_ms_per_step=sum(own) / max(1, len(own)),
               deadline_attainment=_attainment(tm["reqs"]),
               preemptions=sum(p["preemptions"] for p in per),
               refills=sum(p["continuous_refills"] for p in per),
               requeued=sum(h.sched.n_requeued for h in hosts),
               steps=[h.steps for h in hosts])
    log(f"  (c) 2 hosts, kill:0@4: {len(got)} done, {fe.n_retries} retries, "
        f"{fe.n_deduped} duplicate tokens dropped, drain clean; "
        f"{res['tok_s']:.1f} tok/s over {wall:.2f} s; decode ms/step by "
        f"host {dec_ms}; "
        f"TTFT p50/p95 ms {ttft}; deadline attainment "
        f"{res['deadline_attainment']}; preemptions {res['preemptions']}, "
        f"refills {res['refills']}, requeues {res['requeued']}; scheduler "
        f"host {res['sched_host_ms_per_step']:.3f} ms/step beyond its "
        f"engines'; host steps {res['steps']}; trace {n_ev} events -> "
        f"{os.path.relpath(path, ROOT)}; pools checked, no page leaked; "
        f"near-ties {len(ties)} (1 host: {len(ties1)}); launches {launches}")
    fe.close()
    return res


def subprocess_spec():
    """The host_worker spec of (d): qwen3-32b packed at full width, 1
    layer, bf16, seed 0, wo / w2 rescaled, 50% tiles, scope all."""
    return dict(device=DEVICE, reduce=False,
                layers=SCHED["subprocess_layers"], param_seed=0,
                spread_output_scales=True, sasp=SPARSITY, path="packed",
                scope="all", compute="bfloat16", slots=SCHED["slots"],
                cache_len=SCHED["cache_len"])


def _subprocess_run(torch):
    """(d): two ``host_worker`` processes on the card (packed, full width,
    1 layer, bf16, seed 0), host 0 SIGKILLed mid-load, against an
    undisturbed 1-worker run and the solo oracle on the same weights
    built in this process."""
    from repro_torch.launch.serve import synthetic_requests
    from repro_torch.serve.frontend import (ClusterFrontend, FrontendConfig,
                                            SubprocessHost)
    from repro_torch.serve.host_worker import build_model

    spec = subprocess_spec()
    params, cfg = build_model(spec)
    reqs = synthetic_requests(SCHED["subprocess_requests"], cfg.vocab_size,
                              SCHED["subprocess_new"])
    solo, margins = _solo_oracle(torch, params, cfg, reqs)
    del params
    if DEVICE == "cuda":
        torch.cuda.empty_cache()

    t = time.perf_counter()
    ref_host = SubprocessHost(0, spec=dict(spec, seed=0))
    start_s = time.perf_counter() - t
    ref_fe = ClusterFrontend([ref_host], FrontendConfig())
    try:
        one = {r.rid: list(r.out_tokens)
               for r in ref_fe.run(_fresh_req(reqs))}
    finally:
        ref_fe.close()
    hosts = [SubprocessHost(0, spec=dict(spec, seed=0)),
             SubprocessHost(1, spec=dict(spec, seed=1))]
    step_ms = {h.host_id: [] for h in hosts}
    for h in hosts:
        inner = h.step

        def step(h=h, inner=inner):
            t = time.perf_counter()
            out = inner()
            step_ms[h.host_id].append((time.perf_counter() - t) * 1e3)
            return out
        h.step = step
    delivered, killed = {}, []
    fe = ClusterFrontend(hosts, FrontendConfig(retries=2,
                                               backoff_base=0.001),
                         on_token=lambda r, tk: delivered.setdefault(
                             r.rid, []).append(tk))

    def on_tick(tick):
        if tick == SCHED["kill_tick"] and not killed:
            check(any(tr.host_id == 0 for tr in fe.unresolved()),
                  "(d) host 0 holds no request at the kill")
            hosts[0].kill()
            killed.append(tick)

    t = time.perf_counter()
    try:
        done = fe.run(_fresh_req(reqs), on_tick=on_tick)
    finally:
        fe.close()
    wall = time.perf_counter() - t
    got = {r.rid: list(r.out_tokens) for r in done}
    check(killed and fe._state(0) == "dead", "(d) host 0 was not killed")
    check(len(got) == len(reqs) and not fe.failed and not fe.rejected,
          f"(d) not every request completed: {fe.stats()}")
    check(fe.n_retries >= 1, "(d) no retry after the kill")
    check(delivered == got, "(d) a token was streamed twice or lost")
    check(all(h.proc.poll() is not None for h in [ref_host] + hosts),
          "(d) a worker process is still running")
    check(hosts[0].proc.returncode == -9, "(d) host 0 did not die of "
          f"SIGKILL: {hosts[0].proc.returncode}")
    ties = _greedy_equal("(d)", got, solo, margins, ref="the solo oracle")
    ties1 = _greedy_equal("(d) undisturbed 1 worker", one, solo, margins,
                          ref="the solo oracle")
    _greedy_equal("(d) vs the undisturbed 1-worker run", got, one, margins,
                  ref="the 1-worker run")
    toks = sum(len(v) for v in got.values())
    ms = {h: sum(v) / max(1, len(v)) for h, v in step_ms.items()}
    res = dict(tok_s=toks / wall, wall_s=wall, worker_start_s=start_s,
               step_ms_by_host=ms, steps_by_host={
                   h: len(v) for h, v in step_ms.items()},
               retries=fe.n_retries, near_ties=ties,
               near_ties_one_worker=ties1,
               exit_codes=[h.proc.returncode for h in [ref_host] + hosts])
    log(f"  (d) 2 host_worker processes ({SCHED['subprocess_layers']} "
        f"layer, full width), host 0 SIGKILLed at tick "
        f"{SCHED['kill_tick']}: {len(got)} done, {fe.n_retries} retries, no "
        f"token duplicated, {res['tok_s']:.1f} tok/s over {wall:.2f} s "
        f"(worker start {start_s:.1f} s); ms per step (the worker's step "
        f"and the protocol round trip) by host "
        f"{ {h: round(v, 2) for h, v in ms.items()} }, steps "
        f"{res['steps_by_host']}; TTFT and attainment not measured (they "
        f"live in the workers); exit codes {res['exit_codes']}; "
        f"near-ties {len(ties)} (1 worker: {len(ties1)})")
    return res


# (path, layers, int8 weights, scope) of phase 3b
OTHER_PATHS = (("kernel", N_LAYERS, False, "all"), ("bsr", 2, False, "all"),
               ("masked", 2, True, "ffn"))


def paths_phase(torch, counters):
    """The kernel, bsr and int8 masked serving paths at full width, bf16,
    from the packed phase's seed and rescaling; the kernel path is also
    profiled. Returns the results and layer 0's int8 w1 of the masked
    path (for phase 5b)."""
    from repro_torch.launch.serve import build_serving_params
    from repro_torch.models import lm

    results, qw = {}, None
    for path, layers, int8, scope in OTHER_PATHS:
        name = path + ("+int8" if int8 else "")
        log(f"  --path {path}{' --int8-weights' if int8 else ''} --scope "
            f"{scope}, {layers} layers")
        cfg = main_config(layers, "bfloat16")
        t0 = time.time()
        params, cfg = build_serving_params(
            spread_output_scales(lm.init_params(cfg, seed=0, device=DEVICE),
                                 cfg),
            cfg, path=path, sparsity=SPARSITY, scope=scope,
            int8_weights=int8, verbose=False)
        torch.cuda.synchronize()
        log(f"  init + prune + deploy: {time.time() - t0:.1f} s")
        launches, e2e = _serve(torch, params, cfg, counters)
        if path == "kernel":
            check(launches["sasp_gemm"] > 0,
                  "the kernel path never launched sasp_gemm")
            log("  kernel path under torch.profiler: the prefill step and "
                "3 decode steps")
            e2e["profile"] = profile_phase(torch, params, cfg, "kernel_")
        if int8:
            qw = params["segments"][0]["slot0"]["ffn"]["w1"]["qw"].layer(0)
        results[name] = dict(layers=layers, scope=scope, launches=launches,
                             **e2e)
        del params
        torch.cuda.empty_cache()
    return results, qw


def _profiled(torch, step, n: int, name: str, ops_by_shape=(),
              quiet: bool = False):
    """Device time by kernel over ``n`` calls of ``step`` under
    torch.profiler, and the share of the wall time the device was busy
    (sum of kernel self times; kernels of one stream do not overlap);
    the ops named in ``ops_by_shape`` also by their input shapes. The
    trace goes to build/chip_smoke/<name>_trace.json. ``quiet``: log
    nothing (a spawned rank's)."""
    say = (lambda m: None) if quiet else log
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=bool(ops_by_shape)) as prof:
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
        say(f"  {name}: device time not measured (the profiler saw no "
            f"device activity)")
        return dict(wall_ms_per_step=wall_us / n / 1e3, busy_share=None,
                    kernels=[])
    say(f"  {name}, {n} step(s): {wall_us / n / 1e3:.2f} ms/step wall, "
        f"device busy {busy_us / n / 1e3:.2f} ms/step "
        f"({busy_us / wall_us:.1%} of wall)")
    rows = []
    for e in sorted(events, key=dev_us, reverse=True)[:12]:
        rows.append(dict(name=e.key[:90], calls=e.count,
                         ms_per_step=dev_us(e) / n / 1e3))
        say(f"    {dev_us(e) / n / 1e3:8.3f} ms/step  {e.count / n:6.1f} "
            f"calls/step  {e.key[:90]}")
    shaped = []
    if ops_by_shape:
        def tot_us(e):
            return getattr(e, "device_time_total", None) or \
                getattr(e, "cuda_time_total", 0)
        ops = [e for e in prof.key_averages(group_by_input_shape=True)
               if e.key in ops_by_shape and tot_us(e)]
        say(f"  {name}: {', '.join(ops_by_shape)} by input shapes "
            f"(device time, their kernels included):")
        for e in sorted(ops, key=tot_us, reverse=True)[:16]:
            shaped.append(dict(op=e.key, shapes=str(e.input_shapes),
                               calls=e.count, ms_per_step=tot_us(e) / n / 1e3))
            say(f"    {tot_us(e) / n / 1e3:8.3f} ms/step  "
                f"{e.count / n:6.1f} calls/step  {e.key} "
                f"{str(e.input_shapes)[:100]}")
    return dict(wall_ms_per_step=wall_us / n / 1e3,
                busy_ms_per_step=busy_us / n / 1e3,
                busy_share=busy_us / wall_us, kernels=rows, ops=shaped)


def profile_phase(torch, params, cfg, tag: str = "", **engine_kw):
    """A served model (4 slots) under torch.profiler: the admission step
    (left-padded prefill of 4 prompts, then the first decode step), then
    three decode steps; traces go to <tag>prefill / <tag>decode.
    ``engine_kw`` go to the Engine (the paged phase's pool)."""
    from repro_torch.launch.serve import synthetic_requests
    from repro_torch.serve.engine import Engine

    eng = Engine(params, cfg, batch_slots=4, cache_len=256, **engine_kw)
    for r in synthetic_requests(4, cfg.vocab_size, 8):
        eng.submit(r)
    torch.cuda.synchronize()
    return dict(prefill=_profiled(torch, eng.step, 1, tag + "prefill"),
                decode=_profiled(torch, eng.step, 3, tag + "decode"))


def parity_phase(torch, params, layers: int = N_LAYERS):
    """fp32 compute on the main path's pruned weights: packed vs masked,
    and kernel (BSR through the tile-skip GEMM) vs masked. Returns the
    errors and layer 0's fp32 tensors for phase 5b."""
    from repro_torch.core.deploy import deploy_packed, strip_packed
    from repro_torch.core.pruning import compute_sasp_masks
    from repro_torch.core.sasp import bsr_overlay_from_masks, merge_overlay
    from repro_torch.models import lm
    from repro_torch.models.modules import embedding_apply, rmsnorm_apply

    cfg = main_config(layers, "float32")
    dense = strip_packed(params)
    masked_cfg = dataclasses.replace(cfg, sasp=dataclasses.replace(
        cfg.sasp, enabled=True, block_k=32, block_n=32, sparsity=SPARSITY,
        scope="all", path="masked"))
    t0 = time.time()
    packed, pcfg = deploy_packed(dense, masked_cfg)
    # the pruned tiles are exactly zero, so selecting the same share of
    # tiles again gives the served masks
    masks = compute_sasp_masks(dense, masked_cfg.sasp)
    kparams = merge_overlay(dense, bsr_overlay_from_masks(
        dense, masks, masked_cfg.sasp))
    kcfg = dataclasses.replace(masked_cfg, sasp=dataclasses.replace(
        masked_cfg.sasp, path="kernel"))
    log(f"  fp32 re-pack and BSR: {time.time() - t0:.1f} s")
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (2, 24), generator=gen,
                         device=DEVICE)
    errs = {}
    with torch.no_grad():
        lg_m, c_m = lm.prefill(dense, masked_cfg, toks, cache_len=32)
        nxt = torch.argmax(lg_m[:, 0], dim=-1, keepdim=True)
        pos = torch.full((2,), 24, dtype=torch.int32, device=DEVICE)
        d_m, _ = lm.decode_step(dense, masked_cfg, nxt, pos, c_m)
        for name, p, pc in (("packed", packed, pcfg),
                            ("kernel", kparams, kcfg)):
            lg, c = lm.prefill(p, pc, toks, cache_len=32)
            d, _ = lm.decode_step(p, pc, nxt, pos, c)
            e_pre, e_dec = rel_err(lg, lg_m), rel_err(d, d_m)
            log(f"  {name} vs masked (fp32, TF32 off): prefill rel err "
                f"{e_pre:.3g}, decode rel err {e_dec:.3g} (tolerance 1e-4 "
                f"of the logit scale)")
            check(e_pre < 1e-4 and e_dec < 1e-4,
                  f"{name} path disagrees with masked")
            check(bool(torch.isfinite(lg).all() and torch.isfinite(d).all()),
                  "non-finite logits")
            errs[name] = dict(prefill_rel_err=e_pre, decode_rel_err=e_dec)
    slot = dense["segments"][0]["slot0"]
    w1_path = ("segments", 0, "slot0", "ffn", "w1", "w")
    with torch.no_grad():
        h0 = rmsnorm_apply(lm.layer_params(slot["norm1"], 0),
                           embedding_apply(dense["embed"], toks,
                                           dtype=torch.float32),
                           eps=cfg.norm_eps)
    layer0 = dict(
        cfg=masked_cfg, toks=toks, h0=h0,
        mixer=lm.layer_params(slot["mixer"], 0),
        w1=slot["ffn"]["w1"]["w"][0], w1_mask=masks[w1_path][0],
        w1_bsr=kparams["segments"][0]["slot0"]["ffn"]["sasp_bsr"]["w1"]
        .layer(0))
    return dict(errs["packed"], kernel=errs["kernel"]), layer0


def ablation_phase(torch, layer0, qw, counters):
    """The ablation kernels through their entry points on one fp32 layer
    of the served model, held against the served paths' own products.
    The launch counts of ``counters`` are set to 0 just before and read
    just after: this is those kernels' path."""
    from repro_torch.core.quantization import dequantize_int8
    from repro_torch.kernels.flash_attn.ops import mha
    from repro_torch.kernels.int8_gemm.gemm import int8_matmul
    from repro_torch.kernels.sasp_gemm.gemm import sasp_matmul
    from repro_torch.kernels.sasp_gemm.masked import masked_matmul
    from repro_torch.models.attention import _project_qkv, attend_chunked

    cfg, toks = layer0["cfg"], layer0["toks"]
    B, S = toks.shape
    h0 = layer0["h0"]                                # (B, S, d) fp32
    pos = torch.arange(S, dtype=torch.int32, device=DEVICE)
    x = h0.reshape(B * S, -1)
    w1, mask, bsr = layer0["w1"], layer0["w1_mask"], layer0["w1_bsr"]
    bf16 = torch.bfloat16
    with torch.no_grad():
        q, k, v = _project_qkv(layer0["mixer"], cfg, h0, pos[None])
        H, KH = q.shape[2], k.shape[2]
        xb, qb, kb, vb, w1b = (t.to(bf16) for t in (x, q, k, v, w1))
        reset(counters)
        got = dict(masked=masked_matmul(x, w1, mask),
                   masked_bf16=masked_matmul(xb, w1b, mask),
                   tile_skip=sasp_matmul(x, bsr),
                   int8=int8_matmul(x, qw),
                   flash=mha(q, k, v, pos, pos, window=S + 1),
                   int8_bf16=int8_matmul(xb, qw),
                   flash_bf16=mha(qb, kb, vb, pos, pos, window=S + 1))
        torch.cuda.synchronize()
        launches = read(counters)
        variants = {n: dict(counters[n].variant_launches)
                    for n in ("sasp_gemm_masked", "int8_gemm",
                              "flash_attention")}

        def attend(q_, k_, v_):
            return attend_chunked(q_.reshape(B, S, KH, H // KH, -1), k_, v_,
                                  pos, pos, window=S + 1).reshape(q_.shape)
        want = dict(masked=torch.matmul(x, w1),
                    masked_bf16=torch.matmul(xb, w1b),
                    tile_skip=torch.matmul(x, w1),
                    int8=torch.matmul(x, dequantize_int8(qw, x.dtype)),
                    flash=attend(q, k, v),
                    int8_bf16=torch.matmul(xb, dequantize_int8(qw, bf16)),
                    flash_bf16=attend(qb, kb, vb))
    errs = {n: (row_rel_err if n.startswith("flash") else rel_err)(
        got[n], want[n]) for n in got}
    tol = {n: 1e-2 if n.endswith("bf16") else 1e-4 for n in got}
    log(f"  on layer 0 of the served model ({B * S} rows; attention "
        f"{B}x{S} causal; fp32, and bf16 for the masked grid, int8 and "
        f"attention): rel err "
        f"vs the served paths' products {errs} (tolerance 1e-4 fp32, 1e-2 "
        f"bf16, per output row for attention); launches {launches}, by "
        f"variant {variants}")
    for n, e in errs.items():
        check(e < tol[n], f"{n} disagrees with its served path: {e:.3g}")
    for n in ("sasp_gemm_masked", "int8_gemm", "flash_attention",
              "sasp_gemm"):
        check(launches[n] > 0, f"kernel {n} never launched on its path")
    # the masked grid's tensor-core variant is its TMA-fed one
    both = {"sasp_gemm_masked": {"tma", "fma"}}
    for n, ran in variants.items():
        want_ran = both.get(n, {"mma", "fma"})
        check(set(ran) == want_ran,
              f"{n} ran {ran} on the ablation path, not {sorted(want_ran)}")
    return dict(rel_err=errs, launches=launches, variants=variants)


def reset(counters):
    for m in counters.values():
        m.launches = 0
        for name in ("variant_launches", "weight_launches"):
            if hasattr(m, name):
                getattr(m, name).clear()


def read(counters):
    return {name: m.launches for name, m in counters.items()}


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
    reset(counters)
    with torch.no_grad():
        got = lm.forward(params, pcfg, toks)
        launches = read(counters)
        ref = lm.forward(dense, mcfg, toks)
    err = rel_err(got, ref)
    log(f"  int8 packed vs fp32 masked, 1 layer: rel err {err:.3g} "
        f"(bound 5e-2); int8 launches {launches}")
    check(err < 5e-2, "int8 path outside the 5e-2 bound")
    for name in MAIN_PATH:
        check(launches[name] > 0, f"int8 variant of {name} never launched")
    return dict(rel_err=err, launches=launches)


# ---------------------------------------------------------------------------
# phase 7: training, checkpoints, serving the trained checkpoint
# ---------------------------------------------------------------------------

TRAIN = dict(layers=4, batch=4, seq=256, steps=20, lr=3e-4, warmup=3,
             sparsity=0.5)


def train_config(layers: int):
    """qwen3-32b at full width, fp32 master weights, bf16 compute, every
    layer recomputed in backward, SASP at 50% of the 32x32 FFN tiles."""
    from repro_torch.configs import SASPConfig
    return dataclasses.replace(
        main_config(layers, "bfloat16"), remat="full",
        sasp=SASPConfig(enabled=True, block_k=BLOCK, block_n=BLOCK,
                        sparsity=TRAIN["sparsity"]))


def _batch(torch, pipe):
    return {k: torch.from_numpy(v).to(DEVICE) for k, v in pipe.next().items()}


def _ffn_masks(overlay, grads):
    """(gradient of a masked FFN weight, its mask) for every masked FFN
    weight of the overlay (scope ffn)."""
    for si, seg in overlay["segments"].items():
        for slot, sp in seg.items():
            for mat, mask in sp["ffn"]["sasp_masks"].items():
                yield grads["segments"][int(si)][slot]["ffn"][mat]["w"], mask


def _pruned_grad_max(torch, overlay, grads):
    """The largest |gradient| over every pruned FFN tile (one layer at a
    time, to bound the temporaries)."""
    worst = torch.zeros((), device=DEVICE)
    for g, mask in _ffn_masks(overlay, grads):
        KB, NB = mask.shape[-2:]
        for layer in range(g.shape[0]):
            K, N = g.shape[-2:]
            tiles = g[layer].reshape(KB, K // KB, NB, N // NB).abs().amax(
                dim=(1, 3))
            worst = torch.maximum(worst, tiles.masked_fill(mask[layer],
                                                           0).amax())
    return worst


def _model_flops(cfg, params, batch: int, seq: int) -> float:
    """6 x (the layers' GEMM weights x tokens + the head table x the
    predicted positions) + causal attention's matmuls (forward and
    backward, 3x the forward); recomputation not counted."""
    from repro_torch.core.pruning import iter_leaves
    gemm = sum(w.numel() for path, w in iter_leaves(params["segments"])
               if path[-1] == "w")
    head = cfg.vocab_size * cfg.d_model
    attn_fwd = 4 * batch * cfg.num_heads * cfg.attn_head_dim * \
        seq * (seq + 1) // 2
    return (6 * (gemm * batch * seq + head * batch * (seq - 1))
            + 3 * attn_fwd * cfg.num_layers)


def train_full_width(torch):
    """(a) 20 timed steps after one untimed, 4 full-width layers, each
    run as the train step's two halves between CUDA events
    (``value_and_grad``, then ``global_norm`` and ``adamw_update``): the
    split, and the gradients for the pruned-tile check. Then 3 steps of
    ``make_train_step`` between CUDA events (the step time) and one under
    torch.profiler."""
    import numpy as np

    from repro_torch.core.sasp import build_sasp_overlay, sasp_summary
    from repro_torch.data.pipeline import DataConfig, Pipeline
    from repro_torch.models import lm
    from repro_torch.train.optimizer import (AdamWConfig, adamw_init,
                                             adamw_update, global_norm)
    from repro_torch.train.schedule import warmup_cosine
    from repro_torch.train.train_step import make_train_step, value_and_grad

    L, B, S = TRAIN["layers"], TRAIN["batch"], TRAIN["seq"]
    cfg = train_config(L)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    params = spread_output_scales(lm.init_params(cfg, seed=0, device=DEVICE),
                                  cfg)
    n_params = sum(p.numel() for p in _tensors(params))
    opt_cfg = AdamWConfig(lr=TRAIN["lr"])
    opt = adamw_init(params, opt_cfg)
    overlay, got = build_sasp_overlay(params, cfg.sasp)
    summ = sasp_summary(overlay)
    log(f"  qwen3-32b full width, {L} layers, {n_params / 1e9:.3f} B params "
        f"(fp32 master, bf16 compute, remat full); overlay at "
        f"{got:.6f} of {summ['total_tiles']} FFN tiles (scope ffn) built "
        f"at step 0; init + overlay {time.time() - t0:.1f} s")
    check(abs(got - TRAIN["sparsity"]) <= 1.0 / summ["total_tiles"],
          f"overlay sparsity {got} not within one tile of 50%")
    sched = warmup_cosine(TRAIN["warmup"], TRAIN["steps"])
    pipe = Pipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                               global_batch=B))
    rows = []
    for i in range(TRAIN["steps"] + 1):
        t = time.perf_counter()
        batch = _batch(torch, pipe)
        data_ms = (time.perf_counter() - t) * 1e3
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        loss, _, grads = value_and_grad(cfg, params, batch, overlay)
        ev[1].record()
        gnorm = global_norm(grads)
        params, opt = adamw_update(grads, opt, params, opt_cfg,
                                   lr_scale=sched(opt.step), gnorm=gnorm)
        ev[2].record()
        pruned = float(_pruned_grad_max(torch, overlay, grads))
        del grads
        torch.cuda.synchronize()
        fwd_bwd_ms, opt_ms = (ev[0].elapsed_time(ev[1]),
                              ev[1].elapsed_time(ev[2]))
        row = dict(step=i, loss=float(loss), grad_norm=float(gnorm),
                   fwd_bwd_ms=fwd_bwd_ms, opt_ms=opt_ms, data_ms=data_ms,
                   pruned_grad_max=pruned)
        rows.append(row)
        log(f"  step {i:2d}{' (untimed)' if i == 0 else ''}: loss "
            f"{row['loss']:.4f}, grad norm {row['grad_norm']:.3f}, forward "
            f"+ backward {fwd_bwd_ms:.1f} ms, optimizer {opt_ms:.1f} ms, "
            f"batch {data_ms:.2f} ms, pruned tiles' largest |grad| {pruned}")
        check(np.isfinite(row["loss"]), f"loss not finite at step {i}")
        check(pruned == 0.0,
              f"a pruned FFN tile got gradient {pruned} at step {i}")
    step_fn = make_train_step(cfg, opt_cfg, overlay=overlay,
                              lr_schedule=sched)
    e2e = []
    for i in range(3):
        batch = _batch(torch, pipe)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        params, opt, m = step_fn(params, opt, batch)
        ev[1].record()
        torch.cuda.synchronize()
        e2e.append(ev[0].elapsed_time(ev[1]))
        check(np.isfinite(float(m["loss"])),
              f"make_train_step's loss not finite at step {len(rows) + i}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    state = [params, opt]

    def one_step():
        state[0], state[1], _ = step_fn(state[0], state[1],
                                        _batch(torch, pipe))
    prof = _profiled(torch, one_step, 1, "train_step", ops_by_shape=(
        "aten::add", "aten::add_", "aten::fill_", "aten::zero_",
        "aten::cat", "aten::stack"))
    params, opt = state
    timed_rows = rows[1:]
    fwd_bwd_ms = sum(r["fwd_bwd_ms"] for r in timed_rows) / len(timed_rows)
    opt_ms = sum(r["opt_ms"] for r in timed_rows) / len(timed_rows)
    data_ms = sum(r["data_ms"] for r in timed_rows) / len(timed_rows)
    step_ms = sum(e2e) / len(e2e)
    tok_s = B * S / (step_ms / 1e3)
    flops = _model_flops(cfg, params, B, S)
    mfu = flops / (step_ms / 1e3) / h100().PEAK_FLOPS["bfloat16"]
    first, last5 = rows[1]["loss"], [r["loss"] for r in rows[-5:]]
    log(f"  {len(timed_rows)} timed steps in halves: forward + backward "
        f"{fwd_bwd_ms:.1f} ms, optimizer {opt_ms:.1f} ms (sum "
        f"{fwd_bwd_ms + opt_ms:.1f}); make_train_step {step_ms:.1f} ms/step "
        f"over {len(e2e)} steps {[round(x, 1) for x in e2e]} (CUDA events); "
        f"waiting for the batch {data_ms:.2f} ms/step (host build + copy, "
        f"device idle), {tok_s:.0f} tokens/s, peak {peak:.2f} GiB; model "
        f"utilization {mfu:.4f} ({flops / 1e12:.2f} TFLOP a step: 6 x "
        f"(GEMM weights + head table) x tokens + causal attention, "
        f"recomputation not counted, over 989 TFLOP/s bf16); loss "
        f"{first:.4f} at step 1 -> mean {sum(last5) / 5:.4f} over the last "
        f"5")
    check(sum(last5) / 5 < first,
          "the mean loss of the last 5 steps is not below step 1's")
    del params, opt, overlay, step_fn
    return dict(layers=L, params=n_params, achieved_sparsity=got,
                tiles=summ["total_tiles"], step_ms=step_ms, e2e_ms=e2e,
                opt_ms=opt_ms, fwd_bwd_ms=fwd_bwd_ms, data_ms=data_ms,
                tok_s=tok_s, peak_gib=peak, model_flops=flops, mfu=mfu,
                steps=rows, profile=prof)


def _tensors(tree):
    from repro_torch.train.checkpoint import named_leaves
    return [t for _, t in named_leaves(tree)]


def _rel_diff(a_tree, b_tree):
    """Largest |a - b| over each leaf's largest |b|, over every leaf."""
    from repro_torch.train.checkpoint import named_leaves
    worst = (0.0, "")
    for (n, a), (_, b) in zip(named_leaves(a_tree), named_leaves(b_tree)):
        a, b = a.float(), b.to(a.device).float()
        e = float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
        worst = max(worst, (e, n))
    return worst


def train_checkpoint_serve(torch, counters):
    """(b) 1 full-width layer, int8 moments: 6 steps with save_async at
    step 3; restore into a fresh state and run steps 4-6 again; serve the
    restored params packed through the serve launcher's --ckpt-dir path."""
    import shutil

    from repro_torch.core.sasp import build_sasp_overlay
    from repro_torch.data.pipeline import DataConfig, DataState, Pipeline
    from repro_torch.launch.serve import build_serving_params, restore_params
    from repro_torch.models import lm
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.schedule import warmup_cosine
    from repro_torch.train.train_step import make_train_step

    cfg = train_config(1)
    opt_cfg = AdamWConfig(lr=TRAIN["lr"], quantized=True)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN["seq"],
                      global_batch=TRAIN["batch"])

    def fresh(seed):
        p = spread_output_scales(lm.init_params(cfg, seed=seed,
                                                device=DEVICE), cfg)
        return p, adamw_init(p, opt_cfg)

    params, opt = fresh(0)
    need = 2 * sum(t.numel() * t.element_size()
                   for t in _tensors({"params": params, "opt": opt}))
    ckpt_dir = os.path.join(OUT_DIR, "train_ckpt")
    os.makedirs(OUT_DIR, exist_ok=True)
    free = shutil.disk_usage(OUT_DIR).free
    check(free > need, f"disk too short for the checkpoint: {free / 1e9:.1f}"
          f" GB free under {OUT_DIR}, {need / 1e9:.1f} GB needed")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    overlay, _ = build_sasp_overlay(params, cfg.sasp)
    step_fn = make_train_step(
        cfg, opt_cfg, overlay=overlay,
        lr_schedule=warmup_cosine(TRAIN["warmup"], TRAIN["steps"]))
    pipe = Pipeline(dcfg)
    mgr = CheckpointManager(ckpt_dir, keep=1)
    losses = []
    try:
        for i in range(6):
            params, opt, m = step_fn(params, opt, _batch(torch, pipe))
            losses.append(float(m["loss"]))
            if i + 1 == 3:
                t = time.perf_counter()
                mgr.save_async(3, {"params": params, "opt": opt},
                               extra=pipe.state.to_dict())
                t_snap = time.time()
                stall_ms = (time.perf_counter() - t) * 1e3
        mgr.wait()
        step_dir = os.path.join(ckpt_dir, f"step_{3:010d}")
        files = [os.path.join(step_dir, f) for f in os.listdir(step_dir)]
        n_bytes = sum(os.path.getsize(f) for f in files)
        write_s = os.path.getmtime(os.path.join(step_dir, "manifest.json")) \
            - t_snap
        log(f"  1 layer, int8 moments: losses {losses}; save_async at step "
            f"3: stall {stall_ms:.1f} ms (host snapshot), write "
            f"{write_s:.2f} s in the background ({n_bytes / 1e9:.3f} GB, "
            f"{n_bytes / 1e9 / max(write_s, 1e-9):.2f} GB/s)")
        p2, o2 = fresh(1)
        t = time.perf_counter()
        state, extra = mgr.restore({"params": p2, "opt": o2})
        restore_s = time.perf_counter() - t
        del p2, o2
        p2, o2 = state["params"], state["opt"]
        pipe2 = Pipeline(dcfg, state=DataState.from_dict(extra))
        resumed = []
        for i in range(3, 6):
            p2, o2, m = step_fn(p2, o2, _batch(torch, pipe2))
            resumed.append(float(m["loss"]))
        loss_err = max(abs(a - b) / abs(b)
                       for a, b in zip(resumed, losses[3:]))
        p_err, p_leaf = _rel_diff(p2, params)
        log(f"  restored in {restore_s:.2f} s; steps 4-6 resumed: losses "
            f"{resumed}, largest relative difference from the "
            f"uninterrupted run: losses {loss_err:.3g}, params {p_err:.3g} "
            f"({p_leaf}) (tolerance 1e-3 of each leaf's scale)")
        check(loss_err <= 1e-3 and p_err <= 1e-3,
              "the resumed run left the uninterrupted one")
        del params, opt, p2, o2, state, step_fn, overlay
        torch.cuda.empty_cache()

        with torch.no_grad():
            served = restore_params(ckpt_dir, lm.init_params(
                cfg, seed=2, device=DEVICE))
            served, scfg = build_serving_params(
                served, cfg, path="packed", sparsity=SPARSITY, scope="all")
        launches, e2e = _serve(torch, served, scfg, counters)
        for name in MAIN_PATH:
            check(launches[name] > 0,
                  f"kernel {name} never launched serving the checkpoint")
        want = {"sasp_gemm": "mma", "sasp_fused_ffn": "mma/mma"}
        for name, ran in e2e["variants"].items():
            check(set(ran) == {want[name]},
                  f"{name} ran {ran} serving the checkpoint, not only "
                  f"{want[name]}")
        parity, _ = parity_phase(torch, served, layers=1)
        del served
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    return dict(losses=losses, resumed=resumed, stall_ms=stall_ms,
                write_s=write_s, bytes=n_bytes, restore_s=restore_s,
                loss_rel_err=loss_err, param_rel_err=p_err,
                launches=launches, serve=e2e, parity=parity)


def train_card_vs_cpu(torch, cfg=None):
    """(c) one train step on the card against the same step on the CPU,
    both in the port, fp32, ``cfg`` (default: reduced qwen3-32b, 2
    layers, d 256), the overlay (built once, on the CPU) closed over;
    once more with 2 micro-batches. The loss and the MoE aux loss, the
    gradients and the moments must agree within 1e-5 of each leaf's
    scale; every element of the params within its own bound
    (``_param_bound_diff``). A stack with neither MoE nor SSM layers is
    also held flat at 1e-5 over the elements whose gradient is at least
    100 eps (``_conditioned_diff``); the largest difference over all
    params is printed beside it."""
    import copy

    from repro_torch.configs import SASPConfig, get_config, reduced
    from repro_torch.core.sasp import build_sasp_overlay
    from repro_torch.data.pipeline import DataConfig, lm_batch
    from repro_torch.models import lm
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.train_step import make_train_step, value_and_grad

    cfg = dataclasses.replace(
        cfg or reduced(get_config("qwen3-32b"), layers=2, d_model=256,
                       vocab=512),
        sasp=SASPConfig(enabled=True, block_k=BLOCK, block_n=BLOCK,
                        sparsity=0.5))
    base = spread_output_scales(lm.init_params(cfg, seed=0, device="cpu"),
                                cfg)
    overlay, _ = build_sasp_overlay(base, cfg.sasp)
    batch = lm_batch(DataConfig(vocab_size=512, seq_len=64,
                                global_batch=4), 0)
    opt_cfg = AdamWConfig()
    flat = cfg.moe is None and cfg.ssm is None
    out = {}
    for dev in ("cpu", DEVICE):
        p = _to(copy.deepcopy(base), dev)
        ov = _to(overlay, dev)
        b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        loss, metrics, grads = value_and_grad(cfg, p, b, ov)
        res = {"grads": grads, "loss": float(loss),
               "aux": float(metrics["aux"])}
        for k in (1, 2):
            pk = copy.deepcopy(p)
            pk, ok, _ = make_train_step(cfg, opt_cfg, overlay=ov,
                                        n_microbatches=k)(
                pk, adamw_init(pk, opt_cfg), b)
            res[k] = dict(params=pk, m=ok.m, v=ok.v)
        out[dev] = res
    errs = {k: (abs(out[DEVICE][k] - out["cpu"][k])
                / max(abs(out["cpu"][k]), 1e-30), k) for k in ("loss", "aux")}
    errs["grads"] = _rel_diff(out[DEVICE]["grads"], out["cpu"]["grads"])
    bounds = {}
    for k in (1, 2):
        card, cpu = out[DEVICE][k], out["cpu"][k]
        errs[f"m (K={k})"] = _rel_diff(card["m"], cpu["m"])
        errs[f"v (K={k})"] = _rel_diff(card["v"], cpu["v"])
        if flat:
            errs[f"params (K={k}), |g| >= 100 eps"] = _conditioned_diff(
                card["params"], cpu["params"], out["cpu"]["grads"],
                100 * opt_cfg.eps)
        errs[f"params (K={k}), all"] = _rel_diff(card["params"],
                                                 cpu["params"])
        bounds[k] = _param_bound_diff(card["params"], cpu["params"],
                                      card["m"], cpu["m"], opt_cfg)
    log("  card vs CPU, fp32, largest difference over each leaf's scale: "
        + ", ".join(f"{k} {e:.3g} ({n})" for k, (e, n) in errs.items()))
    for k, b in bounds.items():
        log(f"  params (K={k}), every element against its own bound: "
            f"largest |difference| / bound {b['ratio']:.3g} ({b['leaf']}); "
            f"{b['above']} of {b['elements']} elements have a bound above "
            f"1e-5 of their leaf's scale, by leaf {b['above_by_leaf']}")
        check(b["ratio"] <= 1, f"card and CPU differ in params (K={k}) "
              f"beyond an element's bound: {b['ratio']:.3g} at {b['leaf']}")
    for k, (e, n) in errs.items():
        if not k.endswith("all"):
            check(e <= 1e-5, f"card and CPU differ in {k}: {e:.3g} at {n}")
    return {k: dict(rel_err=e, leaf=n) for k, (e, n) in errs.items()} | {
        f"params (K={k}), bound": b for k, b in bounds.items()}


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to(v, dev) for v in tree)
    return tree.to(dev)


def _conditioned_diff(a_tree, b_tree, g_tree, floor):
    """``_rel_diff`` over the elements whose gradient is at least
    ``floor``: the first AdamW step moves an element by lr * g / (|g| +
    eps), which amplifies rounding in g by eps / (|g| + eps)^2 ~ 1/eps
    where |g| is near eps, and by under 1% of g's own relative error
    where |g| >= 100 eps."""
    from repro_torch.train.checkpoint import named_leaves
    grads = dict(named_leaves(g_tree))
    worst = (0.0, "")
    for (n, a), (_, b) in zip(named_leaves(a_tree), named_leaves(b_tree)):
        keep = grads[n].abs() >= floor
        a, b = a.float().cpu(), b.float()
        e = float(((a - b).abs() * keep).max()
                  / b.abs().max().clamp_min(1e-30))
        worst = max(worst, (e, n))
    return worst


def _param_bound_diff(a_tree, b_tree, ma_tree, mb_tree, opt_cfg):
    """Every element of the params after a first AdamW step (zero moments
    before) against its own bound. The step moves an element by
    lr * g / (|g| + eps), where g = m / (1 - b1) is the gradient it
    applied (with MoE, micro-batches route, and so differentiate,
    otherwise than the whole batch). An error dg in g (here the element's
    own, from the two sides' first moments, which their check holds
    within 1e-5) moves it by at most
    lr * eps * dg / (max(|g| - dg, 0) + eps)^2, and never by over 2 lr;
    the bound is that plus 1e-5 of the leaf's max|param|. Returns the
    largest |difference| / bound and its leaf, and how many elements, by
    leaf, have a bound above that flat term."""
    from repro_torch.train.checkpoint import named_leaves
    ma, mb = dict(named_leaves(ma_tree)), dict(named_leaves(mb_tree))
    lr, eps = opt_cfg.lr, opt_cfg.eps
    ratio, leaf, above, n_el, by_leaf = 0.0, "", 0, 0, {}
    for (n, a), (_, b) in zip(named_leaves(a_tree), named_leaves(b_tree)):
        if b.numel() == 0:
            continue
        g = mb[n].double().abs() / (1 - opt_cfg.b1)
        dg = (ma[n].double().cpu() - mb[n].double()).abs() / (1 - opt_cfg.b1)
        step = (lr * eps * dg / ((g - dg).clamp_min(0) + eps) ** 2
                ).clamp_max(2 * lr)
        a, b = a.double().cpu(), b.double()
        flat = 1e-5 * float(b.abs().max())
        r = float(((a - b).abs() / (flat + step).clamp_min(1e-30)).max())
        if r > ratio:
            ratio, leaf = r, n
        k = int((step > flat).sum())
        above, n_el = above + k, n_el + b.numel()
        if k:
            by_leaf[n] = k
    return dict(ratio=ratio, leaf=leaf, above=above, elements=n_el,
                above_by_leaf=by_leaf)


def train_phase(torch, counters):
    t0 = time.time()
    torch.cuda.empty_cache()
    log(f"  device memory held before the phase: "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    log("  (a) full width: 4 layers, batch 4 x 256 tokens, 20 steps")
    out = {"a": train_full_width(torch)}
    torch.cuda.empty_cache()
    log("  (b) checkpoint, resume and serve: 1 full-width layer, int8 "
        "moments")
    out["b"] = train_checkpoint_serve(torch, counters)
    torch.cuda.empty_cache()
    log("  (c) one step on the card against the CPU, fp32, 2 layers, d 256")
    out["c"] = train_card_vs_cpu(torch)
    out["seconds"] = time.time() - t0
    log(f"  phase 7: {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 8: the other model families (MoE, SSM, hybrid) on one card
# ---------------------------------------------------------------------------

FAMILY = dict(moonshot_layers=8, parity_layers=2, slots=4, cache_len=256,
              max_new=16, preempts={3: True, 6: False})


def moonshot_config(layers: int, compute: str):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("moonshot-v1-16b-a3b"),
                               num_layers=layers, compute_dtype=compute)


def mamba_config(layers: int, compute: str):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("mamba2-780m"), num_layers=layers,
                               compute_dtype=compute)


def jamba_config(weights: str):
    """jamba-1.5-large's one 8-layer super-block at d_model 1024 (the
    reduced config's widths: 128 SSM heads of 16, state 16, 4 experts top
    2, d_ff 1024), bf16 compute, weights stored in ``weights``. With the
    launcher's fp32 masters a mamba layer's products come out fp32 (JAX's
    promotion), which carries the residual, and so the kernels' inputs,
    in fp32: both kernels then run their FMA variants. bf16 weights keep
    the residual in bf16 and the kernels on their tensor-core variants."""
    from repro_torch.configs import get_config, reduced
    return dataclasses.replace(
        reduced(get_config("jamba-1.5-large-398b"), layers=8, d_model=1024,
                vocab=65536),
        param_dtype=weights, compute_dtype="bfloat16")


def _served(torch, cfg, seed=0):
    """Random weights from ``seed`` (output projections spread as in
    phase 3), 50% of the 32x32 tiles pruned with scope all, packed."""
    from repro_torch.launch.serve import build_serving_params
    from repro_torch.models import lm
    return build_serving_params(
        spread_output_scales(lm.init_params(cfg, seed=seed, device=DEVICE),
                             cfg),
        cfg, path="packed", sparsity=SPARSITY, scope="all", verbose=False)


def _family_serve(torch, name, params, cfg, counters, preempts=()):
    """The launcher's 4 prompts, 16 new tokens each, through
    Engine(4 slots, cache 256) after one untimed run of the same prompts;
    every step timed, every decode step's logits and every token's top-2
    margin recorded, launches counted from 0 over the timed run."""
    from repro_torch.launch.serve import synthetic_requests
    from repro_torch.serve.engine import Engine

    F = FAMILY
    Engine(params, cfg, batch_slots=F["slots"], cache_len=F["cache_len"]
           ).run(synthetic_requests(F["slots"], cfg.vocab_size, 2))
    _sync(torch)
    reqs = synthetic_requests(F["slots"], cfg.vocab_size, F["max_new"])
    eng = Engine(params, cfg, batch_slots=F["slots"],
                 cache_len=F["cache_len"])
    rec = _recording(eng)
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2**30
    reset(counters)
    streams, steps = _drive_timed(torch, eng, reqs, preempts=preempts)
    launches = read(counters)
    variants = {n: dict(m.variant_launches) for n, m in counters.items()
                if n in MAIN_PATH and m.launches}
    peak = torch.cuda.max_memory_allocated() / 2**30
    t = _step_times(steps)
    log(f"  {name}: prefill {t['prefill_ms']:.1f} ms, decode "
        f"{t['decode_ms_per_step']:.2f} ms/step, {t['tok_s']:.1f} tok/s, "
        f"{t['steps']} steps, peak {peak:.2f} GiB ({held:.2f} held "
        f"before the run); launches "
        f"{ {n: launches[n] for n in MAIN_PATH} } by variant {variants}; "
        f"preemptions {eng.stats['preemptions']}, resumes "
        f"{eng.stats['resumes']}")
    check(all(len(st) == F["max_new"] for st in streams.values()),
          f"{name}: not every request produced {F['max_new']} tokens")
    check(all(0 <= tok < cfg.vocab_size for st in streams.values()
              for tok in st), f"{name}: token id out of the vocabulary")
    check(all(bool(torch.isfinite(x).all()) for x in rec["steps"]),
          f"{name}: non-finite logits")
    return dict(streams=streams, logits=rec["steps"], margins=rec["margins"],
                timing=t, peak_gib=peak, held_gib=held, launches=launches,
                variants=variants, preemptions=eng.stats["preemptions"])


def _deterministic(name, a, b):
    """Two runs of the same requests: equal streams and every decode
    step's logits equal bit for bit."""
    torch = sys.modules["torch"]
    check(a["streams"] == b["streams"], f"{name}: streams differ between "
          f"two runs of the same requests")
    check(len(a["logits"]) == len(b["logits"]) and all(
        torch.equal(x, y) for x, y in zip(a["logits"], b["logits"])),
        f"{name}: decode logits differ between two runs")
    log(f"  {name}: a second run gives the same streams and "
        f"{len(a['logits'])} decode steps' logits bit for bit")


def _packed_vs_masked(torch, name, params, cfg):
    """fp32: the packed model's prefill logits (2 x 24 tokens) and first
    decode step against the masked-dense model on the same pruned
    weights, within 1e-4 of the logit scale."""
    from repro_torch.core.deploy import strip_packed
    from repro_torch.models import lm

    masked = strip_packed(params)
    mcfg = dataclasses.replace(cfg, sasp=dataclasses.replace(
        cfg.sasp, path="masked"))
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (2, 24), generator=gen,
                         device=DEVICE)
    pos = torch.full((2,), 24, dtype=torch.int32, device=DEVICE)
    with torch.no_grad():
        lg_m, c_m = lm.prefill(masked, mcfg, toks, cache_len=32)
        nxt = torch.argmax(lg_m[:, 0], dim=-1, keepdim=True)
        d_m, _ = lm.decode_step(masked, mcfg, nxt, pos, c_m)
        lg, c = lm.prefill(params, cfg, toks, cache_len=32)
        d, _ = lm.decode_step(params, cfg, nxt, pos, c)
    e_pre, e_dec = rel_err(lg, lg_m), rel_err(d, d_m)
    log(f"  {name}: fp32 packed vs masked, prefill rel err {e_pre:.3g}, "
        f"decode rel err {e_dec:.3g} (tolerance 1e-4 of the logit scale)")
    check(e_pre < 1e-4 and e_dec < 1e-4, f"{name}: packed disagrees with "
          f"masked")
    return dict(prefill_rel_err=e_pre, decode_rel_err=e_dec)


def _kernel_checks(name, run, want):
    """Every kernel of ``want`` launched, only on its tensor-core variant;
    the others not at all."""
    for k in MAIN_PATH:
        if k in want:
            check(run["launches"][k] > 0, f"{name}: {k} never launched")
            check(set(run["variants"].get(k, {})) == {want[k]},
                  f"{name}: {k} ran {run['variants'].get(k)}, not only "
                  f"{want[k]}")
        else:
            check(run["launches"][k] == 0, f"{name}: {k} launched")


def _summary(run):
    return {k: v for k, v in run.items()
            if k not in ("logits", "margins", "streams")} | dict(
        streams={str(r): s for r, s in run["streams"].items()})


def families_moe(torch, counters, cfg, parity_cfg):
    """(a) moonshot-v1-16b-a3b."""
    t0 = time.time()
    params, cfg = _served(torch, cfg)
    _sync(torch)
    log(f"  (a) {cfg.name}: d_model {cfg.d_model}, heads {cfg.num_heads}/"
        f"{cfg.num_kv_heads} of {cfg.head_dim}, {cfg.moe.num_experts} "
        f"experts top {cfg.moe.top_k}, capacity {cfg.moe.capacity_factor}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; depth cut 48 -> "
        f"{cfg.num_layers} layers; init + prune + pack "
        f"{time.time() - t0:.1f} s, device memory "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB")
    first = _family_serve(torch, "(a)", params, cfg, counters)
    _kernel_checks("(a)", first, {"sasp_gemm": "mma"})
    forwards = 1 + len(first["logits"])
    per = first["launches"]["sasp_gemm"] / forwards
    log(f"  (a) tile-skip GEMM launches per forward: {per:g} (4 "
        f"projections x {cfg.num_layers} layers = {4 * cfg.num_layers})")
    check(per == 4 * cfg.num_layers, "(a) the tile-skip GEMM did not run "
          "once per projection and layer")
    second = _family_serve(torch, "(a) again", params, cfg, counters)
    _deterministic("(a)", first, second)
    prof = profile_phase(torch, params, cfg, tag="moonshot_")
    del params
    torch.cuda.empty_cache()
    parity = _packed_vs_masked(torch, f"(a) at {parity_cfg.num_layers} "
                               "layers", *_served(torch, parity_cfg))
    torch.cuda.empty_cache()
    return dict(serve=_summary(first), parity=parity, profile=prof,
                seconds=time.time() - t0)


def families_ssm(torch, counters, cfg, parity_cfg):
    """(b) mamba2-780m whole."""
    from repro_torch.launch.serve import synthetic_requests
    from repro_torch.models import lm

    t0 = time.time()
    params, cfg = _served(torch, cfg)
    s = cfg.ssm
    n_params = sum(t.numel() for t in _tensors(params))
    log(f"  (b) {cfg.name}: d_model {cfg.d_model}, d_inner "
        f"{s.d_inner(cfg.d_model)}, {s.num_heads(cfg.d_model)} heads of "
        f"{s.head_dim}, state {s.state_dim}, conv {s.conv_kernel}, chunk "
        f"{s.chunk_size}, vocab {cfg.vocab_size}, {cfg.num_layers} layers, "
        f"{n_params / 1e9:.3f} B params; fp32 master weights, "
        f"{cfg.compute_dtype} compute (the SSM's products promote to fp32); "
        f"nothing packs (the SSM serves masked-dense)")
    run = _family_serve(torch, "(b)", params, cfg, counters,
                        preempts=FAMILY["preempts"])
    _kernel_checks("(b)", run, {})
    check(run["preemptions"] == 2, "(b) expected 2 preemptions")
    solo, margins = _solo_oracle(torch, params, cfg, synthetic_requests(
        FAMILY["slots"], cfg.vocab_size, FAMILY["max_new"]))
    ties = _greedy_equal("(b)", run["streams"], solo, margins,
                         ref="the solo run")
    log(f"  (b) streams greedy-equal to each request alone "
        f"({len(ties)} near-ties)")
    prof = profile_phase(torch, params, cfg, tag="mamba2_")
    del params
    torch.cuda.empty_cache()
    # fp32, 2 layers: prefill 16 tokens and decode 8 against the forward
    params, pcfg = _served(torch, parity_cfg)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(4)
    toks = torch.randint(0, pcfg.vocab_size, (2, 24), generator=gen,
                         device=DEVICE)
    with torch.no_grad():
        full = lm.forward(params, pcfg, toks)
        lg, caches = lm.prefill(params, pcfg, toks[:, :16], cache_len=24)
        errs = [float((lg[:, 0] - full[:, 15]).abs().max())]
        for t in range(16, 24):
            lg, caches = lm.decode_step(
                params, pcfg, toks[:, t:t + 1],
                torch.full((2,), t, dtype=torch.int32, device=DEVICE),
                caches)
            errs.append(float((lg[:, 0] - full[:, t]).abs().max()))
    log(f"  (b) fp32 {pcfg.num_layers} layers: prefill + 8 decode steps "
        f"against the forward, largest |difference| {max(errs):.3g} "
        f"(bound 5e-3, the reference's)")
    check(max(errs) < 5e-3, "(b) decode disagrees with the forward")
    del params, caches
    torch.cuda.empty_cache()
    return dict(serve=_summary(run), near_ties=ties, profile=prof,
                decode_vs_forward_max_abs=max(errs),
                seconds=time.time() - t0)


def families_hybrid(torch, counters):
    """(c) jamba's hybrid super-block: with bf16 weights (both kernels on
    their tensor-core variants), twice, then fp32 against masked; and as
    the launcher builds it, fp32 masters (both kernels on FMAs)."""
    t0 = time.time()
    params, cfg = _served(torch, jamba_config("bfloat16"))
    kinds = ["attn" if m == 0 else "mamba" for m in cfg.layer_mixer_kinds()]
    ffns = ["moe" if f else "dense" for f in cfg.layer_ffn_kinds()]
    log(f"  (c) {cfg.name} reduced: d_model {cfg.d_model}, layers "
        f"{list(zip(kinds, ffns))}, {cfg.moe.num_experts} experts top "
        f"{cfg.moe.top_k}, vocab {cfg.vocab_size}, weights and compute "
        f"{cfg.compute_dtype}")
    first = _family_serve(torch, "(c)", params, cfg, counters)
    _kernel_checks("(c)", first, {"sasp_gemm": "mma",
                                  "sasp_fused_ffn": "mma/mma"})
    second = _family_serve(torch, "(c) again", params, cfg, counters)
    _deterministic("(c)", first, second)
    fp32 = _to_fp32(params, dataclasses.replace(
        cfg, param_dtype="float32", compute_dtype="float32"))
    del params
    parity = _packed_vs_masked(torch, "(c)", *fp32)
    del fp32
    torch.cuda.empty_cache()
    params, cfg = _served(torch, jamba_config("float32"))
    log(f"  (c) as the serve launcher builds it: fp32 master weights, "
        f"{cfg.compute_dtype} compute")
    launcher = _family_serve(torch, "(c) launcher", params, cfg, counters)
    _kernel_checks("(c) launcher", launcher, {"sasp_gemm": "fma",
                                              "sasp_fused_ffn": "fma/fma"})
    del params
    torch.cuda.empty_cache()
    return dict(serve=_summary(first), launcher=_summary(launcher),
                parity=parity, seconds=time.time() - t0)


def _to_fp32(params, cfg):
    """(params, cfg) of the served tree with its dense weights in fp32,
    packed again from them (bf16 -> fp32 is exact: the same pruned
    weights); ``cfg`` is the served config in fp32."""
    from repro_torch.core.deploy import deploy_packed, strip_packed
    from repro_torch.core.pruning import map_leaves
    dense = map_leaves(lambda _, t: t.float() if t.is_floating_point()
                       else t, strip_packed(params))
    return deploy_packed(dense, cfg)


def families_phase(torch, counters):
    """Phase 8, at the sizes of ``FAMILY`` and the configs above."""
    from repro_torch.configs import get_config, reduced

    F = FAMILY
    t0 = time.time()
    torch.cuda.empty_cache()
    out = {"a": families_moe(
        torch, counters, moonshot_config(F["moonshot_layers"], "bfloat16"),
        moonshot_config(F["parity_layers"], "float32"))}
    out["b"] = families_ssm(torch, counters, mamba_config(48, "bfloat16"),
                            mamba_config(F["parity_layers"], "float32"))
    out["c"] = families_hybrid(torch, counters)
    out["d"] = {}
    for arch in ("granite-moe-1b-a400m", "jamba-1.5-large-398b"):
        cfg = reduced(get_config(arch), layers=4, d_model=256, vocab=512)
        log(f"  (d) one train step on the card against the CPU: {arch}, "
            f"fp32, {cfg.num_layers} layers, d {cfg.d_model}")
        out["d"][arch] = train_card_vs_cpu(torch, cfg)
    out["seconds"] = time.time() - t0
    log(f"  phase 8: {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 9: tensor-parallel packed serving
# ---------------------------------------------------------------------------

# (a) shard counts of the shard loop; (b) the mesh's model ranks and the
# paged run's pool (8 pages of 32 tokens a slot, as phase 3c (a))
TPP = dict(tps=(2, 4, 8), mesh_tp=2, slots=4, cache_len=256, kv_pages=32)


def _tree_gib(tree) -> float:
    """GiB of every tensor in a param tree (containers included)."""
    torch = sys.modules["torch"]
    seen = []

    def walk(node):
        if isinstance(node, torch.Tensor):
            seen.append(node.numel() * node.element_size())
        elif isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, (tuple, list)):
            for v in node:
                walk(v)
        elif dataclasses.is_dataclass(node):
            for f in dataclasses.fields(node):
                walk(getattr(node, f.name))
    walk(tree)
    return sum(seen) / 2**30


def _digest(x) -> str:
    """sha256 of a tensor's fp32 bytes: equal digests, equal bits."""
    import hashlib
    return hashlib.sha256(x.float().cpu().numpy().tobytes()).hexdigest()


def _tp_serve(torch, params, cfg, counters, mesh=None, **engine_kw):
    """Phase 3's 4 requests of 16 tokens (Engine(4 slots, cache 256))
    after an untimed 2-token run; launch counts set to 0 just before and
    read just after; every decode step's logits kept with a digest."""
    from repro_torch.launch.serve import synthetic_requests
    from repro_torch.serve.engine import Engine
    kw = dict(batch_slots=TPP["slots"], cache_len=TPP["cache_len"],
              mesh=mesh, **engine_kw)
    Engine(params, cfg, **kw).run(synthetic_requests(4, cfg.vocab_size, 2))
    eng = Engine(params, cfg, **kw)
    rec = _recording(eng)
    reset(counters)
    streams, steps = _drive_timed(
        torch, eng, synthetic_requests(4, cfg.vocab_size, 16))
    launches = _launch_counts(counters)
    return dict(streams=streams, rec=rec, times=_step_times(steps),
                launches=launches,
                digests=[_digest(x) for x in rec["steps"]])


def _col_shard_bits(torch, whole, sharded, tp: int, rows) -> int:
    """Every layer's wq / wk / wv: each col shard's output equal to its
    columns of the unsharded kernel's bit for bit, at decode and prefill
    rows. Returns the number of shard outputs compared."""
    from repro_torch.core.deploy import packed_matmul
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(9)
    n = 0
    for seg_w, seg_s in zip(whole["segments"], sharded["segments"]):
        for slot in seg_w:
            gw = seg_w[slot]["mixer"]["sasp_packed"]
            gs = seg_s[slot]["mixer"]["sasp_packed"]
            for name in ("wq", "wk", "wv"):
                check(gs[name].shards == tp and gs[name].shard_kind == "col",
                      f"(a) tp={tp}: {name} is not col-sharded")
                K, N = gw[name].shape
                ns, nb = N // tp, N // gw[name].block[1]
                for li in range(gw[name].vals.shape[0]):
                    pw, ps = gw[name].layer(li), gs[name].layer(li)
                    for M in rows:
                        x = torch.randn((M, K), generator=gen, device=DEVICE
                                        ).to(torch.bfloat16)
                        want = packed_matmul(x, pw)
                        for sh in range(tp):
                            got = packed_matmul(x, ps.shard(sh), group_nb=nb)
                            check(torch.equal(
                                got, want[:, sh * ns:(sh + 1) * ns]),
                                f"(a) tp={tp} {name} layer {li} shard {sh} "
                                f"M={M}: not its columns of the unsharded "
                                f"kernel bit for bit")
                            n += 1
    return n


def _mesh_spec(layers: int, backend: str) -> dict:
    """(b)'s spec for ``serve_mesh``: phase 3's model on a (1, 2) mesh
    over ``backend``."""
    return dict(mesh=(1, TPP["mesh_tp"]), cfg=main_config(layers, "bfloat16"),
                device=DEVICE, backend=backend,
                build=dict(seed=0, sparsity=SPARSITY, scope="all",
                           int8_weights=False))


def spread_leaf(cfg):
    """``spread_output_scales`` as ``build_rank_params``' ``prepare``
    hook: wo and w2 times sqrt(2 L), in place, as each stacked leaf is
    drawn (the same product on the same values)."""
    f = max(1.0, (2 * cfg.num_layers) ** 0.5)

    def prepare(path, t):
        if path[-3:] in (("mixer", "wo", "w"), ("ffn", "w2", "w")):
            t.mul_(f)
        return t
    return prepare


def _rs_ag_check(torch, params, cfg, mesh) -> dict:
    """Layer 0's FFN on this rank's shard, reduced exactly and with
    ``tp_comm="rs_ag_int8"``, on the same input: the largest error over
    the exact output's largest magnitude (the reference's bound is
    2e-2)."""
    from repro_torch.distribution import context as dctx
    from repro_torch.models import ffn as ffn_mod
    from repro_torch.models import lm
    p0 = lm.layer_params(params["segments"][0]["slot0"]["ffn"], 0)
    gen = torch.Generator(device=mesh.device)
    gen.manual_seed(7)
    x = torch.randn((4, cfg.d_model), generator=gen, device=mesh.device
                    ).to(torch.bfloat16)
    with torch.no_grad(), dctx.use_mesh(mesh):
        exact = ffn_mod.ffn_apply(p0, dataclasses.replace(cfg, tp_comm="ar"),
                                  x).float()
        int8 = ffn_mod.ffn_apply(
            p0, dataclasses.replace(cfg, tp_comm="rs_ag_int8"), x).float()
    return dict(rel_err=float((int8 - exact).abs().max()
                              / exact.abs().max().clamp_min(1e-30)))


def _mesh_rank(rank: int, spec: dict, init_file: str) -> dict:
    """(b)'s model rank, spawned by the launcher's ``serve_mesh``: join
    the mesh over ``spec["backend"]``, build phase 3's model layer by
    layer (``build_rank_params``, wo and w2 spread as drawn), hold
    rs+int8-ag against the exact reduction, and serve (a)'s requests
    contiguous, then paged. Returns what the parent process checks."""
    import torch
    from repro_torch.kernels.sasp_gemm import fused_ffn, gemm
    from repro_torch.launch import serve as launch
    counters = {"sasp_gemm": gemm, "sasp_fused_ffn": fused_ffn}
    mesh = launch.join_mesh(rank, spec, init_file, backend=spec["backend"])
    dev = mesh.device
    t0 = time.perf_counter()
    params, cfg, lcfg, _ = launch.build_rank_params(
        spec["cfg"], tp=spec["mesh"][1], rank=mesh.model_rank, device=dev,
        prepare=spread_leaf(spec["cfg"]), **spec["build"])
    torch.cuda.synchronize(dev)
    out = dict(rank=rank, transport=mesh.transport,
               build_s=time.perf_counter() - t0,
               build_peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30,
               tree_gib=_tree_gib(params))
    torch.cuda.reset_peak_memory_stats(dev)
    out["rs_ag"] = _rs_ag_check(torch, params, lcfg, mesh)
    keep = ("streams", "digests", "times", "launches")
    run = _tp_serve(torch, params, lcfg, counters, mesh=mesh)
    out.update({k: run[k] for k in keep})
    run = _tp_serve(torch, params, lcfg, counters, mesh=mesh,
                    kv_pages=TPP["kv_pages"])
    out["paged"] = {k: run[k] for k in keep}
    out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    out["held_gib"] = torch.cuda.memory_allocated(dev) / 2**30
    return out


def tp_phase(torch, counters, layers: int = N_LAYERS):
    """Phase 9 alone (``tools/tp_phase.py``): phase 3's model built here,
    then (a) and (b)."""
    from repro_torch.launch import serve as launch
    from repro_torch.models import lm

    t_phase = time.time()
    cfg0 = main_config(layers, "bfloat16")
    params, cfg = launch.build_serving_params(
        spread_output_scales(lm.init_params(cfg0, seed=0, device=DEVICE),
                             cfg0),
        cfg0, path="packed", sparsity=SPARSITY, scope="all", verbose=False)
    torch.cuda.synchronize()
    log(f"  phase 3's model ({layers} layers) built in "
        f"{time.time() - t_phase:.1f} s")
    out, a2 = tp_shard_loop(torch, params, cfg, counters)
    del params
    torch.cuda.empty_cache()
    out["b"] = _tp_mesh(torch, layers, a2)
    out["seconds"] = time.time() - t_phase
    log(f"  phase 9: {out['seconds']:.1f} s")
    return out


def tp_shard_loop(torch, params, cfg, counters):
    """(a): phase 3's served tree, ``reshard_packed`` to tp 2, 4 and 8
    and served by the shard loop on one card. Returns the results and
    the tp=2 run (what (b) is held to)."""
    from repro_torch.core.deploy import reshard_packed
    from repro_torch.distribution.sharding import local_params, vocab_config

    t_phase = time.time()
    layers = cfg.num_layers
    # a 1-rank local tree: the containers without the dense masters
    params = local_params(params, cfg, 1, 0)
    log(f"  (a) phase 3's model ({layers} layers, bf16, 50% of the 32x32 "
        f"tiles, scope all), packed tp=1: containers "
        f"{_tree_gib(params):.2f} GiB")
    base = _tp_serve(torch, params, cfg, counters)
    out = {"a": {1: dict(times=base["times"], launches=base["launches"],
                         tree_gib=_tree_gib(params))}}
    rows = [4, 168]
    a2 = None
    for tp in TPP["tps"]:
        t0 = time.time()
        sharded = reshard_packed(params, cfg, tp=tp)
        torch.cuda.synchronize()
        reshard_s = time.time() - t0
        n_bits = _col_shard_bits(torch, params, sharded, tp, rows)
        run = _tp_serve(torch, sharded, vocab_config(cfg, tp), counters)
        for name in MAIN_PATH:
            got, want = run["launches"][name], base["launches"][name]
            check(got["total"] == tp * want["total"],
                  f"(a) tp={tp}: {name} launched {got['total']} times, not "
                  f"{tp} x tp=1's {want['total']}")
            ran = set(got["variant"])
            check(ran == set(want["variant"]) and ran <= {"mma", "mma/mma"},
                  f"(a) tp={tp}: {name} ran {got['variant']}")
        ties = _greedy_equal(f"(a) tp={tp}", run["streams"], base["streams"],
                             base["rec"]["margins"], ref="the tp=1 run")
        fwd = max(1, base["launches"]["sasp_fused_ffn"]["total"] // layers)
        out["a"][tp] = dict(
            times=run["times"], launches=run["launches"], near_ties=ties,
            reshard_s=reshard_s, col_shard_outputs_bit_equal=n_bits,
            tree_gib=_tree_gib(sharded))
        log(f"  (a) tp={tp}: reshard {reshard_s:.2f} s, containers "
            f"{out['a'][tp]['tree_gib']:.2f} GiB; {n_bits} col-shard outputs "
            f"(wq/wk/wv, every layer, rows {rows}) bit for bit the unsharded "
            f"kernel's columns; decode "
            f"{run['times']['decode_ms_per_step']:.2f} ms/step (tp=1 "
            f"{base['times']['decode_ms_per_step']:.2f}), prefill "
            f"{run['times']['prefill_ms']:.1f} ms; launches per forward "
            f"sasp_gemm {run['launches']['sasp_gemm']['total'] // fwd}, "
            f"fused FFN {run['launches']['sasp_fused_ffn']['total'] // fwd}"
            f" ({fwd} forwards), by variant "
            f"{ {n: l['variant'] for n, l in run['launches'].items()} }; "
            f"{len(ties)} near-tie divergences from tp=1")
        if tp == TPP["mesh_tp"]:
            a2 = {k: run[k] for k in ("streams", "digests", "launches",
                                      "times")}
        del sharded, run
    torch.cuda.empty_cache()
    out["seconds_a"] = time.time() - t_phase
    log(f"  phase 9 (a): {out['seconds_a']:.1f} s")
    return out, a2




def _check_mesh_run(tag, run, a2, tp):
    check(run["streams"] == a2["streams"],
          f"{tag}: streams differ from (a)'s tp={tp} shard loop")
    check(run["digests"] == a2["digests"],
          f"{tag}: decode logits are not bit for bit (a)'s tp={tp}")
    for name in MAIN_PATH:
        got, want = run["launches"][name], a2["launches"][name]
        check(got["total"] * tp == want["total"],
              f"{tag}: {name} launched {got['total']} times, not 1/{tp} of "
              f"(a)'s tp={tp} {want['total']}")
        check(got["variant"].keys() == want["variant"].keys(),
              f"{tag}: {name} ran {got['variant']}, (a) {want['variant']}")


def _tp_mesh(torch, layers: int, a2):
    """(b): --mesh 1,2 through the launcher's ``serve_mesh`` with
    ``_mesh_rank`` (2 spawned ranks), contiguous then paged in each rank,
    held bit for bit to (a)'s tp=2 shard loop; rs+int8-ag on layer 0's
    FFN; over NCCL too where the ranks can have a card each."""
    from repro_torch.launch import serve as launch
    tp = TPP["mesh_tp"]
    keep = ("rank", "transport", "build_s", "build_peak_gib", "tree_gib",
            "peak_gib", "held_gib", "rs_ag", "times", "launches")
    out = {}
    backends = ["gloo"] + (["nccl"] if torch.cuda.device_count() >= tp
                           else [])
    for backend in backends:
        t0 = time.time()
        res = launch.serve_mesh(_mesh_spec(layers, backend), _mesh_rank,
                                store_dir=OUT_DIR, timeout=400)
        wall = time.time() - t0
        for r in res:
            tag = f"(b) {backend} rank {r['rank']}"
            _check_mesh_run(f"{tag} contiguous", r, a2, tp)
            _check_mesh_run(f"{tag} paged", r["paged"], a2, tp)
            check(r["rs_ag"]["rel_err"] <= 2e-2,
                  f"{tag}: rs+int8-ag {r['rs_ag']['rel_err']:.3g} from the "
                  f"exact reduction (bound 2e-2)")
        r0 = res[0]
        log(f"  (b) --mesh 1,{tp} over {backend}: {tp} spawned ranks, "
            f"transport {r0['transport']}, {wall:.1f} s wall (build "
            f"{[round(r['build_s'], 1) for r in res]} s by rank, layer by "
            f"layer); every rank's streams and all {len(r0['digests'])} "
            f"decode steps' logits bit for bit (a)'s tp={tp}, contiguous "
            f"and paged; decode {r0['times']['decode_ms_per_step']:.2f} "
            f"ms/step (paged {r0['paged']['times']['decode_ms_per_step']:.2f}"
            f"; (a) tp={tp} {a2['times']['decode_ms_per_step']:.2f}), "
            f"prefill {r0['times']['prefill_ms']:.1f} ms; launches a rank "
            f"{ {n: l['total'] for n, l in r0['launches'].items()} }; GiB by "
            f"rank: tree {[round(r['tree_gib'], 2) for r in res]}, peak "
            f"building {[round(r['build_peak_gib'], 2) for r in res]}, peak "
            f"serving {[round(r['peak_gib'], 2) for r in res]}, held "
            f"{[round(r['held_gib'], 2) for r in res]}; rs+int8-ag "
            f"{[r['rs_ag']['rel_err'] for r in res]} of the exact reduction")
        out[backend] = dict(wall_s=wall, ranks=[{k: r[k] for k in keep}
                                                for r in res],
                            paged=[r["paged"]["times"] for r in res])
    if "nccl" not in out:
        out["nccl"] = "not run (1 card)"
        log(f"  nccl: not run ({torch.cuda.device_count()} card)")
    return out


# ---------------------------------------------------------------------------
# phase 10: qwen3-32b at its full depth
# ---------------------------------------------------------------------------

# (a)-(c) at ``layers``; (d) and (e) restore phase 3's 4-layer model
# (d)'s checkpoint: phase 3's model cut to ``ckpt_layers`` (4 until the
# smoke outgrew its time limit on slower hosts: 1210 s with 4)
DEPTH = dict(layers=64, tp=2, nccl_tp=4, ckpt_layers=2, new=16)


def _free(torch):
    """Collect the engines' reference cycles (their recording hooks),
    then return the freed blocks: a 64-layer tree must be gone before the
    next is built."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def _visits(params) -> dict:
    """Layer 0's visits: padded nnz / tiles of each packed matrix (per
    shard), and the fused FFN's nv / d_ff blocks."""
    slot = params["segments"][0]["slot0"]
    out = {}
    for n, pw in slot["mixer"]["sasp_packed"].items():
        tiles = (pw.shape[0] // pw.block[0]) * (pw.shape[1] // pw.block[1])
        out[n] = f"{pw.nnz}/{tiles // pw.shards}"
    pf = slot["ffn"]["sasp_fused"]
    out["ffn"] = f"{pf.nv}/{pf.d_ff // pf.block_f // pf.shards}"
    return out


def _plain_kernels():
    """Route ``core.deploy``'s two main-path calls to the kernels' plain
    versions (on CUDA tensors too) until the returned function is
    called; no launch is counted meanwhile."""
    from repro_torch.core import deploy
    from repro_torch.kernels.sasp_gemm import fused_ffn, gemm
    saved = deploy.sasp_gemm, deploy.fused_ffn

    def plain_gemm(x, vals, kn, col_ptr, n, scales=None, bias=None,
                   act=None, group_nb=None):
        return gemm.sasp_gemm_plain(x, vals, kn, n, scales, bias, act)

    def plain_ffn(x, w1v, w3v, w2v, b1, b3, b2, *, act="silu", scales=None):
        return fused_ffn.fused_ffn_plain(x, w1v, w3v, w2v, b1, b3, b2,
                                         act=act, scales=scales)

    deploy.sasp_gemm, deploy.fused_ffn = plain_gemm, plain_ffn

    def restore():
        deploy.sasp_gemm, deploy.fused_ffn = saved
    return restore


def _prefill_vs_plain(torch, params, cfg):
    """The first prefill of phase 3's 4 requests (one left-padded group,
    as the engine admits them) through both kernels and again through
    their plain versions on the same tree: the largest logit error over
    the logit scale, and the greedy tokens (a difference passes only at
    a top-2 margin under 1e-2 of the logit scale, printed)."""
    from repro_torch.launch.serve import synthetic_requests
    from repro_torch.models import lm
    reqs = synthetic_requests(4, cfg.vocab_size, 1)
    S = max(len(r.prompt) for r in reqs)
    toks = torch.zeros((len(reqs), S), dtype=torch.int32, device=DEVICE)
    pos = torch.empty((len(reqs), S), dtype=torch.int32, device=DEVICE)
    for i, r in enumerate(reqs):
        L = len(r.prompt)
        toks[i, S - L:] = torch.as_tensor(r.prompt, device=DEVICE)
        pos[i] = torch.arange(-(S - L), L, device=DEVICE)
    with torch.no_grad():
        got = lm.prefill(params, cfg, toks, 256, positions=pos)[0][:, 0]
        restore = _plain_kernels()
        try:
            t0 = time.perf_counter()
            want = lm.prefill(params, cfg, toks, 256, positions=pos)[0][:, 0]
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t0
        finally:
            restore()
    got, want = got.float(), want.float()
    scale = float(want.abs().max())
    err = float((got - want).abs().max()) / scale
    top = torch.topk(want, 2, dim=-1)
    ties = []
    for i in range(len(reqs)):
        a, b = int(got[i].argmax()), int(top.indices[i, 0])
        if a != b:
            margin = float(top.values[i, 0] - top.values[i, 1])
            log(f"  (a) request {i}: the kernels' first token {a}, the plain "
                f"versions' {b}; top-2 margin {margin:.4g}, logit scale "
                f"{scale:.4g}")
            check(margin < 1e-2 * scale, f"(a) request {i}: first token "
                  f"differs from the plain versions' where they are no "
                  f"near-tie")
            ties.append(dict(rid=i, margin=margin, got=a, want=b))
    return dict(rel_err=err, near_ties=ties, plain_s=plain_s, rows=S)


def _depth_launches(tag, launches, layers: int, tp: int):
    """Launches per forward: 4 tile-skip GEMMs and 1 fused FFN a layer a
    shard, all on the tensor-core variants. Returns the forwards."""
    ffn, gemm = launches["sasp_fused_ffn"], launches["sasp_gemm"]
    fwd = ffn["total"] // (layers * tp)
    check(fwd > 0 and ffn["total"] == fwd * layers * tp
          and gemm["total"] == 4 * fwd * layers * tp,
          f"{tag}: launches {gemm['total']} tile-skip GEMMs and "
          f"{ffn['total']} fused FFNs are not {4 * layers * tp} and "
          f"{layers * tp} a forward")
    check(set(gemm["variant"]) == {"mma"}
          and set(ffn["variant"]) == {"mma/mma"},
          f"{tag}: variants {gemm['variant']} / {ffn['variant']}, not mma")
    return fwd


def _depth_one_card(torch, counters, cfg0):
    """(a): the launcher's packed build at tp 1 (``build_rank_params``,
    layer by layer), served on one card, and its first prefill against
    the plain versions of both kernels."""
    from repro_torch.launch.serve import build_rank_params
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() / 2**30
    t0 = time.perf_counter()
    params, _, lcfg, _ = build_rank_params(
        cfg0, tp=1, rank=0, device=DEVICE, sparsity=SPARSITY, scope="all",
        prepare=spread_leaf(cfg0), verbose=True)
    torch.cuda.synchronize()
    out = dict(build_s=time.perf_counter() - t0,
               build_peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               tree_gib=_tree_gib(params), base_gib=base,
               table_gib=_tree_gib(params["embed"]), visits=_visits(params),
               ffn_gib=sum(_tree_gib(
                   seg["slot0"]["ffn"]["sasp_fused"])
                   for seg in params["segments"]))
    torch.cuda.reset_peak_memory_stats()
    run = _tp_serve(torch, params, lcfg, counters)
    out.update(times=run["times"], launches=run["launches"],
               held_gib=torch.cuda.memory_allocated() / 2**30,
               serve_peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    out["forwards"] = _depth_launches("(a)", run["launches"],
                                      cfg0.num_layers, 1)
    check(all(len(s) == DEPTH["new"] and all(0 <= t < cfg0.vocab_size
                                             for t in s)
              for s in run["streams"].values()) and len(run["streams"]) == 4,
          "(a): not every request produced its tokens in the vocabulary")
    out["plain"] = _prefill_vs_plain(torch, params, lcfg)
    check(math.isfinite(out["plain"]["rel_err"]),
          "(a): the prefill logits are not finite")
    t, a = out["times"], out["plain"]
    log(f"  (a) one card, {cfg0.num_layers} layers: build "
        f"{out['build_s']:.1f} s (peak {out['build_peak_gib']:.2f} GiB, "
        f"{base:.2f} held before), tree {out['tree_gib']:.2f} GiB (table "
        f"{out['table_gib']:.2f}, fused FFNs {out['ffn_gib']:.2f}; layer 0's "
        f"visits {out['visits']}); serving: held {out['held_gib']:.2f} GiB, "
        f"peak {out['serve_peak_gib']:.2f}; prefill {t['prefill_ms']:.1f} "
        f"ms, decode {t['decode_ms_per_step']:.2f} ms/step, "
        f"{t['tok_s']:.1f} tok/s; launches per forward "
        f"{run['launches']['sasp_gemm']['total'] // out['forwards']} "
        f"tile-skip GEMMs, "
        f"{run['launches']['sasp_fused_ffn']['total'] // out['forwards']} "
        f"fused FFNs ({out['forwards']} forwards, all mma); first prefill "
        f"({a['rows']} columns) vs the plain versions: {a['rel_err']:.3g} of "
        f"the logit scale, {len(a['near_ties'])} near-tie token(s) "
        f"(plain run {a['plain_s']:.1f} s)")
    for rid in sorted(run["streams"]):
        log(f"  (a) req {rid} -> {run['streams'][rid]}")
    return out, run, params


def _parted(streams, a_run) -> list:
    """Where each stream first parts from (a)'s tp=1 stream, and (a)'s
    top-2 margin there over its logit scale. At 64 layers in bf16 the
    shards' split sums move logits by more than phase 3c's near-tie
    bound, so this is reported, not held: the mesh is held bit for bit
    to the loop of its own shard count."""
    out = []
    for rid, want in a_run["streams"].items():
        got = streams[rid]
        t = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                 None)
        if t is not None:
            margin, scale = a_run["rec"]["margins"][(rid, t)][:2]
            out.append(dict(rid=rid, token=t, margin_of_scale=margin / scale))
    return out


def _depth_spec(cfg, tp: int, backend=None, **build) -> dict:
    """A ``serve_mesh`` spec for the launcher's ``serve_rank`` (or
    ``_depth_rank``): phase 3's requests on ``Engine(4 slots, cache
    256)``."""
    return dict(mesh=(1, tp), cfg=cfg, device=DEVICE, backend=backend,
                build=dict(seed=0, sparsity=SPARSITY, scope="all",
                           int8_weights=False, **build),
                requests=dict(n=4, max_new=DEPTH["new"], temperature=0.0,
                              eos_id=None),
                engine=dict(batch_slots=TPP["slots"],
                            cache_len=TPP["cache_len"]))


def _depth_rank(rank: int, spec: dict, init_file: str) -> dict:
    """(b)'s model rank: join the mesh, build its tree layer by layer
    from the seed (wo and w2 spread as drawn), serve as (a) serves, with
    every decode step's logits digested."""
    import torch
    import torch.distributed as dist
    from repro_torch.kernels.sasp_gemm import fused_ffn, gemm
    from repro_torch.launch import serve as launch
    counters = {"sasp_gemm": gemm, "sasp_fused_ffn": fused_ffn}
    mesh = launch.join_mesh(rank, spec, init_file, backend=spec["backend"])
    dev = mesh.device
    torch.cuda.reset_peak_memory_stats(dev)
    # ranks sharing one card build in turn, each releasing its build's
    # cached transients, so that one rank's transients stand beside the
    # trees
    turns = range(spec["mesh"][1]) if mesh.host_staged else [rank]
    for turn in turns:
        if turn == rank:
            t0 = time.perf_counter()
            params, _, lcfg, _ = launch.build_rank_params(
                spec["cfg"], tp=spec["mesh"][1], rank=mesh.model_rank,
                device=dev, prepare=spread_leaf(spec["cfg"]),
                **spec["build"])
            torch.cuda.synchronize(dev)
            build_s = time.perf_counter() - t0
            build_peak = torch.cuda.max_memory_allocated(dev) / 2**30
            torch.cuda.empty_cache()    # the build's transients, cached
        if mesh.host_staged:
            dist.barrier()
    out = dict(rank=rank, transport=mesh.transport, build_s=build_s,
               build_peak_gib=build_peak,
               tree_gib=_tree_gib(params),
               table_gib=_tree_gib(params["embed"]),
               table_rows=int(params["embed"]["emb"].shape[0]))
    torch.cuda.reset_peak_memory_stats(dev)
    run = _tp_serve(torch, params, lcfg, counters, mesh=mesh)
    out.update({k: run[k] for k in ("streams", "digests", "times",
                                     "launches")})
    out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    out["held_gib"] = torch.cuda.memory_allocated(dev) / 2**30
    return out


def _depth_tp(torch, counters, cfg0, a_run):
    """(b): the shard loop at tp 2 (every shard, built layer by layer)
    on this card, then ``--mesh 1,2`` through ``serve_mesh``, every rank
    bit for bit the loop; (c) ``--mesh 1,4`` over NCCL where there is a
    card per rank."""
    from repro_torch.launch import serve as launch
    tp, layers = DEPTH["tp"], cfg0.num_layers
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loop, dcfg, _, _ = launch.build_rank_params(
        cfg0, tp=tp, rank=None, device=DEVICE, sparsity=SPARSITY,
        scope="all", prepare=spread_leaf(cfg0))
    torch.cuda.synchronize()
    out = dict(loop=dict(build_s=time.perf_counter() - t0,
                         build_peak_gib=torch.cuda.max_memory_allocated()
                         / 2**30, tree_gib=_tree_gib(loop),
                         vocab_shards=dcfg.vocab_shards))
    check(dcfg.vocab_shards == tp, f"(b): the loop's table is not split "
          f"into {tp} vocab shards")
    out["loop"]["visits"] = _visits(loop)
    run = _tp_serve(torch, loop, dcfg, counters)
    del loop
    _free(torch)
    _depth_launches("(b) loop", run["launches"], layers, tp)
    parted = _parted(run["streams"], a_run)
    out["loop"].update(times=run["times"], launches=run["launches"],
                       parted_from_tp1=parted)
    log(f"  (b) before spawning the ranks this process holds "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
        f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved")
    t0 = time.time()
    res = launch.serve_mesh(_depth_spec(cfg0, tp, "gloo"), _depth_rank,
                            store_dir=OUT_DIR, timeout=600)
    wall = time.time() - t0
    for r in res:
        _check_mesh_run(f"(b) rank {r['rank']}", r, run, tp)
        check(r["table_rows"] == cfg0.vocab_size // tp,
              f"(b) rank {r['rank']} holds {r['table_rows']} table rows, "
              f"not V/{tp}")
    keep = ("rank", "transport", "build_s", "build_peak_gib", "tree_gib",
            "table_gib", "table_rows", "peak_gib", "held_gib", "times",
            "launches")
    out["mesh"] = dict(wall_s=wall, ranks=[{k: r[k] for k in keep}
                                           for r in res])
    r0, lp = res[0], out["loop"]
    log(f"  (b) shard loop tp={tp}: build {lp['build_s']:.1f} s (peak "
        f"{lp['build_peak_gib']:.2f} GiB), tree {lp['tree_gib']:.2f} GiB, "
        f"decode {run['times']['decode_ms_per_step']:.2f} ms/step, prefill "
        f"{run['times']['prefill_ms']:.1f} ms; parts from (a)'s tp=1 "
        f"streams at {parted}. --mesh 1,{tp} over {r0['transport']}: "
        f"{wall:.1f} s wall; every rank's streams and all "
        f"{len(r0['digests'])} decode steps' logits bit for bit the loop's; "
        f"by rank (building in turn on the shared card): build "
        f"{[round(r['build_s'], 1) for r in res]} s, peak "
        f"building {[round(r['build_peak_gib'], 2) for r in res]} GiB, "
        f"tree {[round(r['tree_gib'], 2) for r in res]} GiB (table "
        f"{[round(r['table_gib'], 2) for r in res]}, {r0['table_rows']} of "
        f"{cfg0.vocab_size} rows), held serving "
        f"{[round(r['held_gib'], 2) for r in res]}, peak serving "
        f"{[round(r['peak_gib'], 2) for r in res]}; decode "
        f"{r0['times']['decode_ms_per_step']:.2f} ms/step, prefill "
        f"{r0['times']['prefill_ms']:.1f} ms")
    del run
    n = DEPTH["nccl_tp"]
    if torch.cuda.device_count() >= n:
        t0 = time.time()
        res = launch.serve_mesh(_depth_spec(cfg0, n, "nccl"), _depth_rank,
                                store_dir=OUT_DIR, timeout=600)
        wall = time.time() - t0
        for r in res:
            _depth_launches(f"(c) rank {r['rank']}", r["launches"], layers,
                            1)
        out["nccl"] = dict(wall_s=wall, ranks=[{k: r[k] for k in keep}
                                               for r in res],
                           parted_from_tp1=_parted(res[0]["streams"], a_run))
        log(f"  (c) --mesh 1,{n} over {res[0]['transport']}: {wall:.1f} s "
            f"wall, {n} ranks' streams equal; decode "
            f"{res[0]['times']['decode_ms_per_step']:.2f} ms/step, tree "
            f"{[round(r['tree_gib'], 2) for r in res]} GiB, held "
            f"{[round(r['held_gib'], 2) for r in res]} GiB; parts from "
            f"(a)'s tp=1 streams at {out['nccl']['parted_from_tp1']}")
    else:
        out["nccl"] = f"not run ({torch.cuda.device_count()} card)"
        log(f"  (c) nccl: not run ({torch.cuda.device_count()} card)")
    return out


def _depth_ckpt(torch, counters):
    """(d) phase 3's model (``DEPTH["ckpt_layers"]`` layers, wo and w2
    spread) saved by the port's ``CheckpointManager``, restored through
    ``--mesh 1,2 --ckpt-dir --stream --trace-out --metrics-dump`` (the
    launcher's ``serve_rank``), against the shard loop at tp 2 built from
    the whole restore; (e) rank 0 alone wrote the trace and the
    metrics."""
    import shutil

    from repro_torch.launch import serve as launch
    from repro_torch.models import lm
    from repro_torch.serve.engine import _STAT_KEYS
    from repro_torch.train.checkpoint import CheckpointManager
    cfg = main_config(DEPTH["ckpt_layers"], "bfloat16")
    ckpt = os.path.join(OUT_DIR, "depth_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    out = {}
    try:
        t0 = time.perf_counter()
        with torch.no_grad():
            params = spread_output_scales(
                lm.init_params(cfg, seed=0, device=DEVICE), cfg)
            CheckpointManager(ckpt).save(3, {"params": params})
            del params
            out["save_s"] = time.perf_counter() - t0
            out["ckpt_gib"] = sum(
                os.path.getsize(os.path.join(d, f))
                for d, _, fs in os.walk(ckpt) for f in fs) / 2**30
            t0 = time.perf_counter()
            whole = launch.restore_params(
                ckpt, lm.init_params(cfg, seed=1, device=DEVICE))
            loop, lcfg = launch.build_serving_params(
                whole, cfg, path="packed", sparsity=SPARSITY, scope="all",
                tp=DEPTH["tp"], verbose=False)
            del whole
            out["whole_restore_s"] = time.perf_counter() - t0
        run = _tp_serve(torch, loop, lcfg, counters)
        del loop
        _free(torch)
        spec = _depth_spec(cfg, DEPTH["tp"], ckpt_dir=ckpt)
        trace = os.path.join(OUT_DIR, "depth_trace.json")
        prom = os.path.join(OUT_DIR, "depth_metrics.prom")
        for f in (trace, prom):
            if os.path.exists(f):
                os.remove(f)
        spec["serve"] = dict(stream=True, trace_out=trace, metrics_dump=prom,
                             metrics_interval=0.0)
        t0 = time.time()
        e = launch.serve_mesh(spec, store_dir=OUT_DIR, timeout=600)
        out["d"] = dict(wall_s=time.time() - t0,
                        build_s=[r["build_s"] for r in e])
        out["e"] = {}
        for r in e:
            check(r["streams"] == run["streams"],
                  f"(d) rank {r['rank']}: streamed and traced streams differ "
                  f"from the shard loop's tp={DEPTH['tp']} on the whole "
                  f"restore")
        check(e[0]["wrote"] == [trace, prom] and not any(
            r["wrote"] for r in e[1:]),
            f"(e): files written by rank: {[r['wrote'] for r in e]}, not "
            f"the trace and the metrics by rank 0 alone")
        with open(trace, encoding="utf-8") as fh:
            events = json.load(fh)["traceEvents"]
        with open(prom, encoding="utf-8") as fh:
            text = fh.read()
        missing = [k for k in _STAT_KEYS if f"serve_{k}_total" not in text]
        check(len(events) > 0 and not missing,
              f"(e): {len(events)} trace events; Prometheus text lacks "
              f"{missing}")
        out["e"].update(trace_events=len(events), prom_bytes=len(text))
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    log(f"  (d) checkpoint of phase 3's model ({cfg.num_layers} layers, "
        f"{out['ckpt_gib']:.2f} GiB on disk, saved in {out['save_s']:.1f} "
        f"s): --mesh 1,{DEPTH['tp']} --ckpt-dir --stream --trace-out "
        f"--metrics-dump, each rank restoring layer by layer "
        f"({[round(b, 1) for b in out['d']['build_s']]} s), "
        f"{out['d']['wall_s']:.1f} s wall; streams equal the shard loop's "
        f"tp={DEPTH['tp']} on the whole restore ({out['whole_restore_s']:.1f}"
        f" s to restore and build). (e) rank 0 alone wrote the trace "
        f"({out['e']['trace_events']} events) and the Prometheus text "
        f"(every engine counter)")
    return out


def depth_phase(torch, counters, layers: int = DEPTH["layers"]):
    """Phase 10: qwen3-32b at full width and ``layers`` layers (default
    all 64), built layer by layer: (a) one card, (b) the shard loop and
    ``--mesh 1,2``, (c) ``--mesh 1,4`` over NCCL where there are cards
    for it; then (d) and (e) on phase 3's model, cut to
    ``DEPTH["ckpt_layers"]`` layers, restored from a checkpoint. Run
    last, with every earlier model freed."""
    t_phase = time.time()
    cfg0 = main_config(layers, "bfloat16")
    log(f"  qwen3-32b at full width and {layers} layers; seed 0, wo and w2 "
        f"spread, 50% of the 32x32 tiles pruned (scope all), bf16")
    out = {}
    out["a"], a_run, params = _depth_one_card(torch, counters, cfg0)
    del params
    _free(torch)
    out["b"] = _depth_tp(torch, counters, cfg0, a_run)
    del a_run
    _free(torch)
    out["d"] = _depth_ckpt(torch, counters)
    out["seconds"] = time.time() - t_phase
    log(f"  phase 10: {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 11: data parallelism
# ---------------------------------------------------------------------------

# (a) and (b) at ``layers`` on one card, (c) at ``depth_layers`` on four;
# ``requests`` > 2 ranks x ``slots_per_rank``
# (2 layers; 4 until the smoke outgrew its time limit on slower hosts)
DPP = dict(layers=2, depth_layers=64, tp=2, requests=8, new=16,
           slots_per_rank=2, cache_len=256, kv_pages=20, engine_slots=4)


def _dp_requests(vocab: int, eos=None, new: int = DPP["new"]):
    """(a)'s traffic: the launcher's first 8 prompts (seed 0), ``new``
    tokens each, ``eos`` the EOS of every one (the launcher's
    ``--eos-id``)."""
    from repro_torch.launch.serve import synthetic_requests
    return synthetic_requests(DPP["requests"], vocab, new, eos_id=eos)


def _dp_sched_config(kv_pages=None):
    from repro_torch.serve.scheduler import SchedulerConfig
    return SchedulerConfig(slots_per_rank=DPP["slots_per_rank"],
                           cache_len=DPP["cache_len"], kv_pages=kv_pages)


def _dp_serve(torch, params, cfg, eos=None, kv_pages=None, mesh=None,
              counters=None):
    """(a)'s requests through ``ShardedScheduler``: meshless with 2 ranks,
    or on ``mesh`` (one rank a data index), after an untimed 2-token run
    of the same prompts. Launch counts set to 0 just before and read
    just after; this process's engine steps timed with the device
    synchronised, and the scheduler's steps around them. Returns the
    streams, the rank that served each request, the refills, tok/s over
    the run, a data rank's decode ms/step, the scheduler's ms a step
    beyond its engine's, and on a mesh the ms of its own collectives a
    step (part of that, with the wait for the slowest rank)."""
    from repro_torch.serve.scheduler import ShardedScheduler
    kw = dict(sched=_dp_sched_config(kv_pages))
    if mesh is None:
        kw["ranks"] = 2
    else:
        kw["mesh"] = mesh
    ShardedScheduler(params, cfg, **kw).run(
        _dp_requests(cfg.vocab_size, eos, new=2))
    sched = ShardedScheduler(params, cfg, **kw)
    rows, sync_ms = [], []
    eng_ms = _timed_scheduler(torch, sched, rows) if mesh is None else \
        _timed_mesh_scheduler(torch, sched, rows, sync_ms)
    reqs = _dp_requests(cfg.vocab_size, eos)
    if counters is not None:
        reset(counters)
    _sync(torch)
    t0 = time.perf_counter()
    done = sched.run(reqs)
    _sync(torch)
    wall = time.perf_counter() - t0
    st = sched.stats()
    out = dict(streams={r.rid: list(r.out_tokens) for r in done},
               served={r.rid: r.rank for r in done},
               refills=sum(r["continuous_refills"] for r in st["per_rank"]),
               wall_s=wall,
               tok_s=sum(len(r.out_tokens) for r in done) / wall,
               decode_ms_per_step=_decode_ms(eng_ms),
               steps=len(rows),
               sched_ms_per_step=sum(ms for ms, _ in rows) / len(rows),
               beyond_engine_ms_per_step=sum(ms - e for ms, e in rows)
               / len(rows),
               collectives_ms_per_step=sum(sync_ms) / len(rows))
    if counters is not None:
        out["launches"] = _launch_counts(counters)
    return out


def _timed_mesh_scheduler(torch, sched, rows, sync_ms):
    """``_timed_scheduler`` on a mesh: this process's own engine timed
    (its peers run elsewhere), and ``sync_ms`` gets the ms of each
    collective the scheduler adds (the clock's broadcast, the step
    records' all-gather)."""
    eng_ms = []
    for name in ("_now", "_exchange"):
        def timed(*a, inner=getattr(sched, name)):
            t = time.perf_counter()
            try:
                return inner(*a)
            finally:
                sync_ms.append((time.perf_counter() - t) * 1e3)
        setattr(sched, name, timed)
    eng = sched.shards[sched._me]
    inner_eng = eng.step

    def eng_step():
        adm = eng.stats["admitted"]
        t = time.perf_counter()
        try:
            return inner_eng()
        finally:
            _sync(torch)
            eng_ms.append((eng.rank, (time.perf_counter() - t) * 1e3,
                           eng.stats["admitted"] - adm))
    eng.step = eng_step
    inner = sched.step

    def step():
        k = len(eng_ms)
        _sync(torch)
        t = time.perf_counter()
        out = inner()
        _sync(torch)
        rows.append(((time.perf_counter() - t) * 1e3,
                     sum(ms for _, ms, _ in eng_ms[k:])))
        return out
    sched.step = step
    return eng_ms


def _dp_pick_eos(streams) -> int:
    """A token some stream first emits mid-decode (index 4 or later, else
    1 or later) and no stream emits first: with it as every request's
    EOS, a slot frees while the others decode."""
    firsts = {s[0] for s in streams.values()}
    for lo in (4, 1):
        for rid in sorted(streams):
            s = streams[rid]
            for i in range(lo, len(s) - 1):
                if s[i] not in s[:i] and s[i] not in firsts:
                    return int(s[i])
    fail("(a) no stream has a fresh token mid-decode: no EOS can free a "
         "slot")


def _dp_oracle(torch, params, cfg, tag: str, paged: bool = True):
    """The meshless 2-rank scheduler over ``params`` (the shard loop at
    the mesh's TP): run once to pick the EOS, then with it, contiguous
    and (``paged``) paged. Returns the EOS and the runs."""
    eos = _dp_pick_eos(_dp_serve(torch, params, cfg)["streams"])
    out = {"eos": eos}
    for name, pages in (("contiguous", None), ("paged", DPP["kv_pages"])):
        if name == "paged" and not paged:
            continue
        run = _dp_serve(torch, params, cfg, eos, pages)
        check(any(len(s) < DPP["new"] and s[-1] == eos
                  for s in run["streams"].values()),
              f"{tag} {name}: the EOS {eos} stopped no request mid-decode")
        check(run["refills"] >= 1, f"{tag} {name}: no slot was refilled")
        check(set(run["served"].values()) == {0, 1},
              f"{tag} {name}: one rank served every request")
        out[name] = run
    return out


def _dp_spec(layers: int, tp: int, backend: str, eos: int, paged: bool,
             engine: bool) -> dict:
    """A ``serve_mesh`` spec for ``_dp_rank``: phase 11's model on a
    (2, ``tp``) mesh over ``backend``."""
    return dict(mesh=(2, tp), cfg=main_config(layers, "bfloat16"),
                device=DEVICE, backend=backend, eos=eos, paged=paged,
                engine=engine,
                build=dict(seed=0, sparsity=SPARSITY, scope="all",
                           int8_weights=False))


def _dp_rank(rank: int, spec: dict, init_file: str) -> dict:
    """Phase 11's process, spawned by the launcher's ``serve_mesh``: join
    the (2, TP) mesh over ``spec["backend"]``, build its model rank's tree
    layer by layer (``build_rank_params``, wo and w2 spread as drawn),
    serve (a)'s requests through ``ShardedScheduler(mesh=)`` contiguous
    and (``paged``) paged, and (``engine``) (b)'s requests through one
    ``Engine`` on the mesh with 4 slots. Returns what the parent checks."""
    import torch
    from repro_torch.kernels.sasp_gemm import fused_ffn, gemm
    from repro_torch.launch import serve as launch
    from repro_torch.launch.serve import synthetic_requests
    from repro_torch.serve.engine import Engine
    counters = {"sasp_gemm": gemm, "sasp_fused_ffn": fused_ffn}
    mesh = launch.join_mesh(rank, spec, init_file, backend=spec["backend"])
    dev = mesh.device
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params, _, lcfg, _ = launch.build_rank_params(
        spec["cfg"], tp=spec["mesh"][1], rank=mesh.model_rank, device=dev,
        prepare=spread_leaf(spec["cfg"]), **spec["build"])
    torch.cuda.synchronize(dev)
    out = dict(rank=rank, data_rank=mesh.data_rank, transport=mesh.transport,
               build_s=time.perf_counter() - t0,
               build_peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30,
               tree_gib=_tree_gib(params))
    torch.cuda.reset_peak_memory_stats(dev)
    out["contiguous"] = _dp_serve(torch, params, lcfg, spec["eos"],
                                  mesh=mesh, counters=counters)
    if spec["paged"]:
        out["paged"] = _dp_serve(torch, params, lcfg, spec["eos"],
                                 DPP["kv_pages"], mesh=mesh,
                                 counters=counters)
    if spec["engine"]:
        kw = dict(batch_slots=DPP["engine_slots"],
                  cache_len=DPP["cache_len"], mesh=mesh)
        Engine(params, lcfg, **kw).run(
            synthetic_requests(4, lcfg.vocab_size, 2))
        eng = Engine(params, lcfg, **kw)
        reset(counters)
        streams, steps = _drive_timed(
            torch, eng, synthetic_requests(4, lcfg.vocab_size, DPP["new"]))
        out["engine"] = dict(layout=eng.layout, streams=streams,
                             times=_step_times(steps),
                             launches=_launch_counts(counters))
    out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    out["held_gib"] = torch.cuda.memory_allocated(dev) / 2**30
    # what serve_mesh holds equal in every process
    out["streams"] = out["contiguous"]["streams"]
    out["served"] = out["contiguous"]["served"]
    return out


def _dp_check(tag, res, oracle, kinds, layers):
    """Every process's streams and served ranks bit for bit the
    oracle's; a model rank's launches 4 tile-skip GEMMs and 1 fused FFN
    a layer a forward, all mma."""
    for r in res:
        for kind in kinds:
            got, want = r[kind], oracle[kind]
            check(got["streams"] == want["streams"],
                  f"{tag} {kind} process {r['rank']}: streams differ from "
                  f"the meshless 2-rank scheduler's")
            check(got["served"] == want["served"],
                  f"{tag} {kind} process {r['rank']}: requests served on "
                  f"other ranks than the meshless scheduler's")
            check(got["refills"] == want["refills"] >= 1,
                  f"{tag} {kind} process {r['rank']}: refills "
                  f"{got['refills']}, the meshless scheduler's "
                  f"{want['refills']}")
            _depth_launches(f"{tag} {kind} process {r['rank']}",
                            got["launches"], layers, 1)


def _dp_report(tag, res, oracle, kinds, wall):
    r0 = res[0]
    for kind in kinds:
        log(f"  {tag} {kind}: {len(res)} processes over {r0['transport']}, "
            f"{wall:.1f} s wall; streams and served ranks bit for bit the "
            f"meshless 2-rank scheduler's (refills {r0[kind]['refills']}); "
            f"tok/s {r0[kind]['tok_s']:.1f} on the mesh (meshless "
            f"{oracle[kind]['tok_s']:.1f}); decode ms/step by data rank "
            f"{ {r['data_rank']: round(r[kind]['decode_ms_per_step'][r['data_rank']], 2) for r in res} } "
            f"(meshless { {k: round(v, 2) for k, v in oracle[kind]['decode_ms_per_step'].items()} }); "
            f"scheduler step {r0[kind]['sched_ms_per_step']:.2f} ms, "
            f"{r0[kind]['beyond_engine_ms_per_step']:.2f} beyond its "
            f"engine's (meshless "
            f"{oracle[kind]['beyond_engine_ms_per_step']:.2f}), of which "
            f"in the scheduler's collectives (with the wait for the slower "
            f"rank) {r0[kind]['collectives_ms_per_step']:.2f}; launches a "
            f"process { {n: l['total'] for n, l in r0[kind]['launches'].items()} }")
    log(f"  {tag}: build s by process "
        f"{[round(r['build_s'], 1) for r in res]}, GiB held "
        f"{[round(r['held_gib'], 2) for r in res]}, peak "
        f"{[round(max(r['peak_gib'], r['build_peak_gib']), 2) for r in res]}"
        f" (tree {[round(r['tree_gib'], 2) for r in res]})")


def _dp_keep(r, kinds):
    out = {k: r[k] for k in ("rank", "data_rank", "transport", "build_s",
                             "build_peak_gib", "tree_gib", "peak_gib",
                             "held_gib")}
    for kind in kinds:
        out[kind] = {k: v for k, v in r[kind].items()
                     if k not in ("streams", "served")}
    return out


def _dp_one_card(torch):
    """(a) ``--mesh 2,1 --scheduler`` and ``--mesh 2,2 --scheduler`` (the
    latter with (b) ``--mesh 2,2``'s engine) on this card over gloo,
    host-staged."""
    from repro_torch.launch import serve as launch
    from repro_torch.launch.serve import synthetic_requests
    layers = DPP["layers"]
    cfg0 = main_config(layers, "bfloat16")
    out = {}
    kinds = ("contiguous", "paged")
    for tp in (1, DPP["tp"]):
        tag = f"(a) --mesh 2,{tp} --scheduler"
        loop, dcfg, _, _ = launch.build_rank_params(
            cfg0, tp=tp, rank=None, device=DEVICE, sparsity=SPARSITY,
            scope="all", prepare=spread_leaf(cfg0))
        oracle = _dp_oracle(torch, loop, dcfg, tag)
        solo = None
        if tp == DPP["tp"]:
            solo = _solo_oracle(torch, loop, dcfg,
                                synthetic_requests(4, dcfg.vocab_size,
                                                   DPP["new"]))
        del loop
        _free(torch)
        t0 = time.time()
        res = launch.serve_mesh(
            _dp_spec(layers, tp, "gloo", oracle["eos"], True, solo is not None),
            _dp_rank, store_dir=OUT_DIR, timeout=400)
        wall = time.time() - t0
        _dp_check(tag, res, oracle, kinds, layers)
        _dp_report(tag, res, oracle, kinds, wall)
        out[f"2,{tp}"] = dict(wall_s=wall, eos=oracle["eos"],
                              oracle={k: {kk: v for kk, v in oracle[k].items()
                                          if kk not in ("streams", "served")}
                                      for k in kinds},
                              processes=[_dp_keep(r, kinds) for r in res])
        if solo is not None:
            out["b"] = _dp_engine_check(res, solo)
    return out


def _dp_engine_check(res, solo):
    """(b): ``Engine(mesh=(2, 2))`` with 4 slots, split over 'data':
    every process's streams greedy-equal to each request served alone at
    tp 2 (phase 3c's near-tie rule)."""
    streams, margins = solo
    for r in res:
        e = r["engine"]
        check(e["layout"] == "slots split over data",
              f"(b) process {r['rank']}: layout {e['layout']!r}")
        check(e["streams"] == res[0]["engine"]["streams"],
              f"(b) process {r['rank']}: streams differ from process 0's")
        _depth_launches(f"(b) process {r['rank']}", e["launches"],
                        DPP["layers"], 1)
    ties = _greedy_equal("(b) --mesh 2,2", res[0]["engine"]["streams"],
                         streams, margins, ref="each request alone")
    e = res[0]["engine"]
    log(f"  (b) --mesh 2,2, one Engine of {DPP['engine_slots']} slots: "
        f"layout '{e['layout']}'; streams greedy-equal to each request "
        f"alone at tp {DPP['tp']}, {len(ties)} near-tie divergence(s); "
        f"decode ms/step by data rank "
        f"{ {r['data_rank']: round(r['engine']['times']['decode_ms_per_step'], 2) for r in res[::DPP['tp']]} }, "
        f"prefill {e['times']['prefill_ms']:.1f} ms, "
        f"{e['times']['tok_s']:.1f} tok/s; launches a process "
        f"{ {n: l['total'] for n, l in e['launches'].items()} }")
    return dict(layout=e["layout"], near_ties=ties,
                times=[r["engine"]["times"] for r in res],
                launches=e["launches"])


def _dp_four_cards(torch):
    """(c) ``--mesh 2,2 --scheduler`` at all 64 layers over NCCL, a card a
    process, against the meshless 2-rank scheduler over the shard loop at
    tp 2 on card 0 (its 55.5 GiB tree freed before the processes build)."""
    from repro_torch.launch import serve as launch
    layers, tp = DPP["depth_layers"], DPP["tp"]
    if torch.cuda.device_count() < 2 * tp:
        log(f"  (c) nccl: not run ({torch.cuda.device_count()} card)")
        return f"not run ({torch.cuda.device_count()} card)"
    tag = f"(c) --mesh 2,{tp} --scheduler, {layers} layers"
    cfg0 = main_config(layers, "bfloat16")
    t0 = time.perf_counter()
    loop, dcfg, _, _ = launch.build_rank_params(
        cfg0, tp=tp, rank=None, device=DEVICE, sparsity=SPARSITY,
        scope="all", prepare=spread_leaf(cfg0))
    torch.cuda.synchronize()
    loop_build_s = time.perf_counter() - t0
    loop_gib = _tree_gib(loop)
    oracle = _dp_oracle(torch, loop, dcfg, tag, paged=False)
    del loop
    _free(torch)
    t0 = time.time()
    res = launch.serve_mesh(
        _dp_spec(layers, tp, "nccl", oracle["eos"], False, False),
        _dp_rank, store_dir=OUT_DIR, timeout=900)
    wall = time.time() - t0
    _dp_check(tag, res, oracle, ("contiguous",), layers)
    log(f"  {tag}: the meshless oracle's tree {loop_gib:.2f} GiB on card 0, "
        f"built in {loop_build_s:.1f} s")
    _dp_report(tag, res, oracle, ("contiguous",), wall)
    return dict(wall_s=wall, eos=oracle["eos"], loop_gib=loop_gib,
                loop_build_s=loop_build_s,
                oracle={k: v for k, v in oracle["contiguous"].items()
                        if k not in ("streams", "served")},
                processes=[_dp_keep(r, ("contiguous",)) for r in res])


def dp_phase(torch):
    """Phase 11: data parallelism on phase 3's model, (a) and (b) on one
    card, (c) on four where the machine has them. Run last, with every
    earlier model freed."""
    t_phase = time.time()
    log(f"  qwen3-32b at full width; seed 0, wo and w2 spread, 50% of the "
        f"32x32 tiles pruned (scope all), bf16; {DPP['requests']} requests "
        f"of {DPP['new']} tokens, {DPP['slots_per_rank']} slots a scheduler "
        f"rank, every request's EOS a token that frees a slot mid-decode")
    out = _dp_one_card(torch)
    _free(torch)
    out["c"] = _dp_four_cards(torch)
    out["seconds"] = time.time() - t_phase
    log(f"  phase 11: {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 12: every serving path of the dense decoder on a mesh
# ---------------------------------------------------------------------------

# (a) at ``layers`` on one card, (c) at ``depth_layers`` on four
# (1 layer; 4 until PR 27, 2 until the smoke outgrew its time limit)
MPP = dict(layers=1, depth_layers=64, tp=2, nccl_tp=4, slots=4,
           cache_len=256, kv_pages=32, new=16, draft_k=4)
# name -> (path, sparsity, int8 weights, scope, paged, drafter: None or
# (its sparsity, its int8 flag)); at 75% a drafter of random weights
# accepts nothing (phase 3c), so one more at the target's own 50%
MESH_PATHS = {
    "--sasp 0": ("packed", 0.0, False, "all", False, None),
    "masked": ("masked", SPARSITY, False, "all", False, None),
    "masked int8": ("masked", SPARSITY, True, "ffn", False, None),
    "bsr": ("bsr", SPARSITY, False, "all", False, None),
    "kernel": ("kernel", SPARSITY, False, "all", False, None),
    "packed paged": ("packed", SPARSITY, False, "all", True, None),
    "packed drafter": ("packed", SPARSITY, False, "all", True, (0.75, False)),
    "packed int8 drafter": ("packed", SPARSITY, False, "all", True,
                            (0.75, True)),
    "packed drafter 50%": ("packed", SPARSITY, False, "all", True,
                           (SPARSITY, False)),
}

def _mp_build(torch, cfg0, name, tp, rank, device):
    """``build_rank_params`` of case ``name`` (wo and w2 spread as drawn),
    timed, with the peak GiB the build reached on ``device``."""
    from repro_torch.launch import serve as launch
    path, sparsity, int8, scope, _, drafter = MESH_PATHS[name]
    ds, dq = drafter or (None, False)
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    params, cfg, lcfg, draft = launch.build_rank_params(
        cfg0, tp=tp, rank=rank, device=device, sparsity=sparsity,
        scope=scope, int8_weights=int8, path=path, draft_sparsity=ds,
        draft_int8=dq, prepare=spread_leaf(cfg0))
    torch.cuda.synchronize(device)
    # the drafter shares the target's table and norms
    return params, cfg, lcfg, draft, dict(
        build_s=time.perf_counter() - t0,
        build_peak_gib=torch.cuda.max_memory_allocated(device) / 2**30,
        tree_gib=_tree_gib(params),
        draft_gib=0.0 if draft is None else _tree_gib(draft[0]["segments"]))


def _mp_serve(torch, params, cfg, counters, name, mesh=None, draft=None):
    """Phase 3's 4 requests of 16 tokens through ``Engine`` (4 slots,
    cache 256; paged where the case says, with its drafter) after an
    untimed 2-token run; launch counts set to 0 just before the timed run
    and read just after. Returns the streams, decode-logit digests, the
    top-2 margins, step times, launches (with the target forwards) and
    the speculation counters."""
    from repro_torch.launch.serve import SPEC_KEYS, synthetic_requests
    from repro_torch.serve.engine import Engine
    kw = dict(batch_slots=MPP["slots"], cache_len=MPP["cache_len"],
              mesh=mesh)
    if MESH_PATHS[name][4]:
        kw["kv_pages"] = MPP["kv_pages"]
    if draft is not None:
        kw.update(draft=draft, draft_k=MPP["draft_k"])
    Engine(params, cfg, **kw).run(synthetic_requests(4, cfg.vocab_size, 2))
    eng = Engine(params, cfg, **kw)
    rec = _recording(eng)
    fwd = [0]
    pre = eng._run_prefill

    def prefill(*a):
        fwd[0] += 1
        return pre(*a)
    eng._run_prefill = prefill
    reset(counters)
    streams, steps = _drive_timed(
        torch, eng, synthetic_requests(4, cfg.vocab_size, MPP["new"]))
    launches = _launch_counts(counters)
    return dict(streams=streams, digests=[_digest(x) for x in rec["steps"]],
                margins=rec["margins"], times=_step_times(steps),
                launches=launches, forwards=fwd[0] + len(rec["steps"]),
                spec={k: eng.stats[k] for k in SPEC_KEYS})


def _mp_rank(rank: int, spec: dict, init_file: str) -> dict:
    """Phase 12's model rank, spawned by the launcher's ``serve_mesh``:
    join the mesh over ``spec["backend"]``, then for each case build its
    trees layer by layer (``build_rank_params``), hold rs+int8-ag on the
    dense tree's FFN against the exact reduction, serve, free. Returns
    what the parent checks (the streams of every case under
    ``streams``, which ``serve_mesh`` holds equal in every process)."""
    import torch
    from repro_torch.kernels.sasp_gemm import fused_ffn, gemm
    from repro_torch.launch import serve as launch
    counters = {"sasp_gemm": gemm, "sasp_fused_ffn": fused_ffn}
    mesh = launch.join_mesh(rank, spec, init_file, backend=spec["backend"])
    dev = mesh.device
    cfg0 = main_config(spec["layers"], "bfloat16")
    out = dict(rank=rank, transport=mesh.transport, cases={}, streams={})
    for name in spec["cases"]:
        params, _, lcfg, draft, res = _mp_build(
            torch, cfg0, name, spec["mesh"][1], mesh.model_rank, dev)
        res["held_gib"] = torch.cuda.memory_allocated(dev) / 2**30
        if name == "--sasp 0" and spec["rs_ag"]:
            res["rs_ag"] = _rs_ag_check(torch, params, lcfg, mesh)
        torch.cuda.reset_peak_memory_stats(dev)
        run = _mp_serve(torch, params, lcfg, counters, name, mesh, draft)
        run["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
        out["streams"][name] = run.pop("streams")
        res.update(run)
        out["cases"][name] = res
        del params, draft
        _free(torch)
    return out


def _mp_oracles(torch, counters):
    """For each case on this card: the shard loop at tp 2 (the tree with
    every shard, ``build_rank_params(rank=None)``) and the one-card
    engine on the same weights (the loop's tree at tp 1: its dense and
    BSR leaves whole, its containers ``reshard_packed`` to 1)."""
    from repro_torch.core.deploy import reshard_packed
    from repro_torch.distribution.sharding import tp_config
    cfg0 = main_config(MPP["layers"], "bfloat16")
    out = {}
    for name in MESH_PATHS:
        loop, tcfg, _, draft, res = _mp_build(torch, cfg0, name, MPP["tp"],
                                              None, DEVICE)
        res["loop"] = _mp_serve(torch, loop, tcfg, counters, name,
                                draft=draft)
        one, ocfg = reshard_packed(loop, tcfg, tp=1), tp_config(tcfg, 1)
        odraft = None if draft is None else (
            reshard_packed(draft[0], draft[1], tp=1), tp_config(draft[1], 1))
        del loop, draft
        res["one_card"] = _mp_serve(torch, one, ocfg, counters, name,
                                    draft=odraft)
        out[name] = res
        del one, odraft
        _free(torch)
    return out


def _mp_check(name, r, oracle):
    """A rank's case: streams, decode logits and speculation counters bit
    for bit the loop's; the kernels its path runs (none on the dense,
    masked and bsr paths, whose products are plain, as in the
    reference), on their tensor-core variants; an int8 drafter's on the
    int8 forms too."""
    loop = oracle["loop"]
    tag = f"(a) {name} rank {r['rank']}"
    got = r["cases"][name]
    check(r["streams"][name] == loop["streams"],
          f"{tag}: streams differ from the shard loop's at tp {MPP['tp']}")
    check(got["digests"] == loop["digests"],
          f"{tag}: decode logits are not bit for bit the shard loop's")
    check(got["spec"] == loop["spec"],
          f"{tag}: speculation counters {got['spec']}, the loop's "
          f"{loop['spec']}")
    path, sparsity, _, _, _, drafter = MESH_PATHS[name]
    dq = drafter is not None and drafter[1]
    lg, lf = got["launches"]["sasp_gemm"], got["launches"]["sasp_fused_ffn"]
    if path in ("masked", "bsr") or sparsity == 0:
        check(lg["total"] == lf["total"] == 0,
              f"{tag}: launched {lg['total']} tile-skip GEMMs and "
              f"{lf['total']} fused FFNs on a path of plain products")
        return
    # the kernel path's BSR blocks stay fp32 (as the reference keeps
    # them): its variant is the one-card engine's, FMAs
    want = {"mma"} if path == "packed" else \
        set(loop["launches"]["sasp_gemm"]["variant"])
    check(lg["total"] > 0 and want and set(lg["variant"]) == want,
          f"{tag}: sasp_gemm launched {lg}, the loop "
          f"{loop['launches']['sasp_gemm']}")
    if path == "packed":
        # the int8 fused FFN's down projection runs on FMAs (phase 3c)
        check(lf["total"] > 0 and set(lf["variant"]) == (
            {"mma/mma", "mma/fma"} if dq else {"mma/mma"}),
              f"{tag}: sasp_fused_ffn launched {lf}")
        kinds = {"bfloat16"} | ({"int8"} if dq else set())
        for n, l in (("sasp_gemm", lg), ("sasp_fused_ffn", lf)):
            check(set(l["weight"]) == kinds,
                  f"{tag}: {n} ran weights {l['weight']}, not {kinds}")


def _mp_report(name, res, oracle):
    """One case's lines: ms/step of a rank beside the one-card engine's
    and the loop's, GiB, build s, launches a forward, spec counters."""
    r0 = res[0]["cases"][name]
    one, loop = oracle["one_card"], oracle["loop"]
    drafted = MESH_PATHS[name][5] is not None
    # a drafter's steps also run its forwards and the verify pass: count
    # those by step
    fwd = max(1, r0["times"]["steps"] if drafted else r0["forwards"])
    per = {n: {v: round(c / fwd, 2) for v, c in l["variant"].items()}
           for n, l in r0["launches"].items() if l["total"]}
    wts = {n: l["weight"] for n, l in r0["launches"].items() if l["total"]}
    line = (f"  (a) {name}: decode ms/step by rank "
            f"{[round(r['cases'][name]['times']['decode_ms_per_step'], 2) for r in res]}"
            f" (one card {one['times']['decode_ms_per_step']:.2f}, the "
            f"loop at tp {MPP['tp']} {loop['times']['decode_ms_per_step']:.2f}),"
            f" prefill {r0['times']['prefill_ms']:.1f} ms (one card "
            f"{one['times']['prefill_ms']:.1f}); GiB a rank: tree "
            f"{[round(r['cases'][name]['tree_gib'] + r['cases'][name]['draft_gib'], 2) for r in res]}"
            f", held {[round(r['cases'][name]['held_gib'], 2) for r in res]}"
            f", peak building "
            f"{[round(r['cases'][name]['build_peak_gib'], 2) for r in res]}"
            f"; build s {[round(r['cases'][name]['build_s'], 1) for r in res]}"
            f"; launches a {'step' if drafted else 'forward'} ({fwd} "
            f"{'steps' if drafted else 'forwards'}) by variant "
            f"{per or 'none'}, in all by weight {wts or 'none'}")
    if drafted:
        sc = r0["spec"]
        line += (f"; speculation: {sc['spec_rounds']} rounds, "
                 f"{sc['spec_accepted_tokens']}/{sc['spec_draft_tokens']} "
                 f"drafts accepted, {sc['spec_fallbacks']} fallbacks, "
                 f"{r0['times']['decode_ms_per_step']:.2f} ms a step (one "
                 f"batched round over the slots), "
                 f"{r0['times']['tokens_per_decode_step']:.2f} tokens a step")
    if "rs_ag" in r0:
        line += (f"; rs+int8-ag FFN "
                 f"{[r['cases'][name]['rs_ag']['rel_err'] for r in res]} of "
                 f"the exact reduction")
    log(line)


def _mp_one_card(torch, counters):
    """(a) and (b): every case on ``--mesh 1,2`` on this card over gloo,
    host-staged, against its oracles."""
    from repro_torch.launch import serve as launch
    t0 = time.time()
    oracles = _mp_oracles(torch, counters)
    oracle_s = time.time() - t0
    _free(torch)
    t0 = time.time()
    spec = dict(mesh=(1, MPP["tp"]), layers=MPP["layers"], device=DEVICE,
                backend="gloo", cases=list(MESH_PATHS), rs_ag=True)
    res = launch.serve_mesh(spec, _mp_rank, store_dir=OUT_DIR, timeout=600)
    wall = time.time() - t0
    log(f"  (a) --mesh 1,{MPP['tp']}: {len(res)} spawned ranks over "
        f"{res[0]['transport']}, {wall:.1f} s wall for {len(MESH_PATHS)} "
        f"cases (the oracles {oracle_s:.1f} s)")
    out = {"wall_s": wall, "oracle_s": oracle_s, "cases": {}}
    for name in MESH_PATHS:
        path = MESH_PATHS[name][0]
        for r in res:
            _mp_check(name, r, oracles[name])
            if "rs_ag" in r["cases"][name]:
                check(r["cases"][name]["rs_ag"]["rel_err"] <= 2e-2,
                      f"(b) rank {r['rank']}: rs+int8-ag "
                      f"{r['cases'][name]['rs_ag']['rel_err']:.3g} from the "
                      f"exact reduction (bound 2e-2)")
        one = oracles[name]["one_card"]
        drafted = MESH_PATHS[name][5] is not None
        margins = one["margins"]
        if drafted:
            # a token of a verify pass has no recorded margin: read it
            # off the one-card engine without a drafter
            margins = {**oracles["packed paged"]["one_card"]["margins"],
                       **margins}
        ties = _greedy_equal(f"(a) {name}", res[0]["streams"][name],
                             one["streams"], margins,
                             ref="the one-card engine")
        if drafted:
            base = oracles["packed paged"]["loop"]
            ties += _greedy_equal(f"(a) {name}", res[0]["streams"][name],
                                  base["streams"], base["margins"],
                                  ref="the mesh without a drafter")
        _mp_report(name, res, oracles[name])
        out["cases"][name] = dict(
            path=path, near_ties=ties,
            ranks=[{k: v for k, v in r["cases"][name].items()
                    if k not in ("digests", "margins")} for r in res],
            one_card={k: v for k, v in oracles[name]["one_card"].items()
                      if k not in ("digests", "margins", "streams")},
            loop={k: v for k, v in oracles[name]["loop"].items()
                  if k not in ("digests", "margins", "streams")})
    log(f"  (a) every rank's streams and decode logits bit for bit the "
        f"shard loop at tp {MPP['tp']} on every path; greedy-equal to the "
        f"one-card engine but at the near-ties printed")
    out["launches"] = {n: sum(r["cases"][c]["launches"][n]["total"]
                              for r in res for c in MESH_PATHS)
                       for n in MAIN_PATH}
    return out


def _mp_four_cards(torch):
    """(c) ``--mesh 1,4 --sasp 0`` and packed ``--mesh 1,4`` at all 64
    layers over NCCL, a card a rank, one after the other in the same
    processes: decode ms/step of each."""
    from repro_torch.launch import serve as launch
    tp, n = MPP["nccl_tp"], torch.cuda.device_count()
    if n < tp:
        log(f"  (c) nccl: not run ({n} card{'s' if n > 1 else ''})")
        return f"not run ({n} card{'s' if n > 1 else ''})"
    t0 = time.time()
    spec = dict(mesh=(1, tp), layers=MPP["depth_layers"], device=DEVICE,
                backend="nccl", cases=["--sasp 0", "packed paged"],
                rs_ag=False)
    res = launch.serve_mesh(spec, _mp_rank, store_dir=OUT_DIR, timeout=900)
    wall = time.time() - t0
    out = {"wall_s": wall, "cases": {}}
    for name in spec["cases"]:
        for r in res:
            streams = r["streams"][name]
            check(len(streams) == 4 and all(
                len(s) == MPP["new"] and all(0 <= t < 151_936 for t in s)
                for s in streams.values()),
                f"(c) {name} rank {r['rank']}: not 4 streams of "
                f"{MPP['new']} tokens in the vocabulary")
        out["cases"][name] = [{k: v for k, v in r["cases"][name].items()
                               if k not in ("digests", "margins")}
                              for r in res]
    d = [r["cases"]["--sasp 0"]["times"]["decode_ms_per_step"] for r in res]
    p = [r["cases"]["packed paged"]["times"]["decode_ms_per_step"]
         for r in res]
    log(f"  (c) --mesh 1,{tp} at {MPP['depth_layers']} layers over "
        f"{res[0]['transport']}, {wall:.1f} s wall: --sasp 0 (dense fp32 "
        f"weights) decode ms/step by rank {[round(v, 2) for v in d]}, tree "
        f"{[round(r['cases']['--sasp 0']['tree_gib'], 2) for r in res]} GiB"
        f" (peak building "
        f"{[round(r['cases']['--sasp 0']['build_peak_gib'], 2) for r in res]}"
        f", build s "
        f"{[round(r['cases']['--sasp 0']['build_s'], 1) for r in res]}); "
        f"packed at {SPARSITY:.0%} (paged) "
        f"{[round(v, 2) for v in p]} ms/step, tree "
        f"{[round(r['cases']['packed paged']['tree_gib'], 2) for r in res]}"
        f" GiB; dense / packed {d[0] / p[0]:.2f}")
    return out


def mesh_paths_phase(torch, counters):
    """Phase 12: every serving path of the dense decoder on --mesh 1,2 on
    one card, (a) and (b); (c) on four where the machine has them. Run
    last, with every earlier model freed."""
    t_phase = time.time()
    log(f"  qwen3-32b at full width, {MPP['layers']} layers; seed 0, wo and "
        f"w2 spread, 50% of the 32x32 tiles where pruned, bf16 compute; "
        f"phase 3's 4 requests of {MPP['new']} tokens, 4 slots; drafters "
        f"k {MPP['draft_k']}, paged ({MPP['kv_pages']} pages)")
    out = _mp_one_card(torch, counters)
    _free(torch)
    out["c"] = _mp_four_cards(torch)
    out["seconds"] = time.time() - t_phase
    log(f"  phase 12: {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 13: MoE, SSM and hybrid layers on a mesh
# ---------------------------------------------------------------------------

# (a)-(c) on one card; (d) on four: jamba at full width, moonshot at all
# 48 layers
# moonshot at 1 layer on one card (4 until PR 27, 2 until the smoke
# outgrew its time limit)
FMP = dict(moonshot_layers=1, moonshot_depth=48, slots=4, cache_len=256,
           new=16)
# the one-card meshes: (DP, TP) -> [(model, --scheduler)], one spawn each
FAMILY_MESHES = {
    (2, 1): (("moonshot", False),),
    (1, 2): (("moonshot", False), ("mamba2", False)),
    (2, 2): (("moonshot", False), ("moonshot", True), ("jamba", False)),
}


def _fm_config(model: str, full: bool = False):
    """moonshot-v1-16b-a3b at full width (1 layer; ``full``: all 48),
    mamba2-780m whole, jamba's 8-layer super-block at phase 8 (c)'s
    widths with bf16 weights (``full``: at full width, the launcher's
    fp32 masters); bf16 compute."""
    from repro_torch.configs import get_config
    if model == "moonshot":
        return moonshot_config(FMP["moonshot_depth"] if full
                               else FMP["moonshot_layers"], "bfloat16")
    if model == "mamba2":
        return mamba_config(48, "bfloat16")
    if full:
        return dataclasses.replace(get_config("jamba-1.5-large-398b"),
                                   num_layers=8, compute_dtype="bfloat16")
    return jamba_config("bfloat16")


def _fm_key(mesh, model, sched) -> str:
    return f"{model} --mesh {mesh[0]},{mesh[1]}" + (" --scheduler"
                                                    if sched else "")


def _fm_build(torch, cfg0, mesh, sched, rank, data_rank, device):
    """``build_rank_params`` of a case (50% of the 32x32 tiles, scope
    all, packed; wo and w2 spread as drawn), timed, with the peak GiB the
    build reached on ``device``."""
    from repro_torch.launch import serve as launch
    ep = launch.expert_shards(cfg0, mesh, scheduler=sched)
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    params, cfg, lcfg, _ = launch.build_rank_params(
        cfg0, tp=mesh[1], rank=rank, device=device, sparsity=SPARSITY,
        scope="all", path="packed", prepare=spread_leaf(cfg0), ep=ep,
        data_rank=data_rank)
    torch.cuda.synchronize(device)
    return params, cfg, lcfg, dict(
        ep=ep, build_s=time.perf_counter() - t0,
        build_peak_gib=torch.cuda.max_memory_allocated(device) / 2**30,
        tree_gib=_tree_gib(params))


def _fm_serve(torch, params, cfg, counters, *, mesh=None, data_shards=1,
              sched_ranks=0, keep=False):
    """Phase 3's 4 requests of 16 tokens: through ``Engine`` (4 slots,
    cache 256, on ``mesh`` or ``data_shards`` groups) or, with
    ``sched_ranks``, ``ShardedScheduler`` (2 slots a rank), after an
    untimed 2-token run. Launch counts and the 'data' all-to-all bytes
    set to 0 just before the timed run and read just after. An engine's
    steps are timed with the device synchronised and every decode step's
    logits kept (``keep``) or digested; the all-to-all bytes of a decode
    step are read apart."""
    from repro_torch.launch.serve import synthetic_requests
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.scheduler import SchedulerConfig, ShardedScheduler
    V = cfg.vocab_size

    def make():
        if sched_ranks:
            return ShardedScheduler(
                params, cfg, mesh=mesh,
                ranks=None if mesh is not None else sched_ranks,
                sched=SchedulerConfig(slots_per_rank=FMP["slots"] // 2,
                                      cache_len=FMP["cache_len"]))
        return Engine(params, cfg, batch_slots=FMP["slots"],
                      cache_len=FMP["cache_len"], mesh=mesh,
                      data_shards=data_shards)
    make().run(synthetic_requests(4, V, 2))
    server = make()
    reqs = synthetic_requests(4, V, FMP["new"])
    def a2a():
        return mesh.a2a if mesh is not None else {"calls": 0, "bytes": 0}
    out = {}
    reset(counters)
    if mesh is not None:
        mesh.reset_record()
    if sched_ranks:
        _sync(torch)
        t0 = time.perf_counter()
        done = server.run(reqs)
        _sync(torch)
        wall = time.perf_counter() - t0
        out.update(streams={r.rid: list(r.out_tokens) for r in done},
                   served={r.rid: r.rank for r in done}, wall_s=wall,
                   tok_s=sum(len(r.out_tokens) for r in done) / wall)
    else:
        logits, step_a2a = [], []
        dec = server._decode_step

        def recorded(p, c, *a):
            x = dec(p, c, *a)
            logits.append(x.clone() if keep else _digest(x))
            return x
        server._decode_step = recorded
        step = server.step

        def counted():
            b = a2a()["bytes"]
            adm = server.stats["admitted"]
            res = step()
            if server.stats["admitted"] == adm:
                step_a2a.append(a2a()["bytes"] - b)
            return res
        server.step = counted
        streams, steps = _drive_timed(torch, server, reqs)
        out.update(streams=streams, logits=logits,
                   times=_step_times(steps), layout=server.layout,
                   a2a_decode_bytes=(max(step_a2a) if step_a2a else 0))
    out["launches"] = _launch_counts(counters)
    out["a2a"] = a2a()
    return out


def _fm_rank(rank: int, spec: dict, init_file: str) -> dict:
    """Phase 13's process, spawned by the launcher's ``serve_mesh``: join
    the mesh over ``spec["backend"]``, then for each case build this
    rank's tree layer by layer (its experts over 'data' where one engine
    splits its slots, d_ff and SSM heads over 'model'), serve, free.
    Returns what the parent checks (every case's streams under
    ``streams``, which ``serve_mesh`` holds equal in every process)."""
    import torch
    from repro_torch.kernels.sasp_gemm import fused_ffn, gemm
    from repro_torch.launch import serve as launch
    counters = {"sasp_gemm": gemm, "sasp_fused_ffn": fused_ffn}
    mesh = launch.join_mesh(rank, spec, init_file, backend=spec["backend"])
    dev = mesh.device
    out = dict(rank=rank, data_rank=mesh.data_rank,
               model_rank=mesh.model_rank, transport=mesh.transport,
               cases={}, streams={})
    for model, sched in spec["cases"]:
        key = _fm_key(spec["mesh"], model, sched)
        cfg0 = _fm_config(model, spec.get("full", False))
        params, _, lcfg, res = _fm_build(torch, cfg0, spec["mesh"], sched,
                                         mesh.model_rank, mesh.data_rank,
                                         dev)
        res["held_gib"] = torch.cuda.memory_allocated(dev) / 2**30
        torch.cuda.reset_peak_memory_stats(dev)
        run = _fm_serve(torch, params, lcfg, counters, mesh=mesh,
                        sched_ranks=spec["mesh"][0] if sched else 0)
        run["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
        out["streams"][key] = run.pop("streams")
        res.update(run)
        out["cases"][key] = res
        del params
        _free(torch)
    return out


def _fm_oracles(torch, counters):
    """On this card, for every model: the one-card engine (the tree at tp
    1, every expert) and each mesh case's meshless loop of its shard
    counts (``build_rank_params(rank=None)``: every shard and expert,
    ``Engine(data_shards=DP)`` where the slots split over 'data', the
    meshless ``ShardedScheduler`` for ``--scheduler``). Decode logits
    kept: a split engine's rank holds its rows of them."""
    out = {}
    for model in ("moonshot", "mamba2", "jamba"):
        cfg0 = _fm_config(model)
        cases = [(m, s) for m, cs in FAMILY_MESHES.items()
                 for md, s in cs if md == model]
        for tp in sorted({m[1] for m, _ in cases} | {1}):
            tree, tcfg, _, res = _fm_build(torch, cfg0, (1, tp), False,
                                           None, 0, DEVICE)
            if tp == 1:
                out[model, "one card"] = dict(res, **_fm_serve(
                    torch, tree, tcfg, counters, keep=True))
            for mesh, sched in cases:
                if mesh[1] != tp:
                    continue
                ep = 1 if sched else mesh[0] if cfg0.moe else 1
                cfg = dataclasses.replace(tcfg, ep_shards=ep)
                out[_fm_key(mesh, model, sched)] = dict(res, **_fm_serve(
                    torch, tree, cfg, counters, keep=True,
                    data_shards=1 if sched else mesh[0],
                    sched_ranks=mesh[0] if sched else 0))
            del tree
            _free(torch)
    return out


# the kernels each model's packed path launches (scope all): moonshot
# its attention projections, mamba2 nothing (its SSM projections stay
# pruned-dense, its d_ff is 0), jamba both
FM_KERNELS = {"moonshot": {"sasp_gemm": "mma"}, "mamba2": {},
              "jamba": {"sasp_gemm": "mma", "sasp_fused_ffn": "mma/mma"}}


def _fm_check(key, model, r, loop, mesh, sched):
    """A rank's case bit for bit its loop: streams (and served ranks), a
    split engine's decode logits its rows of the loop's; the main-path
    kernels its model runs, on their tensor-core variants, none else."""
    tag = f"(a) {key} rank {r['rank']}"
    got = r["cases"][key]
    check(r["streams"][key] == loop["streams"],
          f"{tag}: streams differ from the meshless loop's")
    if sched:
        check(got["served"] == loop["served"],
              f"{tag}: served ranks differ from the meshless loop's")
    else:
        per = FMP["slots"] // mesh[0] if got["layout"] else FMP["slots"]
        lo = r["data_rank"] * per if got["layout"] else 0
        want = [_digest(x[lo:lo + per]) for x in loop["logits"]]
        check(got["logits"] == want,
              f"{tag}: decode logits are not bit for bit the loop's "
              f"(layout {got['layout']}, loop {loop['layout']})")
    for k in MAIN_PATH:
        lk = got["launches"][k]
        if k in FM_KERNELS[model]:
            check(lk["total"] > 0 and set(lk["variant"]) == {
                FM_KERNELS[model][k]}, f"{tag}: {k} launched {lk}")
        else:
            check(lk["total"] == 0, f"{tag}: {k} launched {lk}")


def _fm_agreement(got, one) -> str:
    """How a case's streams compare with the one-card engine's: equal, or
    the first token that differs (EP's per-source capacity drops other
    tokens than one card's global capacity where it binds)."""
    diff = [(rid, next(i for i, (a, b) in enumerate(zip(s, one[rid]))
                       if a != b)) for rid, s in got.items()
            if s != one[rid]]
    if not diff:
        return "equal to the one-card engine's"
    return (f"{len(got) - len(diff)}/{len(got)} equal to the one-card "
            f"engine's (first differences (request, token) {diff})")


def _fm_report(key, res, loop, one):
    r0 = res[0]["cases"][key]
    ms = ([round(r["cases"][key]["times"]["decode_ms_per_step"], 2)
           for r in res] if "times" in r0 else None)
    lms = loop.get("times", {}).get("decode_ms_per_step")
    line = (f"  {key}: " + (
        f"decode ms/step by rank {ms} (the loop {lms:.2f}, one card "
        f"{one['times']['decode_ms_per_step']:.2f}), prefill "
        f"{r0['times']['prefill_ms']:.1f} ms" if ms else
        f"{r0['tok_s']:.1f} tok/s (the loop {loop['tok_s']:.1f}), served "
        f"ranks {sorted(set(r0['served'].values()))}") +
        f"; experts in {r0['ep']} EP shard(s); GiB a rank: tree "
        f"{[round(r['cases'][key]['tree_gib'], 2) for r in res]}, held "
        f"{[round(r['cases'][key]['held_gib'], 2) for r in res]}, peak "
        f"serving {[round(r['cases'][key]['peak_gib'], 2) for r in res]}, "
        f"peak building "
        f"{[round(r['cases'][key]['build_peak_gib'], 2) for r in res]}; "
        f"build s {[round(r['cases'][key]['build_s'], 1) for r in res]}; "
        f"launches {({k: l['variant'] for k, l in r0['launches'].items() if l['total']}) or 'none'}"
        f"; all-to-all {r0['a2a']['calls']} calls, {r0['a2a']['bytes']} "
        f"bytes a rank in the run"
        + (f", {r0['a2a_decode_bytes']} a decode step" if ms else "")
        + f"; streams {_fm_agreement(res[0]['streams'][key], one['streams'])}")
    log(line)


def _fm_one_card(torch, counters):
    """(a)-(c): every case on this card over gloo, host-staged, one spawn
    a mesh shape, against its loop."""
    from repro_torch.launch import serve as launch
    t0 = time.time()
    oracles = _fm_oracles(torch, counters)
    oracle_s = time.time() - t0
    _free(torch)
    out = {"oracle_s": oracle_s, "cases": {}, "launches": dict.fromkeys(
        MAIN_PATH, 0)}
    for mesh, cases in FAMILY_MESHES.items():
        t0 = time.time()
        spec = dict(mesh=mesh, device=DEVICE, backend="gloo",
                    cases=list(cases))
        res = launch.serve_mesh(spec, _fm_rank, store_dir=OUT_DIR,
                                timeout=600)
        wall = time.time() - t0
        log(f"  --mesh {mesh[0]},{mesh[1]}: {len(res)} spawned processes "
            f"over {res[0]['transport']}, {wall:.1f} s wall")
        for model, sched in cases:
            key = _fm_key(mesh, model, sched)
            for r in res:
                _fm_check(key, model, r, oracles[key], mesh, sched)
            _fm_report(key, res, oracles[key], oracles[model, "one card"])
            out["cases"][key] = dict(
                wall_s=wall, ranks=[{k: v for k, v in
                                     r["cases"][key].items()
                                     if k != "logits"} for r in res],
                loop={k: v for k, v in oracles[key].items()
                      if k not in ("logits", "streams")},
                one_card_streams_agree=_fm_agreement(
                    res[0]["streams"][key],
                    oracles[model, "one card"]["streams"]))
            for n in MAIN_PATH:
                out["launches"][n] += sum(r["cases"][key]["launches"][n][
                    "total"] for r in res)
    log(f"  (a)-(c) every process bit for bit its meshless loop (streams, "
        f"served ranks, decode logits) in oracles {oracle_s:.1f} s")
    return out


def _fm_four_cards(torch):
    """(d) over NCCL, a card a process: jamba-1.5-large at full width
    (one 8-layer super-block, the launcher's fp32 masters) on --mesh 2,2,
    then moonshot at all 48 layers on --mesh 4,1: decode ms/step, GiB a
    rank, build s, all-to-all bytes a decode step."""
    from repro_torch.launch import serve as launch
    n = torch.cuda.device_count()
    if n < 4:
        log(f"  (d) nccl: not run ({n} card{'s' if n > 1 else ''})")
        return f"not run ({n} card{'s' if n > 1 else ''})"
    out = {}
    for model, mesh in (("jamba", (2, 2)), ("moonshot", (4, 1))):
        t0 = time.time()
        spec = dict(mesh=mesh, device=DEVICE, backend="nccl", full=True,
                    cases=[(model, False)])
        res = launch.serve_mesh(spec, _fm_rank, store_dir=OUT_DIR,
                                timeout=600)
        wall = time.time() - t0
        key = _fm_key(mesh, model, False)
        cfg0 = _fm_config(model, True)
        for r in res:
            s = r["streams"][key]
            check(len(s) == 4 and all(
                len(t) == FMP["new"] and all(0 <= v < cfg0.vocab_size
                                             for v in t)
                for t in s.values()),
                f"(d) {key} rank {r['rank']}: not 4 streams of "
                f"{FMP['new']} tokens in the vocabulary")
        c = [r["cases"][key] for r in res]
        log(f"  (d) {key} ({cfg0.num_layers} layers, d_model "
            f"{cfg0.d_model}) over {res[0]['transport']}, {wall:.1f} s "
            f"wall: decode ms/step by rank "
            f"{[round(x['times']['decode_ms_per_step'], 2) for x in c]}, "
            f"prefill {c[0]['times']['prefill_ms']:.1f} ms; GiB a rank: "
            f"tree {[round(x['tree_gib'], 2) for x in c]}, held "
            f"{[round(x['held_gib'], 2) for x in c]}, peak serving "
            f"{[round(x['peak_gib'], 2) for x in c]}, peak building "
            f"{[round(x['build_peak_gib'], 2) for x in c]}; build s "
            f"{[round(x['build_s'], 1) for x in c]}; launches "
            f"{ {k: l['variant'] for k, l in c[0]['launches'].items() if l['total']} }"
            f"; all-to-all {c[0]['a2a_decode_bytes']} bytes a decode step")
        out[key] = dict(wall_s=wall, ranks=[{k: v for k, v in x.items()
                                             if k != "logits"} for x in c])
    return out


def family_mesh_phase(torch, counters):
    """Phase 13: MoE, SSM and hybrid layers on a mesh, (a)-(c) on this
    card, (d) on four where the machine has them. Run last, with every
    earlier model freed."""
    t_phase = time.time()
    log(f"  moonshot-v1-16b-a3b at full width, {FMP['moonshot_layers']} "
        f"layers; mamba2-780m whole; jamba's super-block at phase 8 (c)'s "
        f"widths, bf16 weights; seed 0, wo and w2 spread, 50% of the "
        f"32x32 tiles (scope all), bf16 compute; phase 3's 4 requests of "
        f"{FMP['new']} tokens, 4 slots")
    out = _fm_one_card(torch, counters)
    _free(torch)
    out["d"] = _fm_four_cards(torch)
    out["seconds"] = time.time() - t_phase
    log(f"  phase 13: {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 14: training under a (data, model) mesh
# ---------------------------------------------------------------------------

# (a) full width on --mesh 1,2; (b) a narrower qwen3 (fp32 compute) on
# --mesh 2,1 and 2,2; (c) (b)'s checkpoint served on --mesh 1,2; (d) full
# width, 8 layers, on 2,2 and 1,4 over NCCL with four cards
# (a)'s depth: 1 layer (2 before phase 17 was added, which the smoke's
# time limit then could not hold)
TMP = dict(layers=1, batch=4, seq=256, steps=3, lr=3e-4, warmup=3,
           total=20, narrow=dict(layers=4, d_model=512, vocab=8192),
           nbatch=8, nseq=128, nccl_layers=8, probe=65536)
# (b)'s cases by mesh: (name, int8 moments, micro-batches); the last
# (2, 2) case saves the checkpoint that (c) resumes and serves
TM_CASES = {
    (2, 1): (("fp32", False, 1), ("int8 mb2", True, 2)),
    (2, 2): (("fp32 mb2", False, 2), ("int8", True, 1)),
}


def tm_config(narrow: bool, layers=None):
    """(a) / (d): qwen3-32b at full width, ``layers`` (default 2), as
    phase 7 trains it (fp32 masters, bf16 compute, remat full, the
    overlay at 50% of the 32x32 FFN tiles); (b): the narrower qwen3 of
    ``TMP["narrow"]``, fp32 compute, the same overlay."""
    from repro_torch.configs import get_config, reduced
    if not narrow:
        return train_config(layers or TMP["layers"])
    cfg = reduced(get_config("qwen3-32b"), **TMP["narrow"])
    return dataclasses.replace(cfg, sasp=train_config(1).sasp)


def _dev_sync(torch, dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def _probe(t, n: int):
    """(fp64 norm, largest |x|, up to ``n`` strided elements) of a
    tensor, on the host."""
    import numpy as np
    flat = t.detach().reshape(-1)
    if not flat.numel():                  # mamba2's d_ff = 0 FFN
        return 0.0, 0.0, np.zeros(0, np.float32)
    k = max(1, flat.numel() // n)
    return (float(flat.double().norm()), float(flat.abs().max()),
            flat[::k][:n].float().cpu().numpy().copy())


def _tm_slices(tree_items, specs, tp, dp, n):
    """Probes of every (model rank, data rank)'s slice of each whole leaf
    of the meshless loop: what each mesh rank probes of its own."""
    from repro_torch.distribution.sharding import take_slice
    out = {}
    for path, t in tree_items:
        for r in range(tp):
            for d in range(dp):
                out[path, r, d] = _probe(take_slice(t, specs[path], r, tp, d,
                                                    dp), n)
    return out


def _tm_loop(torch, cfg, mesh_shape, quantized, mb):
    """The meshless loop at ``mesh_shape`` ((DP, TP) or (P, DP, TP): a TP
    config's shard loop, every DP rank's rows in turn), run in this
    process: its overlay masks, step 1's mean gradient and the params
    after step 1, probed as each mesh rank holds them (every pod holds
    the same), and the losses of TMP["steps"] steps."""
    from repro_torch.core.pruning import iter_leaves
    from repro_torch.core.sasp import build_sasp_overlay
    from repro_torch.data.pipeline import DataConfig, Pipeline
    from repro_torch.distribution.sharding import tp_config
    from repro_torch.models import lm
    from repro_torch.train import train_step as ts
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    pod, dp, tp = ((1,) + tuple(mesh_shape))[-3:]
    n_dp = pod * dp
    narrow = cfg.compute_dtype == "float32"
    B, S = (TMP["nbatch"], TMP["nseq"]) if narrow else (TMP["batch"],
                                                         TMP["seq"])
    t0 = time.time()
    with torch.no_grad():
        params = spread_output_scales(lm.init_params(cfg, seed=0,
                                                     device=DEVICE), cfg)
    oc = AdamWConfig(lr=TMP["lr"], quantized=quantized)
    layout = ts.mesh_layout(cfg, dp, tp, oc)
    overlay, got = build_sasp_overlay(params, cfg.sasp)
    masks = {k: m.cpu().numpy() for k, m in _overlay_masks(overlay)}
    tcfg = tp_config(cfg, tp)
    pipe = Pipeline(DataConfig(cfg.vocab_size, S, B))
    batches = [_batch(torch, pipe) for _ in range(TMP["steps"])]
    got_grads = []

    def first(grads):                     # step 1's mean gradient
        if not got_grads:
            got_grads.append(_tm_slices(list(iter_leaves(grads)),
                                        layout.zero, tp, dp, TMP["probe"]))
    step = ts.make_train_step(tcfg, oc, overlay=overlay, n_microbatches=mb,
                              data_shards=n_dp, lr_schedule=_tm_schedule(),
                              on_grads=first)
    opt = adamw_init(params, oc)
    losses = []
    for i, b in enumerate(batches):
        params, opt, m = step(params, opt, b)
        losses.append(float(m["loss"]))
        if i == 0:
            p1 = _tm_slices(list(iter_leaves(params)), layout.params, tp, 1,
                            TMP["probe"])
    out = dict(losses=losses, grads=got_grads[0], params1=p1, masks=masks,
               sparsity=got, seconds=time.time() - t0)
    del params, opt, overlay, step
    return out


def _overlay_masks(overlay):
    """((segment, slot, matrix), mask) of every FFN mask of an
    overlay."""
    for si, seg in overlay["segments"].items():
        for slot, sp in seg.items():
            for mat, m in sp["ffn"]["sasp_masks"].items():
                yield (int(si), slot, mat), m


def _tm_case(torch, mesh, spec, case):
    """One training case on this rank: its TP slices drawn layer by
    layer (wo and w2 spread as drawn), ZeRO moments, the overlay ranked
    over the whole tree and gathered back for the check, step 1's mean
    gradient and the params after step 1 probed, TMP["steps"] timed mesh
    steps; with ``case["save"]``, the state saved (``save_on_mesh``) after
    them, one more step, and the same step again from the checkpoint
    restored into a fresh state."""
    from repro_torch.core.pruning import iter_leaves
    from repro_torch.core.sasp import mesh_overlay
    from repro_torch.data.pipeline import DataConfig, Pipeline
    from repro_torch.distribution.sharding import local_config, tp_config
    from repro_torch.launch.train import rank_params
    from repro_torch.train import train_step as ts
    from repro_torch.train.checkpoint import (CheckpointManager,
                                              gather_whole, named_leaves,
                                              restore_on_mesh, save_on_mesh)
    from repro_torch.train.optimizer import AdamWConfig, zero_adamw_init
    dev = mesh.device
    dp, tp = mesh.shape["data"], mesh.shape["model"]
    cfg = spec["cfg"]
    narrow = cfg.compute_dtype == "float32"
    B, S = (TMP["nbatch"], TMP["nseq"]) if narrow else (TMP["batch"],
                                                         TMP["seq"])
    q, mb = case["int8"], case["mb"]
    oc = AdamWConfig(lr=TMP["lr"], quantized=q)
    layout = ts.mesh_layout(cfg, dp, tp, oc, pod=mesh.pods)
    if torch.device(dev).type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        params = rank_params(cfg, layout, mesh, prepare=spread_leaf(cfg))
    opt = zero_adamw_init(params, layout.zero, oc, mesh)
    overlay, got = mesh_overlay(params, cfg.sasp, mesh, layout.params)
    _dev_sync(torch, dev)
    out = dict(init_s=time.perf_counter() - t0, sparsity=got)
    out["masks"] = {
        k: gather_whole(m.to(torch.uint8), layout.params[
            ("segments", k[0], k[1], "ffn", k[2], "w")], mesh).bool().cpu()
        .numpy() for k, m in _overlay_masks(overlay)}
    lcfg = local_config(tp_config(cfg, tp), tp)
    pipe = Pipeline(DataConfig(cfg.vocab_size, S, B))
    batches = [_batch_on(torch, pipe, dev) for _ in range(TMP["steps"] + 1)]
    n = TMP["probe"]

    def first(gs):              # step 1's reduced gradient slices
        if "grads" not in out:
            out["grads"] = {p: _probe(x, n) for p, x in gs.items()}
    step = ts.make_mesh_train_step(lcfg, opt_cfg=oc, mesh=mesh,
                                   layout=layout, overlay=overlay,
                                   n_microbatches=mb,
                                   lr_schedule=_tm_schedule(),
                                   on_grads=first)
    losses, ms, out["sums"] = [], [], []
    for i in range(TMP["steps"]):
        _dev_sync(torch, dev)
        if i == 0:
            mesh.reset_record()
        t = time.perf_counter()
        params, opt, m = step(params, opt, batches[i])
        _dev_sync(torch, dev)
        ms.append((time.perf_counter() - t) * 1e3)
        losses.append(float(m["loss"]))
        if mesh.pods > 1:
            out["sums"].append(_state_sums(torch, params, opt))
        if i == 0:
            # the collectives of one step, by kind and axis (phase 15 (c)
            # holds the dry run's record to it)
            out["record"] = mesh.record()
            out["params1"] = {p: _probe(x, n) for p, x in
                              iter_leaves(params)}
    out.update(losses=losses, step_ms=ms,
               tok_s=B * S / (sum(ms[1:]) / max(1, len(ms) - 1) / 1e3))
    cuda = torch.device(dev).type == "cuda"     # (not measured on the CPU)
    out["held_gib"] = torch.cuda.memory_allocated(dev) / 2**30 if cuda \
        else float("nan")
    out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30 if cuda \
        else float("nan")
    if case.get("save"):
        specs = ts.state_specs(params, layout)
        mgr = CheckpointManager(spec["ckpt_dir"])
        t = time.perf_counter()
        save_on_mesh(mgr, TMP["steps"], {"params": params, "opt": opt},
                     specs, mesh, extra={"step": TMP["steps"]})
        out["save_s"] = time.perf_counter() - t
        params, opt, m = step(params, opt, batches[-1])
        want = [float(m["loss"])] + [x.cpu() for _, x in named_leaves(
            {"params": params, "opt": opt})]
        del params, opt
        with torch.no_grad():
            fresh = rank_params(cfg, layout, mesh)
        with mgr.reader() as reader:
            state = restore_on_mesh(reader, {"params": fresh, "opt":
                                             zero_adamw_init(fresh,
                                                             layout.zero, oc,
                                                             mesh)},
                                    specs, mesh)
        p2, o2, m2 = step(state["params"], state["opt"], batches[-1])
        got_ = [float(m2["loss"])] + [x.cpu() for _, x in named_leaves(
            {"params": p2, "opt": o2})]
        out["resume_equal"] = got_[0] == want[0] and all(
            torch.equal(a, b) for a, b in zip(got_[1:], want[1:]))
        out["resume_loss"] = (want[0], got_[0])
    return out


def _tm_schedule():
    """Phase 7's warmup_cosine(3, 20) from its second step (its first
    scales lr by 0, which would leave step 1's params unchecked), on the
    loop and the mesh alike."""
    from repro_torch.train.schedule import warmup_cosine
    f = warmup_cosine(TMP["warmup"], TMP["total"])
    return lambda step: f(step + 1)


def _batch_on(torch, pipe, dev):
    return {k: torch.from_numpy(v).to(dev) for k, v in pipe.next().items()}


def _tm_rank(rank: int, spec: dict, init_file: str) -> dict:
    """A training mesh's rank, spawned: join the mesh over
    ``spec["backend"]`` (``spec["pod"]`` pods, default 1), run
    ``spec["cases"]`` in turn (``_tm_case``)."""
    import torch
    from repro_torch.launch.mesh import make_mesh
    dp, tp = spec["mesh"]
    pod = spec.get("pod", 1)
    if spec["device"] == "cpu":
        torch.set_num_threads(max(1, torch.get_num_threads()
                                  // (pod * dp * tp)))
    mesh = make_mesh(dp, tp, pod=pod, rank=rank, init_file=init_file,
                     backend=spec["backend"], device=spec["device"])
    out = dict(rank=rank, model_rank=mesh.model_rank,
               data_rank=mesh.data_rank, pod_rank=mesh.pod_rank,
               transport=mesh.transport, cases={})
    for case in spec["cases"]:
        out["cases"][case["name"]] = _tm_case(torch, mesh, spec, case)
        _free(torch)
    return out


def _tm_spawn(spec, timeout=900):
    from repro_torch.launch.mesh import init_file_in, run_ranks
    store = init_file_in(OUT_DIR, f"tm_store_{os.getpid()}_{time.time_ns()}")
    try:
        return run_ranks(_tm_rank, spec.get("pod", 1) * spec["mesh"][0]
                         * spec["mesh"][1], (spec, store), timeout=timeout)
    finally:
        if os.path.exists(store):
            os.remove(store)


def _probe_err(got, want, absolute: bool = False) -> float:
    """Largest |got - want| over the probed elements, over the slice's
    largest |want| (or as it is: ``absolute``); and the norms' relative
    difference, whichever is larger."""
    import numpy as np
    scale = 1.0 if absolute else max(want[1], 1e-30)
    if not want[2].size:
        return abs(got[0] - want[0])
    return max(float(np.abs(got[2] - want[2]).max()) / scale,
               abs(got[0] - want[0]) / max(want[0], 1e-30))


def _tm_check(tag, res, loop, tol):
    """Every rank against the loop: masks equal, step 1's loss, the
    losses, step 1's gradient slices and the params after step 1 within
    ``tol`` (dict: loss, losses, grads, params). Returns the largest
    errors found."""
    worst = dict(loss1=0.0, losses=0.0, grads=0.0, params1=0.0,
                 mask_tiles=0)
    for r in res:
        c = r["case"]
        diff = sum(int((c["masks"][k] != m).sum())
                   for k, m in loop["masks"].items())
        worst["mask_tiles"] = max(worst["mask_tiles"], diff)
        l1 = abs(c["losses"][0] - loop["losses"][0]) / abs(loop["losses"][0])
        ls = max(abs(a - b) / abs(b) for a, b in zip(c["losses"],
                                                     loop["losses"]))
        ge = max(_probe_err(g, loop["grads"][p, r["model_rank"],
                                             r["data_rank"]])
                 for p, g in c["grads"].items())
        pe = max(_probe_err(x, loop["params1"][p, r["model_rank"], 0],
                            "params1_abs" in tol)
                 for p, x in c["params1"].items())
        for k, v in (("loss1", l1), ("losses", ls), ("grads", ge),
                     ("params1", pe)):
            worst[k] = max(worst[k], v)
    check(worst["mask_tiles"] == 0,
          f"{tag}: {worst['mask_tiles']} overlay tiles differ from the "
          f"loop's (a near-tie of the tile L1?)")
    tol = dict(tol, params1=tol.get("params1_abs", tol.get("params1")))
    for k in ("loss1", "losses", "grads", "params1"):
        check(worst[k] <= tol[k], f"{tag}: {k} {worst[k]:.3e} from the "
              f"meshless loop, bound {tol[k]}")
    return worst


def _tm_full(torch):
    """(a): qwen3-32b at full width, ``TMP["layers"]`` layers, on --mesh
    1,2 (this card, gloo host-staged), held to the loop at tp 2 run
    first here."""
    cfg = tm_config(False)
    t0 = time.time()
    loop = _tm_loop(torch, cfg, (1, 2), False, 1)
    _free(torch)
    loop_s = time.time() - t0
    spec = dict(mesh=(1, 2), cfg=cfg, device=DEVICE, backend="gloo",
                cases=[dict(name="a", int8=False, mb=1)])
    t0 = time.time()
    res = _tm_spawn(spec)
    wall = time.time() - t0
    for r in res:
        r["case"] = r["cases"]["a"]
    # bf16 compute: the forward is the loop's bit for bit (partials summed
    # in fp32 in shard order), the backward sums a column region's input
    # gradient in another order (bf16 rounding); AdamW's first step moves
    # an element by lr times the gradient's sign (and the decay), so two
    # near-equal gradients leave params at most 2 lr apart (lr: step 1's)
    lr1 = TMP["lr"] * float(_tm_schedule()(0))
    worst = _tm_check("(a)", res, loop, dict(
        loss1=0.0, losses=1e-3, grads=5e-2, params1_abs=2.5 * lr1))
    c = [r["case"] for r in res]
    log(f"  (a) qwen3-32b full width, {cfg.num_layers} layers, --mesh 1,2 "
        f"over {res[0]['transport']}: loop {loop_s:.1f} s, mesh "
        f"{wall:.1f} s wall; losses {[round(x, 5) for x in c[0]['losses']]}"
        f" (loop {[round(x, 5) for x in loop['losses']]}); step ms by rank "
        f"{[[round(x, 1) for x in r['step_ms']] for r in c]}, "
        f"{c[0]['tok_s']:.0f} tokens/s; GiB a rank held "
        f"{[round(r['held_gib'], 2) for r in c]}, peak "
        f"{[round(r['peak_gib'], 2) for r in c]}; against the loop: step 1 "
        f"loss {worst['loss1']:.2e}, losses {worst['losses']:.2e}, step 1 "
        f"gradient slices {worst['grads']:.2e} (of each slice's largest), "
        f"params after step 1 {worst['params1']:.2e} (absolute; step 1's "
        f"lr {lr1:.3g}), overlay tiles differing {worst['mask_tiles']}")
    return dict(wall_s=wall, loop_s=loop_s, worst=worst, ranks=[
        {k: v for k, v in r.items() if k not in ("masks", "grads",
                                                  "params1")} for r in c],
        loop_losses=loop["losses"])


def _tm_narrow(torch, ckpt):
    """(b): the narrower qwen3 (fp32 compute) on --mesh 2,1 and 2,2 with
    ZeRO, fp32 and int8 moments, 1 and 2 micro-batches, each held to its
    loop; the last (2,2) case saves the checkpoint (c) uses."""
    cfg = tm_config(True)
    out = {}
    for shape, cases in TM_CASES.items():
        loops = {}
        t0 = time.time()
        for name, q, mb in cases:
            loops[name] = _tm_loop(torch, cfg, shape, q, mb)
            _free(torch)
        loop_s = time.time() - t0
        spec = dict(mesh=shape, cfg=cfg, device=DEVICE, backend="gloo",
                    ckpt_dir=ckpt, cases=[
                        dict(name=n, int8=q, mb=mb,
                             save=shape == (2, 2) and n == cases[-1][0])
                        for n, q, mb in cases])
        t0 = time.time()
        res = _tm_spawn(spec)
        wall = time.time() - t0
        for name, q, mb in cases:
            for r in res:
                r["case"] = r["cases"][name]
            tag = f"(b) --mesh {shape[0]},{shape[1]} {name}"
            # fp32 compute: as on the CPU (tests/test_torch_train_mesh.py);
            # int8 moments part after step 1 (a .5 tie of q, amplified)
            worst = _tm_check(tag, res, loops[name], dict(
                loss1=1e-5, losses=1e-5 if not q else 1e-3, grads=1e-5,
                params1=1e-4))
            c = [r["case"] for r in res]
            log(f"  {tag} ({wall:.1f} s wall): "
                f"{[round(x, 5) for x in c[0]['losses']]}; step ms "
                f"{[round(x, 1) for x in c[0]['step_ms']]}, "
                f"{c[0]['tok_s']:.0f} tokens/s; GiB a rank held "
                f"{[round(r['held_gib'], 3) for r in c]}, peak "
                f"{[round(r['peak_gib'], 3) for r in c]}; against the loop:"
                f" losses {worst['losses']:.2e}, gradient slices "
                f"{worst['grads']:.2e}, params after step 1 "
                f"{worst['params1']:.2e}")
            if "resume_equal" in c[0]:
                check(all(r["case"]["resume_equal"] for r in res),
                      f"{tag}: step {TMP['steps'] + 1} from the restored "
                      f"checkpoint differs from the uninterrupted run "
                      f"({[r['case']['resume_loss'] for r in res]})")
                log(f"  {tag}: saved by world rank 0 in "
                    f"{c[0]['save_s']:.2f} s, restored on the mesh: step "
                    f"{TMP['steps'] + 1} bit for bit the uninterrupted run's"
                    f" on every rank (loss, params, moments)")
            out[tag] = dict(worst=worst, ranks=[{
                k: v for k, v in r["case"].items()
                if k not in ("masks", "grads", "params1")} for r in res])
        out[f"--mesh {shape[0]},{shape[1]}"] = dict(wall_s=wall,
                                                    loop_s=loop_s)
    return out


def _tm_serve_rank(rank: int, spec: dict, init_file: str) -> dict:
    """(c)'s model rank: the mesh-trained checkpoint read layer by layer
    (``build_rank_params(ckpt_dir=)``), packed, served as phase 9
    serves."""
    import torch
    from repro_torch.kernels.sasp_gemm import fused_ffn, gemm
    from repro_torch.launch import serve as launch
    counters = {"sasp_gemm": gemm, "sasp_fused_ffn": fused_ffn}
    mesh = launch.join_mesh(rank, spec, init_file, backend=spec["backend"])
    params, _, lcfg, _ = launch.build_rank_params(
        spec["cfg"], tp=spec["mesh"][1], rank=mesh.model_rank,
        device=mesh.device, **spec["build"])
    run = _tp_serve(torch, params, lcfg, counters, mesh=mesh)
    return dict(rank=rank, transport=mesh.transport,
                **{k: run[k] for k in ("streams", "launches", "times")})


def _tm_serve(torch, counters, ckpt):
    """(c): (b)'s checkpoint through --mesh 1,2 --ckpt-dir (packed, 50% of
    the 32x32 tiles, scope all, bf16), against the shard loop at tp 2
    built from the whole restore; both main-path kernels on mma."""
    from repro_torch.launch import serve as launch
    from repro_torch.models import lm
    cfg = dataclasses.replace(tm_config(True), compute_dtype="bfloat16")
    build = dict(sparsity=SPARSITY, scope="all", int8_weights=False,
                 ckpt_dir=ckpt)
    t0 = time.time()
    whole = launch.restore_params(ckpt, lm.init_params(cfg, seed=1,
                                                       device=DEVICE))
    loop, lcfg = launch.build_serving_params(
        whole, cfg, path="packed", sparsity=SPARSITY, scope="all", tp=2,
        verbose=False)
    del whole
    want = _tp_serve(torch, loop, lcfg, counters)
    del loop
    _free(torch)
    spec = dict(mesh=(1, 2), cfg=cfg, device=DEVICE, backend="gloo",
                build=build)
    res = launch.serve_mesh(spec, _tm_serve_rank, store_dir=OUT_DIR,
                            timeout=600)
    wall = time.time() - t0
    launches = dict.fromkeys(MAIN_PATH, 0)
    for r in res:
        check(r["streams"] == want["streams"],
              f"(c) rank {r['rank']}: streams differ from the shard loop's "
              f"tp 2 on the whole restore")
        for n in MAIN_PATH:
            lc = r["launches"][n]
            check(lc["total"] > 0 and all(
                part == "mma" for v in lc["variant"] for part in v.split("/")),
                f"(c) rank {r['rank']}: {n} launched {lc}, not on mma")
            launches[n] += lc["total"]
    log(f"  (c) (b)'s checkpoint served packed through --mesh 1,2 "
        f"--ckpt-dir over {res[0]['transport']}: streams equal the shard "
        f"loop's tp 2 on the whole restore; launches "
        f"{ {n: res[0]['launches'][n]['variant'] for n in MAIN_PATH} } a "
        f"rank; decode {res[0]['times']['decode_ms_per_step']:.2f} ms/step;"
        f" {wall:.1f} s")
    return dict(wall_s=wall, launches=launches,
                times=[r["times"] for r in res])


def _tm_four_cards(torch):
    """(d) over NCCL, a card a rank: full width, 8 layers, --mesh 2,2 and
    1,4: step ms, tokens/s, GiB held and peak a rank, losses finite."""
    import numpy as np
    n = torch.cuda.device_count()
    if n < 4:
        log(f"  (d) nccl: not run ({n} card{'s' if n > 1 else ''})")
        return f"not run ({n} card{'s' if n > 1 else ''})"
    out = {}
    cfg = tm_config(False, TMP["nccl_layers"])
    for shape in ((2, 2), (1, 4)):
        spec = dict(mesh=shape, cfg=cfg, device=DEVICE, backend="nccl",
                    cases=[dict(name="d", int8=False, mb=1)])
        t0 = time.time()
        res = _tm_spawn(spec)
        c = [r["cases"]["d"] for r in res]
        check(all(np.isfinite(r["losses"]).all() for r in c),
              f"(d) --mesh {shape}: a loss is not finite")
        key = f"--mesh {shape[0]},{shape[1]}"
        log(f"  (d) {key} over {res[0]['transport']}, {cfg.num_layers} "
            f"layers: losses {[round(x, 5) for x in c[0]['losses']]}; step "
            f"ms {[round(x, 1) for x in c[0]['step_ms']]}, "
            f"{c[0]['tok_s']:.0f} tokens/s; GiB a rank held "
            f"{[round(r['held_gib'], 2) for r in c]}, peak "
            f"{[round(r['peak_gib'], 2) for r in c]}; "
            f"{time.time() - t0:.1f} s")
        out[key] = [{k: v for k, v in r.items()
                     if k not in ("masks", "grads", "params1")} for r in c]
    return out


def train_mesh_phase(torch, counters):
    """Phase 14: training under a (data, model) mesh; run last, with
    every earlier model freed."""
    import shutil
    t_phase = time.time()
    ckpt = os.path.join(OUT_DIR, "train_mesh_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    out = {"a": _tm_full(torch)}
    _free(torch)
    try:
        out["b"] = _tm_narrow(torch, ckpt)
        _free(torch)
        out["c"] = _tm_serve(torch, counters, ckpt)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    _free(torch)
    out["d"] = _tm_four_cards(torch)
    out["launches"] = out["c"]["launches"]
    out["seconds"] = time.time() - t_phase
    log(f"  phase 14: {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 15: the analysis tier on the H100 model
# ---------------------------------------------------------------------------

# (a) FlopCounterMode's count of one layer within this band of the
# analytic one (the reference's band against XLA, test_counters_hlo.py);
# (b) a step's bound over its measured time at most this (the counters
# would undercount); (c) the dry run's held bytes within this of the rank's
AN = dict(flop_band=(0.65, 1.55), max_share=1.05, held_tol=0.10,
          tps=(8, 16), layers=2)


def analysis_phase(torch, counters, e2e, train_mesh):
    """Phase 15: (a) FlopCounterMode over one full-width layer's forward
    on the card against ``analysis.counters``; (b) the H100 roofline of
    phase 3's decode step and prefill beside their measured times; (c)
    the dry run of phase 14 (a)'s configuration on a dry 1,2 mesh beside
    phase 14 (a)'s measured GiB and its ranks' collective records; (d)
    the shard loop at tp 16 with every KV head on every shard (8 KV heads
    do not divide 16) against tp 1 and tp 8."""
    from repro_torch.core import h100_model
    t_phase = time.time()
    total = torch.cuda.get_device_properties(0).total_memory
    log(f"  the card: {card_line()}, total_memory {total} B; "
        f"h100_model.HBM_BYTES {h100_model.HBM_BYTES}, CHIP_POWER_W "
        f"{h100_model.CHIP_POWER_W}")
    out = {"total_memory": total, "a": _an_flops(torch),
           "b": _an_roofline(e2e)}
    _free(torch)
    out["c"] = _an_dry(torch, train_mesh["a"])
    out["d"] = _an_tp16(torch, counters)
    _free(torch)
    check(total == h100_model.HBM_BYTES, f"h100_model.HBM_BYTES "
          f"{h100_model.HBM_BYTES} is not this card's total_memory {total}")
    out["seconds"] = time.time() - t_phase
    log(f"  phase 15: {out['seconds']:.1f} s")
    return out


def _an_flops(torch):
    """(a): one layer of qwen3-32b at full width, dense (--sasp 0), bf16,
    the forward of phase 3's 4 prompts left-padded into one prefill group
    (every position's logits, as the counters count the head)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.analysis.counters import step_costs
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.serve import synthetic_requests
    from repro_torch.models import lm
    cfg = main_config(1, "bfloat16")
    params = lm.init_params(cfg, seed=0, device=DEVICE)
    reqs = synthetic_requests(4, cfg.vocab_size, 16)
    S = max(len(r.prompt) for r in reqs)
    toks = torch.zeros((len(reqs), S), dtype=torch.int32, device=DEVICE)
    for i, r in enumerate(reqs):
        toks[i, S - len(r.prompt):] = torch.as_tensor(r.prompt,
                                                      device=DEVICE)
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        lm.forward(params, cfg, toks)
    counted = fc.get_total_flops()
    ours = step_costs(cfg, ShapeConfig("p3", "prefill", S, len(reqs))
                      ).flops_fwd
    ratio = ours / counted
    lo, hi = AN["flop_band"]
    log(f"  (a) one qwen3-32b layer, dense, bf16, prefill group 4 x {S}: "
        f"FlopCounterMode {counted:.4e} FLOP, analytic {ours:.4e}, ratio "
        f"{ratio:.4f} (band {lo}-{hi}); on {card_line()}")
    check(lo < ratio < hi, f"(a) analytic / counted FLOPs {ratio:.4f} "
          f"outside {lo}-{hi}")
    del params
    return dict(counted=counted, analytic=ours, ratio=ratio, rows=S)


def _an_roofline(e2e):
    """(b): step_costs and the H100 roofline of phase 3's decode step (4
    slots, cache 256) and prefill (4 x the longest prompt), 4 layers,
    50% sparsity, bf16, beside what phase 3 measured in this run."""
    from repro_torch.analysis.counters import step_costs
    from repro_torch.configs import ShapeConfig
    from repro_torch.core.h100_model import roofline
    cfg = main_config(N_LAYERS, "bfloat16")
    rows = e2e["prefill_rows"] // 4
    out = {}
    for kind, shape, ms in (
            ("decode", ShapeConfig("p3_decode", "decode", 256, 4),
             e2e["decode_ms_per_step"]),
            ("prefill", ShapeConfig("p3_prefill", "prefill", rows, 4),
             e2e["prefill_ms"])):
        c = step_costs(cfg, shape, sparsity=SPARSITY)
        t = roofline(c.flops, c.bytes_hbm, 0.0, 1)
        share = t.bound_s * 1e3 / ms
        out[kind] = dict(flops=c.flops, bytes_hbm=c.bytes_hbm,
                         bound_ms=t.bound_s * 1e3, bottleneck=t.bottleneck,
                         measured_ms=ms, share=share)
        log(f"  (b) {kind}: bound {t.bound_s * 1e3:.4f} ms ({t.bottleneck};"
            f" {c.flops:.4e} FLOP, {c.bytes_hbm:.4e} B) against phase 3's "
            f"{ms:.3f} ms: {share:.2%} of the measured time, on "
            f"{card_line()}")
        check(share <= AN["max_share"], f"(b) {kind}: the bound is "
              f"{share:.3f} of the measured time: the counters undercount")
    return out


def _an_dry(torch, tm_a):
    """(c): phase 14 (a)'s configuration traced on a dry 1,2 mesh (fake
    tensors, on the host): each rank's held and peak GiB beside what
    phase 14 (a) measured, and its step's collective record equal to the
    real rank's, kind for kind, calls and bytes."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.dryrun import trace_step
    from repro_torch.train.optimizer import AdamWConfig
    cfg = tm_config(False)
    shape = ShapeConfig("tm", "train", TMP["seq"], TMP["batch"])
    out = []
    for r, real in enumerate(tm_a["ranks"]):
        t0 = time.time()
        tr = trace_step(cfg, shape, 1, 2, r,
                        opt_cfg=AdamWConfig(lr=TMP["lr"]), overlay=True,
                        lr_schedule=_tm_schedule())
        held, peak = tr["held"] / 2**30, tr["peak"] / 2**30
        err = abs(held - real["held_gib"]) / real["held_gib"]
        same = tr["record"] == real["record"]
        out.append(dict(rank=r, held_gib=held, peak_gib=peak,
                        real_held_gib=real["held_gib"],
                        real_peak_gib=real["peak_gib"], held_err=err,
                        peak_ratio=peak / real["peak_gib"],
                        record=tr["record"], record_equal=same,
                        trace_s=time.time() - t0))
        log(f"  (c) rank {r}: dry run held {held:.2f} GiB, peak {peak:.2f} "
            f"(phase 14 (a) measured {real['held_gib']:.2f}, "
            f"{real['peak_gib']:.2f}: held {err:.2%} off, peak ratio "
            f"{peak / real['peak_gib']:.3f}); record "
            f"{'equal to' if same else 'NOT equal to'} the real rank's: "
            f"{tr['record']}; traced in {time.time() - t0:.1f} s; on "
            f"{card_line()}")
        check(same, f"(c) rank {r}: the dry record {tr['record']} is not "
              f"the real rank's {real['record']}")
        check(err <= AN["held_tol"], f"(c) rank {r}: held {held:.2f} GiB "
              f"predicted, {real['held_gib']:.2f} measured")
    return out


def _an_tp16(torch, counters):
    """(d): phase 3's packed model at 2 layers, served by the shard loop
    at tp 1, 8 and 16 (``reshard_packed``); at 16 the 8 KV heads do not
    split, so attention stays whole on every shard (the reference's
    replicated SDPA). Greedy streams equal tp 1's but at printed
    near-ties."""
    from repro_torch.core.deploy import reshard_packed
    from repro_torch.distribution.sharding import (heads_split, local_params,
                                                   vocab_config)
    from repro_torch.launch.serve import build_serving_params
    from repro_torch.models import lm
    cfg = main_config(AN["layers"], "bfloat16")
    params, cfg = build_serving_params(
        spread_output_scales(lm.init_params(cfg, seed=0, device=DEVICE),
                             cfg), cfg, path="packed", sparsity=SPARSITY,
        scope="all")
    params = local_params(params, cfg, 1, 0)
    base = _tp_serve(torch, params, cfg, counters)
    out = {1: dict(times=base["times"], launches=base["launches"])}
    for tp in AN["tps"]:
        sharded = reshard_packed(params, cfg, tp=tp)
        wq = sharded["segments"][0]["slot0"]["mixer"]["sasp_packed"]["wq"]
        split = heads_split(cfg, tp)
        check(wq.shards == (tp if split else 1),
              f"(d) tp={tp}: wq in {wq.shards} shards")
        run = _tp_serve(torch, sharded, vocab_config(cfg, tp), counters)
        ties = _greedy_equal(f"(d) tp={tp}", run["streams"], base["streams"],
                             base["rec"]["margins"], ref="the tp=1 run")
        out[tp] = dict(times=run["times"], launches=run["launches"],
                       near_ties=ties, heads="split" if split else
                       "every KV head on every shard")
        log(f"  (d) tp={tp} ({out[tp]['heads']}): decode "
            f"{run['times']['decode_ms_per_step']:.2f} ms/step (tp 1 "
            f"{base['times']['decode_ms_per_step']:.2f}), prefill "
            f"{run['times']['prefill_ms']:.1f} ms; {len(ties)} near-tie "
            f"divergences from tp 1; launches "
            f"{ {n: l['total'] for n, l in run['launches'].items()} }; on "
            f"{card_line()}")
        del sharded, run
    del params
    return out


# name -> (source, TPU kernel it replaces); the first two run on the
# packed main path, the other three on the ablation path of phase 5b
# ---------------------------------------------------------------------------
# phase 16: MoE, SSM and hybrid families trained on a (data, model) mesh
# ---------------------------------------------------------------------------

# (a) moonshot-v1-16b-a3b at full width on --mesh 2,2 (experts in EP over
# 'data', each expert's d_ff over 'model'); (b) jamba's reduced stack on
# 2,2 and mamba2 on 1,2 at widths whose SSD gradients are finite; (c) (a)'s
# checkpoint served packed on one card; (d) four NCCL cards: moonshot at
# full width, 8 layers, on 2,2 and 4,1
# (a)'s depth: 1 layer (2 before phase 17 was added, which the smoke's
# time limit then could not hold)
TFM = dict(layers=1, batch=4, seq=256, steps=3, lr=3e-4, probe=65536,
           nbatch=8, nseq=128, nccl_layers=8,
           narrow=dict(d_model=256, vocab=8192),
           ssm=dict(head_dim=64, state_dim=64, chunk_size=16))
# (b)'s widths: 256 wide, 8 SSM heads of 64 (state 64, chunks of 16):
# above the diagonal the SSD takes exp of sums of up to 15 steps of
# dt |A| <= 8 x 0.3, which stay finite, where mamba2-780m's 48 heads over
# 256-step chunks overflow to inf and its backward gives NaN (the
# reference's _segsum_decay, in both packages)
TFM_NARROW = {"jamba": ((2, 2), 8), "mamba2": ((1, 2), 4)}


def tfm_config(model: str, layers=None):
    """(a) / (d): moonshot-v1-16b-a3b at full width (``layers``, default
    2), fp32 masters, bf16 compute, remat full, the 50% overlay of the
    32x32 FFN tiles, expert stacks included; (b): jamba's (8 layers:
    attention, SSM, MoE and dense-FFN slots, remat full) or mamba2's (4
    layers) reduced stack at ``TFM["narrow"]`` with ``TFM["ssm"]``'s
    heads, fp32 compute, jamba with the overlay."""
    from repro_torch.configs import get_config, reduced
    sasp = train_config(1).sasp
    if model == "moonshot":
        return dataclasses.replace(
            moonshot_config(layers or TFM["layers"], "bfloat16"),
            remat="full", sasp=sasp)
    arch = {"jamba": "jamba-1.5-large-398b", "mamba2": "mamba2-780m"}[model]
    cfg = reduced(get_config(arch), layers=TFM_NARROW[model][1],
                  **TFM["narrow"])
    cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm,
                                                           **TFM["ssm"]))
    if model == "jamba":
        cfg = dataclasses.replace(cfg, remat="full", sasp=sasp)
    return cfg


def _tfm_shape(cfg):
    return (TFM["nbatch"], TFM["nseq"]) if cfg.compute_dtype == "float32" \
        else (TFM["batch"], TFM["seq"])


def _tfm_loop(torch, cfg, mesh_shape, mb=1, steps=TFM["steps"]):
    """The meshless loop at ``mesh_shape`` ((DP, TP) or (P, DP, TP)) run
    in this process: every DP rank's rows in lock step through every MoE
    layer where experts split over 'data' (``train_step._grads_groups``,
    each pod's DP groups joined), else in turn; its masks, step 1's mean
    gradient and the params after step 1 probed as each mesh rank holds
    them (every pod holds the same), losses and aux of ``steps``
    steps."""
    from repro_torch.core.pruning import iter_leaves
    from repro_torch.core.sasp import build_sasp_overlay
    from repro_torch.data.pipeline import DataConfig, Pipeline
    from repro_torch.distribution.sharding import tp_config
    from repro_torch.models import lm
    from repro_torch.train import train_step as ts
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    pod, dp, tp = ((1,) + tuple(mesh_shape))[-3:]
    n_dp = pod * dp
    B, S = _tfm_shape(cfg)
    t0 = time.time()
    with torch.no_grad():
        params = lm.init_params(cfg, seed=0, device=DEVICE)
    oc = AdamWConfig(lr=TFM["lr"])
    layout = ts.mesh_layout(cfg, dp, tp, oc)
    overlay, got = (build_sasp_overlay(params, cfg.sasp)
                    if cfg.sasp.enabled else (None, 0.0))
    masks = ({k: m.cpu().numpy() for k, m in _overlay_masks(overlay)}
             if overlay is not None else {})
    tcfg = tp_config(cfg, tp, ep=dp)
    pipe = Pipeline(DataConfig(cfg.vocab_size, S, B))
    batches = [_batch(torch, pipe) for _ in range(TFM["steps"])]
    got_grads = []

    def first(grads):                     # step 1's mean gradient
        if not got_grads:
            got_grads.append(_tm_slices(list(iter_leaves(grads)),
                                        layout.zero, tp, dp, TFM["probe"]))
    step = ts.make_train_step(tcfg, oc, overlay=overlay, n_microbatches=mb,
                              data_shards=n_dp, lr_schedule=_tm_schedule(),
                              on_grads=first)
    opt = adamw_init(params, oc)
    losses, aux = [], []
    for i, b in enumerate(batches[:steps]):
        params, opt, m = step(params, opt, b)
        losses.append(float(m["loss"]))
        aux.append(float(m["aux"]))
        if i == 0:
            p1 = _tm_slices(list(iter_leaves(params)), layout.params, tp, dp,
                            TFM["probe"])
    out = dict(losses=losses, aux=aux, grads=got_grads[0], params1=p1,
               masks=masks, sparsity=got, seconds=time.time() - t0)
    del params, opt, overlay, step
    return out


def _tfm_case(torch, mesh, spec, case):
    """One family's training case on this rank (``launch.train``'s
    ``rank_params``: its data rank's experts, its model rank's d_ff and
    heads), ZeRO moments (expert stacks EP-cut only), the overlay ranked
    over the whole tree, step 1's mean gradient and the params after
    step 1 probed, TFM["steps"] timed steps (all-to-alls counted on the
    last), the final params probed; with ``case["save"]`` the params
    saved by ``save_on_mesh``."""
    from repro_torch.core.pruning import iter_leaves
    from repro_torch.core.sasp import mesh_overlay
    from repro_torch.data.pipeline import DataConfig, Pipeline
    from repro_torch.distribution.sharding import local_config, tp_config
    from repro_torch.launch.train import rank_params
    from repro_torch.train import train_step as ts
    from repro_torch.train.checkpoint import (CheckpointManager,
                                              gather_whole, save_on_mesh)
    from repro_torch.train.optimizer import AdamWConfig, zero_adamw_init
    dev = mesh.device
    dp, tp = mesh.shape["data"], mesh.shape["model"]
    cfg = case["cfg"]
    B, S = _tfm_shape(cfg)
    oc = AdamWConfig(lr=TFM["lr"])
    layout = ts.mesh_layout(cfg, dp, tp, oc, pod=mesh.pods)
    cuda = torch.device(dev).type == "cuda"     # (not measured on the CPU)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        params = rank_params(cfg, layout, mesh)
    opt = zero_adamw_init(params, layout.zero, oc, mesh)
    overlay, got = (mesh_overlay(params, cfg.sasp, mesh, layout.params)
                    if cfg.sasp.enabled else (None, 0.0))
    _dev_sync(torch, dev)
    out = dict(init_s=time.perf_counter() - t0, sparsity=got, masks={})
    if overlay is not None:
        out["masks"] = {
            k: gather_whole(m.to(torch.uint8), layout.params[
                ("segments", k[0], k[1], "ffn", k[2], "w")], mesh).bool()
            .cpu().numpy() for k, m in _overlay_masks(overlay)}
    lcfg = local_config(tp_config(cfg, tp, ep=dp), tp)
    pipe = Pipeline(DataConfig(cfg.vocab_size, S, B))
    batches = [_batch_on(torch, pipe, dev) for _ in range(TFM["steps"])]
    mb = case.get("mb", 1)
    n = TFM["probe"]

    def first(gs):              # step 1's reduced gradient slices
        if "grads" not in out:
            out["grads"] = {p: _probe(x, n) for p, x in gs.items()}
            out["grads_finite"] = all(bool(torch.isfinite(x).all())
                                      for x in gs.values())
    step = ts.make_mesh_train_step(lcfg, opt_cfg=oc, mesh=mesh,
                                   layout=layout, overlay=overlay,
                                   n_microbatches=mb,
                                   lr_schedule=_tm_schedule(),
                                   on_grads=first)
    losses, aux, ms, out["sums"] = [], [], [], []
    for i in range(case.get("steps", TFM["steps"])):
        _dev_sync(torch, dev)
        mesh.reset_record()
        t = time.perf_counter()
        params, opt, m = step(params, opt, batches[i])
        _dev_sync(torch, dev)
        ms.append((time.perf_counter() - t) * 1e3)
        losses.append(float(m["loss"]))
        aux.append(float(m["aux"]))
        if mesh.pods > 1:
            out["sums"].append(_state_sums(torch, params, opt))
        if i == 0:
            out["params1"] = {p: _probe(x, n) for p, x in
                              iter_leaves(params)}
    out.update(losses=losses, aux=aux, step_ms=ms, a2a=mesh.a2a,
               record=mesh.record(),
               tok_s=B * S / (sum(ms[1:]) / max(1, len(ms) - 1) / 1e3),
               held_gib=torch.cuda.memory_allocated(dev) / 2**30 if cuda
               else float("nan"),
               peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30 if cuda
               else float("nan"))
    if case.get("save"):
        out["final"] = {p: _probe(x, n) for p, x in iter_leaves(params)}
        specs = ts.state_specs(params, layout)
        t = time.perf_counter()
        save_on_mesh(CheckpointManager(spec["ckpt_dir"]), TFM["steps"],
                     {"params": params}, {"params": specs["params"]}, mesh,
                     extra={"step": TFM["steps"]})
        out["save_s"] = time.perf_counter() - t
    return out


def _tfm_rank(rank: int, spec: dict, init_file: str) -> dict:
    """A training mesh's rank, spawned: join the mesh (``spec["pod"]``
    pods, default 1), run ``spec["cases"]`` in turn (``_tfm_case``, or
    ``_tm_case`` for a case with ``"tm"``)."""
    import torch
    from repro_torch.launch.mesh import make_mesh
    dp, tp = spec["mesh"]
    pod = spec.get("pod", 1)
    if spec["device"] == "cpu":
        torch.set_num_threads(max(1, torch.get_num_threads()
                                  // (pod * dp * tp)))
    mesh = make_mesh(dp, tp, pod=pod, rank=rank, init_file=init_file,
                     backend=spec["backend"], device=spec["device"])
    out = dict(rank=rank, model_rank=mesh.model_rank,
               data_rank=mesh.data_rank, pod_rank=mesh.pod_rank,
               transport=mesh.transport, cases={})
    for case in spec["cases"]:
        run = _tm_case if case.get("tm") else _tfm_case
        out["cases"][case["name"]] = run(torch, mesh, spec, case)
        _free(torch)
    return out


def _tfm_spawn(spec, timeout=900):
    from repro_torch.launch.mesh import init_file_in, run_ranks
    store = init_file_in(OUT_DIR,
                         f"tfm_store_{os.getpid()}_{time.time_ns()}")
    try:
        return run_ranks(_tfm_rank, spec.get("pod", 1) * spec["mesh"][0]
                         * spec["mesh"][1], (spec, store), timeout=timeout)
    finally:
        if os.path.exists(store):
            os.remove(store)


def _tfm_check(tag, res, name, loop, tol):
    """Every rank's case ``name`` against the loop: masks equal, step 1's
    loss, the losses and aux, step 1's gradient slices and the params
    after step 1 (each rank's own slices, its experts' included) within
    ``tol``. Returns the largest errors found."""
    worst = dict(loss1=0.0, losses=0.0, aux=0.0, grads=0.0, params1=0.0,
                 mask_tiles=0)
    for r in res:
        c, key = r["cases"][name], (r["model_rank"], r["data_rank"])
        check(c["grads_finite"], f"{tag} rank {r['rank']}: a gradient is "
              f"not finite")
        worst["mask_tiles"] = max(worst["mask_tiles"], sum(
            int((c["masks"][k] != m).sum()) for k, m in loop["masks"].items()))
        errs = dict(
            loss1=abs(c["losses"][0] - loop["losses"][0])
            / abs(loop["losses"][0]),
            losses=max(abs(a - b) / abs(b) for a, b in zip(c["losses"],
                                                           loop["losses"])),
            aux=max(abs(a - b) / max(abs(b), 1e-30)
                    for a, b in zip(c["aux"], loop["aux"])),
            grads=max(_probe_err(g, loop["grads"][(p,) + key])
                      for p, g in c["grads"].items()),
            params1=max(_probe_err(x, loop["params1"][(p,) + key],
                                   "params1_abs" in tol)
                        for p, x in c["params1"].items()))
        for k, v in errs.items():
            worst[k] = max(worst[k], v)
    check(worst["mask_tiles"] == 0, f"{tag}: {worst['mask_tiles']} overlay "
          f"tiles differ from the loop's (a near-tie of the tile L1?)")
    tol = dict(tol, params1=tol.get("params1_abs", tol.get("params1")))
    for k in ("loss1", "losses", "aux", "grads", "params1"):
        check(worst[k] <= tol[k], f"{tag}: {k} {worst[k]:.3e} from the "
              f"meshless loop, bound {tol[k]}")
    return worst


def _tfm_log(tag, res, name, loop, worst, wall):
    c = [r["cases"][name] for r in res]
    a2a = c[0]["a2a"]
    log(f"  {tag} over {res[0]['transport']}: {wall:.1f} s wall (loop "
        f"{loop['seconds']:.1f} s); losses "
        f"{[round(x, 5) for x in c[0]['losses']]} (loop "
        f"{[round(x, 5) for x in loop['losses']]}); aux "
        f"{[round(x, 6) for x in c[0]['aux']]} (loop "
        f"{[round(x, 6) for x in loop['aux']]}); step ms by rank "
        f"{[[round(x, 1) for x in r['step_ms']] for r in c]}, "
        f"{c[0]['tok_s']:.0f} tokens/s; GiB a rank held "
        f"{[round(r['held_gib'], 2) for r in c]}, peak "
        f"{[round(r['peak_gib'], 2) for r in c]}; all-to-alls a step "
        f"{a2a['calls']} calls, {a2a['bytes'] / 2**20:.1f} MiB a rank; "
        f"against the loop: step 1 loss {worst['loss1']:.2e}, losses "
        f"{worst['losses']:.2e}, aux {worst['aux']:.2e}, step 1 gradient "
        f"slices {worst['grads']:.2e}, params after step 1 "
        f"{worst['params1']:.2e}, overlay tiles differing "
        f"{worst['mask_tiles']}")


def _tfm_summary(res, name, loop, worst, wall):
    return dict(wall_s=wall, loop_s=loop["seconds"], worst=worst,
                loop_losses=loop["losses"], loop_aux=loop["aux"],
                ranks=[{k: v for k, v in r["cases"][name].items()
                        if k not in ("masks", "grads", "params1", "final",
                                     "record")} for r in res])


def _tfm_full(torch, ckpt):
    """(a) and (b)'s jamba on --mesh 2,2 in one spawn (this card, gloo
    host-staged), each held to its loop run first here; (b)'s mamba2 on
    --mesh 1,2."""
    cfg = tfm_config("moonshot")
    log(f"  (a) moonshot-v1-16b-a3b at full width: d_model {cfg.d_model}, "
        f"{cfg.moe.num_experts} experts top {cfg.moe.top_k}, expert d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}; depth cut 48 -> "
        f"{cfg.num_layers} layers; batch {TFM['batch']} x {TFM['seq']}; "
        f"{TFM_NARROW['jamba'][1]}-layer jamba and "
        f"{TFM_NARROW['mamba2'][1]}-layer mamba2 at d_model "
        f"{TFM['narrow']['d_model']} with {TFM['ssm']} (finite SSD "
        f"gradients: mamba2-780m's own widths give NaN in both packages)")
    cfgs = {"a": cfg, "jamba": tfm_config("jamba"),
            "mamba2": tfm_config("mamba2")}
    loops = {}
    for name, shape in (("a", (2, 2)), ("jamba", TFM_NARROW["jamba"][0]),
                        ("mamba2", TFM_NARROW["mamba2"][0])):
        loops[name] = _tfm_loop(torch, cfgs[name], shape)
        _free(torch)
    out = {}
    # bf16 compute (phase 14 (a)'s bounds): the forward is the loop's bit
    # for bit, the backward sums a column region's input gradient in
    # another order; AdamW's first step moves an element by lr times the
    # gradient's sign, so near-equal gradients leave params 2 lr apart
    lr1 = TFM["lr"] * float(_tm_schedule()(0))
    bf16 = dict(loss1=0.0, losses=1e-3, aux=1e-3, grads=5e-2,
                params1_abs=2.5 * lr1)
    # fp32 compute: as on the CPU; the params after step 1 absolute, a
    # tenth of (a)'s bound: the SSM's zero-init conv_b moves by lr g /
    # (|g| + eps) on step 1, a share of lr that a gradient's last bits
    # shift where |g| is near eps
    fp32 = dict(loss1=1e-5, losses=1e-5, aux=1e-5, grads=1e-5,
                params1_abs=0.25 * lr1)
    for shape, names in (((2, 2), ("a", "jamba")), ((1, 2), ("mamba2",))):
        spec = dict(mesh=shape, device=DEVICE, backend="gloo",
                    ckpt_dir=ckpt, cases=[
                        dict(name=n, cfg=cfgs[n], save=n == "a")
                        for n in names])
        t0 = time.time()
        res = _tfm_spawn(spec)
        wall = time.time() - t0
        for n in names:
            tag = (f"({'a' if n == 'a' else 'b'}) "
                   f"{cfgs[n].name} --mesh {shape[0]},{shape[1]}")
            worst = _tfm_check(tag, res, n, loops[n],
                               bf16 if n == "a" else fp32)
            _tfm_log(tag, res, n, loops[n], worst, wall)
            out[n] = _tfm_summary(res, n, loops[n], worst, wall)
        if "a" in names:
            out["final"] = {(r["model_rank"], r["data_rank"]):
                            r["cases"]["a"]["final"] for r in res}
            out["record"] = res[0]["cases"]["a"]["record"]
    return out


def _tfm_serve(torch, counters, ckpt, final):
    """(c): (a)'s checkpoint, restored whole on this card (every leaf
    equal to the ranks' final slices, probed), packed at 50% scope all
    through ``launch.serve``'s path, served: the tile-skip GEMM on
    mma."""
    from repro_torch.core.pruning import iter_leaves
    from repro_torch.distribution.sharding import take_slice
    from repro_torch.launch import serve as launch
    from repro_torch.models import lm
    from repro_torch.train import train_step as ts
    from repro_torch.train.optimizer import AdamWConfig
    cfg = tfm_config("moonshot")
    t0 = time.time()
    with torch.no_grad():
        whole = launch.restore_params(ckpt, lm.init_params(cfg, seed=1,
                                                           device=DEVICE))
    layout = ts.mesh_layout(cfg, 2, 2, AdamWConfig())
    bad = [(p, key) for key, probes in final.items()
           for p, x in iter_leaves(whole)
           if _probe_err(_probe(take_slice(x, layout.params[p], key[0], 2,
                                           key[1], 2), TFM["probe"]),
                         probes[p]) != 0.0]
    check(not bad, f"(c) restored leaves differ from the ranks' trained "
          f"slices: {bad[:4]}")
    params, lcfg = launch.build_serving_params(
        whole, cfg, path="packed", sparsity=SPARSITY, scope="all",
        verbose=False)
    del whole
    run = _tp_serve(torch, params, lcfg, counters)
    lc = run["launches"]["sasp_gemm"]
    check(lc["total"] > 0 and set(lc["variant"]) == {"mma"},
          f"(c) sasp_gemm launched {lc}, not on mma")
    check(all(len(s) == 16 for s in run["streams"].values()),
          "(c) a request did not finish its 16 tokens")
    wall = time.time() - t0
    log(f"  (c) (a)'s checkpoint restored on one card (every leaf equal to "
        f"the ranks' trained slices), packed at 50% scope all: 4 requests "
        f"x 16 tokens, sasp_gemm {lc['total']} launches {lc['variant']}, "
        f"decode {run['times']['decode_ms_per_step']:.2f} ms/step; "
        f"{wall:.1f} s")
    del params
    return dict(wall_s=wall, launches={n: run["launches"][n]["total"]
                                       for n in MAIN_PATH},
                times=run["times"])


def _tfm_four_cards(torch):
    """(d) over NCCL, a card a rank: moonshot at full width, 8 layers, on
    --mesh 2,2 and 4,1: step ms, tokens/s, GiB a rank, all-to-all bytes
    a step, losses finite."""
    import numpy as np
    n = torch.cuda.device_count()
    if n < 4:
        log(f"  (d) nccl: not run ({n} card{'s' if n > 1 else ''})")
        return f"not run ({n} card{'s' if n > 1 else ''})"
    out = {}
    cfg = tfm_config("moonshot", TFM["nccl_layers"])
    for shape in ((2, 2), (4, 1)):
        spec = dict(mesh=shape, device=DEVICE, backend="nccl",
                    cases=[dict(name="d", cfg=cfg)])
        t0 = time.time()
        res = _tfm_spawn(spec)
        c = [r["cases"]["d"] for r in res]
        check(all(np.isfinite(r["losses"]).all() and r["grads_finite"]
                  for r in c), f"(d) --mesh {shape}: a loss or gradient is "
              f"not finite")
        key = f"--mesh {shape[0]},{shape[1]}"
        a2a = c[0]["a2a"]
        log(f"  (d) {key} over {res[0]['transport']}, {cfg.num_layers} "
            f"layers: losses {[round(x, 5) for x in c[0]['losses']]}; step "
            f"ms {[round(x, 1) for x in c[0]['step_ms']]}, "
            f"{c[0]['tok_s']:.0f} tokens/s; GiB a rank held "
            f"{[round(r['held_gib'], 2) for r in c]}, peak "
            f"{[round(r['peak_gib'], 2) for r in c]}; all-to-alls a step "
            f"{a2a['calls']} calls, {a2a['bytes'] / 2**20:.1f} MiB a rank; "
            f"{time.time() - t0:.1f} s")
        out[key] = [{k: v for k, v in r.items()
                     if k not in ("masks", "grads", "params1", "record")}
                    for r in c]
    return out


def train_family_mesh_phase(torch, counters):
    """Phase 16: MoE, SSM and hybrid families trained on a mesh; run
    last, with every earlier model freed."""
    import shutil
    t_phase = time.time()
    ckpt = os.path.join(OUT_DIR, "train_family_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    try:
        out = _tfm_full(torch, ckpt)
        _free(torch)
        out["c"] = _tfm_serve(torch, counters, ckpt, out.pop("final"))
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    _free(torch)
    out["d"] = _tfm_four_cards(torch)
    out["launches"] = out["c"]["launches"]
    out["seconds"] = time.time() - t_phase
    log(f"  phase 16: {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 17: training on a (pod, data, model) mesh
# ---------------------------------------------------------------------------

# (a) phase 16 (a)'s moonshot on --mesh 2,2,2 (experts in EP over each
# pod's 'data' ranks, a replica in each pod); (b) phase 14 (b)'s narrow
# qwen3 on 2,2,2 and 2,1,2; (c) (b)'s checkpoint served packed on one
# card; (d) (a)'s and (b)'s steps on a dry 2,2,2 mesh; (e) four NCCL
# cards: moonshot, 8 layers, on 2,2,1, printed beside phase 16 (d)'s
# 4287 tokens/s on 2,2 and 4673 on 4,1 (four H100 80GB HBM3, 700 W)
# (a) is cut to 1 layer: 8 ranks of 2 layers need more than the card's 79
# GiB (a rank reached 7.6 GiB allocated, 78.85 GiB in use on the card,
# when one more allocation failed)
POD = dict(mesh=(2, 2, 2), layers=1, nccl=(2, 2, 1), nccl_layers=8,
           dry_ranks=(0, 7), tok_s_before={"2,2": 4287, "4,1": 4673})
# (b)'s cases by mesh: (name, int8 moments, micro-batches); the 2,1,2
# case saves the checkpoint that (c) serves and resumes it
POD_CASES = {(2, 2, 2): (("fp32 mb2", False, 2), ("int8", True, 1)),
             (2, 1, 2): (("fp32", False, 1),)}


def _state_sums(torch, params, opt):
    """Every leaf of a rank's params and moments as (sum, sum of squares)
    of its elements' bit patterns (int64, wrapping), summed on the card
    in chunks: two ranks whose sums agree leaf for leaf hold the same
    bits but for a collision of both sums."""
    from repro_torch.train.checkpoint import named_leaves
    ints = {4: torch.int32, 2: torch.int16, 1: torch.int8}
    sums = []
    for _, t in named_leaves({"params": params, "opt": opt}):
        v = t.detach().reshape(-1).view(ints[t.element_size()])
        s1 = s2 = torch.zeros((), dtype=torch.int64, device=v.device)
        for i in range(0, v.numel(), 1 << 24):
            c = v[i:i + (1 << 24)].to(torch.int64)
            s1, s2 = s1 + c.sum(), s2 + (c * c).sum()
        sums += [s1, s2]
    return torch.stack(sums).tolist()


def _pods_equal(tag, res, name) -> int:
    """Check that every rank's state sums (``_state_sums``, after every
    step) equal those of the rank at its (data, model) index in pod 0;
    returns the leaf-steps compared."""
    first = {(r["model_rank"], r["data_rank"]): r["cases"][name]["sums"]
             for r in res if r["pod_rank"] == 0}
    n = 0
    for r in res:
        got = r["cases"][name]["sums"]
        want = first[r["model_rank"], r["data_rank"]]
        check(bool(got) and got == want, f"{tag}: rank {r['rank']} (pod "
              f"{r['pod_rank']}) holds other params or moments than pod 0's "
              f"rank at its (data, model) index")
        n += sum(len(x) // 2 for x in got) if r["pod_rank"] else 0
    return n


def _pod_train(torch, ckpt):
    """(a) and (b)'s 2,2,2 cases in one spawn of 8 processes on this card
    (gloo host-staged), then (b)'s 2,1,2 case (4 processes); each held
    to its loop, run first here, and both pods to each other."""
    from repro_torch.analysis.comms import axis_bytes
    cfg_a, cfg_b = tfm_config("moonshot", POD["layers"]), tm_config(True)
    log(f"  (a) moonshot-v1-16b-a3b at full width: d_model {cfg_a.d_model}, "
        f"{cfg_a.moe.num_experts} experts top {cfg_a.moe.top_k}, expert "
        f"d_ff {cfg_a.d_ff}, vocab {cfg_a.vocab_size}; depth cut 48 -> "
        f"{cfg_a.num_layers} layers; batch {TFM['batch']} x {TFM['seq']}; "
        f"(b) qwen3 at {TMP['narrow']}, fp32, batch {TMP['nbatch']} x "
        f"{TMP['nseq']}")
    t0 = time.time()
    loops = {"a": _tfm_loop(torch, cfg_a, POD["mesh"])}
    _free(torch)
    for shape, cases in POD_CASES.items():
        for name, q, mb in cases:
            loops[shape, name] = _tm_loop(torch, cfg_b, shape, q, mb)
            _free(torch)
    loop_s = time.time() - t0
    log(f"  the loops: {loop_s:.1f} s ((a) {loops['a']['seconds']:.1f} s)")
    lr1 = TFM["lr"] * float(_tm_schedule()(0))
    out = dict(loop_s=loop_s)
    for shape, cases in POD_CASES.items():
        pod, dp, tp = shape
        tm = [dict(name=n, tm=True, int8=q, mb=mb, save=shape[1] == 1)
              for n, q, mb in cases]
        first = shape == POD["mesh"]
        spec = dict(mesh=(dp, tp), pod=pod, device=DEVICE, backend="gloo",
                    cfg=cfg_b, ckpt_dir=ckpt,
                    cases=([dict(name="a", cfg=cfg_a)] if first else []) + tm)
        t0 = time.time()
        res = _tfm_spawn(spec)
        wall = time.time() - t0
        key = f"--mesh {pod},{dp},{tp}"
        out[key] = dict(wall_s=wall)
        if first:
            # phase 16 (a)'s bounds (bf16 compute)
            tag = f"(a) {cfg_a.name} {key}"
            worst = _tfm_check(tag, res, "a", loops["a"], dict(
                loss1=0.0, losses=1e-3, aux=1e-3, grads=5e-2,
                params1_abs=2.5 * lr1))
            _tfm_log(tag, res, "a", loops["a"], worst, wall)
            n = _pods_equal(tag, res, "a")
            c = [r["cases"]["a"] for r in res]
            rec = c[0]["record"]
            by = axis_bytes(rec)
            log(f"  {tag}: both pods' params and moments equal after every "
                f"step ({n} leaf-steps of pod 1 against pod 0); a step moves "
                f"{by.get('pod', 0) / 2**20:.1f} MiB over 'pod', "
                f"{by.get('data', 0) / 2**20:.1f} MiB over 'data' "
                f"({c[0]['a2a']['bytes'] / 2**20:.1f} MiB in "
                f"{c[0]['a2a']['calls']} all-to-alls) and "
                f"{by.get('pod,data', 0) / 2**20:.3f} MiB over "
                f"('pod', 'data') a rank; on {card_line()}")
            out["a"] = dict(_tfm_summary(res, "a", loops["a"], worst, wall),
                            pods_equal=n, record=rec,
                            records={r["rank"]: r["cases"]["a"]["record"]
                                     for r in res})
        for case in tm:
            name = case["name"]
            for r in res:
                r["case"] = r["cases"][name]
            tag = f"(b) {key} {name}"
            q = name.startswith("int8")
            worst = _tm_check(tag, res, loops[shape, name], dict(
                loss1=1e-5, losses=1e-5 if not q else 1e-3, grads=1e-5,
                params1=1e-4))
            n = _pods_equal(tag, res, name)
            c = [r["case"] for r in res]
            log(f"  {tag} ({wall:.1f} s wall): "
                f"{[round(x, 5) for x in c[0]['losses']]}; step ms "
                f"{[round(x, 1) for x in c[0]['step_ms']]}, "
                f"{c[0]['tok_s']:.0f} tokens/s; against the loop: losses "
                f"{worst['losses']:.2e}, gradient slices {worst['grads']:.2e}"
                f", params after step 1 {worst['params1']:.2e}; pods equal "
                f"({n} leaf-steps)")
            if case["save"]:
                check(all(r["case"]["resume_equal"] for r in res),
                      f"{tag}: step {TMP['steps'] + 1} from the restored "
                      f"checkpoint differs from the uninterrupted run "
                      f"({[r['case']['resume_loss'] for r in res]})")
                log(f"  {tag}: saved by world rank 0 in "
                    f"{c[0]['save_s']:.2f} s (pod 0 gathers), restored on "
                    f"every pod: step {TMP['steps'] + 1} bit for bit the "
                    f"uninterrupted run's on every rank")
            out[tag] = dict(worst=worst, pods_equal=n, ranks=[{
                k: v for k, v in r["case"].items()
                if k not in ("masks", "grads", "params1", "sums")}
                for r in res])
    return out


def _pod_serve(torch, counters, ckpt):
    """(c): (b)'s 2,1,2 checkpoint restored whole on this card, packed at
    50% scope all, bf16, served: both main-path kernels on mma."""
    from repro_torch.launch import serve as launch
    from repro_torch.models import lm
    cfg = dataclasses.replace(tm_config(True), compute_dtype="bfloat16")
    t0 = time.time()
    with torch.no_grad():
        whole = launch.restore_params(ckpt, lm.init_params(cfg, seed=1,
                                                           device=DEVICE))
    params, lcfg = launch.build_serving_params(
        whole, cfg, path="packed", sparsity=SPARSITY, scope="all",
        verbose=False)
    del whole
    run = _tp_serve(torch, params, lcfg, counters)
    for n in MAIN_PATH:
        lc = run["launches"][n]
        check(lc["total"] > 0 and all(
            part == "mma" for v in lc["variant"] for part in v.split("/")),
            f"(c) {n} launched {lc}, not on mma")
    check(all(len(s) == 16 for s in run["streams"].values()),
          "(c) a request did not finish its 16 tokens")
    wall = time.time() - t0
    log(f"  (c) (b)'s pod-trained checkpoint restored on one card, packed "
        f"at 50% scope all: 4 requests x 16 tokens, launches "
        f"{ {n: run['launches'][n]['variant'] for n in MAIN_PATH} }, decode "
        f"{run['times']['decode_ms_per_step']:.2f} ms/step; {wall:.1f} s")
    del params
    return dict(wall_s=wall, launches={n: run["launches"][n]["total"]
                                       for n in MAIN_PATH},
                times=run["times"])


def _pod_dry(torch, train):
    """(d): (a)'s moonshot MoE step traced on a dry 2,2,2 mesh (fake
    tensors, on the host: expert parallelism declared even, no host
    read), its record equal to the real rank's and its held GiB beside
    what (a)'s rank held; (b)'s int8 step traced there, its record equal
    to the real rank's."""
    from repro_torch.analysis.comms import axis_bytes
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.dryrun import trace_step
    from repro_torch.train.optimizer import AdamWConfig
    pod, dp, tp = POD["mesh"]
    cfg = tfm_config("moonshot", POD["layers"])
    B, S = _tfm_shape(cfg)
    out = {}
    for r in POD["dry_ranks"]:
        t0 = time.time()
        tr = trace_step(cfg, ShapeConfig("tfm", "train", S, B), dp, tp, r,
                        opt_cfg=AdamWConfig(lr=TFM["lr"]), overlay=True,
                        lr_schedule=_tm_schedule(), pod=pod)
        held = tr["held"] / 2**30
        real = train["a"]["ranks"][r]["held_gib"]
        err = abs(held - real) / real
        want_a = train["a"]["records"][r]
        same_a = tr["record"] == want_a
        t_a = time.time() - t0
        tr_b = trace_step(tm_config(True), ShapeConfig(
            "tm", "train", TMP["nseq"], TMP["nbatch"]), dp, tp, r,
            opt_cfg=AdamWConfig(lr=TMP["lr"], quantized=True), overlay=True,
            lr_schedule=_tm_schedule(), pod=pod)
        want = train["(b) --mesh 2,2,2 int8"]["ranks"][r]["record"]
        same = tr_b["record"] == want
        out[r] = dict(held_gib=held, peak_gib=tr["peak"] / 2**30,
                      real_held_gib=real, held_err=err,
                      record_a=tr["record"], record_a_equal=same_a,
                      trace_a_s=t_a, record=tr_b["record"],
                      record_equal=same, seconds=time.time() - t0)
        log(f"  (d) rank {r}: (a)'s MoE step traced on the dry mesh in "
            f"{t_a:.1f} s: held {held:.2f} GiB, peak "
            f"{tr['peak'] / 2**30:.2f} ((a) measured {real:.2f}, "
            f"{err:.2%} off); record "
            f"{'equal to' if same_a else 'NOT equal to'} the real rank's "
            f"(all-to-alls {want_a.get('all-to-all')}); (b)'s int8 step "
            f"record "
            f"{'equal to' if same else 'NOT equal to'} the real rank's "
            f"({axis_bytes(want).get('pod', 0) / 2**20:.2f} MiB over "
            f"'pod'); {time.time() - t0:.1f} s")
        check(same_a, f"(d) rank {r}: (a)'s dry record {tr['record']} is "
              f"not the real rank's {want_a}")
        check(same, f"(d) rank {r}: the dry record {tr_b['record']} is not "
              f"the real rank's {want}")
        check(err <= AN["held_tol"], f"(d) rank {r}: held {held:.2f} GiB "
              f"predicted, {real:.2f} measured")
    return out


def _pod_four_cards(torch):
    """(e) over NCCL, a card a rank: moonshot at full width, 8 layers, on
    --mesh 2,2,1: step ms, tokens/s, GiB a rank, bytes over 'pod' and
    all-to-all bytes a step, losses finite, pods equal."""
    from repro_torch.analysis.comms import axis_bytes
    import numpy as np
    n = torch.cuda.device_count()
    if n < 4:
        log(f"  (e) nccl: not run ({n} card{'s' if n > 1 else ''})")
        return f"not run ({n} card{'s' if n > 1 else ''})"
    pod, dp, tp = POD["nccl"]
    cfg = tfm_config("moonshot", POD["nccl_layers"])
    spec = dict(mesh=(dp, tp), pod=pod, device=DEVICE, backend="nccl",
                cases=[dict(name="e", cfg=cfg)])
    t0 = time.time()
    res = _tfm_spawn(spec)
    c = [r["cases"]["e"] for r in res]
    key = f"--mesh {pod},{dp},{tp}"
    check(all(np.isfinite(r["losses"]).all() and r["grads_finite"]
              for r in c), f"(e) {key}: a loss or gradient is not finite")
    eq = _pods_equal(f"(e) {key}", res, "e")
    rec = c[0]["record"]
    log(f"  (e) {key} over {res[0]['transport']}, {cfg.num_layers} layers: "
        f"losses {[round(x, 5) for x in c[0]['losses']]}; step ms "
        f"{[round(x, 1) for x in c[0]['step_ms']]}, {c[0]['tok_s']:.0f} "
        f"tokens/s (phase 16 (d) measured 2,2 "
        f"{POD['tok_s_before']['2,2']}, 4,1 {POD['tok_s_before']['4,1']}); "
        f"GiB a rank held {[round(r['held_gib'], 2) for r in c]}, peak "
        f"{[round(r['peak_gib'], 2) for r in c]}; a step moves "
        f"{axis_bytes(rec).get('pod', 0) / 2**20:.1f} MiB over "
        f"'pod', "
        f"{c[0]['a2a']['bytes'] / 2**20:.1f} MiB in all-to-alls a rank; "
        f"pods equal ({eq} leaf-steps); {time.time() - t0:.1f} s")
    return {key: [{k: v for k, v in r.items()
                   if k not in ("masks", "grads", "params1", "sums")}
                  for r in c]}


def pod_mesh_phase(torch, counters):
    """Phase 17: training on a (pod, data, model) mesh; run last, with
    every earlier model freed."""
    import shutil
    t_phase = time.time()
    ckpt = os.path.join(OUT_DIR, "pod_mesh_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    try:
        out = {"train": _pod_train(torch, ckpt)}
        _free(torch)
        out["c"] = _pod_serve(torch, counters, ckpt)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    _free(torch)
    out["d"] = _pod_dry(torch, out["train"])
    out["e"] = _pod_four_cards(torch)
    out["launches"] = out["c"]["launches"]
    out["seconds"] = time.time() - t_phase
    log(f"  phase 17: {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 18: the reference's long-context layout on a mesh
# ---------------------------------------------------------------------------

# one slot, so that the batch does not split over 'data': (a) gemma3-4b at
# full width, 6 layers (5 windowed of 1024, 1 global), cache 32768, a
# 512-token prompt, on --mesh 2,1 (rings cut over 'data'); (b) moonshot
# at full width, 1 layer, on --mesh 2,1 (experts cut 32 / 32, the
# replicated mode); (c) a narrow gemma3 with one KV head on --mesh 1,2
# (every model rank runs every head: rings cut over 'model')
SEQP = dict(layers=6, new=16, logit_share=2e-2,
            cases={"a": (512, 32768), "b": (64, 256), "c": (64, 256)})
SEQ_MESHES = {(2, 1): ("a", "b"), (1, 2): ("c",)}
# the main-path kernels each case launches (packed, scope all): moonshot
# its attention projections only (its FFNs are experts, masked-dense)
SEQ_KERNELS = {"a": {"sasp_gemm": "mma", "sasp_fused_ffn": "mma/mma"},
               "b": {"sasp_gemm": "mma"},
               "c": {"sasp_gemm": "mma", "sasp_fused_ffn": "mma/mma"}}


def seq_case_config(case: str):
    """(a) gemma3-4b at full width, ``SEQP["layers"]`` layers; (b)
    moonshot-v1-16b-a3b at full width, 1 layer; (c) gemma3-4b at d_model
    512 (4 heads of 128, window 16), 6 layers, vocab 8192, with one KV
    head; bf16 compute."""
    from repro_torch.configs import get_config, reduced
    if case == "a":
        return dataclasses.replace(get_config("gemma3-4b"),
                                   num_layers=SEQP["layers"],
                                   compute_dtype="bfloat16")
    if case == "b":
        return moonshot_config(1, "bfloat16")
    return dataclasses.replace(
        reduced(get_config("gemma3-4b"), layers=6, d_model=512, vocab=8192),
        num_kv_heads=1, compute_dtype="bfloat16")


def _seq_build(torch, cfg0, tp, rank, data_rank, ep, device):
    """``build_rank_params`` (50% of the 32x32 tiles, scope all, packed;
    wo and w2 spread as drawn): (tree, deployed config, rank config)."""
    from repro_torch.launch import serve as launch
    params, tcfg, lcfg, _ = launch.build_rank_params(
        cfg0, tp=tp, rank=rank, device=device, sparsity=SPARSITY,
        scope="all", path="packed", prepare=spread_leaf(cfg0), ep=ep,
        data_rank=data_rank)
    return params, tcfg, lcfg


def _kv_bytes(eng) -> int:
    """Bytes of an engine's attention rings (SSM states apart)."""
    return sum(leaf.numel() * leaf.element_size()
               for seg in eng.caches for c in seg.values()
               if hasattr(c, "k") for leaf in c if leaf is not None)


def _expert_bytes(params) -> int:
    """Bytes of every expert stack's matrices in a tree."""
    n = 0
    for seg in params["segments"]:
        for slot in seg.values():
            ffn = slot["ffn"]
            if "router" in ffn:
                n += sum(ffn[w]["w"].numel() * ffn[w]["w"].element_size()
                         for w in ("w1", "w2", "w3") if w in ffn)
    return n


def _seq_prompt(vocab: int, n: int):
    import numpy as np
    return np.random.default_rng(18).integers(0, vocab, size=(n,)).astype(
        np.int32)


def _seq_serve(torch, params, cfg, counters, case, mesh=None, **kw):
    """The case's one request (its prompt, ``SEQP["new"]`` tokens)
    through ``Engine`` of one slot at the case's cache length, on
    ``mesh`` or as the meshless twin (``kw``), every step timed, every
    decode step's fp32 logits kept; launch counts and the mesh's record
    set to 0 just before the run and read just after."""
    from repro_torch.serve.engine import Engine, Request
    n, C = SEQP["cases"][case]
    eng = Engine(params, cfg, batch_slots=1, cache_len=C, mesh=mesh, **kw)
    logits = []
    dec = eng._decode_step

    def recorded(p, c, *a):
        x = dec(p, c, *a)
        logits.append(x.float().cpu())
        return x
    eng._decode_step = recorded
    req = Request(rid=0, prompt=_seq_prompt(cfg.vocab_size, n),
                  max_new_tokens=SEQP["new"])
    reset(counters)
    if mesh is not None:
        mesh.reset_record()
    streams, steps = _drive_timed(torch, eng, [req], check_pool=False)
    return dict(stream=streams[0], logits=logits, times=_step_times(steps),
                layout=eng.layout, kv_bytes=_kv_bytes(eng),
                launches=_launch_counts(counters),
                record=None if mesh is None else mesh.record())


def _seq_rank(rank: int, spec: dict, init_file: str) -> dict:
    """Phase 18's process, spawned by the launcher's ``serve_mesh``: join
    the mesh, then for each case build this rank's tree layer by layer
    (a MoE's experts cut over 'data': ``expert_shards``), serve the
    case's request on one slot (the sequence-parallel layout), count the
    ``_Infos`` gathers (the EP path's host read), free. Decode logits
    come back as digests."""
    import torch
    from repro_torch.distribution import moe_ep
    from repro_torch.kernels.sasp_gemm import fused_ffn, gemm
    from repro_torch.launch import serve as launch
    counters = {"sasp_gemm": gemm, "sasp_fused_ffn": fused_ffn}
    mesh = launch.join_mesh(rank, spec, init_file, backend=spec["backend"])
    dev = mesh.device
    out = dict(rank=rank, data_rank=mesh.data_rank,
               model_rank=mesh.model_rank, transport=mesh.transport,
               cases={}, streams={})
    for case in spec["cases"]:
        cfg0 = seq_case_config(case)
        ep = launch.expert_shards(cfg0, spec["mesh"], scheduler=False)
        params, _, lcfg = _seq_build(torch, cfg0, spec["mesh"][1],
                                     mesh.model_rank, mesh.data_rank, ep,
                                     dev)
        infos = {"n": 0}
        base = moe_ep._Infos

        class Counted(base):
            def __init__(self, *a, **k):
                infos["n"] += 1
                super().__init__(*a, **k)
        moe_ep._Infos = Counted
        try:
            run = _seq_serve(torch, params, lcfg, counters, case, mesh=mesh)
        finally:
            moe_ep._Infos = base
        run.update(infos=infos["n"], expert_bytes=_expert_bytes(params),
                   logits=[_digest(x) for x in run["logits"]], ep=ep)
        out["streams"][case] = run.pop("stream")
        out["cases"][case] = run
        del params
        _free(torch)
    return out


def _seq_oracles(torch, counters):
    """On this card, each case's meshless twin (the whole tree at the
    mesh's TP, ``Engine(data_shards=D, seq_split=True)``: every ring
    whole, every block run in turn) and, for (a), the one-card engine
    (rings whole, the plain softmax)."""
    out = {}
    for case in ("a", "b", "c"):
        (dp, tp), = [m for m, cs in SEQ_MESHES.items() if case in cs]
        cfg0 = seq_case_config(case)
        tree, tcfg, _ = _seq_build(torch, cfg0, tp, None, 0, 1, DEVICE)
        cfg = dataclasses.replace(tcfg, ep_shards=dp) if cfg0.moe else tcfg
        res = dict(twin=_seq_serve(torch, tree, cfg, counters, case,
                                   data_shards=dp, seq_split=True),
                   expert_bytes=_expert_bytes(tree))
        if case == "a":
            res["one"] = _seq_serve(torch, tree, tcfg, counters, case)
        out[case] = res
        del tree
        _free(torch)
    return out


def _seq_check(case, mesh, res, oracle):
    """Every process of a case: the sequence-parallel layout; streams and
    every decode step's logits bit for bit the twin's; each rank's KV
    (and, (b), expert) bytes the whole model's over the cut; three
    collectives an attention layer a decode step over the cut's axes (and
    (b)'s one ordered sum a MoE layer a call); no ``_Infos`` gather; the
    case's kernels on their tensor-core variants."""
    twin = oracle["twin"]
    D, T = mesh
    cfg0 = seq_case_config(case)
    attn = cfg0.num_layers
    n = D * T if case == "c" else D
    axis = "data,model" if case == "c" else "data"
    for r in res:
        tag = f"(18{case}) --mesh {D},{T} rank {r['rank']}"
        got = r["cases"][case]
        check(got["layout"] == "sequence split over data",
              f"{tag}: layout {got['layout']}")
        check(r["streams"][case] == twin["stream"],
              f"{tag}: stream differs from the meshless twin's")
        check(got["logits"] == [_digest(x) for x in twin["logits"]],
              f"{tag}: decode logits are not bit for bit the twin's")
        check(got["kv_bytes"] * n == twin["kv_bytes"],
              f"{tag}: {got['kv_bytes']} KV bytes, the whole rings' "
              f"{twin['kv_bytes']} over {n}")
        steps = len(got["logits"])
        rec = got["record"]
        moe = 1 if cfg0.moe else 0
        ar = rec.get("all-reduce", {}).get(axis, {}).get("calls", 0)
        ag = rec.get("all-gather", {}).get(axis, {}).get("calls", 0)
        check(ar == attn * steps and ag == 2 * attn * steps
              + moe * (steps + 1),
              f"{tag}: {ar} all-reduces and {ag} all-gathers over {axis} "
              f"in {steps} decode steps of {attn} attention layers")
        check(got["infos"] == 0, f"{tag}: {got['infos']} _Infos gathers")
        if cfg0.moe:
            check(got["expert_bytes"] * D == oracle["expert_bytes"],
                  f"{tag}: expert bytes {got['expert_bytes']}, the whole "
                  f"stacks' {oracle['expert_bytes']} over {D}")
        for k in MAIN_PATH:
            lk = got["launches"][k]
            if k in SEQ_KERNELS[case]:
                check(lk["total"] > 0 and set(lk["variant"]) == {
                    SEQ_KERNELS[case][k]}, f"{tag}: {k} launched {lk}")
            else:
                check(lk["total"] == 0, f"{tag}: {k} launched {lk}")


def _seq_share(twin, one) -> float:
    """The largest |twin - one card| of a decode step's logits, as a share
    of that step's logit scale (max |one card|), over the steps both runs
    take from the same tokens (up to the step that samples their first
    differing token, where the streams part)."""
    first = next((i for i, (a, b) in enumerate(zip(twin["stream"],
                                                   one["stream"]))
                  if a != b), len(one["stream"]))
    pairs = list(zip(twin["logits"], one["logits"]))[:max(first, 0)]
    return max((float((a - b).abs().max()) / float(b.abs().max())
                for a, b in pairs), default=0.0)


def _seq_one_card(torch, counters):
    """(a)-(c) on this card over gloo, host-staged, one spawn a mesh
    shape, against the twins run first."""
    from repro_torch.launch import serve as launch
    t0 = time.time()
    oracles = _seq_oracles(torch, counters)
    out = {"oracle_s": time.time() - t0, "cases": {},
           "launches": dict.fromkeys(MAIN_PATH, 0)}
    a = oracles["a"]
    share = _seq_share(a["twin"], a["one"])
    agree = a["twin"]["stream"] == a["one"]["stream"]
    check(share <= SEQP["logit_share"],
          f"(18a) the twin's logits differ from the one-card engine's by "
          f"{share:.3g} of the logit scale (bound {SEQP['logit_share']})")
    out["a_vs_one_card"] = dict(share=share, streams_equal=agree)
    _free(torch)
    for mesh, cases in SEQ_MESHES.items():
        t0 = time.time()
        spec = dict(mesh=mesh, device=DEVICE, backend="gloo",
                    cases=list(cases))
        res = launch.serve_mesh(spec, _seq_rank, store_dir=OUT_DIR,
                                timeout=600)
        wall = time.time() - t0
        for case in cases:
            _seq_check(case, mesh, res, oracles[case])
            c = [r["cases"][case] for r in res]
            tw = oracles[case]["twin"]
            line = (f"  (18{case}) --mesh {mesh[0]},{mesh[1]} over "
                    f"{res[0]['transport']}: decode ms/step by rank "
                    f"{[round(x['times']['decode_ms_per_step'], 2) for x in c]}"
                    f" (the twin {tw['times']['decode_ms_per_step']:.2f}"
                    + (f", one card {a['one']['times']['decode_ms_per_step']:.2f}"
                       if case == "a" else "")
                    + f"), prefill {c[0]['times']['prefill_ms']:.1f} ms; KV "
                    f"MiB a rank {c[0]['kv_bytes'] / 2**20:.2f} (whole "
                    f"{tw['kv_bytes'] / 2**20:.2f}); "
                    + (f"experts in {c[0]['ep']} shards, expert MiB a rank "
                       f"{c[0]['expert_bytes'] / 2**20:.1f} (whole "
                       f"{oracles[case]['expert_bytes'] / 2**20:.1f}), "
                       f"_Infos gathers {c[0]['infos']}; "
                       if c[0]["ep"] > 1 else "")
                    + f"record {c[0]['record']}; launches "
                    f"{ {k: l['variant'] for k, l in c[0]['launches'].items() if l['total']} }"
                    f"; bit for bit the twin ({wall:.1f} s wall)")
            if case == "a":
                line += (f"; the twin against one card: logits within "
                         f"{share:.3g} of the logit scale, streams "
                         f"{'equal' if agree else 'differ'}")
            log(line)
            out["cases"][f"{case} {mesh}"] = dict(
                wall_s=wall, twin={k: v for k, v in tw.items()
                                   if k != "logits"},
                ranks=[{k: v for k, v in x.items() if k != "logits"}
                       for x in c])
            for k in MAIN_PATH:
                out["launches"][k] += sum(x["launches"][k]["total"]
                                          for x in c)
    return out


# the four-card runs of ``tools/seq_mesh_phase.py`` (not in the smoke):
# gemma3-4b at full depth with the long_500k ring, and jamba's block
SEQ4 = dict(cache_len=524288, prompt=4096, steps=32, meshes=((4, 1), (2, 2)))


def seq4_config(model: str):
    """gemma3-4b at full depth (34 layers), bf16 compute; or jamba-1.5-
    large's 8-layer block at full width with bf16 weights (the dry run's
    cells' type: with fp32 masters a 4,1 rank's quarter of the experts,
    38.7 GB, and their bf16 casts per call do not fit beside NCCL's
    buffers)."""
    from repro_torch.configs import get_config
    if model == "gemma":
        return dataclasses.replace(get_config("gemma3-4b"),
                                   compute_dtype="bfloat16")
    return dataclasses.replace(_fm_config("jamba", full=True),
                               param_dtype="bfloat16")


def _seq_fill(torch, caches, cfg, pos: int, cut_of, heads):
    """Every attention ring of ``caches`` (a rank's blocks, or whole) as
    if ``pos`` tokens had been written: slot j holds the latest position
    below ``pos`` that lands on it, with k / v drawn from generators
    seeded by (segment, slot, layer, leaf), each drawn whole and cut to
    this process's block (``cut_of(spec)``: its slots) and heads
    (``heads``: (first, count) of the whole KV heads)."""
    import zlib
    from repro_torch.models import lm
    for si, (pattern, repeat) in enumerate(lm.segment_plan(cfg)):
        for sl, spec in enumerate(pattern):
            c = caches[si][f"slot{sl}"]
            if not hasattr(c, "k"):
                continue
            C = lm.ring_capacity(cfg, spec, SEQ4["cache_len"])
            lo, n = cut_of(spec, C)
            j = torch.arange(C, device=c.pos.device)
            whole = (pos - 1 - (pos - 1 - j) % C).to(torch.int32)
            for r in range(repeat):
                c.pos[r, 0] = whole[lo:lo + n]
                for name in ("k", "v"):
                    g = torch.Generator(device=c.k.device)
                    g.manual_seed(zlib.crc32(f"{si}/{sl}/{r}/{name}".encode()))
                    full = torch.randn((C, cfg.num_kv_heads,
                                        cfg.attn_head_dim), generator=g,
                                       device=c.k.device)
                    getattr(c, name)[r, 0] = full[lo:lo + n, heads[0]:
                                                  heads[0] + heads[1]].to(
                        c.k.dtype)
                    del full


def _seq_full_ring(torch, params, cfg, whole_cfg, mesh=None):
    """One decode step at position ``cache_len - 1`` against rings filled
    to it (``_seq_fill``): (the logits' digest, its ms)."""
    from repro_torch.distribution.context import use_mesh
    from repro_torch.distribution.sharding import ring_cut
    from repro_torch.models import lm
    dev = params["embed"]["emb"].device
    caches = lm.init_caches(params, cfg, 1, SEQ4["cache_len"], device=dev)
    kh = cfg.num_kv_heads
    first = (mesh.model_rank * kh if mesh is not None
             and not cfg.heads_replicated and kh < whole_cfg.num_kv_heads
             else 0)

    def cut_of(spec, C):
        cut = ring_cut(cfg, C)
        if cut is None or not cut.local:
            return 0, C
        return cut.index * cut.block, cut.block
    pos = SEQ4["cache_len"] - 1
    _seq_fill(torch, caches, whole_cfg, pos, cut_of, (first, kh))
    tok = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    p = torch.full((1,), pos, dtype=torch.int32, device=dev)
    _dev_sync(torch, dev)
    t0 = time.perf_counter()
    with use_mesh(mesh), torch.no_grad():
        logits, _ = lm.decode_step(params, cfg, tok, p, caches)
    _dev_sync(torch, dev)
    ms = (time.perf_counter() - t0) * 1e3
    del caches
    return _digest(logits), ms


def _seq_long(torch, params, lcfg, counters, mesh=None, **kw):
    """The long_500k engine: one slot at cache 524288, a 4096-token
    prompt, then ``SEQ4["steps"]`` decode steps timed; GiB held (the
    tree and the rings) and the rings' GiB."""
    from repro_torch.serve.engine import Engine, Request
    dev = params["embed"]["emb"].device
    _free(torch)
    eng = Engine(params, lcfg, batch_slots=1, cache_len=SEQ4["cache_len"],
                 mesh=mesh, **kw)
    held = torch.cuda.memory_allocated(dev) / 2**30
    torch.cuda.reset_peak_memory_stats(dev)
    req = Request(rid=0, prompt=_seq_prompt(lcfg.vocab_size,
                                            SEQ4["prompt"]),
                  max_new_tokens=SEQ4["steps"] + 1)
    reset(counters)
    streams, steps = _drive_timed(torch, eng, [req], check_pool=False)
    out = dict(stream=streams[0], times=_step_times(steps), held_gib=held,
               kv_gib=_kv_bytes(eng) / 2**30, layout=eng.layout,
               peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30,
               launches=_launch_counts(counters))
    # two more decode steps under torch.profiler (every rank, so that the
    # collectives pair up; rank 0's and one card's are logged)
    tok = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    pos = torch.full((1,), SEQ4["prompt"] + SEQ4["steps"] + 1,
                     dtype=torch.int32, device=dev)

    def step():
        with torch.no_grad(), eng._mesh_ctx():
            eng._decode_step(params, eng.cfg, tok, pos)
    step()
    tag = "one_card" if mesh is None else f"rank{mesh.rank}"
    out["profile"] = _profiled(
        torch, step, 2, f"seq4_{tag}",
        quiet=mesh is not None and mesh.rank != 0)
    del eng
    _free(torch)
    return out


def _seq4_rank(rank: int, spec: dict, init_file: str) -> dict:
    """A process of the four-card runs: gemma3-4b at full depth, the
    long_500k engine and one full-ring step; or jamba's block with one
    slot (GiB held, a short request served)."""
    import torch
    from repro_torch.kernels.sasp_gemm import fused_ffn, gemm
    from repro_torch.launch import serve as launch
    counters = {"sasp_gemm": gemm, "sasp_fused_ffn": fused_ffn}
    mesh = launch.join_mesh(rank, spec, init_file, backend=spec["backend"])
    dev = mesh.device
    D, T = spec["mesh"]
    out = dict(rank=rank, transport=mesh.transport, streams={})
    cfg0 = seq4_config(spec["model"])
    if spec["model"] == "gemma":
        params, tcfg, lcfg = _seq_build(torch, cfg0, T, mesh.model_rank,
                                        mesh.data_rank, 1, dev)
        out["tree_gib"] = _tree_gib(params)
        run = _seq_long(torch, params, lcfg, counters, mesh=mesh)
        out["streams"]["long"] = run.pop("stream")
        out["long"] = run
        from repro_torch.distribution.sharding import seq_config
        scfg = seq_config(lcfg, mesh, 1, SEQ4["cache_len"])
        out["full_ring"] = _seq_full_ring(torch, params, scfg, tcfg, mesh)
    else:
        ep = launch.expert_shards(cfg0, spec["mesh"], scheduler=False)
        params, _, lcfg = _seq_build(torch, cfg0, T, mesh.model_rank,
                                     mesh.data_rank, ep, dev)
        out["tree_gib"] = _tree_gib(params)
        out["expert_gib"] = _expert_bytes(params) / 2**30
        from repro_torch.serve.engine import Engine, Request
        eng = Engine(params, lcfg, batch_slots=1, cache_len=256, mesh=mesh)
        out["held_gib"] = torch.cuda.memory_allocated(dev) / 2**30
        out["layout"] = eng.layout
        (done,) = eng.run([Request(rid=0, prompt=_seq_prompt(
            lcfg.vocab_size, 64), max_new_tokens=4)])
        out["streams"]["jamba"] = [int(t) for t in done.out_tokens]
        out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    return out


def _seq_four_cards(torch, counters):
    """The four-card runs over NCCL, a card a process: gemma3-4b at full
    depth (34 layers) with one slot at cache 524288 (the long_500k ring,
    10.12 GiB of bf16 KV on one card) meshless on this card, then on
    ``--mesh 4,1`` and ``2,2``: GiB held a rank, the rings' GiB, decode
    ms/step over 32 steps after a 4096-token prompt, and one decode step
    at position 524287 against rings filled by seeded draws, each rank
    bit for bit its meshless twin's step on this card; then jamba-1.5-
    large's block at full width on ``--mesh 4,1`` with one slot (experts
    cut four ways): GiB held a rank."""
    from repro_torch.distribution.sharding import seq_config
    from repro_torch.launch import serve as launch
    n = torch.cuda.device_count()
    if n < 4:
        log(f"  four cards: not run ({n} card{'s' if n > 1 else ''})")
        return f"not run ({n} card{'s' if n > 1 else ''})"
    out = {}
    cfg0 = seq4_config("gemma")
    twins = {}
    for tp in sorted({T for _, T in SEQ4["meshes"]}):
        tree, tcfg, _ = _seq_build(torch, cfg0, tp, None, 0, 1, DEVICE)
        if tp == 1:
            one = _seq_long(torch, tree, tcfg, counters)
            out["one card"] = {k: v for k, v in one.items() if k != "stream"}
            log(f"  gemma3-4b, {cfg0.num_layers} layers, one card: held "
                f"{one['held_gib']:.2f} GiB (rings {one['kv_gib']:.2f}), "
                f"peak {one['peak_gib']:.2f}; decode "
                f"{one['times']['decode_ms_per_step']:.2f} ms/step, "
                f"prefill {one['times']['prefill_ms']:.1f} ms")
        for D, T in SEQ4["meshes"]:
            if T == tp:
                twins[D, T] = _seq_full_ring(
                    torch, tree, seq_config(tcfg, {"data": D, "model": T},
                                            1, SEQ4["cache_len"]), tcfg)
        del tree
        _free(torch)
    for D, T in SEQ4["meshes"]:
        t0 = time.time()
        spec = dict(mesh=(D, T), device=DEVICE, backend="nccl",
                    model="gemma")
        res = launch.serve_mesh(spec, _seq4_rank, store_dir=OUT_DIR,
                                timeout=1200)
        key = f"--mesh {D},{T}"
        for r in res:
            check(r["full_ring"][0] == twins[D, T][0],
                  f"(four cards) {key} rank {r['rank']}: the full-ring "
                  f"step is not bit for bit the twin's")
            check(r["long"]["layout"] == "sequence split over data",
                  f"(four cards) {key}: layout {r['long']['layout']}")
        c = [r["long"] for r in res]
        log(f"  gemma3-4b, {cfg0.num_layers} layers, {key} over "
            f"{res[0]['transport']}: "
            f"held GiB a rank {[round(x['held_gib'], 2) for x in c]} "
            f"(rings {[round(x['kv_gib'], 3) for x in c]}), peak "
            f"{[round(x['peak_gib'], 2) for x in c]}; decode ms/step "
            f"{[round(x['times']['decode_ms_per_step'], 2) for x in c]}, "
            f"prefill {c[0]['times']['prefill_ms']:.1f} ms; the full-ring "
            f"step {[round(r['full_ring'][1], 2) for r in res]} ms, bit "
            f"for bit the twin ({twins[D, T][1]:.2f} ms on one card); "
            f"{time.time() - t0:.1f} s")
        out[key] = dict(ranks=[dict(r["long"], tree_gib=r["tree_gib"],
                                    full_ring_ms=r["full_ring"][1])
                               for r in res], twin_ms=twins[D, T][1])
    t0 = time.time()
    res = launch.serve_mesh(dict(mesh=(4, 1), device=DEVICE,
                                 backend="nccl", model="jamba"),
                            _seq4_rank, store_dir=OUT_DIR, timeout=1200)
    log(f"  jamba-1.5-large block, --mesh 4,1, one slot "
        f"({res[0]['layout'] if 'layout' in res[0] else ''}): held GiB a "
        f"rank {[round(r['held_gib'], 2) for r in res]} (experts "
        f"{[round(r['expert_gib'], 2) for r in res]}), peak "
        f"{[round(r['peak_gib'], 2) for r in res]}; {time.time() - t0:.1f}"
        f" s")
    out["jamba --mesh 4,1"] = [{k: v for k, v in r.items()
                                if k != "streams"} for r in res]
    return out


def seq_mesh_phase(torch, counters):
    """Phase 18: the reference's long-context layout on a mesh, (a)-(c)
    on this card. Run last, with every earlier model freed."""
    t_phase = time.time()
    log(f"  one slot; (a) gemma3-4b at full width, {SEQP['layers']} layers, "
        f"cache {SEQP['cases']['a'][1]}, a {SEQP['cases']['a'][0]}-token "
        f"prompt; (b) moonshot at full width, 1 layer; (c) gemma3 at d "
        f"512 with one KV head; seed 0, wo and w2 spread, 50% of the 32x32 "
        f"tiles (scope all), bf16 compute; {SEQP['new']} new tokens")
    out = _seq_one_card(torch, counters)
    out["seconds"] = time.time() - t_phase
    log(f"  phase 18: {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 19: the paged KV pool cut over 'data', and a MoE drafter on a mesh
# ---------------------------------------------------------------------------

PGM = dict(layers=1, slots=4, cache_len=256, page_len=32, kv_pages=30,
           draft=0.75, draft_k=3, mesh=(2, 1), logit_tol=1e-2)
# the main-path kernels each model launches (target and drafter packed,
# scope all; moonshot's FFNs are experts, masked-dense)
PGM_KERNELS = {"qwen": {"sasp_gemm": "mma", "sasp_fused_ffn": "mma/mma"},
               "moonshot": {"sasp_gemm": "mma"}}
PGM_SPEC = ("spec_rounds", "spec_draft_tokens", "spec_accepted_tokens",
            "spec_fallbacks")


def pgm_config(model: str):
    """qwen3-32b at full width, ``PGM["layers"]`` layers, or moonshot-v1-
    16b-a3b at full width, 1 layer; bf16 compute."""
    if model == "qwen":
        return main_config(PGM["layers"], "bfloat16")
    return moonshot_config(1, "bfloat16")


def _pgm_build(torch, cfg0, rank, data_rank, ep, device):
    """``build_rank_params`` at tp 1 with a drafter: 50% of the 32x32
    tiles (scope all), packed, wo and w2 spread as drawn; the drafter at
    75%, its experts (moonshot) cut like the target's: (tree, deployed
    config, rank config, drafter)."""
    from repro_torch.launch import serve as launch
    return launch.build_rank_params(
        cfg0, tp=1, rank=rank, device=device, sparsity=SPARSITY,
        scope="all", path="packed", prepare=spread_leaf(cfg0), ep=ep,
        data_rank=data_rank, draft_sparsity=PGM["draft"])


def _pgm_serve(torch, params, cfg, draft, counters, mesh=None, **kw):
    """3c (b)'s first 4 requests (a 96-token prefix of 3 pages and a
    suffix each, 16 new tokens) through ``Engine`` of 4 slots, cache 256,
    32-token pages, ``kv_pages`` 30 (P = 32), prefix sharing and the
    drafter (``draft_k`` 3), on ``mesh`` or as the meshless twin
    (``kw``); submitted one a step, so that each data rank's second
    request maps the prefix pages its first wrote. Every step timed with
    the device synchronised, the pools checked after each; every target
    decode step's fp32 logits kept; launch counts and the mesh's record
    set to 0 just before the run and read just after."""
    from repro_torch.serve.engine import Engine
    eng = Engine(params, cfg, batch_slots=PGM["slots"],
                 cache_len=PGM["cache_len"], kv_pages=PGM["kv_pages"],
                 kv_page_len=PGM["page_len"], kv_share=True, draft=draft,
                 draft_k=PGM["draft_k"], mesh=mesh, **kw)
    logits = []
    dec = eng._paged_decode_step

    def recorded(p, c, toks, pos, bt, tabs=None):
        x = dec(p, c, toks, pos, bt, tabs)
        if p is eng.params:                     # not the drafter's steps
            logits.append(_live_rows(eng, x, bt).cpu())
        return x
    eng._paged_decode_step = recorded
    reqs = shared_prefix_requests(cfg.vocab_size)[:PGM["slots"]]
    pending, steps = list(reqs), []
    reset(counters)
    if mesh is not None:
        mesh.reset_record()
    while pending or eng.has_work():
        if pending:
            eng.submit(pending.pop(0))
        adm = eng.stats["admitted"]
        toks = sum(len(r.out_tokens) for r in reqs)
        torch.cuda.synchronize()
        t = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        steps.append(((time.perf_counter() - t) * 1e3,
                      eng.stats["admitted"] - adm,
                      sum(len(r.out_tokens) for r in reqs) - toks))
        eng.pool.check()
    launches = _launch_counts(counters)
    record = None if mesh is None else mesh.record()
    mem = eng.memory_stats()
    return dict(streams={r.rid: list(r.out_tokens) for r in reqs},
                logits=logits, times=_step_times(steps), layout=eng.layout,
                launches=launches, record=record,
                spec={k: eng.stats[k] for k in PGM_SPEC},
                prefix=dict(hits=mem.prefix_hits,
                            reused=mem.prefix_pages_reused,
                            elsewhere=mem.prefix_pages_elsewhere),
                pool_bytes=eng.pool.nbytes(), pages=PGM["kv_pages"] + 2,
                blocks=eng.pool.blocks, page_errors=_page_errors(eng))


def _live_rows(eng, x, bt):
    """A paged decode step's fp32 logits (a mesh rank's rows, or every
    row) with the rows of slots that decode no token set to 0: idle and
    speculating slots read the trash page, whose content is whichever
    of the step's duplicate writes to it landed last (unspecified on the
    card)."""
    torch = sys.modules["torch"]
    from repro_torch.serve import memory as kvmem
    live = torch.as_tensor((bt != kvmem.TRASH_PAGE).any(axis=1),
                           device=x.device)
    if len(live) > len(x):
        live = live[eng._lo:eng._lo + eng._per]
    return torch.where(live[:, None], x.float(), torch.zeros_like(
        x, dtype=torch.float32))


def _pgm_rank(rank: int, spec: dict, init_file: str) -> dict:
    """Phase 19's process, spawned by the launcher's ``serve_mesh``: join
    the mesh, then for each model build this rank's tree and drafter
    layer by layer (moonshot's experts, the drafter's too, cut over
    'data': ``expert_shards``) and serve (``_pgm_serve``). Decode logits
    come back as digests."""
    import torch
    from repro_torch.kernels.sasp_gemm import fused_ffn, gemm
    from repro_torch.launch import serve as launch
    counters = {"sasp_gemm": gemm, "sasp_fused_ffn": fused_ffn}
    mesh = launch.join_mesh(rank, spec, init_file, backend=spec["backend"])
    out = dict(rank=rank, data_rank=mesh.data_rank,
               transport=mesh.transport, cases={}, streams={})
    for model in spec["cases"]:
        cfg0 = pgm_config(model)
        ep = launch.expert_shards(cfg0, spec["mesh"], scheduler=False)
        params, _, lcfg, draft = _pgm_build(torch, cfg0, mesh.model_rank,
                                            mesh.data_rank, ep, mesh.device)
        run = _pgm_serve(torch, params, lcfg, draft, counters, mesh=mesh)
        run.update(logits=[_digest(x) for x in run["logits"]],
                   draft_ep=draft[1].ep_shards)
        out["streams"][model] = run.pop("streams")
        out["cases"][model] = run
        del params, draft
        _free(torch)
    return out


def _pgm_oracles(torch, counters):
    """On this card, each model's meshless twin (the whole tree and
    drafter, ``Engine(data_shards=2)``: both page blocks in one process,
    each data rank's rows in lock step), the bytes of a whole pool (the
    replicated layout's, every rank's there), and its first prefill
    through both kernels against their plain versions."""
    from repro_torch.serve import memory as kvmem
    D = PGM["mesh"][0]
    out = {}
    for model in PGM_KERNELS:
        cfg0 = pgm_config(model)
        ep = D if cfg0.moe else 1
        tree, tcfg, _, draft = _pgm_build(torch, cfg0, None, 0, ep, DEVICE)
        twin = _pgm_serve(torch, tree, tcfg, draft, counters, data_shards=D)
        whole = kvmem.PagedKVPool(tree, tcfg, cache_len=PGM["cache_len"],
                                  device_pages=PGM["kv_pages"],
                                  page_len=PGM["page_len"]).nbytes()
        vs = _prefill_vs_plain(torch, tree,
                               dataclasses.replace(tcfg, ep_shards=1))
        check(vs["rel_err"] <= PGM["logit_tol"],
              f"(19 {model}) the kernels' prefill logits differ from their "
              f"plain versions' by {vs['rel_err']:.3g} of the logit scale")
        out[model] = dict(twin=twin, whole_bytes=whole, vs_plain=vs)
        del tree, draft
        _free(torch)
    return out


def _pgm_check(model, res, oracle):
    """Every process: the cut layout; streams, every decode step's logits
    (its rows), the speculation and prefix counters bit for bit the
    twin's; its pool's bytes its block's (half the whole pool, two local
    reserved pages more on data rank 1); over 'data' no broadcast (no KV
    moved); the model's kernels on their tensor-core variants."""
    from repro_torch.serve.engine import PAGED_LAYOUT
    twin = oracle["twin"]
    D = PGM["mesh"][0]
    per = PGM["slots"] // D
    page = oracle["whole_bytes"] // twin["pages"]
    for r in res:
        d = r["data_rank"]
        tag = f"(19 {model}) --mesh {D},1 rank {r['rank']}"
        got = r["cases"][model]
        check(got["layout"] == PAGED_LAYOUT, f"{tag}: layout {got['layout']}")
        check(r["streams"][model] == twin["streams"],
              f"{tag}: streams differ from the meshless twin's")
        want = [_digest(x[d * per:(d + 1) * per]) for x in twin["logits"]]
        first = next((i for i, (a, b) in enumerate(zip(got["logits"], want))
                      if a != b), None)
        check(got["logits"] == want,
              f"{tag}: decode logits are not bit for bit the twin's rows "
              f"({len(got['logits'])} steps, the twin {len(want)}; first "
              f"differing step {first})")
        check(got["spec"] == twin["spec"] and got["prefix"] ==
              twin["prefix"], f"{tag}: counters {got['spec']} "
              f"{got['prefix']}, the twin's {twin['spec']} "
              f"{twin['prefix']}")
        check(got["spec"]["spec_rounds"] > 0 and got["prefix"]["hits"] >= 2,
              f"{tag}: {got['spec']} {got['prefix']}")
        check(got["pool_bytes"] == oracle["whole_bytes"] // D
              + (2 * page if d else 0),
              f"{tag}: {got['pool_bytes']} pool bytes, not the block's of "
              f"{oracle['whole_bytes']}")
        check("data" not in got["record"].get("broadcast", {}),
              f"{tag}: a broadcast over 'data': {got['record']}")
        for k in MAIN_PATH:
            lk = got["launches"][k]
            if k in PGM_KERNELS[model]:
                check(lk["total"] > 0 and set(lk["variant"]) == {
                    PGM_KERNELS[model][k]}, f"{tag}: {k} launched {lk}")
            else:
                check(lk["total"] == 0, f"{tag}: {k} launched {lk}")


# the four-card runs of ``tools/paged_mesh_phase.py`` (not in the smoke):
# qwen3-32b at 16 layers with an 8 GiB page pool (4094 pages of 32
# tokens, 64 KiB of KV a token) cut over 'data' on 4,1 and 2,2, and
# replicated over 'data' on 4,1 (kv_pages 4093: P = 4095 does not divide)
PGM4 = dict(layers=16, kv_pages=4094, page_len=32, slots=16,
            cache_len=2048, prompt=512, requests=32, new=32,
            meshes=(((4, 1), 4094), ((2, 2), 4094), ((4, 1), 4093)))


def _pgm4_requests(vocab: int):
    """32 requests of 512-token prompts (16 pages each), 32 new tokens."""
    import numpy as np
    from repro_torch.serve.engine import Request
    rng = np.random.default_rng(19)
    return [Request(rid=i, prompt=rng.integers(
        0, vocab, size=(PGM4["prompt"],)).astype(np.int32),
        max_new_tokens=PGM4["new"]) for i in range(PGM4["requests"])]


def _pgm4_build(torch, tp, rank, device):
    from repro_torch.launch import serve as launch
    cfg0 = main_config(PGM4["layers"], "bfloat16")
    params, tcfg, lcfg, _ = launch.build_rank_params(
        cfg0, tp=tp, rank=rank, device=device, sparsity=SPARSITY,
        scope="all", path="packed", prepare=spread_leaf(cfg0))
    return params, tcfg, lcfg


def _pgm4_serve(torch, params, cfg, counters, kv_pages, mesh=None, **kw):
    """The 32 requests through ``Engine`` of 16 slots at cache 2048 with
    ``kv_pages`` pages of 32 tokens: GiB held (tree and pool) and the
    pool's GiB, peak GiB, decode ms/step and tokens/s over the run (every
    step timed with the device synchronised), every target decode step's
    logits digested after the run (this process's rows)."""
    from repro_torch.serve.engine import Engine
    dev = params["embed"]["emb"].device
    _free(torch)
    eng = Engine(params, cfg, batch_slots=PGM4["slots"],
                 cache_len=PGM4["cache_len"], kv_pages=kv_pages,
                 kv_page_len=PGM4["page_len"], mesh=mesh, **kw)
    held = torch.cuda.memory_allocated(dev) / 2**30
    torch.cuda.reset_peak_memory_stats(dev)
    logits = []
    dec = eng._paged_decode_step

    def recorded(p, c, toks, pos, bt, tabs=None):
        x = dec(p, c, toks, pos, bt, tabs)
        logits.append(_live_rows(eng, x, bt))
        return x
    eng._paged_decode_step = recorded
    reset(counters)
    streams, steps = _drive_timed(torch, eng,
                                  _pgm4_requests(cfg.vocab_size),
                                  check_pool=False)
    out = dict(streams=streams, times=_step_times(steps), held_gib=held,
               pool_gib=eng.pool.nbytes() / 2**30, layout=eng.layout,
               peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30,
               launches=_launch_counts(counters), logits=logits)
    del eng
    return out


def _pgm4_rank(rank: int, spec: dict, init_file: str) -> dict:
    """A process of the four-card runs: its tree layer by layer, then the
    32 requests on the mesh; decode logits come back as digests."""
    import torch
    from repro_torch.kernels.sasp_gemm import fused_ffn, gemm
    from repro_torch.launch import serve as launch
    counters = {"sasp_gemm": gemm, "sasp_fused_ffn": fused_ffn}
    mesh = launch.join_mesh(rank, spec, init_file, backend=spec["backend"])
    params, _, lcfg = _pgm4_build(torch, spec["mesh"][1], mesh.model_rank,
                                  mesh.device)
    run = _pgm4_serve(torch, params, lcfg, counters, spec["kv_pages"],
                      mesh=mesh)
    run.update(rank=rank, data_rank=mesh.data_rank,
               transport=mesh.transport, tree_gib=_tree_gib(params),
               logits=[_digest(x) for x in run["logits"]])
    return run


def _pgm_four_cards(torch, counters):
    """The four-card runs over NCCL, a card a process: qwen3-32b at full
    width, 16 layers, 16 slots, an 8 GiB pool (4094 pages of 32 tokens)
    on one card; cut over 'data' on ``--mesh 4,1`` and ``2,2`` (each rank
    2 GiB of pages: a quarter of the pages, or half the pages of half the
    KV heads); replicated over 'data' on ``4,1`` (kv_pages 4093, every
    rank the whole pool and the whole batch). GiB held a rank, the pool's
    GiB, decode ms/step and tokens/s; each cut rank's streams and decode
    logits against its meshless twin's on this card."""
    from repro_torch.launch import serve as launch
    n = torch.cuda.device_count()
    if n < 4:
        log(f"  four cards: not run ({n} card{'s' if n > 1 else ''})")
        return f"not run ({n} card{'s' if n > 1 else ''})"
    out, twins = {}, {}
    for tp in (1, 2):
        tree, tcfg, _ = _pgm4_build(torch, tp, None, DEVICE)
        if tp == 1:
            one = _pgm4_serve(torch, tree, tcfg, counters, PGM4["kv_pages"])
            out["one card"] = {k: v for k, v in one.items()
                               if k not in ("streams", "logits")}
            one_streams = one["streams"]
            log(f"  qwen3-32b, {PGM4['layers']} layers, one card: held "
                f"{one['held_gib']:.2f} GiB (pool {one['pool_gib']:.2f}), "
                f"peak {one['peak_gib']:.2f}; decode "
                f"{one['times']['decode_ms_per_step']:.2f} ms/step, "
                f"{one['times']['tok_s']:.1f} tok/s")
            del one
        for (D, T), kv in PGM4["meshes"]:
            if T == tp and (D, T) not in twins and kv == PGM4["kv_pages"]:
                tw = _pgm4_serve(torch, tree, tcfg, counters, kv,
                                 data_shards=D)
                per = PGM4["slots"] // D
                twins[D, T] = dict(streams=tw["streams"], rows=[
                    [_digest(x[d * per:(d + 1) * per]) for x in tw["logits"]]
                    for d in range(D)])
                del tw
        del tree
        _free(torch)
    for (D, T), kv in PGM4["meshes"]:
        t0 = time.time()
        spec = dict(mesh=(D, T), device=DEVICE, backend="nccl",
                    kv_pages=kv)
        res = launch.serve_mesh(spec, _pgm4_rank, store_dir=OUT_DIR,
                                timeout=1200)
        key = f"--mesh {D},{T} kv_pages {kv}"
        tw = twins.get((D, T)) if kv == PGM4["kv_pages"] else None
        bits = None if tw is None else [
            r["streams"] == tw["streams"] and r["logits"] ==
            tw["rows"][r["data_rank"]] for r in res]
        log(f"  {key} over {res[0]['transport']} ({res[0]['layout']}): "
            f"held GiB a rank {[round(r['held_gib'], 2) for r in res]} "
            f"(pool {[round(r['pool_gib'], 3) for r in res]}), peak "
            f"{[round(r['peak_gib'], 2) for r in res]}; decode ms/step "
            f"{[round(r['times']['decode_ms_per_step'], 2) for r in res]}, "
            f"tok/s {res[0]['times']['tok_s']:.1f}; streams "
            f"{'equal' if res[0]['streams'] == one_streams else 'differ'} "
            f"to one card's; bit for bit the twin: {bits}; "
            f"{time.time() - t0:.1f} s")
        out[key] = dict(ranks=[{k: v for k, v in r.items()
                                if k not in ("streams", "logits")}
                               for r in res], twin_bits=bits,
                        streams_equal_one_card=res[0]["streams"]
                        == one_streams)
    return out


def paged_mesh_phase(torch, counters):
    """Phase 19: the paged KV pool cut over 'data' (the reference's
    ``pool_shardings`` placement, ``Engine.layout`` "slots and pages
    split over data") with prefix sharing and a drafter, qwen3-32b and
    moonshot (its experts and its drafter's in EP over 'data') on
    ``--mesh 2,1`` on this card (gloo, host-staged), against the twins
    run first. Run last, with every earlier model freed."""
    from repro_torch.launch import serve as launch
    t_phase = time.time()
    log(f"  qwen3-32b at full width, {PGM['layers']} layer(s), and "
        f"moonshot at full width, 1 layer; seed 0, wo and w2 spread, 50% "
        f"of the 32x32 tiles (scope all), bf16; a drafter at 75%, draft_k "
        f"{PGM['draft_k']}; Engine({PGM['slots']} slots, cache "
        f"{PGM['cache_len']}, kv_pages {PGM['kv_pages']} of "
        f"{PGM['page_len']} tokens, prefix sharing); 3c (b)'s first 4 "
        f"requests, one submitted a step")
    t0 = time.time()
    oracles = _pgm_oracles(torch, counters)
    out = {"oracle_s": time.time() - t0, "cases": {},
           "launches": dict.fromkeys(MAIN_PATH, 0)}
    _free(torch)
    t0 = time.time()
    spec = dict(mesh=PGM["mesh"], device=DEVICE, backend="gloo",
                cases=list(PGM_KERNELS))
    res = launch.serve_mesh(spec, _pgm_rank, store_dir=OUT_DIR, timeout=600)
    wall = time.time() - t0
    for model in PGM_KERNELS:
        _pgm_check(model, res, oracles[model])
        c = [r["cases"][model] for r in res]
        tw, o = oracles[model]["twin"], oracles[model]
        log(f"  (19 {model}) --mesh 2,1 over {res[0]['transport']}: decode "
            f"ms/step by rank "
            f"{[round(x['times']['decode_ms_per_step'], 2) for x in c]} "
            f"(the twin {tw['times']['decode_ms_per_step']:.2f}), tok/s "
            f"{c[0]['times']['tok_s']:.1f} (twin {tw['times']['tok_s']:.1f})"
            f"; pool MiB a rank "
            f"{[round(x['pool_bytes'] / 2**20, 3) for x in c]} of a whole "
            f"{o['whole_bytes'] / 2**20:.3f}; spec {c[0]['spec']}; prefix "
            f"{c[0]['prefix']}; record {c[0]['record']}; launches "
            f"{ {k: l['total'] for k, l in c[0]['launches'].items()} }; "
            f"kernels vs plain {o['vs_plain']['rel_err']:.3g} of the logit "
            f"scale; bit for bit the twin ({wall:.1f} s wall)")
        out["cases"][model] = dict(
            twin={k: v for k, v in tw.items() if k != "logits"},
            whole_bytes=o["whole_bytes"], vs_plain=o["vs_plain"],
            ranks=[{k: v for k, v in x.items() if k != "logits"}
                   for x in c])
        for k in MAIN_PATH:
            out["launches"][k] += sum(x["launches"][k]["total"] for x in c)
    out["wall_s"] = wall
    out["seconds"] = time.time() - t_phase
    log(f"  phase 19: {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 20: the port's static analyzer, the packed containers and the
# page pools
# ---------------------------------------------------------------------------

BASELINE = os.path.join(ROOT, "tools", "analyze_torch", "baseline.json")


def analyze_containers(torch, params):
    """Phase 20's container check, run on phase 3's tree while it is
    held: ``validate_params_tree`` on the card. Returns the errors, the
    containers checked and the seconds."""
    from tools.analyze_torch import packed
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    errors = packed.validate_params_tree(params)
    torch.cuda.synchronize()
    out = dict(errors=errors, seconds=time.perf_counter() - t0,
               containers=len(list(packed.packed_leaves(params))))
    log(f"  (20) validate_params_tree over phase 3's containers: "
        f"{out['containers']} containers, {len(errors)} errors, "
        f"{out['seconds']:.2f} s")
    return out


def analyze_phase(torch, containers, paged, paged_mesh):
    """Phase 20: every pass of ``tools/analyze_torch`` (the packed pass
    on this card) against its baseline, with the container check made
    after phase 3 and the page checks made in phases 3c and 19."""
    import collections

    from tools.analyze_torch import load_baseline, run_all
    t0 = time.perf_counter()
    findings = run_all(device=DEVICE)
    torch.cuda.synchronize()
    passes_s = time.perf_counter() - t0
    baseline = set(load_baseline(BASELINE))
    fresh = [f for f in findings if f.key() not in baseline]
    by_rule = dict(sorted(collections.Counter(
        f.rule for f in findings).items()))
    pages = {f"3c ({k})": v["page_errors"] for k, v in paged.items()
             if isinstance(v, dict) and "page_errors" in v}
    for model, case in paged_mesh["cases"].items():
        pages[f"19 {model} twin"] = case["twin"]["page_errors"]
        for i, r in enumerate(case["ranks"]):
            pages[f"19 {model} rank {i}"] = r["page_errors"]
    blocks = sum(case["twin"]["blocks"] + sum(r["blocks"]
                                              for r in case["ranks"])
                 for case in paged_mesh["cases"].values())
    out = dict(seconds=passes_s + containers["seconds"], passes_s=passes_s,
               containers_s=containers["seconds"],
               containers=containers["containers"],
               container_errors=len(containers["errors"]),
               findings=len(findings), baselined=len(findings) - len(fresh),
               new=len(fresh), by_rule=by_rule, pools=len(pages),
               blocks=blocks,
               page_errors=sum(len(e) for e in pages.values()))
    for f in fresh:
        log(f"  (20) NEW {f.render()}")
    log("  phase 20: " + json.dumps(out))
    check(not fresh, f"(20) {len(fresh)} finding(s) outside "
          f"tools/analyze_torch/baseline.json")
    check(not containers["errors"], f"(20) phase 3's containers: "
          f"{containers['errors'][:3]}")
    check(all(f"3c ({k})" in pages for k in "abcd"),
          f"(20) phase 3c recorded page checks for {sorted(pages)}")
    check(all(not e for e in pages.values()),
          f"(20) page errors: { {k: v[:2] for k, v in pages.items() if v} }")
    return out


KERNELS = {
    "sasp_gemm": ("src/repro_torch/kernels/csrc/sasp_gemm.cu",
                  "src/repro/kernels/sasp_gemm/kernel.py:142"),
    "sasp_fused_ffn": ("src/repro_torch/kernels/csrc/fused_ffn.cu",
                       "src/repro/kernels/sasp_gemm/kernel.py:254"),
    "sasp_gemm_masked": ("src/repro_torch/kernels/csrc/sasp_gemm_masked.cu",
                         "src/repro/kernels/sasp_gemm/kernel.py:346"),
    "int8_gemm": ("src/repro_torch/kernels/csrc/int8_gemm.cu",
                  "src/repro/kernels/int8_gemm/kernel.py:39"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attn.cu",
                        "src/repro/kernels/flash_attn/kernel.py:66"),
}
MAIN_PATH = ("sasp_gemm", "sasp_fused_ffn")


def kernels_line(res, launches):
    """One entry per kernel, read at its most frequent launch on its path:
    a decode step (4 rows, bf16) for the GEMMs (at wq's shape) and the
    fused FFN; the 42-row causal prefill group (bf16) for flash
    attention. ``launches`` are counted on each kernel's path."""
    def pick(name):
        if name == "flash_attention":
            return next(r for r in res[name] if r["x"] == "bfloat16"
                        and r["Sq"] == r["Sk"] == 42)
        return next(r for r in res[name] if r["variant"] == "fp"
                    and r["x"] == "bfloat16" and r["M"] == 4
                    and r.get("proj") in (None, "wq"))
    out = []
    for name, (src, repl) in KERNELS.items():
        r = pick(name)
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": repl, "launches": launches[name],
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
    from repro_torch.kernels.flash_attn import kernel as flash
    from repro_torch.kernels.int8_gemm import gemm as int8
    from repro_torch.kernels.sasp_gemm import fused_ffn, gemm, masked
    counters = {"sasp_gemm": gemm, "sasp_fused_ffn": fused_ffn,
                "sasp_gemm_masked": masked, "int8_gemm": int8,
                "flash_attention": flash}

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
        f"the output scale with fp32 activations, 1e-2 with bf16; for "
        f"attention the scale of each output row)")
    res = {"sasp_gemm": gemm_checks(torch, timer, rows),
           "sasp_fused_ffn": ffn_checks(torch, timer, rows),
           "sasp_gemm_masked": masked_checks(torch, timer, rows),
           "int8_gemm": int8_checks(torch, timer, rows),
           "flash_attention": flash_checks(torch, timer)}
    del timer
    torch.cuda.empty_cache()

    log("[3] serve: packed qwen3-32b, bf16, 4 layers")
    params, cfg, launches, e2e = serve_phase(torch, counters)
    containers = analyze_containers(torch, params)

    log("[4] profile: the prefill step and 3 decode steps under "
        "torch.profiler")
    prof = profile_phase(torch, params, cfg)

    log("[3c] paged KV: (a) paged only, (b) prefix sharing with spill and "
        "preemption, (c) (b) with an int8 self-speculation drafter, (d) "
        "(b) with the target's own weights as the drafter")
    paged = paged_phase(torch, params, cfg, counters)

    log("[3d] scheduler / frontend: (a) 2-rank QoS scheduler (EDF, aging, "
        "preemption), traced and untraced, and the drain baseline; (b) a "
        "rank fault with requeue, then revive; (c) 2 in-process hosts with "
        "paged sharing pools, chaos kill:0@4; (d) 2 host_worker processes, "
        "kill -9")
    sched = sched_phase(torch, params, cfg, counters)

    log("[5] parity: packed and kernel vs masked, fp32")
    parity, layer0 = parity_phase(torch, params)

    log("[9a] tp: the shard loop at tp 2, 4 and 8 on one card, on phase 3's "
        "model")
    tp, tp_a2 = tp_shard_loop(torch, params, cfg, counters)
    del params
    torch.cuda.empty_cache()

    log("[3b] the kernel, bsr and masked int8 paths, bf16 (after [5], when "
        "the packed model is freed)")
    paths, qw = paths_phase(torch, counters)

    log("[5b] ablation path: masked_matmul, int8_matmul and mha on layer 0")
    ablation = ablation_phase(torch, layer0, qw, counters)
    del layer0, qw
    torch.cuda.empty_cache()

    log("[6] int8 weights, 1 layer")
    int8_res = int8_phase(torch, counters)

    log("[7] train: qwen3-32b at full width under the SASP overlay; "
        "checkpoint, resume and serve the checkpoint; card vs CPU")
    train = train_phase(torch, counters)

    log("[8] families: (a) moonshot-v1-16b-a3b packed at full width, (b) "
        "mamba2-780m whole, (c) jamba's hybrid super-block, (d) MoE and "
        "hybrid train steps, card vs CPU")
    families = families_phase(torch, counters)

    log("[9b] tp: --mesh 1,2, two spawned ranks (last, every earlier model "
        "freed)")
    t0 = time.time()
    tp["b"] = _tp_mesh(torch, N_LAYERS, tp_a2)
    tp["seconds"] = tp["seconds_a"] + time.time() - t0
    log(f"  phase 9: {tp['seconds']:.1f} s")

    log(f"[10] depth: qwen3-32b at all {DEPTH['layers']} layers, one card, "
        f"the shard loop and --mesh 1,{DEPTH['tp']}, a checkpoint restored "
        f"on the mesh, streaming and tracing (last, every earlier model "
        f"freed)")
    _free(torch)
    depth = depth_phase(torch, counters)

    log("[11] dp: --mesh 2,1 and 2,2 with the scheduler and --mesh 2,2 "
        "with one engine on this card; --mesh 2,2 --scheduler at all 64 "
        "layers over NCCL where there are four cards (last, every earlier "
        "model freed)")
    _free(torch)
    dp = dp_phase(torch)

    log("[12] mesh paths: --mesh 1,2 on this card with --sasp 0, masked, "
        "masked int8, bsr, kernel, packed and packed with fp / int8 "
        "drafters; the dense rs+int8-ag FFN; --mesh 1,4 --sasp 0 and "
        "packed at all 64 layers over NCCL where there are four cards "
        "(last, every earlier model freed)")
    _free(torch)
    mesh_paths = mesh_paths_phase(torch, counters)

    log("[13] families on a mesh: moonshot at full width on --mesh 2,1, "
        "1,2, 2,2 and 2,2 --scheduler, mamba2-780m whole on --mesh 1,2, "
        "jamba's super-block on --mesh 2,2, each bit for bit its meshless "
        "loop; jamba at full width on --mesh 2,2 and moonshot at 48 layers "
        "on --mesh 4,1 over NCCL where there are four cards (last, every "
        "earlier model freed)")
    _free(torch)
    family_mesh = family_mesh_phase(torch, counters)

    log("[14] train on a mesh: qwen3-32b at full width on --mesh 1,2 "
        "against its meshless loop; a narrower qwen3 on --mesh 2,1 and 2,2 "
        "with ZeRO, fp32 and int8 moments; its mesh checkpoint resumed and "
        "served packed through --mesh 1,2 --ckpt-dir; full width, 8 "
        "layers, on 2,2 and 1,4 over NCCL where there are four cards "
        "(last, every earlier model freed)")
    _free(torch)
    train_mesh = train_mesh_phase(torch, counters)

    log("[15] analysis: FlopCounterMode over one full-width layer against "
        "the analytic counters; the H100 roofline of phase 3's decode and "
        "prefill; the dry run of phase 14 (a) on a dry 1,2 mesh against its "
        "measured GiB and collective record; the shard loop at tp 16 with "
        "every KV head on every shard (last, every earlier model freed)")
    _free(torch)
    analysis = analysis_phase(torch, counters, e2e, train_mesh)

    log("[16] train MoE, SSM and hybrid families on a mesh: moonshot-v1-"
        "16b-a3b at full width on --mesh 2,2 (experts in EP over 'data', "
        "their d_ff over 'model') and reduced jamba (2,2) and mamba2 (1,2), "
        "each against its meshless loop; the moonshot checkpoint served "
        "packed on one card; moonshot at 8 layers on 2,2 and 4,1 over NCCL "
        "where there are four cards (last, every earlier model freed)")
    _free(torch)
    family_train = train_family_mesh_phase(torch, counters)

    log("[17] train on a (pod, data, model) mesh: moonshot-v1-16b-a3b at "
        "full width on --mesh 2,2,2 (8 processes; experts in EP inside each "
        "pod) and a narrower qwen3 on 2,2,2 and 2,1,2, each against its "
        "lock-step loop, both pods equal; the qwen3 checkpoint resumed and "
        "served packed on one card; the dry 2,2,2 mesh against the real "
        "ranks; moonshot at 8 layers on 2,2,1 over NCCL where there are "
        "four cards (last, every earlier model freed)")
    _free(torch)
    pod_train = pod_mesh_phase(torch, counters)

    log("[18] the long-context layout on a mesh, one slot: gemma3-4b at "
        "full width (6 layers, cache 32768) on --mesh 2,1, its rings cut "
        "over 'data'; moonshot at full width on --mesh 2,1, its experts "
        "cut over 'data' (the replicated mode); a narrow gemma3 with one "
        "KV head on --mesh 1,2, its rings cut over 'model'; each bit for "
        "bit its meshless twin (last, every earlier model freed)")
    _free(torch)
    seq_mesh = seq_mesh_phase(torch, counters)

    log("[19] the paged KV pool cut over 'data' and a MoE drafter on a "
        "mesh: qwen3-32b and moonshot at full width, 1 layer, on --mesh 2,1 "
        "with prefix sharing and a drafter, each process bit for bit its "
        "meshless twin (last, every earlier model freed)")
    _free(torch)
    paged_mesh = paged_mesh_phase(torch, counters)

    log("[20] analyze: tools/analyze_torch --strict (the packed pass on "
        "this card) against its baseline, phase 3's containers, the page "
        "pools of phases 3c and 19")
    analyze = analyze_phase(torch, containers, paged, paged_mesh)

    # each kernel's launches on its own path: the main path's, phase 3's,
    # phase 12's mesh ranks' (every path, both ranks), phase 13's (every
    # family case, every process) and phase 14's (the mesh-trained
    # checkpoint served, both ranks) and phase 16's (the mesh-trained
    # moonshot checkpoint served on one card) and phase 17's (the
    # pod-trained qwen3 checkpoint served on one card) and phase 18's
    # and phase 19's (every case, every process)
    path_launches = {n: launches[n] + mesh_paths["launches"][n]
                     + family_mesh["launches"][n]
                     + train_mesh["launches"][n]
                     + family_train["launches"][n]
                     + pod_train["launches"][n]
                     + seq_mesh["launches"][n]
                     + paged_mesh["launches"][n]
                     if n in MAIN_PATH else ablation["launches"][n]
                     for n in KERNELS}
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w",
              encoding="utf-8") as fh:
        json.dump(dict(card=card, kernels=res, serve=e2e, launches=launches,
                       profile=prof, paged=paged, scheduler=sched,
                       parity=parity,
                       paths=paths,
                       ablation=ablation, int8=int8_res, train=train,
                       families=families, tp=tp, depth=depth, dp=dp,
                       mesh_paths=mesh_paths, family_mesh=family_mesh,
                       train_mesh=train_mesh, analysis=analysis,
                       family_train=family_train, pod_train=pod_train,
                       seq_mesh=seq_mesh, paged_mesh=paged_mesh,
                       analyze=analyze,
                       seconds=time.time() - t_start), fh, indent=1,
                  default=str)
    log(f"total {time.time() - t_start:.1f} s")
    print(card)
    print(json.dumps(kernels_line(res, path_launches)))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
