"""A cluster-frontend host in its own process: one ShardedScheduler driven
over a newline-JSON protocol (the port's counterpart of the reference's
``frontend_host`` worker, which imports jax).

    python -m repro_torch.serve.host_worker '{"device": "cuda", ...}'

Commands arrive on stdin, one JSON object a line: ``ping``, ``submit``
(``rid``, ``prompt``, ``resume`` = tokens already delivered, ``max_new``,
``temperature``, ``eos``, ``slo``), ``step``, ``cancel`` (``rid``) and
``exit``. Events go to stdout as ``EV {json}`` lines: ``ready``,
``pong``, ``submitted`` (``ok``, ``status``), ``tok`` (``rid``, ``i`` =
the GLOBAL output index, resume prefix included, and ``tok``), ``done``,
``failed`` (``error``), ``stepped`` and ``cancelled``.
:class:`~repro_torch.serve.frontend.SubprocessHost` is the parent side.

The spec (``argv[1]``, a JSON object) picks the model and the scheduler:

* ``arch`` (default ``"qwen3-32b"``); ``reduce`` (default true) shrinks it
  to ``layers`` / ``d_model`` / ``vocab`` (defaults 2 / 64 / 64), and
  with ``reduce`` false ``layers`` only cuts the depth of the full-width
  config;
* ``param_seed`` (0) and ``spread_output_scales`` (false: wo and w2
  times sqrt(2 L)); or ``params_file``, a ``torch.save`` of a params
  tree (tensors only), in place of the seeded init;
* ``sasp`` (0: dense), ``path`` (``"packed"``), ``scope`` (``"all"``),
  ``compute`` (the config's compute type);
* ``device`` (``"cuda"``), ``ranks`` (1), ``slots`` (2), ``cache_len``
  (64) and ``seed`` (the scheduler's rng seed, 0).

:func:`build_model` is the same construction in-process, so a test can
hold a worker's streams to an engine on the same weights.
"""
from __future__ import annotations

import dataclasses
import json
import sys
from typing import Dict

import numpy as np
import torch


def spread_output_scales(params, cfg):
    """Test-only weights: the output projections (attention's wo, the
    SSM's out_proj, the FFN's w2 and every expert's w2) times sqrt(2 L),
    which puts every projection at 0.02. With the reference's init (those
    at 0.02 / sqrt(2 L)) tile L1 separates by scale so sharply that 50%
    global pruning removes every tile of them first, and the kernels
    would run on empty visit lists."""
    f = max(1.0, (2 * cfg.num_layers) ** 0.5)
    for seg in params["segments"]:
        for slot in seg.values():
            mixer = slot["mixer"]
            mixer["wo" if "wo" in mixer else "out_proj"]["w"].mul_(f)
            slot["ffn"]["w2"]["w"].mul_(f)
    return params


def build_model(spec: Dict):
    """(params, cfg) ready for the scheduler, from the spec's model keys."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.serve import build_serving_params
    from repro_torch.models import lm

    cfg = get_config(spec.get("arch", "qwen3-32b"))
    if spec.get("reduce", True):
        cfg = reduced(cfg, layers=spec.get("layers", 2),
                      d_model=spec.get("d_model", 64),
                      vocab=spec.get("vocab", 64))
    elif "layers" in spec:
        cfg = dataclasses.replace(cfg, num_layers=int(spec["layers"]))
    if "compute" in spec:
        cfg = dataclasses.replace(cfg, compute_dtype=spec["compute"])
    device = spec.get("device", "cuda")
    with torch.no_grad():
        if "params_file" in spec:
            params = torch.load(spec["params_file"], map_location=device,
                                weights_only=True)
        else:
            params = lm.init_params(cfg, seed=spec.get("param_seed", 0),
                                    device=device)
        if spec.get("spread_output_scales", False):
            spread_output_scales(params, cfg)
        return build_serving_params(
            params, cfg, path=spec.get("path", "packed"),
            sparsity=float(spec.get("sasp", 0.0)),
            scope=spec.get("scope", "all"), verbose=False)


def main(argv=None) -> int:
    from repro_torch.serve.engine import Request
    from repro_torch.serve.scheduler import SchedulerConfig, ShardedScheduler

    argv = sys.argv[1:] if argv is None else argv
    spec = json.loads(argv[0]) if argv else {}
    params, cfg = build_model(spec)
    sched = ShardedScheduler(
        params, cfg, ranks=spec.get("ranks", 1),
        sched=SchedulerConfig(slots_per_rank=spec.get("slots", 2),
                              cache_len=spec.get("cache_len", 64),
                              rng_seed=spec.get("seed", 0)))

    def ev(**kw):
        print("EV " + json.dumps(kw), flush=True)

    sched.set_on_token(lambda req, tok: ev(
        ev="tok", rid=req.rid, i=len(req.out_tokens) - 1, tok=int(tok)))
    ev(ev="ready")
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        msg = json.loads(line)
        cmd = msg["cmd"]
        if cmd == "ping":
            ev(ev="pong")
        elif cmd == "submit":
            req = Request(
                rid=msg["rid"], prompt=np.asarray(msg["prompt"], np.int32),
                max_new_tokens=msg["max_new"],
                temperature=msg.get("temperature", 0.0),
                eos_id=msg.get("eos"), slo=msg.get("slo", "batch"),
                out_tokens=list(msg.get("resume") or []))
            if req.out_tokens:
                req.mark_resumable()    # exact re-prefill continuation
            ok = sched.submit(req)
            ev(ev="submitted", rid=req.rid, ok=bool(ok), status=req.status)
        elif cmd == "step":
            for r in sched.step():
                ev(ev="done", rid=r.rid)
            for r in sched.drain_failed():
                ev(ev="failed", rid=r.rid, error=r.error or "rank failure")
            ev(ev="stepped")
        elif cmd == "cancel":
            sched.cancel(msg["rid"])
            ev(ev="cancelled", rid=msg["rid"])
        elif cmd == "exit":
            break
    return 0


if __name__ == "__main__":
    sys.exit(main())
