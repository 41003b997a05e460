"""The port's checkpoint manager (``repro_torch.train.checkpoint``), case
for case with the reference's tests/test_checkpoint.py (round trip,
latest and retention, CRC, atomicity, async, shape mismatch, a bit for
bit resume on the CPU), and across the packages: a ``{"params", "opt"}``
tree written by either package's manager (fp32 and bf16 leaves, int8
moments) restores in the other bit for bit, and the port's serve
launcher serves a checkpoint that the reference wrote with greedy packed
streams equal to the reference engine's on the same params."""
import json
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config, reduced  # noqa: E402
from repro.models import lm as r_lm  # noqa: E402
from repro.train import optimizer as r_opt  # noqa: E402
from repro.train.checkpoint import CheckpointManager as RManager  # noqa
from repro.train.checkpoint import _flatten_with_names  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.data.pipeline import (DataConfig, DataState,  # noqa: E402
                                       Pipeline)
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.models import lm as t_lm  # noqa: E402
from repro_torch.train import optimizer as t_opt  # noqa: E402
from repro_torch.train.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.train.checkpoint import named_leaves  # noqa: E402
from repro_torch.train.train_step import make_train_step  # noqa: E402
from torch_parity import KEY, to_np  # noqa: E402


def _state(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "params": {"w": torch.from_numpy(
            rng.normal(size=(8, 8)).astype(np.float32)),
            "b": torch.from_numpy(rng.normal(size=(8,)).astype(
                np.float32)).to(torch.bfloat16)},
        "step": torch.tensor(3, dtype=torch.int32),
    }


def _like(s):
    return {"params": {k: torch.zeros_like(v)
                       for k, v in s["params"].items()},
            "step": torch.zeros_like(s["step"])}


def _equal(a, b):
    la, lb = list(named_leaves(a)), list(named_leaves(b))
    assert [n for n, _ in la] == [n for n, _ in lb]
    for (n, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype, n
        assert torch.equal(x, y), n


def test_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    s = _state()
    mgr.save(10, s, extra={"data_step": 123})
    restored, extra = mgr.restore(_like(s))
    assert extra["data_step"] == 123
    _equal(restored, s)


def test_latest_and_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for step in (1, 2, 3, 4):
        mgr.save(step, _state(step))
    assert mgr.all_steps() == [3, 4]
    assert mgr.latest_step() == 4


def test_crc_detects_corruption(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    s = _state()
    mgr.save(5, s)
    path = os.path.join(str(tmp_path), "step_0000000005", "arrays.0.npz")
    data = dict(np.load(path))
    k = sorted(data)[0]
    data[k] = data[k] + 1
    np.savez(path, **data)
    with pytest.raises(IOError, match="CRC"):
        mgr.restore(_like(s))


def test_atomic_no_partial_checkpoint(tmp_path):
    """tmp dirs never count as checkpoints."""
    mgr = CheckpointManager(str(tmp_path))
    os.makedirs(os.path.join(str(tmp_path), "tmp.99.123"))
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        mgr.restore(_like(_state()))
    mgr.save(1, _state())
    assert mgr.latest_step() == 1


def test_async_save_snapshots_before_returning(tmp_path):
    """The snapshot is taken before save_async returns: an in-place
    update right after it does not reach the file."""
    mgr = CheckpointManager(str(tmp_path))
    s = _state()
    want = {k: v.clone() for k, v in s["params"].items()}
    mgr.save_async(7, s)
    s["params"]["w"].add_(1.0)
    mgr.wait()
    restored, _ = mgr.restore(_like(s))
    assert torch.equal(restored["params"]["w"], want["w"])


def test_shape_mismatch_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _state())
    bad = {"params": {"w": torch.zeros((4, 4)), "b": torch.zeros((8,))},
           "step": torch.zeros((), dtype=torch.int32)}
    with pytest.raises(ValueError, match="shape mismatch"):
        mgr.restore(bad)


def test_restore_resumes_training_bit_for_bit(tmp_path):
    """Train 2 steps, checkpoint, restore, 2 more: equal bit for bit to 4
    uninterrupted steps on the CPU (deterministic data)."""
    cfg = t_reduced(t_get_config("qwen3-32b"), layers=2, d_model=32,
                    vocab=64)
    dcfg = DataConfig(vocab_size=64, seq_len=16, global_batch=2)
    opt_cfg = t_opt.AdamWConfig(lr=1e-3, quantized=True)
    step_fn = make_train_step(cfg, opt_cfg)

    def run(n_steps, start=None):
        if start is None:
            params = t_lm.init_params(cfg, seed=0, device="cpu")
            opt = t_opt.adamw_init(params, opt_cfg)
            pipe = Pipeline(dcfg)
        else:
            params, opt, pipe = start
        for _ in range(n_steps):
            batch = {k: torch.from_numpy(v) for k, v in pipe.next().items()}
            params, opt, _ = step_fn(params, opt, batch)
        return params, opt, pipe

    p_ref, o_ref, _ = run(4)
    p2, o2, pipe2 = run(2)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, {"params": p2, "opt": o2}, extra=pipe2.state.to_dict())
    fresh = t_lm.init_params(cfg, seed=1, device="cpu")
    like = {"params": fresh, "opt": t_opt.adamw_init(fresh, opt_cfg)}
    restored, extra = mgr.restore(like)
    pipe3 = Pipeline(dcfg, state=DataState.from_dict(extra))
    p_res, o_res, _ = run(2, start=(restored["params"], restored["opt"],
                                    pipe3))
    _equal({"params": p_res, "opt": o_res}, {"params": p_ref, "opt": o_ref})


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------


def _ref_tree():
    """A reduced qwen3 ``{"params", "opt"}`` tree of the reference with a
    bf16 leaf, int8 moments and a nonzero step."""
    cfg = reduced(get_config("qwen3-32b"), layers=2, d_model=64, vocab=64)
    params = r_lm.init_params(KEY, cfg)
    params["final_norm"]["scale"] = (
        params["final_norm"]["scale"] * 1.5).astype(jnp.bfloat16)
    rng = np.random.default_rng(3)
    grads = jax.tree.map(
        lambda p: jnp.asarray(rng.normal(size=p.shape), p.dtype), params)
    oc = r_opt.AdamWConfig(quantized=True)
    _, opt = r_opt.adamw_update(grads, r_opt.adamw_init(params, oc),
                                params, oc)
    return {"params": params, "opt": opt}


def _to_port(tree):
    """``_ref_tree`` in the port (its bf16 leaf through an int16 view:
    numpy has no bf16 without ml_dtypes)."""
    sc = tree["params"]["final_norm"]["scale"]
    fp = {**tree, "params": {**tree["params"], "final_norm": {
        "scale": sc.astype(jnp.float32)}}}
    port = bridge.from_numpy(to_np(fp), device="cpu")
    port["params"]["final_norm"]["scale"] = torch.from_numpy(
        np.asarray(sc).view(np.int16).copy()).view(torch.bfloat16)
    return port


def _zeros(tree):
    if isinstance(tree, dict):
        return {k: _zeros(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_zeros(v) for v in tree))
    if isinstance(tree, tuple):
        return tuple(_zeros(v) for v in tree)
    return torch.zeros_like(tree)


def _manifest(d):
    step = max(os.listdir(d))
    with open(os.path.join(d, step, "manifest.json")) as f:
        return json.load(f)


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    tree = _ref_tree()
    RManager(str(tmp_path)).save(9, tree, extra={"data_step": 9})
    restored, extra = CheckpointManager(str(tmp_path)).restore(
        _zeros(_to_port(tree)))
    assert extra == {"data_step": 9}
    want = _flatten_with_names(tree)
    got = list(named_leaves(restored))
    assert [n for n, _ in got] == [n for n, _ in want]
    assert "opt/.m/segments/0/slot0/ffn/w1/w/.scale" in dict(got)
    assert restored["params"]["final_norm"]["scale"].dtype == torch.bfloat16
    for (n, t), (_, a) in zip(got, want):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          a.view(np.int16))
        else:
            assert t.numpy().dtype == a.dtype, n
            np.testing.assert_array_equal(t.numpy(), a)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    tree = _ref_tree()
    CheckpointManager(str(tmp_path)).save(4, _to_port(tree),
                                          extra={"data_step": 4})
    mine = _manifest(str(tmp_path))
    RManager(str(tmp_path / "ref")).save(4, tree, extra={"data_step": 4})
    ref = _manifest(str(tmp_path / "ref"))
    for a, b in zip(mine["leaves"], ref["leaves"]):
        assert {k: a[k] for k in ("name", "key", "shape", "dtype", "crc32")}\
            == {k: b[k] for k in ("name", "key", "shape", "dtype", "crc32")}
    assert len(mine["leaves"]) == len(ref["leaves"])
    restored, extra = RManager(str(tmp_path)).restore(
        jax.eval_shape(lambda: tree))
    assert extra == {"data_step": 4}
    for (n, a), (m, b) in zip(_flatten_with_names(restored),
                              _flatten_with_names(tree)):
        assert n == m and np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_serve_launcher_serves_a_reference_checkpoint(tmp_path, capsys):
    """The launcher's reduced qwen3-32b, every weight times 3 (streams
    that depend on the prompt), written by the reference's manager; the
    port's launcher (packed, 25%, scope all) and the reference engine on
    the same params give equal greedy streams."""
    from repro.launch.serve import build_serving_params
    from repro.serve.engine import Engine, Request

    cfg = reduced(get_config("qwen3-32b"), layers=4, d_model=128,
                  vocab=512)
    params = jax.tree.map(lambda a: a * 3.0, r_lm.init_params(KEY, cfg))
    RManager(str(tmp_path)).save(12, {"params": params})
    t_serve.main(["--ckpt-dir", str(tmp_path), "--sasp", "0.25", "--path",
                  "packed", "--scope", "all", "--requests", "3",
                  "--max-new", "6", "--slots", "2", "--cache-len", "64",
                  "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"restored step 12 from {tmp_path}" in out
    got = {int(m.group(1)): [int(t) for t in m.group(2).split(",")]
           for m in re.finditer(r"req (\d+): prompt\[\d+\] -> \[([^\]]*)\]",
                                out)}
    sp, scfg = build_serving_params(params, cfg, path="packed",
                                    sparsity=0.25, scope="all")
    reqs = t_serve.synthetic_requests(3, cfg.vocab_size, 6)
    done = Engine(sp, scfg, batch_slots=2, cache_len=64).run(
        [Request(rid=r.rid, prompt=r.prompt.copy(), max_new_tokens=6)
         for r in reqs])
    want = {r.rid: [int(t) for t in r.out_tokens] for r in done}
    assert got == want and len(got) == 3
    assert len({tuple(s) for s in got.values()}) > 1
