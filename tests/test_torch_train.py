"""The port's training path (``repro_torch.{data,train}``, ``lm.loss_fn``,
``launch/train.py``) against the reference on the same inputs, in fp32:
the synthetic batches bit for bit, the schedules, the SASP overlay, the
loss (tokens, embeds, overlay) within 1e-5 relative, every gradient leaf
within 1e-4 of its leaf's scale with the pruned tiles' gradients exactly
0, one AdamW update (fp32 and int8 moments), micro-batching and the three
remat modes, a 10-step trajectory within 1e-4 relative, and the launcher
ending in a checkpoint. Models: the reduced qwen3-32b of
``torch_parity.model`` and the reduced paper-espnet2-mt of the
reference's tests/test_system.py."""
import copy
import dataclasses
import os
import signal

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:                      # the fixed twins below still run
    HAVE_HYPOTHESIS = False

from repro.configs import SASPConfig, get_config, reduced  # noqa: E402
from repro.core import pruning as r_pruning  # noqa: E402
from repro.core import sasp as r_sasp  # noqa: E402
from repro.data import pipeline as r_data  # noqa: E402
from repro.models import lm as r_lm  # noqa: E402
from repro.train import optimizer as r_opt  # noqa: E402
from repro.train import schedule as r_sched  # noqa: E402
from repro.train.checkpoint import _flatten_with_names  # noqa: E402
from repro.train.train_step import make_train_step  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import SASPConfig as TSASPConfig  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.core import pruning as t_pruning  # noqa: E402
from repro_torch.core import sasp as t_sasp  # noqa: E402
from repro_torch.data import pipeline as t_data  # noqa: E402
from repro_torch.launch import train as t_launch  # noqa: E402
from repro_torch.models import lm as t_lm  # noqa: E402
from repro_torch.train import optimizer as t_opt  # noqa: E402
from repro_torch.train import schedule as t_sched  # noqa: E402
from repro_torch.train import train_step as t_step  # noqa: E402
from repro_torch.train.checkpoint import named_leaves  # noqa: E402
from torch_parity import KEY, bridged, mask_key, model, to_np  # noqa: E402
from torch_parity import assert_leaves_close as _assert_leaves_close  # noqa

ESP_VOCAB = 32


def _qwen(sparsity=0.25, scope="ffn"):
    return model(scope=scope, sparsity=sparsity)


def _espnet():
    kw = dict(enabled=True, block_k=8, block_n=8, sparsity=0.3)
    cfg = dataclasses.replace(
        reduced(get_config("paper-espnet2-mt"), layers=2, d_model=64,
                vocab=ESP_VOCAB), sasp=SASPConfig(**kw))
    tcfg = dataclasses.replace(
        t_reduced(t_get_config("paper-espnet2-mt"), layers=2, d_model=64,
                  vocab=ESP_VOCAB), sasp=TSASPConfig(**kw))
    params = r_lm.init_params(KEY, cfg)
    return cfg, tcfg, params, bridged(params)


def _lm_batch(vocab=64, seq=32, batch=4, step=0):
    b = r_data.lm_batch(r_data.DataConfig(vocab, seq, batch), step)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def _asr_batch(d_model=64, step=0):
    """The reference's tests/test_system.py batch: features shifted left
    by one, so next-token CE is per-position transcription."""
    b = r_data.asr_batch(r_data.DataConfig(ESP_VOCAB, 32, 8), step,
                         d_model, noise=2.0)
    b = {"tokens": b["tokens"], "embeds": np.roll(b["embeds"], -1, axis=1)}
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


def _batches_equal(seed, step, hosts, host_id):
    kw = dict(vocab_size=97, seq_len=70, global_batch=4, seed=seed,
              num_hosts=hosts, host_id=host_id)
    rc, tc = r_data.DataConfig(**kw), t_data.DataConfig(**kw)
    for want, got in ((r_data.lm_batch(rc, step), t_data.lm_batch(tc, step)),
                      (r_data.asr_batch(rc, step, 16),
                       t_data.asr_batch(tc, step, 16))):
        assert want.keys() == got.keys()
        for k in want:
            assert want[k].dtype == got[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("seed,step,hosts,host_id",
                         [(0, 0, 1, 0), (3, 17, 2, 1)])
def test_batches_bit_for_bit(seed, step, hosts, host_id):
    _batches_equal(seed, step, hosts, host_id)


if HAVE_HYPOTHESIS:
    @settings(max_examples=15, deadline=None)
    @given(seed=st.integers(0, 2**31 - 1), step=st.integers(0, 10**6))
    def test_batches_bit_for_bit_drawn(seed, step):
        _batches_equal(seed, step, 1, 0)


def test_pipeline_resumes_from_its_state():
    cfg = t_data.DataConfig(vocab_size=64, seq_len=16, global_batch=2)
    pipe = t_data.Pipeline(cfg)
    for _ in range(3):
        pipe.next()
    extra = pipe.state.to_dict()
    want = pipe.next()
    resumed = t_data.Pipeline(cfg, state=t_data.DataState.from_dict(extra))
    np.testing.assert_array_equal(resumed.next()["tokens"], want["tokens"])
    ref = r_data.Pipeline(r_data.DataConfig(64, 16, 2),
                          state=r_data.DataState.from_dict(extra))
    np.testing.assert_array_equal(ref.next()["tokens"], want["tokens"])
    asr = t_data.Pipeline(cfg, kind="asr", d_model=8, noise=0.5)
    np.testing.assert_array_equal(
        asr.next()["embeds"],
        r_data.Pipeline(r_data.DataConfig(64, 16, 2), kind="asr",
                        d_model=8, noise=0.5).next()["embeds"])


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------


def test_schedules_and_watchdog_equal():
    for warm, total in ((3, 20), (0, 5), (30, 100)):
        rf, tf = r_sched.warmup_cosine(warm, total), \
            t_sched.warmup_cosine(warm, total)
        for s in range(total + 3):
            np.testing.assert_allclose(float(tf(s)), float(rf(s)),
                                       rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(
            float(tf(torch.tensor(7, dtype=torch.int32))), float(rf(7)),
            rtol=1e-6)
    for i in range(60):
        kw = dict(start_step=10, end_step=50, final_sparsity=0.4)
        assert t_pruning.cubic_sparsity_schedule(i, **kw) == \
            r_pruning.cubic_sparsity_schedule(i, **kw)
    times = [0.1, 0.1, 0.5, 0.11, 0.3, 0.09, 1.0, 0.1] * 3
    rw, tw = r_sched.StragglerWatchdog(), t_sched.StragglerWatchdog()
    assert [tw.observe(t) for t in times] == [rw.observe(t) for t in times]
    assert (tw.slow_steps, tw.cv, tw.checkpoint_every(50)) == \
        (rw.slow_steps, rw.cv, rw.checkpoint_every(50))
    assert tw.slow_steps > 0


# ---------------------------------------------------------------------------
# the SASP overlay
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scope", ["ffn", "all"])
def test_overlay_masks_and_sparsity_equal(scope):
    cfg, tcfg, params, tparams = _qwen(sparsity=0.5, scope=scope)
    ov, got = r_sasp.build_sasp_overlay(params, cfg.sasp)
    tov, tgot = t_sasp.build_sasp_overlay(tparams, tcfg.sasp)
    assert tgot == got
    want = {n: np.asarray(m) for n, m in _flatten_with_names(ov)}
    have = {n: m.numpy() for n, m in named_leaves(tov)}
    assert have.keys() == want.keys() and want
    for n in want:
        np.testing.assert_array_equal(have[n], want[n])
    assert t_sasp.sasp_summary(tov) == r_sasp.sasp_summary(ov)
    masks = r_pruning.compute_sasp_masks(params, cfg.sasp)
    tmasks = t_pruning.compute_sasp_masks(tparams, tcfg.sasp)
    assert t_pruning.mask_sparsity(tmasks) == r_pruning.mask_sparsity(masks)
    assert t_pruning.per_matrix_sparsity(tmasks) == \
        r_pruning.per_matrix_sparsity(masks)
    assert {mask_key(p) for p in masks} == set(tmasks)


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------


def _case(name):
    """(ref cfg, port cfg, ref params, port params, ref overlay, port
    overlay, ref batch, port batch)."""
    if name == "espnet-embeds":
        cfg, tcfg, params, tparams = _espnet()
        rb, tb = _asr_batch()
    else:
        cfg, tcfg, params, tparams = _qwen()
        rb, tb = _lm_batch()
    ov = tov = None
    if name != "qwen-dense":
        ov, _ = r_sasp.build_sasp_overlay(params, cfg.sasp)
        tov, _ = t_sasp.build_sasp_overlay(tparams, tcfg.sasp)
    return cfg, tcfg, params, tparams, ov, tov, rb, tb


def _view(params, ov, merge):
    return merge(params, ov) if ov is not None else params


@pytest.mark.parametrize("name", ["qwen-dense", "qwen-overlay",
                                  "espnet-embeds"])
def test_loss_equal(name):
    cfg, tcfg, params, tparams, ov, tov, rb, tb = _case(name)
    want, wm = r_lm.loss_fn(_view(params, ov, r_sasp.merge_overlay), cfg,
                            rb)
    got, gm = t_lm.loss_fn(_view(tparams, tov, t_sasp.merge_overlay), tcfg,
                           tb)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(float(gm["ce"]), float(wm["ce"]), rtol=1e-5)
    assert float(gm["aux"]) == float(wm["aux"]) == 0.0
    ev = t_step.make_eval_step(tcfg, tov)(tparams, tb)
    assert float(ev["loss"]) == float(got) and set(ev) == {"loss", "ce",
                                                          "aux"}
    if name == "espnet-embeds":      # the embeds replace the token table
        t_tok = t_lm.loss_fn(tparams, tcfg, {"tokens": tb["tokens"]})[0]
        assert abs(float(t_tok) - float(got)) > 1e-3
        np.testing.assert_allclose(
            t_lm.forward(tparams, tcfg, tb["tokens"],
                         embeds=tb["embeds"]).numpy(),
            np.asarray(r_lm.forward(params, cfg, rb["tokens"],
                                    embeds=rb["embeds"])),
            rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", ["qwen-overlay", "espnet-embeds"])
def test_gradients_equal_and_pruned_tiles_zero(name):
    cfg, tcfg, params, tparams, ov, tov, rb, tb = _case(name)
    want = jax.grad(lambda p: r_lm.loss_fn(
        r_sasp.merge_overlay(p, ov), cfg, rb)[0])(params)
    loss, _, got = t_step.value_and_grad(tcfg, tparams, tb, tov)
    _assert_leaves_close(got, want, 1e-4)
    masks = t_pruning.compute_sasp_masks(tparams, tcfg.sasp)
    n_pruned = n_live = 0
    for path, mask in masks.items():
        g = got
        for k in path:
            g = g[k]
        L, K, N = g.shape
        KB, NB = mask.shape[-2:]
        tiles = g.reshape(L, KB, K // KB, NB, N // NB).abs().amax(
            dim=(2, 4))
        assert bool((tiles[~mask] == 0).all()), path
        n_pruned += int((~mask).sum())
        n_live += int((tiles[mask] > 0).sum())
    assert n_pruned > 0 and n_live > 0


def test_remat_modes_give_equal_loss_and_gradients():
    _, tcfg, _, tparams, _, tov, _, tb = _case("qwen-overlay")
    out = {}
    for remat in ("none", "full", "dots"):
        out[remat] = t_step.value_and_grad(
            dataclasses.replace(tcfg, remat=remat), tparams, tb, tov)
    for remat in ("full", "dots"):
        np.testing.assert_allclose(float(out[remat][0]),
                                   float(out["none"][0]), rtol=1e-6)
        _assert_leaves_close(out[remat][2], out["none"][2], 1e-6)
    with pytest.raises(ValueError, match="remat"):
        t_step.value_and_grad(dataclasses.replace(tcfg, remat="some"),
                              tparams, tb, tov)


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_stacked_leaves_split_by_one_backward_node(remat):
    """Each layer-stacked leaf (through its overlay product, if masked)
    reaches the layers by one chain that ends in an unbind: its backward
    stacks the layers' gradients once, where a node per layer would add
    a zero-padded full-size gradient per layer."""
    _, tcfg, _, tparams, _, tov, _, tb = _case("qwen-overlay")
    live = {k: p.detach().requires_grad_(True)
            for k, p in t_pruning.iter_leaves(tparams)}
    with torch.enable_grad():
        p = t_pruning.map_leaves(lambda path, _: live[path], tparams)
        loss, _ = t_lm.loss_fn(t_sasp.merge_overlay(p, tov),
                               dataclasses.replace(tcfg, remat=remat), tb)
    users, acc, seen, todo = {}, {}, set(), [loss.grad_fn]
    while todo:
        node = todo.pop()
        if node in seen:
            continue
        seen.add(node)
        for nxt, _ in node.next_functions:
            if nxt is not None:
                users.setdefault(nxt, set()).add(node)
                if hasattr(nxt, "variable"):
                    acc[id(nxt.variable)] = nxt
                todo.append(nxt)
    stacked = [k for k in live if k[0] == "segments"]
    assert stacked
    for k in stacked:
        node, chain = acc[id(live[k])], []
        while node.name() != "UnbindBackward0":
            assert len(users[node]) == 1, (k, chain, users[node])
            node = next(iter(users[node]))
            chain.append(node.name())
        assert chain[:-1] in ([], ["MulBackward0"]), (k, chain)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quantized", [False, True])
def test_adamw_update_equal(quantized):
    """Two updates with the global-norm clip active (norm about 30 > 1):
    params within fp32 rounding; int8 moments with ``q`` equal except
    where |x / scale| is within one ulp of a .5 tie, scales within fp32
    rounding (a few ulps: the clip's global norm is summed in another
    order, so the clipped gradient can differ in its last bit)."""
    rng = np.random.default_rng(5)
    shapes = {"w": (3, 40, 300), "b": (300,), "n": (7,)}
    p_np = {k: rng.normal(size=s).astype(np.float32) * 0.1
            for k, s in shapes.items()}
    g_np = [{k: rng.normal(size=s).astype(np.float32)
             for k, s in shapes.items()} for _ in range(2)]
    rc = r_opt.AdamWConfig(lr=1e-2, quantized=quantized)
    tc = t_opt.AdamWConfig(lr=1e-2, quantized=quantized)
    rp = {k: jnp.asarray(v) for k, v in p_np.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p_np.items()}
    rs, ts = r_opt.adamw_init(rp, rc), t_opt.adamw_init(tp, tc)
    assert float(t_opt.global_norm(
        {k: torch.from_numpy(v) for k, v in g_np[0].items()})) > 1.0
    for g in g_np:
        rp, rs = r_opt.adamw_update({k: jnp.asarray(v) for k, v in g.items()},
                                    rs, rp, rc, lr_scale=0.5)
        tp, ts = t_opt.adamw_update({k: torch.from_numpy(v)
                                     for k, v in g.items()}, ts, tp, tc,
                                    lr_scale=torch.tensor(0.5))
    assert int(ts.step) == int(rs.step) == 2
    _assert_leaves_close(tp, rp, 1e-6)
    if not quantized:
        _assert_leaves_close({"m": ts.m, "v": ts.v}, {"m": rs.m, "v": rs.v},
                             1e-6)
        return
    for k in shapes:
        for tm, rm in ((ts.m[k], rs.m[k]), (ts.v[k], rs.v[k])):
            np.testing.assert_allclose(tm.scale.numpy(),
                                       np.asarray(rm.scale), rtol=5e-7)
            q, want_q = tm.q.numpy(), np.asarray(rm.q)
            assert q.dtype == want_q.dtype == np.int8
            off = q != want_q
            assert np.abs(q.astype(int) - want_q).max(initial=0) <= 1
            if off.any():                   # only at .5 ties
                x = r_opt._dequantize_moment(rm, rm.q.shape)
                ratio = np.abs(np.asarray(x)[off])
                frac = np.abs(ratio / np.repeat(
                    np.asarray(rm.scale), r_opt.QBLOCK, axis=-1)[
                        ..., :q.shape[-1]][off] % 1 - 0.5)
                assert (frac < 1e-5).all()


def test_microbatched_step_matches_full_batch():
    """As the reference's tests/test_models.py: K = 2 against 1."""
    _, tcfg, _, tparams, _, tov, _, tb = _case("qwen-overlay")
    oc = t_opt.AdamWConfig(lr=1e-3)
    outs = []
    for k in (1, 2):
        p = copy.deepcopy(tparams)
        outs.append(t_step.make_train_step(tcfg, oc, overlay=tov,
                                           n_microbatches=k)(
            p, t_opt.adamw_init(p, oc), tb))
    (p1, _, m1), (p2, _, m2) = outs
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-4
    assert set(m2) == {"loss", "ce", "aux", "grad_norm"}
    diff = max(float((a - b).abs().max()) for (_, a), (_, b) in
               zip(named_leaves(p1), named_leaves(p2)))
    assert diff < 1e-4


def test_ten_step_trajectory_equal():
    """10 steps of the jitted reference step and the port's, the overlay
    closed over, warmup_cosine(3, 10): losses within 1e-4 relative at
    every step. fp32 moments: with int8 moments one ulp of a block scale
    moves ``q`` by one step at a .5 tie, which m / (sqrt(v) + eps)
    amplifies where v is small, and the two packages' losses part by
    1e-4 to 2e-3 after 4 steps (equal to 2e-7 before); int8 moments are
    held update by update in ``test_adamw_update_equal``."""
    cfg, tcfg, params, tparams = _qwen(sparsity=0.5)
    rc = r_opt.AdamWConfig(lr=2e-3)
    tc = t_opt.AdamWConfig(lr=2e-3)
    ov, _ = r_sasp.build_sasp_overlay(params, cfg.sasp)
    tov, _ = t_sasp.build_sasp_overlay(tparams, tcfg.sasp)
    rstep = jax.jit(make_train_step(cfg, rc, overlay=ov,
                                    lr_schedule=r_sched.warmup_cosine(3, 10)))
    tstep = t_step.make_train_step(tcfg, tc, overlay=tov,
                                   lr_schedule=t_sched.warmup_cosine(3, 10))
    rs, ts = r_opt.adamw_init(params, rc), t_opt.adamw_init(tparams, tc)
    want, got = [], []
    for i in range(10):
        rb, tb = _lm_batch(step=i)
        params, rs, rm = rstep(params, rs, rb)
        tparams, ts, tm = tstep(tparams, ts, tb)
        want.append(float(rm["loss"]))
        got.append(float(tm["loss"]))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]


def test_optimizer_state_crosses_the_bridge():
    """Reference AdamWState / QMoment -> port -> numpy, bit for bit."""
    _, _, params, _ = _qwen()
    st = r_opt.adamw_init(params, r_opt.AdamWConfig(quantized=True))
    st = st._replace(step=jnp.asarray(4, jnp.int32))
    port = bridge.from_numpy(to_np(st), device="cpu")
    assert isinstance(port, t_opt.AdamWState)
    assert isinstance(port.m["embed"]["emb"], t_opt.QMoment)
    back = bridge.to_numpy(port)
    for (n, a), (m, b) in zip(_flatten_with_names(st),
                              _flatten_with_names(back)):
        assert n == m
        np.testing.assert_array_equal(np.asarray(a), b)
    assert int(port.step) == 4


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


@pytest.fixture
def sigterm():
    """The launcher installs a SIGTERM handler (PreemptionHook); put the
    test process's own back afterwards."""
    old = signal.getsignal(signal.SIGTERM)
    yield
    signal.signal(signal.SIGTERM, old)


def test_preemption_hook_flags_sigterm(sigterm):
    hook = t_sched.PreemptionHook()
    assert not hook.requested
    os.kill(os.getpid(), signal.SIGTERM)
    assert hook.requested


def test_launcher_trains_on_cpu_and_checkpoints(tmp_path, capsys, sigterm):
    d = str(tmp_path / "ckpt")
    common = ["--reduce", "--batch", "2", "--seq", "32", "--sasp", "0.25",
              "--device", "cpu", "--ckpt-dir", d]
    t_launch.main(common + ["--steps", "4"])
    out = capsys.readouterr().out
    assert "SASP masks: 25.0% sparsity" in out and "done" in out
    assert os.path.isdir(os.path.join(d, "step_0000000004"))
    t_launch.main(common + ["--steps", "6", "--resume"])
    out = capsys.readouterr().out
    assert "resumed from step 4" in out
    assert sorted(os.listdir(d)) == ["step_0000000004", "step_0000000006"]
    # the reference's production meshes stop where their ranks are
    # missing, naming them: 512 for --mesh multi (a 'pod' axis), 256 for
    # --mesh single
    with pytest.raises(SystemExit, match="needs 512 ranks"):
        t_launch.main(["--mesh", "multi"])
    with pytest.raises(SystemExit, match="needs 256 ranks"):
        t_launch.main(["--mesh", "single"])
