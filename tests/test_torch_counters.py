"""The port's analytic counters (``repro_torch.analysis.counters``), shape
cells (``repro_torch.configs.shapes``) and H100 roofline
(``repro_torch.core.h100_model``):

* ``step_costs`` equal to the reference's, every field (``detail``
  included), for every assigned arch × its shape cells, at sparsity 0 and
  0.5, weight bytes 0 and 1, int8 KV off and on;
* ``model_flops``, ``get_shape``, ``shapes_for`` and
  ``skipped_shapes_for`` equal to the reference's;
* the roofline's terms against their formulas and the card's constants;
* ``FlopCounterMode`` over one layer of the port's forward within
  0.65-1.55 of the analytic forward count (the band the reference holds
  its counts to against XLA's, ``test_counters_hlo.py``), and the
  reference's own checks of the counters, run on the port."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro.analysis.counters import step_costs as r_step_costs  # noqa: E402
from repro.configs import ASSIGNED_ARCHS  # noqa: E402
from repro.configs import get_config as r_get_config  # noqa: E402
from repro.configs import shapes as r_shapes  # noqa: E402
from repro.core import tpu_model as r_tpu  # noqa: E402
from repro_torch.analysis.counters import step_costs  # noqa: E402
from repro_torch.configs import (ShapeConfig, get_config, get_shape,  # noqa
                                 reduced, shapes_for, skipped_shapes_for)
from repro_torch.core import h100_model as H  # noqa: E402
from repro_torch.models import lm  # noqa: E402

CELLS = [(a, s.name) for a in ASSIGNED_ARCHS
         for s in r_shapes.shapes_for(r_get_config(a))]


def _both(arch, kv_quant):
    return (dataclasses.replace(get_config(arch), kv_quant=kv_quant),
            dataclasses.replace(r_get_config(arch), kv_quant=kv_quant))


@pytest.mark.parametrize("arch,shape", CELLS)
def test_step_costs_equal_reference(arch, shape):
    for kv in (False, True):
        cfg, rcfg = _both(arch, kv)
        for sparsity in (0.0, 0.5):
            for wq in (0, 1):
                got = dataclasses.asdict(step_costs(
                    cfg, get_shape(shape), sparsity=sparsity,
                    weight_quant_bytes=wq))
                want = dataclasses.asdict(r_step_costs(
                    rcfg, r_shapes.get_shape(shape), sparsity=sparsity,
                    weight_quant_bytes=wq))
                assert got == want, (arch, shape, kv, sparsity, wq)


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_shapes_and_model_flops_equal_reference(arch):
    cfg, rcfg = get_config(arch), r_get_config(arch)
    assert [dataclasses.astuple(s) for s in shapes_for(cfg)] == \
        [dataclasses.astuple(s) for s in r_shapes.shapes_for(rcfg)]
    assert skipped_shapes_for(cfg) == r_shapes.skipped_shapes_for(rcfg)
    for s in r_shapes.ALL_SHAPES:
        assert dataclasses.astuple(get_shape(s)) == \
            dataclasses.astuple(r_shapes.get_shape(s))
        assert H.model_flops(cfg, get_shape(s)) == \
            r_tpu.model_flops(rcfg, r_shapes.get_shape(s))


@pytest.mark.parametrize("chips,flops", [(1, 3.1e15), (4, 3.1e15),
                                         (256, 1.7e18)])
def test_roofline_terms_follow_their_formulas(chips, flops):
    hbm, coll = 7.7e12, 2.5e11
    t = H.roofline(flops, hbm, coll, chips)
    assert t.compute_s == flops / (chips * 989e12)
    assert t.memory_s == hbm / (chips * 3.35e12)
    assert t.collective_s == coll / (chips * 450e9)
    assert t.bound_s == max(t.compute_s, t.memory_s, t.collective_s)
    assert t.serial_s == t.compute_s + t.memory_s + t.collective_s
    assert t.bottleneck == max(
        ("compute", t.compute_s), ("memory", t.memory_s),
        ("collective", t.collective_s), key=lambda kv: kv[1])[0]
    assert t.mfu == t.compute_s / t.bound_s
    assert t.energy_j() == t.bound_s * chips * H.CHIP_POWER_W == \
        t.bound_s * chips * 700.0
    assert t.row()["bound_s"] == t.bound_s
    assert H.roofline(0.0, 0.0, 0.0, 1).mfu == 0.0
    assert H.PEAK_FLOPS == {"bfloat16": 989e12, "float32": 67e12}


def _one_layer_cfg(arch):
    return dataclasses.replace(
        reduced(get_config(arch), layers=1, d_model=64, vocab=128),
        remat="none")


@pytest.mark.parametrize("arch", ["qwen3-32b", "mamba2-780m",
                                  "musicgen-medium"])
def test_forward_flops_match_flop_counter_on_one_layer(arch):
    """The analytic forward count against ``FlopCounterMode`` (matmuls,
    einsums, convolutions) over the port's one-layer forward."""
    from torch.utils.flop_counter import FlopCounterMode
    cfg = _one_layer_cfg(arch)
    B, S = 2, 64
    params = lm.init_params(cfg, device="cpu")
    kw = {}
    if cfg.frontend != "none":
        kw["embeds"] = torch.zeros((B, S, cfg.d_model))
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        lm.forward(params, cfg, torch.zeros((B, S), dtype=torch.int32),
                   **kw)
    counted = fc.get_total_flops()
    ours = step_costs(cfg, ShapeConfig("t", "prefill", S, B)).flops_fwd
    assert counted > 0
    assert 0.65 < ours / counted < 1.55, (arch, ours, counted)


def test_train_multiplier():
    cfg = _one_layer_cfg("qwen3-32b")
    cp = step_costs(cfg, ShapeConfig("p", "prefill", 64, 2))
    ct = step_costs(cfg, ShapeConfig("t", "train", 64, 2))
    assert abs(ct.flops / cp.flops - 3.0) < 1e-6
    cfg_r = dataclasses.replace(cfg, remat="full")
    assert abs(step_costs(cfg_r, ShapeConfig("t", "train", 64, 2)).flops
               / cp.flops - 4.0) < 1e-6


def test_decode_kv_bytes_dominate_large_context():
    cfg = dataclasses.replace(get_config("qwen2.5-32b"),
                              compute_dtype="bfloat16")
    shape = ShapeConfig("d", "decode", seq_len=32768, global_batch=128)
    c = step_costs(cfg, shape)
    assert c.kv_bytes / c.bytes_hbm > 0.8
    c8 = step_costs(dataclasses.replace(cfg, kv_quant=True), shape)
    assert 0.4 < c8.kv_bytes / c.kv_bytes < 0.6


def test_sasp_sparsity_scales_ffn_flops():
    cfg = _one_layer_cfg("qwen3-32b")
    shape = ShapeConfig("p", "prefill", 64, 2)
    c0 = step_costs(cfg, shape)
    c5 = step_costs(cfg, shape, sparsity=0.5)
    assert abs((c0.detail["ffn"] - c5.detail["ffn"]) / c0.detail["ffn"]
               - 0.5) < 1e-6
