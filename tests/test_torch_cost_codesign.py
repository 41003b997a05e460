"""The port's cost model and co-design explorer (``repro_torch.core.
cost_model`` / ``codesign``): every assertion of ``test_cost_codesign.py``
on the port (Table 3 within 5%, area, speedup monotone in sparsity, int8
energy, sublinear speedup at fixed QoS, ``best_under_qos``, Pareto
non-domination), then every number exactly equal to the reference's:
the copies run the same arithmetic in the same order."""
import dataclasses

import pytest

hypothesis = pytest.importorskip(
    "hypothesis", reason="property tests need hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.configs import ASSIGNED_ARCHS, get_config as r_get_config  # noqa
from repro.core import codesign as r_cd  # noqa: E402
from repro.core import cost_model as r_cm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.codesign import (  # noqa: E402
    best_under_qos,
    exponential_qos_proxy,
    pareto_front,
    speedup_at_fixed_qos,
    sweep,
)
from repro_torch.core.cost_model import (  # noqa: E402
    GEMMWork,
    SystolicConfig,
    encoder_gemms,
    energy_j,
    gemm_cycles,
    model_gemms_from_config,
    speedup_vs_cpu,
)

PAPER_NOSASP = {("fp32", 4): 8.42, ("fp32", 8): 19.79,
                ("fp32", 16): 35.22, ("fp32", 32): 50.95,
                ("int8", 4): 8.03, ("int8", 8): 20.18,
                ("int8", 16): 36.53, ("int8", 32): 61.33}

GEMMS = encoder_gemms(num_layers=18, d_model=512, d_ff=2048, seq=512)
SIZES = (4, 8, 16, 32)
QUANTS = ("fp32", "int8")


def _small(mod, s):
    return mod.encoder_gemms(num_layers=4, d_model=256, d_ff=1024, seq=128,
                             ffn_sparsity=s)


def _paper(mod, s):
    return mod.encoder_gemms(num_layers=18, d_model=512, d_ff=2048,
                             seq=512, ffn_sparsity=s)


# ---------------------------------------------------------------------------
# the reference's assertions, on the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quant,size", list(PAPER_NOSASP))
def test_fit_within_5pct_of_paper_table3(quant, size):
    sp = speedup_vs_cpu(SystolicConfig(size, quant), GEMMS)
    assert abs(sp / PAPER_NOSASP[(quant, size)] - 1) < 0.05


def test_area_matches_paper():
    assert abs(SystolicConfig(32, "fp32").area_mm2 - 3.34) < 0.1
    assert abs(SystolicConfig(8, "fp32").area_mm2 - 0.21) < 0.02


@settings(max_examples=25, deadline=None)
@given(s1=st.floats(0.0, 0.4), s2=st.floats(0.4, 0.8),
       size=st.sampled_from([4, 8, 16, 32]))
def test_speedup_monotone_in_sparsity(s1, s2, size):
    import repro_torch.core.cost_model as cm
    sa = SystolicConfig(size, "int8")
    assert speedup_vs_cpu(sa, _small(cm, s2)) >= \
        speedup_vs_cpu(sa, _small(cm, s1))


def test_int8_reduces_energy_and_weight_load_time():
    for size in (8, 16, 32):
        assert energy_j(SystolicConfig(size, "int8"), GEMMS) < \
            energy_j(SystolicConfig(size, "fp32"), GEMMS)
    w = GEMMWork(1, 512, 512)      # M=1 isolates programming cost
    assert gemm_cycles(SystolicConfig(32, "int8"), w) < \
        gemm_cycles(SystolicConfig(32, "fp32"), w)


def test_sublinear_speedup_at_fixed_qos():
    import repro_torch.core.cost_model as cm
    pts = sweep(lambda s: _paper(cm, s), exponential_qos_proxy())
    sel = speedup_at_fixed_qos(pts, 5.0, "int8")
    sizes = sorted(sel)
    assert len(sizes) >= 3
    assert sel[sizes[-1]] / sel[sizes[0]] < (sizes[-1] / sizes[0]) ** 2 / 3


def test_best_under_qos_respects_target():
    import repro_torch.core.cost_model as cm
    sel = best_under_qos(sweep(lambda s: _small(cm, s),
                               exponential_qos_proxy()), 5.0)
    assert sel and all(p.qos <= 5.0 for p in sel.values())


def test_pareto_front_is_nondominated():
    import repro_torch.core.cost_model as cm
    pts = sweep(lambda s: _small(cm, s), exponential_qos_proxy(),
                tiles=(4, 8))
    front = pareto_front(pts)
    assert 0 < len(front) < len(pts)
    for p in front:
        for o in pts:
            assert not (o.qos <= p.qos and o.time_s <= p.time_s
                        and o.area_energy <= p.area_energy
                        and (o.qos < p.qos or o.time_s < p.time_s
                             or o.area_energy < p.area_energy))


# ---------------------------------------------------------------------------
# exactly the reference's numbers
# ---------------------------------------------------------------------------


def _gemms_both(build):
    import repro_torch.core.cost_model as cm
    return build(cm), build(r_cm)


def _as_tuples(gs):
    return [(g.M, g.K, g.N, g.sparsity) for g in gs]


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("size", SIZES)
def test_cycles_speedup_energy_equal_reference(size, quant):
    mine, ref = _gemms_both(lambda m: _paper(m, 0.25))
    sa, rsa = SystolicConfig(size, quant), r_cm.SystolicConfig(size, quant)
    assert (sa.area_mm2, sa.power_w, sa.wpc) == \
        (rsa.area_mm2, rsa.power_w, rsa.wpc)
    for g, rg in zip(mine, ref):
        assert gemm_cycles(sa, g) == r_cm.gemm_cycles(rsa, rg)
    assert speedup_vs_cpu(sa, mine) == r_cm.speedup_vs_cpu(rsa, ref)
    assert energy_j(sa, mine) == r_cm.energy_j(rsa, ref)
    assert energy_j(sa, mine, 0.5) == r_cm.energy_j(rsa, ref, 0.5)


@pytest.mark.parametrize("gated", [False, True])
def test_encoder_gemms_equal_reference(gated):
    import repro_torch.core.cost_model as cm
    kw = dict(num_layers=3, d_model=96, d_ff=384, seq=40, ffn_gated=gated,
              ffn_sparsity=0.3, attn_sparsity=0.1)
    assert _as_tuples(cm.encoder_gemms(**kw)) == \
        _as_tuples(r_cm.encoder_gemms(**kw))


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_model_gemms_from_config_equal_reference(arch):
    for seq, s in ((1, 0.0), (512, 0.5)):
        assert _as_tuples(model_gemms_from_config(get_config(arch), seq, s)) \
            == _as_tuples(r_cm.model_gemms_from_config(r_get_config(arch),
                                                       seq, s))


@pytest.mark.parametrize("workload", ["paper", "small"])
def test_sweep_and_selections_equal_reference(workload):
    import repro_torch.core.cost_model as cm
    build = _paper if workload == "paper" else _small
    pts = sweep(lambda s: build(cm, s), exponential_qos_proxy())
    ref = r_cd.sweep(lambda s: build(r_cm, s), r_cd.exponential_qos_proxy())
    assert [dataclasses.asdict(p) for p in pts] == \
        [dataclasses.asdict(p) for p in ref]
    assert [p.area_energy for p in pts] == [p.area_energy for p in ref]
    for target in (3.6, 5.0, 8.0):
        sel = best_under_qos(pts, target)
        rsel = r_cd.best_under_qos(ref, target)
        assert {k: dataclasses.asdict(v) for k, v in sel.items()} == \
            {k: dataclasses.asdict(v) for k, v in rsel.items()}
        for q in QUANTS:
            assert speedup_at_fixed_qos(pts, target, q) == \
                r_cd.speedup_at_fixed_qos(ref, target, q)
    assert [dataclasses.asdict(p) for p in pareto_front(pts)] == \
        [dataclasses.asdict(p) for p in r_cd.pareto_front(ref)]


def test_qos_proxy_equal_reference():
    mine = exponential_qos_proxy(base_qos=3.0, brittleness=18.0)
    ref = r_cd.exponential_qos_proxy(base_qos=3.0, brittleness=18.0)
    for tile in SIZES:
        for s in (0.0, 0.1, 0.35):
            for q in QUANTS:
                assert mine(tile, s, q) == ref(tile, s, q)
