"""The port's ZeRO placement (``repro_torch.train.optimizer``:
``zero_spec_from_param_spec``, ``opt_state_shardings``, and the mesh
step's ``train_step.mesh_layout``) against the reference's
(``repro.train.optimizer``, ``repro.distribution.sharding.
param_shardings``) on every leaf of a reduced qwen3 tree, on
``jax.sharding.AbstractMesh``es (no devices), fp32 and int8 moments (the
scale's placement included); and int8 moments quantized on slices of a
leaf's last dim (a ZeRO or TP slice, with the max over the slices' ranks)
equal to the whole leaf's quantization at every place."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import get_config, reduced  # noqa: E402
from repro.distribution import sharding as r_shd  # noqa: E402
from repro.models import lm as r_lm  # noqa: E402
from repro.train import optimizer as r_opt  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.train import optimizer as t_opt  # noqa: E402
from repro_torch.train.train_step import mesh_layout  # noqa: E402
from torch_parity import mask_key  # noqa: E402

MESHES = [(2, 2), (2, 1), (1, 2), (4, 2), (3, 2), (2, 4), (1, 1)]


def _spec(p, ndim):
    """A PartitionSpec as the port's tuple, one entry a dim."""
    return tuple(p) + (None,) * (ndim - len(p))


def _reference(dp, tp, quantized, layers=2, d_model=64, vocab=128):
    cfg = reduced(get_config("qwen3-32b"), layers=layers, d_model=d_model,
                  vocab=vocab)
    shapes = jax.eval_shape(lambda: r_lm.init_params(jax.random.PRNGKey(0),
                                                     cfg))
    mesh = AbstractMesh((dp, tp), ("data", "model"))
    psh = r_shd.param_shardings(cfg, shapes, mesh)
    osh = r_opt.opt_state_shardings(
        cfg, shapes, mesh, r_opt.AdamWConfig(quantized=quantized), psh)
    flat = jax.tree_util.tree_flatten_with_path
    ndim = {mask_key(p): len(s.shape) for p, s in flat(shapes)[0]}
    params = {mask_key(p): _spec(s.spec, ndim[mask_key(p)])
              for p, s in flat(psh)[0]}
    moments = {}
    for p, s in flat(osh.m, is_leaf=lambda x: isinstance(
            x, r_opt.QMoment))[0]:
        k = mask_key(p)
        moments[k] = (t_opt.QMoment(_spec(s.q.spec, ndim[k]),
                                    _spec(s.scale.spec, ndim[k]))
                      if quantized else _spec(s.spec, ndim[k]))
    return params, moments


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("dp,tp", MESHES)
def test_placement_equals_the_reference(dp, tp, quantized):
    """Every leaf's param spec and moment spec (q and scale with int8
    moments) equal the reference's."""
    want_p, want_m = _reference(dp, tp, quantized)
    cfg = t_reduced(t_get_config("qwen3-32b"), layers=2, d_model=64,
                    vocab=128)
    got = mesh_layout(cfg, dp, tp, t_opt.AdamWConfig(quantized=quantized))
    assert got.params == want_p
    assert got.opt.m == want_m and got.opt.v == want_m
    assert got.zero == {k: (m.q if quantized else m)
                        for k, m in want_m.items()}


@pytest.mark.parametrize("spec,shape,data", [
    ((None, None, "model"), (2, 64, 128), 2),
    ((None, "model", None), (2, 128, 64), 2),
    (("model", None), (128, 64), 4),
    ((None,), (64,), 3),           # nothing divides: stays whole
    ((None, None), (4, 4), 2),     # a tie: the first dim
    ((None, "data"), (8, 6), 2),   # already over 'data'
    ((), (6, 10), 5),              # a spec shorter than the leaf
])
def test_zero_spec_equals_the_reference(spec, shape, data):
    from jax.sharding import PartitionSpec as P
    mesh = AbstractMesh((data, 2), ("data", "model"))
    want = _spec(r_opt.zero_spec_from_param_spec(P(*spec), shape, mesh),
                 len(shape))
    assert t_opt.zero_spec_from_param_spec(
        spec, shape, {"data": data, "model": 2}) == want


@pytest.mark.parametrize("last,parts", [(1000, 4), (512, 2), (64, 2),
                                        (768, 3)])
def test_int8_moment_slices_equal_the_whole_leaf(last, parts):
    """A leaf's last dim cut in ``parts`` slices: each slice quantized
    against the whole leaf's 256-wide blocks (``lo``, ``nb``, the max
    over every slice's amax) gives the whole quantization's q and scale,
    and dequantizes to the whole's columns."""
    rng = np.random.default_rng(last)
    x = torch.from_numpy(rng.standard_normal((3, last)).astype(np.float32))
    whole = t_opt._quantize_moment(x)
    n, nb = last // parts, whole.scale.shape[-1]
    partial = []                      # each slice's amax, whole blocks

    def keep(a):
        partial.append(a.clone())
        return a
    for i in range(parts):
        t_opt._quantize_moment(x[:, i * n:(i + 1) * n], i * n, nb, keep)
    amax = torch.stack(partial).amax(0)

    def reduce(a):                    # the all-reduce max over the ranks
        return torch.maximum(a, amax)
    for i in range(parts):
        got = t_opt._quantize_moment(x[:, i * n:(i + 1) * n], i * n, nb,
                                     reduce)
        assert torch.equal(got.scale, whole.scale)
        assert torch.equal(got.q, whole.q[:, i * n:(i + 1) * n])
        assert torch.equal(
            t_opt._dequantize_moment(got, got.q.shape, i * n),
            t_opt._dequantize_moment(whole, x.shape)[:, i * n:(i + 1) * n])
