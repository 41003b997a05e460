"""The port's int8 error-feedback all-reduce (``repro_torch.train.
grad_compress``) on 2- and 4-rank 'data' meshes of spawned gloo
processes, against the reference's ``compressed_psum`` and
``compressed_allreduce_tree`` under ``jax.vmap(axis_name="pod")`` (the
reference's collectives need no devices there): the mean and the
residual within 1 ulp over two error-feedback steps, a length that is
not a multiple of the 256-wide block, the reference's own bound (the
error of one step at most amax / 127 * 1.01, a residual that is not
zero), every rank's result equal. The module imports no jax at its top:
the spawned ranks import it."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch.mesh import init_file_in  # noqa: E402
from repro_torch.launch.mesh import make_mesh, run_ranks  # noqa: E402
from repro_torch.train.grad_compress import (  # noqa: E402
    compressed_allreduce_tree, compressed_psum)

N = 1000                       # not a multiple of the 256-wide block


def _inputs(ranks: int):
    """Per-rank gradients of different scales (as the reference's worker
    draws them), and a tree of two leaves."""
    rng = np.random.default_rng(ranks)
    scale = np.arange(1, ranks + 1, dtype=np.float32)[:, None] * 2 - 1
    x = (rng.standard_normal((ranks, N)) * scale).astype(np.float32)
    tree = {"a": rng.standard_normal((ranks, 3, 100)).astype(np.float32),
            "b": rng.standard_normal((ranks, 512)).astype(np.float32)}
    return x, tree


def compress_rank(rank: int, ranks: int, init_file: str) -> dict:
    """One data rank: two error-feedback steps of ``compressed_psum`` (the
    second on half the gradient, carrying the first's residual) and one
    ``compressed_allreduce_tree``."""
    torch.set_num_threads(1)
    mesh = make_mesh(ranks, 1, rank=rank, init_file=init_file,
                     backend="gloo", device="cpu")
    x, tree = _inputs(ranks)
    xt = torch.from_numpy(x[rank])
    y1, r1 = compressed_psum(xt, mesh, "data")
    y2, r2 = compressed_psum(xt * 0.5, mesh, "data", r1)
    ty, tr = compressed_allreduce_tree(
        {k: torch.from_numpy(v[rank]) for k, v in tree.items()}, mesh,
        "data")
    return {"y1": y1.numpy(), "r1": r1.numpy(), "y2": y2.numpy(),
            "r2": r2.numpy(), "tree_y": {k: v.numpy() for k, v in ty.items()},
            "tree_r": {k: v.numpy() for k, v in tr.items()}}


def _reference(ranks: int) -> dict:
    """The reference's results, one row a pod, under ``jax.vmap``."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.train.grad_compress import (compressed_allreduce_tree as
                                           r_tree, compressed_psum as r_psum)
    x, tree = _inputs(ranks)

    def two_steps(xl):
        y1, r1 = r_psum(xl, "pod", None)
        y2, r2 = r_psum(xl * 0.5, "pod", r1)
        return y1, r1, y2, r2

    y1, r1, y2, r2 = jax.vmap(two_steps, axis_name="pod")(jnp.asarray(x))
    ty, tr = jax.vmap(lambda t: r_tree(t, "pod"), axis_name="pod")(
        {k: jnp.asarray(v) for k, v in tree.items()})
    np_ = np.asarray
    return {"y1": np_(y1), "r1": np_(r1), "y2": np_(y2), "r2": np_(r2),
            "tree_y": {k: np_(v) for k, v in ty.items()},
            "tree_r": {k: np_(v) for k, v in tr.items()}}


@pytest.fixture(scope="module", params=[2, 4], ids=["2ranks", "4ranks"])
def runs(request, tmp_path_factory):
    ranks = request.param
    store = init_file_in(str(tmp_path_factory.mktemp(f"gc{ranks}")))
    return ranks, run_ranks(compress_rank, ranks, (ranks, store),
                            timeout=120), _reference(ranks)


def test_compressed_psum_equals_the_reference(runs):
    """Every rank's mean and residual, over two error-feedback steps,
    within 1 ulp of the reference's pod at that rank."""
    ranks, got, want = runs
    for r in range(ranks):
        for key in ("y1", "r1", "y2", "r2"):
            np.testing.assert_array_max_ulp(got[r][key], want[key][r],
                                            maxulp=1)


def test_compressed_psum_within_int8_bound(runs):
    """The reference's bound: one step's error against the exact mean at
    most amax / 127 * 1.01, the residual not zero, every rank the same
    mean."""
    ranks, got, _ = runs
    x, _ = _inputs(ranks)
    err = float(np.abs(got[0]["y1"] - x.mean(axis=0)).max())
    assert err <= float(np.abs(x).max()) / 127.0 * 1.01
    assert float(np.abs(got[0]["r1"]).max()) > 0
    for r in range(1, ranks):
        np.testing.assert_array_equal(got[r]["y1"], got[0]["y1"])
        np.testing.assert_array_equal(got[r]["y2"], got[0]["y2"])


def test_compressed_allreduce_tree_equals_the_reference(runs):
    ranks, got, want = runs
    for r in range(ranks):
        for part in ("tree_y", "tree_r"):
            assert got[r][part].keys() == want[part].keys()
            for k in want[part]:
                np.testing.assert_array_max_ulp(got[r][part][k],
                                                want[part][k][r], maxulp=1)
