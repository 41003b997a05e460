"""The reference's expert-parallel MoE on 8 forced CPU devices, for
tests/test_torch_moe_ep.py (run as a script in a subprocess, as
tests/dist_worker.py runs ``mode_moe_ep``):

  python tests/torch_ep_reference.py OUT.npz

Writes the reduced granite-moe's layer-0 MoE params (the reference's
draw, through numpy), the input (numpy, seed 0), and for each mesh
(2, 1), (2, 2), (4, 2) and each capacity factor (8.0 drop-free, 1.25
default) ``moe_ffn_ep``'s y and aux, ``moe_ffn_local``'s, and
``moe_ffn_dp``'s on the (4, 2) mesh."""
import os

os.environ["XLA_FLAGS"] = (
    "--xla_force_host_platform_device_count=8 "
    + os.environ.get("XLA_FLAGS", ""))

import dataclasses  # noqa: E402
import sys  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

MESHES = ((2, 1), (2, 2), (4, 2))
FACTORS = (8.0, 1.25)


def config(cf: float):
    from repro.configs import get_config, reduced
    cfg = reduced(get_config("granite-moe-1b-a400m"), layers=2,
                  d_model=64, vocab=128)
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))


def main(out_path: str):
    from repro.distribution.moe_ep import can_use_ep, moe_ffn_dp, \
        moe_ffn_ep
    from repro.models import lm, moe as moe_mod

    cfg = config(FACTORS[0])
    params = lm.init_params(jax.random.PRNGKey(0), cfg)
    slot = jax.tree.map(lambda a: a[0],
                        params["segments"][0]["slot0"])["ffn"]
    x = np.random.default_rng(0).standard_normal((8, 16, 64)).astype(
        np.float32)
    out = {f"p/{k}": np.asarray(v["w"]) for k, v in slot.items()}
    out["x"] = x
    for cf in FACTORS:
        c = config(cf)
        y, aux = moe_mod.moe_ffn_local(slot, c, jnp.asarray(x))
        out[f"local/{cf}/y"], out[f"local/{cf}/aux"] = \
            np.asarray(y), np.asarray(aux)
        for dp, tp in MESHES:
            mesh = jax.make_mesh((dp, tp), ("data", "model"))
            assert can_use_ep(c, x.shape, mesh)
            with mesh:
                y, aux = jax.jit(lambda s, xx: moe_ffn_ep(
                    s, c, xx, mesh))(slot, jnp.asarray(x))
            out[f"ep/{dp},{tp}/{cf}/y"] = np.asarray(y)
            out[f"ep/{dp},{tp}/{cf}/aux"] = np.asarray(aux)
    mesh = jax.make_mesh((4, 2), ("data", "model"))
    with mesh:
        y, aux = jax.jit(lambda s, xx: moe_ffn_dp(
            s, config(1.25), xx, mesh))(slot, jnp.asarray(x))
    out["dp/y"], out["dp/aux"] = np.asarray(y), np.asarray(aux)
    np.savez(out_path, **out)


if __name__ == "__main__":
    main(sys.argv[1])
