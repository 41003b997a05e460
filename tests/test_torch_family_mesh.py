"""MoE, SSM and hybrid stacks served on (data, model) gloo meshes of
spawned processes (CPU): reduced granite-moe, mamba2 and jamba (4 layers,
d_model 64, every weight times 3 so that streams depend on the prompt,
written by the reference's ``CheckpointManager`` and read back layer by
layer and expert by expert), packed at 50% (scope all), on ``--mesh
1,2``, ``2,1`` and ``2,2``. One ``Engine`` per mesh (slots split over
'data', the experts in EP over 'data' and their d_ff, like the SSM heads,
over 'model'): every process is bit for bit its meshless loop of the
same shard counts (``build_rank_params(rank=None)`` and
``Engine(data_shards=DP)``), in streams and in every decode step's
logits. ``ShardedScheduler(mesh=)`` (each rank's experts whole, d_ff
over 'model'): streams and served ranks bit for bit the meshless
scheduler over the shard loop. At drop-free capacity the dense (2, 2)
engine's greedy streams equal the reference's meshless engine. Every
rank's layer-by-layer build (one expert at a time) equals its slice of
the whole packed build, leaf for leaf. Imports
no jax at its top: the ranks are spawned processes that import this
module."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.launch.mesh import init_file_in, make_mesh  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402
from repro_torch.launch.serve import build_rank_params  # noqa: E402
from repro_torch.launch.serve import expert_shards  # noqa: E402
from repro_torch.serve.engine import Engine, Request  # noqa: E402
from repro_torch.serve.scheduler import SchedulerConfig  # noqa: E402
from repro_torch.serve.scheduler import ShardedScheduler  # noqa: E402

ARCHS = ("granite-moe-1b-a400m", "mamba2-780m", "jamba-1.5-large-398b")
SHAPES = ((1, 2), (2, 1), (2, 2))
SLOTS, CACHE = 4, 64
PACKED = dict(sparsity=0.5, scope="all", path="packed")
DENSE = dict(sparsity=0.0, path="dense")


def port_config(arch, cf=None):
    cfg = reduced(get_config(arch), layers=4, d_model=64, vocab=128)
    if cf is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cf))
    return cfg


def requests(cls=Request):
    rng = np.random.default_rng(3)
    return [cls(rid=i, prompt=rng.integers(0, 128, size=(5 + 3 * i,))
                .astype(np.int32), max_new_tokens=5) for i in range(5)]


def _streams(done):
    return {r.rid: [int(t) for t in r.out_tokens] for r in done}


def _engine(params, cfg, mesh=None, data_shards=1):
    """Streams and every decode step's logits (this data rank's rows)."""
    eng = Engine(params, cfg, batch_slots=SLOTS, cache_len=CACHE, mesh=mesh,
                 data_shards=data_shards)
    steps = []
    step = eng._decode_step

    def recorded(p, c, *a):
        out = step(p, c, *a)
        steps.append(out.numpy().copy())
        return out
    eng._decode_step = recorded
    return _streams(eng.run(requests())), steps, eng.layout


def _sched(params, cfg, mesh=None, ranks=None):
    s = ShardedScheduler(params, cfg, mesh=mesh, ranks=ranks,
                         sched=SchedulerConfig(slots_per_rank=2,
                                               cache_len=CACHE))
    done = s.run(requests())
    return _streams(done), {r.rid: r.rank for r in done}


def _build(arch, shape, ckpt, rank, data_rank, scheduler, cf=None,
           how=PACKED):
    dp, tp = shape
    cfg = port_config(arch, cf)
    ep = expert_shards(cfg, shape, scheduler=scheduler)
    with torch.no_grad():
        params, tcfg, lcfg, _ = build_rank_params(
            cfg, tp=tp, rank=rank, device="cpu", ckpt_dir=ckpt, ep=ep,
            data_rank=data_rank, **how)
    return params, (tcfg if rank is None else lcfg), ep


def _rank(rank, shape, ckpts, store):
    torch.set_num_threads(1)
    dp, tp = shape
    mesh = make_mesh(dp, tp, rank=rank, init_file=store, backend="gloo",
                     device="cpu")
    out = {"data_rank": mesh.data_rank}
    for arch in ARCHS:
        p, lcfg, _ = _build(arch, shape, ckpts[arch], mesh.model_rank,
                            mesh.data_rank, False)
        out[arch, "engine"] = _engine(p, lcfg, mesh)
        p, lcfg, _ = _build(arch, shape, ckpts[arch], mesh.model_rank,
                            mesh.data_rank, True)
        out[arch, "sched"] = _sched(p, lcfg, mesh)
        if shape == (2, 2):
            cf = None if arch == "mamba2-780m" else 8.0
            p, lcfg, _ = _build(arch, shape, ckpts[arch], mesh.model_rank,
                                mesh.data_rank, False, cf, DENSE)
            out[arch, "dense"] = _engine(p, lcfg, mesh)[0]
    return out


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """Each arch's reference params times 3 in a reference checkpoint,
    and the reference's meshless engine's greedy streams on them at
    drop-free capacity (4 slots, dense)."""
    jax = pytest.importorskip("jax")
    from repro.configs import get_config as r_get
    from repro.configs import reduced as r_reduced
    from repro.models import lm as r_lm
    from repro.serve.engine import Engine as REngine
    from repro.serve.engine import Request as RRequest
    from repro.train.checkpoint import CheckpointManager as RManager
    ckpts, want = {}, {}
    for arch in ARCHS:
        cfg = r_reduced(r_get(arch), layers=4, d_model=64, vocab=128)
        params = jax.tree.map(lambda a: a * 3.0,
                              r_lm.init_params(jax.random.PRNGKey(0), cfg))
        path = tmp_path_factory.mktemp("ckpt") / arch
        RManager(str(path)).save(1, {"params": params})
        ckpts[arch] = str(path)
        if cfg.moe is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=8.0))
        want[arch] = _streams(REngine(params, cfg, batch_slots=SLOTS,
                                      cache_len=CACHE).run(
                                          requests(RRequest)))
    return ckpts, want


@pytest.fixture(scope="module")
def runs(checkpoints, tmp_path_factory):
    """Each mesh shape's processes, spawned once (lazily)."""
    ckpts, _ = checkpoints
    cache = {}

    def get(shape):
        if shape not in cache:
            store = init_file_in(str(tmp_path_factory.mktemp("store")),
                                 f"fam_{shape[0]}x{shape[1]}")
            cache[shape] = run_ranks(_rank, shape[0] * shape[1],
                                     (shape, ckpts, store), timeout=300)
        return cache[shape]
    return get


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_mesh_engine_is_its_loop_bit_for_bit(checkpoints, runs, shape):
    ckpts, _ = checkpoints
    dp, tp = shape
    results = runs(shape)
    for arch in ARCHS:
        p, cfg, ep = _build(arch, shape, ckpts[arch], None, 0, False)
        assert ep == (dp if arch != "mamba2-780m" and dp > 1 else 1)
        streams, steps, layout = _engine(p, cfg, data_shards=dp)
        assert layout == (None if dp == 1 else
                          "slots split over data (meshless)")
        assert len({tuple(s) for s in streams.values()}) > 1, arch
        per = SLOTS // dp
        for r in results:
            got, gsteps, glayout = r[arch, "engine"]
            assert glayout == (None if dp == 1 else "slots split over data")
            assert got == streams, arch
            assert len(gsteps) == len(steps) > 0, arch
            d = r["data_rank"]
            for a, b in zip(gsteps, steps):
                assert np.array_equal(a, b[d * per:(d + 1) * per]), arch


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_mesh_scheduler_is_its_loop_bit_for_bit(checkpoints, runs, shape):
    ckpts, _ = checkpoints
    results = runs(shape)
    for arch in ARCHS:
        p, cfg, ep = _build(arch, shape, ckpts[arch], None, 0, True)
        assert ep == 1
        want = _sched(p, cfg, ranks=shape[0])
        for r in results:
            assert r[arch, "sched"] == want, arch


def test_mesh_streams_equal_reference_engine(checkpoints, runs):
    """Drop-free capacity, dense params: the (2, 2) engine's greedy
    streams (experts in EP over 'data', d_ff and SSM heads over
    'model') are the reference's meshless engine's."""
    _, want = checkpoints
    for r in runs((2, 2)):
        for arch in ARCHS:
            assert r[arch, "dense"] == want[arch], arch


@pytest.mark.parametrize("arch", ARCHS)
def test_rank_build_is_the_whole_build_cut(arch):
    """``build_rank_params`` of every (data, model) rank at tp 2 (ep 2 for
    the MoE stacks), its experts taken one at a time, equals
    ``local_params`` of the whole packed build of the same seed's
    weights, leaf for leaf."""
    from repro_torch.distribution.sharding import local_params
    from repro_torch.launch.serve import build_serving_params
    from repro_torch.models import lm
    from test_torch_tp_mesh import _leaves
    cfg = port_config(arch)
    ep = 2 if cfg.moe is not None else 1
    with torch.no_grad():
        whole, wcfg = build_serving_params(
            lm.init_params(cfg, seed=0, device="cpu"), cfg, tp=2,
            verbose=False, **PACKED)
        for d in range(ep):
            for m in range(2):
                got = dict(_leaves(build_rank_params(
                    cfg, tp=2, rank=m, device="cpu", ep=ep, data_rank=d,
                    **PACKED)[0]))
                want = dict(_leaves(local_params(whole, wcfg, 2, m, ep, d)))
                assert got.keys() == want.keys()
                for k, v in want.items():
                    if isinstance(v, torch.Tensor):
                        assert torch.equal(got[k], v), (d, m, k)
                    else:
                        assert got[k] == v, (d, m, k)
