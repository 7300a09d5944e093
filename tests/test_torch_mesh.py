"""The port's sharded engine and Trainer over a real device mesh: four
processes, one per shard, joined by gloo on the CPU, against the
reference's emulated engine and Trainer and the port's own emulated ones.

Four ranks are spawned once for the whole module
(tests/_torch_mesh_ranks.py, torch only) and save what they computed; the
tests below read it. The world is the reference's own sharded test's
(tests/test_distributed.py): arxiv at scale 0.02, an LDG partition into 4
shards, 8 roots per model, 2 layers of 16, fanout 4. Tolerances:

* one sharded iteration against the reference's emulated one: loss and
  every gradient within 1e-5 (the reference's bound for shard_map against
  its emulation, tests/test_distributed.py);
* the fused and stacked steps against the port's emulated ones: rtol
  1e-6, atol 1e-7 (tests/test_torch_train.py's STEP_TOL) — the gradient
  sum runs in the all_reduce's order, not shard order;
* fit losses against the port's emulated Trainer and the reference's:
  rtol 1e-6 (FIT_RTOL);
* bitwise: every rank's parameters against every other rank's, faulted
  sharded runs against the straight sharded run, the stacked sharded fit
  against the unstacked one, and a sharded run's checkpoint loaded by
  either package.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing

import repro.checkpoint as jax_ckpt
import repro.core.distributed as jax_engine
import repro.core.strategies as jax_strategies
import repro.features as jax_features
import repro.graph as jax_graph
import repro.models.gnn.models as jax_models
import repro.optim as jax_optim
import repro.train as jax_train
import repro_torch.models.gnn.models as torch_models
import repro_torch.train as torch_train
from repro_torch.checkpoint import load_checkpoint

import _torch_mesh_ranks as ranks_prog

WORLD = ranks_prog.WORLD
ITER_TOL = 1e-5
STEP_TOL = dict(rtol=1e-6, atol=1e-7)
FIT_RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread in this worker (the suite runs in several)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    ds, part, table, owner, local_idx = ranks_prog.world()
    return dict(ds_t=ds, ds_j=jax_graph.make_dataset("arxiv", scale=0.02,
                                                     seed=0),
                part=part, table=table, owner=owner, local_idx=local_idx)


def _cfgs(w, model):
    cfg_t = ranks_prog.cfg_of(w["ds_t"], model)
    kw = {f: getattr(cfg_t, f) for f in ("model", "num_layers", "hidden_dim",
                                         "feature_dim", "num_classes",
                                         "fanout")}
    return jax_models.GNNConfig(**kw), cfg_t


@pytest.fixture(scope="module")
def trees(world):
    """The reference's init per model, and the port's copy of it."""
    out = {}
    for model in ("sage", "gcn"):
        cfg_j, _ = _cfgs(world, model)
        tree = jax_models.init_gnn(jax.random.PRNGKey(0), cfg_j)
        out[model] = (tree, torch_models.params_from_jax(tree, device="cpu"))
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, trees):
    """Spawn the four ranks once; each saves rank{r}.pt."""
    out = tmp_path_factory.mktemp("mesh")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        torch.multiprocessing.spawn(
            ranks_prog.run_rank,
            args=(str(out), {m: t for m, (_, t) in trees.items()}),
            nprocs=WORLD, join=True)
    res = [torch.load(out / f"rank{r}.pt", weights_only=False)
           for r in range(WORLD)]
    assert [r["rank"] for r in res] == list(range(WORLD))
    return res, out


def _ref_iteration(w, tree, model, mode):
    """The reference's emulated iteration on the same roots and seed."""
    m = ranks_prog.MODES[mode]
    cfg_j, _ = _cfgs(w, model)
    store = (jax_features.FeatureStore.from_array(
        w["table"], owner=w["owner"], local_idx=w["local_idx"],
        host_budget_bytes=w["table"].nbytes // 3) if m["tiered"] else None)
    ds = w["ds_j"]
    plan = jax_strategies.plan_iteration(
        ds.graph, ds.labels, w["part"], w["owner"], w["local_idx"],
        w["table"].shape[1], ranks_prog.roots_of(w["ds_t"]), num_layers=2,
        fanout=4, strategy="hopgnn", pregather=m["pregather"],
        sample_seed=ranks_prog.SAMPLE_SEED, feature_store=store)
    table = None if m["tiered"] else jnp.asarray(w["table"])
    return jax_engine.run_iteration(tree, table, plan, cfg_j,
                                    fold_returns=m["fold"])


@pytest.mark.parametrize("mode", sorted(ranks_prog.MODES))
@pytest.mark.parametrize("model", ["sage", "gcn"])
def test_sharded_iteration_matches_reference(ranks, world, trees, model,
                                             mode):
    """Each rank's loss and gradients of one sharded iteration (its shard,
    real exchanges, one all_reduce) within 1e-5 of the reference's
    emulated iteration, and the same on every rank."""
    res, _ = ranks
    g_ref, l_ref = _ref_iteration(world, trees[model][0], model, mode)
    g_ref = [np.asarray(x) for x in jax.tree.leaves(g_ref)]
    first = res[0][("iteration", model, mode)]
    for r in res:
        got = r[("iteration", model, mode)]
        assert got["kind"] == "sharded"
        # only this rank's shard: the table and cache with the shard axis
        # kept at size 1
        assert got["shapes"][0][0] == got["shapes"][1][0] == 1
        assert abs(got["loss"] - float(l_ref)) < ITER_TOL
        assert len(got["grads"]) == len(g_ref)
        for a, b in zip(got["grads"], g_ref):
            assert a.shape == b.shape
            assert float(np.abs(a.numpy() - b).max()) < ITER_TOL
        assert got["loss"] == first["loss"]
        for a, b in zip(got["grads"], first["grads"]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("mode", sorted(ranks_prog.MODES))
def test_collective_counts(ranks, mode):
    """The collectives one sharded iteration runs, per rank: all_to_alls
    as the reference counts them (tests/test_distributed.py: 2 in
    pregather and folded per-step mode, T+1 unfolded; streamed mode runs
    no feature collective) and one all_reduce of every gradient and the
    loss."""
    res, _ = ranks
    for r in res:
        for model in ("sage", "gcn"):
            got = r[("iteration", model, mode)]
            want = {"pregather": 2, "per-step": got["T"] + 1,
                    "per-step folded": 2, "streamed": 0}[mode]
            assert got["T"] > 1
            assert got["counts"].get("all_to_all", 0) == want
            assert got["counts"]["all_reduce"] == 1


@pytest.mark.parametrize("step", ["fused", "stacked"])
def test_train_steps_match_emulated(ranks, step):
    """run_train_step under the mesh, and the stacked fused step over two
    same-bucket plans, against the port's emulated steps from the same
    start: losses and updated parameters at STEP_TOL, and bitwise the same
    parameters on every rank."""
    res, _ = ranks
    first = res[0][(step, "sharded")]
    if step == "stacked":
        assert first["kind"] == "sharded-fused-stacked"
        assert res[0][(step, "emulated")]["kind"] == "emulated-fused-stacked"
    for r in res:
        got, emu = r[(step, "sharded")], r[(step, "emulated")]
        np.testing.assert_allclose(got.get("losses", got.get("loss")),
                                   emu.get("losses", emu.get("loss")),
                                   **STEP_TOL)
        for a, b, c in zip(got["params"], emu["params"], first["params"]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), **STEP_TOL)
            assert torch.equal(a, c)


def _trainers(w, trees):
    """The reference's Trainer and the port's emulated one, with the
    ranks' settings (merging off, cosine AdamW)."""
    tree, params = trees["sage"]
    cfg_j, cfg_t = _cfgs(w, "sage")
    common = dict(labels=w["ds_t"].labels, part=w["part"], owner=w["owner"],
                  local_idx=w["local_idx"], table=w["table"],
                  train_vertices=w["ds_t"].train_vertices(), merging=False)
    key = ("cos", 3e-3, 2, 9)
    tj = jax_train.Trainer(
        graph=w["ds_j"].graph, cfg=cfg_j, params=tree, resilience=False,
        optimizer=jax_optim.adamw(jax_optim.cosine_schedule(3e-3, 2, 9),
                                  weight_decay=1e-4, grad_clip=1.0, key=key),
        **common)
    tt = torch_train.Trainer(graph=w["ds_t"].graph, cfg=cfg_t, params=params,
                             optimizer=ranks_prog.fit_optimizer(),
                             device="cpu", **common)
    return tj, tt


def test_fit_matches_emulated_and_reference(ranks, world, trees):
    """Trainer(mesh) per-epoch losses against the port's emulated Trainer
    and the reference's Trainer within FIT_RTOL; the sharded Trainer
    recorded only sharded signatures, none after epoch 0."""
    res, _ = ranks
    tj, tt = _trainers(world, trees)
    st_j = tj.fit(**ranks_prog.FIT)
    st_t = tt.fit(**ranks_prog.FIT)
    for r in res:
        fit = r["fit"]
        np.testing.assert_allclose(fit["losses"], [s.loss for s in st_t],
                                   rtol=FIT_RTOL)
        np.testing.assert_allclose(fit["losses"], [s.loss for s in st_j],
                                   rtol=FIT_RTOL)
        assert fit["global_step"] == tt.global_step == tj.global_step == 9
        assert fit["traces"][1:] == [0, 0]
        assert "sharded-fused" in fit["kinds"]
        assert not any(k.startswith("emulated") for k in fit["kinds"])


def test_parameters_equal_across_ranks(ranks, world):
    """The replicated parameters and AdamW moments after the fit are
    bitwise equal on every rank; each rank held only its own table slice
    and uploaded one plan slice per iteration."""
    res, _ = ranks
    first = res[0]["fit"]
    rows, d = world["table"].shape[1:]
    for r in res:
        fit = r["fit"]
        assert fit["device"] == "cpu"
        assert fit["table"] == (1, rows, d)
        assert fit["uploads"] == 9
        assert fit["step"] == first["step"] == 9
        for a, b in zip(fit["params"] + fit["opt"],
                        first["params"] + first["opt"]):
            assert torch.equal(a, b)


def test_cached_fit_matches_emulated(ranks, world, trees):
    """With a degree-policy cache each rank uploads only its own
    (1, c_max, d) cache slice; hits and losses as the port's emulated
    Trainer with the same cache (FIT_RTOL)."""
    res, _ = ranks
    tt = torch_train.Trainer(
        graph=world["ds_t"].graph, labels=world["ds_t"].labels,
        part=world["part"], owner=world["owner"],
        local_idx=world["local_idx"], table=world["table"],
        cfg=_cfgs(world, "sage")[1], params=trees["sage"][1],
        optimizer=ranks_prog.fit_optimizer(), merging=False,
        train_vertices=world["ds_t"].train_vertices(), device="cpu",
        cache_policy="degree",
        cache_budget_bytes=ranks_prog.CACHE_ROWS * world["table"].shape[-1]
        * 4)
    stats = tt.fit(**ranks_prog.FIT)
    assert all(s.cache_hit_rows > 0 for s in stats)
    for r in res:
        got = r["fit cache"]
        assert got["cache"] == (1, tt.cache_store.c_max,
                                world["table"].shape[-1])
        assert got["hits"] == [s.cache_hit_rows for s in stats]
        np.testing.assert_allclose(got["losses"], [s.loss for s in stats],
                                   rtol=FIT_RTOL)


def test_stacked_fit_is_bitwise_unstacked(ranks):
    """pipeline_stack=2 under the mesh runs the same operations in the
    same order as one plan per dispatch."""
    res, _ = ranks
    for r in res:
        a, b = r["fit"], r["fit stack2"]
        assert a["losses"] == b["losses"]
        for x, y in zip(a["params"] + a["opt"], b["params"] + b["opt"]):
            assert torch.equal(x, y)


def test_merge_patterns_agree_under_a_slow_rank(ranks):
    """With merging on and rank 1's own steady times read 10x, 100x, ...
    slower, every rank feeds its merge controller the slowest rank's time
    (an all_reduce MAX), so all ranks walk the same merge patterns and
    their losses stay equal."""
    res, _ = ranks
    first = res[0]["merging"]
    assert first["patterns"][0] == WORLD
    for r in res:
        assert r["merging"]["patterns"] == first["patterns"]
        assert r["merging"]["losses"] == first["losses"]


@pytest.mark.parametrize("name", sorted(ranks_prog.FAULTS))
def test_faulted_sharded_run_is_bitwise(ranks, name):
    """Under the mesh, a comm drop, a comm delay and a prefetch-thread
    death ("comm"), or a NaN step ("nan"), fire on every rank, recover on
    every rank together, and leave losses, parameters and moments bitwise
    the straight sharded run's."""
    res, _ = ranks
    want_kinds = sorted({s.kind for s in ranks_prog.FAULTS[name]})
    for r in res:
        got, straight = r[("faulted", name)], r["fit"]
        assert got["fired"] == want_kinds
        assert max(got["attempts"]) >= 2
        assert got["rollbacks"] == (1 if name == "nan" else 0)
        assert got["losses"] == straight["losses"]
        assert got["global_step"] == straight["global_step"]
        for a, b in zip(got["params"] + got["opt"],
                        straight["params"] + straight["opt"]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("reader", ["port", "reference"])
def test_sharded_checkpoint_loads_in_both_packages(ranks, world, trees,
                                                   reader):
    """Rank 0 wrote the sharded fit's checkpoints (the others waited at a
    barrier); the newest loads bitwise into the emulated port Trainer's
    state and into the reference Trainer's."""
    res, out = ranks
    fit = res[0]["fit"]
    ck = str(out / "ckpt")
    tj, tt = _trainers(world, trees)
    if reader == "port":
        tree, step, extra = load_checkpoint(
            ck, {"params": tt.params, "opt": tt.opt_state})
        got = list(tree["params"].leaves())
        opt = list(tree["opt"].mu) + list(tree["opt"].nu)
        assert int(tree["opt"].step) == fit["step"]
        for a, b in zip(got + opt, fit["params"] + fit["opt"]):
            assert torch.equal(a, b)
    else:
        tree, step, extra = jax_ckpt.load_checkpoint(
            ck, {"params": tj.params, "opt": tj.opt_state})
        got = jax.tree.leaves(tree["params"])
        opt = jax.tree.leaves((tree["opt"].mu, tree["opt"].nu))
        assert len(got) == len(fit["params"])
        assert int(tree["opt"].step) == fit["step"]
        for a, b in zip(got + opt, fit["params"] + fit["opt"]):
            assert np.array_equal(np.asarray(a), b.numpy())
    assert step == fit["global_step"] == 9 and extra["epoch"] == 2


def test_elastic_shrink_under_a_mesh_raises(ranks):
    """A confirmed peer death under membership_mode="redistribute" raises
    NotImplementedError on every rank, as the reference does; rejoin is
    the mode for runs over a mesh."""
    res, _ = ranks
    for r in res:
        assert r["shrink"] is not None
        assert "elastic shrink under a device mesh" in r["shrink"]


def test_trainer_mesh_must_be_a_device_mesh(world, trees):
    """Trainer(mesh=...) takes a torch.distributed DeviceMesh and nothing
    else."""
    _, params = trees["sage"]
    with pytest.raises(TypeError, match="DeviceMesh"):
        torch_train.Trainer(
            graph=world["ds_t"].graph, labels=world["ds_t"].labels,
            part=world["part"], owner=world["owner"],
            local_idx=world["local_idx"], table=world["table"],
            cfg=_cfgs(world, "sage")[1], params=params, mesh=object(),
            device="cpu")
