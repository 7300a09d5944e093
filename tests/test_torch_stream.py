"""Streamed (out-of-core) training in the port against the JAX package's
and against the port's own resident training, at a small size (products at
scale 0.03, 4 shards, SAGE 2 layers, hidden 32, fanout 4).

A tiered FeatureStore switches planning to streamed mode: each plan
carries its feature blocks, host-gathered through the store's tiers. That
is data movement, so streamed plans (``feat_local``, ``feat_fetch``, hop
indices, ``l_max`` and the per-tier row counts) are bitwise the
reference's. Each tree position then reads the same values as in the
resident path, so a streamed iteration, a streamed ``Trainer.fit``, a
faulted streamed fit and a streamed resume are bitwise the port's resident
(or fault-free, or straight) runs. Against the reference's streamed
Trainer the losses agree at the fit tolerance of tests/test_torch_train.py
(rtol 1e-6: two backends sum in different orders).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.cache as jax_cache
import repro.core.distributed as jax_engine
import repro.core.strategies as jax_strategies
import repro.features as jax_features
import repro.graph as jax_graph
import repro.models.gnn.models as jax_models
import repro.optim as jax_optim
import repro.train as jax_train
import repro_torch.cache as torch_cache
import repro_torch.core.distributed as engine
import repro_torch.core.strategies as torch_strategies
import repro_torch.graph as torch_graph
import repro_torch.models.gnn.models as torch_models
import repro_torch.optim as torch_optim
import repro_torch.train as torch_train
from repro_torch.core.pregather import PlanOverflow
from repro_torch.features import FeatureStore
from repro_torch.graph.partition import community_partition, shard_features
from repro_torch.resilience import FaultPlan, FaultSpec

SHARDS = 4
GRAD_TOL = dict(rtol=1e-5, atol=1e-7)
FIT_RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test worker (the suite runs several)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    ds_j = jax_graph.make_dataset("products", scale=0.03, seed=0)
    ds_t = torch_graph.make_dataset("products", scale=0.03, seed=0)
    part = community_partition(ds_t.communities, SHARDS)
    table, owner, local_idx = shard_features(ds_t.features, part, SHARDS)
    return dict(ds_j=ds_j, ds_t=ds_t, part=part, table=table, owner=owner,
                local_idx=local_idx, tv=ds_t.train_vertices())


def _cfgs(w):
    kw = dict(model="sage", num_layers=2, hidden_dim=32,
              feature_dim=w["ds_t"].feature_dim,
              num_classes=w["ds_t"].num_classes, fanout=4)
    return jax_models.GNNConfig(**kw), torch_models.GNNConfig(**kw)


def _tree(cfg_j):
    return jax_models.init_gnn(jax.random.PRNGKey(0), cfg_j)


def _tiered(w, package=FeatureStore, frac=3):
    """An in-RAM tiered store over the test table: a hot tier of a
    ``frac``-th of the table, the rest read from the backing arrays."""
    return package.from_array(w["table"], owner=w["owner"],
                              local_idx=w["local_idx"],
                              host_budget_bytes=w["table"].nbytes // frac)


def _spilled(w, directory, frac=4):
    """The features spilled to per-shard .npy files under ``directory``
    (checksums on, the source attached for repair)."""
    return FeatureStore.build(w["ds_t"].features, w["part"], SHARDS,
                              directory=str(directory),
                              host_budget_bytes=w["table"].nbytes // frac)


def _roots(w, seed, per_model=8):
    rng = np.random.default_rng(seed)
    return [rng.choice(w["tv"], per_model, replace=False)
            for _ in range(SHARDS)]


def _plan_kwargs(w, ds, roots, **kw):
    out = dict(graph=ds.graph, labels=ds.labels, part=w["part"],
               owner=w["owner"], local_idx=w["local_idx"],
               local_rows=w["table"].shape[1], roots_per_model=roots,
               num_layers=2, fanout=4, sample_seed=7)
    out.update(kw)
    return out


def _make_trainer(w, cfg_t, tree, **kw):
    kw.setdefault("optimizer", torch_optim.adam(5e-3))
    kw.setdefault("merging", False)
    kw.setdefault("table", w["table"])
    return torch_train.Trainer(
        graph=w["ds_t"].graph, labels=w["ds_t"].labels, part=w["part"],
        owner=w["owner"], local_idx=w["local_idx"], cfg=cfg_t,
        params=torch_models.params_from_jax(tree, device="cpu"),
        train_vertices=w["tv"], device="cpu", **kw)


def _assert_same_state(a, b):
    for x, y in zip(a.params.leaves() + a.opt_state.mu + a.opt_state.nu,
                    b.params.leaves() + b.opt_state.mu + b.opt_state.nu):
        assert torch.equal(x, y)
    assert int(a.opt_state.step) == int(b.opt_state.step)


# ---------------------------------------------------------------------------
# Planning: bitwise the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cached", [False, True])
def test_streamed_plan_bitwise_reference(world, cached):
    w = world
    roots = _roots(w, 5, per_model=12)
    kw_j, kw_t = {}, {}
    if cached:
        pol = torch_cache.make_policy("degree", graph=w["ds_t"].graph,
                                      owner=w["owner"], num_shards=SHARDS)
        sel = [pol.select(s, 64) for s in range(SHARDS)]
        rows = [FeatureStore.from_array(
            w["table"], owner=w["owner"],
            local_idx=w["local_idx"]).take_global(i) for i in sel]
        cj = jax_cache.CacheStore(SHARDS, w["table"].shape[-1], c_max=64)
        ct = torch_cache.CacheStore(SHARDS, w["table"].shape[-1], c_max=64,
                                    device="cpu")
        cj.install(sel, rows)
        ct.install(sel, rows)
        kw_j, kw_t = dict(cache_index=cj.index), dict(cache_index=ct.index)
    pj = jax_strategies.plan_iteration(**_plan_kwargs(
        w, w["ds_j"], roots, feature_store=_tiered(w, jax_features
                                                   .FeatureStore), **kw_j))
    pt = torch_strategies.plan_iteration(**_plan_kwargs(
        w, w["ds_t"], roots, feature_store=_tiered(w), **kw_t))
    assert pj.streamed and pt.streamed and pt.l_max == pj.l_max > 0
    for f in ("r_max", "batch_pad", "c_max", "remote_rows_exact",
              "unique_rows", "cache_hit_rows", "tier_stats"):
        assert getattr(pj, f) == getattr(pt, f), f
    assert pt.tier_stats["tier2_rows"] > 0         # a cold hot tier
    for f in ("feat_local", "feat_fetch", "labels", "weights"):
        a, b = getattr(pj, f), getattr(pt, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    for a, b in zip(pj.hop_idx, pt.hop_idx):
        assert b.dtype == np.int32 and np.array_equal(a, b)
    assert sorted(pt.device_args()) == sorted(pj.device_args()) == [
        "feat_fetch", "feat_local", "hop_idx", "labels", "weights"]


def test_streamed_budget_and_l_max_overflow_match_reference(world):
    """l_max overflows explicitly, and ShapeBudget buckets it per pattern
    with the reference's headroom and floor, state round trip included."""
    w = world
    roots = _roots(w, 6)
    with pytest.raises(PlanOverflow) as e:
        torch_strategies.plan_iteration(**_plan_kwargs(
            w, w["ds_t"], roots, feature_store=_tiered(w), l_max=1))
    assert e.value.field == "l_max" and e.value.needed > 1
    bj, bt = jax_train.ShapeBudget(), torch_train.ShapeBudget()
    sj = _tiered(w, jax_features.FeatureStore)
    st = _tiered(w)
    for i, per_model in enumerate((8, 20)):
        roots = _roots(w, 20 + i, per_model)
        pj = bj.plan(**_plan_kwargs(w, w["ds_j"], roots, feature_store=sj))
        pt = bt.plan(**_plan_kwargs(w, w["ds_t"], roots, feature_store=st))
        assert pt.l_max == pj.l_max and np.array_equal(pj.feat_local,
                                                       pt.feat_local)
    assert bt.l_buckets == bj.l_buckets and bt.rebuckets == bj.rebuckets
    assert bt.bucket_shapes(SHARDS)[3] == bt.l_buckets[SHARDS]
    assert (bt.probes, bt.plans_built) == (bj.probes, bj.plans_built)
    assert bt.state_dict() == bj.state_dict()
    fresh = torch_train.ShapeBudget()
    fresh.load_state(bt.state_dict())
    assert fresh.l_buckets == bt.l_buckets and fresh.l_max == bt.l_max


def test_epoch_touched_bitwise_reference(world):
    w = world
    kw = dict(part=w["part"], owner=w["owner"], num_shards=SHARDS,
              num_layers=2, fanout=4,
              roots_for=lambda e, i: _roots(w, 100 * e + i),
              sample_seed_for=lambda e, i: e * 10_000 + i)
    pj = jax_cache.EpochPrefetcher(graph=w["ds_j"].graph, **kw)
    pt = torch_cache.EpochPrefetcher(graph=w["ds_t"].graph, **kw)
    got = pt.epoch_touched(1, 3)
    assert sum(ids.size for ids, _ in got) > 0
    for (ij, cj), (it, ct) in zip(pj.epoch_touched(1, 3), got):
        assert np.array_equal(ij, it) and np.array_equal(cj, ct)
        assert ct.dtype == np.int64


def test_streamed_plan_requires_pregather(world):
    with pytest.raises(ValueError, match="pregather"):
        torch_strategies.plan_iteration(**_plan_kwargs(
            world, world["ds_t"], _roots(world, 1),
            feature_store=_tiered(world), pregather=False))


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------

def test_streamed_iteration_bitwise_resident(world):
    """The same values per tree position: grads and loss equal the
    resident iteration's exactly (and the reference's at GRAD_TOL)."""
    w = world
    cfg_j, cfg_t = _cfgs(w)
    tree = _tree(cfg_j)
    params = torch_models.params_from_jax(tree, device="cpu")
    roots = _roots(w, 8)
    pr = torch_strategies.plan_iteration(**_plan_kwargs(w, w["ds_t"], roots))
    ps = torch_strategies.plan_iteration(**_plan_kwargs(
        w, w["ds_t"], roots, feature_store=_tiered(w)))
    gr, lr = engine.run_iteration(params, w["table"], pr, cfg_t,
                                  device="cpu")
    engine.clear_compile_cache()
    gs, ls = engine.run_iteration(params, None, ps, cfg_t, device="cpu")
    assert torch.equal(lr, ls)
    for a, b in zip(gr, gs):
        assert torch.equal(a, b)
    assert engine.trace_log()[-1][:3] == ("emulated", "sage", True)
    pj = jax_strategies.plan_iteration(**_plan_kwargs(
        w, w["ds_j"], roots,
        feature_store=_tiered(w, jax_features.FeatureStore)))
    gj, lj = jax_engine.run_iteration(tree, None, pj, cfg_j)
    np.testing.assert_allclose(float(ls), float(lj), **GRAD_TOL)
    for a, b in zip(gs, jax.tree.leaves(gj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL)


def test_missing_table_rejected_for_resident_plan(world):
    w = world
    _, cfg_t = _cfgs(w)
    params = torch_models.init_gnn(cfg_t, device="cpu")
    plan = torch_strategies.plan_iteration(**_plan_kwargs(w, w["ds_t"],
                                                          _roots(w, 2)))
    with pytest.raises(ValueError, match="streamed"):
        engine.run_iteration(params, None, plan, cfg_t, device="cpu")


def test_streamed_plan_blocks_checked(world):
    """A streamed plan's tree positions are held to the compacted
    workspace height, and its blocks to the plan's shapes."""
    w = world
    _, cfg_t = _cfgs(w)
    params = torch_models.init_gnn(cfg_t, device="cpu")
    ps = torch_strategies.plan_iteration(**_plan_kwargs(
        w, w["ds_t"], _roots(w, 3), feature_store=_tiered(w)))
    bad = dataclasses.replace(ps, hop_idx=[h.copy() for h in ps.hop_idx])
    bad.hop_idx[1][0, 0, 0] = ps.l_max + ps.c_max + SHARDS * ps.r_max
    with pytest.raises(IndexError, match="hop_idx"):
        engine.run_iteration(params, None, bad, cfg_t, device="cpu")
    bad = dataclasses.replace(ps, feat_local=ps.feat_local[:, :-1])
    with pytest.raises(ValueError, match="feat_local"):
        engine.run_iteration(params, None, bad, cfg_t, device="cpu")


def test_uploader_stages_streamed_blocks(world):
    """The pipeline commits a streamed plan's feature blocks with its other
    device args, checked against the budget's l_max bucket."""
    from repro_torch.train.pipeline import PlanUploader
    w = world
    budget = torch_train.ShapeBudget()
    plan = budget.plan(**_plan_kwargs(w, w["ds_t"], _roots(w, 4),
                                      feature_store=_tiered(w)))
    up = PlanUploader(budget=budget, device="cpu")
    up.commit(plan)
    dev = plan.committed["dev"]
    assert torch.equal(dev["feat_local"], torch.from_numpy(plan.feat_local))
    assert torch.equal(dev["feat_fetch"], torch.from_numpy(plan.feat_fetch))
    assert "req" not in dev and up.uploads == 1
    bad = dataclasses.replace(plan, l_max=plan.l_max * 2, committed=None)
    with pytest.raises(AssertionError, match="drifted"):
        up.commit(bad)


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------

_TRAINER_CASES = {
    "plain": dict(),
    "cache_on": dict(cache_policy="degree", cache_budget_bytes=1 << 14),
    "stacked": dict(pipeline_stack=2),
}


@pytest.mark.parametrize("name", sorted(_TRAINER_CASES))
def test_streamed_trainer_bitwise_resident(world, name):
    """A tiered store (streamed engine, readahead on the cache thread)
    trains bitwise as the resident store does."""
    w = world
    cfg_j, cfg_t = _cfgs(w)
    tree = _tree(cfg_j)
    kw = _TRAINER_CASES[name]
    tr = _make_trainer(w, cfg_t, tree, **kw)
    st_r = tr.fit(epochs=2, iters_per_epoch=3, batch_per_model=8)
    ts = _make_trainer(w, cfg_t, tree, table=_tiered(w), **kw)
    assert ts.streamed and ts.table is None and not tr.streamed
    st_s = ts.fit(epochs=2, iters_per_epoch=3, batch_per_model=8)
    assert [s.loss for s in st_s] == [s.loss for s in st_r]
    _assert_same_state(tr, ts)
    assert all(s.streamed for s in st_s) and not any(s.streamed
                                                     for s in st_r)
    # tier accounting flows: gathers happened, readahead warmed tier 1
    assert st_s[0].tier1_rows + st_s[0].tier2_rows > 0
    assert st_s[1].tier1_rows > 0 and st_s[0].upload_bytes > 0
    assert st_s[1].traces == 0
    if name == "cache_on":
        assert all(s.cache_hit_rows > 0 for s in st_s)


def test_streamed_trainer_rejects_per_step(world):
    cfg_j, cfg_t = _cfgs(world)
    with pytest.raises(ValueError, match="pregather"):
        _make_trainer(world, cfg_t, _tree(cfg_j), table=_tiered(world),
                      pregather=False)


def test_streamed_trainer_on_disk_shards(world, tmp_path):
    """Features only on disk (mmap tier 2) under a quarter-table hot tier,
    checksums on: losses and state bitwise the resident run's."""
    w = world
    cfg_j, cfg_t = _cfgs(w)
    tree = _tree(cfg_j)
    store = _spilled(w, tmp_path)
    assert store.spilled and store.checksums_enabled
    ts = _make_trainer(w, cfg_t, tree, table=store)
    st_s = ts.fit(epochs=2, iters_per_epoch=3, batch_per_model=8)
    tr = _make_trainer(w, cfg_t, tree)
    st_r = tr.fit(epochs=2, iters_per_epoch=3, batch_per_model=8)
    assert [s.loss for s in st_s] == [s.loss for s in st_r]
    _assert_same_state(tr, ts)
    assert st_s[0].tier2_rows > 0 and st_s[0].crc_failures == 0


def test_streamed_trainer_matches_reference(world):
    """The port's streamed Trainer against the reference's, on the same
    tiered store layout, weights and cosine AdamW: losses within FIT_RTOL,
    tier traffic and remote rows equal."""
    w = world
    cfg_j, cfg_t = _cfgs(w)
    tree = _tree(cfg_j)
    key = ("cos", 3e-3, 2, 9)
    opt_j = jax_optim.adamw(jax_optim.cosine_schedule(3e-3, 2, 9),
                            weight_decay=1e-4, grad_clip=1.0, key=key)
    opt_t = torch_optim.adamw(torch_optim.cosine_schedule(3e-3, 2, 9),
                              weight_decay=1e-4, grad_clip=1.0, key=key)
    tj = jax_train.Trainer(
        graph=w["ds_j"].graph, labels=w["ds_j"].labels, part=w["part"],
        owner=w["owner"], local_idx=w["local_idx"],
        table=_tiered(w, jax_features.FeatureStore), cfg=cfg_j,
        optimizer=opt_j, params=tree, merging=False, train_vertices=w["tv"],
        resilience=False)
    st_j = tj.fit(epochs=3, iters_per_epoch=3, batch_per_model=8)
    tt = _make_trainer(w, cfg_t, tree, table=_tiered(w), optimizer=opt_t,
                       resilience=False)
    st_t = tt.fit(epochs=3, iters_per_epoch=3, batch_per_model=8)
    assert tj.streamed and tt.streamed
    np.testing.assert_allclose([s.loss for s in st_t],
                               [s.loss for s in st_j], rtol=FIT_RTOL)
    for f in ("remote_rows", "tier1_rows", "tier2_rows", "upload_bytes"):
        assert [getattr(s, f) for s in st_t] == \
            [getattr(s, f) for s in st_j], f


def test_disk_corruption_repaired_bitwise(world, tmp_path):
    """A corrupted disk chunk injected at an epoch boundary is caught by
    the store's checksums and repaired from the source before any plan
    reads it: the run is bitwise the fault-free one."""
    w = world
    cfg_j, cfg_t = _cfgs(w)
    tree = _tree(cfg_j)
    clean = _make_trainer(w, cfg_t, tree, table=_spilled(w, tmp_path / "a"))
    st_c = clean.fit(epochs=2, iters_per_epoch=3, batch_per_model=8)
    fp = FaultPlan([FaultSpec("disk_corrupt", epoch=1, shard=0, row=0,
                              rows=3)], seed=5)
    faulted = _make_trainer(w, cfg_t, tree,
                            table=_spilled(w, tmp_path / "b"))
    with fp.active():
        st_f = faulted.fit(epochs=2, iters_per_epoch=3, batch_per_model=8)
    assert [k for k, *_ in fp.fired] == ["disk_corrupt"]
    assert [s.loss for s in st_f] == [s.loss for s in st_c]
    _assert_same_state(clean, faulted)
    assert st_f[1].crc_failures >= 1 and st_f[1].repaired_rows >= 1
    assert st_c[1].crc_failures == 0


def test_streamed_resume_bitwise(world, tmp_path):
    """A streamed run resumed from its epoch-1 checkpoint finishes bitwise
    as the straight run, planning straight into the saved l_max buckets
    (no probe, no new signature)."""
    import shutil
    w = world
    cfg_j, cfg_t = _cfgs(w)
    tree = _tree(cfg_j)
    full = _make_trainer(w, cfg_t, tree, table=_tiered(w),
                         ckpt_dir=str(tmp_path / "full"))
    st_full = full.fit(epochs=3, iters_per_epoch=3, batch_per_model=8)
    part = tmp_path / "part"
    part.mkdir()
    step = 2 * 3
    for ext in ("npz", "json"):
        name = f"step-{step:08d}.{ext}"
        shutil.copy(tmp_path / "full" / name, part / name)
    (part / "latest").write_text(str(step))
    res = _make_trainer(w, cfg_t, tree, table=_tiered(w),
                        ckpt_dir=str(part))
    st_res = res.fit(epochs=3, iters_per_epoch=3, batch_per_model=8,
                     resume=True)
    assert [s.epoch for s in st_res] == [2]
    assert st_res[0].loss == st_full[-1].loss
    _assert_same_state(full, res)
    assert res.budget.probes == 0 and res.budget.l_buckets == \
        full.budget.l_buckets
