"""The port's training slice against the JAX package's, at a small size
(products at scale 0.03, 4 shards, 2 layers, hidden 32, fanout 4).

Host-side planning is data movement and must match the reference bit for
bit: micrograph assignments, merges, gather plans and slot maps, iteration
plans of every strategy (with and without a cache index), budgeted plans
and epoch prefetch forecasts. Grads and losses are arithmetic on two
backends (XLA's CPU kernels and PyTorch's) that sum in different orders:

* one iteration's grads and loss: rtol 1e-5, atol 1e-7 (measured: losses
  equal, grads at most 3.0e-8 apart on |g| up to 0.43, in every mode, for
  sage and gcn);
* parameters after one fused AdamW step: rtol 1e-6, atol 1e-7 (measured
  3.7e-8) — the first step's update is ±lr · g/|g| and does not amplify
  grad differences;
* per-epoch losses of Trainer.fit over 3 epochs (9 AdamW steps): rtol
  1e-6 (measured 4.8e-8). From the second step on Adam's
  mhat / (sqrt(vhat) + eps) can magnify grad differences where vhat is
  small; over these steps it did not (ROADMAP Queue 3).

Within the port, the pipelined, synchronous and stacked loops run the same
operations in the same order and agree exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.cache as jax_cache
import repro.core.distributed as jax_engine
import repro.core.merging as jax_merging
import repro.core.micrograph as jax_micro
import repro.core.pregather as jax_pregather
import repro.core.strategies as jax_strategies
import repro.graph as jax_graph
import repro.models.gnn.models as jax_models
import repro.optim as jax_optim
import repro.train as jax_train
import repro_torch.cache as torch_cache
import repro_torch.core.distributed as engine
import repro_torch.core.merging as torch_merging
import repro_torch.core.micrograph as torch_micro
import repro_torch.core.pregather as torch_pregather
import repro_torch.core.strategies as torch_strategies
import repro_torch.graph as torch_graph
import repro_torch.models.gnn.models as torch_models
import repro_torch.optim as torch_optim
import repro_torch.train as torch_train
from repro_torch.features import FeatureStore
from repro_torch.graph.partition import community_partition, shard_features
from repro_torch.kernels import ops, ref

SHARDS = 4
GRAD_TOL = dict(rtol=1e-5, atol=1e-7)
STEP_TOL = dict(rtol=1e-6, atol=1e-7)
FIT_RTOL = 1e-6


@pytest.fixture(scope="module")
def world():
    ds_j = jax_graph.make_dataset("products", scale=0.03, seed=0)
    ds_t = torch_graph.make_dataset("products", scale=0.03, seed=0)
    part = community_partition(ds_t.communities, SHARDS)
    table, owner, local_idx = shard_features(ds_t.features, part, SHARDS)
    return dict(ds_j=ds_j, ds_t=ds_t, part=part, table=table, owner=owner,
                local_idx=local_idx, tv=ds_t.train_vertices())


def _cfgs(w, model="sage"):
    kw = dict(model=model, num_layers=2, hidden_dim=32,
              feature_dim=w["ds_t"].feature_dim,
              num_classes=w["ds_t"].num_classes, fanout=4)
    return jax_models.GNNConfig(**kw), torch_models.GNNConfig(**kw)


def _params(cfg_j):
    tree = jax_models.init_gnn(jax.random.PRNGKey(0), cfg_j)
    return tree, torch_models.params_from_jax(tree, device="cpu")


def _roots(w, seed, per_model=12):
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


def _caches(w, rows=64):
    """The same degree-policy cache selection in both packages."""
    pol = torch_cache.make_policy("degree", graph=w["ds_t"].graph,
                                  owner=w["owner"], num_shards=SHARDS)
    sel = [pol.select(s, rows) for s in range(SHARDS)]
    store_j = FeatureStore.from_array(w["table"], owner=w["owner"],
                                      local_idx=w["local_idx"])
    cj = jax_cache.CacheStore(SHARDS, w["table"].shape[-1], c_max=rows)
    ct = torch_cache.CacheStore(SHARDS, w["table"].shape[-1], c_max=rows,
                                device="cpu")
    rows_of = [store_j.take_global(ids) for ids in sel]
    cj.install(sel, rows_of)
    ct.install(sel, rows_of)
    return cj, ct


def _assert_plans_equal(pj, pt):
    for f in ("num_shards", "num_steps", "fanout", "num_layers", "pregather",
              "local_rows", "r_max", "batch_pad", "global_batch",
              "remote_rows_exact", "remote_rows_nodedup", "total_rows",
              "unique_rows", "step_unique_rows", "c_max", "cache_version",
              "cache_hit_rows"):
        assert getattr(pj, f) == getattr(pt, f), f
    for f in ("req", "labels", "weights", "true_counts"):
        a, b = getattr(pj, f), getattr(pt, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert (pj.step_req is None) == (pt.step_req is None)
    if pj.step_req is not None:
        assert np.array_equal(pj.step_req, pt.step_req)
    assert len(pj.hop_idx) == len(pt.hop_idx)
    for a, b in zip(pj.hop_idx, pt.hop_idx):
        assert a.dtype == b.dtype == np.int32 and np.array_equal(a, b)
    assert (pj.remote_ids is None) == (pt.remote_ids is None)
    for a, b in zip(pj.remote_ids or [], pt.remote_ids or []):
        assert np.array_equal(a, b)
    _assert_assignments_equal(pj.assignment, pt.assignment)


def _assert_assignments_equal(aj, at):
    assert (aj.num_shards, aj.num_steps) == (at.num_shards, at.num_steps)
    assert sorted(aj.groups) == sorted(at.groups)
    for k, gj in aj.groups.items():
        gt = at.groups[k]
        assert [d for d, _ in gj] == [d for d, _ in gt]
        for (_, rj), (_, rt) in zip(gj, gt):
            assert rj.dtype == rt.dtype and np.array_equal(rj, rt)


def _close(port_leaves, ref_tree, tol):
    ref_leaves = jax.tree.leaves(ref_tree)
    assert len(port_leaves) == len(ref_leaves)
    for a, b in zip(port_leaves, ref_leaves):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **tol)


# ---------------------------------------------------------------------------
# Host planning: bitwise
# ---------------------------------------------------------------------------

def test_assignments_and_merges_bitwise(world):
    w = world
    roots = _roots(w, 1)
    for name in ("hopgnn", "lo"):
        aj = getattr(jax_micro, f"{name}_assignment")(roots, w["part"])
        at = getattr(torch_micro, f"{name}_assignment")(roots, w["part"])
        _assert_assignments_equal(aj, at)
        assert np.array_equal(aj.root_counts(), at.root_counts())
        assert np.array_equal(aj.model_step_counts(), at.model_step_counts())
    _assert_assignments_equal(jax_micro.model_centric_assignment(roots),
                              torch_micro.model_centric_assignment(roots))
    aj = jax_micro.hopgnn_assignment(roots, w["part"])
    at = torch_micro.hopgnn_assignment(roots, w["part"])
    _assert_assignments_equal(jax_merging.merge_min_step(aj),
                              torch_merging.merge_min_step(at))
    _assert_assignments_equal(
        jax_merging.merge_random_step(aj, np.random.default_rng(3)),
        torch_merging.merge_random_step(at, np.random.default_rng(3)))
    for steps in (1, 2, 3):
        for sel in ("min", "random"):
            _assert_assignments_equal(
                jax_merging.fold_assignment(aj, steps, sel,
                                            np.random.default_rng(5)),
                torch_merging.fold_assignment(at, steps, sel,
                                              np.random.default_rng(5)))


def test_merging_controller_walk_bitwise(world):
    """The §5.3 examination on one scripted time sequence: both
    controllers merge, revert and freeze at the same epochs."""
    base_j = jax_micro.hopgnn_assignment(_roots(world, 2), world["part"])
    base_t = torch_micro.hopgnn_assignment(_roots(world, 2), world["part"])
    cj = jax_merging.MergingController(base=base_j)
    ct = torch_merging.MergingController(base=base_t)
    for t in (5.0, 4.0, 3.5, 3.9, 3.0):
        _assert_assignments_equal(cj.assignment_for_epoch(),
                                  ct.assignment_for_epoch())
        cj.record_epoch_time(t)
        ct.record_epoch_time(t)
        assert (cj.history, cj.frozen) == (ct.history, ct.frozen)
    fresh = torch_micro.hopgnn_assignment(_roots(world, 3), world["part"])
    _assert_assignments_equal(
        cj.apply_to(jax_micro.hopgnn_assignment(_roots(world, 3),
                                                world["part"])),
        ct.apply_to(fresh))


@pytest.mark.parametrize("cached", [False, True])
def test_gather_plan_and_slot_map_bitwise(world, cached):
    w = world
    rng = np.random.default_rng(4)
    V = w["owner"].size
    needed = [rng.integers(0, V, 900) for _ in range(SHARDS)]
    cj, ct = _caches(w) if cached else (None, None)
    L = w["table"].shape[1]
    pj = jax_pregather.build_gather_plan(
        needed, w["owner"], w["local_idx"], SHARDS, L,
        cache=None if cj is None else cj.index)
    pt = torch_pregather.build_gather_plan(
        needed, w["owner"], w["local_idx"], SHARDS, L,
        cache=None if ct is None else ct.index)
    oracle = jax_pregather._reference_build_gather_plan(
        needed, w["owner"], w["local_idx"], SHARDS, L,
        cache=None if cj is None else cj.index)
    for p in (pj, oracle):
        assert p.r_max == pt.r_max and p.c_max == pt.c_max
        assert np.array_equal(p.req, pt.req)
        assert np.array_equal(p.req_count, pt.req_count)
        assert (p.cache_hits is None) == (pt.cache_hits is None)
        if cached:
            assert np.array_equal(p.cache_hits, pt.cache_hits)
            assert pt.cache_hit_rows() > 0
    assert pt.remote_rows_padded() == pj.remote_rows_padded()
    for f in ("starts", "ids", "slots"):
        assert np.array_equal(getattr(pj.slot_map, f),
                              getattr(pt.slot_map, f)), f
    hops = [rng.choice(needed[1], 40), rng.choice(needed[1], 160)]
    wj = jax_pregather.workspace_indices(hops, 1, w["owner"], w["local_idx"],
                                         pj)
    wt = torch_pregather.workspace_indices(hops, 1, w["owner"],
                                           w["local_idx"], pt)
    wo = jax_pregather._reference_workspace_indices(
        hops, 1, w["owner"], w["local_idx"], oracle)
    for a, b, c in zip(wj, wt, wo):
        assert b.dtype == np.int32
        assert np.array_equal(a, b) and np.array_equal(c, b)
    with pytest.raises(torch_pregather.PlanOverflow) as e:
        torch_pregather.build_gather_plan(needed, w["owner"],
                                          w["local_idx"], SHARDS, L,
                                          r_max=1)
    assert e.value.field == "r_max"


@pytest.mark.parametrize("cached", [False, True])
@pytest.mark.parametrize("strategy,pregather", [
    ("hopgnn", True), ("hopgnn", False), ("model_centric", True),
    ("model_centric", False), ("lo", True)])
def test_plan_iteration_bitwise(world, strategy, pregather, cached):
    w = world
    roots = _roots(w, 5)
    cj, ct = _caches(w) if cached else (None, None)
    pj = jax_strategies.plan_iteration(**_plan_kwargs(
        w, w["ds_j"], roots, strategy=strategy, pregather=pregather,
        cache_index=None if cj is None else cj.index))
    pt = torch_strategies.plan_iteration(**_plan_kwargs(
        w, w["ds_t"], roots, strategy=strategy, pregather=pregather,
        cache_index=None if ct is None else ct.index))
    _assert_plans_equal(pj, pt)
    dj, dt = pj.device_args(), pt.device_args()
    assert sorted(dj) == sorted(dt)


def test_plan_iteration_with_executor_and_budget_bitwise(world):
    """The planning pool does not change plans, and ShapeBudget.plan
    buckets and re-buckets as the reference's does."""
    from concurrent.futures import ThreadPoolExecutor
    w = world
    bj, bt = jax_train.ShapeBudget(), torch_train.ShapeBudget()
    with ThreadPoolExecutor(3) as pool:
        for i, per_model in enumerate((12, 7, 30)):
            roots = _roots(w, 10 + i, per_model)
            pj = bj.plan(**_plan_kwargs(w, w["ds_j"], roots))
            pt = bt.plan(**_plan_kwargs(w, w["ds_t"], roots,
                                        executor=pool))
            _assert_plans_equal(pj, pt)
    assert bj.buckets == bt.buckets and bj.rebuckets == bt.rebuckets >= 1
    assert (bj.probes, bj.plans_built) == (bt.probes, bt.plans_built)
    assert bj.state_dict() == bt.state_dict()


def test_epoch_prefetcher_bitwise(world):
    w = world
    kw = dict(part=w["part"], owner=w["owner"], num_shards=SHARDS,
              num_layers=2, fanout=4,
              roots_for=lambda e, i: _roots(w, 100 * e + i),
              sample_seed_for=lambda e, i: e * 10_000 + i)
    pj = jax_cache.EpochPrefetcher(graph=w["ds_j"].graph, **kw)
    pt = torch_cache.EpochPrefetcher(graph=w["ds_t"].graph, **kw)
    for (ij, cj), (it, ct) in zip(pj.epoch_requests(1, 3),
                                  pt.epoch_requests(1, 3)):
        assert np.array_equal(ij, it) and np.array_equal(cj, ct)
    assert pj.covering_rows(1, 3) == pt.covering_rows(1, 3)


# ---------------------------------------------------------------------------
# Device engine
# ---------------------------------------------------------------------------

def test_emulated_comm_bitwise():
    rng = np.random.default_rng(6)
    n, L, d, T, r = 4, 11, 5, 3, 6
    table = rng.standard_normal((n, L, d)).astype(np.float32)
    req = rng.integers(0, L, (n, n, r)).astype(np.int32)
    step_req = rng.integers(0, L, (n, T, n, r)).astype(np.int32)
    cj, ct = jax_engine.EmulatedComm(), engine.EmulatedComm()
    tt = torch.from_numpy(table)
    assert np.array_equal(
        np.asarray(cj.exchange_global(jnp.asarray(table), jnp.asarray(req))),
        ct.exchange_global(tt, torch.from_numpy(req)).numpy())
    inc_j = cj.exchange_indices_batched_global(jnp.asarray(step_req))
    inc_t = ct.exchange_indices_batched_global(torch.from_numpy(step_req))
    assert np.array_equal(np.asarray(inc_j), inc_t.numpy())
    assert np.array_equal(
        np.asarray(cj.serve_features_batched_global(jnp.asarray(table),
                                                    inc_j)),
        ct.serve_features_batched_global(tt, inc_t).numpy())
    for t in range(T):
        for s in range(n):
            assert np.array_equal(
                np.asarray(cj.serve_step_global(jnp.asarray(table), inc_j,
                                                t, s)),
                ct.serve_step_global(tt, inc_t, t, s).numpy())
    grads = [[torch.from_numpy(rng.standard_normal(3).astype(np.float32))]
             for _ in range(n)]
    denom = torch.tensor(7.0)
    want = (((grads[0][0] + grads[1][0]) + grads[2][0]) + grads[3][0]) / 7
    assert torch.equal(ct.grad_mean_global(grads, denom)[0], want)


def test_gnn_loss_and_grads_match_reference(world):
    cfg_j, cfg_t = _cfgs(world)
    tree, params = _params(cfg_j)
    rng = np.random.default_rng(7)
    B = 6
    feats = [rng.standard_normal((B * 4 ** h, cfg_t.feature_dim))
             .astype(np.float32) for h in range(3)]
    labels = rng.integers(0, cfg_t.num_classes, B).astype(np.int32)
    weight = np.array([1, 1, 0, 1, 0, 1], np.float32)
    for wgt in (None, weight):
        def f(p):
            return jax_models.gnn_loss(
                p, cfg_j, [jnp.asarray(x) for x in feats],
                jnp.asarray(labels),
                weight=None if wgt is None else jnp.asarray(wgt))[0]
        lj, gj = jax.jit(jax.value_and_grad(f))(tree)
        lt, _ = torch_models.gnn_loss(
            params, cfg_t, [torch.from_numpy(x) for x in feats],
            torch.from_numpy(labels),
            weight=None if wgt is None else torch.from_numpy(wgt))
        gt = torch.autograd.grad(lt, params.leaves())
        np.testing.assert_allclose(float(lt.detach()), float(lj),
                                   **GRAD_TOL)
        _close(gt, gj, GRAD_TOL)
    acc_j = jax_models.gnn_accuracy(tree, cfg_j,
                                    [jnp.asarray(x) for x in feats],
                                    jnp.asarray(labels))
    acc_t = torch_models.gnn_accuracy(params, cfg_t,
                                      [torch.from_numpy(x) for x in feats],
                                      torch.from_numpy(labels))
    assert float(acc_j) == float(acc_t)


def _plans(w, roots, **kw):
    pj = jax_strategies.plan_iteration(**_plan_kwargs(w, w["ds_j"], roots,
                                                      **kw))
    pt = torch_strategies.plan_iteration(**_plan_kwargs(w, w["ds_t"], roots,
                                                        **kw))
    return pj, pt


MODES = {"pregather": dict(pregather=True, fold=None),
         "per-step folded": dict(pregather=False, fold=True),
         "per-step unfolded": dict(pregather=False, fold=False)}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("model", ["sage", "gcn", "gat", "deepgcn", "film"])
def test_run_iteration_matches_reference(world, model, mode):
    w = world
    m = MODES[mode]
    cfg_j, cfg_t = _cfgs(w, model)
    tree, params = _params(cfg_j)
    pj, pt = _plans(w, _roots(w, 8), pregather=m["pregather"])
    engine.clear_compile_cache()
    gj, lj = jax_engine.run_iteration(tree, jnp.asarray(w["table"]), pj,
                                      cfg_j, fold_returns=m["fold"])
    gt, lt = engine.run_iteration(params, w["table"], pt, cfg_t,
                                  fold_returns=m["fold"], device="cpu")
    np.testing.assert_allclose(float(lt), float(lj), **GRAD_TOL)
    _close(gt, gj, GRAD_TOL)
    # the record the reference writes for this call, with its kind
    assert engine.trace_log()[-1][:3] == ("emulated", model, m["pregather"])


def test_run_iteration_with_cache_matches_reference(world):
    w = world
    cfg_j, cfg_t = _cfgs(w)
    tree, params = _params(cfg_j)
    cj, ct = _caches(w)
    roots = _roots(w, 9)
    pj, pt = _plans(w, roots, cache_index=cj.index)
    assert pt.cache_hit_rows > 0 and pt.c_max == 64
    gj, lj = jax_engine.run_iteration(tree, jnp.asarray(w["table"]), pj,
                                      cfg_j, cache=cj.device_table)
    gt, lt = engine.run_iteration(params, w["table"], pt, cfg_t,
                                  cache=ct.device_table, device="cpu")
    np.testing.assert_allclose(float(lt), float(lj), **GRAD_TOL)
    _close(gt, gj, GRAD_TOL)
    # the cache is numerics-neutral within the port too
    _, pt0 = _plans(w, roots)
    g0, l0 = engine.run_iteration(params, w["table"], pt0, cfg_t,
                                  device="cpu")
    np.testing.assert_allclose(float(l0), float(lt), **GRAD_TOL)
    for a, b in zip(g0, gt):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **GRAD_TOL)
    with pytest.raises(ValueError, match="no cache table"):
        engine.run_iteration(params, w["table"], pt, cfg_t, device="cpu")


def test_prepare_checks_indices_and_shapes(world):
    w = world
    cfg_j, cfg_t = _cfgs(w)
    _, params = _params(cfg_j)
    _, pt = _plans(w, _roots(w, 11))
    bad = dataclasses.replace(pt, hop_idx=[h.copy() for h in pt.hop_idx])
    bad.hop_idx[2][0, 0, 0] = pt.local_rows + SHARDS * pt.r_max
    with pytest.raises(IndexError, match="hop_idx"):
        engine.run_iteration(params, w["table"], bad, cfg_t, device="cpu")
    bad = dataclasses.replace(pt, req=pt.req.copy())
    bad.req[0, 1, 0] = pt.local_rows
    with pytest.raises(IndexError, match="req"):
        engine.run_iteration(params, w["table"], bad, cfg_t, device="cpu")
    with pytest.raises(ValueError, match="does not match"):
        engine.run_iteration(params, w["table"][:, :-1], pt, cfg_t,
                             device="cpu")


def test_fused_train_step_matches_iteration_plus_update(world):
    """run_train_step equals run_iteration + optimizer.update exactly in
    the port, and the reference's fused step within STEP_TOL."""
    w = world
    cfg_j, cfg_t = _cfgs(w)
    tree, _ = _params(cfg_j)
    pj, pt = _plans(w, _roots(w, 12))
    opt_t = torch_optim.adamw(3e-3, weight_decay=1e-4, grad_clip=1.0)
    opt_j = jax_optim.adamw(3e-3, weight_decay=1e-4, grad_clip=1.0)
    pa = torch_models.params_from_jax(tree, device="cpu")
    pb = torch_models.params_from_jax(tree, device="cpu")
    sa, sb = opt_t.init(pa), opt_t.init(pb)
    for _ in range(2):
        pa, sa, la = engine.run_train_step(pa, sa, w["table"], pt, cfg_t,
                                           opt_t, device="cpu")
        g, lb = engine.run_iteration(pb, w["table"], pt, cfg_t,
                                     device="cpu")
        pb, sb = opt_t.update(g, sb, pb)
        assert torch.equal(la, lb)
        for x, y in zip(pa.leaves() + sa.mu + sa.nu,
                        pb.leaves() + sb.mu + sb.nu):
            assert torch.equal(x, y)
    assert int(sa.step) == 2
    p1 = torch_models.params_from_jax(tree, device="cpu")
    s1 = opt_t.init(p1)
    p1, s1, l1 = engine.run_train_step(p1, s1, w["table"], pt, cfg_t, opt_t,
                                       device="cpu")
    pj1, sj1, lj1 = jax_engine.run_train_step(
        jax.tree.map(jnp.array, tree), opt_j.init(tree),
        jnp.asarray(w["table"]), pj, cfg_j, opt_j)
    np.testing.assert_allclose(float(l1), float(lj1), **GRAD_TOL)
    _close(p1.leaves(), pj1, STEP_TOL)
    _close(s1.mu, sj1.mu, GRAD_TOL)


def test_gather_rows_guard_and_plain_gradient():
    """On the CPU the plain gather is differentiable; the condition under
    which the CUDA path refuses (a table that requires grad, grad mode on)
    is what the engine never meets: its workspace requires no grad."""
    table = torch.randn(5, 3, requires_grad=True)
    idx = torch.tensor([4, 0, 4], dtype=torch.int32)
    out = ops.gather_rows(table, idx)
    out.sum().backward()
    assert torch.equal(table.grad[:, 0], torch.tensor([1., 0, 0, 0, 2]))
    assert torch.equal(out, ref.gather_rows_ref(table, idx))
    assert ops.needs_backward(table)
    with torch.no_grad():
        assert not ops.needs_backward(table)
    assert not ops.needs_backward(table.detach())
    with pytest.raises(RuntimeError, match="no backward"):
        ops._forward_only(table, "gather_rows")


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------

def _trainers(w, cfgs, tree, **kw):
    cfg_j, cfg_t = cfgs
    kw.setdefault("merging", False)
    common = dict(graph=None, labels=w["ds_t"].labels, part=w["part"],
                  owner=w["owner"], local_idx=w["local_idx"],
                  table=w["table"], train_vertices=w["tv"])
    key = ("cos", 3e-3, 2, 9)
    opt_j = jax_optim.adamw(jax_optim.cosine_schedule(3e-3, 2, 9),
                            weight_decay=1e-4, grad_clip=1.0, key=key)
    opt_t = torch_optim.adamw(torch_optim.cosine_schedule(3e-3, 2, 9),
                              weight_decay=1e-4, grad_clip=1.0, key=key)
    tj = jax_train.Trainer(**dict(common, graph=w["ds_j"].graph), cfg=cfg_j,
                           optimizer=opt_j, params=tree, resilience=False,
                           **kw)
    def make_t(**extra):
        args = dict(common, graph=w["ds_t"].graph, cfg=cfg_t,
                    optimizer=opt_t, device="cpu",
                    params=torch_models.params_from_jax(tree, device="cpu"))
        return torch_train.Trainer(**dict(args, **kw, **extra))
    return tj, make_t


@pytest.fixture
def scripted_merging(monkeypatch):
    """Pin the §5.3 walk: each controller sees epoch times 3, 2, 1, ... —
    always improving, so it merges one step per epoch in both packages."""
    for mod in (jax_merging, torch_merging):
        orig = mod.MergingController.record_epoch_time

        def scripted(self, seconds, _orig=orig):
            _orig(self, 3.0 - len(self._times))
        monkeypatch.setattr(mod.MergingController, "record_epoch_time",
                            scripted)


def test_trainer_fit_matches_reference_with_merging(world, scripted_merging):
    """Per-epoch losses of the port's pipelined and synchronous loops are
    identical, and agree with the reference's Trainer within FIT_RTOL,
    through a merge pattern of 4, 3 and 2 steps."""
    w = world
    cfgs = _cfgs(w)
    tree, _ = _params(cfgs[0])
    tj, make_t = _trainers(w, cfgs, tree, merging=True)
    st_j = tj.fit(epochs=3, iters_per_epoch=3, batch_per_model=8)
    tp = make_t(pipeline=True)
    st_p = tp.fit(epochs=3, iters_per_epoch=3, batch_per_model=8)
    ts = make_t(pipeline=False)
    st_s = ts.fit(epochs=3, iters_per_epoch=3, batch_per_model=8)
    assert [s.num_steps for s in st_j] == [s.num_steps for s in st_p] \
        == [s.num_steps for s in st_s] == [4, 3, 2]
    assert [s.loss for s in st_p] == [s.loss for s in st_s]
    for a, b in zip(tp.params.leaves(), ts.params.leaves()):
        assert torch.equal(a, b)
    np.testing.assert_allclose([s.loss for s in st_p],
                               [s.loss for s in st_j], rtol=FIT_RTOL)
    assert [s.remote_rows for s in st_p] == [s.remote_rows for s in st_j]
    assert all(s.pipelined for s in st_p) and not st_s[0].pipelined
    assert tp.global_step == tj.global_step == 9
    assert tp.evaluate() == pytest.approx(tj.evaluate(), abs=1 / 256)


FIT_VARIANTS = {
    "model_centric": ("sage", dict(strategy="model_centric")),
    "lo": ("sage", dict(strategy="lo")),
    "hopgnn_per_step": ("sage", dict(pregather=False)),
    "stack2": ("sage", dict(pipeline_stack=2)),
    "gcn_lfu": ("gcn", dict(cache_policy="lfu",
                            cache_budget_bytes=64 * 100 * 4)),
}


@pytest.mark.parametrize("name", sorted(FIT_VARIANTS))
def test_trainer_fit_variants_match_reference(world, name):
    """Per-epoch losses of other strategies, modes, models and the LFU
    cache against the reference's Trainer within FIT_RTOL (merging off),
    with equal remote rows and cache hits."""
    w = world
    model, kw = FIT_VARIANTS[name]
    cfgs = _cfgs(w, model)
    tree, _ = _params(cfgs[0])
    tj, make_t = _trainers(w, cfgs, tree, **kw)
    st_j = tj.fit(epochs=3, iters_per_epoch=3, batch_per_model=8)
    tt = make_t()
    st_t = tt.fit(epochs=3, iters_per_epoch=3, batch_per_model=8)
    np.testing.assert_allclose([s.loss for s in st_t],
                               [s.loss for s in st_j], rtol=FIT_RTOL)
    for f in ("remote_rows", "cache_hit_rows", "num_steps"):
        assert [getattr(s, f) for s in st_t] == \
            [getattr(s, f) for s in st_j], f
    assert tt.global_step == tj.global_step == 9


def test_trainer_cache_on_matches_reference(world):
    w = world
    cfgs = _cfgs(w)
    tree, _ = _params(cfgs[0])
    kw = dict(cache_policy="degree", cache_budget_bytes=64 * 100 * 4)
    tj, make_t = _trainers(w, cfgs, tree, **kw)
    st_j = tj.fit(epochs=2, iters_per_epoch=3, batch_per_model=8)
    tt = make_t()
    st_t = tt.fit(epochs=2, iters_per_epoch=3, batch_per_model=8)
    assert all(s.cache_hit_rows > 0 for s in st_t)
    assert [s.cache_hit_rows for s in st_t] == \
        [s.cache_hit_rows for s in st_j]
    assert [s.remote_rows for s in st_t] == [s.remote_rows for s in st_j]
    np.testing.assert_allclose([s.loss for s in st_t],
                               [s.loss for s in st_j], rtol=FIT_RTOL)


def test_stacked_dispatch_matches_unstacked(world):
    """pipeline_stack=2 over 5 iterations (dispatches of 2, 2, 1) runs the
    same operations in the same order as one plan per dispatch."""
    w = world
    cfgs = _cfgs(w)
    tree, _ = _params(cfgs[0])
    _, make_t = _trainers(w, cfgs, tree)
    t1, tk = make_t(), make_t(pipeline_stack=2)
    st1 = t1.fit(epochs=2, iters_per_epoch=5, batch_per_model=8)
    stk = tk.fit(epochs=2, iters_per_epoch=5, batch_per_model=8)
    assert [s.loss for s in st1] == [s.loss for s in stk]
    for a, b in zip(t1.params.leaves(), tk.params.leaves()):
        assert torch.equal(a, b)
    assert t1.global_step == tk.global_step == 10
    kinds = {r[0] for r in engine.trace_log()}
    assert {"emulated-fused", "emulated-fused-stacked"} <= kinds


def test_unfused_loop_matches_fused(world):
    w = world
    cfgs = _cfgs(w)
    tree, _ = _params(cfgs[0])
    _, make_t = _trainers(w, cfgs, tree, pregather=False)
    ta, tb = make_t(pipeline=False, fused=False), make_t(pipeline=False)
    sa = ta.fit(epochs=1, iters_per_epoch=3, batch_per_model=8)
    sb = tb.fit(epochs=1, iters_per_epoch=3, batch_per_model=8)
    assert [s.loss for s in sa] == [s.loss for s in sb]
    with pytest.raises(ValueError, match="fused"):
        make_t(pipeline=True, fused=False)


def test_no_traces_after_epoch0(world):
    engine.clear_compile_cache()
    w = world
    cfgs = _cfgs(w)
    tree, _ = _params(cfgs[0])
    _, make_t = _trainers(w, cfgs, tree)
    tt = make_t()
    stats = tt.fit(epochs=3, iters_per_epoch=3, batch_per_model=8)
    assert stats[0].traces == 1
    assert stats[1].traces == 0 and stats[2].traces == 0
    assert all(s.compile_free for s in stats)
    assert tt._uploader.uploads == 9 and tt._uploader.shape_changes == 0
    assert tt.budget.rebuckets == 0
    assert all(s.plans_built == 3 and s.plan_time_s > 0 for s in stats)


# Measured on the CPU (torch 2.13.0, jax 0.9.0): over these 80 AdamW
# steps the per-epoch losses drifted from the reference's by at most
# 3.0e-6 relative (epoch 7), and the final parameters by at most 4.6e-7 of
# each leaf's largest |value|. Adam's mhat / (sqrt(vhat) + eps) magnifies
# the float32 summation-order differences where vhat is small, so this
# bound belongs to this run length only; the 9-step fits above keep
# FIT_RTOL.
LONG_FIT = dict(epochs=10, iters_per_epoch=8, batch_per_model=32)
LONG_FIT_RTOL = 1e-5
LONG_FIT_PARAM_RTOL = 5e-6


def test_long_fit_matches_reference(world):
    """Trainer.fit over 10 epochs x 8 iterations (80 AdamW steps, cosine
    schedule, clipping, merging off) against the reference's Trainer:
    per-epoch losses within LONG_FIT_RTOL, final parameters within
    LONG_FIT_PARAM_RTOL of each leaf's largest |value|, equal eval
    accuracy."""
    w = world
    cfg_j, cfg_t = _cfgs(w)
    tree, _ = _params(cfg_j)
    total = LONG_FIT["epochs"] * LONG_FIT["iters_per_epoch"]
    key = ("cos", 3e-3, 10, total)
    common = dict(labels=w["ds_t"].labels, part=w["part"], owner=w["owner"],
                  local_idx=w["local_idx"], table=w["table"],
                  train_vertices=w["tv"], merging=False)
    tj = jax_train.Trainer(
        graph=w["ds_j"].graph, cfg=cfg_j, params=tree, resilience=False,
        optimizer=jax_optim.adamw(jax_optim.cosine_schedule(3e-3, 10, total),
                                  weight_decay=1e-4, grad_clip=1.0, key=key),
        **common)
    tt = torch_train.Trainer(
        graph=w["ds_t"].graph, cfg=cfg_t, device="cpu",
        params=torch_models.params_from_jax(tree, device="cpu"),
        optimizer=torch_optim.adamw(
            torch_optim.cosine_schedule(3e-3, 10, total), weight_decay=1e-4,
            grad_clip=1.0, key=key), **common)
    st_j = tj.fit(**LONG_FIT)
    st_t = tt.fit(**LONG_FIT)
    assert tt.global_step == tj.global_step == total
    np.testing.assert_allclose([s.loss for s in st_t],
                               [s.loss for s in st_j], rtol=LONG_FIT_RTOL)
    want = torch_models.params_from_jax(tj.params, device="cpu")
    for a, b in zip(tt.params.leaves(), want.leaves()):
        a, b = a.detach(), b.detach()
        assert float((a - b).abs().max()) <= \
            LONG_FIT_PARAM_RTOL * float(b.abs().max())
    assert tt.evaluate() == tj.evaluate()
