"""The port's serving slice against the JAX package's, at a small size
(products at scale 0.01, SAGE, 2 layers, hidden 32, fanout 10).

Host-side planning is data movement and must match the reference bit for
bit: the dataset, the partition, the sampled trees and the inference plan.
Served logits are arithmetic on two BLAS libraries and match at 1e-5.
"""
import jax
import numpy as np
import pytest
import torch

import repro.cache as jax_cache
import repro.core as jax_core
import repro.features as jax_features
import repro.graph as jax_graph
import repro.graph.partition as jax_partition
import repro.graph.sampler as jax_sampler
import repro.models.gnn.models as jax_models
import repro.serve as jax_serve
import repro_torch.cache as torch_cache
import repro_torch.core as torch_core
import repro_torch.features as torch_features
import repro_torch.graph as torch_graph
import repro_torch.graph.partition as torch_partition
import repro_torch.graph.sampler as torch_sampler
import repro_torch.models.gnn.models as torch_models
import repro_torch.serve as torch_serve
from repro_torch.kernels import gather_agg as cuda_kernels
from repro_torch.train.budget import ShapeBudget

TOL = dict(rtol=1e-5, atol=1e-5)
SHARDS = 4


@pytest.fixture(scope="module")
def world():
    ds_j = jax_graph.make_dataset("products", scale=0.01, seed=0)
    ds_t = torch_graph.make_dataset("products", scale=0.01, seed=0)
    part = torch_partition.community_partition(ds_t.communities, SHARDS)
    table, owner, local_idx = torch_partition.shard_features(
        ds_t.features, part, SHARDS)
    kw = dict(model="sage", num_layers=2, hidden_dim=32,
              feature_dim=ds_t.feature_dim, num_classes=ds_t.num_classes,
              fanout=10)
    tree = jax_models.init_gnn(jax.random.PRNGKey(0),
                               jax_models.GNNConfig(**kw))
    return dict(
        ds_j=ds_j, ds_t=ds_t, part=part, table=table, owner=owner,
        local_idx=local_idx, tree=tree,
        cfg_j=jax_models.GNNConfig(**kw), cfg_t=torch_models.GNNConfig(**kw),
        params=torch_models.params_from_jax(tree, device="cpu"))


def _servers(w, **kw):
    """The reference server and the port's, on the same graph, features,
    partition and parameters."""
    sj = jax_serve.GNNServer(
        graph=w["ds_j"].graph, params=w["tree"], cfg=w["cfg_j"],
        store=jax_features.FeatureStore.from_array(
            w["table"], owner=w["owner"], local_idx=w["local_idx"]), **kw)
    st = torch_serve.GNNServer(
        graph=w["ds_t"].graph, params=w["params"], cfg=w["cfg_t"],
        store=torch_features.FeatureStore.from_array(
            w["table"], owner=w["owner"], local_idx=w["local_idx"]),
        device="cpu", **kw)
    return sj, st


# ----------------------------------------------------------------------
# Host side: bitwise
# ----------------------------------------------------------------------

def test_dataset_and_partition_bitwise(world):
    a, b = world["ds_j"], world["ds_t"]
    assert a.num_vertices == b.num_vertices == 2450
    for name in ("features", "labels", "communities", "train_mask"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    np.testing.assert_array_equal(a.graph.indptr, b.graph.indptr)
    np.testing.assert_array_equal(a.graph.indices, b.graph.indices)
    np.testing.assert_array_equal(
        jax_partition.community_partition(a.communities, SHARDS),
        world["part"])
    for x, y in zip(jax_partition.shard_features(a.features, world["part"],
                                                 SHARDS),
                    (world["table"], world["owner"], world["local_idx"])):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("seed", [None, 999])
def test_sampler_bitwise(world, seed):
    roots = np.array([0, 7, 7, 1234, 2449], np.int64)

    def kw():
        return (dict(seed=seed) if seed is not None
                else dict(rng=np.random.default_rng(5)))
    a = jax_sampler.sample_tree_block(world["ds_j"].graph, roots, 3, 10,
                                      **kw())
    b = torch_sampler.sample_tree_block(world["ds_t"].graph, roots, 3, 10,
                                        **kw())
    assert len(a.hops) == len(b.hops) == 4
    for x, y in zip(a.hops, b.hops):
        np.testing.assert_array_equal(x, y)


def _installed(mod, ids, d):
    store = (mod.CacheStore(1, d, c_max=64) if mod is jax_cache else
             mod.CacheStore(1, d, c_max=64, device="cpu"))
    store.install([ids], [np.zeros((ids.size, d), np.float32)])
    return store.index


@pytest.mark.parametrize("cached", [False, True])
def test_plan_inference_bitwise(world, cached):
    nodes = np.array([5, 9, 21, 600], np.int64)
    kw = dict(sample_seed=999, batch_pad=8)
    if cached:
        ids = np.arange(0, 2450, 50, dtype=np.int64)
        kw_j = dict(kw, cache_index=_installed(jax_cache, ids, 100))
        kw_t = dict(kw, cache_index=_installed(torch_cache, ids, 100))
    else:
        kw_j = kw_t = kw
    a = jax_core.plan_inference(world["ds_j"].graph, nodes, 2, 10, **kw_j)
    b = torch_core.plan_inference(world["ds_t"].graph, nodes, 2, 10, **kw_t)
    np.testing.assert_array_equal(a.fetch_ids, b.fetch_ids)
    for x, y in zip(a.hop_idx, b.hop_idx):
        assert y.dtype == np.int32
        np.testing.assert_array_equal(x, y)
    assert (a.c_max, a.cache_hit_rows) == (b.c_max, b.cache_hit_rows)
    assert (b.cache_hit_rows > 0) == cached


def test_plan_inference_overflow(world):
    with pytest.raises(torch_core.PlanOverflow):
        torch_core.plan_inference(world["ds_t"].graph, np.arange(9), 2, 10,
                                  sample_seed=999, batch_pad=8)


# ----------------------------------------------------------------------
# Served logits: port vs reference
# ----------------------------------------------------------------------

def test_predict_matches_reference_cache_off(world):
    sj, st = _servers(world, max_batch=16)
    sj.warmup()
    st.warmup()
    nodes = [3, 14, 15, 92, 65, 35, 2449]
    np.testing.assert_allclose(st.predict(nodes), sj.predict(nodes), **TOL)
    assert st.stats()["fresh_requests"] == len(nodes)


def test_predict_matches_reference_across_cache_installs(world):
    sj, st = _servers(world, max_batch=16, cache_budget_bytes=64 * 1024,
                      cache_refresh_every=2)
    sj.warmup()
    st.warmup()
    rng = np.random.default_rng(1)
    for i in range(6):
        nodes = np.unique(rng.integers(0, 2450, 12)).tolist()
        np.testing.assert_allclose(st.predict(nodes), sj.predict(nodes),
                                   err_msg=f"batch {i}", **TOL)
    a, b = sj.stats(), st.stats()
    assert b["cache_installs"] > 0 and b["cache_hit_rows"] > 0
    for k in ("cache_installs", "cache_hit_rows", "fetch_rows",
              "cached_rows", "serve_rungs"):
        assert a[k] == b[k], k


def test_predict_from_spilled_store(world, tmp_path):
    """Features resolved through a spilled store (a 64 KiB host hot tier
    over per-shard .npy files on disk): answers bitwise the port's offline
    forward over the same store, and within TOL of the reference's served
    logits over a resident table."""
    w = world
    spilled = torch_features.FeatureStore.build(
        w["ds_t"].features, w["part"], SHARDS, directory=str(tmp_path),
        host_budget_bytes=64 * 1024)
    assert not spilled.resident and spilled.spilled
    st = torch_serve.GNNServer(graph=w["ds_t"].graph, params=w["params"],
                               cfg=w["cfg_t"], store=spilled, max_batch=16,
                               cache_budget_bytes=128 * 1024, device="cpu")
    sj, _ = _servers(w, max_batch=16)
    st.warmup()
    sj.warmup()
    nodes = [7, 11, 200, 41, 2449, 1234]
    out = st.predict(nodes)
    cfg = w["cfg_t"]
    blk = torch_sampler.sample_tree_block(
        w["ds_t"].graph, np.asarray(nodes, np.int64), cfg.num_layers,
        cfg.fanout, seed=999)
    feats = [torch.from_numpy(spilled.take_global(ids)) for ids in blk.hops]
    with torch.inference_mode():
        want = torch_models.gnn_forward(w["params"], cfg, feats).numpy()
    assert np.array_equal(out, want)
    np.testing.assert_allclose(out, sj.predict(nodes), **TOL)
    assert spilled.stats.t2_rows > 0          # reads reached the disk tier


def test_zero_retraces_after_warmup_and_no_launches_on_cpu(world):
    cuda_kernels.reset_launches()
    torch_core.clear_compile_cache()
    _, st = _servers(world, max_batch=16, cache_budget_bytes=64 * 1024,
                     cache_refresh_every=3)
    w = st.warmup()
    assert w["rungs"] == [8, 16] and w["traces"] == 2
    rng = np.random.default_rng(2)
    for _ in range(12):
        st.predict(rng.integers(0, 2450, int(rng.integers(1, 17))).tolist())
    assert st.retraces_since_warmup == 0
    assert st.stats()["cache_installs"] > 0
    assert cuda_kernels.launches["gather_rows"] == 0


def test_edge_scores_and_background_loop(world):
    sj, st = _servers(world, max_batch=8)
    sj.warmup()
    st.warmup()
    tj = sj.submit((3, 14))
    sj.loop.pump(wait_s=0.0)
    st.start()
    try:
        t = st.submit((3, 14))
        score = t.wait(60.0)
        logits = st.predict([3, 14])
    finally:
        st.stop()
    assert t.via == "edge"
    assert score == pytest.approx(float(np.dot(logits[0], logits[1])),
                                  rel=1e-6)
    assert score == pytest.approx(tj.wait(60.0), rel=1e-5, abs=1e-5)


def test_hop_indices_checked_against_workspace(world):
    fn = torch_core.get_compiled_inference(world["cfg_t"])
    cache = torch.zeros((0, 100))
    fetched = np.zeros((8, 100), np.float32)
    hops = [np.zeros(8 * 10 ** h, np.int32) for h in range(3)]
    assert fn(world["params"], cache, fetched, *hops).shape == (8, 47)
    hops[2][5] = 8
    with pytest.raises(IndexError, match="outside the workspace"):
        fn(world["params"], cache, fetched, *hops)


def test_server_refuses_what_the_slice_lacks(world, tmp_path):
    """The precomputed tier needs a snapshot: a ckpt_dir without one, or
    mode="precomputed" without a ckpt_dir, is refused (the tier itself is
    tests/test_torch_embeddings.py's)."""
    kw = dict(graph=world["ds_t"].graph, params=world["params"],
              cfg=world["cfg_t"], store=world["ds_t"].features, device="cpu")
    with pytest.raises(FileNotFoundError, match="embedding snapshot"):
        torch_serve.GNNServer(ckpt_dir=str(tmp_path / "snapshots"), **kw)
    with pytest.raises(ValueError, match="ckpt_dir"):
        torch_serve.GNNServer(mode="precomputed", **kw)
    with pytest.raises(ValueError, match="unknown serve mode"):
        torch_serve.GNNServer(mode="cold", **kw)
    with pytest.raises(ValueError, match="params lie on"):
        torch_serve.GNNServer(**dict(kw, device="meta"))


def test_budget_serve_buckets_roundtrip():
    b = ShapeBudget()
    bp = b.serve_batch_pad(13)
    assert bp == 16
    u = b.serve_fetch_pad(bp, 700)
    assert u >= 700 and (u & (u - 1)) == 0
    assert b.serve_fetch_pad(bp, u + 1) > u
    b2 = ShapeBudget()
    b2.load_state(b.state_dict())
    assert b2.serve_rungs() == b.serve_rungs()
