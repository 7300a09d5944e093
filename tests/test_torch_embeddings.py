"""The port's precomputed-embedding tier (repro_torch.serve.embeddings) and
the GNNServer modes that read it, at a small size (products at scale 0.01,
SAGE 2 layers, hidden 32, fanout 10, as tests/test_torch_serve.py).

The table is the serving forward run over every vertex, so it is held to
the reference's ``precompute_embeddings`` at 1e-5 (two BLAS libraries
summing in different orders) and to the port's own fresh compute at 1e-5
(another batch size). A precomputed answer is a table row, bit for bit.
The reference's own versions of the mode tests compare exactly and fail
under jax 0.9.0 (ROADMAP Queue 3); these hold the port at tolerance.
"""
import jax
import numpy as np
import pytest
import torch

import repro.features as jax_features
import repro.graph as jax_graph
import repro.models.gnn.models as jax_models
import repro.serve as jax_serve
import repro_torch.graph as torch_graph
import repro_torch.graph.partition as torch_partition
import repro_torch.models.gnn.models as torch_models
from repro_torch.features import FeatureStore
from repro_torch.graph.sampler import sample_tree_block
from repro_torch.kernels import gather_agg as cuda_kernels
from repro_torch.serve import (EmbeddingTable, GNNServer, embeddings_dir,
                               load_embeddings, precompute_embeddings)

TOL = dict(rtol=1e-5, atol=1e-5)
SHARDS = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes on a few cores: one
    intra-op thread per worker keeps PyTorch's thread pools from
    oversubscribing them (the Trainer's planner pool still runs)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
        ds_j=ds_j, ds_t=ds_t, table=table, owner=owner, local_idx=local_idx,
        tree=tree, cfg_j=jax_models.GNNConfig(**kw),
        cfg_t=torch_models.GNNConfig(**kw),
        params=torch_models.params_from_jax(tree, device="cpu"),
        store=FeatureStore.from_array(table, owner=owner,
                                      local_idx=local_idx))


@pytest.fixture(scope="module")
def snapshot(world, tmp_path_factory):
    """The port's table, precomputed once at params_step 7."""
    d = tmp_path_factory.mktemp("emb")
    precompute_embeddings(world["ds_t"].graph, world["store"],
                          world["params"], world["cfg_t"], ckpt_dir=d,
                          params_step=7, chunk=128)
    return d


def offline_logits(w, nodes) -> np.ndarray:
    """The port's forward on the CPU, outside the server: each root's
    tree sampled with the serving seed, its rows read, the model run."""
    blk = sample_tree_block(w["ds_t"].graph, np.asarray(nodes, np.int64),
                            w["cfg_t"].num_layers, w["cfg_t"].fanout,
                            seed=999)
    feats = [torch.from_numpy(w["store"].take_global(ids))
             for ids in blk.hops]
    with torch.inference_mode():
        return torch_models.gnn_forward(w["params"], w["cfg_t"],
                                        feats).numpy()


def _server(w, **kw):
    return GNNServer(graph=w["ds_t"].graph, params=w["params"],
                     cfg=w["cfg_t"], store=w["store"], device="cpu", **kw)


def test_table_matches_reference_precompute(world, snapshot, tmp_path):
    jax_serve.precompute_embeddings(
        world["ds_j"].graph,
        jax_features.FeatureStore.from_array(
            world["table"], owner=world["owner"],
            local_idx=world["local_idx"]),
        world["tree"], world["cfg_j"], ckpt_dir=tmp_path, params_step=7,
        chunk=128)
    ref = jax_serve.load_embeddings(tmp_path, params_step=7,
                                    sample_seed=999)
    mine = load_embeddings(snapshot, params_step=7, sample_seed=999)
    assert mine.num_vertices == ref.num_vertices == 2450
    assert mine.extra == ref.extra and mine.step == ref.step == 7
    np.testing.assert_allclose(mine.logits, ref.logits, **TOL)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_snapshot_loads_in_the_other_package(world, snapshot, tmp_path,
                                             writer):
    """The snapshot is a checkpoint in the shared layout: either package's
    loader reads the other's table bit for bit, with its stamp."""
    if writer == "torch":
        ref = jax_serve.load_embeddings(snapshot, params_step=7)
        mine = load_embeddings(snapshot, params_step=7)
    else:
        logits = np.random.default_rng(0).standard_normal(
            (50, 47)).astype(np.float32)
        from repro.checkpoint import save_checkpoint as jax_save
        jax_save(jax_serve.embeddings_dir(tmp_path), 3, {"logits": logits},
                 extra={"params_step": 3, "sample_seed": 999})
        ref = jax_serve.load_embeddings(tmp_path, params_step=3)
        mine = load_embeddings(tmp_path, params_step=3, sample_seed=999)
        assert np.array_equal(mine.logits, logits)
    assert np.array_equal(mine.logits, np.asarray(ref.logits))
    assert mine.extra == ref.extra


def test_table_matches_fresh_compute(world, snapshot):
    tab = load_embeddings(snapshot, params_step=7)
    nodes = [3, 14, 15, 92, 2449]
    srv = _server(world, mode="fresh")
    np.testing.assert_allclose(tab.lookup(nodes), srv.predict(nodes), **TOL)
    np.testing.assert_allclose(tab.lookup(nodes),
                               offline_logits(world, nodes), **TOL)
    assert embeddings_dir(snapshot).is_dir()


@pytest.mark.parametrize("kw,match", [
    (dict(params_step=8), "stale"),
    (dict(params_step=7, sample_seed=123), "seed"),
])
def test_stale_snapshot_refused(snapshot, kw, match):
    with pytest.raises(ValueError, match=match):
        load_embeddings(snapshot, **kw)
    assert isinstance(load_embeddings(snapshot, allow_stale=True, **kw),
                      EmbeddingTable)


def test_missing_snapshot_and_server_guards(world, snapshot, tmp_path):
    with pytest.raises(FileNotFoundError):
        load_embeddings(tmp_path / "nowhere")
    with pytest.raises(ValueError, match="stale"):
        _server(world, ckpt_dir=snapshot, params_step=8)
    with pytest.raises(ValueError, match="precomputed"):
        _server(world, mode="precomputed")
    srv = _server(world, ckpt_dir=snapshot, params_step=8,
                  allow_stale_embeddings=True)
    assert srv.embeddings.extra["params_step"] == 7


def test_precomputed_mode_serves_table_rows(world, snapshot):
    srv = _server(world, ckpt_dir=snapshot, params_step=7,
                  mode="precomputed")
    nodes = [3, 14, 15, 92]
    cuda_kernels.reset_launches()
    out = srv.predict(nodes)
    tab = load_embeddings(snapshot, params_step=7)
    assert np.array_equal(out, tab.lookup(nodes))
    np.testing.assert_allclose(out, offline_logits(world, nodes), **TOL)
    st = srv.stats()
    assert srv.fresh_batches == 0 and st["precomputed_hits"] == len(nodes)
    assert cuda_kernels.launches["gather_rows"] == 0   # no device work


def test_auto_mode_promotes_hot_vertices(world, snapshot):
    srv = _server(world, ckpt_dir=snapshot, params_step=7, mode="auto",
                  cache_budget_bytes=256 * 1024, cache_refresh_every=1)
    srv.warmup()
    fresh_after_warmup = srv.fresh_batches
    # cold vertex → precomputed tier, the table's row bit for bit
    t = srv.submit(42)
    srv.loop.pump(wait_s=0.0)
    t.wait(1.0)
    assert t.via == "precomputed"
    assert srv.fresh_batches == fresh_after_warmup
    assert np.array_equal(t.result, srv.embeddings.lookup([42])[0])
    # hammer the same vertex: the LFU admits its feature row and later
    # requests flip to fresh compute (current params, cached features)
    for _ in range(6):
        srv.predict([42])
    t2 = srv.submit(42)
    srv.loop.pump(wait_s=0.0)
    t2.wait(1.0)
    assert t2.via == "fresh"
    np.testing.assert_allclose(t2.result, offline_logits(world, [42])[0],
                               **TOL)
    assert srv.retraces_since_warmup == 0
    # without a hot tier, auto answers every vertex from the table
    cold = _server(world, ckpt_dir=snapshot, params_step=7, mode="auto")
    assert cold._precomputed_mask(np.arange(5)).all()
