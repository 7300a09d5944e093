"""The port's P³ baseline and byte accounting against the JAX package's, at
a small size (products at scale 0.03, 4 shards, 2 layers, hidden 32,
fanout 4).

``comm_model`` is host arithmetic, so every byte count (and the modeled
Ethernet seconds) equals the reference's exactly, and ``plan_p3`` is
bitwise the reference's. ``run_p3_iteration`` is arithmetic on two
backends that sum in other orders: its loss and grads agree with the
reference's at the training tolerance of tests/test_torch_train.py (rtol
1e-5, atol 1e-7; measured: losses equal, grads at most 3.0e-8 apart for
gcn, sage and gat), and with the port's own model-centric iteration at
the reference's P³ parity bound (rtol 2e-3, atol 2e-5,
tests/test_core.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.comm_model as jax_comm
import repro.core.p3 as jax_p3
import repro.graph as jax_graph
import repro.models.gnn.models as jax_models
import repro_torch.core.comm_model as comm
import repro_torch.core.distributed as engine
import repro_torch.core.p3 as p3
import repro_torch.core.strategies as torch_strategies
import repro_torch.graph as torch_graph
import repro_torch.models.gnn.models as torch_models
from repro.graph.sampler import micrograph_split as jax_micrograph_split
from repro_torch.graph.partition import community_partition, shard_features
from repro_torch.graph.sampler import micrograph_split

SHARDS = 4
GRAD_TOL = dict(rtol=1e-5, atol=1e-7)
P3_TOL = dict(rtol=2e-3, atol=2e-5)     # tests/test_core.py, P³ vs MC


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


def _roots(w, seed=0, per_model=12):
    rng = np.random.default_rng(seed)
    return [rng.choice(w["tv"], per_model, replace=False)
            for _ in range(SHARDS)]


def _cfgs(w, model):
    kw = dict(model=model, num_layers=2, hidden_dim=32,
              feature_dim=w["ds_t"].feature_dim,
              num_classes=w["ds_t"].num_classes, fanout=4)
    return jax_models.GNNConfig(**kw), torch_models.GNNConfig(**kw)


def _plans(w, roots, hidden=32, seed=7):
    pj = jax_p3.plan_p3(w["ds_j"].graph, w["ds_j"].labels, roots, 2, 4,
                        hidden_dim=hidden, sample_seed=seed)
    pt = p3.plan_p3(w["ds_t"].graph, w["ds_t"].labels, roots, 2, 4,
                    hidden_dim=hidden, sample_seed=seed)
    return pj, pt


# ---------------------------------------------------------------------------
# comm_model: equal byte counts
# ---------------------------------------------------------------------------

def _accounting(mod, w, blocks, micros, shard_of, remote_rows):
    """Every comm_model function of ``mod`` on the same inputs."""
    spec = mod.ModelSpec(feature_dim=w["ds_t"].feature_dim, hidden_dim=32,
                         num_layers=2, param_bytes=123_456)
    n = SHARDS
    return {
        "model_centric": mod.model_centric_bytes(blocks, w["owner"],
                                                 list(range(n)), spec, n),
        "model_centric_micro": mod.model_centric_bytes(
            micros, w["owner"], shard_of, spec, n),
        "naive_fc": mod.naive_fc_bytes(micros, w["owner"], spec, n),
        "hopgnn": mod.hopgnn_bytes(remote_rows, n, spec, n),
        "hopgnn_spmd": mod.hopgnn_bytes(remote_rows, n, spec, n,
                                        replicated_params=True),
        "hopgnn_cached": mod.hopgnn_bytes_cached(
            remote_rows // 2, remote_rows - remote_rows // 2, n, spec, n,
            refresh_rows=500, iters_per_refresh=8),
        "p3": mod.p3_bytes(blocks, w["owner"], list(range(n)), spec, n),
        "p3_micro": mod.p3_bytes(micros, w["owner"], shard_of, spec, n),
        "lo": mod.lo_bytes(spec, n),
        "tiered": mod.tiered_feature_bytes(1000, 300, 200, 123_456,
                                           spec.feature_dim, iters=7),
        "alpha": mod.alpha_ratio(remote_rows, spec.feature_dim,
                                 spec.param_bytes),
        "alpha_cached": mod.alpha_ratio_cached(remote_rows // 2,
                                               spec.feature_dim,
                                               spec.param_bytes,
                                               refresh_rows=500,
                                               iters_per_refresh=8),
        "topology": [mod.topology_bytes(b) for b in blocks],
        "remote_unique": [mod._remote_unique_rows(micros, w["owner"],
                                                  shard_of, dd)
                          for dd in (False, True)],
    }


STRATEGIES = ["model_centric", "model_centric_micro", "naive_fc", "hopgnn",
              "hopgnn_spmd", "hopgnn_cached", "p3", "p3_micro", "lo",
              "tiered", "alpha", "alpha_cached", "topology", "remote_unique"]


@pytest.fixture(scope="module")
def accounting(world):
    w = world
    roots = _roots(w)
    pj, pt = _plans(w, roots)
    plan = torch_strategies.plan_iteration(
        graph=w["ds_t"].graph, labels=w["ds_t"].labels, part=w["part"],
        owner=w["owner"], local_idx=w["local_idx"],
        local_rows=w["table"].shape[1], roots_per_model=roots, num_layers=2,
        fanout=4, strategy="hopgnn", sample_seed=7)
    micros_t = [m for b in pt.blocks for m in micrograph_split(b)]
    micros_j = [m for b in pj.blocks for m in jax_micrograph_split(b)]
    shard_of = [int(w["part"][m.hops[0][0]]) for m in micros_t]
    return (_accounting(jax_comm, w, pj.blocks, micros_j, shard_of,
                        plan.remote_rows_exact),
            _accounting(comm, w, pt.blocks, micros_t, shard_of,
                        plan.remote_rows_exact))


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_comm_model_equals_reference(accounting, strategy):
    want, got = (a[strategy] for a in accounting)
    assert got == want
    if isinstance(got, dict) and "total" in got:
        assert got["total"] > 0
        eth = comm.FABRICS["ethernet_10g"]
        ref = jax_comm.FABRICS["ethernet_10g"]
        assert eth == comm.Fabric("ethernet_10g", 10e9 / 8, 50e-6)
        assert eth.seconds(got["total"], 3) == ref.seconds(want["total"], 3)


def test_fabrics_carry_no_tpu_link():
    assert set(comm.FABRICS) == {"ethernet_10g"}
    assert "tpu_ici" in jax_comm.FABRICS      # the reference keeps its own


# ---------------------------------------------------------------------------
# P³ plan and iteration
# ---------------------------------------------------------------------------

def test_plan_p3_bitwise_reference(world):
    pj, pt = _plans(world, _roots(world, 3))
    assert (pj.num_shards, pj.num_layers, pj.fanout, pj.hidden_dim) == \
        (pt.num_shards, pt.num_layers, pt.fanout, pt.hidden_dim)
    for bj, bt in zip(pj.blocks, pt.blocks):
        assert bj.fanout == bt.fanout and len(bj.hops) == len(bt.hops)
        for a, b in zip(bj.hops, bt.hops):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    for a, b in zip(pj.labels, pt.labels):
        assert a.dtype == b.dtype == np.int32 and np.array_equal(a, b)
    assert pt.activation_bytes() == pj.activation_bytes() > 0


def test_activation_bytes_scale_with_hidden_dim(world):
    """P³'s activation bytes scale with the hidden width, never the
    feature width (the sensitivity of paper §7.2): 16× for 16 → 256."""
    roots = _roots(world)
    small = p3.plan_p3(world["ds_t"].graph, world["ds_t"].labels, roots, 2,
                       4, hidden_dim=16, sample_seed=1)
    big = p3.plan_p3(world["ds_t"].graph, world["ds_t"].labels, roots, 2, 4,
                     hidden_dim=256, sample_seed=1)
    assert big.activation_bytes() == 16 * small.activation_bytes()


@pytest.mark.parametrize("model", ["gcn", "sage", "gat"])
def test_p3_iteration_matches_reference(world, model):
    w = world
    cfg_j, cfg_t = _cfgs(w, model)
    tree = jax_models.init_gnn(jax.random.PRNGKey(0), cfg_j)
    params = torch_models.params_from_jax(tree, device="cpu")
    pj, pt = _plans(w, _roots(w))
    gj, lj = jax_p3.run_p3_iteration(tree, jnp.asarray(w["ds_j"].features),
                                     pj, cfg_j)
    gt, lt = p3.run_p3_iteration(params, w["ds_t"].features, pt, cfg_t,
                                 device="cpu")
    np.testing.assert_allclose(float(lt), float(lj), **GRAD_TOL)
    leaves = jax.tree.leaves(gj)
    assert len(gt) == len(leaves) == len(params.leaves())
    for a, b in zip(gt, leaves):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL)


@pytest.mark.parametrize("model", ["gcn", "sage", "gat"])
def test_p3_matches_model_centric(world, model):
    """Within the port: P³'s dim-sliced input layer is placement only, so
    its grads equal the model-centric engine's on the same roots."""
    w = world
    cfg_j, cfg_t = _cfgs(w, model)
    tree = jax_models.init_gnn(jax.random.PRNGKey(1), cfg_j)
    params = torch_models.params_from_jax(tree, device="cpu")
    roots = _roots(w, 2)
    mc = torch_strategies.plan_iteration(
        graph=w["ds_t"].graph, labels=w["ds_t"].labels, part=w["part"],
        owner=w["owner"], local_idx=w["local_idx"],
        local_rows=w["table"].shape[1], roots_per_model=roots, num_layers=2,
        fanout=4, strategy="model_centric", sample_seed=7)
    gm, lm = engine.run_iteration(params, w["table"], mc, cfg_t,
                                  device="cpu")
    _, pt = _plans(w, roots)
    g3, l3 = p3.run_p3_iteration(params, torch.from_numpy(
        w["ds_t"].features), pt, cfg_t)
    assert abs(float(lm) - float(l3)) < 1e-4
    for a, b in zip(gm, g3):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **P3_TOL)


@pytest.mark.parametrize("model", ["deepgcn", "film"])
def test_p3_rejects_norm_fronted_models(world, model):
    _, cfg_t = _cfgs(world, model)
    params = torch_models.init_gnn(cfg_t, device="cpu")
    _, pt = _plans(world, _roots(world))
    with pytest.raises(p3.P3Unsupported):
        p3.run_p3_iteration(params, world["ds_t"].features, pt, cfg_t,
                            device="cpu")
    assert p3.SUPPORTED == jax_p3.SUPPORTED == ("gcn", "sage", "gat")


def test_p3_checks_hop_ids(world):
    """The table rows a hop names are checked on the host before any
    gather (the kernel does no bounds check)."""
    _, cfg_t = _cfgs(world, "sage")
    params = torch_models.init_gnn(cfg_t, device="cpu")
    _, pt = _plans(world, _roots(world))
    with pytest.raises(IndexError, match="outside the feature table"):
        p3.run_p3_iteration(params, world["ds_t"].features[:10], pt, cfg_t,
                            device="cpu")
