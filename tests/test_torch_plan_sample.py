"""The planner's sampling stage drawn on a device (``plan.sample`` tagged
``path="device"``): the hop-wise expansion of a plan's concatenated roots
by :mod:`repro_torch.kernels.sample_tree`, cut back into its jobs, against
the JAX package's ``sample_tree_block`` per job, bit for bit;
``plan_iteration`` with ``device_trees`` against the port's host path and
the JAX package's ``plan_iteration``; the stage's ``path`` tag; and the
wrapper's refusals. On the CPU the kernel's plain version runs. The tests
marked ``chip`` run the CUDA kernel, and skip without a card; the JAX
package does not run there, so on the card the kernel is held against the
port's host sampler, which the CPU tests hold bitwise to the JAX
package's:

    PYTHONPATH=src python -m pytest -q tests/test_torch_plan_sample.py -m chip
"""
import numpy as np
import pytest
import torch

from repro_torch.core import strategies
from repro_torch.core.strategies import DeviceTrees, plan_iteration
from repro_torch.graph.partition import community_partition, local_index_map
from repro_torch.graph.sampler import _sample_neighbors, sample_tree_block
from repro_torch.graph.structs import CSRGraph
from repro_torch.graph.synthetic import community_graph
from repro_torch.kernels import sample_tree
from repro_torch.kernels.sample_tree import DeviceCSR
from repro_torch.obs import trace as obs_trace

SHARDS = 4
LAYERS = 3
FANOUT = 4
SEEDS = [0, 12_345, 2 ** 31 + 7, 2 ** 63 - 1, 2 ** 63, 2 ** 64 - 1]
PLAN_ARRAYS = ("req", "step_req", "labels", "weights", "true_counts")
PLAN_COUNTS = ("num_steps", "batch_pad", "r_max", "global_batch",
               "remote_rows_exact", "remote_rows_nodedup", "total_rows",
               "unique_rows", "step_unique_rows")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test worker (the suite runs several)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _trace_reset():
    obs_trace.disable()
    obs_trace.clear()
    yield
    obs_trace.disable()
    obs_trace.clear()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _random_csr(v: int, mean_deg: float, seed: int) -> CSRGraph:
    """Poisson degrees with a tenth of the vertices and the last three of
    degree 0 (so the last ones start at nnz), and the last vertex with
    edges of degree 1, whose one draw reads ``indices[nnz - 1]``."""
    rng = np.random.default_rng(seed)
    deg = rng.poisson(mean_deg, v)
    deg[rng.random(v) < 0.1] = 0
    deg[-3:] = 0
    deg[-4] = 1
    indptr = np.zeros(v + 1, np.int64)
    np.cumsum(deg, out=indptr[1:])
    return CSRGraph(indptr=indptr,
                    indices=rng.integers(0, v, int(indptr[-1]),
                                         dtype=np.int32))


def _jobs(graph: CSRGraph, sizes, seed: int) -> list:
    """(s, t, roots, k) jobs of the given root counts; roots include
    vertices of degree 0, the last vertices and the one at nnz - 1."""
    rng = np.random.default_rng(seed)
    v = graph.num_vertices
    zero = np.nonzero(np.diff(graph.indptr) == 0)[0]
    jobs = []
    for i, k in enumerate(sizes):
        roots = rng.integers(0, v, k).astype(np.int64)
        if k >= 4:
            roots[:4] = [v - 1, v - 4, zero[i % zero.size], v - 2]
        jobs.append((i, 0, roots, k))
    return jobs


def _jax_graph(graph: CSRGraph):
    """The same CSR as the JAX package's graph type. The JAX package is
    imported inside the CPU tests alone: it does not run beside the card,
    where the ``chip`` tests run."""
    from repro.graph.structs import CSRGraph as JaxCSRGraph
    return JaxCSRGraph(indptr=graph.indptr, indices=graph.indices)


def _assert_same_hops(got: list, want: list) -> None:
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.int64 and np.array_equal(a, b)


# ---------------------------------------------------------------------------
# The expansion of concatenated roots, cut into jobs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS, ids=lambda s: f"seed{s}")
@pytest.mark.parametrize("sizes", [(16, 9, 23, 1), (0, 12, 0, 7, 0),
                                   (0, 0)],
                         ids=["jobs", "empty_jobs", "all_empty"])
def test_batched_expansion_is_each_jobs_trees(sizes, seed):
    graph = _random_csr(600, 3.0, seed=len(sizes))
    jobs = _jobs(graph, sizes, seed=sum(sizes))
    csr = DeviceCSR.from_graph(graph, "cpu")
    sample_tree.reset_launches()
    roots = np.concatenate([j[2] for j in jobs])
    hops = csr.sample_trees(roots, LAYERS, FANOUT, seed)
    assert [h.size for h in hops] == [roots.size * FANOUT ** h
                                      for h in range(LAYERS + 1)]
    import repro.graph.sampler as jax_sampler
    blks = strategies._slice_jobs(hops, jobs, FANOUT)
    ref = _jax_graph(graph)
    for (_, _, r, _), blk in zip(jobs, blks, strict=True):
        want = jax_sampler.sample_tree_block(ref, r, LAYERS, FANOUT,
                                             seed=seed)
        _assert_same_hops(blk.hops, want.hops)
    assert sample_tree.launches["sample_tree"] == 0     # the plain version


@pytest.mark.parametrize("hop", [0, 2, 7])
def test_one_hop_is_the_host_draw_at_every_slot(hop):
    """sample_hop against ``_sample_neighbors`` at a wider fanout, on a
    frontier of every vertex: degree 0, the last vertices, the entry at
    nnz - 1, and hubs with more neighbours than slots."""
    import repro.graph.sampler as jax_sampler
    graph = _random_csr(300, 12.0, seed=hop)
    frontier = np.arange(graph.num_vertices, dtype=np.int64)
    for seed in SEEDS:
        got = sample_tree.sample_hop(torch.from_numpy(graph.indptr),
                                     torch.from_numpy(graph.indices),
                                     torch.from_numpy(frontier), 13, hop,
                                     seed)
        want = jax_sampler._sample_neighbors(_jax_graph(graph), frontier,
                                             13, None, seed=seed, hop=hop)
        assert got.dtype == torch.int64
        assert np.array_equal(got.numpy(), want)


def test_a_graph_without_edges_self_loops():
    graph = CSRGraph(indptr=np.zeros(6, np.int64),
                     indices=np.zeros(0, np.int32))
    hops = DeviceCSR.from_graph(graph, "cpu").sample_trees(
        np.array([4, 0, 2]), 2, 3, seed=5)
    assert np.array_equal(hops[2], np.repeat([4, 0, 2], 9))


@pytest.mark.parametrize("seed", SEEDS, ids=lambda s: f"seed{s}")
def test_host_sampler_is_the_reference(seed):
    """The port's host sampler, which the ``chip`` tests hold the kernel
    against, is the JAX package's, bit for bit, on a CSR like theirs."""
    import repro.graph.sampler as jax_sampler
    graph = _random_csr(2_000, 20.0, seed=5)
    roots = _jobs(graph, [256], seed=6)[0][2]
    _assert_same_hops(
        sample_tree_block(graph, roots, LAYERS, 10, seed=seed).hops,
        jax_sampler.sample_tree_block(_jax_graph(graph), roots, LAYERS, 10,
                                      seed=seed).hops)
    frontier = np.arange(graph.num_vertices, dtype=np.int64)
    assert np.array_equal(
        _sample_neighbors(graph, frontier, 10, None, seed=seed, hop=2),
        jax_sampler._sample_neighbors(_jax_graph(graph), frontier, 10, None,
                                      seed=seed, hop=2))


# ---------------------------------------------------------------------------
# plan_iteration with device_trees against the host path
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world():
    """A community graph with 40 isolated vertices appended, partitioned
    4 ways."""
    g, comm = community_graph(2_000, 4.0, 8, 0.85, seed=3)
    extra = 40
    graph = CSRGraph(indptr=np.concatenate(
        [g.indptr, np.full(extra, g.indptr[-1], np.int64)]),
        indices=g.indices)
    comm = np.concatenate([comm, np.arange(extra) % 8])
    part = community_partition(comm, SHARDS)
    owner, local_idx, rows = local_index_map(part, SHARDS)
    return dict(graph=graph, part=part, owner=owner, local_idx=local_idx,
                local_rows=rows, labels=(comm % 7).astype(np.int32),
                trees=DeviceTrees.build(graph, owner, local_idx, SHARDS,
                                        "cpu"))


def _plan_kwargs(w, strategy: str, pregather: bool, padded: bool,
                 seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    n = w["graph"].num_vertices
    roots = np.split(rng.choice(n - 40, 12 * SHARDS, replace=False), SHARDS)
    roots[1][:3] = [n - 1, n - 2, n - 40]                 # isolated vertices
    kw = dict(graph=w["graph"], labels=w["labels"], part=w["part"],
              owner=w["owner"], local_idx=w["local_idx"],
              local_rows=w["local_rows"], roots_per_model=roots,
              num_layers=LAYERS, fanout=FANOUT, strategy=strategy,
              pregather=pregather, sample_seed=2 ** 31 + 99)
    if padded:
        kw["batch_pad"] = 64
    return kw


def _assert_same_plan(got, want) -> None:
    for f in PLAN_COUNTS:
        assert getattr(got, f) == getattr(want, f), f
    for f in PLAN_ARRAYS:
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert a.dtype == b.dtype and np.array_equal(a, b), f
    for a, b in zip(got.hop_idx, want.hop_idx, strict=True):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def _sample_tags() -> list:
    return [r.tags for r in obs_trace.records()
            if r.kind == "X" and r.name == "plan.sample"]


@pytest.mark.parametrize("padded", [False, True], ids=["unpadded", "padded"])
@pytest.mark.parametrize("pregather", [True, False],
                         ids=["pregather", "per_step"])
@pytest.mark.parametrize("strategy", ["hopgnn", "model_centric"])
def test_device_trees_plan_is_the_host_plan(world, strategy, pregather,
                                            padded):
    kw = _plan_kwargs(world, strategy, pregather, padded)
    want = plan_iteration(**kw)
    obs_trace.enable()
    got = plan_iteration(**kw, device_trees=world["trees"])
    obs_trace.disable()
    assert _sample_tags() == [{"path": "device"}]
    assert (got.true_counts.max() < got.batch_pad) == padded
    _assert_same_plan(got, want)
    import repro.core.strategies as jax_strategies
    kw["graph"] = _jax_graph(kw["graph"])
    _assert_same_plan(got, jax_strategies.plan_iteration(**kw))


@pytest.mark.parametrize("case", ["lo", "stateful_rng", "no_argument"])
def test_sample_stage_is_tagged_host_where_the_host_samples(world, case):
    kw = _plan_kwargs(world, "lo" if case == "lo" else "hopgnn", True, False)
    trees = None if case == "no_argument" else world["trees"]
    if case == "stateful_rng":
        kw.update(sample_seed=None, rng=np.random.default_rng(1))
    obs_trace.enable()
    got = plan_iteration(**kw, device_trees=trees)
    obs_trace.disable()
    assert _sample_tags() == [{"path": "host"}]
    if case == "stateful_rng":
        kw["rng"] = np.random.default_rng(1)
    _assert_same_plan(got, plan_iteration(**kw))


def test_device_trees_of_another_partition_are_refused(world):
    trees = world["trees"].for_partition(world["owner"] % 3,
                                         world["local_idx"], 3)
    with pytest.raises(ValueError, match="pad vertices of 3 shards"):
        plan_iteration(**_plan_kwargs(world, "hopgnn", True, False),
                       device_trees=trees)


def test_pad_vertices_are_each_shards_first_vertex():
    owner = np.array([2, 0, 2, 0, 3, 3])
    assert strategies.pad_vertices(owner, 5).tolist() == [1, 0, 0, 4, 0]


# ---------------------------------------------------------------------------
# Refusals
# ---------------------------------------------------------------------------

def _hop_args(**change):
    graph = _random_csr(50, 3.0, seed=0)
    args = dict(indptr=torch.from_numpy(graph.indptr),
                indices=torch.from_numpy(graph.indices),
                frontier=torch.arange(5, dtype=torch.int64), fanout=3,
                hop=0, seed=1)
    args.update(change)
    return args


@pytest.mark.parametrize("change,error", [
    (dict(indptr=torch.zeros(51, dtype=torch.int32)), TypeError),
    (dict(indices=torch.zeros(4, dtype=torch.int64)), TypeError),
    (dict(frontier=torch.arange(5, dtype=torch.int32)), TypeError),
    (dict(frontier=torch.arange(5.0)), TypeError),
    (dict(frontier=torch.zeros((2, 2), dtype=torch.int64)), ValueError),
    (dict(frontier=torch.arange(10, dtype=torch.int64)[::2]), ValueError),
    (dict(fanout=0), ValueError),
    (dict(seed=-1), ValueError),
    (dict(seed=2 ** 64), ValueError),
    (dict(out=torch.empty(15, dtype=torch.int64)), ValueError),
], ids=["indptr_int32", "indices_int64", "frontier_int32", "frontier_float",
        "frontier_2d", "frontier_strided", "fanout_0", "seed_negative",
        "seed_65_bits", "out_on_cpu"])
def test_sample_hop_refuses(change, error):
    with pytest.raises(error):
        sample_tree.sample_hop(**_hop_args(**change))


@pytest.mark.parametrize("indptr,indices", [
    ([1, 2, 3], [0, 1, 0]),                  # does not start at 0
    ([0, 2, 1, 2], [0, 1]),                  # falls
    ([0, 1, 3], [0, 1]),                     # ends past nnz
    ([0, 1, 2], [0, 2]),                     # an index past V
    ([0, 1, 2], [-1, 0]),                    # a negative index
], ids=["start", "falls", "end", "index_past_v", "index_negative"])
def test_device_csr_refuses_a_malformed_graph(indptr, indices):
    graph = CSRGraph(indptr=np.array(indptr, np.int64),
                     indices=np.array(indices, np.int32))
    with pytest.raises(ValueError):
        DeviceCSR.from_graph(graph, "cpu")


@pytest.mark.parametrize("root", [-1, 50])
def test_sample_trees_refuses_a_root_outside_the_graph(root):
    csr = DeviceCSR.from_graph(_random_csr(50, 3.0, seed=0), "cpu")
    with pytest.raises(IndexError):
        csr.sample_trees(np.array([0, root]), 2, 3, seed=1)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

# (vertices, mean degree of the nine tenths not at degree 0): the CSRs of
# train-sage-products (127,621,488 entries) and train-gat-uk (235,924,360),
# as random graphs of that size
CELL_SIZES = {"sage_products": (2_449_029, 52.11 / 0.9),
              "gat_uk": (10_000_000, 23.59 / 0.9)}


@pytest.mark.chip
@pytest.mark.parametrize("cell", sorted(CELL_SIZES))
def test_kernel_is_the_host_sampler_at_the_cells_sizes(card, cell):
    """One plan's trees (1,024 roots, 3 hops of fanout 10) drawn by the
    kernel, bitwise the port's host sampler hop by hop (the JAX package's,
    by ``test_host_sampler_is_the_reference``), and one launch per hop."""
    v, mean_deg = CELL_SIZES[cell]
    graph = _random_csr(v, mean_deg, seed=1)
    csr = DeviceCSR.from_graph(graph, card)
    roots = _jobs(graph, [1024], seed=2)[0][2]
    for seed in (2 ** 31 + 12_345, 2 ** 64 - 1):
        sample_tree.reset_launches()
        hops = csr.sample_trees(roots, 3, 10, seed)
        assert sample_tree.launches["sample_tree"] == 3
        _assert_same_hops(hops, sample_tree_block(graph, roots, 3, 10,
                                                  seed=seed).hops)


def _trainer(w, device):
    from repro_torch.models.gnn import GNNConfig
    from repro_torch.optim import adam
    from repro_torch.train import Trainer
    rng = np.random.default_rng(0)
    n = w["graph"].num_vertices
    table = rng.standard_normal((SHARDS, w["local_rows"], 8)).astype(
        np.float32)
    cfg = GNNConfig(model="sage", num_layers=LAYERS, hidden_dim=8,
                    feature_dim=8, num_classes=7, fanout=FANOUT)
    return Trainer(graph=w["graph"], labels=w["labels"], part=w["part"],
                   owner=w["owner"], local_idx=w["local_idx"], table=table,
                   cfg=cfg, optimizer=adam(1e-3), sample_seed_base=2 ** 31,
                   train_vertices=np.arange(0, n, 3), device=device)


@pytest.mark.chip
def test_trainer_plan_on_the_card_is_the_cpu_plan(card, world):
    on_card, on_cpu = _trainer(world, card), _trainer(world, "cpu")
    assert on_cpu._device_trees is None
    for it in range(3):
        _assert_same_plan(on_card.build_plan(0, it, 16),
                          on_cpu.build_plan(0, it, 16))


@pytest.mark.chip
def test_a_fit_launches_three_per_plan_pass_all_on_the_device(card, world):
    trainer = _trainer(world, card)
    sample_tree.reset_launches()
    obs_trace.enable()
    trainer.fit(epochs=2, iters_per_epoch=3, batch_per_model=16)
    obs_trace.disable()
    recs = [r for r in obs_trace.records() if r.kind == "X"]
    passes = [r for r in recs if r.name == "plan.pass"]
    assert passes and sample_tree.launches["sample_tree"] == 3 * len(passes)
    tags = [r.tags for r in recs if r.name == "plan.sample"]
    assert len(tags) == len(passes)
    assert all(t == {"path": "device"} for t in tags)
