"""The planner's accounting block (``plan.account``): ``total_rows``,
``unique_rows``, ``step_unique_rows`` and ``remote_rows_nodedup`` on both of
its paths — distinct ids counted with a stamp array over the vertex space
(``path="mark"``) or with sorts (``path="sort"``) — held to the formula the
planner used before, which cut each padded tree back to its true roots with
``TreeBlock.select`` and ran ``np.unique`` over each shard's and each step's
ids, and to the reference's plan. The graph's size picks the path: a small
graph with many ids marks, a large one with few ids sorts."""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import repro.core.merging as jax_merging
import repro.core.micrograph as jax_micro
import repro.core.strategies as jax_strategies
import repro.graph.synthetic as jax_synthetic
import repro_torch.core.merging as torch_merging
import repro_torch.core.micrograph as torch_micro
import repro_torch.core.strategies as torch_strategies
import repro_torch.graph.synthetic as torch_synthetic
from repro_torch.graph.partition import (community_partition,
                                         drop_cross_edges, local_index_map)
from repro_torch.graph.sampler import sample_tree_block
from repro_torch.obs import trace as obs_trace

SHARDS = 4
LAYERS = 2
FANOUT = 3
SEED = 11
# (vertices, communities, roots per model): the small graph's plans have
# 25 mark cells per id or fewer, the large one's 3,000 or more
GRAPHS = {"mark": (1024, 8, 16), "sort": (60_000, 30, 3)}
CASES = ("hopgnn", "hopgnn-padded", "hopgnn-empty", "hopgnn-merged",
         "model_centric-unpadded", "lo")
COUNTS = ("total_rows", "unique_rows", "step_unique_rows",
          "remote_rows_nodedup")


@pytest.fixture(autouse=True)
def _trace_reset():
    obs_trace.disable()
    obs_trace.clear()
    yield
    obs_trace.disable()
    obs_trace.clear()


@pytest.fixture(scope="module")
def worlds():
    out = {}
    for path, (v, comms, per_model) in GRAPHS.items():
        g_t, comm = torch_synthetic.community_graph(v, 4.0, comms, 0.85,
                                                    seed=3)
        g_j, _ = jax_synthetic.community_graph(v, 4.0, comms, 0.85, seed=3)
        part = community_partition(comm, SHARDS)
        owner, local_idx, rows = local_index_map(part, SHARDS)
        out[path] = dict(g_t=g_t, g_j=g_j, part=part, owner=owner,
                         local_idx=local_idx, local_rows=rows,
                         labels=(comm % 7).astype(np.int32),
                         per_model=per_model)
    return out


def _case_kwargs(w, case, pregather, seed):
    """Planner arguments for one case, without the graph and the
    assignment, and ``assign(micrograph, merging)``, which builds the
    case's assignment from either package's modules (None: the strategy's
    own)."""
    rng = np.random.default_rng(seed)
    k = w["per_model"]
    pool = (np.nonzero(w["part"] < 2)[0] if case == "hopgnn-empty"
            else np.arange(w["part"].size))
    roots = [rng.choice(pool, k, replace=False) for _ in range(SHARDS)]
    kw = dict(labels=w["labels"], part=w["part"], owner=w["owner"],
              local_idx=w["local_idx"], local_rows=w["local_rows"],
              roots_per_model=roots, num_layers=LAYERS, fanout=FANOUT,
              strategy=case.split("-")[0], pregather=pregather,
              sample_seed=SEED)
    if case == "hopgnn-padded":
        kw["batch_pad"] = 3 * k
    assign = None
    if case == "hopgnn-merged":
        def assign(micro, merging, roots=roots, part=w["part"]):
            return merging.fold_assignment(
                micro.hopgnn_assignment(roots, part), 1)
    return kw, assign


def _old_counts(plan, graph, kw):
    """The accounting as the planner computed it before the mark path: each
    (s, t)'s padded block cut back to its true roots with ``select``, its
    rows counted tree by tree, and ``np.unique`` over the ids of each shard
    and of each (s, t)."""
    if kw["strategy"] == "lo":
        graph = drop_cross_edges(graph, kw["part"])
    owner = kw["owner"]
    total_rows = unique_rows = step_unique = remote_nodedup = 0
    for s in range(plan.num_shards):
        pad_vertex = np.nonzero(owner == s)[0][0]
        per_step_ids = []
        for t in range(plan.num_steps):
            roots = plan.assignment.roots_at(s, t)
            if roots.size == 0:
                continue
            blk = sample_tree_block(graph, roots, LAYERS, FANOUT,
                                    seed=SEED)
            total_rows += blk.num_feature_rows()
            padded = torch_strategies._pad_tree_block(blk, plan.batch_pad,
                                                      pad_vertex)
            per_step_ids.append(
                padded.select(np.arange(roots.size)).all_ids())
        if per_step_ids:
            unique_rows += np.unique(np.concatenate(per_step_ids)).size
            for ids in per_step_ids:
                u = np.unique(ids)
                step_unique += u.size
                remote_nodedup += int((owner[u] != s).sum())
    return dict(total_rows=total_rows, unique_rows=unique_rows,
                step_unique_rows=step_unique,
                remote_rows_nodedup=remote_nodedup)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("pregather", [True, False],
                         ids=["pregather", "per_step"])
@pytest.mark.parametrize("path", list(GRAPHS))
def test_account_counts_match_the_old_formula_and_the_reference(
        worlds, path, pregather, case):
    w = worlds[path]
    kw, assign = _case_kwargs(w, case, pregather, seed=len(case))
    obs_trace.enable()
    plan = torch_strategies.plan_iteration(
        graph=w["g_t"], assignment=assign and assign(torch_micro,
                                                     torch_merging), **kw)
    obs_trace.disable()
    ref = jax_strategies.plan_iteration(
        graph=w["g_j"], assignment=assign and assign(jax_micro,
                                                     jax_merging), **kw)

    spans = [r for r in obs_trace.records()
             if r.kind == "X" and r.name == "plan.account"]
    assert [r.tags for r in spans] == [{"path": path}]
    if case == "hopgnn-merged":
        assert plan.num_steps == 1
    counts = plan.true_counts
    if case == "hopgnn-empty":
        assert (counts == 0).any()
    assert (counts.max() < plan.batch_pad) == (case == "hopgnn-padded")
    if case == "model_centric-unpadded":
        assert (counts == plan.batch_pad).all()

    old = _old_counts(plan, w["g_t"], kw)
    got = {f: getattr(plan, f) for f in COUNTS}
    assert got == old
    assert got == {f: getattr(ref, f) for f in COUNTS}
    assert (got["remote_rows_nodedup"] > 0) == (kw["strategy"] != "lo")
    for f in ("num_steps", "r_max", "batch_pad", "remote_rows_exact"):
        assert getattr(plan, f) == getattr(ref, f), f
    arrays = ["req", "labels", "weights", "true_counts"] + (
        [] if pregather else ["step_req"])
    for f in arrays:
        a, b = getattr(plan, f), getattr(ref, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    for a, b in zip(plan.hop_idx, ref.hop_idx, strict=True):
        assert a.dtype == b.dtype == np.int32 and np.array_equal(a, b)


@pytest.mark.parametrize("shards,steps", [(3, 2), (4, 4), (20, 30)])
def test_mark_and_sort_counts_agree(shards, steps):
    """Both counters on the same hop lists: repeated ids, shards with no
    step, and (13 shards with 30 steps each) more stamps than a byte
    holds."""
    rng = np.random.default_rng(shards * steps)
    V = 500
    owner = rng.integers(0, shards, V).astype(np.int32)
    true_hops = []
    for s in range(shards):
        n_steps = 0 if s % 3 == 1 else steps
        true_hops.append([[rng.integers(0, V, rng.integers(1, 40) * 3 ** h)
                           for h in range(3)] for _ in range(n_steps)])
    sorted_ = torch_strategies._count_rows_sorted(true_hops, owner)
    marked = torch_strategies._count_rows_marked(true_hops, owner)
    assert marked == sorted_ and min(sorted_) > 0


@pytest.mark.parametrize("n,T,V,ids,marked", [
    (4, 4, 2_449_029, 1024 * 1111, True),      # train-sage-products
    (4, 1, 2_449_029, 1024 * 1111, True),      # the same, fully merged
    (4, 4, 30_000_000, 4 * 1111, False),       # a per-step plan, few ids
    (4, 4, 0, 100, False),                     # no vertices
], ids=["products_plan", "products_merged", "few_ids_large_graph",
        "empty_graph"])
def test_mark_path_where_the_id_volume_pays(n, T, V, ids, marked):
    assert torch_strategies._use_mark_count(n, T, V, ids) is marked


def test_marked_accounting_shares_no_state_across_threads(worlds):
    """The mark path's arrays are each call's own: plans built at once on
    eight threads count what one thread alone counts."""
    w = worlds["mark"]
    kws = [_case_kwargs(w, "hopgnn", True, seed=i)[0] for i in range(8)]
    alone = [torch_strategies.plan_iteration(graph=w["g_t"], **kw)
             for kw in kws]
    with ThreadPoolExecutor(8) as pool:
        futures = [pool.submit(torch_strategies.plan_iteration,
                               graph=w["g_t"], **kw) for kw in kws * 4]
        together = [f.result(timeout=120) for f in futures]
    for i, plan in enumerate(together):
        want = alone[i % len(kws)]
        assert {f: getattr(plan, f) for f in COUNTS} == \
            {f: getattr(want, f) for f in COUNTS}
