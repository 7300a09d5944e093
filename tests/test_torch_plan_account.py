"""The planner's accounting: ``total_rows``, counted while the plan is
built, and the Fig. 14 counts ``unique_rows``, ``step_unique_rows`` and
``remote_rows_nodedup``, which the plan counts from its trees' true-root
prefixes when one of them is first read. All are held to the formula the
planner used before, which cut each padded tree back to its true roots
with ``TreeBlock.select`` and ran ``np.unique`` over each shard's and each
step's ids, and to the reference's plan, on a small graph with many ids
per vertex and a large one with few."""
import sys
import threading
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
from repro_torch.train.budget import ShapeBudget

SHARDS = 4
LAYERS = 2
FANOUT = 3
SEED = 11
# (vertices, communities, roots per model): the small graph's plans touch
# most of its vertices, the large one's a few in a thousand
GRAPHS = {"small": (1024, 8, 16), "large": (60_000, 30, 3)}
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
    for size, (v, comms, per_model) in GRAPHS.items():
        g_t, comm = torch_synthetic.community_graph(v, 4.0, comms, 0.85,
                                                    seed=3)
        g_j, _ = jax_synthetic.community_graph(v, 4.0, comms, 0.85, seed=3)
        part = community_partition(comm, SHARDS)
        owner, local_idx, rows = local_index_map(part, SHARDS)
        out[size] = dict(g_t=g_t, g_j=g_j, part=part, owner=owner,
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


def _counts(plan) -> dict:
    return {f: getattr(plan, f) for f in COUNTS}


def _old_counts(plan, graph, kw):
    """The accounting as the planner once computed it while building: each
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
@pytest.mark.parametrize("size", list(GRAPHS))
def test_account_counts_match_the_old_formula_and_the_reference(
        worlds, size, pregather, case):
    w = worlds[size]
    kw, assign = _case_kwargs(w, case, pregather, seed=len(case))
    obs_trace.enable()
    plan = torch_strategies.plan_iteration(
        graph=w["g_t"], assignment=assign and assign(torch_micro,
                                                     torch_merging), **kw)
    obs_trace.disable()
    ref = jax_strategies.plan_iteration(
        graph=w["g_j"], assignment=assign and assign(jax_micro,
                                                     jax_merging), **kw)

    assert not [r for r in obs_trace.records() if r.name == "plan.account"]
    if case == "hopgnn-merged":
        assert plan.num_steps == 1
    counts = plan.true_counts
    if case == "hopgnn-empty":
        assert (counts == 0).any()
    assert (counts.max() < plan.batch_pad) == (case == "hopgnn-padded")
    if case == "model_centric-unpadded":
        assert (counts == plan.batch_pad).all()

    old = _old_counts(plan, w["g_t"], kw)
    got = _counts(plan)
    assert got == old
    assert got == _counts(ref)
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


@pytest.fixture
def count_calls(monkeypatch):
    """One entry per call of the planner's row counter."""
    calls = []
    count = torch_strategies._count_rows

    def counting(*args):
        calls.append(1)
        return count(*args)

    monkeypatch.setattr(torch_strategies, "_count_rows", counting)
    return calls


@pytest.mark.parametrize("pregather", [True, False],
                         ids=["pregather", "per_step"])
@pytest.mark.parametrize("strategy", ["hopgnn", "model_centric", "lo"])
def test_counts_are_computed_only_when_read(worlds, count_calls, strategy,
                                            pregather):
    w = worlds["small"]
    kw, _ = _case_kwargs(w, strategy, pregather, seed=7)
    plan = torch_strategies.plan_iteration(graph=w["g_t"], **kw)
    assert count_calls == []
    got = [_counts(plan) for _ in range(2)]
    rates = [(plan.miss_rate(), plan.miss_rate_per_request())
             for _ in range(2)]
    assert len(count_calls) == 1
    assert got[0] == got[1] == _old_counts(plan, w["g_t"], kw)
    assert rates[0] == rates[1] == (
        plan.remote_rows_exact / max(got[0]["unique_rows"], 1),
        got[0]["remote_rows_nodedup"] / max(got[0]["step_unique_rows"], 1))


def test_counts_read_on_many_threads_equal_one_thread(worlds):
    """Eight plans built at once on eight threads, then their counts read
    at once from four, with the interpreter switching threads as often as
    it can: each reader sees what one thread alone counts."""
    w = worlds["small"]
    kws = [_case_kwargs(w, "hopgnn", True, seed=i)[0] for i in range(8)]
    alone = [_counts(torch_strategies.plan_iteration(graph=w["g_t"], **kw))
             for kw in kws]
    with ThreadPoolExecutor(8) as pool:
        plans = [f.result(timeout=120) for f in
                 [pool.submit(torch_strategies.plan_iteration,
                              graph=w["g_t"], **kw) for kw in kws]]
    start = threading.Barrier(4)

    def read_all(_):
        start.wait(timeout=60)
        return [_counts(p) for p in plans]

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(4) as pool:
            reads = list(pool.map(read_all, range(4), timeout=120))
    finally:
        sys.setswitchinterval(interval)
    assert all(r == alone for r in reads)


def test_counts_survive_a_budget_rebuild(worlds, count_calls):
    """A budget seeded too small for the fetches overflows, re-buckets and
    plans again; that plan counts what a direct plan at its final shapes
    and the reference's count, and no pass counted anything."""
    w = worlds["small"]
    kw, _ = _case_kwargs(w, "hopgnn", True, seed=5)
    budget = ShapeBudget(batch_pad=64, r_max=1)
    plan = budget.plan(graph=w["g_t"], **kw)
    assert budget.rebuckets == 1 and count_calls == []
    shapes = dict(batch_pad=budget.batch_pad, r_max=budget.r_max)
    direct = torch_strategies.plan_iteration(graph=w["g_t"], **kw, **shapes)
    ref = jax_strategies.plan_iteration(graph=w["g_j"], **kw, **shapes)
    assert plan.batch_pad == 64 and plan.r_max == budget.r_max > 1
    for a, b in zip(plan.hop_idx, ref.hop_idx, strict=True):
        assert np.array_equal(a, b)
    got = _counts(plan)
    assert got == _counts(direct) == _counts(ref)
    assert got == _old_counts(plan, w["g_t"], kw)
