"""The planner traced from inside: ``plan.pass`` spans in the shape budget,
the three stage spans of ``plan_iteration`` (``plan.sample``,
``plan.dedup``, ``plan.translate``) and their per-item jobs, the
recording thread's CPU time on every span, the recorder's clock pairs,
and their export. Tracing off records nothing and reads no clock; tracing
on leaves every plan bitwise the same."""
from concurrent.futures import ThreadPoolExecutor
import time

import numpy as np
import pytest
import torch

import repro_torch.graph as torch_graph
from repro_torch.core.strategies import plan_iteration
from repro_torch.graph.partition import community_partition, shard_features
from repro_torch.models.gnn import GNNConfig
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.export import chrome_trace, validate_chrome_trace
from repro_torch.optim import adam
from repro_torch.train import Trainer
from repro_torch.train.budget import ShapeBudget

SHARDS = 4
STAGES = ("plan.sample", "plan.dedup", "plan.translate")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test worker (the suite runs several)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _trace_reset():
    """Tracing state is module-global: leave every test with the recorder
    off and drained."""
    obs_trace.disable()
    obs_trace.clear()
    yield
    obs_trace.disable()
    obs_trace.clear()


@pytest.fixture(scope="module")
def world():
    ds = torch_graph.make_dataset("products", scale=0.03, seed=0)
    part = community_partition(ds.communities, SHARDS)
    table, owner, local_idx = shard_features(ds.features, part, SHARDS)
    return dict(ds=ds, part=part, table=table, owner=owner,
                local_idx=local_idx)


def _plan_kwargs(w, seed=0, **kw):
    rng = np.random.default_rng(seed)
    roots = [rng.choice(w["ds"].train_vertices(), 12, replace=False)
             for _ in range(SHARDS)]
    out = dict(graph=w["ds"].graph, labels=w["ds"].labels, part=w["part"],
               owner=w["owner"], local_idx=w["local_idx"],
               local_rows=w["table"].shape[1], roots_per_model=roots,
               num_layers=2, fanout=4, sample_seed=7)
    out.update(kw)
    return out


def _complete(recs, name):
    return [r for r in recs if r.kind == "X" and r.name == name]


def _inside(outer, recs, name, same_track=True):
    """The ``name`` spans that lie within ``outer``'s interval (and on its
    track)."""
    return [r for r in _complete(recs, name)
            if outer.t0_ns <= r.t0_ns and r.t1_ns <= outer.t1_ns
            and (r.track == outer.track or not same_track)]


# ---------------------------------------------------------------------------
# A traced pipelined fit
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def traced_fit(world):
    """A pipelined fit of 2 epochs × 4 iterations with a planning pool of
    two threads, traced; its records."""
    d = world
    cfg = GNNConfig(model="sage", num_layers=2, hidden_dim=16,
                    feature_dim=d["ds"].feature_dim,
                    num_classes=d["ds"].num_classes, fanout=4)
    tr = Trainer(graph=d["ds"].graph, labels=d["ds"].labels, part=d["part"],
                 owner=d["owner"], local_idx=d["local_idx"], cfg=cfg,
                 table=d["table"], optimizer=adam(5e-3), merging=False,
                 pipeline=True, planner_threads=2,
                 train_vertices=d["ds"].train_vertices(), device="cpu")
    obs_trace.enable()
    try:
        stats = tr.fit(epochs=2, iters_per_epoch=4, batch_per_model=8)
    finally:
        obs_trace.disable()
    recs = obs_trace.records()
    obs_trace.clear()
    return dict(recs=recs, stats=stats, budget=tr.budget)


def test_one_pass_per_build_once_the_budget_is_warm(traced_fit):
    recs = traced_fit["recs"]
    builds = sorted(_complete(recs, "plan.build"), key=lambda r: r.t0_ns)
    assert len(builds) == sum(s.plans_built for s in traced_fit["stats"])
    assert traced_fit["budget"].rebuckets == 0
    passes = [_inside(b, recs, "plan.pass") for b in builds]
    # the first plan probes its pattern: a probe pass, then the real one
    assert [bool((p.tags or {}).get("probe")) for p in passes[0]] == \
        [True, False]
    assert all(len(p) == 1 and not p[0].tags for p in passes[1:])
    for b, ps in zip(builds, passes):
        assert all(p.depth == b.depth + 1 for p in ps)
        assert b.track.startswith("prefetch")
    assert len(_complete(recs, "plan.pass")) == len(builds) + 1


@pytest.mark.parametrize("stage", STAGES)
def test_stages_nest_in_every_pass_on_the_prefetch_track(traced_fit, stage):
    recs = traced_fit["recs"]
    passes = _complete(recs, "plan.pass")
    assert passes
    for p in passes:
        inner = _inside(p, recs, stage)
        assert len(inner) == 1, (stage, p)
        assert inner[0].depth == p.depth + 1
        assert inner[0].track.startswith("prefetch")
    assert len(_complete(recs, stage)) == len(passes)


@pytest.mark.parametrize("job,stage", [("plan.sample.job", "plan.sample"),
                                       ("plan.translate.job",
                                        "plan.translate")])
def test_jobs_run_on_the_planner_lanes_inside_their_stage(traced_fit, job,
                                                          stage):
    recs = traced_fit["recs"]
    jobs = _complete(recs, job)
    assert jobs and all(r.track.startswith("plan_") for r in jobs)
    for s in _complete(recs, stage):
        assert _inside(s, recs, job, same_track=False)
    assert not _complete(recs, "plan.dedup.job")      # pregather: no fan-out


def test_a_traced_fit_records_no_accounting_span(traced_fit):
    """The plan counts its Fig. 14 rows when read, not while it is built:
    each pass holds the three stages and nothing else at its depth."""
    recs = traced_fit["recs"]
    passes = _complete(recs, "plan.pass")
    assert passes
    for p in passes:
        stages = sorted(r.name for r in recs if r.kind == "X"
                        and r.track == p.track and r.depth == p.depth + 1
                        and p.t0_ns <= r.t0_ns and r.t1_ns <= p.t1_ns)
        assert stages == sorted(STAGES), stages
    assert not [r for r in recs if r.name == "plan.account"]


def test_fit_spans_carry_cpu_time(traced_fit):
    recs = traced_fit["recs"]
    for name in ("plan.build", "plan.pass", "plan.dedup", "dispatch",
                 "plan.sample.job"):
        spans = _complete(recs, name)
        assert spans and all(0 <= r.cpu_ns for r in spans), name
        assert sum(r.cpu_ns for r in spans) > 0, name
        assert all(r.cpu_ns <= r.dur_ns + 1_000_000 for r in spans), name


# ---------------------------------------------------------------------------
# The budget's passes
# ---------------------------------------------------------------------------

def test_a_new_merge_pattern_records_a_probe_pass(world):
    budget = ShapeBudget()
    obs_trace.enable()
    budget.plan(**_plan_kwargs(world, seed=1))
    budget.plan(**_plan_kwargs(world, seed=2))
    budget.plan(**_plan_kwargs(world, seed=3, strategy="model_centric"))
    obs_trace.disable()
    passes = sorted(_complete(obs_trace.records(), "plan.pass"),
                    key=lambda r: r.t0_ns)
    probes = [bool((p.tags or {}).get("probe")) for p in passes]
    # pattern 4: probe + pass; again: pass; pattern 1: probe + pass
    assert probes == [True, False, False, True, False]
    assert budget.probes == 2 and budget.plans_built == 3


def test_an_overflow_records_a_failed_pass_then_a_good_one(world):
    budget = ShapeBudget(batch_pad=64, r_max=1)       # seeded: no probe
    obs_trace.enable()
    plan = budget.plan(**_plan_kwargs(world, seed=1))
    obs_trace.disable()
    passes = sorted(_complete(obs_trace.records(), "plan.pass"),
                    key=lambda r: r.t0_ns)
    assert [(p.tags or {}).get("error") for p in passes] == \
        ["PlanOverflow", None]
    assert budget.rebuckets == 1 and budget.probes == 0
    assert plan.r_max == budget.r_max > 1


# ---------------------------------------------------------------------------
# Per-step mode's dedup fan-out
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("threads", [0, 2])
def test_per_step_mode_records_dedup_jobs(world, threads):
    pool = ThreadPoolExecutor(threads) if threads else None
    try:
        obs_trace.enable()
        plan = plan_iteration(**_plan_kwargs(world, pregather=False,
                                             executor=pool))
        obs_trace.disable()
    finally:
        if pool is not None:
            pool.shutdown()
    recs = obs_trace.records()
    dedup, = _complete(recs, "plan.dedup")
    jobs = _inside(dedup, recs, "plan.dedup.job", same_track=False)
    assert len(jobs) == len(_complete(recs, "plan.dedup.job")) == \
        plan.num_steps
    if not threads:
        assert all(j.track == dedup.track and j.depth == dedup.depth + 1
                   for j in jobs)


# ---------------------------------------------------------------------------
# CPU time on spans
# ---------------------------------------------------------------------------

def test_a_sleeping_span_is_off_the_cpu():
    obs_trace.enable()
    with obs_trace.span("sleep"):
        time.sleep(0.05)
    obs_trace.disable()
    r, = obs_trace.records()
    assert r.dur_ns >= 50_000_000
    assert 0 <= r.cpu_ns < 0.2 * r.dur_ns


@pytest.mark.parametrize("track", [None, "uploader"])
def test_a_busy_span_is_on_the_cpu(track):
    obs_trace.enable()
    with obs_trace.span("busy", track=track):
        t_end = time.thread_time_ns() + 20_000_000
        while time.thread_time_ns() < t_end:
            pass
    obs_trace.disable()
    r, = obs_trace.records()
    assert r.track == (track or "MainThread")
    assert 20_000_000 <= r.cpu_ns <= r.dur_ns


def test_instant_events_have_no_cpu_time():
    obs_trace.enable()
    with obs_trace.span("outer"):
        obs_trace.event("mark", site="x")
    obs_trace.disable()
    ev, = [r for r in obs_trace.records() if r.kind == "i"]
    assert ev.cpu_ns == 0 and ev.tags == {"site": "x"}


def test_positional_records_keep_working():
    r = obs_trace.SpanRecord("X", "a", "t", 0, 5, 0, None)
    assert r.cpu_ns == 0 and r.dur_ns == 5


def test_a_span_left_by_an_exception_is_tagged():
    obs_trace.enable()
    with pytest.raises(KeyError):
        with obs_trace.span("fails", k=1):
            raise KeyError("x")
    obs_trace.disable()
    r, = obs_trace.records()
    assert r.tags == {"k": 1, "error": "KeyError"}


# ---------------------------------------------------------------------------
# Tracing off costs nothing; tracing on changes nothing
# ---------------------------------------------------------------------------

def test_tracing_off_reads_no_cpu_clock(world, monkeypatch):
    calls = []
    real = time.thread_time_ns

    def counting():
        calls.append(1)
        return real()

    monkeypatch.setattr(time, "thread_time_ns", counting)
    assert obs_trace.span("a") is obs_trace.span("b", x=1)   # shared no-op
    plan_iteration(**_plan_kwargs(world))
    assert calls == []
    obs_trace.enable()
    plan_iteration(**_plan_kwargs(world))
    obs_trace.disable()
    assert calls                      # the same call reads it when on


def _arrays(plan):
    out = {"req": plan.req, "labels": plan.labels, "weights": plan.weights,
           "true_counts": plan.true_counts}
    if plan.step_req is not None:
        out["step_req"] = plan.step_req
    out.update({f"hop_idx{h}": a for h, a in enumerate(plan.hop_idx)})
    return out


@pytest.mark.parametrize("pregather", [True, False])
@pytest.mark.parametrize("threads", [0, 2])
def test_plans_bitwise_equal_with_tracing_on_and_off(world, pregather,
                                                     threads):
    pool = ThreadPoolExecutor(threads) if threads else None
    try:
        kw = _plan_kwargs(world, seed=5, pregather=pregather, executor=pool)
        off = plan_iteration(**kw)
        obs_trace.enable()
        on = plan_iteration(**kw)
        obs_trace.disable()
    finally:
        if pool is not None:
            pool.shutdown()
    assert _complete(obs_trace.records(), "plan.translate")
    a, b = _arrays(off), _arrays(on)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    for f in ("r_max", "batch_pad", "remote_rows_exact",
              "remote_rows_nodedup", "total_rows", "unique_rows",
              "step_unique_rows"):
        assert getattr(off, f) == getattr(on, f), f


# ---------------------------------------------------------------------------
# The shared clock and the export
# ---------------------------------------------------------------------------

def test_clock_pairs_hold_enable_then_disable():
    obs_trace.enable()
    first = obs_trace.clock_pairs()
    assert len(first) == 1
    time.sleep(0.01)
    obs_trace.disable()
    obs_trace.disable()                        # already off: no new pair
    pairs = obs_trace.clock_pairs()
    assert pairs[:1] == first and len(pairs) == 2
    (p0, w0), (p1, w1) = pairs
    assert p1 - p0 >= 10_000_000 and w1 > w0
    assert abs((w1 - p1) - (w0 - p0)) < 5_000_000   # drift over 10 ms
    obs_trace.clear()
    assert obs_trace.clock_pairs() == pairs
    obs_trace.enable()
    assert len(obs_trace.clock_pairs()) == 1


def test_chrome_trace_exports_cpu_time_and_clock_pairs():
    obs_trace.enable()
    with obs_trace.span("a"):
        with obs_trace.span("b", track="uploader"):
            pass
    obs_trace.event("mark")
    obs_trace.disable()
    doc = chrome_trace(manifest={"git_sha": "x"})
    assert validate_chrome_trace(doc) == []
    spans = [ev for ev in doc["traceEvents"] if ev["ph"] == "X"]
    assert len(spans) == 2
    assert all(ev["args"]["cpu_ms"] >= 0 for ev in spans)
    marks = [ev for ev in doc["traceEvents"] if ev["ph"] == "i"]
    assert marks and all("cpu_ms" not in ev.get("args", {}) for ev in marks)
    meta = doc["metadata"]
    assert meta["git_sha"] == "x"
    assert meta["clock_pairs"] == [list(p) for p in obs_trace.clock_pairs()]
    assert meta["epoch_perf_counter_ns"] == obs_trace.epoch_ns()


@pytest.mark.parametrize("defect,problem", [
    (lambda d: d["traceEvents"][-1].setdefault("args", {}).update(
        cpu_ms=-1.0), "bad cpu_ms"),
    (lambda d: d["metadata"].update(clock_pairs=[[1, 2, 3]]),
     "clock_pairs"),
    (lambda d: d["metadata"].update(clock_pairs=[[1.5, 2]]),
     "clock_pairs"),
])
def test_validate_catches_bad_cpu_time_and_clock_pairs(defect, problem):
    obs_trace.enable()
    with obs_trace.span("a"):
        pass
    obs_trace.disable()
    doc = chrome_trace(manifest={})
    assert validate_chrome_trace(doc) == []
    defect(doc)
    assert any(problem in p for p in validate_chrome_trace(doc))
