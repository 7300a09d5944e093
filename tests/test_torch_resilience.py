"""repro_torch.resilience in the port's Trainer, at a small size (products
at scale 0.03, 4 shards, SAGE 2 layers, hidden 32, fanout 4).

The contract is the reference's: *bit-identity*. Plans are pure functions
of (epoch, it, seeds, pattern, cache_version), and every pipeline and
cache mode is bitwise its fallback, so an absorbed fault must leave no
numerical trace. Each test injects a fault class, asserts that it fired,
and asserts that the run's losses and parameters equal the port's own
fault-free run exactly.
"""
import json
import os
import subprocess
import sys
import textwrap
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.resilience as jax_resilience
import repro_torch.core.distributed as engine
import repro_torch.graph as torch_graph
from repro_torch.graph.partition import community_partition, shard_features
from repro_torch.models.gnn import GNNConfig
from repro_torch.optim import adam
from repro_torch.resilience import (BackgroundError, ChaosPlan,
                                    CheckpointRollbackExhausted,
                                    CommCounters, CommTimeout, FaultPlan,
                                    FaultSpec, ResiliencePolicy, RetryPolicy,
                                    ThreadSupervisor, TransientCommError,
                                    resilient_call)
from repro_torch.resilience import faults as rfaults
from repro_torch.train import Trainer

ROOT = Path(__file__).resolve().parents[1]
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
def partitioned():
    ds = torch_graph.make_dataset("products", scale=0.03, seed=0)
    part = community_partition(ds.communities, SHARDS)
    table, owner, local_idx = shard_features(ds.features, part, SHARDS)
    return dict(ds=ds, part=part, table=table, owner=owner,
                local_idx=local_idx)


@pytest.fixture(autouse=True)
def _clean_registry():
    """The dead-peer registry and the active plan are process-global."""
    yield
    for p in list(engine.dead_peers()):
        engine.revive_peer(p)
    assert rfaults.active_plan() is None


def _cfg(d):
    return GNNConfig(model="sage", num_layers=2, hidden_dim=32,
                     feature_dim=d["ds"].feature_dim,
                     num_classes=d["ds"].num_classes, fanout=4)


def _trainer(d, **kw):
    kw.setdefault("optimizer", adam(5e-3))
    kw.setdefault("merging", False)
    kw.setdefault("train_vertices", d["ds"].train_vertices())
    kw.setdefault("table", d["table"])
    return Trainer(graph=d["ds"].graph, labels=d["ds"].labels,
                   part=d["part"], owner=d["owner"],
                   local_idx=d["local_idx"], cfg=_cfg(d), device="cpu",
                   **kw)


def _losses(stats):
    return [s.loss for s in stats]


def _run(d, plan=None, epochs=2, iters=4, **kw):
    tr = _trainer(d, **kw)
    if plan is not None:
        with plan.active():
            stats = tr.fit(epochs=epochs, iters_per_epoch=iters,
                           batch_per_model=8)
    else:
        stats = tr.fit(epochs=epochs, iters_per_epoch=iters,
                       batch_per_model=8)
    return tr, stats


def _assert_params_equal(a, b):
    for x, y in zip(a.params.leaves(), b.params.leaves()):
        assert torch.equal(x, y)
    for x, y in zip(a.opt_state.mu + a.opt_state.nu,
                    b.opt_state.mu + b.opt_state.nu):
        assert torch.equal(x, y)
    assert int(a.opt_state.step) == int(b.opt_state.step)


@pytest.fixture(scope="module")
def clean(partitioned):
    """Fault-free baseline for the default (resident, pipelined) config."""
    tr, stats = _run(partitioned)
    return tr, _losses(stats)


# ---------------------------------------------------------------------------
# Chaos parity, one fault class at a time
# ---------------------------------------------------------------------------

def test_default_policy_is_on(partitioned):
    tr = _trainer(partitioned)
    assert isinstance(tr.resilience, ResiliencePolicy)
    assert tr.resilience.membership and tr.membership is not None
    assert _trainer(partitioned, resilience=False).resilience is None


def test_comm_delay_is_absorbed(partitioned, clean):
    fp = FaultPlan([FaultSpec("comm_delay", epoch=0, it=1, delay_s=0.002),
                    FaultSpec("comm_delay", epoch=1, it=2, delay_s=0.002)])
    tr, stats = _run(partitioned, fp)
    assert fp.fired_count() == 2
    assert _losses(stats) == clean[1]
    assert all(s.epoch_attempts == 1 for s in stats)   # pure wall-clock
    _assert_params_equal(tr, clean[0])


@pytest.mark.parametrize("stack", [1, 2])
def test_comm_drop_is_retried(partitioned, clean, stack):
    """A dropped exchange raises at the comm fault point, before the
    in-place update, so the retry applies the step exactly once — for a
    single dispatch and for a stacked one (its own fault point)."""
    base = clean if stack == 1 else None
    if base is None:
        btr, bst = _run(partitioned, pipeline_stack=stack)
        base = (btr, _losses(bst))
    fp = FaultPlan([FaultSpec("comm_drop", epoch=0, it=2, drops=2,
                              once=False)])
    tr, stats = _run(partitioned, fp, pipeline_stack=stack)
    assert _losses(stats) == base[1]
    assert stats[0].comm_retries >= 2
    assert stats[0].comm_timeouts == 0
    _assert_params_equal(tr, base[0])


def test_split_stack_retry_applies_each_step_once(partitioned):
    """A stacked group whose shapes a budget re-bucket split runs plan by
    plan. A comm drop on its second plan fires before the first plan's
    in-place update, so the retry of the whole group applies each step
    once: losses, parameters and moments equal the same group's without
    the fault."""
    def group(tr):
        # the second plan's batch outgrows the first one's bucket
        return [tr.build_plan(0, 0, 8), tr.build_plan(0, 1, 32)]
    base = _trainer(partitioned, pipeline_stack=2)
    pb = group(base)
    assert pb[0].batch_pad != pb[1].batch_pad
    lb = base._dispatch(pb, 0, 0)
    tr = _trainer(partitioned, pipeline_stack=2)
    pt = group(tr)
    with FaultPlan([FaultSpec("comm_drop", epoch=0, it=1,
                              drops=1)]).active() as fp:
        lt = tr._dispatch(pt, 0, 0)
    assert fp.fired_count() == 1
    assert tr._comm_counters.retries == 1
    assert tr.global_step == base.global_step == 2
    assert torch.equal(lt, lb)
    _assert_params_equal(tr, base)


def test_prefetch_thread_death_replays_bit_identical(partitioned, clean):
    fp = FaultPlan([FaultSpec("thread_exc", epoch=1, it=1,
                              site="prefetch")])
    tr, stats = _run(partitioned, fp)
    assert fp.fired_count() == 1
    assert _losses(stats) == clean[1]
    assert stats[1].bg_errors >= 1
    assert stats[1].epoch_attempts == 2        # one in-mode replay
    assert tr.pipeline                          # no degradation needed
    _assert_params_equal(tr, clean[0])


def test_nan_loss_rolls_back_and_replays(partitioned, clean):
    fp = FaultPlan([FaultSpec("nan_loss", epoch=1, it=1)])
    tr, stats = _run(partitioned, fp)
    assert _losses(stats) == clean[1]
    assert stats[1].rollbacks == 1
    assert np.isfinite(stats[1].loss)
    _assert_params_equal(tr, clean[0])


def test_nan_poisons_the_live_parameters(partitioned):
    """The poison lands in the module's own tensors, so the rollback test
    above passes only if the restore really copies the snapshot back."""
    tr = _trainer(partitioned)
    plan = tr.build_plan(0, 0, 8)
    before = [t for t in tr.params.leaves()]
    with FaultPlan([FaultSpec("nan_loss", epoch=0, it=0)]).active():
        loss = tr._dispatch([plan], 0, 0)
    assert not torch.isfinite(loss).any()
    assert all(a is b for a, b in zip(tr.params.leaves(), before))
    assert all(torch.isnan(t).all() for t in tr.params.leaves())


def test_nan_divergence_exhausts_rollbacks(partitioned):
    # a NaN that re-fires on every replay is genuine divergence
    fp = FaultPlan([FaultSpec("nan_loss", epoch=0, it=0, once=False)])
    with pytest.raises(CheckpointRollbackExhausted):
        _run(partitioned, fp)


def test_stalled_prefetch_hits_deadline_and_recovers(partitioned, clean):
    policy = ResiliencePolicy(stall_deadline_s=0.25)
    fp = FaultPlan([FaultSpec("thread_stall", epoch=0, it=0,
                              site="prefetch", delay_s=1.0)])
    _, stats = _run(partitioned, fp, resilience=policy)
    assert _losses(stats) == clean[1]
    assert stats[0].epoch_attempts >= 2


def test_persistent_comm_drop_raises_comm_timeout(partitioned):
    fp = FaultPlan([FaultSpec("comm_drop", epoch=0, it=1, drops=99,
                              once=False)])
    with pytest.raises(CommTimeout):
        _run(partitioned, fp,
             resilience=ResiliencePolicy(
                 retry=RetryPolicy(max_retries=2, backoff_s=0.001)))


# ---------------------------------------------------------------------------
# Degradation ladder
# ---------------------------------------------------------------------------

def test_persistent_prefetch_fault_degrades_to_sync(partitioned, clean):
    """A prefetch thread that dies on every submission walks the ladder:
    replay in-mode, then pipeline→sync with inline planning — which stops
    tripping the fault (inline planning is not the 'prefetch' site) and
    stays bitwise (the two loops run the same operations)."""
    fp = FaultPlan([FaultSpec("thread_exc", epoch=0, it=-1,
                              site="prefetch", once=False)])
    tr, stats = _run(partitioned, fp)
    assert _losses(stats) == clean[1]
    assert "pipeline_to_sync" in tr.degradations_taken
    assert not tr.pipeline and tr._uploader is None
    assert stats[0].epoch_attempts >= 3
    _assert_params_equal(tr, clean[0])


def test_persistent_uploader_fault_walks_the_ladder(partitioned, clean):
    """An uploader that dies on every commit. The commit runs on the
    prefetch thread, whose supervisor attributes the failure to the
    prefetch site (as in the reference), so the ladder ends at
    pipeline_to_sync — bitwise, and with no uploader left to fail."""
    fp = FaultPlan([FaultSpec("thread_exc", epoch=0, it=-1,
                              site="uploader", once=False)])
    tr, stats = _run(partitioned, fp)
    assert fp.fired_count() >= 2
    assert _losses(stats) == clean[1]
    assert tr.degradations_taken == ["pipeline_to_sync"]
    assert not tr.pipeline and tr._uploader is None
    _assert_params_equal(tr, clean[0])


def test_degrade_rungs_in_order(partitioned):
    tr = _trainer(partitioned, cache_policy="degree",
                  cache_budget_bytes=1 << 14)
    tr.fit(epochs=1, iters_per_epoch=1, batch_per_model=8)
    assert tr._uploader is not None and tr.pipeline
    assert tr._degrade("uploader") == "uploader_off"
    assert tr._uploader is None and tr.pipeline
    assert tr._degrade("uploader") == "pipeline_to_sync"
    assert not tr.pipeline and tr._inline_planning
    assert tr._degrade("comm") is None           # nothing left to drop
    assert tr._degrade("cache") == "cache_off" and tr.cache_store is None
    assert tr._degrade("cache") is None
    assert tr._degrade("readahead") is None      # no streamed store here


def test_persistent_cache_fault_degrades_to_cache_off(partitioned):
    # the epoch-(e+1) cache compute runs during epoch e, so where the
    # failure surfaces depends on thread timing; two failing epochs make
    # the second site failure — and the cache_off rung — certain
    kw = dict(epochs=4, cache_policy="lfu", cache_budget_bytes=1 << 16)
    ctr, cs = _run(partitioned, **kw)
    assert sum(s.cache_hit_rows for s in cs) > 0
    fp = FaultPlan([FaultSpec("thread_exc", epoch=1, site="cache",
                              once=False),
                    FaultSpec("thread_exc", epoch=2, site="cache",
                              once=False)])
    tr, stats = _run(partitioned, fp, **kw)
    assert _losses(stats) == _losses(cs)       # cache parity
    assert "cache_off" in tr.degradations_taken
    assert tr.cache_store is None
    _assert_params_equal(tr, ctr)


def test_persistent_readahead_fault_degrades_to_resident_gather(
        partitioned):
    """A readahead forecast that keeps failing takes the tiered store's
    rung: plan gathers bypass the hot tier and read the backing rows,
    which are the same values — bitwise the fault-free streamed run."""
    from repro_torch.features import FeatureStore
    d = partitioned

    def tiered():
        return FeatureStore.build(d["ds"].features, d["part"], SHARDS,
                                  host_budget_bytes=1 << 18)
    ctr, cs = _run(d, epochs=4, table=tiered())
    fp = FaultPlan([FaultSpec("thread_exc", epoch=1, site="readahead",
                              once=False),
                    FaultSpec("thread_exc", epoch=2, site="readahead",
                              once=False)])
    tr, stats = _run(d, fp, epochs=4, table=tiered())
    assert tr.streamed
    assert _losses(stats) == _losses(cs)
    assert "resident_gather" in tr.degradations_taken
    assert tr.store.hot_bypass and not tr._readahead_enabled
    _assert_params_equal(tr, ctr)
    assert tr._degrade("readahead") is None      # nothing left to drop


# ---------------------------------------------------------------------------
# The headline gate: a mixed recoverable plan, bit-identical
# ---------------------------------------------------------------------------

def test_recoverable_faultplan_headline_gate(partitioned):
    """Thread kill + straggler + dropped exchange + a NaN step in one run
    on the resident store (the reference's recoverable plan without its
    disk_corrupt spec, which corrupts a spilled store's disk tier: the
    streamed variant below runs the whole plan): every kind fires, exactly
    one rollback, losses AND parameters bitwise fault-free."""
    tr1, cs = _run(partitioned, epochs=3, iters=6)
    specs = [sp for sp in FaultPlan.recoverable(seed=3).specs
             if sp.kind != "disk_corrupt"]
    fp = FaultPlan(specs, seed=3)
    tr2, fs = _run(partitioned, fp, epochs=3, iters=6)
    kinds = {k for (k, *_rest) in fp.fired}
    assert kinds == {"thread_exc", "comm_delay", "comm_drop", "nan_loss"}
    assert kinds == {sp.kind for sp in specs}
    assert _losses(fs) == _losses(cs)
    _assert_params_equal(tr1, tr2)
    assert sum(s.rollbacks for s in fs) == 1
    assert sum(s.faults_injected for s in fs) == fp.fired_count() == 4


def test_recoverable_faultplan_headline_gate_streamed(partitioned,
                                                       tmp_path):
    """The reference's full recoverable plan, disk_corrupt included, on a
    streamed run from features spilled to disk (checksums on): all five
    kinds fire, the corrupted chunk is caught and repaired from the source,
    exactly one rollback, and losses and parameters are bitwise the
    fault-free streamed run's."""
    from repro_torch.features import FeatureStore

    def spilled(sub):
        d = partitioned
        return FeatureStore.build(d["ds"].features, d["part"], SHARDS,
                                  directory=str(tmp_path / sub),
                                  host_budget_bytes=d["table"].nbytes // 4)

    tr1, cs = _run(partitioned, epochs=3, iters=6, table=spilled("clean"))
    fp = FaultPlan.recoverable(seed=3)
    tr2, fs = _run(partitioned, fp, epochs=3, iters=6,
                   table=spilled("faulted"))
    assert tr1.streamed and tr2.streamed
    kinds = {k for (k, *_rest) in fp.fired}
    assert kinds == {"thread_exc", "comm_delay", "comm_drop", "nan_loss",
                     "disk_corrupt"}
    assert _losses(fs) == _losses(cs)
    _assert_params_equal(tr1, tr2)
    assert sum(s.rollbacks for s in fs) == 1
    assert sum(s.crc_failures for s in fs) >= 1
    assert sum(s.repaired_rows for s in fs) >= 1
    assert sum(s.faults_injected for s in fs) == fp.fired_count() == 5


def test_recoverable_plan_keeps_the_reference_specs():
    """The port's FaultPlan.recoverable is a copy of the reference's,
    disk_corrupt included."""
    def key(sp):
        return (sp.kind, sp.epoch, sp.it, sp.site, sp.shard, sp.row,
                sp.rows, sp.delay_s, sp.drops, sp.once, sp.transient)
    mine = [key(sp) for sp in FaultPlan.recoverable(seed=3).specs]
    ref = [key(sp) for sp in
           jax_resilience.FaultPlan.recoverable(seed=3).specs]
    assert mine == ref


# ---------------------------------------------------------------------------
# ChaosPlan
# ---------------------------------------------------------------------------

def test_chaos_plan_is_deterministic_and_transient_only():
    a, b = ChaosPlan(seed=11, rate=0.5), ChaosPlan(seed=11, rate=0.5)
    ref = jax_resilience.ChaosPlan(seed=11, rate=0.5)
    for e in range(4):
        for i in range(16):
            sa = a._take("comm_delay", e, i)
            sb = b._take("comm_delay", e, i)
            sr = ref._take("comm_delay", e, i)
            assert [s.delay_s for s in sa] == [s.delay_s for s in sb] \
                == [s.delay_s for s in sr]
    assert a._take("disk_corrupt", 0, 0) == []     # never destructive
    assert a._take("nan_loss", 0, 0) == []
    assert a._take("thread_exc", 0, 0) == []


def test_training_under_chaos_is_bit_identical(partitioned, clean):
    plan = ChaosPlan(seed=5, rate=0.5, max_delay_s=0.001)
    tr, stats = _run(partitioned, plan)
    assert plan.fired_count() > 0
    assert _losses(stats) == clean[1]
    _assert_params_equal(tr, clean[0])


# ---------------------------------------------------------------------------
# Supervisor + retry wrapper units
# ---------------------------------------------------------------------------

def test_supervisor_surfaces_background_error_with_context():
    sup = ThreadSupervisor()
    pool = ThreadPoolExecutor(max_workers=1)
    try:
        def boom():
            raise RuntimeError("dead worker")
        fut = sup.submit(pool.submit, "prefetch", boom, epoch=3, it=7)
        with pytest.raises(BackgroundError) as ei:
            fut.result(timeout=5)
        assert ei.value.site == "prefetch"
        assert (ei.value.epoch, ei.value.it) == (3, 7)
        sup.mark_delivered(ei.value)
        sup.check()                     # delivered once — no double raise
        # an undelivered error raises at the next boundary check
        sup.submit(pool.submit, "cache", boom, epoch=4, it=-1).exception(
            timeout=5)
        with pytest.raises(BackgroundError) as ei2:
            sup.check()
        assert ei2.value.site == "cache" and ei2.value.epoch == 4
        assert sup.drain() == []
    finally:
        pool.shutdown(wait=False)


def test_resilient_call_retries_then_times_out():
    counters = CommCounters()
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] <= 2:
            raise TransientCommError("drop")
        return "ok"
    out = resilient_call(flaky, policy=RetryPolicy(backoff_s=0.0001),
                         counters=counters)
    assert out == "ok" and counters.retries == 2 and counters.timeouts == 0

    def dead():
        raise TransientCommError("drop")
    with pytest.raises(CommTimeout) as ei:
        resilient_call(dead, policy=RetryPolicy(max_retries=2,
                                                backoff_s=0.0001),
                       counters=counters, epoch=1, it=2)
    assert counters.timeouts == 1
    assert (ei.value.epoch, ei.value.it) == (1, 2)


# ---------------------------------------------------------------------------
# SIGKILL mid-epoch + resume (subprocess)
# ---------------------------------------------------------------------------

def _run_py(code: str, expect_signal=None) -> dict:
    out = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(code)],
        capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 OMP_NUM_THREADS="1"),
        timeout=600)
    if expect_signal is not None:
        assert out.returncode == -expect_signal, out.stderr[-2000:]
        return {}
    assert out.returncode == 0, out.stderr[-3000:]
    for line in out.stdout.splitlines():
        if line.startswith("RESULT:"):
            return json.loads(line[len("RESULT:"):])
    raise AssertionError(f"no RESULT line in:\n{out.stdout}\n{out.stderr}")


_SIGKILL_PRELUDE = """
import json, os, signal
import torch
from repro_torch.graph import make_dataset
from repro_torch.graph.partition import community_partition, shard_features
from repro_torch.models.gnn import GNNConfig
from repro_torch.optim import adam
from repro_torch.train import Trainer

ds = make_dataset("products", scale=0.03, seed=0)
part = community_partition(ds.communities, 4)
table, owner, local_idx = shard_features(ds.features, part, 4)
cfg = GNNConfig(model="sage", num_layers=2, hidden_dim=32,
                feature_dim=ds.feature_dim, num_classes=ds.num_classes,
                fanout=4)

def trainer(ckpt):
    return Trainer(graph=ds.graph, labels=ds.labels, part=part,
                   owner=owner, local_idx=local_idx, table=table, cfg=cfg,
                   optimizer=adam(5e-3), merging=False, root_seed=5,
                   train_vertices=ds.train_vertices(), ckpt_dir=ckpt,
                   device="cpu")
"""


def test_sigkill_mid_epoch_resume_is_bit_identical(tmp_path):
    """Kill -9 the training process in the middle of epoch 2 (after epoch
    1's checkpoint is durable), resume from disk, and require the final
    parameters to match an uninterrupted run bit for bit."""
    ck = str(tmp_path / "ck")
    _run_py(_SIGKILL_PRELUDE + f"""
tr = trainer({ck!r})
orig = tr.build_plan
def killing(epoch, it, batch):
    if (epoch, it) == (2, 1):
        os.kill(os.getpid(), signal.SIGKILL)
    return orig(epoch, it, batch)
tr.build_plan = killing
tr.fit(epochs=3, iters_per_epoch=3, batch_per_model=8)
""", expect_signal=9)
    res = _run_py(_SIGKILL_PRELUDE + f"""
tr = trainer({ck!r})
stats = tr.fit(epochs=3, iters_per_epoch=3, batch_per_model=8,
               resume=True)
tr2 = trainer(None)
tr2.fit(epochs=3, iters_per_epoch=3, batch_per_model=8)
same = all(torch.equal(a, b)
           for a, b in zip(tr.params.leaves(), tr2.params.leaves()))
print("RESULT:" + json.dumps({{
    "resumed_epochs": [s.epoch for s in stats], "identical": same}}))
""")
    assert res["resumed_epochs"] == [2]
    assert res["identical"]
