"""repro_torch.membership: peer-death detection, re-ownership and resume
in the port's Trainer, at a small size (products at scale 0.03, 4 shards,
SAGE 2 layers, hidden 32, fanout 4).

* a persistent ``peer_death`` mid-epoch is detected through the comm
  deadline, confirmed by the bounded probe, and recovered — same-world
  **rejoin** resumes bitwise the fault-free run (losses AND parameters);
* **elastic shrink** (redistribute/adopt) re-owns the lost shard's
  vertices, rebuilds every world-shaped structure, and continues at P-1:
  its per-epoch losses agree with the reference's Trainer under the same
  fault within 1e-6 relative, and stay within the reference's own sanity
  bound (0.35 relative) of a fresh P-1 run;
* plans of an older generation are refused at dispatch and at upload.

The world maps come from host code copied from the reference, so they are
held to the reference's bit for bit.
"""
import types

import jax
import numpy as np
import pytest
import torch

import repro.core.distributed as jax_engine
import repro.graph as jax_graph
import repro.graph.partition as jax_partition
import repro.membership as jax_membership
import repro.models.gnn.models as jax_models
import repro.optim as jax_optim
import repro.resilience as jax_resilience
import repro.train as jax_train
import repro_torch.core.distributed as engine
import repro_torch.graph as torch_graph
from repro_torch.features import FeatureStore
from repro_torch.graph.partition import (community_partition,
                                         reassign_partition, shard_features)
from repro_torch.membership import (MembershipView, PeerProbe,
                                    StaleGeneration, peer_of, rebuild_world)
from repro_torch.models.gnn import GNNConfig, params_from_jax
from repro_torch.optim import adam
from repro_torch.resilience import (CommTimeout, FaultPlan, FaultSpec,
                                    PeerDeadError, ResiliencePolicy,
                                    RetryPolicy, backoff_schedule,
                                    resilient_call)
from repro_torch.train import PlanUploader, Trainer

SHARDS = 4
FIT_RTOL = 1e-6


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
    return dict(ds=ds, parts=SHARDS, part=part, table=table, owner=owner,
                local_idx=local_idx)


@pytest.fixture(autouse=True)
def _clean_registry():
    """The dead-peer registry is process-global; a test that kills a peer
    and fails before recovery must not poison its neighbours."""
    yield
    for p in list(engine.dead_peers()):
        engine.revive_peer(p)
    for p in list(jax_engine.dead_peers()):
        jax_engine.revive_peer(p)


def _cfg(d):
    return GNNConfig(model="sage", num_layers=2, hidden_dim=32,
                     feature_dim=d["ds"].feature_dim,
                     num_classes=d["ds"].num_classes, fanout=4)


def _trainer(d, **kw):
    kw.setdefault("optimizer", adam(5e-3))
    kw.setdefault("merging", False)
    kw.setdefault("train_vertices", d["ds"].train_vertices())
    return Trainer(graph=d["ds"].graph, labels=d["ds"].labels,
                   part=d["part"], owner=d["owner"],
                   local_idx=d["local_idx"], table=d["table"], cfg=_cfg(d),
                   device="cpu", **kw)


def _losses(stats):
    return [s.loss for s in stats]


def _assert_params_equal(a, b):
    for x, y in zip(a.params.leaves(), b.params.leaves()):
        assert torch.equal(x, y)


def _policy(mode="rejoin", retries=2):
    return ResiliencePolicy(
        retry=RetryPolicy(max_retries=retries, backoff_s=0.001,
                          deadline_s=5.0),
        membership_mode=mode, probe_backoff_s=0.0)


# ---------------------------------------------------------------------------
# MembershipView + generation discipline
# ---------------------------------------------------------------------------

def test_view_state_machine():
    v = MembershipView(4)
    assert v.world_size() == 4 and v.generation == 0
    v.mark_suspect(2, epoch=1)
    assert v.is_suspect(2) and v.is_alive(2)
    assert v.generation == 0          # suspicion never bumps the world
    v.clear_suspect(2)
    assert not v.is_suspect(2)
    g = v.confirm_dead(2, epoch=1)
    assert g == 1 and not v.is_alive(2) and v.world_size() == 3
    assert v.alive_shards() == [0, 1, 3]
    assert v.confirm_dead(2, epoch=1) == 1    # idempotent
    assert v.rejoin(2, epoch=1) == 2
    assert v.is_alive(2) and v.world_size() == 4
    v.confirm_dead(3, epoch=2)
    assert v.shrink(3, epoch=2) == 4
    assert v.num_shards == 3 and v.world_size() == 3
    kinds = [e[0] for e in v.events]
    assert kinds == ["suspect", "dead", "rejoin", "dead", "shrink"]


def test_stale_generation_refused():
    v = MembershipView(4)
    v.check_generation(-1, epoch=0, it=0)     # unstamped passes
    v.check_generation(0, epoch=0, it=0)      # current passes
    v.confirm_dead(1, epoch=0)
    with pytest.raises(StaleGeneration) as ei:
        v.check_generation(0, epoch=0, it=3)
    assert ei.value.have == 0 and ei.value.want == 1
    assert ei.value.site == "membership"


def test_shrink_one_shard_world_rejected():
    with pytest.raises(ValueError):
        MembershipView(1).shrink(0)


# ---------------------------------------------------------------------------
# Deterministic re-ownership: the reference's maps, bit for bit
# ---------------------------------------------------------------------------

def test_reassign_redistribute_is_deterministic_and_balanced():
    part = np.random.default_rng(0).integers(0, 4, size=1000).astype(
        np.int32)
    a = reassign_partition(part, 1, mode="redistribute")
    np.testing.assert_array_equal(a, reassign_partition(
        part, 1, mode="redistribute"))
    np.testing.assert_array_equal(a, jax_partition.reassign_partition(
        part, 1, mode="redistribute"))
    assert a.min() >= 0 and a.max() <= 2      # compacted to 3 shards
    old = part.copy()
    old[old > 1] -= 1
    keep = part != 1
    np.testing.assert_array_equal(a[keep], old[keep])
    lost_counts = np.bincount(a[part == 1], minlength=3)
    assert lost_counts.max() - lost_counts.min() <= 1


def test_reassign_adopt_and_errors():
    part = np.random.default_rng(1).integers(0, 4, size=500).astype(
        np.int32)
    sizes = np.bincount(part, minlength=4)
    smallest = int(np.argmin(np.where(np.arange(4) == 2, np.iinfo(int).max,
                                      sizes)))
    a = reassign_partition(part, 2, mode="adopt")
    tgt = smallest if smallest < 2 else smallest - 1
    assert set(a[part == 2]) == {tgt}         # one adopter takes the shard
    for kw in (dict(mode="nope"), dict(mode="adopt", adopter=2)):
        with pytest.raises(ValueError):
            reassign_partition(part, 2, **kw)
    with pytest.raises(ValueError):
        reassign_partition(part, 7)


@pytest.mark.parametrize("mode", ["redistribute", "adopt"])
@pytest.mark.parametrize("dead", [0, 3])
def test_rebuild_world_matches_reference(mode, dead):
    part = np.random.default_rng(2).integers(0, 4, size=800).astype(
        np.int32)
    wr = rebuild_world(part, dead, 4, mode=mode)
    ref = jax_membership.rebuild_world(part, dead, 4, mode=mode)
    for f in ("part", "owner", "local_idx"):
        a, b = getattr(wr, f), getattr(ref, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    for f in ("max_part_size", "num_shards", "dead", "mode", "moved_rows"):
        assert getattr(wr, f) == getattr(ref, f), f
    for s in range(3):            # a dense 0..size-1 numbering per shard
        rows = np.sort(wr.local_idx[wr.part == s])
        np.testing.assert_array_equal(rows, np.arange(rows.size))
    assert wr.moved_rows >= int((part == dead).sum())
    with pytest.raises(ValueError):
        rebuild_world(part, dead, 4, mode="rejoin")


# ---------------------------------------------------------------------------
# Detection: attribution, probe, timeout plumbing, backoff
# ---------------------------------------------------------------------------

def test_peer_of_walks_cause_chain():
    try:
        try:
            raise PeerDeadError("inner", peer=3)
        except PeerDeadError as inner:
            raise CommTimeout("outer") from inner
    except CommTimeout as e:
        assert peer_of(e) == 3
    assert peer_of(RuntimeError("no peer")) == -1
    assert peer_of(CommTimeout("stamped", peer=1)) == 1


def test_probe_confirms_death_and_clears_flap():
    engine.kill_peer(2)
    try:
        pr = PeerProbe(attempts=3, backoff_s=0.0).confirm(2)
        assert not pr.alive and pr.attempts == 3
    finally:
        engine.revive_peer(2)
    pr = PeerProbe(attempts=3, backoff_s=0.0).confirm(2)
    assert pr.alive and pr.attempts == 1      # first answer clears it


def test_dead_peer_timeout_carries_attribution():
    engine.kill_peer(1)
    plan = types.SimpleNamespace(epoch_it=(0, 0))
    try:
        with pytest.raises(CommTimeout) as ei:
            resilient_call(lambda: engine.comm_fault_point(plan),
                           policy=RetryPolicy(max_retries=1,
                                              backoff_s=0.0001),
                           epoch=0, it=0)
        assert ei.value.peer == 1
    finally:
        engine.revive_peer(1)
    assert engine.comm_fault_point(plan) is None   # registry empty again


def test_backoff_schedule_is_deterministic_bounded_and_the_reference():
    kw = dict(max_retries=4, backoff_s=0.01, backoff_mult=2.0, jitter=0.5)
    pol = RetryPolicy(seed=3, **kw)
    a = backoff_schedule(pol, epoch=1, it=2)
    assert a == backoff_schedule(pol, epoch=1, it=2) and len(a) == 4
    assert a == jax_resilience.backoff_schedule(
        jax_resilience.RetryPolicy(seed=3, **kw), epoch=1, it=2)
    plain = [0.01 * 2.0 ** k for k in range(4)]
    for got, base in zip(a, plain):
        assert base * 0.5 <= got <= base      # never longer than unjittered
    assert a != backoff_schedule(pol, epoch=1, it=3)   # decorrelated
    assert a != backoff_schedule(RetryPolicy(seed=4, **kw), epoch=1, it=2)
    assert backoff_schedule(RetryPolicy(**dict(kw, jitter=0.0)),
                            epoch=1, it=2) == plain


def test_feature_store_reshard_serves_identical_rows(partitioned):
    d = partitioned
    store = FeatureStore.from_array(d["table"], owner=d["owner"],
                                    local_idx=d["local_idx"])
    wr = rebuild_world(d["part"], 1, d["parts"], mode="redistribute")
    st2 = store.reshard(wr.part, wr.num_shards)
    assert st2.num_shards == d["parts"] - 1
    ids = np.arange(d["part"].shape[0])
    np.testing.assert_array_equal(store.take_global(ids),
                                  st2.take_global(ids))


# ---------------------------------------------------------------------------
# End-to-end recovery in the Trainer
# ---------------------------------------------------------------------------

def test_peer_death_rejoin_is_bit_identical(partitioned, tmp_path):
    """Persistent peer death mid-epoch: detected via the comm deadline,
    confirmed by the probe, recovered by rejoin + resume from the shared
    checkpoint — losses and parameters bitwise the fault-free run's."""
    d = partitioned
    clean_tr = _trainer(d, resilience=_policy())
    clean_stats = clean_tr.fit(epochs=3, iters_per_epoch=4,
                               batch_per_model=8)
    fp = FaultPlan([FaultSpec("peer_death", epoch=2, it=1, shard=1)])
    tr = _trainer(d, resilience=_policy(), ckpt_dir=str(tmp_path / "ck"))
    with fp.active():
        stats = tr.fit(epochs=3, iters_per_epoch=4, batch_per_model=8)
    assert fp.fired_count() == 1
    assert _losses(stats) == _losses(clean_stats)
    _assert_params_equal(tr, clean_tr)
    assert tr.membership_recoveries == 1
    assert tr.degradations_taken == ["membership_rejoin"]
    assert tr.membership.generation == 2      # death + rejoin
    assert stats[2].epoch_attempts == 2
    assert stats[2].membership_recoveries == 1
    assert stats[2].membership_generation == 2
    assert stats[2].comm_timeouts >= 1        # detection went via deadline
    assert engine.dead_peers() == frozenset()
    assert [r["rung"] for r in tr.recovery_log] == ["membership_rejoin"]


def test_peer_death_rejoin_without_checkpoint(partitioned):
    """No ckpt_dir: the epoch-start snapshot is the restore point and the
    recovery is still bitwise."""
    d = partitioned
    clean_tr = _trainer(d, resilience=_policy())
    clean_stats = clean_tr.fit(epochs=2, iters_per_epoch=4,
                               batch_per_model=8)
    fp = FaultPlan([FaultSpec("peer_death", epoch=1, it=2, shard=2)])
    tr = _trainer(d, resilience=_policy())
    with fp.active():
        stats = tr.fit(epochs=2, iters_per_epoch=4, batch_per_model=8)
    assert _losses(stats) == _losses(clean_stats)
    _assert_params_equal(tr, clean_tr)
    assert tr.degradations_taken == ["membership_rejoin"]


@pytest.mark.parametrize("mode", ["redistribute", "adopt"])
def test_peer_death_elastic_shrink(partitioned, mode):
    """Elastic shrink: the world compacts to P-1 mid-run (table, cache,
    uploader rebuilt), training continues within loss tolerance of a fresh
    P-1 run, and the epoch after the recovery has no new signature."""
    d = partitioned
    fp = FaultPlan([FaultSpec("peer_death", epoch=1, it=2, shard=1)])
    tr = _trainer(d, resilience=_policy(mode=mode))
    with fp.active():
        stats = tr.fit(epochs=4, iters_per_epoch=4, batch_per_model=8)
    assert tr.num_shards == d["parts"] - 1
    assert tuple(tr.table.shape[:2]) == (d["parts"] - 1,
                                         tr.store.local_rows)
    assert tr._uploader.view is tr.membership
    assert tr.degradations_taken == [f"membership_{mode}"]
    assert tr.membership.generation == 2       # death + shrink
    assert engine.dead_peers() == frozenset()
    assert all(np.isfinite(s.loss) for s in stats)
    assert stats[-1].loss < stats[0].loss      # still converging
    assert stats[-1].traces == 0               # steady after the recovery
    p3 = d["parts"] - 1
    ds = d["ds"]
    part3 = community_partition(ds.communities, p3)
    t3, o3, l3 = shard_features(ds.features, part3, p3)
    base = Trainer(graph=ds.graph, labels=ds.labels, part=part3, owner=o3,
                   local_idx=l3, table=t3, cfg=_cfg(d),
                   optimizer=adam(5e-3), merging=False,
                   train_vertices=ds.train_vertices(), device="cpu",
                   resilience=_policy())
    bstats = base.fit(epochs=4, iters_per_epoch=4, batch_per_model=8)
    assert abs(stats[-1].loss - bstats[-1].loss) <= \
        0.35 * max(abs(bstats[-1].loss), 1e-6)


@pytest.mark.parametrize("mode", ["redistribute", "adopt"])
def test_elastic_shrink_matches_reference(partitioned, mode):
    """The same peer death under the same policy, from the same weights,
    in the reference's Trainer and the port's: the shrunk run's per-epoch
    losses agree within FIT_RTOL (the tolerance of ``Trainer.fit`` in
    tests/test_torch_train.py), so the rebuilt owner map, table, cache and
    uploader feed the port's engine the rows the reference's gets."""
    d = partitioned
    ds_j = jax_graph.make_dataset("products", scale=0.03, seed=0)
    cfg = _cfg(d)
    cfg_j = jax_models.GNNConfig(
        model=cfg.model, num_layers=cfg.num_layers,
        hidden_dim=cfg.hidden_dim, feature_dim=cfg.feature_dim,
        num_classes=cfg.num_classes, fanout=cfg.fanout)
    tree = jax_models.init_gnn(jax.random.PRNGKey(0), cfg_j)
    run = dict(epochs=4, iters_per_epoch=4, batch_per_model=8)
    spec = dict(epoch=1, it=2, shard=1)

    ref = jax_train.Trainer(
        graph=ds_j.graph, labels=ds_j.labels, part=d["part"],
        owner=d["owner"], local_idx=d["local_idx"], table=d["table"],
        cfg=cfg_j, params=tree, optimizer=jax_optim.adam(5e-3),
        merging=False, train_vertices=ds_j.train_vertices(),
        resilience=jax_resilience.ResiliencePolicy(
            retry=jax_resilience.RetryPolicy(max_retries=2, backoff_s=0.001,
                                             deadline_s=5.0),
            membership_mode=mode, probe_backoff_s=0.0))
    with jax_resilience.FaultPlan(
            [jax_resilience.FaultSpec("peer_death", **spec)]).active():
        st_j = ref.fit(**run)
    tr = _trainer(d, resilience=_policy(mode=mode),
                  params=params_from_jax(tree, device="cpu"))
    with FaultPlan([FaultSpec("peer_death", **spec)]).active():
        st_t = tr.fit(**run)

    assert ref.degradations_taken == tr.degradations_taken == \
        [f"membership_{mode}"]
    assert ref.num_shards == tr.num_shards == d["parts"] - 1
    assert np.array_equal(np.asarray(ref.owner), tr.owner)
    assert np.array_equal(np.asarray(ref.local_idx), tr.local_idx)
    assert [s.remote_rows for s in st_t] == [s.remote_rows for s in st_j]
    assert [s.num_steps for s in st_t] == [s.num_steps for s in st_j]
    np.testing.assert_allclose(_losses(st_t), _losses(st_j), rtol=FIT_RTOL)


def test_elastic_shrink_rebuilds_the_cache(partitioned):
    """The cache store and its forecast are rebuilt against the new world
    and refill at the next epoch boundary (the LFU policy's prefetch; a
    static degree cache stays cold after a shrink, as in the
    reference)."""
    d = partitioned
    fp = FaultPlan([FaultSpec("peer_death", epoch=1, it=1, shard=3)])
    tr = _trainer(d, resilience=_policy(mode="redistribute"),
                  cache_policy="lfu", cache_budget_bytes=1 << 14)
    with fp.active():
        stats = tr.fit(epochs=3, iters_per_epoch=3, batch_per_model=8)
    assert tr.cache_store.num_shards == d["parts"] - 1
    assert tuple(tr.cache_store.device_table.shape[:1]) == (
        d["parts"] - 1,)
    assert stats[-1].cache_hit_rows > 0
    assert all(np.isfinite(s.loss) for s in stats)


def test_transient_flap_absorbed_with_zero_trace(partitioned):
    """A flapping peer is absorbed by the retry guard: bit-parity holds,
    no membership change, generation stays 0."""
    d = partitioned
    clean_tr = _trainer(d, resilience=_policy())
    clean_stats = clean_tr.fit(epochs=2, iters_per_epoch=4,
                               batch_per_model=8)
    fp = FaultPlan([FaultSpec("peer_death", epoch=0, it=1, shard=3,
                              transient=True, drops=1, once=False)])
    tr = _trainer(d, resilience=_policy())
    with fp.active():
        stats = tr.fit(epochs=2, iters_per_epoch=4, batch_per_model=8)
    assert _losses(stats) == _losses(clean_stats)
    _assert_params_equal(tr, clean_tr)
    assert stats[0].comm_retries >= 1
    assert tr.membership.generation == 0
    assert tr.membership_recoveries == 0


def test_probe_false_positive_clears_suspicion(partitioned):
    tr = _trainer(partitioned, resilience=_policy())
    rung = tr._recover(CommTimeout("ghost", peer=2, epoch=0, it=0), 0)
    assert rung is None
    assert not tr.membership.is_suspect(2)
    assert tr.membership.generation == 0
    assert tr.membership_recoveries == 0
    assert tr._site_failures.get("comm") == 1  # fell through to comm path


def test_stale_plan_refused_at_dispatch_and_upload(partitioned):
    tr = _trainer(partitioned, resilience=_policy())
    plan = tr.build_plan(0, 0, 8)
    assert plan.generation == 0 and plan.epoch_it == (0, 0)
    tr.membership.confirm_dead(3, epoch=0)     # the world moved on
    with pytest.raises(StaleGeneration):
        tr._dispatch([plan], 0, 0)
    assert tr.global_step == 0                 # nothing was applied
    up = PlanUploader(view=tr.membership, device="cpu")
    with pytest.raises(StaleGeneration):
        up.commit(plan)
    assert up.uploads == 0                     # refused before staging
