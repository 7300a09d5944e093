"""Checkpoint and resume of the port's Trainer at a small size (products
at scale 0.03, 4 shards, SAGE 2 layers, hidden 32, fanout 4).

Within the port a resumed run is bitwise the straight run: parameters,
optimizer state and the merge pattern come back from the checkpoint, the
budget's buckets from its ``extra``, and plans are a pure function of
(epoch, it, seeds). Against the reference, the resumed epoch's loss is
held to the 1e-6 relative tolerance ``tests/test_torch_train.py`` uses for
``Trainer.fit`` (two backends summing in different orders).
"""
import jax
import numpy as np
import pytest
import torch

import repro.graph as jax_graph
import repro.models.gnn.models as jax_models
import repro.optim as jax_optim
import repro.train as jax_train
import repro_torch.core.distributed as engine
import repro_torch.core.merging as torch_merging
import repro_torch.graph as torch_graph
import repro_torch.models.gnn.models as torch_models
import repro_torch.optim as torch_optim
import repro_torch.train as torch_train
from repro_torch.checkpoint import save_checkpoint
from repro_torch.graph.partition import community_partition, shard_features

SHARDS = 4
FIT_RTOL = 1e-6
KEY = ("cos", 3e-3, 2, 9)


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
    ds_j = jax_graph.make_dataset("products", scale=0.03, seed=0)
    ds_t = torch_graph.make_dataset("products", scale=0.03, seed=0)
    part = community_partition(ds_t.communities, SHARDS)
    table, owner, local_idx = shard_features(ds_t.features, part, SHARDS)
    kw = dict(model="sage", num_layers=2, hidden_dim=32,
              feature_dim=ds_t.feature_dim, num_classes=ds_t.num_classes,
              fanout=4)
    return dict(ds_j=ds_j, ds_t=ds_t, part=part, table=table, owner=owner,
                local_idx=local_idx, cfg_j=jax_models.GNNConfig(**kw),
                cfg_t=torch_models.GNNConfig(**kw),
                tree=jax_models.init_gnn(jax.random.PRNGKey(0),
                                         jax_models.GNNConfig(**kw)))


def _common(w, ds, **kw):
    out = dict(graph=ds.graph, labels=ds.labels, part=w["part"],
               owner=w["owner"], local_idx=w["local_idx"], table=w["table"],
               train_vertices=ds.train_vertices(), root_seed=5)
    out.update(kw)
    return out


def _port(w, **kw):
    kw.setdefault("merging", False)
    return torch_train.Trainer(
        **_common(w, w["ds_t"], **kw), cfg=w["cfg_t"], device="cpu",
        optimizer=torch_optim.adamw(torch_optim.cosine_schedule(3e-3, 2, 9),
                                    weight_decay=1e-4, grad_clip=1.0,
                                    key=KEY),
        params=torch_models.params_from_jax(w["tree"], device="cpu"))


def _ref(w, **kw):
    kw.setdefault("merging", False)
    return jax_train.Trainer(
        **_common(w, w["ds_j"], **kw), cfg=w["cfg_j"], params=w["tree"],
        optimizer=jax_optim.adamw(jax_optim.cosine_schedule(3e-3, 2, 9),
                                  weight_decay=1e-4, grad_clip=1.0,
                                  key=KEY))


def _same_state(a, b):
    for x, y in zip(a.params.leaves(), b.params.leaves()):
        assert torch.equal(x, y)
    assert int(a.opt_state.step) == int(b.opt_state.step)
    for x, y in zip(a.opt_state.mu + a.opt_state.nu,
                    b.opt_state.mu + b.opt_state.nu):
        assert torch.equal(x, y)


@pytest.fixture
def scripted_merging(monkeypatch):
    """An epoch's time is its merge pattern's step count, so every merge
    improves it and the §5.3 walk goes 4, 3, 2 in every run whatever the
    wall clock says; the straight run and the resumed one then choose the
    same pattern for epoch 2."""
    orig = torch_merging.MergingController.record_epoch_time

    def scripted(self, seconds):
        orig(self, float(self.pattern_steps))
    monkeypatch.setattr(torch_merging.MergingController,
                        "record_epoch_time", scripted)


@pytest.mark.parametrize("merging", [False, True])
def test_resume_matches_straight_run(world, tmp_path, merging,
                                     scripted_merging):
    """Two epochs, a new Trainer resumes at epoch 2: its loss and its
    parameters and moments equal the straight three-epoch run's, with the
    merge pattern restored from the checkpoint when merging is on."""
    ck = str(tmp_path / "ck")
    _port(world, ckpt_dir=ck, merging=merging).fit(
        epochs=2, iters_per_epoch=3, batch_per_model=8)
    tr = _port(world, ckpt_dir=ck, merging=merging)
    stats = tr.fit(epochs=3, iters_per_epoch=3, batch_per_model=8,
                   resume=True)
    assert [s.epoch for s in stats] == [2]            # epochs 0-1 skipped
    assert tr.global_step == 9
    straight = _port(world, merging=merging)
    st = straight.fit(epochs=3, iters_per_epoch=3, batch_per_model=8)
    assert stats[0].loss == st[2].loss
    assert stats[0].num_steps == st[2].num_steps
    if merging:
        assert [s.num_steps for s in st] == [4, 3, 2]
    _same_state(tr, straight)


def test_resume_restores_budget_no_first_epoch_retrace(world, tmp_path):
    """With budget_state in the checkpoint's extra, the resumed Trainer
    plans into the original buckets: no probe and no new signature."""
    ck = str(tmp_path / "ck")
    tr1 = _port(world, ckpt_dir=ck)
    tr1.fit(epochs=2, iters_per_epoch=2, batch_per_model=8)
    tr2 = _port(world, ckpt_dir=ck)
    tc0 = engine.trace_count()
    stats = tr2.fit(epochs=3, iters_per_epoch=2, batch_per_model=8,
                    resume=True)
    assert tr2.budget.buckets == tr1.budget.buckets
    assert tr2.budget.c_max == tr1.budget.c_max
    assert tr2.budget.probes == 0                 # bucket known, no probe
    assert engine.trace_count() == tc0
    assert stats[0].traces == 0


def test_resume_when_checkpoint_covers_every_epoch(world, tmp_path):
    ck = str(tmp_path / "ck")
    _port(world, ckpt_dir=ck).fit(epochs=2, iters_per_epoch=2,
                                  batch_per_model=8)
    tr = _port(world, ckpt_dir=ck)
    assert tr.fit(epochs=2, iters_per_epoch=2, batch_per_model=8,
                  resume=True) == []
    assert tr.global_step == 4
    # no checkpoint at all: resume starts from epoch 0
    fresh = _port(world, ckpt_dir=str(tmp_path / "empty"))
    assert [s.epoch for s in fresh.fit(epochs=1, iters_per_epoch=1,
                                       batch_per_model=8,
                                       resume=True)] == [0]


def test_resume_from_bare_params_reinits_the_optimizer(world, tmp_path):
    """A checkpoint of parameters alone (no optimizer state) resumes its
    parameters and starts the optimizer afresh."""
    ck = tmp_path / "ck"
    src = _port(world)
    src.fit(epochs=1, iters_per_epoch=2, batch_per_model=8)
    save_checkpoint(ck, 2, src.params, extra={"epoch": 0})
    tr = _port(world, ckpt_dir=str(ck))
    stats = tr.fit(epochs=2, iters_per_epoch=2, batch_per_model=8,
                   resume=True)
    assert [s.epoch for s in stats] == [1]
    assert tr.global_step == 4 and int(tr.opt_state.step) == 2


def test_resumed_losses_match_reference(world, tmp_path):
    """The reference and the port each train two epochs into their own
    checkpoints and resume for the third: per-epoch losses agree within
    FIT_RTOL, and the resumed runs start from the same step."""
    cj, ct = str(tmp_path / "jax"), str(tmp_path / "torch")
    first_j = _ref(world, ckpt_dir=cj).fit(epochs=2, iters_per_epoch=3,
                                           batch_per_model=8)
    first_t = _port(world, ckpt_dir=ct).fit(epochs=2, iters_per_epoch=3,
                                            batch_per_model=8)
    tj, tt = _ref(world, ckpt_dir=cj), _port(world, ckpt_dir=ct)
    st_j = tj.fit(epochs=3, iters_per_epoch=3, batch_per_model=8,
                  resume=True)
    st_t = tt.fit(epochs=3, iters_per_epoch=3, batch_per_model=8,
                  resume=True)
    assert [s.epoch for s in st_j] == [s.epoch for s in st_t] == [2]
    assert tj.global_step == tt.global_step == 9
    np.testing.assert_allclose([s.loss for s in first_t + st_t],
                               [s.loss for s in first_j + st_j],
                               rtol=FIT_RTOL)
    assert [s.remote_rows for s in st_t] == [s.remote_rows for s in st_j]
