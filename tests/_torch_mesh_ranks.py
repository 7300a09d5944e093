"""One rank of the port's sharded engine and Trainer over a 4-process gloo
mesh on the CPU; tests/test_torch_mesh.py spawns four of these with
``torch.multiprocessing.spawn`` and checks what they save.

Imports torch and repro_torch only (never JAX), so each process starts
quickly. Every rank runs the same program with the same seeds, builds the
same plans, and saves ``rank{r}.pt`` in the output directory: per case the
loss and gradient leaves, the collective counts, the fit losses and final
parameters, the merge patterns, and what the faulted and shrinking runs
did. The world is the reference's own sharded test's: arxiv at scale 0.02,
an LDG partition into 4 shards, 8 roots per model, SAGE or GCN with 2
layers of 16 and fanout 4.
"""
from __future__ import annotations

import copy
import dataclasses
import datetime
import os

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.core import distributed as engine
from repro_torch.core import plan_iteration
from repro_torch.features import FeatureStore
from repro_torch.graph import make_dataset
from repro_torch.graph.partition import ldg_partition, shard_features
from repro_torch.models.gnn import GNNConfig
from repro_torch.optim import adamw, cosine_schedule
from repro_torch.resilience import (FaultPlan, FaultSpec, ResiliencePolicy,
                                    RetryPolicy)
from repro_torch.train import Trainer
from repro_torch.train.pipeline import stack_committed

WORLD = 4
ROOTS_PER_MODEL = 8
SAMPLE_SEED = 3
MODES = {"pregather": dict(pregather=True, fold=None, tiered=False),
         "per-step": dict(pregather=False, fold=False, tiered=False),
         "per-step folded": dict(pregather=False, fold=True, tiered=False),
         "streamed": dict(pregather=True, fold=None, tiered=True)}
FIT = dict(epochs=3, iters_per_epoch=3, batch_per_model=8)
CACHE_ROWS = 32      # degree-policy cache rows per shard
FAULTS = {
    "comm": [FaultSpec("comm_drop", epoch=1, it=0, drops=1),
             FaultSpec("comm_delay", epoch=1, it=2, delay_s=0.002),
             FaultSpec("thread_exc", epoch=2, it=1, site="prefetch")],
    "nan": [FaultSpec("nan_loss", epoch=1, it=1)],
}


def world():
    """The dataset, partition and sharded table every rank builds."""
    ds = make_dataset("arxiv", scale=0.02, seed=0)
    part = ldg_partition(ds.graph, WORLD, passes=1)
    table, owner, local_idx = shard_features(ds.features, part, WORLD)
    return ds, part, table, owner, local_idx


def cfg_of(ds, model: str) -> GNNConfig:
    return GNNConfig(model=model, num_layers=2, hidden_dim=16,
                     feature_dim=ds.feature_dim, num_classes=ds.num_classes,
                     fanout=4)


def roots_of(ds, seed: int = 0):
    rng = np.random.default_rng(seed)
    tv = ds.train_vertices()
    return [rng.choice(tv, ROOTS_PER_MODEL, replace=False)
            for _ in range(WORLD)]


def tiered(table, owner, local_idx):
    """An in-RAM tiered store: a hot tier of a third of the table."""
    return FeatureStore.from_array(table, owner=owner, local_idx=local_idx,
                                   host_budget_bytes=table.nbytes // 3)


def make_plan(ds, part, table, owner, local_idx, roots, mode: str, **kw):
    m = MODES[mode]
    store = tiered(table, owner, local_idx) if m["tiered"] else None
    return plan_iteration(ds.graph, ds.labels, part, owner, local_idx,
                          table.shape[1], roots, num_layers=2, fanout=4,
                          strategy="hopgnn", pregather=m["pregather"],
                          sample_seed=SAMPLE_SEED, feature_store=store, **kw)


def fit_optimizer():
    key = ("cos", 3e-3, 2, 9)
    return adamw(cosine_schedule(3e-3, 2, 9), weight_decay=1e-4,
                 grad_clip=1.0, key=key)


def leaves(xs) -> list:
    return [x.detach().clone() for x in xs]


def run_rank(rank: int, out_dir: str, params: dict) -> None:
    """The spawned entry point (rank first, as spawn passes it).
    ``params[model]`` is the port GNN converted from the reference's init,
    shared by every rank and by the parent's emulated runs."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/rdzv",
                            rank=rank, world_size=WORLD,
                            timeout=datetime.timedelta(seconds=60))
    try:
        mesh = init_device_mesh("cpu", (WORLD,), mesh_dim_names=("data",))
        out = {"rank": engine.mesh_rank(mesh)}
        w = world()
        out.update(iterations(mesh, w, params))
        out.update(fused_steps(mesh, w, params["sage"]))
        out.update(fits(mesh, w, params["sage"], out_dir))
        out.update(shrink(mesh, w, params["sage"]))
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def iterations(mesh, w, params: dict) -> dict:
    """One sharded iteration per (model, mode): loss, gradient leaves and
    the collectives it ran."""
    ds, part, table, owner, local_idx = w
    out = {}
    for model, p in params.items():
        cfg = cfg_of(ds, model)
        for mode, m in MODES.items():
            plan = make_plan(ds, part, table, owner, local_idx, roots_of(ds),
                             mode)
            tab = None if m["tiered"] else table
            g, loss = engine.run_iteration(p, tab, plan, cfg, mesh=mesh,
                                           fold_returns=m["fold"])
            fn = engine.get_compiled_iteration(
                cfg, plan.pregather, streamed=plan.streamed, mesh=mesh,
                fold_returns=engine.resolve_fold_returns(plan, m["fold"]))
            args = engine.prepare_iteration_args(tab, plan, mesh=mesh)
            out[("iteration", model, mode)] = dict(
                loss=float(loss), grads=leaves(g), T=plan.num_steps,
                counts=engine.collective_counts(fn, p, *args),
                kind=engine.trace_log()[-1][0],
                shapes=[tuple(a.shape) for a in args[:2]])
    return out


def fused_steps(mesh, w, params) -> dict:
    """run_train_step under the mesh and emulated, and the stacked fused
    step over two same-bucket plans, each from the same start."""
    ds, part, table, owner, local_idx = w
    cfg = cfg_of(ds, "sage")
    plans = [make_plan(ds, part, table, owner, local_idx, roots_of(ds, s),
                       "pregather", batch_pad=ROOTS_PER_MODEL, r_max=128)
             for s in (0, 1)]
    out = {}
    for name, m in (("sharded", mesh), ("emulated", None)):
        opt = fit_optimizer()
        p = copy.deepcopy(params)
        st = opt.init(p)
        p, st, loss = engine.run_train_step(p, st, table, plans[0], cfg, opt,
                                            mesh=m, device="cpu")
        out[("fused", name)] = dict(loss=float(loss), params=leaves(
            p.leaves()))
        opt = fit_optimizer()
        p = copy.deepcopy(params)
        st = opt.init(p)
        fn = engine.get_compiled_train_step(cfg, True, opt, stacked=True,
                                            mesh=m)
        tab, cache, _, _ = engine.prepare_iteration_args(
            table, plans[0], mesh=m, device="cpu")
        devs, denoms = stack_committed(
            plans, tab.device, None if m is None else engine.mesh_rank(m))
        p, st, losses = fn(p, st, tab, cache, devs, denoms)
        out[("stacked", name)] = dict(losses=losses.tolist(), params=leaves(
            p.leaves()), kind=engine.trace_log()[-1][0])
    return out


def trainer(mesh, w, params, **kw):
    ds, part, table, owner, local_idx = w
    kw.setdefault("merging", False)
    return Trainer(graph=ds.graph, labels=ds.labels, part=part, owner=owner,
                   local_idx=local_idx, table=table, cfg=cfg_of(ds, "sage"),
                   optimizer=fit_optimizer(), params=params,
                   train_vertices=ds.train_vertices(), mesh=mesh, **kw)


def state(tr) -> dict:
    st = tr.opt_state
    return dict(params=leaves(tr.params.leaves()),
                opt=leaves(list(st.mu) + list(st.nu)), step=int(st.step),
                global_step=tr.global_step)


def fits(mesh, w, params, out_dir: str) -> dict:
    """The straight sharded fit (checkpointing into a shared directory),
    the same fit under each fault plan, with a degree cache, and stacked,
    and a merging fit on which rank 1's clock reads slower."""
    out = {}
    ta = trainer(mesh, w, params, ckpt_dir=os.path.join(out_dir, "ckpt"))
    n0 = engine.trace_count()
    stats = ta.fit(**FIT)
    out["fit"] = dict(losses=[s.loss for s in stats], **state(ta),
                      device=str(ta.device), table=tuple(ta.table.shape),
                      traces=[s.traces for s in stats],
                      uploads=ta._uploader.uploads,
                      kinds=sorted({r[0] for r in engine.trace_log()[n0:]}))
    for name, specs in FAULTS.items():
        fp = FaultPlan(list(specs), seed=0, name=name)
        tb = trainer(mesh, w, params)
        with fp.active():
            stats = tb.fit(**FIT)
        out[("faulted", name)] = dict(
            losses=[s.loss for s in stats], **state(tb),
            fired=sorted({k for k, *_ in fp.fired}),
            attempts=[s.epoch_attempts for s in stats],
            rollbacks=sum(s.rollbacks for s in stats))
    tc = trainer(mesh, w, params, cache_policy="degree",
                 cache_budget_bytes=CACHE_ROWS * w[2].shape[-1] * 4)
    stats = tc.fit(**FIT)
    out["fit cache"] = dict(losses=[s.loss for s in stats],
                            hits=[s.cache_hit_rows for s in stats],
                            cache=tuple(tc.cache_store.device_table.shape))
    tk = trainer(mesh, w, params, pipeline_stack=2)
    stats = tk.fit(**FIT)
    out["fit stack2"] = dict(losses=[s.loss for s in stats], **state(tk))
    tm = trainer(mesh, w, params, merging=True)
    if engine.mesh_rank(mesh) == 1:
        # this rank's own steady times read 10x, 100x, ... slower each
        # epoch: without the agreement its controller would walk another
        # way than the other ranks'
        attempt = tm._epoch_with_recovery

        def slow(epoch, *a, **k):
            res, ra, rf, meta = attempt(epoch, *a, **k)
            if res.steady_iter_s is not None:
                res = dataclasses.replace(
                    res, steady_iter_s=res.steady_iter_s * 10.0 ** (epoch + 1))
            return res, ra, rf, meta
        tm._epoch_with_recovery = slow
    stats = tm.fit(epochs=4, iters_per_epoch=3, batch_per_model=8)
    out["merging"] = dict(patterns=[s.num_steps for s in stats],
                          losses=[s.loss for s in stats])
    return out


def shrink(mesh, w, params) -> dict:
    """A peer death under the redistribute policy: elastic shrink is not
    possible under a mesh and raises on every rank."""
    policy = ResiliencePolicy(membership_mode="redistribute",
                              retry=RetryPolicy(max_retries=1,
                                                backoff_s=0.001))
    tr = trainer(mesh, w, params, resilience=policy)
    fp = FaultPlan([FaultSpec("peer_death", epoch=0, it=1, shard=2)])
    try:
        with fp.active():
            tr.fit(epochs=1, iters_per_epoch=3, batch_per_model=8)
        raised = None
    except NotImplementedError as e:
        raised = str(e)
    finally:
        engine.revive_peer(2)
    return {"shrink": raised}
