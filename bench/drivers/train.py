"""The training driver: ``repro_torch``'s ``Trainer.fit`` over one long
epoch of the cell's traffic.

Set-up makes one Trainer from the benchmark's inputs and weights, drives
it through its first ``check_steps`` iterations (the first alone in a
one-iteration epoch, so the optimizer's state can be read after it; the
rest as one pipelined epoch like the window's, with plans built, uploaded
and dispatched while the one before runs and the losses kept on the card
to the epoch's end), then warms it up one epoch at a time until the
merging controller's pattern is frozen and has run once, and hands that
same Trainer to the window: one ``fit`` epoch of as many iterations as the
warm-up rate fits into ``--seconds``. Every iteration's roots are the
next slice of one permutation of the training vertices drawn from
``--seed``, so no two iterations of a run share a root until the
permutation wraps.

Once the window has closed, the memory peak is read and the program's
state freed, the reference runs the check steps from the same weights on
the same roots and trees, and ``bench.compare`` decides ``correct``.
"""
from __future__ import annotations

import gc
import math
import sys
import time

import numpy as np
import torch

from bench import compare, data, harness, program, weights
from bench.counts import flops, gather_bytes
from bench.reference import train as ref_train
from bench.reference.sampler import sample_tree


class Feed:
    """Roots by (epoch, iteration) of the current ``fit`` call: iteration
    i of the run takes the i-th slice of ``models * batch`` vertices of a
    permutation of the training vertices drawn from the seed."""

    def __init__(self, train_vertices: np.ndarray, models: int, batch: int,
                 seed: int):
        self.perm = np.random.default_rng(seed).permutation(train_vertices)
        self.models, self.batch = models, batch
        self.base, self.per_epoch = 0, 1

    def start(self, base: int, per_epoch: int) -> None:
        """The next ``fit`` call's epoch 0, iteration 0 is run iteration
        ``base``; an epoch holds ``per_epoch`` iterations."""
        self.base, self.per_epoch = base, per_epoch

    def roots_at(self, i: int) -> np.ndarray:
        per = self.models * self.batch
        return self.perm[(np.arange(per) + i * per) % self.perm.size]

    def __call__(self, epoch: int, it: int) -> list:
        return np.split(self.roots_at(self.base + epoch * self.per_epoch
                                      + it), self.models)


def sample_seed(base: int, epoch: int, it: int) -> int:
    """The Trainer's stateless sampling seed of (epoch, iteration)."""
    return base + epoch * 10_000 + it


def make_trainer(cell, ds, params0: dict, seed: int, device):
    from repro_torch.models.gnn.models import GNNConfig
    from repro_torch.train.loop import Trainer
    cfg, traffic = cell.config, cell.traffic
    model, tr = cfg["model"], cfg["trainer"]
    graph, part, table, owner, local_idx = program.world(cfg, ds)
    feed = Feed(ds.train_vertices(), cfg["partition"]["shards"],
                traffic["batch_per_model"], seed)
    gcfg = GNNConfig(model=model["kind"], num_layers=model["num_layers"],
                     hidden_dim=model["hidden_dim"],
                     feature_dim=ds.feature_dim,
                     num_classes=ds.num_classes, fanout=model["fanout"])
    gnn = program.gnn(params0, model)
    trainer = Trainer(graph=graph, labels=np.array(ds.labels), part=part,
                      owner=owner, local_idx=local_idx, table=table,
                      cfg=gcfg, optimizer=program.optimizer(cfg["optimizer"]),
                      params=gnn, strategy=tr["strategy"],
                      pregather=tr["pregather"], merging=tr["merging"],
                      pipeline=tr["pipeline"], root_fn=feed,
                      sample_seed_base=seed, device=device)
    return trainer, feed, program.leaf_names(gnn)


def check_steps(trainer, feed, names: list, params0: dict, steps: int,
                batch: int, b1: float) -> dict:
    """The first ``steps`` iterations through ``fit``: step 1 as an epoch
    of its own (its loss, and each leaf's gradient as the optimizer got
    it: the first moment over 1 - b1), then steps 2 .. ``steps`` as one
    pipelined epoch (its mean loss, and each leaf's change after its last
    step)."""
    feed.start(0, 1)
    first = trainer.fit(1, 1, batch_per_model=batch)[-1]
    grad1 = {n: float(torch.linalg.vector_norm(m.double())) / (1.0 - b1)
             for n, m in zip(names, trainer.opt_state.mu)}
    feed.start(1, steps - 1)
    rest = trainer.fit(1, steps - 1, batch_per_model=batch)[-1]
    change = {n: float(torch.linalg.vector_norm(
        p.detach().double() - params0[n].double()))
        for n, p in zip(names, trainer.params.leaves())}
    return {"losses": [float(first.loss)], "epoch_loss": float(rest.loss),
            "grad1": grad1, "change": change}


def warm_up(trainer, feed, base: int, traffic: dict) -> tuple[int, float,
                                                              int]:
    """Epochs of ``warmup_iters`` until the merge pattern is frozen and
    the window's pattern has run (at least ``warmup_min_epochs``).
    Returns (next run iteration, iterations per second of the last epoch,
    epochs run)."""
    k = traffic["warmup_iters"]
    batch = traffic["batch_per_model"]
    for e in range(traffic["warmup_max_epochs"]):
        feed.start(base, k)
        st = trainer.fit(1, k, batch_per_model=batch)[-1]
        base += k
        c = trainer.controller
        settled = c is None or (c.frozen and st.num_steps == c.pattern_steps)
        if settled and e + 1 >= traffic["warmup_min_epochs"]:
            break
    return base, k / st.time_s, e + 1


def reference_readings(cell, ds, params0: dict, feed, seed: int, steps: int,
                       device, *, tf32: bool = False, fault=None) -> dict:
    cfg = cell.config
    feats = data.upload_features(ds, device)
    roots = [feed.roots_at(i) for i in range(steps)]
    # step 1 is epoch 0's iteration 0 of its fit call, and steps 2 .. are
    # iterations 0 .. of the next call's epoch 0
    seeds = [sample_seed(seed, 0, 0)] + [sample_seed(seed, 0, i)
                                         for i in range(steps - 1)]
    part = (np.asarray(ds.communities) % cfg["partition"]["shards"]
            if fault == "no_exchange" else None)
    out = ref_train.train_steps(ds, feats, params0, cfg["model"],
                                cfg["optimizer"], roots, seeds, tf32=tf32,
                                fault=fault, part=part)
    del feats
    return out


def window_counts(cell, ds, feed, seed: int, base: int, iters: int) -> dict:
    """Model FLOPs and the least ``gather_rows`` bytes of the window's
    iterations, from their trees."""
    model = cell.config["model"]
    roots = feed.models * feed.batch
    per_iter = flops.iteration(model, ds.feature_dim, ds.num_classes, roots)
    nbytes = 0
    for it in range(iters):
        hops = sample_tree(ds.graph.indptr, ds.graph.indices,
                           feed.roots_at(base + it), model["num_layers"],
                           model["fanout"], sample_seed(seed, 0, it))
        nbytes += gather_bytes.tree_bytes(hops, ds.feature_dim)
    return {"flops": per_iter * iters, "gather_rows_bytes": nbytes}


def run(cell, *, seed: int, seconds: float, trace: bool, device,
        t_start: float):
    cfg, traffic = cell.config, cell.traffic
    program.set_precision(cfg)
    ds = data.generate(cfg["dataset"], device)
    if device != "cpu":
        # the program's peak, not the generator's
        torch.cuda.reset_peak_memory_stats()
    params0 = weights.make(cfg["model"], ds.feature_dim, ds.num_classes,
                           seed, device)
    trainer, feed, names = make_trainer(cell, ds, params0, seed, device)
    steps = traffic["check_steps"]
    batch = traffic["batch_per_model"]
    got = check_steps(trainer, feed, names, params0, steps, batch,
                      cfg["optimizer"].get("b1", 0.9))
    base, rate, warm_epochs = warm_up(trainer, feed, steps, traffic)
    iters = max(traffic["window_min_iters"], math.ceil(seconds * rate))
    feed.start(base, iters)

    on_card = device != "cpu"
    if trace:
        from repro_torch.obs import trace as obs
        obs.enable(capacity=1 << 16)
        dtrace = harness.DeviceTrace().__enter__() if on_card else None
    if on_card:
        torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    st = trainer.fit(1, iters, batch_per_model=batch)[-1]
    if on_card:
        torch.cuda.synchronize()
    t1 = time.perf_counter_ns()
    traced = None
    if trace:
        if dtrace is not None:
            dtrace.__exit__(None, None, None)
        obs.disable()
        ops = dtrace.ops(t0, t1) if on_card else []
        traced = {"spans": obs.records(), "ops": ops, "counters": {},
                  "busy_s": harness.union_ns([(a, b) for _, a, b in ops])
                  / 1e9}
        obs.clear()
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    del trainer
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return report(cell, ds, feed, seed, base, iters, st, (t0, t1), t_start,
                  peak, traced, got, params0, device,
                  {"warmup_epochs": warm_epochs, "warmup_rate_it_s": rate})


def report(cell, ds, feed, seed: int, base: int, iters: int, st,
           window: tuple, t_start: float, peak: int, traced, got: dict,
           params0: dict, device, info: dict):
    """The result line of a training window: the end-to-end metrics, or
    with ``traced`` (the window's spans, device operations, busy seconds
    averaged over the cards, extra counters) the per-layer ones; then the
    reference's check steps and the judgement."""
    t0, t1 = window
    dev = harness.device_line(cell.chips, peak)
    info = {"iterations": iters, "merge_steps": st.num_steps,
            "window_traces": st.traces, "csr_entries": ds.graph.num_edges,
            **info}
    if traced is not None:
        win = harness.Window(
            t0_ns=t0, t1_ns=t1, spans=traced["spans"], ops=traced["ops"],
            counters={"iterations": iters, "remote_rows": st.remote_rows,
                      "plans_built": st.plans_built, **traced["counters"]},
            counts=window_counts(cell, ds, feed, seed, base, iters),
            chips=cell.chips, peaks=harness.peaks_for(dev["kind"]))
        metrics = harness.read_per_layer(cell, win)
        dev["busy_s"] = traced["busy_s"]
        dev["window_s"] = win.seconds
        extra = {"breakdown": harness.breakdown(win)}
        print(f"traced window: {len(win.spans)} spans, {len(win.ops)} "
              f"device operations", file=sys.stderr)
    else:
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        roots = iters * feed.models * feed.batch
        metrics = {"train_roots_per_s": {"value": roots / ((t1 - t0) / 1e9),
                                         "unit": units["train_roots_per_s"]},
                   "setup_s": {"value": t0 / 1e9 - t_start,
                               "unit": units["setup_s"]}}
        extra = {}
    t_ref = time.perf_counter()
    ref = reference_readings(cell, ds, params0, feed, seed,
                             cell.traffic["check_steps"], device)
    info["reference_s"] = time.perf_counter() - t_ref
    numbers, info["leaves"] = compare.train_numbers(got, ref)
    info["numbers"] = numbers
    correct, compared = compare.judge(
        numbers, compare.limits_for(cell.name, cell.limits_dir))
    result = {"correct": correct, "attempted": iters, "failed": 0,
              "metrics": metrics, "device": dev, **extra, "info": info}
    return result, compared
