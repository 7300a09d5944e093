"""The readings that a cell's limits are set from, at the cell's own size
on the card (the benchmark's own runs never run this).

    python3 bench/control.py --workload <cell> --seeds 1 2 ... --control-seeds 7 8 9

For each of ``--seeds``: the program's numbers after the check steps
(the lower readings: the largest over the seeds). For each of
``--control-seeds``: the numbers of the reference put in the program's
place and computed in TF32, the precision below the configuration's
float32 (the control, which has to fail a limit), and of the faults
planted in the reference put in the program's place (half of the batch
left out; the exchange between shards left out). A step that returns its
state unchanged reads 1 on the two leaf numbers by their definition and
needs no run. Prints one JSON line and writes every reading under
``build/bench_out/control/``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def per_leaf(got: dict, ref: dict) -> dict:
    from bench import compare
    return {"grad_by_leaf": compare.leaf_gaps(got["grad1"], ref["grad1"]),
            "change_by_leaf": compare.leaf_gaps(got["change"],
                                                ref["change"])}


def as_program(ref: dict) -> dict:
    """The reference's readings in the form the program's take: step 1's
    loss alone and the mean loss of the steps after it."""
    import numpy as np
    return {**ref, "losses": ref["losses"][:1],
            "epoch_loss": float(np.mean(ref["losses"][1:]))}


def train_readings(cell, seeds, control_seeds, device) -> dict:
    import gc

    import torch

    from bench import compare, data, program, weights
    from bench.drivers import train as drv
    cfg, traffic = cell.config, cell.traffic
    program.set_precision(cfg)
    ds = data.generate(cfg["dataset"], device)
    steps, batch = traffic["check_steps"], traffic["batch_per_model"]
    out = {"program": {}, "tf32": {}, "half_batch": {}, "no_exchange": {}}
    for seed in seeds:
        t0 = time.perf_counter()
        params0 = weights.make(cfg["model"], ds.feature_dim, ds.num_classes,
                               seed, device)
        trainer, feed, names = drv.make_trainer(cell, ds, params0, seed,
                                                device)
        got = drv.check_steps(trainer, feed, names, params0, steps, batch,
                              cfg["optimizer"].get("b1", 0.9))
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
        ref = drv.reference_readings(cell, ds, params0, feed, seed, steps,
                                     device)
        nums, leaves = compare.train_numbers(got, ref)
        out["program"][seed] = {**nums, "leaves": leaves,
                                **per_leaf(got, ref),
                                "s": time.perf_counter() - t0}
        print(f"program seed {seed}: {nums} {leaves}", file=sys.stderr,
              flush=True)
    for seed in control_seeds:
        params0 = weights.make(cfg["model"], ds.feature_dim, ds.num_classes,
                               seed, device)
        feed = drv.Feed(ds.train_vertices(), cfg["partition"]["shards"],
                        batch, seed)
        ref = drv.reference_readings(cell, ds, params0, feed, seed, steps,
                                     device)
        for kind, kw in (("tf32", {"tf32": True}),
                         ("half_batch", {"fault": "half_batch"}),
                         ("no_exchange", {"fault": "no_exchange"})):
            bad = drv.reference_readings(cell, ds, params0, feed, seed,
                                         steps, device, **kw)
            nums, leaves = compare.train_numbers(as_program(bad), ref)
            out[kind][seed] = {**nums, "leaves": leaves,
                               **per_leaf(bad, ref)}
            print(f"{kind} seed {seed}: {nums} {leaves}", file=sys.stderr,
                  flush=True)
    return out


def summary(readings: dict) -> dict:
    """Per number: the lower reading (largest over the program's seeds)
    and the smallest of each control and fault."""
    names = [k for k in next(iter(readings["program"].values()))
             if k not in ("leaves", "s", "grad_by_leaf", "change_by_leaf")]
    out = {}
    for n in names:
        row = {"lower": max(r[n] for r in readings["program"].values())}
        for kind in ("tf32", "half_batch", "no_exchange"):
            if readings.get(kind):
                row[kind] = min(r[n] for r in readings[kind].values())
        out[n] = row
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    os.environ["USE_FLAX"] = "0"
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch

    from bench import harness
    if not torch.cuda.is_available():
        print("the control runs on a CUDA card", file=sys.stderr)
        return 3
    cell = harness.find_cell(args.workload)
    readings = train_readings(cell, args.seeds, args.control_seeds, "cuda")
    line = {"workload": args.workload,
            "card": harness.device_line(cell.chips, 0),
            "summary": summary(readings), "readings": readings}
    where = ROOT / "build" / "bench_out" / "control"
    where.mkdir(parents=True, exist_ok=True)
    (where / f"{args.workload}.json").write_text(json.dumps(line, indent=1))
    print(json.dumps({"workload": args.workload,
                      "summary": line["summary"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
