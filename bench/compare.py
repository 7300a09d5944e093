"""The numbers that decide ``correct``, and their limits.

Training (the first steps of the window's own Trainer, from the
benchmark's weights and rows, against the reference's same steps: step 1
alone in a one-iteration epoch, then the rest as one pipelined epoch, the
window's kind of ``fit`` call). Each leaf's gap is the gap between the
program's norm of the leaf and the reference's, over the larger of the
reference's norm of that leaf and of the median leaf.

* ``loss_gap``: step 1's |loss - reference loss| / |reference loss|.
* ``epoch_loss_gap``: the same of the pipelined epoch's mean loss against
  the mean of the reference's losses of those steps.
* ``grad_gap``: step 1's gradient as the optimizer got it (its first
  moment after one step over 1 - beta1), by the median leaf.
* ``change_gap``: each leaf's change after the last step, by the median
  leaf, over the leaves whose reference gradient is at least a thousandth
  of the median leaf's (a leaf below that moves under Adam by round-off).
* ``change_worst``: the same change by the worst of those leaves.

The first gradient's worst leaf swings with rounding (an input of ReLU or
LeakyReLU at its kink rounds to the other side in one leaf: 5.8e-5 on one
seed of sixty, about 1e-7 on the rest), so it is reported beside the
numbers, not compared.

A cell's limits are in ``bench/limits/<workload>.json``; a number without
a limit there is reported and not compared. PERF.md gives the readings
each limit was set from.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

LIMITS_DIR = Path(__file__).resolve().parent / "limits"
GRAD_FLOOR = 1e-3     # of the median leaf's reference gradient norm


def limits_for(workload: str, directory: Path = LIMITS_DIR) -> dict:
    return json.loads((Path(directory) / f"{workload}.json").read_text())


def leaf_gaps(got: dict, want: dict, keep=None) -> dict:
    """Each leaf's |got - want| over the larger of want and the median
    leaf's want."""
    names = [k for k in want if keep is None or k in keep]
    med = float(np.median([want[k] for k in names]))
    return {k: abs(got[k] - want[k]) / max(want[k], med, 1e-30)
            for k in names}


def worst(gaps: dict) -> tuple[float, str]:
    """(the worst leaf's gap, its name)."""
    return max((v, k) for k, v in gaps.items())


def train_numbers(prog: dict, ref: dict) -> tuple[dict, dict]:
    """``prog`` and ``ref`` hold ``losses`` (step 1's alone for the
    program, each step's for the reference), ``epoch_loss`` (the program's
    mean loss over steps 2 ..), ``grad1`` and ``change`` (per leaf
    norms). Returns the numbers and what else a reader of a run wants: the
    worst leaf of the first gradient, and the leaves behind the worst
    gaps."""
    first = abs(prog["losses"][0] - ref["losses"][0]) / max(
        abs(ref["losses"][0]), 1e-30)
    rest = float(np.mean(ref["losses"][1:]))
    epoch = abs(prog["epoch_loss"] - rest) / max(abs(rest), 1e-30)
    med = float(np.median(list(ref["grad1"].values())))
    moving = {k for k, v in ref["grad1"].items() if v >= GRAD_FLOOR * med}
    grads = leaf_gaps(prog["grad1"], ref["grad1"])
    changes = leaf_gaps(prog["change"], ref["change"], moving)
    (grad_worst, grad_leaf), (change_worst, change_leaf) = \
        worst(grads), worst(changes)
    return ({"loss_gap": float(first), "epoch_loss_gap": float(epoch),
             "grad_gap": float(np.median(list(grads.values()))),
             "change_gap": float(np.median(list(changes.values()))),
             "change_worst": float(change_worst)},
            {"grad_worst": float(grad_worst), "grad_worst_leaf": grad_leaf,
             "change_worst_leaf": change_leaf})


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Correct when every number that has a limit is finite and within it
    (and every limit has its number). Returns (correct, {name: {"value",
    "limit"}})."""
    missing = set(limits) - set(numbers)
    if missing:
        raise KeyError(f"limits without a number: {sorted(missing)}")
    shown = {k: {"value": numbers[k], "limit": v} for k, v in limits.items()}
    ok = all(np.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in shown.values())
    return bool(ok), shown
