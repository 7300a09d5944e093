"""Micrograph merging (paper §5.3): adaptive time-step reduction.

Merging trades remote-fetch volume against per-step overhead (kernel
launches, synchronization). The controller reproduces the paper's algorithm:

* *Which*: rank time steps by total root count (the paper's proxy for
  Num_vertex, decided before sampling); pick ts_min.
* *How*:  redistribute each model's ts_min roots evenly over that model's
  remaining steps (Fig. 10), keeping per-model batch composition intact —
  the accuracy-fidelity invariant.
* *How many*: an examination period starting at epoch 2 — keep merging while
  the measured epoch time improves; then freeze the pattern.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.micrograph import AssignmentMatrix


def merge_min_step(amat: AssignmentMatrix,
                   ts_min: Optional[int] = None) -> AssignmentMatrix:
    """Fold the lightest time step into the remaining ones (one §5.3 round).

    Each model's groups at ts_min are split evenly across the model's other
    steps; the merged roots execute on the *hosting* server of the target
    step (locality loss is the cost the examination period measures).
    """
    if amat.num_steps <= 1:
        return amat
    counts = amat.root_counts().sum(axis=1)      # (T,)
    t_min = int(np.argmin(counts)) if ts_min is None else ts_min
    T = amat.num_steps

    # model -> its (server, roots) at t_min, and its target (server, step)s
    new_groups: dict = {}
    per_model_targets: dict[int, list[tuple[int, int]]] = {}
    for (s, t), gs in amat.groups.items():
        if t == t_min:
            continue
        nt = t if t < t_min else t - 1
        new_groups.setdefault((s, nt), []).extend(
            (d, r.copy()) for d, r in gs)
        for d, _ in gs:
            # Dedupe: a model with several groups at one (server, step) slot
            # (common after a previous merge round) must count that slot
            # once, or array_split over-weights it and skews the even
            # redistribution Fig. 10 requires.
            tgt = per_model_targets.setdefault(d, [])
            if (s, nt) not in tgt:
                tgt.append((s, nt))

    for (s, t), gs in amat.groups.items():
        if t != t_min:
            continue
        for d, roots in gs:
            targets = per_model_targets.get(d)
            if not targets:
                # model d only trained at t_min: keep it at step 0 on the
                # same server (degenerate but load-consistent).
                new_groups.setdefault((s, 0), []).append((d, roots.copy()))
                continue
            chunks = np.array_split(roots, len(targets))
            for (ts_s, ts_t), chunk in zip(targets, chunks):
                if chunk.size:
                    new_groups.setdefault((ts_s, ts_t), []).append((d, chunk))

    return AssignmentMatrix(num_shards=amat.num_shards, num_steps=T - 1,
                            groups=new_groups)


def merge_random_step(amat: AssignmentMatrix, rng: np.random.Generator
                      ) -> AssignmentMatrix:
    """RD baseline of §7.4: merge a uniformly random step (load-oblivious)."""
    t = int(rng.integers(0, amat.num_steps))
    return merge_min_step(amat, ts_min=t)


def fold_assignment(base: AssignmentMatrix, num_steps: int,
                    selector: str = "min",
                    rng: Optional[np.random.Generator] = None
                    ) -> AssignmentMatrix:
    """Fold ``base`` down to ``num_steps`` time steps by repeated merging.

    This is how a frozen merge *pattern* (a step count, decided once by the
    examination period) is applied to each epoch's fresh mini-batch
    assignment: the controller owns the depth, the per-iteration roots stay
    the model's own (accuracy fidelity)."""
    amat = base
    while amat.num_steps > max(1, num_steps):
        amat = (merge_min_step(amat) if selector == "min"
                else merge_random_step(amat, rng or np.random.default_rng(0)))
    return amat


@dataclasses.dataclass
class MergingController:
    """Epoch-level examination loop (§5.3 'How many').

    Call ``assignment_for_epoch()`` before each epoch and
    ``record_epoch_time(seconds)`` after it. From epoch 2 on, the controller
    proposes one more merge per epoch while measured time improves, then
    freezes.

    Timing signal: pass *steady-state* epoch time — device execution only,
    excluding host planning and the first call of a new shape signature. A
    merge changes the iteration's device shapes, so the first iteration
    after a pattern change is a new signature (a "trace" in the engine's
    log); feeding its wall time back in would measure that warm-up, not the
    kernel-switch/sync overhead §5.3 trades against. The repro_torch.train
    Trainer computes the trace-free time via the engine's trace log."""

    base: AssignmentMatrix
    selector: str = "min"          # "min" (paper) | "random" (RD baseline)
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        self._current = self.base
        self._previous: Optional[AssignmentMatrix] = None
        self._times: list[float] = []
        self._frozen = False
        self.history: list[int] = [self.base.num_steps]

    @property
    def frozen(self) -> bool:
        return self._frozen

    @property
    def last_epoch_time(self) -> Optional[float]:
        """Most recent recorded epoch time (the examination baseline)."""
        return self._times[-1] if self._times else None

    @property
    def pattern_steps(self) -> int:
        """The merge pattern: how many time steps the controller currently
        folds the base rotation down to."""
        return self._current.num_steps

    def assignment_for_epoch(self) -> AssignmentMatrix:
        return self._current

    def apply_to(self, base: AssignmentMatrix) -> AssignmentMatrix:
        """Apply the current merge pattern to a *fresh* per-iteration
        assignment (new mini-batch, same fold depth)."""
        return fold_assignment(base, self.pattern_steps, self.selector,
                               self._rng)

    def restore(self, num_steps: int, frozen: bool,
                last_time: Optional[float] = None) -> None:
        """Resume from a checkpointed pattern.

        ``last_time`` re-seeds the examination baseline so the first
        post-resume epoch is compared against the pre-resume measurement
        (otherwise the controller would merge unconditionally). The revert
        target is reconstructed as the one-step-shallower fold, so a
        regression after resume can still undo the last merge."""
        self._current = fold_assignment(self.base, num_steps, self.selector,
                                        self._rng)
        self._previous = (fold_assignment(self.base, num_steps + 1,
                                          self.selector, self._rng)
                          if num_steps < self.base.num_steps else None)
        self._frozen = bool(frozen)
        self._times = [] if last_time is None else [float(last_time)]
        self.history.append(self._current.num_steps)

    def record_epoch_time(self, seconds: float) -> None:
        self._times.append(seconds)
        if self._frozen:
            return
        if len(self._times) >= 2 and self._times[-1] >= self._times[-2]:
            # regression: revert to the previous pattern and freeze (§5.3)
            if self._previous is not None:
                self._current = self._previous
            self._frozen = True
            self.history.append(self._current.num_steps)
            return
        if self._current.num_steps > 1:
            self._previous = self._current
            self._current = (merge_min_step(self._current)
                             if self.selector == "min"
                             else merge_random_step(self._current, self._rng))
            self.history.append(self._current.num_steps)
        else:
            self._frozen = True
