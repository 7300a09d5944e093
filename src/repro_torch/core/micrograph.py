"""Micrograph construction and root-vertex redistribution (paper §4, §5.1).

An *assignment* maps every (server s, time step t) to the list of
(model d, roots) groups trained there. LeapGNN's rotation schedule places
model d on server (d + t) mod N at step t; merging (§5.3) later edits this
matrix. The planner consumes the assignment and emits device-ready index
arrays.
"""
from __future__ import annotations

import dataclasses

import numpy as np

# (server, time_step) -> list of (model_id, roots int64 array)
Assignment = dict[tuple[int, int], list[tuple[int, np.ndarray]]]


@dataclasses.dataclass
class AssignmentMatrix:
    """Assignment plus its shape metadata."""

    num_shards: int
    num_steps: int
    groups: Assignment

    def roots_at(self, s: int, t: int) -> np.ndarray:
        gs = self.groups.get((s, t), [])
        return (np.concatenate([r for _, r in gs])
                if gs else np.zeros((0,), np.int64))

    def root_counts(self) -> np.ndarray:
        """(num_steps, num_shards) true root counts — the Num_vertex proxy
        the merging heuristic ranks time steps by (§5.3)."""
        c = np.zeros((self.num_steps, self.num_shards), np.int64)
        for (s, t), gs in self.groups.items():
            c[t, s] = sum(r.size for _, r in gs)
        return c

    def model_step_counts(self) -> np.ndarray:
        """(num_steps, num_models) root counts per model per step (Fig. 10b)."""
        n_models = self.num_shards
        c = np.zeros((self.num_steps, n_models), np.int64)
        for (_, t), gs in self.groups.items():
            for d, r in gs:
                c[t, d] += r.size
        return c


def model_centric_assignment(roots_per_model: list[np.ndarray]
                             ) -> AssignmentMatrix:
    """DGL-style: one step; model s trains its own mini-batch on server s."""
    n = len(roots_per_model)
    groups: Assignment = {(s, 0): [(s, np.asarray(roots_per_model[s], np.int64))]
                          for s in range(n)}
    return AssignmentMatrix(num_shards=n, num_steps=1, groups=groups)


def hopgnn_assignment(roots_per_model: list[np.ndarray], part: np.ndarray
                      ) -> AssignmentMatrix:
    """§5.1 steps 1–2: group each model's roots by home server; model d's
    group homed at server h is trained at time step t = (h - d) mod N
    (when model d, rotating as (d + t) mod N, visits h)."""
    n = len(roots_per_model)
    groups: Assignment = {}
    for d, roots in enumerate(roots_per_model):
        roots = np.asarray(roots, np.int64)
        home = part[roots]
        for h in range(n):
            sel = roots[home == h]
            if sel.size == 0:
                continue
            t = (h - d) % n
            groups.setdefault((h, t), []).append((d, sel))
    return AssignmentMatrix(num_shards=n, num_steps=n, groups=groups)


def lo_assignment(roots_per_model: list[np.ndarray], part: np.ndarray
                  ) -> AssignmentMatrix:
    """Locality-optimized baseline (§5.1 'Limitations', §7.9): every root is
    trained at its home server by that server's resident model, one step.
    Fast, but batch composition becomes locality-correlated → biased."""
    n = len(roots_per_model)
    all_roots = np.concatenate([np.asarray(r, np.int64) for r in roots_per_model])
    home = part[all_roots]
    groups: Assignment = {}
    for s in range(n):
        sel = all_roots[home == s]
        if sel.size:
            groups[(s, 0)] = [(s, sel)]
    return AssignmentMatrix(num_shards=n, num_steps=1, groups=groups)


def micrograph_locality_stats(blocks_hops: list[list[np.ndarray]],
                              part: np.ndarray) -> tuple[float, float]:
    """(R_micro-style local fraction, remote fraction) over tree blocks.

    Each root's subtree is scored against *that root's own* home server.
    The fixed-fanout layout makes the per-root slice rectangular: root i of
    a B-root block owns ``hops[h][i * f**h : (i+1) * f**h]``, so a
    multi-root block with mixed homes is no longer lumped under the first
    root's partition."""
    local = total = 0
    for hops in blocks_hops:
        roots = np.asarray(hops[0])
        b = roots.shape[0]
        if b == 0:
            continue
        homes = part[roots]
        for h in hops[1:]:
            per_root = h.size // b          # f**h vertices per root subtree
            local += int((part[h] == np.repeat(homes, per_root)).sum())
            total += h.size
    return (local / max(total, 1), 1.0 - local / max(total, 1))
