"""Precomputed-embedding tier: offline full-graph forward, persisted.

The port of ``repro.serve.embeddings``. The cold-vertex fast path: an
offline pass runs every vertex through the serving forward itself (the
same stateless ``sample_seed``, ``plan_inference`` → the ``[cached |
fetched]`` workspace → one ``gather_rows`` kernel launch per hop →
``gnn_forward``) and persists the resulting logits table next to the
training checkpoints — ``<ckpt_dir>/embeddings/`` — with
repro_torch.checkpoint's crash-atomic npz+manifest discipline, in the
reference's layout. Serving a cold vertex then bypasses sampling, feature
gathering and the device: one table row.

Because the precompute IS the serving forward, table rows equal what a
live fresh compute of the same vertex produces at the same rung — until
the params move. The manifest therefore records ``params_step`` and
``sample_seed``; :func:`load_embeddings` refuses a snapshot whose stamp
disagrees with the server's unless explicitly allowed.
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint import (latest_step, load_checkpoint,
                                    save_checkpoint)
from repro_torch.core import get_compiled_inference, plan_inference
from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace
from repro_torch.train.budget import next_bucket

EMB_SUBDIR = "embeddings"


def embeddings_dir(ckpt_dir) -> Path:
    return Path(ckpt_dir) / EMB_SUBDIR


def precompute_embeddings(graph, store, params, cfg, *, ckpt_dir,
                          sample_seed: int = 999, params_step: int = 0,
                          chunk: int = 256, keep: int = 2) -> Path:
    """Full-graph offline forward → ``<ckpt_dir>/embeddings/``.

    Runs all ``N`` vertices in ``chunk``-sized micro-batches through the
    serving forward on the device ``params`` lie on (one pow2 rung, so
    one signature for the whole pass; the fetch buffer is sized in one
    bucket grown ×1.5 when a chunk outgrows it), gathering features
    through ``store``'s tier chain. Returns the snapshot directory.
    ``params_step`` should be the checkpoint step the params came from —
    it is the staleness stamp.
    """
    n = int(graph.num_vertices)
    d = store.feature_dim
    batch_pad = next_bucket(min(chunk, n))
    fn = get_compiled_inference(cfg)
    device = next(params.parameters()).device
    empty = torch.from_numpy(np.zeros((0, d), store.dtype)).to(device)
    out = np.zeros((n, cfg.num_classes), np.float32)
    u_max = 0
    with _trace.span("serve.precompute", vertices=n):
        for lo in range(0, n, batch_pad):
            nodes = np.arange(lo, min(lo + batch_pad, n), dtype=np.int64)
            with _trace.span("serve.precompute.plan", lo=lo):
                plan = plan_inference(graph, nodes, cfg.num_layers,
                                      cfg.fanout, sample_seed=sample_seed,
                                      batch_pad=batch_pad)
                u = int(plan.fetch_ids.size)
                # one fetch bucket for the whole pass (chunks are
                # same-sized, so the unique-row count is tightly banded)
                if u > u_max:
                    u_max = next_bucket(int(u * 1.5))
                fetch = np.zeros((u_max, d), store.dtype)
                fetch[:u] = store.take_global(plan.fetch_ids)
            # the upload, the kernels and the copy back of the logits
            with _trace.span("serve.precompute.forward", lo=lo):
                logits = fn(params, empty, fetch, *plan.hop_idx)
                out[lo:lo + nodes.size] = logits[:nodes.size].cpu().numpy()
    directory = embeddings_dir(ckpt_dir)
    extra = {"kind": "serve-embeddings", "num_vertices": n,
             "num_classes": int(cfg.num_classes),
             "sample_seed": int(sample_seed),
             "params_step": int(params_step), "model": cfg.model,
             "num_layers": int(cfg.num_layers), "fanout": int(cfg.fanout)}
    save_checkpoint(directory, params_step, {"logits": out}, extra=extra,
                    keep=keep)
    _metrics.inc("serve.precomputed_rows", n)
    return directory


class EmbeddingTable:
    """Loaded snapshot: ``(N, C)`` logits + its staleness stamp."""

    def __init__(self, logits: np.ndarray, extra: dict, step: int):
        self.logits = logits
        self.extra = extra
        self.step = int(step)

    @property
    def num_vertices(self) -> int:
        return int(self.logits.shape[0])

    def lookup(self, ids) -> np.ndarray:
        return self.logits[np.asarray(ids, np.int64)]


def load_embeddings(ckpt_dir, *, params_step: Optional[int] = None,
                    sample_seed: Optional[int] = None,
                    allow_stale: bool = False) -> EmbeddingTable:
    """Load the newest durable embedding snapshot under ``ckpt_dir``.

    With ``params_step``/``sample_seed`` given, a snapshot stamped
    differently raises ``ValueError`` (stale precomputed logits would
    silently break the served-equals-offline contract) unless
    ``allow_stale=True``.
    """
    directory = embeddings_dir(ckpt_dir)
    if latest_step(directory) is None:
        raise FileNotFoundError(f"no embedding snapshot under {directory}")
    tree, step, extra = load_checkpoint(
        directory, {"logits": np.zeros((0, 0), np.float32)})
    if not allow_stale:
        if params_step is not None \
                and int(extra.get("params_step", -1)) != int(params_step):
            raise ValueError(
                f"embedding snapshot is stale: precomputed at params_step="
                f"{extra.get('params_step')} but the server holds step "
                f"{params_step} (re-run precompute_embeddings, or pass "
                f"allow_stale=True to serve stale logits knowingly)")
        if sample_seed is not None \
                and int(extra.get("sample_seed", -1)) != int(sample_seed):
            raise ValueError(
                f"embedding snapshot sampled with seed "
                f"{extra.get('sample_seed')} != server seed {sample_seed}")
    return EmbeddingTable(np.asarray(tree["logits"]), extra, step)
