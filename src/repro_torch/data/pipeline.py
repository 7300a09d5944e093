"""Synthetic token batches, seeded and deterministic.

The port's copy of the reference's ``data/pipeline.py``: tokens follow a
Zipfian unigram draw with a Markov bigram twist, drawn with numpy exactly as
the reference draws them, so the same seed gives bitwise the same tokens in
both packages. Batches are CPU tensors; the model moves them to its device.
The modality stubs of the vlm and audio families arrive with those families
(ROADMAP.md, Queue 1 item 9).
"""
from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from repro_torch.models.transformer.config import ArchConfig


def _zipf_markov_tokens(rng: np.random.Generator, batch: int, seq: int,
                        vocab: int) -> np.ndarray:
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = 1.0 / ranks
    p /= p.sum()
    toks = rng.choice(vocab, size=(batch, seq), p=p).astype(np.int32)
    # Markov twist: with prob .5, token t+1 = f(token t) — learnable bigram
    follow = rng.permutation(vocab).astype(np.int32)
    mask = rng.random((batch, seq - 1)) < 0.5
    toks[:, 1:] = np.where(mask, follow[toks[:, :-1]], toks[:, 1:])
    return toks


def make_batch(cfg: ArchConfig, batch: int, seq: int, seed: int) -> dict:
    """{"tokens": (batch, seq) int32 CPU tensor}."""
    if cfg.family in ("vlm", "audio"):
        raise NotImplementedError(
            f"{cfg.family} batches are not ported yet (ROADMAP.md, Queue 1 "
            f"item 9)")
    rng = np.random.default_rng(seed)
    return {"tokens": torch.from_numpy(
        _zipf_markov_tokens(rng, batch, seq, cfg.vocab_size))}


def token_batches(cfg: ArchConfig, batch: int, seq: int, steps: int,
                  seed: int = 0) -> Iterator[dict]:
    for i in range(steps):
        yield make_batch(cfg, batch, seq, seed * 100_003 + i)
