"""Synthetic token and modality batches, seeded and deterministic.

The port's copy of the reference's ``data/pipeline.py``: tokens follow a
Zipfian unigram draw with a Markov bigram twist, and the modality stubs
(vlm patches, audio frames) are unit-Gaussian float32 embeddings of the
configured width, all drawn with numpy exactly as the reference draws them
(the stub first, then the tokens, from one generator), so the same seed
gives bitwise the same batch in both packages. Batches are CPU tensors;
the model moves them to its device.
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
    """{"tokens": (batch, seq) int32} CPU tensors, and for vlm
    ``patches`` (batch, P, patch_dim) float32 with P = min(num_patches,
    max(seq // 4, 1)) and seq - P text tokens, for audio ``frames``
    (batch, encoder_seq, De) float32."""
    rng = np.random.default_rng(seed)
    out: dict = {}
    if cfg.family == "vlm":
        P = min(cfg.num_patches, max(seq // 4, 1))
        out["patches"] = torch.from_numpy(
            rng.standard_normal((batch, P, cfg.patch_dim), dtype=np.float32))
        seq -= P
    elif cfg.family == "audio":
        De = cfg.encoder_d_model or cfg.d_model
        out["frames"] = torch.from_numpy(
            rng.standard_normal((batch, cfg.encoder_seq, De),
                                dtype=np.float32))
    out["tokens"] = torch.from_numpy(
        _zipf_markov_tokens(rng, batch, seq, cfg.vocab_size))
    return out


def token_batches(cfg: ArchConfig, batch: int, seq: int, steps: int,
                  seed: int = 0) -> Iterator[dict]:
    for i in range(steps):
        yield make_batch(cfg, batch, seq, seed * 100_003 + i)
