"""Batched LLM serving: prefill a batch of prompts, then decode.

The port of the reference's ``launch/serve.py``, for every family. Runs on
``cuda`` unless given ``device="cpu"``:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
        --smoke --batch 4 --prompt-len 32 --gen 16

:class:`LLMServer` wraps :func:`generate` behind the port's
``repro_torch.serve.BatchingLoop``, the loop the GNN server uses — one
queue, one dynamic micro-batcher, one set of latency metrics
(``llm.latency_ms`` etc.). Prompts are right-padded to pow2 (batch, seq)
buckets, as in the reference, so steady traffic sees a handful of shapes.
A request is a token prompt, so the server takes the token-only families
(dense, moe, ssm, hybrid); :func:`generate` takes the vlm and audio
batches too, with their ``patches`` or ``frames``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.transformer import decode_step, init_params, prefill
from repro_torch.models.transformer.config import ArchConfig
from repro_torch.serve import BatchingLoop
from repro_torch.train.budget import next_bucket


def generate(params, cfg: ArchConfig, batch: dict, gen_tokens: int,
             max_seq: int, greedy: bool = True, seed: int = 0
             ) -> torch.Tensor:
    """Prefill + autoregressive decode of ``batch`` (``make_batch``'s
    keys for the family: tokens, and patches or frames). Returns
    (B, gen_tokens) int32 on the parameters' device. Greedy takes the first maximal logit, as
    ``jnp.argmax`` does; sampling draws from the softmax with a
    ``torch.Generator`` seeded with ``seed``. The reference also runs a
    decode step after the last token and drops its logits; that step is
    not run here, which changes no token."""
    with torch.inference_mode():
        logits, state = prefill(params, cfg, batch, max_seq=max_seq)
        gen = None if greedy else \
            torch.Generator(device=logits.device).manual_seed(seed)
        toks = []
        tok = logits[:, : cfg.vocab_size].argmax(-1).to(torch.int32)
        for i in range(gen_tokens):
            toks.append(tok)
            if i + 1 == gen_tokens:
                break
            logits, state = decode_step(params, cfg, tok, state)
            logits = logits[:, : cfg.vocab_size]
            if greedy:
                tok = logits.argmax(-1).to(torch.int32)
            else:
                probs = torch.softmax(logits.float(), -1)
                tok = torch.multinomial(probs, 1, generator=gen)[:, 0] \
                    .to(torch.int32)
        return torch.stack(toks, 1)


class LLMServer:
    """Queue-fed token generation over the shared batched-serving loop.

    A request payload is a 1-D int32 prompt; the result is a
    ``(gen_tokens,)`` int32 numpy array. Drained prompts are right-padded
    with token 0 to a pow2 sequence bucket and stacked into a pow2 batch
    bucket. As in the reference, a short prompt padded into a longer bucket
    is generated after its pad tokens, so its tokens depend on the bucket;
    the bit-parity serving contract lives on the GNN side. ``device``
    (default ``cuda``; raises without a GPU unless ``device="cpu"``) must
    be where ``params`` lie. A vlm or audio config is refused: its
    requests would need patches or frames beside the prompt, which the
    reference's server does not build either (it would fail in
    ``prefill``)."""

    def __init__(self, params, cfg: ArchConfig, *, gen_tokens: int = 16,
                 max_batch: int = 8, max_wait_s: float = 0.002,
                 min_seq_pad: int = 8, greedy: bool = True, seed: int = 0,
                 name: str = "llm", device=None):
        if cfg.family in ("vlm", "audio"):
            raise ValueError(
                f"LLMServer serves token prompts; {cfg.name} ({cfg.family}) "
                f"also needs {'patches' if cfg.family == 'vlm' else 'frames'}"
                f" per request: call generate() with make_batch's batch")
        want = resolve_device(device)
        self.device = params["embed"].device
        if self.device.type != want.type \
                or want.index not in (None, self.device.index):
            raise ValueError(f"params lie on {self.device}, the server was "
                             f"asked for {want}")
        self.params = params
        self.cfg = cfg
        self.gen_tokens = int(gen_tokens)
        self.min_seq_pad = int(min_seq_pad)
        self.greedy = greedy
        self.seed = int(seed)
        self.buckets: dict = {}        # (batch bucket, seq bucket) -> count
        self.loop = BatchingLoop(self._dispatch, max_batch=max_batch,
                                 max_wait_s=max_wait_s, name=name)

    def submit(self, prompt):
        return self.loop.submit(np.asarray(prompt, np.int32).ravel())

    def pump(self, wait_s=None) -> int:
        return self.loop.pump(wait_s=wait_s)

    def start(self) -> "LLMServer":
        self.loop.start()
        return self

    def stop(self, drain: bool = True) -> None:
        self.loop.stop(drain=drain)

    def _dispatch(self, tickets):
        prompts = [t.payload for t in tickets]
        bp = next_bucket(len(prompts), 1)
        sp = next_bucket(max(p.size for p in prompts), self.min_seq_pad)
        toks = np.zeros((bp, sp), np.int32)
        for i, p in enumerate(prompts):
            toks[i, : p.size] = p
        self.buckets[(bp, sp)] = self.buckets.get((bp, sp), 0) + 1
        batch = {"tokens": torch.from_numpy(toks).to(self.device)}
        out = generate(self.params, self.cfg, batch, self.gen_tokens,
                       max_seq=sp + self.gen_tokens + 8,
                       greedy=self.greedy, seed=self.seed).cpu().numpy()
        return [out[i] for i in range(len(prompts))]

    def stats(self) -> dict:
        return dict(self.loop.stats(), buckets=dict(self.buckets))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.data import make_batch

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    device = resolve_device(args.device)
    params = init_params(
        cfg, torch.Generator(device=device).manual_seed(0), device)
    batch = make_batch(cfg, args.batch, args.prompt_len, seed=0)
    t0 = time.perf_counter()
    out = generate(params, cfg, batch, args.gen,
                   max_seq=args.prompt_len + args.gen + 8).cpu().numpy()
    dt = time.perf_counter() - t0
    print(f"arch={cfg.name} device={device} generated {out.shape} in "
          f"{dt:.2f}s ({args.batch * args.gen / dt:.1f} tok/s)")
    print(out[:, :12])


if __name__ == "__main__":
    main()
