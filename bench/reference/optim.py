"""AdamW with global-norm clipping and a linear-warmup cosine schedule, in
plain PyTorch (decoupled weight decay, bias-corrected moments)."""
from __future__ import annotations

import math

import torch


def cosine_lr(step: int, base_lr: float, warmup: int, total: int) -> float:
    """The learning rate of update ``step`` (1 for the first update),
    rounded to float32 as the schedule is stated in float32."""
    if step < warmup:
        lr = base_lr * step / max(1.0, warmup)
    else:
        frac = min(max((step - warmup) / max(1.0, total - warmup), 0.0), 1.0)
        lr = 0.5 * base_lr * (1.0 + math.cos(math.pi * frac))
    return float(torch.tensor(lr, dtype=torch.float32))


class AdamW:
    def __init__(self, params: dict, spec: dict):
        self.spec = spec
        self.step = 0
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def clip(self, grads: dict) -> dict:
        """The gradients scaled to a global norm of at most ``grad_clip``:
        what the update is given."""
        clip = self.spec.get("grad_clip")
        if clip is None:
            return grads
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
        scale = min(1.0, float(clip) / (float(norm) + 1e-9))
        return {k: g * scale for k, g in grads.items()}

    @torch.no_grad()
    def update(self, params: dict, grads: dict) -> None:
        """One update of ``params`` in place from the clipped ``grads``."""
        s = self.spec
        b1, b2 = s.get("b1", 0.9), s.get("b2", 0.999)
        eps, wd = s.get("eps", 1e-8), s.get("weight_decay", 0.0)
        self.step += 1
        lr = cosine_lr(self.step, s["lr"], s["warmup"], s["total"])
        c1, c2 = 1.0 - b1 ** self.step, 1.0 - b2 ** self.step
        for k, p in params.items():
            g = grads[k]
            self.mu[k].mul_(b1).add_(g, alpha=1.0 - b1)
            self.nu[k].mul_(b2).add_(g * g, alpha=1.0 - b2)
            upd = (self.mu[k] / c1) / ((self.nu[k] / c2).sqrt() + eps)
            p.sub_(lr * (upd + wd * p))
