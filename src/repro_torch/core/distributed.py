"""Device engine, serving half: the forward over ``[cached | fetched]``.

The reference (``repro.core.distributed``) jit-compiles one program per
argument-shape bucket and records each trace in a module-level log, which
the serve rungs' compile-once gate reads. PyTorch runs eagerly and has no
trace: here a "trace" is the first call of a compiled callable with a new
shape signature. The log keeps its meaning — a serve rung that is warm
adds no record — and so holds for the CUDA graphs later work captures per
signature. The training programs arrive with the training slice.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.models.gnn.models import GNNConfig, gnn_forward
from repro_torch.obs import metrics as _obs_metrics
from repro_torch.obs import trace as _obs_trace

# ("infer", cfg) -> compiled callable
_COMPILE_CACHE: dict = {}

# One record per new shape signature of a compiled callable: (kind, model,
# pregather, fetched shape, cache shape, hop signature).
_TRACE_LOG: list = []


def trace_count() -> int:
    """Number of traces since process start."""
    return len(_TRACE_LOG)


def trace_log() -> tuple:
    """Immutable view of the trace records."""
    return tuple(_TRACE_LOG)


def clear_compile_cache() -> None:
    """Drop cached callables (forces fresh traces — test isolation)."""
    _COMPILE_CACHE.clear()


def infer_trace_count() -> int:
    """Traces of the serving forward alone (kind ``"infer"`` records)."""
    return sum(1 for r in _TRACE_LOG if r[0] == "infer")


def _note_trace(kind: str, cfg: GNNConfig, table, cache, hops) -> None:
    _TRACE_LOG.append((kind, cfg.model, True, tuple(table.shape),
                       tuple(cache.shape),
                       tuple((tuple(h.shape), str(h.dtype)) for h in hops)))
    _obs_metrics.inc("engine.traces")
    _obs_trace.event("engine.retrace", kind=kind, model=cfg.model)


def get_compiled_inference(cfg: GNNConfig):
    """Cached serving forward (the port's serving device program).

    Signature ``fn(params, cache_tab, fetched, *hop_idx) -> logits``:
    ``params`` the :class:`~repro_torch.models.gnn.models.GNN`,
    ``cache_tab`` the serve cache's resident ``(c_max, d)`` hot rows as a
    tensor on the device the forward runs on (height 0 disables it),
    ``fetched`` the micro-batch's host-gathered ``(u_max, d)`` unique rows
    (numpy), and ``hop_idx[h]`` the ``(batch_pad · fanout^h,)`` int32 tree
    positions (numpy) into the concatenated ``[cached | fetched]``
    workspace. The host checks every position against the workspace height
    before upload — the kernel does no bounds check — then each hop's rows
    are gathered with ``ops.gather_rows`` and the GNN forward runs on the
    device. Returns ``(batch_pad, num_classes)`` logits on the device.
    """
    key = ("infer", cfg)
    fn = _COMPILE_CACHE.get(key)
    if fn is None:
        seen: set = set()

        @torch.inference_mode()
        def infer(params, cache_tab, fetched, *hop_idx):
            height = cache_tab.shape[0] + fetched.shape[0]
            for h, idx in enumerate(hop_idx):
                if idx.dtype != np.int32:
                    raise TypeError(f"hop_idx[{h}] must be int32, got "
                                    f"{idx.dtype}")
                if idx.size and (idx.min() < 0 or idx.max() >= height):
                    raise IndexError(
                        f"hop_idx[{h}] points outside the workspace: range "
                        f"[{idx.min()}, {idx.max()}], height {height}")
            sig = (tuple(cache_tab.shape), str(cache_tab.dtype),
                   fetched.shape, str(fetched.dtype),
                   tuple(i.shape for i in hop_idx), str(cache_tab.device))
            if sig not in seen:
                seen.add(sig)
                _note_trace("infer", cfg, fetched, cache_tab, hop_idx)
            dev = cache_tab.device
            ws = torch.cat([cache_tab, torch.from_numpy(fetched).to(dev)], 0)
            feats = [ops.gather_rows(ws, torch.from_numpy(i).to(dev))
                     for i in hop_idx]
            return gnn_forward(params, cfg, feats)

        fn = infer
        _COMPILE_CACHE[key] = fn
    return fn
