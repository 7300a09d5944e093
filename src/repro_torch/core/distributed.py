"""Device engine: execute an IterationPlan, and the serving forward.

The reference (``repro.core.distributed``) writes the per-iteration
computation once against a ``Comm`` interface: real collectives inside
``shard_map`` (``ShardComm``), or the same exchange as gathers over
globally stacked arrays on one device (``EmulatedComm``). The port has the
emulated half: all N shards run on one device, the exchange is plain
tensor indexing (bitwise the reference's data movement), and a Python loop
over shards and time steps takes the place of the reference's ``vmap`` and
``scan``. Multi-GPU collectives over NCCL are ROADMAP Queue 1 item 8.

The feature exchange is LeapGNN's pre-gathering (§5.2): the plan's
deduplicated request indices select each peer's rows once per iteration,
and every time step of the shard then gathers its tree rows from the
workspace ``[local | cached | fetched]`` with the ``gather_rows`` kernel
(:mod:`repro_torch.kernels.ops`) — once per (shard, step, hop). Per-step
mode rebuilds the fetched region every step, from one batched index
exchange ahead of the steps and either one folded feature return
(``fold_returns``) or one per step, as the reference does.

Gradients: each time step's loss (a padding-masked sum) is differentiated
with ``torch.autograd.grad`` with respect to the parameters only — the
workspace never requires a gradient, as the reference never differentiates
it, so the forward-only kernel suffices. A shard sums its T step gradients
from its first in step order; the shards' sums are added in shard order and
divided by the true global batch (``denom``), which is the reference's
grouping. Summation inside each kernel differs from XLA's, so grads agree
with the reference at float32 tolerance.

Compile-once contract: PyTorch runs eagerly and has no trace. Each cached
callable (:func:`get_compiled_iteration`, :func:`get_compiled_train_step`,
:func:`get_compiled_inference`) instead records in a module-level trace log
the first call of every new argument-shape signature, with the reference's
``kind``. A warm shape bucket adds no record, so the Trainer's
zero-retraces-after-epoch-0 gate and serving's zero-retraces-after-warmup
gate read the reference's signal — and mark where CUDA graphs would be
captured.

Fused train step: :func:`get_compiled_train_step` runs the iteration and
the optimizer update in one call, ``fn(params, opt_state, table, cache,
dev, denom) -> (params, opt_state, loss)``. The update writes the
parameters and moments in place, which stands in for the reference's
buffer donation: the caller continues from what the call returns. With
``stacked=True`` the call takes K plans' device args and a (K,) denom
vector and loops the fused step over them, returning (K,) losses.

Argument fast path: :func:`prepare_iteration_args` uploads a plan's numpy
arrays only when the pipeline has not committed them already
(``plan.committed``, see repro_torch.train.pipeline). Every index a plan
hands the device is checked on the host once per plan — at commit or
here — since the gather kernel does no bounds check.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models.gnn.models import GNNConfig, gnn_forward, gnn_loss
from repro_torch.obs import metrics as _obs_metrics
from repro_torch.obs import trace as _obs_trace


# ---------------------------------------------------------------------------
# Trees of device arguments (dicts, lists, tensors or arrays, and None)
# ---------------------------------------------------------------------------

def tree_map(fn, tree):
    """``fn`` over every array of a tree of dicts and lists; None stays."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_leaves(tree) -> list:
    """The arrays of a tree in ``jax.tree.leaves`` order (dicts by sorted
    key, None skipped)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def _dtype_name(x) -> str:
    return str(x.dtype).removeprefix("torch.")


def _shape_sig(tree) -> tuple:
    return tuple((tuple(x.shape), _dtype_name(x)) for x in tree_leaves(tree))


# ---------------------------------------------------------------------------
# Emulated comm: the exchange as indexing over globally stacked tensors
# ---------------------------------------------------------------------------

class EmulatedComm:
    """Single-device emulation over globally stacked tensors (leading N
    axis). Every method is pure data movement, bitwise the reference's
    ``EmulatedComm``; ``grad_mean_global`` adds the shards in order."""

    @staticmethod
    def _peers(n: int, device, ndim: int) -> torch.Tensor:
        return torch.arange(n, device=device).reshape((n,) + (1,) * ndim)

    def exchange_global(self, table_g: torch.Tensor,
                        req_g: torch.Tensor) -> torch.Tensor:
        """table_g: (N, local_rows, d); req_g: (N, P, r_max).
        Returns (N, P, r_max, d): out[s, p] = table_g[p][req_g[s, p]]."""
        peer = self._peers(table_g.shape[0], table_g.device, 1)
        return table_g[peer, req_g.long()]

    def exchange_indices_batched_global(self, step_req_g: torch.Tensor
                                        ) -> torch.Tensor:
        """step_req_g: (N, T, P, r_max). Returns (N, T, P, r_max) in the
        *server* view: out[m, t, p] = step_req_g[p, t, m] — the indices
        peer p wants from shard m at step t (a transpose)."""
        return step_req_g.permute(2, 1, 0, 3)

    def serve_step_global(self, table_g: torch.Tensor,
                          incoming_g: torch.Tensor, t: int,
                          shard: int) -> torch.Tensor:
        """Feature return for requesting ``shard`` at step ``t``.
        incoming_g: (N, T, P, r_max) server view. Returns (P, r_max, d):
        row p = table_g[p][incoming_g[p, t, shard]]."""
        idx = incoming_g[:, t, shard]                          # (P, r_max)
        peer = self._peers(table_g.shape[0], table_g.device, 1)
        return table_g[peer, idx.long()]

    def serve_features_batched_global(self, table_g: torch.Tensor,
                                      incoming_g: torch.Tensor
                                      ) -> torch.Tensor:
        """All T feature returns for all shards at once. incoming_g:
        (N, T, P, r_max) server view. Returns (N, T, P, r_max, d):
        ``out[s, t, p] = table_g[p][incoming_g[p, t, s]]``."""
        peer = self._peers(table_g.shape[0], table_g.device, 3)
        out = table_g[peer, incoming_g.long()]               # (P, T, S, r, d)
        return out.permute(2, 1, 0, 3, 4)                    # (S, T, P, r, d)

    def grad_mean_global(self, grads_g: list, denom) -> list:
        """grads_g[s]: shard s's gradient leaves. Returns the leaves summed
        over shards in shard order, divided by ``denom``."""
        out = list(grads_g[0])             # shard 0's own sums, added into
        for g in grads_g[1:]:
            torch._foreach_add_(out, g)
        return torch._foreach_div(out, denom)


# ---------------------------------------------------------------------------
# Per-shard iteration body
# ---------------------------------------------------------------------------

def _shard_grads(params, cfg: GNNConfig, workspace_fn: Callable,
                 hop_idx, labels, weights):
    """Run the time steps of one shard, accumulating grads and loss.

    workspace_fn(t) -> (rows, d) feature workspace for step t (one tensor
    for every step in pregather mode). The per-hop feature gather is the
    ``gather_rows`` CUDA kernel on the card and its plain version on the
    CPU, dispatched by :mod:`repro_torch.kernels.ops`. Returns (grad
    leaves in :meth:`GNN.leaves` order, loss sum), both detached."""
    leaves = params.leaves()
    gacc, lacc = None, None
    for t in range(labels.shape[0]):
        ws = workspace_fn(t)
        feats = [ops.gather_rows(ws, h[t]) for h in hop_idx]
        loss, _ = gnn_loss(params, cfg, feats, labels[t], weight=weights[t])
        g = torch.autograd.grad(loss, leaves)
        if gacc is None:                    # 0 + g_0 == g_0 exactly
            gacc, lacc = list(g), loss.detach()
        else:
            torch._foreach_add_(gacc, g)
            lacc = lacc + loss.detach()
    return gacc, lacc


def _emulated_iteration(params, table_g, cache_g, dev, denom,
                        cfg: GNNConfig, pregather: bool, fold_returns: bool):
    """All shards on one device: a loop over shards, explicit exchange."""
    ecomm = EmulatedComm()
    n, d = table_g.shape[0], table_g.shape[-1]
    if pregather:
        recv_g = ecomm.exchange_global(table_g, dev["req"])   # (N,P,r,d)
    else:
        # the index exchange ahead of the steps, as the reference's one
        # batched collective (here a transpose)
        incoming_g = ecomm.exchange_indices_batched_global(dev["step_req"])
        if fold_returns:
            recv_all_g = ecomm.serve_features_batched_global(table_g,
                                                             incoming_g)
    per_shard = []
    for s in range(n):
        if pregather:
            ws = torch.cat([table_g[s], cache_g[s],
                            recv_g[s].reshape(-1, d)], 0)
            workspace_fn = lambda t, ws=ws: ws
        elif fold_returns:
            def workspace_fn(t, s=s):
                return torch.cat([table_g[s], cache_g[s],
                                  recv_all_g[s, t].reshape(-1, d)], 0)
        else:
            def workspace_fn(t, s=s):
                recv = ecomm.serve_step_global(table_g, incoming_g, t, s)
                return torch.cat([table_g[s], cache_g[s],
                                  recv.reshape(-1, d)], 0)
        hop_idx = [h[s] for h in dev["hop_idx"]]
        per_shard.append(_shard_grads(params, cfg, workspace_fn, hop_idx,
                                      dev["labels"][s], dev["weights"][s]))
    grads = ecomm.grad_mean_global([g for g, _ in per_shard], denom)
    loss = sum(l for _, l in per_shard) / denom
    return grads, loss


# ---------------------------------------------------------------------------
# Compiled-fn cache + trace log (compile-once contract)
# ---------------------------------------------------------------------------

# key -> cached callable; each callable records its own new signatures
_COMPILE_CACHE: dict = {}

# Fold the T per-step feature returns into one batched gather when
# T·r_max is at most this many rows per peer (the staging buffer is
# (N, T, P, r_max, d)). run_iteration's fold_returns=None consults this;
# pass an explicit bool to override.
FOLD_RETURNS_MAX_TR = 1 << 15

# One record per new shape signature of a cached callable: (kind, model,
# pregather, table shape, cache shape, device-arg signature).
_TRACE_LOG: list = []


def trace_count() -> int:
    """Number of traces since process start / last reset."""
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


def _note_trace(kind: str, cfg: GNNConfig, pregather: bool, table, cache,
                dev) -> None:
    _TRACE_LOG.append((kind, cfg.model, bool(pregather), tuple(table.shape),
                       tuple(cache.shape), _shape_sig(dev)))
    _obs_metrics.inc("engine.traces")
    _obs_trace.event("engine.retrace", kind=kind, model=cfg.model)


def _tracing(kind: str, cfg: GNNConfig, pregather: bool, body: Callable,
             dev_pos: int) -> Callable:
    """Wrap ``body(*args)`` so its first call with each new signature of
    (table, cache, device args, device) is recorded in the trace log. The
    table and cache are the two arguments before ``args[dev_pos]``."""
    seen: set = set()

    def fn(*args):
        table, cache, dev = args[dev_pos - 2:dev_pos + 1]
        sig = (tuple(table.shape), _dtype_name(table), tuple(cache.shape),
               _shape_sig(dev), str(table.device))
        if sig not in seen:
            seen.add(sig)
            _note_trace(kind, cfg, pregather, table, cache, dev)
        return body(*args)
    return fn


def get_compiled_iteration(cfg: GNNConfig, pregather: bool,
                           fold_returns: bool = False):
    """The cached iteration callable for this engine configuration:
    ``fn(params, table, cache, dev, denom) -> (grads, loss)`` with
    ``table`` (N, local_rows, d) and ``cache`` (N, c_max, d) tensors on the
    device the parameters are on (c_max = 0 disables caching), ``dev`` the
    plan's device args as tensors there, and ``denom`` the true global
    batch size as a float32 scalar tensor. Returns the gradient leaves in
    :meth:`GNN.leaves` order and the mean loss, both on the device.
    ``fold_returns`` only affects per-step mode."""
    key = ("emulated", cfg, bool(pregather), bool(fold_returns))
    fn = _COMPILE_CACHE.get(key)
    if fn is None:
        def body(params, table, cache, dev, denom):
            return _emulated_iteration(params, table, cache, dev, denom, cfg,
                                       pregather, fold_returns)
        fn = _tracing("emulated", cfg, pregather, body, dev_pos=3)
        _COMPILE_CACHE[key] = fn
    return fn


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
    Lives in the same compile cache and trace log as the training
    callables (kind ``"infer"``).
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
                _note_trace("infer", cfg, True, fetched, cache_tab,
                            list(hop_idx))
            dev = cache_tab.device
            ws = torch.cat([cache_tab, torch.from_numpy(fetched).to(dev)], 0)
            feats = [ops.gather_rows(ws, torch.from_numpy(i).to(dev))
                     for i in hop_idx]
            return gnn_forward(params, cfg, feats)

        fn = infer
        _COMPILE_CACHE[key] = fn
    return fn


def optimizer_cache_key(optimizer) -> tuple:
    """Stable cache identity for an optimizer: its declared value ``key``
    when it has one (two ``adam(5e-3)`` instances then share one cached
    train step), else the instance id — safe because the cached callable
    closes over the optimizer and keeps it alive, so the id is never
    recycled while the entry exists. A schedule optimizer without an
    explicit ``key=`` thus pins its entry for the process lifetime."""
    key = getattr(optimizer, "key", None)
    return key if key is not None else ("optimizer-id", id(optimizer))


def get_compiled_train_step(cfg: GNNConfig, pregather: bool, optimizer,
                            fold_returns: bool = False,
                            stacked: bool = False):
    """Cached *fused* train step: iteration + optimizer update, one call.

    Signature ``fn(params, opt_state, table, cache, dev, denom) ->
    (params, opt_state, loss)``. The update runs in place (the parameters
    and moments given are overwritten and returned; continue from the
    returned ones). With ``stacked=True`` ``dev`` is a list of K plans'
    device args and ``denom`` a (K,) tensor; the fused step runs over the
    K iterations in order and the call returns (K,) losses."""
    key = ("fused", cfg, bool(pregather), bool(fold_returns),
           optimizer_cache_key(optimizer), bool(stacked))
    fn = _COMPILE_CACHE.get(key)
    if fn is None:
        kind = "emulated-fused" + ("-stacked" if stacked else "")

        def one(params, opt_state, table, cache, dev, denom):
            grads, loss = _emulated_iteration(params, table, cache, dev,
                                              denom, cfg, pregather,
                                              fold_returns)
            params, opt_state = optimizer.update(grads, opt_state, params)
            return params, opt_state, loss

        def many(params, opt_state, table, cache, devs, denoms):
            losses = []
            for k, dev in enumerate(devs):
                params, opt_state, loss = one(params, opt_state, table,
                                              cache, dev, denoms[k])
                losses.append(loss)
            return params, opt_state, torch.stack(losses)

        fn = _tracing(kind, cfg, pregather, many if stacked else one,
                      dev_pos=4)
        _COMPILE_CACHE[key] = fn
    return fn


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------

def resolve_fold_returns(plan, fold_returns: Optional[bool] = None) -> bool:
    """Auto-fold policy: fold the per-step feature returns when the staging
    buffer is small enough (T·r_max ≤ FOLD_RETURNS_MAX_TR). Explicit bools
    pass through; pregather mode never folds (nothing to fold)."""
    if plan.pregather:
        return False
    if fold_returns is not None:
        return bool(fold_returns)
    return plan.num_steps * plan.r_max <= FOLD_RETURNS_MAX_TR


def check_plan_indices(plan) -> None:
    """Every index a plan hands the device, checked on the host: tree
    positions below the workspace height ``local_rows + c_max + P·r_max``
    (the gather kernel does no bounds check), request indices below
    ``local_rows``. Raises TypeError or IndexError."""
    height = plan.local_rows + plan.c_max + plan.num_shards * plan.r_max
    reqs = plan.req if plan.pregather else plan.step_req
    for name, arr, hi in ([(f"hop_idx[{h}]", a, height)
                           for h, a in enumerate(plan.hop_idx)]
                          + [("req" if plan.pregather else "step_req", reqs,
                              plan.local_rows)]):
        if arr.dtype != np.int32:
            raise TypeError(f"{name} must be int32, got {arr.dtype}")
        if arr.size and (arr.min() < 0 or arr.max() >= hi):
            raise IndexError(f"{name} points outside its table: range "
                             f"[{arr.min()}, {arr.max()}], height {hi}")


def upload(x, device: torch.device) -> torch.Tensor:
    """A numpy array (or tensor) as a tensor on ``device``."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))
    return t.to(device)


def block_until_ready(device: torch.device) -> None:
    """Wait until the work queued on ``device``'s current stream is done:
    a CUDA event recorded there and synchronized (on the CPU, work is
    already done when a call returns)."""
    if device.type == "cuda":
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(device))
        ev.synchronize()


# (num_shards, feature_dim, dtype, device) -> (N, 0, d) zeros. Cache-off
# iterations share one zero-width cache table.
_EMPTY_CACHE: dict = {}


def empty_cache_table(num_shards: int, feature_dim: int,
                      dtype=torch.float32, device=None) -> torch.Tensor:
    device = resolve_device(device)
    key = (int(num_shards), int(feature_dim), dtype, str(device))
    tab = _EMPTY_CACHE.get(key)
    if tab is None:
        tab = torch.zeros((key[0], 0, key[1]), dtype=dtype, device=device)
        _EMPTY_CACHE[key] = tab
    return tab


def prepare_iteration_args(table_global, plan, cache=None, device=None):
    """Shared argument prep for :func:`run_iteration` /
    :func:`run_train_step`: validates the table and cache against the plan
    and returns device-ready ``(table, cache, dev, denom)``.

    The iteration runs on the table's device when it is a tensor, else on
    ``device`` (default ``cuda``). Fast path: a plan whose device args were
    committed by the pipeline uploader (``plan.committed``) skips the
    upload (:func:`plan_device_args`); an uncommitted plan has its indices
    checked on the host here, then uploads."""
    if table_global is None:
        raise ValueError("table_global is required (streamed plans from a "
                         "tiered FeatureStore are not ported yet)")
    if not isinstance(table_global, torch.Tensor):
        table_global = upload(table_global, resolve_device(device))
    device = table_global.device
    if tuple(table_global.shape[:2]) != (plan.num_shards, plan.local_rows):
        raise ValueError(f"table {tuple(table_global.shape)} does not match "
                         f"the plan's ({plan.num_shards}, {plan.local_rows}, "
                         f"d)")
    if cache is None:
        if plan.c_max:
            raise ValueError(
                f"plan was built against a cache (c_max={plan.c_max}) "
                "but no cache table was passed")
        cache = empty_cache_table(plan.num_shards, table_global.shape[-1],
                                  table_global.dtype, device)
    else:
        cache = upload(cache, device)
        if int(cache.shape[1]) != int(plan.c_max):
            raise ValueError(
                f"cache table height {cache.shape[1]} != plan c_max "
                f"{plan.c_max} (stale cache?)")
    dev, denom = plan_device_args(plan, device)
    return table_global, cache, dev, denom


def plan_device_args(plan, device: torch.device):
    """``(dev, denom)`` of one plan on ``device``: the committed tensors
    when the pipeline uploaded them — the current stream then waits for the
    upload's event, and each tensor is marked as used on that stream so the
    caching allocator does not hand its memory to a later upload while this
    stream still reads it — else the plan's arrays, checked and uploaded."""
    committed = plan.committed
    if committed is None:
        check_plan_indices(plan)
        dev = tree_map(lambda x: upload(x, device), plan.device_args())
        denom = torch.tensor(float(plan.global_batch), dtype=torch.float32,
                             device=device)
        return dev, denom
    dev, denom = committed["dev"], committed["denom"]
    if committed["event"] is not None:
        stream = torch.cuda.current_stream(device)
        stream.wait_event(committed["event"])
        for t in tree_leaves(dev) + [denom]:
            t.record_stream(stream)
    return dev, denom


def run_iteration(params, table_global, plan, cfg: GNNConfig, cache=None,
                  fold_returns: Optional[bool] = None, device=None):
    """Execute one planned iteration on one device (all shards emulated).

    ``cache`` is the (N, c_max, d) remote-feature table a cache-aware plan
    was built against (required iff plan.c_max > 0; its height must match
    the plan's). ``fold_returns=None`` applies the
    :data:`FOLD_RETURNS_MAX_TR` auto policy in per-step mode. Returns
    (grad leaves in :meth:`GNN.leaves` order, mean loss) — the optimizer
    update is the caller's (see :func:`run_train_step` for the fused
    variant)."""
    table_global, cache, dev, denom = prepare_iteration_args(
        table_global, plan, cache, device)
    fn = get_compiled_iteration(cfg, plan.pregather,
                                fold_returns=resolve_fold_returns(
                                    plan, fold_returns))
    return fn(params, table_global, cache, dev, denom)


def run_train_step(params, opt_state, table_global, plan, cfg: GNNConfig,
                   optimizer, cache=None,
                   fold_returns: Optional[bool] = None, device=None):
    """Execute one planned iteration *and* the optimizer update as one
    fused call. Returns ``(params, opt_state, loss)``; the parameters and
    moments are updated in place. The loss stays on the device (no host
    sync); call ``float(loss)`` only when the value is needed."""
    table_global, cache, dev, denom = prepare_iteration_args(
        table_global, plan, cache, device)
    fn = get_compiled_train_step(cfg, plan.pregather, optimizer,
                                 fold_returns=resolve_fold_returns(
                                     plan, fold_returns))
    return fn(params, opt_state, table_global, cache, dev, denom)
