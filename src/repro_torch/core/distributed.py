"""Device engine: execute an IterationPlan, and the serving forward.

The reference (``repro.core.distributed``) writes the per-iteration
computation once against a ``Comm`` interface: real collectives inside
``shard_map`` (``ShardComm``), or the same exchange as gathers over
globally stacked arrays on one device (``EmulatedComm``). The port has
both halves:

* **Emulated** (``mesh=None``): all N shards run on one device, the
  exchange is plain tensor indexing (bitwise the reference's data
  movement), and a Python loop over shards and time steps takes the place
  of the reference's ``vmap`` and ``scan``.
* **Sharded** (``mesh=`` a 1-D ``torch.distributed`` ``DeviceMesh`` over
  the ``"data"`` axis, one process per shard): the PyTorch idiom for
  ``shard_map`` is SPMD — every rank runs the same program with the same
  seeds, so it builds the same plans, and executes only its own shard.
  :class:`ShardComm` joins the ranks with ``all_to_all_single`` for the
  exchanges and ONE ``all_reduce`` per iteration over a flat buffer of
  every gradient leaf and the shard's loss sum (DDP's bucketing; the
  reference runs one psum per leaf, which is elementwise the same sum).
  NCCL on the card, gloo on the CPU. :func:`prepare_iteration_args` hands
  the shard body the rank's slice of every leading-N argument, with the
  shard axis kept at size 1 as ``shard_map`` does, and uploads only that
  slice. Over one rank the collectives are copies, so the sharded
  iteration is bitwise the emulated one; over N ranks the gradient sum
  runs in the collective's order, not shard order, and agrees with the
  emulated sum at float32 tolerance.

The feature exchange is LeapGNN's pre-gathering (§5.2): the plan's
deduplicated request indices select each peer's rows once per iteration,
and every time step of the shard then gathers its tree rows from the
workspace ``[local | cached | fetched]`` with the ``gather_rows`` kernel
(:mod:`repro_torch.kernels.ops`) — once per (shard, step, hop). Per-step
mode rebuilds the fetched region every step, from one batched index
exchange ahead of the steps and either one folded feature return
(``fold_returns``) or one per step, as the reference does.

Streamed mode (a tiered FeatureStore, :mod:`repro_torch.features`): the
plan carries its own feature blocks, host-gathered through the store's
tiers — the touched local rows compacted into ``feat_local`` and the miss
rows in ``feat_fetch`` — so no feature table lives on the device and no
feature exchange runs. Each shard's workspace is ``[feat_local | cached |
feat_fetch]``, gathered from with the same ``gather_rows`` kernel; the
values per tree position equal the resident path's, so grads and losses
are bitwise the resident iteration's.

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

import os
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.tree import tree_leaves
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
# Device meshes: one process per shard
# ---------------------------------------------------------------------------

def mesh_group(mesh):
    """The process group of a 1-D mesh's ``"data"`` axis."""
    if mesh.ndim != 1:
        raise ValueError(f"the engine takes a 1-D mesh, got {mesh.ndim} "
                         f"dimensions")
    return mesh.get_group(0)


def mesh_rank(mesh) -> int:
    """This process's shard: its rank on the mesh's data axis."""
    return dist.get_rank(mesh_group(mesh))


def mesh_device(mesh) -> torch.device:
    """The device this rank computes on: the CPU for a CPU mesh, else
    ``cuda:LOCAL_RANK`` (set by torchrun; without it, the global rank
    modulo the cards this process sees)."""
    if mesh.device_type == "cpu":
        return torch.device("cpu")
    local = os.environ.get("LOCAL_RANK")
    index = (int(local) if local is not None
             else dist.get_rank() % torch.cuda.device_count())
    return torch.device(mesh.device_type, index)


def check_mesh(mesh, num_shards: int) -> None:
    """The reference's precondition: the data axis has one rank per shard."""
    if mesh.size() != num_shards:
        raise ValueError(f"mesh of {mesh.size()} ranks for a plan of "
                         f"{num_shards} shards: the data axis needs one "
                         f"rank per shard")


def agree_max(values, mesh) -> list:
    """The elementwise max over the mesh's ranks of a few host numbers.

    Under a mesh every host decision that precedes a collective must come
    out the same on every rank, or the ranks enter different collectives:
    the Trainer agrees the ones read from a wall clock or a thread's
    timing (the merge controller's epoch time, the retry guard's deadline,
    the plan wait's stall deadline) with this small ``all_reduce(MAX)``
    on the mesh's own group and device."""
    t = torch.tensor([float(v) for v in values], dtype=torch.float64,
                     device=mesh_device(mesh))
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh_group(mesh))
    return t.tolist()


class ShardComm:
    """Real collectives over a process group, one rank per shard: the
    reference's ``ShardComm`` (``lax.all_to_all``/``psum`` inside
    ``shard_map``) as ``torch.distributed`` calls.

    Every method is data movement over the group except the two means,
    which sum with ``all_reduce`` and then divide. ``counts`` and
    ``nbytes`` record, per collective, the executions this instance made
    and the bytes each rank handed them (its own chunk included) —
    :func:`collective_counts` reads the former.

    On a ``fake`` group (the pod dry run, :mod:`repro_torch.launch.mesh`)
    no data crosses between ranks, and whether the backend writes the
    receive buffer at all depends on the torch version. So there an
    all_to_all's receive buffer is seeded with a copy of the send buffer
    before the collective (``loopback``): every peer asks this rank for
    what it asked them for, and fetched rows are rows of its own shard at
    valid indices. Real groups (gloo, NCCL) receive into a fresh buffer."""

    def __init__(self, group=None):
        self.group = group
        self.size = dist.get_world_size(group)
        self.loopback = dist.get_backend(group) == "fake"
        self.counts = {"all_to_all": 0, "all_reduce": 0}
        self.nbytes = {"all_to_all": 0, "all_reduce": 0}

    def _note(self, name: str, x: torch.Tensor) -> None:
        self.counts[name] += 1
        self.nbytes[name] += x.numel() * x.element_size()

    def _all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """Split dim 0 into ``size`` equal chunks, send chunk p to rank p
        and stack what each rank sent back in rank order. A zero-size
        exchange (``r_max = 0``) is issued like any other."""
        x = x.contiguous()
        out = torch.empty_like(x)
        if self.loopback:
            out.copy_(x)
        dist.all_to_all_single(out, x, group=self.group)
        self._note("all_to_all", x)
        return out

    def exchange_indices(self, req: torch.Tensor) -> torch.Tensor:
        """req: (P, r_max) peer-local indices I want. Returns (P, r_max):
        row p = indices peer p wants from me."""
        return self._all_to_all(req)

    def exchange_indices_batched(self, step_req: torch.Tensor
                                 ) -> torch.Tensor:
        """step_req: (T, P, r_max) — all T per-step requests in ONE
        all_to_all. Returns (T, P, r_max): ``out[t, p]`` = indices peer p
        wants from me at step t. The reference splits axis 1;
        ``all_to_all_single`` splits dim 0, so the peer axis moves in
        front for the exchange and back after it."""
        return self._all_to_all(step_req.permute(1, 0, 2)).permute(1, 0, 2)

    def serve_features(self, table: torch.Tensor,
                       incoming: torch.Tensor) -> torch.Tensor:
        """table: (local_rows, d); incoming: (P, r_max) indices each peer
        wants from me. Gathers them from the local shard (the reference's
        ``jnp.take``, outside any kernel) and ships them back; returns
        (P, r_max, d): row p = rows fetched from peer p."""
        P, r = incoming.shape
        served = table.index_select(0, incoming.reshape(-1).long())
        return self._all_to_all(served.reshape(P, r, table.shape[1]))

    def serve_features_batched(self, table: torch.Tensor,
                               incoming: torch.Tensor) -> torch.Tensor:
        """All T feature returns in ONE all_to_all. incoming: (T, P, r_max)
        server-view indices. Returns (T, P, r_max, d): ``out[t]`` equals
        the per-step :meth:`serve_features` of ``incoming[t]``."""
        T, P, r = incoming.shape
        served = table.index_select(0, incoming.reshape(-1).long())
        served = served.reshape(T, P, r, table.shape[1]).permute(1, 0, 2, 3)
        return self._all_to_all(served).permute(1, 0, 2, 3)

    def exchange(self, table: torch.Tensor,
                 req: torch.Tensor) -> torch.Tensor:
        """table: (local_rows, d); req: (P, r_max) peer-local indices.
        Returns (P, r_max, d): row p = rows fetched from peer p."""
        return self.serve_features(table, self.exchange_indices(req))

    def _sum(self, tensors: list) -> torch.Tensor:
        """Every tensor summed over the group by ONE all_reduce of a flat
        buffer (one dtype), returned flat."""
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=self.group)
        self._note("all_reduce", flat)
        return flat

    def grad_mean(self, grads: list, denom, loss_sum=None):
        """The gradient leaves summed over the group and divided by
        ``denom``. With ``loss_sum`` the shard's loss sum rides in the same
        buffer and ``(grads, loss)`` comes back: one all_reduce per
        iteration."""
        parts = list(grads) + ([] if loss_sum is None
                               else [loss_sum.reshape(1)])
        flat = self._sum(parts) / denom
        out = [f.view_as(g) for f, g in
               zip(torch.split(flat, [t.numel() for t in parts]), parts)]
        if loss_sum is None:
            return out
        return out[:-1], out[-1].reshape(())

    def mean_scalar(self, x: torch.Tensor) -> torch.Tensor:
        """The mean of a scalar over the group (the reference's pmean)."""
        return self._sum([x]).reshape(x.shape) / self.size

    # -- membership hooks: a peer's death is registered process-wide, so
    # every comm boundary sees the same world view
    @staticmethod
    def kill(shard: int) -> None:
        kill_peer(shard)

    @staticmethod
    def revive(shard: int) -> None:
        revive_peer(shard)


# ---------------------------------------------------------------------------
# Per-shard iteration body
# ---------------------------------------------------------------------------

def _shard_grads(params, cfg: GNNConfig, workspace_fn: Callable,
                 hop_idx, labels, weights):
    """Run the time steps of one shard, accumulating grads and loss.

    workspace_fn(t) -> (rows, d) feature workspace for step t (one tensor
    for every step in pregather mode). The per-hop feature gather is the
    ``gather_rows`` CUDA kernel on the card and its plain version on the
    CPU, dispatched by :mod:`repro_torch.kernels.ops`. Each step's loss
    runs in a ``model.forward`` span (tagged with the layer kind) and its
    gradient in a ``model.backward`` span. Returns (grad leaves in
    :meth:`GNN.leaves` order, loss sum), both detached."""
    leaves = params.leaves()
    gacc, lacc = None, None
    for t in range(labels.shape[0]):
        ws = workspace_fn(t)
        feats = [ops.gather_rows(ws, h[t]) for h in hop_idx]
        with _obs_trace.span("model.forward", layer=cfg.model):
            loss, _ = gnn_loss(params, cfg, feats, labels[t],
                               weight=weights[t])
        with _obs_trace.span("model.backward"):
            g = torch.autograd.grad(loss, leaves)
        if gacc is None:                    # 0 + g_0 == g_0 exactly
            gacc, lacc = list(g), loss.detach()
        else:
            torch._foreach_add_(gacc, g)
            lacc = lacc + loss.detach()
    return gacc, lacc


def _emulated_streamed_iteration(params, cache_g, dev, denom,
                                 cfg: GNNConfig):
    """Streamed mode, all shards on one device: each shard's workspace
    comes straight from the plan's feature blocks (no table, no exchange).
    Feature values per tree position equal the resident path's exactly —
    only the slot numbering differs — so grads and losses are bitwise the
    resident iteration's."""
    ecomm = EmulatedComm()
    n = dev["labels"].shape[0]
    d = dev["feat_local"].shape[-1]
    per_shard = []
    for s in range(n):
        ws = torch.cat([dev["feat_local"][s], cache_g[s],
                        dev["feat_fetch"][s].reshape(-1, d)], 0)
        hop_idx = [h[s] for h in dev["hop_idx"]]
        per_shard.append(_shard_grads(params, cfg, lambda t, ws=ws: ws,
                                      hop_idx, dev["labels"][s],
                                      dev["weights"][s]))
    grads = ecomm.grad_mean_global([g for g, _ in per_shard], denom)
    loss = sum(l for _, l in per_shard) / denom
    return grads, loss


def _emulated_iteration(params, table_g, cache_g, dev, denom,
                        cfg: GNNConfig, pregather: bool, fold_returns: bool,
                        streamed: bool = False):
    """All shards on one device: a loop over shards, explicit exchange
    (``streamed``: no table and no exchange; the plan carries the rows)."""
    if streamed:
        return _emulated_streamed_iteration(params, cache_g, dev, denom, cfg)
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


def _iteration_shard(params, table, cache, dev, cfg: GNNConfig,
                     pregather: bool, fold_returns: bool, denom,
                     comm: ShardComm):
    """The body each rank runs for its own shard. ``dev`` is the plan's
    device args with the shard axis stripped, ``table`` the shard's
    (local_rows, d) rows and ``cache`` its (c_max, d) cached remote rows;
    the workspace is ``[local | cached | fetched]``. Pregather: one index
    and one feature all_to_all ahead of the steps. Per-step: the T index
    requests in one batched all_to_all, then the T feature returns folded
    into one (``fold_returns``) or one per step."""
    d = table.shape[1]
    if pregather:
        ws = torch.cat([table, cache,
                        comm.exchange(table, dev["req"]).reshape(-1, d)], 0)
        workspace_fn = lambda t: ws  # noqa: E731
    else:
        incoming = comm.exchange_indices_batched(dev["step_req"])
        if fold_returns:
            recv_all = comm.serve_features_batched(table, incoming)

            def workspace_fn(t):
                return torch.cat([table, cache,
                                  recv_all[t].reshape(-1, d)], 0)
        else:
            def workspace_fn(t):
                recv = comm.serve_features(table, incoming[t])
                return torch.cat([table, cache, recv.reshape(-1, d)], 0)
    grads, loss_sum = _shard_grads(params, cfg, workspace_fn, dev["hop_idx"],
                                   dev["labels"], dev["weights"])
    return comm.grad_mean(grads, denom, loss_sum)


def _streamed_shard(params, cache, dev, cfg: GNNConfig, denom,
                    comm: ShardComm):
    """Streamed-mode shard body: the workspace comes entirely from the
    plan's feature blocks — ``[feat_local | cached | feat_fetch]`` — so no
    feature collective runs; only the gradient reduction remains."""
    d = dev["feat_local"].shape[-1]
    ws = torch.cat([dev["feat_local"], cache,
                    dev["feat_fetch"].reshape(-1, d)], 0)
    grads, loss_sum = _shard_grads(params, cfg, lambda t: ws, dev["hop_idx"],
                                   dev["labels"], dev["weights"])
    return comm.grad_mean(grads, denom, loss_sum)


def _grads_callable(cfg: GNNConfig, pregather: bool, fold_returns: bool,
                    streamed: bool, mesh) -> tuple:
    """``(fn, comm)``: the ``(params, table, cache, dev, denom) -> (grads,
    loss)`` core that the plain, fused and stacked callables wrap —
    emulated over stacked shards without a mesh (``comm`` None), else this
    rank's shard body over a :class:`ShardComm` on the mesh's group."""
    if mesh is None:
        def fn(params, table, cache, dev, denom):
            return _emulated_iteration(params, table, cache, dev, denom, cfg,
                                       pregather, fold_returns, streamed)
        return fn, None
    comm = ShardComm(mesh_group(mesh))

    def body(params, table, cache, dev, denom):
        # this rank's views with the shard axis kept (size 1), as
        # shard_map passes them
        table, cache = table[0], cache[0]
        dev = tree_map(lambda x: x[0], dev)
        if streamed:
            return _streamed_shard(params, cache, dev, cfg, denom, comm)
        return _iteration_shard(params, table, cache, dev, cfg, pregather,
                                fold_returns, denom, comm)
    return body, comm


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


def _mesh_key(mesh):
    """Compile-cache identity of a mesh: its id (the cached callable keeps
    the mesh as its ``mesh`` attribute, so the id is never recycled while
    the entry exists)."""
    return None if mesh is None else ("mesh-id", id(mesh))


def get_compiled_iteration(cfg: GNNConfig, pregather: bool,
                           fold_returns: bool = False,
                           streamed: bool = False, mesh=None):
    """The cached iteration callable for this engine configuration:
    ``fn(params, table, cache, dev, denom) -> (grads, loss)`` with
    ``table`` (N, local_rows, d) and ``cache`` (N, c_max, d) tensors on the
    device the parameters are on (c_max = 0 disables caching), ``dev`` the
    plan's device args as tensors there, and ``denom`` the true global
    batch size as a float32 scalar tensor. Returns the gradient leaves in
    :meth:`GNN.leaves` order and the mean loss, both on the device.
    ``fold_returns`` only affects per-step mode. ``streamed``: the plan
    carries its feature blocks (``feat_local``/``feat_fetch`` in ``dev``)
    and ``table`` is the shared zero-width placeholder; no feature exchange
    runs.

    With a ``mesh`` the callable is this rank's shard body (kind
    ``"sharded"``): every leading-N argument is the rank's slice with the
    shard axis kept at size 1 (:func:`prepare_iteration_args` makes them),
    and the callable's ``comm`` attribute is the :class:`ShardComm` whose
    counters :func:`collective_counts` reads."""
    key = ("emulated" if mesh is None else "sharded", cfg, bool(pregather),
           bool(fold_returns), bool(streamed), _mesh_key(mesh))
    fn = _COMPILE_CACHE.get(key)
    if fn is None:
        body, comm = _grads_callable(cfg, pregather, fold_returns, streamed,
                                     mesh)
        fn = _tracing(key[0], cfg, pregather, body, dev_pos=3)
        fn.comm = comm
        fn.mesh = mesh
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
                            stacked: bool = False,
                            streamed: bool = False, mesh=None):
    """Cached *fused* train step: iteration + optimizer update, one call.

    Signature ``fn(params, opt_state, table, cache, dev, denom) ->
    (params, opt_state, loss)``. The update runs in place (the parameters
    and moments given are overwritten and returned; continue from the
    returned ones). With ``stacked=True`` ``dev`` is a list of K plans'
    device args and ``denom`` a (K,) tensor; the fused step runs over the
    K iterations in order and the call returns (K,) losses. ``streamed``
    and ``mesh`` as for :func:`get_compiled_iteration`; under a mesh the
    gradients every rank applies are the same all-reduced sums, so the
    replicated parameters stay equal on every rank."""
    key = ("fused", cfg, bool(pregather), bool(fold_returns),
           optimizer_cache_key(optimizer), bool(stacked), bool(streamed),
           _mesh_key(mesh))
    fn = _COMPILE_CACHE.get(key)
    if fn is None:
        kind = (("emulated" if mesh is None else "sharded") + "-fused"
                + ("-stacked" if stacked else ""))
        grads_fn, comm = _grads_callable(cfg, pregather, fold_returns,
                                         streamed, mesh)

        def one(params, opt_state, table, cache, dev, denom):
            grads, loss = grads_fn(params, table, cache, dev, denom)
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
        fn.comm = comm
        fn.mesh = mesh
        _COMPILE_CACHE[key] = fn
    return fn


def make_sharded_iteration(cfg: GNNConfig, pregather: bool, mesh,
                           fold_returns: bool = False):
    """This rank's shard-body iteration ``fn(params, table, cache, dev,
    denom)`` for repeated use by a training loop (cached per config)."""
    return get_compiled_iteration(cfg, pregather, fold_returns=fold_returns,
                                  mesh=mesh)


def collective_counts(fn, *args) -> dict:
    """Collective *executions* in one call of ``fn(*args)``.

    The reference walks ``fn``'s jaxpr, multiplying a collective inside a
    ``scan`` by its trip count; the port has no jaxpr, so it runs ``fn``
    once (a fused step therefore applies its update) and returns what the
    callable's :class:`ShardComm` counted — ``{"all_to_all": n,
    "all_reduce": m}``, zero entries left out; an emulated callable runs
    none. Per iteration: pregather and folded per-step mode run 2
    all_to_alls, unfolded per-step mode T+1, streamed mode none; every
    mode runs one all_reduce."""
    comm = getattr(fn, "comm", None)
    before = dict(comm.counts) if comm is not None else {}
    fn(*args)
    if comm is None:
        return {}
    return {k: v - before[k] for k, v in comm.counts.items()
            if v - before[k]}


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
    (``l_max`` in place of ``local_rows`` for a streamed plan, whose feature
    blocks must have the plan's shapes) — the gather kernel does no bounds
    check — and request indices below ``local_rows``. Raises TypeError,
    IndexError or ValueError."""
    n, streamed = plan.num_shards, plan.streamed
    height = (plan.l_max if streamed else plan.local_rows) \
        + plan.c_max + n * plan.r_max
    if streamed:
        d = plan.feat_local.shape[-1]
        for name, arr, want in (
                ("feat_local", plan.feat_local, (n, plan.l_max, d)),
                ("feat_fetch", plan.feat_fetch, (n, n, plan.r_max, d))):
            if tuple(arr.shape) != want:
                raise ValueError(f"{name} {tuple(arr.shape)} does not match "
                                 f"the plan's {want}")
        reqs = []
    else:
        reqs = [("req" if plan.pregather else "step_req",
                 plan.req if plan.pregather else plan.step_req,
                 plan.local_rows)]
    for name, arr, hi in ([(f"hop_idx[{h}]", a, height)
                           for h, a in enumerate(plan.hop_idx)] + reqs):
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


# Host comm boundary hook (repro_torch.resilience). In a multi-host
# deployment each exchange is an RPC fan-out that can stall or drop; here
# the host-side point where an iteration's exchanges are initiated is the
# dispatch that stages their arguments. A fault or robustness layer
# installs a callable here; it runs BEFORE the iteration's forward pass and
# its in-place optimizer update (the port's stand-in for the reference's
# buffer donation), so a raise from the hook is always safe to retry. None
# (the default) costs one global read.
_COMM_FAULT_HOOK: Optional[Callable] = None


def set_comm_fault_hook(hook: Optional[Callable]) -> None:
    """Install/remove the host comm-boundary hook (``hook(plan)``)."""
    global _COMM_FAULT_HOOK
    _COMM_FAULT_HOOK = hook


# Dead-peer registry (repro_torch.membership). On a multi-host deployment
# liveness comes from the RPC layer; in this single-process harness a death
# is registered here — by the ``peer_death`` fault kind or a membership
# test — and every later dispatch that would contact the fabric raises
# PeerDeadError from the host staging boundary. The raise comes before any
# update (safe to retry) and persists until revive_peer, so a guarded
# caller's retries exhaust into a CommTimeout with the peer attributed —
# the signal repro_torch.membership consumes.
_DEAD_PEERS: set = set()


class PeerDeadError(RuntimeError):
    """An exchange addressed a peer registered as dead.

    A typed transient for the retry guard (repro_torch.resilience.comm
    retries it alongside TransientCommError): the *probe* decides
    permanence, not the raise — a flapping peer that comes back mid-retry
    is absorbed with no membership change."""

    def __init__(self, msg: str, *, peer: int = -1):
        super().__init__(msg)
        self.site = "comm"
        self.peer = int(peer)


def kill_peer(shard: int) -> None:
    """Register ``shard`` as dead; every later dispatch fails until
    :func:`revive_peer`."""
    _DEAD_PEERS.add(int(shard))


def revive_peer(shard: int) -> None:
    _DEAD_PEERS.discard(int(shard))


def peer_is_dead(shard: int) -> bool:
    return int(shard) in _DEAD_PEERS


def dead_peers() -> frozenset:
    return frozenset(_DEAD_PEERS)


def comm_fault_point(plan) -> None:
    """Run the comm-boundary hook for one iteration dispatch, before any
    in-place update. Called by :func:`prepare_iteration_args` and the
    Trainer's stacked dispatch.

    The hook runs first (a scheduled ``peer_death`` fault registers the
    kill here), then the dead-peer registry is consulted: a dispatch stages
    exchanges with *every* peer, so any registered death fails the staging
    with the peer attributed."""
    hook = _COMM_FAULT_HOOK
    if hook is not None:
        hook(plan)
    if _DEAD_PEERS:
        peer = min(_DEAD_PEERS)
        ei = getattr(plan, "epoch_it", (-1, -1))
        raise PeerDeadError(
            f"peer shard {peer} is dead at (epoch {ei[0]}, it {ei[1]}); "
            "exchange fan-out cannot be staged", peer=peer)


def block_until_ready(device: torch.device) -> None:
    """Wait until the work queued on ``device``'s current stream is done:
    a CUDA event recorded there and synchronized (on the CPU, work is
    already done when a call returns)."""
    if device.type == "cuda":
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(device))
        ev.synchronize()


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a numpy dtype."""
    return torch.from_numpy(np.empty(0, dtype)).dtype


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


def shard_slice(x, shard: Optional[int], num_shards: int):
    """This rank's slice ``x[shard:shard+1]`` of a leading-N array or
    tensor (the shard axis kept at size 1, as ``shard_map`` passes it);
    ``x`` itself without a shard, or when it already holds one shard's
    slice (leading axis 1)."""
    if shard is None or x is None or x.shape[0] == 1:
        return x
    if x.shape[0] != num_shards:
        raise ValueError(f"leading axis {x.shape[0]} is neither the "
                         f"{num_shards} shards nor one shard's slice")
    return x[shard:shard + 1]


def prepare_iteration_args(table_global, plan, cache=None, device=None,
                           fault_point: bool = True, mesh=None):
    """Shared argument prep for :func:`run_iteration` /
    :func:`run_train_step`: validates the table and cache against the plan
    and returns device-ready ``(table, cache, dev, denom)``.

    The iteration runs on the table's device when it is a tensor, else on
    ``device`` (default ``cuda``; under a mesh, the rank's device). Fast
    path: a plan whose device args were committed by the pipeline uploader
    (``plan.committed``) skips the upload (:func:`plan_device_args`); an
    uncommitted plan has its indices checked on the host here, then
    uploads. The comm fault point runs first, before anything reaches the
    device, unless the caller ran it already (``fault_point=False``).

    Under a ``mesh`` (one rank per shard, the reference's precondition)
    every leading-N argument — table, cache, plan args — becomes this
    rank's slice with the shard axis kept at size 1, and only that slice
    is uploaded. A table or cache that already holds one shard's slice
    passes as it is.

    Streamed plans: no resident table exists — ``table_global=None`` is
    replaced by the shared zero-width placeholder on ``device`` (the
    plan's feature blocks ride in its device args)."""
    if fault_point:
        comm_fault_point(plan)
    shard = None
    n_local = plan.num_shards
    if mesh is not None:
        check_mesh(mesh, plan.num_shards)
        shard, n_local = mesh_rank(mesh), 1
        if device is None and not isinstance(table_global, torch.Tensor):
            device = mesh_device(mesh)
    if table_global is None:
        if not plan.streamed:
            raise ValueError("table_global=None is only valid for streamed "
                             "plans (tiered FeatureStore)")
        fl = plan.feat_local
        table_global = empty_cache_table(n_local, fl.shape[-1],
                                         torch_dtype(fl.dtype), device)
    table_global = shard_slice(table_global, shard, plan.num_shards)
    if not isinstance(table_global, torch.Tensor):
        table_global = upload(table_global, resolve_device(device))
    device = table_global.device
    # a streamed plan never reads the table: no shape to check
    if not plan.streamed and \
            tuple(table_global.shape[:2]) != (n_local, plan.local_rows):
        raise ValueError(f"table {tuple(table_global.shape)} does not match "
                         f"the plan's ({n_local}, {plan.local_rows}, d)")
    if cache is None:
        if plan.c_max:
            raise ValueError(
                f"plan was built against a cache (c_max={plan.c_max}) "
                "but no cache table was passed")
        cache = empty_cache_table(n_local, table_global.shape[-1],
                                  table_global.dtype, device)
    else:
        cache = upload(shard_slice(cache, shard, plan.num_shards), device)
        if int(cache.shape[1]) != int(plan.c_max):
            raise ValueError(
                f"cache table height {cache.shape[1]} != plan c_max "
                f"{plan.c_max} (stale cache?)")
    dev, denom = plan_device_args(plan, device, shard)
    return table_global, cache, dev, denom


def plan_device_args(plan, device: torch.device,
                     shard: Optional[int] = None):
    """``(dev, denom)`` of one plan on ``device`` (with ``shard``: that
    shard's slice of every leading-N leaf): the committed tensors when the
    pipeline uploaded them — the current stream then waits for the
    upload's event, and each tensor is marked as used on that stream so the
    caching allocator does not hand its memory to a later upload while this
    stream still reads it — else the plan's arrays, checked and uploaded."""
    committed = plan.committed
    if committed is None:
        check_plan_indices(plan)
        dev = tree_map(lambda x: upload(shard_slice(x, shard,
                                                    plan.num_shards),
                                        device), plan.device_args())
        denom = torch.tensor(float(plan.global_batch), dtype=torch.float32,
                             device=device)
        return dev, denom
    if committed.get("shard") != shard:
        raise ValueError(f"plan committed for shard {committed.get('shard')}"
                         f" dispatched for shard {shard}")
    dev, denom = committed["dev"], committed["denom"]
    if committed["event"] is not None:
        stream = torch.cuda.current_stream(device)
        stream.wait_event(committed["event"])
        for t in tree_leaves(dev) + [denom]:
            t.record_stream(stream)
    return dev, denom


def run_iteration(params, table_global, plan, cfg: GNNConfig, cache=None,
                  fold_returns: Optional[bool] = None, device=None,
                  mesh=None):
    """Execute one planned iteration.

    Without a ``mesh``, all shards are emulated on one device. With one
    (a 1-D ``DeviceMesh`` of ``plan.num_shards`` ranks, every rank calling
    with the same plan), this rank runs its own shard with real
    collectives (same numerics up to the gradient sum's order).
    ``cache`` is the (N, c_max, d) remote-feature table a cache-aware plan
    was built against (required iff plan.c_max > 0; its height must match
    the plan's). ``fold_returns=None`` applies the
    :data:`FOLD_RETURNS_MAX_TR` auto policy in per-step mode. Returns
    (grad leaves in :meth:`GNN.leaves` order, mean loss) — the optimizer
    update is the caller's (see :func:`run_train_step` for the fused
    variant)."""
    table_global, cache, dev, denom = prepare_iteration_args(
        table_global, plan, cache, device, mesh=mesh)
    fn = get_compiled_iteration(cfg, plan.pregather,
                                fold_returns=resolve_fold_returns(
                                    plan, fold_returns),
                                streamed=plan.streamed, mesh=mesh)
    return fn(params, table_global, cache, dev, denom)


def run_train_step(params, opt_state, table_global, plan, cfg: GNNConfig,
                   optimizer, cache=None,
                   fold_returns: Optional[bool] = None, device=None,
                   mesh=None):
    """Execute one planned iteration *and* the optimizer update as one
    fused call. Returns ``(params, opt_state, loss)``; the parameters and
    moments are updated in place. The loss stays on the device (no host
    sync); call ``float(loss)`` only when the value is needed. ``mesh`` as
    for :func:`run_iteration`."""
    table_global, cache, dev, denom = prepare_iteration_args(
        table_global, plan, cache, device, mesh=mesh)
    fn = get_compiled_train_step(cfg, plan.pregather, optimizer,
                                 fold_returns=resolve_fold_returns(
                                     plan, fold_returns),
                                 streamed=plan.streamed, mesh=mesh)
    return fn(params, opt_state, table_global, cache, dev, denom)
