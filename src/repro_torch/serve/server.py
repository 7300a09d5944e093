"""Online GNN inference server on PyTorch.

The port of ``repro.serve.server``. The model is tiny and replicated, the
features are the traffic — so the serving path keeps feature bytes off the
per-request critical path:

  1. **Hot feature tier** — a device-resident :class:`CacheStore` admitted
     by an LFU over observed *request* frequencies (the roots of every
     micro-batch plus the tree rows fresh computes touch); fresh computes
     of frequently requested vertices then upload only their cache-miss
     rows.
  2. **Precomputed-embedding tier** (repro_torch.serve.embeddings) —
     cold vertices are answered from the offline full-graph forward's
     persisted logits table (``ckpt_dir``): no sampling, no gather, no
     device dispatch.
  3. **Fresh compute** — a dynamic micro-batch through ``plan_inference``
     → ``get_compiled_inference``: stateless sampling (``sample_seed=999``,
     the reference's eval seed), unique-row dedup against the cache index,
     pow2 ``ShapeBudget`` serve rungs, and on the device one ``gather_rows``
     kernel launch per hop followed by the GNN forward.

``mode="auto"`` routes a request fresh when its vertex sits in the hot set
(frequent vertices get current-params answers at cached-feature cost) and
precomputed otherwise; ``"fresh"``/``"precomputed"`` force one path.
Without ``ckpt_dir`` every request is fresh.

Compile-once contract: :meth:`warmup` runs every serve rung once (and
seeds each rung's fetch bucket with headroom); steady-state serving then
adds zero records to the engine's trace log.

Threads and streams: the batching loop dispatches on its own thread, and
every kernel launches on that thread's current stream. The only wait for
the device is the copy of the logits to the host (the ``sync`` span).

Request payloads: an ``int`` vertex id → ``(num_classes,)`` logits; a
``(u, v)`` pair → an edge score (dot of the endpoint logit vectors).
"""
from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.cache import CacheStore, LFUPolicy, budget_rows
from repro_torch.core import get_compiled_inference, plan_inference
from repro_torch.core.distributed import infer_trace_count
from repro_torch.device import resolve_device
from repro_torch.features import FeatureStore
from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace
from repro_torch.serve.embeddings import load_embeddings
from repro_torch.serve.loop import BatchingLoop, Ticket
from repro_torch.train.budget import ShapeBudget, next_bucket

EVAL_SAMPLE_SEED = 999     # the reference Trainer.evaluate's stateless seed


class GNNServer:
    """Queue-fed, micro-batched GNN prediction server.

    ``store`` is a bound :class:`repro_torch.features.FeatureStore`
    (resident or tiered/spilled — the read path is ``take_global``) or a
    classic ``(N, rows, d)`` sharded table plus ``owner``/``local_idx`` to
    wrap one from. ``params`` is the port's
    :class:`~repro_torch.models.gnn.models.GNN` and must lie on
    ``device`` (default ``cuda``; raises without a GPU unless
    ``device="cpu"``).
    """

    def __init__(self, *, graph, params, cfg, store,
                 owner: Optional[np.ndarray] = None,
                 local_idx: Optional[np.ndarray] = None,
                 budget: Optional[ShapeBudget] = None,
                 max_batch: int = 64, max_wait_s: float = 0.002,
                 sample_seed: int = EVAL_SAMPLE_SEED,
                 cache_budget_bytes: int = 0,
                 cache_refresh_every: int = 16,
                 cache_decay: float = 0.5,
                 ckpt_dir=None, mode: str = "auto",
                 params_step: int = 0, allow_stale_embeddings: bool = False,
                 device=None, name: str = "serve"):
        if mode not in ("auto", "fresh", "precomputed"):
            raise ValueError(f"unknown serve mode {mode!r}")
        want = resolve_device(device)
        self.device = next(params.parameters()).device
        if self.device.type != want.type \
                or want.index not in (None, self.device.index):
            raise ValueError(f"params lie on {self.device}, the server was "
                             f"asked to run on {want}")
        self.graph = graph
        self.params = params
        self.cfg = cfg
        if not isinstance(store, FeatureStore):
            arr = np.asarray(store)
            if arr.ndim == 2:          # dense (N, d) global table → 1 shard
                n = arr.shape[0]
                owner = np.zeros(n, np.int64) if owner is None else owner
                local_idx = (np.arange(n, dtype=np.int64)
                             if local_idx is None else local_idx)
                arr = arr[None]
            store = FeatureStore.from_array(arr, owner=owner,
                                            local_idx=local_idx)
        if store.owner is None or store.local_idx is None:
            raise ValueError("feature store must be bound "
                             "(owner/local_idx) — take_global is the "
                             "serving read path")
        self.store = store
        self.budget = budget if budget is not None else ShapeBudget()
        self.max_batch = int(max_batch)
        self.sample_seed = int(sample_seed)
        self.mode = mode
        self.name = name
        d = store.feature_dim

        # hot feature tier: single-view CacheStore pre-sized to its final
        # pow2 height, so enabling it never changes device shapes mid-serve
        self._cache_rows = budget_rows(cache_budget_bytes, d,
                                       store.dtype.itemsize)
        if self._cache_rows > 0:
            self.cache: Optional[CacheStore] = CacheStore(
                1, d, c_max=self._cache_rows, dtype=store.dtype,
                device=self.device)
            self.policy: Optional[LFUPolicy] = LFUPolicy(
                1, decay=cache_decay)
        else:
            self.cache = None
            self.policy = None
        self.cache_refresh_every = int(cache_refresh_every)
        self._cache_dev = None          # (c_max, d) slice, refreshed on install

        # precomputed tier (stamped; stale snapshots are refused)
        self.embeddings = None
        if ckpt_dir is not None:
            self.embeddings = load_embeddings(
                ckpt_dir, params_step=params_step,
                sample_seed=self.sample_seed,
                allow_stale=allow_stale_embeddings)
        if mode == "precomputed" and self.embeddings is None:
            raise ValueError("mode='precomputed' needs ckpt_dir with an "
                             "embedding snapshot")

        self._fn = get_compiled_inference(cfg)
        self._empty_cache = torch.from_numpy(
            np.zeros((0, d), store.dtype)).to(self.device)
        self.loop = BatchingLoop(self._dispatch, max_batch=max_batch,
                                 max_wait_s=max_wait_s, name=name)
        # stats
        self._dispatches = 0
        self.fresh_batches = 0
        self.fresh_requests = 0
        self.precomputed_hits = 0
        self.cache_hit_rows = 0
        self.fetch_rows = 0
        self._traces_at_warmup = infer_trace_count()

    # ------------------------------------------------------------------
    # Client surface
    # ------------------------------------------------------------------

    def submit(self, payload) -> Ticket:
        """Enqueue one request: ``int`` vertex → logits, ``(u, v)`` →
        edge score. Returns a :class:`Ticket` (``.wait()`` for the result).
        """
        return self.loop.submit(payload)

    def predict(self, nodes: Sequence[int], timeout: float = 120.0
                ) -> np.ndarray:
        """Synchronous convenience: serve ``nodes`` through the queue and
        micro-batcher (NOT one forced batch — packing is the batcher's)
        and return ``(len(nodes), num_classes)`` logits."""
        tickets = [self.submit(int(v)) for v in nodes]
        if self.loop._thread is None:
            deadline = time.perf_counter() + timeout
            while not all(t.done() for t in tickets):
                if time.perf_counter() > deadline:
                    raise TimeoutError("predict timed out")
                self.loop.pump(wait_s=0.0)
        return np.stack([t.wait(timeout) for t in tickets])

    def start(self) -> "GNNServer":
        self.loop.start()
        return self

    def stop(self, drain: bool = True) -> None:
        self.loop.stop(drain=drain)

    # ------------------------------------------------------------------
    # Warmup: run every rung once, seed fetch buckets with headroom
    # ------------------------------------------------------------------

    def warmup(self, nodes: Optional[np.ndarray] = None) -> dict:
        """Run every serve rung (pow2 ladder up to ``max_batch``) once by
        dispatching one representative micro-batch per rung. ``nodes``
        (default: a deterministic spread of the graph's vertices) should
        resemble live traffic — each rung's fetch bucket is seeded from its
        probe × ``r_max_headroom``, which is what absorbs batch-to-batch
        unique-row variance without retracing."""
        n = int(self.graph.num_vertices)
        if nodes is None:
            nodes = np.linspace(0, n - 1, min(n, self.max_batch * 4),
                                dtype=np.int64)
        nodes = np.unique(np.asarray(nodes, np.int64))
        rungs, bp = [], 0
        while bp < next_bucket(self.max_batch, self.budget.min_batch_pad):
            bp = next_bucket(bp + 1, self.budget.min_batch_pad)
            rungs.append(bp)
        before = infer_trace_count()
        with _trace.span(f"{self.name}.warmup", rungs=len(rungs)):
            for bp in rungs:
                take = nodes[np.linspace(0, nodes.size - 1,
                                         min(bp, nodes.size),
                                         dtype=np.int64)]
                self._forward(take, record_stats=False)
        self._traces_at_warmup = infer_trace_count()
        return {"rungs": rungs,
                "traces": self._traces_at_warmup - before,
                "ladder": self.budget.serve_rungs()}

    @property
    def retraces_since_warmup(self) -> int:
        """Serving-forward traces after :meth:`warmup` — the steady-state
        compile-once gate (must be 0)."""
        return infer_trace_count() - self._traces_at_warmup

    # ------------------------------------------------------------------
    # Dispatch (one drained micro-batch)
    # ------------------------------------------------------------------

    def _dispatch(self, tickets) -> list:
        vertices = []
        for t in tickets:
            if isinstance(t.payload, (int, np.integer)):
                vertices.append(int(t.payload))
            else:
                u, v = t.payload
                vertices.extend((int(u), int(v)))
        vertices = np.unique(np.asarray(vertices, np.int64))
        pre_mask = self._precomputed_mask(vertices)
        fresh = vertices[~pre_mask]
        pre = vertices[pre_mask]
        # request-frequency admission sees every root, whichever tier
        # answers it — that is what promotes a warming vertex from the
        # precomputed tier into the hot (fresh) set
        if self.policy is not None:
            self.policy.observe(0, vertices)
        logits = {}
        if pre.size:
            logits.update(zip(pre.tolist(), self.embeddings.lookup(pre)))
            self.precomputed_hits += int(pre.size)
            _metrics.inc(f"{self.name}.precomputed_hits", int(pre.size))
        if fresh.size:
            logits.update(zip(fresh.tolist(), self._forward(fresh)))
        self._dispatches += 1
        self._maybe_refresh_cache()
        pre_set = set(pre.tolist())
        out = []
        for t in tickets:
            if isinstance(t.payload, (int, np.integer)):
                t.via = ("precomputed" if int(t.payload) in pre_set
                         else "fresh")
                out.append(logits[int(t.payload)])
            else:
                u, v = t.payload
                t.via = "edge"
                out.append(float(np.dot(logits[int(u)], logits[int(v)])))
        return out

    def _precomputed_mask(self, vertices: np.ndarray) -> np.ndarray:
        """Which requested vertices the precomputed tier answers."""
        if self.embeddings is None or self.mode == "fresh":
            return np.zeros(vertices.size, bool)
        if self.mode == "precomputed":
            return np.ones(vertices.size, bool)
        # auto: hot vertices (feature row admitted to the serve cache) go
        # fresh — current params at cached-feature cost; cold go precomputed
        if self.cache is None:
            return np.ones(vertices.size, bool)
        hot, _ = self.cache.index.hit_split(0, vertices)
        return ~hot

    def _forward(self, nodes: np.ndarray, record_stats: bool = True
                 ) -> np.ndarray:
        """Fresh compute for a deduped vertex set: plan → gather → device.
        Returns ``(len(nodes), num_classes)`` float32 logits."""
        d = self.store.feature_dim
        with _trace.span(f"{self.name}.batch.build", n=int(nodes.size)):
            bp = self.budget.serve_batch_pad(int(nodes.size))
            cache_index = self.cache.index if self.cache is not None else None
            plan = plan_inference(self.graph, nodes, self.cfg.num_layers,
                                  self.cfg.fanout,
                                  sample_seed=self.sample_seed,
                                  batch_pad=bp, cache_index=cache_index)
            u = int(plan.fetch_ids.size)
            u_max = self.budget.serve_fetch_pad(bp, u)
            fetch = np.zeros((u_max, d), self.store.dtype)
            if u:
                fetch[:u] = self.store.take_global(plan.fetch_ids)
            if self.policy is not None:
                self.policy.observe(0, plan.touched, plan.touched_counts)
        with _trace.span(f"{self.name}.dispatch", batch_pad=bp, u_max=u_max,
                         c_max=plan.c_max):
            if self.cache is not None and plan.c_max:
                if plan.cache_version != self.cache.version:
                    raise RuntimeError(
                        f"stale serve plan: built against cache version "
                        f"{plan.cache_version}, store is at "
                        f"{self.cache.version}")
                cache_tab = self._cache_device()
            else:
                cache_tab = self._empty_cache
            dev = self._fn(self.params, cache_tab, fetch, *plan.hop_idx)
        with _trace.span(f"{self.name}.sync"):
            logits = dev[:nodes.size].cpu().numpy()
        if record_stats:
            self.fresh_batches += 1
            self.fresh_requests += int(nodes.size)
            self.cache_hit_rows += plan.cache_hit_rows
            self.fetch_rows += u
            _metrics.inc(f"{self.name}.cache_hit_rows", plan.cache_hit_rows)
            _metrics.inc(f"{self.name}.fetch_rows", u)
        return logits

    # ------------------------------------------------------------------
    # Hot-tier admission (request-frequency LFU → CacheStore install)
    # ------------------------------------------------------------------

    def _cache_device(self):
        if self._cache_dev is None:
            self._cache_dev = self.cache.device_table[0]
        return self._cache_dev

    def _maybe_refresh_cache(self) -> None:
        if self.cache is None:
            return
        # cadence counts *all* dispatches, not just fresh ones — a cold
        # (all-precomputed) workload must still admit its frequent roots,
        # or auto mode could never promote anything to the fresh tier
        if self._dispatches == 0 \
                or self._dispatches % self.cache_refresh_every:
            return
        sel = self.policy.select(0, self._cache_rows)
        if np.array_equal(sel, self.cache.index.ids[0]):
            return
        # install between micro-batches on the loop thread: plans and
        # installs are serialized, so no in-flight plan can go stale
        self.cache.install_from(self.store, [sel])
        self._cache_dev = None

    # ------------------------------------------------------------------

    def stats(self) -> dict:
        out = dict(self.loop.stats())
        out.update(fresh_batches=self.fresh_batches,
                   fresh_requests=self.fresh_requests,
                   precomputed_hits=self.precomputed_hits,
                   cache_hit_rows=self.cache_hit_rows,
                   fetch_rows=self.fetch_rows,
                   cache_installs=(self.cache.installs
                                   if self.cache is not None else 0),
                   cached_rows=(self.cache.rows_installed()
                                if self.cache is not None else 0),
                   retraces_since_warmup=self.retraces_since_warmup,
                   serve_rungs=self.budget.serve_rungs())
        return out
