"""Shape budgets: quantized device shapes for a compile-once hot path.

The planner (repro_torch.core.strategies) emits rectangular arrays sized to the
*exact* needs of one iteration — ``batch_pad`` to the largest root group,
``r_max`` to the largest per-peer fetch. Exact sizes differ between
iterations, so every plan used to carry fresh device shapes and the jitted
iteration retraced on nearly every step; epoch wall-times then measured XLA
compilation rather than execution (the bug the merging controller's timing
signal inherited).

A :class:`ShapeBudget` fixes ``batch_pad``/``r_max`` per run instead: sizes
are quantized to power-of-two buckets learned from the first plan, every
subsequent plan is forced into the same bucket (padding roots are local and
zero-weighted; padded request slots fetch row 0 and are never read, so
numerics are unchanged — see the budgeted-gradient-parity test), and an
overflow re-buckets explicitly to the next power of two. One bucket ⇒ one
jit trace; re-buckets are counted and visible.

Buckets are kept **per merge pattern** (keyed by the plan's ``num_steps``):
merging folds the same roots into fewer, larger (shard, step) groups, so a
pattern change legitimately needs a larger ``batch_pad`` — but growing one
global bucket would retrace *every* pattern and, worse, reverting the merge
would keep the oversized shapes forever. With per-pattern buckets a §5.3
examination walk (T → T-1 → revert to T) reuses the T bucket untouched:
pattern changes never force a global re-bucket.

``c_max`` — the height of the cached workspace region a plan was built
against (repro_torch.cache) — is a third budgeted dimension, but a *global* one:
the cache store is shared across merge patterns, so its shape is too. The
planner raises ``PlanOverflow("c_max", ...)`` when a cache index outgrows
the budget (a store re-pad after cache-size drift) and :meth:`grow`
re-buckets it explicitly, exactly like the other two dimensions.
"""
from __future__ import annotations

import dataclasses


def next_bucket(n: int, minimum: int = 1) -> int:
    """Smallest power of two ≥ max(n, minimum, 1)."""
    n = max(int(n), int(minimum), 1)
    return 1 << (n - 1).bit_length()


@dataclasses.dataclass
class ShapeBudget:
    """Per-run quantized sizes for the planner's rectangular arrays.

    ``batch_pad``/``r_max`` given to the constructor seed every new
    pattern's bucket (both nonzero: used as-is, no probe; one nonzero: a
    floor merged with the probe). After each :meth:`plan` call they mirror
    the *active* pattern's bucket, so existing callers keep reading the
    shapes the last plan was built with. ``buckets`` maps
    ``num_steps -> [batch_pad, r_max]`` and is the source of truth.
    """

    batch_pad: int = 0
    r_max: int = 0
    c_max: int = 0            # cached-region height (global, not per-pattern)
    l_max: int = 0            # streamed compacted-local height (per-pattern;
    #                           repro_torch.features — 0 when not streaming)
    min_batch_pad: int = 8
    min_r_max: int = 8
    min_l_max: int = 8
    max_rebuckets: int = 8
    # Probe headroom for r_max: the probe only sees one iteration's exact
    # per-peer fetch counts, and those vary batch-to-batch (sampling is
    # data-dependent), so bucketing the bare probe routinely overflows a
    # few iterations later — one PlanOverflow re-bucket, one full XLA
    # recompile mid-training (measured ~100× an iteration). Bucketing
    # probe × headroom instead absorbs ordinary variance; padded request
    # slots fetch row 0 and are never read, so the cost is exchange-buffer
    # bytes, not numerics. batch_pad gets no headroom: padded roots carry
    # real (weight-0) tree compute, and overflow there is assignment-skew
    # driven, which the per-pattern buckets already isolate.
    r_max_headroom: float = 1.5
    # l_max headroom (streamed mode): the touched-local set varies batch to
    # batch like per-peer fetches do, but less violently (it is bounded by
    # the whole tree, most of which IS local) — a lighter pad suffices.
    l_max_headroom: float = 1.25
    # --- counters (observability; the compile-once tests read these) ---
    rebuckets: int = 0
    plans_built: int = 0
    probes: int = 0
    buckets: dict = dataclasses.field(default_factory=dict)
    # num_steps -> l_max bucket, kept SEPARATE from ``buckets`` so existing
    # readers of the [batch_pad, r_max] pairs never see a layout change
    l_buckets: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        # constructor-given sizes become the seed for every new bucket
        self._seed = (int(self.batch_pad), int(self.r_max))
        self._active_key = None

    def signature(self) -> tuple[int, int]:
        return (self.batch_pad, self.r_max)

    def bucket_shapes(self, num_steps) -> "tuple[int, int, int, int] | None":
        """(batch_pad, r_max, c_max, l_max) of the bucket serving this merge
        pattern, or None if the pattern hasn't been planned yet. The
        pipeline uploader's ping-pong stability check reads this: every
        committed plan of a pattern must carry exactly these shapes, or
        an upload would imply a retrace. ``l_max`` is 0 for patterns that
        have never planned streamed."""
        b = self.buckets.get(int(num_steps))
        return None if b is None else (int(b[0]), int(b[1]), int(self.c_max),
                                       int(self.l_buckets.get(int(num_steps),
                                                              0)))

    def grow(self, field: str, needed: int) -> None:
        """Explicit overflow re-bucketing: jump to the next power-of-two
        bucket that fits ``needed`` (strictly larger than the current one).
        Only the active pattern's bucket grows — others keep their shapes
        (and their compiled programs)."""
        self.rebuckets += 1
        if field == "batch_pad":
            self.batch_pad = next_bucket(needed, self.batch_pad + 1)
        elif field == "r_max":
            self.r_max = next_bucket(needed, self.r_max + 1)
        elif field == "c_max":
            # global (cross-pattern) dimension — see module doc
            self.c_max = next_bucket(needed, self.c_max + 1)
            return
        elif field == "l_max":
            # per-pattern like batch_pad/r_max, but stored in l_buckets
            self.l_max = next_bucket(needed, self.l_max + 1)
            if self._active_key is not None:
                self.l_buckets[self._active_key] = self.l_max
            return
        else:
            raise ValueError(f"unknown budget field {field!r}")
        if self._active_key is not None:
            self.buckets[self._active_key] = [self.batch_pad, self.r_max]

    @staticmethod
    def _pattern_key(plan_kwargs: dict):
        """The plan's merge pattern (num_steps), derived without planning:
        an explicit assignment carries it; otherwise hopgnn's rotation has
        one step per model and the one-step strategies have 1."""
        assignment = plan_kwargs.get("assignment")
        if assignment is not None:
            return int(assignment.num_steps)
        roots = plan_kwargs.get("roots_per_model")
        if plan_kwargs.get("strategy", "hopgnn") == "hopgnn" \
                and roots is not None:
            return len(roots)
        return 1 if roots is not None else "default"

    def plan(self, planner=None, **plan_kwargs):
        """Build an IterationPlan under this budget (bucketed shapes).

        ``planner`` defaults to :func:`repro_torch.core.plan_iteration`;
        any callable with the same keyword contract (and raising
        :class:`repro_torch.core.PlanOverflow` on overflow) works.
        """
        from repro_torch.core.pregather import PlanOverflow
        if planner is None:
            from repro_torch.core.strategies import plan_iteration as planner
        key = self._pattern_key(plan_kwargs)
        fs = plan_kwargs.get("feature_store")
        streamed = fs is not None and not getattr(fs, "resident", True)
        bucket = self.buckets.get(key)
        need_l = streamed and key not in self.l_buckets
        probe = None

        def _probe():
            # First plan of this pattern: probe exact sizes once, then
            # bucket. The probe is host-side numpy only — it never touches
            # the device engine, so it costs one extra planning pass per
            # *pattern* and nothing after. (In streamed mode the probe does
            # pay a host feature gather; still once per pattern.)
            self.probes += 1
            return planner(**plan_kwargs)

        if bucket is None:
            seed_bp, seed_rm = self._seed
            if seed_bp and seed_rm and not need_l:
                bucket = [seed_bp, seed_rm]
            else:
                probe = _probe()
                bucket = [next_bucket(probe.batch_pad,
                                      max(self.min_batch_pad, seed_bp)),
                          next_bucket(int(probe.r_max
                                          * max(self.r_max_headroom, 1.0)),
                                      max(self.min_r_max, seed_rm))]
            self.buckets[key] = bucket
        if need_l:
            if probe is None:
                probe = _probe()
            self.l_buckets[key] = next_bucket(
                int(probe.l_max * max(self.l_max_headroom, 1.0)),
                self.min_l_max)
        self._active_key = key
        self.batch_pad, self.r_max = bucket
        # c_max ceiling only applies to cache-aware plans; passing 0/None
        # lets the first such plan teach the budget its height.
        cache_kw = {}
        if plan_kwargs.get("cache_index") is not None:
            cache_kw = dict(c_max=self.c_max or None)
        stream_kw = {}
        if streamed:
            self.l_max = self.l_buckets[key]
            stream_kw = dict(l_max=self.l_max)
        for _ in range(self.max_rebuckets + 1):
            try:
                out = planner(**plan_kwargs, batch_pad=self.batch_pad,
                              r_max=self.r_max, **cache_kw, **stream_kw)
                self.plans_built += 1
                if getattr(out, "c_max", 0) > self.c_max:
                    self.c_max = int(out.c_max)    # first learn, no rebucket
                return out
            except PlanOverflow as e:
                self.grow(e.field, e.needed)
                if e.field == "c_max":
                    cache_kw = dict(c_max=self.c_max)
                elif e.field == "l_max":
                    stream_kw = dict(l_max=self.l_max)
        raise RuntimeError(
            f"shape budget failed to converge after {self.max_rebuckets} "
            f"re-buckets (batch_pad={self.batch_pad}, r_max={self.r_max})")

    # ------------------------------------------------------------------
    # Serving buckets (repro_torch.serve): the same compile-once discipline for
    # online inference micro-batches. Serving has two quantized dimensions:
    # the padded root count (a pow2 ladder up to the server's max batch,
    # keyed "serve:<batch_pad>" in ``buckets``) and the padded host-fetch
    # height u_max of that rung (stored as the rung's second slot, grown
    # with r_max_headroom exactly like training fetches). Keys are strings,
    # so serve rungs ride state_dict()/load_state() untouched — a server
    # restored from a training checkpoint's budget state plans straight
    # into the warmed shapes and never retraces.
    # ------------------------------------------------------------------

    def serve_batch_pad(self, batch: int) -> int:
        """Quantized root count for a serving micro-batch of ``batch``
        requests: the pow2 rung ≥ max(batch, min_batch_pad). A new rung
        starts with no fetch bucket (``serve_fetch_pad`` learns it)."""
        bp = next_bucket(batch, self.min_batch_pad)
        key = f"serve:{bp}"
        if key not in self.buckets:
            self.buckets[key] = [bp, 0]
            self.probes += 1
        return bp

    def serve_fetch_pad(self, batch_pad: int, fetch_rows: int) -> int:
        """Padded host-fetch height (u_max) for rung ``batch_pad``.

        First call on a rung buckets ``fetch_rows × r_max_headroom`` (the
        warmup probe); later calls reuse the bucket, re-bucketing (counted
        in ``rebuckets`` — one retrace downstream) only on overflow."""
        key = f"serve:{int(batch_pad)}"
        b = self.buckets.setdefault(key, [int(batch_pad), 0])
        if b[1] == 0:
            b[1] = next_bucket(int(fetch_rows * max(self.r_max_headroom, 1.0)),
                               self.min_r_max)
        elif fetch_rows > b[1]:
            self.rebuckets += 1
            b[1] = next_bucket(fetch_rows, b[1] + 1)
        return int(b[1])

    def serve_rungs(self) -> list:
        """The learned serve ladder: sorted [(batch_pad, u_max), ...]."""
        out = [(int(v[0]), int(v[1])) for k, v in self.buckets.items()
               if isinstance(k, str) and k.startswith("serve:")]
        return sorted(out)

    # ------------------------------------------------------------------
    # Persistence (repro_torch.checkpoint): a resumed run must reuse the exact
    # buckets of the original run, or its first epoch re-probes/re-traces.
    # ------------------------------------------------------------------

    def state_dict(self) -> dict:
        """JSON-serializable bucket state. Buckets are stored as
        ``[key, ...]`` rows (not an object) so integer pattern keys survive
        the JSON round-trip with their type intact."""
        return {
            "buckets": [[k, int(v[0]), int(v[1])]
                        for k, v in self.buckets.items()],
            "l_buckets": [[k, int(v)] for k, v in self.l_buckets.items()],
            "c_max": int(self.c_max),
            "batch_pad": int(self.batch_pad),
            "r_max": int(self.r_max),
            "l_max": int(self.l_max),
            "r_max_headroom": float(self.r_max_headroom),
            "l_max_headroom": float(self.l_max_headroom),
            "rebuckets": int(self.rebuckets),
        }

    def load_state(self, state: dict) -> None:
        """Restore :meth:`state_dict` output: every pattern the original
        run learned plans straight into its old bucket — no probe, no
        overflow, and (process-wide compile cache permitting) no retrace
        on the resumed run's first epoch."""
        def _k(k):
            return k if isinstance(k, str) else int(k)
        self.buckets = {_k(k): [int(bp), int(rm)]
                        for k, bp, rm in state.get("buckets", [])}
        self.l_buckets = {_k(k): int(l)
                          for k, l in state.get("l_buckets", [])}
        self.c_max = int(state.get("c_max", self.c_max))
        self.batch_pad = int(state.get("batch_pad", self.batch_pad))
        self.r_max = int(state.get("r_max", self.r_max))
        self.l_max = int(state.get("l_max", self.l_max))
        self.r_max_headroom = float(state.get("r_max_headroom",
                                              self.r_max_headroom))
        self.l_max_headroom = float(state.get("l_max_headroom",
                                              self.l_max_headroom))
        self.rebuckets = int(state.get("rebuckets", self.rebuckets))
        self._active_key = None
