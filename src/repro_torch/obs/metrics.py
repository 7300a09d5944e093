"""Unified metrics registry: named counters, gauges, histograms.

One process-wide :class:`MetricsRegistry` (module helpers ``inc`` /
``set_gauge`` / ``observe`` write to it) is the single surface all the
repo's scattered counter objects flow through: ``TierStats`` row/byte
and crc counters (repro_torch.features), ``CommCounters`` retries/timeouts
(repro_torch.resilience), engine retraces, fault firings, checkpoint traffic,
and the per-epoch ``EpochStats`` published by the Trainer. The legacy
dataclasses stay — they are cheap, lock-scoped views used by tests and
the merging controller — but every mutation site now *also* lands in
the registry, so one ``snapshot()``/``delta()`` answers "what happened"
without digging through sub-objects.

Naming scheme: dotted ``subsystem.metric`` —

- ``features.*``   tier rows/bytes, crc checks/failures/repairs
- ``cache.*``      installs, rows, device uploads
- ``comm.*``       resilient_call retries/timeouts
- ``engine.*``     jit traces (retraces after epoch 0 are defects)
- ``faults.*``     injected-fault firings, per kind
- ``ckpt.*``       checkpoint saves/loads
- ``epoch.*``      EpochStats published once per epoch

Counters are monotonic (deltas are meaningful); gauges are last-write
instantaneous values; histograms keep count/total/min/max (enough for
mean + envelope without per-sample storage).
"""
from __future__ import annotations

import threading
from typing import Optional

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "registry", "inc", "set_gauge", "observe",
           "publish_epoch_stats"]


class Counter:
    __slots__ = ("name", "_v", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._v = 0
        self._lock = threading.Lock()

    def add(self, n: int = 1) -> None:
        with self._lock:
            self._v += n

    @property
    def value(self) -> int:
        return self._v


class Gauge:
    __slots__ = ("name", "_v", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._v = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._v = float(v)

    @property
    def value(self) -> float:
        return self._v


class Histogram:
    __slots__ = ("name", "count", "total", "vmin", "vmax", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.total = 0.0
        self.vmin = float("inf")
        self.vmax = float("-inf")
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.total += v
            if v < self.vmin:
                self.vmin = v
            if v > self.vmax:
                self.vmax = v

    def summary(self) -> dict:
        with self._lock:
            if self.count == 0:
                return {"count": 0, "total": 0.0, "mean": 0.0,
                        "min": 0.0, "max": 0.0}
            return {"count": self.count, "total": self.total,
                    "mean": self.total / self.count,
                    "min": self.vmin, "max": self.vmax}


class MetricsRegistry:
    """Create-on-first-use registry with one snapshot/delta API."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._hists: dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(name, Counter(name))
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(name, Gauge(name))
        return g

    def histogram(self, name: str) -> Histogram:
        h = self._hists.get(name)
        if h is None:
            with self._lock:
                h = self._hists.setdefault(name, Histogram(name))
        return h

    def snapshot(self) -> dict:
        """Point-in-time copy: ``{"counters": {...}, "gauges": {...},
        "histograms": {name: {count,total,mean,min,max}}}``."""
        with self._lock:
            cs = list(self._counters.values())
            gs = list(self._gauges.values())
            hs = list(self._hists.values())
        return {"counters": {c.name: c.value for c in cs},
                "gauges": {g.name: g.value for g in gs},
                "histograms": {h.name: h.summary() for h in hs}}

    def delta(self, prev: dict) -> dict:
        """Change since a prior :meth:`snapshot`. Counters subtract
        (names absent from ``prev`` count from 0), gauges report their
        current value, histograms subtract count/total."""
        now = self.snapshot()
        pc = prev.get("counters", {})
        ph = prev.get("histograms", {})
        return {
            "counters": {k: v - pc.get(k, 0)
                         for k, v in now["counters"].items()},
            "gauges": dict(now["gauges"]),
            "histograms": {
                k: {"count": s["count"] - ph.get(k, {}).get("count", 0),
                    "total": s["total"] - ph.get(k, {}).get("total", 0.0)}
                for k, s in now["histograms"].items()},
        }

    def reset(self) -> None:
        """Drop every instrument (tests / fresh runs)."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()


_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    return _REGISTRY


def inc(name: str, n: int = 1) -> None:
    _REGISTRY.counter(name).add(n)


def set_gauge(name: str, v: float) -> None:
    _REGISTRY.gauge(name).set(v)


def observe(name: str, v: float) -> None:
    _REGISTRY.histogram(name).observe(v)


# EpochStats fields that are instantaneous (gauges). Remaining int
# fields are additive across epochs (counters); remaining float fields
# are per-epoch times fed into histograms (count/total/min/max keeps
# both the sum and the envelope).
_EPOCH_GAUGES = frozenset({
    "epoch", "loss", "acc", "cache_hit_rate", "num_steps",
})
_EPOCH_SKIP = frozenset({"degradations"})


def publish_epoch_stats(st, prefix: str = "epoch") -> None:
    """Route one finished epoch's ``EpochStats`` into the registry as
    ``epoch.<field>`` instruments: gauges for instantaneous values
    (loss, hit rate, ...), counters for additive ints (rows, retries,
    rollbacks, ...), histograms for per-epoch times (time_s,
    steady_time_s, plan_time_s, ...)."""
    import dataclasses
    for f in dataclasses.fields(st):
        if f.name in _EPOCH_SKIP:
            continue
        v = getattr(st, f.name)
        if v is None or isinstance(v, (tuple, list, str)):
            continue
        name = f"{prefix}.{f.name}"
        if f.name in _EPOCH_GAUGES:
            set_gauge(name, float(v))
        elif isinstance(v, float):
            observe(name, v)
        else:
            inc(name, int(v))
    degr = getattr(st, "degradations", ()) or ()
    if degr:
        inc(f"{prefix}.degradations", len(degr))
