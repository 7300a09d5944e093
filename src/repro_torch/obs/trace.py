"""Span tracing: a thread-safe, preallocated ring-buffer recorder.

Design constraints (this module sits on the training hot path):

- **Near-zero cost when disabled.** ``span()``/``event()`` check one
  module-level bool and return a shared no-op context manager — no
  allocation, no clock read, no lock.
- **Lock-free when enabled.** Each thread records into its own
  preallocated ring (``threading.local``); the hot path is two
  ``perf_counter_ns`` reads and one list-slot store per span. The global
  lock is touched only on first use per thread and at drain time.
- **Nesting-safe.** A per-thread depth counter stamps every span with
  its nesting level, so the exporter can rebuild the flame even though
  spans are recorded at *exit* (children land before parents).
- **Read-only w.r.t. training state.** Tracing reads clocks and writes
  host-side tuples; it never touches params, plans, rngs, or device
  buffers — tracing on is bit-identical to tracing off by construction.

Timeline semantics in the non-blocking pipelined loop: a ``dispatch``
span measures *host-side enqueue* (near-zero in steady state), not
device execution. Device time shows up in the synced windows the loop
already has — the ``loss.sync`` / ``trace.sync`` spans wrapping
``block_until_ready`` — so device cost per window is read off the sync
spans, exactly like the engine's steady-state timing contract.

Track ids are thread names by default; a ``track=`` override lets work
that borrows another thread record on its logical track (the uploader
commit runs on the prefetch thread but belongs on the "uploader"
track). Export to Perfetto via :mod:`repro_torch.obs.export`.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Optional

__all__ = ["enable", "disable", "is_enabled", "clear", "span", "event",
           "records", "dropped", "epoch_ns", "SpanRecord"]

_DEFAULT_CAPACITY = 1 << 14          # records per thread track

_lock = threading.Lock()
_enabled = False
_capacity = _DEFAULT_CAPACITY
_generation = 0                      # bumped by enable()/clear(): stale
#                                      thread-local rings are abandoned
_epoch_ns = 0                        # perf_counter_ns at enable/clear
_tracks: list = []                   # live _Track registry (drain order)
_tls = threading.local()


class _Track:
    """Per-thread preallocated ring. Only its owner thread writes; the
    GIL makes the slot store + counter bump safe to read concurrently
    (a drain may miss the very latest record, never see a torn one)."""

    __slots__ = ("thread", "gen", "buf", "n", "depth")

    def __init__(self, thread: str, gen: int, capacity: int):
        self.thread = thread
        self.gen = gen
        self.buf: list = [None] * capacity
        self.n = 0                   # total records ever pushed
        self.depth = 0               # current span nesting level

    def push(self, rec) -> None:
        self.buf[self.n % len(self.buf)] = rec
        self.n += 1


def _get_track() -> _Track:
    tr = getattr(_tls, "track", None)
    if tr is None or tr.gen != _generation:
        tr = _Track(threading.current_thread().name, _generation, _capacity)
        _tls.track = tr
        with _lock:
            if tr.gen == _generation:    # lost race with clear(): drop
                _tracks.append(tr)
    return tr


@dataclass(frozen=True)
class SpanRecord:
    """One drained record. ``kind`` is ``"X"`` (complete span) or
    ``"i"`` (instant event); times are perf_counter_ns."""
    kind: str
    name: str
    track: str
    t0_ns: int
    t1_ns: int
    depth: int
    tags: Optional[dict]

    @property
    def dur_ns(self) -> int:
        return self.t1_ns - self.t0_ns


class _Noop:
    """Shared do-nothing context manager returned while disabled."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class _Span:
    __slots__ = ("name", "track", "tags", "_t0", "_tr")

    def __init__(self, name: str, track: Optional[str], tags):
        self.name = name
        self.track = track
        self.tags = tags or None

    def __enter__(self):
        tr = _get_track()
        self._tr = tr
        tr.depth += 1
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        tr = self._tr
        tr.depth -= 1
        tr.push(("X", self.name, self.track or tr.thread,
                 self._t0, t1, tr.depth, self.tags))
        return False


def span(name: str, track: Optional[str] = None, **tags):
    """Context manager timing a named region on the calling thread's
    track (or the ``track=`` override). ``**tags`` become Perfetto args.
    When tracing is disabled this is one bool check and a shared no-op
    object — safe to leave on the hottest paths."""
    if not _enabled:
        return _NOOP
    return _Span(name, track, tags)


def event(name: str, track: Optional[str] = None, **tags) -> None:
    """Record an instant mark (fault firing, retry, retrace, ...)."""
    if not _enabled:
        return
    tr = _get_track()
    t = time.perf_counter_ns()
    tr.push(("i", name, track or tr.thread, t, t, tr.depth, tags or None))


def enable(capacity: int = _DEFAULT_CAPACITY) -> None:
    """Start recording (drops anything previously recorded).
    ``capacity`` is the per-thread ring size; overflow overwrites the
    oldest records and is reported by :func:`dropped`."""
    global _enabled, _capacity, _generation, _epoch_ns
    with _lock:
        _capacity = int(capacity)
        _generation += 1
        _tracks.clear()
        _epoch_ns = time.perf_counter_ns()
        _enabled = True


def disable() -> None:
    """Stop recording; already-recorded spans stay drainable."""
    global _enabled
    _enabled = False


def is_enabled() -> bool:
    return _enabled


def clear() -> None:
    """Drop all recorded spans (keeps the enabled/disabled state)."""
    global _generation, _epoch_ns
    with _lock:
        _generation += 1
        _tracks.clear()
        _epoch_ns = time.perf_counter_ns()


def epoch_ns() -> int:
    """perf_counter_ns origin of the current recording session."""
    return _epoch_ns


def records() -> list[SpanRecord]:
    """Drain a consistent-enough snapshot of every track, oldest first
    globally (sorted by start time). Non-destructive."""
    with _lock:
        tracks = list(_tracks)
    out: list[SpanRecord] = []
    for tr in tracks:
        n, cap = tr.n, len(tr.buf)
        for i in range(max(0, n - cap), n):
            rec = tr.buf[i % cap]
            if rec is not None:
                out.append(SpanRecord(*rec))
    out.sort(key=lambda r: (r.t0_ns, -r.depth))
    return out


def dropped() -> int:
    """Total records overwritten by ring wraparound since enable()."""
    with _lock:
        tracks = list(_tracks)
    return sum(max(0, tr.n - len(tr.buf)) for tr in tracks)
