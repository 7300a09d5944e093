"""One batched-serving loop for every stack (repro_torch.serve tentpole, part a).

Online inference is queue-shaped everywhere: requests arrive one at a
time, latency is measured per request, but the device wants micro-batches.
:class:`BatchingLoop` owns exactly that translation — a thread-safe FIFO
:class:`RequestQueue`, a dynamic micro-batcher that drains up to
``max_batch`` pending tickets (waiting at most ``max_wait_s`` for the
first), and per-request latency accounting — and delegates the model to a
``dispatch(tickets) -> results`` callable. The GNN server
(repro_torch.serve.server) is a thin dispatch function over this one loop,
which keeps its latency semantics and observability identical to the JAX
package's server.

Observability (repro_torch.obs): the idle wait for work is a ``<name>.queue.wait``
span, each dispatch a ``<name>.batch`` span; the registry carries
``<name>.queue_depth`` / ``<name>.qps`` gauges, a ``<name>.latency_ms``
histogram (submit → result, the user-visible number), a
``<name>.queue_wait_ms`` histogram (submit → drain), and
``<name>.requests`` / ``<name>.batches`` / ``<name>.errors`` counters.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Callable, Optional, Sequence

from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace


class ServeShutdown(RuntimeError):
    """The serving loop stopped before this ticket was dispatched.

    Raised from ``ticket.wait()`` for every request still queued when
    :meth:`BatchingLoop.stop` gave up draining — an explicit answer
    instead of a silently-forever-pending ticket."""


class Ticket:
    """One pending request: payload in, result (or error) out."""

    __slots__ = ("payload", "t_submit", "t_drain", "t_done", "result",
                 "error", "via", "_done")

    def __init__(self, payload):
        self.payload = payload
        self.t_submit = time.perf_counter()
        self.t_drain = 0.0
        self.t_done = 0.0
        self.result = None
        self.error: Optional[BaseException] = None
        self.via = ""                  # serving tier that answered (server-set)
        self._done = threading.Event()

    def done(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout: Optional[float] = None):
        """Block until served; returns the result or raises the dispatch
        error. TimeoutError if the deadline passes first."""
        if not self._done.wait(timeout):
            raise TimeoutError(f"request not served within {timeout}s")
        if self.error is not None:
            raise self.error
        return self.result

    def latency_s(self) -> float:
        return self.t_done - self.t_submit

    def _finish(self, result=None, error: Optional[BaseException] = None):
        self.result = result
        self.error = error
        self.t_done = time.perf_counter()
        self._done.set()


class RequestQueue:
    """Thread-safe FIFO of tickets with a batching drain."""

    def __init__(self):
        self._q: collections.deque = collections.deque()
        self._lock = threading.Lock()
        self._nonempty = threading.Condition(self._lock)

    def put(self, payload) -> Ticket:
        t = payload if isinstance(payload, Ticket) else Ticket(payload)
        with self._nonempty:
            self._q.append(t)
            self._nonempty.notify()
        return t

    def depth(self) -> int:
        return len(self._q)

    def drain(self, max_n: int, wait_s: float = 0.0) -> list:
        """Up to ``max_n`` tickets, FIFO. Blocks at most ``wait_s`` for the
        *first* ticket; once any are pending, takes what is there without
        further waiting — the dynamic-batching tradeoff (a bounded wait
        buys a fuller batch; an empty queue never stalls a ready one)."""
        with self._nonempty:
            if not self._q and wait_s > 0:
                self._nonempty.wait_for(lambda: bool(self._q), wait_s)
            out = []
            while self._q and len(out) < max_n:
                out.append(self._q.popleft())
        now = time.perf_counter()
        for t in out:
            t.t_drain = now
        return out


class BatchingLoop:
    """Dynamic micro-batcher around a model-specific ``dispatch``.

    ``dispatch(tickets)`` serves one drained micro-batch and returns the
    results aligned with ``tickets`` (it may also set ``ticket.via``).
    Drive the loop synchronously with :meth:`pump` (tests, benchmarks,
    offline drains) or in a background thread with :meth:`start`/
    :meth:`stop` (open-loop load). A dispatch exception fails that batch's
    tickets (each ``wait()`` re-raises it) and is counted, not swallowed.
    """

    def __init__(self, dispatch: Callable[[Sequence[Ticket]], Sequence],
                 *, max_batch: int = 64, max_wait_s: float = 0.002,
                 name: str = "serve", qps_window_s: float = 2.0,
                 drain_deadline_s: float = 30.0):
        self.dispatch = dispatch
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_s)
        self.drain_deadline_s = float(drain_deadline_s)
        self.name = name
        self.queue = RequestQueue()
        self.served = 0
        self.batches = 0
        self.errors = 0
        self._qps_window_s = float(qps_window_s)
        self._done_ts: collections.deque = collections.deque()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # ------------------------------------------------------------------

    def submit(self, payload) -> Ticket:
        t = self.queue.put(payload)
        _metrics.set_gauge(f"{self.name}.queue_depth", self.queue.depth())
        return t

    def pump(self, wait_s: Optional[float] = None) -> int:
        """Serve one micro-batch; returns how many tickets it answered
        (0 if the queue stayed empty through the wait)."""
        with _trace.span(f"{self.name}.queue.wait",
                         depth=self.queue.depth()):
            tickets = self.queue.drain(
                self.max_batch,
                self.max_wait_s if wait_s is None else wait_s)
        _metrics.set_gauge(f"{self.name}.queue_depth", self.queue.depth())
        if not tickets:
            return 0
        try:
            with _trace.span(f"{self.name}.batch", n=len(tickets)):
                results = self.dispatch(tickets)
        except BaseException as e:                       # noqa: BLE001
            self.errors += 1
            _metrics.inc(f"{self.name}.errors")
            for t in tickets:
                t._finish(error=e)
            raise
        for t, r in zip(tickets, results):
            t._finish(result=r)
        self._account(tickets)
        return len(tickets)

    def _account(self, tickets) -> None:
        self.batches += 1
        self.served += len(tickets)
        _metrics.inc(f"{self.name}.requests", len(tickets))
        _metrics.inc(f"{self.name}.batches")
        now = time.perf_counter()
        for t in tickets:
            _metrics.observe(f"{self.name}.latency_ms",
                             1e3 * t.latency_s())
            _metrics.observe(f"{self.name}.queue_wait_ms",
                             1e3 * (t.t_drain - t.t_submit))
            self._done_ts.append(now)
        horizon = now - self._qps_window_s
        while self._done_ts and self._done_ts[0] < horizon:
            self._done_ts.popleft()
        span = now - self._done_ts[0] if len(self._done_ts) > 1 else 0.0
        qps = len(self._done_ts) / span if span > 0 else 0.0
        _metrics.set_gauge(f"{self.name}.qps", qps)

    # ------------------------------------------------------------------
    # Background serving (open-loop clients)
    # ------------------------------------------------------------------

    def start(self) -> "BatchingLoop":
        if self._thread is not None:
            raise RuntimeError("loop already started")
        self._stop.clear()

        def run():
            # the drain's condition variable wakes on submit, so a longer
            # idle wait costs no latency — it only bounds the empty-queue
            # spin rate
            while not self._stop.is_set():
                try:
                    self.pump(wait_s=0.05)
                except BaseException:                    # noqa: BLE001
                    # the batch's tickets already carry the error; the
                    # loop keeps serving later requests
                    continue

        self._thread = threading.Thread(target=run,
                                        name=f"{self.name}-loop",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self, drain: bool = True) -> None:
        """Stop the background loop.

        With ``drain`` (default) waits up to ``drain_deadline_s`` (ctor
        parameter) for the queue to empty first. Any ticket still queued
        after the loop stops — drain disabled, deadline missed, or
        submitted during shutdown — is failed with :class:`ServeShutdown`
        so its ``wait()`` raises promptly instead of timing out."""
        if self._thread is None:
            return
        if drain:
            deadline = time.perf_counter() + self.drain_deadline_s
            while self.queue.depth() and time.perf_counter() < deadline:
                time.sleep(0.001)
        self._stop.set()
        self._thread.join(timeout=max(self.drain_deadline_s, 1.0))
        self._thread = None
        undrained = self.queue.drain(max_n=2**31, wait_s=0.0)
        if undrained:
            self.errors += len(undrained)
            _metrics.inc(f"{self.name}.shutdown_failed", len(undrained))
            err = ServeShutdown(
                f"{self.name}: loop stopped with {len(undrained)} "
                f"request(s) undrained (drain_deadline_s="
                f"{self.drain_deadline_s})")
            for t in undrained:
                t._finish(error=err)
        _metrics.set_gauge(f"{self.name}.queue_depth", self.queue.depth())

    def stats(self) -> dict:
        return {"served": self.served, "batches": self.batches,
                "errors": self.errors, "queue_depth": self.queue.depth()}
