"""Exporters: Chrome-trace/Perfetto timelines, JSONL metrics, manifests.

``chrome_trace()`` turns the ring-buffer span records into the Chrome
trace-event JSON format — load the file at https://ui.perfetto.dev or
``chrome://tracing``. One timeline track per recording thread:

- ``main``            the dispatch loop (plan waits, dispatch, syncs)
- ``prefetch``        the plan-prefetch thread (plan build + uploads)
- ``uploader``        ping-pong slot commits (virtual track: the commit
                      runs on the prefetch thread but is its own lane)
- ``cache+readahead`` the shared cache/readahead worker
- ``planner-N``       planner fan-out pool threads (when cores allow)

The planner's spans, outermost first: ``plan.build`` (one plan, its
upload commit included) on ``prefetch``; inside it one ``plan.pass`` per
call of the planner (``probe=True`` on a new merge pattern's probe, and
``error=PlanOverflow`` on a pass that overflowed its budget and was
rebuilt); inside each pass the three stages ``plan.sample``,
``plan.dedup`` and ``plan.translate`` on the same lane (``plan.dedup``
tagged ``path="bitmap"`` or ``path="sort"``). The stages'
per-item work, ``plan.sample.job``, ``plan.dedup.job`` (per-step mode)
and ``plan.translate.job``, lands on whichever ``planner-N`` lane runs
it, or nested in its stage when the pool is off.

The rest of the training path: ``plan.wait``, ``dispatch`` (the host's
enqueue) and ``loss.sync``/``trace.sync`` (the synced windows that hold
the device's time) on ``main``; ``cache.forecast``, ``cache.refresh`` and
``features.readahead(.forecast)`` on ``cache+readahead``; and, on the
thread that does them, ``cache.install``/``cache.upload``,
``ckpt.save``/``ckpt.load`` and ``membership.probe/detect/rebuild/resume``.

Each span's args carry ``cpu_ms``, the recording thread's CPU time inside
it; the document's ``metadata`` carries the recorder's ``clock_pairs``
(``[perf_counter_ns, time_ns]`` at enable and at disable) and
``epoch_perf_counter_ns``, the perf_counter time of ``ts`` 0, so the
timeline can be put on the system clock of a ``torch.profiler`` trace of
the same run.

``run_manifest()`` stamps artifacts with the git sha, the torch, CUDA,
numpy and Python versions, the GPU's name and power limit, and the
platform, so any result or trace file can be matched to the commit and the
card that produced it; ``write_metrics_jsonl()`` emits a manifest header
line followed by one JSON object per row.

A port of the reference's ``repro.obs.export``: the same documents, track
labels and checks, with the manifest stamping torch and the GPU where the
reference stamps jax.
"""
from __future__ import annotations

import hashlib
import json
import platform
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

from repro_torch.obs import trace as _trace

__all__ = ["run_manifest", "config_digest", "chrome_trace",
           "export_chrome_trace", "validate_chrome_trace",
           "trace_track_names", "trace_span_names", "write_metrics_jsonl"]

_REPO_ROOT = Path(__file__).resolve().parents[3]


def _git_sha() -> str:
    try:
        out = subprocess.run(["git", "rev-parse", "HEAD"], cwd=_REPO_ROOT,
                             capture_output=True, text=True, timeout=10)
        if out.returncode == 0 and out.stdout.strip():
            return out.stdout.strip()
    except Exception:                                   # noqa: BLE001
        pass
    return "unknown"


def config_digest(config) -> str:
    """Short stable digest of any JSON-serializable config object."""
    blob = json.dumps(config, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:12]


def _gpu() -> tuple[str, str]:
    """The first GPU's name and power limit, as ``nvidia-smi`` prints them
    (the limit as reported, e.g. ``"700.00 W"``); ``("none", "none")``
    without a CUDA device, and ``"unknown"`` for a limit nvidia-smi did
    not give."""
    import torch
    if not torch.cuda.is_available():
        return "none", "none"
    name = torch.cuda.get_device_name(0)
    limit = "unknown"
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        if out.returncode == 0 and out.stdout.strip():
            limit = out.stdout.strip().splitlines()[0].rsplit(",", 1)[-1]
            limit = limit.strip()
    except (OSError, subprocess.SubprocessError):
        pass
    return name, limit


def run_manifest(seed: Optional[int] = None, config=None,
                 extra: Optional[dict] = None) -> dict:
    """Provenance stamp shared by every artifact writer: git sha,
    interpreter + library versions, the GPU's name and power limit
    (``"none"`` without a CUDA device), platform, optional seed and config
    digest."""
    import numpy as np
    import torch
    gpu, power_limit = _gpu()
    m = {
        "git_sha": _git_sha(),
        "python": platform.python_version(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda or "none",
        "gpu": gpu,
        "gpu_power_limit": power_limit,
        "numpy": np.__version__,
        "platform": platform.platform(),
        "argv": " ".join(sys.argv),
        "time_unix": round(time.time(), 3),
    }
    if seed is not None:
        m["seed"] = int(seed)
    if config is not None:
        m["config_digest"] = config_digest(config)
    if extra:
        m.update(extra)
    return m


def _track_label(raw: str) -> str:
    """Friendly Perfetto lane names for the repo's known threads."""
    if raw == "uploader":
        return "uploader"
    if raw == "MainThread":
        return "main"
    if raw.startswith("prefetch"):
        return "prefetch"
    if raw.startswith("cache"):
        return "cache+readahead"
    if raw.startswith("plan"):
        tail = raw.rsplit("_", 1)[-1]
        return f"planner-{tail}" if tail.isdigit() else "planner"
    return raw


# Stable lane ordering in the Perfetto UI; unknown tracks sort after.
_TRACK_ORDER = {"main": 0, "prefetch": 1, "uploader": 2,
                "cache+readahead": 3}


def chrome_trace(records=None, manifest: Optional[dict] = None) -> dict:
    """Build a Chrome trace-event document from drained span records
    (defaults to the live recorder's). Complete spans become ``ph:"X"``
    events with µs timestamps relative to the recording epoch; instant
    marks become ``ph:"i"`` thread-scoped instants; every track gets a
    ``thread_name`` metadata event. Spans carry ``cpu_ms`` in their args;
    ``metadata`` is the manifest with the recorder's clock pairs and
    epoch added."""
    recs = _trace.records() if records is None else list(records)
    t0 = _trace.epoch_ns()
    labels: list[str] = []
    for r in recs:
        lab = _track_label(r.track)
        if lab not in labels:
            labels.append(lab)
    labels.sort(key=lambda s: (_TRACK_ORDER.get(s, 99), s))
    tid = {lab: i + 1 for i, lab in enumerate(labels)}

    events: list[dict] = [{
        "name": "process_name", "ph": "M", "pid": 1, "tid": 0,
        "args": {"name": "repro_torch"},
    }]
    for lab, i in tid.items():
        events.append({"name": "thread_name", "ph": "M", "pid": 1,
                       "tid": i, "args": {"name": lab}})
        events.append({"name": "thread_sort_index", "ph": "M", "pid": 1,
                       "tid": i, "args": {"sort_index": i}})
    for r in recs:
        ev = {"name": r.name, "cat": "repro_torch", "pid": 1,
              "tid": tid[_track_label(r.track)],
              "ts": (r.t0_ns - t0) / 1e3}
        if r.kind == "X":
            ev["ph"] = "X"
            ev["dur"] = (r.t1_ns - r.t0_ns) / 1e3
        else:
            ev["ph"] = "i"
            ev["s"] = "t"
        args = {k: (v if isinstance(v, (int, float, bool)) else str(v))
                for k, v in (r.tags or {}).items()}
        if r.kind == "X":
            args["cpu_ms"] = r.cpu_ns / 1e6
        if args:
            ev["args"] = args
        events.append(ev)
    metadata = dict(manifest if manifest is not None else run_manifest())
    metadata["clock_pairs"] = [list(p) for p in _trace.clock_pairs()]
    metadata["epoch_perf_counter_ns"] = t0
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "metadata": metadata,
        "otherData": {"dropped_records": _trace.dropped(),
                      "span_records": len(recs)},
    }


def export_chrome_trace(path, records=None,
                        manifest: Optional[dict] = None) -> Path:
    """Write :func:`chrome_trace` to ``path`` and return it."""
    doc = chrome_trace(records, manifest)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(doc))
    return path


def validate_chrome_trace(doc: dict) -> list[str]:
    """Structural check against the Chrome trace-event format; returns
    a list of problems (empty ⇒ loadable by Perfetto/chrome://tracing)."""
    problems: list[str] = []
    evs = doc.get("traceEvents")
    if not isinstance(evs, list):
        return ["traceEvents missing or not a list"]
    named_tids = set()
    for i, ev in enumerate(evs):
        ph = ev.get("ph")
        if ph not in ("X", "i", "M"):
            problems.append(f"event {i}: unsupported ph {ph!r}")
            continue
        if not isinstance(ev.get("name"), str) or not ev["name"]:
            problems.append(f"event {i}: missing name")
        if not isinstance(ev.get("pid"), int) or \
                not isinstance(ev.get("tid"), int):
            problems.append(f"event {i}: pid/tid must be ints")
        if ph == "M":
            if ev["name"] == "thread_name":
                named_tids.add(ev.get("tid"))
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            problems.append(f"event {i}: bad ts {ts!r}")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"event {i}: bad dur {dur!r}")
            cpu = ev.get("args", {}).get("cpu_ms", 0)
            if not isinstance(cpu, (int, float)) or cpu < 0:
                problems.append(f"event {i}: bad cpu_ms {cpu!r}")
        if ph == "i" and ev.get("s") not in ("t", "p", "g"):
            problems.append(f"event {i}: instant missing scope")
        if ev.get("tid") not in named_tids:
            problems.append(f"event {i}: tid {ev.get('tid')} has no "
                            "thread_name metadata")
    meta = doc.get("metadata")
    if not isinstance(meta, dict):
        problems.append("metadata manifest missing")
    elif "clock_pairs" in meta:
        pairs = meta["clock_pairs"]
        if not isinstance(pairs, list) or not all(
                isinstance(p, list) and len(p) == 2
                and all(isinstance(x, int) for x in p) for p in pairs):
            problems.append("metadata clock_pairs must be a list of "
                            "[perf_counter_ns, time_ns] int pairs")
    return problems


def trace_track_names(doc: dict) -> set:
    """Track labels present in an exported document."""
    return {ev["args"]["name"] for ev in doc.get("traceEvents", [])
            if ev.get("ph") == "M" and ev.get("name") == "thread_name"}


def trace_span_names(doc: dict) -> set:
    """Names of complete spans present in an exported document."""
    return {ev["name"] for ev in doc.get("traceEvents", [])
            if ev.get("ph") == "X"}


def write_metrics_jsonl(path, rows, manifest: Optional[dict] = None,
                        ) -> Path:
    """Emit a JSONL metrics artifact: first line is
    ``{"manifest": {...}}``, then one JSON object per row."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with path.open("w") as f:
        f.write(json.dumps(
            {"manifest": manifest if manifest is not None
             else run_manifest()}) + "\n")
        for row in rows:
            f.write(json.dumps(row, default=str) + "\n")
    return path
