"""What every cell shares: finding a cell's files by name, the device line,
the profiler window, the per-layer readers and the result line.

A cell of ``BENCHMARK.json`` names a configuration (``bench/configs/
<config>.json``) and a traffic mix (``bench/traffic/<traffic>.json``); the
mix names its driver (``bench/drivers/<driver>.py``), and each per-layer
metric is read by ``bench/metrics/<metric>.py``. Adding a cell or a metric
adds files and entries and edits none.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "ml_dtypes")


def process_start_s() -> float:
    """perf_counter() reading of this process's start, from /proc (to the
    clock tick); the first call's own time where /proc is absent."""
    now = time.perf_counter()
    try:
        stat = Path("/proc/self/stat").read_text()
        ticks = int(stat.rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return now - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


def load_module(path: Path):
    """The module in ``path`` (a file whose name may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "bench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    end_to_end: list      # the BENCHMARK.json entries this cell reports
    per_layer: list
    limits_dir: Path = BENCH / "limits"
    bench_dir: Path = BENCH

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])

    def driver(self):
        return load_module(self.bench_dir / "drivers"
                           / f"{self.traffic['driver']}.py")


def reports(metric: dict, cell: str, e2e_names: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def find_cell(name: str, bench_json: Path = ROOT / "BENCHMARK.json",
              bench_dir: Path = BENCH) -> Cell:
    spec = json.loads(Path(bench_json).read_text())
    by_name = {w["name"]: w for w in spec["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in {bench_json}; have "
                       f"{sorted(by_name)}")
    return make_cell(by_name[name], spec, bench_dir)


def make_cell(w: dict, spec: dict, bench_dir: Path = BENCH) -> Cell:
    """The cell of workload entry ``w`` (name, config, traffic, chips),
    with the metrics of ``spec`` (BENCHMARK.json's content) it reports."""
    name = w["name"]
    config = json.loads((bench_dir / "configs" / f"{w['config']}.json"
                         ).read_text())
    traffic = json.loads((bench_dir / "traffic" / f"{w['traffic']}.json"
                          ).read_text())
    e2e = [m for m in spec["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if reports(m, name, e2e_names)]
    return Cell(name=name, workload=w, config=config, traffic=traffic,
                end_to_end=e2e, per_layer=per_layer,
                limits_dir=bench_dir / "limits", bench_dir=bench_dir)


# ---------------------------------------------------------------------------
# The device
# ---------------------------------------------------------------------------

def power_limit_w() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else None
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def device_line(chips: int, memory_peak_bytes: int) -> dict:
    import torch
    return {"platform": "gpu" if torch.cuda.is_available() else "cpu",
            "kind": (torch.cuda.get_device_name(0)
                     if torch.cuda.is_available() else "cpu"),
            "count": int(chips), "memory_peak_bytes": int(memory_peak_bytes),
            "power_limit": power_limit_w()}


def peaks_for(kind: str) -> Optional[dict]:
    table = json.loads((BENCH / "peaks.json").read_text())["cards"]
    return table.get(kind)


# ---------------------------------------------------------------------------
# The traced window: the program's spans and the device's operations
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Window:
    """What a per-layer reader reads. Times are perf_counter nanoseconds;
    ``ops`` are the device operations of the first card (name, start, end),
    clipped to the window."""
    t0_ns: int
    t1_ns: int
    spans: list                  # SpanRecord-like: name, track, t0_ns, t1_ns
    ops: list
    counters: dict
    counts: dict
    chips: int
    peaks: Optional[dict]      # the card's row of peaks.json, if known

    @property
    def seconds(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e9

    def span_ns(self, name: str) -> list:
        return [r.t1_ns - r.t0_ns for r in self.spans
                if r.name == name and r.kind == "X"]

    def op_ns(self, contains: str) -> int:
        return sum(e - s for n, s, e in self.ops if contains in n)

    def busy_ns(self) -> int:
        return union_ns([(s, e) for _, s, e in self.ops])


def union_ns(intervals: list) -> int:
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


class DeviceTrace:
    """``torch.profiler`` over the device's activity only (no host op
    events, so the host pays little), mapped onto perf_counter time."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])

    def __enter__(self):
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)
        return False

    def ops(self, t0_ns: int, t1_ns: int, device: int = 0) -> list:
        """(name, start, end) of each device operation on ``device``,
        clipped to [t0_ns, t1_ns] in perf_counter nanoseconds."""
        from torch.autograd import DeviceType
        offset = clock_offset_ns()
        out = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA or \
                    e.device_index() != device:
                continue
            s = e.start_ns() - offset
            t = s + e.duration_ns()
            s, t = max(s, t0_ns), min(t, t1_ns)
            if t > s:
                out.append((e.name(), s, t))
        return out


def clock_offset_ns() -> int:
    """The profiler's clock (the system clock) less perf_counter, taken
    where the two readings lie closest together."""
    best = None
    for _ in range(5):
        a = time.perf_counter_ns()
        w = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, w - (a + b) // 2)
    return best[1]


def breakdown(win: Window, main_track: str = "MainThread") -> dict:
    """The ten device operations that took most time, and the ten longest
    idle gaps of the first card labelled by the innermost span open on the
    main thread at the gap's middle."""
    by_name: dict = {}
    for n, s, e in win.ops:
        by_name[n] = by_name.get(n, 0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    busy, end = [], win.t0_ns
    for s, e in sorted((s, e) for _, s, e in win.ops):
        if s > end:
            busy.append((end, s))
        end = max(end, e)
    if win.t1_ns > end:
        busy.append((end, win.t1_ns))
    gaps = sorted(busy, key=lambda g: g[0] - g[1])[:10]
    main = [r for r in win.spans if r.kind == "X" and r.track == main_track]
    labelled = []
    for s, e in gaps:
        mid = (s + e) // 2
        open_ = [r for r in main if r.t0_ns <= mid <= r.t1_ns]
        label = max(open_, key=lambda r: r.depth).name if open_ else \
            "no span open"
        labelled.append([label, (e - s) / 1e9])
    return {"device_ops": [[n, ns / 1e9] for n, ns in ops],
            "idle_gaps": labelled}


def read_per_layer(cell: Cell, win: Window) -> dict:
    """Each per-layer metric of the cell from its reader; a reader that
    finds nothing to read returns None and the metric is left out."""
    out = {}
    for m in cell.per_layer:
        reader = load_module(cell.bench_dir / "metrics" / f"{m['name']}.py")
        value = reader.read(win)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


# ---------------------------------------------------------------------------
# The end of a run
# ---------------------------------------------------------------------------

def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def emit(result: dict, compared: dict) -> None:
    """The compared numbers beside their limits as the last lines of
    standard error, and the result line, with them last, as the last line
    of standard output."""
    for name, c in compared.items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps({**result, "compared": compared}), flush=True)
