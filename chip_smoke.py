#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

Drives the port's serving path end to end on the card and holds every
kernel it builds against its plain PyTorch version. Imports nothing of JAX
and nothing of the JAX package. Phases (any failure ends the run with a
non-zero exit and no result line):

  1. build    nvcc builds src/repro_torch/kernels/csrc/gather_agg.cu for
              sm_90a into build/repro_torch_kernels/ (git-ignored).
  2. kernels  gather_rows at every hop of a batch_pad=64 serve rung (the
              workspace and tree positions of a real micro-batch) and at an
              odd (33, 96) shape, bitwise against its plain version;
              gather_agg (sum/mean/max, f=10, d=100, float32 and bfloat16)
              within the tolerances of tests/test_kernels.py. Each kernel's
              device time (calls captured in a CUDA graph, timed with CUDA
              events) stands beside its plain version's, one PyTorch call
              that computes the same function (a yardstick the port never
              calls), its bound, and its cost per call from the host.
  3. serve    GNNServer with GraphSAGE at the paper's settings (3 layers,
              hidden 128, fanout 10) on the synthetic products graph at
              full scale (245,000 vertices, 4-way community partition),
              max_batch=64 and a 32 MiB hot tier: warmup, then a paced
              zipf(1.1) request stream through start()/submit(). Checks
              zero retraces after warmup, the gather_rows launch count,
              and the served logits of 256 vertices against the port's
              own forward on the CPU. Tracing is off in the stream.
  4. profile  32 unpaced micro-batches with the port's spans and
              torch.profiler on: host time per span, the device's busy
              share, and device time by kernel.

Output: one line per measurement; then the kernels' JSON line, the card's
name and power limit, and last ``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py [--requests 4096] [--qps 1000] [--seed 0]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.core import plan_inference  # noqa: E402
from repro_torch.features import FeatureStore  # noqa: E402
from repro_torch.graph import make_dataset  # noqa: E402
from repro_torch.graph.partition import (community_partition,  # noqa: E402
                                         shard_features)
from repro_torch.graph.sampler import sample_tree_block  # noqa: E402
from repro_torch.kernels import gather_agg as ga  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models.gnn import GNNConfig, gnn_forward, init_gnn  # noqa: E402
from repro_torch.obs import trace  # noqa: E402
from repro_torch.serve import GNNServer  # noqa: E402
from repro_torch.train.budget import next_bucket  # noqa: E402

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory (data sheet)
F32_FLOP_PER_S = 67e12             # H100 SXM float32 outside tensor cores
SRC = "src/repro_torch/kernels/csrc/gather_agg.cu"
AGG_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}   # test_kernels.py
CPU_TOL = 1e-4     # served (GPU, f32) vs CPU forward: summation order only
CACHE_BYTES = 32 << 20
MAX_BATCH = 64


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def call_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Time per call of ``fn`` issued back to back from the host, as CUDA
    events see it: for small work this is the host's launch cost."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20, replays: int = 5) -> float:
    """Device time per call of ``fn``: ``iters`` calls captured in one CUDA
    graph, replayed and timed with CUDA events, so the host's launch cost
    is left out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * iters)
    del graph
    return ms


def moved_bytes(table: torch.Tensor, idx: torch.Tensor, out_rows: int) -> int:
    """Bytes a gather must move: the index read once, each distinct table
    row it names read once, and the output written once."""
    row = table.shape[1] * table.element_size()
    return (idx.numel() * idx.element_size()
            + int(torch.unique(idx).numel()) * row + out_rows * row)


def bound_ms(nbytes: int, flops: int = 0) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# Phase 1: build
# ---------------------------------------------------------------------------

def phase_build() -> None:
    t0 = time.perf_counter()
    path, msgs = ga.build(verbose=True)
    log("build", f"{os.path.relpath(path, ROOT)} in "
                 f"{time.perf_counter() - t0:.2f} s")
    for line in msgs.splitlines():
        if "ptxas info" in line and ("Used" in line or "spill" in line):
            log("build", line.strip())


# ---------------------------------------------------------------------------
# Phase 2: kernels vs plain versions
# ---------------------------------------------------------------------------

def check_gather_rows(ws: torch.Tensor, hop_idx: list, seed: int) -> dict:
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
    for h, idx in enumerate(hop_idx):
        if not torch.equal(ga.gather_rows(ws, idx),
                           ref.gather_rows_ref(ws, idx)):
            raise AssertionError(f"gather_rows differs from plain at hop {h}")
        ms = device_ms(lambda: ga.gather_rows(ws, idx))
        pms = device_ms(lambda: ref.gather_rows_ref(ws, idx))
        lms = device_ms(lambda: torch.index_select(ws, 0, idx))
        host = call_ms(lambda: ga.gather_rows(ws, idx))
        nbytes = moved_bytes(ws, idx, idx.numel())
        b, _ = bound_ms(nbytes)
        log("kernels", f"gather_rows hop {h}: table {tuple(ws.shape)} f32, "
                       f"n={idx.numel()}: device {ms:.5f} ms (plain "
                       f"{pms:.5f}, index_select {lms:.5f}); per call from "
                       f"the host {host:.5f} ms; moves {nbytes} B, bound "
                       f"{b:.5f} ms; bitwise equal")
        for k, v in zip(tot, (ms, pms, lms, b)):
            tot[k] += v
    g = torch.Generator().manual_seed(seed)
    for dtype in (torch.float32, torch.bfloat16):
        t = torch.randn((33, 96), generator=g).to("cuda", dtype)
        i = torch.randint(0, 33, (29,), generator=g,
                          dtype=torch.int32).to("cuda")
        if not torch.equal(ga.gather_rows(t, i), ref.gather_rows_ref(t, i)):
            raise AssertionError(f"gather_rows differs at (33, 96) {dtype}")
    log("kernels", "gather_rows at (33, 96) float32 and bfloat16: bitwise "
                   "equal")
    log("kernels", f"gather_rows, all hops of one rung-64 micro-batch: "
                   f"device {tot['ms']:.5f} ms (plain {tot['plain_ms']:.5f}, "
                   f"index_select {tot['library_ms']:.5f}, bound "
                   f"{tot['bound_ms']:.5f})")
    return dict(name="gather_rows", route="cuda", source=SRC,
                replaces="src/repro/kernels/gather_agg.py:66",
                max_abs_err=0.0, bound_by="bytes", **tot)


def check_gather_agg(ws: torch.Tensor, hop_idx: list) -> dict:
    """Layer-0 child aggregation shapes: hop h+1's positions as (n, 10)
    neighbour lists, n = 64·10^h."""
    err = 0.0
    nbrs = [hop_idx[h + 1].reshape(-1, 10) for h in range(len(hop_idx) - 1)]
    for dtype in (torch.float32, torch.bfloat16):
        table = ws.to(dtype)
        for nbr in nbrs:
            for reduce in ("sum", "mean", "max"):
                out = ga.gather_agg(table, nbr, reduce).float()
                want = ref.gather_agg_ref(table, nbr, reduce).float()
                diff = float((out - want).abs().max())
                tol = 0.0 if reduce == "max" else AGG_TOL[dtype]
                if not torch.allclose(out, want, rtol=tol, atol=tol):
                    raise AssertionError(
                        f"gather_agg {reduce} {dtype} n={nbr.shape[0]}: max "
                        f"abs err {diff} over tolerance {tol}")
                err = max(err, diff)
    log("kernels", f"gather_agg sum/mean/max, float32 and bfloat16, n in "
                   f"{[x.shape[0] for x in nbrs]}, f=10, d={ws.shape[1]}: "
                   f"within tolerance, max abs err {err}")
    nbr = nbrs[-1]
    nbr64 = nbr.long()
    timed = {}
    for reduce in ("sum", "mean", "max"):
        ms = device_ms(lambda: ga.gather_agg(ws, nbr, reduce))
        pms = device_ms(lambda: ref.gather_agg_ref(ws, nbr, reduce))
        lms = device_ms(lambda: torch.nn.functional.embedding_bag(
            nbr64, ws, mode=reduce))
        host = call_ms(lambda: ga.gather_agg(ws, nbr, reduce))
        nbytes = moved_bytes(ws, nbr, nbr.shape[0])
        b, by = bound_ms(nbytes, nbr.numel() * ws.shape[1])
        log("kernels", f"gather_agg {reduce} f32 n={nbr.shape[0]} f=10: "
                       f"device {ms:.5f} ms (plain {pms:.5f}, embedding_bag "
                       f"{lms:.5f}); per call from the host {host:.5f} ms; "
                       f"moves {nbytes} B, bound {b:.5f} ms ({by})")
        timed[reduce] = dict(ms=ms, plain_ms=pms, library_ms=lms,
                             bound_ms=b, bound_by=by)
    return dict(name="gather_agg", route="cuda", source=SRC,
                replaces="src/repro/kernels/gather_agg.py:130",
                max_abs_err=err, **timed["mean"])


# ---------------------------------------------------------------------------
# Phase 3: serve
# ---------------------------------------------------------------------------

def build_world(seed: int):
    t0 = time.perf_counter()
    ds = make_dataset("products", scale=1.0, seed=seed)
    part = community_partition(ds.communities, 4)
    table, owner, local_idx = shard_features(ds.features, part, 4)
    store = FeatureStore.from_array(table, owner=owner, local_idx=local_idx)
    cfg = GNNConfig(model="sage", num_layers=3, hidden_dim=128,
                    feature_dim=ds.feature_dim, num_classes=ds.num_classes,
                    fanout=10)
    log("serve", f"products: {ds.num_vertices} vertices, "
                 f"{ds.graph.num_edges} edges, d={ds.feature_dim}, "
                 f"{ds.num_classes} classes, 4 shards; sage 3x128 fanout 10; "
                 f"set up in {time.perf_counter() - t0:.2f} s")
    return ds, store, cfg


def rung64_workspace(ds, store, cfg, seed: int):
    """The workspace ``[hot tier | fetched]`` and device tree positions of
    one real rung-64 micro-batch, sized as the server sizes them."""
    roots = np.unique(np.random.default_rng(seed).integers(
        0, ds.num_vertices, MAX_BATCH))
    plan = plan_inference(ds.graph, roots, cfg.num_layers, cfg.fanout,
                          sample_seed=999, batch_pad=MAX_BATCH)
    c_max = next_bucket(CACHE_BYTES // (ds.feature_dim * 4))
    u = plan.fetch_ids.size
    ws = np.zeros((c_max + next_bucket(int(u * 1.5), 8), ds.feature_dim),
                  np.float32)
    ws[c_max:c_max + u] = store.take_global(plan.fetch_ids)
    hops = [torch.from_numpy((h + c_max).astype(np.int32)).cuda()
            for h in plan.hop_idx]
    return torch.from_numpy(ws).cuda(), hops


def offline_logits(ds, store, cfg, params, nodes) -> np.ndarray:
    """The port's own forward on the CPU (plain versions): sample each
    root's tree, read its rows, run the model."""
    blk = sample_tree_block(ds.graph, np.asarray(nodes, np.int64),
                            cfg.num_layers, cfg.fanout, seed=999)
    feats = [torch.from_numpy(store.take_global(ids)) for ids in blk.hops]
    with torch.inference_mode():
        return gnn_forward(params, cfg, feats).numpy()


def phase_serve(ds, store, cfg, seed: int, requests: int,
                qps: float) -> dict:
    params = init_gnn(cfg, torch.Generator().manual_seed(seed), "cuda")
    srv = GNNServer(graph=ds.graph, params=params, cfg=cfg, store=store,
                    max_batch=MAX_BATCH, cache_budget_bytes=CACHE_BYTES,
                    device="cuda")
    t0 = time.perf_counter()
    w = srv.warmup()
    log("serve", f"warmup: rungs {w['rungs']}, {w['traces']} traces, ladder "
                 f"{w['ladder']}, {time.perf_counter() - t0:.2f} s")

    rng = np.random.default_rng(seed)
    n = ds.num_vertices
    p = np.arange(1, n + 1, dtype=np.float64) ** -1.1
    vertices = rng.permutation(n)[rng.choice(n, requests, p=p / p.sum())]

    # the main path: counts are zeroed just before it and read just after
    ga.reset_launches()
    batches0 = srv.fresh_batches
    srv.start()
    gap = 1.0 / qps
    tickets, t_next = [], time.perf_counter()
    try:
        for v in vertices:
            now = time.perf_counter()
            if now < t_next:
                time.sleep(t_next - now)
            tickets.append(srv.submit(int(v)))
            t_next += gap
        results = [t.wait(120.0) for t in tickets]
    finally:
        srv.stop()
    launches = dict(ga.launches)
    batches = srv.fresh_batches - batches0

    lat = np.array([1e3 * t.latency_s() for t in tickets])
    wall = tickets[-1].t_done - tickets[0].t_submit
    st = srv.stats()
    log("serve", f"{len(tickets)} zipf(1.1) requests offered at {qps} req/s:"
                 f" served at {len(tickets) / wall:.1f} req/s, latency p50 "
                 f"{np.percentile(lat, 50):.3f} ms p99 "
                 f"{np.percentile(lat, 99):.3f} ms")
    log("serve", f"tiers: {st['fresh_requests']} fresh requests in "
                 f"{st['fresh_batches']} micro-batches, "
                 f"{st['cache_hit_rows']} hot-tier rows hit, "
                 f"{st['fetch_rows']} rows fetched, {st['cached_rows']} rows "
                 f"cached after {st['cache_installs']} installs; retraces "
                 f"since warmup {st['retraces_since_warmup']}")
    log("serve", f"launches during the stream: {launches} for {batches} "
                 f"micro-batches")
    if st["retraces_since_warmup"] != 0:
        raise AssertionError("serving retraced after warmup")
    if batches == 0 or \
            launches["gather_rows"] < (cfg.num_layers + 1) * batches:
        raise AssertionError(f"gather_rows launched {launches['gather_rows']}"
                             f" times for {batches} micro-batches")

    # what came out: 256 served vertices against the port's CPU forward
    served = {}
    for v, r in zip(vertices.tolist(), results):
        served.setdefault(v, r)
    sample = rng.choice(np.array(sorted(served)), min(256, len(served)),
                        replace=False)
    got = np.stack([served[int(v)] for v in sample])
    if got.shape != (sample.size, cfg.num_classes) \
            or not np.isfinite(got).all():
        raise AssertionError(f"served logits malformed: {got.shape}")
    cpu_params = init_gnn(cfg, torch.Generator().manual_seed(seed), "cpu")
    want = offline_logits(ds, store, cfg, cpu_params, sample)
    err = float(np.abs(got - want).max())
    if not np.allclose(got, want, rtol=CPU_TOL, atol=CPU_TOL):
        raise AssertionError(f"served logits differ from the CPU forward: "
                             f"max abs err {err} > {CPU_TOL}")
    # packing invariance: the same vertices packed into other micro-batches
    again = srv.predict(sample[::-1].tolist())[::-1]
    pack = float(np.abs(again - got).max())
    log("serve", f"{sample.size} served vertices vs the CPU forward: max abs "
                 f"err {err} (tolerance {CPU_TOL}, logits up to "
                 f"{float(np.abs(want).max()):.3f}); same vertices repacked: "
                 f"max abs diff {pack}")
    profile_window(srv, vertices[:32 * MAX_BATCH])
    return launches


def profile_window(srv, vertices: np.ndarray) -> None:
    """Where the time of the serving path goes, in a traced run apart from
    the latency stream: micro-batches of up to 64 vertices driven back to
    back through ``predict`` (no pacing) with the port's spans on and
    ``torch.profiler`` recording the device. Prints each span's mean, and
    device activity (kernels and copies) summed by name against the
    window's wall time under the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    chunks = [np.unique(c) for c in
              np.array_split(vertices, max(1, vertices.size // MAX_BATCH))]
    trace.clear()
    trace.enable()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for c in chunks:
                srv.predict(c.tolist())
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    finally:
        trace.disable()
    spans: dict = {}
    for r in trace.records():
        if r.kind == "X":
            s = spans.setdefault(r.name, [0, 0])
            s[0] += 1
            s[1] += r.dur_ns
    trace.clear()
    for name in sorted(spans):
        c, ns = spans[name]
        log("profile", f"span {name}: {c} x {ns / 1e6 / c:.3f} ms mean, "
                       f"{ns / 1e6:.1f} ms total")
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) \
                + e.time_range.elapsed_us()
    busy = sum(by_name.values())
    if not by_name:
        log("profile", f"{len(chunks)} micro-batches in {wall_us / 1e3:.1f} "
                       f"ms: no device activity recorded, device busy share "
                       f"not measured")
        return
    log("profile", f"{len(chunks)} micro-batches in {wall_us / 1e3:.1f} ms "
                   f"under the profiler: device busy {busy / 1e3:.3f} ms = "
                   f"{100 * busy / wall_us:.2f}% of wall (idle "
                   f"{100 - 100 * busy / wall_us:.2f}%), "
                   f"{busy / len(chunks):.1f} us per micro-batch")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log("profile", f"{us / len(chunks):9.1f} us/micro-batch "
                       f"{100 * us / busy:5.1f}%  {name[:90]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=4096)
    ap.add_argument("--qps", type=float, default=1000.0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_all = time.perf_counter()
    log("device", f"{card_line()}; torch {torch.__version__} cuda "
                  f"{torch.version.cuda}; tf32 matmul "
                  f"{torch.backends.cuda.matmul.allow_tf32} cudnn "
                  f"{torch.backends.cudnn.allow_tf32}")
    phase_build()
    ds, store, cfg = build_world(args.seed)
    ws, hops = rung64_workspace(ds, store, cfg, args.seed + 1)
    kernels = [check_gather_rows(ws, hops, args.seed),
               check_gather_agg(ws, hops)]
    del ws, hops
    launches = phase_serve(ds, store, cfg, args.seed, args.requests,
                           args.qps)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    torch.cuda.synchronize()
    log("done", f"all phases passed in {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
