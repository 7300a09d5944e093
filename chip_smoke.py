#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

Drives the port's two serving paths and its GNN training path end to end
on the card and holds every kernel it builds against its plain PyTorch
version. Imports nothing of JAX and nothing of the JAX package. Phases
(any failure ends the run with a non-zero exit and no result line):

  1. build    nvcc builds src/repro_torch/kernels/csrc/gather_agg.cu and
              csrc/linattn.cu for sm_90a into build/repro_torch_kernels/
              (git-ignored), all at once, and prints each kernel's
              registers, shared memory and spills.
  2. kernels  gather_rows at every hop of a batch_pad=64 serve rung (the
              workspace and tree positions of a real micro-batch) and at an
              odd (33, 96) shape, bitwise against its plain version;
              gather_agg (sum/mean/max, f=10, d=100, float32 and bfloat16)
              within the tolerances of tests/test_kernels.py; linattn at the
              RWKV6 prefill's shapes (BH = 8·64, dk = dv = 64, T 256 and
              2048, chunk 64, the latter also with RWKV-like decays; T 24 at
              chunk 24 and chunk 1; T 126 at chunk 63), a ragged dv (48),
              and odd shapes (BH 3, T 128, dk 32; BH 5, T 96, dk 30, dv 45,
              chunk 32), with a nonzero u and w in (0.5, 1], within 5e-4 of
              its plain version, and once against the token scan. Each
              kernel's device time (calls captured in a CUDA graph, timed
              with CUDA events) stands beside its plain version's, one
              PyTorch call that computes the same function where there is
              one (a yardstick the port never calls), its bound, and its
              cost per call from the host. linattn's bound counts its
              products in 3xTF32 at the TF32 tensor-core peak.
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
  5. train    LeapGNN training on the same products world and model
              (4 shards emulated on the card, hopgnn, pre-gathering,
              merging, the async pipeline, batch 256 per model = 1024
              global, AdamW with a cosine schedule as
              examples/train_hopgnn.py): gather_rows at the four hops of
              one (shard, step) of a real plan, bitwise and timed; one
              iteration's loss and every grad leaf on CUDA against the
              port on the CPU (plain gather_rows) within 1e-4 of each
              leaf's largest value; then fit for 2 epochs of 8 iterations,
              gating finite losses, no retraces after epoch 0 beyond one
              per new merge pattern, and gather_rows launched once per
              (shard, step, hop) of every iteration. Prints losses, steady
              ms/iter, dispatch and plan ms/iter, rows fetched per
              iteration, and one more epoch under torch.profiler (device
              busy share, time by kernel). TF32 stays off.
  6. rwkv6    rwkv6-7b at its published width, cut to 2 layers, float32:
              the CUDA prefill (through the linattn kernel) against the
              same parameters' prefill on the CPU (plain versions), and
              prefill(63) + decode_step(token 64) against prefill(64).
  7. llm      LLMServer with rwkv6-7b at its published width and depth in
              bfloat16 (random weights drawn on the card), max_batch=8,
              gen_tokens=16: 64 prompts of the port's make_batch tokens,
              lengths uniform in 128..2048, through start()/submit(). Gates
              result shapes and range, >= 32 linattn launches per batch and
              zero errors; prints prefill time per bucket, decode time per
              token, tokens/s, latency p50/p99, and a profiled generate at
              the largest bucket (device busy share, time by kernel).

Output: one line per measurement; then the kernels' JSON line (launches
summed over the paths, per path under ``launches_by_path``), the card's
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

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import distributed as engine  # noqa: E402
from repro_torch.core import plan_inference  # noqa: E402
from repro_torch.data import make_batch  # noqa: E402
from repro_torch.features import FeatureStore  # noqa: E402
from repro_torch.graph import make_dataset  # noqa: E402
from repro_torch.graph.partition import (community_partition,  # noqa: E402
                                         shard_features)
from repro_torch.graph.sampler import sample_tree_block  # noqa: E402
from repro_torch.kernels import gather_agg as ga  # noqa: E402
from repro_torch.kernels import linattn as la  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch.serve import LLMServer, generate  # noqa: E402
from repro_torch.models.gnn import GNNConfig, gnn_forward, init_gnn  # noqa: E402
from repro_torch.models.transformer import (decode_step,  # noqa: E402
                                            init_params, prefill)
from repro_torch.obs import trace  # noqa: E402
from repro_torch.optim import adamw, cosine_schedule  # noqa: E402
from repro_torch.serve import GNNServer  # noqa: E402
from repro_torch.train import Trainer  # noqa: E402
from repro_torch.train.budget import next_bucket  # noqa: E402
from repro_torch.train.pipeline import run_pipelined_epoch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory (data sheet)
F32_FLOP_PER_S = 67e12             # H100 SXM float32 outside tensor cores
TF32_FLOP_PER_S = 495e12           # H100 SXM TF32 tensor cores, dense
SRC = "src/repro_torch/kernels/csrc/gather_agg.cu"
LA_SRC = "src/repro_torch/kernels/csrc/linattn.cu"
LA_TOL = 5e-4      # tests/test_kernels.py: chunked kernel vs plain, f32
WIDE_TOL = 1e-3    # full-width 2-layer f32 prefill, CUDA vs CPU
# Its returned state S, CUDA vs CPU: measured max abs err 2.1e-4 on |S| up
# to 168 (H100), so an absolute floor plus a share of |S|.
STATE_RTOL, STATE_ATOL = 1e-4, 1e-3
DECODE_TOL = 5e-3  # prefill + decode vs prefill, tests/test_arch_smoke.py
LLM_BATCH = 8
GEN_TOKENS = 16
AGG_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}   # test_kernels.py
CPU_TOL = 1e-4     # served (GPU, f32) vs CPU forward: summation order only
CACHE_BYTES = 32 << 20
MAX_BATCH = 64
SHARDS = 4
TRAIN_EPOCHS, TRAIN_ITERS, TRAIN_BATCH = 2, 8, 256   # batch per model
# one iteration's grads, CUDA vs CPU, per leaf: max abs err within this
# share of the leaf's largest |value| (summation order only)
TRAIN_RTOL = 1e-4


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


def bound_ms(nbytes: int, flops: int = 0,
             flop_rate: float = F32_FLOP_PER_S) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# Phase 1: build
# ---------------------------------------------------------------------------

def phase_build() -> None:
    """Both libraries at once: one nvcc per source, started together."""
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        futs = [pool.submit(mod.build, True) for mod in (ga, la)]
        built = [f.result() for f in futs]
    for path, msgs in built:
        log("build", f"{os.path.relpath(path, ROOT)} built")
        for line in msgs.splitlines():
            if "Used" in line or "spill" in line or "smem" in line:
                log("build", line.strip())
    log("build", f"both libraries in {time.perf_counter() - t0:.2f} s; "
                 f"linattn takes {la.smem_bytes()} B of dynamic shared "
                 f"memory per block")


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


def linattn_inputs(g, bh: int, T: int, dk: int, dv: int, u_per_bh: bool,
                   decay: str = "uniform"):
    """q, k, v standard normal; w in the kernel's domain, uniform in
    (0.5, 1) or RWKV-like exp(-exp(-6 + 0.5 z)) with z standard normal; u
    nonzero (a fresh model's u is 0 and would hide the bonus term)."""
    q, k = (torch.randn((bh, T, dk), generator=g, device="cuda")
            for _ in range(2))
    v = torch.randn((bh, T, dv), generator=g, device="cuda")
    if decay == "uniform":
        w = 0.5 + 0.5 * torch.rand((bh, T, dk), generator=g, device="cuda")
        w = w.clamp_(min=0.5 + 2 ** -24)
    else:
        z = torch.randn((bh, T, dk), generator=g, device="cuda")
        w = torch.exp(-torch.exp(-6 + 0.5 * z))
    u = torch.randn((bh, dk) if u_per_bh else (dk,), generator=g,
                    device="cuda")
    return q, k, v, w, u


def linattn_cost(bh: int, T: int, dk: int, dv: int) -> tuple[int, int]:
    """Bytes (q, k, w, v and u read once; o and S_out written once) and
    flops (four products of 2·C·dk·dv per chunk per bh)."""
    nbytes = 4 * (bh * T * (3 * dk + 2 * dv) + bh * dk + bh * dk * dv)
    return nbytes, 8 * bh * T * dk * dv


def linattn_bound(nbytes: int, flops: int) -> tuple[float, str]:
    """The card does this f32 function on its tensor cores in 3xTF32, three
    TF32 products per f32 product, at the TF32 peak."""
    return bound_ms(nbytes, 3 * flops, TF32_FLOP_PER_S)


def check_linattn(seed: int) -> dict:
    g = torch.Generator(device="cuda").manual_seed(seed)
    bh = LLM_BATCH * 64
    # (BH, T, dk, dv, chunk, u per bh, decay)
    cases = [(bh, 256, 64, 64, 64, True, "uniform"),
             (bh, 2048, 64, 64, 64, True, "uniform"),
             (bh, 2048, 64, 64, 64, True, "rwkv"),
             (bh, 24, 64, 64, 24, True, "uniform"),
             (bh, 24, 64, 64, 1, True, "uniform"),
             (bh, 126, 64, 64, 63, True, "uniform"),
             (64, 256, 64, 48, 64, True, "uniform"),
             (3, 128, 32, 64, 64, False, "uniform"),
             (5, 96, 30, 45, 32, True, "uniform")]
    err, timed = 0.0, {}
    for BH, T, dk, dv, chunk, per_bh, decay in cases:
        xs = linattn_inputs(g, BH, T, dk, dv, per_bh, decay)
        o, s = la.linattn_chunked(*xs, chunk=chunk)
        o_ref, s_ref = ref.linattn_chunked_ref(*xs, chunk=chunk)
        torch.cuda.synchronize()
        e_o = float((o - o_ref).abs().max())
        e_s = float((s - s_ref).abs().max())
        ok = (torch.allclose(o, o_ref, rtol=LA_TOL, atol=LA_TOL)
              and torch.allclose(s, s_ref, rtol=LA_TOL, atol=LA_TOL))
        shape = f"BH={BH} T={T} dk={dk} dv={dv} chunk={chunk} " \
                f"u {'(BH, dk)' if per_bh else '(dk,)'} w {decay}"
        if not ok:
            raise AssertionError(f"linattn {shape}: max abs err o {e_o}, "
                                 f"S {e_s} over tolerance {LA_TOL}")
        err = max(err, e_o, e_s)
        msg = f"linattn {shape}: max abs err o {e_o} S {e_s} (|o| up to " \
              f"{float(o_ref.abs().max()):.2f}, tolerance {LA_TOL})"
        if chunk == 64 and BH == bh and decay == "uniform":
            ms = device_ms(lambda: la.linattn_chunked(*xs, chunk=chunk))
            pms = device_ms(lambda: ref.linattn_chunked_ref(*xs,
                                                            chunk=chunk))
            host = call_ms(lambda: la.linattn_chunked(*xs, chunk=chunk))
            nbytes, flops = linattn_cost(BH, T, dk, dv)
            b, by = linattn_bound(nbytes, flops)
            b_f32, by_f32 = bound_ms(nbytes, flops)
            msg += (f"; device {ms:.5f} ms (plain {pms:.5f}, no single "
                    f"PyTorch call computes it); per call from the host "
                    f"{host:.5f} ms; moves {nbytes} B, {flops} flops, bound "
                    f"{b:.5f} ms ({by}; 3xTF32 at 495 TF/s), "
                    f"{100 * b / ms:.1f}% of bound; f32 SIMT bound (67 "
                    f"TF/s, no tensor cores) {b_f32:.5f} ms ({by_f32}), "
                    f"{100 * b_f32 / ms:.1f}%")
            timed[T] = dict(ms=ms, plain_ms=pms, library_ms=None,
                            bound_ms=b, bound_by=by)
        log("kernels", msg)
    xs = linattn_inputs(g, 8, 64, 64, 64, True)
    o, s = la.linattn_chunked(*xs, chunk=16)
    o_scan, s_scan = ref.linattn_ref(*xs)
    e_scan = max(float((o - o_scan).abs().max()),
                 float((s - s_scan).abs().max()))
    if not (torch.allclose(o, o_scan, rtol=LA_TOL, atol=LA_TOL)
            and torch.allclose(s, s_scan, rtol=LA_TOL, atol=LA_TOL)):
        raise AssertionError(f"linattn vs the token scan: max abs err "
                             f"{e_scan} over tolerance {LA_TOL}")
    log("kernels", f"linattn BH=8 T=64 chunk=16 vs the token scan "
                   f"(linattn_ref): max abs err {e_scan}")
    return dict(name="linattn", route="cuda", source=LA_SRC,
                replaces="src/repro/kernels/linattn.py:93",
                max_abs_err=max(err, e_scan), **timed[2048])


# ---------------------------------------------------------------------------
# Phase 3: serve
# ---------------------------------------------------------------------------

def build_world(seed: int):
    t0 = time.perf_counter()
    ds = make_dataset("products", scale=1.0, seed=seed)
    part = community_partition(ds.communities, SHARDS)
    table, owner, local_idx = shard_features(ds.features, part, SHARDS)
    store = FeatureStore.from_array(table, owner=owner, local_idx=local_idx)
    cfg = GNNConfig(model="sage", num_layers=3, hidden_dim=128,
                    feature_dim=ds.feature_dim, num_classes=ds.num_classes,
                    fanout=10)
    log("serve", f"products: {ds.num_vertices} vertices, "
                 f"{ds.graph.num_edges} edges, d={ds.feature_dim}, "
                 f"{ds.num_classes} classes, 4 shards; sage 3x128 fanout 10; "
                 f"set up in {time.perf_counter() - t0:.2f} s")
    return ds, store, cfg, part


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


def device_profile(fn, label: str, per: int, unit: str) -> None:
    """Run ``fn`` under torch.profiler: the device's busy share of the
    window's wall time, and device activity (kernels and copies) summed by
    name, printed per ``unit`` (``per`` of them in the window). The
    profiler's own host cost stretches the window, so the busy share is a
    lower bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) \
                + e.time_range.elapsed_us()
    busy = sum(by_name.values())
    if not by_name:
        log(label, f"{per} x {unit} in {wall_us / 1e3:.1f} ms: no device "
                   f"activity recorded, device busy share not measured")
        return
    log(label, f"{per} x {unit} in {wall_us / 1e3:.1f} ms under the "
               f"profiler: device busy {busy / 1e3:.3f} ms = "
               f"{100 * busy / wall_us:.2f}% of wall (idle "
               f"{100 - 100 * busy / wall_us:.2f}%), {busy / per / 1e3:.3f} "
               f"ms per {unit}")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        log(label, f"{us / per / 1e3:9.3f} ms/{unit} {100 * us / busy:5.1f}%"
                   f"  {name[:90]}")


def profile_window(srv, vertices: np.ndarray) -> None:
    """Where the time of the serving path goes, in a traced run apart from
    the latency stream: micro-batches of up to 64 vertices driven back to
    back through ``predict`` (no pacing) with the port's spans on and
    ``torch.profiler`` recording the device. Prints the device's busy share
    and time by kernel, then each span's mean."""
    chunks = [np.unique(c) for c in
              np.array_split(vertices, max(1, vertices.size // MAX_BATCH))]
    trace.clear()
    trace.enable()
    try:
        device_profile(lambda: [srv.predict(c.tolist()) for c in chunks],
                       "profile", len(chunks), "micro-batch")
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


# ---------------------------------------------------------------------------
# Phase 5: LeapGNN training
# ---------------------------------------------------------------------------

def check_gather_rows_train(trainer, plan) -> None:
    """gather_rows at the four hops of (shard 0, step 0) of a real training
    plan, on shard 0's pre-gathered workspace ``[local | fetched]``:
    bitwise against its plain version, and timed as phase 2 times it."""
    dev = engine.tree_map(lambda x: engine.upload(x, trainer.device),
                          plan.device_args())
    d = trainer.table.shape[-1]
    recv = engine.EmulatedComm().exchange_global(trainer.table, dev["req"])
    ws = torch.cat([trainer.table[0], recv[0].reshape(-1, d)], 0)
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
    for h, hop in enumerate(dev["hop_idx"]):
        idx = hop[0, 0].contiguous()
        if not torch.equal(ga.gather_rows(ws, idx),
                           ref.gather_rows_ref(ws, idx)):
            raise AssertionError(f"gather_rows differs from plain at "
                                 f"training hop {h}")
        ms = device_ms(lambda: ga.gather_rows(ws, idx))
        pms = device_ms(lambda: ref.gather_rows_ref(ws, idx))
        lms = device_ms(lambda: torch.index_select(ws, 0, idx))
        nbytes = moved_bytes(ws, idx, idx.numel())
        b, _ = bound_ms(nbytes)
        log("train", f"gather_rows training hop {h}: workspace "
                     f"{tuple(ws.shape)} f32, n={idx.numel()}: device "
                     f"{ms:.5f} ms (plain {pms:.5f}, index_select {lms:.5f})"
                     f"; moves {nbytes} B, bound {b:.5f} ms; bitwise equal")
        for k, v in zip(tot, (ms, pms, lms, b)):
            tot[k] += v
    log("train", f"gather_rows, 4 hops of one (shard, step): device "
                 f"{tot['ms']:.5f} ms (plain {tot['plain_ms']:.5f}, "
                 f"index_select {tot['library_ms']:.5f}, bound "
                 f"{tot['bound_ms']:.5f}); an iteration runs "
                 f"{plan.num_shards * plan.num_steps} such")


def check_train_grads(trainer, plan, store, cfg) -> None:
    """One iteration's loss and grad leaves on CUDA (the gather_rows
    kernel) against the same parameters' iteration on the CPU (plain
    gather_rows)."""
    import copy
    t0 = time.perf_counter()
    g_gpu, l_gpu = engine.run_iteration(trainer.params, trainer.table,
                                        plan, cfg)
    torch.cuda.synchronize()
    t_gpu = time.perf_counter() - t0
    params_cpu = copy.deepcopy(trainer.params).cpu()
    t0 = time.perf_counter()
    g_cpu, l_cpu = engine.run_iteration(params_cpu, store.as_dense(), plan,
                                        cfg, device="cpu")
    t_cpu = time.perf_counter() - t0
    errs = []
    for i, (a, b) in enumerate(zip(g_gpu, g_cpu)):
        err = float((a.cpu() - b).abs().max())
        scale = float(b.abs().max())
        errs.append(err)
        if err > TRAIN_RTOL * scale:
            raise AssertionError(f"grad leaf {i} {tuple(b.shape)}: CUDA vs "
                                 f"CPU max abs err {err} > {TRAIN_RTOL} x "
                                 f"{scale}")
    e_loss = abs(float(l_gpu) - float(l_cpu))
    if e_loss > TRAIN_RTOL * abs(float(l_cpu)):
        raise AssertionError(f"loss CUDA {float(l_gpu)} vs CPU "
                             f"{float(l_cpu)}")
    log("train", f"one iteration (T={plan.num_steps}, batch_pad "
                 f"{plan.batch_pad}, r_max {plan.r_max}): loss CUDA "
                 f"{float(l_gpu):.7f} vs CPU {float(l_cpu):.7f} (abs err "
                 f"{e_loss:.3g}); grad leaves max abs err "
                 f"{[float(f'{e:.3g}') for e in errs]} (each within "
                 f"{TRAIN_RTOL} x the leaf's largest |g|); CUDA "
                 f"{t_gpu:.3f} s incl. first calls, CPU {t_cpu:.2f} s")


def phase_train(ds, store, part, cfg, seed: int) -> int:
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 is on; training parity needs it off")
    total = TRAIN_EPOCHS * TRAIN_ITERS
    opt = adamw(cosine_schedule(3e-3, warmup=10, total=total),
                weight_decay=1e-4, grad_clip=1.0,
                key=("cos", 3e-3, 10, total))
    trainer = Trainer(graph=ds.graph, labels=ds.labels, part=part,
                      owner=store.owner, local_idx=store.local_idx,
                      table=store, cfg=cfg, optimizer=opt, init_seed=seed,
                      strategy="hopgnn", pregather=True,
                      train_vertices=ds.train_vertices(), device="cuda")
    log("train", f"hopgnn, pregather, merging {trainer.merging}, pipeline "
                 f"{trainer.pipeline}, {SHARDS} shards on one card, batch "
                 f"{TRAIN_BATCH} per model ({SHARDS * TRAIN_BATCH} global), "
                 f"{trainer.planner_threads} planner threads; tf32 matmul "
                 f"{torch.backends.cuda.matmul.allow_tf32} cudnn "
                 f"{torch.backends.cudnn.allow_tf32}")
    plan = trainer.build_plan(0, 0, TRAIN_BATCH)
    trainer._drain_plan_stats()
    check_gather_rows_train(trainer, plan)
    check_train_grads(trainer, plan, store, cfg)
    del plan

    # the main path: counts are zeroed just before it and read just after
    ga.reset_launches()
    t0 = time.perf_counter()
    stats = trainer.fit(TRAIN_EPOCHS, TRAIN_ITERS,
                        batch_per_model=TRAIN_BATCH)
    wall = time.perf_counter() - t0
    launches = ga.launches["gather_rows"]
    want = sum((cfg.num_layers + 1) * SHARDS * st.num_steps * TRAIN_ITERS
               for st in stats)
    seen, retraces = set(), 0
    for st in stats:
        new = st.num_steps not in seen
        seen.add(st.num_steps)
        if st.epoch > 0:
            retraces += st.traces - int(new)
        log("train", f"epoch {st.epoch}: loss {st.loss:.5f}, merge pattern "
                     f"{st.num_steps} steps{' (new)' if new else ''}, "
                     f"traces {st.traces}, steady "
                     f"{1e3 * st.steady_time_s / TRAIN_ITERS:.2f} ms/iter "
                     f"(synced window), dispatch "
                     f"{1e3 * st.dispatch_s / TRAIN_ITERS:.2f} ms/iter, plan "
                     f"{1e3 * st.plan_time_s / max(st.plans_built, 1):.2f} "
                     f"ms/plan ({st.plans_built} plans, on the prefetch "
                     f"thread), rows fetched {st.remote_rows / TRAIN_ITERS:.1f}"
                     f"/iter, wall {st.time_s:.3f} s")
    log("train", f"fit {TRAIN_EPOCHS}x{TRAIN_ITERS} in {wall:.2f} s; "
                 f"gather_rows launches {launches} (want {want} = "
                 f"(layers+1) x shards x steps per iteration, summed); "
                 f"retraces after epoch 0 beyond one per new merge pattern "
                 f"{retraces}; budget {trainer.budget.signature()} with "
                 f"{trainer.budget.rebuckets} rebuckets; uploads "
                 f"{trainer._uploader.uploads}, shape changes "
                 f"{trainer._uploader.shape_changes}")
    if not all(np.isfinite(st.loss) for st in stats):
        raise AssertionError(f"non-finite loss: {[s.loss for s in stats]}")
    if retraces != 0:
        raise AssertionError(f"{retraces} retraces after epoch 0")
    if launches != want:
        raise AssertionError(f"gather_rows launched {launches} times, "
                             f"want {want}")

    # one more epoch of the same loop, profiled
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(1, thread_name_prefix="prefetch") as pool:
        res = []
        device_profile(lambda: res.append(run_pipelined_epoch(
            trainer, TRAIN_EPOCHS, TRAIN_ITERS, TRAIN_BATCH, pool.submit,
            loss_sync_iters=trainer.loss_sync_iters)), "train",
            TRAIN_ITERS, "iteration")
    log("train", f"profiled epoch: loss {np.mean(res[0].losses):.5f}, "
                 f"merge pattern {res[0].num_steps} steps, traces "
                 f"{res[0].traces}")
    # the dispatch of a built plan with no planning in flight: what the
    # fused step costs the host, and until the device is done with it
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    host, done = [], []
    for i in range(4):
        plan = trainer.build_plan(TRAIN_EPOCHS + 1, i, TRAIN_BATCH)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev[0].record()
        trainer._dispatch([plan])
        host.append(1e3 * (time.perf_counter() - t0))
        ev[1].record()
        torch.cuda.synchronize()
        done.append(ev[0].elapsed_time(ev[1]))
    trainer._close_plan_pool()
    log("train", f"one fused dispatch with no planning in flight (T="
                 f"{plan.num_steps}), after a warm one: host "
                 f"{np.mean(host[1:]):.2f} ms, device done after "
                 f"{np.mean(done[1:]):.2f} ms (CUDA events)")
    del trainer
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# Phase 6: RWKV6 at full width, 2 layers, float32
# ---------------------------------------------------------------------------

def phase_rwkv6_wide(seed: int) -> None:
    """The published width with depth cut to 2 layers, in float32 so the
    comparison is of the algorithm. u is set to small random values, since
    a fresh model's u is 0 and would skip the bonus term."""
    import dataclasses
    cfg = dataclasses.replace(get_config("rwkv6-7b"), num_layers=2,
                              dtype="float32")
    g = torch.Generator(device="cuda").manual_seed(seed)
    params = init_params(cfg, g, "cuda")
    for layer in params["layers"]:
        layer["blk"]["u"] = 0.1 * torch.randn(
            layer["blk"]["u"].shape, generator=g, device="cuda")
    toks = make_batch(cfg, 2, 64, seed=seed)["tokens"]
    la.reset_launches()
    with torch.inference_mode():
        gpu, st_gpu = prefill(params, cfg, {"tokens": toks}, max_seq=80)
        torch.cuda.synchronize()
        if la.launches["linattn"] != cfg.num_layers:
            raise AssertionError(f"prefill launched linattn "
                                 f"{la.launches['linattn']} times")
        cpu_params = _tree_map(lambda t: t.cpu(), params)
        t0 = time.perf_counter()
        cpu, st_cpu = prefill(cpu_params, cfg, {"tokens": toks}, max_seq=80)
        t_cpu = time.perf_counter() - t0
        err = float((gpu.cpu() - cpu).abs().max())
        err_s = max(float((a.s.cpu() - b.s).abs().max())
                    for a, b in zip(st_gpu.caches, st_cpu.caches))
        log("rwkv6", f"{cfg.name} 2 layers f32, B=2 S=64 prefill: CUDA "
                     f"(linattn kernel) vs CPU (plain, {t_cpu:.1f} s): "
                     f"logits max abs err {err} (|logits| up to "
                     f"{float(cpu.abs().max()):.3f}, tolerance {WIDE_TOL}); "
                     f"state max abs err {err_s} (|S| up to "
                     f"{max(float(b.s.abs().max()) for b in st_cpu.caches):.3f}"
                     f", rtol {STATE_RTOL}, atol {STATE_ATOL})")
        if not torch.allclose(gpu.cpu(), cpu, rtol=WIDE_TOL, atol=WIDE_TOL):
            raise AssertionError(f"CUDA prefill differs from the CPU's: max "
                                 f"abs err {err} > {WIDE_TOL}")
        for i, (a, b) in enumerate(zip(st_gpu.caches, st_cpu.caches)):
            if not torch.allclose(a.s.cpu(), b.s, rtol=STATE_RTOL,
                                  atol=STATE_ATOL):
                raise AssertionError(
                    f"layer {i}: CUDA prefill state differs from the CPU's "
                    f"beyond rtol {STATE_RTOL}, atol {STATE_ATOL}")
        last, state = prefill(params, cfg, {"tokens": toks[:, :63]},
                              max_seq=80)
        dl, _ = decode_step(params, cfg, toks[:, 63], state)
        err_d = float((dl - gpu).abs().max())
        log("rwkv6", f"prefill(63 tokens, chunk 63) + decode_step(token 64) "
                     f"vs prefill(64): max abs err {err_d} (tolerance "
                     f"{DECODE_TOL})")
        if not torch.allclose(dl, gpu, rtol=DECODE_TOL, atol=DECODE_TOL):
            raise AssertionError(f"decode after prefill differs from the "
                                 f"longer prefill: {err_d} > {DECODE_TOL}")
    del params, cpu_params, st_gpu, st_cpu, state
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 7: LLM serving, rwkv6-7b at full width and depth, bfloat16
# ---------------------------------------------------------------------------

def phase_llm(seed: int) -> int:
    cfg = get_config("rwkv6-7b")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(seed),
                         "cuda")
    torch.cuda.synchronize()
    sizes = []
    _tree_map(lambda t: sizes.append(t.numel()), params)
    n_par = sum(sizes)
    log("llm", f"{cfg.name}: {cfg.num_layers} layers, d_model "
               f"{cfg.d_model}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
               f"{n_par} parameters in {cfg.dtype} drawn on the card in "
               f"{time.perf_counter() - t0:.2f} s; "
               f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    srv = LLMServer(params, cfg, gen_tokens=GEN_TOKENS, max_batch=LLM_BATCH,
                    device="cuda")
    rng = np.random.default_rng(seed)
    toks = make_batch(cfg, 64, 2048, seed=seed)["tokens"].numpy()
    lengths = rng.integers(128, 2049, 64)
    prompts = [toks[i, :n] for i, n in enumerate(lengths)]
    # one request first, so the stream does not carry cuBLAS's start-up
    warm = srv.submit(prompts[0][:128])
    srv.pump(wait_s=0.0)
    warm.wait(600.0)

    # the main path: counts are zeroed just before it and read just after
    la.reset_launches()
    ga.reset_launches()
    before = srv.stats()
    torch.cuda.reset_peak_memory_stats()
    srv.start()
    try:
        t_start = time.perf_counter()
        tickets = [srv.submit(p) for p in prompts]
        results = [t.wait(600.0) for t in tickets]
        wall = time.perf_counter() - t_start
    finally:
        srv.stop()
    launches = la.launches["linattn"]
    st = srv.stats()
    batches = st["batches"] - before["batches"]
    buckets = {f"{b}x{s}": c - before["buckets"].get((b, s), 0)
               for (b, s), c in st["buckets"].items()
               if c > before["buckets"].get((b, s), 0)}

    for r in results:
        if r.shape != (GEN_TOKENS,) or r.dtype != np.int32 \
                or not ((0 <= r) & (r < cfg.vocab_size)).all():
            raise AssertionError(f"malformed result {r!r}")
    if st["errors"] != 0:
        raise AssertionError(f"{st['errors']} serving errors")
    if batches == 0 or launches < cfg.num_layers * batches:
        raise AssertionError(f"linattn launched {launches} times for "
                             f"{batches} batches")
    if ga.launches != {"gather_rows": 0, "gather_agg": 0}:
        raise AssertionError(f"the LLM path launched {ga.launches}")
    lat = np.array([1e3 * t.latency_s() for t in tickets])
    log("llm", f"64 prompts (lengths {int(lengths.min())}..."
               f"{int(lengths.max())}, {int(lengths.sum())} tokens) submitted "
               f"at once: {batches} batches, buckets {buckets}, "
               f"{64 * GEN_TOKENS} tokens generated in {wall:.3f} s = "
               f"{64 * GEN_TOKENS / wall:.1f} tokens/s; latency p50 "
               f"{np.percentile(lat, 50):.1f} ms p99 "
               f"{np.percentile(lat, 99):.1f} ms; peak memory "
               f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
               f"linattn launches {launches} ({launches // batches} per "
               f"batch); errors {st['errors']}")
    llm_timings(params, cfg, sorted({s for (_, s) in st["buckets"]}), seed)
    del params, srv
    torch.cuda.empty_cache()
    return launches


def _tree_map(fn, node):
    """``fn`` over every tensor of a parameter tree of dicts and lists."""
    if isinstance(node, dict):
        return {k: _tree_map(fn, v) for k, v in node.items()}
    if isinstance(node, list):
        return [_tree_map(fn, v) for v in node]
    return fn(node)


def llm_timings(params, cfg, seq_buckets: list, seed: int) -> None:
    """Prefill time per sequence bucket at batch 8 and decode time per
    step (CUDA events, after a warm call), then one generate at the largest
    bucket under torch.profiler: device busy share and time by kernel."""
    toks = make_batch(cfg, LLM_BATCH, max(seq_buckets), seed=seed + 1)[
        "tokens"].cuda()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    with torch.inference_mode():
        for sp in seq_buckets:
            batch = {"tokens": toks[:, :sp]}
            prefill(params, cfg, batch, max_seq=sp + 24)
            ev[0].record()
            _, state = prefill(params, cfg, batch, max_seq=sp + 24)
            ev[1].record()
            torch.cuda.synchronize()
            ms = ev[0].elapsed_time(ev[1])
            log("llm", f"prefill {LLM_BATCH}x{sp}: {ms:.2f} ms "
                       f"({LLM_BATCH * sp / ms * 1e3:.0f} prompt tokens/s)")
        tok = toks[:, 0]
        decode_step(params, cfg, tok, state)
        steps = 8
        ev[0].record()
        for _ in range(steps):
            _, state = decode_step(params, cfg, tok, state)
        ev[1].record()
        torch.cuda.synchronize()
        ms = ev[0].elapsed_time(ev[1]) / steps
        log("llm", f"decode_step at batch {LLM_BATCH}: {ms:.2f} ms per step "
                   f"({LLM_BATCH / ms * 1e3:.0f} tokens/s)")
        batch = {"tokens": toks[:, :max(seq_buckets)]}
        log("llm", f"profiled generate {LLM_BATCH}x{max(seq_buckets)} + "
                   f"{GEN_TOKENS} tokens:")
        device_profile(lambda: generate(
            params, cfg, batch, GEN_TOKENS,
            max_seq=max(seq_buckets) + GEN_TOKENS + 8), "llm", 1, "generate")


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
    ds, store, cfg, part = build_world(args.seed)
    ws, hops = rung64_workspace(ds, store, cfg, args.seed + 1)
    kernels = [check_gather_rows(ws, hops, args.seed),
               check_gather_agg(ws, hops), check_linattn(args.seed)]
    del ws, hops
    by_path = {k["name"]: {} for k in kernels}
    for name, n in phase_serve(ds, store, cfg, args.seed, args.requests,
                               args.qps).items():
        by_path[name]["gnn_serve"] = n
    by_path["gather_rows"]["gnn_train"] = phase_train(ds, store, part, cfg,
                                                      args.seed)
    del ds, store
    phase_rwkv6_wide(args.seed)
    by_path["linattn"]["llm_serve"] = phase_llm(args.seed)
    for k in kernels:
        k["launches"] = sum(by_path[k["name"]].values())
        k["launches_by_path"] = by_path[k["name"]]
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
