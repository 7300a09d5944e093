#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

Drives the port's serving paths (GNN; RWKV6, dense, MoE, the RG-LRU
hybrid, the vlm and audio transformers), its GNN training path
(resident, streamed from disk, over a device mesh, and the P³ baseline)
and its transformer training path end to end on the card, and
holds every kernel it builds against its plain PyTorch version. Imports
nothing of JAX and nothing of the JAX package. Phases (any failure ends
the run with a non-zero exit and no result line):

  1. build    nvcc builds src/repro_torch/kernels/csrc/gather_agg.cu,
              csrc/linattn.cu, csrc/sample_tree.cu and csrc/plan_dedup.cu
              for sm_90a into
              build/repro_torch_kernels/ (git-ignored), all at once, and
              prints one line per kernel
              instance: registers, static shared memory, stack and spills.
              A gather_agg instance that spills fails the run.
  2. kernels  gather_rows at every hop of a batch_pad=64 serve rung (the
              workspace and tree positions of a real micro-batch) and at an
              odd (33, 96) shape, bitwise against its plain version;
              gather_agg, each instance (fanout 10's and the generic one)
              and word width against its plain version, sum and max
              bitwise and mean within one ulp of the plain version's
              value: f in 1, 3, 4, 10, 25, 40, d in 1, 96, 100, 130,
              float32 and bfloat16, base pointers aligned, shifted by a
              row and by one element, n 1 and 301, NaNs in the max rows;
              then at the serve shape (the rung-64 workspace, hop 3's
              positions as (6,400, 10) neighbour lists); linattn at the
              RWKV6 prefill's shapes (BH = 8·64, dk = dv = 64, T 256 and
              2048, chunk 64, the latter also with RWKV-like decays; T 24 at
              chunk 24 and chunk 1; T 126 at chunk 63), a ragged dv (48),
              and odd shapes (BH 3, T 128, dk 32; BH 5, T 96, dk 30, dv 45,
              chunk 32), with a nonzero u and w in (0.5, 1], within 5e-4 of
              its plain version, and once against the token scan; then at a
              constant w = 0.45, below its domain (BH 2, T 128, dk = dv =
              16, chunk 16 and 64; BH 512, T 2048, dk = dv = 64, chunk 64),
              against its plain version within 5e-4 where both are finite,
              the non-finite positions of each printed. Each
              kernel's device time (calls captured in a CUDA graph, timed
              with CUDA events) stands beside its plain version's, one
              PyTorch call that computes the same function where there is
              one (a yardstick the port never calls), its bound, and its
              cost per call from the host; gather_agg's beside its first
              design's (PERF.md). linattn's bound counts its products in
              3xTF32 at the TF32 tensor-core peak. gather_agg runs on no
              path, as in the JAX package: it is only gated and timed, here
              and at the training and P3 shapes, outside every window that
              counts launches. sample_tree on a train-sage-products plan
              (1,024 roots, 3 hops of fanout 10, 1,137,664 ids) over a
              random CSR of that cell's size with degree-0 vertices:
              bitwise the host sampler and its plain version on the card,
              then the three launches' device time beside the plain
              version's and the bound, the planner's whole call (launches,
              copy to pinned memory, sync) and the host sampler's 16 jobs.
              plan_dedup on a plan of each cell (16 jobs of 64 roots
              padded to 128, 3 hops of fanout 10) over a random CSR of the
              cell's size, 4 shards: bitwise build_gather_plan and
              workspace_indices and its plain version on the card, the
              dedup's and the translation's device time beside the plain
              version's and the bound, the planner's whole call from the
              host beside the host path's, and the launches of one plan
              pass.
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
              merging, the async pipeline, resilience off, batch 256 per
              model = 1024 global, AdamW with a cosine schedule as
              examples/train_hopgnn.py): gather_rows at the four hops of
              one (shard, step) of a real plan, bitwise and timed, and
              gather_agg on its workspace with hop 3's positions as
              (12,800, 10), gated and timed as in phase 2; one
              iteration's loss and every grad leaf on CUDA against the
              port on the CPU (plain gather_rows) within 1e-4 of each
              leaf's largest value; then fit for 2 epochs of 8 iterations,
              gating finite losses, no retraces after epoch 0 beyond one
              per new merge pattern, gather_rows launched once per
              (shard, step, hop) of every iteration, sample_tree three
              times per plan pass and plan_dedup four dedup launches per
              plan pass (three in one that overflows its r_max) and one
              translation per hop. Prints losses, steady
              ms/iter, dispatch and plan ms/iter, rows fetched per
              iteration, and one more epoch under torch.profiler (device
              busy share, time by kernel). TF32 stays off.
  ckpt        checkpoints, resilience, membership and the precomputed
              tier on the same world and model (merging off, so the run is
              a pure function of its seeds; 3 epochs x 6 iterations, batch
              256 per model, the default resilience policy): a straight
              run writing checkpoints under build/ (git-ignored); the same
              run under injected faults (a prefetch-thread death, a comm
              delay and drop, a NaN step, a peer death recovered by
              rejoin), gated bitwise against it with exactly one rollback
              and one membership recovery; a fresh Trainer resuming from
              the straight run's epoch-1 checkpoint, gated bitwise, with
              no new signature; precompute_embeddings over all 245,000
              vertices (chunk 256: 958 chunks, gather_rows 958 x 4),
              gated against the CPU forward at 256 vertices and for its
              staleness refusal; then GNNServer(ckpt_dir, mode="auto")
              under the phase 3 stream, gating precomputed hits, fresh
              gather_rows launches, zero retraces and errors, and 256
              answers against the table (bitwise) or the CPU forward.
              Prints steady ms/iter, each recovery's cost, checkpoint
              save/load ms and bytes, precompute time split into host
              plan and forward, and the served rate, p50/p99 and share
              answered from the table.
  p3          the P³ baseline on the same world and model: one
              run_p3_iteration (the input layer over 4 slices of the
              feature dims, each hop's rows gathered once per shard from the
              full table with gather_rows) on the same roots as one
              model-centric and one hopgnn iteration. Gates its grads on
              CUDA against the port's P³ on the CPU (1e-4 of each leaf's
              largest value) and against model-centric on the card (rtol
              2e-3, atol 2e-5, tests/test_core.py), the losses within 1e-4,
              gather_rows bitwise at the P³ hop sizes, and (layers+1) x
              shards launches; gather_agg on the full table with shard 0's
              hop 3 as (25,600, 10), gated and timed as in phase 2.
              Prints time per iteration of P³ and hopgnn (CUDA events, and
              device busy time under the profiler), and the comm_model
              bytes of model_centric, naive_fc, hopgnn, p3 and lo with
              P3Plan.activation_bytes.
  stream      streamed (out-of-core) training: the features spilled to
              per-shard .npy files under build/ with a host hot tier of a
              third of the table and checksums on; three runs of 3 epochs x
              6 iterations with merging off — resident, streamed (spans on)
              and streamed under the reference's whole
              FaultPlan.recoverable(seed=3), disk_corrupt included. Gates
              the streamed run bitwise against the resident one and the
              faulted one against it (5 kinds fired, 1 rollback, a crc
              failure repaired), tier-1 rows from epoch 1 on, no new
              signature after epoch 0, gather_rows launched once per
              (shard, step, hop), and the exported Chrome trace valid with
              the main, prefetch, uploader and cache+readahead tracks.
              Prints per-epoch steady ms/iter, plan ms, tier rows and bytes
              and upload bytes per plan, and one profiled epoch.
  mesh        LeapGNN training over a real device mesh. In the default run
              (world size 1): a 1-rank NCCL process group in this process
              (rendezvous through a FileStore under build/), the products
              world in one shard; a zero-size exchange (r_max 0) through
              ShardComm; one iteration per mode (pregather, per-step,
              per-step folded) through run_iteration(mesh=...) bitwise the
              emulated one, with the collectives it ran (all_to_all 2, T+1
              and 2, one all_reduce); Trainer(mesh=...) 2 epochs x 6
              iterations (merging off, resilience on) bitwise the emulated
              Trainer, gather_rows launched (layers+1) x T per iteration,
              no new signature after epoch 0. Prints gather_rows at rank
              0's hops, one built plan's iteration sharded and emulated
              (CUDA events), NCCL and other device time per iteration
              under torch.profiler, and the bytes each collective moved
              beside comm_model's. With --world N (N cards, one spawned
              rank each; only the build and this phase run): phase 5's
              world N-way partitioned; each mode's iteration within 1e-5 of
              the emulated one on rank 0's card; the collectives; a 3 x 6
              fit against the emulated Trainer (rtol 1e-5), parameters
              bitwise equal across ranks (all_gather of checksums),
              gather_rows per rank; with merging on, the same merge
              patterns on every rank; [ckpt]'s faults but the peer death,
              bitwise the straight sharded run; then the measurements
              above. Every gate is agreed across ranks, so they fail
              together.
  dryrun      LeapGNN's pod dry run: python -m repro_torch.launch.dryrun_gnn
              and the same with --multi-pod, each its own process (one
              default process group per process), at the reference's
              default shapes (SAGE 3 x 128, fanout 10, d 600, batch_pad 8,
              16,384 local rows, r_max 2048): rank 0 of a fake 256- or
              512-rank world runs its shard body on the card, T = n steps.
              Reads each record under build/dryrun_torch/ and prints the
              [ok] line, the per-rank census of collectives, memory, FLOPs,
              rank 0's iteration time by CUDA events and the kernel
              launches; gates the census against ShardComm's own bytes and
              the closed form (all_to_all n*r_max*4 + n*r_max*d*4, the
              all_reduce equal to the gradients plus the loss) and
              gather_rows launched (layers+1) x T times in the measured
              call. A process that fails fails the run. Then gather_rows at
              one (shard, step)'s 4 hops on the 256-shard workspace
              (540,672 x 600), bitwise and timed; and the dry run at world 8
              with narrowed shapes on the card and on the CPU, loss and
              every grad leaf within 1e-5 of the leaf's largest value.
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
  lm-wide     qwen2-1.5b at its published width, 2 layers, float32 (QKV
              biases random): forward logits at B=2 S=256 on CUDA against
              the port on the CPU, and prefill(256) + 8 decode steps
              against the full forward on the card; h2o-danube-3-4b the
              same way with a 4,608-token prompt, past its 4,096-token
              window, so the KV ring wraps; loss_fn's loss and every grad
              leaf at B=2 S=256, CUDA against the CPU, for qwen2-1.5b and
              rwkv6-7b (2 layers), with no linattn launch (training
              differentiates the plain chunked version). Then the other
              families at their published widths, 2 layers
              (recurrentgemma-9b 3, one period), f32, every bias and
              RG-LRU's Λ random: logits CUDA vs CPU for deepseek-moe-16b
              and qwen2-moe-a2.7b (4 x 128), recurrentgemma-9b, pixtral-12b
              (64 patches before 192 tokens) and whisper-base (1,500
              frames); prefill + 8 decode steps vs the forward for
              qwen2-moe (capacity factor 8: a drop is a training
              artifact), recurrentgemma past its 2,048 window (2,304
              tokens), pixtral with its 66-patch prefix and whisper;
              loss_fn's loss, aux and every grad leaf, CUDA vs CPU, for
              deepseek-moe and recurrentgemma. Each within 1e-4 of the
              largest |value|. MoE routing first: each token's top-k
              experts and each row's kept slots, card vs CPU; a token
              whose experts differ (a near-tie of the float32 router
              summed in another order) must have a margin p_j - p_(j+1)
              below 1e-5, its row leaves the comparison, and all rows but
              one must agree.
  lm-dryrun   the transformer pod dry run. In a child process, a 1-rank
              NCCL group and a (1, 1) ("data", "model") mesh: one train
              step and the prefill logits of qwen2-1.5b at full width, 2
              layers, f32, its parameters, AdamW state and batch placed as
              DTensors by launch/sharding.py with the sharding hints and
              the FSDP gather active, against the same step on plain
              tensors: loss, logits and every parameter bitwise. Then
              python -m repro_torch.launch.dryrun --device cuda for each
              combo of LM_DRYRUNS, all at once (a train, a prefill and
              decode combos; both meshes; MoE): rank 0 of a fake 256- or
              512-rank world traces the step on meta tensors. Per record:
              status, argument/output/temp bytes, rank 0's FLOPs and the
              whole mesh's, the census; gates status ok, the census equal
              to CommDebugMode's (above 0 for a train step), the argument
              bytes equal to the closed form from the specs and global
              shapes (rank 0's torch.chunk share of each leaf), and no
              kernel launched.
  llm-dense   phase 7 with qwen2-1.5b at its published size (28 layers,
              bf16, random weights): 32 prompts (half phase 7's 64, so
              the whole run stays within 560 s) and the same measurements;
              gates zero launches of every kernel (the dense path runs no
              TPU kernel).
  llm-moe     phase 7 with deepseek-moe-16b at its published size (28
              layers, 64 routed experts top-6 + 2 shared, bf16, 31.4 GiB):
              16 prompts, the same measurements, each layer's MoEStats
              (HopMoE mode, dispatch and weight bytes, dropped share) at
              the largest prefill bucket and at decode; zero launches.
  llm-hybrid  the same with recurrentgemma-9b (38 layers: 12 periods of
              rec, rec, attn and two rec; MQA, head dim 256, bf16): 16
              prompts of 128..3,072 tokens, past its 2,048-token local
              window; zero launches.
  llm-mm      generate() at the published size on pixtral-12b (2 x 1,024
              patches of 1,024 before 3,072 tokens) and whisper-base (8 x
              1,500 frames and a 64-token prompt), 16 tokens each: tokens in
              the vocabulary, zero launches; time, tokens/s, prefill and
              decode ms, peak memory.
  lm-train    the CUDA linattn refusing a q that requires grad; one accum-2
              step against the accum-1 step on the 2-layer full-width
              qwen2-1.5b in float32 (loss and accumulated grads within
              1e-5, parameters at the reference's rtol 2e-3, atol 2e-5);
              make_train_step with pick_optimizer's AdamW on token_batches:
              qwen2-1.5b at full size (bf16, f32 moments), 6 steps at
              batch 4 x 1,024, and rwkv6-7b at full width and 8 of its 32
              layers (all 32 with their grads and f32 moments would take
              about 90 GB), 4 steps at 2 x 1,024, and deepseek-moe-16b at
              4 of its 28 layers (all 28 with f32 moments would take about
              200 GB), 4 steps at 2 x 1,024. Gates finite losses, an aux
              loss finite and > 0 on every MoE step, and zero kernel
              launches; prints ms/step, tokens/s, 6*N*tokens/s (N_active
              for MoE) against the bf16 dense peak and peak memory, with
              the card, and one more step of each under torch.profiler
              (device busy share, time by kernel).

Output: one line per measurement; then the kernels' JSON line (launches
summed over the paths, per path under ``launches_by_path`` (the dry
runs' as gnn_dryrun_256 and gnn_dryrun_512, counted in their own
processes over the measured call, and the transformer's as lm_dryrun,
the (1, 1) step's and each record's launches), the
transformer phases' paths with 0 where no kernel runs; sample_tree's on
every GNN path, held to 3 per plan pass on each Trainer's fit (its
budget's probes, plans built and overflowed passes; the ckpt, stream
and mesh phases' runs under their own path names) and to 0 on serving,
precompute, P3 and the dry runs; gather_agg's
timings at the P3 shape, every shape's under ``shapes``; with --world
N, the mesh phase's summary instead, where every rank's straight,
merging and faulted fits hold sample_tree to 3 per plan pass; plan_dedup's
on every path of this process, dedup and translation launches summed,
and its timings at both cells' plan sizes under ``cells``), the card's
name and power limit,
and last ``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py [--requests 4096] [--qps 1000] [--seed 0]
    python3 chip_smoke.py --world 4        # on four cards
    python3 chip_smoke.py --lm-only        # build, linattn, phases 6, 7,
                                           # lm-wide, lm-dryrun, llm-dense,
                                           # llm-moe, llm-hybrid, llm-mm,
                                           # lm-train
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import datetime
import gc
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import distributed as engine  # noqa: E402
from repro_torch.core import (plan_inference, plan_iteration,  # noqa: E402
                              plan_p3, run_p3_iteration)
from repro_torch.core.pregather import (build_gather_plan,  # noqa: E402
                                        workspace_indices)
from repro_torch.core.strategies import DeviceTrees  # noqa: E402
from repro_torch.core.comm_model import (FABRICS, ModelSpec,  # noqa: E402
                                         hopgnn_bytes, lo_bytes,
                                         model_centric_bytes, naive_fc_bytes,
                                         p3_bytes)
from repro_torch.data import make_batch, token_batches  # noqa: E402
from repro_torch.features import FeatureStore  # noqa: E402
from repro_torch.graph import make_dataset  # noqa: E402
from repro_torch.graph.partition import (community_partition,  # noqa: E402
                                         local_index_map, shard_features)
from repro_torch.graph.sampler import (micrograph_split,  # noqa: E402
                                       sample_tree_block)
from repro_torch.graph.structs import CSRGraph  # noqa: E402
from repro_torch.kernels import gather_agg as ga  # noqa: E402
from repro_torch.kernels import linattn as la  # noqa: E402
from repro_torch.kernels import plan_dedup as pd  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import sample_tree as sk  # noqa: E402
from repro_torch.launch import dryrun_gnn  # noqa: E402
from repro_torch.launch.serve import LLMServer, generate  # noqa: E402
from repro_torch.launch.train import (accumulated_grads,  # noqa: E402
                                      make_train_step, pick_optimizer,
                                      value_and_grad)
from repro_torch.models.gnn import GNNConfig, gnn_forward, init_gnn  # noqa: E402
from repro_torch.models.gnn.models import model_param_bytes  # noqa: E402
from repro_torch.models.transformer import (decode_step,  # noqa: E402
                                            forward, forward_hidden,
                                            init_params, prefill)
from repro_torch.models.transformer.model import _head_matrix  # noqa: E402
from repro_torch.models.transformer.moe import (_alpha_mode,  # noqa: E402
                                                moe_capacity)
from repro_torch.obs import trace  # noqa: E402
from repro_torch.obs.export import (export_chrome_trace,  # noqa: E402
                                    run_manifest, trace_track_names,
                                    validate_chrome_trace)
from repro_torch.checkpoint import (load_checkpoint,  # noqa: E402
                                    save_checkpoint)
from repro_torch.optim import (adamw, cosine_schedule,  # noqa: E402
                               tree_leaves)
from repro_torch.resilience import FaultPlan, FaultSpec  # noqa: E402
from repro_torch.serve import (GNNServer, load_embeddings,  # noqa: E402
                               precompute_embeddings)
from repro_torch.train import Trainer  # noqa: E402
from repro_torch.train.budget import next_bucket  # noqa: E402
from repro_torch.train.pipeline import run_pipelined_epoch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory (data sheet)
F32_FLOP_PER_S = 67e12             # H100 SXM float32 outside tensor cores
TF32_FLOP_PER_S = 495e12           # H100 SXM TF32 tensor cores, dense
BF16_FLOP_PER_S = 989e12           # H100 SXM bf16 tensor cores, dense
SRC = "src/repro_torch/kernels/csrc/gather_agg.cu"
ST_SRC = "src/repro_torch/kernels/csrc/sample_tree.cu"
PD_SRC = "src/repro_torch/kernels/csrc/plan_dedup.cu"
# [kernels] plan_dedup: a plan of each cell (16 (shard, step) jobs of 64
# roots, batch_pad 128, 3 hops of fanout 10) over a random CSR of the
# cell's size, 4 shards by runs of vertices with a fifth strayed at random
DEDUP_CELLS = {"train-sage-products": (2_449_029, 52.11 / 0.9),
               "train-gat-uk": (10_000_000, 23.59 / 0.9)}
DEDUP_JOBS, DEDUP_BATCH_PAD = 16, 128
# [kernels] sample_tree: a train-sage-products plan (4 models x 256 roots,
# 3 hops of fanout 10) over a random CSR of that cell's size: its 52.11
# entries per vertex, with a tenth of the vertices at degree 0
SAMPLE_V, SAMPLE_DEG, SAMPLE_ROOTS, SAMPLE_JOBS = (2_449_029, 52.11 / 0.9,
                                                  1024, 16)
LA_SRC = "src/repro_torch/kernels/csrc/linattn.cu"
LA_TOL = 5e-4      # tests/test_kernels.py: chunked kernel vs plain, f32
# a constant decay below linattn's domain (0.5, 1], and the shapes it is
# checked at: tests/test_torch_linattn.py's (BH, T, dk, dv, chunk) and the
# RWKV6 prefill's
LA_OUTSIDE_W = 0.45
LA_OUTSIDE_CASES = ((2, 128, 16, 16, 16), (2, 128, 16, 16, 64),
                    (512, 2048, 64, 64, 64))
WIDE_TOL = 1e-3    # full-width 2-layer f32 prefill, CUDA vs CPU
# Its returned state S, CUDA vs CPU: measured max abs err 2.1e-4 on |S| up
# to 168 (H100), so an absolute floor plus a share of |S|.
STATE_RTOL, STATE_ATOL = 1e-4, 1e-3
DECODE_TOL = 5e-3  # prefill + decode vs prefill, tests/test_arch_smoke.py
LLM_BATCH = 8
GEN_TOKENS = 16
# gather_agg's first design (one warp per row, one element per lane): mean
# at the serve shape (n 6,400, f 10, d 100, f32) on an NVIDIA H100 80GB HBM3
# at 700 W (PERF.md section 6)
AGG_FIRST_MS = 0.00933
AGG_FANOUT = 10    # layer-0 child aggregation: hop 3's positions as (n, 10)
# the extended gate: every instance (fanout 10's and the generic one) and
# word width (16, 8, 4, 2 B) of the kernel
AGG_CASE_FANOUTS = (1, 3, 4, 10, 25, 40)
AGG_CASE_WIDTHS = (1, 96, 100, 130)
AGG_CASE_ROWS = (1, 301)   # 301: a multiple of no block's row count
CPU_TOL = 1e-4     # served (GPU, f32) vs CPU forward: summation order only
CACHE_BYTES = 32 << 20
MAX_BATCH = 64
SHARDS = 4
TRAIN_EPOCHS, TRAIN_ITERS, TRAIN_BATCH = 2, 8, 256   # batch per model
# one iteration's grads, CUDA vs CPU, per leaf: max abs err within this
# share of the leaf's largest |value| (summation order only)
TRAIN_RTOL = 1e-4
CKPT_EPOCHS, CKPT_ITERS = 3, 6
PRECOMPUTE_CHUNK = 256
DEVICE = "cuda"    # the device of the p3 and stream phases
P3_SAMPLE_SEED = 7
P3_TOL = dict(rtol=2e-3, atol=2e-5)   # tests/test_core.py: P3 vs MC grads
STREAM_EPOCHS, STREAM_ITERS = 3, 6
MESH_EPOCHS, MESH_ITERS = 2, 6     # the world-1 fit
MESH4_EPOCHS = 3                   # world > 1: faults in epochs 1 and 2
MESH_MODES = (("pregather", True, None), ("per-step", False, False),
              ("per-step folded", False, True))
# sharded vs emulated, one iteration's loss and grads: the reference's own
# bound (tests/test_distributed.py, shard_map against its emulation)
MESH_TOL = 1e-5
MESH_FIT_RTOL = 1e-5   # fit losses, sharded vs emulated (summation order)
MESH_TIMEOUT_S = 600   # a collective that waits longer fails the run
DRYRUN_TIMEOUT_S = 300     # one dry-run process; it is killed past this
# [dryrun] world 8, card vs CPU: loss and every grad leaf within this share
# of the leaf's largest |value| (summation order only)
DRYRUN_TOL = 1e-5
# [lm-wide]: CUDA vs CPU logits and grads, and decode vs the full forward,
# each within this share of the largest |value| (summation order only)
LM_TOL = 1e-4
# loss_fn's grads CUDA vs CPU, per leaf: RWKV6's sums run through the
# chunked decays, and at full width one leaf's error reached 1.64e-4 of
# its max |g| on an H100 80GB HBM3 at 700 W (PERF.md §6)
GRAD_TOL = {"dense": LM_TOL, "ssm": 5e-4, "moe": LM_TOL, "hybrid": LM_TOL}
DANUBE_PROMPT = 4608   # past h2o-danube-3-4b's 4096-token window: a ring
HYBRID_PROMPT = 2304   # past recurrentgemma-9b's 2048-token local window
# an expert choice that differs between the card and the CPU is a near-tie
# of the float32 router's probabilities: its margin must be below this
MOE_FLIP_MARGIN = 1e-5
# [lm-train]: accum 2 vs accum 1. The loss within ACCUM_TOL (relative) and
# the accumulated grads within ACCUM_GRAD_TOL of each leaf's max |g|
# (measured 9.6e-6 on an H100 80GB HBM3 at 700 W, PERF.md §6). The
# parameters after the AdamW step within ACCUM_TOL of each leaf's max
# |value| at the
# elements whose clipped |g| is at least ACCUM_MIN_G, 100x AdamW's eps:
# the first step moves an element by lr*g/(|g| + 1e-8), so below that the
# float32 differences of g become moves of a sizable share of lr
# (measured 4.9e-3 of a leaf's max over all elements)
ACCUM_TOL = 1e-5
ACCUM_GRAD_TOL = 5e-5
ACCUM_MIN_G = 1e-6
RWKV_TRAIN_LAYERS = 8  # of 32: params, grads and f32 moments of all 32
#                        would take about 90 GB
MOE_TRAIN_LAYERS = 4   # of deepseek-moe-16b's 28 (about 2.8B parameters):
#                        all 28 with f32 moments would take about 200 GB
MM_VLM_BATCH = 2       # pixtral-12b prompts of 1,024 patches + 3,072 tokens
NEW_LLM_PROMPTS = 16   # prompts served in [llm-moe] and [llm-hybrid] (32
#                        until [lm-dryrun] joined the run)
DENSE_LLM_PROMPTS = 32     # [llm-dense]: half phase 7's 64, so the whole
#                            run, [lm-dryrun] included, stays within 560 s
HYBRID_MAX_PROMPT = 3072   # [llm-hybrid]: prompts past the 2,048 window


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def free_card() -> None:
    """Release the card's memory of what a phase dropped: a collection
    first, since a server and its batching loop refer to each other, so
    its parameters outlive ``del`` until the collector runs."""
    gc.collect()
    torch.cuda.empty_cache()


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

def ptxas_summary(msgs: str) -> list:
    """Per kernel, from ``nvcc -Xptxas -v``: registers, static shared
    memory, stack and spill bytes, names demangled with the toolkit's
    cu++filt where it has one."""
    import re
    kernels, cur = [], None
    for line in msgs.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = dict(name=m.group(1), registers=0, smem=0, stack=0,
                       spill_stores=0, spill_loads=0)
            kernels.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur["stack"], cur["spill_stores"], cur["spill_loads"] = map(
                int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(m.group(1)) if m else 0
    for k in kernels:
        k["spills"] = k["spill_stores"] + k["spill_loads"]
    filt = shutil.which("cu++filt") or os.path.join(
        os.path.dirname(shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"),
        "cu++filt")
    if kernels and os.path.exists(filt):
        out = subprocess.run([filt], input="\n".join(k["name"]
                                                     for k in kernels),
                             capture_output=True, text=True, timeout=60)
        names = out.stdout.splitlines()
        if out.returncode == 0 and len(names) == len(kernels):
            for k, name in zip(kernels, names):
                name = re.sub(r"\((?:bool|int)\)|\(anonymous namespace\)::"
                              r"|<unnamed>::", "", name)
                k["name"] = name.split(">(")[0].removeprefix("void ") + ">" \
                    if ">(" in name else name.split("(")[0]
    return kernels


def phase_build() -> None:
    """Every library at once: one nvcc per source, started together."""
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.perf_counter()
    with ThreadPoolExecutor(4) as pool:
        futs = [pool.submit(mod.build, True) for mod in (ga, la, sk, pd)]
        built = [f.result() for f in futs]
    spilled = []
    for path, msgs in built:
        kernels = ptxas_summary(msgs)
        log("build", f"{os.path.relpath(path, ROOT)} built: {len(kernels)} "
                     f"kernels, {sum(k['spills'] > 0 for k in kernels)} "
                     f"with spills")
        for k in kernels:
            log("build", f"  {k['name']}: {k['registers']} registers, "
                         f"{k['smem']} B static smem, {k['stack']} B stack, "
                         f"spill stores {k['spill_stores']} B, loads "
                         f"{k['spill_loads']} B")
            if "gather_agg_kernel" in k["name"] and k["spills"]:
                spilled.append(k["name"])
    log("build", f"all libraries in {time.perf_counter() - t0:.2f} s; "
                 f"linattn takes {la.smem_bytes()} B of dynamic shared "
                 f"memory per block")
    if spilled:
        raise AssertionError(f"gather_agg instances spill: {spilled}")


# ---------------------------------------------------------------------------
# Phase 2: kernels vs plain versions
# ---------------------------------------------------------------------------

def time_gather_rows(phase: str, what: str, ws: torch.Tensor,
                     hop_idx: list, host: bool = False) -> dict:
    """gather_rows at each hop of a real workspace: bitwise against its
    plain version, then its device time beside the plain version's,
    index_select's and its bound (and, with ``host``, its cost per call
    from the host). Returns the sums over the hops."""
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
    for h, idx in enumerate(hop_idx):
        if not torch.equal(ga.gather_rows(ws, idx),
                           ref.gather_rows_ref(ws, idx)):
            raise AssertionError(f"gather_rows differs from plain at {what} "
                                 f"hop {h}")
        ms = device_ms(lambda: ga.gather_rows(ws, idx))
        pms = device_ms(lambda: ref.gather_rows_ref(ws, idx))
        lms = device_ms(lambda: torch.index_select(ws, 0, idx))
        per_call = (f"; per call from the host "
                    f"{call_ms(lambda: ga.gather_rows(ws, idx)):.5f} ms"
                    if host else "")
        nbytes = moved_bytes(ws, idx, idx.numel())
        b, _ = bound_ms(nbytes)
        log(phase, f"gather_rows {what} hop {h}: table {tuple(ws.shape)} "
                   f"f32, n={idx.numel()}: device {ms:.5f} ms (plain "
                   f"{pms:.5f}, index_select {lms:.5f}){per_call}; moves "
                   f"{nbytes} B, bound {b:.5f} ms; bitwise equal")
        for k, v in zip(tot, (ms, pms, lms, b)):
            tot[k] += v
    return tot


def check_gather_rows(ws: torch.Tensor, hop_idx: list, seed: int) -> dict:
    tot = time_gather_rows("kernels", "serve", ws, hop_idx, host=True)
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


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit for bit, NaNs and signed zeros included."""
    as_int = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.view(as_int[a.dtype]), b.view(as_int[b.dtype]))


def ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of x's dtype at each element of x (at 0, that just
    below 1)."""
    _, e = torch.frexp(x.float())
    eps = torch.full_like(x, torch.finfo(x.dtype).eps, dtype=torch.float32)
    return torch.ldexp(eps, e - 1)


def agg_gate(table: torch.Tensor, nbr: torch.Tensor, reduce: str,
             what: str) -> float:
    """gather_agg against its plain version on the same inputs: sum and max
    bit for bit (the same adds in the same order, no FMA, the same cast),
    mean within one ulp of the plain version's value (which may divide by
    the fanout as a multiply by its reciprocal where the kernel divides;
    one ulp is inside tests/test_kernels.py's 1e-5 for float32 and 2e-2
    for bfloat16). Returns the max abs err (0 where bitwise)."""
    out = ga.gather_agg(table, nbr, reduce)
    want = ref.gather_agg_ref(table, nbr, reduce)
    if reduce != "mean":
        if not same_bits(out, want):
            raise AssertionError(f"gather_agg {reduce} {what}: not bitwise "
                                 f"equal to its plain version")
        return 0.0
    if out.shape != want.shape or out.dtype != want.dtype:
        raise AssertionError(f"gather_agg mean {what}: {out.dtype} "
                             f"{tuple(out.shape)}, want {want.dtype} "
                             f"{tuple(want.shape)}")
    diff = (out.float() - want.float()).abs()
    err = float(diff.max())
    if not bool((diff <= ulp(want)).all()):
        raise AssertionError(f"gather_agg mean {what}: max abs err {err}, "
                             f"more than one ulp of the plain version's "
                             f"value")
    return err


def check_gather_agg_cases(seed: int) -> float:
    """Every instance and word width of gather_agg against its plain
    version: fanout 10, which has an instance of its own, and the generic
    one below, at and past a chunk of 8 and a warp of indices; widths whose
    rows take words of 16, 8, 4 and 2 B in float32 and bfloat16; base
    pointers shifted by a row (a contiguous table[1:]) and by one element;
    one row and a row count no block divides; a NaN in the max rows.
    Returns the largest mean error."""
    g = torch.Generator().manual_seed(seed)
    err, cases, shapes = 0.0, 0, set()
    for dtype in (torch.float32, torch.bfloat16):
        for d in AGG_CASE_WIDTHS:
            flat = torch.randn(51 * d + 1, generator=g).to("cuda", dtype)
            with_nan = flat.clone()
            with_nan[7 * d:9 * d + 1:3] = float("nan")  # rows 7-8 of each view
            for shift, view in (
                    ("aligned", lambda x: x[:50 * d].view(50, d)),
                    ("table[1:]", lambda x: x[:51 * d].view(51, d)[1:]),
                    ("shifted by one element",
                     lambda x: x[1:].view(51, d))):
                table, nan_table = view(flat), view(with_nan)
                for f in AGG_CASE_FANOUTS:
                    for n in AGG_CASE_ROWS:
                        nbr = torch.randint(0, table.shape[0], (n, f),
                                            generator=g,
                                            dtype=torch.int32).to("cuda")
                        nbr[0, f // 2] = 7      # a NaN row for max
                        for reduce in ("sum", "mean", "max"):
                            t = nan_table if reduce == "max" else table
                            what = (f"{dtype} d={d} f={f} n={n} {shift}")
                            err = max(err, agg_gate(t, nbr, reduce, what))
                            cases += 1
                        word, _ = ga.agg_shape(d * table.element_size(),
                                               table.data_ptr(),
                                               table.data_ptr())
                        shapes.add((str(dtype)[6:], word))
    log("kernels", f"gather_agg: {cases} cases (f in {AGG_CASE_FANOUTS}, d "
                   f"in {AGG_CASE_WIDTHS}, float32 and bfloat16, base "
                   f"aligned / table[1:] / shifted by one element, n in "
                   f"{AGG_CASE_ROWS}, NaNs in the max rows): sum and max "
                   f"bitwise, mean within one ulp, max abs err {err}; (dtype, "
                   f"word bytes) reached: {sorted(shapes)}")
    return err


AGG_SHAPES: dict = {}   # shape name -> reduce -> timings (time_gather_agg)
AGG_BY_PATH: dict = {}  # path -> gather_agg launches in its window
SAMPLE_BY_PATH: dict = {}   # path -> sample_tree launches in its window
DEDUP_BY_PATH: dict = {}    # path -> plan_dedup's launches in its window


def reset_launches() -> None:
    """At the start of a path's counted window: every GNN kernel's counts
    zeroed."""
    ga.reset_launches()
    sk.reset_launches()
    pd.reset_launches()


def window_end(path: str) -> int:
    """At the end of a path's counted window: gather_rows' launches in it,
    and gather_agg's, which no path calls, kept for the kernels line."""
    AGG_BY_PATH[path] = ga.launches["gather_agg"]
    return ga.launches["gather_rows"]


def plan_passes(trainer) -> int:
    """The planner passes a Trainer has made: its budget's probes, plans
    built and overflowed passes. Each draws its trees once."""
    b = trainer.budget
    return b.probes + b.plans_built + b.rebuckets


def sample_end(path: str, passes: int, layers: int) -> str:
    """At the end of a path's counted window: sample_tree's launches in
    it, recorded for the kernels line and held to one per hop of every
    plan pass (``passes`` 0 on a path that builds no Trainer plan), and
    plan_dedup's (its dedup and translation launches together), recorded
    for the kernels line. Returns the log's words."""
    got = SAMPLE_BY_PATH[path] = sk.launches["sample_tree"]
    DEDUP_BY_PATH[path] = sum(pd.launches.values())
    want = layers * passes
    words = (f"sample_tree launches {got} (want {want} = {layers} x "
             f"{passes} plan passes)")
    if got != want:
        raise AssertionError(f"{path}: {words}")
    return words


def time_gather_agg(phase: str, what: str, table: torch.Tensor,
                    nbr: torch.Tensor) -> dict:
    """gather_agg at one layer-0 child aggregation shape (hop 3's positions
    as (n, 10) neighbour lists into a real table): gated against its plain
    version, then per reduce its device time (CUDA-graph replays) beside
    the plain version's, embedding_bag's (a yardstick the port never
    calls), the bytes bound and its share, and the cost per call from the
    host. Outside every window that counts launches."""
    nbr64 = nbr.long()
    n, f = nbr.shape
    nbytes = moved_bytes(table, nbr, n)
    b, by = bound_ms(nbytes, nbr.numel() * table.shape[1])
    row_bytes = table.shape[1] * table.element_size()
    word, group = ga.agg_shape(row_bytes, table.data_ptr(), table.data_ptr())
    counts = torch.unique(nbr, return_counts=True)[1]
    read = nbr.numel() * row_bytes
    log(phase, f"gather_agg {what}: {nbr.numel()} positions name "
               f"{counts.numel()} distinct rows (the most repeated "
               f"{int(counts.max())} times); the kernel reads {read} B of "
               f"rows into the SMs, the bound counts each distinct row once")
    timed = {}
    for reduce in ("sum", "mean", "max"):
        err = agg_gate(table, nbr, reduce, what)
        ms = device_ms(lambda: ga.gather_agg(table, nbr, reduce))
        pms = device_ms(lambda: ref.gather_agg_ref(table, nbr, reduce))
        lms = device_ms(lambda: torch.nn.functional.embedding_bag(
            nbr64, table, mode=reduce))
        host = call_ms(lambda: ga.gather_agg(table, nbr, reduce))
        log(phase, f"gather_agg {reduce} {what}: table {tuple(table.shape)} "
                   f"f32, n={n} f={f} (word {word} B, {group} lanes per "
                   f"row): "
                   f"device {ms:.5f} ms (plain {pms:.5f}, embedding_bag "
                   f"{lms:.5f}); per call from the host {host:.5f} ms; moves "
                   f"{nbytes} B, bound {b:.5f} ms ({by}), {100 * b / ms:.1f}% "
                   f"of it; rows read at {read / ms / 1e9:.2f} TB/s; "
                   + (f"max abs err {err}" if reduce == "mean" else "bitwise"))
        timed[reduce] = dict(n=n, ms=ms, plain_ms=pms, library_ms=lms,
                             bound_ms=b, bound_by=by, host_ms=host,
                             max_abs_err=err)
    AGG_SHAPES[what] = timed
    return timed


def check_gather_agg(ws: torch.Tensor, hop_idx: list, seed: int) -> float:
    """Every instance of the kernel against its plain version, then the
    serve shape: the rung-64 workspace with hop 3's positions as (n, 10)
    neighbour lists, n = 6,400. Returns the largest mean error."""
    err = check_gather_agg_cases(seed)
    nbr = hop_idx[-1].reshape(-1, AGG_FANOUT)
    wb = ws.to(torch.bfloat16)
    for reduce in ("sum", "mean", "max"):
        err = max(err, agg_gate(wb, nbr, reduce, "serve bfloat16"))
    log("kernels", f"gather_agg at the serve shape in bfloat16: sum and max "
                   f"bitwise, mean within one ulp")
    del wb
    timed = time_gather_agg("kernels", "serve", ws, nbr)
    log("kernels", f"gather_agg mean serve: device {timed['mean']['ms']:.5f}"
                   f" ms against the first design's {AGG_FIRST_MS} ms (same "
                   f"shape, NVIDIA H100 80GB HBM3, 700 W, PERF.md)")
    return max(err, timed["mean"]["max_abs_err"])


def sample_bytes(k: int, fanout: int, layers: int) -> int:
    """The least bytes of drawing ``layers`` hops below ``k`` roots: each
    frontier id (8 B) and its two indptr words (16 B) read once, each
    neighbour id read (4 B) and each id drawn written (8 B) once."""
    return sum(k * fanout ** h * (8 + 16 + fanout * (4 + 8))
               for h in range(layers))


def check_sample_tree(seed: int) -> dict:
    """sample_tree on a train-sage-products plan: bitwise the host sampler
    and the plain version on the card, then timed (see the module doc)."""
    rng = np.random.default_rng(seed)
    deg = rng.poisson(SAMPLE_DEG, SAMPLE_V)
    deg[rng.random(SAMPLE_V) < 0.1] = 0
    indptr = np.zeros(SAMPLE_V + 1, np.int64)
    np.cumsum(deg, out=indptr[1:])
    graph = CSRGraph(indptr=indptr, indices=rng.integers(
        0, SAMPLE_V, int(indptr[-1]), dtype=np.int32))
    csr = sk.DeviceCSR.from_graph(graph, DEVICE)
    roots = rng.choice(SAMPLE_V, SAMPLE_ROOTS, replace=False)
    roots[:8] = np.nonzero(deg == 0)[0][:8]
    s = 2 ** 31 + seed
    layers, f = 3, 10
    sk.reset_launches()
    hops = csr.sample_trees(roots, layers, f, s)
    if sk.launches["sample_tree"] != layers:
        raise AssertionError(f"sample_trees launched "
                             f"{sk.launches['sample_tree']} times, want "
                             f"{layers}")
    want = sample_tree_block(graph, roots, layers, f, seed=s).hops
    plain = [torch.from_numpy(roots).to(DEVICE)]
    for h in range(layers):
        plain.append(sk.sample_hop_ref(csr.indptr, csr.indices, plain[-1],
                                       f, h, s))
    for h in range(layers + 1):
        if not (np.array_equal(hops[h], want[h])
                and np.array_equal(plain[h].cpu().numpy(), want[h])):
            raise AssertionError(f"sample_tree differs from the host "
                                 f"sampler at hop {h}")
    sizes = [SAMPLE_ROOTS * f ** h for h in range(layers + 1)]
    ends = np.cumsum(sizes).tolist()
    buf = torch.empty(ends[-1], dtype=torch.int64, device=DEVICE)
    buf[:SAMPLE_ROOTS] = plain[0]

    def kernel():
        for h in range(layers):
            sk.sample_hop(csr.indptr, csr.indices,
                          buf[ends[h] - sizes[h]:ends[h]], f, h, s,
                          out=buf[ends[h]:ends[h + 1]])

    def plain_version():
        x = plain[0]
        for h in range(layers):
            x = sk.sample_hop_ref(csr.indptr, csr.indices, x, f, h, s)

    ms = device_ms(kernel)
    pms = call_ms(plain_version)
    calls = []
    for _ in range(20):
        t0 = time.perf_counter()
        csr.sample_trees(roots, layers, f, s)
        calls.append(1e3 * (time.perf_counter() - t0))
    call = float(np.median(calls))
    jobs = np.split(roots, SAMPLE_JOBS)
    t0 = time.perf_counter()
    for _ in range(3):
        for r in jobs:
            sample_tree_block(graph, r, layers, f, seed=s)
    host = 1e3 * (time.perf_counter() - t0) / 3
    nbytes = sample_bytes(SAMPLE_ROOTS, f, layers)
    b, by = bound_ms(nbytes)
    log("kernels", f"sample_tree train-sage-products plan: CSR "
                   f"({SAMPLE_V}, {graph.num_edges} entries), "
                   f"{SAMPLE_ROOTS} roots, {layers} hops of fanout {f}, "
                   f"{ends[-1]} ids, seed {s}: bitwise the host sampler and "
                   f"the plain version; device {ms:.5f} ms for the "
                   f"{layers} launches (plain {pms:.5f} ms); moves {nbytes}"
                   f" B, bound {b:.5f} ms ({by}), {100 * b / ms:.1f}% of it;"
                   f" the planner's call (launches, {8 * ends[-1]} B to "
                   f"pinned memory, sync) {call:.3f} ms from the host (median"
                   f" of 20); the "
                   f"host sampler's {SAMPLE_JOBS} jobs {host:.2f} ms")
    del csr, buf, plain
    free_card()
    return dict(name="sample_tree", route="cuda", source=ST_SRC,
                replaces=None, max_abs_err=0.0, bound_by=by, ms=ms,
                plain_ms=pms, bound_ms=b, call_ms=call, host_ms=host)


def dedup_end(path: str, trainer, before: tuple, layers: int) -> str:
    """plan_dedup's launches in a Trainer's window on the device path,
    held to 4 dedup launches per plan pass (3 in a pass that overflows its
    r_max: the budget's re-buckets on a path with no cache and no streamed
    store) and one translation per hop of each pass that does not.
    ``before``: the budget's (probes + plans built, re-buckets) at the
    window's start."""
    b = trainer.budget
    ok = b.probes + b.plans_built - before[0]
    over = b.rebuckets - before[1]
    want = {"plan_dedup": 4 * ok + 3 * over,
            "plan_translate": (layers + 1) * ok}
    got = dict(pd.launches)
    words = (f"plan_dedup launches {got} (want {want}: {ok} plan passes, "
             f"{over} overflowed)")
    if got != want:
        raise AssertionError(f"{path}: {words}")
    return words


def dedup_inputs(v: int, mean_deg: float, seed: int):
    """A cell-sized plan's trees on the card: a random CSR of ``v``
    vertices at ``mean_deg`` (a tenth at degree 0), 4 shards by runs of
    vertices with a fifth strayed at random, 16 jobs of 64 roots drawn
    three hops deep at fanout 10."""
    rng = np.random.default_rng(seed)
    deg = rng.poisson(mean_deg, v)
    deg[rng.random(v) < 0.1] = 0
    indptr = np.zeros(v + 1, np.int64)
    np.cumsum(deg, out=indptr[1:])
    graph = CSRGraph(indptr=indptr, indices=rng.integers(
        0, v, int(indptr[-1]), dtype=np.int32))
    part = np.minimum(np.arange(v) * SHARDS // v, SHARDS - 1)
    stray = rng.random(v) < 0.2
    part[stray] = rng.integers(0, SHARDS, int(stray.sum()))
    owner, local_idx, rows = local_index_map(part, SHARDS)
    roots = rng.choice(v, SAMPLE_ROOTS, replace=False)
    return graph, owner, local_idx, rows, roots


def check_plan_dedup(seed: int) -> dict:
    """plan_dedup at both cells' plan sizes: the kernels bitwise their
    plain version on the card and the host's build_gather_plan and
    workspace_indices; their device time beside the bound and the plain
    version's; the planner's whole call from the host (count, the wait for
    the counts, scatter, translate, one copy back and its wait) beside the
    host path's; the launches of one plan pass."""
    layers, f, steps = 3, 10, DEDUP_JOBS // SHARDS
    job_k = np.full(DEDUP_JOBS, SAMPLE_ROOTS // DEDUP_JOBS, np.int64)
    entry = dict(name="plan_dedup", route="cuda", source=PD_SRC,
                 replaces=None, max_abs_err=0.0, cells={})
    for cell, (v, mean_deg) in DEDUP_CELLS.items():
        graph, owner, local_idx, rows, roots = dedup_inputs(v, mean_deg,
                                                            seed)
        trees = DeviceTrees.build(graph, owner, local_idx, SHARDS, DEVICE)
        part, s = trees.part, 2 ** 31 + seed
        drawn = trees.csr.draw_trees(roots, layers, f, s)
        torch.cuda.synchronize()
        pd.reset_launches()
        dd = part.count(drawn, job_k, steps, layers, f, DEDUP_BATCH_PAD)
        r_max = int(dd.req_count.max())
        part.scatter(dd, r_max, rows)
        req, hops = part.translate(dd)
        launches = dict(pd.launches)
        if launches != {"plan_dedup": 4, "plan_translate": layers + 1}:
            raise AssertionError(f"plan_dedup launched {launches} in one "
                                 f"plan pass")
        # the host path over the same trees
        host = drawn.cpu().numpy()
        sizes = [SAMPLE_ROOTS * f ** h for h in range(layers + 1)]
        ends = np.cumsum(sizes).tolist()
        hop_all = [host[e - z:e] for z, e in zip(sizes, ends)]
        per = SAMPLE_ROOTS // DEDUP_JOBS
        blocks = [[hop_all[h][j * per * f ** h:(j + 1) * per * f ** h]
                   for h in range(layers + 1)] for j in range(DEDUP_JOBS)]
        padded = [[np.concatenate([b[h], np.full(
            (DEDUP_BATCH_PAD - per) * f ** h,
            part.pad_vertex_host[j // steps])]) for h in range(layers + 1)]
            for j, b in enumerate(blocks)]

        def host_path():
            needed = [np.concatenate([np.concatenate(padded[j])
                                      for j in range(sh * steps,
                                                     (sh + 1) * steps)])
                      for sh in range(SHARDS)]
            plan = build_gather_plan(needed, owner, local_idx, SHARDS, rows,
                                     r_max)
            return plan, [workspace_indices(padded[j], j // steps, owner,
                                            local_idx, plan)
                          for j in range(DEDUP_JOBS)]
        t0 = time.perf_counter()
        plan, widx = host_path()
        host_ms = 1e3 * (time.perf_counter() - t0)
        if not (np.array_equal(plan.req, req)
                and np.array_equal(plan.req_count, dd.req_count)):
            raise AssertionError(f"plan_dedup's exchange differs from the "
                                 f"host's at {cell}")
        for h in range(layers + 1):
            want = np.stack([widx[j][h] for j in range(DEDUP_JOBS)])
            if not np.array_equal(want.reshape(hops[h].shape), hops[h]):
                raise AssertionError(f"plan_dedup's hop {h} differs from "
                                     f"the host's at {cell}")
        # the kernels and the plain version on the card, on the same inputs
        root_shard = torch.from_numpy(np.repeat(
            np.arange(DEDUP_JOBS) // steps, per)).to(DEVICE)
        pad_mark = part.pad_vertex.clone()
        job_off = torch.arange(DEDUP_JOBS, device=DEVICE) * per
        job_kt = torch.from_numpy(job_k).to(DEVICE)
        out = {}
        for name, mark_fn, count_fn, scatter_fn, hop_fn in (
                ("kernel", pd.mark_ids, pd.count_marks, pd.scatter_marks,
                 pd.translate_hop),
                ("plain", pd.mark_ids_ref, pd.count_marks_ref,
                 pd.scatter_marks_ref, pd.translate_hop_ref)):
            def dedup(mark_fn=mark_fn, count_fn=count_fn,
                      scatter_fn=scatter_fn):
                mark = mark_fn(drawn, SAMPLE_ROOTS, f, layers, root_shard,
                               pad_mark, v)
                counts, chunk_off = count_fn(mark, part)
                req_t = torch.zeros((SHARDS, SHARDS, r_max),
                                    dtype=torch.int32, device=DEVICE)
                slot = torch.empty((SHARDS, v), dtype=torch.int32,
                                   device=DEVICE)
                scatter_fn(mark, part, chunk_off, r_max, rows, req_t, slot)
                return counts, req_t, slot
            counts, req_t, slot = dedup()
            outs = [torch.empty(SHARDS * steps * DEDUP_BATCH_PAD * f ** h,
                                dtype=torch.int32, device=DEVICE)
                    for h in range(layers + 1)]

            def translate(hop_fn=hop_fn, slot=slot, outs=outs):
                for h in range(layers + 1):
                    hop_fn(drawn[ends[h] - sizes[h]:ends[h]], f ** h,
                           DEDUP_BATCH_PAD, steps, job_off, job_kt, part,
                           slot, outs[h])
            translate()
            if not (torch.equal(counts.cpu(), torch.from_numpy(
                    dd.req_count.reshape(-1)))
                    and torch.equal(req_t.cpu(), torch.from_numpy(req))
                    and all(torch.equal(o.cpu(), torch.from_numpy(
                        hops[h].reshape(-1))) for h, o in enumerate(outs))):
                raise AssertionError(f"plan_dedup {name} differs at {cell}")
            timer = device_ms if name == "kernel" else call_ms
            out[name] = (timer(dedup), timer(translate))
        calls = []
        for _ in range(20):
            t0 = time.perf_counter()
            dd = part.count(drawn, job_k, steps, layers, f, DEDUP_BATCH_PAD)
            part.scatter(dd, r_max, rows)
            part.translate(dd)
            calls.append(1e3 * (time.perf_counter() - t0))
        call = float(np.median(calls))
        n_ids = ends[-1]
        remote = int(dd.req_count.sum())
        touched = int(sum(np.unique(np.concatenate(
            [np.concatenate(padded[j]) for j in range(sh * steps,
                                                      (sh + 1) * steps)])
        ).size for sh in range(SHARDS)))
        positions = sum(SHARDS * steps * DEDUP_BATCH_PAD * f ** h
                        for h in range(layers + 1))
        # least bytes: the tree ids and the owner row read once; each
        # remote id's local index read and slot written once; req written
        d_bytes = 8 * n_ids + 4 * v + 8 * remote + 4 * req.size
        # each true tree id read, each position written, and for each
        # distinct (shard, id) its owner and its local index or slot once
        t_bytes = 8 * n_ids + 4 * positions + 8 * touched
        (dk, tk), (dp, tp) = out["kernel"], out["plain"]
        db, _ = bound_ms(d_bytes)
        tb, _ = bound_ms(t_bytes)
        log("kernels", f"plan_dedup {cell} plan: V {v}, {SHARDS} shards, "
                       f"{DEDUP_JOBS} jobs of {per} roots padded to "
                       f"{DEDUP_BATCH_PAD}, {n_ids} tree ids, {remote} "
                       f"remote ids, r_max {r_max}, {positions} positions: "
                       f"bitwise the host path and the plain version; "
                       f"dedup (mark with its zeroing, count, scan, "
                       f"scatter) device {dk:.5f} ms (plain {dp:.5f} ms), "
                       f"moves {d_bytes} B, bound {db:.5f} ms (bytes), "
                       f"{100 * db / dk:.1f}% of it; translate (4 hops) "
                       f"device {tk:.5f} ms (plain {tp:.5f} ms), moves "
                       f"{t_bytes} B, bound {tb:.5f} ms (bytes), "
                       f"{100 * tb / tk:.1f}% of it; launches per plan pass "
                       f"{launches}; the planner's call {call:.3f} ms from "
                       f"the host (median of 20); the host path "
                       f"(build_gather_plan {plan.dedup}, workspace_indices)"
                       f" {host_ms:.2f} ms")
        entry["cells"][cell] = dict(
            dedup_ms=dk, dedup_plain_ms=dp, dedup_bound_ms=db,
            translate_ms=tk, translate_plain_ms=tp, translate_bound_ms=tb,
            call_ms=call, host_ms=host_ms, launches_per_pass=launches)
        del trees, part, drawn, dd, graph
        free_card()
    sage = entry["cells"]["train-sage-products"]
    entry.update(ms=sage["dedup_ms"] + sage["translate_ms"],
                 plain_ms=sage["dedup_plain_ms"] + sage["translate_plain_ms"],
                 bound_ms=sage["dedup_bound_ms"] + sage["translate_bound_ms"],
                 bound_by="bytes")
    return entry


def gather_agg_entry(err: float) -> dict:
    """gather_agg's kernels-line entry: the P3 shape's mean timings, every
    shape's under ``shapes``."""
    p3 = {k: v for k, v in AGG_SHAPES["P3"]["mean"].items()
          if k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}
    return dict(name="gather_agg", route="cuda", source=SRC,
                replaces="src/repro/kernels/gather_agg.py:130",
                max_abs_err=err, **p3, shapes=AGG_SHAPES)


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
    check_linattn_outside_domain(g)
    return dict(name="linattn", route="cuda", source=LA_SRC,
                replaces="src/repro/kernels/linattn.py:93",
                max_abs_err=max(err, e_scan), **timed[2048])


def check_linattn_outside_domain(g) -> None:
    """The kernel at a constant decay w = LA_OUTSIDE_W, below its domain
    (0.5, 1], against its plain version on the same inputs (the CPU test
    tests/test_torch_linattn.py::test_chunked_ref_outside_the_decay_domain
    holds the plain version against the Pallas kernel there). Gated within
    LA_TOL only where both outputs are finite; where either is not, the
    positions are printed, not gated."""
    for BH, T, dk, dv, chunk in LA_OUTSIDE_CASES:
        q, k, v, w, u = linattn_inputs(g, BH, T, dk, dv, True)
        w = torch.full_like(w, LA_OUTSIDE_W)
        o, s = la.linattn_chunked(q, k, v, w, u, chunk=chunk)
        o_ref, s_ref = ref.linattn_chunked_ref(q, k, v, w, u, chunk=chunk)
        torch.cuda.synchronize()
        msg, bad = [], []
        for name, got, want in (("o", o, o_ref), ("S", s, s_ref)):
            fin_k, fin_p = torch.isfinite(got), torch.isfinite(want)
            both = fin_k & fin_p
            err = float((got[both] - want[both]).abs().max()) \
                if both.any() else 0.0
            big = float(want[both].abs().max()) if both.any() else 0.0
            first = (int(torch.nonzero(~both)[0, 1]) if name == "o"
                     and not both.all() else None)
            msg.append(f"{name}: non-finite kernel {int((~fin_k).sum())}, "
                       f"plain {int((~fin_p).sum())} of {got.numel()}"
                       + (f" (first at t {first})" if first is not None
                          else "")
                       + f"; where both finite max abs err {err:.3e} "
                         f"(|{name}| up to {big:.3e})")
            if both.any() and not torch.allclose(got[both], want[both],
                                                 rtol=LA_TOL, atol=LA_TOL):
                bad.append(name)
        log("kernels", f"linattn outside its domain, w {LA_OUTSIDE_W}, "
                       f"BH={BH} T={T} dk={dk} dv={dv} chunk={chunk}: "
                       + "; ".join(msg) + f" (tolerance {LA_TOL} where both "
                                          f"are finite)")
        if bad:
            raise AssertionError(f"linattn at w {LA_OUTSIDE_W} (BH={BH} "
                                 f"T={T} chunk={chunk}) differs from its "
                                 f"plain version where both are finite: "
                                 f"{bad}")


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
    vertices = zipf_vertices(rng, ds.num_vertices, requests)

    # the main path: counts are zeroed just before it and read just after
    reset_launches()
    batches0 = srv.fresh_batches
    tickets, results = open_loop(srv, vertices, qps)
    launches = dict(ga.launches)
    sampled = sample_end("gnn_serve", 0, cfg.num_layers)
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
                 f"micro-batches; {sampled}")
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


def zipf_vertices(rng, n: int, requests: int) -> np.ndarray:
    """``requests`` vertex ids drawn zipf(1.1) over a random ranking."""
    p = np.arange(1, n + 1, dtype=np.float64) ** -1.1
    return rng.permutation(n)[rng.choice(n, requests, p=p / p.sum())]


def open_loop(srv, vertices: np.ndarray, qps: float):
    """Submit one request per vertex at ``qps`` through start()/submit(),
    wait for every answer, stop the server. Returns (tickets, results)."""
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
    return tickets, results


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

def check_gathers_train(trainer, plan) -> None:
    """gather_rows at the four hops of (shard 0, step 0) of a real training
    plan, on shard 0's pre-gathered workspace ``[local | fetched]``:
    bitwise against its plain version, and timed as phase 2 times it; then
    gather_agg on the same workspace with hop 3's positions as (n, 10)."""
    dev = engine.tree_map(lambda x: engine.upload(x, trainer.device),
                          plan.device_args())
    d = trainer.table.shape[-1]
    recv = engine.EmulatedComm().exchange_global(trainer.table, dev["req"])
    ws = torch.cat([trainer.table[0], recv[0].reshape(-1, d)], 0)
    hops = [hop[0, 0].contiguous() for hop in dev["hop_idx"]]
    tot = time_gather_rows("train", "training", ws, hops)
    log("train", f"gather_rows, 4 hops of one (shard, step): device "
                 f"{tot['ms']:.5f} ms (plain {tot['plain_ms']:.5f}, "
                 f"index_select {tot['library_ms']:.5f}, bound "
                 f"{tot['bound_ms']:.5f}); an iteration runs "
                 f"{plan.num_shards * plan.num_steps} such")
    time_gather_agg("train", "training", ws, hops[-1].reshape(-1, AGG_FANOUT))


def check_train_grads(trainer, plan, store, cfg) -> None:
    """One iteration's loss and grad leaves on CUDA (the gather_rows
    kernel) against the same parameters' iteration on the CPU (plain
    gather_rows)."""
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


def train_optimizer():
    """examples/train_hopgnn.py's AdamW: cosine schedule, weight decay,
    clipping, with a value key for the engine's fused-step cache."""
    total = TRAIN_EPOCHS * TRAIN_ITERS
    return adamw(cosine_schedule(3e-3, warmup=10, total=total),
                 weight_decay=1e-4, grad_clip=1.0,
                 key=("cos", 3e-3, 10, total))


def phase_train(ds, store, part, cfg, seed: int) -> int:
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 is on; training parity needs it off")
    trainer = Trainer(graph=ds.graph, labels=ds.labels, part=part,
                      owner=store.owner, local_idx=store.local_idx,
                      table=store, cfg=cfg, optimizer=train_optimizer(),
                      init_seed=seed,
                      strategy="hopgnn", pregather=True,
                      train_vertices=ds.train_vertices(), resilience=False,
                      device="cuda")
    log("train", f"hopgnn, pregather, merging {trainer.merging}, pipeline "
                 f"{trainer.pipeline}, resilience "
                 f"{'off' if trainer.resilience is None else 'on'}, "
                 f"{SHARDS} shards on one card, batch {TRAIN_BATCH} per "
                 f"model ({SHARDS * TRAIN_BATCH} global), "
                 f"{trainer.planner_threads} planner threads; tf32 matmul "
                 f"{torch.backends.cuda.matmul.allow_tf32} cudnn "
                 f"{torch.backends.cudnn.allow_tf32}")
    plan = trainer.build_plan(0, 0, TRAIN_BATCH)
    trainer._drain_plan_stats()
    check_gathers_train(trainer, plan)
    check_train_grads(trainer, plan, store, cfg)
    del plan

    # the main path: counts are zeroed just before it and read just after
    reset_launches()
    passes = plan_passes(trainer)
    before = (trainer.budget.probes + trainer.budget.plans_built,
              trainer.budget.rebuckets)
    t0 = time.perf_counter()
    stats = trainer.fit(TRAIN_EPOCHS, TRAIN_ITERS,
                        batch_per_model=TRAIN_BATCH)
    wall = time.perf_counter() - t0
    launches = window_end("gnn_train")
    sampled = sample_end("gnn_train", plan_passes(trainer) - passes,
                         cfg.num_layers)
    sampled += "; " + dedup_end("gnn_train", trainer, before,
                                cfg.num_layers)
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
                 f"{trainer._uploader.shape_changes}; {sampled}")
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
# Phase ckpt: checkpoints, resilience, membership, the precomputed tier
# ---------------------------------------------------------------------------

def ckpt_trainer(ds, store, part, cfg, seed: int, ckpt_dir: str):
    """Phase 5's Trainer with merging off (the merge controller is fed
    wall-clock times, so two runs could choose different patterns) and
    checkpoints under ``ckpt_dir``; the default resilience policy."""
    return Trainer(graph=ds.graph, labels=ds.labels, part=part,
                   owner=store.owner, local_idx=store.local_idx,
                   table=store, cfg=cfg, optimizer=train_optimizer(),
                   init_seed=seed, strategy="hopgnn", pregather=True,
                   merging=False, train_vertices=ds.train_vertices(),
                   ckpt_dir=ckpt_dir, device="cuda")


def state_tensors(trainer) -> list:
    st = trainer.opt_state
    return list(trainer.params.leaves()) + list(st.mu) + list(st.nu) \
        + [st.step]


def same_state(a, b) -> bool:
    return all(torch.equal(x, y)
               for x, y in zip(state_tensors(a), state_tensors(b)))


def log_fit(tag: str, stats) -> None:
    for st in stats:
        log("ckpt", f"{tag} epoch {st.epoch}: loss {st.loss!r}, steady "
                    f"{1e3 * st.steady_time_s / CKPT_ITERS:.2f} ms/iter, "
                    f"wall {st.time_s:.3f} s, traces {st.traces}, attempts "
                    f"{st.epoch_attempts}, rollbacks {st.rollbacks}, "
                    f"degradations {list(st.degradations)}, faults "
                    f"{st.faults_injected}, comm retries {st.comm_retries}"
                    f" (timeouts {st.comm_timeouts}), background errors "
                    f"{st.bg_errors}, membership generation "
                    f"{st.membership_generation} (recoveries "
                    f"{st.membership_recoveries})")


def checkpoint_cost(trainer, directory: str) -> None:
    """One save and one load of the Trainer's {"params", "opt"} tree, as
    its epoch boundary writes it; the load fills a fresh template on the
    card and must equal the live state."""
    tree = {"params": trainer.params, "opt": trainer.opt_state}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_checkpoint(directory, trainer.global_step, tree,
                    extra={"epoch": CKPT_EPOCHS - 1})
    save_ms = 1e3 * (time.perf_counter() - t0)
    nbytes = sum(os.path.getsize(os.path.join(directory, f))
                 for f in os.listdir(directory) if f.startswith("step-"))
    like_p = copy.deepcopy(trainer.params)
    like = {"params": like_p, "opt": trainer.optimizer.init(like_p)}
    t0 = time.perf_counter()
    got, step, _ = load_checkpoint(directory, like)
    torch.cuda.synchronize()
    load_ms = 1e3 * (time.perf_counter() - t0)
    ok = all(torch.equal(x, y) for x, y in zip(
        list(got["params"].leaves()) + got["opt"].mu + got["opt"].nu,
        list(trainer.params.leaves()) + trainer.opt_state.mu
        + trainer.opt_state.nu)) and int(got["opt"].step) == int(
        trainer.opt_state.step)
    log("ckpt", f"checkpoint of params + AdamW moments (step {step}): save "
                f"{save_ms:.2f} ms, load into the card's tensors "
                f"{load_ms:.2f} ms, {nbytes} B on disk; loaded state "
                f"bitwise the live one: {ok}")
    if not ok:
        raise AssertionError("a loaded checkpoint differs from the state "
                             "it was saved from")


def check_answers(tickets, results, tab, ds, store, cfg, params_cpu,
                  seed: int) -> tuple[int, int]:
    """256 served answers against their source: up to 128 distinct fresh
    ones against the port's CPU forward (1e-4), the rest from the table,
    which must be its row bit for bit."""
    first = {}
    for t, r in zip(tickets, results):
        first.setdefault((t.via, int(t.payload)), r)
    rng = np.random.default_rng(seed)
    fresh = sorted(v for via, v in first if via == "fresh")
    pre = sorted(v for via, v in first if via == "precomputed")
    fresh = [int(v) for v in rng.permutation(fresh)[:128]]
    pre = [int(v) for v in rng.permutation(pre)[:256 - len(fresh)]]
    for v in pre:
        if not np.array_equal(first[("precomputed", v)], tab.lookup([v])[0]):
            raise AssertionError(f"precomputed answer for vertex {v} is not "
                                 f"its table row")
    err = 0.0
    if fresh:
        got = np.stack([first[("fresh", v)] for v in fresh])
        want = offline_logits(ds, store, cfg, params_cpu, fresh)
        err = float(np.abs(got - want).max())
        if not np.allclose(got, want, rtol=CPU_TOL, atol=CPU_TOL):
            raise AssertionError(f"fresh answers differ from the CPU "
                                 f"forward: max abs err {err} > {CPU_TOL}")
    log("ckpt", f"answers checked: {len(pre)} precomputed, each its table "
                f"row bitwise; {len(fresh)} fresh vs the CPU forward, max "
                f"abs err {err} (tolerance {CPU_TOL})")
    return len(pre), len(fresh)


def phase_ckpt(ds, store, part, cfg, seed: int, requests: int,
               qps: float) -> dict:
    base = os.path.join(ROOT, "build", "chip_smoke_ckpt")
    shutil.rmtree(base, ignore_errors=True)
    dirs = {k: os.path.join(base, k)
            for k in ("straight", "faulted", "resume", "probe")}
    launches = {}
    layers = cfg.num_layers + 1
    per_run = layers * SHARDS * SHARDS * CKPT_ITERS * CKPT_EPOCHS

    # 1. straight run, writing a checkpoint at each epoch boundary
    ta = ckpt_trainer(ds, store, part, cfg, seed, dirs["straight"])
    log("ckpt", f"card {card_line()}; {CKPT_EPOCHS} epochs x {CKPT_ITERS} "
                f"iterations, batch "
                f"{TRAIN_BATCH} per model, merging off, resilience "
                f"{type(ta.resilience).__name__} (membership "
                f"{ta.resilience.membership}, mode "
                f"{ta.resilience.membership_mode}), checkpoints in "
                f"{os.path.relpath(base, ROOT)}/")
    reset_launches()
    passes = plan_passes(ta)
    t0 = time.perf_counter()
    sa = ta.fit(CKPT_EPOCHS, CKPT_ITERS, batch_per_model=TRAIN_BATCH)
    window_end("gnn_train_ckpt")
    sampled = sample_end("gnn_train_ckpt", plan_passes(ta) - passes,
                         cfg.num_layers)
    log_fit("straight", sa)
    log("ckpt", f"straight run {time.perf_counter() - t0:.2f} s; {sampled}")
    if not all(np.isfinite(st.loss) for st in sa):
        raise AssertionError(f"non-finite loss: {[s.loss for s in sa]}")
    checkpoint_cost(ta, dirs["probe"])

    # 2. the same run under faults — counts zeroed just before, read after
    fp = FaultPlan([
        FaultSpec("thread_exc", epoch=1, it=1, site="prefetch"),
        FaultSpec("comm_delay", epoch=1, it=3, delay_s=0.003),
        FaultSpec("comm_drop", epoch=1, it=4, drops=1),
        FaultSpec("peer_death", epoch=2, it=1, shard=2),
        FaultSpec("nan_loss", epoch=2, it=4)], seed=seed, name="ckpt")
    tb = ckpt_trainer(ds, store, part, cfg, seed, dirs["faulted"])
    reset_launches()
    passes = plan_passes(tb)
    t0 = time.perf_counter()
    with fp.active():
        sb = tb.fit(CKPT_EPOCHS, CKPT_ITERS, batch_per_model=TRAIN_BATCH)
    wall_b = time.perf_counter() - t0
    launches["gnn_train_faulted"] = window_end("gnn_train_faulted")
    # the replays and the shrunk world's plans are plan passes too
    sampled = sample_end("gnn_train_faulted", plan_passes(tb) - passes,
                         cfg.num_layers)
    log_fit("faulted", sb)
    kinds = sorted({k for k, *_ in fp.fired})
    log("ckpt", f"faulted run {wall_b:.2f} s; fired {fp.fired}; "
                f"gather_rows launches {launches['gnn_train_faulted']} "
                f"(a clean run launches {per_run}; replays add more); "
                f"{sampled}")
    for r in tb.recovery_log:
        same = [st for st in sa if st.epoch == r["epoch"]][0]
        log("ckpt", f"recovery in epoch {r['epoch']} after attempt "
                    f"{r['attempt']}: {r['error']} -> "
                    f"{r['rung'] or 'replay in mode'}; attempt wall lost "
                    f"{1e3 * r['lost_s']:.1f} ms, recovery itself "
                    f"{1e3 * r['recover_s']:.2f} ms (a clean epoch takes "
                    f"{1e3 * same.time_s:.1f} ms)")
    want_kinds = sorted({sp.kind for sp in fp.specs})
    rollbacks = sum(st.rollbacks for st in sb)
    recoveries = sum(st.membership_recoveries for st in sb)
    bitwise = [a.loss for a in sa] == [b.loss for b in sb] \
        and same_state(ta, tb)
    log("ckpt", f"faulted vs straight: losses and parameters bitwise "
                f"{bitwise}; kinds fired {kinds}; rollbacks {rollbacks}; "
                f"membership recoveries {recoveries}")
    if kinds != want_kinds:
        raise AssertionError(f"fault kinds fired {kinds}, want {want_kinds}")
    if not bitwise:
        raise AssertionError("the faulted run is not bitwise the straight "
                             "run")
    if rollbacks != 1 or recoveries != 1 or tb.membership_recoveries != 1:
        raise AssertionError(f"rollbacks {rollbacks}, membership recoveries"
                             f" {recoveries}; want 1 and 1")
    if launches["gnn_train_faulted"] <= per_run:
        raise AssertionError("the replays launched no gather_rows")
    del tb

    # 3. resume from the straight run's epoch-1 checkpoint
    step1 = 2 * CKPT_ITERS
    os.makedirs(dirs["resume"])
    for ext in ("npz", "json"):
        name = f"step-{step1:08d}.{ext}"
        shutil.copy(os.path.join(dirs["straight"], name),
                    os.path.join(dirs["resume"], name))
    with open(os.path.join(dirs["resume"], "latest"), "w") as f:
        f.write(str(step1))
    tc = ckpt_trainer(ds, store, part, cfg, seed, dirs["resume"])
    # resuming restores the budget's rebuckets from the checkpoint
    with open(os.path.join(dirs["resume"], f"step-{step1:08d}.json")) as f:
        passes = plan_passes(tc) + int(
            json.load(f)["extra"]["budget_state"]["rebuckets"])
    reset_launches()
    t0 = time.perf_counter()
    sc = tc.fit(CKPT_EPOCHS, CKPT_ITERS, batch_per_model=TRAIN_BATCH,
                resume=True)
    window_end("gnn_train_resumed")
    sampled = sample_end("gnn_train_resumed", plan_passes(tc) - passes,
                         cfg.num_layers)
    log_fit("resumed", sc)
    ok = [s.epoch for s in sc] == [CKPT_EPOCHS - 1] \
        and sc[0].loss == sa[-1].loss and same_state(ta, tc)
    log("ckpt", f"resumed at step {step1} in {time.perf_counter() - t0:.2f}"
                f" s: epoch {[s.epoch for s in sc]} loss and final state "
                f"bitwise the straight run's {ok}; budget probes "
                f"{tc.budget.probes}, new signatures {sc[0].traces}; "
                f"{sampled}")
    if not ok:
        raise AssertionError("the resumed run is not bitwise the straight "
                             "run")
    if sc[0].traces != 0 or tc.budget.probes != 0:
        raise AssertionError("the resumed run's first epoch re-probed or "
                             "recorded a new signature")
    del tc

    # 4. the full-graph precompute with the straight run's parameters: the
    # kernel at the shapes of its first chunk, then the pass itself
    roots = np.arange(PRECOMPUTE_CHUNK, dtype=np.int64)
    plan = plan_inference(ds.graph, roots, cfg.num_layers, cfg.fanout,
                          sample_seed=999, batch_pad=PRECOMPUTE_CHUNK)
    u = plan.fetch_ids.size
    ws = np.zeros((next_bucket(int(u * 1.5)), ds.feature_dim), np.float32)
    ws[:u] = store.take_global(plan.fetch_ids)
    tot = time_gather_rows("ckpt", "precompute", torch.from_numpy(ws).cuda(),
                           [torch.from_numpy(h).cuda() for h in plan.hop_idx])
    log("ckpt", f"gather_rows, 4 hops of one {PRECOMPUTE_CHUNK}-root chunk: "
                f"device {tot['ms']:.5f} ms (plain {tot['plain_ms']:.5f}, "
                f"index_select {tot['library_ms']:.5f}, bound "
                f"{tot['bound_ms']:.5f})")
    del ws, plan
    n = ds.num_vertices
    step = ta.global_step
    chunks = -(-n // PRECOMPUTE_CHUNK)
    reset_launches()
    trace.clear()
    trace.enable()
    t0 = time.perf_counter()
    try:
        precompute_embeddings(ds.graph, store, ta.params, cfg,
                              ckpt_dir=dirs["straight"], params_step=step,
                              chunk=PRECOMPUTE_CHUNK)
    finally:
        trace.disable()
    wall = time.perf_counter() - t0
    launches["gnn_precompute"] = window_end("gnn_precompute")
    sampled = sample_end("gnn_precompute", 0, cfg.num_layers)
    spans: dict = {}
    for r in trace.records():
        if r.kind == "X":
            spans[r.name] = spans.get(r.name, 0) + r.dur_ns
    trace.clear()
    plan_ms = spans.get("serve.precompute.plan", 0) / 1e6 / chunks
    fwd_ms = spans.get("serve.precompute.forward", 0) / 1e6 / chunks
    log("ckpt", f"precompute of {n} vertices in {chunks} chunks of "
                f"{PRECOMPUTE_CHUNK}: {wall:.2f} s, {n / wall:.0f} rows/s; "
                f"per chunk host plan + gather {plan_ms:.3f} ms, upload + "
                f"forward + logits back {fwd_ms:.3f} ms; table save "
                f"{spans.get('ckpt.save', 0) / 1e6:.1f} ms; gather_rows "
                f"launches {launches['gnn_precompute']} (want "
                f"{chunks * layers}); {sampled}")
    if launches["gnn_precompute"] != chunks * layers:
        raise AssertionError(f"precompute launched gather_rows "
                             f"{launches['gnn_precompute']} times, want "
                             f"{chunks * layers}")
    tab = load_embeddings(dirs["straight"], params_step=step,
                          sample_seed=999)
    sample = np.linspace(0, n - 1, 256).astype(np.int64)
    params_cpu = copy.deepcopy(ta.params).cpu()
    want = offline_logits(ds, store, cfg, params_cpu, sample)
    got = tab.lookup(sample)
    err = float(np.abs(got - want).max())
    log("ckpt", f"table rows of {sample.size} vertices over the id range vs "
                f"the CPU forward: max abs err {err} (tolerance {CPU_TOL}); "
                f"table {tab.logits.shape} finite "
                f"{bool(np.isfinite(tab.logits).all())}")
    if got.shape != (sample.size, cfg.num_classes) \
            or not np.isfinite(tab.logits).all() \
            or not np.allclose(got, want, rtol=CPU_TOL, atol=CPU_TOL):
        raise AssertionError(f"precomputed rows differ from the CPU forward:"
                             f" max abs err {err}")
    try:
        load_embeddings(dirs["straight"], params_step=step + 1)
    except ValueError as e:
        log("ckpt", f"another params_step refused: {e}")
    else:
        raise AssertionError("a stale embedding snapshot was accepted")

    # 5. serve from the checkpoint: hot vertices fresh, cold from the table
    srv = GNNServer(graph=ds.graph, params=ta.params, cfg=cfg, store=store,
                    max_batch=MAX_BATCH, cache_budget_bytes=CACHE_BYTES,
                    ckpt_dir=dirs["straight"], mode="auto",
                    params_step=step, device="cuda")
    w = srv.warmup()
    vertices = zipf_vertices(np.random.default_rng(seed + 2), n, requests)
    reset_launches()
    fresh0, pre0 = srv.fresh_batches, srv.precomputed_hits
    tickets, results = open_loop(srv, vertices, qps)
    launches["gnn_serve_auto"] = window_end("gnn_serve_auto")
    sampled = sample_end("gnn_serve_auto", 0, cfg.num_layers)
    st = srv.stats()
    fresh_batches = srv.fresh_batches - fresh0
    hits = srv.precomputed_hits - pre0
    lat = np.array([1e3 * t.latency_s() for t in tickets])
    wall = tickets[-1].t_done - tickets[0].t_submit
    via_pre = sum(t.via == "precomputed" for t in tickets)
    log("ckpt", f"auto mode, {len(tickets)} zipf(1.1) requests offered at "
                f"{qps} req/s after a warmup of {w['traces']} traces: served "
                f"at {len(tickets) / wall:.1f} req/s, latency p50 "
                f"{np.percentile(lat, 50):.3f} ms p99 "
                f"{np.percentile(lat, 99):.3f} ms; {via_pre} requests "
                f"({100 * via_pre / len(tickets):.1f}%) answered from the "
                f"table, {hits} table rows read, {fresh_batches} fresh "
                f"micro-batches with {launches['gnn_serve_auto']} gather_rows"
                f" launches; retraces since warmup "
                f"{st['retraces_since_warmup']}, errors {st['errors']}; "
                f"{sampled}")
    if hits <= 0 or st["precomputed_hits"] <= 0:
        raise AssertionError("auto mode answered nothing from the table")
    if fresh_batches == 0 \
            or launches["gnn_serve_auto"] < layers * fresh_batches:
        raise AssertionError(f"the fresh path launched gather_rows "
                             f"{launches['gnn_serve_auto']} times for "
                             f"{fresh_batches} micro-batches")
    if st["retraces_since_warmup"] != 0 or st["errors"] != 0:
        raise AssertionError("auto serving retraced or failed")
    check_answers(tickets, results, tab, ds, store, cfg, params_cpu, seed)
    del srv, ta
    torch.cuda.empty_cache()
    shutil.rmtree(base, ignore_errors=True)
    return launches


# ---------------------------------------------------------------------------
# Phase p3: the P³ baseline beside LeapGNN, and the byte accounting
# ---------------------------------------------------------------------------

def max_errs(got, want) -> list:
    """Per leaf: (max abs err, the reference leaf's largest |value|)."""
    return [(float((a.cpu() - b.cpu()).abs().max()),
             float(b.cpu().abs().max())) for a, b in zip(got, want)]


def phase_p3(ds, store, part, cfg, seed: int) -> int:
    """One P³ iteration on the same roots as one model-centric and one
    hopgnn iteration, at phase 5's world and model."""
    layers = cfg.num_layers + 1
    params = init_gnn(cfg, torch.Generator().manual_seed(seed), DEVICE)
    rng = np.random.default_rng(seed + 3)
    roots = [rng.choice(ds.train_vertices(), TRAIN_BATCH, replace=False)
             for _ in range(SHARDS)]
    t0 = time.perf_counter()
    plan = plan_p3(ds.graph, ds.labels, roots, cfg.num_layers, cfg.fanout,
                   cfg.hidden_dim, sample_seed=P3_SAMPLE_SEED)
    plan_ms = 1e3 * (time.perf_counter() - t0)
    common = dict(graph=ds.graph, labels=ds.labels, part=part,
                  owner=store.owner, local_idx=store.local_idx,
                  local_rows=store.local_rows, roots_per_model=roots,
                  num_layers=cfg.num_layers, fanout=cfg.fanout,
                  sample_seed=P3_SAMPLE_SEED)
    mc = plan_iteration(strategy="model_centric", **common)
    hg = plan_iteration(strategy="hopgnn", **common)
    feats = torch.from_numpy(ds.features).to(DEVICE)
    table = engine.upload(store.as_dense(), DEVICE)
    log("p3", f"{SHARDS} models x {TRAIN_BATCH} roots, sage "
              f"{cfg.num_layers}x{cfg.hidden_dim} fanout {cfg.fanout}, "
              f"feature table {tuple(feats.shape)} on the card; plan_p3 "
              f"{plan_ms:.1f} ms; the input layer runs over "
              f"{SHARDS} slices of the {cfg.feature_dim} feature dims")
    # the kernels at the P³ hop sizes: shard 0's hops from the full table
    hops = [torch.from_numpy(h.astype(np.int32)).to(DEVICE)
            for h in plan.blocks[0].hops]
    tot = time_gather_rows("p3", "P3", feats, hops)
    log("p3", f"gather_rows, {layers} hops of one shard: device "
              f"{tot['ms']:.5f} ms (plain {tot['plain_ms']:.5f}, "
              f"index_select {tot['library_ms']:.5f}, bound "
              f"{tot['bound_ms']:.5f}); an iteration runs {SHARDS} such")
    time_gather_agg("p3", "P3", feats, hops[-1].reshape(-1, AGG_FANOUT))
    del hops

    # the main path: counts are zeroed just before it and read just after
    reset_launches()
    g3, l3 = run_p3_iteration(params, feats, plan, cfg)
    torch.cuda.synchronize()
    launches = window_end("p3_train")
    sampled = sample_end("p3_train", 0, cfg.num_layers)
    gm, lm = engine.run_iteration(params, table, mc, cfg)
    t0 = time.perf_counter()
    g3c, l3c = run_p3_iteration(copy.deepcopy(params).cpu(), ds.features,
                                plan, cfg, device="cpu")
    t_cpu = time.perf_counter() - t0
    e_cpu = max_errs(g3, g3c)
    e_mc = max_errs(g3, gm)
    losses = (float(l3), float(lm), float(l3c))
    log("p3", f"loss P3 CUDA {losses[0]:.7f}, model-centric CUDA "
              f"{losses[1]:.7f}, P3 CPU {losses[2]:.7f} (CPU "
              f"{t_cpu:.2f} s); grad leaves, P3 CUDA vs CPU max abs err "
              f"{[float(f'{e:.3g}') for e, _ in e_cpu]} (each within "
              f"{TRAIN_RTOL} x the leaf's largest |g|); vs model-centric "
              f"{[float(f'{e:.3g}') for e, _ in e_mc]} (rtol "
              f"{P3_TOL['rtol']}, atol {P3_TOL['atol']}); gather_rows "
              f"launches {launches} (want {layers * SHARDS} = (layers+1) x "
              f"shards); {sampled}")
    for i, (err, scale) in enumerate(e_cpu):
        if err > TRAIN_RTOL * scale:
            raise AssertionError(f"P3 grad leaf {i}: CUDA vs CPU max abs "
                                 f"err {err} > {TRAIN_RTOL} x {scale}")
    for i, (a, b) in enumerate(zip(g3, gm)):
        if not torch.allclose(a, b, **P3_TOL):
            raise AssertionError(f"P3 grad leaf {i} differs from "
                                 f"model-centric's: {e_mc[i][0]}")
    if max(losses) - min(losses) > 1e-4:
        raise AssertionError(f"P3 / model-centric / CPU losses {losses}")
    if launches != layers * SHARDS:
        raise AssertionError(f"P3 launched gather_rows {launches} times, "
                             f"want {layers * SHARDS}")
    del g3c, gm

    # time per iteration: CUDA events around warm calls (host gaps and
    # the plan's index uploads included), then the device's busy time
    p3_ms = call_ms(lambda: run_p3_iteration(params, feats, plan, cfg),
                    iters=3, warmup=1)
    hop_ms = call_ms(lambda: engine.run_iteration(params, table, hg, cfg),
                     iters=3, warmup=1)
    log("p3", f"per iteration (CUDA events, warm): P3 {p3_ms:.3f} ms, "
              f"hopgnn (T={hg.num_steps}, pregather) {hop_ms:.3f} ms")
    device_profile(lambda: [run_p3_iteration(params, feats, plan, cfg)
                            for _ in range(3)], "p3", 3, "P3 iteration")
    device_profile(lambda: [engine.run_iteration(params, table, hg, cfg)
                            for _ in range(3)], "p3", 3, "hopgnn iteration")

    # the byte accounting of every strategy on these roots' trees
    spec = ModelSpec(feature_dim=cfg.feature_dim, hidden_dim=cfg.hidden_dim,
                     num_layers=cfg.num_layers,
                     param_bytes=model_param_bytes(params))
    micros, shard_of = [], []
    for s, blk in enumerate(plan.blocks):
        m = micrograph_split(blk)
        micros.extend(m)
        shard_of.extend([s] * len(m))
    eth = FABRICS["ethernet_10g"]
    acct = {"model_centric": model_centric_bytes(micros, store.owner,
                                                 shard_of, spec, SHARDS),
            "naive_fc": naive_fc_bytes(micros, store.owner, spec, SHARDS),
            "hopgnn": hopgnn_bytes(hg.remote_rows_exact, hg.num_steps, spec,
                                   SHARDS),
            "p3": p3_bytes(micros, store.owner, shard_of, spec, SHARDS),
            "lo": lo_bytes(spec, SHARDS)}
    for name, b in acct.items():
        log("p3", f"comm_model {name}: total {b['total']} B (features "
                  f"{b['feature_bytes']}, grads {b['grad_bytes']}, model "
                  f"{b['model_bytes']}, intermediate "
                  f"{b['intermediate_bytes']}); modeled on 10 Gb/s "
                  f"Ethernet {1e3 * eth.seconds(b['total'] / SHARDS):.3f} "
                  f"ms per shard")
    log("p3", f"hopgnn remote rows (plan, exact) {hg.remote_rows_exact}, "
              f"model-centric remote rows "
              f"{acct['model_centric']['remote_rows']}; "
              f"P3Plan.activation_bytes {plan.activation_bytes()} B; params "
              f"{spec.param_bytes} B")
    del params, feats, table, plan, mc, hg
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# Phase stream: streamed (out-of-core) training from a spilled store
# ---------------------------------------------------------------------------

def stream_trainer(ds, table, part, cfg, seed: int):
    """Phase ckpt's Trainer (merging off, the default resilience policy)
    without checkpoints, over ``table``: a resident or a tiered store."""
    return Trainer(graph=ds.graph, labels=ds.labels, part=part,
                   owner=table.owner, local_idx=table.local_idx,
                   table=table, cfg=cfg, optimizer=train_optimizer(),
                   init_seed=seed, strategy="hopgnn", pregather=True,
                   merging=False, train_vertices=ds.train_vertices(),
                   device=DEVICE)


def spill(ds, part, directory: str, budget: int):
    t0 = time.perf_counter()
    st = FeatureStore.build(ds.features, part, SHARDS, directory=directory,
                            host_budget_bytes=budget)
    return st, time.perf_counter() - t0


def log_stream(tag: str, stats) -> None:
    for st in stats:
        n = max(st.plans_built, 1)
        log("stream", f"{tag} epoch {st.epoch}: loss {st.loss!r}, steady "
                      f"{1e3 * st.steady_time_s / STREAM_ITERS:.2f} ms/iter,"
                      f" plan {1e3 * st.plan_time_s / n:.2f} ms/plan "
                      f"({st.plans_built} plans, host tier reads included),"
                      f" tier-1 rows {st.tier1_rows} ({st.tier1_bytes} B), "
                      f"tier-2 rows {st.tier2_rows} ({st.tier2_bytes} B), "
                      f"upload {st.upload_bytes // STREAM_ITERS} B/plan, "
                      f"readahead {1e3 * st.readahead_s:.1f} ms, traces "
                      f"{st.traces}, attempts {st.epoch_attempts}, "
                      f"rollbacks {st.rollbacks}, crc failures "
                      f"{st.crc_failures}, repaired rows {st.repaired_rows},"
                      f" wall {st.time_s:.3f} s")


def phase_stream(ds, store, part, cfg, seed: int) -> int:
    base = os.path.join(ROOT, "build", "chip_smoke_stream")
    shutil.rmtree(base, ignore_errors=True)
    budget = store.backing_nbytes() // 3
    layers = cfg.num_layers + 1
    per_run = layers * SHARDS * SHARDS * STREAM_ITERS * STREAM_EPOCHS
    args = (STREAM_EPOCHS, STREAM_ITERS)

    # 1. resident baseline
    tr = stream_trainer(ds, store, part, cfg, seed)
    reset_launches()
    passes = plan_passes(tr)
    t0 = time.perf_counter()
    sr = tr.fit(*args, batch_per_model=TRAIN_BATCH)
    window_end("gnn_train_resident")
    sampled = sample_end("gnn_train_resident", plan_passes(tr) - passes,
                         cfg.num_layers)
    steady = [round(1e3 * s.steady_time_s / STREAM_ITERS, 2) for s in sr]
    log("stream", f"resident run {time.perf_counter() - t0:.2f} s; steady "
                  f"{steady} ms/iter; {sampled}")

    # 2. streamed straight run, traced — counts zeroed just before it
    sp, spill_s = spill(ds, part, os.path.join(base, "straight"), budget)
    ts = stream_trainer(ds, sp, part, cfg, seed)
    log("stream", f"features spilled to {SHARDS} .npy shards under "
                  f"{os.path.relpath(base, ROOT)}/ in {spill_s:.2f} s "
                  f"({sp.backing_nbytes()} B, checksums "
                  f"{sp.checksums_enabled}); host hot tier budget {budget} B"
                  f" ({sp.hot_rows} rows per shard of {sp.local_rows}); "
                  f"{STREAM_EPOCHS} epochs x {STREAM_ITERS} iterations, "
                  f"merging off, spans on")
    trace.clear()
    trace.enable()
    reset_launches()
    passes = plan_passes(ts)
    t0 = time.perf_counter()
    try:
        ss = ts.fit(*args, batch_per_model=TRAIN_BATCH)
    finally:
        trace.disable()
    wall = time.perf_counter() - t0
    launches = window_end("gnn_train_streamed")
    sampled = sample_end("gnn_train_streamed", plan_passes(ts) - passes,
                         cfg.num_layers)
    log_stream("streamed", ss)
    path = export_chrome_trace(os.path.join(base, "streamed_trace.json"),
                               manifest=run_manifest(seed=seed))
    trace.clear()
    doc = json.loads(open(path).read())
    problems = validate_chrome_trace(doc)
    tracks = trace_track_names(doc)
    want_tracks = {"main", "prefetch", "uploader", "cache+readahead"}
    bitwise = [a.loss for a in sr] == [b.loss for b in ss] \
        and same_state(tr, ts)
    retraces = sum(s.traces for s in ss[1:])
    log("stream", f"streamed run {wall:.2f} s; vs resident: losses and "
                  f"parameters bitwise {bitwise}; gather_rows launches "
                  f"{launches} (want {per_run} = (layers+1) x shards x "
                  f"steps x iterations); new signatures after epoch 0 "
                  f"{retraces}; l_max {ts.budget.l_max}, r_max "
                  f"{ts.budget.r_max}; {sampled}")
    log("stream", f"trace {os.path.relpath(path, ROOT)}: "
                  f"{doc['otherData']['span_records']} records, "
                  f"{sum(1 for e in doc['traceEvents'] if e['ph'] == 'X')} "
                  f"spans, tracks {sorted(tracks)}, validation problems "
                  f"{len(problems)}")
    if not bitwise:
        raise AssertionError("the streamed run is not bitwise the resident "
                             "run")
    if launches != per_run:
        raise AssertionError(f"streamed training launched gather_rows "
                             f"{launches} times, want {per_run}")
    if retraces != 0:
        raise AssertionError(f"{retraces} new signatures after epoch 0")
    if not all(s.tier1_rows > 0 for s in ss[1:]):
        raise AssertionError("readahead did not warm the hot tier")
    if problems or not want_tracks <= tracks:
        raise AssertionError(f"exported trace: problems {problems[:5]}, "
                             f"tracks {sorted(tracks)}")

    # 3. the reference's whole recoverable plan on a second spilled store
    fp = FaultPlan.recoverable(seed=3)
    sf_store, _ = spill(ds, part, os.path.join(base, "faulted"), budget)
    tf = stream_trainer(ds, sf_store, part, cfg, seed)
    reset_launches()
    passes = plan_passes(tf)
    t0 = time.perf_counter()
    with fp.active():
        sf = tf.fit(*args, batch_per_model=TRAIN_BATCH)
    wall_f = time.perf_counter() - t0
    window_end("gnn_train_streamed_faulted")
    sampled = sample_end("gnn_train_streamed_faulted",
                         plan_passes(tf) - passes, cfg.num_layers)
    log_stream("faulted", sf)
    kinds = sorted({k for k, *_ in fp.fired})
    rollbacks = sum(s.rollbacks for s in sf)
    crc = sum(s.crc_failures for s in sf)
    repaired = sum(s.repaired_rows for s in sf)
    bitwise_f = [a.loss for a in ss] == [b.loss for b in sf] \
        and same_state(ts, tf)
    log("stream", f"faulted run {wall_f:.2f} s; fired {fp.fired}; vs the "
                  f"straight streamed run: losses and parameters bitwise "
                  f"{bitwise_f}; kinds fired {kinds}; rollbacks {rollbacks};"
                  f" crc failures {crc}, repaired rows {repaired}; "
                  f"gather_rows launches {ga.launches['gather_rows']} "
                  f"(replays add to {per_run}); {sampled}")
    if kinds != sorted({sp.kind for sp in fp.specs}) or len(kinds) != 5:
        raise AssertionError(f"fault kinds fired {kinds}")
    if not bitwise_f:
        raise AssertionError("the faulted streamed run is not bitwise the "
                             "straight one")
    if rollbacks != 1 or crc < 1 or repaired < 1:
        raise AssertionError(f"rollbacks {rollbacks}, crc failures {crc}, "
                             f"repaired rows {repaired}")

    # the kernel at the streamed hop sizes: (shard 0, step 0) of a fresh
    # plan, on shard 0's workspace [feat_local | feat_fetch]
    plan = ts.build_plan(STREAM_EPOCHS + 1, 0, TRAIN_BATCH)
    d = cfg.feature_dim
    ws = torch.cat([torch.from_numpy(plan.feat_local[0]),
                    torch.from_numpy(plan.feat_fetch[0]).reshape(-1, d)],
                   0).to(DEVICE)
    tot = time_gather_rows("stream", "streamed", ws, [
        torch.from_numpy(np.ascontiguousarray(h[0, 0])).to(DEVICE)
        for h in plan.hop_idx])
    log("stream", f"gather_rows, {layers} hops of one (shard, step): device "
                  f"{tot['ms']:.5f} ms (plain {tot['plain_ms']:.5f}, "
                  f"index_select {tot['library_ms']:.5f}, bound "
                  f"{tot['bound_ms']:.5f}); workspace l_max {plan.l_max} + "
                  f"{SHARDS} x r_max {plan.r_max} rows")
    del plan, ws

    # one more epoch of the straight run's loop, profiled (it moves the
    # straight run's state on, so it comes after the comparisons)
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(1, thread_name_prefix="prefetch") as pool:
        device_profile(lambda: run_pipelined_epoch(
            ts, STREAM_EPOCHS, STREAM_ITERS, TRAIN_BATCH, pool.submit,
            loss_sync_iters=ts.loss_sync_iters), "stream", STREAM_ITERS,
            "iteration")
    ts._close_plan_pool()
    del tr, ts, tf, sp, sf_store
    torch.cuda.empty_cache()
    for sub in ("straight", "faulted"):
        shutil.rmtree(os.path.join(base, sub), ignore_errors=True)
    return launches


# ---------------------------------------------------------------------------
# Phase mesh: LeapGNN training over a real device mesh (NCCL)
# ---------------------------------------------------------------------------

def join_mesh(rank: int, world: int, store_path: str):
    """This process as rank ``rank`` of a ``world``-rank NCCL process group
    (rendezvous through a FileStore under build/, a collective that
    mismatches fails after MESH_TIMEOUT_S) and its 1-D mesh over the
    ``"data"`` axis, on card ``rank``."""
    torch.cuda.set_device(rank)
    os.environ["LOCAL_RANK"] = str(rank)
    dist.init_process_group(
        "nccl", store=dist.FileStore(store_path, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    return init_device_mesh("cuda", (world,), mesh_dim_names=("data",))


def mesh_trainer(ds, store, part, cfg, seed: int, mesh=None, **kw):
    """Phase 5's Trainer with merging off unless asked (the controller is
    fed wall-clock times) and the default resilience policy: over ``mesh``
    one rank per shard, else every shard emulated on this card."""
    kw.setdefault("merging", False)
    return Trainer(graph=ds.graph, labels=ds.labels, part=part,
                   owner=store.owner, local_idx=store.local_idx, table=store,
                   cfg=cfg, optimizer=train_optimizer(), init_seed=seed,
                   strategy="hopgnn", pregather=True,
                   train_vertices=ds.train_vertices(), mesh=mesh,
                   device=None if mesh is not None else "cuda", **kw)


def flat(tensors) -> torch.Tensor:
    return torch.cat([t.detach().reshape(-1).float() for t in tensors])


def rank_checksums(tensors) -> torch.Tensor:
    """One int64 per tensor: its bits weighted by position, so two ranks'
    tensors agree in every checksum only if they agree bit for bit (up to
    a collision)."""
    out = []
    for t in tensors:
        bits = t.detach().reshape(-1).contiguous().view(torch.int32) \
            .to("cuda").long()
        w = torch.arange(bits.numel(), device=bits.device) % 65521 + 1
        out.append((bits * w).sum())
    return torch.stack(out)


def mesh_iterations(mesh, world: int, ds, store, part, cfg, params,
                    seed: int, lead: bool) -> None:
    """One iteration per mode through run_iteration(mesh=...) against the
    emulated iteration on rank 0's card (broadcast to every rank): bitwise
    over one rank, within MESH_TOL over several; the collectives each ran."""
    group = engine.mesh_group(mesh)
    rng = np.random.default_rng(seed + 5)
    roots = [rng.choice(ds.train_vertices(), TRAIN_BATCH, replace=False)
             for _ in range(world)]
    dense = store.as_dense()
    full = engine.upload(dense, "cuda") if lead else None
    for name, pregather, fold in MESH_MODES:
        plan = plan_iteration(ds.graph, ds.labels, part, store.owner,
                              store.local_idx, store.local_rows, roots,
                              num_layers=cfg.num_layers, fanout=cfg.fanout,
                              strategy="hopgnn", pregather=pregather,
                              sample_seed=P3_SAMPLE_SEED)
        g_m, l_m = engine.run_iteration(params, dense, plan, cfg, mesh=mesh,
                                        fold_returns=fold)
        fn = engine.get_compiled_iteration(
            cfg, pregather, mesh=mesh,
            fold_returns=engine.resolve_fold_returns(plan, fold))
        counts = engine.collective_counts(
            fn, params, *engine.prepare_iteration_args(dense, plan,
                                                       mesh=mesh))
        mine = flat(list(g_m) + [l_m])
        want = torch.empty_like(mine)
        if lead:
            g_e, l_e = engine.run_iteration(params, full, plan, cfg,
                                            fold_returns=fold)
            want = flat(list(g_e) + [l_e])
        dist.broadcast(want, 0, group=group)
        err = float((mine - want).abs().max())
        same = bool(torch.equal(mine, want))
        errs = engine.agree_max([err, not same], mesh)
        a2a = {"pregather": 2, "per-step": plan.num_steps + 1,
               "per-step folded": 2}[name]
        ok_counts = counts == {"all_to_all": a2a, "all_reduce": 1}
        bad_counts = engine.agree_max([not ok_counts], mesh)[0]
        if lead:
            log("mesh", f"{name}: one iteration (T={plan.num_steps}, r_max "
                        f"{plan.r_max}, batch_pad {plan.batch_pad}) through "
                        f"run_iteration(mesh) vs the emulated one on rank 0's "
                        f"card: loss {float(l_m)!r} vs {float(want[-1])!r}, "
                        f"max abs err over loss and grad leaves {errs[0]!r} "
                        f"on the worst rank ("
                        + ("bitwise on every rank: "
                           f"{not errs[1]}" if world == 1 else
                           f"bound {MESH_TOL}") + f"); collectives {counts} "
                        f"(want all_to_all {a2a}, all_reduce 1)")
        if world == 1 and errs[1]:
            raise AssertionError(f"{name}: the sharded iteration over one "
                                 f"rank is not bitwise the emulated one")
        if errs[0] > MESH_TOL:
            raise AssertionError(f"{name}: sharded vs emulated max abs err "
                                 f"{errs[0]} > {MESH_TOL}")
        if bad_counts:
            raise AssertionError(f"{name}: collectives {counts}, want "
                                 f"all_to_all {a2a}, all_reduce 1")
    del full


def mesh_cost(mesh, world: int, trainer, cfg, lead: bool,
              emulated=None) -> dict:
    """What one built plan's iteration costs over the mesh, with no
    planning in flight: CUDA-event time of the sharded iteration (and of
    the emulated one on rank 0's card, the others waiting), the NCCL and
    other device time per iteration under torch.profiler, and the bytes
    each rank handed the all_to_alls and the all_reduce beside comm_model's
    hopgnn bytes for the same plan."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    plan = trainer.build_plan(99, 0, TRAIN_BATCH)
    plan.committed = None      # uploaded by each call, sharded or emulated
    trainer._close_plan_pool()
    run = lambda: engine.run_iteration(  # noqa: E731
        trainer.params, trainer.table, plan, cfg, mesh=mesh)
    # gather_rows at this rank's hops of (its shard, step 0), on its
    # workspace [local | fetched] after a real exchange; rank 0 times them
    # while the others wait
    table, cache, dev, _ = engine.prepare_iteration_args(
        trainer.table, plan, mesh=mesh)
    recv = engine.ShardComm(engine.mesh_group(mesh)).exchange(
        table[0], dev["req"][0])
    ws = torch.cat([table[0], cache[0], recv.reshape(-1, table.shape[-1])])
    engine.agree_max([0], mesh)
    hops = (time_gather_rows("mesh", f"rank 0 of {world}", ws,
                             [h[0, 0].contiguous() for h in dev["hop_idx"]])
            if lead else None)
    engine.agree_max([0], mesh)
    del table, cache, dev, recv, ws
    run()
    fn = engine.get_compiled_iteration(cfg, True, mesh=mesh)
    b0 = dict(fn.comm.nbytes)
    run()
    nbytes = {k: v - b0[k] for k, v in fn.comm.nbytes.items()}
    reps = 5
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    engine.agree_max([0], mesh)
    torch.cuda.synchronize()
    ev[0].record()
    for _ in range(reps):
        run()
    ev[1].record()
    torch.cuda.synchronize()
    sharded_ms = ev[0].elapsed_time(ev[1]) / reps
    emu_ms = None
    if lead and emulated is not None:
        table = emulated.table
        ev[0].record()
        for _ in range(reps):
            engine.run_iteration(trainer.params, table, plan, cfg)
        ev[1].record()
        torch.cuda.synchronize()
        emu_ms = ev[0].elapsed_time(ev[1]) / reps
    engine.agree_max([0], mesh)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            run()
        torch.cuda.synchronize()
    kinds = {"all_to_all": 0.0, "all_reduce": 0.0, "other": 0.0}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us() / 3
        if "nccl" in e.name.lower():
            kinds["all_reduce" if "allreduce" in e.name.lower()
                  else "all_to_all"] += us
        else:
            kinds["other"] += us
    off = (world - 1) / world
    # the link alone: the iteration's feature exchange and gradient
    # all_reduce at their sizes, issued back to back after a barrier, so
    # the time holds no skew between the ranks' hosts
    group = engine.mesh_group(mesh)
    feat = torch.ones((world, plan.r_max, cfg.feature_dim),
                      device=trainer.device)
    got = torch.empty_like(feat)
    flat_g = torch.ones(nbytes["all_reduce"] // 4, device=trainer.device)
    link = engine.agree_max([
        link_ms(mesh, lambda: dist.all_to_all_single(got, feat, group=group)),
        link_ms(mesh, lambda: dist.all_reduce(flat_g, group=group))], mesh)
    link_gbps = feat.numel() * 4 * off / link[0] / 1e6
    busbw = 2 * off * flat_g.numel() * 4 / link[1] / 1e6
    del feat, got, flat_g
    spec = ModelSpec(feature_dim=cfg.feature_dim, hidden_dim=cfg.hidden_dim,
                     num_layers=cfg.num_layers,
                     param_bytes=model_param_bytes(trainer.params))
    model = hopgnn_bytes(plan.remote_rows_exact, plan.num_steps, spec, world)
    per_rank = engine.agree_max([kinds["all_to_all"], kinds["all_reduce"],
                                 kinds["other"], sharded_ms], mesh)
    a2a_ms = kinds["all_to_all"] / 1e3
    bw = (nbytes["all_to_all"] * off / (a2a_ms / 1e3)
          if a2a_ms > 0 else float("nan"))
    out = dict(sharded_ms=sharded_ms, emulated_ms=emu_ms,
               nccl_a2a_ms=a2a_ms, nccl_allreduce_ms=kinds["all_reduce"] / 1e3,
               other_device_ms=kinds["other"] / 1e3,
               worst_rank_ms=[v / 1e3 for v in per_rank[:3]]
               + [per_rank[3]],
               a2a_bytes=nbytes["all_to_all"],
               a2a_offrank_bytes=int(nbytes["all_to_all"] * off),
               allreduce_bytes=nbytes["all_reduce"],
               model_feature_bytes=model["feature_bytes"],
               model_grad_bytes=model["grad_bytes"],
               remote_rows=plan.remote_rows_exact, r_max=plan.r_max,
               T=plan.num_steps, a2a_gbps=bw / 1e9, gather_rows=hops,
               link_a2a_ms=link[0], link_allreduce_ms=link[1],
               link_a2a_gbps=link_gbps, link_allreduce_busbw_gbps=busbw)
    if lead:
        log("mesh", f"gather_rows, {cfg.num_layers + 1} hops of "
                    f"rank 0's (shard, step): device {hops['ms']:.5f} ms "
                    f"(plain {hops['plain_ms']:.5f}, index_select "
                    f"{hops['library_ms']:.5f}, bound {hops['bound_ms']:.5f})")
        log("mesh", f"one built plan's iteration (T={plan.num_steps}, r_max "
                    f"{plan.r_max}, {plan.remote_rows_exact} remote rows), "
                    f"no planning in flight, CUDA events over {reps}: "
                    f"sharded {sharded_ms:.3f} ms/iter on rank 0 (worst rank"
                    f" {per_rank[3]:.3f})"
                    + (f", emulated {emu_ms:.3f} ms/iter (the {world} "
                       f"shard(s) on rank 0's card)" if emu_ms is not None
                       else ""))
        log("mesh", f"device per iteration under torch.profiler, rank 0: "
                    f"NCCL all_to_all {a2a_ms:.4f} ms, all_reduce "
                    f"{kinds['all_reduce'] / 1e3:.4f} ms (kernel time, "
                    f"waits for peers included), other kernels and copies "
                    f"{kinds['other'] / 1e3:.4f} ms; worst rank "
                    f"{per_rank[0] / 1e3:.4f}, {per_rank[1] / 1e3:.4f}, "
                    f"{per_rank[2] / 1e3:.4f} ms")
        log("mesh", f"bytes per iteration on each rank: all_to_all "
                    f"{nbytes['all_to_all']} B handed in "
                    f"({out['a2a_offrank_bytes']} B to other ranks), "
                    f"all_reduce {nbytes['all_reduce']} B; comm_model hopgnn "
                    f"for this plan: features {model['feature_bytes']} B "
                    f"over all ranks ({plan.remote_rows_exact} deduped rows),"
                    f" grads {model['grad_bytes']} B; all_to_all rate in "
                    f"the iteration {out['a2a_gbps']:.2f} GB/s off-rank "
                    f"(bytes to other ranks over its kernel time, waits "
                    f"included)")
        log("mesh", f"the link alone, CUDA events over back-to-back calls "
                    f"after a barrier, slowest rank: all_to_all of "
                    f"({world}, {plan.r_max}, {cfg.feature_dim}) f32 "
                    f"{link[0]:.4f} ms = {link_gbps:.2f} GB/s off-rank per "
                    f"rank; all_reduce of {nbytes['all_reduce']} B "
                    f"{link[1]:.4f} ms = {busbw:.2f} GB/s bus bandwidth "
                    f"(2(P-1)/P x bytes / time)")
    return out


def link_ms(mesh, fn, reps: int = 20) -> float:
    """Device time per call of the collective ``fn`` on this rank: a
    barrier, one warm call, then ``reps`` calls back to back between CUDA
    events."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    engine.agree_max([0], mesh)
    fn()
    torch.cuda.synchronize()
    engine.agree_max([0], mesh)
    ev[0].record()
    for _ in range(reps):
        fn()
    ev[1].record()
    torch.cuda.synchronize()
    return ev[0].elapsed_time(ev[1]) / reps


def mesh_fit_log(tag: str, stats, iters: int) -> None:
    for st in stats:
        n = max(st.plans_built, 1)
        log("mesh", f"{tag} epoch {st.epoch}: loss {st.loss!r}, merge "
                    f"pattern {st.num_steps}, steady "
                    f"{1e3 * st.steady_time_s / iters:.2f} ms/iter, plan "
                    f"{1e3 * st.plan_time_s / n:.2f} ms/plan, traces "
                    f"{st.traces}, attempts {st.epoch_attempts}, rollbacks "
                    f"{st.rollbacks}, wall {st.time_s:.3f} s")


def phase_mesh1(ds, cfg, seed: int) -> int:
    """[mesh] at world size 1: a one-rank NCCL process group in this
    process, the products world in one shard. Returns the main path's
    gather_rows launches (the Trainer(mesh) fit)."""
    base = os.path.join(ROOT, "build", "chip_smoke_mesh")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    mesh = join_mesh(0, 1, os.path.join(base, "store1"))
    t_phase = time.perf_counter()
    try:
        t0 = time.perf_counter()
        part = community_partition(ds.communities, 1)
        table, owner, local_idx = shard_features(ds.features, part, 1)
        store = FeatureStore.from_array(table, owner=owner,
                                        local_idx=local_idx)
        log("mesh", f"card {card_line()}; a 1-rank NCCL group (FileStore "
                    f"under {os.path.relpath(base, ROOT)}/), mesh "
                    f"{tuple(mesh.shape)} over 'data' on "
                    f"{engine.mesh_device(mesh)}; products in 1 shard "
                    f"({store.local_rows} rows) in "
                    f"{time.perf_counter() - t0:.2f} s")
        # a zero-size exchange (r_max = 0): NCCL gets it like any other
        comm = engine.ShardComm(engine.mesh_group(mesh))
        got = comm.exchange(torch.zeros((1, 4, cfg.feature_dim),
                                        device="cuda")[0],
                            torch.zeros((1, 0), dtype=torch.int32,
                                        device="cuda"))
        torch.cuda.synchronize()
        log("mesh", f"zero-size exchange (r_max 0): shape "
                    f"{tuple(got.shape)}, collectives {comm.counts}")
        if tuple(got.shape) != (1, 0, cfg.feature_dim):
            raise AssertionError(f"zero-size exchange gave {got.shape}")
        tm = mesh_trainer(ds, store, part, cfg, seed, mesh=mesh)
        mesh_iterations(mesh, 1, ds, store, part, cfg, tm.params, seed,
                        True)

        # the main path: counts zeroed just before the mesh fit, read after
        reset_launches()
        passes = plan_passes(tm)
        t0 = time.perf_counter()
        sm = tm.fit(MESH_EPOCHS, MESH_ITERS, batch_per_model=TRAIN_BATCH)
        wall_m = time.perf_counter() - t0
        launches = window_end("gnn_train_mesh")
        sampled = sample_end("gnn_train_mesh", plan_passes(tm) - passes,
                             cfg.num_layers)
        mesh_fit_log("sharded", sm, MESH_ITERS)
        te = mesh_trainer(ds, store, part, cfg, seed)
        reset_launches()
        passes = plan_passes(te)
        t0 = time.perf_counter()
        se = te.fit(MESH_EPOCHS, MESH_ITERS, batch_per_model=TRAIN_BATCH)
        wall_e = time.perf_counter() - t0
        window_end("gnn_train_mesh_emulated")
        sampled += "; emulated: " + sample_end(
            "gnn_train_mesh_emulated", plan_passes(te) - passes,
            cfg.num_layers)
        mesh_fit_log("emulated", se, MESH_ITERS)
        want = sum((cfg.num_layers + 1) * st.num_steps * MESH_ITERS
                   for st in sm)
        bitwise = [a.loss for a in sm] == [b.loss for b in se] \
            and same_state(tm, te)
        new_sigs = sum(st.traces for st in sm[1:])
        log("mesh", f"Trainer(mesh) fit {MESH_EPOCHS}x{MESH_ITERS} in "
                    f"{wall_m:.2f} s (emulated {wall_e:.2f} s): losses and "
                    f"parameters bitwise the emulated Trainer's {bitwise}; "
                    f"gather_rows launches {launches} (want {want} = "
                    f"(layers+1) x T x iterations); new signatures after "
                    f"epoch 0 {new_sigs}; trace kinds "
                    f"{sorted({r[0] for r in engine.trace_log()})}; "
                    f"{sampled}")
        if not bitwise:
            raise AssertionError("the 1-rank mesh fit is not bitwise the "
                                 "emulated fit")
        if launches != want:
            raise AssertionError(f"gather_rows launched {launches} times, "
                                 f"want {want}")
        if new_sigs:
            raise AssertionError(f"{new_sigs} new signatures after epoch 0")
        mesh_cost(mesh, 1, tm, cfg, True, emulated=te)
        del tm, te
        torch.cuda.empty_cache()
        log("mesh", f"phase done in {time.perf_counter() - t_phase:.1f} s")
        return launches
    finally:
        dist.destroy_process_group()


def mesh_rank_main(rank: int, world: int, seed: int, base: str) -> None:
    """One rank of the [mesh] phase at world size > 1 (spawned, one per
    card). Every gate is agreed across ranks before it raises, so the
    ranks fail together; rank 0 logs and writes the summary."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = join_mesh(rank, world, os.path.join(base, "store"))
    lead = rank == 0
    try:
        t0 = time.perf_counter()
        ds = make_dataset("products", scale=1.0, seed=seed)
        part = community_partition(ds.communities, world)
        table, owner, local_idx = shard_features(ds.features, part, world)
        store = FeatureStore.from_array(table, owner=owner,
                                        local_idx=local_idx)
        cfg = GNNConfig(model="sage", num_layers=3, hidden_dim=128,
                        feature_dim=ds.feature_dim,
                        num_classes=ds.num_classes, fanout=10)
        if lead:
            log("mesh", f"card {card_line()}; {world} ranks, one per card "
                        f"(NCCL, FileStore under "
                        f"{os.path.relpath(base, ROOT)}/); products "
                        f"{ds.num_vertices} vertices in {world} shards of "
                        f"{store.local_rows} rows; sage 3x128 fanout 10; "
                        f"set up in {time.perf_counter() - t0:.2f} s")
        ts = mesh_trainer(ds, store, part, cfg, seed, mesh=mesh)
        mesh_iterations(mesh, world, ds, store, part, cfg, ts.params, seed,
                        lead)
        layers = cfg.num_layers + 1

        # the straight sharded fit: counts zeroed just before, read after
        reset_launches()
        passes = plan_passes(ts)
        t0 = time.perf_counter()
        ss = ts.fit(MESH4_EPOCHS, MESH_ITERS, batch_per_model=TRAIN_BATCH)
        wall = time.perf_counter() - t0
        launches = window_end("gnn_train_mesh")
        # sample_tree: one launch per hop of every plan pass on this rank
        sampled = [sk.launches["sample_tree"],
                   cfg.num_layers * (plan_passes(ts) - passes)]
        SAMPLE_BY_PATH["gnn_train_mesh"] = sampled[0]
        want = sum(layers * st.num_steps * MESH_ITERS for st in ss)
        if lead:
            mesh_fit_log("sharded", ss, MESH_ITERS)
        losses = torch.tensor([st.loss for st in ss], dtype=torch.float64,
                              device="cuda")
        if lead:
            te = mesh_trainer(ds, store, part, cfg, seed)
            se = te.fit(MESH4_EPOCHS, MESH_ITERS,
                        batch_per_model=TRAIN_BATCH)
            mesh_fit_log("emulated", se, MESH_ITERS)
            emu = torch.tensor([st.loss for st in se], dtype=torch.float64,
                               device="cuda")
        else:
            te, emu = None, torch.empty_like(losses)
        dist.broadcast(emu, 0, group=engine.mesh_group(mesh))
        rel = float(((losses - emu).abs() / emu.abs()).max())
        sums = rank_checksums(state_tensors(ts))
        every = [torch.empty_like(sums) for _ in range(world)]
        dist.all_gather(every, sums, group=engine.mesh_group(mesh))
        same_params = all(torch.equal(every[0], s) for s in every)
        counts = engine.agree_max([rel, launches != want, launches,
                                   AGG_BY_PATH["gnn_train_mesh"],
                                   sampled[0] != sampled[1]], mesh)
        if lead:
            log("mesh", f"Trainer(mesh) fit {MESH4_EPOCHS}x{MESH_ITERS} in "
                        f"{wall:.2f} s: losses vs the emulated Trainer's "
                        f"max rel err {counts[0]!r} over ranks (bound "
                        f"{MESH_FIT_RTOL}); parameters and moments bitwise "
                        f"equal across ranks (all_gather of "
                        f"{sums.numel()} checksums) {same_params}; "
                        f"gather_rows launches per rank {launches} (want "
                        f"{want} = (layers+1) x T x iterations; worst rank "
                        f"{int(counts[2])}); gather_agg launches, worst "
                        f"rank {int(counts[3])}; sample_tree launches on "
                        f"rank 0 {sampled[0]} (want {sampled[1]} = "
                        f"{cfg.num_layers} x plan passes), every rank as "
                        f"wanted {not counts[4]}")
        if counts[0] > MESH_FIT_RTOL:
            raise AssertionError(f"mesh fit losses vs emulated rel err "
                                 f"{counts[0]} > {MESH_FIT_RTOL}")
        if not same_params:
            raise AssertionError("parameters differ across ranks")
        if counts[1]:
            raise AssertionError(f"gather_rows launched {launches} times "
                                 f"on a rank, want {want}")
        if counts[3]:
            raise AssertionError(f"the sharded fit launched gather_agg "
                                 f"{int(counts[3])} times on a rank")
        if counts[4]:
            raise AssertionError(f"sample_tree launched {sampled[0]} times "
                                 f"over {sampled[1] // cfg.num_layers} plan"
                                 f" passes on a rank")
        cost = mesh_cost(mesh, world, ts, cfg, lead, emulated=te)
        del te

        # merging on: every rank must walk the same merge patterns
        tm = mesh_trainer(ds, store, part, cfg, seed, mesh=mesh,
                          merging=True)
        sk.reset_launches()
        passes = plan_passes(tm)
        sm = tm.fit(MESH4_EPOCHS, MESH_ITERS, batch_per_model=TRAIN_BATCH)
        sampled_m = (sk.launches["sample_tree"]
                     != cfg.num_layers * (plan_passes(tm) - passes))
        pat = torch.tensor([st.num_steps for st in sm], device="cuda")
        every = [torch.empty_like(pat) for _ in range(world)]
        dist.all_gather(every, pat, group=engine.mesh_group(mesh))
        same_pat = all(torch.equal(every[0], p) for p in every)
        if lead:
            mesh_fit_log("merging", sm, MESH_ITERS)
            log("mesh", f"merging on: patterns per rank "
                        f"{[p.tolist() for p in every]}; the same on every "
                        f"rank {same_pat}")
        if not same_pat:
            raise AssertionError("ranks walked different merge patterns")
        del tm

        # the straight fit again under faults, as in [ckpt]
        fp = FaultPlan([
            FaultSpec("thread_exc", epoch=1, it=1, site="prefetch"),
            FaultSpec("comm_delay", epoch=1, it=3, delay_s=0.003),
            FaultSpec("comm_drop", epoch=1, it=4, drops=1),
            FaultSpec("nan_loss", epoch=2, it=4)], seed=seed, name="mesh")
        tf = mesh_trainer(ds, store, part, cfg, seed, mesh=mesh)
        sk.reset_launches()
        passes = plan_passes(tf)
        with fp.active():
            sf = tf.fit(MESH4_EPOCHS, MESH_ITERS,
                        batch_per_model=TRAIN_BATCH)
        sampled_f = (sk.launches["sample_tree"]
                     != cfg.num_layers * (plan_passes(tf) - passes))
        kinds = sorted({k for k, *_ in fp.fired})
        bitwise = [a.loss for a in ss] == [b.loss for b in sf] \
            and same_state(ts, tf)
        bad = engine.agree_max([not bitwise,
                                kinds != sorted({s.kind for s in fp.specs}),
                                sampled_m, sampled_f], mesh)
        if lead:
            mesh_fit_log("faulted", sf, MESH_ITERS)
            log("mesh", f"faulted sharded run: fired {fp.fired}; losses, "
                        f"parameters and moments bitwise the straight "
                        f"sharded run on every rank {not bad[0]}; rollbacks "
                        f"{sum(st.rollbacks for st in sf)}; sample_tree "
                        f"launches {cfg.num_layers} per plan pass on every "
                        f"rank, merging {not bad[2]}, faulted {not bad[3]}")
        if bad[0] or bad[1]:
            raise AssertionError(f"faulted sharded run: bitwise "
                                 f"{not bad[0]}, kinds {kinds}")
        if bad[2] or bad[3]:
            raise AssertionError(f"sample_tree did not launch "
                                 f"{cfg.num_layers} times per plan pass on "
                                 f"a rank: merging {bool(bad[2])}, faulted "
                                 f"{bool(bad[3])}")
        if lead:
            summary = dict(world=world, launches_per_rank=launches,
                           gather_agg_launches=int(counts[3]),
                           sample_tree_launches=sampled[0],
                           fit_rel_err=counts[0], cost=cost,
                           steady_ms=[1e3 * st.steady_time_s / MESH_ITERS
                                      for st in ss],
                           plan_ms=[1e3 * st.plan_time_s
                                    / max(st.plans_built, 1) for st in ss],
                           patterns=pat.tolist())
            with open(os.path.join(base, "summary.json"), "w") as f:
                json.dump(summary, f)
    finally:
        dist.destroy_process_group()


def phase_mesh(world: int, seed: int) -> dict:
    """[mesh] at world size > 1: spawn one rank per card and collect rank
    0's summary. Needs ``world`` cards; there is no fallback."""
    if torch.cuda.device_count() < world:
        raise RuntimeError(f"--world {world} needs {world} cards, "
                           f"{torch.cuda.device_count()} visible")
    import torch.multiprocessing as tmp
    base = os.path.join(ROOT, "build", "chip_smoke_mesh")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    t0 = time.perf_counter()
    tmp.spawn(mesh_rank_main, args=(world, seed, base), nprocs=world,
              join=True)
    with open(os.path.join(base, "summary.json")) as f:
        summary = json.load(f)
    log("mesh", f"{world} ranks done in {time.perf_counter() - t0:.1f} s")
    return summary


LM_MESH_TOL = 1e-5     # sharded vs one-card step, share of a leaf's max
LM_MESH_LR = 0.1       # SGD: the parameters after the step hold the grads


def lm_mesh_rank_main(rank: int, world: int, seed: int, base: str,
                      device: str = "cuda", backend: str = "nccl") -> None:
    """[lm-mesh], one rank of a (2, world/2) ("data", "model") mesh: the
    2-layer full-width f32 qwen2-1.5b step (SGD, so the parameters after
    it hold the gradient to the same bound; AdamW's first step divides by
    each element's own |g|) and its prefill logits, placed by
    launch/sharding.py, against the same step on plain tensors on this
    rank's card; rank 0 writes each share of a leaf's largest |value|."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.launch import sharding as shd
    from repro_torch.models.transformer.common import set_mesh_axes
    from repro_torch.optim import sgd
    if device == "cuda":
        torch.cuda.set_device(rank)
        os.environ["LOCAL_RANK"] = str(rank)
    dist.init_process_group(
        backend, store=dist.FileStore(os.path.join(base, "lm_store"), world),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    try:
        mesh = init_device_mesh(device, (2, world // 2),
                                mesh_dim_names=("data", "model"))
        set_mesh_axes(dp=("data",), tp=("model",))
        cfg = dataclasses.replace(get_config("qwen2-1.5b"), num_layers=2,
                                  dtype="float32")
        g = torch.Generator(device=device).manual_seed(seed)
        params = init_params(cfg, g, device)
        for layer in params["layers"]:
            for w in ("wq", "wk", "wv"):
                b = layer["attn"][w]["b"]
                b.copy_(0.1 * torch.randn(b.shape, generator=g,
                                          device=device))
        batch = {k: v.to(device)
                 for k, v in make_batch(cfg, 4, 512, seed).items()}
        opt = sgd(LM_MESH_LR)
        step = make_train_step(cfg, opt)

        def logits(p, b):
            with torch.no_grad():
                x, _ = forward_hidden(p, cfg, b)
                return x[:, -1] @ _head_matrix(p)

        def full(t):
            return t.full_tensor() if isinstance(t, DTensor) else t

        def share_of(got, want):
            got, want = full(got).detach().float(), want.detach().float()
            return float((got - want).abs().max() / want.abs().max())

        plain = copy.deepcopy(params)
        want_logits = logits(plain, batch)
        plain, _, m_plain = step(plain, opt.init(plain), batch)
        specs = shd.param_pspecs(params)
        d_params = shd.distribute(mesh, copy.deepcopy(params), specs)
        d_batch = shd.distribute(mesh, batch,
                                 shd.batch_pspecs(cfg, mesh, batch))
        with implicit_replication():
            got_logits = logits(d_params, d_batch)
            d_params, _, m = step(d_params, opt.init(params), d_batch)
        leaves = [share_of(a, b) for a, b in zip(tree_leaves(d_params),
                                                 tree_leaves(plain))]
        res = dict(loss=share_of(m["loss"], m_plain["loss"]),
                   logits=share_of(got_logits, want_logits),
                   worst_leaf=max(leaves), leaves=len(leaves),
                   loss_value=float(m_plain["loss"]),
                   mesh=list(mesh.shape))
        if rank == 0:
            with open(os.path.join(base, "lm_mesh.json"), "w") as f:
                json.dump(res, f)
    finally:
        dist.destroy_process_group()


def phase_lm_mesh(world: int, seed: int) -> dict:
    """[lm-mesh] at world size > 1: the transformer step over a real
    (2, world/2) NCCL mesh against the one-card step, within LM_MESH_TOL
    of each leaf's largest |value| (loss, prefill logits, every parameter
    after the step)."""
    import torch.multiprocessing as tmp
    base = os.path.join(ROOT, "build", "chip_smoke_lm_mesh")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    t0 = time.perf_counter()
    tmp.spawn(lm_mesh_rank_main, args=(world, seed, base), nprocs=world,
              join=True)
    with open(os.path.join(base, "lm_mesh.json")) as f:
        res = json.load(f)
    log("lm-mesh", f"qwen2-1.5b 2 layers f32 on a {res['mesh']} NCCL mesh "
                   f"vs one card: loss {res['loss_value']:.6f} (share "
                   f"{res['loss']:.3e}), prefill logits {res['logits']:.3e}"
                   f", worst of {res['leaves']} parameters after an SGD "
                   f"step {res['worst_leaf']:.3e} (bound {LM_MESH_TOL}); "
                   f"{time.perf_counter() - t0:.1f} s; {card_line()}")
    if max(res["loss"], res["logits"], res["worst_leaf"]) > LM_MESH_TOL:
        raise AssertionError(f"[lm-mesh] the sharded step differs: {res}")
    return res


# ---------------------------------------------------------------------------
# [dryrun]: LeapGNN's pod dry run, rank 0 of 256 and 512 shards
# ---------------------------------------------------------------------------

def run_python(args: list, what: str) -> str:
    """``python args`` from the checkout's root with the port on the path;
    its stdout. A non-zero exit, or DRYRUN_TIMEOUT_S passing (the child is
    killed), fails the run."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src")]
        + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
           if p]))
    proc = subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True,
                          timeout=DRYRUN_TIMEOUT_S)
    if proc.returncode != 0:
        raise AssertionError(f"{what} exited with {proc.returncode}:\n"
                             f"{proc.stdout[-2000:]}{proc.stderr[-4000:]}")
    return proc.stdout


def dryrun_world(n: int, seed: int) -> int:
    """``python -m repro_torch.launch.dryrun_gnn`` at the reference's
    default shapes on n shards: its [ok] line, then its record's census,
    memory, FLOPs, rank 0's time and launches, gated against the closed
    form. Returns the record's gather_rows launches (its measured call);
    sets AGG_BY_PATH for the path."""
    path = f"gnn_dryrun_{n}"
    out = dryrun_gnn.RESULTS_DIR / f"hopgnn.sage.{n}shards.json"
    out.unlink(missing_ok=True)
    t0 = time.perf_counter()
    stdout = run_python(["-m", "repro_torch.launch.dryrun_gnn",
                         *(["--multi-pod"] if n == 512 else []),
                         "--seed", str(seed)], f"the {n}-shard dry run")
    wall = time.perf_counter() - t0
    for line in stdout.splitlines():
        log("dryrun", line)
    rec = json.loads(out.read_text())
    sh, coll, mem = rec["shapes"], rec["collectives"], rec["memory"]
    L, r, d = sh["layers"], sh["r_max"], sh["feature_dim"]
    want = (L + 1) * n
    got = rec["launches"]["gather_rows"]
    AGG_BY_PATH[path] = rec["launches"]["gather_agg"]
    # the measured call runs a plan built beforehand: it samples nothing
    SAMPLE_BY_PATH[path] = rec["launches"]["sample_tree"]
    log("dryrun", f"{n} shards ({rec['mesh']}, T {rec['world']}, "
                  f"{rec['device']}; process {wall:.1f} s): per-rank census "
                  f"{coll['bytes_by_op']} B in {coll['count_by_op']}, total "
                  f"{coll['total_bytes']} B; ShardComm {rec['shard_comm']}")
    log("dryrun", f"{n} shards: memory argument "
                  f"{mem['argument_size_in_bytes']} B, output "
                  f"{mem['output_size_in_bytes']} B, temp (peak allocated "
                  f"over the call) {mem['temp_size_in_bytes']} B; flops "
                  f"(FlopCounterMode, all T steps, forward and backward) "
                  f"{rec['flops']:.0f}; rank 0's iteration "
                  f"{rec['iteration_ms']:.3f} ms by CUDA events, "
                  f"{rec['iteration_ms'] / rec['world']:.5f} ms per (shard, "
                  f"step); fake backend wrote the receive buffer "
                  f"{rec['fake_all_to_all_writes_receive_buffer']}; loss "
                  f"{rec['loss']:.6f}; {card_line()}")
    log("dryrun", f"{n} shards: gather_rows launches {got} (want {want}); "
                  f"gather_agg launches {rec['launches']['gather_agg']}; "
                  f"sample_tree launches {SAMPLE_BY_PATH[path]} (want 0)")
    a2a = n * r * 4 + n * r * d * 4
    checks = {
        "status ok": rec["status"] == "ok",
        "mesh": rec["mesh"] == f"{n}x1(data)",
        "gather_rows launches": got == want,
        "sample_tree launches": SAMPLE_BY_PATH[path] == 0,
        "census = ShardComm": rec["shard_comm"]["nbytes"] == {
            "all_to_all": coll["bytes_by_op"].get("all-to-all"),
            "all_reduce": coll["bytes_by_op"].get("all-reduce")},
        "counts": coll["count_by_op"] == {"all-to-all": 2, "all-reduce": 1},
        "all-to-all bytes n*r*4 + n*r*d*4": coll["bytes_by_op"].get(
            "all-to-all") == a2a,
        "all-reduce bytes = output": coll["bytes_by_op"].get("all-reduce")
        == mem["output_size_in_bytes"],
        "finite loss": np.isfinite(rec["loss"]),
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"the {n}-shard dry run failed {failed}")
    return got


_DRYRUN_8 = """
import json, sys, torch
from repro_torch.launch import dryrun_gnn
out = {}
for device in ("cuda", "cpu"):
    rec, grads, loss = dryrun_gnn.run(8, device=device, seed=int(sys.argv[2]),
                                      results_dir=None, batch_pad=4,
                                      r_max=256, feature_dim=128, hidden=32)
    out[device] = dict(rec=json.loads(json.dumps(rec)),
                       grads=[g.cpu() for g in grads],
                       loss=loss.cpu())
torch.save(out, sys.argv[1])
"""


def dryrun_card_vs_cpu(seed: int) -> None:
    """The dry run at world 8 with the narrowed shapes on the card and on
    the CPU, in one process (each run starts and destroys its own fake
    world): loss and every gradient leaf within DRYRUN_TOL of the leaf's
    largest |value|, the census equal."""
    base = os.path.join(ROOT, "build", "chip_smoke_dryrun")
    os.makedirs(base, exist_ok=True)
    saved = os.path.join(base, "world8.pt")
    run_python(["-c", _DRYRUN_8, saved, str(seed)], "the world-8 dry run")
    res = torch.load(saved)
    cu, cp = res["cuda"], res["cpu"]
    errs = [float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
            for a, b in zip(cu["grads"], cp["grads"])]
    e_loss = abs(float(cu["loss"]) - float(cp["loss"])) \
        / max(abs(float(cp["loss"])), 1e-30)
    same = cu["rec"]["collectives"] == cp["rec"]["collectives"]
    log("dryrun", f"world 8 (batch_pad 4, r_max 256, d 128, hidden 32), "
                  f"card vs CPU: loss {float(cu['loss']):.7f} vs "
                  f"{float(cp['loss']):.7f} (rel {e_loss:.3e}), worst grad "
                  f"leaf {max(errs):.3e} of its max over {len(errs)} leaves "
                  f"(bound {DRYRUN_TOL}); census equal {same}; gather_rows "
                  f"launches {cu['rec']['launches']['gather_rows']}; "
                  f"card {cu['rec']['iteration_ms']:.3f} ms, CPU "
                  f"{cp['rec']['iteration_ms']:.3f} ms")
    if not (max(errs) <= DRYRUN_TOL and e_loss <= DRYRUN_TOL and same):
        raise AssertionError("the world-8 dry run differs between the card "
                             "and the CPU")


def phase_dryrun(seed: int) -> dict:
    """[dryrun]: the 256- and 512-shard dry runs, each its own process;
    gather_rows bitwise at one step's hops on the 256-shard workspace; the
    world-8 dry run on the card against the CPU. Returns the main path's
    gather_rows launches per world (each the subprocess's own count over
    its measured call)."""
    t_phase = time.perf_counter()
    launches = {f"gnn_dryrun_{n}": dryrun_world(n, seed) for n in (256, 512)}
    cfg = GNNConfig(model="sage", num_layers=3, hidden_dim=128,
                    feature_dim=600, num_classes=dryrun_gnn.NUM_CLASSES,
                    fanout=10)
    _, table, cache, dev, _ = dryrun_gnn.shard_args(
        cfg, 256, batch_pad=8, local_rows=16384, r_max=2048, device="cuda",
        seed=seed)
    # rank 0's loopback workspace [local | cached | fetched]
    ws = torch.cat([table[0], cache[0],
                    table[0].index_select(0, dev["req"][0].reshape(-1)
                                          .long())], 0)
    tot = time_gather_rows("dryrun", "256-shard step 0", ws,
                           [h[0, 0] for h in dev["hop_idx"]])
    log("dryrun", f"gather_rows, one (shard, step)'s 4 hops on the "
                  f"{ws.shape[0]}-row workspace of width {ws.shape[1]}: "
                  f"device {tot['ms']:.5f} ms (plain {tot['plain_ms']:.5f}, "
                  f"index_select {tot['library_ms']:.5f}, bound "
                  f"{tot['bound_ms']:.5f})")
    del table, cache, dev, ws
    free_card()
    dryrun_card_vs_cpu(seed)
    log("dryrun", f"phase done in {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# [lm-dryrun]: the transformer pod dry run, and its placements on the card
# ---------------------------------------------------------------------------

# One train step and the prefill logits of qwen2-1.5b at full width, 2
# layers, f32, on a 1-rank group: the parameters, AdamW's state and the
# batch placed by launch/sharding.py as DTensors on a (1, 1) ("data",
# "model") mesh with the hints and the FSDP gather active, against the same
# step on plain tensors. argv: device, backend, seed, out.pt
_LM_MESH1 = """
import copy, dataclasses, json, os, sys
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import get_config
from repro_torch.data import make_batch
from repro_torch.kernels import gather_agg, linattn
from repro_torch.launch import sharding as shd
from repro_torch.launch.train import make_train_step, pick_optimizer
from repro_torch.models.transformer import init_params
from repro_torch.models.transformer.common import set_mesh_axes
from repro_torch.models.transformer.model import _head_matrix, forward_hidden
from repro_torch.optim import tree_leaves
device, backend, seed, out = sys.argv[1], sys.argv[2], int(sys.argv[3]), \\
    sys.argv[4]
dist.init_process_group(backend, init_method="file://" + out + ".rdv",
                        rank=0, world_size=1)
mesh = init_device_mesh(device, (1, 1), mesh_dim_names=("data", "model"))
set_mesh_axes(dp=("data",), tp=("model",))
cfg = dataclasses.replace(get_config("qwen2-1.5b"), num_layers=2,
                          dtype="float32")
g = torch.Generator(device=device).manual_seed(seed)
params = init_params(cfg, g, device)
for layer in params["layers"]:
    for w in ("wq", "wk", "wv"):
        b = layer["attn"][w]["b"]
        b.copy_(0.1 * torch.randn(b.shape, generator=g, device=device))
batch = {k: v.to(device) for k, v in make_batch(cfg, 4, 512, seed).items()}
opt = pick_optimizer(cfg)
step = make_train_step(cfg, opt)

def logits(p, b):
    with torch.no_grad():
        x, _ = forward_hidden(p, cfg, b)
        return x[:, -1] @ _head_matrix(p)

def full(t):
    return t.full_tensor() if isinstance(t, DTensor) else t

launched = {**gather_agg.launches, **linattn.launches}
plain = copy.deepcopy(params)
want_logits = logits(plain, batch)
plain, _, m_plain = step(plain, opt.init(plain), batch)
specs = shd.param_pspecs(params)
d_params = shd.distribute(mesh, copy.deepcopy(params), specs)
state = opt.init(params)
d_state = shd.distribute_opt_state(mesh, state, shd.opt_pspecs(state, specs))
d_batch = shd.distribute(mesh, batch, shd.batch_pspecs(cfg, mesh, batch))
with implicit_replication():
    got_logits = logits(d_params, d_batch)
    d_params, _, m = step(d_params, d_state, d_batch)
got, want = [full(t) for t in tree_leaves(d_params)], tree_leaves(plain)
res = dict(
    logits=bool(torch.equal(full(got_logits), want_logits)),
    loss=bool(torch.equal(full(m["loss"]), m_plain["loss"])),
    params=[bool(torch.equal(a, b)) for a, b in zip(got, want)],
    worst=max(float((a - b).abs().max()) for a, b in zip(got, want)),
    logit_err=float((full(got_logits) - want_logits).abs().max()),
    loss_value=float(m_plain["loss"]),
    dtensors=sum(isinstance(t, DTensor) for t in tree_leaves(d_params)),
    launches={k: v - launched[k]
              for k, v in {**gather_agg.launches,
                           **linattn.launches}.items()})
dist.destroy_process_group()
torch.save(res, out)
"""

# The dry runs [lm-dryrun] runs, each its own process and all at once:
# (arch, shape, meshes). A train, a prefill and decodes, both meshes, MoE
# and every kind of cache; the cheapest train (whisper-base) keeps the
# phase near 35 s on an H100 host (PERF.md section 4)
LM_DRYRUNS = (("whisper-base", "train_4k", ("16x16",)),
              ("deepseek-moe-16b", "prefill_32k", ("16x16",)),
              ("qwen2-1.5b", "decode_32k", ("16x16", "2x16x16")),
              ("qwen2-moe-a2.7b", "decode_32k", ("2x16x16",)),
              ("rwkv6-7b", "decode_32k", ("16x16",)),
              ("recurrentgemma-9b", "decode_32k", ("16x16",)))
LM_DRYRUN_TIMEOUT_S = 240


def lm_mesh1_check(seed: int, fails: list) -> dict:
    """The (1, 1) NCCL step against the plain one: loss, logits and every
    parameter after the step bitwise. Returns its kernel launches."""
    base = os.path.join(ROOT, "build", "chip_smoke_lm_dryrun")
    os.makedirs(base, exist_ok=True)
    saved = os.path.join(base, "mesh1.pt")
    for f in (saved, saved + ".rdv"):
        if os.path.exists(f):
            os.unlink(f)
    t0 = time.perf_counter()
    run_python(["-c", _LM_MESH1, "cuda", "nccl", str(seed), saved],
               "the (1, 1) mesh step")
    res = torch.load(saved)
    same = all(res["params"]) and res["logits"] and res["loss"]
    log("lm-dryrun", f"qwen2-1.5b 2 layers f32 on a (1, 1) NCCL mesh, "
                     f"{res['dtensors']} DTensor leaves placed by "
                     f"param_pspecs (FSDP on), hints active: loss "
                     f"{res['loss_value']:.6f} bitwise {res['loss']}, "
                     f"prefill logits bitwise {res['logits']} (max abs err "
                     f"{res['logit_err']:.3e}), parameters after the AdamW "
                     f"step bitwise {sum(res['params'])} of "
                     f"{len(res['params'])} (worst {res['worst']:.3e}); "
                     f"launches {res['launches']}; process "
                     f"{time.perf_counter() - t0:.1f} s")
    if not same:
        fails.append(f"(1, 1) mesh step not bitwise the plain step: {res}")
    return res["launches"]


def rank0_bytes(tree, specs, mesh) -> int:
    """Rank 0's bytes of a tree of tensors placed by specs (a tree of the
    same structure): each sharded dim cut to its first torch.chunk piece,
    axis by axis in mesh order."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    order = list(mesh.mesh_dim_names)
    if isinstance(tree, torch.Tensor):
        shape = list(tree.shape)
        for d, entry in enumerate(specs or ()):
            axes = (entry,) if isinstance(entry, str) else (entry or ())
            for a in sorted(axes, key=order.index):
                shape[d] = min(shape[d], -(-shape[d] // sizes[a]))
        return int(np.prod(shape)) * tree.element_size()
    if isinstance(tree, dict):
        return sum(rank0_bytes(v, specs[k], mesh) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return sum(rank0_bytes(v, s, mesh) for v, s in zip(tree, specs))
    return 0


def closed_form_arguments(arch: str, shape: str, multi_pod: bool) -> int:
    """Rank 0's argument bytes of a dry-run combo from the specs and the
    global shapes alone."""
    from repro_torch.configs import SHAPES, input_specs
    from repro_torch.launch import sharding as shd
    from repro_torch.models.transformer import init_decode_state
    cfg = get_config(arch)
    mesh = shd.production_mesh_shape(multi_pod)
    params = init_params(cfg, device="meta")
    p_specs = shd.param_pspecs(params)
    data = input_specs(cfg, shape)
    sh = SHAPES[shape]
    total = rank0_bytes(params, p_specs, mesh)
    if sh.kind == "train":
        state = pick_optimizer(cfg).init(params)
        o_specs = shd.opt_pspecs(state, p_specs)
        total += rank0_bytes(state.mu, o_specs.mu, mesh) \
            + rank0_bytes(state.nu, o_specs.nu, mesh) \
            + state.step.numel() * state.step.element_size()
    if sh.kind in ("train", "prefill"):
        return total + rank0_bytes(data, shd.batch_pspecs(cfg, mesh, data),
                                   mesh)
    B, S = sh.global_batch, sh.seq_len
    if cfg.family == "audio":
        De = cfg.encoder_d_model or cfg.d_model
        enc = torch.empty((B, cfg.encoder_seq, De),
                          dtype=cfg.activation_dtype, device="meta")
        with torch.no_grad():
            state = init_decode_state(cfg, B, S, enc=enc, params=params)
    else:
        state = init_decode_state(cfg, B, S, device="meta")
    return total + rank0_bytes(data["token"], (shd.dp_for_batch(mesh, B),),
                               mesh) \
        + rank0_bytes(state, shd.decode_state_pspecs(cfg, mesh, state),
                      mesh)


def phase_lm_dryrun(seed: int) -> dict:
    """[lm-dryrun]: the listed dry runs as processes of their own, all
    started together, and while they trace, the (1, 1) mesh step on the
    card. Each record is gated: status ok, the census equal to
    CommDebugMode's (and above 0 for a train step), the argument bytes
    equal to the closed form, no kernel launched. Returns the phase's
    kernel launches."""
    fails: list = []
    out_dir = os.path.join(ROOT, "build", "chip_smoke_lm_dryrun")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src")]
        + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
           if p]), OMP_NUM_THREADS="1")
    procs = []
    t0 = time.perf_counter()
    for arch, shape, meshes in LM_DRYRUNS:
        for mesh in meshes:
            name = f"{arch}.{shape}.{mesh}.json"
            if os.path.exists(os.path.join(out_dir, name)):
                os.unlink(os.path.join(out_dir, name))
            args = [sys.executable, "-m", "repro_torch.launch.dryrun",
                    "--arch", arch, "--shape", shape, "--device", "cuda",
                    "--results-dir", out_dir] \
                + (["--multi-pod"] if mesh == "2x16x16" else [])
            procs.append((arch, shape, mesh, time.perf_counter(),
                          subprocess.Popen(args, cwd=ROOT, env=env,
                                           stdout=subprocess.PIPE,
                                           stderr=subprocess.PIPE,
                                           text=True)))
    launched = lm_mesh1_check(seed, fails)
    for arch, shape, mesh, t_start, proc in procs:
        try:
            stdout, stderr = proc.communicate(
                timeout=max(1.0, LM_DRYRUN_TIMEOUT_S
                            - (time.perf_counter() - t_start)))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            fails.append(f"{arch} × {shape} × {mesh}: past "
                         f"{LM_DRYRUN_TIMEOUT_S} s")
            continue
        wall = time.perf_counter() - t_start
        path = os.path.join(out_dir, f"{arch}.{shape}.{mesh}.json")
        if proc.returncode != 0 or not os.path.exists(path):
            fails.append(f"{arch} × {shape} × {mesh} exited "
                         f"{proc.returncode}: {stdout[-1000:]}"
                         f"{stderr[-2000:]}")
            continue
        rec = json.loads(open(path).read())
        if rec["status"] != "ok":
            fails.append(f"{arch} × {shape} × {mesh}: {rec['status']} "
                         f"{rec.get('error', '')}")
            continue
        mem, coll = rec["memory"], rec["collectives"]
        want_args = closed_form_arguments(arch, shape, mesh == "2x16x16")
        for k, v in rec["launches"].items():
            launched[k] = launched.get(k, 0) + v
        log("lm-dryrun", f"[{rec['status']}] {arch} × {shape} × {mesh} "
                         f"(process {wall:.1f} s, traced step "
                         f"{rec['compile_seconds']} s): argument "
                         f"{mem['argument_size_in_bytes']} B (closed form "
                         f"{want_args}), output "
                         f"{mem['output_size_in_bytes']} B, temp "
                         f"{mem['temp_size_in_bytes']} B; flops (rank 0) "
                         f"{rec['flops']:.6g}, flops_global "
                         f"{rec['flops_global']:.6g}; census "
                         f"{coll['count_by_op']} {coll['bytes_by_op']} B, "
                         f"CommDebugMode {rec['comm_debug_counts']}; "
                         f"launches {rec['launches']}")
        checks = {
            "census = CommDebugMode":
                coll["count_by_op"] == rec["comm_debug_counts"],
            "census above 0 for a train step":
                shape != "train_4k" or (
                    coll["count_by_op"]
                    and all(n > 0 for n in coll["count_by_op"].values())),
            "argument bytes = closed form":
                mem["argument_size_in_bytes"] == want_args,
            "no kernel launched": not any(rec["launches"].values()),
        }
        bad = [k for k, ok in checks.items() if not ok]
        if bad:
            fails.append(f"{arch} × {shape} × {mesh}: {bad}")
    log("lm-dryrun", f"{len(procs)} dry runs in {time.perf_counter() - t0:.1f}"
                     f" s (all at once); kernel launches on the path "
                     f"{launched}; {card_line()}")
    if any(launched.values()):
        fails.append(f"a kernel was launched on the dry-run path: "
                     f"{launched}")
    if fails:
        raise AssertionError(f"[lm-dryrun] failed: {fails}")
    return launched


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
    free_card()


# ---------------------------------------------------------------------------
# Phase 7: LLM serving, rwkv6-7b at full width and depth, bfloat16
# ---------------------------------------------------------------------------

def phase_llm(seed: int, arch: str = "rwkv6-7b", tag: str = "llm",
              prompts_n: int = 64, max_len: int = 2048) -> dict:
    """LLMServer at the published size of ``arch``, ``prompts_n`` prompts
    of 128..``max_len`` tokens. An RWKV6 model must launch linattn at least
    once per layer per batch; the other families run no TPU kernel, so
    they must launch none. Returns each kernel's launches in the served
    stream."""
    cfg = get_config(arch)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(seed),
                         "cuda")
    torch.cuda.synchronize()
    n_par = n_params(params)
    log(tag, f"{cfg.name}: {cfg.num_layers} layers, d_model "
               f"{cfg.d_model}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
               f"{n_par} parameters in {cfg.dtype} drawn on the card in "
               f"{time.perf_counter() - t0:.2f} s; "
               f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    srv = LLMServer(params, cfg, gen_tokens=GEN_TOKENS, max_batch=LLM_BATCH,
                    device="cuda")
    rng = np.random.default_rng(seed)
    toks = make_batch(cfg, prompts_n, max_len, seed=seed)["tokens"].numpy()
    lengths = rng.integers(128, max_len + 1, prompts_n)
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
    if batches == 0 or (launches < cfg.num_layers * batches
                        if cfg.family == "ssm" else launches != 0):
        raise AssertionError(f"linattn launched {launches} times for "
                             f"{batches} {cfg.family} batches")
    if ga.launches != {"gather_rows": 0, "gather_agg": 0}:
        raise AssertionError(f"the LLM path launched {ga.launches}")
    lat = np.array([1e3 * t.latency_s() for t in tickets])
    n_gen = prompts_n * GEN_TOKENS
    log(tag, f"{prompts_n} prompts (lengths {int(lengths.min())}..."
               f"{int(lengths.max())}, {int(lengths.sum())} tokens) submitted "
               f"at once: {batches} batches, buckets {buckets}, "
               f"{n_gen} tokens generated in {wall:.3f} s = "
               f"{n_gen / wall:.1f} tokens/s; latency p50 "
               f"{np.percentile(lat, 50):.1f} ms p99 "
               f"{np.percentile(lat, 99):.1f} ms; peak memory "
               f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
               f"linattn launches {launches} ({launches // batches} per "
               f"batch); errors {st['errors']}")
    seq_buckets = sorted({s for (_, s) in st["buckets"]})
    if cfg.moe_num_experts:
        log_moe_stats(params, cfg, max(seq_buckets), seed, tag)
    llm_timings(params, cfg, seq_buckets, seed, tag)
    del params, srv
    free_card()
    return {"linattn": launches, **ga.launches}


def log_moe_stats(params, cfg, seq: int, seed: int, tag: str) -> None:
    """Each MoE layer's MoEStats at a prefill of LLM_BATCH x ``seq`` (one
    forward recording them) and at decode (batch LLM_BATCH, one token: the
    α decision is host arithmetic on the shapes, the same in every
    layer), and the share of routed choices each layer dropped."""
    toks = make_batch(cfg, LLM_BATCH, seq, seed=seed + 2)["tokens"]
    stats: list = []
    with torch.inference_mode():
        forward_hidden(params, cfg, {"tokens": toks}, moe_stats=stats)
    modes = sorted({st.mode for st in stats})
    bytes_ = sorted({(st.dispatch_bytes, st.weight_bytes) for st in stats})
    drops = [100 * float((~st.routing.keep).float().mean()) for st in stats]
    log(tag, f"MoEStats at prefill {LLM_BATCH}x{seq} (capacity "
             f"{moe_capacity(seq, cfg.moe_top_k, cfg.moe_num_experts, cfg.moe_capacity_factor)}"
             f" slots per expert per row): {len(stats)} layers, mode "
             f"{modes}, (dispatch_bytes, weight_bytes) {bytes_}; choices "
             f"dropped per layer {min(drops):.2f}..{max(drops):.2f}% "
             f"(mean {np.mean(drops):.2f}%)")
    mode, db, wb = _alpha_mode(cfg, LLM_BATCH, 1)
    log(tag, f"MoEStats at decode {LLM_BATCH}x1 (capacity 1): every layer "
             f"mode {mode!r}, dispatch_bytes {db}, weight_bytes {wb}")


def _tree_map(fn, node):
    """``fn`` over every tensor of a parameter tree of dicts and lists."""
    if isinstance(node, dict):
        return {k: _tree_map(fn, v) for k, v in node.items()}
    if isinstance(node, list):
        return [_tree_map(fn, v) for v in node]
    return fn(node)


def llm_timings(params, cfg, seq_buckets: list, seed: int,
                tag: str = "llm") -> None:
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
            log(tag, f"prefill {LLM_BATCH}x{sp}: {ms:.2f} ms "
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
        log(tag, f"decode_step at batch {LLM_BATCH}: {ms:.2f} ms per step "
                   f"({LLM_BATCH / ms * 1e3:.0f} tokens/s)")
        batch = {"tokens": toks[:, :max(seq_buckets)]}
        log(tag, f"profiled generate {LLM_BATCH}x{max(seq_buckets)} + "
                   f"{GEN_TOKENS} tokens:")
        device_profile(lambda: generate(
            params, cfg, batch, GEN_TOKENS,
            max_seq=max(seq_buckets) + GEN_TOKENS + 8), tag, 1, "generate")


# ---------------------------------------------------------------------------
# Phase llm-mm: generate on the vlm and audio families at full size
# ---------------------------------------------------------------------------

def phase_llm_mm(seed: int) -> dict:
    """generate() at the published size, in bf16 with random weights, on
    pixtral-12b (make_batch's 1,024 patches of 1,024 before 3,072 text
    tokens, batch MM_VLM_BATCH) and whisper-base (1,500 frames of 512
    and a 64-token decoder prompt, batch LLM_BATCH): GEN_TOKENS tokens
    each. Gates the tokens' shape and range and 0 launches of every kernel
    (neither family runs a TPU kernel); prints time, tokens/s, prefill ms,
    decode ms per step and peak memory. Returns each path's launches."""
    out = {}
    for path, arch, rows, seq in (("llm_vlm_generate", "pixtral-12b",
                                   MM_VLM_BATCH, 4096),
                                  ("llm_audio_generate", "whisper-base",
                                   LLM_BATCH, 64)):
        cfg = get_config(arch)
        t0 = time.perf_counter()
        params = init_params(
            cfg, torch.Generator(device="cuda").manual_seed(seed), "cuda")
        torch.cuda.synchronize()
        log("llm-mm", f"{cfg.name}: {cfg.num_layers} layers, d_model "
                      f"{cfg.d_model}, vocab {cfg.vocab_size}, "
                      f"{n_params(params)} parameters in {cfg.dtype} drawn "
                      f"on the card in {time.perf_counter() - t0:.2f} s")
        batch = {k: v.cuda() for k, v in
                 make_batch(cfg, rows, seq, seed=seed).items()}
        S = batch["tokens"].shape[1] + (batch["patches"].shape[1]
                                        if "patches" in batch else 0)
        max_seq = S + GEN_TOKENS + 8
        generate(params, cfg, batch, 2, max_seq=max_seq)       # warm
        la.reset_launches()
        ga.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = generate(params, cfg, batch, GEN_TOKENS, max_seq=max_seq)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"linattn": la.launches["linattn"], **ga.launches}
        if toks.shape != (rows, GEN_TOKENS) or toks.dtype != torch.int32 \
                or not ((0 <= toks) & (toks < cfg.vocab_size)).all():
            raise AssertionError(f"{cfg.name}: malformed tokens {toks!r}")
        if any(launches.values()):
            raise AssertionError(f"{cfg.name} generate launched {launches}")
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        with torch.inference_mode():
            ev[0].record()
            logits, state = prefill(params, cfg, batch, max_seq=max_seq)
            ev[1].record()
            tok = logits[:, :cfg.vocab_size].argmax(-1)
            for _ in range(8):
                _, state = decode_step(params, cfg, tok, state)
            ev[2].record()
        torch.cuda.synchronize()
        shapes = ", ".join(f"{k} {tuple(v.shape)}" for k, v in batch.items())
        log("llm-mm", f"{cfg.name} generate({shapes}) + {GEN_TOKENS} tokens: "
                      f"{wall:.3f} s = {rows * GEN_TOKENS / wall:.1f} "
                      f"tokens/s; prefill {ev[0].elapsed_time(ev[1]):.2f} "
                      f"ms, decode_step {ev[1].elapsed_time(ev[2]) / 8:.2f} "
                      f"ms at batch {rows}; peak memory "
                      f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB;"
                      f" launches {launches}; errors 0; on {card_line()}")
        out[path] = launches
        del params, batch, state, logits
        free_card()
    return out


# ---------------------------------------------------------------------------
# Phase lm-wide: every family at full width, 2 or 3 layers, float32
# ---------------------------------------------------------------------------

def wide_model(arch: str, seed: int, layers: int = 2, **kw):
    """``arch`` at its published width with depth cut to ``layers`` (and
    ``kw`` replaced), in float32 so a comparison is of the algorithm, with
    random weights drawn on the card. A fresh model's biases, RWKV6 bonus
    u and norm shifts are 0 and RG-LRU's Λ is 2 in every channel, which
    would hide them: the dense and RWKV6 models get small random QKV
    biases and u, the other families random values in every bias (``b``,
    ``conv_b``) and Λ in (1, 3)."""
    cfg = dataclasses.replace(get_config(arch), num_layers=layers,
                              dtype="float32", **kw)
    g = torch.Generator(device="cuda").manual_seed(seed)
    params = init_params(cfg, g, "cuda")
    if cfg.family in ("dense", "ssm"):
        for layer in params["layers"]:
            for t in ([layer["attn"][w]["b"] for w in ("wq", "wk", "wv")]
                      if cfg.qkv_bias else []) + \
                    ([layer["blk"]["u"]] if cfg.family == "ssm" else []):
                t.copy_(0.1 * torch.randn(t.shape, generator=g,
                                          device="cuda"))
        return cfg, params
    for name, t in zip(leaf_names(params), tree_leaves(params)):
        leaf = name.rsplit("/", 1)[-1]
        if leaf in ("b", "conv_b"):
            t.copy_(0.1 * torch.randn(t.shape, generator=g, device="cuda"))
        elif leaf == "lam":
            t.copy_(1 + 2 * torch.rand(t.shape, generator=g, device="cuda"))
    return cfg, params


def leaf_names(node, prefix: str = "") -> list:
    """Paths of a parameter tree's tensors in tree_leaves order."""
    if isinstance(node, dict):
        return [n for k in sorted(node)
                for n in leaf_names(node[k], f"{prefix}/{k}")]
    if isinstance(node, list):
        return [n for i, v in enumerate(node)
                for n in leaf_names(v, f"{prefix}/{i}")]
    return [prefix]


def share(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| as a share of max |want| (both moved to the CPU)."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    return float((got - want).abs().max() / want.abs().max())


def kv_slots(state) -> int:
    """Slots of the first self-attention KV cache of a decode state (a
    dense layer's, a hybrid period's attention position's, an audio
    decoder layer's)."""
    c = state.caches[0]
    if isinstance(c, dict):
        c = next(b for b in c["blocks"] if hasattr(b, "k"))
    return (c.self_kv if hasattr(c, "self_kv") else c).k.shape[1]


def check_decode(tag: str, cfg, params, batch: dict, prompt: int,
                 steps: int, fails: list) -> None:
    """prefill(the first ``prompt`` tokens, and the batch's patches or
    frames) + ``steps`` decode steps, each step's logits against the full
    forward over every token at that position, on the card. A vlm's
    patches take the first positions of the forward."""
    toks = batch["tokens"]
    pre = batch["patches"].shape[1] if "patches" in batch else 0
    with torch.inference_mode():
        full, _ = forward(params, cfg, batch)
        last, state = prefill(params, cfg, dict(batch,
                                                tokens=toks[:, :prompt]),
                              max_seq=pre + prompt + steps + 8)
        errs = [share(last, full[:, pre + prompt - 1])]
        for i in range(steps):
            logits, state = decode_step(params, cfg,
                                        toks[:, prompt + i].cuda(), state)
            errs.append(share(logits, full[:, pre + prompt + i]))
    ring = kv_slots(state)
    wrapped = ", a wrapped ring" if ring < pre + prompt else ""
    extra = "".join(f", {k} {tuple(v.shape)}" for k, v in batch.items()
                    if k != "tokens")
    log(tag, f"{cfg.name} {cfg.num_layers} layers f32: prefill({prompt}"
             f"{extra}) + {steps} decode steps vs the full forward over "
             f"{toks.shape[1]} tokens (KV cache of {ring} slots{wrapped}): "
             f"max abs err {max(errs):.3e} of max |logit| per step "
             f"{[f'{e:.2e}' for e in errs]} (bound {LM_TOL})")
    if max(errs) > LM_TOL:
        fails.append(f"{cfg.name} decode vs forward {max(errs)} > {LM_TOL}")


def moe_rows_agreeing(tag: str, cfg, params, cpu_params, batch: dict,
                      fails: list) -> tuple[list, list, tuple]:
    """Every MoE layer's routing on the card against the CPU's on
    ``batch``: the top-k experts of each token, then each row's kept flags
    and slots. The router's float32 product sums in another order on the
    card, so a near-tie between two experts may flip; a token whose
    choices differ must have a margin p_j - p_(j+1) (CPU probabilities,
    at the first rank that differs) below MOE_FLIP_MARGIN, and its row
    leaves the comparison. Returns (the rows whose routing agrees in every
    layer, the flips as (layer, row, token, margin), and the final hidden
    states on the card and the CPU)."""
    st_g, st_c = [], []
    with torch.inference_mode():
        xg, _ = forward_hidden(params, cfg, batch, moe_stats=st_g)
        xc, _ = forward_hidden(cpu_params, cfg, batch, moe_stats=st_c)
    B = batch["tokens"].shape[0]
    agree = torch.ones(B, dtype=torch.bool)
    flips = []
    for layer, (g, c) in enumerate(zip(st_g, st_c)):
        te_g, te_c = g.routing.top_e.cpu(), c.routing.top_e
        differ = (te_g != te_c)                               # (B, S, k)
        token_differs = differ.any(-1)
        if token_differs.any():
            sorted_p = c.routing.probs.sort(-1, descending=True).values
            for b, t in token_differs.nonzero().tolist():
                j = int(differ[b, t].nonzero()[0])
                margin = float(sorted_p[b, t, j] - sorted_p[b, t, j + 1])
                flips.append((layer, b, t, margin))
                if margin >= MOE_FLIP_MARGIN:
                    fails.append(f"{cfg.name} layer {layer} row {b} token "
                                 f"{t}: experts {te_g[b, t].tolist()} on "
                                 f"the card, {te_c[b, t].tolist()} on the "
                                 f"CPU, margin {margin:.3e} >= "
                                 f"{MOE_FLIP_MARGIN}")
        row_differs = token_differs.any(-1)
        slots_differ = ((g.routing.slot.cpu() != c.routing.slot)
                        | (g.routing.keep.cpu() != c.routing.keep)).any(-1)
        if (slots_differ & ~row_differs).any():
            fails.append(f"{cfg.name} layer {layer}: kept slots differ in "
                         f"rows whose experts agree")
        agree &= ~(row_differs | slots_differ)
    rows = agree.nonzero()[:, 0].tolist()
    log(tag, f"{cfg.name} routing, card vs CPU, {len(st_g)} MoE layers x "
             f"{B} rows x {batch['tokens'].shape[1]} tokens x top-"
             f"{cfg.moe_top_k} of {cfg.moe_num_experts}: "
             f"{len(flips)} tokens differ"
             + (f" (layer, row, token, margin p_j - p_j+1: "
                f"{[(l, b, t, f'{m:.2e}') for l, b, t, m in flips]}; bound "
                f"{MOE_FLIP_MARGIN})" if flips else "")
             + f"; kept slots equal in every row whose experts agree; rows "
               f"agreeing in every layer {rows}")
    if len(rows) < B - 1:
        fails.append(f"{cfg.name}: routing agrees in rows {rows} of {B}")
    return rows, flips, (xg, xc)


def check_loss_grads(tag: str, arch: str, seed: int, fails: list,
                     layers: int = 2) -> list:
    """loss_fn's loss (MoE's balance loss included) and every gradient
    leaf, CUDA against the CPU, on the full-width model cut to ``layers``
    at batch 2 x 256 tokens; the training path must launch no linattn
    kernel. For MoE the routing is compared first, and only the rows whose
    routing agrees go on (returns its flips)."""
    cfg, params = wide_model(arch, seed, layers)
    batch = make_batch(cfg, 2, 256, seed=seed + 3)
    flips = []
    if cfg.moe_num_experts:
        rows, flips, _ = moe_rows_agreeing(
            tag, cfg, params, _tree_map(lambda t: t.cpu(), params), batch,
            fails)
        batch = {k: v[rows] for k, v in batch.items()}
    la.reset_launches()
    t0 = time.perf_counter()
    loss_g, parts_g, grads_g = value_and_grad(params, cfg, batch)
    torch.cuda.synchronize()
    t_gpu = time.perf_counter() - t0
    launched = la.launches["linattn"]
    cpu_params = _tree_map(lambda t: t.cpu(), params)
    del params
    t0 = time.perf_counter()
    loss_c, parts_c, grads_c = value_and_grad(cpu_params, cfg, batch)
    t_cpu = time.perf_counter() - t0
    errs = [share(a, b) for a, b in zip(grads_g, grads_c)]
    worst = sorted(zip(errs, leaf_names(cpu_params)), reverse=True)[:3]
    err_loss = abs(float(loss_g) - float(loss_c)) / abs(float(loss_c))
    bound = GRAD_TOL[cfg.family]
    aux = (f" (aux CUDA {float(parts_g['aux']):.6f} vs CPU "
           f"{float(parts_c['aux']):.6f})" if cfg.moe_num_experts else "")
    log(tag, f"{cfg.name} {cfg.num_layers} layers f32, loss_fn at B="
             f"{batch['tokens'].shape[0]} S=256: loss CUDA "
             f"{float(loss_g):.6f} vs CPU {float(loss_c):.6f}{aux} (rel err "
             f"{err_loss:.2e}, bound {LM_TOL}); {len(errs)} grad leaves, "
             f"max abs err as a share of the leaf's max |g| (bound {bound}):"
             f" worst {', '.join(f'{n} {e:.3e}' for e, n in worst)}; CUDA "
             f"{t_gpu:.2f} s, CPU {t_cpu:.1f} s; linattn launches "
             f"{launched} (want 0: training differentiates "
             f"linattn_chunked_torch)")
    if err_loss > LM_TOL or max(errs) > bound:
        fails.append(f"{cfg.name} loss/grads CUDA vs CPU: loss {err_loss} > "
                     f"{LM_TOL} or grads {max(errs)} > {bound}")
    if launched:
        fails.append(f"{cfg.name} loss_fn launched linattn {launched} times")
    if cfg.moe_num_experts:
        err_aux = abs(float(parts_g["aux"]) - float(parts_c["aux"])) \
            / abs(float(parts_c["aux"]))
        if not err_aux <= LM_TOL or not float(parts_g["aux"]) > 0:
            fails.append(f"{cfg.name} aux CUDA vs CPU {err_aux} > {LM_TOL} "
                         f"or not > 0")
    return flips


def check_logits(tag: str, arch: str, seed: int, fails: list,
                 layers: int = 2, rows: int = 2, seq: int = 256) -> list:
    """Forward logits on the card against the CPU on the full-width model
    cut to ``layers``, at ``rows`` x ``seq`` of make_batch (with its
    patches or frames); for MoE over the rows whose routing agrees.
    Returns the routing flips."""
    cfg, params = wide_model(arch, seed, layers)
    batch = make_batch(cfg, rows, seq, seed=seed)
    cpu_params = _tree_map(lambda t: t.cpu(), params)
    t0 = time.perf_counter()
    if cfg.moe_num_experts:
        keep, flips, (xg, xc) = moe_rows_agreeing(tag, cfg, params,
                                                  cpu_params, batch, fails)
        gpu, cpu = xg @ params["head"], xc @ cpu_params["head"]
    else:
        keep, flips = list(range(rows)), []
        with torch.inference_mode():
            gpu, _ = forward(params, cfg, batch)
            cpu, _ = forward(cpu_params, cfg, batch)
    t_cpu = time.perf_counter() - t0
    err = share(gpu[keep], cpu[keep])
    extra = "".join(f", {k} {tuple(v.shape)}" for k, v in batch.items()
                    if k != "tokens")
    log(tag, f"{cfg.name} {cfg.num_layers} layers f32 (d_model "
             f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads, "
             f"vocab {cfg.vocab_size}), tokens {tuple(batch['tokens'].shape)}"
             f"{extra}, forward: CUDA vs CPU ({t_cpu:.1f} s) over rows "
             f"{keep}: max abs err {err:.3e} of max |logit| "
             f"{float(cpu[keep].abs().max()):.3f} (bound {LM_TOL})")
    if err > LM_TOL:
        fails.append(f"{cfg.name} forward CUDA vs CPU {err} > {LM_TOL}")
    del params, cpu_params, gpu, cpu
    free_card()
    return flips


def phase_lm_wide(seed: int) -> list:
    """Every family at its published width, cut to 2 layers (3 for the
    hybrid: one period), in float32: logits, prefill + 8 decode steps and
    loss_fn's grads, on the card against the CPU or the full forward.
    Returns the MoE routing flips between the card and the CPU."""
    fails: list = []
    flips = []
    for arch, layers, rows, seq in (("qwen2-1.5b", 2, 2, 256),
                                    ("deepseek-moe-16b", 2, 4, 128),
                                    ("qwen2-moe-a2.7b", 2, 4, 128),
                                    ("recurrentgemma-9b", 3, 2, 256),
                                    ("pixtral-12b", 2, 2, 256),
                                    ("whisper-base", 2, 2, 256)):
        flips += [(arch, *f) for f in check_logits("lm-wide", arch, seed,
                                                    fails, layers, rows,
                                                    seq)]
    for arch, layers, rows, prompt, kw in (
            ("qwen2-1.5b", 2, 2, 256, {}),
            ("h2o-danube-3-4b", 2, 1, DANUBE_PROMPT, {}),
            # a capacity drop is a training artifact (tests/test_arch_smoke.py)
            ("qwen2-moe-a2.7b", 2, 2, 256, dict(moe_capacity_factor=8.0)),
            ("recurrentgemma-9b", 3, 1, HYBRID_PROMPT, {}),
            ("pixtral-12b", 2, 2, 190, {}),     # 66 patches + 198 tokens
            ("whisper-base", 2, 2, 256, {})):
        cfg, params = wide_model(arch, seed, layers, **kw)
        batch = make_batch(cfg, rows, max(264, prompt + 8), seed=seed)
        check_decode("lm-wide", cfg, params, batch, prompt, 8, fails)
        del params
        free_card()
    for arch, layers in (("qwen2-1.5b", 2), ("rwkv6-7b", 2),
                         ("deepseek-moe-16b", 2), ("recurrentgemma-9b", 3)):
        flips += [(arch, *f) for f in check_loss_grads("lm-wide", arch, seed,
                                                        fails, layers)]
        free_card()
    if fails:
        raise AssertionError("; ".join(fails))
    return flips


# ---------------------------------------------------------------------------
# Phase lm-train: make_train_step at full width
# ---------------------------------------------------------------------------

def n_params(params) -> int:
    sizes = []
    _tree_map(lambda t: sizes.append(t.numel()), params)
    return sum(sizes)


def train_run(cfg, seed: int, batch: int, seq: int, steps: int,
              card: str) -> dict:
    """``steps`` of make_train_step with pick_optimizer's AdamW on token
    batches from token_batches; linattn counts zeroed just before and read
    just after; then one more step under the profiler. Returns losses,
    step seconds and launches."""
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(seed),
                         "cuda")
    opt = pick_optimizer(cfg)
    opt_state = opt.init(params)
    step = make_train_step(cfg, opt)
    torch.cuda.synchronize()
    n = n_params(params)
    mdtype = str(opt_state.mu[0].dtype).removeprefix("torch.")
    log("lm-train", f"{cfg.name}: {cfg.num_layers} layers, {n} parameters "
                    f"in {cfg.dtype}, AdamW moments in {mdtype}: "
                    f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB "
                    f"allocated before activations (set up in "
                    f"{time.perf_counter() - t0:.1f} s)")
    batches = list(token_batches(cfg, batch, seq, steps=steps, seed=seed))
    torch.cuda.reset_peak_memory_stats()
    la.reset_launches()
    ga.reset_launches()
    losses, auxes, secs = [], [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, m = step(params, opt_state, b)
        losses.append(float(m["loss"]))
        auxes.append(float(m["aux"]))
        secs.append(time.perf_counter() - t0)
    # MoE: the routed experts a token does not pick are not active
    inactive = cfg.num_layers * (cfg.moe_num_experts - cfg.moe_top_k) * 3 \
        * cfg.d_model * cfg.moe_expert_d_ff
    out = dict(losses=losses, auxes=auxes, secs=secs, n=n - inactive,
               tokens=batch * seq, linattn=la.launches["linattn"],
               gather=dict(ga.launches),
               peak=torch.cuda.max_memory_allocated())
    log_train(cfg, out, card)
    log("lm-train", f"{cfg.name}: one more step under the profiler:")
    device_profile(lambda: step(params, opt_state, batches[0]), "lm-train",
                   1, "step")
    del params, opt_state
    free_card()
    return out


def log_train(cfg, r: dict, card: str) -> None:
    steady = float(np.mean(r["secs"][1:]))
    tps = r["tokens"] / steady
    aux = (f"; aux {[f'{x:.4f}' for x in r['auxes']]}"
           if cfg.moe_num_experts else "")
    n = "N_active" if cfg.moe_num_experts else "N"
    log("lm-train", f"{cfg.name} losses {[f'{x:.4f}' for x in r['losses']]}"
                    f"{aux}")
    log("lm-train", f"{cfg.name} {len(r['secs'])} steps at {r['tokens']} "
                    f"tokens: first {1e3 * r['secs'][0]:.1f} ms, then "
                    f"{1e3 * steady:.1f} ms/step = {tps:.0f} tokens/s; "
                    f"6*{n}*tokens/s ({n} {r['n']}) = "
                    f"{6 * r['n'] * tps / 1e12:.1f} TFLOP/s = "
                    f"{100 * 6 * r['n'] * tps / BF16_FLOP_PER_S:.2f}% of the "
                    f"bf16 dense peak; peak memory "
                    f"{r['peak'] / 2**30:.2f} GiB; linattn launches "
                    f"{r['linattn']}; on {card}")


def check_grad_refusal(fails: list) -> None:
    """The CUDA linattn kernel has no backward: a q that requires grad is
    refused, and nothing is launched."""
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, w, u = linattn_inputs(g, 4, 64, 64, 64, False)
    q.requires_grad_()
    la.reset_launches()
    try:
        la.linattn_chunked(q, k, v, w, u, chunk=64)
    except RuntimeError as e:
        log("lm-train", f"CUDA linattn with a q that requires grad raised: "
                        f"{str(e)[:80]}...; launches "
                        f"{la.launches['linattn']}")
        if la.launches["linattn"]:
            fails.append("linattn counted a refused launch")
    else:
        fails.append("CUDA linattn accepted a q that requires grad")


def check_accum(seed: int, fails: list) -> None:
    """One accum-2 step against the accum-1 step from the same parameters
    on the 2-layer full-width qwen2-1.5b in float32: the loss, the
    accumulated gradients, and the parameters after the AdamW step where
    the step is well-conditioned (see ACCUM_MIN_G)."""
    res = []
    for accum in (1, 2):
        cfg, params = wide_model("qwen2-1.5b", seed)
        batch = make_batch(cfg, 4, 256, seed=seed + 4)
        _, _, grads = accumulated_grads(params, cfg, batch, accum)
        opt = pick_optimizer(cfg, lr=1e-3)
        params, _, m = make_train_step(cfg, opt, accum=accum)(
            params, opt.init(params), batch)
        res.append((tree_leaves(params), float(m["loss"]), grads))
        names = leaf_names(params)
        del params
    (p1, l1, g1), (p2, l2, g2) = res
    scale = min(1.0, 1.0 / (float(torch.sqrt(sum(
        g.float().square().sum() for g in g1))) + 1e-9))   # the clip
    err_l = abs(l2 - l1) / abs(l1)
    err_g = sorted(((share(b, a), n) for a, b, n in zip(g1, g2, names)),
                   reverse=True)
    err_p, err_all, kept = [], 0.0, 0
    for a, b, g, n in zip(p1, p2, g1, names):
        d = (b - a).abs()
        top = float(a.abs().max())
        err_all = max(err_all, float(d.max()) / top)
        ok = g.abs() * scale >= ACCUM_MIN_G
        kept += int(ok.sum())
        err_p.append((float(d[ok].max()) / top if ok.any() else 0.0, n))
    err_p.sort(reverse=True)
    total = sum(t.numel() for t in p1)
    log("lm-train", f"qwen2-1.5b 2 layers f32, B=4 S=256: accum 2 vs accum "
                    f"1, loss {l2:.7f} vs {l1:.7f} (rel err {err_l:.2e}, "
                    f"bound {ACCUM_TOL}); accumulated grads, share of the "
                    f"leaf's max (bound {ACCUM_GRAD_TOL}): worst "
                    f"{', '.join(f'{n} {e:.3e}' for e, n in err_g[:3])}")
    log("lm-train", f"parameters after the AdamW step, share of the leaf's "
                    f"max: {err_all:.3e} over all {total} elements; "
                    f"{err_p[0][0]:.3e} ({err_p[0][1]}; bound {ACCUM_TOL}) "
                    f"over the {kept} whose clipped |g| >= {ACCUM_MIN_G}")
    if err_l > ACCUM_TOL or err_g[0][0] > ACCUM_GRAD_TOL \
            or err_p[0][0] > ACCUM_TOL:
        fails.append(f"accum 2 vs 1: loss {err_l} > {ACCUM_TOL}, grads "
                     f"{err_g[0]} > {ACCUM_GRAD_TOL} or params {err_p[0]} > "
                     f"{ACCUM_TOL}")
    del res, p1, p2, g1, g2
    free_card()


def phase_lm_train(seed: int) -> dict:
    """Returns each kernel's launches in the training runs (0 when
    right)."""
    fails: list = []
    card = card_line()
    check_grad_refusal(fails)
    check_accum(seed, fails)
    runs = [(get_config("qwen2-1.5b"), 4, 1024, 6),
            (dataclasses.replace(get_config("rwkv6-7b"),
                                 num_layers=RWKV_TRAIN_LAYERS), 2, 1024, 4),
            (dataclasses.replace(get_config("deepseek-moe-16b"),
                                 num_layers=MOE_TRAIN_LAYERS), 2, 1024, 4)]
    launched = {"linattn": 0, "gather_rows": 0, "gather_agg": 0}
    for cfg, batch, seq, steps in runs:
        r = train_run(cfg, seed, batch, seq, steps, card)
        for k, v in dict(r["gather"], linattn=r["linattn"]).items():
            launched[k] += v
        if not np.isfinite(r["losses"]).all():
            fails.append(f"{cfg.name}: non-finite loss {r['losses']}")
        if cfg.moe_num_experts and not (np.isfinite(r["auxes"]).all()
                                        and min(r["auxes"]) > 0):
            fails.append(f"{cfg.name}: aux loss not finite and > 0 on every "
                         f"step: {r['auxes']}")
        if r["linattn"] or any(r["gather"].values()):
            fails.append(f"{cfg.name} training launched linattn "
                         f"{r['linattn']} times, gathers {r['gather']}")
    if fails:
        raise AssertionError("; ".join(fails))
    return launched



def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=4096)
    ap.add_argument("--qps", type=float, default=1000.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--world", type=int, default=1,
                    help="ranks of the [mesh] phase, one per card; above 1 "
                         "only the build and [mesh] run")
    ap.add_argument("--lm-only", action="store_true",
                    help="run only the build, the linattn kernel check and "
                         "the transformer phases (6, 7, lm-wide, lm-dryrun, "
                         "llm-dense, llm-moe, llm-hybrid, llm-mm, "
                         "lm-train)")
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
                  f"{torch.backends.cudnn.allow_tf32}; "
                  f"{torch.cuda.device_count()} cards visible")
    phase_build()
    if args.world > 1:
        summary = phase_mesh(args.world, args.seed)
        lm_mesh = phase_lm_mesh(args.world, args.seed)
        if summary["gather_agg_launches"]:
            raise AssertionError(f"the sharded fit launched gather_agg: "
                                 f"{summary['gather_agg_launches']}")
        log("done", f"build, [mesh] and [lm-mesh] at world size {args.world} "
                    f"passed in "
                    f"{time.perf_counter() - t_all:.1f} s")
        print(json.dumps({"mesh": summary, "lm_mesh": lm_mesh}))
        print(card_line())
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if args.lm_only:
        kernels = [check_linattn(args.seed)]
        by_path = {"linattn": {}}
    else:
        ds, store, cfg, part = build_world(args.seed)
        ws, hops = rung64_workspace(ds, store, cfg, args.seed + 1)
        kernels = [check_gather_rows(ws, hops, args.seed)]
        agg_err = check_gather_agg(ws, hops, args.seed)
        kernels.append(check_linattn(args.seed))
        kernels.append(check_sample_tree(args.seed))
        kernels.append(check_plan_dedup(args.seed))
        del ws, hops
        by_path = {"gather_rows": {}, "gather_agg": {}, "linattn": {},
                   "sample_tree": SAMPLE_BY_PATH,
                   "plan_dedup": DEDUP_BY_PATH}
        for name, n in phase_serve(ds, store, cfg, args.seed, args.requests,
                                   args.qps).items():
            by_path[name]["gnn_serve"] = n
        by_path["gather_rows"]["gnn_train"] = phase_train(ds, store, part,
                                                          cfg, args.seed)
        by_path["gather_rows"].update(phase_ckpt(ds, store, part, cfg,
                                                 args.seed, args.requests,
                                                 args.qps))
        by_path["gather_rows"]["p3_train"] = phase_p3(ds, store, part, cfg,
                                                      args.seed)
        by_path["gather_rows"]["gnn_train_streamed"] = phase_stream(
            ds, store, part, cfg, args.seed)
        by_path["gather_rows"]["gnn_train_mesh"] = phase_mesh1(ds, cfg,
                                                               args.seed)
        by_path["gather_rows"].update(phase_dryrun(args.seed))
        by_path["gather_agg"].update(AGG_BY_PATH)
        if any(by_path["gather_agg"].values()):
            raise AssertionError(f"a path launched gather_agg: "
                                 f"{by_path['gather_agg']}")
        kernels.insert(1, gather_agg_entry(agg_err))
        del ds, store
    def record(path: str, launches: dict) -> None:
        for name, n in launches.items():
            if name in by_path:
                by_path[name][path] = n

    phase_rwkv6_wide(args.seed)
    record("llm_serve", phase_llm(args.seed))
    flips: list = []
    for tag, fn in (
            ("lm-wide", lambda: flips.extend(phase_lm_wide(args.seed))),
            ("lm-dryrun", lambda: record("lm_dryrun",
                                         phase_lm_dryrun(args.seed))),
            ("llm-dense", lambda: record("llm_dense_serve", phase_llm(
                args.seed, "qwen2-1.5b", "llm-dense", DENSE_LLM_PROMPTS))),
            ("llm-moe", lambda: record("llm_moe_serve", phase_llm(
                args.seed, "deepseek-moe-16b", "llm-moe", NEW_LLM_PROMPTS))),
            ("llm-hybrid", lambda: record("llm_hybrid_serve", phase_llm(
                args.seed, "recurrentgemma-9b", "llm-hybrid",
                NEW_LLM_PROMPTS, HYBRID_MAX_PROMPT))),
            ("llm-mm", lambda: [record(path, n) for path, n in
                                phase_llm_mm(args.seed).items()]),
            ("lm-train", lambda: record("lm_train",
                                        phase_lm_train(args.seed)))):
        t0 = time.perf_counter()
        fn()
        log(tag, f"phase done in {time.perf_counter() - t0:.1f} s")
    log("lm-wide", f"MoE routing flips between the card and the CPU: "
                   f"{len(flips)} {flips}")
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
