"""Dry runs of the port: the transformer pod dry run over every (arch ×
input shape × mesh), where records go, and the census of collectives.

The reference lowers and compiles each step for the production mesh on
512 placeholder host devices (``jax.jit(...).lower(...).compile()``) and
reads its memory, cost and collectives from XLA. The port traces the step
instead: :func:`lower_combo` starts a ``fake`` process group of 256 ranks
(512 for two pods), builds the production mesh over it, places full-size
``meta`` parameters, optimizer state, batch and decode state on it as
DTensors by ``launch/sharding.py``'s specs, and calls the step as rank 0
under ``implicit_replication()`` (the model's own plain tensors count as
replicated). Nothing executes: meta tensors carry shapes and dtypes, and a
fake collective moves no data, so what the step would run, allocate and
send is visible with no card beyond the mesh's device type. No TPU kernel
is on this path: ``ops.linattn`` takes its plain version on ``meta``.

* train: ``make_train_step(cfg, pick_optimizer(cfg), accum)`` on (params,
  opt state, batch); prefill: ``forward_hidden`` then ``x[:, -1] @
  _head_matrix``; decode: ``decode_step`` on a decode state from
  ``init_decode_state`` (audio's from the encoder output ``enc``).

The census (:class:`CollectiveCensus`) is a ``TorchDispatchMode`` that sees
every c10d collective a call issues (the ``torch.distributed`` ops and the
functional collectives) and sums, per op, the bytes of its output on this
rank. An op executed T times is counted T times; the reference's HLO lists
an op inside a ``scan`` body once. A mode runs before a tensor subclass,
so a DTensor op reaches it whole and desugars into its collectives only
after the mode has handed it on: the census declines DTensor ops
(returns ``NotImplemented``, as ``CommDebugMode`` does), so DTensor runs
first and the census sees the local ops and collectives it issues.
:class:`StepCensus` adds, over the same local ops, rank 0's FLOPs, bytes
accessed and peak live bytes.

The record, ``{arch}.{shape}.{16x16|2x16x16}[.tag].json`` under
:data:`RESULTS_DIR`, has the reference's keys, defined here:

* ``memory.argument_size_in_bytes``: Σ of rank 0's local shard bytes of
  what the step is handed (parameters, optimizer moments and step, batch;
  or the token and decode state); ``output_size_in_bytes``: the same for
  what it returns; ``temp_size_in_bytes``: the peak of the live bytes of
  the local tensors the step allocates (outputs included; arguments and
  what is written into them in place excluded), tracked by
  :class:`StepCensus` over each local op's outputs, not by
  ``MemTracker``; ``generated_code_size_in_bytes``: 0.
* ``flops``: rank 0's local FLOPs (``torch.utils.flop_counter``'s
  registry over the local ops: matmuls, attention), the reference's
  per-device meaning; ``flops_global``: the whole mesh's FLOPs,
  ``FlopCounterMode``'s count of the same step on plain ``meta`` tensors
  (a second, unplaced call: attention's core and the linear attention run
  on local shards, out of DTensor's sight). ``flops_hlo_raw`` =
  ``flops``.
* ``bytes_accessed``: Σ over rank 0's local ops of their tensor inputs'
  and outputs' bytes, each op on its own, with no fusion (views
  included); ``bytes_accessed_raw`` = ``bytes_accessed``.
* ``collectives``: the census dict; ``collective_bytes_total`` and
  ``collective_bytes_by_op``: rank 0's output bytes of every collective
  issued, counted as often as it runs. ``comm_debug_counts``:
  ``CommDebugMode``'s counts of the same run, by the census's op names.
* ``compile_seconds``: the wall time of the traced step.
* ``scan_length``, ``params``, ``active_params``, ``accum``, ``fsdp``,
  ``seq_shard``, ``remat_policy`` as the reference has them; ``launches``:
  the hand-written kernels launched by the step (none: meta tensors take
  the plain versions); ``manifest``: ``obs/export``'s.

A combo ``shape_applicable`` rejects is ``skipped`` with its reason; an
exception makes it ``failed`` with the error and the last 2,000 characters
of its trace. A process holds one default group, so :func:`main` runs the
combos mesh by mesh and destroys the group between the two meshes.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b \\
        --shape train_4k --device cpu
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes \\
        --device cpu [--skip-done]

Records are written under ``build/dryrun_torch/`` at the root of the
checkout (git-ignored), never under ``benchmarks/``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
import weakref
from pathlib import Path
from typing import Optional

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode, flop_registry

RESULTS_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun_torch"

# qualified op name -> (the reference's HLO op name, where the output is:
# "arg" = the op's first argument, written in place; "ret" = its result)
_COLLECTIVES = {
    "c10d::alltoall_base_": ("all-to-all", "arg"),
    "c10d::alltoall_": ("all-to-all", "arg"),
    "c10d::allreduce_": ("all-reduce", "arg"),
    "c10d::allreduce_coalesced_": ("all-reduce", "arg"),
    "c10d::allgather_": ("all-gather", "arg"),
    "c10d::_allgather_base_": ("all-gather", "arg"),
    "c10d::allgather_coalesced_": ("all-gather", "arg"),
    "c10d::allgather_into_tensor_coalesced_": ("all-gather", "arg"),
    "c10d::reduce_scatter_": ("reduce-scatter", "arg"),
    "c10d::_reduce_scatter_base_": ("reduce-scatter", "arg"),
    "c10d::reduce_scatter_tensor_coalesced_": ("reduce-scatter", "arg"),
    "_c10d_functional::all_to_all_single": ("all-to-all", "ret"),
    "_c10d_functional::all_reduce": ("all-reduce", "ret"),
    "_c10d_functional::all_reduce_": ("all-reduce", "ret"),
    "_c10d_functional::all_reduce_coalesced": ("all-reduce", "ret"),
    "_c10d_functional::all_reduce_coalesced_": ("all-reduce", "ret"),
    "_c10d_functional::all_gather_into_tensor": ("all-gather", "ret"),
    "_c10d_functional::all_gather_into_tensor_out": ("all-gather", "ret"),
    "_c10d_functional::all_gather_into_tensor_coalesced": ("all-gather",
                                                           "ret"),
    "_c10d_functional::reduce_scatter_tensor": ("reduce-scatter", "ret"),
    "_c10d_functional::reduce_scatter_tensor_out": ("reduce-scatter", "ret"),
    "_c10d_functional::reduce_scatter_tensor_coalesced": ("reduce-scatter",
                                                          "ret"),
}


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


class CollectiveCensus(TorchDispatchMode):
    """Count the collectives run under it, with this rank's output bytes
    of each: for all-gather the gathered output, for reduce-scatter the
    scattered output, as the reference's census counts them.

        with CollectiveCensus() as census:
            fn(*args)
        census.result()   # {"bytes_by_op", "count_by_op", "total_bytes"}
    """

    def __init__(self):
        super().__init__()
        self.bytes_by_op: dict[str, int] = {}
        self.count_by_op: dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **(kwargs or {}))
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented       # DTensor desugars, then we see it
        out = func(*args, **(kwargs or {}))
        hit = _COLLECTIVES.get(func.name().split(".")[0])
        if hit is not None:
            op, where = hit
            n = _nbytes(args[0] if where == "arg" else out)
            self.bytes_by_op[op] = self.bytes_by_op.get(op, 0) + n
            self.count_by_op[op] = self.count_by_op.get(op, 0) + 1
        self._local_op(func, args, kwargs or {}, out)
        return out

    def _local_op(self, func, args, kwargs, out) -> None:
        """A local op on plain tensors, after it ran (subclasses count)."""

    def result(self) -> dict:
        """The reference's census dict."""
        return {"bytes_by_op": dict(self.bytes_by_op),
                "count_by_op": dict(self.count_by_op),
                "total_bytes": sum(self.bytes_by_op.values())}


def _flops(func, args, kwargs, out) -> int:
    fn = flop_registry.get(func._overloadpacket)
    return 0 if fn is None else int(fn(*args, **kwargs, out_val=out))


class StepCensus(CollectiveCensus):
    """The census, plus this rank's FLOPs (``flops``), bytes accessed
    (Σ of each local op's tensor inputs and outputs) and the peak of the
    live bytes of the local tensors allocated under it (``peak_bytes``).

    A local tensor is live from the op that makes it until its storage is
    freed: its storage is held by a weak reference, checked when a tensor
    on it is collected. The storages of ``exclude`` (the step's arguments)
    are never counted, so writing into them in place adds nothing."""

    def __init__(self, exclude=()):
        super().__init__()
        from torch.multiprocessing.reductions import StorageWeakRef
        self._ref = StorageWeakRef
        self.flops = 0
        self.bytes_accessed = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self._excluded = {self._ref(t.untyped_storage()).cdata
                          for t in _local_tensors(exclude)}
        self._live: dict = {}       # storage key -> (weak ref, bytes)
        self._check: set = set()    # keys whose tensors were collected
        self._tensor_refs: dict = {}

    def _collected(self, key):
        def callback(ref):
            self._check.add(key)
            self._tensor_refs.pop(id(ref), None)
        return callback

    def _local_op(self, func, args, kwargs, out) -> None:
        self.flops += _flops(func, args, kwargs, out)
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        self.bytes_accessed += _nbytes((args, kwargs)) + _nbytes(outs)
        for key in list(self._check):
            ref, n = self._live[key]
            if ref.expired():
                del self._live[key]
                self.live_bytes -= n
            self._check.discard(key)
        for t in outs:
            st = t.untyped_storage()
            ref = self._ref(st)
            key = ref.cdata
            if key in self._excluded:
                continue
            old = self._live.get(key)
            if old is None or old[0].expired():
                if old is not None:
                    self.live_bytes -= old[1]
                self._live[key] = (ref, st.nbytes())
                self.live_bytes += st.nbytes()
            # every tensor on the storage, views too, rechecks it when it
            # is collected
            ref = weakref.ref(t, self._collected(key))
            self._tensor_refs[id(ref)] = ref
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)


def _local_tensors(tree) -> list:
    out = []
    for t in tree_leaves(tree):
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, torch.Tensor):
            out.append(t)
    return out


# CommDebugMode's op names (legacy and native functional collectives) in
# the census's terms
def _comm_debug_counts(comm) -> dict:
    out: dict = {}
    for op, n in comm.get_comm_counts().items():
        name = str(op).split(".")[-1].removesuffix("_")
        for key, ref_name in (("all_gather", "all-gather"),
                              ("reduce_scatter", "reduce-scatter"),
                              ("all_reduce", "all-reduce"),
                              ("allreduce", "all-reduce"),
                              ("all_to_all", "all-to-all"),
                              ("alltoall", "all-to-all"),
                              ("allgather", "all-gather")):
            if key in name:
                out[ref_name] = out.get(ref_name, 0) + n
                break
        else:
            out[name] = out.get(name, 0) + n
    return out


def _local_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _local_tensors(tree))


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def lower_combo(arch: str, shape_name: str, multi_pod: bool,
                moe_dispatch: Optional[str] = None, fsdp: bool = True,
                seq_shard: bool = True, accum: Optional[int] = None,
                kv_tp_repeat: int = 1, remat_policy: str = "full",
                extra_tag: str = "", device=None) -> dict:
    """Trace one (arch, shape, mesh) as rank 0 of the production mesh and
    return its record. The mesh is built over the default group, started
    here as a fake world of 256 or 512 ranks when there is none (the
    caller destroys it); ``device`` names its device type (default
    ``cuda``, which raises without a GPU)."""
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import (SHAPES, get_config, input_specs,
                                     shape_applicable)
    from repro_torch.device import resolve_device
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.train import (make_train_step, pick_accum,
                                          pick_optimizer)
    from repro_torch.models.transformer import (decode_step,
                                                init_decode_state,
                                                init_params)
    from repro_torch.models.transformer.common import set_mesh_axes
    from repro_torch.models.transformer.model import (
        _head_matrix, forward_hidden, scan_length, set_remat_policy,
        set_sequence_sharding)
    from repro_torch.obs.export import run_manifest

    device = resolve_device(device)
    cfg = get_config(arch)
    if moe_dispatch and cfg.moe_num_experts:
        cfg = dataclasses.replace(cfg, moe_dispatch=moe_dispatch)
    if kv_tp_repeat > 1:
        cfg = dataclasses.replace(cfg, kv_tp_repeat=kv_tp_repeat)
    ok, reason = shape_applicable(cfg, shape_name)
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "2x16x16" if multi_pod else "16x16",
           "family": cfg.family, "tag": extra_tag}
    if not ok:
        rec.update(status="skipped", reason=reason)
        return rec
    if cfg.moe_num_experts and cfg.moe_dispatch not in ("tokens", "weights",
                                                        "auto"):
        raise ValueError(f"moe_dispatch {cfg.moe_dispatch!r}; have tokens, "
                         f"weights and auto")

    mesh = make_production_mesh(multi_pod=multi_pod,
                                device_type=device.type)
    set_mesh_axes(dp=shd.dp_axes(mesh), tp=("model",))
    set_sequence_sharding(seq_shard)
    set_remat_policy(remat_policy)
    rec.update(seq_shard=seq_shard, remat_policy=remat_policy, fsdp=fsdp)
    sh = SHAPES[shape_name]

    params = init_params(cfg, device="meta")
    p_specs = shd.param_pspecs(params, fsdp=fsdp)
    data = input_specs(cfg, shape_name)
    opt = pick_optimizer(cfg)
    accum_eff = accum or pick_accum(cfg, sh.global_batch)
    if sh.kind == "train":
        rec["accum"] = accum_eff

    def step_args(place: bool) -> tuple:
        """The step's arguments: meta tensors, placed on the mesh as
        DTensors when ``place``."""
        put = (lambda tree, specs: shd.distribute(mesh, tree, specs)) \
            if place else (lambda tree, specs: tree)
        p = put(params, p_specs)
        if sh.kind == "train":
            state = opt.init(params)
            if place:
                state = shd.distribute_opt_state(
                    mesh, state, shd.opt_pspecs(state, p_specs))
            return p, state, put(data, shd.batch_pspecs(cfg, mesh, data))
        if sh.kind == "prefill":
            return p, put(data, shd.batch_pspecs(cfg, mesh, data))
        B, S = sh.global_batch, sh.seq_len
        if cfg.family == "audio":
            De = cfg.encoder_d_model or cfg.d_model
            enc = _meta((B, cfg.encoder_seq, De), cfg.activation_dtype)
            with torch.no_grad():
                state = init_decode_state(cfg, B, S, enc=enc, params=params)
        else:
            state = init_decode_state(cfg, B, S, device="meta")
        return (p, put(data["token"], (shd.dp_for_batch(mesh, B),)),
                put(state, shd.decode_state_pspecs(cfg, mesh, state)))

    train_step = make_train_step(cfg, opt, accum=accum_eff)

    def run(args):
        if sh.kind == "train":
            return train_step(*args)
        with torch.no_grad():
            if sh.kind == "prefill":
                x, _ = forward_hidden(args[0], cfg, args[1])
                return x[:, -1] @ _head_matrix(args[0])
            return decode_step(args[0], cfg, args[1], args[2])

    # the whole mesh's FLOPs: the same step on plain meta tensors
    with FlopCounterMode(display=False) as whole:
        run(step_args(place=False))
    t0 = time.perf_counter()
    args = step_args(place=True)
    census = StepCensus(exclude=args)
    before = _launches()
    with implicit_replication(), CommDebugMode() as comm, census:
        out = run(args)
    launched = {k: v - before[k] for k, v in _launches().items()}
    t1 = time.perf_counter()
    coll = census.result()
    mem = {"argument_size_in_bytes": _local_bytes(args),
           "output_size_in_bytes": _local_bytes(out),
           "temp_size_in_bytes": census.peak_bytes,
           "generated_code_size_in_bytes": 0}
    rec.update(
        status="ok",
        compile_seconds=round(t1 - t0, 1),
        memory=mem,
        scan_length=scan_length(cfg),
        flops_hlo_raw=float(census.flops),
        flops=float(census.flops),
        flops_global=float(whole.get_total_flops()),
        bytes_accessed_raw=float(census.bytes_accessed),
        bytes_accessed=float(census.bytes_accessed),
        collectives=coll,
        collective_bytes_total=coll["total_bytes"],
        collective_bytes_by_op=dict(coll["bytes_by_op"]),
        comm_debug_counts=_comm_debug_counts(comm),
        params=cfg.param_count(),
        active_params=cfg.active_param_count(),
        device=device.type,
        launches=launched,
        manifest=run_manifest(),
    )
    return rec


def _launches() -> dict:
    """The hand-written kernels' launch counts so far in this process."""
    from repro_torch.kernels import gather_agg, linattn
    return {**gather_agg.launches, **linattn.launches}


def _mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def main(argv=None) -> None:
    import torch.distributed as dist

    from repro_torch.configs import ARCH_IDS, SHAPES
    from repro_torch.device import resolve_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--moe-dispatch", default=None,
                    help="override MoE dispatch mode (tokens|weights|auto)")
    ap.add_argument("--no-fsdp", action="store_true",
                    help="TP-only parameters (no data-axis sharding)")
    ap.add_argument("--no-seq-shard", action="store_true",
                    help="disable sequence-parallel carry sharding")
    ap.add_argument("--accum", type=int, default=None,
                    help="override gradient-accumulation microbatch count")
    ap.add_argument("--kv-tp-repeat", type=int, default=1,
                    help="KV-head replication factor for TP")
    ap.add_argument("--remat-policy", default="full",
                    choices=["full", "dots"],
                    help="per-layer checkpoint policy")
    ap.add_argument("--tag", default="", help="suffix for the result file")
    ap.add_argument("--skip-done", action="store_true")
    ap.add_argument("--device", default=None,
                    help="the mesh's device type: cuda (default) or cpu")
    ap.add_argument("--results-dir", type=Path, default=RESULTS_DIR)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    results = Path(args.results_dir)
    results.mkdir(parents=True, exist_ok=True)
    meshes = [args.multi_pod] if not args.both_meshes else [False, True]
    if args.all:
        combos = [(a, s, mp) for mp in meshes for a in ARCH_IDS
                  for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        combos = [(args.arch, args.shape, mp) for mp in meshes]

    n_ok = n_skip = n_fail = 0
    world_of = None
    for arch, shape_name, mp in combos:
        tagsfx = f".{args.tag}" if args.tag else ""
        fname = results / f"{arch}.{shape_name}.{_mesh_name(mp)}{tagsfx}.json"
        if args.skip_done and fname.exists():
            existing = json.loads(fname.read_text())
            if existing.get("status") in ("ok", "skipped"):
                print(f"[cached ] {fname.name}")
                n_ok += existing["status"] == "ok"
                n_skip += existing["status"] == "skipped"
                continue
        if world_of is not None and world_of != mp:
            dist.destroy_process_group()     # one default group at a time
            world_of = None
        try:
            rec = lower_combo(arch, shape_name, mp,
                              moe_dispatch=args.moe_dispatch,
                              fsdp=not args.no_fsdp,
                              seq_shard=not args.no_seq_shard,
                              accum=args.accum,
                              kv_tp_repeat=args.kv_tp_repeat,
                              remat_policy=args.remat_policy,
                              extra_tag=args.tag, device=device)
        except Exception as e:                        # noqa: BLE001
            rec = {"arch": arch, "shape": shape_name,
                   "mesh": _mesh_name(mp), "status": "failed",
                   "error": f"{type(e).__name__}: {e}",
                   "trace": traceback.format_exc()[-2000:]}
        if dist.is_initialized():
            world_of = mp
        fname.write_text(json.dumps(rec, indent=1))
        st = rec["status"]
        n_ok += st == "ok"
        n_skip += st == "skipped"
        n_fail += st == "failed"
        extra = (f" {rec.get('compile_seconds', '')}s "
                 f"flops={rec.get('flops', 0):.3g}" if st == "ok" else
                 rec.get("reason", rec.get("error", "")))
        print(f"[{st:7s}] {arch} × {shape_name} × {_mesh_name(mp)}{extra}",
              flush=True)
    if dist.is_initialized():
        dist.destroy_process_group()
    print(f"\ndone: {n_ok} ok, {n_skip} skipped, {n_fail} failed")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
