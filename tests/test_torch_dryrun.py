"""The port's pod dry runs (``repro_torch.launch.dryrun_gnn`` and the
transformer's ``launch.dryrun``), the census of collectives, the meshes
(``launch.mesh``) and the shape registry (``configs``), against the
reference.

Every dry run is a subprocess with one torch thread and a timeout of its
own: a process holds one default process group at a time, and a fake
world is one. The reference is compiled in a subprocess too, with
``XLA_FLAGS`` set only there. The shapes are the reference's stand-ins,
narrowed as ``--batch-pad 4 --r-max 256 --feature-dim 128 --hidden 32``
(3 SAGE layers, fanout 10, 16,384 local rows).
"""
import ast
import json
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import pytest

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.configs import input_specs as jax_input_specs
from repro.configs import shape_applicable as jax_shape_applicable
from repro_torch import configs

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.abspath(os.path.join(HERE, os.pardir, "src"))
TIMEOUT_S = 120
NARROW = dict(batch_pad=4, r_max=256, feature_dim=128, hidden=32)
LAYERS, FANOUT, LOCAL_ROWS = 3, 10, 16384
WORLD = 8
MODES = {"pregather": (True, False), "unfolded": (False, False),
         "folded": (False, True)}


def _python(code_or_args, env=None):
    """Run python in a subprocess with one thread; returns its stdout."""
    args = (["-c", code_or_args] if isinstance(code_or_args, str)
            else code_or_args)
    full = dict(os.environ, PYTHONPATH=os.pathsep.join([SRC, HERE]),
                OMP_NUM_THREADS="1", **(env or {}))
    out = subprocess.run([sys.executable, *args], env=full,
                         capture_output=True, text=True, timeout=TIMEOUT_S)
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout


def _last_json(stdout: str):
    return json.loads(stdout.strip().splitlines()[-1])


_REFERENCE = f"""
import json
import jax, jax.numpy as jnp
from repro.core.distributed import make_sharded_iteration
from repro.launch.dryrun import collective_bytes
from repro.models.gnn import GNNConfig, init_gnn
n, L, f, bp, rows = {WORLD}, {LAYERS}, {FANOUT}, {NARROW['batch_pad']}, \\
    {LOCAL_ROWS}
d, r, hid = {NARROW['feature_dim']}, {NARROW['r_max']}, {NARROW['hidden']}
T = n
mesh = jax.make_mesh((n,), ("data",))
cfg = GNNConfig(model="sage", num_layers=L, hidden_dim=hid, feature_dim=d,
                num_classes=47, fanout=f)
params = jax.eval_shape(lambda: init_gnn(jax.random.PRNGKey(0), cfg))
S = jax.ShapeDtypeStruct
out = {{}}
for name, (pg, fold) in {MODES!r}.items():
    dev = dict(req=S((n, n, r), jnp.int32) if pg else None,
               step_req=None if pg else S((n, T, n, r), jnp.int32),
               hop_idx=[S((n, T, bp * f ** h), jnp.int32)
                        for h in range(L + 1)],
               labels=S((n, T, bp), jnp.int32),
               weights=S((n, T, bp), jnp.float32))
    fn = make_sharded_iteration(cfg, pregather=pg, mesh=mesh,
                                fold_returns=fold)
    compiled = fn.lower(params, S((n, rows, d), jnp.float32),
                        S((n, 0, d), jnp.float32), dev,
                        S((), jnp.float32)).compile()
    out[name] = collective_bytes(compiled.as_text())
print(json.dumps(out))
"""

_PORT = f"""
import json
from repro_torch.launch import dryrun_gnn
out = {{}}
for name, (pg, fold) in {MODES!r}.items():
    rec, _, _ = dryrun_gnn.run({WORLD}, device="cpu", pregather=pg,
                               fold_returns=fold, results_dir=None,
                               **{NARROW!r})
    out[name] = rec
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_census():
    return _last_json(_python(_REFERENCE, env={
        "XLA_FLAGS": f"--xla_force_host_platform_device_count={WORLD}",
        "JAX_PLATFORMS": "cpu"}))


@pytest.fixture(scope="module")
def port_records():
    return _last_json(_python(_PORT))


def _feature_return_bytes(n, r, d):
    """One feature return of one step: (P, r_max, d) float32."""
    return n * r * d * 4


@pytest.mark.parametrize("mode", list(MODES))
def test_census_matches_the_reference_at_world_8(mode, reference_census,
                                                 port_records):
    """Rank 0's collective bytes per op, the port's census of one executed
    iteration against the reference's census of its compiled HLO.

    Pregather and folded per-step mode: equal op by op, bytes and counts.
    Unfolded per-step mode runs one feature return per step inside the
    reference's ``lax.scan``; its HLO lists that op once, while the port
    executes it T times. So the port's all-to-all bytes equal the census
    with the in-scan op taken T times (the reference's own correction for
    loop bodies, ``repro/launch/dryrun.py``'s unroll extrapolation), and
    its count is T + 1 against the census's 2. The all-reduce is equal."""
    ref, rec = reference_census[mode], port_records[mode]
    port = rec["collectives"]
    assert rec["shard_comm"]["nbytes"] == {
        "all_to_all": port["bytes_by_op"]["all-to-all"],
        "all_reduce": port["bytes_by_op"]["all-reduce"]}
    assert rec["shard_comm"]["counts"] == {
        "all_to_all": port["count_by_op"]["all-to-all"],
        "all_reduce": port["count_by_op"]["all-reduce"]}
    if mode != "unfolded":
        assert port == ref
        return
    T = WORLD
    in_scan = _feature_return_bytes(WORLD, NARROW["r_max"],
                                    NARROW["feature_dim"])
    assert port["bytes_by_op"]["all-to-all"] \
        == ref["bytes_by_op"]["all-to-all"] + (T - 1) * in_scan == 8_454_144
    assert ref["bytes_by_op"]["all-to-all"] == 1_114_112
    assert port["count_by_op"]["all-to-all"] == T + 1
    assert ref["count_by_op"]["all-to-all"] == 2
    assert port["bytes_by_op"]["all-reduce"] \
        == ref["bytes_by_op"]["all-reduce"]
    assert port["count_by_op"]["all-reduce"] \
        == ref["count_by_op"]["all-reduce"] == 1


def test_port_flops_count_every_step(port_records):
    """FlopCounterMode counts the matmuls of all T steps, forward and
    backward; the three modes run the same model on the same trees. (The
    reference's cost analysis counts the scan body once: the two packages'
    FLOPs are not compared.)"""
    flops = {m: r["flops"] for m, r in port_records.items()}
    assert flops == {m: 121_399_296.0 for m in MODES}


# the closed form at world 256: the CLI with the narrowed shapes, the
# plain gather_rows wrapped with a counter
_CLI_256 = """
import json, sys
from repro_torch.kernels import ref
from repro_torch.launch import dryrun_gnn
calls = [0]
plain = ref.gather_rows_ref
def counted(table, idx):
    calls[0] += 1
    return plain(table, idx)
ref.gather_rows_ref = counted
dryrun_gnn.main(sys.argv[1:])
print(json.dumps({"gather_rows_ref_calls": calls[0]}))
"""


@pytest.fixture(scope="module")
def cli_256(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("dryrun")
    stdout = _python(["-c", _CLI_256, "--device", "cpu", "--batch-pad", "4",
                      "--r-max", "256", "--feature-dim", "128", "--hidden",
                      "32", "--results-dir", str(out_dir)])
    rec = json.loads((out_dir / "hopgnn.sage.256shards.json").read_text())
    return dict(stdout=stdout, rec=rec, calls=_last_json(stdout))


def _sage_params(d, hidden, layers, classes=47):
    """SAGE: w_self and w_nbr (d_in, d_out) and b (d_out) per layer, and
    the head's w and b."""
    dims = [d] + [hidden] * layers
    n = sum(2 * a * b + b for a, b in zip(dims[:-1], dims[1:]))
    return n + hidden * classes + classes


def test_closed_form_at_world_256(cli_256):
    """Rank 0 of a fake 256-rank world: the exchange moves n·r_max int32
    indices and n·r_max·d float32 rows, the one all-reduce carries every
    parameter's gradient and the loss, the census equals ShardComm's own
    bytes, and the plain gather_rows runs (layers + 1)·T times per call
    (twice here: the counted call and the measured one)."""
    rec, n = cli_256["rec"], 256
    r, d = NARROW["r_max"], NARROW["feature_dim"]
    coll = rec["collectives"]
    assert coll["count_by_op"] == {"all-to-all": 2, "all-reduce": 1}
    assert coll["bytes_by_op"]["all-to-all"] == n * r * 4 + n * r * d * 4 \
        == 33_816_576
    n_params = _sage_params(d, NARROW["hidden"], LAYERS)
    assert coll["bytes_by_op"]["all-reduce"] == (n_params + 1) * 4
    assert rec["memory"]["output_size_in_bytes"] == (n_params + 1) * 4
    assert rec["shard_comm"]["nbytes"] == {
        "all_to_all": coll["bytes_by_op"]["all-to-all"],
        "all_reduce": coll["bytes_by_op"]["all-reduce"]}
    assert cli_256["calls"]["gather_rows_ref_calls"] \
        == 2 * (LAYERS + 1) * n
    assert rec["launches"] == {"gather_rows": 0, "gather_agg": 0,
                               "sample_tree": 0}


_OK_RE = re.compile(r"^\[ok\] hopgnn (\w+) iteration on (\d+)-shard mesh: "
                    r"temp (\S+) GB/dev, collectives ([0-9.]+) GB "
                    r"\((\{.*\})\)$")


def test_record_has_the_reference_keys_and_ok_line(cli_256):
    """The record carries every key the reference's record has, with the
    reference's mesh string, and the printed summary line parses as the
    reference's does."""
    rec = cli_256["rec"]
    for key in ("kind", "mesh", "model", "status", "memory", "flops",
                "collectives"):
        assert key in rec
    assert rec["kind"] == "hopgnn_gnn_iteration"
    assert rec["mesh"] == "256x1(data)" and rec["status"] == "ok"
    assert set(rec["memory"]) == {"argument_size_in_bytes",
                                  "output_size_in_bytes",
                                  "temp_size_in_bytes"}
    assert rec["memory"]["temp_size_in_bytes"] is None      # the CPU
    assert set(rec["collectives"]) == {"bytes_by_op", "count_by_op",
                                       "total_bytes"}
    assert rec["flops"] > 0 and rec["iteration_ms"] > 0
    assert {"torch", "cuda", "gpu"} <= set(rec["manifest"])
    line = next(l for l in cli_256["stdout"].splitlines()
                if l.startswith("[ok]"))
    m = _OK_RE.match(line)
    assert m, line
    model, n, temp, gb, counts = m.groups()
    assert (model, int(n), temp) == ("sage", 256, "n/a")
    assert float(gb) == round(rec["collectives"]["total_bytes"] / 1e9, 2)
    assert ast.literal_eval(counts) == rec["collectives"]["count_by_op"]


_CENSUS_KINDS = """
import json
import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from repro_torch.launch.dryrun import CollectiveCensus
from repro_torch.launch.mesh import init_fake_world
init_fake_world(4, "cpu")
g = dist.group.WORLD
x = torch.ones(8, 3)
with CollectiveCensus() as census:
    dist.all_gather_into_tensor(torch.empty(32, 3), x)
    dist.all_gather([torch.empty(8, 3) for _ in range(4)], x)
    dist.reduce_scatter_tensor(torch.empty(2, 3), x)
    dist.all_reduce(x)
    dist.all_to_all_single(torch.empty(8, 3), x)
    for t in (funcol.all_gather_tensor(x, 0, g),
              funcol.reduce_scatter_tensor(x, "sum", 0, g),
              funcol.all_reduce(x, "sum", g),
              funcol.all_to_all_single(x, None, None, g)):
        funcol.wait_tensor(t)
dist.destroy_process_group()
print(json.dumps(census.result()))
"""


def test_census_counts_each_collective_kind():
    """On a fake world of 4, each kind through ``torch.distributed`` and
    through the functional collectives, an (8, 3) float32 input per
    rank: all-gather counts the gathered (32, 3) output, reduce-scatter
    the scattered (2, 3), all-reduce and all-to-all their (8, 3)."""
    res = _last_json(_python(_CENSUS_KINDS))
    row = 3 * 4
    assert res["count_by_op"] == {"all-gather": 3, "reduce-scatter": 2,
                                  "all-reduce": 2, "all-to-all": 2}
    assert res["bytes_by_op"] == {"all-gather": 3 * 32 * row,
                                  "reduce-scatter": 2 * 2 * row,
                                  "all-reduce": 2 * 8 * row,
                                  "all-to-all": 2 * 8 * row}
    assert res["total_bytes"] == sum(res["bytes_by_op"].values())


_LOOPBACK = """
import json, sys
import torch
import torch.distributed as dist
from repro_torch.core import distributed as engine
from repro_torch.launch import dryrun_gnn
narrow = dict(batch_pad=4, r_max=256, feature_dim=128, hidden=32)
clean, _, _ = dryrun_gnn.run(8, device="cpu", results_dir=None, **narrow)
# a backend that leaves the receive buffer as it was, over a buffer that
# holds out-of-range values until the dry run's copy
empty_like = torch.empty_like
def poisoned(x, *a, **k):
    return torch.full_like(empty_like(x, *a, **k), 1 << 30)
torch.empty_like = poisoned
dist.all_to_all_single = lambda out, x, group=None: None
stubbed, _, _ = dryrun_gnn.run(8, device="cpu", results_dir=None, **narrow)
init = engine.ShardComm.__init__
def without_loopback(self, group=None):
    init(self, group)
    self.loopback = False
engine.ShardComm.__init__ = without_loopback
engine.clear_compile_cache()
try:
    dryrun_gnn.run(8, device="cpu", results_dir=None, **narrow)
    failed = ""
except IndexError as e:
    failed = str(e)
print(json.dumps({"clean": clean["loss"], "stubbed": stubbed["loss"],
                  "without_loopback": failed}))
"""


def test_loopback_keeps_the_exchanged_indices_in_range():
    """With a backend that never writes the receive buffer, and a receive
    buffer full of out-of-range values, the dry run's copy of the send
    buffer wins: the run completes with the same loss as on the real fake
    backend. Without the copy the same stubs send the out-of-range indices
    into the exchange's gather, which raises."""
    res = _last_json(_python(_LOOPBACK))
    assert res["stubbed"] == res["clean"]
    assert "out of range" in res["without_loopback"]


@pytest.mark.parametrize("shape", list(JAX_SHAPES))
@pytest.mark.parametrize("arch", JAX_ARCH_IDS)
def test_input_specs_match_the_reference(arch, shape):
    """Names, shapes and dtypes of every data input, on the meta device;
    ``shape_applicable`` equal, reason included."""
    assert configs.ARCH_IDS == JAX_ARCH_IDS
    cfg_t, cfg_j = configs.get_config(arch), jax_get_config(arch)
    assert configs.shape_applicable(cfg_t, shape) \
        == jax_shape_applicable(cfg_j, shape)
    got, want = configs.input_specs(cfg_t, shape), \
        jax_input_specs(cfg_j, shape)
    assert list(got) == list(want)
    for k, spec in want.items():
        assert got[k].device.type == "meta"
        assert tuple(got[k].shape) == tuple(spec.shape)
        assert str(got[k].dtype).removeprefix("torch.") \
            == jnp.dtype(spec.dtype).name


def test_input_specs_override_seq_and_batch():
    for arch in ("pixtral-12b", "whisper-base", "qwen2-1.5b"):
        got = configs.input_specs(configs.get_config(arch), "train_4k",
                                  seq=256, batch=2)
        want = jax_input_specs(jax_get_config(arch), "train_4k", seq=256,
                               batch=2)
        assert {k: tuple(v.shape) for k, v in got.items()} \
            == {k: tuple(v.shape) for k, v in want.items()}


def test_shapes_registry_matches_the_reference():
    assert {k: (v.name, v.seq_len, v.global_batch, v.kind)
            for k, v in configs.SHAPES.items()} \
        == {k: (v.name, v.seq_len, v.global_batch, v.kind)
            for k, v in JAX_SHAPES.items()}


_MESHES = """
import json
import torch.distributed as dist
from repro_torch.launch.mesh import init_fake_world, make_production_mesh
out = {}
for multi in (False, True):
    mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
    out[str(multi)] = dict(
        shape=list(mesh.shape), names=list(mesh.mesh_dim_names),
        world=dist.get_world_size(), backend=dist.get_backend(),
        groups=[dist.get_world_size(mesh.get_group(a))
                for a in mesh.mesh_dim_names])
    try:
        init_fake_world(8, "cpu")
        out[str(multi)]["second"] = ""
    except RuntimeError as e:
        out[str(multi)]["second"] = str(e)
    dist.destroy_process_group()
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def production_meshes():
    return _last_json(_python(_MESHES))


@pytest.mark.parametrize("multi_pod,shape,names", [
    (False, [16, 16], ["data", "model"]),
    (True, [2, 16, 16], ["pod", "data", "model"])])
def test_production_mesh_on_a_fake_world(multi_pod, shape, names,
                                         production_meshes):
    """16×16 over a fake world of 256 ranks, 2×16×16 over 512, started by
    the mesh itself; a second default group is refused by name."""
    m = production_meshes[str(multi_pod)]
    assert m["shape"] == shape and m["names"] == names
    assert m["world"] == (512 if multi_pod else 256)
    assert m["backend"] == "fake" and m["groups"] == shape
    assert "already exists" in m["second"]


def test_host_mesh_on_a_gloo_world_of_8(tmp_path):
    """make_host_mesh(4, 2) over 8 spawned gloo ranks: each rank's
    coordinate is (rank // 2, rank % 2), and a sum over each axis's group
    adds the ranks that share the other coordinate."""
    _python([os.path.join(HERE, "_torch_dryrun_ranks.py"), str(tmp_path)])
    for rank in range(8):
        res = json.loads((tmp_path / f"rank{rank}.json").read_text())
        i, j = divmod(rank, 2)
        assert res["shape"] == [4, 2] and res["names"] == ["data", "model"]
        assert res["device_type"] == "cpu"
        assert res["coordinate"] == [i, j]
        assert res["sums"] == {"model": float(2 * i + 2 * i + 1),
                               "data": float(sum(j + 2 * k
                                                 for k in range(4)))}


_REFUSALS = """
import json, os, sys, tempfile
import torch.distributed as dist
from repro_torch.launch import mesh
out = {}
try:
    mesh.make_host_mesh(4, 2)
except RuntimeError as e:
    out["host_without_world"] = str(e)
sys.modules["torch.testing._internal.distributed.fake_pg"] = None
try:
    mesh.init_fake_world(4, "cpu")
except RuntimeError as e:
    out["no_fake_backend"] = str(e)
del sys.modules["torch.testing._internal.distributed.fake_pg"]
mesh.init_fake_world(4, "cpu")
try:
    mesh.make_production_mesh(device_type="cpu")
except ValueError as e:
    out["wrong_world"] = str(e)
dist.destroy_process_group()
print(json.dumps(out))
"""


def test_mesh_refusals():
    """A host mesh needs a world; a torch without the fake backend is
    named; a production mesh over a world of the wrong size is refused."""
    res = _last_json(_python(_REFUSALS))
    assert "none is initialized" in res["host_without_world"]
    assert "no fake process group" in res["no_fake_backend"]
    assert "needs 256 ranks" in res["wrong_world"]


_IMPORTS = """
import json, sys
import torch.distributed as dist
import repro_torch.launch.dryrun, repro_torch.launch.dryrun_gnn
import repro_torch.launch.mesh, repro_torch.launch.sharding
print(json.dumps({"initialized": dist.is_initialized(),
                  "fake_pg": "torch.testing._internal.distributed.fake_pg"
                             in sys.modules,
                  "jax": sorted(k for k in sys.modules
                                if k.split(".")[0] in ("jax", "repro"))}))
"""


def test_importing_the_dry_run_starts_no_world():
    """Importing the dry-run modules and the sharding policy starts no
    process group and loads no ``torch.testing._internal`` module, and no
    module of JAX or of the reference."""
    assert _last_json(_python(_IMPORTS)) == {"initialized": False,
                                            "fake_pg": False, "jax": []}


# ---------------------------------------------------------------------------
# the transformer pod dry run: launch/dryrun.py's lower_combo and main
# ---------------------------------------------------------------------------

LM_TIMEOUT_S = 400
# rank 0's argument bytes of the reference's qwen2-1.5b × train_4k on its
# 16x16 mesh (memory_analysis() of the compiled step, XLA on 512
# placeholder host devices)
REF_TRAIN_ARGUMENT_BYTES = 70_785_028
# the reference record's keys (repro/launch/dryrun.py's lower_combo)
REF_KEYS = {"arch", "shape", "mesh", "family", "tag", "status", "seq_shard",
            "remat_policy", "fsdp", "compile_seconds", "memory",
            "scan_length", "flops_hlo_raw", "flops", "bytes_accessed_raw",
            "bytes_accessed", "collectives", "collective_bytes_total",
            "collective_bytes_by_op", "params", "active_params"}


def _lm_cli(args, out_dir, expect_rc=0):
    """``python -m repro_torch.launch.dryrun ... --device cpu`` in a child
    with one thread; its stdout."""
    full = dict(os.environ, PYTHONPATH=os.pathsep.join([SRC, HERE]),
                OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *args,
         "--device", "cpu", "--results-dir", str(out_dir)],
        env=full, capture_output=True, text=True, timeout=LM_TIMEOUT_S)
    assert proc.returncode == expect_rc, proc.stderr[-4000:]
    return proc.stdout


def _record(out_dir, arch, shape, mesh="16x16"):
    return json.loads((out_dir / f"{arch}.{shape}.{mesh}.json").read_text())


@pytest.fixture(scope="module")
def lm_train(tmp_path_factory):
    out = tmp_path_factory.mktemp("lm_train")
    stdout = _lm_cli(["--arch", "qwen2-1.5b", "--shape", "train_4k"], out)
    return stdout, _record(out, "qwen2-1.5b", "train_4k")


def test_lm_train_record_argument_bytes_and_census(lm_train):
    """qwen2-1.5b × train_4k on the fake 256-rank world: rank 0's share of
    the parameters, AdamW's moments and step and the batch is the
    reference's argument size to the byte; the census counts every kind
    of collective the step issues and agrees with CommDebugMode's count."""
    stdout, rec = lm_train
    assert rec["status"] == "ok" and rec["accum"] == 1
    assert rec["memory"]["argument_size_in_bytes"] \
        == REF_TRAIN_ARGUMENT_BYTES
    coll = rec["collectives"]
    assert coll["count_by_op"] == rec["comm_debug_counts"]
    assert set(coll["count_by_op"]) >= {"all-gather", "all-reduce",
                                        "reduce-scatter"}
    assert all(n > 0 for n in coll["count_by_op"].values())
    assert all(b > 0 for b in coll["bytes_by_op"].values())
    assert rec["collective_bytes_total"] == coll["total_bytes"] \
        == sum(coll["bytes_by_op"].values())
    assert "[ok     ] qwen2-1.5b × train_4k × 16x16" in stdout
    assert stdout.strip().splitlines()[-1] == "done: 1 ok, 0 skipped, 0 failed"


def test_lm_record_has_the_reference_keys(lm_train):
    _, rec = lm_train
    assert REF_KEYS | {"accum", "flops_global", "manifest"} <= set(rec)
    assert set(rec["memory"]) == {"argument_size_in_bytes",
                                  "output_size_in_bytes",
                                  "temp_size_in_bytes",
                                  "generated_code_size_in_bytes"}
    assert rec["memory"]["generated_code_size_in_bytes"] == 0
    assert rec["memory"]["temp_size_in_bytes"] > 0
    assert set(rec["collectives"]) == {"bytes_by_op", "count_by_op",
                                       "total_bytes"}
    assert (rec["mesh"], rec["family"], rec["fsdp"], rec["seq_shard"],
            rec["remat_policy"], rec["scan_length"]) \
        == ("16x16", "dense", True, True, "full", 28)
    assert rec["params"] == rec["active_params"] == 1_782_140_928
    assert rec["flops_hlo_raw"] == rec["flops"]
    assert rec["bytes_accessed_raw"] == rec["bytes_accessed"] > 0
    assert {"torch", "cuda", "gpu"} <= set(rec["manifest"])


_PLAIN_FLOPS = """
import json, sys, torch
from torch.utils.flop_counter import FlopCounterMode
from repro_torch.configs import SHAPES, get_config, input_specs
from repro_torch.launch.train import make_train_step, pick_accum, pick_optimizer
from repro_torch.models.transformer import (decode_step, init_decode_state,
                                            init_params)
out = {}
for arch, shape in (("qwen2-1.5b", "train_4k"), ("qwen2-1.5b", "decode_32k")):
    cfg, sh = get_config(arch), SHAPES[shape]
    params = init_params(cfg, device="meta")
    data = input_specs(cfg, shape)
    with FlopCounterMode(display=False) as fc:
        if sh.kind == "train":
            opt = pick_optimizer(cfg)
            make_train_step(cfg, opt, pick_accum(cfg, sh.global_batch))(
                params, opt.init(params), data)
        else:
            state = init_decode_state(cfg, sh.global_batch, sh.seq_len,
                                      device="meta")
            with torch.no_grad():
                decode_step(params, cfg, data["token"], state)
    out[shape] = fc.get_total_flops()
print(json.dumps(out))
"""


def test_lm_flops_global_and_local(lm_train, tmp_path):
    """``flops_global`` is FlopCounterMode's count of the same step on
    plain meta tensors (train and decode), and rank 0's ``flops`` lies
    between a 256th of it and all of it."""
    _, train = lm_train
    _lm_cli(["--arch", "qwen2-1.5b", "--shape", "decode_32k"], tmp_path)
    decode = _record(tmp_path, "qwen2-1.5b", "decode_32k")
    plain = _last_json(_python(_PLAIN_FLOPS))
    for rec, shape in ((train, "train_4k"), (decode, "decode_32k")):
        assert rec["flops_global"] == plain[shape] > 0
        assert rec["flops_global"] / 256 <= rec["flops"] \
            <= rec["flops_global"]


def test_lm_statuses_skipped_and_failed(tmp_path):
    """A long_500k combo of a full-attention arch is skipped with the
    reference's reason; an invalid MoE dispatch fails the combo (error and
    trace recorded) and main exits 1."""
    stdout = _lm_cli(["--arch", "qwen2-1.5b", "--shape", "long_500k"],
                     tmp_path)
    rec = _record(tmp_path, "qwen2-1.5b", "long_500k")
    reason = jax_shape_applicable(jax_get_config("qwen2-1.5b"),
                                  "long_500k")[1]
    assert rec["status"] == "skipped" and rec["reason"] == reason
    assert "done: 0 ok, 1 skipped, 0 failed" in stdout
    stdout = _lm_cli(["--arch", "deepseek-moe-16b", "--shape", "decode_32k",
                      "--moe-dispatch", "bogus", "--tag", "bad"], tmp_path,
                     expect_rc=1)
    rec = json.loads((tmp_path / "deepseek-moe-16b.decode_32k.16x16.bad.json")
                     .read_text())
    assert rec["status"] == "failed"
    assert "moe_dispatch 'bogus'" in rec["error"]
    assert "Traceback" in rec["trace"] and len(rec["trace"]) <= 2000
    assert "[failed ] deepseek-moe-16b × decode_32k × 16x16" in stdout
    assert "done: 0 ok, 0 skipped, 1 failed" in stdout


_NO_CUDA_LINATTN = """
import json, sys
import torch
from repro_torch.kernels import _build, linattn as la, ops
def refuse(*a, **k):
    raise AssertionError("the CUDA linattn was reached")
_build.load = refuse
la.linattn_chunked = refuse
# the plain version on meta inputs
q = torch.empty((4, 128, 64), device="meta")
u = torch.empty((4, 64), device="meta")
o, s = ops.linattn(q, q, q, q, u)
from repro_torch.launch import dryrun
dryrun.main(sys.argv[1:])
print(json.dumps({"launches": la.launches["linattn"],
                  "library": la._lib is not None,
                  "o": list(o.shape), "s": list(s.shape)}))
"""


def test_lm_dry_run_never_reaches_the_cuda_linattn(tmp_path):
    """rwkv6-7b × decode_32k with the CUDA kernel's wrapper and library
    loader replaced by ones that raise: the combo is ok, nothing was
    launched or loaded, and ops.linattn on meta tensors takes the plain
    version."""
    full = dict(os.environ, PYTHONPATH=os.pathsep.join([SRC, HERE]),
                OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", _NO_CUDA_LINATTN, "--arch", "rwkv6-7b",
         "--shape", "decode_32k", "--device", "cpu", "--results-dir",
         str(tmp_path)], env=full, capture_output=True, text=True,
        timeout=LM_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = _last_json(proc.stdout)
    assert res == {"launches": 0, "library": False, "o": [4, 128, 64],
                   "s": [4, 64, 64]}
    assert _record(tmp_path, "rwkv6-7b", "decode_32k")["status"] == "ok"
