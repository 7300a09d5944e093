"""The port stands alone: importing every module of ``repro_torch`` loads
neither JAX nor any module of the reference package, and its entry points
run on CUDA unless told otherwise — without a GPU they raise instead of
quietly running on the CPU."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, smoke_variant
from repro_torch.launch.serve import LLMServer
from repro_torch.models import transformer
from repro_torch.models.gnn.models import GNNConfig, init_gnn
from repro_torch.serve import GNNServer

_IMPORT_ALL = """
import importlib, json, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "repro", "ml_dtypes"))
print(json.dumps({"modules": names, "bad": bad}))
"""

# Checkpoints, the precomputed tier, resilience and membership at work in
# a process where ml_dtypes cannot be imported: a bfloat16 leaf round
# trip, a FaultPlan fired at the comm boundary, a membership view, and an
# empty embedding directory refused.
_USE_NEW_MODULES = """
import json, sys, tempfile, types
sys.modules["ml_dtypes"] = None
import torch
import repro_torch.checkpoint as ck
import repro_torch.membership as mb
import repro_torch.resilience as rs
import repro_torch.serve.embeddings as emb
from repro_torch.core import distributed as engine
d = tempfile.mkdtemp()
w = torch.arange(6.0).to(torch.bfloat16)
ck.save_checkpoint(d, 1, {"w": w})
tree, step, _ = ck.load_checkpoint(d, {"w": torch.zeros(6,
                                                        dtype=torch.bfloat16)})
fp = rs.FaultPlan([rs.FaultSpec("comm_delay", epoch=0, it=0)])
with fp.active():
    engine.comm_fault_point(types.SimpleNamespace(epoch_it=(0, 0)))
view = mb.MembershipView(4)
view.confirm_dead(1)
try:
    emb.load_embeddings(d)
    refused = False
except FileNotFoundError:
    refused = True
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({"bf16": bool(torch.equal(tree["w"], w)),
                  "fired": fp.fired_count(), "gen": view.generation,
                  "refused": refused, "bad": bad}))
"""


def test_importing_the_port_loads_no_jax_and_no_reference():
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(src))
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert "repro_torch.serve.server" in res["modules"]
    assert "repro_torch.kernels.gather_agg" in res["modules"]
    assert "repro_torch.kernels.linattn" in res["modules"]
    assert "repro_torch.launch.serve" in res["modules"]
    for name in ("optim.optimizers", "core.micrograph", "core.merging",
                 "core.pregather", "core.strategies", "core.distributed",
                 "cache.prefetch", "train.budget", "train.pipeline",
                 "train.loop", "launch.train_gnn", "checkpoint.store",
                 "resilience.faults", "resilience.comm",
                 "resilience.supervisor", "membership.view",
                 "membership.detector", "membership.recovery",
                 "serve.embeddings"):
        assert f"repro_torch.{name}" in res["modules"]
    assert res["bad"] == []


def test_new_modules_run_without_jax_and_ml_dtypes():
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(src))
    out = subprocess.run([sys.executable, "-c", _USE_NEW_MODULES], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"bf16": True, "fired": 1, "gen": 1, "refused": True,
                   "bad": []}


def _no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")


def test_init_gnn_without_gpu_raises():
    _no_gpu()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_gnn(GNNConfig(model="sage", num_layers=1, feature_dim=4))


def test_server_without_gpu_raises():
    _no_gpu()
    cfg = GNNConfig(model="sage", num_layers=1, hidden_dim=8, feature_dim=4,
                    num_classes=3, fanout=2)
    params = init_gnn(cfg, device="cpu")
    from repro_torch.graph.structs import CSRGraph
    g = CSRGraph.from_edges(4, np.array([0, 1, 2]), np.array([1, 2, 3]))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GNNServer(graph=g, params=params, cfg=cfg,
                  store=np.zeros((4, 4), np.float32))


def test_init_transformer_params_without_gpu_raises():
    _no_gpu()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        transformer.init_params(smoke_variant(get_config("rwkv6-7b")))


def test_llm_server_without_gpu_raises():
    _no_gpu()
    cfg = smoke_variant(get_config("rwkv6-7b"))
    params = transformer.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LLMServer(params, cfg)


def test_trainer_without_gpu_raises():
    _no_gpu()
    from repro_torch.graph.structs import CSRGraph
    from repro_torch.train import Trainer
    cfg = GNNConfig(model="sage", num_layers=1, hidden_dim=8, feature_dim=4,
                    num_classes=3, fanout=2)
    g = CSRGraph.from_edges(4, np.array([0, 1, 2]), np.array([1, 2, 3]))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(graph=g, labels=np.zeros(4, np.int32),
                part=np.array([0, 0, 1, 1]), owner=np.array([0, 0, 1, 1]),
                local_idx=np.array([0, 1, 0, 1]),
                table=np.zeros((2, 2, 4), np.float32), cfg=cfg)
