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
             if k.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({"modules": names, "bad": bad}))
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
    assert res["bad"] == []


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
