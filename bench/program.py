"""The program under test as the drivers build it from the benchmark's
inputs: its graph type, partition and sharded table, its model object
holding the benchmark's weights, its optimizer, and the configuration's
precision. Everything here calls ``repro_torch``; nothing here computes
what the reference computes."""
from __future__ import annotations

import numpy as np
import torch

from bench.reference import gnn as ref_gnn


def world(config: dict, ds):
    """The program's view of the inputs: its graph type, the partition and
    the sharded feature table it trains from."""
    from repro_torch.graph.partition import (community_partition,
                                             shard_features)
    from repro_torch.graph.structs import CSRGraph
    shards = config["partition"]["shards"]
    part = community_partition(np.asarray(ds.communities), shards)
    table, owner, local_idx = shard_features(np.asarray(ds.features), part,
                                             shards)
    graph = CSRGraph(indptr=np.array(ds.graph.indptr),
                     indices=np.array(ds.graph.indices))
    return graph, part, table, owner, local_idx


def gnn(params: dict, model: dict):
    """The program's model object holding copies of the benchmark's
    weights."""
    from repro_torch.models.gnn.layers import LAYER_REGISTRY
    from repro_torch.models.gnn.models import GNN
    cls = LAYER_REGISTRY[model["kind"]][1]
    layers = [cls({k: v.detach().clone() for k, v in
                   ref_gnn.layer_params(params, i).items()})
              for i in range(model["num_layers"])]
    return GNN(layers, {"w": params["head.w"].detach().clone(),
                        "b": params["head.b"].detach().clone()})


def leaf_names(gnn) -> list:
    """Names of ``gnn.leaves()`` in its order (head first, then each layer,
    each by sorted parameter name)."""
    mods = [("head", gnn.head)] + [(f"layers.{i}", m)
                                   for i, m in enumerate(gnn.layers)]
    return [f"{p}.{k}" for p, m in mods for k in sorted(m._parameters)]


def optimizer(spec: dict):
    from repro_torch.optim import adamw, cosine_schedule
    return adamw(cosine_schedule(spec["lr"], warmup=spec["warmup"],
                                 total=spec["total"]),
                 b1=spec.get("b1", 0.9), b2=spec.get("b2", 0.999),
                 eps=spec.get("eps", 1e-8),
                 weight_decay=spec["weight_decay"],
                 grad_clip=spec["grad_clip"],
                 key=("cos", spec["lr"], spec["warmup"], spec["total"]))


def set_precision(config: dict) -> None:
    """The configuration's precision: float32 matmuls in full float32."""
    prec = config["precision"]
    if prec["dtype"] != "float32":
        raise ValueError(f"this driver runs float32, not {prec['dtype']}")
    torch.backends.cuda.matmul.allow_tf32 = bool(prec["allow_tf32"])
    torch.backends.cudnn.allow_tf32 = bool(prec["allow_tf32"])
