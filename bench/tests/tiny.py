"""Tiny cells for the CPU tests: the real drivers and comparisons, at a
size a test run holds."""
import copy
import json
from pathlib import Path

from bench import harness

BENCH = Path(__file__).resolve().parents[1]

TINY_DATASET = {"num_vertices": 4096, "avg_degree": 8.0, "feature_dim": 16,
                "num_classes": 5, "community_size": 256, "p_intra": 0.85,
                "train_frac": 0.25, "seed": 3}
TINY_MODELS = {
    "sage": {"kind": "sage", "num_layers": 2, "hidden_dim": 16, "fanout": 4},
    "gat": {"kind": "gat", "num_layers": 2, "hidden_dim": 16, "heads": 2,
            "fanout": 4},
}
TRAIN_TRAFFIC = {"driver": "train", "batch_per_model": 8, "check_steps": 3,
                 "warmup_iters": 2, "warmup_min_epochs": 1,
                 "warmup_max_epochs": 4, "window_min_iters": 4}
LOOSE = {"loss_gap": 1e-5, "epoch_loss_gap": 1e-4, "grad_gap": 1e-4,
         "change_gap": 1e-3, "change_worst": 1e-2}


def bench_json() -> dict:
    return json.loads((BENCH.parent / "BENCHMARK.json").read_text())


def config(name: str, kind: str) -> dict:
    base = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    base = copy.deepcopy(base)
    base["name"] = f"tiny-{kind}"
    base["dataset"] = dict(TINY_DATASET)
    base["model"] = dict(TINY_MODELS[kind])
    return base


def train_cell(kind: str, tmp: Path, limits: dict = LOOSE) -> harness.Cell:
    spec = bench_json()
    name = f"train-tiny-{kind}"
    (tmp / "limits").mkdir(parents=True, exist_ok=True)
    (tmp / "limits" / f"{name}.json").write_text(json.dumps(limits))
    e2e = [m for m in spec["end_to_end"]
           if "workloads" not in m or "train-sage-products" in m["workloads"]]
    per_layer = [m for m in spec["per_layer"]
                 if "train-sage-products" in m.get("workloads", ())]
    return harness.Cell(
        name=name, workload={"name": name, "chips": 1},
        config=config("sage-products", kind), traffic=dict(TRAIN_TRAFFIC),
        end_to_end=e2e, per_layer=per_layer, limits_dir=tmp / "limits")
