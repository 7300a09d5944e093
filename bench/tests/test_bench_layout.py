"""Adding a cell or a per-layer metric takes new files and new entries in
``BENCHMARK.json``, and no edit to a file the benchmark has: a copy of the
benchmark gains a configuration, a traffic mix, a reader and a limits
file, and the harness runs the new cell and reads the new metric."""
import hashlib
import json
import shutil
import time

from bench import harness
from bench.tests import tiny


def digest(root):
    return {str(p.relative_to(root)): hashlib.sha1(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_a_new_cell_and_metric_are_files_and_entries(tmp_path):
    bench = tmp_path / "bench"
    shutil.copytree(harness.BENCH, bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = digest(bench)
    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())

    cfg = tiny.config("sage-products", "gat")
    cfg["name"] = "tiny-new"
    (bench / "configs" / "tiny-new.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "train-tiny.json").write_text(
        json.dumps(tiny.TRAIN_TRAFFIC))
    (bench / "limits" / "train-tiny-new.json").write_text(
        json.dumps(tiny.LOOSE))
    (bench / "metrics" / "plans_per_iter.train.py").write_text(
        "def read(win):\n"
        "    return win.counters['plans_built'] / win.counters['iterations']\n")
    spec["configs"].append({"name": "tiny-new", "source": "test",
                            "file": "bench/configs/tiny-new.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "train-tiny-new", "config": "tiny-new",
                              "traffic": "train-tiny", "chips": 1,
                              "why": "test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "train-sage-products" in m.get("workloads", ()):
            m["workloads"].append("train-tiny-new")
    spec["per_layer"].append({
        "name": "plans_per_iter.train", "unit": "plans", "better": "lower",
        "source": "program_counter", "layer": "planner",
        "moves": "train_roots_per_s", "workloads": ["train-tiny-new"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    after = digest(bench)
    assert {k: v for k, v in after.items() if k in before} == before

    cell = harness.find_cell("train-tiny-new", tmp_path / "BENCHMARK.json",
                             bench)
    assert cell.traffic["driver"] == "train"
    result, compared = cell.driver().run(
        cell, seed=9, seconds=0.2, trace=True, device="cpu",
        t_start=time.perf_counter())
    assert result["correct"], compared
    assert "plans_per_iter.train" in result["metrics"]
    assert result["metrics"]["plans_per_iter.train"]["value"] > 0
    assert "plan_ms.train" in result["metrics"]
