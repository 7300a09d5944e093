"""The readers of the model step's spans (``model.forward``,
``model.backward``, ``gat.attention``) on synthetic windows worked out by
hand, and the four metrics from traced runs of the training driver on the
CPU: a tiny cell of ``gat-uk`` reports all four, a tiny cell of
``sage-products`` all but GAT's attention."""
import collections
import json
import time

import pytest

from bench import harness
from bench.tests import tiny

MS = 1_000_000
Rec = collections.namedtuple(
    "Rec", "kind name track t0_ns t1_ns depth tags cpu_ns")

NEW = ("model_fwd_ms.train", "model_bwd_ms.train", "gat_attn_ms.train",
       "model_passes_per_iter.train")


def span(name, t0, t1, depth=1, tags=None):
    return Rec("X", name, "MainThread", t0 * MS, t1 * MS, depth, tags,
               (t1 - t0) * MS)


def window(spans, iterations=2):
    return harness.Window(t0_ns=0, t1_ns=1000 * MS, spans=spans, ops=[],
                          counters={"iterations": iterations}, counts={},
                          chips=1, peaks=None)


def gat_window():
    """Two iterations of two (shard, step) passes each; every forward
    holds three attentions (two layers over three hops)."""
    recs = [span("dispatch", 0, 400, depth=0),
            span("plan.wait", 400, 410, depth=0)]
    for i, t in enumerate((0, 100, 200, 300)):
        recs.append(span("model.forward", t, t + 40, tags={"layer": "gat"}))
        recs.append(span("model.backward", t + 40, t + 70 + i))
        recs += [span("gat.attention", t + 5 + 10 * k, t + 10 + 10 * k,
                      depth=2) for k in range(3)]
    recs.append(Rec("i", "engine.retrace", "MainThread", 5 * MS, 5 * MS, 1,
                    None, 0))
    return window(recs)


# by hand: Σ over the window, over its 2 iterations
EXPECTED = {
    "model_fwd_ms.train": 4 * 40 / 2,
    "model_bwd_ms.train": (30 + 31 + 32 + 33) / 2,
    "gat_attn_ms.train": 12 * 5 / 2,
    "model_passes_per_iter.train": 4 / 2,
}


def read(name, win):
    return harness.load_module(
        harness.BENCH / "metrics" / f"{name}.py").read(win)


@pytest.mark.parametrize("name", NEW)
def test_reader_by_hand(name):
    assert read(name, gat_window()) == pytest.approx(EXPECTED[name],
                                                     rel=1e-12)


@pytest.mark.parametrize("name", NEW)
def test_reader_without_its_spans(name):
    """A window of the parent program, which has no model-step spans."""
    assert read(name, window([])) is None
    others = [span("dispatch", 0, 50, depth=0),
              span("plan.wait", 50, 60, depth=0)]
    assert read(name, window(others)) is None


@pytest.mark.parametrize("name", NEW)
def test_reader_of_an_empty_window(name):
    assert read(name, window(gat_window().spans, iterations=0)) is None


def test_sage_window_has_no_attention_reading():
    win = window([r for r in gat_window().spans if r.name != "gat.attention"])
    assert read("gat_attn_ms.train", win) is None
    for name in NEW[:2] + NEW[3:]:
        assert read(name, win) == pytest.approx(EXPECTED[name], rel=1e-12)


def tiny_cell(kind: str, real: str, tmp) -> harness.Cell:
    """A tiny cell of ``real``'s configuration and metrics."""
    spec = tiny.bench_json()
    workload = next(w for w in spec["workloads"] if w["name"] == real)
    name = f"train-tiny-{kind}"
    (tmp / "limits").mkdir(parents=True, exist_ok=True)
    (tmp / "limits" / f"{name}.json").write_text(json.dumps(tiny.LOOSE))
    e2e = [m for m in spec["end_to_end"]
           if "workloads" not in m or real in m["workloads"]]
    per_layer = [m for m in spec["per_layer"]
                 if harness.reports(m, real, {m["name"] for m in e2e})]
    return harness.Cell(
        name=name, workload={"name": name, "chips": 1},
        config=tiny.config(workload["config"], kind),
        traffic=dict(tiny.TRAIN_TRAFFIC), end_to_end=e2e,
        per_layer=per_layer, limits_dir=tmp / "limits")


@pytest.mark.parametrize("kind,real,want", [
    ("gat", "train-gat-uk", NEW),
    ("sage", "train-sage-products",
     tuple(n for n in NEW if n != "gat_attn_ms.train")),
])
def test_traced_cpu_run_reports_the_model_step(tmp_path, kind, real, want):
    cell = tiny_cell(kind, real, tmp_path)
    assert set(want) <= {m["name"] for m in cell.per_layer}
    result, compared = cell.driver().run(
        cell, seed=2**31 + 23, seconds=0.2, trace=True, device="cpu",
        t_start=time.perf_counter())
    assert result["correct"], compared
    m = {k: v["value"] for k, v in result["metrics"].items()}
    assert set(want) <= set(m)
    assert "gat_attn_ms.train" not in m or kind == "gat"
    shards = cell.config["partition"]["shards"]
    assert m["model_passes_per_iter.train"] == \
        shards * result["info"]["merge_steps"]
    assert 0 < m["model_fwd_ms.train"] and 0 < m["model_bwd_ms.train"]
    assert m["model_fwd_ms.train"] + m["model_bwd_ms.train"] <= \
        m["dispatch_ms.train"]
    if kind == "gat":
        assert 0 < m["gat_attn_ms.train"] < m["model_fwd_ms.train"]
