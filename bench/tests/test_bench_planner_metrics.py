"""The readers of the planner's pass, stage and job spans and of the CPU
time on spans, on synthetic windows worked out by hand; and the eight
metrics from a traced run of the training driver on the CPU."""
import collections
import time

import pytest

from bench import harness
from bench.tests import tiny

MS = 1_000_000
Rec = collections.namedtuple(
    "Rec", "kind name track t0_ns t1_ns depth tags cpu_ns")
OldRec = collections.namedtuple(          # a program without CPU time
    "OldRec", "kind name track t0_ns t1_ns depth tags")

NEW = ("plan_sample_ms.train", "plan_dedup_ms.train",
       "plan_translate_ms.train", "plan_account_ms.train", "upload_ms.train",
       "plan_passes_per_plan.train", "plan_offcpu_pct.train",
       "dispatch_offcpu_pct.train")


def span(name, t0, t1, cpu, track="prefetch_0", tags=None):
    return Rec("X", name, track, t0 * MS, t1 * MS, 0, tags, cpu * MS)


def window(spans):
    return harness.Window(t0_ns=0, t1_ns=1000 * MS, spans=spans, ops=[],
                          counters={"iterations": 2}, counts={}, chips=1,
                          peaks=None)


def pregather_window():
    """Two plans in pregather mode: the first probes its pattern."""
    return window([
        span("plan.build", 0, 100, 80), span("plan.build", 200, 300, 90),
        span("plan.pass", 0, 40, 30, tags={"probe": True}),
        span("plan.pass", 40, 95, 40), span("plan.pass", 200, 290, 80),
        span("plan.sample", 41, 61, 5), span("plan.sample", 201, 231, 9),
        span("plan.dedup", 61, 71, 10), span("plan.dedup", 231, 245, 7),
        span("plan.translate", 71, 79, 1),
        span("plan.translate", 245, 257, 2),
        span("plan.account", 79, 109, 30),
        span("plan.account", 257, 287, 30),
        span("upload.commit", 95, 100, 4, track="uploader"),
        span("upload.commit", 290, 297, 6, track="uploader"),
        *[span("plan.sample.job", 42 + 5 * i, 52 + 5 * i, 6,
               track=f"plan_{i % 2}") for i in range(4)],
        *[span("plan.translate.job", 72, 77, 5, track=f"plan_{i}")
          for i in range(2)],
        span("dispatch", 100, 110, 9, track="MainThread"),
        span("dispatch", 300, 310, 5, track="MainThread"),
        Rec("i", "fault.x", "MainThread", 5 * MS, 5 * MS, 0, None, 0),
    ])


# by hand: Σ over the window, over the 2 plan.build spans
EXPECTED = {
    "plan_sample_ms.train": (20 + 30) / 2,
    "plan_dedup_ms.train": (10 + 14) / 2,
    "plan_translate_ms.train": (8 + 12) / 2,
    "plan_account_ms.train": (30 + 30) / 2,
    "upload_ms.train": (5 + 7) / 2,
    "plan_passes_per_plan.train": 3 / 2,
    # sample jobs 4 x (10 wall, 6 cpu), translate jobs 2 x (5, 5),
    # accounts (30, 30) x 2, dedups (10, 10) and (14, 7): no jobs inside
    "plan_offcpu_pct.train": 100 * (16 + 0 + 0 + 7) / (40 + 10 + 60 + 24),
    "dispatch_offcpu_pct.train": 100 * (1 + 5) / 20,
}


def read(name, win):
    return harness.load_module(
        harness.BENCH / "metrics" / f"{name}.py").read(win)


@pytest.mark.parametrize("name", NEW)
def test_reader_by_hand(name):
    assert read(name, pregather_window()) == pytest.approx(EXPECTED[name],
                                                           rel=1e-12)


@pytest.mark.parametrize("name", NEW)
def test_reader_without_its_spans(name):
    assert read(name, window([])) is None
    others = [span("plan.wait", 0, 5, 0, track="MainThread"),
              span("loss.sync", 5, 9, 1, track="MainThread")]
    assert read(name, window(others)) is None


@pytest.mark.parametrize("name", ["plan_sample_ms.train",
                                  "plan_offcpu_pct.train",
                                  "dispatch_offcpu_pct.train"])
def test_reader_on_a_program_without_passes_or_cpu_time(name):
    """The parent program: ``plan.sample`` named the sampling jobs, no
    ``plan.pass``, and records without ``cpu_ns``."""
    win = window([OldRec(r.kind, r.name, r.track, r.t0_ns, r.t1_ns, r.depth,
                         r.tags) for r in pregather_window().spans
                  if r.name != "plan.pass"])
    assert read(name, win) is None


def test_per_step_dedup_is_counted_by_its_jobs():
    """A ``plan.dedup`` that fanned out waits on its jobs by design: its
    jobs count, the stage does not."""
    win = window([
        span("plan.dedup", 0, 50, 1),
        span("plan.dedup.job", 10, 20, 4, track="plan_0"),
        span("plan.dedup.job", 12, 22, 10, track="plan_1"),
        span("plan.dedup", 60, 70, 5),                    # no job inside
    ])
    assert read("plan_offcpu_pct.train", win) == pytest.approx(
        100 * (6 + 0 + 5) / (10 + 10 + 10))


def test_traced_cpu_run_reports_the_eight_metrics(tmp_path):
    cell = tiny.train_cell("sage", tmp_path)
    assert set(NEW) <= {m["name"] for m in cell.per_layer}
    result, compared = cell.driver().run(
        cell, seed=2**31 + 17, seconds=0.2, trace=True, device="cpu",
        t_start=time.perf_counter())
    assert result["correct"], compared
    m = {k: v["value"] for k, v in result["metrics"].items()}
    assert set(NEW) <= set(m)
    stages = sum(m[k] for k in NEW[:5])
    assert 0 < stages <= m["plan_ms.train"]
    assert m["plan_passes_per_plan.train"] >= 1.0
    for k in ("plan_offcpu_pct.train", "dispatch_offcpu_pct.train"):
        assert 0 <= m[k] <= 100, k
