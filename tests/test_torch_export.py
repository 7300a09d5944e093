"""repro_torch.obs.export against the reference's exporter, and the port's
Trainer timeline it writes (products at scale 0.03, 4 shards, SAGE 2
layers, hidden 16, fanout 4).

The documents are the reference's: the same Chrome trace-event schema,
track labels and lane order, JSONL layout and config digest. The manifest
stamps torch, CUDA and the GPU (name and power limit, ``"none"`` without a
card) where the reference stamps jax. A traced port ``Trainer.fit`` is
bitwise the untraced one, and its exported timeline validates with the
four lanes of the training stack and its iteration spans (the port's
counterpart of tests/test_obs.py's export and training-stack tests).
"""
import json

import numpy as np
import pytest
import torch

import repro.obs.export as jax_export
import repro_torch.graph as torch_graph
from repro_torch.features import FeatureStore
from repro_torch.graph.partition import community_partition, shard_features
from repro_torch.models.gnn import GNNConfig
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.export import (_TRACK_ORDER, _track_label, chrome_trace,
                                    config_digest, export_chrome_trace,
                                    run_manifest, trace_span_names,
                                    trace_track_names, validate_chrome_trace,
                                    write_metrics_jsonl)
from repro_torch.optim import adam
from repro_torch.resilience import FaultPlan, FaultSpec
from repro_torch.train import Trainer

SHARDS = 4
EPOCHS, ITERS, BATCH = 3, 4, 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test worker (the suite runs several)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _trace_reset():
    """Tracing state is module-global: leave every test with the recorder
    off and drained."""
    yield
    obs_trace.disable()
    obs_trace.clear()


@pytest.fixture(scope="module")
def partitioned():
    ds = torch_graph.make_dataset("products", scale=0.03, seed=0)
    part = community_partition(ds.communities, SHARDS)
    table, owner, local_idx = shard_features(ds.features, part, SHARDS)
    return dict(ds=ds, part=part, table=table, owner=owner,
                local_idx=local_idx)


def _trainer(d, **kw):
    kw.setdefault("optimizer", adam(5e-3))
    kw.setdefault("merging", False)
    kw.setdefault("table", d["table"])
    cfg = GNNConfig(model="sage", num_layers=2, hidden_dim=16,
                    feature_dim=d["ds"].feature_dim,
                    num_classes=d["ds"].num_classes, fanout=4)
    return Trainer(graph=d["ds"].graph, labels=d["ds"].labels,
                   part=d["part"], owner=d["owner"],
                   local_idx=d["local_idx"], cfg=cfg,
                   train_vertices=d["ds"].train_vertices(), device="cpu",
                   **kw)


# ---------------------------------------------------------------------------
# Manifests, schema, JSONL
# ---------------------------------------------------------------------------

def test_config_digest_stable_order_free_and_the_reference_s():
    cfg = {"a": 1, "b": [2, 3], "c": {"x": 1.5, "y": None}}
    a = config_digest(cfg)
    assert a == config_digest({"c": {"y": None, "x": 1.5}, "b": [2, 3],
                               "a": 1})
    assert len(a) == 12 and config_digest({"a": 2, "b": [2, 3]}) != a
    assert a == jax_export.config_digest(cfg)


def test_run_manifest_keys():
    m = run_manifest(seed=7, config={"x": 1}, extra={"note": "t"})
    for k in ("git_sha", "python", "torch", "cuda", "gpu",
              "gpu_power_limit", "numpy", "platform", "argv", "time_unix"):
        assert k in m, k
    assert "jax" not in m
    assert m["torch"] == torch.__version__
    assert m["seed"] == 7 and m["note"] == "t"
    assert m["config_digest"] == config_digest({"x": 1})
    if not torch.cuda.is_available():
        assert m["gpu"] == m["gpu_power_limit"] == "none"
    json.dumps(m)                                   # serializable


def test_chrome_trace_schema_valid(tmp_path):
    obs_trace.enable()
    with obs_trace.span("a", epoch=0):
        with obs_trace.span("b", track="uploader"):
            pass
    obs_trace.event("fault.test", site="x")
    doc = chrome_trace(manifest=run_manifest(seed=1, config={"k": 1}))
    assert validate_chrome_trace(doc) == []
    assert {"main", "uploader"} <= trace_track_names(doc)
    assert trace_span_names(doc) == {"a", "b"}
    assert doc["metadata"]["seed"] == 1
    assert "config_digest" in doc["metadata"]
    instants = {ev["name"] for ev in doc["traceEvents"]
                if ev.get("ph") == "i"}
    assert "fault.test" in instants
    assert doc["otherData"]["span_records"] == 3
    path = export_chrome_trace(tmp_path / "sub" / "t.json",
                               manifest={"git_sha": "x"})
    back = json.loads(path.read_text())
    assert validate_chrome_trace(back) == []
    assert trace_span_names(back) == {"a", "b"}


def test_validate_catches_defects():
    bad = {"traceEvents": [{"name": "x", "ph": "X", "pid": 1, "tid": 9,
                            "ts": -1.0, "dur": 1.0}],
           "metadata": {}}
    problems = validate_chrome_trace(bad)
    assert any("bad ts" in p for p in problems)
    assert any("thread_name" in p for p in problems)
    assert validate_chrome_trace({}) == ["traceEvents missing or not a list"]
    assert problems == jax_export.validate_chrome_trace(bad)


@pytest.mark.parametrize("raw", ["MainThread", "prefetch_0", "uploader",
                                 "cache_0", "plan_3", "plan", "other"])
def test_track_labels_match_reference(raw):
    assert _track_label(raw) == jax_export._track_label(raw)
    assert _TRACK_ORDER == jax_export._TRACK_ORDER


def test_write_metrics_jsonl_roundtrip(tmp_path):
    p = write_metrics_jsonl(tmp_path / "m.jsonl", [{"a": 1}, {"b": "x"}],
                            manifest={"git_sha": "deadbeef"})
    lines = [json.loads(line) for line in p.read_text().splitlines()]
    assert lines[0] == {"manifest": {"git_sha": "deadbeef"}}
    assert lines[1:] == [{"a": 1}, {"b": "x"}]
    q = write_metrics_jsonl(tmp_path / "n.jsonl", [{"c": np.int64(3)}])
    head, row = [json.loads(x) for x in q.read_text().splitlines()]
    assert "torch" in head["manifest"] and row == {"c": "3"}


# ---------------------------------------------------------------------------
# The Trainer's timeline
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def traced_pair(partitioned):
    """One pipelined + cached run twice — tracing off, then on — with the
    on-run's registry delta, records and exported document."""
    d = partitioned
    kw = dict(cache_policy="lfu", cache_budget_bytes=1 << 20,
              loss_sync_iters=2)
    obs_trace.disable()
    obs_trace.clear()
    tr_off = _trainer(d, **kw)
    st_off = tr_off.fit(epochs=EPOCHS, iters_per_epoch=ITERS,
                        batch_per_model=BATCH)
    snap = obs_metrics.registry().snapshot()
    obs_trace.enable()
    try:
        tr_on = _trainer(d, **kw)
        st_on = tr_on.fit(epochs=EPOCHS, iters_per_epoch=ITERS,
                          batch_per_model=BATCH)
    finally:
        obs_trace.disable()
    delta = obs_metrics.registry().delta(snap)
    recs = obs_trace.records()
    doc = chrome_trace(manifest=run_manifest(seed=0))
    obs_trace.clear()
    return dict(tr_off=tr_off, tr_on=tr_on, st_off=st_off, st_on=st_on,
                delta=delta, recs=recs, doc=doc)


def test_tracing_is_bit_neutral(traced_pair):
    tp = traced_pair
    assert [s.loss for s in tp["st_on"]] == [s.loss for s in tp["st_off"]]
    for a, b in zip(tp["tr_off"].params.leaves(),
                    tp["tr_on"].params.leaves()):
        assert torch.equal(a, b)


def test_trace_covers_four_tracks_and_iteration_spans(traced_pair):
    doc = traced_pair["doc"]
    assert validate_chrome_trace(doc) == []
    assert {"main", "prefetch", "uploader",
            "cache+readahead"} <= trace_track_names(doc)
    assert {"plan.build", "plan.wait", "upload.commit", "dispatch",
            "loss.sync", "cache.refresh",
            "cache.forecast"} <= trace_span_names(doc)
    assert doc["metadata"]["torch"] == torch.__version__


def test_pipelined_spans_nest_sanely(traced_pair):
    recs = traced_pair["recs"]
    assert all(r.depth >= 0 for r in recs)
    builds = [r for r in recs if r.name == "plan.build"]
    assert builds and all(r.track.startswith("prefetch") for r in builds)
    samples = [r for r in recs if r.name == "plan.sample"]
    assert samples
    assert all(r.depth >= 1 or r.track.startswith("plan") for r in samples)
    commits = [r for r in recs if r.name == "upload.commit"]
    assert commits and {r.track for r in commits} == {"uploader"}


def test_epoch_stats_published_to_registry(traced_pair):
    tp = traced_pair
    d = tp["delta"]
    assert d["histograms"]["epoch.time_s"]["count"] == EPOCHS
    assert d["counters"]["epoch.remote_rows"] == \
        sum(s.remote_rows for s in tp["st_on"])


def test_streamed_fit_trace(partitioned):
    """A streamed fit's timeline: the readahead forecast runs on the
    cache+readahead lane, the install on main."""
    d = partitioned
    store = FeatureStore.from_array(d["table"],
                                    host_budget_bytes=d["table"].nbytes // 3)
    obs_trace.enable()
    try:
        tr = _trainer(d, table=store)
        tr.fit(epochs=EPOCHS, iters_per_epoch=ITERS, batch_per_model=BATCH)
    finally:
        obs_trace.disable()
    doc = chrome_trace()
    assert validate_chrome_trace(doc) == []
    assert {"main", "prefetch", "uploader",
            "cache+readahead"} <= trace_track_names(doc)
    assert {"features.readahead", "features.readahead.forecast",
            "plan.build", "dispatch"} <= trace_span_names(doc)
    lanes = {_track_label(r.track) for r in obs_trace.records()
             if r.name == "features.readahead.forecast"}
    assert "cache+readahead" in lanes


def test_fault_marks_appear_in_exported_trace(partitioned):
    fp = FaultPlan([FaultSpec("comm_delay", epoch=0, it=1, delay_s=0.002),
                    FaultSpec("comm_drop", epoch=1, it=2, drops=1)])
    obs_trace.enable()
    try:
        with fp.active():
            _trainer(partitioned).fit(epochs=2, iters_per_epoch=4,
                                      batch_per_model=8)
    finally:
        obs_trace.disable()
    assert fp.fired_count() >= 2
    doc = chrome_trace()
    assert validate_chrome_trace(doc) == []
    instants = {ev["name"] for ev in doc["traceEvents"]
                if ev.get("ph") == "i"}
    assert {"fault.comm_delay", "fault.comm_drop"} <= instants
