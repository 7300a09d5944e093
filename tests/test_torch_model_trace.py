"""The model step traced from inside: a ``model.forward`` span (tagged with
the layer kind) and a ``model.backward`` span per (shard, step) pass of the
emulated engine, ``gat.attention`` inside GAT's forward once per pair of
hops per layer, and the dedup path on every ``plan.dedup`` span. Tracing
off records nothing; tracing on leaves losses and gradients bitwise the
same."""
import numpy as np
import pytest
import torch

import repro_torch.core.distributed as engine
import repro_torch.core.pregather as pregather_mod
import repro_torch.graph as torch_graph
from repro_torch.core.strategies import plan_iteration
from repro_torch.graph.partition import community_partition, shard_features
from repro_torch.models.gnn import GNNConfig
from repro_torch.models.gnn.models import init_gnn
from repro_torch.obs import trace as obs_trace

SHARDS = 4
LAYERS = 3
KINDS = ("gat", "sage")


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
    obs_trace.disable()
    obs_trace.clear()
    yield
    obs_trace.disable()
    obs_trace.clear()


@pytest.fixture(scope="module")
def world():
    ds = torch_graph.make_dataset("products", scale=0.03, seed=0)
    part = community_partition(ds.communities, SHARDS)
    table, owner, local_idx = shard_features(ds.features, part, SHARDS)
    return dict(ds=ds, part=part, table=table, owner=owner,
                local_idx=local_idx)


def _plan_kwargs(w, seed=0, **kw):
    rng = np.random.default_rng(seed)
    roots = [rng.choice(w["ds"].train_vertices(), 6, replace=False)
             for _ in range(SHARDS)]
    out = dict(graph=w["ds"].graph, labels=w["ds"].labels, part=w["part"],
               owner=w["owner"], local_idx=w["local_idx"],
               local_rows=w["table"].shape[1], roots_per_model=roots,
               num_layers=LAYERS, fanout=3, sample_seed=11)
    out.update(kw)
    return out


def _cfg(w, kind):
    return GNNConfig(model=kind, num_layers=LAYERS, hidden_dim=8,
                     feature_dim=w["ds"].feature_dim,
                     num_classes=w["ds"].num_classes, fanout=3)


def _iteration(w, kind, pregather=True, traced=False):
    """One emulated iteration of a fresh model from a fixed seed: (plan,
    grads, loss, records)."""
    plan = plan_iteration(**_plan_kwargs(w, pregather=pregather))
    cfg = _cfg(w, kind)
    params = init_gnn(cfg, torch.Generator().manual_seed(3), device="cpu")
    if traced:
        obs_trace.enable()
    grads, loss = engine.run_iteration(params, w["table"], plan, cfg,
                                       device="cpu")
    obs_trace.disable()
    recs = obs_trace.records()
    obs_trace.clear()
    return plan, grads, loss, recs


def _complete(recs, name):
    return sorted((r for r in recs if r.kind == "X" and r.name == name),
                  key=lambda r: r.t0_ns)


def _inside(outer, recs, name):
    return [r for r in _complete(recs, name)
            if outer.t0_ns <= r.t0_ns and r.t1_ns <= outer.t1_ns
            and r.track == outer.track]


@pytest.mark.parametrize("pregather", [True, False])
@pytest.mark.parametrize("kind", KINDS)
def test_one_forward_and_backward_per_shard_step(world, kind, pregather):
    plan, _, _, recs = _iteration(world, kind, pregather, traced=True)
    fwd, bwd = _complete(recs, "model.forward"), \
        _complete(recs, "model.backward")
    passes = plan.num_shards * plan.num_steps
    assert len(fwd) == len(bwd) == passes
    assert all(r.tags == {"layer": kind} for r in fwd)
    assert all(not r.tags for r in bwd)
    # each pass: its forward, then its backward, on the calling thread
    for f, b, nxt in zip(fwd, bwd, fwd[1:] + [None]):
        assert f.track == b.track == "MainThread"
        assert f.t1_ns <= b.t0_ns
        assert nxt is None or b.t1_ns <= nxt.t0_ns
        assert f.depth == b.depth


def test_attention_nests_in_every_gat_forward(world):
    plan, _, _, recs = _iteration(world, "gat", traced=True)
    fwd = _complete(recs, "model.forward")
    # layer l updates hops 0 .. LAYERS - 1 - l: one attention per pair
    per_forward = LAYERS * (LAYERS + 1) // 2
    for f in fwd:
        inner = _inside(f, recs, "gat.attention")
        assert len(inner) == per_forward
        assert all(a.depth == f.depth + 1 for a in inner)
    assert len(_complete(recs, "gat.attention")) == per_forward * len(fwd)
    for b in _complete(recs, "model.backward"):
        assert not _inside(b, recs, "gat.attention")


def test_sage_records_no_attention(world):
    _, _, _, recs = _iteration(world, "sage", traced=True)
    assert _complete(recs, "model.forward")
    assert not _complete(recs, "gat.attention")


@pytest.mark.parametrize("kind", KINDS)
def test_tracing_off_records_nothing(world, kind):
    _, _, _, recs = _iteration(world, kind, traced=False)
    assert recs == []


@pytest.mark.parametrize("pregather", [True, False])
@pytest.mark.parametrize("kind", KINDS)
def test_grads_and_loss_bitwise_with_tracing_on_and_off(world, kind,
                                                        pregather):
    _, g_off, l_off, _ = _iteration(world, kind, pregather, traced=False)
    _, g_on, l_on, recs = _iteration(world, kind, pregather, traced=True)
    assert _complete(recs, "model.backward")
    assert torch.equal(l_off, l_on)
    assert len(g_off) == len(g_on)
    for a, b in zip(g_off, g_on):
        assert torch.equal(a, b)


@pytest.mark.parametrize("force_sort", [False, True])
@pytest.mark.parametrize("pregather", [True, False])
def test_dedup_span_names_the_path_the_plan_took(world, monkeypatch,
                                                 pregather, force_sort):
    """The tag is the path ``build_gather_plan`` took in every call the
    stage made; a bitmap budget of one cell sends it to the sort."""
    if force_sort:
        monkeypatch.setattr(pregather_mod, "_DENSE_DEDUP_MAX_CELLS", 1)
    taken = []
    real = pregather_mod._use_bitmap_dedup

    def recording(*args):
        taken.append(real(*args))
        return taken[-1]

    monkeypatch.setattr(pregather_mod, "_use_bitmap_dedup", recording)
    obs_trace.enable()
    plan_iteration(**_plan_kwargs(world, pregather=pregather))
    obs_trace.disable()
    dedup, = _complete(obs_trace.records(), "plan.dedup")
    want = "sort" if force_sort else "bitmap"
    assert dedup.tags == {"path": want}
    assert taken and all(t == (want == "bitmap") for t in taken)


def test_gather_plan_names_its_dedup_path(world, monkeypatch):
    """``build_gather_plan`` records the path it took on the plan, and
    both paths build the same exchange."""
    rng = np.random.default_rng(5)
    V = world["owner"].size
    needed = [rng.integers(0, V, 300) for _ in range(SHARDS)]
    args = (needed, world["owner"], world["local_idx"], SHARDS,
            world["table"].shape[1])
    by_bitmap = pregather_mod.build_gather_plan(*args)
    monkeypatch.setattr(pregather_mod, "_DENSE_DEDUP_MAX_CELLS", 1)
    by_sort = pregather_mod.build_gather_plan(*args)
    assert (by_bitmap.dedup, by_sort.dedup) == ("bitmap", "sort")
    assert by_bitmap.r_max == by_sort.r_max
    assert np.array_equal(by_bitmap.req, by_sort.req)
    assert np.array_equal(by_bitmap.slot_map.ids, by_sort.slot_map.ids)


def test_span_tags_added_inside_it_are_recorded():
    with obs_trace.span("late") as sp:
        sp.tag(path="sort")
    obs_trace.enable()
    with obs_trace.span("late", kind="x") as sp:
        sp.tag(path="bitmap")
    obs_trace.disable()
    late, = _complete(obs_trace.records(), "late")
    assert late.tags == {"kind": "x", "path": "bitmap"}
