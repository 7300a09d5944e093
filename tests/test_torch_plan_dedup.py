"""The planner's dedup and translation on a device (``plan.dedup`` and
``plan.translate`` tagged ``path="device"``): ``plan_iteration`` with
``device_trees`` against the port's host path (held to the JAX package by
``tests/test_torch_plan_sample.py`` and the planner's other tests), bit for
bit, with the plan's Fig. 14 counts read from the trees on first read;
``PlanOverflow`` as the host raises it; the host paths kept, and tagged as
the host's, where the plan caches, streams, plans per step or samples
``lo``; the kernels' chunked algorithm, emulated in numpy from the
partition's tables, against the plain version; and the partition's
refusals. On the CPU the kernels' plain versions run. The tests marked
``chip`` run the CUDA kernels, and skip without a card:

    PYTHONPATH=src python -m pytest -q tests/test_torch_plan_dedup.py -m chip
"""
import numpy as np
import pytest
import torch

from repro_torch.cache import CacheStore
from repro_torch.core import strategies
from repro_torch.core.pregather import PlanOverflow
from repro_torch.core.strategies import DeviceTrees, plan_iteration
from repro_torch.features import FeatureStore
from repro_torch.graph.partition import local_index_map
from repro_torch.graph.structs import CSRGraph
from repro_torch.kernels import plan_dedup
from repro_torch.kernels.plan_dedup import CHUNK, DevicePartition
from repro_torch.obs import trace as obs_trace

SHARDS = 4
LAYERS = 3
FANOUT = 4
EMPTY_SHARD = 2          # owns no vertex: its trees are all padding
PLAN_ARRAYS = ("req", "step_req", "labels", "weights", "true_counts")
PLAN_COUNTS = ("num_steps", "batch_pad", "r_max", "c_max", "global_batch",
               "remote_rows_exact", "total_rows", "cache_hit_rows",
               "unique_rows", "step_unique_rows", "remote_rows_nodedup")
# vertices of the two worlds: a V whose (shard, vertex) cells the host
# dedups with its bitmap, and one past 2^22 cells, which it sorts
SIZES = {"bitmap": 3_000, "sort": 1_100_000}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test worker (the suite runs several)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _trace_reset():
    obs_trace.disable()
    obs_trace.clear()
    yield
    obs_trace.disable()
    obs_trace.clear()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _random_csr(v: int, mean_deg: float, seed: int) -> CSRGraph:
    """Poisson degrees, a tenth of the vertices at degree 0."""
    rng = np.random.default_rng(seed)
    deg = rng.poisson(mean_deg, v)
    deg[rng.random(v) < 0.1] = 0
    indptr = np.zeros(v + 1, np.int64)
    np.cumsum(deg, out=indptr[1:])
    return CSRGraph(indptr=indptr,
                    indices=rng.integers(0, v, int(indptr[-1]),
                                         dtype=np.int32))


def _world(v: int, seed: int = 0, device="cpu") -> dict:
    """A random graph of ``v`` vertices, ``SHARDS`` shards of which
    ``EMPTY_SHARD`` owns nothing, the others owning runs of vertices with a
    tenth scattered at random."""
    rng = np.random.default_rng(seed)
    graph = _random_csr(v, 3.0, seed)
    part = np.repeat([0, 1, 3], -(-v // 3))[:v]
    stray = rng.random(v) < 0.1
    part[stray] = rng.choice([0, 1, 3], int(stray.sum()))
    owner, local_idx, rows = local_index_map(part, SHARDS)
    return dict(graph=graph, part=part, owner=owner, local_idx=local_idx,
                local_rows=rows, labels=(np.arange(v) % 7).astype(np.int32),
                trees=DeviceTrees.build(graph, owner, local_idx, SHARDS,
                                        device))


@pytest.fixture(scope="module")
def worlds():
    return {name: _world(v) for name, v in SIZES.items()}


def _plan_kwargs(w, strategy: str = "hopgnn", padded: bool = False,
                 seed: int = 0, **kw) -> dict:
    """Roots drawn anywhere but model 3's, which has none: an empty (shard,
    step) job under either strategy, besides the empty shard's."""
    rng = np.random.default_rng(seed)
    v = w["graph"].num_vertices
    roots = np.split(rng.choice(v, 12 * (SHARDS - 1), replace=False),
                     SHARDS - 1) + [np.zeros(0, np.int64)]
    out = dict(graph=w["graph"], labels=w["labels"], part=w["part"],
               owner=w["owner"], local_idx=w["local_idx"],
               local_rows=w["local_rows"], roots_per_model=roots,
               num_layers=LAYERS, fanout=FANOUT, strategy=strategy,
               sample_seed=2 ** 31 + 1_234 + seed)
    if padded:
        out["batch_pad"] = 64
    out.update(kw)
    return out


def _assert_same_plan(got, want) -> None:
    for f in PLAN_COUNTS:
        assert getattr(got, f) == getattr(want, f), f
    for f in PLAN_ARRAYS:
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert a.dtype == b.dtype and a.shape == b.shape, f
            assert np.array_equal(a, b), f
    assert len(got.hop_idx) == len(want.hop_idx)
    for a, b in zip(got.hop_idx, want.hop_idx):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)


def _tags(name: str) -> list:
    return [r.tags for r in obs_trace.records()
            if r.kind == "X" and r.name == name]


def _traced_plan(**kw):
    obs_trace.enable()
    plan = plan_iteration(**kw)
    obs_trace.disable()
    return plan


# ---------------------------------------------------------------------------
# The device path against the host path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("padded", [False, True], ids=["unpadded", "padded"])
@pytest.mark.parametrize("strategy", ["hopgnn", "model_centric"])
@pytest.mark.parametrize("size", sorted(SIZES))
def test_device_plan_is_the_host_plan(worlds, size, strategy, padded):
    w = worlds[size]
    kw = _plan_kwargs(w, strategy, padded)
    want = _traced_plan(**kw)
    host_path = _tags("plan.dedup")
    obs_trace.clear()
    got = _traced_plan(**kw, device_trees=w["trees"])
    assert host_path == [{"path": size}]
    assert _tags("plan.dedup") == _tags("plan.translate") == [
        {"path": "device"}]
    # among the cases: a shard that owns nothing, an empty (shard, step)
    assert not (w["owner"] == EMPTY_SHARD).any()
    assert (got.true_counts == 0).any()
    assert (got.true_counts.max() < got.batch_pad) == padded
    _assert_same_plan(got, want)


@pytest.mark.parametrize("strategy", ["hopgnn", "model_centric"])
def test_overflow_is_the_hosts(worlds, strategy):
    w = worlds["bitmap"]
    need = plan_iteration(**_plan_kwargs(w, strategy)).r_max
    assert need > 1
    kw = _plan_kwargs(w, strategy, r_max=need - 1)
    with pytest.raises(PlanOverflow) as host:
        plan_iteration(**kw)
    with pytest.raises(PlanOverflow) as dev:
        plan_iteration(**kw, device_trees=w["trees"])
    assert (dev.value.field, dev.value.needed, dev.value.limit) == (
        host.value.field, host.value.needed, host.value.limit) == (
        "r_max", need, need - 1)
    _assert_same_plan(plan_iteration(**_plan_kwargs(w, strategy, r_max=need),
                                     device_trees=w["trees"]),
                      plan_iteration(**_plan_kwargs(w, strategy,
                                                    r_max=need)))


def test_counts_come_from_the_trees_on_first_read(worlds, monkeypatch):
    """The device plan copies its trees to the host only when a Fig. 14
    count is first read, once, and its counts are the host plan's."""
    calls = []
    real = strategies._true_hops_from_device

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)
    monkeypatch.setattr(strategies, "_true_hops_from_device", counting)
    w = worlds["bitmap"]
    kw = _plan_kwargs(w, padded=True)
    got = plan_iteration(**kw, device_trees=w["trees"])
    assert calls == []
    want = plan_iteration(**kw)
    for _ in range(2):
        assert (got.unique_rows, got.step_unique_rows,
                got.remote_rows_nodedup) == (want.unique_rows,
                                             want.step_unique_rows,
                                             want.remote_rows_nodedup)
        assert got.miss_rate() == want.miss_rate()
        assert got.miss_rate_per_request() == want.miss_rate_per_request()
    assert calls == [1]


def _cache_index(w):
    store = CacheStore(SHARDS, 8, c_max=64, device="cpu")
    rng = np.random.default_rng(3)
    ids = [np.sort(rng.choice(w["graph"].num_vertices, 40, replace=False))
           for _ in range(SHARDS)]
    store.install(ids, [np.zeros((40, 8), np.float32)] * SHARDS)
    return store.index


def _tiered(w):
    table = np.random.default_rng(4).standard_normal(
        (SHARDS, w["local_rows"], 8)).astype(np.float32)
    return FeatureStore.from_array(table, owner=w["owner"],
                                   local_idx=w["local_idx"],
                                   host_budget_bytes=table.nbytes // 3)


@pytest.mark.parametrize("case", ["cached", "streamed", "per_step", "lo"])
def test_other_plans_keep_the_host_paths(worlds, case):
    w = worlds["bitmap"]
    kw = _plan_kwargs(w, "lo" if case == "lo" else "hopgnn")
    if case == "cached":
        kw["cache_index"] = _cache_index(w)
    elif case == "streamed":
        kw["feature_store"] = _tiered(w)
    elif case == "per_step":
        kw["pregather"] = False
    plan_dedup.reset_launches()
    got = _traced_plan(**kw, device_trees=w["trees"])
    dedup = _tags("plan.dedup")
    assert len(dedup) == 1 and dedup[0]["path"] in ("bitmap", "sort")
    assert _tags("plan.translate") == [None]
    assert plan_dedup.launches == {"plan_dedup": 0, "plan_translate": 0}
    if case == "streamed":
        kw["feature_store"] = _tiered(w)
    _assert_same_plan(got, plan_iteration(**kw))


# ---------------------------------------------------------------------------
# The kernels' algorithm and the partition's tables
# ---------------------------------------------------------------------------

def _emulate_kernels(part: DevicePartition, mark: np.ndarray, r_max: int,
                     local_rows: int):
    """count_kernel, scan_kernel and scatter_kernel in numpy, from the
    partition's chunk tables: each chunk's count, the per-shard prefix over
    the chunks, and each marked cell's rank inside its chunk."""
    n, v = part.num_shards, part.num_vertices
    order, lo = part.order.numpy(), part.chunk_lo.numpy()
    seg, seg_chunk = part.chunk_seg.numpy(), part.seg_chunk.numpy()
    nc = seg.size
    counts = np.zeros((n, nc), np.int64)
    for s in range(n):
        for c in range(nc):
            if seg[c] != s:
                counts[s, c] = mark[s, order[lo[c]:lo[c + 1]]].sum()
    off = np.concatenate([np.zeros((n, 1), np.int64),
                          np.cumsum(counts, axis=1)], axis=1)
    req_count = off[:, seg_chunk[1:]] - off[:, seg_chunk[:-1]]
    req = np.zeros((n, n, r_max), np.int32)
    slot_row = np.full((n, v), -1, np.int32)
    local_idx = part.local_idx.numpy()
    for s in range(n):
        for c in range(nc):
            p = seg[c]
            if p == s:
                continue
            cells = order[lo[c]:lo[c + 1]]
            hit = cells[mark[s, cells] == 1]
            j = off[s, c] - off[s, seg_chunk[p]] + np.arange(hit.size)
            req[s, p, j] = local_idx[hit]
            slot_row[s, hit] = local_rows + p * r_max + j
    return req_count, req, slot_row


@pytest.mark.parametrize("size", sorted(SIZES))
def test_chunked_kernels_are_the_plain_version(worlds, size):
    """The chunked count, scan and scatter give the plain version's counts,
    exchange and slots, on a partition whose owners span several chunks
    (the sort world) or one (the bitmap world)."""
    w = worlds[size]
    part = w["trees"].part
    kw = _plan_kwargs(w, padded=True)
    roots = np.concatenate([np.asarray(r) for r in kw["roots_per_model"]])
    trees = w["trees"].csr.draw_trees(roots, LAYERS, FANOUT,
                                      kw["sample_seed"])
    root_shard = torch.from_numpy(np.arange(roots.size) % SHARDS)
    pad_mark = torch.tensor([5, -1, 7, -1])
    mark = plan_dedup.mark_ids(trees, roots.size, FANOUT, LAYERS, root_shard,
                               pad_mark, part.num_vertices)
    req_count, chunk_off = plan_dedup.count_marks(mark, part)
    assert chunk_off is None                          # the plain version
    r_max = int(req_count.max())
    req = torch.zeros((SHARDS, SHARDS, r_max), dtype=torch.int32)
    slot_row = torch.full((SHARDS, part.num_vertices), -1, dtype=torch.int32)
    plan_dedup.scatter_marks(mark, part, None, r_max, 100, req, slot_row)
    e_count, e_req, e_slot = _emulate_kernels(part, mark.numpy(), r_max, 100)
    assert np.array_equal(e_count.reshape(-1), req_count.numpy())
    assert np.array_equal(e_req, req.numpy())
    assert np.array_equal(e_slot, slot_row.numpy())
    assert mark[0, 5] == 1 and mark[2, 7] == 1
    assert (part.chunk_lo[1:] - part.chunk_lo[:-1]).max() <= CHUNK
    if size == "sort":
        assert part.chunk_seg.numel() > SHARDS       # several per owner


def test_partition_tables_cut_each_owner_into_chunks():
    owner = np.array([3, 0, 3, 3, 0, 1] * 2_000)
    part = DevicePartition(owner, np.zeros_like(owner), np.zeros(5, np.int64),
                           "cpu")
    order, lo = part.order.numpy(), part.chunk_lo.numpy()
    seg, seg_chunk = part.chunk_seg.numpy(), part.seg_chunk.numpy()
    assert np.array_equal(order, np.argsort(owner, kind="stable"))
    assert lo[0] == 0 and lo[-1] == owner.size
    assert seg_chunk.tolist() == [0, 1, 2, 2, 4, 4]   # 4,000 of 0, 6,000 of 3
    for c in range(seg.size):
        cells = order[lo[c]:lo[c + 1]]
        assert 0 < cells.size <= CHUNK and (owner[cells] == seg[c]).all()
        assert (np.diff(cells) > 0).all()


@pytest.mark.parametrize("change,match", [
    (dict(owner=np.array([0, 1, 4])), "owner lies outside"),
    (dict(owner=np.array([0, -1, 1])), "owner lies outside"),
    (dict(local_idx=np.array([0, -1, 2])), "local index"),
    (dict(local_idx=np.array([0, 1])), "want"),
    (dict(pad_vertex=np.array([0, 3, 0, 0])), "pad vertex"),
    (dict(owner=np.zeros(0, np.int32), local_idx=np.zeros(0, np.int32)),
     "want"),
], ids=["owner_past_n", "owner_negative", "local_negative", "local_shape",
        "pad_past_v", "no_vertex"])
def test_device_partition_refuses(change, match):
    args = dict(owner=np.array([0, 1, 2]), local_idx=np.array([0, 0, 0]),
                pad_vertex=np.array([0, 1, 2, 0]))
    args.update(change)
    with pytest.raises(ValueError, match=match):
        DevicePartition(args["owner"], args["local_idx"], args["pad_vertex"],
                        "cpu")


def test_device_trees_refuse_another_graphs_partition(worlds):
    w = worlds["bitmap"]
    with pytest.raises(ValueError, match="owner of shape"):
        w["trees"].for_partition(w["owner"][:-1], w["local_idx"][:-1],
                                 SHARDS)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

# (vertices, mean degree): the CSRs of train-sage-products and
# train-gat-uk, as random graphs of that size (tests/test_torch_plan_sample)
CELL_SIZES = {"sage_products": (2_449_029, 52.11 / 0.9),
              "gat_uk": (10_000_000, 23.59 / 0.9)}


@pytest.mark.chip
@pytest.mark.parametrize("cell", sorted(CELL_SIZES))
def test_kernels_are_the_plain_version_at_the_cells_sizes(card, cell):
    """A cell-sized plan (4 shards by runs of vertices, 1,024 roots in 16
    (shard, step) jobs, one of them empty, 3 hops of fanout 10, padded to
    80 roots) deduped and translated by the kernels, bitwise the plain
    version on the CPU; 4 dedup launches and one translation per hop."""
    v, mean_deg = CELL_SIZES[cell]
    rng = np.random.default_rng(1)
    graph = _random_csr(v, mean_deg, seed=1)
    part = np.minimum(np.arange(v) * SHARDS // v, SHARDS - 1)
    stray = rng.random(v) < 0.2
    part[stray] = rng.integers(0, SHARDS, int(stray.sum()))
    owner, local_idx, rows = local_index_map(part, SHARDS)
    job_k = np.full(16, 1024 // 15)
    job_k[5] = 0
    job_k[-1] += 1024 - job_k.sum()
    roots = rng.choice(v, 1024, replace=False)
    out = {}
    for dev in (card, "cpu"):
        trees = DeviceTrees.build(graph, owner, local_idx, SHARDS, dev)
        drawn = trees.csr.draw_trees(roots, 3, 10, 2 ** 31 + 99)
        plan_dedup.reset_launches()
        dd = trees.part.count(drawn, job_k, 4, 3, 10, 80)
        r_max = int(dd.req_count.max())
        trees.part.scatter(dd, r_max, rows)
        req, hops = trees.part.translate(dd)
        out[str(dev)] = (dd.req_count, req, hops, dict(plan_dedup.launches))
    (c1, r1, h1, l1), (c0, r0, h0, l0) = out.values()
    assert np.array_equal(c1, c0) and np.array_equal(r1, r0)
    for a, b in zip(h1, h0, strict=True):
        assert a.dtype == b.dtype == np.int32 and np.array_equal(a, b)
    assert l1 == {"plan_dedup": 4, "plan_translate": 4}
    assert l0 == {"plan_dedup": 0, "plan_translate": 0}


def _trainer(w, device):
    from repro_torch.models.gnn import GNNConfig
    from repro_torch.optim import adam
    from repro_torch.train import Trainer
    rng = np.random.default_rng(0)
    table = rng.standard_normal((SHARDS, w["local_rows"], 8)).astype(
        np.float32)
    cfg = GNNConfig(model="sage", num_layers=LAYERS, hidden_dim=8,
                    feature_dim=8, num_classes=7, fanout=FANOUT)
    return Trainer(graph=w["graph"], labels=w["labels"], part=w["part"],
                   owner=w["owner"], local_idx=w["local_idx"], table=table,
                   cfg=cfg, optimizer=adam(1e-3), sample_seed_base=2 ** 31,
                   train_vertices=np.arange(0, w["graph"].num_vertices, 3),
                   device=device)


@pytest.mark.chip
def test_trainer_plans_on_the_card_are_the_cpu_plans(card, worlds):
    w = worlds["bitmap"]
    on_card, on_cpu = _trainer(w, card), _trainer(w, "cpu")
    for it in range(3):
        obs_trace.enable()
        got = on_card.build_plan(0, it, 16)
        obs_trace.disable()
        _assert_same_plan(got, on_cpu.build_plan(0, it, 16))
    assert _tags("plan.dedup") and all(
        t == {"path": "device"} for t in _tags("plan.dedup"))


@pytest.mark.chip
def test_a_fit_dedups_and_translates_every_pass_on_the_device(card, worlds):
    """Every plan.dedup and plan.translate of a fit tagged ``device``; 4
    dedup launches per ``plan.pass`` (3 in a pass that overflows its
    ``r_max``) and one translation per hop of each pass that does not."""
    trainer = _trainer(worlds["bitmap"], card)
    plan_dedup.reset_launches()
    obs_trace.enable()
    trainer.fit(epochs=2, iters_per_epoch=3, batch_per_model=16)
    obs_trace.disable()
    recs = [r for r in obs_trace.records() if r.kind == "X"]
    passes = [r for r in recs if r.name == "plan.pass"]
    over = [r for r in passes
            if (r.tags or {}).get("error") == "PlanOverflow"]
    ok = len(passes) - len(over)
    assert passes and plan_dedup.launches == {
        "plan_dedup": 4 * ok + 3 * len(over),
        "plan_translate": (LAYERS + 1) * ok}
    for name in ("plan.dedup", "plan.translate"):
        tags = _tags(name)
        assert len(tags) == (len(passes) if name == "plan.dedup" else ok)
        assert all(t == {"path": "device"} for t in tags)
