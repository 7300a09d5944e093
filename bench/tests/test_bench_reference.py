"""The benchmark's generator, and its frozen copies of the sampler and the
layer equations against the program's, at small sizes on the CPU. (The
whole reference against ``Trainer.fit`` is in ``test_bench_train.py``.)"""
import numpy as np
import pytest
import torch

from bench import data, weights
from bench.reference import gnn as ref_gnn
from bench.reference.sampler import sample_tree
from bench.tests import tiny


def test_generator_is_fixed_by_its_seed():
    spec = dict(tiny.TINY_DATASET)
    a, b = data.generate(spec), data.generate(spec)
    for x, y in ((a.graph.indptr, b.graph.indptr),
                 (a.graph.indices, b.graph.indices),
                 (a.features, b.features), (a.labels, b.labels),
                 (a.train_mask, b.train_mask)):
        assert np.array_equal(x, y)
    spec["seed"] += 1
    c = data.generate(spec)
    assert not np.array_equal(c.features, a.features)
    assert not np.array_equal(c.graph.indices, a.graph.indices)


def test_generator_makes_a_simple_symmetric_graph():
    ds = data.generate(tiny.TINY_DATASET)
    n, g = ds.num_vertices, ds.graph
    src = np.repeat(np.arange(n), np.diff(g.indptr))
    dst = g.indices.astype(np.int64)
    key = src * n + dst
    assert np.all(np.diff(key) > 0)                 # sorted, no duplicates
    assert not np.any(src == dst)                   # no self loops
    assert np.array_equal(np.sort(dst * n + src), key)   # symmetric
    assert g.indptr[0] == 0 and g.indptr[-1] == g.num_edges
    assert ds.features.shape == (n, tiny.TINY_DATASET["feature_dim"])
    assert ds.features.dtype == np.float32
    share = ds.train_mask.mean()
    assert abs(share - tiny.TINY_DATASET["train_frac"]) < 0.03


@pytest.mark.chip
def test_csr_entries_match_the_published_graph(card):
    """The configuration's graph, made on the card as a run makes it,
    holds the published count of CSR entries (an undirected edge is two)
    to within 5%, and its published vertex count. The realised count moves
    by a few percent with the draw, because the power-law degrees' mean is
    set by their heaviest few: 123,831,800 drawn on the CPU, 127,621,488
    on the card."""
    from bench import harness
    import json
    cfg = json.loads((harness.BENCH / "configs" / "sage-products.json")
                     .read_text())
    ds = data.generate(cfg["dataset"], card)
    pub = cfg["published"]
    assert ds.num_vertices == pub["num_vertices"]
    assert abs(ds.graph.num_edges / (2 * pub["num_edges"]) - 1) < 0.05, \
        ds.graph.num_edges


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 3])
def test_sampler_equals_the_programs(seed):
    from repro_torch.graph.sampler import sample_tree_block
    from repro_torch.graph.structs import CSRGraph
    ds = data.generate(tiny.TINY_DATASET)
    g = CSRGraph(indptr=ds.graph.indptr, indices=ds.graph.indices)
    roots = np.random.default_rng(seed % 97).choice(ds.num_vertices, 50)
    want = sample_tree_block(g, roots, 3, 5, seed=seed).hops
    got = sample_tree(ds.graph.indptr, ds.graph.indices, roots, 3, 5, seed)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("kind", ["sage", "gat"])
def test_layer_equations_equal_the_programs(kind):
    from bench import program
    from repro_torch.models.gnn.models import GNNConfig, gnn_forward
    model = dict(tiny.TINY_MODELS[kind], num_layers=3)
    params = weights.make(model, 12, 6, seed=4, device="cpu")
    gen = torch.Generator().manual_seed(1)
    feats = [torch.randn(5 * model["fanout"] ** h, 12, generator=gen)
             for h in range(4)]
    want = gnn_forward(program.gnn(params, model),
                       GNNConfig(model=kind, num_layers=3, hidden_dim=16,
                                 feature_dim=12, num_classes=6,
                                 fanout=model["fanout"]), feats)
    got = ref_gnn.forward(params, kind, 3, model["fanout"], feats)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
