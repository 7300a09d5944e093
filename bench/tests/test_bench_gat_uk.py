"""The ``gat-uk`` configuration: its graph holds uk-2005's density of CSR
entries at the cut vertex count, and the layer it runs is the published
GAT's width.

The graph is drawn from the generator before the features, so it does not
depend on the feature width; the card's test draws it with one feature
column instead of 600 (24 GB) and gets the graph a run draws."""
import json

import numpy as np
import pytest

from bench import data, harness, weights
from bench.tests import tiny


def config() -> dict:
    return json.loads((harness.BENCH / "configs" / "gat-uk.json")
                      .read_text())


def test_the_graph_does_not_depend_on_the_feature_width():
    wide = data.generate(tiny.TINY_DATASET)
    narrow = data.generate(dict(tiny.TINY_DATASET, feature_dim=1))
    assert np.array_equal(wide.graph.indptr, narrow.graph.indptr)
    assert np.array_equal(wide.graph.indices, narrow.graph.indices)
    assert np.array_equal(wide.labels, narrow.labels)


def test_the_configuration_keeps_the_published_widths():
    cfg = config()
    pub, ds, model = cfg["published"], cfg["dataset"], cfg["model"]
    assert ds["feature_dim"] == pub["feature_dim"] == 600
    assert ds["num_classes"] == pub["num_classes"] == 10
    assert model == {"kind": "gat", "num_layers": 3, "hidden_dim": 128,
                     "heads": 4, "fanout": 10}
    assert cfg["partition"] == {"kind": "community", "shards": 4}
    assert cfg["precision"] == {"dtype": "float32", "allow_tf32": False}
    assert set(cfg["reduced"]) == set(cfg["changed"]) == \
        {"graph", "num_vertices"}
    assert ds["num_vertices"] == 10_000_000 < pub["num_vertices"]
    shapes = weights.shapes(model, ds["feature_dim"], ds["num_classes"])
    assert shapes["layers.0.w"][0] == (600, 128)
    assert shapes["layers.2.a_src"][0] == (4, 32)


@pytest.mark.chip
def test_csr_entries_per_vertex_match_uk_2005(card):
    """Drawn on the card as a run draws it: the cut vertex count, and
    uk-2005's 936,364,282 arcs over 39,459,925 vertices (23.73 CSR entries
    per vertex) to within 5%."""
    cfg = config()
    ds = data.generate(dict(cfg["dataset"], feature_dim=1), card)
    pub = cfg["published"]
    assert ds.num_vertices == cfg["dataset"]["num_vertices"] == 10_000_000
    per_vertex = ds.graph.num_edges / ds.num_vertices
    want = pub["num_edges"] / pub["num_vertices"]
    assert abs(per_vertex / want - 1) < 0.05, ds.graph.num_edges
