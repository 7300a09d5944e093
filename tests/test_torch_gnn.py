"""The port's GNN layers and models against the JAX package's, on the
reference's own parameters (converted with ``params_from_jax``) and the
same numpy features. float32 on the CPU on both sides: rtol 1e-5, atol
1e-5 covers the two BLAS libraries summing in different orders."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.gnn import layers as jax_layers
from repro.models.gnn import models as jax_models
from repro_torch.models.gnn import layers as torch_layers
from repro_torch.models.gnn import models as torch_models

MODELS = ["gcn", "sage", "gat", "deepgcn", "film"]
TOL = dict(rtol=1e-5, atol=1e-5)


def _cfg(model, cls=torch_models.GNNConfig):
    return cls(model=model, num_layers=2, hidden_dim=32, feature_dim=24,
               num_classes=7, fanout=3)


def _jax_tree(model):
    return jax_models.init_gnn(jax.random.PRNGKey(0),
                               _cfg(model, jax_models.GNNConfig))


@pytest.mark.parametrize("model", MODELS)
def test_layer_matches_jax(model):
    """One layer on a (parent, child) pair; d_in == d_out so deepgcn's
    residual branch runs too."""
    rng = np.random.default_rng(3)
    init_fn, apply_fn = jax_layers.LAYER_REGISTRY[model]
    p = init_fn(jax.random.PRNGKey(1), 32, 32)
    parent = rng.standard_normal((6, 32)).astype(np.float32)
    child = rng.standard_normal((6, 4, 32)).astype(np.float32)
    ref = apply_fn(p, jnp.asarray(parent), jnp.asarray(child))
    cls = torch_layers.LAYER_REGISTRY[model][1]
    layer = cls({k: torch.from_numpy(np.array(v)) for k, v in p.items()})
    with torch.no_grad():
        out = layer(torch.from_numpy(parent), torch.from_numpy(child))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("model", MODELS)
def test_gnn_forward_matches_jax(model):
    rng = np.random.default_rng(4)
    cfg = _cfg(model)
    tree = _jax_tree(model)
    feats = [rng.standard_normal((5 * cfg.fanout ** h, cfg.feature_dim))
             .astype(np.float32) for h in range(cfg.num_layers + 1)]
    ref = jax_models.gnn_forward(tree, _cfg(model, jax_models.GNNConfig),
                                 [jnp.asarray(x) for x in feats])
    params = torch_models.params_from_jax(tree, device="cpu")
    with torch.no_grad():
        out = torch_models.gnn_forward(params, cfg,
                                       [torch.from_numpy(x) for x in feats])
    assert out.shape == (5, cfg.num_classes)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("model", MODELS)
def test_init_matches_reference_layout(model):
    """The port's seeded init has the reference's parameter names, shapes
    and byte count, and it is reproducible from its generator."""
    cfg = _cfg(model)
    tree = _jax_tree(model)
    a = torch_models.init_gnn(cfg, torch.Generator().manual_seed(5), "cpu")
    b = torch_models.init_gnn(cfg, torch.Generator().manual_seed(5), "cpu")
    for lt, lj in zip(a.layers, tree["layers"]):
        assert {k: tuple(v.shape) for k, v in lt.named_parameters()} == \
            {k: tuple(v.shape) for k, v in lj.items()}
    assert tuple(a.head.w.shape) == tree["head"]["w"].shape
    assert torch_models.model_param_bytes(a) == \
        jax_models.model_param_bytes(tree)
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)


def test_params_from_jax_copies_exactly_and_rejects_unknown_layers():
    tree = _jax_tree("sage")
    params = torch_models.params_from_jax(tree, device="cpu")
    np.testing.assert_array_equal(params.layers[1].w_nbr.detach().numpy(),
                                  np.asarray(tree["layers"][1]["w_nbr"]))
    bad = {"layers": [{"w": np.zeros((2, 2)), "gain": np.zeros(2)}],
           "head": tree["head"]}
    with pytest.raises(ValueError, match="no layer kind"):
        torch_models.params_from_jax(bad, device="cpu")


def test_gnn_forward_refuses_wrong_depth():
    params = torch_models.init_gnn(_cfg("gcn"), device="cpu")
    deeper = dataclasses.replace(_cfg("gcn"), num_layers=3)
    with pytest.raises(ValueError, match="layers"):
        torch_models.gnn_forward(params, deeper, [])
