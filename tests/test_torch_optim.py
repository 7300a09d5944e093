"""The port's optimizers against the reference's (``repro.optim``), step by
step, on the reference's own GNN parameter tree and numpy-seeded grads.

Both run float32 on the CPU with the reference's arithmetic in its order;
the elementwise kernels of XLA and PyTorch round alike, and the scalar
ops (pow, cos) may differ in their last bit. Tolerances:

* the cosine schedule: rtol 1e-6 (measured: equal at every step);
* clip_by_global_norm: rtol 1e-6 on the norm and the clipped grads;
* AdamW and SGD parameters over 6 steps: rtol 1e-6, atol 1e-7, about
  three ulps at the parameters' scale (|p| up to 0.3). Without clipping
  the moments are equal and parameters at most 2.3e-10 apart; with it the
  global norm sums in another order, the scale moves by an ulp, and so
  do the clipped grads (measured: parameters 3.0e-8 apart, one ulp);
* the moments over the same steps: rtol 1e-6 and atol 1e-8 for mu
  (measured 1.4e-9), 1e-11 for nu (measured 9.1e-13).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.gnn.models as jax_models
import repro.optim as jax_optim
import repro_torch.models.gnn.models as torch_models
import repro_torch.optim as torch_optim

TOL = dict(rtol=1e-6, atol=1e-7)
MU_TOL = dict(rtol=1e-6, atol=1e-8)
NU_TOL = dict(rtol=1e-6, atol=1e-11)
CFG = dict(model="sage", num_layers=2, hidden_dim=32, feature_dim=24,
           num_classes=7, fanout=4)


def _tree():
    return jax_models.init_gnn(jax.random.PRNGKey(0),
                               jax_models.GNNConfig(**CFG))


def _grads(tree, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: (scale * rng.standard_normal(x.shape))
                        .astype(np.float32), tree)


def _close(port_leaves, ref_tree, tol=TOL):
    ref_leaves = jax.tree.leaves(ref_tree)
    assert len(port_leaves) == len(ref_leaves)
    for a, b in zip(port_leaves, ref_leaves):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **tol)


def test_leaf_order_is_the_references():
    tree = _tree()
    params = torch_models.params_from_jax(tree, device="cpu")
    leaves = params.leaves()
    assert [tuple(p.shape) for p in leaves] == \
        [x.shape for x in jax.tree.leaves(tree)]
    for a, b in zip(leaves, jax.tree.leaves(tree)):
        assert np.array_equal(a.detach().numpy(), np.asarray(b))
    back = torch_models.params_to_tree(params)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == np.float32 and np.array_equal(a, np.asarray(b))


def test_cosine_schedule_matches_reference():
    lj = jax_optim.cosine_schedule(3e-3, warmup=10, total=40)
    lt = torch_optim.cosine_schedule(3e-3, warmup=10, total=40)
    for step in range(0, 46):
        want = lj(jnp.asarray(step, jnp.int32))
        got = lt(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("max_norm", [0.1, 100.0])
def test_clip_by_global_norm_matches_reference(max_norm):
    tree = _tree()
    g = _grads(tree, 1)
    gj, nj = jax_optim.clip_by_global_norm(g, max_norm)
    gt, nt = torch_optim.clip_by_global_norm(
        [torch.from_numpy(x) for x in jax.tree.leaves(g)], max_norm)
    np.testing.assert_allclose(float(nt), float(nj), rtol=1e-6)
    _close(gt, gj)


def _run_both(opt_j, opt_t, steps=6):
    tree = _tree()
    params = torch_models.params_from_jax(tree, device="cpu")
    sj, st = opt_j.init(tree), opt_t.init(params)
    pj = tree
    for k in range(steps):
        g = _grads(tree, 10 + k)
        pj, sj = opt_j.update(g, sj, pj)
        params, st = opt_t.update(
            [torch.from_numpy(x) for x in jax.tree.leaves(g)], st, params)
        _close(params.leaves(), pj)
        assert int(st.step) == int(sj.step) == k + 1
        assert st.step.dtype == torch.int32
    return sj, st


@pytest.mark.parametrize("kw", [
    dict(lr=3e-3),
    dict(lr=3e-3, weight_decay=1e-4, grad_clip=1.0),
    dict(lr="cosine", weight_decay=1e-4, grad_clip=0.05)])
def test_adamw_matches_reference_step_by_step(kw):
    kw_j, kw_t = dict(kw), dict(kw)
    if kw["lr"] == "cosine":
        kw_j["lr"] = jax_optim.cosine_schedule(3e-3, warmup=2, total=6)
        kw_t["lr"] = torch_optim.cosine_schedule(3e-3, warmup=2, total=6)
    sj, st = _run_both(jax_optim.adamw(**kw_j), torch_optim.adamw(**kw_t))
    _close(st.mu, sj.mu, MU_TOL)
    _close(st.nu, sj.nu, NU_TOL)


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_matches_reference_step_by_step(momentum):
    sj, st = _run_both(jax_optim.sgd(0.1, momentum=momentum),
                       torch_optim.sgd(0.1, momentum=momentum))
    if momentum:
        _close(st.momentum, sj.momentum, MU_TOL)
    else:
        assert st.momentum is None


def test_update_runs_in_place_and_adam_has_no_decay():
    """The update overwrites the parameter tensors it is given (the
    reference's donation); ``adam`` is ``adamw`` without weight decay."""
    tree = _tree()
    params = torch_models.params_from_jax(tree, device="cpu")
    before = [p.data_ptr() for p in params.leaves()]
    opt = torch_optim.adam(1e-2)
    state = opt.init(params)
    g = [torch.ones_like(p) for p in params.leaves()]
    p2, s2 = opt.update(g, state, params)
    assert p2 is params and [p.data_ptr() for p in p2.leaves()] == before
    assert s2.mu[0] is state.mu[0]
    assert all(not p.grad_fn for p in p2.leaves())
    ref = torch_models.params_from_jax(tree, device="cpu")
    for a, b in zip(p2.leaves(), ref.leaves()):
        np.testing.assert_allclose((b - a).detach().numpy(), 1e-2,
                                   rtol=1e-4)


def test_optimizer_keys_give_value_identity():
    assert torch_optim.adamw(5e-3).key == torch_optim.adamw(5e-3).key
    assert torch_optim.adamw(5e-3).key != torch_optim.adamw(4e-3).key
    assert torch_optim.adamw(torch_optim.cosine_schedule(1e-3, 1, 5)).key \
        is None
    a = torch_optim.adamw(torch_optim.cosine_schedule(1e-3, 1, 5),
                          key=("cos", 1e-3, 1, 5))
    b = torch_optim.adamw(torch_optim.cosine_schedule(1e-3, 1, 5),
                          key=("cos", 1e-3, 1, 5))
    assert a.key == b.key
    # the reference's layout of the key, dtype named as numpy names it
    assert torch_optim.adamw(5e-3).key == jax_optim.adamw(5e-3).key
    assert torch_optim.sgd(0.1, 0.9).key == jax_optim.sgd(0.1, 0.9).key


def test_opt_state_from_jax_round_trip():
    tree = _tree()
    opt_j = jax_optim.adamw(1e-3)
    sj = opt_j.init(tree)
    for k in range(2):
        tree, sj = opt_j.update(_grads(tree, k), sj, tree)
    st = torch_models.opt_state_from_jax(sj, device="cpu")
    assert st.step.dtype == torch.int32 and int(st.step) == 2
    _close(st.mu, sj.mu, dict(rtol=0, atol=0))
    _close(st.nu, sj.nu, dict(rtol=0, atol=0))
    # continuing from the converted state agrees with the reference
    params = torch_models.params_from_jax(tree, device="cpu")
    g = _grads(tree, 9)
    pj, _ = opt_j.update(g, sj, tree)
    pt, _ = torch_optim.adamw(1e-3).update(
        [torch.from_numpy(x) for x in jax.tree.leaves(g)], st, params)
    _close(pt.leaves(), pj)
