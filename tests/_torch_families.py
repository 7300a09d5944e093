"""Helpers shared by the parity tests of the port's moe, hybrid, vlm and
audio families against the JAX package (tests/test_torch_moe.py,
tests/test_torch_hybrid.py, tests/test_torch_multimodal.py).

The reference's init leaves every bias at 0, every norm gain at 1 and
RG-LRU's Λ at 2 in every channel, which would hide them, so ``model``
perturbs the tree with seeded noise before it goes to both packages.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.configs as jax_configs
import repro.data as jax_data
import repro.models.transformer as jax_tf
import repro_torch.configs as torch_configs
import repro_torch.data as torch_data
import repro_torch.launch.train as torch_train
import repro_torch.models.transformer as torch_tf

TOL = dict(rtol=1e-5, atol=1e-5)          # module outputs
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)    # whole-model logits
GRAD_TOL = 1e-5                           # of each leaf's max |g|
LOSS_RTOL = 1e-5


def close(got: torch.Tensor, want, tol=TOL) -> None:
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **tol)


def perturb(tree, rng):
    """Biases (``b``, ``conv_b``) to seeded noise, norm gains to 1 +
    noise, ``lam`` to values in (1, 3), leaf by leaf."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if isinstance(v, (dict, list, tuple)):
                out[k] = perturb(v, rng)
            elif k in ("b", "conv_b"):
                out[k] = jnp.asarray(0.1 * rng.standard_normal(v.shape),
                                     v.dtype)
            elif k == "g":
                out[k] = jnp.asarray(1 + 0.1 * rng.standard_normal(v.shape),
                                     v.dtype)
            elif k == "lam":
                out[k] = jnp.asarray(1 + 2 * rng.random(v.shape), v.dtype)
            else:
                out[k] = v
        return out
    if isinstance(tree, (list, tuple)):
        return type(tree)(perturb(v, rng) for v in tree)
    return tree


def cfgs(arch, **kw):
    """(reference smoke config, port smoke config), each with ``kw``."""
    cj = jax_configs.smoke_variant(jax_configs.get_config(arch))
    ct = torch_configs.smoke_variant(torch_configs.get_config(arch))
    return dataclasses.replace(cj, **kw), dataclasses.replace(ct, **kw)


def model(arch, seed=0, **kw) -> dict:
    """The smoke variant of ``arch`` (with ``kw``) in both packages: the
    reference's perturbed init and the port's conversion of it."""
    cj, ct = cfgs(arch, **kw)
    tree = perturb(jax_tf.init_params(jax.random.PRNGKey(seed), cj),
                   np.random.default_rng(seed))
    return dict(cfg_j=cj, cfg_t=ct, tree=tree,
                params=torch_tf.params_from_jax(tree, ct, "cpu"))


def batches(m: dict, batch: int, seq: int, seed: int):
    """The same make_batch in both packages (bitwise, asserted)."""
    bj = jax_data.make_batch(m["cfg_j"], batch, seq, seed)
    bt = torch_data.make_batch(m["cfg_t"], batch, seq, seed)
    assert bj.keys() == bt.keys()
    for k in bj:
        np.testing.assert_array_equal(bt[k].numpy(), np.asarray(bj[k]))
    return bj, bt


def _np(node):
    if isinstance(node, dict):
        return {k: _np(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_np(v) for v in node]
    return node.detach().float().numpy()


def _stack(trees):
    return jax.tree.map(lambda *xs: np.stack(xs), *trees)


def restack(params: dict) -> dict:
    """The port's tree (parameters or gradients) in the reference's layout,
    as numpy: per-layer lists stacked on a leading axis, the hybrid's
    groups stacked per pattern position into ``{"blocks": (...)}``."""
    out = {}
    for k, v in params.items():
        if k in ("layers", "enc_layers", "dec_layers"):
            out[k] = _stack([_np(layer) for layer in v])
        elif k == "groups":
            out[k] = _stack([{"blocks": tuple(_np(b) for b in g["blocks"])}
                             for g in v])
        else:
            out[k] = _np(v)
    return out


def assert_trees_close(got: dict, want, tol: float = GRAD_TOL) -> None:
    """Leaf by leaf, in the reference's layout: the same paths and shapes,
    each within ``tol`` of the reference leaf's largest |value|."""
    got_l, got_def = jax.tree_util.tree_flatten_with_path(restack(got))
    want_l, want_def = jax.tree_util.tree_flatten_with_path(want)
    assert [jax.tree_util.keystr(p) for p, _ in got_l] == \
        [jax.tree_util.keystr(p) for p, _ in want_l]
    for (path, g), (_, w) in zip(got_l, want_l):
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape, jax.tree_util.keystr(path)
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=tol * np.abs(w).max() + 1e-30,
                                   err_msg=jax.tree_util.keystr(path))


def loss_and_grads(m: dict, batch: int, seq: int, seed: int):
    """loss_fn and every gradient leaf of both packages on the same batch:
    (loss_j, parts_j, grads_j, loss_t, parts_t, grads_t as a port tree)."""
    bj, bt = batches(m, batch, seq, seed)
    (loss_j, parts_j), g_j = jax.value_and_grad(
        jax_tf.loss_fn, has_aux=True)(m["tree"], m["cfg_j"], bj)
    loss_t, parts_t, g_t = torch_train.value_and_grad(m["params"],
                                                      m["cfg_t"], bt)
    return (loss_j, parts_j, g_j, loss_t, parts_t,
            torch_train._with_leaves(m["params"], iter(g_t)))


def check_loss_and_grads(m: dict, batch: int, seq: int, seed: int) -> None:
    loss_j, parts_j, g_j, loss_t, parts_t, g_t = loss_and_grads(
        m, batch, seq, seed)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(parts_t["ce"]), float(parts_j["ce"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(parts_t["aux"]), float(parts_j["aux"]),
                               rtol=LOSS_RTOL)
    assert_trees_close(g_t, g_j)


def check_prefill_decode(m: dict, batch: int, seq: int, seed: int,
                         steps=([3, 7], [11, 5], [2, 9])) -> None:
    """Prefill and then decode steps, both packages: logits at MODEL_TOL."""
    bj, bt = batches(m, batch, seq, seed)
    want, st_j = jax_tf.prefill(m["tree"], m["cfg_j"], bj, max_seq=seq + 8)
    got, st_t = torch_tf.prefill(m["params"], m["cfg_t"], bt,
                                 max_seq=seq + 8)
    assert got.shape == (batch, m["cfg_t"].padded_vocab)
    close(got, want, MODEL_TOL)
    for nxt in steps:
        nxt = np.array(nxt[:batch], np.int32)
        want, st_j = jax_tf.decode_step(m["tree"], m["cfg_j"],
                                        jnp.asarray(nxt), st_j)
        got, st_t = torch_tf.decode_step(m["params"], m["cfg_t"],
                                         torch.from_numpy(nxt), st_t)
        close(got, want, MODEL_TOL)


def check_decode_matches_forward(cfg, params, batch: dict,
                                 nxt=(3, 7)) -> None:
    """The port against itself, as tests/test_arch_smoke.py holds the
    reference: prefill equals the forward's last position, and a decode
    step after it the forward over one more token."""
    seq = batch["tokens"].shape[1]
    if "patches" in batch:                 # the vlm's prefix takes slots
        seq += batch["patches"].shape[1]
    last, state = torch_tf.prefill(params, cfg, batch, max_seq=seq + 8)
    full, _ = torch_tf.forward(params, cfg, batch)
    close(last, full[:, -1], MODEL_TOL)
    nxt = torch.tensor(nxt, dtype=torch.int32)
    dl, _ = torch_tf.decode_step(params, cfg, nxt, state)
    ext = dict(batch, tokens=torch.cat([batch["tokens"], nxt[:, None]], 1))
    full2, _ = torch_tf.forward(params, cfg, ext)
    close(dl, full2[:, -1], MODEL_TOL)


def leaf_shapes(node, prefix="", lead=0) -> dict:
    """{path: shape} of a tree of dicts, lists and tuples of arrays or
    tensors, each shape less its first ``lead`` axes."""
    if isinstance(node, dict):
        return {p: s for k, v in node.items()
                for p, s in leaf_shapes(v, f"{prefix}/{k}", lead).items()}
    if isinstance(node, (list, tuple)):
        return {p: s for i, v in enumerate(node)
                for p, s in leaf_shapes(v, f"{prefix}/{i}", lead).items()}
    return {prefix: tuple(node.shape)[lead:]}


def check_init_like_reference(m: dict) -> None:
    """The port's init has every leaf of the reference's, at its shape in
    the reference's layout, in float32 (the smoke dtype) but the leaves
    the reference keeps in float32 anyway; the same seed draws the same
    tensors."""
    ct = m["cfg_t"]
    a = torch_tf.init_params(ct, torch.Generator().manual_seed(3), "cpu")
    b = torch_tf.init_params(ct, torch.Generator().manual_seed(3), "cpu")
    assert leaf_shapes(restack(a)) == leaf_shapes(m["tree"])
    for ta, tb in zip(torch_train.leaves(a), torch_train.leaves(b)):
        assert ta.dtype == torch.float32
        assert torch.equal(ta, tb)


def drain(srv, tickets):
    while not all(t.done() for t in tickets):
        srv.pump(wait_s=0.0)
    return [t.wait(1.0) for t in tickets]
