"""The port's transformer training against the JAX package's, on the CPU:
the differentiable chunked linear attention and its dispatch, the chunked
cross-entropy, ``loss_fn`` and every gradient leaf for the dense and RWKV6
smoke models, ``make_train_step`` over several steps and with gradient
accumulation, the optimizer and accumulation choices, and the training
entry point.

Inputs come from numpy seeds (tokens from both packages' ``make_batch``,
bitwise equal), the parameters are the reference's init converted with
``params_from_jax``, all float32 at the smoke size. Tolerances: the
linear attention's gradients at 1e-5 and the chunked CE at 1e-6; the loss
at rtol 1e-5 and each gradient leaf within 1e-5 of its largest |g|
(float32 summation order only; measured at most 3.4e-6 on the dense smoke
models), except RWKV6's at 5e-5 (measured 1.9e-5, on ``wk`` and ``u``:
its gradients sum many terms through the chunked decays); training losses
at rtol 1e-5 over 5 steps.
"""
import contextlib
import io
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jax_configs
import repro.data as jax_data
import repro.launch.train as jax_train
import repro.models.transformer as jax_tf
from repro.kernels import ops as jax_ops
from repro.models.transformer import model as jax_model
import repro_torch.configs as torch_configs
import repro_torch.data as torch_data
import repro_torch.launch.train as torch_train
import repro_torch.models.transformer as torch_tf
from repro_torch.kernels import linattn as cuda_linattn
from repro_torch.kernels import ops
from repro_torch.models.transformer import common as torch_common
from repro_torch.models.transformer import model as torch_model
from repro_torch.optim import tree_leaves

ARCHS = ["qwen2-1.5b", "nemotron-4-340b", "h2o-danube-3-4b", "rwkv6-7b"]
GRAD_TOL = 1e-5
RWKV6_GRAD_TOL = 5e-5      # measured 1.9e-5 of the leaf's max |g|
LOSS_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread in this worker (the suite runs in several)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the differentiable linear attention and its dispatch
# ---------------------------------------------------------------------------

def _la_inputs(seed=0, BH=3, T=48, dk=8, dv=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((BH, T, dk)).astype(np.float32)
    k = rng.standard_normal((BH, T, dk)).astype(np.float32)
    v = rng.standard_normal((BH, T, dv)).astype(np.float32)
    w = (0.6 + 0.39 * rng.random((BH, T, dk))).astype(np.float32)
    u = rng.standard_normal((BH, dk)).astype(np.float32)
    s0 = rng.standard_normal((BH, dk, dv)).astype(np.float32)
    co = rng.standard_normal((BH, T, dv)).astype(np.float32)
    cs = rng.standard_normal((BH, dk, dv)).astype(np.float32)
    return (q, k, v, w, u), s0, co, cs


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("chunk", [16, 48])
def test_linattn_chunked_torch_grads_match_jax(chunk, with_state):
    """Gradients of <o, co> + <S, cs> with respect to q, k, v, w, u (and
    the incoming state) against ``jax.grad`` of the reference's
    ``linattn_chunked_jnp``, each within 1e-5 of its largest |g|."""
    xs, s0, co, cs = _la_inputs(chunk)
    n = 6 if with_state else 5

    def f_j(*a):
        o, s = jax_ops.linattn_chunked_jnp(*a[:5], state=a[5] if with_state
                                           else None, chunk=chunk)
        return jnp.sum(o * co) + jnp.sum(s * cs)

    args = list(xs) + ([s0] if with_state else [])
    want = jax.grad(f_j, argnums=tuple(range(n)))(
        *[jnp.asarray(a) for a in args])
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    o, s = ops.linattn_chunked_torch(*ts[:5], state=ts[5] if with_state
                                     else None, chunk=chunk)
    (o * torch.from_numpy(co)).sum().add((s * torch.from_numpy(cs)).sum()) \
        .backward()
    for t, w in zip(ts, want):
        w = np.asarray(w)
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=0,
                                   atol=GRAD_TOL * np.abs(w).max())


def test_linattn_takes_the_differentiable_path_when_grads_are_needed(
        monkeypatch):
    """ops.linattn's rule: autograd needs a gradient -> linattn_chunked_torch;
    an incoming state -> linattn_chunked_torch; otherwise the plain version
    on the CPU. No kernel launch is counted either way."""
    calls = []
    real = ops.linattn_chunked_torch

    def spy(*a, **kw):
        calls.append("torch")
        return real(*a, **kw)

    monkeypatch.setattr(ops, "linattn_chunked_torch", spy)
    cuda_linattn.reset_launches()
    (q, k, v, w, u), s0, _, _ = _la_inputs(1)
    t = [torch.from_numpy(x) for x in (q, k, v, w, u)]
    ops.linattn(*t, chunk=16)
    assert calls == []
    t[3].requires_grad_()
    o, _ = ops.linattn(*t, chunk=16)
    assert calls == ["torch"] and o.grad_fn is not None
    with torch.no_grad():
        ops.linattn(*t, chunk=16)
    assert calls == ["torch"]
    t[3].requires_grad_(False)
    ops.linattn(*t, state=torch.from_numpy(s0), chunk=16)
    assert calls == ["torch", "torch"]
    assert cuda_linattn.launches == {"linattn": 0}


@pytest.mark.parametrize("which", ["q", "k", "v", "w", "u"])
def test_cuda_linattn_refuses_inputs_that_require_grad(which):
    """The kernel has no backward: an input that requires grad under grad
    mode is refused before anything is built or launched."""
    cuda_linattn.reset_launches()
    (q, k, v, w, u), _, _, _ = _la_inputs(2, T=64)
    ts = dict(zip("qkvwu", (torch.from_numpy(x) for x in (q, k, v, w, u))))
    ts[which].requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        cuda_linattn.linattn_chunked(*ts.values(), chunk=64)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        cuda_linattn.linattn_chunked(*ts.values(), chunk=64)
    assert cuda_linattn.launches == {"linattn": 0}


# ---------------------------------------------------------------------------
# the loss and its gradients
# ---------------------------------------------------------------------------

def _perturbed_tree(cfg_j, seed):
    """The reference's init with biases, norm gains and RWKV6's u and mu
    perturbed by seeded noise (the init leaves them at 0, 1, 0 and 0.5)."""
    tree = jax_tf.init_params(jax.random.PRNGKey(seed), cfg_j)
    rng = np.random.default_rng(seed)

    def walk(node, name=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if name in ("b", "u", "gn_b"):
            return jnp.asarray(0.1 * rng.standard_normal(node.shape),
                               node.dtype)
        if name in ("g", "gn_g"):
            return jnp.asarray(1 + 0.1 * rng.standard_normal(node.shape),
                               node.dtype)
        if name in ("mu", "mu_c"):
            return jnp.asarray(rng.random(node.shape), node.dtype)
        return node
    return walk(tree)


def _model(arch, seed=0):
    cj = jax_configs.smoke_variant(jax_configs.get_config(arch))
    ct = torch_configs.smoke_variant(torch_configs.get_config(arch))
    tree = _perturbed_tree(cj, seed)
    return cj, ct, tree, torch_tf.params_from_jax(tree, ct, "cpu")


def _stacked_leaves(params):
    """The port's tree with its layers stacked on a leading axis, as the
    reference's, leaves in ``jax.tree.leaves`` order."""
    top = {k: v for k, v in params.items() if k != "layers"}
    layers = [tree_leaves(layer) for layer in params["layers"]]
    stacked = [torch.stack(ts) for ts in zip(*layers)]
    order = sorted(list(top) + ["layers"])
    out = []
    for k in order:
        out += stacked if k == "layers" else tree_leaves(top[k])
    return out


def _with_grads(params, grads):
    return torch_train._with_leaves(params, iter(grads))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    cj, ct, tree, params = _model(arch)
    S = 64 if ct.family == "ssm" else 40
    bj = jax_data.make_batch(cj, 2, S, seed=4)
    bt = torch_data.make_batch(ct, 2, S, seed=4)
    (loss_j, parts_j), g_j = jax.value_and_grad(
        jax_tf.loss_fn, has_aux=True)(tree, cj, bj)
    loss_t, parts_t, g_t = torch_train.value_and_grad(params, ct, bt)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(parts_t["ce"]), float(parts_j["ce"]),
                               rtol=LOSS_RTOL)
    assert float(parts_t["aux"]) == float(parts_j["aux"]) == 0.0
    got = _stacked_leaves(_with_grads(params, g_t))
    want = jax.tree.leaves(g_j)
    assert len(got) == len(want)
    tol = RWKV6_GRAD_TOL if ct.family == "ssm" else GRAD_TOL
    for gt, gw in zip(got, want):
        gw = np.asarray(gw)
        assert gt.shape == gw.shape and gt.dtype == torch.float32
        np.testing.assert_allclose(gt.numpy(), gw, rtol=0,
                                   atol=tol * np.abs(gw).max())
    for p in tree_leaves(params):
        assert not p.requires_grad       # differentiated through aliases


@pytest.mark.parametrize("S,chunk", [(40, 16), (37, 512), (64, 64)])
def test_chunked_ce_matches_unchunked(S, chunk):
    """S not a multiple of the chunk pads; the chunked sum equals the
    unchunked masked CE of the same logits, and the reference's chunked_ce,
    at 1e-6."""
    rng = np.random.default_rng(S)
    D, V = 32, 96
    x = rng.standard_normal((2, S, D)).astype(np.float32)
    head = (0.3 * rng.standard_normal((D, V))).astype(np.float32)
    labels = rng.integers(0, V, (2, S)).astype(np.int32)
    mask = rng.random((2, S)) < 0.8
    got = torch_model.chunked_ce({"head": torch.from_numpy(head)},
                                 torch.from_numpy(x),
                                 torch.from_numpy(labels),
                                 torch.from_numpy(mask), chunk=chunk)
    full = torch_common.cross_entropy(
        torch.from_numpy(x) @ torch.from_numpy(head),
        torch.from_numpy(labels), torch.from_numpy(mask))
    want = jax_model.chunked_ce({"head": jnp.asarray(head)}, jnp.asarray(x),
                                jnp.asarray(labels), jnp.asarray(mask),
                                chunk=chunk)
    np.testing.assert_allclose(float(got), float(full), rtol=1e-6)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen2-1.5b", "rwkv6-7b"])
def test_train_steps_match_reference(arch):
    """5 steps of make_train_step against the reference's jitted step, from
    the same parameters on the same token batches: every step's loss, ce
    and aux at rtol 1e-5."""
    cj, ct, tree, params = _model(arch, seed=1)
    opt_j = jax_train.pick_optimizer(cj, lr=3e-4)
    opt_t = torch_train.pick_optimizer(ct, lr=3e-4)
    step_j = jax.jit(jax_train.make_train_step(cj, opt_j))
    step_t = torch_train.make_train_step(ct, opt_t)
    st_j, st_t = opt_j.init(tree), opt_t.init(params)
    pj = tree
    for bj, bt in zip(jax_data.token_batches(cj, 4, 32, steps=5, seed=0),
                      torch_data.token_batches(ct, 4, 32, steps=5, seed=0)):
        pj, st_j, mj = step_j(pj, st_j, bj)
        params, st_t, mt = step_t(params, st_t, bt)
        for k in ("loss", "ce", "aux"):
            np.testing.assert_allclose(float(mt[k]), float(mj[k]),
                                       rtol=LOSS_RTOL)
    assert int(st_t.step) == 5


def test_accumulated_step_matches_full_batch():
    """Two microbatches accumulated against the full batch, on qwen2-smoke
    in float32 (the port's counterpart of tests/test_arch_smoke.py::
    test_microbatched_step_matches_full_batch): the loss at rtol 1e-5, each
    accumulated gradient leaf within 1e-5 of its largest |g|, and the
    parameters after the AdamW step at the reference's own bound for this
    comparison (rtol 2e-3, atol 2e-5). Not within 1e-5 of each leaf's
    largest value: AdamW's first step moves an element by lr·g/(|g| + 1e-8),
    so where |g| is near 1e-8 gradients that agree to 5e-7 of the leaf's
    max still move it differently (measured up to 5.3e-5 of the leaf's
    max)."""
    _, ct, tree, _ = _model("qwen2-1.5b", seed=2)
    opt = torch_train.pick_optimizer(ct, lr=1e-3)
    batch = torch_data.make_batch(ct, 4, 32, seed=0)
    out = []
    for accum in (1, 2):
        params = torch_tf.params_from_jax(tree, ct, "cpu")
        loss, _, grads = torch_train.accumulated_grads(params, ct, batch,
                                                       accum)
        step = torch_train.make_train_step(ct, opt, accum=accum)
        params, _, m = step(params, opt.init(params), batch)
        assert float(m["loss"]) == float(loss)
        out.append((params, m, grads))
    (p1, m1, g1), (p2, m2, g2) = out
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                               rtol=LOSS_RTOL)
    for a, b in zip(g1, g2):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0,
                                   atol=GRAD_TOL * float(a.abs().max()))
    for a, b in zip(tree_leaves(p1), tree_leaves(p2)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=2e-3,
                                   atol=2e-5)


@pytest.mark.parametrize("arch", jax_configs.ARCH_IDS)
def test_pick_optimizer_and_accum_match_reference(arch):
    """At the published size, for every config: the same AdamW
    (hyperparameters and moment dtype, read from the optimizers' value
    keys) and the same accumulation factor at several global batches
    (deepseek-moe-16b, above 8B parameters, takes 4 microbatches)."""
    cj, ct = jax_configs.get_config(arch), torch_configs.get_config(arch)
    assert torch_train.pick_optimizer(ct).key == \
        jax_train.pick_optimizer(cj).key
    for gb in (1, 6, 8, 24, 256):
        assert torch_train.pick_accum(ct, gb) == jax_train.pick_accum(cj, gb)
    if arch == "nemotron-4-340b":
        assert torch_train.pick_optimizer(ct).key[-1] == "bfloat16"
        assert torch_train.pick_accum(ct, 256) == 16
    if arch == "deepseek-moe-16b":
        assert torch_train.pick_accum(ct, 256) == 4


def test_train_main_runs_on_the_cpu():
    """``python -m repro_torch.launch.train --arch qwen2-1.5b --smoke
    --device cpu --steps 3``: three steps with finite losses."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        torch_train.main(["--arch", "qwen2-1.5b", "--smoke", "--device",
                          "cpu", "--steps", "3", "--batch", "2",
                          "--seq", "32"])
    lines = buf.getvalue().splitlines()
    assert lines[0].startswith("arch=qwen2-1.5b-smoke device=cpu")
    losses = [float(m.group(1)) for m in
              (re.match(r"step +\d+ loss (\S+)", ln) for ln in lines) if m]
    assert len(losses) == 3 and np.isfinite(losses).all()
