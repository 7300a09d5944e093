"""The port's RG-LRU hybrid (recurrentgemma) against the JAX package's, on
the CPU: the log-depth scan against ``jax.lax.associative_scan`` and the
sequential recurrence, the conv and gates, ``rglru_block`` with its state
and its decode, the config, and the smoke models — one pattern period
(rec, rec, attn) and a 5-layer variant with a two-position tail — through
forward, prefill past the local window + decode, ``loss_fn`` and every
gradient leaf, and serving, on the reference's own parameters converted
with ``params_from_jax``.

Inputs come from numpy seeds; float32. Tolerances: module outputs at 1e-5,
model logits at 1e-4, each gradient leaf within 1e-5 of its largest |g|,
losses at rtol 1e-5 (float32 summation order only).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jax_configs
import repro.launch.serve as jax_serve
import repro.models.transformer as jax_tf
from repro.models.transformer import rglru as jax_rglru
import repro_torch.configs as torch_configs
import repro_torch.launch.serve as torch_serve
import repro_torch.models.transformer as torch_tf
from repro_torch.kernels import gather_agg as cuda_ga
from repro_torch.kernels import linattn as cuda_linattn
from repro_torch.models.transformer import rglru as torch_rglru

from _torch_families import (MODEL_TOL, batches, cfgs,
                             check_decode_matches_forward,
                             check_init_like_reference,
                             check_loss_and_grads, check_prefill_decode,
                             close, drain, model, perturb)

ARCH = "recurrentgemma-9b"
B = 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread in this worker (the suite runs in several)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("smoke", [False, True])
def test_hybrid_config_matches_reference(smoke):
    """Every field and the parameter count equal the reference's; the
    published model is 38 layers of (rec, rec, attn): 12 periods and a
    tail of two rec positions, MQA with head dim 256 and a 2,048-token
    local window."""
    ref_cfg = jax_configs.get_config(ARCH)
    cfg = torch_configs.get_config(ARCH)
    if smoke:
        ref_cfg = jax_configs.smoke_variant(ref_cfg)
        cfg = torch_configs.smoke_variant(cfg)
        assert cfg.num_layers == 3 and cfg.local_attn_window == 32
    else:
        assert cfg.num_layers == 38 and cfg.hdim == 256
        assert cfg.num_kv_heads == 1 and cfg.local_attn_window == 2048
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    assert cfg.param_count() == ref_cfg.param_count()


# ---------------------------------------------------------------------------
# the scan and the block
# ---------------------------------------------------------------------------

def _ab(rng, shape, low=0.0):
    a = (low + (1 - low) * rng.random(shape)).astype(np.float32)
    b = rng.standard_normal(shape).astype(np.float32)
    return a, b


def _sequential(a, b):
    h = np.zeros_like(b[:, 0])
    out = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        out.append(h)
    return np.stack(out, 1)


@pytest.mark.parametrize("S", [1, 2, 3, 7, 24, 64, 100])
def test_rglru_scan_matches_associative_scan_and_recurrence(S):
    a, b = _ab(np.random.default_rng(S), (B, S, 16))
    got = torch_rglru.rglru_scan(torch.from_numpy(a), torch.from_numpy(b))
    close(got, jax_rglru.rglru_scan(jnp.asarray(a), jnp.asarray(b)))
    close(got, _sequential(a, b))


def test_rglru_scan_has_no_underflow_trouble():
    """Decays as the block makes them at Λ = 2 and r near 1 (a_t ≈ e^-17):
    the products of a underflow float32 after a few steps, which a
    cumprod-and-divide form would turn into NaN or inf; the scan stays
    finite and equal to the recurrence."""
    rng = np.random.default_rng(0)
    r = rng.random((B, 200, 8)).astype(np.float32)
    a = np.exp(-8.0 * r * np.log1p(np.exp(2.0))).astype(np.float32)
    b = rng.standard_normal(a.shape).astype(np.float32)
    got = torch_rglru.rglru_scan(torch.from_numpy(a), torch.from_numpy(b))
    assert torch.isfinite(got).all()
    assert np.prod(a.astype(np.float64), 1).min() < 1e-300
    close(got, _sequential(a, b))


@pytest.fixture(scope="module")
def block():
    """One RG-LRU block of the smoke variant, the reference's init with
    its conv bias and Λ perturbed, and the pre-norm of its position."""
    cj, ct = cfgs(ARCH)
    pj = perturb(jax_rglru.init_rglru_block(jax.random.PRNGKey(2), cj,
                                            jnp.float32),
                 np.random.default_rng(2))
    norm = {"g": jnp.asarray(1 + 0.1 * np.random.default_rng(3)
                             .standard_normal(ct.d_model), jnp.float32)}
    to_t = lambda t: jax.tree.map(  # noqa: E731
        lambda a: torch.from_numpy(np.array(a, np.float32)), t)
    return cj, ct, pj, to_t(pj), norm, to_t(norm)


def test_conv_and_gates_match_reference(block):
    cj, ct, pj, pt, _, _ = block
    u = np.random.default_rng(4).standard_normal((B, 9, ct.d_model)
                                                 ).astype(np.float32)
    close(torch_rglru._conv1d(pt, torch.from_numpy(u)),
          jax_rglru._conv1d(pj, jnp.asarray(u)))
    a_t, b_t = torch_rglru._gates(pt, torch.from_numpy(u))
    a_j, b_j = jax_rglru._gates(pj, jnp.asarray(u))
    close(a_t, a_j)
    close(b_t, b_j)


@pytest.mark.parametrize("S", [1, 2, 24])
def test_rglru_block_with_state_matches_reference(block, S):
    """The block's output and the state after the last token, including
    S = 1 and 2, where the conv tail is padded with zeros."""
    cj, ct, pj, pt, nj, nt = block
    x = np.random.default_rng(S).standard_normal((B, S, ct.d_model)
                                                 ).astype(np.float32)
    want, st_j = jax_rglru.rglru_block(pj, cj, jnp.asarray(x), nj,
                                       return_state=True)
    got, st_t = torch_rglru.rglru_block(pt, ct, torch.from_numpy(x), nt,
                                        return_state=True)
    close(got, want)
    close(st_t.h, st_j.h)
    assert st_t.conv.shape == (B, ct.conv_width - 1, ct.d_model)
    close(st_t.conv, st_j.conv)
    plain = torch_rglru.rglru_block(pt, ct, torch.from_numpy(x), nt)
    assert torch.equal(plain, got)


def test_rglru_block_decode_matches_reference(block):
    """From the state after a 5-token prompt and from a zero state, four
    decode steps: outputs and states against the reference's."""
    cj, ct, pj, pt, nj, nt = block
    rng = np.random.default_rng(6)
    x = rng.standard_normal((B, 5, ct.d_model)).astype(np.float32)
    _, st_j = jax_rglru.rglru_block(pj, cj, jnp.asarray(x), nj,
                                    return_state=True)
    _, st_t = torch_rglru.rglru_block(pt, ct, torch.from_numpy(x), nt,
                                      return_state=True)
    zero_j = jax_rglru.init_rglru_state(B, cj)
    zero_t = torch_rglru.init_rglru_state(B, ct)
    assert zero_t.h.dtype == torch.float32 and not zero_t.h.any()
    for sj, stt in ((st_j, st_t), (zero_j, zero_t)):
        for _ in range(4):
            xt = rng.standard_normal((B, 1, ct.d_model)).astype(np.float32)
            want, sj = jax_rglru.rglru_block_decode(pj, cj, jnp.asarray(xt),
                                                    nj, sj)
            got, stt = torch_rglru.rglru_block_decode(
                pt, ct, torch.from_numpy(xt), nt, stt)
            close(got, want)
            close(stt.h, sj.h)
            close(stt.conv, sj.conv)


# ---------------------------------------------------------------------------
# the smoke models: one period (no tail) and 5 layers (a two-position tail)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[3, 5], ids=["period", "tail"])
def hybrid(request):
    return model(ARCH, seed=request.param, num_layers=request.param)


def test_params_from_jax_layout_and_dtypes(hybrid):
    """groups un-stacked into a list of {"blocks": [rec, rec, attn]}, the
    tail copied as it is; in a bf16 config Λ stays float32."""
    p, ct, tree = hybrid["params"], hybrid["cfg_t"], hybrid["tree"]
    assert len(p["groups"]) == 1
    assert len(p["tail"]) == ct.num_layers - 3
    assert [sorted(b) for b in p["groups"][0]["blocks"]] == [
        ["blk", "ln1", "ln2", "mlp"], ["blk", "ln1", "ln2", "mlp"],
        ["attn", "ln1", "ln2", "mlp"]]
    np.testing.assert_array_equal(
        p["groups"][0]["blocks"][1]["blk"]["wa"]["w"].numpy(),
        np.asarray(tree["groups"]["blocks"][1]["blk"]["wa"]["w"][0]))
    for j, pos in enumerate(p["tail"]):
        np.testing.assert_array_equal(
            pos["blk"]["w_out"]["w"].numpy(),
            np.asarray(tree["tail"][j]["blk"]["w_out"]["w"]))
    bf = torch_tf.params_from_jax(tree, dataclasses.replace(
        ct, dtype="bfloat16"), "cpu")
    blk = bf["groups"][0]["blocks"][0]["blk"]
    assert blk["lam"].dtype == torch.float32
    assert blk["wa"]["w"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="groups"):
        torch_tf.params_from_jax(tree, dataclasses.replace(
            ct, num_layers=ct.num_layers + 3), "cpu")


def test_init_params_hybrid_shapes_like_reference(hybrid):
    check_init_like_reference(hybrid)


def test_forward_matches_reference(hybrid):
    bj, bt = batches(hybrid, B, 24, seed=0)
    want, _ = jax_tf.forward(hybrid["tree"], hybrid["cfg_j"], bj)
    got, aux = torch_tf.forward(hybrid["params"], hybrid["cfg_t"], bt)
    assert got.shape == (B, 24, hybrid["cfg_t"].padded_vocab)
    assert float(aux) == 0.0
    close(got, want, MODEL_TOL)


@pytest.mark.parametrize("seq", [24, 40])
def test_prefill_and_decode_match_reference(hybrid, seq):
    """At 40 tokens the attention position's 32-slot ring is filled and
    rolled; three decode steps follow."""
    check_prefill_decode(hybrid, B, seq, seed=1)


def test_prefill_state_matches_reference(hybrid):
    """Every position's decode state after a 40-token prompt: RG-LRU h and
    conv tail, the attention ring's keys, values and position."""
    bj, bt = batches(hybrid, B, 40, seed=5)
    _, st_j = jax_tf.prefill(hybrid["tree"], hybrid["cfg_j"], bj, max_seq=48)
    _, st_t = torch_tf.prefill(hybrid["params"], hybrid["cfg_t"], bt,
                               max_seq=48)
    pairs = [(st_t.caches[0]["blocks"][j],
              jax.tree.map(lambda a: a[0], st_j.caches["blocks"][j]))
             for j in range(3)] + list(zip(st_t.tail, st_j.tail))
    assert len(st_t.tail) == hybrid["cfg_t"].num_layers - 3
    for got, want in pairs:
        if isinstance(got, torch_rglru.RGLRUState):
            close(got.h, want.h, MODEL_TOL)
            close(got.conv, want.conv, MODEL_TOL)
        else:
            assert got.k.shape[1] == 32 and got.pos == int(want.pos) == 40
            close(got.k, want.k, MODEL_TOL)
            close(got.v, want.v, MODEL_TOL)


@pytest.mark.parametrize("seq", [8, 40])
def test_prefill_then_decode_matches_full_forward(hybrid, seq):
    _, bt = batches(hybrid, B, seq, seed=2)
    check_decode_matches_forward(hybrid["cfg_t"], hybrid["params"], bt)


def test_zero_decode_state_then_decode_matches_reference(hybrid):
    cj, ct = hybrid["cfg_j"], hybrid["cfg_t"]
    st_j = jax_tf.init_decode_state(cj, B, 16)
    st_t = torch_tf.init_decode_state(ct, B, 16, device="cpu")
    assert len(st_t.caches) == 1 and len(st_t.tail) == ct.num_layers - 3
    for nxt in ([11, 5], [4, 2]):
        nxt = np.array(nxt, np.int32)
        want, st_j = jax_tf.decode_step(hybrid["tree"], cj, jnp.asarray(nxt),
                                        st_j)
        got, st_t = torch_tf.decode_step(hybrid["params"], ct,
                                         torch.from_numpy(nxt), st_t)
        close(got, want, MODEL_TOL)


def test_loss_and_grads_match_reference(hybrid):
    check_loss_and_grads(hybrid, B, 40, seed=4)


def test_generate_greedy_matches_reference(hybrid):
    bj, bt = batches(hybrid, B, 36, seed=3)
    want = jax_serve.generate(hybrid["tree"], hybrid["cfg_j"], bj, 6,
                              max_seq=50)
    got = torch_serve.generate(hybrid["params"], hybrid["cfg_t"], bt, 6,
                               max_seq=50)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_llm_server_matches_reference(hybrid):
    """Prompts of mixed lengths (one past the 32-token window) through both
    servers: the same greedy tokens and batches, no kernel launched."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, hybrid["cfg_t"].vocab_size, n)
               for n in (8, 5, 40, 8, 3)]
    sj = jax_serve.LLMServer(hybrid["tree"], hybrid["cfg_j"], gen_tokens=4,
                             max_batch=4, name="llm-ref-hybrid")
    st = torch_serve.LLMServer(hybrid["params"], hybrid["cfg_t"],
                               gen_tokens=4, max_batch=4,
                               name="llm-port-hybrid", device="cpu")
    cuda_linattn.reset_launches()
    cuda_ga.reset_launches()
    want = drain(sj, [sj.submit(p) for p in prompts])
    got = drain(st, [st.submit(p) for p in prompts])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    stats = st.stats()
    assert stats["served"] == 5 and stats["errors"] == 0
    assert stats["batches"] == sj.stats()["batches"] == 2
    assert cuda_linattn.launches == {"linattn": 0}
    assert cuda_ga.launches == {"gather_rows": 0, "gather_agg": 0}
