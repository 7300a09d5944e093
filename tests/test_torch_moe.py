"""The port's MoE family against the JAX package's, on the CPU: capacity,
HopMoE's α decision and ``MoEStats`` bitwise, the routing (top-k experts,
kept slots) equal, ``moe_forward`` with and without shared experts and with
dropped tokens, the two configs, and the smoke models' forward, prefill +
decode, ``loss_fn`` with the balance loss and every gradient leaf, training
steps and serving, on the reference's own parameters converted with
``params_from_jax``.

Inputs come from numpy seeds; both smoke variants in float32. Tolerances:
module outputs at 1e-5, model logits at 1e-4, each gradient leaf within
1e-5 of its largest |g|, losses at rtol 1e-5 (float32 summation order
only). Integers (capacities, byte counts, expert ids, slots) are equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jax_configs
import repro.launch.serve as jax_serve
import repro.launch.train as jax_train
import repro.models.transformer as jax_tf
from repro.models.transformer import moe as jax_moe
import repro_torch.configs as torch_configs
import repro_torch.launch.serve as torch_serve
import repro_torch.launch.train as torch_train
import repro_torch.models.transformer as torch_tf
from repro_torch.kernels import gather_agg as cuda_ga
from repro_torch.kernels import linattn as cuda_linattn
from repro_torch.models.transformer import moe as torch_moe

from _torch_families import (MODEL_TOL, batches, cfgs,
                             check_decode_matches_forward,
                             check_init_like_reference,
                             check_loss_and_grads, check_prefill_decode,
                             close, drain, model)

MOE = ["deepseek-moe-16b", "qwen2-moe-a2.7b"]
B = 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread in this worker (the suite runs in several)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# configs, capacity, the α decision
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", MOE)
def test_moe_configs_match_reference(arch, smoke):
    """Every field of the published config and of its smoke variant equals
    the reference's, and so do the total and active parameter counts."""
    ref_cfg = jax_configs.get_config(arch)
    cfg = torch_configs.get_config(arch)
    if smoke:
        ref_cfg = jax_configs.smoke_variant(ref_cfg)
        cfg = torch_configs.smoke_variant(cfg)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    assert cfg.param_count() == ref_cfg.param_count()
    assert cfg.active_param_count() == ref_cfg.active_param_count()
    assert cfg.family == "moe" and cfg.moe_num_experts


@pytest.mark.parametrize("seq", [1, 2, 7, 24, 256, 1024, 2048, 32768])
def test_moe_capacity_matches_reference(seq):
    for k, e, cf in ((6, 64, 1.25), (4, 60, 1.25), (2, 4, 1.25),
                     (2, 4, 0.5), (2, 4, 8.0), (1, 3, 1.0)):
        assert torch_moe.moe_capacity(seq, k, e, cf) == \
            jax_moe.moe_capacity(seq, k, e, cf)
    assert torch_moe.moe_capacity(1, 6, 64, 1.25) == 1


@pytest.mark.parametrize("mode", ["auto", "tokens", "weights"])
@pytest.mark.parametrize("arch", MOE)
def test_alpha_mode_bitwise(arch, mode):
    """The mode and both byte counts at the serve shapes (the pow2
    prefill buckets at batch 8, decode at batch 8 and 1) and the train
    shapes (4 × 1,024, 2 × 1,024, 256 × 4,096), in bf16 and f32."""
    for dtype in ("bfloat16", "float32"):
        cj = dataclasses.replace(jax_configs.get_config(arch),
                                 moe_dispatch=mode, dtype=dtype)
        ct = dataclasses.replace(torch_configs.get_config(arch),
                                 moe_dispatch=mode, dtype=dtype)
        for b, s in [(8, 2 ** i) for i in range(3, 12)] + [
                (8, 1), (1, 1), (4, 1024), (2, 1024), (256, 4096)]:
            got = torch_moe._alpha_mode(ct, b, s)
            assert got == jax_moe._alpha_mode(cj, b, s), (b, s, dtype)
            assert got[0] == (mode if mode != "auto" else got[0])


def _moe_params(cj, seed, shared: bool):
    cj = dataclasses.replace(cj, moe_num_shared=1 if shared else 0)
    pj = jax_moe.init_moe(jax.random.PRNGKey(seed), cj, jnp.float32)
    if shared:
        assert "shared" in pj
    pt = jax.tree.map(lambda a: torch.from_numpy(np.array(a, np.float32)),
                      pj)
    return cj, pj, pt


def _ref_routing(pj, cj, x):
    """The reference's routing, as moe.py:98-113 computes it."""
    B_, S, _ = x.shape
    E, k = cj.moe_num_experts, cj.moe_top_k
    C = jax_moe.moe_capacity(S, k, E, cj.moe_capacity_factor)
    probs = jax.nn.softmax(x.astype(jnp.float32) @ pj["router"]["w"], -1)
    top_p, top_e = jax.lax.top_k(probs, k)
    eid = top_e.reshape(B_, S * k)
    pos = jnp.cumsum(jax.nn.one_hot(eid, E, dtype=jnp.int32), axis=1) - 1
    my_pos = jnp.take_along_axis(pos, eid[..., None], 2)[..., 0]
    keep = my_pos < C
    slot = jnp.where(keep, eid * C + my_pos, E * C)
    return probs, top_e, keep, slot


@pytest.mark.parametrize("cf", [1.25, 0.5])
@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("arch", MOE)
def test_moe_forward_matches_reference(arch, shared, cf):
    """moe_forward on (2, 24, 256) inputs: the routing equal to the
    reference's (top-k experts, kept flags and slots), the output at
    1e-5, the balance loss at 1e-6, and MoEStats' mode and byte counts
    equal. At capacity factor 0.5 tokens are dropped (asserted)."""
    cj, ct = cfgs(arch, moe_capacity_factor=cf,
                  moe_num_shared=1 if shared else 0)
    cj, pj, pt = _moe_params(cj, 3, shared)
    x = np.random.default_rng(4).standard_normal((B, 24, ct.d_model)
                                                 ).astype(np.float32)
    want, st_j = jax_moe.moe_forward(pj, cj, jnp.asarray(x))
    got, st_t = torch_moe.moe_forward(pt, ct, torch.from_numpy(x))
    close(got, want)
    np.testing.assert_allclose(float(st_t.aux_loss), float(st_j.aux_loss),
                               rtol=1e-6)
    assert (st_t.mode, st_t.dispatch_bytes, st_t.weight_bytes) == \
        (st_j.mode, st_j.dispatch_bytes, st_j.weight_bytes)
    probs, top_e, keep, slot = _ref_routing(pj, cj, jnp.asarray(x))
    r = st_t.routing
    close(r.probs, probs)
    np.testing.assert_array_equal(r.top_e.numpy(), np.asarray(top_e))
    np.testing.assert_array_equal(r.keep.numpy(), np.asarray(keep))
    np.testing.assert_array_equal(r.slot.numpy(), np.asarray(slot))
    assert (not r.keep.all()) == (cf == 0.5)


def test_moe_dispatch_modes_give_the_same_output():
    """HopMoE's tokens and weights modes are shardings of the same math:
    on one device the outputs are bitwise equal, the reference's
    tests/test_arch_smoke.py claim for its own modes."""
    _, ct = cfgs("deepseek-moe-16b")
    _, _, pt = _moe_params(cfgs("deepseek-moe-16b")[0], 0, True)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 16, ct.d_model)).astype(np.float32))
    outs = {}
    for mode in ("tokens", "weights"):
        y, stats = torch_moe.moe_forward(
            pt, dataclasses.replace(ct, moe_dispatch=mode), x)
        assert stats.mode == mode
        outs[mode] = y
    assert torch.equal(outs["tokens"], outs["weights"])


def test_moe_decode_step_has_capacity_one_and_drops_nothing():
    _, ct = cfgs("qwen2-moe-a2.7b")
    cj, pj, pt = _moe_params(cfgs("qwen2-moe-a2.7b")[0], 5, True)
    x = np.random.default_rng(5).standard_normal((3, 1, ct.d_model)
                                                 ).astype(np.float32)
    got, st = torch_moe.moe_forward(pt, ct, torch.from_numpy(x))
    want, _ = jax_moe.moe_forward(pj, cj, jnp.asarray(x))
    close(got, want)
    assert st.routing.keep.all()
    assert int(st.routing.slot.max()) < ct.moe_num_experts   # C = 1


def test_params_from_jax_keeps_the_router_float32():
    """A bf16 config: the router (path moe/router/w) stays float32 as the
    reference draws it, every expert and the shared MLP in bf16."""
    m = model("deepseek-moe-16b")
    bf = dataclasses.replace(m["cfg_t"], dtype="bfloat16")
    p = torch_tf.params_from_jax(m["tree"], bf, "cpu")
    for layer in p["layers"]:
        assert layer["moe"]["router"]["w"].dtype == torch.float32
        for w in ("wg", "wu", "wd"):
            assert layer["moe"][w].dtype == torch.bfloat16
        assert layer["moe"]["shared"]["wg"]["w"].dtype == torch.bfloat16
        assert layer["attn"]["wq"]["w"].dtype == torch.bfloat16
    a = torch_tf.init_params(bf, torch.Generator().manual_seed(0), "cpu")
    assert a["layers"][0]["moe"]["router"]["w"].dtype == torch.float32
    assert a["layers"][0]["moe"]["wg"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# the smoke models
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=MOE)
def moe_model(request):
    return model(request.param, seed=1)


def test_init_params_moe_shapes_like_reference(moe_model):
    check_init_like_reference(moe_model)


def test_forward_matches_reference(moe_model):
    bj, bt = batches(moe_model, B, 24, seed=0)
    want, aux_j = jax_tf.forward(moe_model["tree"], moe_model["cfg_j"], bj)
    got, aux_t = torch_tf.forward(moe_model["params"], moe_model["cfg_t"],
                                  bt)
    assert got.shape == (B, 24, moe_model["cfg_t"].padded_vocab)
    close(got, want, MODEL_TOL)
    assert float(aux_t) > 0
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-5)


def test_forward_records_each_layers_stats(moe_model):
    """forward_hidden(moe_stats=[...]) appends one MoEStats per layer, its
    routing included, and computes the same hidden states."""
    _, bt = batches(moe_model, B, 24, seed=0)
    stats = []
    x, aux = torch_tf.forward_hidden(moe_model["params"],
                                     moe_model["cfg_t"], bt, moe_stats=stats)
    x2, aux2 = torch_tf.forward_hidden(moe_model["params"],
                                       moe_model["cfg_t"], bt)
    assert torch.equal(x, x2) and torch.equal(aux, aux2)
    assert len(stats) == moe_model["cfg_t"].num_layers
    assert all(s.routing.top_e.shape == (B, 24, moe_model["cfg_t"].moe_top_k)
               for s in stats)
    torch.testing.assert_close(sum(s.aux_loss for s in stats), aux)


def test_prefill_and_decode_match_reference(moe_model):
    check_prefill_decode(moe_model, B, 24, seed=1)


@pytest.mark.parametrize("seq", [8, 24])
def test_prefill_then_decode_matches_full_forward(seq):
    """As tests/test_arch_smoke.py: capacity factor 8, since a capacity
    drop in the full forward is a training artifact that decode (C = 1)
    never has."""
    m = model("qwen2-moe-a2.7b", seed=2, moe_capacity_factor=8.0)
    _, bt = batches(m, B, seq, seed=2)
    check_decode_matches_forward(m["cfg_t"], m["params"], bt)


def test_zero_decode_state_then_decode_matches_reference(moe_model):
    cj, ct = moe_model["cfg_j"], moe_model["cfg_t"]
    st_j = jax_tf.init_decode_state(cj, B, 16)
    st_t = torch_tf.init_decode_state(ct, B, 16, device="cpu")
    nxt = np.array([11, 5], np.int32)
    want, _ = jax_tf.decode_step(moe_model["tree"], cj, jnp.asarray(nxt),
                                 st_j)
    got, _ = torch_tf.decode_step(moe_model["params"], ct,
                                  torch.from_numpy(nxt), st_t)
    close(got, want, MODEL_TOL)


@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_loss_and_grads_match_reference(moe_model, cf):
    """loss_fn's total (CE + 0.01 × the balance loss summed over layers),
    its parts and every gradient leaf (the router's through the balance
    loss and the gates) against jax.value_and_grad; at capacity factor
    0.5 with dropped tokens too."""
    m = dict(moe_model,
             cfg_j=dataclasses.replace(moe_model["cfg_j"],
                                       moe_capacity_factor=cf),
             cfg_t=dataclasses.replace(moe_model["cfg_t"],
                                       moe_capacity_factor=cf))
    check_loss_and_grads(m, B, 40, seed=4)


def test_train_steps_match_reference():
    """3 steps of make_train_step against the reference's jitted step on
    deepseek-moe smoke: loss, ce and aux at rtol 1e-5 on every step."""
    m = model("deepseek-moe-16b", seed=3)
    cj, ct = m["cfg_j"], m["cfg_t"]
    opt_j = jax_train.pick_optimizer(cj, lr=3e-4)
    opt_t = torch_train.pick_optimizer(ct, lr=3e-4)
    step_j = jax.jit(jax_train.make_train_step(cj, opt_j))
    step_t = torch_train.make_train_step(ct, opt_t)
    pj, sj = m["tree"], opt_j.init(m["tree"])
    pt, stt = m["params"], opt_t.init(m["params"])
    for i in range(3):
        bj, bt = batches(m, B, 32, seed=10 + i)
        pj, sj, mj = step_j(pj, sj, bj)
        pt, stt, mt = step_t(pt, stt, bt)
        for k in ("loss", "ce", "aux"):
            np.testing.assert_allclose(float(mt[k]), float(mj[k]),
                                       rtol=1e-5, err_msg=f"step {i} {k}")
        assert float(mt["aux"]) > 0


@pytest.mark.parametrize("seq", [8, 24])
def test_generate_greedy_matches_reference(moe_model, seq):
    bj, bt = batches(moe_model, B, seq, seed=3)
    want = jax_serve.generate(moe_model["tree"], moe_model["cfg_j"], bj, 6,
                              max_seq=seq + 14)
    got = torch_serve.generate(moe_model["params"], moe_model["cfg_t"], bt,
                               6, max_seq=seq + 14)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_llm_server_matches_reference(moe_model):
    """Prompts of mixed lengths through both servers: the same greedy
    tokens per prompt, the same batches, and no kernel launched."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, moe_model["cfg_t"].vocab_size, n)
               for n in (8, 5, 13, 8, 3)]
    sj = jax_serve.LLMServer(moe_model["tree"], moe_model["cfg_j"],
                             gen_tokens=4, max_batch=4, name="llm-ref-moe")
    st = torch_serve.LLMServer(moe_model["params"], moe_model["cfg_t"],
                               gen_tokens=4, max_batch=4,
                               name="llm-port-moe", device="cpu")
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
