"""The port's vlm (pixtral) and audio (whisper) families against the JAX
package's, on the CPU: the configs, ``make_batch``'s patch and frame stubs
bitwise, LayerNorm, the encoder and decoder layers and the decoder's
cached decode, and the smoke models' forward, prefill + decode,
``loss_fn`` (the vlm's unsupervised patch prefix included) with every
gradient leaf, and greedy generation, on the reference's own parameters
converted with ``params_from_jax``; and ``LLMServer`` refusing both
families, whose requests need more than a prompt.

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
import repro.data as jax_data
import repro.launch.serve as jax_serve
import repro.models.transformer as jax_tf
from repro.models.transformer import common as jax_common
from repro.models.transformer import encdec as jax_encdec
from repro.models.transformer import model as jax_model
import repro_torch.configs as torch_configs
import repro_torch.data as torch_data
import repro_torch.launch.serve as torch_serve
import repro_torch.models.transformer as torch_tf
from repro_torch.models.transformer import common as torch_common
from repro_torch.models.transformer import encdec as torch_encdec
from repro_torch.models.transformer import model as torch_model

from _torch_families import (MODEL_TOL, batches, cfgs,
                             check_decode_matches_forward,
                             check_init_like_reference,
                             check_loss_and_grads, check_prefill_decode,
                             close, model, perturb)

VLM, AUDIO = "pixtral-12b", "whisper-base"
B = 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread in this worker (the suite runs in several)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _to_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a, np.float32)),
                        tree)


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_configs_match_reference(arch, smoke):
    ref_cfg = jax_configs.get_config(arch)
    cfg = torch_configs.get_config(arch)
    if smoke:
        ref_cfg = jax_configs.smoke_variant(ref_cfg)
        cfg = torch_configs.smoke_variant(cfg)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    assert cfg.param_count() == ref_cfg.param_count()


@pytest.mark.parametrize("batch,seq,seed", [(2, 24, 0), (3, 64, 7),
                                            (1, 2, 123), (2, 4096, 1)])
@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_make_batch_bitwise(arch, batch, seq, seed):
    """The stub (patches or frames, float32) and the tokens, drawn from one
    generator in the reference's order, at the smoke and published widths
    (pixtral: up to 1,024 patches of 1,024; whisper: 1,500 frames of
    512)."""
    for cj, ct in ((jax_configs.get_config(arch),
                    torch_configs.get_config(arch)), cfgs(arch)):
        if seq == 4096 and cj.family == "audio" and ct.encoder_seq > 64:
            continue                          # 1,500 × 512 frames suffice
        bj = jax_data.make_batch(cj, batch, seq, seed)
        bt = torch_data.make_batch(ct, batch, seq, seed)
        assert bt.keys() == bj.keys()
        for k in bj:
            assert bt[k].dtype == (torch.int32 if k == "tokens"
                                   else torch.float32)
            np.testing.assert_array_equal(bt[k].numpy(), np.asarray(bj[k]))
        if ct.family == "vlm":
            P = min(ct.num_patches, max(seq // 4, 1))
            assert bt["patches"].shape == (batch, P, ct.patch_dim)
            assert bt["tokens"].shape == (batch, seq - P)
        else:
            assert bt["frames"].shape == (batch, ct.encoder_seq,
                                          ct.encoder_d_model)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_reference(dtype):
    """Population variance, float32 statistics; bf16 within one bf16
    rounding."""
    rng = np.random.default_rng(0)
    x = (3 + 2 * rng.standard_normal((B, 7, 96))).astype(np.float32)
    g = (1 + 0.1 * rng.standard_normal(96)).astype(np.float32)
    b = (0.1 * rng.standard_normal(96)).astype(np.float32)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = jax_common.layernorm({"g": jnp.asarray(g, jd),
                                 "b": jnp.asarray(b, jd)},
                                jnp.asarray(x, jd))
    got = torch_common.layernorm({"g": torch.from_numpy(g).to(td),
                                  "b": torch.from_numpy(b).to(td)},
                                 torch.from_numpy(x).to(td))
    assert got.dtype == td
    tol = dict(rtol=1e-2, atol=1e-2) if dtype == "bfloat16" else \
        dict(rtol=1e-5, atol=1e-5)
    close(got, np.asarray(want.astype(jnp.float32)), tol)


# ---------------------------------------------------------------------------
# the encoder-decoder layers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def layers():
    """whisper-smoke's width (256, 4 heads, d_ff 512): one encoder and one
    decoder layer from the reference's init, biases and gains perturbed."""
    _, ct = cfgs(AUDIO)
    D, H = ct.d_model, ct.num_heads
    ej = perturb(jax_encdec.init_encoder_layer(jax.random.PRNGKey(0), D, H,
                                               D * 4, jnp.float32),
                 np.random.default_rng(0))
    dj = perturb(jax_encdec.init_decoder_layer(jax.random.PRNGKey(1), D, H,
                                               ct.d_ff, jnp.float32),
                 np.random.default_rng(1))
    assert "b" not in ej["attn"]["wk"] and "b" in ej["attn"]["wq"]
    rng = np.random.default_rng(2)
    enc = rng.standard_normal((B, 40, D)).astype(np.float32)
    return ct, H, ej, _to_torch(ej), dj, _to_torch(dj), enc


def test_encoder_layer_matches_reference(layers):
    ct, H, ej, et, _, _, enc = layers
    close(torch_encdec.encoder_layer(et, torch.from_numpy(enc), H),
          jax_encdec.encoder_layer(ej, jnp.asarray(enc), H))


def test_decoder_layer_matches_reference(layers):
    ct, H, _, _, dj, dt, enc = layers
    x = np.random.default_rng(3).standard_normal((B, 12, ct.d_model)
                                                 ).astype(np.float32)
    close(torch_encdec.decoder_layer(dt, torch.from_numpy(x),
                                     torch.from_numpy(enc), H),
          jax_encdec.decoder_layer(dj, jnp.asarray(x), jnp.asarray(enc), H))


def test_decoder_layer_decode_matches_reference(layers):
    """From init_decoder_cache (cross K/V of the encoder output) five
    cached decode steps: outputs and the self-attention cache at 1e-5, and
    step t equal to the full decoder layer's position t."""
    ct, H, _, _, dj, dt, enc = layers
    D = ct.d_model
    cj = jax_encdec.init_decoder_cache(dj, jnp.asarray(enc), B, 8, H, D,
                                       jnp.float32)
    c_t = torch_encdec.init_decoder_cache(dt, torch.from_numpy(enc), B, 8,
                                          H, D, torch.float32)
    close(c_t.cross_k, cj.cross_k)
    close(c_t.cross_v, cj.cross_v)
    xs = np.random.default_rng(4).standard_normal((B, 5, D)).astype(
        np.float32)
    full = torch_encdec.decoder_layer(dt, torch.from_numpy(xs),
                                      torch.from_numpy(enc), H)
    for t in range(5):
        x = xs[:, t:t + 1]
        want, cj = jax_encdec.decoder_layer_decode(dj, jnp.asarray(x), cj, H)
        got, c_t = torch_encdec.decoder_layer_decode(
            dt, torch.from_numpy(x), c_t, H)
        close(got, want)
        close(c_t.self_kv.k, cj.self_kv.k)
        assert c_t.self_kv.pos == int(cj.self_kv.pos) == t + 1
        close(got[:, 0], full[:, t])


# ---------------------------------------------------------------------------
# the smoke models
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[VLM, AUDIO])
def mm(request):
    return model(request.param, seed=2)


def test_init_params_shapes_like_reference(mm):
    check_init_like_reference(mm)


def test_forward_matches_reference(mm):
    bj, bt = batches(mm, B, 48, seed=0)
    want, _ = jax_tf.forward(mm["tree"], mm["cfg_j"], bj)
    got, aux = torch_tf.forward(mm["params"], mm["cfg_t"], bt)
    S = 48 if mm["cfg_t"].family == "vlm" else bt["tokens"].shape[1]
    assert got.shape == (B, S, mm["cfg_t"].padded_vocab)
    assert float(aux) == 0.0
    close(got, want, MODEL_TOL)


def test_prefill_and_decode_match_reference(mm):
    check_prefill_decode(mm, B, 24, seed=1)


@pytest.mark.parametrize("seq", [8, 48])
def test_prefill_then_decode_matches_full_forward(mm, seq):
    _, bt = batches(mm, B, seq, seed=2)
    check_decode_matches_forward(mm["cfg_t"], mm["params"], bt)


def test_labels_and_mask_match_reference(mm):
    """For vlm the patch prefix is unsupervised and position P - 1 predicts
    the first text token; for audio the decoder's next tokens."""
    bj, bt = batches(mm, B, 48, seed=3)
    S = 48 if mm["cfg_t"].family == "vlm" else bt["tokens"].shape[1]
    lj, mj = jax_model._labels_and_mask(mm["cfg_j"], bj, S)
    lt, mt = torch_model._labels_and_mask(mm["cfg_t"], bt, S, "cpu")
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))


def test_loss_and_grads_match_reference(mm):
    check_loss_and_grads(mm, B, 48, seed=4)


def test_generate_greedy_matches_reference(mm):
    bj, bt = batches(mm, B, 24, seed=5)
    want = jax_serve.generate(mm["tree"], mm["cfg_j"], bj, 6, max_seq=40)
    got = torch_serve.generate(mm["params"], mm["cfg_t"], bt, 6, max_seq=40)
    assert got.shape == (B, 6) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_audio_decode_state_needs_the_encoder_output(mm):
    if mm["cfg_t"].family != "audio":
        assert torch_tf.init_decode_state(mm["cfg_t"], B, 8,
                                          device="cpu").enc is None
        return
    with pytest.raises(ValueError, match="encoder output"):
        torch_tf.init_decode_state(mm["cfg_t"], B, 8, device="cpu")


def test_vlm_bf16_projects_the_patches_in_float32():
    """A bf16 pixtral-smoke: the float32 patches meet the bf16 projection
    in a float32 product (the reference's promotion), cast once to bf16,
    where a bf16 product would round the operands first."""
    m = model(VLM, seed=4)
    ct = dataclasses.replace(m["cfg_t"], dtype="bfloat16")
    p = torch_tf.params_from_jax(m["tree"], ct, "cpu")
    _, bt = batches(m, B, 48, seed=6)
    x = torch.zeros((B, 0, ct.d_model), dtype=torch.bfloat16)
    got = torch_model._with_patches(p, bt, x)
    assert got.dtype == torch.bfloat16
    w = p["patch_proj"]["w"].float()
    want = (bt["patches"] @ w).to(torch.bfloat16)
    assert torch.equal(got, want)
    logits, _ = torch_tf.forward(p, ct, bt)
    assert torch.isfinite(logits.float()).all()


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_llm_server_refuses_vlm_and_audio(arch):
    """Their requests need patches or frames beside the prompt, which a
    token-prompt server cannot build: refused at construction with an
    error naming generate(), where the reference's LLMServer would fail
    later, in prefill."""
    m = model(arch, seed=0)
    with pytest.raises(ValueError, match="generate"):
        torch_serve.LLMServer(m["params"], m["cfg_t"], device="cpu")
