"""The port's RWKV6 model against the JAX package's, at the smoke size
(``smoke_variant(get_config("rwkv6-7b"))``, float32: 2 layers, d_model 256,
head dim 32), on the reference's own parameters converted with
``params_from_jax``. The reference's init leaves ``u`` at 0 and ``mu`` at
0.5, which would hide the bonus term and the token-shift lerp, so both are
perturbed with seeded numpy noise before the tree goes to both packages.

Logits and states match at 1e-4: float32 summation order in the chunked
attention and the matmuls only (measured: a few 1e-6 on logits up to ~1.2,
up to 8e-5 on states of magnitude ~100).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jax_configs
import repro.data as jax_data
import repro.models.transformer as jax_tf
import repro_torch.configs as torch_configs
import repro_torch.data as torch_data
import repro_torch.models.transformer as torch_tf
from repro_torch.kernels import linattn as cuda_linattn

TOL = dict(rtol=1e-4, atol=1e-4)
B, S = 2, 24


@pytest.fixture(scope="module")
def model():
    cfg_j = jax_configs.smoke_variant(jax_configs.get_config("rwkv6-7b"))
    cfg_t = torch_configs.smoke_variant(torch_configs.get_config("rwkv6-7b"))
    tree = jax_tf.init_params(jax.random.PRNGKey(0), cfg_j)
    rng = np.random.default_rng(0)
    blk = tree["layers"]["blk"]
    blk["u"] = jnp.asarray(rng.standard_normal(blk["u"].shape), jnp.float32)
    for name in ("mu", "mu_c"):
        blk[name] = jnp.asarray(rng.random(blk[name].shape), jnp.float32)
    params = torch_tf.params_from_jax(tree, cfg_t, "cpu")
    return dict(cfg_j=cfg_j, cfg_t=cfg_t, tree=tree, params=params,
                batch_j=jax_data.make_batch(cfg_j, B, S, seed=0),
                batch_t=torch_data.make_batch(cfg_t, B, S, seed=0))


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("smoke", [False, True])
def test_configs_match_reference(smoke):
    """The published config and its smoke variant carry every field of the
    reference's, and the same parameter count."""
    ref_cfg = jax_configs.get_config("rwkv6-7b")
    cfg = torch_configs.get_config("rwkv6-7b")
    if smoke:
        ref_cfg = jax_configs.smoke_variant(ref_cfg)
        cfg = torch_configs.smoke_variant(cfg)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    assert cfg.param_count() == ref_cfg.param_count()


def test_published_size_and_registry():
    """7.6 B parameters within the reference's own bounds
    (tests/test_configs_and_launch.py), bf16, and the registry listing the
    reference's ten architectures, in its order."""
    full = torch_configs.get_config("rwkv6-7b")
    assert 0.65 * 7.6 <= full.param_count() / 1e9 <= 1.45 * 7.6
    assert full.activation_dtype == torch.bfloat16
    assert torch_configs.ARCH_IDS == jax_configs.ARCH_IDS
    assert len(torch_configs.ARCH_IDS) == 10


@pytest.mark.parametrize("batch,seq,seed", [(2, 24, 0), (3, 64, 7),
                                            (1, 2, 123)])
def test_make_batch_tokens_bitwise(model, batch, seq, seed):
    want = np.asarray(jax_data.make_batch(model["cfg_j"], batch, seq,
                                          seed)["tokens"])
    got = torch_data.make_batch(model["cfg_t"], batch, seq, seed)["tokens"]
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    j_stream = jax_data.token_batches(model["cfg_j"], batch, seq, 2, seed)
    t_stream = torch_data.token_batches(model["cfg_t"], batch, seq, 2, seed)
    for bj, bt in zip(j_stream, t_stream):
        np.testing.assert_array_equal(bt["tokens"].numpy(),
                                      np.asarray(bj["tokens"]))


def test_params_from_jax_copies_values_and_dtypes(model):
    p, tree = model["params"], model["tree"]
    assert len(p["layers"]) == model["cfg_t"].num_layers
    np.testing.assert_array_equal(p["embed"].numpy(),
                                  np.asarray(tree["embed"]))
    for i, layer in enumerate(p["layers"]):
        for name in ("wr", "ck", "w_lora_b"):
            np.testing.assert_array_equal(
                layer["blk"][name]["w"].numpy(),
                np.asarray(tree["layers"]["blk"][name]["w"][i]))
        assert layer["blk"]["w_base"].dtype == torch.float32
    bf = dataclasses.replace(model["cfg_t"], dtype="bfloat16")
    pb = torch_tf.params_from_jax(tree, bf, "cpu")
    assert pb["embed"].dtype == torch.bfloat16
    assert pb["layers"][0]["blk"]["u"].dtype == torch.float32
    assert pb["layers"][0]["blk"]["w_base"].dtype == torch.float32


def test_forward_matches_reference(model):
    want, _ = jax_tf.forward(model["tree"], model["cfg_j"], model["batch_j"])
    got, aux = torch_tf.forward(model["params"], model["cfg_t"],
                                model["batch_t"])
    assert got.shape == (B, S, model["cfg_t"].padded_vocab)
    assert float(aux) == 0.0
    _close(got, want)


def test_prefill_matches_reference(model):
    """Last-token logits and every field of every layer's state."""
    cuda_linattn.reset_launches()
    want, st_j = jax_tf.prefill(model["tree"], model["cfg_j"],
                                model["batch_j"], max_seq=S + 8)
    got, st_t = torch_tf.prefill(model["params"], model["cfg_t"],
                                 model["batch_t"], max_seq=S + 8)
    _close(got, want)
    assert len(st_t.caches) == model["cfg_t"].num_layers
    for i, layer in enumerate(st_t.caches):
        for field in ("s", "tm_x", "cm_x"):
            _close(getattr(layer, field), getattr(st_j.caches, field)[i])
    assert cuda_linattn.launches == {"linattn": 0}      # CPU: plain version


def test_decode_step_matches_reference(model):
    _, st_j = jax_tf.prefill(model["tree"], model["cfg_j"], model["batch_j"],
                             max_seq=S + 8)
    _, st_t = torch_tf.prefill(model["params"], model["cfg_t"],
                               model["batch_t"], max_seq=S + 8)
    nxt = np.array([3, 7], np.int32)
    want, st_j = jax_tf.decode_step(model["tree"], model["cfg_j"],
                                    jnp.asarray(nxt), st_j)
    got, st_t = torch_tf.decode_step(model["params"], model["cfg_t"],
                                     torch.from_numpy(nxt), st_t)
    assert got.shape == (B, model["cfg_t"].padded_vocab)
    _close(got, want)
    for i, layer in enumerate(st_t.caches):
        _close(layer.s, st_j.caches.s[i])


def test_zero_decode_state_then_decode_matches_reference(model):
    st_j = jax_tf.init_decode_state(model["cfg_j"], B, S)
    st_t = torch_tf.init_decode_state(model["cfg_t"], B, S, device="cpu")
    nxt = np.array([11, 5], np.int32)
    want, _ = jax_tf.decode_step(model["tree"], model["cfg_j"],
                                 jnp.asarray(nxt), st_j)
    got, _ = torch_tf.decode_step(model["params"], model["cfg_t"],
                                  torch.from_numpy(nxt), st_t)
    _close(got, want)


@pytest.mark.parametrize("seq", [24, 64, 96])
def test_prefill_then_decode_matches_full_forward(model, seq):
    """The port against itself, as tests/test_arch_smoke.py holds the
    reference: prefill of ``seq`` tokens equals the full forward's last
    position, and one decode step after it equals the forward over
    ``seq + 1`` tokens. seq 24, 64 and 96 take chunk 24, 64 and 1."""
    cfg, params = model["cfg_t"], model["params"]
    batch = torch_data.make_batch(cfg, B, seq, seed=1)
    last, state = torch_tf.prefill(params, cfg, batch, max_seq=seq + 8)
    full, _ = torch_tf.forward(params, cfg, batch)
    np.testing.assert_allclose(last.numpy(), full[:, -1].numpy(),
                               rtol=2e-3, atol=2e-3)
    nxt = torch.tensor([3, 7], dtype=torch.int32)
    dl, _ = torch_tf.decode_step(params, cfg, nxt, state)
    ext = {"tokens": torch.cat([batch["tokens"], nxt[:, None]], 1)}
    full2, _ = torch_tf.forward(params, cfg, ext)
    np.testing.assert_allclose(dl.numpy(), full2[:, -1].numpy(),
                               rtol=5e-3, atol=5e-3)


def _leaves(node, prefix=""):
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, node


def test_init_params_is_seeded_and_shaped_like_reference(model):
    """Same seed, same draws; every leaf has the reference's shape (less the
    stacked layer axis) and the reference's dtype."""
    cfg = model["cfg_t"]
    a = torch_tf.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    b = torch_tf.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    want = dict(_leaves({k: v for k, v in model["tree"].items()
                         if k != "layers"}))
    for i in range(cfg.num_layers):
        want.update({f"/layers/{i}{k}": v[i] for k, v in
                     _leaves(model["tree"]["layers"])})
    got = dict(_leaves({**{k: v for k, v in a.items() if k != "layers"},
                        "layers": dict(enumerate(a["layers"]))}))
    same = dict(_leaves({**{k: v for k, v in b.items() if k != "layers"},
                         "layers": dict(enumerate(b["layers"]))}))
    assert got.keys() == want.keys()
    for name, t in got.items():
        assert tuple(t.shape) == tuple(want[name].shape), name
        assert str(t.dtype).split(".")[-1] == str(want[name].dtype), name
        assert torch.equal(t, same[name]), name
