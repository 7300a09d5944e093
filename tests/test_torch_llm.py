"""The port's LLM serving against the JAX package's, on the CPU, at
the RWKV6 smoke size with the reference's parameters converted.

Greedy tokens must be equal: the logits agree to a few 1e-6 (test_torch_
rwkv6.py), far inside the margins between the top logits of these prompts,
and both argmaxes take the first maximal index. The server's batching is
the same loop in both packages, drained with ``pump()``, so both see the
same micro-batches and the same pow2 buckets.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jax_configs
import repro.data as jax_data
import repro.launch.serve as jax_serve
import repro.models.transformer as jax_tf
import repro_torch.configs as torch_configs
import repro_torch.data as torch_data
import repro_torch.launch.serve as torch_serve
import repro_torch.models.transformer as torch_tf
from repro_torch.kernels import linattn as cuda_linattn


@pytest.fixture(scope="module")
def model():
    cfg_j = jax_configs.smoke_variant(jax_configs.get_config("rwkv6-7b"))
    cfg_t = torch_configs.smoke_variant(torch_configs.get_config("rwkv6-7b"))
    tree = jax_tf.init_params(jax.random.PRNGKey(1), cfg_j)
    rng = np.random.default_rng(1)
    blk = tree["layers"]["blk"]
    blk["u"] = jnp.asarray(rng.standard_normal(blk["u"].shape), jnp.float32)
    return dict(cfg_j=cfg_j, cfg_t=cfg_t, tree=tree,
                params=torch_tf.params_from_jax(tree, cfg_t, "cpu"))


def _drain(srv, tickets):
    while not all(t.done() for t in tickets):
        srv.pump(wait_s=0.0)
    return [t.wait(1.0) for t in tickets]


@pytest.mark.parametrize("seq", [8, 24])
def test_generate_greedy_matches_reference(model, seq):
    bj = jax_data.make_batch(model["cfg_j"], 2, seq, seed=3)
    bt = torch_data.make_batch(model["cfg_t"], 2, seq, seed=3)
    want = jax_serve.generate(model["tree"], model["cfg_j"], bj, 6,
                              max_seq=seq + 14)
    got = torch_serve.generate(model["params"], model["cfg_t"], bt, 6,
                               max_seq=seq + 14)
    assert got.dtype == torch.int32 and got.shape == (2, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_llm_server_matches_reference(model):
    """Prompts of mixed lengths through both servers: the same greedy
    tokens per prompt (short prompts padded into the batch's bucket, as the
    reference pads them), and the same loop statistics."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, model["cfg_t"].vocab_size, n)
               for n in (8, 5, 13, 8, 3)]
    sj = jax_serve.LLMServer(model["tree"], model["cfg_j"], gen_tokens=4,
                             max_batch=4, name="llm-ref")
    st = torch_serve.LLMServer(model["params"], model["cfg_t"], gen_tokens=4,
                               max_batch=4, name="llm-port", device="cpu")
    cuda_linattn.reset_launches()
    want = _drain(sj, [sj.submit(p) for p in prompts])
    got = _drain(st, [st.submit(p) for p in prompts])
    for g, w in zip(got, want):
        assert g.shape == (4,) and g.dtype == np.int32
        np.testing.assert_array_equal(g, w)
    stats = st.stats()
    assert stats["served"] == 5 and stats["errors"] == 0
    assert stats["batches"] == sj.stats()["batches"] == 2
    assert stats["buckets"] == {(4, 16): 1, (1, 8): 1}
    assert cuda_linattn.launches == {"linattn": 0}      # CPU: plain version


def test_llm_server_background_loop(model):
    st = torch_serve.LLMServer(model["params"], model["cfg_t"], gen_tokens=3,
                               max_batch=2, device="cpu").start()
    try:
        tickets = [st.submit(np.arange(1, 7) + i) for i in range(3)]
        outs = [t.wait(60.0) for t in tickets]
    finally:
        st.stop()
    assert all(o.shape == (3,) and o.dtype == np.int32 for o in outs)
    assert all(((0 <= o) & (o < model["cfg_t"].vocab_size)).all()
               for o in outs)
    assert st.stats()["served"] == 3 and st.stats()["errors"] == 0


def test_sampling_is_seeded(model):
    batch = torch_data.make_batch(model["cfg_t"], 3, 16, seed=5)
    runs = [torch_serve.generate(model["params"], model["cfg_t"], batch, 5,
                                 max_seq=32, greedy=False, seed=s)
            for s in (9, 9, 10)]
    assert torch.equal(runs[0], runs[1])
    assert all(((0 <= r) & (r < model["cfg_t"].vocab_size)).all()
               for r in runs)


def test_server_refuses_params_on_another_device(model):
    with pytest.raises(ValueError, match="params lie on"):
        torch_serve.LLMServer(model["params"], model["cfg_t"],
                              device="meta")
