"""The port's dense transformer family against the JAX package's, on the
CPU: GQA attention (full, windowed, continued, chunked, decoded from a ring
cache), the MLPs, RoPE, the four dense configs, and the smoke models'
forward, prefill + decode and greedy serving on the reference's own
parameters converted with ``params_from_jax``.

Inputs come from numpy seeds and go to both packages as the same float32
values. The reference's init leaves every bias at 0 and every norm gain at
1, which would hide them, so the trees are perturbed with seeded noise
first. Tolerances: attention and the MLPs at 1e-5 and RoPE at 1e-6 (float32
summation order and transcendentals only); smoke-model logits at 1e-4, as
the RWKV6 smoke model is held (tests/test_torch_rwkv6.py).
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
from repro.models.transformer import attention as jax_attn
from repro.models.transformer import common as jax_common
from repro.models.transformer import mlp as jax_mlp
import repro_torch.configs as torch_configs
import repro_torch.data as torch_data
import repro_torch.launch.serve as torch_serve
import repro_torch.models.transformer as torch_tf
from repro_torch.kernels import gather_agg as cuda_ga
from repro_torch.kernels import linattn as cuda_linattn
from repro_torch.models.transformer import attention as torch_attn
from repro_torch.models.transformer import common as torch_common
from repro_torch.models.transformer import mlp as torch_mlp

DENSE = ["qwen2-1.5b", "qwen2.5-3b", "h2o-danube-3-4b", "nemotron-4-340b"]
TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
B = 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread in this worker (the suite runs in several)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got: torch.Tensor, want, tol=TOL) -> None:
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def _perturb(tree, rng):
    """Biases to seeded noise, norm gains to 1 + noise, leaf by leaf."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = _perturb(v, rng)
            elif k == "b":
                out[k] = jnp.asarray(0.1 * rng.standard_normal(v.shape),
                                     v.dtype)
            elif k == "g":
                out[k] = jnp.asarray(1 + 0.1 * rng.standard_normal(v.shape),
                                     v.dtype)
            else:
                out[k] = v
        return out
    return tree


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, np.float32))


def _cfgs(arch, **kw):
    cj = jax_configs.smoke_variant(jax_configs.get_config(arch))
    ct = torch_configs.smoke_variant(torch_configs.get_config(arch))
    return dataclasses.replace(cj, **kw), dataclasses.replace(ct, **kw)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _qkv(rng, b, sq, skv, h, kh, dh):
    q = rng.standard_normal((b, sq, h, dh)).astype(np.float32)
    k = rng.standard_normal((b, skv, kh, dh)).astype(np.float32)
    v = rng.standard_normal((b, skv, kh, dh)).astype(np.float32)
    return q, k, v


ATTEND_CASES = {
    "causal, chunk 16 pads 40": dict(sq=40, skv=40, kw=dict(kv_chunk=16)),
    "causal, one chunk": dict(sq=40, skv=40, kw=dict()),
    "window 8, chunk 16": dict(sq=40, skv=40,
                               kw=dict(window=8, kv_chunk=16)),
    "window 24, chunk 7": dict(sq=40, skv=40,
                               kw=dict(window=24, kv_chunk=7)),
    "q_offset 16, chunk 16": dict(sq=24, skv=40,
                                  kw=dict(q_offset=16, kv_chunk=16)),
    "q_offset 9, window 12, chunk 10": dict(
        sq=31, skv=40, kw=dict(q_offset=9, window=12, kv_chunk=10)),
    "not causal, chunk 12": dict(sq=24, skv=40,
                                 kw=dict(causal=False, kv_chunk=12)),
}


@pytest.mark.parametrize("groups", [1, 2, 4])
@pytest.mark.parametrize("case", list(ATTEND_CASES))
def test_attend_full_matches_reference(case, groups):
    c = ATTEND_CASES[case]
    rng = np.random.default_rng(groups)
    h, dh = 4, 16
    q, k, v = _qkv(rng, B, c["sq"], c["skv"], h, h // groups, dh)
    want = jax_attn.attend_full(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), **c["kw"])
    got = torch_attn.attend_full(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), **c["kw"])
    assert got.shape == (B, c["sq"], h, dh) and got.dtype == torch.float32
    _close(got, want)


def test_attend_full_keeps_bf16_storage():
    """bf16 q/k/v: scores and accumulator in float32, the result cast back
    to bf16, within a bf16 rounding of the reference's."""
    rng = np.random.default_rng(5)
    q, k, v = _qkv(rng, B, 24, 24, 4, 2, 16)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    want = jax_attn.attend_full(jq, jk, jv, kv_chunk=16)
    got = torch_attn.attend_full(tq, tk, tv, kv_chunk=16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=1e-2, atol=1e-2)


def test_cache_append_is_bitwise_through_a_ring_wraparound():
    """A 5-slot ring (window 5) fed 12 tokens: every cache state after each
    append equals the reference's bit for bit."""
    rng = np.random.default_rng(0)
    cj = jax_attn.init_kv_cache(B, 32, 2, 8, jnp.float32, window=5)
    ct = torch_attn.init_kv_cache(B, 32, 2, 8, torch.float32, window=5)
    assert ct.k.shape == (B, 5, 2, 8) and ct.pos == 0
    for _ in range(12):
        kn = rng.standard_normal((B, 1, 2, 8)).astype(np.float32)
        vn = rng.standard_normal((B, 1, 2, 8)).astype(np.float32)
        cj = jax_attn.cache_append(cj, jnp.asarray(kn), jnp.asarray(vn))
        before = ct.k.clone()
        ct2 = torch_attn.cache_append(ct, torch.from_numpy(kn),
                                      torch.from_numpy(vn))
        assert torch.equal(ct.k, before)          # the old cache is kept
        ct = ct2
        np.testing.assert_array_equal(ct.k.numpy(), np.asarray(cj.k))
        np.testing.assert_array_equal(ct.v.numpy(), np.asarray(cj.v))
        assert ct.pos == int(cj.pos)


@pytest.mark.parametrize("pos", [3, 9, 16])
@pytest.mark.parametrize("groups", [1, 2, 4])
def test_attend_decode_matches_reference(pos, groups):
    """One query against a 9-slot cache, partly filled (pos 3), full
    (pos 9) and wrapped (pos 16)."""
    rng = np.random.default_rng(pos)
    h, dh = 4, 16
    q, k, v = _qkv(rng, B, 1, 9, h, h // groups, dh)
    cj = jax_attn.KVCache(k=jnp.asarray(k), v=jnp.asarray(v),
                          pos=jnp.asarray(pos, jnp.int32))
    ct = torch_attn.KVCache(k=torch.from_numpy(k), v=torch.from_numpy(v),
                            pos=pos)
    want = jax_attn.attend_decode(jnp.asarray(q), cj)
    got = torch_attn.attend_decode(torch.from_numpy(q), ct)
    _close(got, want)


@pytest.fixture(scope="module")
def attn_block():
    """qwen2-smoke's attention (QKV bias, 4 query / 2 KV heads) with
    kv_tp_repeat 2, its weights from the reference's init and its biases
    perturbed."""
    cj, ct = _cfgs("qwen2-1.5b", kv_tp_repeat=2)
    pj = _perturb(jax_attn.init_attn(jax.random.PRNGKey(3), cj, jnp.float32),
                  np.random.default_rng(3))
    return cj, ct, pj, _to_torch(pj)


def test_attn_forward_with_bias_and_kv_repeat_matches_reference(attn_block):
    cj, ct, pj, pt = attn_block
    assert ct.qkv_bias and ct.kv_tp_repeat == 2
    x = np.random.default_rng(1).standard_normal(
        (B, 20, ct.d_model)).astype(np.float32)
    pos = np.arange(20)
    want = jax_attn.attn_forward(pj, cj, jnp.asarray(x), jnp.asarray(pos),
                                 kv_chunk=8)
    got = torch_attn.attn_forward(pt, ct, torch.from_numpy(x),
                                  torch.from_numpy(pos), kv_chunk=8)
    _close(got, want)
    plain = dataclasses.replace(ct, kv_tp_repeat=1)
    _close(torch_attn.attn_forward(pt, plain, torch.from_numpy(x),
                                   torch.from_numpy(pos), kv_chunk=8), want)


def test_attn_decode_matches_reference(attn_block):
    """Four decode steps from an empty 3-slot ring (window 3): outputs at
    1e-5, caches bitwise up to the projections' rounding."""
    cj, ct, pj, pt = attn_block
    cache_j = jax_attn.init_kv_cache(B, 16, ct.num_kv_heads, ct.hdim,
                                     jnp.float32, window=3)
    cache_t = torch_attn.init_kv_cache(B, 16, ct.num_kv_heads, ct.hdim,
                                       torch.float32, window=3)
    rng = np.random.default_rng(2)
    for _ in range(4):
        x = rng.standard_normal((B, 1, ct.d_model)).astype(np.float32)
        want, cache_j = jax_attn.attn_decode(pj, cj, jnp.asarray(x), cache_j,
                                             window=3)
        got, cache_t = torch_attn.attn_decode(pt, ct, torch.from_numpy(x),
                                              cache_t, window=3)
        _close(got, want)
        _close(cache_t.k, cache_j.k)
        assert cache_t.pos == int(cache_j.pos)


# ---------------------------------------------------------------------------
# small functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["swiglu", "sqrelu", "gelu"])
def test_mlp_forward_matches_reference(kind):
    pj = jax_mlp.init_mlp(jax.random.PRNGKey(4), 64, 96, kind, jnp.float32)
    pt = _to_torch(pj)
    assert set(pt) == {"wg", "wu", "wd"} if kind == "swiglu" \
        else set(pt) == {"wu", "wd"}
    x = np.random.default_rng(4).standard_normal((B, 7, 64)).astype(
        np.float32)
    _close(torch_mlp.mlp_forward(pt, torch.from_numpy(x), kind),
           jax_mlp.mlp_forward(pj, jnp.asarray(x), kind))
    with pytest.raises(ValueError):
        torch_mlp.mlp_forward(pt, torch.from_numpy(x), "relu")


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
@pytest.mark.parametrize("dh", [16, 64, 128])
def test_apply_rope_matches_reference(theta, dh):
    rng = np.random.default_rng(dh)
    x = rng.standard_normal((B, 48, 3, dh)).astype(np.float32)
    pos = np.arange(100, 148)
    want = jax_common.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = torch_common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                                  theta)
    _close(got, want, dict(rtol=1e-6, atol=1e-6))
    # the frequencies agree to one float32 ulp: torch's and XLA's pow may
    # round one of them differently (measured at dh 128, theta 1e6: 8.6e-8
    # relative)
    np.testing.assert_allclose(
        torch_common.rope_freqs(dh, theta).numpy(),
        np.asarray(jax_common.rope_freqs(dh, theta)), rtol=2 ** -23, atol=0)


def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(6)
    logits = rng.standard_normal((B, 9, 50)).astype(np.float32) * 3
    labels = rng.integers(0, 50, (B, 9)).astype(np.int32)
    mask = rng.random((B, 9)) < 0.7
    for m in (None, mask):
        want = jax_common.cross_entropy(
            jnp.asarray(logits), jnp.asarray(labels),
            None if m is None else jnp.asarray(m))
        got = torch_common.cross_entropy(
            torch.from_numpy(logits), torch.from_numpy(labels),
            None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", DENSE)
def test_dense_configs_match_reference(arch, smoke):
    """Every field of the published config and of its smoke variant equals
    the reference's, and so does the parameter count."""
    ref_cfg = jax_configs.get_config(arch)
    cfg = torch_configs.get_config(arch)
    if smoke:
        ref_cfg = jax_configs.smoke_variant(ref_cfg)
        cfg = torch_configs.smoke_variant(cfg)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    assert cfg.param_count() == ref_cfg.param_count()
    assert cfg.family == "dense"


# ---------------------------------------------------------------------------
# the smoke models
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=DENSE)
def model(request):
    cj, ct = _cfgs(request.param)
    tree = _perturb(jax_tf.init_params(jax.random.PRNGKey(0), cj),
                    np.random.default_rng(0))
    return dict(cfg_j=cj, cfg_t=ct, tree=tree,
                params=torch_tf.params_from_jax(tree, ct, "cpu"))


def test_params_from_jax_copies_dense_values_and_dtypes(model):
    p, tree, ct = model["params"], model["tree"], model["cfg_t"]
    assert len(p["layers"]) == ct.num_layers
    for i, layer in enumerate(p["layers"]):
        np.testing.assert_array_equal(
            layer["attn"]["wq"]["w"].numpy(),
            np.asarray(tree["layers"]["attn"]["wq"]["w"][i]))
        np.testing.assert_array_equal(
            layer["mlp"]["wd"]["w"].numpy(),
            np.asarray(tree["layers"]["mlp"]["wd"]["w"][i]))
        assert ("b" in layer["attn"]["wk"]) == ct.qkv_bias
    bf = dataclasses.replace(ct, dtype="bfloat16")
    pb = torch_tf.params_from_jax(model["tree"], bf, "cpu")
    assert pb["layers"][0]["attn"]["wq"]["w"].dtype == torch.bfloat16
    assert pb["norm_f"]["g"].dtype == torch.bfloat16


def _paths(node, prefix=""):
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _paths(v, f"{prefix}/{k}")
    else:
        yield prefix, node


def test_init_params_dense_shapes_like_reference(model):
    """Seeded: the same generator seed draws the same tensors; every leaf
    of every layer has the reference's shape (less the stacked layer axis)
    and dtype."""
    ct, tree = model["cfg_t"], model["tree"]
    a = torch_tf.init_params(ct, torch.Generator().manual_seed(3), "cpu")
    b = torch_tf.init_params(ct, torch.Generator().manual_seed(3), "cpu")
    top = {k: v for k, v in tree.items() if k != "layers"}
    want = {n: v.shape for n, v in _paths(top)}
    want.update({f"/layers{n}": v.shape[1:]
                 for n, v in _paths(tree["layers"])})
    for i in range(ct.num_layers):
        got = dict(_paths({k: v for k, v in a.items() if k != "layers"}))
        got.update({f"/layers{n}": v for n, v in _paths(a["layers"][i])})
        assert got.keys() == want.keys()
        for name, t in got.items():
            assert tuple(t.shape) == tuple(want[name]), name
            assert t.dtype == torch.float32, name
    for la, lb in zip(a["layers"], b["layers"]):
        for (_, ta), (_, tb) in zip(_paths(la), _paths(lb)):
            assert torch.equal(ta, tb)


def test_forward_matches_reference(model):
    S = 24
    bj = jax_data.make_batch(model["cfg_j"], B, S, seed=0)
    bt = torch_data.make_batch(model["cfg_t"], B, S, seed=0)
    want, _ = jax_tf.forward(model["tree"], model["cfg_j"], bj)
    got, aux = torch_tf.forward(model["params"], model["cfg_t"], bt)
    assert got.shape == (B, S, model["cfg_t"].padded_vocab)
    assert float(aux) == 0.0
    _close(got, want, MODEL_TOL)


def test_prefill_and_decode_match_reference(model):
    """Prefill of S tokens (longer than danube-smoke's 64-token window, so
    its ring is filled and rolled) and then three decode steps: logits and
    every layer's cache against the reference's."""
    S = 80
    cj, ct = model["cfg_j"], model["cfg_t"]
    bj = jax_data.make_batch(cj, B, S, seed=1)
    bt = torch_data.make_batch(ct, B, S, seed=1)
    want, st_j = jax_tf.prefill(model["tree"], cj, bj, max_seq=S + 8)
    got, st_t = torch_tf.prefill(model["params"], ct, bt, max_seq=S + 8)
    _close(got, want, MODEL_TOL)
    length = min(S + 8, ct.swa_window or S + 8)
    for i, c in enumerate(st_t.caches):
        assert c.k.shape == (B, length, ct.num_kv_heads, ct.hdim)
        assert c.pos == S == int(st_j.caches.pos[i])
        _close(c.k, st_j.caches.k[i], MODEL_TOL)
        _close(c.v, st_j.caches.v[i], MODEL_TOL)
    for nxt in ([3, 7], [11, 5], [2, 9]):
        nxt = np.array(nxt, np.int32)
        want, st_j = jax_tf.decode_step(model["tree"], cj, jnp.asarray(nxt),
                                        st_j)
        got, st_t = torch_tf.decode_step(model["params"], ct,
                                         torch.from_numpy(nxt), st_t)
        assert got.shape == (B, ct.padded_vocab)
        _close(got, want, MODEL_TOL)


@pytest.mark.parametrize("seq", [24, 80])
def test_prefill_then_decode_matches_full_forward(model, seq):
    """The port against itself, as tests/test_arch_smoke.py holds the
    reference: prefill equals the forward's last position, and a decode
    step after it equals the forward over seq + 1 tokens (at seq 80 past
    danube-smoke's window, through the rolled ring)."""
    cfg, params = model["cfg_t"], model["params"]
    batch = torch_data.make_batch(cfg, B, seq, seed=2)
    last, state = torch_tf.prefill(params, cfg, batch, max_seq=seq + 8)
    full, _ = torch_tf.forward(params, cfg, batch)
    _close(last, full[:, -1], MODEL_TOL)
    nxt = torch.tensor([3, 7], dtype=torch.int32)
    dl, _ = torch_tf.decode_step(params, cfg, nxt, state)
    ext = {"tokens": torch.cat([batch["tokens"], nxt[:, None]], 1)}
    full2, _ = torch_tf.forward(params, cfg, ext)
    _close(dl, full2[:, -1], MODEL_TOL)


def test_zero_decode_state_then_decode_matches_reference(model):
    cj, ct = model["cfg_j"], model["cfg_t"]
    st_j = jax_tf.init_decode_state(cj, B, 16)
    st_t = torch_tf.init_decode_state(ct, B, 16, device="cpu")
    assert all(c.pos == 0 for c in st_t.caches)
    nxt = np.array([11, 5], np.int32)
    want, _ = jax_tf.decode_step(model["tree"], cj, jnp.asarray(nxt), st_j)
    got, _ = torch_tf.decode_step(model["params"], ct, torch.from_numpy(nxt),
                                  st_t)
    _close(got, want, MODEL_TOL)


# ---------------------------------------------------------------------------
# serving qwen2-smoke
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def qwen2():
    cj, ct = _cfgs("qwen2-1.5b")
    tree = _perturb(jax_tf.init_params(jax.random.PRNGKey(1), cj),
                    np.random.default_rng(1))
    return dict(cfg_j=cj, cfg_t=ct, tree=tree,
                params=torch_tf.params_from_jax(tree, ct, "cpu"))


def _drain(srv, tickets):
    while not all(t.done() for t in tickets):
        srv.pump(wait_s=0.0)
    return [t.wait(1.0) for t in tickets]


@pytest.mark.parametrize("seq", [8, 24])
def test_generate_greedy_matches_reference(qwen2, seq):
    bj = jax_data.make_batch(qwen2["cfg_j"], B, seq, seed=3)
    bt = torch_data.make_batch(qwen2["cfg_t"], B, seq, seed=3)
    want = jax_serve.generate(qwen2["tree"], qwen2["cfg_j"], bj, 6,
                              max_seq=seq + 14)
    got = torch_serve.generate(qwen2["params"], qwen2["cfg_t"], bt, 6,
                               max_seq=seq + 14)
    assert got.dtype == torch.int32 and got.shape == (B, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_llm_server_matches_reference(qwen2):
    """Prompts of mixed lengths through both servers: the same greedy tokens
    per prompt, the same batches and buckets, and no kernel launched (the
    dense path runs none)."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, qwen2["cfg_t"].vocab_size, n)
               for n in (8, 5, 13, 8, 3)]
    sj = jax_serve.LLMServer(qwen2["tree"], qwen2["cfg_j"], gen_tokens=4,
                             max_batch=4, name="llm-ref-dense")
    st = torch_serve.LLMServer(qwen2["params"], qwen2["cfg_t"], gen_tokens=4,
                               max_batch=4, name="llm-port-dense",
                               device="cpu")
    cuda_linattn.reset_launches()
    cuda_ga.reset_launches()
    want = _drain(sj, [sj.submit(p) for p in prompts])
    got = _drain(st, [st.submit(p) for p in prompts])
    for g, w in zip(got, want):
        assert g.shape == (4,) and g.dtype == np.int32
        np.testing.assert_array_equal(g, w)
    stats = st.stats()
    assert stats["served"] == 5 and stats["errors"] == 0
    assert stats["batches"] == sj.stats()["batches"] == 2
    assert stats["buckets"] == {(4, 16): 1, (1, 8): 1}
    assert cuda_linattn.launches == {"linattn": 0}
    assert cuda_ga.launches == {"gather_rows": 0, "gather_agg": 0}
