"""The port's linear-attention plain versions against the JAX package's, on
the same numpy inputs, at the shapes of tests/test_kernels.py plus T = 24 at
chunk 24 and chunk 1, with u shaped (dk,) and (BH, dk).

The chunked plain version is held against the Pallas kernel in interpret
mode at the reference's 5e-4 (tests/test_kernels.py). The token scan, the
chunked version with an incoming state and the decode step are held at
1e-4: they differ from their counterparts only in float32 summation order
(up to a few 1e-5 on outputs up to ~100). The CUDA kernel runs only on the
card, where chip_smoke.py holds it against the same plain version; its
arithmetic (3xTF32 products, segment scan) is emulated on the CPU at the
end of this file and held against the Pallas kernel at 5e-4.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels.linattn import linattn_chunked as jax_linattn_chunked
from repro.kernels.ref import linattn_ref as jax_linattn_ref
from repro_torch.kernels import linattn as cuda_linattn
from repro_torch.kernels import ops, ref

SHAPES = [(2, 64, 16, 16, 16), (3, 128, 32, 64, 64), (1, 96, 8, 8, 32),
          (2, 24, 16, 16, 24), (2, 24, 16, 16, 1)]
U_SHAPES = ["dk", "bh"]
TIGHT = dict(rtol=1e-4, atol=1e-4)
KERNEL_TOL = dict(rtol=5e-4, atol=5e-4)


def _inputs(BH, T, dk, dv, u_shape, seed=2):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((BH, T, dk)).astype(np.float32)
    k = rng.standard_normal((BH, T, dk)).astype(np.float32)
    v = rng.standard_normal((BH, T, dv)).astype(np.float32)
    w = (0.6 + 0.39 * rng.random((BH, T, dk))).astype(np.float32)
    u = rng.standard_normal((dk,) if u_shape == "dk" else (BH, dk)) \
        .astype(np.float32)
    state = rng.standard_normal((BH, dk, dv)).astype(np.float32)
    return (q, k, v, w, u), state


def _j(xs):
    return [jnp.asarray(x) for x in xs]


def _t(xs):
    return [torch.from_numpy(x) for x in xs]


@pytest.mark.parametrize("u_shape", U_SHAPES)
@pytest.mark.parametrize("BH,T,dk,dv,chunk", SHAPES)
def test_chunked_ref_matches_pallas_kernel(BH, T, dk, dv, chunk, u_shape):
    xs, _ = _inputs(BH, T, dk, dv, u_shape)
    o_j, s_j = jax_linattn_chunked(*_j(xs), chunk=chunk, interpret=True)
    o_t, s_t = ref.linattn_chunked_ref(*_t(xs), chunk=chunk)
    assert o_t.shape == (BH, T, dv) and s_t.shape == (BH, dk, dv)
    assert o_t.dtype == s_t.dtype == torch.float32
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), **KERNEL_TOL)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), **KERNEL_TOL)


@pytest.mark.parametrize("u_shape", U_SHAPES)
@pytest.mark.parametrize("BH,T,dk,dv,chunk", SHAPES)
def test_token_scan_matches_reference(BH, T, dk, dv, chunk, u_shape):
    xs, _ = _inputs(BH, T, dk, dv, u_shape)
    o_j, s_j = jax_linattn_ref(*_j(xs))
    o_t, s_t = ref.linattn_ref(*_t(xs))
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), **TIGHT)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), **TIGHT)


@pytest.mark.parametrize("u_shape", U_SHAPES)
@pytest.mark.parametrize("BH,T,dk,dv,chunk", SHAPES)
def test_chunked_ref_with_state_matches_jnp(BH, T, dk, dv, chunk, u_shape):
    """A nonzero incoming state (the CUDA ops path with a state, and every
    CPU call) against the reference's ``linattn_chunked_jnp``."""
    xs, state = _inputs(BH, T, dk, dv, u_shape)
    o_j, s_j = jax_ops.linattn_chunked_jnp(*_j(xs), state=jnp.asarray(state),
                                           chunk=chunk)
    o_t, s_t = ops.linattn(*_t(xs), state=torch.from_numpy(state),
                           chunk=chunk)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), **TIGHT)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), **TIGHT)


@pytest.mark.parametrize("u_shape", U_SHAPES)
@pytest.mark.parametrize("BH,T,dk,dv,chunk", SHAPES)
def test_decode_step_matches_reference(BH, T, dk, dv, chunk, u_shape):
    """T decode steps from a nonzero state, step for step."""
    (q, k, v, w, u), state = _inputs(BH, T, dk, dv, u_shape)
    s_j, s_t = jnp.asarray(state), torch.from_numpy(state)
    u_j, u_t = jnp.asarray(u), torch.from_numpy(u)
    for t in range(T):
        xs = [x[:, t] for x in (q, k, v, w)]
        o_j, s_j = jax_ops.linattn_step(*_j(xs), u_j, s_j)
        o_t, s_t = ops.linattn_step(*_t(xs), u_t, s_t)
        np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), **TIGHT)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), **TIGHT)


# Outside the documented domain w ∈ (0.5, 1], as measured on the CPU at
# BH 2, T 128, dk = dv = 16. Within a chunk the formulation divides by e,
# the cumulative product of w, which leaves float32 once w^chunk falls
# below its smallest subnormal (1.4e-45). The Pallas kernel in interpret
# mode (XLA on the CPU) flushes subnormals to zero, so it loses a chunk
# sooner, below its smallest normal (1.2e-38); the port's plain version
# keeps subnormals, as PyTorch does on the CPU. (The CUDA kernel outside
# the domain is not measured.)
#   "agrees": every output finite, within 5e-4 of the Pallas kernel and
#             of the token scan (measured at most 7.6e-6 and 5.7e-6);
#   "underflows": 0.1^64 = 1e-64. From step 39 of the first chunk on, the
#             port's outputs go non-finite (the Pallas kernel's from step
#             38, a superset of positions); where the port's are finite
#             they still match the token scan (3.8e-6), while the Pallas
#             kernel's finite ones are up to 4.06 off it. The final state
#             is non-finite in both.
OUTSIDE_DOMAIN = {(0.45, 16): "agrees", (0.45, 64): "agrees",
                  (0.3, 16): "agrees", (0.3, 64): "agrees",
                  (0.1, 16): "agrees", (0.1, 64): "underflows"}


@pytest.mark.parametrize("w0,chunk", sorted(OUTSIDE_DOMAIN))
def test_chunked_ref_outside_the_decay_domain(w0, chunk):
    """The port's plain chunked version at a constant decay w0 below the
    domain, against the Pallas kernel in interpret mode and the token scan,
    pinned as measured (OUTSIDE_DOMAIN)."""
    xs, _ = _inputs(2, 128, 16, 16, "dk")
    xs = (*xs[:3], np.full_like(xs[3], w0), xs[4])
    o_j, s_j = jax_linattn_chunked(*_j(xs), chunk=chunk, interpret=True)
    o_t, s_t = ref.linattn_chunked_ref(*_t(xs), chunk=chunk)
    o_s, _ = ref.linattn_ref(*_t(xs))
    o_j, o_t, o_s = np.asarray(o_j), o_t.numpy(), o_s.numpy()
    fin_j, fin_t = np.isfinite(o_j), np.isfinite(o_t)
    if OUTSIDE_DOMAIN[(w0, chunk)] == "agrees":
        assert fin_t.all() and fin_j.all()
        np.testing.assert_allclose(o_t, o_j, **KERNEL_TOL)
        np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j),
                                   **KERNEL_TOL)
        np.testing.assert_allclose(o_t, o_s, **KERNEL_TOL)
    else:
        # the first non-finite step; the non-finite state then carries
        # into every later chunk
        assert np.nonzero(~fin_t)[1].min() == 39
        assert np.nonzero(~fin_j)[1].min() == 38
        assert not fin_j[~fin_t].any()          # the port's NaNs ⊆ Pallas's
        np.testing.assert_allclose(o_t[fin_t], o_s[fin_t], **KERNEL_TOL)
        assert np.abs(o_j[fin_j] - o_s[fin_j]).max() > 1.0
        assert not np.isfinite(s_t.numpy()).all()
        assert not np.isfinite(np.asarray(s_j)).all()


def test_cpu_dispatch_never_launches():
    """On the CPU ``ops.linattn`` takes the plain chunked version, with or
    without a state, and counts no kernel launch."""
    cuda_linattn.reset_launches()
    xs, state = _inputs(2, 32, 8, 8, "dk")
    o, s = ops.linattn(*_t(xs), chunk=16)
    o_ref, s_ref = ref.linattn_chunked_ref(*_t(xs), chunk=16)
    assert torch.equal(o, o_ref) and torch.equal(s, s_ref)
    ops.linattn(*_t(xs), state=torch.from_numpy(state), chunk=16)
    assert cuda_linattn.launches == {"linattn": 0}


@pytest.mark.parametrize("change,err,match", [
    (dict(chunk=0), ValueError, "chunk"),
    (dict(chunk=65, T=130), ValueError, "chunk"),
    (dict(chunk=48), ValueError, "T % chunk"),
    (dict(dk=80), ValueError, "dk"),
    (dict(dtype=torch.bfloat16), TypeError, "float32"),
    (dict(u_len=5), ValueError, "u must be"),
    (dict(), ValueError, "CUDA"),
])
def test_kernel_wrapper_refuses_what_it_does_not_take(change, err, match):
    """The CUDA wrapper checks its arguments before any build or launch; a
    CPU tensor that passes every other check is refused for not lying on a
    CUDA device. Nothing is counted."""
    cuda_linattn.reset_launches()
    BH, T, dk = 2, change.get("T", 64), change.get("dk", 16)
    dtype = change.get("dtype", torch.float32)
    q = torch.randn(BH, T, dk, dtype=dtype)
    v = torch.randn(BH, T, 8, dtype=dtype)
    u = torch.randn(change.get("u_len", dk), dtype=dtype)
    with pytest.raises(err, match=match):
        cuda_linattn.linattn_chunked(q, q.clone(), v, torch.full_like(q, .9),
                                     u, chunk=change.get("chunk", 64))
    assert cuda_linattn.launches == {"linattn": 0}


def test_library_name_tracks_the_source():
    p = cuda_linattn.library_path()
    assert p.name.startswith("liblinattn-") and p.suffix == ".so"
    assert p.parent == cuda_linattn._build.BUILD_DIR
    assert p == cuda_linattn.library_path()


# ---------------------------------------------------------------------------
# The CUDA kernel's arithmetic, emulated in plain PyTorch on the CPU: the
# tensor-core products in 3xTF32 (and, to show why, in single-pass TF32),
# the two-level decay scan in 8-row segments, reciprocals multiplied, the
# bonus on the scores' diagonal. It lives here only; nothing runs it on a
# path. The hardware's accumulation order inside an mma is not emulated.
# ---------------------------------------------------------------------------

SEG = 8           # rows per scan segment in csrc/linattn.cu (kSegRows)


def _tf32(x):
    """Round float32 to TF32 (10-bit mantissa), to nearest with ties away
    from zero, as ``cvt.rna.tf32.f32``: through the int32 view."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm3(a, b):
    """a @ b as the kernel's mma.sync 3xTF32: lo·hi + hi·lo + hi·hi."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _mm1(a, b):
    """a @ b in single-pass TF32 (rejected for the kernel)."""
    return _tf32(a) @ _tf32(b)


def _emulate_kernel(q, k, v, w, u, chunk, mm=_mm3):
    """What csrc/linattn.cu computes, from a zero state, in float32."""
    bh, T, dk = q.shape
    dv = v.shape[-1]
    S = torch.zeros((bh, dk, dv))
    uf = u.expand(bh, dk)
    idx = torch.arange(chunk)
    strict = idx[None, :] < idx[:, None]
    diag = idx[None, :] == idx[:, None]
    outs = []
    for c0 in range(0, T, chunk):
        qb, kb, vb, wb = (x[:, c0:c0 + chunk] for x in (q, k, v, w))
        tots = []
        for s0 in range(0, chunk, SEG):
            p = torch.ones((bh, dk))
            for t in range(s0, min(s0 + SEG, chunk)):
                p = p * wb[:, t]
            tots.append(p)
        el = torch.ones((bh, dk))
        for p in tots:
            el = el * p
        qd, r = torch.empty_like(qb), torch.empty_like(qb)
        for s0 in range(0, chunk, SEG):
            e = torch.ones((bh, dk))
            for s in range(s0 // SEG):
                e = e * tots[s]
            for t in range(s0, min(s0 + SEG, chunk)):
                qd[:, t] = qb[:, t] * e
                e = e * wb[:, t]
                r[:, t] = 1.0 / e
        kd = kb * r
        kl = kb * (el[:, None, :] * r)
        bonus = ((qb * uf[:, None, :]) * kb).sum(-1)
        att = torch.where(strict, mm(qd, kd.transpose(1, 2)),
                          torch.where(diag, bonus[:, :, None],
                                      torch.zeros(())))
        outs.append(mm(qd, S) + mm(att, vb))
        S = el[:, :, None] * S + mm(kl.transpose(1, 2), vb)
    return torch.cat(outs, 1), S


def _decay_inputs(BH, T, dk, dv, decay, seed):
    """q, k, v, u standard normal; w uniform in (0.5, 1) or RWKV-like,
    exp(-exp(-6 + 0.5 z)) with z standard normal."""
    rng = np.random.default_rng(seed)
    q, k = (rng.standard_normal((BH, T, dk)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((BH, T, dv)).astype(np.float32)
    if decay == "uniform":
        w = 0.5 + 0.5 * rng.random((BH, T, dk))
        w = np.maximum(w, 0.5 + 2 ** -24)
    else:
        w = np.exp(-np.exp(-6 + 0.5 * rng.standard_normal((BH, T, dk))))
    u = rng.standard_normal((BH, dk)).astype(np.float32)
    return q, k, v, w.astype(np.float32), u


@pytest.mark.parametrize("decay", ["uniform", "rwkv"])
def test_kernel_arithmetic_3xtf32_matches_pallas_kernel(decay):
    """The kernel's 3xTF32 arithmetic at the prefill's head shape (dk = dv =
    64, chunk 64) stays within the reference's 5e-4 of the Pallas kernel."""
    xs = _decay_inputs(2, 256, 64, 64, decay, seed=13)
    o_j, s_j = jax_linattn_chunked(*_j(xs), chunk=64, interpret=True)
    o_e, s_e = _emulate_kernel(*_t(xs), chunk=64)
    np.testing.assert_allclose(o_e.numpy(), np.asarray(o_j), **KERNEL_TOL)
    np.testing.assert_allclose(s_e.numpy(), np.asarray(s_j), **KERNEL_TOL)


@pytest.mark.parametrize("decay", ["uniform", "rwkv"])
def test_single_pass_tf32_misses_the_tolerance(decay):
    """Why 3xTF32: the same arithmetic with single-pass TF32 products breaks
    5e-4 against the Pallas kernel by far more than rounding noise."""
    xs = _decay_inputs(2, 256, 64, 64, decay, seed=13)
    o_j, _ = jax_linattn_chunked(*_j(xs), chunk=64, interpret=True)
    o_e, _ = _emulate_kernel(*_t(xs), chunk=64, mm=_mm1)
    excess = np.abs(o_e.numpy() - np.asarray(o_j)) \
        / (KERNEL_TOL["atol"] + KERNEL_TOL["rtol"] * np.abs(np.asarray(o_j)))
    assert excess.max() > 10.0


@pytest.mark.parametrize("BH,T,dk,dv,chunk", [
    (2, 126, 64, 64, 63), (2, 24, 16, 16, 24), (2, 24, 16, 16, 1),
    (2, 128, 64, 48, 64), (3, 96, 30, 45, 32)])
def test_kernel_arithmetic_ragged_matches_plain(BH, T, dk, dv, chunk):
    """Ragged chunks (63, 24, 1), a ragged dv inside one block and a dk and
    dv off the 16-byte copies: the emulation against the plain version."""
    xs = _t(_decay_inputs(BH, T, dk, dv, "uniform", seed=5))
    o_e, s_e = _emulate_kernel(*xs, chunk=chunk)
    o_r, s_r = ref.linattn_chunked_ref(*xs, chunk=chunk)
    torch.testing.assert_close(o_e, o_r, **KERNEL_TOL)
    torch.testing.assert_close(s_e, s_r, **KERNEL_TOL)


def test_tf32_rounding_is_to_nearest_ties_away():
    x = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 2 ** -12,
                      1 + 3 * 2 ** -11, 3.0], dtype=torch.float32)
    want = torch.tensor([1 + 2 ** -10, -(1 + 2 ** -10), 1.0,
                         1 + 2 ** -9, 3.0])
    assert torch.equal(_tf32(x), want)
