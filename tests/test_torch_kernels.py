"""The port's kernel dispatch on the CPU (plain versions) against the JAX
package's Pallas kernels in interpret mode, on the same numpy inputs.

gather_rows is data movement and must match bit for bit. gather_agg is
arithmetic: 1e-5 for float32 and 2e-2 for bfloat16 (the tolerances of
tests/test_kernels.py), with max exact. The CUDA kernels themselves run
only on the card, where chip_smoke.py holds them against these same plain
versions.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.gather_agg import gather_agg as jax_gather_agg
from repro.kernels.gather_agg import gather_rows as jax_gather_rows
from repro_torch.kernels import gather_agg as cuda_kernels
from repro_torch.kernels import ops

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(x: np.ndarray, dtype: str):
    jd, td = DTYPES[dtype]
    return jnp.asarray(x, jd), torch.from_numpy(x).to(td)


def _np(out) -> np.ndarray:
    if isinstance(out, torch.Tensor):
        return out.float().numpy()
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("rows,d", [(16, 128), (64, 256), (33, 96),
                                    (40, 1), (40, 100), (40, 130)])
def test_gather_rows_matches_pallas(rows, d, dtype):
    rng = np.random.default_rng(0)
    table = rng.standard_normal((rows, d)).astype(np.float32)
    idx = rng.integers(0, rows, 29).astype(np.int32)
    jt, tt = _pair(table, dtype)
    ref = jax_gather_rows(jt, jnp.asarray(idx), interpret=True)
    out = ops.gather_rows(tt, torch.from_numpy(idx))
    assert out.dtype == tt.dtype and out.shape == (29, d)
    np.testing.assert_array_equal(_np(out), _np(ref))


@pytest.mark.parametrize("reduce", ["sum", "mean", "max"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n,f,d", [(8, 4, 128), (17, 10, 128), (5, 3, 64),
                                   (17, 10, 1), (17, 10, 100),
                                   (17, 10, 130),
                                   # chip_smoke.py's shapes for the CUDA
                                   # kernel's instances: fanout 10 and the
                                   # generic one (1, 3, 4, 25, 40); widths
                                   # whose rows take 16-, 8-, 4- and 2-byte
                                   # words
                                   (1, 1, 100), (9, 3, 96), (5, 25, 130),
                                   (3, 40, 1), (7, 4, 100), (1, 10, 96)])
def test_gather_agg_matches_pallas(n, f, d, reduce, dtype):
    rng = np.random.default_rng(1)
    table = rng.standard_normal((40, d)).astype(np.float32)
    idx = rng.integers(0, 40, (n, f)).astype(np.int32)
    jt, tt = _pair(table, dtype)
    ref = jax_gather_agg(jt, jnp.asarray(idx), reduce=reduce, interpret=True)
    out = ops.gather_agg(tt, torch.from_numpy(idx), reduce=reduce)
    assert out.dtype == tt.dtype and out.shape == (n, d)
    if reduce == "max":
        np.testing.assert_array_equal(_np(out), _np(ref))
    else:
        tol = 2e-2 if dtype == "bfloat16" else 1e-5
        np.testing.assert_allclose(_np(out), _np(ref), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n,f,d", [(9, 10, 100), (5, 3, 96), (3, 40, 1)])
def test_gather_agg_max_propagates_nan_like_pallas(n, f, d, dtype):
    """A NaN in a neighbour row is the max of that column, wherever it
    falls among the f neighbours, as jnp.maximum has it."""
    rng = np.random.default_rng(2)
    table = rng.standard_normal((12, d)).astype(np.float32)
    table[5, ::2] = np.nan
    idx = rng.integers(0, 12, (n, f)).astype(np.int32)
    idx[0, 0], idx[-1, f - 1] = 5, 5
    jt, tt = _pair(table, dtype)
    ref = jax_gather_agg(jt, jnp.asarray(idx), reduce="max", interpret=True)
    out = ops.gather_agg(tt, torch.from_numpy(idx), reduce="max")
    assert np.isnan(_np(out)).any()
    np.testing.assert_array_equal(_np(out), _np(ref))


@pytest.mark.parametrize("row_bytes,table_ptr,out_ptr,want", [
    (400, 0, 512, (16, 32)),   # float32 d=100: one row a warp
    (200, 0, 512, (8, 32)),    # bfloat16 d=100
    (384, 0, 512, (16, 32)),   # float32 d=96
    (192, 0, 512, (16, 16)),   # bfloat16 d=96: two rows a warp
    (520, 0, 512, (8, 32)),    # float32 d=130: three passes
    (260, 0, 512, (4, 32)),    # bfloat16 d=130
    (4, 0, 512, (4, 1)),       # float32 d=1: 32 rows a warp
    (2, 0, 512, (2, 1)),       # bfloat16 d=1
    (400, 4, 512, (4, 32)),    # base shifted by one float32
    (192, 2, 512, (2, 32)),    # base shifted by one bfloat16
    (400, 0, 8, (8, 32)),      # an output that is 8-aligned
    (384, 0, 4, (4, 32)),      # an output that is only 4-aligned: 96 words
])
def test_agg_shape_picks_word_and_lanes(row_bytes, table_ptr, out_ptr,
                                        want):
    """gather_agg's launch shape: the widest word dividing the row and
    both pointers, and a power-of-two group of lanes >= the row's words
    capped at 32."""
    assert cuda_kernels.agg_shape(row_bytes, table_ptr, out_ptr) == want


def test_cpu_dispatch_never_launches():
    """On the CPU the ops layer takes the plain versions: no kernel
    launches are counted."""
    cuda_kernels.reset_launches()
    table = torch.randn(10, 100)
    ops.gather_rows(table, torch.tensor([3, 1, 9], dtype=torch.int32))
    ops.gather_agg(table, torch.zeros((4, 3), dtype=torch.int32), "mean")
    assert cuda_kernels.launches == {"gather_rows": 0, "gather_agg": 0}


@pytest.mark.parametrize("kernel,idx_shape", [("gather_rows", (3,)),
                                              ("gather_agg", (3, 2))])
def test_kernel_wrappers_refuse_cpu_tensors(kernel, idx_shape):
    """The CUDA wrappers have no CPU path: a CPU tensor raises before any
    build or launch, and nothing is counted."""
    cuda_kernels.reset_launches()
    table = torch.randn(10, 8)
    idx = torch.zeros(idx_shape, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        getattr(cuda_kernels, kernel)(table, idx)
    assert cuda_kernels.launches[kernel] == 0


def test_plain_gather_agg_rejects_unknown_reduce():
    with pytest.raises(ValueError, match="reduce"):
        ops.gather_agg(torch.zeros(4, 2), torch.zeros((1, 2), dtype=torch.int32),
                       reduce="prod")


def test_library_name_tracks_the_source():
    """The built library's name carries a hash of the source and flags, so
    an edited kernel is rebuilt and never loaded stale."""
    p = cuda_kernels.library_path()
    assert p.parent == cuda_kernels.BUILD_DIR
    assert p.name.startswith("libgather_agg-") and p.suffix == ".so"
    assert p == cuda_kernels.library_path()
