"""CUDA kernels for Hopper: feature-row gather and fused gather+aggregate.

Python side of ``csrc/gather_agg.cu`` (read that file's head for each
kernel's design: which TPU kernel it replaces, what bounds it on the card,
and what the design does about that). The source is compiled with ``nvcc``
for ``sm_90a`` at first use and loaded with ``ctypes`` by
:mod:`repro_torch.kernels._build`.

The wrappers take CUDA tensors only: they check device, dtype (float32 or
bfloat16), rank, contiguity and int32 indices, raise on anything else,
allocate the output with ``torch.empty``, and launch on the current stream
of the calling thread. The indices are not bounds-checked on the device:
callers validate them on the host (the serving forward does, on numpy,
before upload). Each wrapper adds one to its entry in :data:`launches`
where it launches its kernel, and nowhere else.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from repro_torch.kernels import _build

_SRC = Path(__file__).resolve().parent / "csrc" / "gather_agg.cu"
BUILD_DIR = _build.BUILD_DIR

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_REDUCES = {"sum": 0, "mean": 1, "max": 2}

launches = {"gather_rows": 0, "gather_agg": 0}
_lock = threading.Lock()
_lib = None


def reset_launches() -> None:
    with _lock:
        for k in launches:
            launches[k] = 0


def _count(name: str) -> None:
    with _lock:
        launches[name] += 1


# ---------------------------------------------------------------------------
# Build and load
# ---------------------------------------------------------------------------

def library_path() -> Path:
    return _build.library_path(_SRC)


def build(verbose: bool = False) -> tuple[Path, str]:
    """Compile ``csrc/gather_agg.cu`` unless it is built already
    (:func:`repro_torch.kernels._build.build`)."""
    return _build.build(_SRC, verbose)


def _library():
    global _lib
    with _lock:
        if _lib is None:
            lib = _build.load(_SRC)
            vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
            lib.repro_gather_rows.argtypes = [vp, vp, vp, ll, ll, i, vp]
            lib.repro_gather_rows.restype = i
            lib.repro_gather_agg.argtypes = [vp, vp, vp, ll, i, ll, i, i, i,
                                             i, vp]
            lib.repro_gather_agg.restype = i
            lib.repro_error_string.argtypes = [i]
            lib.repro_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def _raise_on(code: int, name: str) -> None:
    if code != 0:
        msg = _library().repro_error_string(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error "
                           f"{code} ({msg})")


# ---------------------------------------------------------------------------
# Argument checks
# ---------------------------------------------------------------------------

def _check(table: torch.Tensor, idx: torch.Tensor, idx_ndim: int,
           name: str) -> None:
    if table.device.type != "cuda" or idx.device != table.device:
        raise ValueError(f"{name}: table and idx must lie on one CUDA "
                         f"device (got {table.device} and {idx.device})")
    if table.dtype not in _DTYPES:
        raise TypeError(f"{name}: table dtype {table.dtype} is not one of "
                        f"{sorted(map(str, _DTYPES))}")
    if idx.dtype != torch.int32:
        raise TypeError(f"{name}: idx must be int32, got {idx.dtype}")
    if table.dim() != 2 or idx.dim() != idx_ndim:
        raise ValueError(f"{name}: want a 2-d table and a {idx_ndim}-d idx, "
                         f"got {tuple(table.shape)} and {tuple(idx.shape)}")
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError(f"{name}: table and idx must be contiguous")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def word_bytes(row_bytes: int, *ptrs: int) -> int:
    """The widest word (16, 8, 4 or 2 bytes) that divides a row's bytes
    and every base pointer: the width each lane loads and stores."""
    return next(w for w in (16, 8, 4, 2)
                if row_bytes % w == 0 and all(p % w == 0 for p in ptrs))


def agg_shape(row_bytes: int, table_ptr: int,
              out_ptr: int) -> tuple[int, int]:
    """gather_agg's launch shape: (word bytes, lanes per row). A row of W
    words gets the power of two >= W lanes, capped at 32 (a warp then
    reduces 32 / lanes rows at once)."""
    word = word_bytes(row_bytes, table_ptr, out_ptr)
    group = min(32, 1 << (row_bytes // word - 1).bit_length())
    return word, group


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table: (R, d) float32/bfloat16 on CUDA, idx: (n,) int32 -> (n, d)."""
    _check(table, idx, 1, "gather_rows")
    n, d = idx.shape[0], table.shape[1]
    out = torch.empty((n, d), dtype=table.dtype, device=table.device)
    if n == 0 or d == 0:
        return out
    row_bytes = d * table.element_size()
    word = word_bytes(row_bytes, table.data_ptr(), out.data_ptr())
    lib = _library()
    with torch.cuda.device(table.device):
        code = lib.repro_gather_rows(table.data_ptr(), idx.data_ptr(),
                                     out.data_ptr(), n, row_bytes, word,
                                     _stream(table.device))
    _raise_on(code, "gather_rows")
    _count("gather_rows")
    return out


def gather_agg(table: torch.Tensor, idx: torch.Tensor,
               reduce: str = "sum") -> torch.Tensor:
    """table: (R, d) float32/bfloat16 on CUDA, idx: (n, f) int32 with
    f >= 1 -> (n, d), reduced over f in float32 and cast to the table's
    dtype."""
    _check(table, idx, 2, "gather_agg")
    if reduce not in _REDUCES:
        raise ValueError(f"gather_agg: unknown reduce {reduce!r}; have "
                         f"{sorted(_REDUCES)}")
    n, f = idx.shape
    d = table.shape[1]
    if f < 1:
        raise ValueError("gather_agg: fanout must be at least 1")
    out = torch.empty((n, d), dtype=table.dtype, device=table.device)
    if n == 0 or d == 0:
        return out
    row_bytes = d * table.element_size()
    word, group = agg_shape(row_bytes, table.data_ptr(), out.data_ptr())
    lib = _library()
    with torch.cuda.device(table.device):
        code = lib.repro_gather_agg(table.data_ptr(), idx.data_ptr(),
                                    out.data_ptr(), n, f, row_bytes, word,
                                    group, _DTYPES[table.dtype],
                                    _REDUCES[reduce], _stream(table.device))
    _raise_on(code, "gather_agg")
    _count("gather_agg")
    return out
