"""CUDA kernel for Hopper: chunked RWKV6 gated linear attention.

Python side of ``csrc/linattn.cu`` (read that file's head for the kernel's
design: which TPU kernel it replaces, what bounds it on the card, and what
the design does about that). The source is compiled with ``nvcc`` for
``sm_90a`` at first use and loaded with ``ctypes`` by
:mod:`repro_torch.kernels._build`.

The wrapper takes CUDA tensors only: it checks device, dtype (float32),
rank, shapes, contiguity, ``T % chunk == 0`` and ``1 <= chunk <= 64``, and
that autograd wants no gradient through the call (the kernel has no
backward, so an input that requires grad under grad mode is refused rather
than answered with a result cut off from the graph), raises on anything
else, allocates the outputs with ``torch.empty``, and
launches on the current stream of the calling thread. The decay ``w`` is
assumed to lie in (0.5, 1], the reference's domain; it is neither clamped
nor checked. The wrapper adds one to ``launches["linattn"]`` where it
launches the kernel, and nowhere else.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from repro_torch.kernels import _build

_SRC = Path(__file__).resolve().parent / "csrc" / "linattn.cu"
MAX_CHUNK = 64       # kMaxC in csrc/linattn.cu: its shared-memory tiles
MAX_DK = 64          # kMaxK there

launches = {"linattn": 0}
_lock = threading.Lock()
_lib = None


def reset_launches() -> None:
    with _lock:
        launches["linattn"] = 0


def library_path() -> Path:
    return _build.library_path(_SRC)


def build(verbose: bool = False) -> tuple[Path, str]:
    """Compile ``csrc/linattn.cu`` unless it is built already
    (:func:`repro_torch.kernels._build.build`)."""
    return _build.build(_SRC, verbose)


def _library():
    global _lib
    with _lock:
        if _lib is None:
            lib = _build.load(_SRC)
            vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
            lib.repro_linattn_chunked.argtypes = [vp] * 7 + [ll] + [i] * 5 \
                + [vp]
            lib.repro_linattn_chunked.restype = i
            lib.repro_linattn_smem_bytes.argtypes = []
            lib.repro_linattn_smem_bytes.restype = ll
            lib.repro_linattn_error_string.argtypes = [i]
            lib.repro_linattn_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def smem_bytes() -> int:
    """Dynamic shared memory of one block (loads the library)."""
    return int(_library().repro_linattn_smem_bytes())


def _check(q, k, v, w, u, chunk: int) -> None:
    ts = {"q": q, "k": k, "v": v, "w": w, "u": u}
    if torch.is_grad_enabled():
        wanting = [name for name, t in ts.items() if t.requires_grad]
        if wanting:
            raise RuntimeError(
                f"linattn: the CUDA kernel has no backward, and {wanting} "
                f"require grad; call it under torch.no_grad(), or call "
                f"ops.linattn, which differentiates linattn_chunked_torch")
    for name, t in ts.items():
        if t.dtype != torch.float32:
            raise TypeError(f"linattn: {name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"linattn: {name} must be contiguous")
    if q.dim() != 3 or v.dim() != 3:
        raise ValueError(f"linattn: want 3-d q and v, got {tuple(q.shape)} "
                         f"and {tuple(v.shape)}")
    bh, T, dk = q.shape
    if k.shape != q.shape or w.shape != q.shape or v.shape[:2] != (bh, T):
        raise ValueError(f"linattn: q, k, w must be (BH, T, dk) and v "
                         f"(BH, T, dv); got q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, w {tuple(w.shape)}, v "
                         f"{tuple(v.shape)}")
    if u.shape not in ((dk,), (bh, dk)):
        raise ValueError(f"linattn: u must be ({dk},) or ({bh}, {dk}), got "
                         f"{tuple(u.shape)}")
    if not 1 <= dk <= MAX_DK or v.shape[2] < 1:
        raise ValueError(f"linattn: need 1 <= dk <= {MAX_DK} and dv >= 1, "
                         f"got dk={dk}, dv={v.shape[2]}")
    if not 1 <= chunk <= MAX_CHUNK or T % chunk:
        raise ValueError(f"linattn: need 1 <= chunk <= {MAX_CHUNK} and "
                         f"T % chunk == 0, got T={T}, chunk={chunk}")
    dev = q.device
    if dev.type != "cuda" or any(t.device != dev for t in ts.values()):
        raise ValueError("linattn: q, k, v, w and u must lie on one CUDA "
                         f"device (got {[str(t.device) for t in ts.values()]})")


def linattn_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    w: torch.Tensor, u: torch.Tensor, chunk: int = 64
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """q, k, w: (BH, T, dk); v: (BH, T, dv); u: (dk,) or (BH, dk); all
    float32 on CUDA, from a zero state. Returns (o (BH, T, dv) float32,
    final state (BH, dk, dv) float32)."""
    _check(q, k, v, w, u, chunk)
    bh, T, dk = q.shape
    dv = v.shape[2]
    o = torch.empty((bh, T, dv), dtype=torch.float32, device=q.device)
    s_out = torch.empty((bh, dk, dv), dtype=torch.float32, device=q.device)
    if bh == 0 or T == 0:
        return o, s_out.zero_()
    lib = _library()
    with torch.cuda.device(q.device):
        code = lib.repro_linattn_chunked(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), o.data_ptr(), s_out.data_ptr(), bh, T, dk, dv,
            chunk, 0 if u.dim() == 1 else dk,
            torch.cuda.current_stream(q.device).cuda_stream)
    if code != 0:
        msg = lib.repro_linattn_error_string(code).decode()
        raise RuntimeError(f"linattn kernel launch failed: CUDA error {code} "
                           f"({msg})")
    with _lock:
        launches["linattn"] += 1
    return o, s_out
