"""CUDA kernel for Hopper: one hop of the planner's stateless tree sampling.

Python side of ``csrc/sample_tree.cu`` (read that file's head for the
kernel's design: it replaces no TPU kernel, the JAX package samples on the
host; its bound is the random ``indices`` reads and the ids written). The
source is compiled with ``nvcc`` for ``sm_90a`` at first use and loaded
with ``ctypes`` by :mod:`repro_torch.kernels._build`.

:func:`sample_hop` draws one hop below a frontier exactly as
:func:`repro_torch.graph.sampler._sample_neighbors` does with a ``seed``,
bit for bit: a CUDA tensor launches the kernel, a CPU tensor takes the
plain version, :func:`sample_hop_ref`, and there is no fallback from one
to the other. :class:`DeviceCSR` holds a graph's CSR on a device and
expands a whole plan's concatenated roots hop by hop
(:meth:`DeviceCSR.draw_trees`): on CUDA, one launch per hop on a stream of
its own, the trees left on the card for the planner's dedup
(:mod:`repro_torch.kernels.plan_dedup`); :meth:`DeviceCSR.sample_trees`
copies them into pinned host memory with one copy.
:data:`launches` counts the kernel's launches, one per hop expanded on
CUDA, and nothing else.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import _build

_SRC = Path(__file__).resolve().parent / "csrc" / "sample_tree.cu"

_U64 = (1 << 64) - 1
# the key's constants (graph/sampler.py's _sample_neighbors)
_VERTEX_MUL = 0x100000001B3
_HOP_MUL = 0x9E3779B9
_SEED_MUL = 0xDEADBEEF63

launches = {"sample_tree": 0}
_lock = threading.Lock()
_lib = None


def reset_launches() -> None:
    with _lock:
        launches["sample_tree"] = 0


def _count() -> None:
    with _lock:
        launches["sample_tree"] += 1


# ---------------------------------------------------------------------------
# Build and load
# ---------------------------------------------------------------------------

def build(verbose: bool = False) -> tuple[Path, str]:
    """Compile ``csrc/sample_tree.cu`` unless it is built already
    (:func:`repro_torch.kernels._build.build`)."""
    return _build.build(_SRC, verbose)


def _library():
    global _lib
    with _lock:
        if _lib is None:
            lib = _build.load(_SRC)
            vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
            lib.repro_sample_hop.argtypes = [vp, vp, vp, vp, ll, i, ll,
                                             ctypes.c_ulonglong, vp]
            lib.repro_sample_hop.restype = i
            lib.repro_sample_error_string.argtypes = [i]
            lib.repro_sample_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


# ---------------------------------------------------------------------------
# The hash, in uint64 arithmetic kept in int64 bits
# ---------------------------------------------------------------------------

def _hop_salt(hop: int, seed: int) -> int:
    """The key's hop and seed terms, ``hop * 0x9E3779B9 + seed *
    0xDEADBEEF63`` mod 2^64, as an unsigned integer. ``seed`` is a uint64,
    as the host sampler takes it."""
    if not 0 <= seed <= _U64:
        raise ValueError(f"seed {seed} is not a uint64")
    return (hop * _HOP_MUL + seed * _SEED_MUL) & _U64


def _bits(c: int) -> int:
    """The int64 whose bits are those of the uint64 ``c``."""
    c &= _U64
    return c - (1 << 64) if c >> 63 else c


def _shr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 bits (``>>`` on int64 is arithmetic)."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def _splitmix64(x: torch.Tensor) -> torch.Tensor:
    """SplitMix64's finalizer on int64 bits: additions and products wrap
    mod 2^64 as they do in uint64."""
    x = x + _bits(0x9E3779B97F4A7C15)
    x = (x ^ _shr(x, 30)) * _bits(0xBF58476D1CE4E5B9)
    x = (x ^ _shr(x, 27)) * _bits(0x94D049BB133111EB)
    return x ^ _shr(x, 31)


def _umod(h: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """``h``'s bits read as a uint64, mod ``d`` (1 <= d < 2^62). A negative
    h stands for h + 2^64, and 2^64 mod d is twice (2^63 mod d)."""
    r63 = torch.remainder(torch.remainder(torch.full_like(d, (1 << 63) - 1),
                                          d) + 1, d)
    r64 = torch.remainder(2 * r63, d)
    r = torch.remainder(h, d) + torch.where(h < 0, r64, torch.zeros_like(d))
    return torch.remainder(r, d)


# ---------------------------------------------------------------------------
# The plain version and the wrapper
# ---------------------------------------------------------------------------

def sample_hop_ref(indptr: torch.Tensor, indices: torch.Tensor,
                   frontier: torch.Tensor, fanout: int, hop: int,
                   seed: int) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch, on any device:
    ``_sample_neighbors(graph, frontier, fanout, None, seed, hop)``."""
    f = int(fanout)
    loops = frontier.repeat_interleave(f)
    if indices.numel() == 0:                    # every degree is 0
        return loops
    start = indptr[frontier]
    deg = indptr[frontier + 1] - start
    slot = torch.arange(f, dtype=torch.int64, device=frontier.device)
    key = (frontier[:, None] * _bits(_VERTEX_MUL) + slot[None, :]
           + _bits(_hop_salt(hop, seed)))
    offs = _umod(_splitmix64(key), deg.clamp_min(1)[:, None])
    flat = torch.clamp_max(start[:, None] + offs, indices.numel() - 1)
    nbrs = indices[flat.reshape(-1)].to(torch.int64)
    return torch.where(deg.repeat_interleave(f) == 0, loops, nbrs)


def _check(indptr: torch.Tensor, indices: torch.Tensor,
           frontier: torch.Tensor, fanout: int) -> None:
    for name, t, want in (("indptr", indptr, torch.int64),
                          ("indices", indices, torch.int32),
                          ("frontier", frontier, torch.int64)):
        if t.dtype != want:
            raise TypeError(f"sample_hop: {name} must be {want}, got "
                            f"{t.dtype}")
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"sample_hop: {name} must be 1-d and "
                             f"contiguous, got shape {tuple(t.shape)}")
    if not indptr.device == indices.device == frontier.device:
        raise ValueError(f"sample_hop: indptr, indices and frontier must lie "
                         f"on one device (got {indptr.device}, "
                         f"{indices.device} and {frontier.device})")
    if fanout < 1:
        raise ValueError("sample_hop: fanout must be at least 1")


def sample_hop(indptr: torch.Tensor, indices: torch.Tensor,
               frontier: torch.Tensor, fanout: int, hop: int, seed: int,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """(m,) int64 frontier -> (m * fanout,) int64 neighbours drawn with
    replacement from the CSR (``indptr`` (V + 1,) int64, ``indices``
    (nnz,) int32), statelessly from (vertex, slot, hop, seed). On CUDA
    the kernel writes into ``out`` where given (a contiguous int64 tensor
    of that length) on the current stream; frontier ids are not
    bounds-checked on the device, callers validate them (as
    :meth:`DeviceCSR.sample_trees` does). On the CPU the plain version
    runs and ``out`` must be None."""
    _check(indptr, indices, frontier, fanout)
    if frontier.device.type == "cpu":
        if out is not None:
            raise ValueError("sample_hop: out is for the CUDA kernel")
        return sample_hop_ref(indptr, indices, frontier, fanout, hop, seed)
    if frontier.device.type != "cuda":
        raise ValueError(f"sample_hop: no kernel for {frontier.device}")
    m = frontier.shape[0]
    if out is None:
        out = torch.empty(m * fanout, dtype=torch.int64,
                          device=frontier.device)
    elif (out.dtype != torch.int64 or out.shape != (m * fanout,)
          or not out.is_contiguous() or out.device != frontier.device):
        raise ValueError(f"sample_hop: out must be a contiguous int64 "
                         f"({m * fanout},) on {frontier.device}")
    if m == 0:
        return out
    lib = _library()
    with torch.cuda.device(frontier.device):
        code = lib.repro_sample_hop(
            indptr.data_ptr(), indices.data_ptr(), frontier.data_ptr(),
            out.data_ptr(), m, fanout, indices.shape[0],
            _hop_salt(hop, seed),
            torch.cuda.current_stream(frontier.device).cuda_stream)
    if code != 0:
        msg = _library().repro_sample_error_string(code).decode()
        raise RuntimeError(f"sample_tree kernel launch failed: CUDA error "
                           f"{code} ({msg})")
    _count()
    return out


class DeviceCSR:
    """A graph's CSR on a device, checked once, for
    :meth:`sample_trees`: ``indptr`` (V + 1,) int64 and ``indices``
    (nnz,) int32. On CUDA it owns a stream, so its launches and copies do
    not queue behind the work on the default stream."""

    def __init__(self, indptr: torch.Tensor, indices: torch.Tensor):
        self.indptr, self.indices = indptr, indices
        self.num_vertices = int(indptr.shape[0]) - 1
        self.stream = (torch.cuda.Stream(indptr.device)
                       if indptr.device.type == "cuda" else None)

    @classmethod
    def from_graph(cls, graph, device) -> "DeviceCSR":
        """Check ``graph`` (a CSRGraph) and copy its CSR to ``device``:
        indptr non-decreasing from 0 to nnz, every index in [0, V), and V
        below 2^31, so the ids fit the int32 indices."""
        indptr = np.asarray(graph.indptr)
        indices = np.asarray(graph.indices)
        v, nnz = indptr.shape[0] - 1, indices.shape[0]
        if v < 0 or v >= 1 << 31:
            raise ValueError(f"DeviceCSR: {v} vertices; want 0 <= V < 2^31")
        if indptr[0] != 0 or indptr[-1] != nnz or \
                (v and np.diff(indptr).min() < 0):
            raise ValueError("DeviceCSR: indptr must rise from 0 to nnz")
        if nnz and (indices.min() < 0 or indices.max() >= v):
            raise ValueError("DeviceCSR: an index lies outside [0, V)")
        device = torch.device(device)
        return cls(torch.from_numpy(indptr.astype(np.int64, copy=False))
                   .to(device),
                   torch.from_numpy(indices.astype(np.int32, copy=False))
                   .to(device))

    def draw_trees(self, roots: np.ndarray, num_layers: int, fanout: int,
                   seed: int) -> torch.Tensor:
        """The fixed-fanout trees below ``roots`` on the CSR's device, hop
        after hop in one int64 tensor of ``len(roots) * sum(fanout**h for
        h in range(num_layers + 1))`` ids: hop h holds ``len(roots) *
        fanout**h`` ids, root r's at ``[r * fanout**h, (r + 1) *
        fanout**h)``, equal to ``sample_tree_block(graph, roots,
        num_layers, fanout, seed=seed).hops``. On CUDA the launches queue
        on the CSR's stream and are not waited for."""
        roots = np.ascontiguousarray(roots, dtype=np.int64)
        k = roots.size
        if k and (roots.min() < 0 or roots.max() >= self.num_vertices):
            raise IndexError(f"sample_trees: a root lies outside "
                             f"[0, {self.num_vertices})")
        sizes = [k * fanout ** h for h in range(num_layers + 1)]
        if self.stream is None:
            hops = [torch.from_numpy(roots)]
            for h in range(num_layers):
                hops.append(sample_hop(self.indptr, self.indices, hops[-1],
                                       fanout, h, seed))
            return torch.cat(hops)
        ends = np.cumsum(sizes).tolist()
        host = torch.empty(k, dtype=torch.int64, pin_memory=True)
        host.numpy()[:] = roots
        dev = self.indptr.device
        with torch.cuda.device(dev), torch.cuda.stream(self.stream):
            buf = torch.empty(ends[-1], dtype=torch.int64, device=dev)
            buf[:k].copy_(host, non_blocking=True)
            for h in range(num_layers):
                sample_hop(self.indptr, self.indices,
                           buf[ends[h] - sizes[h]:ends[h]], fanout, h, seed,
                           out=buf[ends[h]:ends[h + 1]])
        return buf

    def to_host(self, trees: torch.Tensor) -> np.ndarray:
        """``trees`` (:meth:`draw_trees`) as a numpy array on the host: on
        CUDA one copy into pinned memory of this call's own, queued on the
        CSR's stream behind the draws, and a wait for it."""
        if self.stream is None:
            return trees.numpy()
        host = torch.empty(trees.shape[0], dtype=torch.int64,
                           pin_memory=True)
        with torch.cuda.device(trees.device), torch.cuda.stream(self.stream):
            host.copy_(trees, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.stream)
        done.synchronize()               # releases the GIL while it waits
        return host.numpy()

    def sample_trees(self, roots: np.ndarray, num_layers: int, fanout: int,
                     seed: int) -> list:
        """``hops[h]`` (len(roots) * fanout**h,) int64 numpy: the trees of
        :meth:`draw_trees` on the host (:meth:`to_host`), hop by hop. The
        trees of a slice of the roots are the matching slices of every
        hop."""
        out = self.to_host(self.draw_trees(roots, num_layers, fanout, seed))
        k = len(roots)
        sizes = [k * fanout ** h for h in range(num_layers + 1)]
        ends = np.cumsum(sizes).tolist()
        return [out[e - s:e] for s, e in zip(sizes, ends)]
