"""CUDA kernels for Hopper: the training planner's dedup and translation.

Python side of ``csrc/plan_dedup.cu`` (read that file's head for the
kernels' design: they replace no TPU kernel, the JAX package dedups and
translates on the host; their bound is the random byte writes of the marks
and one pass over the (shard, vertex) cells). The source is compiled with
``nvcc`` for ``sm_90a`` at first use and loaded with ``ctypes`` by
:mod:`repro_torch.kernels._build`.

:class:`DevicePartition` holds a partition's rows on a device (``owner``,
``local_idx``, the shards' pad vertices and the vertices in (owner, id)
order) and builds a pregathered plan's exchange and workspace indices from
the plan's trees where :meth:`DeviceCSR.draw_trees
<repro_torch.kernels.sample_tree.DeviceCSR.draw_trees>` leaves them:
:meth:`DevicePartition.count`, :meth:`DevicePartition.scatter` and
:meth:`DevicePartition.translate`, equal to
:func:`repro_torch.core.pregather.build_gather_plan` and
:func:`repro_torch.core.pregather.workspace_indices` bit for bit. Each step
is a function here (:func:`mark_ids`, :func:`count_marks`,
:func:`scatter_marks`, :func:`translate_hop`): a CUDA tensor launches the
kernel, a CPU tensor takes the plain version (the ``*_ref`` functions), and
there is no fallback from one to the other. :data:`launches` counts the
kernels' launches on CUDA: ``plan_dedup`` four per plan (mark, count, scan,
scatter; three where the plan overflows its ``r_max``), ``plan_translate``
one per hop.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import threading
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import _build

_SRC = Path(__file__).resolve().parent / "csrc" / "plan_dedup.cu"

# vertices of one owner per counting / scattering block (the kernel's
# kChunk: 256 threads of 16 cells)
CHUNK = 4096

launches = {"plan_dedup": 0, "plan_translate": 0}
_lock = threading.Lock()
_lib = None


def reset_launches() -> None:
    with _lock:
        for k in launches:
            launches[k] = 0


def _count(key: str) -> None:
    with _lock:
        launches[key] += 1


# ---------------------------------------------------------------------------
# Build and load
# ---------------------------------------------------------------------------

def build(verbose: bool = False) -> tuple[Path, str]:
    """Compile ``csrc/plan_dedup.cu`` unless it is built already
    (:func:`repro_torch.kernels._build.build`)."""
    return _build.build(_SRC, verbose)


def _library():
    global _lib
    with _lock:
        if _lib is None:
            lib = _build.load(_SRC)
            vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
            lib.repro_dedup_mark.argtypes = [vp, ll, ll, i, vp, vp, i, ll,
                                             vp, vp]
            lib.repro_dedup_count.argtypes = [vp, vp, vp, vp, i, i, ll, vp,
                                              vp]
            lib.repro_dedup_scan.argtypes = [vp, i, vp, i, vp, vp, vp]
            lib.repro_dedup_scatter.argtypes = [vp, vp, vp, vp, vp, vp, i, i,
                                                ll, vp, ll, ll, vp, vp, vp]
            lib.repro_translate_hop.argtypes = [vp, ll, ll, i, ll, vp, vp,
                                                vp, vp, vp, vp, ll, vp, vp]
            for fn in (lib.repro_dedup_mark, lib.repro_dedup_count,
                       lib.repro_dedup_scan, lib.repro_dedup_scatter,
                       lib.repro_translate_hop):
                fn.restype = i
            lib.repro_dedup_error_string.argtypes = [i]
            lib.repro_dedup_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def _launched(code: int, key: str, what: str) -> None:
    if code != 0:
        msg = _library().repro_dedup_error_string(code).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {code} "
                           f"({msg})")
    _count(key)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ---------------------------------------------------------------------------
# The partition's rows on a device
# ---------------------------------------------------------------------------

class DevicePartition:
    """A partition's rows on a device, checked and put there once:
    ``owner`` and ``local_idx`` (V,) int32, ``pad_vertex`` (n,) int64, and
    for the kernels ``order`` (V,) int32, the vertices sorted by (owner,
    id), cut into chunks of at most :data:`CHUNK` vertices of one owner:
    chunk c is ``order[chunk_lo[c]:chunk_lo[c + 1]]``, of owner
    ``chunk_seg[c]``, and owner p's chunks are ``[seg_chunk[p],
    seg_chunk[p + 1])``. On CUDA its work queues on ``stream`` (the
    CSR's, which draws the trees it reads)."""

    def __init__(self, owner: np.ndarray, local_idx: np.ndarray,
                 pad_vertex: np.ndarray, device, stream=None):
        owner = np.asarray(owner)
        local_idx = np.asarray(local_idx)
        pad_vertex = np.asarray(pad_vertex, np.int64)
        n, v = pad_vertex.shape[0], owner.shape[0]
        if owner.ndim != 1 or local_idx.shape != owner.shape or v < 1 \
                or v >= 1 << 31 or n < 1 or pad_vertex.ndim != 1:
            raise ValueError(f"DevicePartition: owner {owner.shape}, "
                             f"local_idx {local_idx.shape} and pad vertices "
                             f"{pad_vertex.shape}; want (V,), (V,) and (n,) "
                             f"with 1 <= V < 2^31")
        if owner.min() < 0 or owner.max() >= n:
            raise ValueError(f"DevicePartition: an owner lies outside "
                             f"[0, {n})")
        if local_idx.min() < 0 or local_idx.max() >= 1 << 31:
            raise ValueError("DevicePartition: a local index lies outside "
                             "[0, 2^31)")
        if pad_vertex.min() < 0 or pad_vertex.max() >= v:
            raise ValueError(f"DevicePartition: a pad vertex lies outside "
                             f"[0, {v})")
        sizes = np.bincount(owner, minlength=n)
        per_seg = -(-sizes // CHUNK)
        seg_start = np.concatenate(([0], np.cumsum(sizes)))[:-1]
        chunk_seg = np.repeat(np.arange(n), per_seg)
        seg_chunk = np.concatenate(([0], np.cumsum(per_seg)))
        first = seg_chunk[chunk_seg]
        chunk_lo = np.append(seg_start[chunk_seg]
                             + (np.arange(chunk_seg.size) - first) * CHUNK, v)
        device = torch.device(device)

        def put(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)
        self.num_shards, self.num_vertices = n, v
        self.owner = put(owner, np.int32)
        self.local_idx = put(local_idx, np.int32)
        self.pad_vertex_host = pad_vertex
        self.pad_vertex = put(pad_vertex, np.int64)
        self.order = put(np.argsort(owner, kind="stable"), np.int32)
        self.chunk_lo = put(chunk_lo, np.int64)
        self.chunk_seg = put(chunk_seg, np.int32)
        self.seg_chunk = put(seg_chunk, np.int32)
        self.stream = stream

    @contextlib.contextmanager
    def _queue(self):
        """On CUDA, the partition's device and stream."""
        if self.stream is None:
            yield
            return
        with torch.cuda.device(self.owner.device), \
                torch.cuda.stream(self.stream):
            yield

    def count(self, trees: torch.Tensor, job_k: np.ndarray, steps: int,
              num_layers: int, fanout: int, batch_pad: int) -> "DeviceDedup":
        """Mark the ids of the plan's trees per shard and count each (shard,
        owner) group of the marked ids that are not the shard's own.

        ``trees``: the concatenated hops below the jobs' concatenated roots
        (:meth:`DeviceCSR.draw_trees`); ``job_k`` (n * steps,): the true
        roots of job j = s * steps + t, whose trees follow job j - 1's. A
        shard any of whose jobs holds fewer than ``batch_pad`` roots is
        padded with its pad vertex, which counts where that vertex is not
        its own. Waits for the counts, which it returns on the host as
        ``DeviceDedup.req_count`` (n, n) int64."""
        n = self.num_shards
        job_k = np.asarray(job_k, np.int64)
        if job_k.shape != (n * steps,) or (job_k.size and job_k.min() < 0) \
                or job_k.max(initial=0) > batch_pad:
            raise ValueError(f"DevicePartition.count: job_k {job_k.shape} "
                             f"of roots in [0, {batch_pad}], want "
                             f"({n * steps},)")
        k = int(job_k.sum())
        if trees.shape != (k * sum(fanout ** h
                                   for h in range(num_layers + 1)),):
            raise ValueError(f"DevicePartition.count: {trees.shape[0]} tree "
                             f"ids for {k} roots of {num_layers} hops")
        padded = (job_k < batch_pad).reshape(n, steps).any(axis=1)
        job_shard = np.repeat(np.arange(n, dtype=np.int64), steps)
        host = np.concatenate([
            np.repeat(job_shard, job_k),                    # root_shard (k,)
            np.cumsum(job_k) - job_k,                       # job_off
            job_k,
            np.where(padded, self.pad_vertex_host, -1)])    # pad_mark (n,)
        j = n * steps
        with self._queue():
            small = _upload(host, trees.device)
            dd = DeviceDedup(
                trees=trees, root_shard=small[:k],
                job_off=small[k:k + j], job_k=small[k + j:k + 2 * j],
                steps=steps, num_layers=num_layers, fanout=fanout,
                batch_pad=batch_pad,
                mark=mark_ids(trees, k, fanout, num_layers, small[:k],
                              small[k + 2 * j:], self.num_vertices))
            counts, dd.chunk_off = count_marks(dd.mark, self)
            dd.req_count = _to_host(counts, self.stream).reshape(n, n)
        return dd

    def scatter(self, dd: "DeviceDedup", r_max: int,
                local_rows: int) -> None:
        """Lay out the exchange at ``r_max`` (each ``req_count`` at most
        that) into ``dd``'s output buffer, and each remote id's workspace
        slot into its shard's slot row. Queues the work and returns."""
        n = self.num_shards
        sizes = [n * n * r_max] + [n * dd.steps * dd.batch_pad
                                   * dd.fanout ** h
                                   for h in range(dd.num_layers + 1)]
        with self._queue():
            dd.out = torch.empty(sum(sizes), dtype=torch.int32,
                                 device=dd.trees.device)
            dd.sizes, dd.r_max = sizes, r_max
            req = dd.out[:sizes[0]]
            req.zero_()
            dd.slot_row = torch.empty((n, self.num_vertices),
                                      dtype=torch.int32,
                                      device=dd.trees.device)
            scatter_marks(dd.mark, self, dd.chunk_off, r_max, local_rows,
                          req.view(n, n, r_max), dd.slot_row)
            dd.mark = dd.chunk_off = None

    def translate(self, dd: "DeviceDedup") -> tuple[np.ndarray, list]:
        """Every hop's workspace indices of every (shard, step) job, then one
        copy of the exchange and the indices to the host and one wait.
        Returns ``req`` (n, n, r_max) and ``hop_idx[h]`` (n, steps,
        batch_pad * fanout**h), int32, views of one host buffer."""
        n, f, k = self.num_shards, dd.fanout, dd.root_shard.shape[0]
        ends = np.cumsum(dd.sizes).tolist()
        with self._queue():
            start = 0
            for h in range(dd.num_layers + 1):
                size = k * f ** h
                translate_hop(dd.trees[start:start + size], f ** h,
                              dd.batch_pad, dd.steps, dd.job_off, dd.job_k,
                              self, dd.slot_row,
                              dd.out[ends[h]:ends[h + 1]])
                start += size
            host = _to_host(dd.out, self.stream)
        dd.out = dd.slot_row = None
        req = host[:ends[0]].reshape(n, n, dd.r_max)
        return req, [host[ends[h]:ends[h + 1]].reshape(n, dd.steps, -1)
                     for h in range(dd.num_layers + 1)]


@dataclasses.dataclass
class DeviceDedup:
    """One plan's state between :meth:`DevicePartition.count`,
    :meth:`~DevicePartition.scatter` and :meth:`~DevicePartition.translate`
    (device tensors, on the partition's stream)."""

    trees: torch.Tensor
    root_shard: torch.Tensor
    job_off: torch.Tensor
    job_k: torch.Tensor
    steps: int
    num_layers: int
    fanout: int
    batch_pad: int
    mark: torch.Tensor | None
    chunk_off: torch.Tensor | None = None
    req_count: np.ndarray | None = None
    r_max: int = 0
    sizes: list | None = None
    out: torch.Tensor | None = None
    slot_row: torch.Tensor | None = None


def _upload(host: np.ndarray, device: torch.device) -> torch.Tensor:
    """``host`` as an int64 tensor on ``device``: through pinned memory and
    a copy on the current stream where that is a CUDA device."""
    src = torch.from_numpy(np.ascontiguousarray(host, np.int64))
    if device.type == "cpu":
        return src
    pinned = torch.empty(src.shape, dtype=torch.int64, pin_memory=True)
    pinned.copy_(src)
    return pinned.to(device, non_blocking=True)


def _to_host(t: torch.Tensor, stream) -> np.ndarray:
    """``t`` on the host as numpy: on CUDA one copy into pinned memory on
    ``stream`` and a wait for it that releases the GIL."""
    if t.device.type == "cpu":
        return t.numpy()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record(stream)
    done.synchronize()
    return host.numpy()


# ---------------------------------------------------------------------------
# The plain versions
# ---------------------------------------------------------------------------

def _position_shards(root_shard: torch.Tensor, fanout: int,
                     num_layers: int) -> torch.Tensor:
    return torch.cat([root_shard.repeat_interleave(fanout ** h)
                      for h in range(num_layers + 1)])


def mark_ids_ref(trees, num_roots, fanout, num_layers, root_shard, pad_mark,
                 num_vertices) -> torch.Tensor:
    n = pad_mark.shape[0]
    mark = torch.zeros((n, num_vertices), dtype=torch.uint8,
                       device=trees.device)
    mark[_position_shards(root_shard, fanout, num_layers), trees] = 1
    has = pad_mark >= 0
    mark[torch.nonzero(has).flatten(), pad_mark[has]] = 1
    return mark


def _remote_cells(mark: torch.Tensor, part: DevicePartition):
    """(s, v) of the marked cells whose v shard s does not own, by (s, v),
    and v's owner."""
    cells = mark.bool()
    v_all = torch.arange(part.num_vertices, device=mark.device)
    cells[part.owner.long(), v_all] = False
    s, v = torch.nonzero(cells, as_tuple=True)
    return s, v, part.owner[v].long()


def count_marks_ref(mark: torch.Tensor, part: DevicePartition):
    n = part.num_shards
    s, _, p = _remote_cells(mark, part)
    return torch.bincount(s * n + p, minlength=n * n), None


def scatter_marks_ref(mark, part, chunk_off, r_max, local_rows, req,
                      slot_row) -> None:
    n = part.num_shards
    s, v, p = _remote_cells(mark, part)
    key = s * n + p
    key, order = torch.sort(key, stable=True)
    s, v, p = s[order], v[order], p[order]
    starts = torch.cumsum(torch.bincount(key, minlength=n * n), 0)
    starts = starts - torch.bincount(key, minlength=n * n)
    j = torch.arange(key.numel(), device=mark.device) - starts[key]
    req[s, p, j] = part.local_idx[v]
    slot_row[s, v] = (local_rows + p * r_max + j).to(torch.int32)


def translate_hop_ref(hop, per_root, batch_pad, steps, job_off, job_k, part,
                      slot_row, out) -> None:
    width = batch_pad * per_root
    i = torch.arange(out.numel(), device=hop.device)
    job, q = i // width, i % width
    s = job // steps
    true = q < job_k[job] * per_root
    at = torch.where(true, job_off[job] * per_root + q, 0)
    v = torch.where(true, hop[at] if hop.numel() else 0,
                    part.pad_vertex[s])
    local = part.owner[v].long() == s
    out.copy_(torch.where(local, part.local_idx[v], slot_row[s, v]))


# ---------------------------------------------------------------------------
# The wrappers
# ---------------------------------------------------------------------------

def _cuda(t: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for {t.device}")
    return True


def mark_ids(trees: torch.Tensor, num_roots: int, fanout: int,
             num_layers: int, root_shard: torch.Tensor,
             pad_mark: torch.Tensor, num_vertices: int) -> torch.Tensor:
    """(n, V) uint8, 1 at (root_shard[r], v) for every id v of the trees
    below root r (``trees``: the concatenated hops, hop h holding
    ``num_roots * fanout**h`` int64 ids, root r's at ``[r f^h, (r + 1)
    f^h)``) and at (s, pad_mark[s]) where ``pad_mark[s] >= 0``; n is
    ``pad_mark``'s length. Ids are not checked on the device: the trees
    come from a checked CSR."""
    if not _cuda(trees, "mark_ids"):
        return mark_ids_ref(trees, num_roots, fanout, num_layers, root_shard,
                            pad_mark, num_vertices)
    n = pad_mark.shape[0]
    mark = torch.zeros((n, num_vertices), dtype=torch.uint8,
                       device=trees.device)
    _launched(_library().repro_dedup_mark(
        trees.data_ptr(), trees.shape[0], num_roots, fanout,
        root_shard.data_ptr(), pad_mark.data_ptr(), n, num_vertices,
        mark.data_ptr(), _stream(trees)), "plan_dedup", "mark")
    return mark


def count_marks(mark: torch.Tensor, part: DevicePartition):
    """``(req_count, chunk_off)``: req_count (n * n,) int64, the marked
    cells (s, v) with v of owner p != s, at s * n + p; chunk_off what
    :func:`scatter_marks` reads on CUDA (per shard the prefix of its counts
    over the chunks), None on the CPU."""
    if not _cuda(mark, "count_marks"):
        return count_marks_ref(mark, part)
    n, nc, dev = part.num_shards, part.chunk_seg.shape[0], mark.device
    counts = torch.empty((n, nc), dtype=torch.int32, device=dev)
    chunk_off = torch.empty((n, nc + 1), dtype=torch.int32, device=dev)
    req_count = torch.empty(n * n, dtype=torch.int64, device=dev)
    lib, stream = _library(), _stream(mark)
    _launched(lib.repro_dedup_count(
        mark.data_ptr(), part.order.data_ptr(), part.chunk_lo.data_ptr(),
        part.chunk_seg.data_ptr(), nc, n, part.num_vertices,
        counts.data_ptr(), stream), "plan_dedup", "count")
    _launched(lib.repro_dedup_scan(
        counts.data_ptr(), nc, part.seg_chunk.data_ptr(), n,
        chunk_off.data_ptr(), req_count.data_ptr(), stream), "plan_dedup",
        "scan")
    return req_count, chunk_off


def scatter_marks(mark: torch.Tensor, part: DevicePartition,
                  chunk_off, r_max: int, local_rows: int, req: torch.Tensor,
                  slot_row: torch.Tensor) -> None:
    """The j-th marked id v of group (s, p), ids ascending, into ``req[s,
    p, j] = local_idx[v]`` ((n, n, r_max) int32, zeroed by the caller) and
    ``slot_row[s, v] = local_rows + p * r_max + j`` ((n, V) int32; other
    cells untouched). Every group must fit ``r_max``."""
    if not _cuda(mark, "scatter_marks"):
        scatter_marks_ref(mark, part, chunk_off, r_max, local_rows, req,
                          slot_row)
        return
    n, nc = part.num_shards, part.chunk_seg.shape[0]
    _launched(_library().repro_dedup_scatter(
        mark.data_ptr(), part.order.data_ptr(), part.chunk_lo.data_ptr(),
        part.chunk_seg.data_ptr(), part.seg_chunk.data_ptr(),
        chunk_off.data_ptr(), nc, n, part.num_vertices,
        part.local_idx.data_ptr(), r_max, local_rows, req.data_ptr(),
        slot_row.data_ptr(), _stream(mark)), "plan_dedup", "scatter")


def translate_hop(hop: torch.Tensor, per_root: int, batch_pad: int,
                  steps: int, job_off: torch.Tensor, job_k: torch.Tensor,
                  part: DevicePartition, slot_row: torch.Tensor,
                  out: torch.Tensor) -> None:
    """One hop's workspace indices of every job into ``out`` ((n * steps *
    batch_pad * per_root,) int32): job j = s * steps + t's position q holds
    ``hop[job_off[j] * per_root + q]`` for q below ``job_k[j] * per_root``,
    else shard s's pad vertex, translated to ``local_idx[v]`` where s owns
    v and ``slot_row[s, v]`` elsewhere."""
    if not _cuda(hop, "translate_hop"):
        translate_hop_ref(hop, per_root, batch_pad, steps, job_off, job_k,
                          part, slot_row, out)
        return
    _launched(_library().repro_translate_hop(
        hop.data_ptr(), per_root, batch_pad * per_root, steps, out.shape[0],
        job_off.data_ptr(), job_k.data_ptr(), part.pad_vertex.data_ptr(),
        part.owner.data_ptr(), part.local_idx.data_ptr(),
        slot_row.data_ptr(), part.num_vertices, out.data_ptr(),
        _stream(hop)), "plan_translate", "translate")
