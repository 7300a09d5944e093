// Hand-written Hopper (sm_90a) kernels for the training planner's dedup and
// translation stages (paper section 5.2), with a plain C interface: the
// Python wrapper in repro_torch/kernels/plan_dedup.py loads this file's
// shared library with ctypes and passes every pointer and the stream as an
// integer. Each entry point launches on the stream it is given, does not
// synchronise, allocates nothing, and returns cudaGetLastError().
//
// These kernels replace no TPU kernel: the JAX package dedups and
// translates on the host (src/repro/core/pregather.py, build_gather_plan
// and workspace_indices), and so did the port until the planner's dedup
// came to set the pace of training. They take a plan's sampled trees where
// the sampling kernel (sample_tree.cu) left them on the card and build the
// plan's exchange and workspace indices there, equal to the host's:
//   mark_kernel     mark[s, v] = 1 for every tree id v of shard s (and
//                   shard s's pad vertex where its trees are padded);
//   count_kernel    per (shard s, chunk c) the marked cells of the chunk,
//                   where a chunk is a run of at most kChunk vertices of one
//                   owner p != s, taken in (owner, id) order (`order`);
//   scan_kernel     per shard, the exclusive prefix of the chunk counts,
//                   and req_count[s, p], the chunks' sum over p's segment;
//   scatter_kernel  the j-th marked id v of group (s, p), ids ascending as
//                   the host's np.nonzero and stable argsort give them:
//                   req[s, p, j] = local_idx[v] and slot_row[s, v] =
//                   local_rows + p * r_max + j;
//   translate_kernel  one hop of every (shard, step) job: a true position's
//                   id v, or a padded position's pad vertex, becomes
//                   owner[v] == s ? local_idx[v] : slot_row[s, v].
// The host reads req_count between the scan and the scatter: it fixes
// r_max, or raises the host's PlanOverflow, before any slot is written.
// Home cells need no clearing pass: a chunk of shard s's own segment is
// skipped by every kernel, so its marks are never read.
// What bounds them on the card: the random byte writes of the marks into
// an n * V mark array that the L2 holds (9.8 MB at train-sage-products'
// V, 40 MB at train-gat-uk's), one pass over the n * V cells through
// `order` per counting and per scattering kernel (a byte of mark and four
// of `order` per cell), and the tree ids read once per kernel that reads
// them. Design: one thread per tree id for the marks (its shard from its
// root, hop by hop); one block per (shard, chunk) for the count and the
// scatter, whose ranks come from a block-wide scan of each thread's
// kItems consecutive cells; one block per shard for the scan; one thread
// per output position for the translation, whose reads of owner and
// local_idx gather at random but stay one int32 each.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int kChunk = kThreads * kItems;
static_assert(kChunk == 4096, "plan_dedup.CHUNK, the wrapper's chunk");
constexpr int kScanThreads = 1024;

// The exclusive prefix of x over the block, in thread order, and the
// block's total in *total. `warps` holds 33 values in shared memory: one
// per warp (at most 32) and the total.
__device__ __forceinline__ long long block_exclusive_scan(
    long long x, long long* warps, long long* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  long long incl = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const long long y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warps[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const long long w = lane < nwarps ? warps[lane] : 0;
    long long winc = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const long long y = __shfl_up_sync(0xffffffffu, winc, o);
      if (lane >= o) winc += y;
    }
    if (lane < nwarps) warps[lane] = winc - w;
    if (lane == nwarps - 1) warps[32] = winc;
  }
  __syncthreads();
  const long long out = warps[warp] + incl - x;
  *total = warps[32];
  __syncthreads();            // warps[] is free for the next call
  return out;
}

__global__ void __launch_bounds__(kThreads) mark_kernel(
    const int64_t* __restrict__ trees, long long n_ids, long long num_roots,
    int fanout, const int64_t* __restrict__ root_shard,
    const int64_t* __restrict__ pad_mark, int n, long long V,
    uint8_t* __restrict__ mark) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i < n_ids) {
    // hop h holds num_roots * fanout^h ids, root r's at [r f^h, (r+1) f^h)
    long long start = 0, size = num_roots, per_root = 1;
    while (i >= start + size) {
      start += size;
      size *= fanout;
      per_root *= fanout;
    }
    const long long r = (i - start) / per_root;
    mark[root_shard[r] * V + trees[i]] = 1;
  } else if (i < n_ids + n) {
    const int s = (int)(i - n_ids);
    const long long v = pad_mark[s];
    if (v >= 0) mark[(long long)s * V + v] = 1;
  }
}

__global__ void __launch_bounds__(kThreads) count_kernel(
    const uint8_t* __restrict__ mark, const int32_t* __restrict__ order,
    const int64_t* __restrict__ chunk_lo,
    const int32_t* __restrict__ chunk_seg, int n_chunks, long long V,
    int32_t* __restrict__ chunk_count) {
  __shared__ long long warps[33];
  const int c = blockIdx.x, s = blockIdx.y;
  long long cnt = 0;
  if (chunk_seg[c] != s) {                 // shard s's own ids stay home
    const uint8_t* row = mark + (long long)s * V;
    for (long long i = chunk_lo[c] + threadIdx.x; i < chunk_lo[c + 1];
         i += kThreads)
      cnt += row[order[i]];
  }
  long long total;
  block_exclusive_scan(cnt, warps, &total);
  if (threadIdx.x == 0) chunk_count[(long long)s * n_chunks + c] = (int)total;
}

__global__ void __launch_bounds__(kScanThreads) scan_kernel(
    const int32_t* __restrict__ chunk_count, int n_chunks,
    const int32_t* __restrict__ seg_chunk, int n,
    int32_t* __restrict__ chunk_off, int64_t* __restrict__ req_count) {
  __shared__ long long warps[33];
  const int s = blockIdx.x;
  const int32_t* cnt = chunk_count + (long long)s * n_chunks;
  int32_t* off = chunk_off + (long long)s * (n_chunks + 1);
  long long carry = 0;
  for (int base = 0; base < n_chunks; base += kScanThreads) {
    const int c = base + threadIdx.x;
    long long total;
    const long long x = c < n_chunks ? cnt[c] : 0;
    const long long ex = block_exclusive_scan(x, warps, &total);
    if (c < n_chunks) off[c] = (int32_t)(carry + ex);
    carry += total;
  }
  if (threadIdx.x == 0) off[n_chunks] = (int32_t)carry;
  __syncthreads();
  for (int p = threadIdx.x; p < n; p += kScanThreads)
    req_count[(long long)s * n + p] =
        off[seg_chunk[p + 1]] - off[seg_chunk[p]];
}

__global__ void __launch_bounds__(kThreads) scatter_kernel(
    const uint8_t* __restrict__ mark, const int32_t* __restrict__ order,
    const int64_t* __restrict__ chunk_lo,
    const int32_t* __restrict__ chunk_seg,
    const int32_t* __restrict__ seg_chunk,
    const int32_t* __restrict__ chunk_off, int n_chunks, int n, long long V,
    const int32_t* __restrict__ local_idx, long long r_max,
    long long local_rows, int32_t* __restrict__ req,
    int32_t* __restrict__ slot_row) {
  __shared__ long long warps[33];
  const int c = blockIdx.x, s = blockIdx.y;
  const int p = chunk_seg[c];
  if (p == s) return;                      // uniform over the block
  const uint8_t* row = mark + (long long)s * V;
  const int32_t* off = chunk_off + (long long)s * (n_chunks + 1);
  const long long lo = chunk_lo[c] + (long long)threadIdx.x * kItems;
  const long long hi = chunk_lo[c + 1];
  int32_t v[kItems];
  unsigned flags = 0;
  long long cnt = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    v[k] = 0;
    if (lo + k < hi) {
      v[k] = order[lo + k];
      if (row[v[k]]) {
        flags |= 1u << k;
        ++cnt;
      }
    }
  }
  long long total;
  long long j = (long long)off[c] - off[seg_chunk[p]] +
                block_exclusive_scan(cnt, warps, &total);
  int32_t* req_sp = req + ((long long)s * n + p) * r_max;
  int32_t* slots = slot_row + (long long)s * V;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (flags & (1u << k)) {
      req_sp[j] = local_idx[v[k]];
      slots[v[k]] = (int32_t)(local_rows + p * r_max + j);
      ++j;
    }
  }
}

__global__ void __launch_bounds__(kThreads) translate_kernel(
    const int64_t* __restrict__ hop, long long per_root, long long width,
    int steps, long long n_out, const int64_t* __restrict__ job_off,
    const int64_t* __restrict__ job_k,
    const int64_t* __restrict__ pad_vertex,
    const int32_t* __restrict__ owner, const int32_t* __restrict__ local_idx,
    const int32_t* __restrict__ slot_row, long long V,
    int32_t* __restrict__ out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_out) return;
  const long long job = i / width;
  const long long q = i - job * width;
  const int s = (int)(job / steps);
  const int64_t v = q < job_k[job] * per_root
                        ? hop[job_off[job] * per_root + q]
                        : pad_vertex[s];
  out[i] = owner[v] == s ? local_idx[v] : slot_row[(long long)s * V + v];
}

int grid_for(long long threads, unsigned* blocks) {
  const long long b = (threads + kThreads - 1) / kThreads;
  if (b > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  *blocks = (unsigned)(b > 0 ? b : 1);
  return (int)cudaSuccess;
}

}  // namespace

extern "C" {

// mark (n, V) uint8, zeroed by the caller: 1 at (root_shard[r], v) for
// every id v of trees, the concatenated hops below num_roots roots (hop h
// holds num_roots * fanout^h int64 ids), and at (s, pad_mark[s]) where
// pad_mark[s] >= 0. The wrapper checks that ids, shards and pad vertices
// lie in range.
int repro_dedup_mark(const void* trees, long long n_ids, long long num_roots,
                     int fanout, const void* root_shard, const void* pad_mark,
                     int n, long long V, void* mark, void* stream) {
  if (n_ids < 0 || num_roots < 0 || fanout < 1 || n < 1 || V < 1)
    return (int)cudaErrorInvalidValue;
  unsigned blocks;
  const int code = grid_for(n_ids + n, &blocks);
  if (code) return code;
  mark_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(trees), n_ids, num_roots, fanout,
      static_cast<const int64_t*>(root_shard),
      static_cast<const int64_t*>(pad_mark), n, V,
      static_cast<uint8_t*>(mark));
  return (int)cudaGetLastError();
}

// chunk_count (n, n_chunks) int32: shard s's marked cells in chunk c of
// `order` (the vertices by (owner, id)), chunk c covering order[chunk_lo[c]
// : chunk_lo[c + 1]] within owner chunk_seg[c]'s segment; 0 where
// chunk_seg[c] == s.
int repro_dedup_count(const void* mark, const void* order,
                      const void* chunk_lo, const void* chunk_seg,
                      int n_chunks, int n, long long V, void* chunk_count,
                      void* stream) {
  if (n_chunks < 1 || n < 1 || n > 65535 || V < 1)
    return (int)cudaErrorInvalidValue;
  count_kernel<<<dim3(n_chunks, n), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(mark), static_cast<const int32_t*>(order),
      static_cast<const int64_t*>(chunk_lo),
      static_cast<const int32_t*>(chunk_seg), n_chunks, V,
      static_cast<int32_t*>(chunk_count));
  return (int)cudaGetLastError();
}

// chunk_off (n, n_chunks + 1) int32: per shard the exclusive prefix of
// chunk_count; req_count (n, n) int64: req_count[s, p] the sum of shard
// s's counts over owner p's chunks [seg_chunk[p], seg_chunk[p + 1]).
int repro_dedup_scan(const void* chunk_count, int n_chunks,
                     const void* seg_chunk, int n, void* chunk_off,
                     void* req_count, void* stream) {
  if (n_chunks < 1 || n < 1) return (int)cudaErrorInvalidValue;
  scan_kernel<<<n, kScanThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(chunk_count), n_chunks,
      static_cast<const int32_t*>(seg_chunk), n,
      static_cast<int32_t*>(chunk_off), static_cast<int64_t*>(req_count));
  return (int)cudaGetLastError();
}

// req (n, n, r_max) int32, zeroed by the caller, and slot_row (n, V) int32
// at every marked cell outside its shard's own segment: the j-th marked id
// v of (s, p) in ascending order gets req[s, p, j] = local_idx[v] and
// slot_row[s, v] = local_rows + p * r_max + j. The caller has checked that
// every req_count[s, p] <= r_max.
int repro_dedup_scatter(const void* mark, const void* order,
                        const void* chunk_lo, const void* chunk_seg,
                        const void* seg_chunk, const void* chunk_off,
                        int n_chunks, int n, long long V,
                        const void* local_idx, long long r_max,
                        long long local_rows, void* req, void* slot_row,
                        void* stream) {
  if (n_chunks < 1 || n < 1 || n > 65535 || V < 1 || r_max < 1)
    return (int)cudaErrorInvalidValue;
  scatter_kernel<<<dim3(n_chunks, n), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(mark), static_cast<const int32_t*>(order),
      static_cast<const int64_t*>(chunk_lo),
      static_cast<const int32_t*>(chunk_seg),
      static_cast<const int32_t*>(seg_chunk),
      static_cast<const int32_t*>(chunk_off), n_chunks, n, V,
      static_cast<const int32_t*>(local_idx), r_max, local_rows,
      static_cast<int32_t*>(req), static_cast<int32_t*>(slot_row));
  return (int)cudaGetLastError();
}

// out (n_jobs, width) int32, width = batch_pad * per_root: job j = s *
// steps + t's position q holds v = hop[job_off[j] * per_root + q] for q <
// job_k[j] * per_root, else pad_vertex[s], translated to owner[v] == s ?
// local_idx[v] : slot_row[s, v].
int repro_translate_hop(const void* hop, long long per_root, long long width,
                        int steps, long long n_out, const void* job_off,
                        const void* job_k, const void* pad_vertex,
                        const void* owner, const void* local_idx,
                        const void* slot_row, long long V, void* out,
                        void* stream) {
  if (per_root < 1 || width < 1 || steps < 1 || n_out < 0 || V < 1)
    return (int)cudaErrorInvalidValue;
  if (n_out == 0) return (int)cudaSuccess;
  unsigned blocks;
  const int code = grid_for(n_out, &blocks);
  if (code) return code;
  translate_kernel<<<blocks, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(hop), per_root, width, steps, n_out,
      static_cast<const int64_t*>(job_off),
      static_cast<const int64_t*>(job_k),
      static_cast<const int64_t*>(pad_vertex),
      static_cast<const int32_t*>(owner),
      static_cast<const int32_t*>(local_idx),
      static_cast<const int32_t*>(slot_row), V, static_cast<int32_t*>(out));
  return (int)cudaGetLastError();
}

const char* repro_dedup_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
