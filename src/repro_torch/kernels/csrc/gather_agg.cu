// Hand-written Hopper (sm_90a) kernels for the GNN feature path, with a
// plain C interface: the Python wrappers in repro_torch/kernels/gather_agg.py
// load this file's shared library with ctypes and pass every pointer and the
// stream as an integer. Each entry point launches on the stream it is given,
// does not synchronise, allocates nothing, and returns cudaGetLastError().
//
// gather_rows replaces the TPU kernel in src/repro/kernels/gather_agg.py
// (_gather_rows_kernel, launched by _gather_rows_call):
//     out[i] = table[idx[i]]
// What bounds it on the card: device memory bandwidth. It reads n indices
// and n rows and writes n rows, with no arithmetic. Design: one warp per
// output row. The warp loads idx[i] itself (the TPU prefetched indices into
// SMEM) and its lanes copy the row in the widest word (16, 8, 4 or 2 bytes)
// that divides the row and both base pointers, so neighbouring lanes touch
// neighbouring addresses and each load is coalesced. The copy moves bytes,
// so one kernel serves every dtype and the result is bit-exact. Offsets are
// 64-bit: R * d passes 2^31 on larger graphs. The TPU's 128-lane column
// split (_dim_splits) is a TPU layout detail and has no counterpart here.
//
// gather_agg replaces _gather_agg_kernel in the same file (launched by
// gather_agg there):
//     out[i] = reduce_{j < f} table[idx[i, j]],  reduce in {sum, mean, max}
// The TPU kernel walks a sequential f grid axis and revisits the output
// block in VMEM; blocks here run in no order, so each output row is reduced
// by one group of lanes from start to end and nothing carries across blocks.
// What bounds it: device memory. It reads n*f indices and the rows they
// name and writes n rows, with one add or compare per element read (a row
// of 100 float32 against f = 10: 4,000 B read, 400 B written, 1,000 adds,
// far below the float32 rate). Repeated rows come from L2 or L1, so the
// n*f*row bytes that reach the SMs exceed the bound's distinct rows. A
// gather of short rows nears that bound only with many independent loads in
// flight, and the first design had few: one warp per row, one 4-byte element
// per lane, a runtime f loop re-reading idx[i, j] on every column pass, so
// each table load waited on its own index load and a 100-wide row left 28
// of 32 lanes idle on its last pass. This design, step by step:
//   1. Indices once per row. The lanes of a row's group read its f indices
//      in one coalesced load (a group at a time where f exceeds the group)
//      and hand each to every lane with __shfl_sync.
//   2. Wide words. Each lane moves the widest word (16, 8, 4 or 2 bytes) that
//      divides the row's bytes and both base pointers, gather_rows' rule,
//      and widens it to float32 in registers. A row of W words gets a group
//      of G lanes, G the power of two >= W capped at 32, so a warp reduces
//      32/G rows at once: float32 at d = 100 is 25 words of 16 B on 25 lanes
//      of one warp; bfloat16 at d = 100 is 25 words of 8 B. Rows wider than
//      32 words take one pass per 32 words.
//   3. Unrolled loads. f is a template parameter for the fanout the repo
//      runs (10, GNNConfig's default), so a lane's f loads are independent,
//      unrolled, and written ahead of the adds; ptxas then keeps several
//      16-byte loads in flight per lane. Any other f takes the generic
//      instance, which loads in unrolled chunks of 8 and adds in the same
//      order; at f = 10 it takes 1.7-2.1 times as long (PERF.md section 6).
//      Which instance runs is decided by f alone.
// A staged design (TMA bulk copies of each neighbour row into a per-warp
// ring in shared memory, cp.async for narrower words, a persistent grid) was
// built and timed against this one and was slower at every shape; most at
// the training shape, whose neighbour lists repeat rows that plain loads
// find in L1 and bulk copies, which bypass L1, fetch from L2 each time
// (PERF.md section 6).
// What it computes is the plain version's arithmetic (kernels/ref.py): a
// float32 accumulator started from neighbour 0 and combined in neighbour
// order 0..f-1 with no FMA; mean divides once, after the sum; max keeps the
// first of equal values and propagates NaN (v > acc || v != v); the result
// is cast to the table's dtype with round-to-nearest-even. Offsets are
// 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = 32 * kWarpsPerBlock;
// gather_agg: at the shapes of the GNN paths its grid is under one wave, and
// blocks of 4 warps spread it more evenly over the SMs than blocks of 8.
constexpr int kAggWarps = 4;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kChunk = 8;   // generic fanout: neighbour loads in flight

enum Reduce { kSum = 0, kMean = 1, kMax = 2 };
enum Dtype { kF32 = 0, kBF16 = 1 };

template <typename V>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const V* __restrict__ table, const int32_t* __restrict__ idx,
                   V* __restrict__ out, long long n, long long words_per_row) {
  const long long row =
      (long long)blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  if (row >= n) return;
  const int lane = threadIdx.x % 32;
  const V* src = table + (long long)idx[row] * words_per_row;
  V* dst = out + row * words_per_row;
  for (long long c = lane; c < words_per_row; c += 32) dst[c] = src[c];
}

// A word of 16, 8, 4 or 2 bytes as 32-bit parts (a 2-byte word is one part
// with the high half zero) and as E float32 elements once widened.
template <typename Wd>
struct Parts {
  static constexpr int K = sizeof(Wd) < 4 ? 1 : (int)sizeof(Wd) / 4;
};
template <bool BF, typename Wd>
struct Elems {
  static constexpr int E = (int)sizeof(Wd) / (BF ? 2 : 4);
};

__device__ __forceinline__ void split(const uint4& w, uint32_t* u) {
  u[0] = w.x; u[1] = w.y; u[2] = w.z; u[3] = w.w;
}
__device__ __forceinline__ void split(const uint2& w, uint32_t* u) {
  u[0] = w.x; u[1] = w.y;
}
__device__ __forceinline__ void split(uint32_t w, uint32_t* u) { u[0] = w; }
__device__ __forceinline__ void split(uint16_t w, uint32_t* u) { u[0] = w; }
__device__ __forceinline__ void join(const uint32_t* u, uint4& w) {
  w = make_uint4(u[0], u[1], u[2], u[3]);
}
__device__ __forceinline__ void join(const uint32_t* u, uint2& w) {
  w = make_uint2(u[0], u[1]);
}
__device__ __forceinline__ void join(const uint32_t* u, uint32_t& w) {
  w = u[0];
}
__device__ __forceinline__ void join(const uint32_t* u, uint16_t& w) {
  w = (uint16_t)u[0];
}

// bfloat16 element e sits in the low half of part e/2 when e is even (little
// endian); widening it to float32 is exact.
template <bool BF, typename Wd>
__device__ __forceinline__ void widen(const Wd& w,
                                      float (&x)[Elems<BF, Wd>::E]) {
  uint32_t u[Parts<Wd>::K];
  split(w, u);
#pragma unroll
  for (int e = 0; e < Elems<BF, Wd>::E; ++e) {
    if constexpr (BF) {
      x[e] = __uint_as_float((e & 1) ? (u[e / 2] & 0xffff0000u)
                                     : (u[e / 2] << 16));
    } else {
      x[e] = __uint_as_float(u[e]);
    }
  }
}

template <bool BF, typename Wd>
__device__ __forceinline__ Wd narrow(const float (&x)[Elems<BF, Wd>::E]) {
  uint32_t u[Parts<Wd>::K];
#pragma unroll
  for (int k = 0; k < Parts<Wd>::K; ++k) u[k] = 0;
#pragma unroll
  for (int e = 0; e < Elems<BF, Wd>::E; ++e) {
    if constexpr (BF) {
      const uint32_t b = __bfloat16_as_ushort(__float2bfloat16_rn(x[e]));
      u[e / 2] |= (e & 1) ? (b << 16) : b;
    } else {
      u[e] = __float_as_uint(x[e]);
    }
  }
  Wd w;
  join(u, w);
  return w;
}

template <bool MAX>
__device__ __forceinline__ float combine(float acc, float v) {
  if constexpr (MAX) return (v > acc || v != v) ? v : acc;
  return acc + v;
}

// Neighbour indices j0 .. j0+C-1 of a row into nbr[], for every lane of the
// row's group: the group's lanes load `group` consecutive indices at once and
// pass each round with __shfl_sync. Every lane of the warp takes part.
template <int C>
__device__ __forceinline__ void row_indices(const int32_t* __restrict__ nbr_idx,
                                            bool live, int j0, int fan, int q,
                                            int group, int (&nbr)[C]) {
  int mine = 0;
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const int src = k & (group - 1);
    if (src == 0) {
      const int j = j0 + k + q;
      mine = (live && k + q < C && j < fan) ? __ldg(nbr_idx + j) : 0;
    }
    nbr[k] = __shfl_sync(kFullMask, mine, src, group);
  }
}

// One group of `group` lanes per output row, 32 / group rows per warp; lane q
// of a group owns words q, q + group, ... of its row. F > 0: the fanout, its
// loads unrolled; F == 0: any fanout f, in chunks of kChunk neighbours.
template <bool BF, typename Wd, bool MAX, int F>
__global__ void __launch_bounds__(32 * kAggWarps)
gather_agg_kernel(const Wd* __restrict__ table, const int32_t* __restrict__ idx,
                  Wd* __restrict__ out, long long n, int f, int words,
                  int group, bool mean) {
  constexpr int E = Elems<BF, Wd>::E;
  constexpr int C = F > 0 ? F : kChunk;
  const int fan = F > 0 ? F : f;
  const int lane = threadIdx.x & 31;
  const int q = lane & (group - 1);
  const long long first =
      ((long long)blockIdx.x * kAggWarps + threadIdx.x / 32) * (32 / group);
  if (first >= n) return;  // the whole warp: the shuffles stay converged
  const long long row = first + lane / group;
  const bool live = row < n;
  const int32_t* nbr_idx = idx + (live ? row : first) * fan;

  int nbr[C];
  if (F > 0) row_indices<C>(nbr_idx, live, 0, fan, q, group, nbr);
  for (int c0 = 0; c0 < words; c0 += group) {  // one pass if words <= group
    const int c = c0 + q;
    const bool on = live && c < words;
    float acc[E];
    for (int j0 = 0; j0 < fan; j0 += C) {      // one trip when F > 0
      if (F == 0) row_indices<C>(nbr_idx, live, j0, fan, q, group, nbr);
      Wd v[C];
#pragma unroll
      for (int k = 0; k < C; ++k) {
        if (on && (F > 0 || j0 + k < fan)) {
          v[k] = __ldg(table + (long long)nbr[k] * words + c);
        }
      }
#pragma unroll
      for (int k = 0; k < C; ++k) {
        if (on && (F > 0 || j0 + k < fan)) {
          float x[E];
          widen<BF>(v[k], x);
#pragma unroll
          for (int e = 0; e < E; ++e) {
            acc[e] = (j0 + k == 0) ? x[e] : combine<MAX>(acc[e], x[e]);
          }
        }
      }
    }
    if (on) {
      if (mean) {
#pragma unroll
        for (int e = 0; e < E; ++e) acc[e] = acc[e] / (float)fan;
      }
      out[row * words + c] = narrow<BF, Wd>(acc);
    }
  }
}

template <bool BF, typename Wd, bool MAX, int F>
cudaError_t launch_agg(const void* table, const void* idx, void* out,
                       long long n, int f, int words, int group, bool mean,
                       cudaStream_t s) {
  const long long rows_per_block = (long long)kAggWarps * (32 / group);
  const unsigned int blocks =
      (unsigned int)((n + rows_per_block - 1) / rows_per_block);
  gather_agg_kernel<BF, Wd, MAX, F><<<blocks, 32 * kAggWarps, 0, s>>>(
      static_cast<const Wd*>(table), static_cast<const int32_t*>(idx),
      static_cast<Wd*>(out), n, f, words, group, mean);
  return cudaGetLastError();
}

// Which instance runs is decided by f alone: the fanout with an instance of
// its own (GNNConfig's default, 10), else the generic one (F = 0).
template <bool BF, typename Wd, bool MAX>
cudaError_t launch_fan(const void* table, const void* idx, void* out,
                       long long n, int f, int words, int group, bool mean,
                       cudaStream_t s) {
  switch (f) {
    case 10:
      return launch_agg<BF, Wd, MAX, 10>(table, idx, out, n, f, words, group,
                                         mean, s);
    default:
      return launch_agg<BF, Wd, MAX, 0>(table, idx, out, n, f, words, group,
                                        mean, s);
  }
}

template <bool BF, typename Wd>
cudaError_t launch_reduce(const void* table, const void* idx, void* out,
                          long long n, int f, int words, int group,
                          int reduce, cudaStream_t s) {
  switch (reduce) {
    case kSum:
    case kMean:
      return launch_fan<BF, Wd, false>(table, idx, out, n, f, words, group,
                                       reduce == kMean, s);
    case kMax:
      return launch_fan<BF, Wd, true>(table, idx, out, n, f, words, group,
                                      false, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <bool BF>
cudaError_t launch_word(const void* table, const void* idx, void* out,
                        long long n, int f, int words, int group, int reduce,
                        int word_bytes, cudaStream_t s) {
  switch (word_bytes) {
    case 16:
      return launch_reduce<BF, uint4>(table, idx, out, n, f, words, group,
                                      reduce, s);
    case 8:
      return launch_reduce<BF, uint2>(table, idx, out, n, f, words, group,
                                      reduce, s);
    case 4:
      return launch_reduce<BF, uint32_t>(table, idx, out, n, f, words, group,
                                         reduce, s);
    case 2:
      if (!BF) return cudaErrorInvalidValue;  // a float32 row has 4-byte words
      return launch_reduce<true, uint16_t>(table, idx, out, n, f, words,
                                           group, reduce, s);
    default:
      return cudaErrorInvalidValue;
  }
}

unsigned int blocks_for(long long n) {
  return (unsigned int)((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

}  // namespace

extern "C" {

// out (n, row_bytes) = table rows idx[0..n); word_bytes in {16, 8, 4, 2}
// divides row_bytes and both base pointers (the wrapper checks).
int repro_gather_rows(const void* table, const void* idx, void* out,
                      long long n, long long row_bytes, int word_bytes,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* i = static_cast<const int32_t*>(idx);
  const long long words = row_bytes / word_bytes;
  switch (word_bytes) {
    case 16:
      gather_rows_kernel<uint4><<<blocks_for(n), kThreads, 0, s>>>(
          static_cast<const uint4*>(table), i, static_cast<uint4*>(out), n, words);
      break;
    case 8:
      gather_rows_kernel<uint2><<<blocks_for(n), kThreads, 0, s>>>(
          static_cast<const uint2*>(table), i, static_cast<uint2*>(out), n, words);
      break;
    case 4:
      gather_rows_kernel<uint32_t><<<blocks_for(n), kThreads, 0, s>>>(
          static_cast<const uint32_t*>(table), i, static_cast<uint32_t*>(out), n, words);
      break;
    case 2:
      gather_rows_kernel<uint16_t><<<blocks_for(n), kThreads, 0, s>>>(
          static_cast<const uint16_t*>(table), i, static_cast<uint16_t*>(out), n, words);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// out (n, row_bytes) = reduce over f of table rows idx[i, 0..f); dtype: 0
// f32, 1 bf16; reduce: 0 sum, 1 mean, 2 max. The wrapper picks the launch
// shape (gather_agg.agg_shape): word_bytes divides row_bytes and both base
// pointers; group, the lanes per row, is a power of two <= 32 (a row wider
// than group words takes one pass per group words).
int repro_gather_agg(const void* table, const void* idx, void* out,
                     long long n, int f, long long row_bytes, int word_bytes,
                     int group, int dtype, int reduce, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || f < 1 || word_bytes < 2 || row_bytes % word_bytes != 0 ||
      row_bytes / word_bytes > (1 << 30) || group < 1 || group > 32 ||
      (group & (group - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  const int words = (int)(row_bytes / word_bytes);
  switch (dtype) {
    case kF32:
      return (int)launch_word<false>(table, idx, out, n, f, words, group,
                                     reduce, word_bytes, s);
    case kBF16:
      return (int)launch_word<true>(table, idx, out, n, f, words, group,
                                    reduce, word_bytes, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
