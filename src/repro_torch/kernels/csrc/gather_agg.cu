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
// gather_agg replaces _gather_agg_kernel in the same file:
//     out[i] = reduce_{j < f} table[idx[i, j]],  reduce in {sum, mean, max}
// What bounds it: bandwidth again (n * f rows read, n rows written, one add
// or compare per element read). Design: one warp per output row; each lane
// owns columns lane, lane + 32, ... and loops over the f neighbours itself.
// That loop replaces the TPU's sequential f grid axis, which revisited the
// output block in VMEM: blocks here run in no order, so nothing carries
// across blocks. The reduction is kept in an f32 register in neighbour order
// 0..f-1, mean divides once after the sum, max starts from the first row
// (and, like torch.maximum, propagates NaN), and the result is cast to the
// table's dtype with round-to-nearest-even.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = 32 * kWarpsPerBlock;

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

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
gather_agg_kernel(const T* __restrict__ table, const int32_t* __restrict__ idx,
                  T* __restrict__ out, long long n, int f, long long d) {
  const long long row =
      (long long)blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  if (row >= n) return;
  const int lane = threadIdx.x % 32;
  const int32_t* nbr = idx + row * f;
  T* dst = out + row * d;
  for (long long c = lane; c < d; c += 32) {
    float acc = to_f32(table[(long long)nbr[0] * d + c]);
    for (int j = 1; j < f; ++j) {
      const float v = to_f32(table[(long long)nbr[j] * d + c]);
      if (R == kMax) {
        acc = (v > acc || v != v) ? v : acc;
      } else {
        acc += v;
      }
    }
    if (R == kMean) acc = acc / (float)f;
    store_as(dst + c, acc);
  }
}

unsigned int blocks_for(long long n) {
  return (unsigned int)((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

template <typename T>
cudaError_t launch_agg(const void* table, const void* idx, void* out,
                       long long n, int f, long long d, int reduce,
                       cudaStream_t s) {
  const T* t = static_cast<const T*>(table);
  const int32_t* i = static_cast<const int32_t*>(idx);
  T* o = static_cast<T*>(out);
  switch (reduce) {
    case kSum:
      gather_agg_kernel<T, kSum><<<blocks_for(n), kThreads, 0, s>>>(t, i, o, n, f, d);
      break;
    case kMean:
      gather_agg_kernel<T, kMean><<<blocks_for(n), kThreads, 0, s>>>(t, i, o, n, f, d);
      break;
    case kMax:
      gather_agg_kernel<T, kMax><<<blocks_for(n), kThreads, 0, s>>>(t, i, o, n, f, d);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
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

// out (n, d) = reduce over f of table rows idx[i, 0..f); dtype: 0 f32, 1 bf16;
// reduce: 0 sum, 1 mean, 2 max.
int repro_gather_agg(const void* table, const void* idx, void* out,
                     long long n, int f, long long d, int dtype, int reduce,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return (int)launch_agg<float>(table, idx, out, n, f, d, reduce, s);
    case kBF16:
      return (int)launch_agg<__nv_bfloat16>(table, idx, out, n, f, d, reduce, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
