// Hand-written Hopper (sm_90a) kernel for the training planner's sampling
// stage, with a plain C interface: the Python wrapper in
// repro_torch/kernels/sample_tree.py loads this file's shared library with
// ctypes and passes every pointer and the stream as an integer. The entry
// point launches on the stream it is given, does not synchronise, allocates
// nothing, and returns cudaGetLastError().
//
// sample_hop replaces no TPU kernel: the JAX package samples on the host
// (src/repro/graph/sampler.py, _sample_neighbors), and so did the port
// until the planner's sampling stage came to set the pace of training. It
// expands one hop of fixed-fanout trees for a whole frontier:
//     out[p * f + j] = the j-th stateless draw among frontier[p]'s
//                      neighbours at this hop and seed
// and reproduces repro_torch.graph.sampler._sample_neighbors bit for bit:
// the uint64 key v * 0x100000001B3 + j + hop * 0x9E3779B9 + seed *
// 0xDEADBEEF63 (the last two terms folded by the wrapper into one salt,
// which changes nothing mod 2^64), the SplitMix64 finalizer with the same
// constants, h % max(deg, 1), the clamp to nnz - 1, a self-loop for a
// vertex of degree 0, and an int64 output. Since the hash sees only the
// vertex, one launch expands the concatenated frontiers of all of a plan's
// (shard, step) jobs at once.
// What bounds it on the card: device memory latency. Each output position
// reads its frontier vertex, two indptr words and one neighbour id at a
// random place in a CSR of 0.5-1 GB, and writes 8 bytes: a SAGE-sized plan's
// three hops read about 3 MB of frontier and indptr and 4.5 MB of indices
// and write 9.1 MB, some 5 us at the card's bandwidth, less than a launch
// costs. Design: one thread per output position. Neighbouring threads share
// a frontier vertex (f of them in a row), so its indptr words come from one
// load the warp coalesces; the neighbour reads are independent, and a
// launch of a million threads keeps enough of them in flight to cover the
// latency. The 64-bit modulo is emulated in software, a few dozen
// instructions a thread, far below what the memory takes. Offsets are
// 64-bit: nnz passes 2^31 on larger graphs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ unsigned long long splitmix64(
    unsigned long long x) {
  x += 0x9E3779B97F4A7C15ull;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

__global__ void __launch_bounds__(kThreads) sample_hop_kernel(
    const int64_t* __restrict__ indptr, const int32_t* __restrict__ indices,
    const int64_t* __restrict__ frontier, int64_t* __restrict__ out,
    long long n_out, int fanout, long long nnz, unsigned long long salt) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_out) return;
  const long long p = i / fanout;
  const int slot = (int)(i - p * fanout);
  const int64_t v = frontier[p];
  const int64_t start = indptr[v];
  const int64_t deg = indptr[v + 1] - start;
  if (deg == 0) {            // degree 0 self-loops
    out[i] = v;
    return;
  }
  const unsigned long long key =
      (unsigned long long)v * 0x100000001B3ull + (unsigned long long)slot +
      salt;
  const long long off =
      (long long)(splitmix64(key) % (unsigned long long)deg);
  const long long flat = min(start + off, nnz - 1);
  out[i] = (int64_t)indices[flat];
}

}  // namespace

extern "C" {

// out (n_frontier * fanout,) int64 = one hop's draws below frontier
// (n_frontier,) int64, from the CSR indptr (V + 1,) int64 and indices
// (nnz,) int32; salt = hop * 0x9E3779B9 + seed * 0xDEADBEEF63 mod 2^64.
// The wrapper checks the roots' ids; the CSR was checked when it was built
// (indptr non-decreasing from 0 to nnz, every index in [0, V)), so every
// id a hop writes is a vertex, and indices is read only where deg > 0.
int repro_sample_hop(const void* indptr, const void* indices,
                     const void* frontier, void* out, long long n_frontier,
                     int fanout, long long nnz, unsigned long long salt,
                     void* stream) {
  if (n_frontier < 0 || fanout < 1 || nnz < 0)
    return (int)cudaErrorInvalidValue;
  const long long n_out = n_frontier * fanout;
  if (n_out == 0) return (int)cudaSuccess;
  const long long blocks = (n_out + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  sample_hop_kernel<<<(unsigned int)blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(indptr),
      static_cast<const int32_t*>(indices),
      static_cast<const int64_t*>(frontier), static_cast<int64_t*>(out),
      n_out, fanout, nnz, salt);
  return (int)cudaGetLastError();
}

const char* repro_sample_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
