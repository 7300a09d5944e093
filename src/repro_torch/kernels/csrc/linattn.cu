// Hand-written Hopper (sm_90a) kernel for chunked RWKV6 gated linear
// attention, with a plain C interface: repro_torch/kernels/linattn.py loads
// this file's shared library with ctypes and passes every pointer and the
// stream as an integer. The entry point launches on the stream it is given,
// does not synchronise, allocates nothing, and returns cudaGetLastError().
//
// linattn_chunked replaces the TPU kernel in src/repro/kernels/linattn.py
// (_linattn_kernel, launched by linattn_chunked). Per batch·head bh, from a
// zero state S (dk, dv), chunk by chunk of C tokens, with e the inclusive
// cumprod of w inside the chunk:
//     o_t   = (q_t ⊙ e_{t-1}) · S + Σ_{s<t} ((q_t ⊙ e_{t-1}) · (k_s / e_s)) v_s
//             + ((q_t ⊙ u) · k_t) v_t
//     S     = diag(e_C) S + (k ⊙ e_C / e)ᵀ v
// and the final S is written out. e_{t-1} is computed as e_t / w_t, k / e and
// e_C / e as divisions, as the TPU kernel does (no reciprocals multiplied),
// so the plain version (kernels/ref.py, linattn_chunked_ref) follows the same
// arithmetic. Everything runs in float32.
//
// Domain: like the reference, the kernel assumes the decay domain
// w ∈ (0.5, 1], where e over a chunk of at most 64 tokens stays far from
// f32 underflow and k / e cannot overflow. It neither clamps w nor checks it
// on the device: clamping would change the function the reference computes,
// and a device-side check would cost a pass over w. RWKV6's
// w = exp(-exp(·)) lies near 1 in practice.
//
// What bounds it on the card: per chunk and bh four products of 2·C·dk·dv
// flops (q_dec·kdᵀ, q_dec·S, att·v, klᵀ·v) against reading q, k, v, w once,
// about 8 flops per byte at C = dk = dv = 64 f32, so the f32 rate (67 TF/s,
// no tensor cores) and the 3.35 TB/s memory rate give bounds of the same
// order. Design, simple first:
//   * one block of 256 threads per (bh, 32-column tile of dv): columns of
//     v, o and S are independent given the chunk's decays, so splitting dv
//     doubles the blocks beyond BH (the TPU's parallel BH grid axis). Each
//     block recomputes the chunk's (C, C) scores for its tile.
//   * the block walks the chunks in order (the TPU's sequential chunk axis
//     of the grid) holding its (dk, 32) f32 state slice in shared memory;
//     nothing carries across blocks.
//   * per chunk: load q, k, w; one thread per column d runs the cumprod
//     serially and writes q_dec and k / e transposed (d-major) and
//     k · e_C / e; warps 2..7 meanwhile reduce the bonus (q ⊙ u) · k per
//     row; then the masked scores, o, and the state update run as register
//     micro-tiles (rows ty + 16 i, columns tx + 16 j) whose shared-memory
//     reads are conflict-free or broadcasts (row strides of 65 where a
//     thread walks a column).
//   * 105 KB of dynamic shared memory, so two blocks fit on one SM.
// Later work: tensor cores (the four products are MMA-shaped at C = 64),
// TMA loads of the next chunk during this one, and a parallel cumprod.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxC = 64;    // largest chunk
constexpr int kMaxK = 64;    // largest dk
constexpr int kTileV = 32;   // dv columns per block
constexpr int kPad = kMaxC + 1;

// dynamic shared memory layout, in floats
constexpr int kOffQ = 0;                            // q [t][d], stride kPad; att [t][s] later
constexpr int kOffK = kOffQ + kMaxC * kPad;         // k [t][d], stride kMaxK
constexpr int kOffW = kOffK + kMaxC * kMaxK;        // w [t][d]; v [t][j] later
constexpr int kOffE = kOffW + kMaxC * kMaxK;        // e [t][d]; k·e_C/e later
constexpr int kOffQd = kOffE + kMaxC * kMaxK;       // q ⊙ e_{t-1}, [d][t], stride kPad
constexpr int kOffKd = kOffQd + kMaxK * kPad;       // k / e, [d][t], stride kPad
constexpr int kOffS = kOffKd + kMaxK * kPad;        // state slice [d][j], stride kTileV
constexpr int kOffU = kOffS + kMaxK * kTileV;       // u [d]
constexpr int kOffEl = kOffU + kMaxK;               // e_C [d]
constexpr int kOffB = kOffEl + kMaxK;               // bonus [t]
constexpr int kSmemFloats = kOffB + kMaxC;
constexpr size_t kSmemBytes = sizeof(float) * kSmemFloats;

__global__ void __launch_bounds__(kThreads, 2)
linattn_chunked_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ w,
                       const float* __restrict__ u, float* __restrict__ o,
                       float* __restrict__ s_out, int T, int dk, int dv,
                       int chunk, int u_stride, int v_tiles) {
  extern __shared__ float smem[];
  float* sq = smem + kOffQ;
  float* satt = smem + kOffQ;
  float* sk = smem + kOffK;
  float* sw = smem + kOffW;
  float* sv = smem + kOffW;
  float* se = smem + kOffE;
  float* skl = smem + kOffE;
  float* sqd = smem + kOffQd;
  float* skd = smem + kOffKd;
  float* ss = smem + kOffS;
  float* su = smem + kOffU;
  float* sel = smem + kOffEl;
  float* sb = smem + kOffB;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const long long bh = blockIdx.x / v_tiles;
  const int j0 = (blockIdx.x % v_tiles) * kTileV;
  const int nj = min(kTileV, dv - j0);
  const int C = chunk;

  const float* qb = q + bh * T * dk;
  const float* kb = k + bh * T * dk;
  const float* wb = w + bh * T * dk;
  const float* vb = v + bh * T * dv;
  float* ob = o + bh * T * dv;

  for (int i = tid; i < kMaxK * kTileV; i += kThreads) ss[i] = 0.f;
  for (int d = tid; d < dk; d += kThreads) su[d] = u[bh * u_stride + d];

  for (int t0 = 0; t0 < T; t0 += C) {
    // ---- 1. load the chunk's q, k, w (rows t0 .. t0+C-1 are contiguous)
    for (int i = tid; i < C * dk; i += kThreads) {
      const int t = i / dk, d = i % dk;
      const long long g = (long long)t0 * dk + i;
      sq[t * kPad + d] = qb[g];
      sk[t * kMaxK + d] = kb[g];
      sw[t * kMaxK + d] = wb[g];
    }
    __syncthreads();

    // ---- 2. cumprod and the decayed operands (one thread per column d);
    //         the bonus row sums on warps 2..7
    if (tid < dk) {
      const int d = tid;
      float e = 1.f;
      for (int t = 0; t < C; ++t) {
        const float wt = sw[t * kMaxK + d];
        e = e * wt;
        se[t * kMaxK + d] = e;
        sqd[d * kPad + t] = sq[t * kPad + d] * (e / wt);
        skd[d * kPad + t] = sk[t * kMaxK + d] / e;
      }
      sel[d] = e;
      for (int t = 0; t < C; ++t)
        skl[t * kMaxK + d] = sk[t * kMaxK + d] * (e / se[t * kMaxK + d]);
    } else if (tid >= 64) {
      const int warp = tid / 32 - 2, lane = tid % 32;
      for (int t = warp; t < C; t += kThreads / 32 - 2) {
        float acc = 0.f;
        for (int d = lane; d < dk; d += 32)
          acc += (sq[t * kPad + d] * su[d]) * sk[t * kMaxK + d];
        for (int off = 16; off > 0; off /= 2)
          acc += __shfl_xor_sync(0xffffffffu, acc, off);
        if (lane == 0) sb[t] = acc;
      }
    }
    __syncthreads();

    // ---- 3. load this block's v tile (w is dead; columns past dv read as
    //         0, so the state's padding columns stay 0); causal scores
    for (int i = tid; i < C * kTileV; i += kThreads) {
      const int t = i / kTileV, j = i % kTileV;
      sv[i] = j < nj ? vb[(long long)(t0 + t) * dv + j0 + j] : 0.f;
    }
    {
      float acc[4][4] = {};
      for (int d = 0; d < dk; ++d) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = sqd[d * kPad + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = skd[d * kPad + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = tx + 16 * j;
          if (t < C && s < C) satt[t * kPad + s] = s < t ? acc[i][j] : 0.f;
        }
      }
    }
    __syncthreads();

    // ---- 4. o = q_dec · S + att · v + bonus ⊙ v
    {
      float a1[4][2] = {}, a2[4][2] = {};
      for (int d = 0; d < dk; ++d) {
        const float s0 = ss[d * kTileV + tx], s1 = ss[d * kTileV + tx + 16];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float a = sqd[d * kPad + ty + 16 * i];
          a1[i][0] = fmaf(a, s0, a1[i][0]);
          a1[i][1] = fmaf(a, s1, a1[i][1]);
        }
      }
      for (int s = 0; s < C; ++s) {
        const float v0 = sv[s * kTileV + tx], v1 = sv[s * kTileV + tx + 16];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = ty + 16 * i;
          const float a = t < C ? satt[t * kPad + s] : 0.f;
          a2[i][0] = fmaf(a, v0, a2[i][0]);
          a2[i][1] = fmaf(a, v1, a2[i][1]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
        if (t >= C) continue;
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int j = tx + 16 * jj;
          if (j < nj)
            ob[(long long)(t0 + t) * dv + j0 + j] =
                (a1[i][jj] + a2[i][jj]) + sb[t] * sv[t * kTileV + j];
        }
      }
    }
    __syncthreads();

    // ---- 5. S = diag(e_C) S + (k ⊙ e_C / e)ᵀ v
    {
      float acc[4][2] = {};
      for (int t = 0; t < C; ++t) {
        const float v0 = sv[t * kTileV + tx], v1 = sv[t * kTileV + tx + 16];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int d = ty + 16 * i;
          const float a = d < dk ? skl[t * kMaxK + d] : 0.f;
          acc[i][0] = fmaf(a, v0, acc[i][0]);
          acc[i][1] = fmaf(a, v1, acc[i][1]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int d = ty + 16 * i;
        if (d >= dk) continue;
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int j = tx + 16 * jj;
          ss[d * kTileV + j] = sel[d] * ss[d * kTileV + j] + acc[i][jj];
        }
      }
    }
    __syncthreads();
  }

  for (int i = tid; i < dk * nj; i += kThreads) {
    const int d = i / nj, j = i % nj;
    s_out[(bh * dk + d) * dv + j0 + j] = ss[d * kTileV + j];
  }
}

}  // namespace

extern "C" {

// q, k, w: (BH, T, dk) f32; v: (BH, T, dv) f32; u: (dk,) with u_stride 0 or
// (BH, dk) with u_stride dk; o: (BH, T, dv) f32; s_out: (BH, dk, dv) f32.
// All contiguous. 1 <= chunk <= 64, T % chunk == 0, 1 <= dk <= 64,
// 1 <= dv. The wrapper checks all of this; the kernel trusts it.
int repro_linattn_chunked(const void* q, const void* k, const void* v,
                          const void* w, const void* u, void* o, void* s_out,
                          long long bh, int T, int dk, int dv, int chunk,
                          int u_stride, void* stream) {
  // above 48 KB of dynamic shared memory needs an opt-in, once per device
  // (and not while a CUDA graph captures the launch)
  static bool opted_in[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || !opted_in[dev]) {
    err = cudaFuncSetAttribute(linattn_chunked_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) opted_in[dev] = true;
  }
  const int v_tiles = (dv + kTileV - 1) / kTileV;
  const long long blocks = bh * v_tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  linattn_chunked_kernel<<<(unsigned)blocks, kThreads, kSmemBytes,
                           (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)w,
      (const float*)u, (float*)o, (float*)s_out, T, dk, dv, chunk, u_stride,
      v_tiles);
  return (int)cudaGetLastError();
}

// dynamic shared memory of one block, in bytes
long long repro_linattn_smem_bytes() { return (long long)kSmemBytes; }

const char* repro_linattn_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
