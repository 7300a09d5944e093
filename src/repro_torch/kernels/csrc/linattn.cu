// Hand-written Hopper (sm_90a) kernel for chunked RWKV6 gated linear
// attention, with a plain C interface: repro_torch/kernels/linattn.py loads
// this file's shared library with ctypes and passes every pointer and the
// stream as an integer. The entry point launches on the stream it is given,
// does not synchronise, allocates nothing, and returns cudaGetLastError().
//
// Replaces the TPU kernel in src/repro/kernels/linattn.py (_linattn_kernel
// at :44, launched by linattn_chunked at :93). Per batch·head bh, from a
// zero state S (dk, dv), chunk by chunk of C tokens, with e the inclusive
// cumprod of w inside the chunk and e_C its value at row C-1:
//     o_t   = (q_t ⊙ e_{t-1}) · S + Σ_{s<t} ((q_t ⊙ e_{t-1}) · (k_s / e_s)) v_s
//             + ((q_t ⊙ u) · k_t) v_t
//     S     = diag(e_C) S + (k ⊙ e_C / e)ᵀ v
// and the final S is written out. Everything is float32 in and out.
//
// Domain: like the reference, the kernel assumes the decay domain
// w ∈ (0.5, 1], where e over a chunk of at most 64 tokens stays far from
// f32 underflow and k / e cannot overflow. It neither clamps w nor checks it
// on the device: clamping would change the function the reference computes,
// and a device-side check would cost a pass over w. RWKV6's
// w = exp(-exp(·)) lies near 1 in practice.
//
// What bounds it on the card: bytes. At the RWKV6 prefill's largest shape
// (BH 512, T 2048, dk = dv = 64) it must read q, k, w, v and u once and
// write o and S once, 1,350,696,960 B, which take 0.403 ms at 3.35 TB/s.
// Its four products (q_dec·(k/e)ᵀ, q_dec·S, att·v, (k ⊙ e_C/e)ᵀ·v) are
// 34.36 GFLOP; on the tensor cores in 3xTF32 (three TF32 products per f32
// product) that is 103 GFLOP, 0.208 ms at the 495 TF/s TF32 peak. So the
// design keeps the tensor cores fed while the loads stream:
//   * one block of 512 threads (16 warps) per (bh, 64-column tile of dv):
//     one block per bh for dv <= 64, so the (C, C) scores are computed once
//     per chunk. The block walks the chunks in order (the TPU's sequential
//     grid axis) with its (dk, 64) state in registers, mirrored to shared
//     memory for the next chunk's q_dec·S; nothing carries across blocks.
//   * asynchronous loads: while chunk c is computed, chunk c+1's q, k, w, v
//     arrive by cp.async (16 B a thread, .cg) in a second shared-memory
//     stage; one wait and one barrier per chunk hand it over.
//   * the decay scan in parallel: thread (d, segment) of 64 x 8 takes the
//     product of its 8 rows, then, after one barrier, its segment's prefix
//     times its rows in order; e_{t-1} is the running (exclusive) product,
//     k / e and e_C / e are reciprocals multiplied (the approximate
//     reciprocal and one Newton step), e_C the product of the segments'
//     totals. The bonus (q ⊙ u) · k is a warp reduction per row and sits
//     on the scores' diagonal, so att·v adds it.
//   * the four products on the tensor cores with mma.sync m16n8k8 TF32 in
//     3xTF32: each operand x splits into hi = tf32(x), lo = tf32(x - hi)
//     and the warp sums lo·hi + hi·lo + hi·hi of each k-step of 8 in a
//     fresh accumulator, then adds it to the running sum in f32 with
//     rounding to nearest (the tensor core's accumulation truncates), close
//     to an f32 product (single-pass TF32 misses the reference's 5e-4 by
//     44-280x, tests/test_torch_linattn.py). Each warp owns a 16 x 16
//     output tile, and each warp scheduler gets all four row blocks, so
//     the causal work spreads evenly; shared-memory row strides of 68 and
//     72 floats make every fragment load conflict-free. Causal tiles above
//     the diagonal are skipped in the scores and in att·v, and the state
//     update shares att·v's v fragments.
//   * ragged edges: rows past C and columns past dk or dv hold zeros (w's
//     padding is never read; the derived operands are written as zeros
//     there), the causal mask is a select, and stores stop at C and dv.
//   * 227,072 B of dynamic shared memory: one block per SM, 16 warps,
//     at most 128 registers a thread.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;  // 16 warps
constexpr int kMaxC = 64;      // largest chunk
constexpr int kMaxK = 64;      // largest dk
constexpr int kTileV = 64;     // dv columns per block
constexpr int kSegs = kThreads / kMaxK;   // scan segments per column
constexpr int kSegRows = kMaxC / kSegs;   // rows per scan segment
constexpr int kLdRaw = 64;     // q, k, w stage rows [t][d]
constexpr int kLdV = 72;       // v stage rows [t][j]: B operand, k = t
constexpr int kLdA = 68;       // q_dec, k/e, att rows: A or B operand, k = column
constexpr int kLdKl = 72;      // k·e_C/e rows [t][d]: A operand read transposed
constexpr int kLdS = 72;       // state rows [d][j]: B operand, k = d

// dynamic shared memory layout, in floats
constexpr int kStQ = 0;
constexpr int kStK = kStQ + kMaxC * kLdRaw;
constexpr int kStW = kStK + kMaxC * kLdRaw;
constexpr int kStV = kStW + kMaxC * kLdRaw;
constexpr int kStage = kStV + kMaxC * kLdV;         // one stage of raw inputs
constexpr int kOffQd = 2 * kStage;                  // q ⊙ e_{t-1}
constexpr int kOffKd = kOffQd + kMaxC * kLdA;       // k / e
constexpr int kOffAtt = kOffKd + kMaxC * kLdA;      // masked scores + bonus
constexpr int kOffKl = kOffAtt + kMaxC * kLdA;      // k ⊙ e_C / e
constexpr int kOffS = kOffKl + kMaxC * kLdKl;       // state
constexpr int kOffTot = kOffS + kMaxK * kLdS;       // segment products [s][d]
constexpr int kOffEl = kOffTot + kSegs * kMaxK;     // e_C [d]
constexpr int kOffB = kOffEl + kMaxK;               // bonus [t]
constexpr int kOffU = kOffB + kMaxC;                // u [d]
constexpr int kSmemFloats = kOffU + kMaxK;
constexpr size_t kSmemBytes = sizeof(float) * kSmemFloats;
static_assert(kSmemBytes <= 232448, "over the 227 KB a block may opt in to");
static_assert(kStage % 4 == 0 && kOffQd % 4 == 0, "16-byte cp.async rows");

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo to about 2^-22 relative, each a TF32 value
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// B fragment (8 x 8) as hi0, hi1, lo0, lo1: element 0 at p, element 1 at
// p + step
__device__ __forceinline__ void load_b(const float* p, int step,
                                       uint32_t (&b)[4]) {
  split(p[0], b[0], b[2]);
  split(p[step], b[1], b[3]);
}

// d += a·b for one k-step of 8, in 3xTF32: the three products, small terms
// first, sum in a fresh accumulator, which is then added to d in f32 with
// rounding to nearest. The tensor core's own accumulation truncates, so it
// never carries the running sum (the state or o) from one k-step to the next.
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&b)[4]) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(t, al, b[0], b[1]);
  mma_tf32(t, ah, b[2], b[3]);
  mma_tf32(t, ah, b[0], b[1]);
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] += t[i];
}

// 1 / x to within an ulp: the approximate reciprocal and one Newton step
__device__ __forceinline__ float recip(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return fmaf(r, fmaf(-x, r, 1.f), r);
}

// A fragment (16 x 8, rows m0.., columns k0..) of a row-major [m][k] array
__device__ __forceinline__ void load_a(const float* p, int ld, int m0, int k0,
                                       int g, int tg, uint32_t (&ah)[4],
                                       uint32_t (&al)[4]) {
  split(p[(m0 + g) * ld + k0 + tg], ah[0], al[0]);
  split(p[(m0 + g + 8) * ld + k0 + tg], ah[1], al[1]);
  split(p[(m0 + g) * ld + k0 + tg + 4], ah[2], al[2]);
  split(p[(m0 + g + 8) * ld + k0 + tg + 4], ah[3], al[3]);
}

// A fragment of the transpose of a row-major [k][m] array
__device__ __forceinline__ void load_at(const float* p, int ld, int m0, int k0,
                                        int g, int tg, uint32_t (&ah)[4],
                                        uint32_t (&al)[4]) {
  split(p[(k0 + tg) * ld + m0 + g], ah[0], al[0]);
  split(p[(k0 + tg) * ld + m0 + g + 8], ah[1], al[1]);
  split(p[(k0 + tg + 4) * ld + m0 + g], ah[2], al[2]);
  split(p[(k0 + tg + 4) * ld + m0 + g + 8], ah[3], al[3]);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// Issue the copies of one chunk's rows t0 .. t0+C-1 of q, k, w (all dk
// columns) and of v (columns j0 .. j0+nj-1) into a stage, as one group.
// vec: dk, dv and j0 are multiples of 4 and the pointers 16-byte aligned.
template <bool kFull>
__device__ __forceinline__ void load_chunk(float* st, const float* qb,
                                           const float* kb, const float* wb,
                                           const float* vb, int t0, int C,
                                           int dk, int dv, int j0, int nj,
                                           bool vec, int tid) {
  if (kFull || vec) {
    const int r4 = kFull ? kMaxK / 4 : dk / 4;
    const int v4 = kFull ? kTileV / 4 : nj / 4;
    for (int i = tid; i < C * r4; i += kThreads) {
      const int t = i / r4, c = 4 * (i - t * r4);
      const long long gi = (long long)(t0 + t) * dk + c;
      cp_async16(st + kStQ + t * kLdRaw + c, qb + gi);
      cp_async16(st + kStK + t * kLdRaw + c, kb + gi);
      cp_async16(st + kStW + t * kLdRaw + c, wb + gi);
    }
    for (int i = tid; i < C * v4; i += kThreads) {
      const int t = i / v4, c = 4 * (i - t * v4);
      cp_async16(st + kStV + t * kLdV + c,
                 vb + (long long)(t0 + t) * dv + j0 + c);
    }
  } else {
    for (int i = tid; i < C * dk; i += kThreads) {
      const int t = i / dk, c = i - t * dk;
      const long long gi = (long long)t0 * dk + i;
      cp_async4(st + kStQ + t * kLdRaw + c, qb + gi);
      cp_async4(st + kStK + t * kLdRaw + c, kb + gi);
      cp_async4(st + kStW + t * kLdRaw + c, wb + gi);
    }
    for (int i = tid; i < C * nj; i += kThreads) {
      const int t = i / nj, c = i - t * nj;
      cp_async4(st + kStV + t * kLdV + c,
                vb + (long long)(t0 + t) * dv + j0 + c);
    }
  }
  cp_async_commit();
}

// kFull: chunk = dk = 64, dv a multiple of 64 and the 16-byte copies, the
// prefill's shape, with every loop bound known to the compiler.
template <bool kFull>
__global__ void __launch_bounds__(kThreads, 1)
linattn_chunked_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ w,
                       const float* __restrict__ u, float* __restrict__ o,
                       float* __restrict__ s_out, int T, int dk, int dv,
                       int chunk, int u_stride, int v_tiles, int vec) {
  extern __shared__ __align__(16) float smem[];
  float* sqd = smem + kOffQd;
  float* skd = smem + kOffKd;
  float* satt = smem + kOffAtt;
  float* skl = smem + kOffKl;
  float* ss = smem + kOffS;
  float* stot = smem + kOffTot;
  float* sel = smem + kOffEl;
  float* sb = smem + kOffB;
  float* su = smem + kOffU;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tg = lane % 4;     // mma fragment coordinates
  // warp tile: rows 16rb, columns 16cq. A warp scheduler runs warps w,
  // w+4, w+8, w+12, which get all four row blocks, so the causal work (more
  // for later row blocks) spreads evenly over the schedulers.
  const int cq = warp / 4, rb = (warp - cq) & 3;
  const int m0 = 16 * rb;
  const long long bh = blockIdx.x / v_tiles;
  const int j0 = (blockIdx.x % v_tiles) * kTileV;
  const int nj = kFull ? kTileV : min(kTileV, dv - j0);
  const int C = kFull ? kMaxC : chunk;
  const int Cr = kFull ? kMaxC : (C + 7) / 8 * 8;    // K extent over rows
  const int dk8 = kFull ? kMaxK : (dk + 7) / 8 * 8;  // K extent over dk
  if (kFull) dk = kMaxK;

  const float* qb = q + bh * T * dk;
  const float* kb = k + bh * T * dk;
  const float* wb = w + bh * T * dk;
  const float* vb = v + bh * T * dv;
  float* ob = o + bh * T * dv;

  // v's stages and the state start as zeros, so v's rows past C and columns
  // past nj (never copied) stay 0; the bonus past C stays 0.
  for (int i = tid; i < kMaxC * kLdV; i += kThreads) {
    smem[kStV + i] = 0.f;
    smem[kStage + kStV + i] = 0.f;
  }
  for (int i = tid; i < kMaxK * kLdS; i += kThreads) ss[i] = 0.f;
  for (int i = tid; i < kMaxC; i += kThreads) sb[i] = 0.f;
  for (int i = tid; i < kMaxK; i += kThreads)
    su[i] = i < dk ? u[bh * u_stride + i] : 0.f;
  __syncthreads();
  load_chunk<kFull>(smem, qb, kb, wb, vb, 0, C, dk, dv, j0, nj, vec != 0,
                    tid);
  cp_async_wait_all();
  __syncthreads();

  // this warp's (16 x 16) tile of the state, in registers: rows m0 + g
  // (+8), columns 16cq + 8n + 2tg (+1)
  float sacc[2][4] = {};
  const int sd = tid % kMaxK, seg = tid / kMaxK;   // scan: column, segment

  for (int c = 0, t0 = 0; t0 < T; ++c, t0 += C) {
    const float* st = smem + (c & 1) * kStage;
    if (t0 + C < T)   // the next chunk into the other stage
      load_chunk<kFull>(smem + ((c + 1) & 1) * kStage, qb, kb, wb, vb, t0 + C,
                        C, dk, dv, j0, nj, vec != 0, tid);
    const float* sq = st + kStQ;
    const float* sk = st + kStK;
    const float* sw = st + kStW;
    const float* sv = st + kStV;

    // ---- 1. each segment's product of w; the bonus row sums
    if (sd < dk) {
      float p = 1.f;
#pragma unroll
      for (int i = 0; i < kSegRows; ++i) {
        const int t = kSegRows * seg + i;
        if (t < C) p *= sw[t * kLdRaw + sd];
      }
      stot[seg * kMaxK + sd] = p;
    }
    for (int t = warp; t < C; t += kThreads / 32) {
      float acc = 0.f;
      for (int d = lane; d < dk; d += 32)
        acc += (sq[t * kLdRaw + d] * su[d]) * sk[t * kLdRaw + d];
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) sb[t] = acc;
    }
    __syncthreads();

    // ---- 2. e within the segment from its prefix; the decayed operands
    {
      const int d = sd;
      float e = 1.f, el = 0.f;
      if (d < dk) {
        el = 1.f;
#pragma unroll
        for (int s = 0; s < kSegs; ++s) {
          const float p = stot[s * kMaxK + d];
          if (s < seg) e *= p;
          el *= p;
        }
        if (seg == 0) sel[d] = el;
      } else if (seg == 0) {
        sel[d] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < kSegRows; ++i) {
        const int t = kSegRows * seg + i;
        float qd = 0.f, kd = 0.f, kl = 0.f;
        if (d < dk && t < C) {
          const float kt = sk[t * kLdRaw + d];
          qd = sq[t * kLdRaw + d] * e;           // q ⊙ e_{t-1}
          e *= sw[t * kLdRaw + d];               // e_t
          const float r = recip(e);
          kd = kt * r;                           // k / e
          kl = kt * (el * r);                    // k ⊙ e_C / e
        }
        sqd[t * kLdA + d] = qd;
        skd[t * kLdA + d] = kd;
        skl[t * kLdKl + d] = kl;
      }
    }
    __syncthreads();

    // ---- 3. scores q_dec·(k/e)ᵀ, strictly causal, the bonus on the diagonal
    if (16 * cq <= m0 && 16 * cq < Cr) {
      float acc[2][4] = {};
#pragma unroll
      for (int k0 = 0; k0 < dk8; k0 += 8) {
        uint32_t ah[4], al[4];
        load_a(sqd, kLdA, m0, k0, g, tg, ah, al);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const int s0 = 16 * cq + 8 * n;
          if (s0 >= Cr) continue;
          uint32_t bf[4];
          load_b(skd + (s0 + g) * kLdA + k0 + tg, 4, bf);
          mma3(acc[n], ah, al, bf);
        }
      }
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int s0 = 16 * cq + 8 * n;
        if (s0 >= Cr) continue;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int t = m0 + g + 8 * (r / 2), s = s0 + 2 * tg + r % 2;
          satt[t * kLdA + s] = s < t ? acc[n][r] : (s == t ? sb[t] : 0.f);
        }
      }
    }
    __syncthreads();

    // ---- 4. o = q_dec·S + att·v (the bonus rides on att's diagonal) and
    //         S = diag(e_C) S + (k ⊙ e_C/e)ᵀ v, the last two sharing v's
    //         fragments
    {
      float acc[2][4] = {};
#pragma unroll
      for (int k0 = 0; k0 < dk8; k0 += 8) {
        uint32_t ah[4], al[4];
        load_a(sqd, kLdA, m0, k0, g, tg, ah, al);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const int n0 = 16 * cq + 8 * n;
          if (n0 >= nj) continue;
          uint32_t bf[4];
          load_b(ss + (k0 + tg) * kLdS + n0 + g, 4 * kLdS, bf);
          mma3(acc[n], ah, al, bf);
        }
      }
      const bool state = m0 < dk;
      if (state) {
        const float e0 = sel[m0 + g], e1 = sel[m0 + g + 8];
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          sacc[n][0] *= e0;
          sacc[n][1] *= e0;
          sacc[n][2] *= e1;
          sacc[n][3] *= e1;
        }
      }
      const int kend = min(m0 + 16, Cr);
#pragma unroll
      for (int k0 = 0; k0 < Cr; k0 += 8) {
        uint32_t bf[2][4];
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const int n0 = 16 * cq + 8 * n;
          if (n0 < nj) load_b(sv + (k0 + tg) * kLdV + n0 + g, 4 * kLdV, bf[n]);
        }
        if (k0 < kend) {
          uint32_t ah[4], al[4];
          load_a(satt, kLdA, m0, k0, g, tg, ah, al);
#pragma unroll
          for (int n = 0; n < 2; ++n)
            if (16 * cq + 8 * n < nj) mma3(acc[n], ah, al, bf[n]);
        }
        if (state) {
          uint32_t ah[4], al[4];
          load_at(skl, kLdKl, m0, k0, g, tg, ah, al);
#pragma unroll
          for (int n = 0; n < 2; ++n)
            if (16 * cq + 8 * n < nj) mma3(sacc[n], ah, al, bf[n]);
        }
      }
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int n0 = 16 * cq + 8 * n;
        if (n0 >= nj) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int t = m0 + g + 8 * h, j = n0 + 2 * tg;
          if (t >= C) continue;
          float* dst = ob + (long long)(t0 + t) * dv + j0 + j;
          if (j + 1 < nj && (dv % 2) == 0) {
            *reinterpret_cast<float2*>(dst) =
                make_float2(acc[n][2 * h], acc[n][2 * h + 1]);
          } else {
            if (j < nj) dst[0] = acc[n][2 * h];
            if (j + 1 < nj) dst[1] = acc[n][2 * h + 1];
          }
        }
      }
    }
    cp_async_wait_all();     // the next chunk has landed (this thread's part)
    __syncthreads();         // ... everyone's; S and this stage are free

    // ---- 5. the new state into shared memory for the next chunk's q_dec·S
    if (m0 < dk) {
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int j = 16 * cq + 8 * n + 2 * tg;
        ss[(m0 + g) * kLdS + j] = sacc[n][0];
        ss[(m0 + g) * kLdS + j + 1] = sacc[n][1];
        ss[(m0 + g + 8) * kLdS + j] = sacc[n][2];
        ss[(m0 + g + 8) * kLdS + j + 1] = sacc[n][3];
      }
    }
  }

  if (m0 < dk) {
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int d = m0 + g + 8 * (r / 2);
        const int j = 16 * cq + 8 * n + 2 * tg + r % 2;
        if (d < dk && j < nj) s_out[(bh * dk + d) * dv + j0 + j] = sacc[n][r];
      }
    }
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
    for (auto kernel : {linattn_chunked_kernel<true>,
                        linattn_chunked_kernel<false>}) {
      err = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)kSmemBytes);
      if (err != cudaSuccess) return (int)err;
    }
    if (dev < 64) opted_in[dev] = true;
  }
  const int v_tiles = (dv + kTileV - 1) / kTileV;
  const long long blocks = bh * v_tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const uintptr_t ptrs = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v |
                         (uintptr_t)w;
  const int vec = dk % 4 == 0 && dv % 4 == 0 && ptrs % 16 == 0;
  const bool full = vec && chunk == kMaxC && dk == kMaxK && dv % kTileV == 0;
  auto kernel = full ? linattn_chunked_kernel<true>
                     : linattn_chunked_kernel<false>;
  kernel<<<(unsigned)blocks, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)w,
      (const float*)u, (float*)o, (float*)s_out, T, dk, dv, chunk, u_stride,
      v_tiles, vec);
  return (int)cudaGetLastError();
}

// dynamic shared memory of one block, in bytes
long long repro_linattn_smem_bytes() { return (long long)kSmemBytes; }

const char* repro_linattn_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
