// Causal flash attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the upstream Pallas TPU kernels of
// jax/experimental/pallas/ops/tpu/flash_attention.py that the JAX package
// dispatches at skypilot_tpu/ops/attention.py:115-123 for seq >= 2048:
//   - forward  `_flash_attention_kernel`  (pallas_call in `_flash_attention_impl`)
//   - dK/dV    `_flash_attention_dkv_kernel` (pallas_call in `_flash_attention_bwd_dkv`)
//   - dQ       `_flash_attention_dq_kernel`  (pallas_call in `_flash_attention_bwd_dq`)
//
// What it computes, for batch row b, query head h (kv head h / (Hq/Hkv)),
// query s and key t <= s:
//   forward   o = softmax_t(q.k_t * scale) @ v,  lse = logsumexp_t(q.k_t * scale)
//   backward  p = exp(q.k_t * scale - lse),  ds = p * (do.v_t - di) * scale,
//             dv_t += p * do,  dk_t += ds * q,  dq += ds * k_t
// with di = sum_d(o * do) computed in f32 by the caller, as upstream does
// outside its kernels. Masked scores take the upstream mask value
// -0.7 * FLT_MAX, never -inf. Layouts are the port's: q/o/do/dq
// [B, S, Hq, D], k/v/dk/dv [B, S, Hkv, D], lse/di f32 [B, Hq, S]. GQA reads
// kv head h / G directly; dK/dV of a kv head sum over the G query heads of
// its group in one block (the sum the reference's jnp.repeat backward
// forms), so no repeat is materialized and no atomics are needed.
//
// What bounds it on an H100: operations. At the training shape (B=8,
// Hq=32, S=2048, D=128) the forward does ~2.7e11 causal flops over
// ~0.3 GB, ~800 flops per byte, far above the card's ~295 bf16 balance.
//
// Design (a first, simple kernel; wgmma, TMA and a fused backward come
// later). bf16: four warps per block, each owning 16 rows of a 64-row
// tile; products are `mma.sync.m16n8k16` bf16 with f32 accumulation, and
// scores, the online softmax state (m, l) and the output accumulator stay
// in registers, the score accumulator re-packed in place as the A operand
// of the P @ V product. The forward streams 64-key K/V tiles into shared
// memory with cp.async, double-buffered, and skips tiles above the
// diagonal. Upstream ran one grid step per K/V block and carried m/l/acc
// across the sequential grid axis in VMEM scratch; Hopper blocks run in
// no order, so the K/V walk is a loop inside the block. The dK/dV kernel
// owns a 64-key tile and loops over 32-row query tiles at or below the
// diagonal for every query head of its group; the dQ kernel owns a 64-row
// query tile and loops over K/V tiles. P and dS are rounded to bf16
// before their products, as upstream rounds them to the input dtype.
// Any S works: rows past S are zero-filled on load and never stored.
// f32 inputs (parity runs) take scalar CUDA-core kernels, one thread per
// row, with the same formulas.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kMaskValue = -0.7f * 3.402823466e38f;  // upstream DEFAULT_MASK_VALUE
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockM = 64;  // query rows of a forward / dQ block, 16 per warp
constexpr int kBlockN = 64;  // keys of a K/V tile
constexpr int kBwdQ = 32;    // query rows per step of the dK/dV loop
constexpr int kPad = 8;      // bf16 padding per shared row (keeps 16-byte alignment)

// -- small helpers ----------------------------------------------------------
__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a @ b for one m16n8k16 tile: a row-major 16x16, b column-major
// 16x8, f32 accumulators. Fragment layout (g = lane / 4, t = lane % 4):
// a0 (g, 2t..), a1 (g+8, 2t..), a2 (g, 2t+8..), a3 (g+8, 2t+8..);
// b0 (k 2t.., n g), b1 (k 2t+8.., n g); d0,d1 (g, 2t..), d2,d3 (g+8, 2t..).
__device__ __forceinline__ void mma(float (&d)[4], uint32_t a0, uint32_t a1,
                                    uint32_t a2, uint32_t a3, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;  // 0 source bytes: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Rows s0 .. s0 + rows - 1 of head h of a [B, S, H, D] bf16 tensor into
// shared [rows][D + kPad], by cp.async; rows at or past S are zeros.
template <int D>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* __restrict__ src, int b,
                                          int s0, int rows, int S, int H, int h, int tid) {
  constexpr int kChunks = D / 8;
  constexpr int kLd = D + kPad;
  for (int i = tid; i < rows * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i - r * kChunks) * 8;
    const int s = s0 + r;
    const bool ok = s < S;
    const bf16* g = src + (((size_t)b * S + (ok ? s : 0)) * H + h) * D + c;
    cp_async16(dst + r * kLd + c, g, ok);
  }
}

// A fragment (16 rows x 16 columns starting at column c) of a shared
// [rows][kLd] bf16 tile whose first row is `base`.
template <int kLd>
__device__ __forceinline__ void a_frag(const bf16* base, int g, int c, uint32_t& a0,
                                       uint32_t& a1, uint32_t& a2, uint32_t& a3) {
  a0 = ld32(base + g * kLd + c);
  a1 = ld32(base + (g + 8) * kLd + c);
  a2 = ld32(base + g * kLd + c + 8);
  a3 = ld32(base + (g + 8) * kLd + c + 8);
}

// acc[16 x D] += P[16 x K] @ X[K x D] where P sits in score accumulators
// p[K/8][4] (rounded to bf16 here) and X is a shared [K][kLd] tile.
template <int D, int K, int kLd>
__device__ __forceinline__ void acc_px(float (&acc)[D / 8][4], const float (&p)[K / 8][4],
                                       const bf16* x, int g, int t4) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    const uint32_t a0 = pack_f32(p[2 * kk][0], p[2 * kk][1]);
    const uint32_t a1 = pack_f32(p[2 * kk][2], p[2 * kk][3]);
    const uint32_t a2 = pack_f32(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    const uint32_t a3 = pack_f32(p[2 * kk + 1][2], p[2 * kk + 1][3]);
    const bf16* r0 = x + (kk * 16 + t4 * 2) * kLd;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      const int col = dn * 8 + g;
      const uint32_t b0 = pack_bf16(r0[col], r0[kLd + col]);
      const uint32_t b1 = pack_bf16(r0[8 * kLd + col], r0[9 * kLd + col]);
      mma(acc[dn], a0, a1, a2, a3, b0, b1);
    }
  }
}

// s[16 x N] = A[16 x D] @ B[N x D]^T with A the 16 shared rows at `a`
// and B the N shared rows at `bm`, both [.][kLd].
template <int D, int N, int kLd>
__device__ __forceinline__ void scores(float (&s)[N / 8][4], const bf16* a, const bf16* bm,
                                       int g, int t4) {
#pragma unroll
  for (int nt = 0; nt < N / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + t4 * 2;
    uint32_t a0, a1, a2, a3;
    a_frag<kLd>(a, g, c, a0, a1, a2, a3);
#pragma unroll
    for (int nt = 0; nt < N / 8; ++nt) {
      const bf16* r = bm + (nt * 8 + g) * kLd + c;
      mma(s[nt], a0, a1, a2, a3, ld32(r), ld32(r + 8));
    }
  }
}

// Rows r (and r + 8) of a 16 x D accumulator into [B, S, H, D] bf16.
template <int D>
__device__ __forceinline__ void store_rows(bf16* __restrict__ out, const float (&acc)[D / 8][4],
                                           int b, int row, int S, int H, int h, int t4,
                                           float inv0, float inv1) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int s = row + 8 * half;
    if (s >= S) continue;
    const float inv = half ? inv1 : inv0;
    bf16* o = out + (((size_t)b * S + s) * H + h) * D + t4 * 2;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      *reinterpret_cast<uint32_t*>(o + dn * 8) =
          pack_f32(acc[dn][2 * half] * inv, acc[dn][2 * half + 1] * inv);
    }
  }
}

// -- bf16 forward -------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
               int S, int Hq, int Hkv, float scale) {
  constexpr int kLd = D + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [kBlockM][kLd]
  bf16* k_s = q_s + kBlockM * kLd;                // [2][kBlockN][kLd]
  bf16* v_s = k_s + 2 * kBlockN * kLd;            // [2][kBlockN][kLd]

  const int m_tile = gridDim.x - 1 - blockIdx.x;  // longest rows start first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = m_tile * kBlockM;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  const int n_tiles = (min(q0 + kBlockM, S) - 1) / kBlockN + 1;

  load_rows<D>(q_s, q, b, q0, kBlockM, S, Hq, h, tid);
  load_rows<D>(k_s, k, b, 0, kBlockN, S, Hkv, hk, tid);
  load_rows<D>(v_s, v, b, 0, kBlockN, S, Hkv, hk, tid);
  cp_async_commit();

  float acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY};
  float l_r[2] = {0.f, 0.f};

  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_tiles) {
      // The other buffer was last read in iteration j - 1, which ended in
      // a barrier: the next tile's copies overlap this tile's products.
      load_rows<D>(k_s + (buf ^ 1) * kBlockN * kLd, k, b, (j + 1) * kBlockN, kBlockN, S,
                   Hkv, hk, tid);
      load_rows<D>(v_s + (buf ^ 1) * kBlockN * kLd, v, b, (j + 1) * kBlockN, kBlockN, S,
                   Hkv, hk, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* ks = k_s + buf * kBlockN * kLd;
    const bf16* vs = v_s + buf * kBlockN * kLd;

    float s[kBlockN / 8][4];
    scores<D, kBlockN, kLd>(s, q_s + warp * 16 * kLd, ks, g, t4);

    const int k0 = j * kBlockN;
    const bool diag = k0 + kBlockN - 1 > q0;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + (e >> 1) * 8;
        const int col = k0 + nt * 8 + t4 * 2 + (e & 1);
        float x = s[nt][e] * scale;
        if (diag && col > row) x = kMaskValue;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // Every row sees key 0 in tile 0, so m is finite from then on.
      const float m_new = fmaxf(m_r[r], quad_max(mx[r]));
      alpha[r] = expf(m_r[r] - m_new);
      m_r[r] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[nt][e] - m_r[e >> 1]);
        s[nt][e] = p;
        sum[e >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_r[r] = l_r[r] * alpha[r] + quad_sum(sum[r]);
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      acc[dn][0] *= alpha[0];
      acc[dn][1] *= alpha[0];
      acc[dn][2] *= alpha[1];
      acc[dn][3] *= alpha[1];
    }
    acc_px<D, kBlockN, kLd>(acc, s, vs, g, t4);
    __syncthreads();
  }

  store_rows<D>(o, acc, b, row0, S, Hq, h, t4, 1.f / l_r[0], 1.f / l_r[1]);
  if (t4 == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row < S) lse[((size_t)b * Hq + h) * S + row] = m_r[r] + logf(l_r[r]);
    }
  }
}

// -- bf16 backward: dK and dV ---------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ di,
                   bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int Hq, int Hkv,
                   float scale) {
  constexpr int kLd = D + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);  // [kBlockN][kLd]
  bf16* v_s = k_s + kBlockN * kLd;                // [kBlockN][kLd]
  bf16* q_s = v_s + kBlockN * kLd;                // [kBwdQ][kLd]
  bf16* do_s = q_s + kBwdQ * kLd;                 // [kBwdQ][kLd]
  float* lse_s = reinterpret_cast<float*>(do_s + kBwdQ * kLd);  // [kBwdQ]
  float* di_s = lse_s + kBwdQ;                                  // [kBwdQ]

  const int k0 = (gridDim.x - 1 - blockIdx.x) * kBlockN;  // most work first
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int G = Hq / Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int key0 = k0 + warp * 16 + g;  // this thread's keys: key0, key0 + 8

  load_rows<D>(k_s, k, b, k0, kBlockN, S, Hkv, hk, tid);
  load_rows<D>(v_s, v, b, k0, kBlockN, S, Hkv, hk, tid);
  cp_async_commit();

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[dn][e] = dv_acc[dn][e] = 0.f;

  for (int gi = 0; gi < G; ++gi) {
    const int h = hk * G + gi;
    const float* lse_h = lse + ((size_t)b * Hq + h) * S;
    const float* di_h = di + ((size_t)b * Hq + h) * S;
    // Query tiles at or below the diagonal: those with a row >= k0.
    for (int qs = (k0 / kBwdQ) * kBwdQ; qs < S; qs += kBwdQ) {
      __syncthreads();  // the previous step is done with q_s / do_s
      load_rows<D>(q_s, q, b, qs, kBwdQ, S, Hq, h, tid);
      load_rows<D>(do_s, dout, b, qs, kBwdQ, S, Hq, h, tid);
      cp_async_commit();
      if (tid < kBwdQ) {
        const int row = qs + tid;
        lse_s[tid] = row < S ? lse_h[row] : 0.f;
        di_s[tid] = row < S ? di_h[row] : 0.f;
      }
      cp_async_wait<0>();
      __syncthreads();

      float pt[kBwdQ / 8][4], dst[kBwdQ / 8][4];
      scores<D, kBwdQ, kLd>(pt, k_s + warp * 16 * kLd, q_s, g, t4);    // S^T
      scores<D, kBwdQ, kLd>(dst, v_s + warp * 16 * kLd, do_s, g, t4);  // dP^T
      const bool diag = qs < k0 + kBlockN - 1;
#pragma unroll
      for (int nt = 0; nt < kBwdQ / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key0 + (e >> 1) * 8;
          const int r = nt * 8 + t4 * 2 + (e & 1);
          const int row = qs + r;
          float p = 0.f, ds = 0.f;
          if (row < S && (!diag || row >= key)) {
            p = expf(pt[nt][e] * scale - lse_s[r]);
            ds = p * (dst[nt][e] - di_s[r]) * scale;
          }
          pt[nt][e] = p;
          dst[nt][e] = ds;
        }
      acc_px<D, kBwdQ, kLd>(dv_acc, pt, do_s, g, t4);   // dV += P^T dO
      acc_px<D, kBwdQ, kLd>(dk_acc, dst, q_s, g, t4);   // dK += dS^T Q
    }
  }
  store_rows<D>(dk, dk_acc, b, key0, S, Hkv, hk, t4, 1.f, 1.f);
  store_rows<D>(dv, dv_acc, b, key0, S, Hkv, hk, t4, 1.f, 1.f);
}

// -- bf16 backward: dQ ------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ di,
                  bf16* __restrict__ dq, int S, int Hq, int Hkv, float scale) {
  constexpr int kLd = D + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [kBlockM][kLd]
  bf16* do_s = q_s + kBlockM * kLd;               // [kBlockM][kLd]
  bf16* k_s = do_s + kBlockM * kLd;               // [kBlockN][kLd]
  bf16* v_s = k_s + kBlockN * kLd;                // [kBlockN][kLd]

  const int m_tile = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = m_tile * kBlockM;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = q0 + warp * 16 + g;
  const int n_tiles = (min(q0 + kBlockM, S) - 1) / kBlockN + 1;

  load_rows<D>(q_s, q, b, q0, kBlockM, S, Hq, h, tid);
  load_rows<D>(do_s, dout, b, q0, kBlockM, S, Hq, h, tid);
  cp_async_commit();
  float lse_r[2], di_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const size_t at = ((size_t)b * Hq + h) * S + row;
    lse_r[r] = row < S ? lse[at] : 0.f;
    di_r[r] = row < S ? di[at] : 0.f;
  }

  float dq_acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[dn][e] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    __syncthreads();  // the previous tile is done with k_s / v_s
    load_rows<D>(k_s, k, b, j * kBlockN, kBlockN, S, Hkv, hk, tid);
    load_rows<D>(v_s, v, b, j * kBlockN, kBlockN, S, Hkv, hk, tid);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    float s[kBlockN / 8][4], dp[kBlockN / 8][4];
    scores<D, kBlockN, kLd>(s, q_s + warp * 16 * kLd, k_s, g, t4);
    scores<D, kBlockN, kLd>(dp, do_s + warp * 16 * kLd, v_s, g, t4);
    const int k0 = j * kBlockN;
    const bool diag = k0 + kBlockN - 1 > q0;
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + (e >> 1) * 8;
        const int col = k0 + nt * 8 + t4 * 2 + (e & 1);
        float ds = 0.f;
        if (row < S && (!diag || col <= row)) {
          const float p = expf(s[nt][e] * scale - lse_r[e >> 1]);
          ds = p * (dp[nt][e] - di_r[e >> 1]) * scale;
        }
        s[nt][e] = ds;
      }
    acc_px<D, kBlockN, kLd>(dq_acc, s, k_s, g, t4);  // dQ += dS K
  }
  store_rows<D>(dq, dq_acc, b, row0, S, Hq, h, t4, 1.f, 1.f);
}

// -- f32 kernels (CUDA cores, one thread per row) ---------------------------------
constexpr int kRowsF = 32;  // rows (threads) per f32 block
constexpr int kKeysF = 32;  // keys or queries per staged f32 tile

// Rows s0 .. s0 + rows - 1 of head h of a [B, S, H, D] f32 tensor into
// shared [rows][ld] (zeros past S), all threads of the block helping.
__device__ __forceinline__ void load_rows_f32(float* dst, const float* __restrict__ src,
                                              int b, int s0, int rows, int S, int H, int h,
                                              int D, int ld) {
  for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
    const int r = i / D;
    const int d = i - r * D;
    const int s = s0 + r;
    dst[r * ld + d] = s < S ? src[(((size_t)b * S + s) * H + h) * D + d] : 0.f;
  }
}

__device__ __forceinline__ float dot_f32(const float* a, const float* b, int D) {
  float s = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) s = fmaf(a[d], b[d], s);
  return s;
}

__global__ void __launch_bounds__(kRowsF)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
              int S, int Hq, int Hkv, int D, float scale) {
  extern __shared__ float sm[];
  const int ld = D + 1;
  float* q_s = sm;                     // [kRowsF][ld]
  float* acc_s = q_s + kRowsF * ld;    // [kRowsF][ld]
  float* k_s = acc_s + kRowsF * ld;    // [kKeysF][D]
  float* v_s = k_s + kKeysF * D;       // [kKeysF][D]
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRowsF;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (Hq / Hkv);
  const int r = threadIdx.x, row = q0 + r;
  load_rows_f32(q_s, q, b, q0, kRowsF, S, Hq, h, D, ld);
  for (int d = 0; d < D; ++d) acc_s[r * ld + d] = 0.f;
  float m = -INFINITY, l = 0.f;
  const int last = min(q0 + kRowsF, S) - 1;
  for (int t0 = 0; t0 <= last; t0 += kKeysF) {
    __syncthreads();
    load_rows_f32(k_s, k, b, t0, kKeysF, S, Hkv, hk, D, D);
    load_rows_f32(v_s, v, b, t0, kKeysF, S, Hkv, hk, D, D);
    __syncthreads();
    if (row >= S) continue;
    // Masked keys (t > row) add exp(mask - m) = 0: they are skipped.
    for (int tt = 0; tt < kKeysF && t0 + tt <= row; ++tt) {
      const float s = dot_f32(q_s + r * ld, k_s + tt * D, D) * scale;
      const float m_new = fmaxf(m, s);
      const float alpha = expf(m - m_new);
      const float p = expf(s - m_new);
      l = l * alpha + p;
      float* a = acc_s + r * ld;
      const float* vr = v_s + tt * D;
      for (int d = 0; d < D; ++d) a[d] = fmaf(p, vr[d], a[d] * alpha);
      m = m_new;
    }
  }
  if (row >= S) return;
  const float inv = 1.f / l;
  float* out = o + (((size_t)b * S + row) * Hq + h) * D;
  for (int d = 0; d < D; ++d) out[d] = acc_s[r * ld + d] * inv;
  lse[((size_t)b * Hq + h) * S + row] = m + logf(l);
}

__global__ void __launch_bounds__(kRowsF)
flash_bwd_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ di,
                  float* __restrict__ dk, float* __restrict__ dv, int S, int Hq, int Hkv,
                  int D, float scale) {
  extern __shared__ float sm[];
  const int ld = D + 1;
  float* k_s = sm;                   // [kRowsF][ld] this block's keys
  float* v_s = k_s + kRowsF * ld;
  float* dk_s = v_s + kRowsF * ld;
  float* dv_s = dk_s + kRowsF * ld;
  float* q_s = dv_s + kRowsF * ld;   // [kKeysF][D] staged queries
  float* do_s = q_s + kKeysF * D;
  float* lse_s = do_s + kKeysF * D;  // [kKeysF]
  float* di_s = lse_s + kKeysF;      // [kKeysF]
  const int k0 = (gridDim.x - 1 - blockIdx.x) * kRowsF;
  const int hk = blockIdx.y, b = blockIdx.z, G = Hq / Hkv;
  const int r = threadIdx.x, key = k0 + r;
  load_rows_f32(k_s, k, b, k0, kRowsF, S, Hkv, hk, D, ld);
  load_rows_f32(v_s, v, b, k0, kRowsF, S, Hkv, hk, D, ld);
  for (int d = 0; d < D; ++d) dk_s[r * ld + d] = dv_s[r * ld + d] = 0.f;
  for (int gi = 0; gi < G; ++gi) {
    const int h = hk * G + gi;
    for (int qs = (k0 / kKeysF) * kKeysF; qs < S; qs += kKeysF) {
      __syncthreads();
      load_rows_f32(q_s, q, b, qs, kKeysF, S, Hq, h, D, D);
      load_rows_f32(do_s, dout, b, qs, kKeysF, S, Hq, h, D, D);
      if (r < kKeysF) {
        const int row = qs + r;
        lse_s[r] = row < S ? lse[((size_t)b * Hq + h) * S + row] : 0.f;
        di_s[r] = row < S ? di[((size_t)b * Hq + h) * S + row] : 0.f;
      }
      __syncthreads();
      if (key >= S) continue;
      for (int i = 0; i < kKeysF; ++i) {
        const int row = qs + i;
        if (row >= S) break;
        if (row < key) continue;
        const float* qr = q_s + i * D;
        const float* dor = do_s + i * D;
        const float p = expf(dot_f32(qr, k_s + r * ld, D) * scale - lse_s[i]);
        const float ds = p * (dot_f32(dor, v_s + r * ld, D) - di_s[i]) * scale;
        for (int d = 0; d < D; ++d) {
          dv_s[r * ld + d] = fmaf(p, dor[d], dv_s[r * ld + d]);
          dk_s[r * ld + d] = fmaf(ds, qr[d], dk_s[r * ld + d]);
        }
      }
    }
  }
  if (key >= S) return;
  const size_t at = (((size_t)b * S + key) * Hkv + hk) * D;
  for (int d = 0; d < D; ++d) {
    dk[at + d] = dk_s[r * ld + d];
    dv[at + d] = dv_s[r * ld + d];
  }
}

__global__ void __launch_bounds__(kRowsF)
flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ di,
                 float* __restrict__ dq, int S, int Hq, int Hkv, int D, float scale) {
  extern __shared__ float sm[];
  const int ld = D + 1;
  float* q_s = sm;                    // [kRowsF][ld]
  float* do_s = q_s + kRowsF * ld;
  float* dq_s = do_s + kRowsF * ld;
  float* k_s = dq_s + kRowsF * ld;    // [kKeysF][D]
  float* v_s = k_s + kKeysF * D;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRowsF;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (Hq / Hkv);
  const int r = threadIdx.x, row = q0 + r;
  load_rows_f32(q_s, q, b, q0, kRowsF, S, Hq, h, D, ld);
  load_rows_f32(do_s, dout, b, q0, kRowsF, S, Hq, h, D, ld);
  for (int d = 0; d < D; ++d) dq_s[r * ld + d] = 0.f;
  const size_t at = ((size_t)b * Hq + h) * S + row;
  const float lse_r = row < S ? lse[at] : 0.f;
  const float di_r = row < S ? di[at] : 0.f;
  const int last = min(q0 + kRowsF, S) - 1;
  for (int t0 = 0; t0 <= last; t0 += kKeysF) {
    __syncthreads();
    load_rows_f32(k_s, k, b, t0, kKeysF, S, Hkv, hk, D, D);
    load_rows_f32(v_s, v, b, t0, kKeysF, S, Hkv, hk, D, D);
    __syncthreads();
    if (row >= S) continue;
    for (int tt = 0; tt < kKeysF && t0 + tt <= row; ++tt) {
      const float* kr = k_s + tt * D;
      const float p = expf(dot_f32(q_s + r * ld, kr, D) * scale - lse_r);
      const float ds = p * (dot_f32(do_s + r * ld, v_s + tt * D, D) - di_r) * scale;
      for (int d = 0; d < D; ++d) dq_s[r * ld + d] = fmaf(ds, kr[d], dq_s[r * ld + d]);
    }
  }
  if (row >= S) return;
  float* out = dq + (((size_t)b * S + row) * Hq + h) * D;
  for (int d = 0; d < D; ++d) out[d] = dq_s[r * ld + d];
}

// -- launch -------------------------------------------------------------------------
// Above 48 KB a block's dynamic shared memory must be opted into, once per
// kernel instantiation and size.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, size_t& configured) {
  if (bytes <= configured) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) configured = bytes;
  return err;
}

template <int D>
size_t ld_bytes(int rows) {
  return sizeof(bf16) * (size_t)rows * (D + kPad);
}

template <int D>
cudaError_t fwd_bf16(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                     int S, int Hq, int Hkv, float scale, cudaStream_t st) {
  static size_t configured = 48 * 1024;
  const size_t smem = ld_bytes<D>(kBlockM + 4 * kBlockN);
  cudaError_t err = allow_smem(flash_fwd_bf16<D>, smem, configured);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBlockM - 1) / kBlockM, Hq, B);
  flash_fwd_bf16<D><<<grid, kThreads, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), static_cast<float*>(lse), S, Hq, Hkv, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t dkv_bf16(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* di, void* dk, void* dv, int B, int S, int Hq,
                     int Hkv, float scale, cudaStream_t st) {
  static size_t configured = 48 * 1024;
  const size_t smem = ld_bytes<D>(2 * kBlockN + 2 * kBwdQ) + 2 * kBwdQ * sizeof(float);
  cudaError_t err = allow_smem(flash_bwd_dkv_bf16<D>, smem, configured);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBlockN - 1) / kBlockN, Hkv, B);
  flash_bwd_dkv_bf16<D><<<grid, kThreads, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(di), static_cast<bf16*>(dk), static_cast<bf16*>(dv), S, Hq,
      Hkv, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t dq_bf16(const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* di, void* dq, int B, int S, int Hq, int Hkv,
                    float scale, cudaStream_t st) {
  static size_t configured = 48 * 1024;
  const size_t smem = ld_bytes<D>(2 * kBlockM + 2 * kBlockN);
  cudaError_t err = allow_smem(flash_bwd_dq_bf16<D>, smem, configured);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBlockM - 1) / kBlockM, Hq, B);
  flash_bwd_dq_bf16<D><<<grid, kThreads, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(di), static_cast<bf16*>(dq), S, Hq, Hkv, scale);
  return cudaGetLastError();
}

bool valid_shape(int B, int S, int Hq, int Hkv, int D, int dtype) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0 || B > 65535 || Hq > 65535) return false;
  if (dtype == 1) return D == 32 || D == 64 || D == 128;
  return dtype == 0 && D > 0 && D <= 256;
}

}  // namespace

// Dtype codes: 0 = float32, 1 = bfloat16 (q, k, v, do and the outputs share
// it; lse and di are always float32). Shapes: q/o/do/dq [B, S, Hq, D];
// k/v/dk/dv [B, S, Hkv, D]; lse/di [B, Hq, S]. All contiguous. `scale`
// multiplies the f32 scores (1/sqrt(D) for the models). Each returns the
// launch's cudaError_t.
extern "C" int skypilot_flash_fwd(const void* q, const void* k, const void* v, void* o,
                                  void* lse, int B, int S, int Hq, int Hkv, int D, int dtype,
                                  float scale, void* stream) {
  if (!valid_shape(B, S, Hq, Hkv, D, dtype)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    static size_t configured = 48 * 1024;
    const size_t smem = sizeof(float) * (2 * (size_t)kRowsF * (D + 1) + 2 * (size_t)kKeysF * D);
    cudaError_t err = allow_smem(flash_fwd_f32, smem, configured);
    if (err != cudaSuccess) return err;
    const dim3 grid((S + kRowsF - 1) / kRowsF, Hq, B);
    flash_fwd_f32<<<grid, kRowsF, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), static_cast<float*>(lse), S,
        Hq, Hkv, D, scale);
    return cudaGetLastError();
  }
  switch (D) {
    case 32: return fwd_bf16<32>(q, k, v, o, lse, B, S, Hq, Hkv, scale, st);
    case 64: return fwd_bf16<64>(q, k, v, o, lse, B, S, Hq, Hkv, scale, st);
    default: return fwd_bf16<128>(q, k, v, o, lse, B, S, Hq, Hkv, scale, st);
  }
}

extern "C" int skypilot_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* di,
                                      void* dk, void* dv, int B, int S, int Hq, int Hkv, int D,
                                      int dtype, float scale, void* stream) {
  if (!valid_shape(B, S, Hq, Hkv, D, dtype)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    static size_t configured = 48 * 1024;
    const size_t smem = sizeof(float) * (4 * (size_t)kRowsF * (D + 1) +
                                         2 * (size_t)kKeysF * D + 2 * kKeysF);
    cudaError_t err = allow_smem(flash_bwd_dkv_f32, smem, configured);
    if (err != cudaSuccess) return err;
    const dim3 grid((S + kRowsF - 1) / kRowsF, Hkv, B);
    flash_bwd_dkv_f32<<<grid, kRowsF, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(di),
        static_cast<float*>(dk), static_cast<float*>(dv), S, Hq, Hkv, D, scale);
    return cudaGetLastError();
  }
  switch (D) {
    case 32: return dkv_bf16<32>(q, k, v, dout, lse, di, dk, dv, B, S, Hq, Hkv, scale, st);
    case 64: return dkv_bf16<64>(q, k, v, dout, lse, di, dk, dv, B, S, Hq, Hkv, scale, st);
    default: return dkv_bf16<128>(q, k, v, dout, lse, di, dk, dv, B, S, Hq, Hkv, scale, st);
  }
}

extern "C" int skypilot_flash_bwd_dq(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse, const void* di,
                                     void* dq, int B, int S, int Hq, int Hkv, int D, int dtype,
                                     float scale, void* stream) {
  if (!valid_shape(B, S, Hq, Hkv, D, dtype)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    static size_t configured = 48 * 1024;
    const size_t smem = sizeof(float) * (3 * (size_t)kRowsF * (D + 1) + 2 * (size_t)kKeysF * D);
    cudaError_t err = allow_smem(flash_bwd_dq_f32, smem, configured);
    if (err != cudaSuccess) return err;
    const dim3 grid((S + kRowsF - 1) / kRowsF, Hq, B);
    flash_bwd_dq_f32<<<grid, kRowsF, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(di),
        static_cast<float*>(dq), S, Hq, Hkv, D, scale);
    return cudaGetLastError();
  }
  switch (D) {
    case 32: return dq_bf16<32>(q, k, v, dout, lse, di, dq, B, S, Hq, Hkv, scale, st);
    case 64: return dq_bf16<64>(q, k, v, dout, lse, di, dq, B, S, Hq, Hkv, scale, st);
    default: return dq_bf16<128>(q, k, v, dout, lse, di, dq, B, S, Hq, Hkv, scale, st);
  }
}

extern "C" const char* skypilot_flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
