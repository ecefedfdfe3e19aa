// Causal flash attention, forward and fused backward, for Hopper (sm_90a).
//
// Replaces the upstream Pallas TPU kernels of
// jax/experimental/pallas/ops/tpu/flash_attention.py (FA below) that the
// JAX package dispatches at skypilot_tpu/ops/attention.py:115-123 for
// seq >= 2048:
//   - flash_fwd  <- forward `_flash_attention_kernel`        (FA:331)
//   - flash_bwd  <- dK/dV   `_flash_attention_dkv_kernel`    (FA:796)
//                   and dQ  `_flash_attention_dq_kernel`     (FA:1146),
//                   fused into one kernel.
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
// kv head h / G in place. P and dS are rounded to bf16 before their
// products, as upstream rounds them to the input dtype.
//
// What bounds it on an H100: operations. Per visible (query, key) pair and
// query head the forward does 4 * D flops (q.k, p.v) and the fused backward
// 10 * D (q.k, do.v, p.do, ds.q, ds.k); at the training shape (B=8, S=2048,
// Hq=32, Hkv=8, D=128) that is 0.278 ms and 0.695 ms at the 989 TFLOP/s bf16
// peak, against ~0.3 GB of operands (0.09 ms at 3.35 TB/s).
//
// Design (bf16; D in {32, 64, 128}, D = 32 runs as 64 with the upper half
// zero-filled by TMA). Both kernels are warp-specialized: 3 warpgroups, the
// last a producer whose one thread issues TMA loads of 128-byte-swizzled
// tiles (boxes of 64 columns, so D = 128 is two boxes) into a ring of
// shared-memory stages, each completing on an mbarrier; the first two are
// consumers that run every product as `wgmma` and hand a stage back
// through a second mbarrier. `setmaxnreg` moves registers from
// the producer (24) to the consumers (240).
//   flash_fwd: persistent (one block per SM) over 128-row query tiles (64
//     rows a consumer), the longest first. A tile's Q is loaded once; 128-key K/V tiles stream
//     through 2 stages and tiles above the diagonal are skipped (only the
//     diagonal tile is masked). S = Q K^T is an SS wgmma (both K-major); the
//     online softmax (m, l, rescaled O) stays in registers, in base 2 with
//     one FFMA and one exp2 a score; P is rounded to bf16 in registers and
//     is the A operand of P V, with V read MN-major (no transposed copy).
//   flash_bwd: a block owns a 64-key tile of one kv head, keeps K and V in
//     shared memory and walks the query heads of its GQA group and the
//     64-row query tiles at or below the diagonal; Q, dO, lse and di of
//     each step arrive by TMA through 3 stages. The two consumers split
//     the work by role, so each holds one 64 x D f32 accumulator (with
//     both dK and dV in one warpgroup, ptxas serialized every wgmma for
//     lack of registers): warpgroup 0 computes S^T = K Q^T, P^T (f32 to
//     warpgroup 1, bf16 to shared memory) and dV += P^T dO; warpgroup 1
//     computes dP^T = V dO^T, dS^T = P^T (dP^T - di) (bf16 to shared
//     memory) and dK += dS^T Q. Then each computes half of dQ = dS K
//     (dS and K MN-major), stages it in shared memory and one thread adds
//     it to an f32 workspace with a TMA reduce-add. P and dP are computed
//     once: 10 * D flops per pair, where the former dK/dV and dQ kernels
//     recomputed them (14 * D). Blocks walk (batch row, kv head) pairs in
//     chunks of 4, the longest key tiles first within a chunk, so that the
//     dQ rows the resident blocks add into stay in L2.
//   dK and dV are summed over the group's query heads in registers, with no
//   atomics: they are deterministic. dQ's sum over key tiles is made by
//   reduce-adds in whatever order the blocks reach them, so its last bits
//   can change from run to run.
// Left for later: overlap of the softmax with the products (within a
// warpgroup, or ping-pong of the two; a first intra-warpgroup try made the
// forward slower), a persistent backward, clusters with multicast K/V
// loads, and FP8.
//
// f32 inputs (parity runs) take scalar CUDA-core kernels, one thread per
// row, with the same formulas: a forward, a dK/dV and a dQ kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

typedef __nv_bfloat16 bf16;

constexpr float kMaskValue = -0.7f * 3.402823466e38f;  // upstream DEFAULT_MASK_VALUE
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kWg = 128;           // threads of a warpgroup
constexpr int kConsumers = 2;      // consumer warpgroups, 64 rows each
constexpr int kProducer = kConsumers * kWg;  // first thread of the producer warpgroup
constexpr int kThreads = kProducer + kWg;
constexpr int kConsumerWarps = 4 * kConsumers;
// setmaxnreg: 384 threads start at 168 registers; the producer gives up
// 144 each, the consumers take 72 each (the backward holds dK and dV, 128).
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kFwdM = 128;         // query rows of a forward tile
constexpr int kFwdN = 128;         // keys of a forward K/V tile
constexpr int kFwdStages = 2;
constexpr int kBwdN = 64;          // keys of a backward block
constexpr int kBwdM = 64;          // query rows of a backward step
constexpr int kBwdStages = 3;
constexpr int kBwdChunk = 4;       // (batch row, kv head) pairs walked together

static_assert(kFwdM == kFwdN, "the forward's key tiles line up with its query tiles");
static_assert(kBwdN == 64, "both backward consumers cover the block's 64 keys");

// Barrier 1 across the consumer warpgroups (barrier 0 is __syncthreads).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers * kWg) : "memory");
}

// Barrier 2 + w across consumer warpgroup w.
__device__ __forceinline__ void warpgroup_sync(int w) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(2 + w), "n"(kWg) : "memory");
}

// -- TMA reduce-add --------------------------------------------------------------
// dst[box at the coordinates] += the box at `src` (f32, dropped past the
// tensor's edges), tracked by the issuing thread's bulk groups.
__device__ __forceinline__ void tma_reduce_add(const CUtensorMap* map, const void* src, int c0,
                                               int c1, int c2, int c3) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.4d.global.shared::cta.add.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// This thread's bulk groups have finished reading shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// -- bf16 forward -------------------------------------------------------------
struct FwdParams {
  CUtensorMap q, k, v;  // [B, S, H, D] as {D, H, S, B}; boxes of 128 rows x 64 columns
  bf16* o;
  float* lse;
  int B, S, Hq, Hkv, D;
  int n_m;      // query tiles of one (batch row, head)
  int n_tiles;  // n_m * Hq * B
  float scale_log2;  // scale * log2(e): the softmax runs in base 2
};

// Tile i (0 = the longest): query tile m of head h of batch row b.
__device__ __forceinline__ void fwd_tile(const FwdParams& p, int i, int& m, int& h, int& b) {
  const int heads = p.Hq * p.B;
  m = p.n_m - 1 - i / heads;
  h = (i % heads) % p.Hq;
  b = (i % heads) / p.Hq;
}

template <int Dp>
__global__ void __launch_bounds__(kThreads, 1) flash_fwd_bf16(const __grid_constant__ FwdParams p) {
  constexpr int kBoxes = Dp / 64;
  constexpr uint32_t kQBytes = kFwdM * Dp * 2;
  constexpr uint32_t kKVBytes = kFwdN * Dp * 2;  // one of K, V
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = smem_base(smem_raw);
  uint8_t* kv_s = q_s + kQBytes;  // stage s: K at 2 s kKVBytes, V right after
  uint64_t* bars = reinterpret_cast<uint64_t*>(kv_s + 2 * kFwdStages * kKVBytes);
  uint64_t* q_full = bars;
  uint64_t* q_free = bars + 1;
  uint64_t* kv_full = bars + 2;
  uint64_t* kv_free = kv_full + kFwdStages;
  if (threadIdx.x == 0) {
    bar_init(q_full, 1);
    bar_init(q_free, kConsumerWarps);
    for (int s = 0; s < kFwdStages; ++s) {
      bar_init(kv_full + s, 1);
      bar_init(kv_free + s, kConsumerWarps);
    }
    bar_init_fence();
  }
  __syncthreads();
  const int group = p.Hq / p.Hkv;

  if (threadIdx.x >= kProducer) {
    // Producer: one thread keeps the ring full, tile after tile.
    regs_release<kProducerRegs>();
    if (threadIdx.x == kProducer) {
      int it = 0, t = 0;
      for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x, ++t) {
        int m, h, b;
        fwd_tile(p, tile, m, h, b);
        bar_wait(q_free, (t & 1) ^ 1);
        bar_expect(q_full, kQBytes);
        for (int x = 0; x < kBoxes; ++x)
          tma_load(q_s + x * kFwdM * kRowBytes, &p.q, q_full, x * 64, h, m * kFwdM, b);
        for (int j = 0; j <= m; ++j, ++it) {  // key tiles at or below the diagonal
          const int s = it % kFwdStages;
          bar_wait(kv_free + s, ((it / kFwdStages) & 1) ^ 1);
          bar_expect(kv_full + s, 2 * kKVBytes);
          uint8_t* k_s = kv_s + 2 * s * kKVBytes;
          for (int x = 0; x < kBoxes; ++x) {
            tma_load(k_s + x * kFwdN * kRowBytes, &p.k, kv_full + s, x * 64, h / group,
                     j * kFwdN, b);
            tma_load(k_s + kKVBytes + x * kFwdN * kRowBytes, &p.v, kv_full + s, x * 64,
                     h / group, j * kFwdN, b);
          }
        }
      }
    }
  } else {
    regs_claim<kConsumerRegs>();
    const int cw = warp_uniform_index<kWg>();  // rows 64 cw .. of the tile
    const int warp = warp_uniform_index<32>() % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, t4 = lane % 4;
    float sacc[kFwdN / 2];
    float oacc[Dp / 2];
    int it = 0, t = 0;
    for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x, ++t) {
      int m, h, b;
      fwd_tile(p, tile, m, h, b);
      const int row0 = m * kFwdM + cw * 64 + warp * 16 + g;  // this thread's rows: +0, +8
#pragma unroll
      for (int i = 0; i < Dp / 2; ++i) oacc[i] = 0.f;
      float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};
      bar_wait(q_full, t & 1);
      const uint32_t q_a = smem_addr(q_s);
      for (int j = 0; j <= m; ++j, ++it) {
        const int s = it % kFwdStages;
        bar_wait(kv_full + s, (it / kFwdStages) & 1);
        const uint32_t k_a = smem_addr(kv_s + 2 * s * kKVBytes);
        const uint32_t v_a = k_a + kKVBytes;

        wg_fence();
#pragma unroll
        for (int kk = 0; kk < Dp / 16; ++kk)
          wgmma_ss<kFwdN, 0, 0>(sacc, desc_k<kFwdM>(q_a, cw * 64, kk), desc_k<kFwdN>(k_a, 0, kk),
                                kk > 0);
        wg_commit();
        wg_wait();
        reg_fence(sacc);

        // Mask above the diagonal (the diagonal tile only), online softmax
        // in base 2: p = 2^(s * scale * log2(e) - m), one FFMA and one
        // exp2 a score; m and l per row, m in raw score units.
        const bool diag = j == m;
        float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
        for (int i = 0; i < kFwdN / 2; ++i) {
          const int r = (i >> 1) & 1;
          if (diag && (i / 4) * 8 + 2 * t4 + (i & 1) > cw * 64 + warp * 16 + g + 8 * r)
            sacc[i] = kMaskValue;
          mx[r] = fmaxf(mx[r], sacc[i]);
        }
        float alpha[2], m2[2], sum[2] = {0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          // Every row sees a key in every tile it visits, so m is finite.
          mx[r] = quad_max(mx[r]);
          alpha[r] = exp2f((m_r[r] - mx[r]) * p.scale_log2);
          m_r[r] = mx[r];
          m2[r] = mx[r] * p.scale_log2;
        }
#pragma unroll
        for (int i = 0; i < kFwdN / 2; ++i) {
          const int r = (i >> 1) & 1;
          sacc[i] = exp2f(fmaf(sacc[i], p.scale_log2, -m2[r]));
          sum[r] += sacc[i];
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) l_r[r] = l_r[r] * alpha[r] + quad_sum(sum[r]);
#pragma unroll
        for (int i = 0; i < Dp / 2; ++i) oacc[i] *= alpha[(i >> 1) & 1];

        // O += P V: P from registers (bf16), V MN-major.
        uint32_t pa[kFwdN / 4];
#pragma unroll
        for (int i = 0; i < kFwdN / 4; ++i) pa[i] = pack_f32(sacc[2 * i], sacc[2 * i + 1]);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < kFwdN / 16; ++kk)
          wgmma_rs<Dp, 1>(oacc, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
                          desc_mn<kFwdN>(v_a, kk * 16, 0), 1);
        wg_commit();
        wg_wait();
        reg_fence(oacc);
        if (lane == 0) bar_arrive(kv_free + s);
      }
      if (lane == 0) bar_arrive(q_free);  // the producer may load the next Q

#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        if (row >= p.S) continue;
        const float inv = 1.f / l_r[r];
        bf16* o = p.o + (((size_t)b * p.S + row) * p.Hq + h) * p.D + 2 * t4;
#pragma unroll
        for (int c = 0; c < Dp / 8; ++c)
          if (c * 8 < p.D)
            *reinterpret_cast<uint32_t*>(o + c * 8) =
                pack_f32(oacc[4 * c + 2 * r] * inv, oacc[4 * c + 2 * r + 1] * inv);
        if (t4 == 0) p.lse[((size_t)b * p.Hq + h) * p.S + row] =
              (m_r[r] * p.scale_log2 + log2f(l_r[r])) * kLn2;
      }
    }
  }
}

// -- bf16 fused backward ----------------------------------------------------------
struct BwdParams {
  CUtensorMap q, dout;  // [B, S, Hq, D]: boxes of 64 rows x 64 columns
  CUtensorMap k, v;     // [B, S, Hkv, D]: boxes of 128 rows x 64 columns
  CUtensorMap lse, di;  // [B * Hq, S] f32 (rows padded to 16 bytes): boxes of 64
  CUtensorMap dq;       // f32 [B, S, Hq, D] workspace, zeroed by the caller: boxes of 64
                        // rows x 32 columns, which the kernel adds in
  bf16* dk;
  bf16* dv;
  int B, S, Hq, Hkv, D;
  int n_qt;  // query tiles (64 rows) of one (batch row, head)
  float scale_log2, scale;
};

template <int Dp>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_bf16(const __grid_constant__ BwdParams p) {
  constexpr int kBoxes = Dp / 64;
  constexpr uint32_t kKVBytes = kBwdN * Dp * 2;      // one of K, V
  constexpr uint32_t kStepBytes = kBwdM * Dp * 2;    // one of Q, dO of a step
  constexpr uint32_t kTileBytes = kBwdN * kBwdM * 2;  // bf16 [keys][queries], 128-byte rows
  constexpr uint32_t kPBytes = kBwdN * kBwdM * 4;     // f32 P^T, in the C fragments' order
  constexpr uint32_t kDqBytes = kBwdM * (Dp / 2) * 4;  // f32 dQ[queries][D/2] of a warpgroup
  extern __shared__ uint8_t smem_raw[];
  uint8_t* k_s = smem_base(smem_raw);
  uint8_t* v_s = k_s + kKVBytes;
  uint8_t* qdo_s = v_s + kKVBytes;                     // stage s: Q at 2 s kStepBytes, dO after
  uint8_t* pt_s = qdo_s + 2 * kBwdStages * kStepBytes;  // P^T, bf16
  uint8_t* ds_s = pt_s + kTileBytes;                    // dS^T, bf16
  float* pf_s = reinterpret_cast<float*>(ds_s + kTileBytes);  // P^T, f32
  uint8_t* dq_s = ds_s + kTileBytes + kPBytes;          // warpgroup w's dQ tile at w kDqBytes
  float* vec_s = reinterpret_cast<float*>(dq_s + kConsumers * kDqBytes);  // stage s: lse, di
  uint64_t* bars = reinterpret_cast<uint64_t*>(vec_s + 2 * kBwdStages * kBwdM);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* free_ = full + kBwdStages;
  if (threadIdx.x == 0) {
    bar_init(kv_full, 1);
    for (int s = 0; s < kBwdStages; ++s) {
      bar_init(full + s, 1);
      bar_init(free_ + s, kConsumerWarps);
    }
    bar_init_fence();
  }
  __syncthreads();

  // Block -> (key tile, kv head, batch row). The (batch row, kv head)
  // pairs go in chunks of kBwdChunk, and within a chunk key tile 0 (the
  // most work) comes first: the blocks resident at one time add into the
  // dQ rows of a few kv heads, which stay in L2, where key-tile-major
  // order over all pairs would spread their reduce-adds over the whole
  // workspace.
  const int n_kt = (p.S + kBwdN - 1) / kBwdN;
  const int pairs = p.Hkv * p.B;
  const int chunk0 = (blockIdx.x / (kBwdChunk * n_kt)) * kBwdChunk;
  const int in_chunk = min(kBwdChunk, pairs - chunk0);
  const int j = blockIdx.x - chunk0 * n_kt;
  const int k0 = (j / in_chunk) * kBwdN;
  const int hk = (chunk0 + j % in_chunk) % p.Hkv;
  const int b = (chunk0 + j % in_chunk) / p.Hkv;
  const int group = p.Hq / p.Hkv;
  const int qt0 = k0 / kBwdM;  // the first query tile with a row >= k0

  if (threadIdx.x >= kProducer) {
    regs_release<kProducerRegs>();
    if (threadIdx.x == kProducer) {
      bar_expect(kv_full, 2 * kKVBytes);
      for (int x = 0; x < kBoxes; ++x) {
        tma_load(k_s + x * kBwdN * kRowBytes, &p.k, kv_full, x * 64, hk, k0, b);
        tma_load(v_s + x * kBwdN * kRowBytes, &p.v, kv_full, x * 64, hk, k0, b);
      }
      int it = 0;
      for (int gi = 0; gi < group; ++gi) {
        const int h = hk * group + gi;
        for (int qt = qt0; qt < p.n_qt; ++qt, ++it) {
          const int s = it % kBwdStages;
          bar_wait(free_ + s, ((it / kBwdStages) & 1) ^ 1);
          bar_expect(full + s, 2 * kStepBytes + 2 * kBwdM * 4);
          uint8_t* q_s = qdo_s + 2 * s * kStepBytes;
          for (int x = 0; x < kBoxes; ++x) {
            tma_load(q_s + x * kBwdM * kRowBytes, &p.q, full + s, x * 64, h, qt * kBwdM, b);
            tma_load(q_s + kStepBytes + x * kBwdM * kRowBytes, &p.dout, full + s, x * 64, h,
                     qt * kBwdM, b);
          }
          float* lse_s = vec_s + 2 * s * kBwdM;
          tma_load(lse_s, &p.lse, full + s, qt * kBwdM, b * p.Hq + h);
          tma_load(lse_s + kBwdM, &p.di, full + s, qt * kBwdM, b * p.Hq + h);
        }
      }
    }
  } else {
    regs_claim<kConsumerRegs>();
    // Warpgroup 0 computes P^T and holds dV; warpgroup 1 computes dS^T and
    // holds dK. Both run the same wgmma calls on role-chosen operands.
    const int cw = warp_uniform_index<kWg>();
    const int warp = warp_uniform_index<32>() % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, t4 = lane % 4;
    const int key_l = warp * 16 + g;  // this thread's keys (in the block): +0, +8
    float4* pf = reinterpret_cast<float4*>(pf_s) + (threadIdx.x % kWg);  // stride kWg
    float acc[Dp / 2];  // dV (warpgroup 0) or dK (warpgroup 1), [keys][D]
#pragma unroll
    for (int i = 0; i < Dp / 2; ++i) acc[i] = 0.f;
    bar_wait(kv_full, 0);
    const uint32_t k_a = smem_addr(k_s);
    const uint32_t kv_a = cw ? k_a + kKVBytes : k_a;  // K (S^T) or V (dP^T)
    const uint32_t pt_a = smem_addr(pt_s), ds_a = smem_addr(ds_s);
    const uint32_t acc_a = cw ? ds_a : pt_a;  // A of dV += P^T dO or dK += dS^T Q
    int it = 0;
    for (int gi = 0; gi < group; ++gi) {
      const int h = hk * group + gi;
      for (int qt = qt0; qt < p.n_qt; ++qt, ++it) {
        const int s = it % kBwdStages;
        const int q0 = qt * kBwdM;
        bar_wait(full + s, (it / kBwdStages) & 1);
        const uint32_t q_a = smem_addr(qdo_s + 2 * s * kStepBytes);
        const uint32_t do_a = q_a + kStepBytes;
        const uint32_t row_a = cw ? do_a : q_a;   // B of S^T (Q) or dP^T (dO)
        const uint32_t accb_a = cw ? q_a : do_a;  // B of dK (Q) or dV (dO)
        const float* lse_s = vec_s + 2 * s * kBwdM;
        const float* di_s = lse_s + kBwdM;

        // S^T = K Q^T (warpgroup 0) or dP^T = V dO^T (warpgroup 1), [keys][queries].
        float sc[kBwdM / 2];
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < Dp / 16; ++kk)
          wgmma_ss<kBwdM, 0, 0>(sc, desc_k<kBwdN>(kv_a, 0, kk), desc_k<kBwdM>(row_a, 0, kk),
                                kk > 0);
        wg_commit();
        wg_wait();
        reg_fence(sc);

        if (cw == 0) {
          // P^T = exp(S^T scale - lse), zero above the diagonal and past S:
          // f32 for warpgroup 1, bf16 (swizzled) for dV.
#pragma unroll
          for (int c = 0; c < kBwdM / 8; ++c) {
            const int col = c * 8 + 2 * t4;
            const float2 lse2 = *reinterpret_cast<const float2*>(lse_s + col);
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int key = k0 + key_l + 8 * r;
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int i = 4 * c + 2 * r + e;
                const int q = q0 + col + e;
                sc[i] = q < p.S && key <= q
                            ? exp2f(fmaf(sc[i], p.scale_log2, -(e ? lse2.y : lse2.x) * kLog2e))
                            : 0.f;
              }
              *reinterpret_cast<uint32_t*>(pt_s + (key_l + 8 * r) * kRowBytes +
                                           ((c ^ g) * 16) + t4 * 4) =
                  pack_f32(sc[4 * c + 2 * r], sc[4 * c + 2 * r + 1]);
            }
          }
#pragma unroll
          for (int j = 0; j < kBwdM / 8; ++j)
            pf[j * kWg] = make_float4(sc[4 * j], sc[4 * j + 1], sc[4 * j + 2], sc[4 * j + 3]);
        }
        fence_async_smem();
        consumers_sync();  // P^T is in shared memory

        if (cw == 1) {
          // dS^T = P^T (dP^T - di) scale, bf16 (swizzled) for dK and dQ.
#pragma unroll
          for (int c = 0; c < kBwdM / 8; ++c) {
            const int col = c * 8 + 2 * t4;
            const float2 di2 = *reinterpret_cast<const float2*>(di_s + col);
            const float4 p4 = pf[c * kWg];
            const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
            for (int r = 0; r < 2; ++r) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int i = 4 * c + 2 * r + e;
                sc[i] = pv[2 * r + e] * (sc[i] - (e ? di2.y : di2.x)) * p.scale;
              }
              *reinterpret_cast<uint32_t*>(ds_s + (key_l + 8 * r) * kRowBytes +
                                           ((c ^ g) * 16) + t4 * 4) =
                  pack_f32(sc[4 * c + 2 * r], sc[4 * c + 2 * r + 1]);
            }
          }
        }
        fence_async_smem();
        if (threadIdx.x % kWg == 0) bulk_wait_read();  // the previous dQ tile is read out
        consumers_sync();  // dS^T is in shared memory

        // dV += P^T dO or dK += dS^T Q (A K-major, B MN-major), and
        // dQ[:, cw D/2 ..] = dS K over the block's keys (both MN-major).
        float dq[Dp / 4];
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < kBwdM / 16; ++kk)
          wgmma_ss<Dp, 0, 1>(acc, desc_k<kBwdN>(acc_a, 0, kk), desc_mn<kBwdM>(accb_a, kk * 16, 0),
                             1);
#pragma unroll
        for (int kk = 0; kk < kBwdN / 16; ++kk)
          wgmma_ss<Dp / 2, 1, 1>(dq, desc_mn<kBwdN>(ds_a, kk * 16, 0),
                                 desc_mn<kBwdN>(k_a, kk * 16, cw * (Dp / 2)), kk > 0);
        wg_commit();
        wg_wait();
        reg_fence(acc);
        reg_fence(dq);
        if (lane == 0) bar_arrive(free_ + s);  // done with this step's Q, dO, lse, di

        // The dQ tile to shared memory as boxes of 32 f32 columns (128-byte
        // swizzle), then one thread adds it to the workspace by TMA.
        uint8_t* dqt = dq_s + cw * kDqBytes;
#pragma unroll
        for (int c = 0; c < Dp / 16; ++c)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = warp * 16 + g + 8 * r;  // row % 8 == g
            const int col = c * 8 + 2 * t4;         // in the warpgroup's D/2 columns
            *reinterpret_cast<float2*>(dqt + (col / 32) * kBwdM * kRowBytes + row * kRowBytes +
                                       ((((col % 32) / 4) ^ g) * 16) + (col % 4) * 4) =
                make_float2(dq[4 * c + 2 * r], dq[4 * c + 2 * r + 1]);
          }
        fence_async_smem();
        warpgroup_sync(cw);
        if (threadIdx.x % kWg == 0) {
          for (int x = 0; x < Dp / 64; ++x)
            if (cw * (Dp / 2) + x * 32 < p.D)
              tma_reduce_add(&p.dq, dqt + x * kBwdM * kRowBytes, cw * (Dp / 2) + x * 32, h, q0, b);
          bulk_commit();
        }
      }
    }
    if (threadIdx.x % kWg == 0) bulk_wait();

    bf16* out = cw ? p.dk : p.dv;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = k0 + key_l + 8 * r;
      if (key >= p.S) continue;
      bf16* row = out + (((size_t)b * p.S + key) * p.Hkv + hk) * p.D + 2 * t4;
#pragma unroll
      for (int c = 0; c < Dp / 8; ++c)
        if (c * 8 < p.D)
          *reinterpret_cast<uint32_t*>(row + c * 8) =
              pack_f32(acc[4 * c + 2 * r], acc[4 * c + 2 * r + 1]);
    }
  }
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

// [B, S, H, D] (bf16, or f32 with `f32`) as a 4-D map {D, H, S, B}: a
// box is `rows` rows of one head by 128 bytes of columns, 128-byte
// swizzled; columns past D and rows past S read as zeros and are not
// written.
bool rows_map(CUtensorMap* map, const void* ptr, int B, int S, int H, int D, int rows,
              bool f32 = false) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t elt = f32 ? 4 : 2;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {D * elt, H * D * elt, S * H * D * elt};
  const cuuint32_t box[4] = {(cuuint32_t)(kRowBytes / elt), 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// [rows, S] f32 with rows `ld` floats apart (ld % 4 == 0) as a 2-D map:
// a box is kBwdM values of one row, zeros past S.
bool vec_map(CUtensorMap* map, const void* ptr, int rows, int S, int ld) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)S, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 4};
  const cuuint32_t box[2] = {kBwdM, 1};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(ptr), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int Dp>
cudaError_t fwd_bf16(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                     int S, int Hq, int Hkv, int D, float scale, cudaStream_t st) {
  FwdParams p;
  if (!rows_map(&p.q, q, B, S, Hq, D, kFwdM) || !rows_map(&p.k, k, B, S, Hkv, D, kFwdN) ||
      !rows_map(&p.v, v, B, S, Hkv, D, kFwdN))
    return cudaErrorInvalidValue;
  p.o = static_cast<bf16*>(o);
  p.lse = static_cast<float*>(lse);
  p.B = B, p.S = S, p.Hq = Hq, p.Hkv = Hkv, p.D = D;
  p.n_m = (S + kFwdM - 1) / kFwdM;
  p.n_tiles = p.n_m * Hq * B;
  p.scale_log2 = scale * kLog2e;
  static PerDevice<size_t> configured(48 * 1024);
  const size_t smem = 1024 + (size_t)(kFwdM + 2 * kFwdStages * kFwdN) * Dp * 2 +
                      (2 + 2 * kFwdStages) * sizeof(uint64_t);
  const cudaError_t err = allow_smem(flash_fwd_bf16<Dp>, smem, configured);
  if (err != cudaSuccess) return err;
  const int grid = p.n_tiles < sm_count() ? p.n_tiles : sm_count();
  flash_fwd_bf16<Dp><<<grid, kThreads, smem, st>>>(p);
  return cudaGetLastError();
}

template <int Dp>
cudaError_t bwd_bf16(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* di, void* dq, void* dk, void* dv, int B, int S,
                     int Hq, int Hkv, int D, int lse_ld, float scale, cudaStream_t st) {
  if (lse_ld % 4 != 0 || lse_ld < S) return cudaErrorInvalidValue;
  BwdParams p;
  if (!rows_map(&p.q, q, B, S, Hq, D, kBwdM) || !rows_map(&p.dout, dout, B, S, Hq, D, kBwdM) ||
      !rows_map(&p.k, k, B, S, Hkv, D, kBwdN) || !rows_map(&p.v, v, B, S, Hkv, D, kBwdN) ||
      !vec_map(&p.lse, lse, B * Hq, S, lse_ld) || !vec_map(&p.di, di, B * Hq, S, lse_ld) ||
      !rows_map(&p.dq, dq, B, S, Hq, D, kBwdM, true))
    return cudaErrorInvalidValue;
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  p.B = B, p.S = S, p.Hq = Hq, p.Hkv = Hkv, p.D = D;
  p.n_qt = (S + kBwdM - 1) / kBwdM;
  p.scale_log2 = scale * kLog2e;
  p.scale = scale;
  static PerDevice<size_t> configured(48 * 1024);
  const size_t smem = 1024 + (size_t)(2 * kBwdN + 2 * kBwdStages * kBwdM) * Dp * 2 +
                      (size_t)kBwdN * kBwdM * (2 + 2 + 4) + (size_t)kConsumers * kBwdM * (Dp / 2) * 4 +
                      2 * kBwdStages * kBwdM * sizeof(float) +
                      (1 + 2 * kBwdStages) * sizeof(uint64_t);
  const cudaError_t err = allow_smem(flash_bwd_bf16<Dp>, smem, configured);
  if (err != cudaSuccess) return err;
  const int grid = ((S + kBwdN - 1) / kBwdN) * Hkv * B;
  flash_bwd_bf16<Dp><<<grid, kThreads, smem, st>>>(p);
  return cudaGetLastError();
}

bool valid_shape(int B, int S, int Hq, int Hkv, int D, int dtype) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0 || B > 65535 || Hq > 65535) return false;
  if (dtype == 1) return D == 32 || D == 64 || D == 128;
  return dtype == 0 && D > 0 && D <= 256;
}

}  // namespace

// Dtype codes: 0 = float32, 1 = bfloat16 (q, k, v, do and the outputs share
// it; lse and di are always float32). Shapes: q/o/do [B, S, Hq, D];
// k/v/dk/dv [B, S, Hkv, D]; lse [B, Hq, S]. All contiguous and 16-byte
// aligned. `scale` multiplies the f32 scores (1/sqrt(D) for the models).
// Each returns the launch's cudaError_t.
extern "C" int skypilot_flash_fwd(const void* q, const void* k, const void* v, void* o,
                                  void* lse, int B, int S, int Hq, int Hkv, int D, int dtype,
                                  float scale, void* stream) {
  if (!valid_shape(B, S, Hq, Hkv, D, dtype)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    static PerDevice<size_t> configured(48 * 1024);
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
  if (D == 128) return fwd_bf16<128>(q, k, v, o, lse, B, S, Hq, Hkv, D, scale, st);
  return fwd_bf16<64>(q, k, v, o, lse, B, S, Hq, Hkv, D, scale, st);
}

// The backward: dq, dk and dv from q, k, v, do, lse and di (f32 [B, Hq, S],
// rows `lse_ld` floats apart). bf16: one fused kernel; `dq` is an f32
// [B, S, Hq, D] workspace that the caller zeroes and the kernel adds into,
// and lse_ld is a multiple of 4 (TMA's 16-byte strides). f32: the dK/dV
// and dQ scalar kernels, `dq` the f32 result, lse_ld == S.
extern "C" int skypilot_flash_bwd(const void* q, const void* k, const void* v, const void* dout,
                                  const void* lse, const void* di, void* dq, void* dk, void* dv,
                                  int B, int S, int Hq, int Hkv, int D, int dtype, int lse_ld,
                                  float scale, void* stream) {
  if (!valid_shape(B, S, Hq, Hkv, D, dtype)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (D == 128)
      return bwd_bf16<128>(q, k, v, dout, lse, di, dq, dk, dv, B, S, Hq, Hkv, D, lse_ld, scale,
                           st);
    return bwd_bf16<64>(q, k, v, dout, lse, di, dq, dk, dv, B, S, Hq, Hkv, D, lse_ld, scale, st);
  }
  if (lse_ld != S) return cudaErrorInvalidValue;
  static PerDevice<size_t> dkv_configured(48 * 1024), dq_configured(48 * 1024);
  const size_t dkv_smem =
      sizeof(float) * (4 * (size_t)kRowsF * (D + 1) + 2 * (size_t)kKeysF * D + 2 * kKeysF);
  const size_t dq_smem = sizeof(float) * (3 * (size_t)kRowsF * (D + 1) + 2 * (size_t)kKeysF * D);
  cudaError_t err = allow_smem(flash_bwd_dkv_f32, dkv_smem, dkv_configured);
  if (err == cudaSuccess) err = allow_smem(flash_bwd_dq_f32, dq_smem, dq_configured);
  if (err != cudaSuccess) return err;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* dof = static_cast<const float*>(dout);
  const float* lsef = static_cast<const float*>(lse);
  const float* dif = static_cast<const float*>(di);
  flash_bwd_dkv_f32<<<dim3((S + kRowsF - 1) / kRowsF, Hkv, B), kRowsF, dkv_smem, st>>>(
      qf, kf, vf, dof, lsef, dif, static_cast<float*>(dk), static_cast<float*>(dv), S, Hq, Hkv,
      D, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_f32<<<dim3((S + kRowsF - 1) / kRowsF, Hq, B), kRowsF, dq_smem, st>>>(
      qf, kf, vf, dof, lsef, dif, static_cast<float*>(dq), S, Hq, Hkv, D, scale);
  return cudaGetLastError();
}

extern "C" const char* skypilot_flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
