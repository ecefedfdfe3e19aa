// W8A16 linear for Hopper (sm_90a): y = x . dequant(q, scale)^T + bias.
//
// Replaces no Pallas kernel. It stands for what XLA does with the
// reference's int8 weights: `dequantize_params`
// (skypilot_tpu/inference/quant.py:86-105) rebuilds each projection as an
// f32 `int8 * scale` product inside the jitted serving function, and XLA
// fuses that product into the consuming Flax `Dense`, so only int8 is
// streamed from memory. PyTorch has no product of bf16 activations with
// int8 weights on the card; dequantizing into a bf16 copy first would move
// ~5x the weight bytes (read int8, write bf16, read bf16).
//
// What it computes, per row m of x [M, K] and output channel n of q [N, K]:
//   w[n, k] = XT(float(q[n, k]) * (scale[n] * (1 + perturb)))   (the reference's
//            dequantize, then the Dense's cast to the compute dtype XT)
//   y[m, n] = XT(sum_k float(x[m, k]) * float(w[n, k]) + float(bias[n]))
// with the sum in f32 (bf16 products are exact in f32, so the tensor cores
// accumulating in f32 compute the reference's function up to the order of
// the sum). XT is bf16 or f32; an all-zero channel (scale 0) gives exactly
// the bias. Every route splits K over the blocks of a thread-block cluster
// where the output tiles alone cannot fill the card, and those blocks sum
// their partials through distributed shared memory in a fixed order
// (`cluster_sum_store`): no scratch in device memory and no atomics, so two
// calls give bit-identical results, and nothing is allocated here, so a
// call can be captured in a CUDA graph. ops/int8_linear.py `plan` picks the
// route and the tiling from the shapes alone.
//
// Route 0, decode (bf16 x, M <= 64) and f32 x: the cp.async kernel.
// What bounds it on an H100: bytes. At decode the int8 weights are nearly
// all of them (Llama-3-8B's wq: 16.8 MB of int8 against 64 KB of x at M =
// 8: 5.0 us at 3.35 TB/s, against 0.07 us of bf16 tensor-core work). So
// every weight byte is read once, by 16-byte cp.async copies kept several
// stages deep, and the grid is cut so that every projection at M = 8 runs
// at least ~132 blocks.
// 128 threads (4 warps) a block; a block owns BN (64 or 32) output
// channels x BT (8, 16, 32 or 64) rows of x, and one of KS (1, 2, 4 or 8)
// slices of K (more slices where the channel tiles alone cannot fill the
// card, as wk / wv's 1024 channels cannot).
//  1. Stages of 128 k: the int8 tile [BN, 128] and the x tile [BT, 128]
//     arrive by 16-byte cp.async (zero-filled past N, M and K) into a ring
//     of kStages slots, kStages - 1 in flight ahead of the one computed.
//  2. bf16: warp w owns 16 channels (the mma's M side: A = the weights) and
//     every row of the tile (the mma's N side, 8 rows an n8 tile: B = x^T);
//     with BN = 32 two warps share a channel group and take alternate
//     64-k halves of each stage. mma.sync m16n8k16, bf16 in, f32
//     accumulators. The sum over k does not depend on the order of k, so
//     within each 64-k chunk k is permuted the same way for both operands:
//     lane (g, t) reads 16 contiguous int8 of its two channel rows and 16
//     contiguous bf16 of each of its x rows, which are its fragments of
//     four k16 steps (logical k 2t, 2t+1 / 2t+8, 2t+9 of step s sit at
//     16t + 4s + 0, 1 / + 2, 3). So every shared-memory read is 16 bytes
//     and conflict-free, and no ldmatrix is needed. Each int8 pair is
//     converted as the reference does (f32 product, rounded to bf16) in
//     registers on its way to the tensor cores.
//     f32 (the parity configs): CUDA-core FMAs, BN channels x 128 / BN
//     k-groups of threads, each thread all BT rows of one channel.
//  3. The partial sums of a block go to shared memory and the cluster sums
//     them.
//
// Route 1, prefill (bf16 x, M > 64): the wgmma kernel. What bounds it:
// operations (DeepSeek-V2-Lite's w_down at M = 256: 11.5 GFLOP, 11.6 us at
// 989 TFLOP/s, against 6.7 us for its 22.4 MB of int8). mma.sync cannot
// reach the tensor cores' full rate, and route 0 converts every weight
// tile once per 64 rows; wgmma can. Its A operand may come from
// registers, so the products are computed transposed, D = W x^T: A = the
// weights, converted straight into A fragments, B = x from shared memory
// (as TMA writes it), D = the y tile as [channels, rows] in f32 registers.
//  1. A block owns BN (64 or 128) channels x BM (64 or 128) rows of x and
//     one K slice. One producer thread (a warp of its own) keeps a ring of
//     stages full: per 64 k, a TMA load of the x tile (BM rows, 128-byte
//     swizzle) and one of the int8 tile (BN rows x 64 bytes, 64-byte
//     swizzle), both zero-filled past M, N and K, on one mbarrier.
//  2. Each consumer warpgroup owns 64 channels. A lane's A fragment of a
//     k16 step needs the bytes 2t, 2t + 1 and 2t + 8, 2t + 9 of its two
//     channel rows: halves of the words at 4 (t / 2) and + 8, which the
//     64-byte swizzle spreads over all 32 banks, so 16 4-byte loads a
//     stage fetch a lane's 32 int8. Each is converted exactly as above
//     (the scale is one f32 a channel, loaded once a block), then wgmma
//     m64nBMk16 runs on the four k16 steps and the warpgroup waits for it
//     before the registers are written again (ptxas serializes wgmma
//     whose register inputs are written while one is in flight). The
//     warpgroups of a block, and the three blocks an SM of the 64-channel
//     tiles, overlap one another's conversions and products. A warpgroup
//     hands a ring slot back once its products are done. Nothing goes
//     through shared memory but TMA's tiles: no converted tile, no fence,
//     no named barrier.
//  3. One slice: the epilogue adds the bias and stores bf16 from the
//     accumulators (a lane's two channels of each of its rows). K slices:
//     the partials go over the ring, [row][channel], and the cluster sums
//     them.
// What the measurements on an H100 showed (PERF.md): converting into a
// shared-memory tile for wgmma with both operands there was 3-28% slower
// (its stage waited on the conversion, a proxy fence and two barriers, and
// moved more shared-memory bytes), and clusters of 4 and 8 cost more than
// smaller tiles do, so `plan` takes the fewest slices that fill the card.
// The tensor maps are built on the host for each call and passed in the
// __grid_constant__ parameters, so a call captured in a CUDA graph carries
// them and allocates nothing.
//
// The TPU had no such kernel to translate: on it the dequantize is an
// elementwise op that XLA fused into the matmul's operand fetch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace hopper;

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTileK = 128;   // k a stage holds
constexpr int kStages = 4;    // ring slots
constexpr int kRedPad = 4;    // f32 past each row of the partial-sum tile
constexpr int kMaxSmem = 227 * 1024;

struct Params {
  const void* x;       // [M, K] XT
  const int8_t* q;     // [N, K]
  const float* scale;  // [N]
  const void* bias;    // [N] XT, or null
  void* y;             // [M, N] XT
  int M, N, K;
  int ks;              // blocks of a cluster: slices of K
  int units;           // ceil(K / kTileK)
  float mult;          // 1 + perturb
};

template <typename XT, int BT, int BN>
struct Shape {
  static constexpr bool kBf16 = std::is_same<XT, bf16>::value;
  // bf16: warps along channels (16 each) and along the 64-k halves.
  static constexpr int kWarpsN = BN / 16;
  static constexpr int kWarpsK = kWarps / kWarpsN;
  // f32: threads of one channel, each a contiguous k range of a stage.
  static constexpr int kThreadsK = kThreads / BN;
  static constexpr int kParts = kBf16 ? kWarpsK : kThreadsK;
  static constexpr int kWBytes = BN * kTileK;                    // int8 tile
  static constexpr int kXBytes = BT * kTileK * (int)sizeof(XT);  // x tile
  static constexpr int kStageBytes = kWBytes + kXBytes;
  static constexpr int kRedRow = BN + kRedPad;
  static constexpr int kRedBytes = kParts * BT * kRedRow * 4;
  static constexpr int kSmem = kStages * kStageBytes + kRedBytes;
  static_assert(kSmem <= kMaxSmem, "tile too large for shared memory");
};

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Bytes 0-1 / 2-3 of a word of four int8, each times s and rounded to
// bf16 (round to nearest even: the reference's cast), as bf16 pairs.
__device__ __forceinline__ void dequant4(uint32_t w, float s, uint32_t& lo, uint32_t& hi) {
  lo = pack_f32((float)((int)(w << 24) >> 24) * s, (float)((int)(w << 16) >> 24) * s);
  hi = pack_f32((float)((int)(w << 8) >> 24) * s, (float)((int)w >> 24) * s);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
template <typename XT>
__device__ __forceinline__ XT from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) { return __float2bfloat16_rn(v); }

// The epilogue of a tile whose K slices are the ks blocks of a cluster: each
// block has left kParts partial tiles [kRows][BN + kRedPad] (f32) at shared
// address `red`. After a cluster barrier each block takes its share of the
// tile's outputs, in groups of 4 channels: the sum over the cluster's blocks
// (rank order) of their parts (part order) through distributed shared
// memory, plus the bias, stored as XT; rows past M are skipped. A fixed
// order, no scratch and no atomics: two calls give bit-identical results.
// Every thread of the block (kThreadsN) takes part.
template <typename XT, int kRows, int BN, int kParts, int kThreadsN>
__device__ __forceinline__ void cluster_sum_store(uint32_t red, int ks, uint32_t rank, int m0,
                                                  int n0, int M, int N, const XT* bias, XT* y) {
  constexpr int kRedRow = BN + kRedPad;
  cluster_arrive();  // release: this block's partials are visible to the cluster
  cluster_wait();
  constexpr int kGroupsRow = BN / 4;
  constexpr int kGroups = kRows * kGroupsRow;
  const int gb = (int)((long long)kGroups * rank / ks);
  const int ge = (int)((long long)kGroups * (rank + 1) / ks);
  for (int gi = gb + (int)threadIdx.x; gi < ge; gi += kThreadsN) {
    const int r = gi / kGroupsRow, c = (gi % kGroupsRow) * 4;
    const int m = m0 + r, n = n0 + c;
    if (m >= M) continue;
    float sum[4] = {0.f, 0.f, 0.f, 0.f};
    for (int b = 0; b < ks; ++b) {
#pragma unroll
      for (int part = 0; part < kParts; ++part) {
        const uint32_t a = red + ((part * kRows + r) * kRedRow + c) * 4;
        const float4 v = ld_cluster_v4(cluster_map(a, b));
        sum[0] += v.x; sum[1] += v.y; sum[2] += v.z; sum[3] += v.w;
      }
    }
    XT out[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float bv = (bias != nullptr && n + e < N) ? to_f32(bias[n + e]) : 0.f;
      out[e] = from_f32<XT>(sum[e] + bv);
    }
    XT* dst = y + (size_t)m * N + n;
    if (n + 4 <= N && (N & 3) == 0) {
      if constexpr (std::is_same<XT, bf16>::value) {
        uint2 v;
        v.x = (uint32_t)__bfloat16_as_ushort(out[0]) | ((uint32_t)__bfloat16_as_ushort(out[1]) << 16);
        v.y = (uint32_t)__bfloat16_as_ushort(out[2]) | ((uint32_t)__bfloat16_as_ushort(out[3]) << 16);
        *reinterpret_cast<uint2*>(dst) = v;
      } else {
        *reinterpret_cast<float4*>(dst) = make_float4(to_f32(out[0]), to_f32(out[1]),
                                                      to_f32(out[2]), to_f32(out[3]));
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (n + e < N) dst[e] = out[e];
    }
  }
  cluster_arrive_relaxed();  // stay alive until the cluster has read our partials
  cluster_wait();
}

// Stage `u` (k0 = u * kTileK) of the weight tile (channels n0 ..) and the x
// tile (rows m0 ..) into ring slot `slot`. Weight layout: two 64-k halves,
// each [BN rows][64 bytes]. x layout (bf16): two 64-k halves, each [BT
// rows][128 bytes]; (f32): [BT rows][512 bytes].
template <typename XT, int BT, int BN>
__device__ __forceinline__ void load_stage(const Params& p, uint32_t slot, int n0, int m0,
                                           int u) {
  using S = Shape<XT, BT, BN>;
  const int k0 = u * kTileK;
  // Weights: BN rows of 8 chunks of 16 bytes.
#pragma unroll
  for (int i = 0; i < BN * 8 / kThreads; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int n = c >> 3, kc = c & 7;
    const bool ok = n0 + n < p.N && k0 + kc * 16 < p.K;
    const int8_t* src = ok ? p.q + (size_t)(n0 + n) * p.K + k0 + kc * 16 : p.q;
    cp_async16(slot + (kc >> 2) * (BN * 64) + n * 64 + (kc & 3) * 16, src, ok);
  }
  // x: BT rows of kTileK * sizeof(XT) / 16 chunks.
  constexpr int per_row = kTileK * (int)sizeof(XT) / 16;  // 16 (bf16) or 32 (f32)
  constexpr int elems = 16 / (int)sizeof(XT);
  const XT* x = static_cast<const XT*>(p.x);
  const uint32_t xs = slot + S::kWBytes;
  for (int c = threadIdx.x; c < BT * per_row; c += kThreads) {
    const int r = c / per_row, kc = c % per_row;
    const bool ok = m0 + r < p.M && k0 + kc * elems < p.K;
    const XT* src = ok ? x + (size_t)(m0 + r) * p.K + k0 + kc * elems : x;
    uint32_t dst;
    if constexpr (S::kBf16)
      dst = xs + (kc >> 3) * (BT * 128) + r * 128 + (kc & 7) * 16;
    else
      dst = xs + r * 512 + kc * 16;
    cp_async16(dst, src, ok);
  }
}

template <typename XT, int BT, int BN>
__global__ void __launch_bounds__(kThreads) int8_linear_kernel(const Params p) {
  using S = Shape<XT, BT, BN>;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  const uint32_t smem = smem_addr(smem_raw);
  float* red = reinterpret_cast<float*>(smem_raw + kStages * S::kStageBytes);

  const uint32_t rank = cluster_rank();
  const int n0 = (blockIdx.x / p.ks) * BN;
  const int m0 = blockIdx.y * BT;
  // This block's K slice: units [u0, u1) of kTileK.
  const int u0 = (int)((long long)p.units * rank / p.ks);
  const int u1 = (int)((long long)p.units * (rank + 1) / p.ks);
  const int nu = u1 - u0;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  // Accumulators. bf16: per n8 tile of rows, the mma C layout (channels g
  // and g + 8 of the warp's 16, rows 2t and 2t + 1). f32: one channel,
  // every row.
  constexpr int kNT = BT / 8;
  float acc[S::kBf16 ? kNT * 4 : BT];
#pragma unroll
  for (int i = 0; i < (S::kBf16 ? kNT * 4 : BT); ++i) acc[i] = 0.f;

  // Per-thread channel scales (perturb folded in).
  const int wn = S::kBf16 ? warp % S::kWarpsN : 0;   // bf16 channel group
  const int wk = S::kBf16 ? warp / S::kWarpsN : 0;   // bf16 64-k half
  const int fc = tid % BN, fk = tid / BN;            // f32 channel, k group
  float s0, s1;
  if constexpr (S::kBf16) {
    const int c0 = n0 + wn * 16 + g, c1 = c0 + 8;
    s0 = c0 < p.N ? __ldg(p.scale + c0) * p.mult : 0.f;
    s1 = c1 < p.N ? __ldg(p.scale + c1) * p.mult : 0.f;
  } else {
    s0 = n0 + fc < p.N ? __ldg(p.scale + n0 + fc) * p.mult : 0.f;
    s1 = 0.f;
  }

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nu) load_stage<XT, BT, BN>(p, smem + s * S::kStageBytes, n0, m0, u0 + s);
    cp_async_commit();
  }
  for (int i = 0; i < nu; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage i landed for every thread; slot of i - 1 is free
    const int nx = i + kStages - 1;
    if (nx < nu) load_stage<XT, BT, BN>(p, smem + (nx % kStages) * S::kStageBytes, n0, m0, u0 + nx);
    cp_async_commit();
    const uint32_t slot = smem + (i % kStages) * S::kStageBytes;
    const uint32_t xs = slot + S::kWBytes;
    if constexpr (S::kBf16) {
#pragma unroll
      for (int j = wk; j < 2; j += S::kWarpsK) {  // 64-k halves of the stage
        const uint32_t wrow = slot + j * (BN * 64) + (wn * 16 + g) * 64 + t * 16;
        const uint4 wa = lds128(wrow), wb = lds128(wrow + 8 * 64);
        const uint32_t wa_w[4] = {wa.x, wa.y, wa.z, wa.w};
        const uint32_t wb_w[4] = {wb.x, wb.y, wb.z, wb.w};
        // x: 32 bytes of each row of the tile; odd rows read their second
        // 16 bytes first (the two halves of a quarter-warp then fall on
        // different banks).
        uint32_t xw[kNT][8];
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          const uint32_t row = xs + j * (BT * 128) + (nt * 8 + g) * 128 + t * 32;
          const int odd = g & 1;
          const uint4 first = lds128(row + odd * 16), second = lds128(row + (1 - odd) * 16);
          const uint4 lo = odd ? second : first, hi = odd ? first : second;
          xw[nt][0] = lo.x; xw[nt][1] = lo.y; xw[nt][2] = lo.z; xw[nt][3] = lo.w;
          xw[nt][4] = hi.x; xw[nt][5] = hi.y; xw[nt][6] = hi.z; xw[nt][7] = hi.w;
        }
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          uint32_t a[4];
          dequant4(wa_w[s], s0, a[0], a[2]);
          dequant4(wb_w[s], s1, a[1], a[3]);
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt) mma_16816(acc + nt * 4, a, xw[nt][2 * s], xw[nt][2 * s + 1]);
        }
      }
    } else {
      // f32: channel fc, k range [fk * kk, (fk + 1) * kk) of the stage.
      constexpr int kk = kTileK / S::kThreadsK;
#pragma unroll 1
      for (int v = 0; v < kk / 16; ++v) {
        const int k = fk * kk + v * 16;  // 16 k, one 16-byte chunk of int8
        const uint4 w4 = lds128(slot + (k >> 6) * (BN * 64) + fc * 64 + (k & 63));
        const uint32_t ww[4] = {w4.x, w4.y, w4.z, w4.w};
        float w[16];
#pragma unroll
        for (int e = 0; e < 16; ++e) w[e] = (float)(((int)(ww[e >> 2] << (24 - 8 * (e & 3)))) >> 24) * s0;
        const float* xf = reinterpret_cast<const float*>(smem_raw + (xs - smem));
#pragma unroll
        for (int r = 0; r < BT; ++r) {
          const float* xr = xf + r * kTileK + k;
#pragma unroll
          for (int e = 0; e < 16; e += 4) {
            const float4 xv = *reinterpret_cast<const float4*>(xr + e);
            acc[r] = fmaf(xv.x, w[e], acc[r]);
            acc[r] = fmaf(xv.y, w[e + 1], acc[r]);
            acc[r] = fmaf(xv.z, w[e + 2], acc[r]);
            acc[r] = fmaf(xv.w, w[e + 3], acc[r]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // Partial sums to shared memory: red[part][row][channel].
  if constexpr (S::kBf16) {
    float* part = red + wk * BT * S::kRedRow;
    const int c0 = wn * 16 + g;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const int r = nt * 8 + 2 * t;
      part[r * S::kRedRow + c0] = acc[nt * 4 + 0];
      part[(r + 1) * S::kRedRow + c0] = acc[nt * 4 + 1];
      part[r * S::kRedRow + c0 + 8] = acc[nt * 4 + 2];
      part[(r + 1) * S::kRedRow + c0 + 8] = acc[nt * 4 + 3];
    }
  } else {
    float* part = red + fk * BT * S::kRedRow;
#pragma unroll
    for (int r = 0; r < BT; ++r) part[r * S::kRedRow + fc] = acc[r];
  }
  cluster_sum_store<XT, BT, BN, S::kParts, kThreads>(smem_addr(red), p.ks, rank, m0, n0, p.M,
                                                     p.N, static_cast<const XT*>(p.bias),
                                                     static_cast<XT*>(p.y));
}

template <typename XT, int BT, int BN>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  using S = Shape<XT, BT, BN>;
  auto kernel = int8_linear_kernel<XT, BT, BN>;
  static PerDevice<size_t> configured(0);
  cudaError_t err = allow_smem(kernel, S::kSmem, configured);
  if (err != cudaSuccess) return err;
  const int tiles_n = (p.N + BN - 1) / BN, tiles_m = (p.M + BT - 1) / BT;
  if (tiles_m > 65535 || (long long)tiles_n * p.ks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles_n * p.ks, tiles_m, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = S::kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.ks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename XT, int BN>
cudaError_t dispatch_bt(int bt, const Params& p, cudaStream_t stream) {
  switch (bt) {
    case 8: return launch<XT, 8, BN>(p, stream);
    case 16: return launch<XT, 16, BN>(p, stream);
    case 32: return launch<XT, 32, BN>(p, stream);
    case 64: return launch<XT, 64, BN>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename XT>
cudaError_t dispatch(int bt, int bn, const Params& p, cudaStream_t stream) {
  switch (bn) {
    case 32: return dispatch_bt<XT, 32>(bt, p, stream);
    case 64: return dispatch_bt<XT, 64>(bt, p, stream);
    default: return cudaErrorInvalidValue;
  }
}

// -- the wgmma route (bf16 x, prefill-sized M) ---------------------------------
namespace wg {
constexpr int kTileK = 64;   // k a stage holds: one 128-byte bf16 row of x
constexpr int kMaxStages = 8;
}  // namespace wg
constexpr int cmin(int a, int b) { return a < b ? a : b; }

struct WgParams {
  CUtensorMap x;       // x [M, K] bf16: boxes of BM rows x 64 columns, 128-byte swizzle
  CUtensorMap q;       // q [N, K] int8: boxes of BN rows x 64 bytes, 64-byte swizzle
  const float* scale;  // [N]
  const bf16* bias;    // [N], or null
  bf16* y;             // [M, N]
  int M, N, K;
  int ks;              // blocks of a cluster: slices of K
  int units;           // ceil(K / wg::kTileK)
  float mult;          // 1 + perturb
};

// A block: BM rows of x, CW consumer warpgroups of 64 output channels each
// (BN = 64 CW), and a producer warp; OCC blocks an SM (the shared memory a
// block may take: the SM's 228 KB less 1 KB a block, shared).
template <int BM, int CW, int OCC>
struct WgShape {
  static constexpr int kBudget = OCC == 1 ? kMaxSmem : (228 / OCC - 1) * 1024;
  static constexpr int kBN = 64 * CW;
  static constexpr int kConsumerThreads = 128 * CW;
  static constexpr int kThreads = kConsumerThreads + 32;
  static constexpr int kXBytes = BM * kRowBytes;          // x tile [BM][64], swizzled
  static constexpr int kQBytes = kBN * wg::kTileK;        // int8 tile [BN][64], swizzled
  static constexpr int kStageBytes = kXBytes + kQBytes;
  static constexpr int kRedRow = kBN + kRedPad;
  static constexpr int kRedBytes = BM * kRedRow * 4;      // partials, over the ring
  static constexpr int kFixed = 2 * wg::kMaxStages * 8 + 1024;  // barriers, alignment
  static constexpr int kStages = cmin(wg::kMaxStages, (kBudget - kFixed) / kStageBytes);
  static constexpr int kSmem = kStages * kStageBytes + kFixed;
  static_assert(kStages >= 3, "ring too shallow");
  static_assert(kStages * kStageBytes >= kRedBytes, "the partials must fit over the ring");
  static_assert(kStageBytes % 1024 == 0, "tiles start on the swizzles' period");
};

// Two int8 of the word w (bytes 2h, 2h + 1: selectors sel, sel + 1 of
// 0x7650 | 2h), each times s and rounded to bf16 as the reference does, as
// a bf16 pair. float(b) comes from the bits, not from I2F: with 0x80 xored
// in, byte u = b + 128 is the low byte of the f32 2^23 + u, and
// subtracting 2^23 + 128 leaves b exactly; the product is then the
// reference's one f32 multiply.
__device__ __forceinline__ uint32_t dequant2(uint32_t w, uint32_t sel, float s) {
  w ^= 0x80808080u;
  const float lo = (__uint_as_float(__byte_perm(w, 0x4B000000u, sel)) - 8388736.f) * s;
  const float hi = (__uint_as_float(__byte_perm(w, 0x4B000000u, sel + 1)) - 8388736.f) * s;
  return pack_f32(lo, hi);
}

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

template <int BM, int CW, int OCC>
__global__ void __launch_bounds__(WgShape<BM, CW, OCC>::kThreads, OCC)
    int8_linear_wgmma(const __grid_constant__ WgParams p) {
  using S = WgShape<BM, CW, OCC>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_base(smem_raw);  // stage s: x tile, then int8 tile
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S::kStages * S::kStageBytes);
  uint64_t* free_ = full + S::kStages;

  const uint32_t rank = cluster_rank();
  const int n0 = (blockIdx.x / p.ks) * S::kBN;
  const int m0 = blockIdx.y * BM;
  // This block's K slice: units [u0, u1) of wg::kTileK.
  const int u0 = (int)((long long)p.units * rank / p.ks);
  const int u1 = (int)((long long)p.units * (rank + 1) / p.ks);
  const int nu = u1 - u0;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < S::kStages; ++s) {
      bar_init(full + s, 1);
      bar_init(free_ + s, S::kConsumerThreads / 32);
    }
    bar_init_fence();
  }
  __syncthreads();

  // D = W x^T in the wgmma C layout: warpgroup cw, warp w, lane (g, t)
  // holds channels c0 = 64 cw + 16 w + g and c1 = c0 + 8 (the A rows) of
  // rows 8 j + 2 t (+ 1) of the x tile: acc[4 j + e] (c0), acc[4 j + 2 + e] (c1).
  float acc[BM / 2];
#pragma unroll
  for (int i = 0; i < BM / 2; ++i) acc[i] = 0.f;
  const int lane = tid % 32, g = lane / 4, t = lane % 4;
  const int c0 = (tid / 32) * 16 + g, c1 = c0 + 8;

  if (tid >= S::kConsumerThreads) {
    // Producer: one thread keeps the ring full.
    if (tid == S::kConsumerThreads) {
      for (int i = 0; i < nu; ++i) {
        const int s = i % S::kStages;
        bar_wait(free_ + s, ((i / S::kStages) & 1) ^ 1);
        bar_expect(full + s, S::kStageBytes);
        uint8_t* st = ring + s * S::kStageBytes;
        const int k0 = (u0 + i) * wg::kTileK;
        tma_load(st, &p.x, full + s, k0, m0);
        tma_load(st + S::kXBytes, &p.q, full + s, k0, n0);
      }
    }
    __syncwarp();
  } else {
    // The A fragment of k16 step s: channel c0 / c1, k 16 s + 2 t (+ 1) and
    // 16 s + 2 t + 8 (+ 1): halves t % 2 of the words at bytes 16 s + 4 (t / 2)
    // and + 8 of the channel's 64-byte row, whose 16-byte chunks the 64-byte
    // swizzle moves to chunk ^ (row / 2 % 4) (the same for c0 and c1 = c0 + 8;
    // a warp's 32 loads of a word then fall on 32 banks).
    const int swz = (c0 / 2) % 4;
    const uint32_t sel = 0x7650u | (2 * (t % 2));
    const uint32_t off0 = c0 * wg::kTileK + 4 * (t / 2), off1 = off0 + 8 * wg::kTileK;
    const float s0 = n0 + c0 < p.N ? __ldg(p.scale + n0 + c0) * p.mult : 0.f;
    const float s1 = n0 + c1 < p.N ? __ldg(p.scale + n0 + c1) * p.mult : 0.f;
    const uint32_t ring_a = smem_addr(ring);
    for (int i = 0; i < nu; ++i) {
      const int s = i % S::kStages;
      const uint32_t xs = ring_a + s * S::kStageBytes, qs = xs + S::kXBytes;
      bar_wait(full + s, (i / S::kStages) & 1);
      uint32_t a[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t chunk = qs + ((kk ^ swz) * 16);
        a[kk][0] = dequant2(lds32(chunk + off0), sel, s0);
        a[kk][1] = dequant2(lds32(chunk + off1), sel, s1);
        a[kk][2] = dequant2(lds32(chunk + off0 + 8), sel, s0);
        a[kk][3] = dequant2(lds32(chunk + off1 + 8), sel, s1);
      }
      reg_fence(acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<BM, 0>(acc, a[kk][0], a[kk][1], a[kk][2], a[kk][3], desc_k<BM>(xs, 0, kk), 1);
      wg_commit();
      wg_wait();  // the A registers and the slot's x tile are free again
      reg_fence(acc);
      if (lane == 0) bar_arrive(free_ + s);
    }
  }

  if (p.ks == 1) {
    // One slice: y straight from the accumulators.
    if (tid >= S::kConsumerThreads) return;
    const int n = n0 + c0, n1 = n0 + c1;
    const float b0 = p.bias != nullptr && n < p.N ? __bfloat162float(p.bias[n]) : 0.f;
    const float b1 = p.bias != nullptr && n1 < p.N ? __bfloat162float(p.bias[n1]) : 0.f;
#pragma unroll
    for (int j = 0; j < BM / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = m0 + 8 * j + 2 * t + e;
        if (m >= p.M) continue;
        bf16* row = p.y + (size_t)m * p.N;
        if (n < p.N) row[n] = __float2bfloat16_rn(acc[4 * j + e] + b0);
        if (n1 < p.N) row[n1] = __float2bfloat16_rn(acc[4 * j + 2 + e] + b1);
      }
    return;
  }
  // K slices: the partials [row][channel] go over the ring (every load has
  // landed and every wgmma has read it), then the cluster sums them.
  __syncthreads();
  float* red = reinterpret_cast<float*>(ring);
  if (tid < S::kConsumerThreads) {
#pragma unroll
    for (int j = 0; j < BM / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = 8 * j + 2 * t + e;
        red[r * S::kRedRow + c0] = acc[4 * j + e];
        red[r * S::kRedRow + c1] = acc[4 * j + 2 + e];
      }
  }
  cluster_sum_store<bf16, BM, S::kBN, 1, S::kThreads>(smem_addr(red), p.ks, rank, m0, n0, p.M,
                                                      p.N, p.bias, p.y);
}

// A 2-D [rows, cols] tensor map: boxes of box_rows rows x wg::kTileK
// columns, zeros past the edges, swizzled as the kernel reads it.
bool tile_map(CUtensorMap* map, const void* ptr, CUtensorMapDataType type, int elt, int rows,
              int cols, int box_rows, CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elt};
  const cuuint32_t box[2] = {(cuuint32_t)wg::kTileK, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BM, int CW, int OCC>
cudaError_t launch_wgmma(WgParams& p, const void* x, const void* q, cudaStream_t stream) {
  using S = WgShape<BM, CW, OCC>;
  if (!tile_map(&p.x, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, p.M, p.K, BM,
                CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tile_map(&p.q, q, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, p.N, p.K, S::kBN,
                CU_TENSOR_MAP_SWIZZLE_64B))
    return cudaErrorNotSupported;
  auto kernel = int8_linear_wgmma<BM, CW, OCC>;
  static PerDevice<size_t> configured(0);
  static PerDevice<bool> carved(false);
  cudaError_t err = allow_smem(kernel, S::kSmem, configured);
  if (err == cudaSuccess) err = max_shared_carveout(kernel, carved);
  if (err != cudaSuccess) return err;
  const int tiles_n = (p.N + S::kBN - 1) / S::kBN, tiles_m = (p.M + BM - 1) / BM;
  if (tiles_m > 65535 || (long long)tiles_n * p.ks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles_n * p.ks, tiles_m, 1);
  cfg.blockDim = dim3(S::kThreads, 1, 1);
  cfg.dynamicSmemBytes = S::kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.ks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// (bt, bn) of ops/int8_linear.py `plan`'s wgmma tilings: 128 channels take
// an SM alone, 64 share it three ways.
cudaError_t dispatch_wgmma(int bt, int bn, WgParams& p, const void* x, const void* q,
                           cudaStream_t stream) {
  if (bt == 128 && bn == 128) return launch_wgmma<128, 2, 1>(p, x, q, stream);
  if (bt == 128 && bn == 64) return launch_wgmma<128, 1, 3>(p, x, q, stream);
  if (bt == 64 && bn == 64) return launch_wgmma<64, 1, 3>(p, x, q, stream);
  return cudaErrorInvalidValue;
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

}  // namespace

// x [M, K] and y [M, N] in x_dtype (0 = float32, 1 = bfloat16), q int8
// [N, K], scale f32 [N], bias [N] in x_dtype or null; all contiguous, on
// one device, x and q 16-byte aligned, K a multiple of 16. route and (bt,
// bn, ks) are ops/int8_linear.py `plan`'s: route 0 the cp.async kernel
// (bf16 mma.sync or f32 FMAs; bt in {8, 16, 32, 64}, bn in {32, 64}), route
// 1 the wgmma kernel (bf16 only; bt 128 or 256, bn in {32, 64, 128}); ks the
// cluster's K slices. One launch on `stream`; returns its cudaError_t.
extern "C" int skypilot_int8_linear(const void* x, const void* q, const void* scale,
                                    const void* bias, void* y, int M, int N, int K, int route,
                                    int bt, int bn, int ks, int x_dtype, float perturb,
                                    void* stream) {
  if (M <= 0) return cudaSuccess;
  if (N <= 0 || K <= 0 || K % 16 != 0 || !(ks == 1 || ks == 2 || ks == 4 || ks == 8) ||
      !aligned16(x) || !aligned16(q))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    if (x_dtype != 1) return cudaErrorInvalidValue;
    WgParams p;
    p.scale = static_cast<const float*>(scale);
    p.bias = static_cast<const bf16*>(bias);
    p.y = static_cast<bf16*>(y);
    p.M = M; p.N = N; p.K = K;
    p.ks = ks;
    p.units = (K + wg::kTileK - 1) / wg::kTileK;
    p.mult = 1.f + perturb;
    return dispatch_wgmma(bt, bn, p, x, q, st);
  }
  if (route != 0) return cudaErrorInvalidValue;
  Params p;
  p.x = x;
  p.q = static_cast<const int8_t*>(q);
  p.scale = static_cast<const float*>(scale);
  p.bias = bias;
  p.y = y;
  p.M = M; p.N = N; p.K = K;
  p.ks = ks;
  p.units = (K + kTileK - 1) / kTileK;
  p.mult = 1.f + perturb;
  switch (x_dtype) {
    case 0: return dispatch<float>(bt, bn, p, st);
    case 1: return dispatch<bf16>(bt, bn, p, st);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* skypilot_int8_linear_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
