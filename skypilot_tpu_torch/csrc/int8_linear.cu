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
// the bias.
//
// What bounds it on an H100: bytes. At decode (M <= 64) the int8 weights
// are nearly all of them (Llama-3-8B's wq: 16.8 MB of int8 against 64 KB of
// x at M = 8: 5.0 us at 3.35 TB/s, against 0.07 us of bf16 tensor-core
// work). So every weight byte is read once, by 16-byte cp.async copies
// kept several stages deep, and the grid is cut so that every projection
// at M = 8 runs at least ~132 blocks. A 2048-row prompt turns the same
// kernel compute-bound (mma.sync, not wgmma: a later design's lever).
//
// Design. 128 threads (4 warps) a block; a block owns BN (64 or 32) output
// channels x BT (8, 16, 32 or 64) rows of x, and one of KS (1, 2, 4 or 8)
// slices of K. The blocks of one (channel tile, row tile) form a thread-
// block cluster of KS along x (ops/int8_linear.py `plan` picks BT, BN and
// KS from the shapes and the SM count: more slices where the channel tiles
// alone cannot fill the card, as wk / wv's 1024 channels cannot).
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
//  3. The partial sums of a block go to shared memory; after a cluster
//     barrier each block of the cluster sums its share of the tile's
//     outputs over the KS blocks (and the warps' k halves) in a fixed
//     order through distributed shared memory, adds the bias and stores.
//     No scratch in device memory and no atomics: two calls give
//     bit-identical results, and nothing is allocated here, so a call can
//     be captured in a CUDA graph.
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
  cluster_arrive();  // release: this block's partials are visible to the cluster
  cluster_wait();

  // This block's share of the tile's outputs, in groups of 4 channels: the
  // sum over the cluster's blocks (rank order) of their parts (part order).
  constexpr int kGroupsRow = BN / 4;
  constexpr int kGroups = BT * kGroupsRow;
  const int gb = (int)((long long)kGroups * rank / p.ks);
  const int ge = (int)((long long)kGroups * (rank + 1) / p.ks);
  const uint32_t red_addr = smem_addr(red);
  const XT* bias = static_cast<const XT*>(p.bias);
  XT* y = static_cast<XT*>(p.y);
  for (int gi = gb + tid; gi < ge; gi += kThreads) {
    const int r = gi / kGroupsRow, c = (gi % kGroupsRow) * 4;
    const int m = m0 + r, n = n0 + c;
    if (m >= p.M) continue;
    float sum[4] = {0.f, 0.f, 0.f, 0.f};
    for (int b = 0; b < p.ks; ++b) {
#pragma unroll
      for (int part = 0; part < S::kParts; ++part) {
        const uint32_t a = red_addr + ((part * BT + r) * S::kRedRow + c) * 4;
        const float4 v = ld_cluster_v4(cluster_map(a, b));
        sum[0] += v.x; sum[1] += v.y; sum[2] += v.z; sum[3] += v.w;
      }
    }
    XT out[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float bv = (bias != nullptr && n + e < p.N) ? to_f32(bias[n + e]) : 0.f;
      out[e] = from_f32<XT>(sum[e] + bv);
    }
    XT* dst = y + (size_t)m * p.N + n;
    if (n + 4 <= p.N && (p.N & 3) == 0) {
      if constexpr (S::kBf16) {
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
        if (n + e < p.N) dst[e] = out[e];
    }
  }
  cluster_arrive_relaxed();  // stay alive until the cluster has read our partials
  cluster_wait();
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

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

}  // namespace

// x [M, K] and y [M, N] in x_dtype (0 = float32, 1 = bfloat16), q int8
// [N, K], scale f32 [N], bias [N] in x_dtype or null; all contiguous, on
// one device, x and q 16-byte aligned, K a multiple of 16. (bt, bn, ks) is
// the tiling of ops/int8_linear.py `plan`: rows and channels a block, and
// the cluster's K slices. One launch on `stream`; returns its cudaError_t.
extern "C" int skypilot_int8_linear(const void* x, const void* q, const void* scale,
                                    const void* bias, void* y, int M, int N, int K, int bt,
                                    int bn, int ks, int x_dtype, float perturb, void* stream) {
  if (M <= 0) return cudaSuccess;
  if (N <= 0 || K <= 0 || K % 16 != 0 || !(ks == 1 || ks == 2 || ks == 4 || ks == 8) ||
      !aligned16(x) || !aligned16(q))
    return cudaErrorInvalidValue;
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case 0: return dispatch<float>(bt, bn, p, st);
    case 1: return dispatch<bf16>(bt, bn, p, st);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* skypilot_int8_linear_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
