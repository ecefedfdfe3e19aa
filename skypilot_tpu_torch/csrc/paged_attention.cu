// Paged grouped-query attention over a paged KV pool, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_attention_kernel` of
// skypilot_tpu/ops/pallas_paged.py:224 (launched through `_fused_call` /
// `fused_paged_attention`). Its bf16 path also stands in for the upstream
// jax.experimental.pallas.ops.tpu.paged_attention decode kernel, which
// the TPU dispatched for bf16 pools.
//
// What it computes, for query row (b, s, hq) with kv head h = hq / G:
//   out = softmax_t( q . k_t * sm_scale * (1 + perturb) ) @ v_t
// over the row's cached tokens t <= positions[b, s], where token t lives
// at physical page page_table[b, t / page_size], slot t % page_size of
// the pool [Hkv, P, page_size, D]. int8 pools carry one f32 scale per
// (page, slot), shared across heads. A row with no visible token
// (position < 0) returns 0, never NaN.
//
// Three routes; ops/paged_kernel.py picks one by a fixed rule on shapes
// and dtypes, and each is one launch:
//
// split (bf16 q; bf16 or int8 pool; D 64 or 128; page size 8..64; S * G
//   <= 16 query rows per kv head: decode). Bound by bytes: a decode step
//   does ~4 G flops per KV byte, far under the card's ~295 flop/byte, so
//   the floor is the visible K/V bytes over 3.35 TB/s (0.0101 ms at
//   B=8, Hkv=8, D=128, context 1024, bf16). A block per (split of the
//   page table, kv head, batch row): the wrapper cuts each row's table
//   into as many splits as fill one wave of ~2 blocks an SM
//   (flash-decoding), since (B x Hkv) blocks alone leave most SMs idle at
//   small batch. A block streams its 32-token tiles through a 3-stage
//   shared-memory ring, K and V kept in the pool's type, each token row
//   fetched by 16-byte cp.async (zero-filled past the visible tokens)
//   that arrive on the stage's mbarrier; its page-table slice and q come
//   in first, in one round trip. Each warp takes 8 tokens of a tile and
//   runs its products on the tensor cores: S = q K^T as m16n8k16
//   mma.sync (q's <= 8 rows in registers, K by ldmatrix from a swizzled
//   tile; f32 accumulation), an online softmax in f32 (int8: score t times
//   k_scale[t]), then O += P V as m16n8k8 with P rounded to bf16 (int8:
//   weight t times v_scale[t] first) and V by transposing ldmatrix. int8
//   tiles are converted to bf16 (exact) per warp first. A first version
//   with f32 FMAs from bf16x2 reads spent ~650 instructions a warp on a
//   tile, more than the memory system needs to deliver it; on an H100
//   SXM it ran 25-28 us at B=8 against 19.5 us with mma.sync. The warps
//   combine at the end. Splits with no visible token write an empty partial (m = -inf,
//   l = 0, acc = 0) and skip the loads: the host cannot see row lengths
//   without a sync. Merge: each block writes its (m, l, acc) partial to
//   an f32 scratch and arrives on a counter of its (b, kv head, row
//   group); the last to arrive merges all partials by log-sum-exp in one
//   pass, writes the rows and resets the counter to 0. That keeps a call
//   at one launch (a second merge kernel would add a launch gap of the
//   order of the merge itself at decode sizes); a row empty in every
//   split merges to 0.
//
// chunk (the same dtypes and page sizes, S * G > 16: prefill chunks past
//   offset 0). Bound by operations: at S=256, offset 768 it does 4 D Hq
//   sum(pos + 1) ~ 3.8 GFLOP (0.0038 ms at the bf16 tensor-core peak)
//   on 4 MB of K/V. A block per (64-row tile, kv head, batch row); a
//   tile's rows are 64 / G query positions x the G heads of one kv head,
//   so each K/V byte feeds every row. At S=256 that is only 128 blocks,
//   one a SM, so a block holds two warpgroups that take alternate K/V
//   tiles (each with its own online softmax, merged at the end): one
//   warpgroup alone left the SM idle between its loads, products and
//   softmax. 64-token K/V tiles arrive by cp.async in the
//   128-byte-swizzled wgmma layout (each token's row of a page is
//   contiguous) through a 3-stage mbarrier ring per warpgroup; S = Q K^T
//   and O += P V run as wgmma (P rounded to bf16 in registers as the A
//   operand, V read MN-major) with the online softmax in f32, base 2.
//   Tiles past the tile's largest position are skipped. int8 tiles land
//   raw and are converted to bf16 (exact) before the products; the scales
//   fold in as on the split route.
//
// scalar (f32 pools, the parity path; and shapes the routes above do not
//   take): the port's first kernel, kept as it was: one block per (32
//   query rows, kv head, batch row) walking the whole context in 32-token
//   tiles with f32 CUDA-core FMAs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

// -- scalar route ------------------------------------------------------------------
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 8;
constexpr int kRows = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kTile = 32;                     // cached tokens per step, one per lane
constexpr int kMaxD = 128;
constexpr int kDimsPerLane = kMaxD / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One tile of K and V (kTile cached tokens x D) staged in registers as
// 16-byte vectors: every thread issues all its loads of a tile before
// using any, and the next tile's loads are in flight while the block
// computes on the current one.
template <typename KVT, bool kQuant>
struct TileLoader {
  static constexpr int kVec = 16 / sizeof(KVT);  // elements per vector
  static constexpr int kLoads = (kTile * kMaxD / kVec + kThreads - 1) / kThreads;
  uint4 k[kLoads], v[kLoads];
  float ks[kLoads], vs[kLoads];

  __device__ __forceinline__ void load(const KVT* __restrict__ k_pages,
                                       const KVT* __restrict__ v_pages,
                                       const float* __restrict__ k_scales,
                                       const float* __restrict__ v_scales,
                                       const int* table_s, int t0, int n_tokens,
                                       int h, int D, int P, int page_size,
                                       int tid) {
    const int per_row = D / kVec;
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int vi = tid + i * kThreads;
      const int t = vi / per_row;
      const int tok = t0 + t;
      k[i] = v[i] = make_uint4(0u, 0u, 0u, 0u);
      ks[i] = vs[i] = 0.f;
      if (t < kTile && tok < n_tokens) {
        const int lp = tok / page_size;
        const int slot = tok - lp * page_size;
        const int phys = table_s[lp];
        const size_t off = (((size_t)h * P + phys) * page_size + slot) * D +
                           (size_t)(vi - t * per_row) * kVec;
        k[i] = *reinterpret_cast<const uint4*>(k_pages + off);
        v[i] = *reinterpret_cast<const uint4*>(v_pages + off);
        if (kQuant) {
          ks[i] = k_scales[(size_t)phys * page_size + slot];
          vs[i] = v_scales[(size_t)phys * page_size + slot];
        }
      }
    }
  }

  // Convert to f32 (dequantizing int8) into k_s/v_s [kTile][ld].
  __device__ __forceinline__ void store(float* k_s, float* v_s, int ld, int D,
                                        int tid) const {
    const int per_row = D / kVec;
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int vi = tid + i * kThreads;
      const int t = vi / per_row;
      if (t >= kTile) continue;
      const int c = (vi - t * per_row) * kVec;
      const KVT* kk = reinterpret_cast<const KVT*>(&k[i]);
      const KVT* vv = reinterpret_cast<const KVT*>(&v[i]);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        float a = to_f32(kk[e]), b = to_f32(vv[e]);
        if (kQuant) {
          a *= ks[i];
          b *= vs[i];
        }
        k_s[t * ld + c + e] = a;
        v_s[t * ld + c + e] = b;
      }
    }
  }
};

template <typename QT, typename KVT, bool kQuant>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const QT* __restrict__ q, const KVT* __restrict__ k_pages,
                       const KVT* __restrict__ v_pages,
                       const float* __restrict__ k_scales,
                       const float* __restrict__ v_scales,
                       const int* __restrict__ positions,
                       const int* __restrict__ page_table, QT* __restrict__ out,
                       int S, int Hq, int Hkv, int D, int P, int page_size,
                       int pages_per_seq, float sm_scale, float perturb) {
  extern __shared__ float smem[];
  __shared__ int pos_s[kRows];
  __shared__ int n_tokens_s;

  const int ld = D + 1;  // padded: lane t reads row t of K conflict-free
  float* q_s = smem;                                     // [kRows][D]
  float* k_s = q_s + kRows * D;                          // [kTile][ld]
  float* v_s = k_s + kTile * ld;                         // [kTile][ld]
  int* table_s = reinterpret_cast<int*>(v_s + kTile * ld);  // [pages_per_seq]

  const int G = Hq / Hkv;
  const int row0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int rows_here = min(kRows, S * G - row0);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // Query row r of the tile is (s, g) = divmod(row0 + r, G): q[b, s, h*G + g].
  for (int e = tid; e < rows_here * D; e += kThreads) {
    const int r = e / D;
    const int d = e - r * D;
    const int row = row0 + r;
    const int s = row / G;
    const int g = row - s * G;
    q_s[r * D + d] = to_f32(q[((size_t)(b * S + s) * Hq + h * G + g) * D + d]);
  }
  for (int i = tid; i < pages_per_seq; i += kThreads)
    table_s[i] = page_table[(size_t)b * pages_per_seq + i];
  if (tid < kRows) {
    pos_s[tid] = tid < rows_here ? positions[b * S + (row0 + tid) / G] : -1;
  }
  __syncthreads();
  if (warp == 0) {
    // kRows == 32: one position per lane. Tokens past the largest
    // position are masked for every row of the block; past the page
    // table they do not exist.
    int mp = pos_s[lane];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mp = max(mp, __shfl_xor_sync(0xffffffffu, mp, o));
    if (lane == 0) n_tokens_s = max(0, min(mp + 1, pages_per_seq * page_size));
  }
  __syncthreads();
  const int n_tokens = n_tokens_s;

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kDimsPerLane];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kDimsPerLane; ++j) acc[i][j] = 0.f;
  }

  TileLoader<KVT, kQuant> tile;
  if (n_tokens > 0)
    tile.load(k_pages, v_pages, k_scales, v_scales, table_s, 0, n_tokens, h, D,
              P, page_size, tid);
  for (int t0 = 0; t0 < n_tokens; t0 += kTile) {
    tile.store(k_s, v_s, ld, D, tid);
    __syncthreads();
    if (t0 + kTile < n_tokens)
      tile.load(k_pages, v_pages, k_scales, v_scales, table_s, t0 + kTile,
                n_tokens, h, D, P, page_size, tid);

    const int tok = t0 + lane;  // tokens past n_tokens were stored as zeros
    const float* k_row = k_s + lane * ld;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp + kWarps * i;
      if (r >= rows_here) continue;  // warp-uniform
      const float* q_row = q_s + r * D;
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) s = fmaf(q_row[d], k_row[d], s);
      s *= sm_scale;
      if (perturb != 0.f) s *= 1.f + perturb;
      if (tok >= n_tokens || tok > pos_s[r]) s = -INFINITY;

      const float m_new = fmaxf(m[i], warp_max(s));
      // A row with nothing visible yet keeps m == -inf; shifting by 0
      // keeps every exp() argument finite or -inf, never NaN.
      const float m_safe = isinf(m_new) ? 0.f : m_new;
      const float alpha = expf(m[i] - m_safe);
      const float w = expf(s - m_safe);
      l[i] = l[i] * alpha + warp_sum(w);
#pragma unroll
      for (int j = 0; j < kDimsPerLane; ++j) acc[i][j] *= alpha;
#pragma unroll 4
      for (int t = 0; t < kTile; ++t) {
        const float wt = __shfl_sync(0xffffffffu, w, t);
        const float* v_row = v_s + t * ld;
#pragma unroll
        for (int j = 0; j < kDimsPerLane; ++j) {
          const int d = lane + 32 * j;
          if (d < D) acc[i][j] = fmaf(wt, v_row[d], acc[i][j]);
        }
      }
      m[i] = m_new;
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp + kWarps * i;
    if (r >= rows_here) continue;
    const int row = row0 + r;
    const int s = row / G;
    const int g = row - s * G;
    const float inv = 1.f / (l[i] > 0.f ? l[i] : 1.f);
    QT* o = out + ((size_t)(b * S + s) * Hq + h * G + g) * D;
#pragma unroll
    for (int j = 0; j < kDimsPerLane; ++j) {
      const int d = lane + 32 * j;
      if (d < D) o[d] = from_f32<QT>(acc[i][j] * inv);
    }
  }
}

template <typename QT, typename KVT, bool kQuant>
cudaError_t launch_scalar(const void* q, const void* k_pages, const void* v_pages,
                   const void* k_scales, const void* v_scales,
                   const void* positions, const void* page_table, void* out,
                   int B, int S, int Hq, int Hkv, int D, int P, int page_size,
                   int pages_per_seq, float perturb, cudaStream_t stream) {
  auto kernel = paged_attention_kernel<QT, KVT, kQuant>;
  const size_t smem = sizeof(float) * ((size_t)kRows * D + 2 * (size_t)kTile * (D + 1)) +
                      sizeof(int) * (size_t)pages_per_seq;
  static PerDevice<size_t> configured(0);
  const cudaError_t err = allow_smem(kernel, smem, configured);
  if (err != cudaSuccess) return err;
  const dim3 grid((S * (Hq / Hkv) + kRows - 1) / kRows, Hkv, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KVT*>(k_pages),
      static_cast<const KVT*>(v_pages), static_cast<const float*>(k_scales),
      static_cast<const float*>(v_scales), static_cast<const int*>(positions),
      static_cast<const int*>(page_table), static_cast<QT*>(out), S, Hq, Hkv, D,
      P, page_size, pages_per_seq, (float)(1.0 / sqrt((double)D)), perturb);
  return cudaGetLastError();
}

template <typename QT>
cudaError_t dispatch_kv(int kv_dtype, const void* q, const void* k_pages,
                        const void* v_pages, const void* k_scales,
                        const void* v_scales, const void* positions,
                        const void* page_table, void* out, int B, int S, int Hq,
                        int Hkv, int D, int P, int page_size, int pages_per_seq,
                        float perturb, cudaStream_t stream) {
  switch (kv_dtype) {
    case 0:
      return launch_scalar<QT, float, false>(q, k_pages, v_pages, nullptr, nullptr,
                                      positions, page_table, out, B, S, Hq, Hkv,
                                      D, P, page_size, pages_per_seq, perturb, stream);
    case 1:
      return launch_scalar<QT, __nv_bfloat16, false>(q, k_pages, v_pages, nullptr, nullptr,
                                              positions, page_table, out, B, S, Hq,
                                              Hkv, D, P, page_size, pages_per_seq,
                                              perturb, stream);
    case 2:
      return launch_scalar<QT, int8_t, true>(q, k_pages, v_pages, k_scales, v_scales,
                                      positions, page_table, out, B, S, Hq, Hkv,
                                      D, P, page_size, pages_per_seq, perturb, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// -- shared by the split-K and chunk routes -----------------------------------
typedef __nv_bfloat16 bf16;

constexpr float kLog2e = 1.4426950408889634f;

// 8 int8 pool elements from shared memory as f32 (the bf16 overload is
// in hopper.cuh).
__device__ __forceinline__ void load8(const int8_t* p, float (&f)[8]) {
  const uint2 r = *reinterpret_cast<const uint2*>(p);
  const uint32_t w[2] = {r.x, r.y};
#pragma unroll
  for (int i = 0; i < 8; ++i)  // byte i, sign-extended
    f[i] = static_cast<float>(static_cast<int32_t>(w[i / 4] << (24 - 8 * (i % 4))) >> 24);
}

template <typename KV>
struct PoolTraits {
  static constexpr bool kQuant = false;
};
template <>
struct PoolTraits<int8_t> {
  static constexpr bool kQuant = true;
};

struct Params {
  const bf16* q;       // [B, S, Hq, D]
  const void* k;       // pools [Hkv, P, page_size, D], bf16 or int8
  const void* v;
  const float* ks;     // [P, page_size], int8 pools only
  const float* vs;
  const int* positions;  // [B, S]
  const int* table;      // [B, pps]
  bf16* out;             // [B, S, Hq, D]
  float* part;           // split-K partials (split route)
  int* counters;         // one per (b, kv head, row group), 0 between calls
  int B, S, Hq, Hkv, P, ps_shift, pps;
  int rows;              // S * G query rows per (b, kv head)
  int groups;            // row groups of a (b, kv head) (split route)
  int n_split, split_tokens;
  float scale_log2;      // (1 + perturb) / sqrt(D) * log2(e): softmax in base 2
};

// -- split-K decode route -------------------------------------------------------
constexpr int kSplitThreads = 128;
constexpr int kSplitWarps = kSplitThreads / 32;
constexpr int kSplitTile = 32;  // tokens per stage; a warp owns 8 of them
constexpr int kSplitStages = 3;
constexpr int kMaxSplits = 64;

template <int Rows, int Dp>
__host__ __device__ constexpr int part_floats() {
  return Rows * (Dp + 2);  // m[Rows], l[Rows], acc[Rows][Dp]
}

template <typename KV, int Dp, int Rows>
__host__ __device__ constexpr size_t split_stage_bytes() {
  return 2 * (size_t)kSplitTile * Dp * sizeof(KV) + 2 * kSplitTile * sizeof(float);
}

// mma.sync helpers (the split route's products: m16n8 tiles of one warp;
// ldmatrix is in hopper.cuh).
// d (+)= A B, m16n8k16: A rows g / g + 8 and k 2t.. / 2t + 8.. in a0..a3
// (rows g + 8 are zero here: a1 = a3 = 0), B k 2t.. / 2t + 8.. of column g.
__device__ __forceinline__ void mma_k16(float (&d)[4], uint32_t a0, uint32_t a2, uint32_t b0,
                                        uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}

// d += A B, m16n8k8: A row g, k 2t.. in a0 (row g + 8 zero).
__device__ __forceinline__ void mma_k8(float (&d)[4], uint32_t a0, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(0u), "r"(b0));
}

// Byte offset of 16-byte chunk c of token row t in a [tokens][Dp] bf16
// tile, swizzled so the 8 rows an ldmatrix reads hit 8 bank groups.
template <int Dp>
__device__ __forceinline__ uint32_t row_chunk(int t, int c) {
  return t * Dp * 2 + ((c ^ (t % 8)) * 16);
}

template <typename KV, int Dp, int Rows>
__global__ void __launch_bounds__(kSplitThreads)
paged_attention_split(const __grid_constant__ Params p) {
  constexpr bool kQuant = PoolTraits<KV>::kQuant;
  constexpr int kTokBytes = Dp * (int)sizeof(KV);
  constexpr int kKVBytes = kSplitTile * kTokBytes;        // one of K, V in a stage
  constexpr int kStageBytes = (int)split_stage_bytes<KV, Dp, Rows>();
  constexpr int kWarpTok = kSplitTile / kSplitWarps;      // 8 tokens a warp, one n8 tile
  constexpr int kConvBytes = 2 * kWarpTok * Dp * 2;       // int8: a warp's K and V as bf16
  constexpr int kPart = part_floats<Rows, Dp>();
  static_assert(kWarpTok == 8, "a warp's tokens are one m16n8 tile");
  static_assert(Rows <= 8, "a block's rows fit the first 8 of an m16 tile");
  static_assert(kStageBytes * kSplitStages >= kSplitWarps * Rows * Dp * 4,
                "the warps' partials fit the ring");
  extern __shared__ __align__(128) uint8_t split_smem[];
  __shared__ uint64_t full[kSplitStages];
  __shared__ int pos_s[Rows];
  __shared__ float wm_s[kSplitWarps][Rows], wl_s[kSplitWarps][Rows];
  __shared__ int last_s;
  uint8_t* stages = split_smem;
  uint8_t* conv = stages + kSplitStages * kStageBytes;  // int8 only: per-warp bf16 K, V
  int* table_s = reinterpret_cast<int*>(conv + (kQuant ? kSplitWarps * kConvBytes : 0));

  const int split = blockIdx.x, h = blockIdx.y;
  const int b = blockIdx.z / p.groups, grp = blockIdx.z % p.groups;
  const int G = p.Hq / p.Hkv;
  const int row0 = grp * Rows;
  const int rows_here = min(Rows, p.rows - row0);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t4 = lane % 4;  // this thread's row, and its token pair / k pair
  const int page_mask = (1 << p.ps_shift) - 1;
  const int max_tokens = p.pps << p.ps_shift;
  const int t_begin = split * p.split_tokens;
  const int t_end = min(t_begin + p.split_tokens, max_tokens);
  const int cidx = (b * p.Hkv + h) * p.groups + grp;
  float* part = p.part + ((size_t)cidx * p.n_split + split) * kPart;

  if (tid < Rows) pos_s[tid] = tid < rows_here ? p.positions[b * p.S + (row0 + tid) / G] : -1;
  if (tid < kSplitStages) bar_init(full + tid, kSplitThreads);
  // q row g as the A operand of S = Q K^T (rows past the block's are 0):
  // qa[kk] holds k 16 kk + 2 t4 .., qa8[kk] k 16 kk + 8 + 2 t4 ...
  uint32_t qa[Dp / 16], qa8[Dp / 16];
  {
    const int row = row0 + g;
    const bf16* qrow =
        p.q + ((size_t)(b * p.S + row / G) * p.Hq + h * G + row % G) * Dp + 2 * t4;
#pragma unroll
    for (int kk = 0; kk < Dp / 16; ++kk) {
      qa[kk] = g < rows_here ? *reinterpret_cast<const uint32_t*>(qrow + 16 * kk) : 0u;
      qa8[kk] = g < rows_here ? *reinterpret_cast<const uint32_t*>(qrow + 16 * kk + 8) : 0u;
    }
  }
  // The split's pages, read beside q and the positions (one round trip).
  const int page0 = t_begin >> p.ps_shift;
  const int n_pages = t_end > t_begin ? ((t_end - 1) >> p.ps_shift) - page0 + 1 : 0;
  for (int i = tid; i < n_pages; i += kSplitThreads)
    table_s[i] = p.table[(size_t)b * p.pps + page0 + i];
  bar_init_fence();
  __syncthreads();
  int max_pos = -1;
#pragma unroll
  for (int r = 0; r < Rows; ++r) max_pos = max(max_pos, pos_s[r]);
  const int pos_g = g < Rows ? pos_s[g] : -1;
  // Tokens [t_begin, t_stop) of this split that some row sees.
  const int t_stop = min(t_end, max_pos + 1);
  const int n_tiles = t_stop > t_begin ? (t_stop - t_begin + kSplitTile - 1) / kSplitTile : 0;

  // Tile j of the split into stage st: K and V rows by 16-byte cp.async
  // (each token's row is contiguous in its page; bf16 lands swizzled for
  // ldmatrix, int8 as it is), the int8 scales after.
  auto load_tile = [&](int j, int st) {
    uint8_t* base = stages + st * kStageBytes;
    const uint32_t dst = smem_addr(base);
    const int t0 = t_begin + j * kSplitTile;
    constexpr int kChunks = kKVBytes / 16;
#pragma unroll
    for (int c = tid; c < kChunks; c += kSplitThreads) {
      const int t = c / (kTokBytes / 16), ch = c % (kTokBytes / 16), tok = t0 + t;
      const bool ok = tok < t_stop;
      const int phys = ok ? table_s[(tok >> p.ps_shift) - page0] : 0;
      const size_t off =
          ((((size_t)h * p.P + phys) << p.ps_shift) + (tok & page_mask)) * kTokBytes + ch * 16;
      const uint32_t at = kQuant ? c * 16 : row_chunk<Dp>(t, ch);
      cp_async16(dst + at, static_cast<const uint8_t*>(p.k) + (ok ? off : 0), ok);
      cp_async16(dst + kKVBytes + at, static_cast<const uint8_t*>(p.v) + (ok ? off : 0), ok);
    }
    if (kQuant && tid < kSplitTile / 2) {  // 4 tokens (one page: page_size >= 8) a thread
      const int which = tid / (kSplitTile / 4), t = (tid % (kSplitTile / 4)) * 4;
      const int tok = t0 + t;
      const bool ok = tok < t_stop;
      const int phys = ok ? table_s[(tok >> p.ps_shift) - page0] : 0;
      const float* src = (which ? p.vs : p.ks) + ((size_t)phys << p.ps_shift) + (tok & page_mask);
      cp_async16(dst + 2 * kKVBytes + (which * kSplitTile + t) * 4, ok ? src : p.ks, ok);
    }
    cp_async_arrive(full + st);
  };

  // Per warp: the online softmax over its tokens for row g (m uniform
  // across the quad, l per thread over its token pair until the end), and
  // O = P V as m16n8 accumulators (o[n][0..1]: row g, dims 8 n + 2 t4 ..;
  // o[n][2..3] belong to the zero rows g + 8).
  float m_w = -INFINITY, l_w = 0.f;
  float o[Dp / 8][4];
#pragma unroll
  for (int n = 0; n < Dp / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  // ldmatrix row addresses: lane i reads row i % 8 of matrix i / 8.
  const int lr = lane % 8, lm = lane / 8;

  for (int j = 0; j < kSplitStages - 1 && j < n_tiles; ++j) load_tile(j, j);
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % kSplitStages;
    if (j + kSplitStages - 1 < n_tiles)
      load_tile(j + kSplitStages - 1, (j + kSplitStages - 1) % kSplitStages);
    bar_wait(full + st, (j / kSplitStages) & 1);
    const uint8_t* base = stages + st * kStageBytes;
    const float* sc_t = reinterpret_cast<const float*>(base + 2 * kKVBytes);  // int8 scales
    uint32_t k_a, v_a;  // this warp's 8 token rows of K and V, swizzled bf16
    if constexpr (kQuant) {
      // int8 -> bf16 (exact: |x| <= 127) into the warp's own buffer.
      uint8_t* cw = conv + warp * kConvBytes;
#pragma unroll
      for (int i = lane; i < 2 * kWarpTok * (Dp / 8); i += 32) {
        const int m = i / (kWarpTok * (Dp / 8)), ii = i % (kWarpTok * (Dp / 8));
        const int t = ii / (Dp / 8), ch = ii % (Dp / 8);
        float f[8];
        load8(reinterpret_cast<const int8_t*>(base + m * kKVBytes) + (warp * kWarpTok + t) * Dp +
                  ch * 8,
              f);
        *reinterpret_cast<uint4*>(cw + m * kWarpTok * Dp * 2 + row_chunk<Dp>(t, ch)) =
            make_uint4(pack_f32(f[0], f[1]), pack_f32(f[2], f[3]), pack_f32(f[4], f[5]),
                       pack_f32(f[6], f[7]));
      }
      __syncwarp();
      k_a = smem_addr(cw);
      v_a = k_a + kWarpTok * Dp * 2;
    } else {
      k_a = smem_addr(base) + warp * kWarpTok * Dp * 2;
      v_a = k_a + kKVBytes;
    }

    // S = Q K^T for row g and the warp's 8 tokens: s[0..1] at tokens 2 t4 ...
    float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < Dp / 16; kk += 2) {
      uint32_t kb[4];  // b0, b1 of k-steps kk and kk + 1
      ldsm_x4(kb, k_a + row_chunk<Dp>(lr, 2 * kk + lm));
      mma_k16(s, qa[kk], qa8[kk], kb[0], kb[1]);
      mma_k16(s, qa[kk + 1], qa8[kk + 1], kb[2], kb[3]);
    }
    const int tt = warp * kWarpTok + 2 * t4;  // the pair's first token in the tile
    const int tok = t_begin + j * kSplitTile + tt;
    float x[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float xs = s[e] * (kQuant ? sc_t[tt + e] : 1.f) * p.scale_log2;
      x[e] = tok + e < t_stop && tok + e <= pos_g ? xs : -INFINITY;
    }
    const float mx = quad_max(fmaxf(m_w, fmaxf(x[0], x[1])));
    // Nothing visible yet: shift by 0, so every exp2 argument is -inf or finite.
    const float mu = mx == -INFINITY ? 0.f : mx;
    const float alpha = exp2f(m_w - mu);
    m_w = mx;
    const float p0 = exp2f(x[0] - mu), p1 = exp2f(x[1] - mu);
    l_w = l_w * alpha + p0 + p1;
    const uint32_t pa = kQuant ? pack_f32(p0 * sc_t[kSplitTile + tt], p1 * sc_t[kSplitTile + tt + 1])
                               : pack_f32(p0, p1);
#pragma unroll
    for (int n = 0; n < Dp / 8; n += 4) {
      uint32_t vb[4];  // B of dims 8 n .. 8 n + 31
      ldsm_x4_trans(vb, v_a + row_chunk<Dp>(lr, n + lm));
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        o[n + q][0] *= alpha;
        o[n + q][1] *= alpha;
        mma_k8(o[n + q], pa, vb[q]);
      }
    }
    __syncthreads();  // stage st (and the warp's int8 buffer) is free for the next load
  }

  // The split's partial: (m, l, acc) in base-2 units. An empty split
  // writes m = -inf, l = 0, acc = 0. A block that is its row's only split
  // writes the rows themselves instead (no partial, no merge).
  const bool alone = p.n_split == 1;
  bf16* out_b = p.out + ((size_t)b * p.S * p.Hq + h * G) * Dp;  // + (s Hq + g) Dp + d
  if (n_tiles == 0) {
    if (alone) {
      for (int e = tid; e < rows_here * Dp; e += kSplitThreads) {
        const int row = row0 + e / Dp;
        out_b[((size_t)(row / G) * p.Hq + row % G) * Dp + e % Dp] = __float2bfloat16(0.f);
      }
    } else {
      for (int e = tid; e < kPart; e += kSplitThreads) part[e] = e < Rows ? -INFINITY : 0.f;
    }
  } else {
    l_w = quad_sum(l_w);
    float* comb = reinterpret_cast<float*>(stages);  // [warps][Rows][Dp]; the ring is drained
    if (g < Rows) {
#pragma unroll
      for (int n = 0; n < Dp / 8; ++n)
        *reinterpret_cast<float2*>(comb + (warp * Rows + g) * Dp + 8 * n + 2 * t4) =
            make_float2(o[n][0], o[n][1]);
      if (t4 == 0) {
        wm_s[warp][g] = m_w;
        wl_s[warp][g] = l_w;
      }
    }
    __syncthreads();
    for (int e = tid; e < Rows * Dp; e += kSplitThreads) {
      const int r = e / Dp;
      float mx = -INFINITY;
#pragma unroll
      for (int w = 0; w < kSplitWarps; ++w) mx = fmaxf(mx, wm_s[w][r]);
      const float mu = mx == -INFINITY ? 0.f : mx;
      float a = 0.f, l = 0.f;
#pragma unroll
      for (int w = 0; w < kSplitWarps; ++w) {
        const float wt = exp2f(wm_s[w][r] - mu);
        a += wt * comb[w * Rows * Dp + e];
        l += wt * wl_s[w][r];
      }
      // Alone, a * (1 / l) as the merge ends: a row's one split gives the bits
      // it gives merged with empty tail splits. A row that sees nothing returns 0.
      if (alone) {
        if (r < rows_here) {
          const int row = row0 + r;
          out_b[((size_t)(row / G) * p.Hq + row % G) * Dp + e % Dp] =
              __float2bfloat16(a * (l > 0.f ? 1.f / l : 0.f));
        }
      } else {
        part[2 * Rows + e] = a;
        if (e % Dp == 0) {
          part[r] = mx;
          part[Rows + r] = l;
        }
      }
    }
  }
  if (alone) return;

  // The last split of this (b, kv head, row group) to finish merges them
  // all (one launch a call, no second pass), then resets the counter.
  __syncthreads();
  if (tid == 0) {
    __threadfence();  // releases the block's partial, ordered before it by the barrier
    last_s = atomicAdd(p.counters + cidx, 1) == p.n_split - 1;
  }
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  const float* parts = p.part + (size_t)cidx * p.n_split * kPart;
  // One pass over the splits per float4 of a row: their (m, l, acc)
  // loads do not depend on each other, so they are all in flight at once.
  constexpr int kVec = Dp / 4;
  for (int c = tid; c < rows_here * kVec; c += kSplitThreads) {
    const int r = c / kVec, row = row0 + r;
    float m_run = -INFINITY, l_run = 0.f;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 16
    for (int s = 0; s < p.n_split; ++s) {
      const float* ps = parts + s * kPart;
      const float m = __ldcg(ps + r), l = __ldcg(ps + Rows + r);
      const float4 a = __ldcg(reinterpret_cast<const float4*>(ps + 2 * Rows) + c);
      const float m_new = fmaxf(m_run, m);
      const float mu = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = exp2f(m_run - mu), w = exp2f(m - mu);
      l_run = fmaf(l_run, alpha, w * l);
      o.x = fmaf(o.x, alpha, w * a.x);
      o.y = fmaf(o.y, alpha, w * a.y);
      o.z = fmaf(o.z, alpha, w * a.z);
      o.w = fmaf(o.w, alpha, w * a.w);
      m_run = m_new;
    }
    const float inv = l_run > 0.f ? 1.f / l_run : 0.f;  // a row that sees nothing returns 0
    bf16* dst = p.out + ((size_t)(b * p.S + row / G) * p.Hq + h * G + row % G) * Dp + (c % kVec) * 4;
    *reinterpret_cast<uint2*>(dst) =
        make_uint2(pack_f32(o.x * inv, o.y * inv), pack_f32(o.z * inv, o.w * inv));
  }
  if (tid == 0) p.counters[cidx] = 0;
}

// -- chunk route: wgmma -----------------------------------------------------------
constexpr int kChunkWGs = 2;                  // warpgroups: each takes every other K/V tile
constexpr int kChunkThreads = 128 * kChunkWGs;
constexpr int kChunkM = 64;                   // query rows of a tile: 64 / G positions x G heads
constexpr int kChunkN = 64;                   // tokens of a K/V tile
constexpr int kChunkStages = 3;               // per warpgroup

template <typename KV, int Dp>
__host__ __device__ constexpr size_t chunk_stage_bytes() {
  // bf16: K and V swizzled for wgmma. int8: K and V raw ([tokens][Dp]) and
  // their scales, converted to bf16 buffers after they land; rounded up to
  // the swizzle's 1024-byte period.
  return ((2 * (size_t)kChunkN * Dp * sizeof(KV) + (PoolTraits<KV>::kQuant ? 2 * kChunkN * 4 : 0) +
           1023) / 1024) * 1024;
}

// Named barrier 1 + w across warpgroup w (barrier 0 is __syncthreads).
__device__ __forceinline__ void wg_bar(int w) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + w) : "memory");
}

template <typename KV, int Dp>
__global__ void __launch_bounds__(kChunkThreads, 1)
paged_attention_chunk(const __grid_constant__ Params p) {
  constexpr bool kQuant = PoolTraits<KV>::kQuant;
  constexpr int kTokBytes = Dp * (int)sizeof(KV);
  constexpr int kKVBytes = kChunkN * kTokBytes;    // one of K, V as loaded
  constexpr int kTileBytes = kChunkN * Dp * 2;     // one bf16 operand tile
  constexpr int kQBytes = kChunkM * Dp * 2;
  constexpr int kStageBytes = (int)chunk_stage_bytes<KV, Dp>();
  static_assert(kChunkStages * kStageBytes >= kChunkM * Dp * 4, "an O tile fits a ring");
  extern __shared__ uint8_t chunk_smem[];
  __shared__ uint64_t full[kChunkWGs][kChunkStages];
  __shared__ int pos_s[kChunkM];
  __shared__ float ml_s[2][kChunkM];  // warpgroup 1's m and l per row
  uint8_t* q_s = smem_base(chunk_smem);
  const int tid = threadIdx.x, wg = tid / 128, wtid = tid % 128;
  uint8_t* ring = q_s + kQBytes + wg * kChunkStages * kStageBytes;
  uint8_t* conv = q_s + kQBytes + kChunkWGs * kChunkStages * kStageBytes +
                  wg * 2 * kTileBytes;  // int8: the warpgroup's bf16 K, then V
  int* table_s = reinterpret_cast<int*>(q_s + kQBytes + kChunkWGs * kChunkStages * kStageBytes +
                                        (kQuant ? kChunkWGs * 2 * kTileBytes : 0));

  const int h = blockIdx.y, b = blockIdx.z;
  const int G = p.Hq / p.Hkv;
  const int row0 = blockIdx.x * kChunkM;
  const int lane = tid % 32, warp = wtid / 32;
  const int g = lane / 4, t4 = lane % 4;
  const int page_mask = (1 << p.ps_shift) - 1;
  const int max_tokens = p.pps << p.ps_shift;

  if (tid < kChunkM)
    pos_s[tid] = row0 + tid < p.rows ? p.positions[b * p.S + (row0 + tid) / G] : -1;
  if (tid < kChunkWGs * kChunkStages) bar_init(&full[0][0] + tid, 128);
  // Q rows (s, g) -> swizzled bf16 tile, zeros past the rows.
  for (int c = tid; c < kChunkM * (Dp / 8); c += kChunkThreads) {
    const int r = c / (Dp / 8), ch = c % (Dp / 8), row = row0 + r;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (row < p.rows)
      x = *reinterpret_cast<const uint4*>(
          p.q + ((size_t)(b * p.S + row / G) * p.Hq + h * G + row % G) * Dp + ch * 8);
    *reinterpret_cast<uint4*>(q_s + swizzled(kChunkM, r, ch)) = x;
  }
  for (int i = tid; i < p.pps; i += kChunkThreads) table_s[i] = p.table[(size_t)b * p.pps + i];
  fence_async_smem();  // Q's stores, seen by wgmma
  bar_init_fence();
  __syncthreads();
  int max_pos = -1;
  for (int r = 0; r < kChunkM; ++r) max_pos = max(max_pos, pos_s[r]);
  // K tiles past the tile's largest position are masked for every row.
  const int n_vis = min(max_pos + 1, max_tokens);
  const int n_kt = n_vis > 0 ? (n_vis + kChunkN - 1) / kChunkN : 0;
  const int n_mine = n_kt > wg ? (n_kt - wg + 1) / 2 : 0;  // tiles wg, wg + 2, ...

  // The warpgroup's i-th K/V tile into its stage st, page by page: a
  // token's row of one kv head is contiguous; bf16 lands in the swizzled
  // operand layout directly.
  auto load_tile = [&](int i, int st) {
    const uint32_t dst = smem_addr(ring + st * kStageBytes);
    const int t0 = (wg + kChunkWGs * i) * kChunkN;
    constexpr int kChunks = kKVBytes / 16;
#pragma unroll
    for (int c = wtid; c < kChunks; c += 128) {
      const int t = c / (kTokBytes / 16), part = c % (kTokBytes / 16), tok = t0 + t;
      const bool ok = tok < n_vis;
      const int phys = ok ? table_s[tok >> p.ps_shift] : 0;
      const size_t off =
          ((((size_t)h * p.P + phys) << p.ps_shift) + (tok & page_mask)) * kTokBytes + part * 16;
      const uint32_t at = kQuant ? c * 16 : swizzled(kChunkN, t, part);
      cp_async16(dst + at, static_cast<const uint8_t*>(p.k) + (ok ? off : 0), ok);
      cp_async16(dst + kKVBytes + at, static_cast<const uint8_t*>(p.v) + (ok ? off : 0), ok);
    }
    if (kQuant && wtid < kChunkN / 2) {  // 4 tokens (one page) a thread
      const int which = wtid / (kChunkN / 4), t = (wtid % (kChunkN / 4)) * 4, tok = t0 + t;
      const bool ok = tok < n_vis;
      const int phys = ok ? table_s[tok >> p.ps_shift] : 0;
      const float* src = (which ? p.vs : p.ks) + ((size_t)phys << p.ps_shift) + (tok & page_mask);
      cp_async16(dst + 2 * kKVBytes + (which * kChunkN + t) * 4, ok ? src : p.ks, ok);
    }
    cp_async_arrive(&full[wg][st]);
  };

  const int row_l = warp * 16 + g;  // this thread's rows of the tile: +0, +8
  const int pos_r[2] = {pos_s[row_l], pos_s[row_l + 8]};
  float oacc[Dp / 2];
#pragma unroll
  for (int i = 0; i < Dp / 2; ++i) oacc[i] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};
  const uint32_t q_a = smem_addr(q_s);

  for (int i = 0; i < kChunkStages - 1 && i < n_mine; ++i) load_tile(i, i);
  for (int i = 0; i < n_mine; ++i) {
    const int st = i % kChunkStages;
    if (i + kChunkStages - 1 < n_mine)
      load_tile(i + kChunkStages - 1, (i + kChunkStages - 1) % kChunkStages);
    bar_wait(&full[wg][st], (i / kChunkStages) & 1);
    uint8_t* base = ring + st * kStageBytes;
    const float* sc_s = reinterpret_cast<const float*>(base + 2 * kKVBytes);  // int8 scales
    uint32_t k_a, v_a;
    if constexpr (kQuant) {
      // int8 -> bf16 (exact: |x| <= 127), swizzled for wgmma. The scales
      // are folded into the scores and weights below.
      for (int c = wtid; c < 2 * kChunkN * (Dp / 8); c += 128) {
        const int m = c / (kChunkN * (Dp / 8)), cc = c % (kChunkN * (Dp / 8));
        const int t = cc / (Dp / 8), ch = cc % (Dp / 8);
        float f[8];
        load8(reinterpret_cast<const int8_t*>(base + m * kKVBytes) + t * Dp + ch * 8, f);
        *reinterpret_cast<uint4*>(conv + m * kTileBytes + swizzled(kChunkN, t, ch)) =
            make_uint4(pack_f32(f[0], f[1]), pack_f32(f[2], f[3]), pack_f32(f[4], f[5]),
                       pack_f32(f[6], f[7]));
      }
      fence_async_smem();
      wg_bar(wg);
      k_a = smem_addr(conv);
      v_a = k_a + kTileBytes;
    } else {
      fence_async_smem();  // cp.async's writes, seen by wgmma
      k_a = smem_addr(base);
      v_a = k_a + kKVBytes;
    }

    // S = Q K^T, both K-major.
    float sacc[kChunkN / 2];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < Dp / 16; ++kk)
      wgmma_ss<kChunkN, 0, 0>(sacc, desc_k<kChunkM>(q_a, 0, kk), desc_k<kChunkN>(k_a, 0, kk),
                              kk > 0);
    wg_commit();
    wg_wait();
    reg_fence(sacc);

    const int t0 = (wg + kChunkWGs * i) * kChunkN;
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int e = 0; e < kChunkN / 2; ++e) {
      const int r = (e >> 1) & 1;
      const int col = (e / 4) * 8 + 2 * t4 + (e & 1);
      const int tok = t0 + col;
      const float x = sacc[e] * (kQuant ? sc_s[col] : 1.f) * p.scale_log2;
      sacc[e] = tok <= pos_r[r] && tok < n_vis ? x : -INFINITY;
      mx[r] = fmaxf(mx[r], sacc[e]);
    }
    float mu[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      mu[r] = mx[r] == -INFINITY ? 0.f : mx[r];
      const float alpha = exp2f(m_r[r] - mu[r]);
      m_r[r] = mx[r];
      l_r[r] *= alpha;
#pragma unroll
      for (int e = r * 2; e < Dp / 2; e += 4) {
        oacc[e] *= alpha;
        oacc[e + 1] *= alpha;
      }
    }
#pragma unroll
    for (int e = 0; e < kChunkN / 2; ++e) {
      const int r = (e >> 1) & 1;
      sacc[e] = exp2f(sacc[e] - mu[r]);
      sum[r] += sacc[e];
      if (kQuant) sacc[e] *= sc_s[kChunkN + (e / 4) * 8 + 2 * t4 + (e & 1)];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_r[r] += quad_sum(sum[r]);

    // O += P V: P (bf16) from registers, V MN-major.
    uint32_t pa[kChunkN / 4];
#pragma unroll
    for (int e = 0; e < kChunkN / 4; ++e) pa[e] = pack_f32(sacc[2 * e], sacc[2 * e + 1]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kChunkN / 16; ++kk)
      wgmma_rs<Dp, 1>(oacc, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
                      desc_mn<kChunkN>(v_a, kk * 16, 0), 1);
    wg_commit();
    wg_wait();
    reg_fence(oacc);
    wg_bar(wg);  // stage st (and the int8 buffers) are free
  }

  // Warpgroup 1 hands its (m, l, O) to warpgroup 0 through its drained
  // ring (same rows and columns per thread); warpgroup 0 merges them.
  float* o1 = reinterpret_cast<float*>(q_s + kQBytes + kChunkStages * kStageBytes);  // [64][Dp]
  if (wg == 1) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row_l + 8 * r;
      if (t4 == 0) {
        ml_s[0][row] = m_r[r];
        ml_s[1][row] = l_r[r];
      }
#pragma unroll
      for (int c = 0; c < Dp / 8; ++c)
        *reinterpret_cast<float2*>(o1 + row * Dp + 8 * c + 2 * t4) =
            make_float2(oacc[4 * c + 2 * r], oacc[4 * c + 2 * r + 1]);
    }
  }
  __syncthreads();
  if (wg == 1) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_l + 8 * r, grow = row0 + row;
    if (grow >= p.rows) continue;
    const float m1 = ml_s[0][row], l1 = ml_s[1][row];
    const float mx = fmaxf(m_r[r], m1);
    const float mu = mx == -INFINITY ? 0.f : mx;
    const float a0 = exp2f(m_r[r] - mu), a1 = exp2f(m1 - mu);
    const float l = a0 * l_r[r] + a1 * l1;
    const float inv = l > 0.f ? 1.f / l : 0.f;  // nothing visible: 0
    bf16* o = p.out + ((size_t)(b * p.S + grow / G) * p.Hq + h * G + grow % G) * Dp + 2 * t4;
#pragma unroll
    for (int c = 0; c < Dp / 8; ++c) {
      const float2 x1 = *reinterpret_cast<const float2*>(o1 + row * Dp + 8 * c + 2 * t4);
      *reinterpret_cast<uint32_t*>(o + c * 8) =
          pack_f32((a0 * oacc[4 * c + 2 * r] + a1 * x1.x) * inv,
                   (a0 * oacc[4 * c + 2 * r + 1] + a1 * x1.y) * inv);
    }
  }
}

template <typename KV, int Dp, int Rows>
cudaError_t launch_split(const Params& p, cudaStream_t st) {
  static PerDevice<size_t> configured(48 * 1024);
  const size_t pages = (size_t)(p.split_tokens >> p.ps_shift) + 2;
  const size_t smem = kSplitStages * split_stage_bytes<KV, Dp, Rows>() +
                      (PoolTraits<KV>::kQuant ? kSplitWarps * 2 * 8 * Dp * 2 : 0) +
                      pages * sizeof(int);
  cudaError_t err = allow_smem(paged_attention_split<KV, Dp, Rows>, smem, configured);
  if (err != cudaSuccess) return err;
  // (The default carveout fitted 3 int8 blocks an SM.)
  static PerDevice<bool> carved(false);
  err = max_shared_carveout(paged_attention_split<KV, Dp, Rows>, carved);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.n_split, p.Hkv, p.B * p.groups);
  paged_attention_split<KV, Dp, Rows><<<grid, kSplitThreads, smem, st>>>(p);
  return cudaGetLastError();
}

template <typename KV, int Dp>
cudaError_t launch_chunk(const Params& p, cudaStream_t st) {
  static PerDevice<size_t> configured(48 * 1024);
  const size_t smem = 1024 + (size_t)kChunkM * Dp * 2 +
                      kChunkWGs * (kChunkStages * chunk_stage_bytes<KV, Dp>() +
                                   (PoolTraits<KV>::kQuant ? 2 * (size_t)kChunkN * Dp * 2 : 0)) +
                      (size_t)p.pps * sizeof(int);
  const cudaError_t err = allow_smem(paged_attention_chunk<KV, Dp>, smem, configured);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.rows + kChunkM - 1) / kChunkM, p.Hkv, p.B);
  paged_attention_chunk<KV, Dp><<<grid, kChunkThreads, smem, st>>>(p);
  return cudaGetLastError();
}

template <typename KV, int Dp>
cudaError_t dispatch_route(int route, const Params& p, cudaStream_t st) {
  if (route == 2) return launch_chunk<KV, Dp>(p, st);
  if (p.rows <= 4) return launch_split<KV, Dp, 4>(p, st);
  return launch_split<KV, Dp, 8>(p, st);
}

bool is_pow2_page(int page_size, int& shift) {
  for (shift = 3; shift <= 6; ++shift)
    if (page_size == (1 << shift)) return true;
  return false;
}

}  // namespace

// Dtype codes: 0 = float32, 1 = bfloat16, 2 = int8 (pools only; needs the
// scale arrays). Shapes: q/out [B, S, Hq, D]; pools [Hkv, P, page_size, D];
// scales f32 [P, page_size]; positions int32 [B, S]; page_table int32
// [B, pages_per_seq]. All contiguous and 16-byte aligned. Route: 0 scalar,
// 1 split (needs `partials`: f32 scratch of B * Hkv * groups * n_split
// parts of rows_per_block * (D + 2) floats, rows_per_block 4 when S * G
// <= 4 else 8, groups = ceil(S * G / rows_per_block); and `counters`:
// int32 [B * Hkv * groups], zero before the call and left zero after it;
// the split covers split_tokens tokens, a multiple of 32), 2 chunk.
// Returns the launch's cudaError_t.
extern "C" int skypilot_paged_attention(
    const void* q, const void* k_pages, const void* v_pages, const void* k_scales,
    const void* v_scales, const void* positions, const void* page_table, void* out,
    void* partials, void* counters, int B, int S, int Hq, int Hkv, int D, int P, int page_size,
    int pages_per_seq, int q_dtype, int kv_dtype, int route, int n_split, int split_tokens,
    float perturb, void* stream) {
  if (B <= 0 || S <= 0) return cudaSuccess;
  if (Hkv <= 0 || Hq % Hkv != 0 || D <= 0 || D > kMaxD || page_size <= 0 ||
      pages_per_seq <= 0 || B > 65535 || Hkv > 65535)
    return cudaErrorInvalidValue;
  if (kv_dtype == 2 && (k_scales == nullptr || v_scales == nullptr))
    return cudaErrorInvalidValue;
  // K/V rows move as 16-byte vectors: D * sizeof(element) % 16 == 0.
  if (D % 16 != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == 0) {
    switch (q_dtype) {
      case 0:
        return dispatch_kv<float>(kv_dtype, q, k_pages, v_pages, k_scales, v_scales, positions,
                                  page_table, out, B, S, Hq, Hkv, D, P, page_size, pages_per_seq,
                                  perturb, st);
      case 1:
        return dispatch_kv<__nv_bfloat16>(kv_dtype, q, k_pages, v_pages, k_scales, v_scales,
                                          positions, page_table, out, B, S, Hq, Hkv, D, P,
                                          page_size, pages_per_seq, perturb, st);
      default:
        return cudaErrorInvalidValue;
    }
  }
  Params p;
  if ((route != 1 && route != 2) || q_dtype != 1 || (kv_dtype != 1 && kv_dtype != 2) ||
      (D != 64 && D != 128) || !is_pow2_page(page_size, p.ps_shift))
    return cudaErrorInvalidValue;
  p.q = static_cast<const bf16*>(q);
  p.k = k_pages;
  p.v = v_pages;
  p.ks = static_cast<const float*>(k_scales);
  p.vs = static_cast<const float*>(v_scales);
  p.positions = static_cast<const int*>(positions);
  p.table = static_cast<const int*>(page_table);
  p.out = static_cast<bf16*>(out);
  p.part = static_cast<float*>(partials);
  p.counters = static_cast<int*>(counters);
  p.B = B, p.S = S, p.Hq = Hq, p.Hkv = Hkv, p.P = P, p.pps = pages_per_seq;
  p.rows = S * (Hq / Hkv);
  p.n_split = n_split, p.split_tokens = split_tokens;
  p.scale_log2 = (float)(1.0 / sqrt((double)D)) * (1.f + perturb) * kLog2e;
  if (route == 1) {
    const long tokens = (long)pages_per_seq * page_size;
    p.groups = (p.rows + (p.rows <= 4 ? 4 : 8) - 1) / (p.rows <= 4 ? 4 : 8);
    if (p.rows > 16 || partials == nullptr || counters == nullptr || n_split < 1 ||
        n_split > kMaxSplits || split_tokens <= 0 || split_tokens % kSplitTile != 0 ||
        (long)n_split * split_tokens < tokens || (long)(n_split - 1) * split_tokens >= tokens ||
        (long)B * p.groups > 65535)
      return cudaErrorInvalidValue;
  } else {
    p.groups = 1;
  }
  if (kv_dtype == 1)
    return D == 128 ? dispatch_route<bf16, 128>(route, p, st) : dispatch_route<bf16, 64>(route, p, st);
  return D == 128 ? dispatch_route<int8_t, 128>(route, p, st)
                  : dispatch_route<int8_t, 64>(route, p, st);
}

extern "C" const char* skypilot_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
