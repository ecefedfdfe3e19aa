// Paged grouped-query attention over a paged KV pool, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_attention_kernel` of
// skypilot_tpu/ops/pallas_paged.py (launched through `_fused_call` /
// `fused_paged_attention`). Its bf16 path also stands in for the upstream
// jax.experimental.pallas.ops.tpu.paged_attention decode kernel, which
// the TPU dispatched for bf16 pools.
//
// What it computes, for query row (b, s, hq) with kv head h = hq / G:
//   out = softmax_t( q . k_t * sm_scale * (1 + perturb) ) @ v_t
// over the row's cached tokens t <= positions[b, s], where token t lives
// at physical page page_table[b, t / page_size], slot t % page_size of
// the pool [Hkv, P, page_size, D]. int8 pools are dequantized on load
// with one f32 scale per (page, slot), shared across heads. A row with
// no visible token (position < 0) returns 0, never NaN.
//
// What bounds it on an H100: the KV bytes it reads. A decode step does
// about 4 * G flops per KV byte (G = Hq / Hkv query rows share a kv head),
// far under the card's ~295 flop/byte bf16 balance, so the kernel is
// memory-bound and its roofline is the pool bytes over 3.35 TB/s.
//
// Design. One thread block per (tile of 32 query rows, kv head, batch
// row); the rows of a tile are the S x G queries that share the kv head,
// so each K/V byte loaded into shared memory serves G (decode) or up to
// 32 (chunk) rows. The block copies its own page-table row and positions
// into shared memory (the TPU kernel got them by scalar prefetch), walks
// the row's cached tokens 32 at a time in logical order (so any
// page_size works, 8 and 16 included) with 16-byte loads staged in
// registers, the next tile's loads in flight while the current one is
// computed, converts each K/V element to f32 once (dequantizing int8),
// and stops at the largest position any of its rows can see:
// tokens past it are masked for every row, so skipping them changes
// nothing. Each warp owns up to 8 query rows; lane t scores cached token
// t against a row (K rows are padded by one float so the 32 lanes hit 32
// banks), the online-softmax state (m, l) sits in registers, and each
// lane keeps D/32 of the row's f32 accumulator. The TPU kernel carried
// m/l/acc across a sequential page axis of its grid in VMEM scratch;
// blocks on Hopper run in no order, so the page walk is a loop inside
// the block instead.
//
// Later work: TMA loads into a multi-stage ring with mbarriers, wgmma for
// the chunk case, and split-K over pages (with a second reduction pass)
// so a long context fills all 132 SMs at small batch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

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
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const void* k_scales, const void* v_scales,
                   const void* positions, const void* page_table, void* out,
                   int B, int S, int Hq, int Hkv, int D, int P, int page_size,
                   int pages_per_seq, float perturb, cudaStream_t stream) {
  auto kernel = paged_attention_kernel<QT, KVT, kQuant>;
  const size_t smem = sizeof(float) * ((size_t)kRows * D + 2 * (size_t)kTile * (D + 1)) +
                      sizeof(int) * (size_t)pages_per_seq;
  // Above 48 KB a block's dynamic shared memory must be opted into, per
  // instantiation; it is raised to the largest size asked for so far.
  static size_t configured = 0;
  if (smem > configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    configured = smem;
  }
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
      return launch<QT, float, false>(q, k_pages, v_pages, nullptr, nullptr,
                                      positions, page_table, out, B, S, Hq, Hkv,
                                      D, P, page_size, pages_per_seq, perturb, stream);
    case 1:
      return launch<QT, __nv_bfloat16, false>(q, k_pages, v_pages, nullptr, nullptr,
                                              positions, page_table, out, B, S, Hq,
                                              Hkv, D, P, page_size, pages_per_seq,
                                              perturb, stream);
    case 2:
      return launch<QT, int8_t, true>(q, k_pages, v_pages, k_scales, v_scales,
                                      positions, page_table, out, B, S, Hq, Hkv,
                                      D, P, page_size, pages_per_seq, perturb, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Dtype codes: 0 = float32, 1 = bfloat16, 2 = int8 (pools only; needs the
// scale arrays). Shapes: q/out [B, S, Hq, D]; pools [Hkv, P, page_size, D];
// scales f32 [P, page_size]; positions int32 [B, S]; page_table int32
// [B, pages_per_seq]. All contiguous. Returns the launch's cudaError_t.
extern "C" int skypilot_paged_attention(
    const void* q, const void* k_pages, const void* v_pages, const void* k_scales,
    const void* v_scales, const void* positions, const void* page_table, void* out,
    int B, int S, int Hq, int Hkv, int D, int P, int page_size, int pages_per_seq,
    int q_dtype, int kv_dtype, float perturb, void* stream) {
  if (B <= 0 || S <= 0) return cudaSuccess;
  if (Hkv <= 0 || Hq % Hkv != 0 || D <= 0 || D > kMaxD || page_size <= 0 ||
      pages_per_seq <= 0 || B > 65535 || Hkv > 65535)
    return cudaErrorInvalidValue;
  if (kv_dtype == 2 && (k_scales == nullptr || v_scales == nullptr))
    return cudaErrorInvalidValue;
  // K/V rows move as 16-byte vectors: D * sizeof(element) % 16 == 0.
  if (D % 16 != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (q_dtype) {
    case 0:
      return dispatch_kv<float>(kv_dtype, q, k_pages, v_pages, k_scales, v_scales,
                                positions, page_table, out, B, S, Hq, Hkv, D, P,
                                page_size, pages_per_seq, perturb, st);
    case 1:
      return dispatch_kv<__nv_bfloat16>(kv_dtype, q, k_pages, v_pages, k_scales,
                                        v_scales, positions, page_table, out, B, S,
                                        Hq, Hkv, D, P, page_size, pages_per_seq,
                                        perturb, st);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* skypilot_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
