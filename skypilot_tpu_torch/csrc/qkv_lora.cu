// Multi-tenant QKV LoRA deltas for Hopper (sm_90a).
//
// Replaces the TPU kernel `_qkv_lora_kernel` of
// skypilot_tpu/ops/pallas_paged.py (launched through
// `fused_qkv_lora_delta`).
//
// What it computes, for each batch row b with adapter id = ids[b] and each
// projection p in {q, k, v}:
//   h_p = x[b] (f32) @ a_p[id] (f32)          [S, r]
//   d_p = h_p @ b_p[id] (f32) * (1 + perturb)  [S, d_out_p], written as f32
// with no LoRA scale (the caller adds `scale * d` after casting). Factors
// are stacked per adapter slot: a_p [N, d_in, r], b_p [N, r, d_out_p]; id 0
// is the base model, whose factors are zeros, and is read like any other.
// An id outside [0, N) yields NaN rows rather than a read out of bounds.
//
// What bounds it on an H100: the factor bytes of the distinct adapters in
// the batch plus x and the f32 outputs. At decode (S = 1) it does about
// 2 flops per factor byte read, far under the card's balance point, so it
// is memory-bound; its roofline is those bytes over 3.35 TB/s, which at
// Llama-3-8B width is under a microsecond, below the cost of a launch.
//
// Design: two launches under one C entry point, no atomics, no library.
//  - shrink: grid (d_in split, S tile, batch row x projection). A block
//    stages its x tile [8 rows, 512 of d_in] in shared memory as f32 and
//    walks its 512 rows of a_p[id]: thread (kl, r) reads a[k, r] for its
//    rank column r (consecutive threads on consecutive addresses) and every
//    k = kl + j * (256 / rank_pow2), keeping 8 f32 sums in registers; the
//    k lanes are then reduced through shared memory. Each split of d_in
//    writes its own partial h to a scratch buffer, so a decode step
//    (B = 8) still fills 192 blocks instead of 24.
//  - expand: grid (d_out tile of 256 columns across q|k|v, S tile, batch
//    row). A block sums the d_in partials of its h tile [16 rows, r] into
//    shared memory; each thread owns one output column, reads b_p[id][r, o]
//    row by row (coalesced) and writes 16 f32 outputs.
// The TPU kernel gathered each row's factors by scalar-prefetched index
// maps and ran the three chains in one grid step per row; here the block
// reads ids[b] itself and the three projections share each launch.
//
// Later work: a segmented GEMM grouped by adapter, with wgmma and TMA
// loads, so that rows that share an adapter read its factors once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kShrinkRows = 8;     // sequence rows per shrink block
constexpr int kSplitK = 512;       // d_in elements per shrink block
constexpr int kExpandRows = 16;    // sequence rows per expand block
constexpr int kExpandCols = kThreads;
constexpr int kMaxRank = 128;

__device__ __forceinline__ float kNaN() { return __int_as_float(0x7fc00000); }
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

struct Factors {
  const void* a[3];  // [N, d_in, R] each
  const void* b[3];  // [N, R, d_out_p]
  float* out[3];     // [B, S, d_out_p]
  int d_out[3];
  int tiles[3];      // column tiles of each projection in the expand grid
};

// Element p of a kernel-parameter array, read with constant indices: a
// runtime index would copy the whole parameter struct to local memory.
template <typename T>
__device__ __forceinline__ T pick(const T (&v)[3], int p) {
  return p == 0 ? v[0] : (p == 1 ? v[1] : v[2]);
}

// h layout: [splits, 3, B, S, R] f32.
__device__ __forceinline__ size_t h_index(int split, int p, int b, int s, int r,
                                          int B, int S, int R) {
  return ((((size_t)split * 3 + p) * B + b) * S + s) * R + r;
}

template <typename XT, typename FT>
__global__ void __launch_bounds__(kThreads)
    shrink_kernel(const XT* __restrict__ x, Factors f, const int* __restrict__ ids,
                  float* __restrict__ h, int B, int S, int d_in, int N, int R,
                  int rank_pow2) {
  __shared__ float xs[kShrinkRows][kSplitK];
  __shared__ float red[kThreads * kShrinkRows];
  const int split = blockIdx.x;
  const int s0 = blockIdx.y * kShrinkRows;
  const int b = blockIdx.z / 3;
  const int p = blockIdx.z % 3;
  const int tid = threadIdx.x;
  const int rows = min(kShrinkRows, S - s0);
  const int k0 = split * kSplitK;
  const int kn = min(kSplitK, d_in - k0);
  const int id = ids[b];
  if (id < 0 || id >= N) {  // uniform over the block: no barrier is skipped
    for (int o = tid; o < rows * R; o += kThreads)
      h[h_index(split, p, b, s0 + o / R, o % R, B, S, R)] = kNaN();
    return;
  }
  for (int i = tid; i < kShrinkRows * kSplitK; i += kThreads) {
    const int s = i / kSplitK, k = i % kSplitK;
    xs[s][k] = (s < rows && k < kn)
                   ? to_f32(x[((size_t)b * S + s0 + s) * d_in + k0 + k])
                   : 0.f;
  }
  __syncthreads();

  const int r = tid % rank_pow2;
  const int kl = tid / rank_pow2;
  const int lanes = kThreads / rank_pow2;
  float acc[kShrinkRows];
#pragma unroll
  for (int s = 0; s < kShrinkRows; ++s) acc[s] = 0.f;
  if (r < R) {
    const FT* a = static_cast<const FT*>(pick(f.a, p)) + ((size_t)id * d_in + k0) * R + r;
#pragma unroll 4
    for (int k = kl; k < kn; k += lanes) {
      const float av = to_f32(a[(size_t)k * R]);
#pragma unroll
      for (int s = 0; s < kShrinkRows; ++s) acc[s] = fmaf(xs[s][k], av, acc[s]);
    }
  }
#pragma unroll
  for (int s = 0; s < kShrinkRows; ++s)
    red[(kl * kShrinkRows + s) * rank_pow2 + r] = acc[s];
  __syncthreads();
  for (int o = tid; o < rows * rank_pow2; o += kThreads) {
    const int s = o / rank_pow2, rr = o % rank_pow2;
    if (rr >= R) continue;
    float v = 0.f;
    for (int l = 0; l < lanes; ++l) v += red[(l * kShrinkRows + s) * rank_pow2 + rr];
    h[h_index(split, p, b, s0 + s, rr, B, S, R)] = v;
  }
}

template <typename FT>
__global__ void __launch_bounds__(kThreads)
    expand_kernel(const float* __restrict__ h, Factors f, const int* __restrict__ ids,
                  int B, int S, int N, int R, int splits, float perturb) {
  __shared__ float hs[kExpandRows][kMaxRank];
  int tile = blockIdx.x;
  int p = 0;
  if (tile >= f.tiles[0]) {
    tile -= f.tiles[0];
    p = 1;
    if (tile >= f.tiles[1]) {
      tile -= f.tiles[1];
      p = 2;
    }
  }
  const int s0 = blockIdx.y * kExpandRows;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int rows = min(kExpandRows, S - s0);
  const int d_out = pick(f.d_out, p);
  const int o = tile * kExpandCols + tid;
  float* out = pick(f.out, p);
  const int id = ids[b];
  if (id < 0 || id >= N) {
    if (o < d_out)
      for (int s = 0; s < rows; ++s) out[((size_t)b * S + s0 + s) * d_out + o] = kNaN();
    return;
  }
  for (int i = tid; i < rows * R; i += kThreads) {
    const int s = i / R, r = i % R;
    float v = 0.f;
    for (int k = 0; k < splits; ++k) v += h[h_index(k, p, b, s0 + s, r, B, S, R)];
    hs[s][r] = v;
  }
  __syncthreads();
  if (o >= d_out) return;
  const FT* bm = static_cast<const FT*>(pick(f.b, p)) + (size_t)id * R * d_out + o;
  float acc[kExpandRows];
#pragma unroll
  for (int s = 0; s < kExpandRows; ++s) acc[s] = 0.f;
#pragma unroll 4
  for (int r = 0; r < R; ++r) {
    const float bv = to_f32(bm[(size_t)r * d_out]);
#pragma unroll
    for (int s = 0; s < kExpandRows; ++s) acc[s] = fmaf(hs[s][r], bv, acc[s]);
  }
  const float scale = 1.f + perturb;
#pragma unroll
  for (int s = 0; s < kExpandRows; ++s)
    if (s < rows) out[((size_t)b * S + s0 + s) * d_out + o] = acc[s] * scale;
}

int splits_for(int d_in) { return (d_in + kSplitK - 1) / kSplitK; }

template <typename XT, typename FT>
cudaError_t launch(const void* x, Factors f, const int* ids, float* h, int B, int S,
                   int d_in, int N, int R, float perturb, cudaStream_t stream) {
  int rank_pow2 = 1;
  while (rank_pow2 < R) rank_pow2 <<= 1;
  const int splits = splits_for(d_in);
  const dim3 g1(splits, (S + kShrinkRows - 1) / kShrinkRows, B * 3);
  shrink_kernel<XT, FT><<<g1, kThreads, 0, stream>>>(static_cast<const XT*>(x), f, ids,
                                                      h, B, S, d_in, N, R, rank_pow2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 g2(f.tiles[0] + f.tiles[1] + f.tiles[2],
                (S + kExpandRows - 1) / kExpandRows, B);
  expand_kernel<FT><<<g2, kThreads, 0, stream>>>(h, f, ids, B, S, N, R, splits, perturb);
  return cudaGetLastError();
}

template <typename XT>
cudaError_t dispatch_f(int f_dtype, const void* x, Factors f, const int* ids, float* h,
                       int B, int S, int d_in, int N, int R, float perturb,
                       cudaStream_t stream) {
  switch (f_dtype) {
    case 0:
      return launch<XT, float>(x, f, ids, h, B, S, d_in, N, R, perturb, stream);
    case 1:
      return launch<XT, __nv_bfloat16>(x, f, ids, h, B, S, d_in, N, R, perturb, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Floats of f32 scratch the caller allocates for `h` (the per-split
// partial products [splits, 3, B, S, R]).
extern "C" long long skypilot_qkv_lora_scratch_floats(int B, int S, int d_in, int R) {
  return (long long)splits_for(d_in) * 3 * B * S * R;
}

// Dtype codes: 0 = float32, 1 = bfloat16 (x and the six factor arrays;
// the factors share one dtype). Shapes: x [B, S, d_in]; a_p [N, d_in, R];
// b_p [N, R, d_out_p]; ids int32 [B]; outputs f32 [B, S, d_out_p]; h f32
// scratch of skypilot_qkv_lora_scratch_floats(...) floats. All contiguous
// and on one device. Two launches on `stream`; returns the first failing
// launch's cudaError_t, or cudaSuccess.
extern "C" int skypilot_qkv_lora(const void* x, const void* aq, const void* bq,
                                 const void* ak, const void* bk, const void* av,
                                 const void* bv, const void* ids, void* h, void* dq,
                                 void* dk, void* dv, int B, int S, int d_in, int N, int R,
                                 int d_q, int d_k, int d_v, int x_dtype, int f_dtype,
                                 float perturb, void* stream) {
  if (B <= 0 || S <= 0) return cudaSuccess;
  if (d_in <= 0 || N <= 0 || R < 1 || R > kMaxRank || d_q <= 0 || d_k <= 0 ||
      d_v <= 0 || B > 65535 / 3 || (S + kShrinkRows - 1) / kShrinkRows > 65535)
    return cudaErrorInvalidValue;
  Factors f;
  f.a[0] = aq; f.a[1] = ak; f.a[2] = av;
  f.b[0] = bq; f.b[1] = bk; f.b[2] = bv;
  f.out[0] = static_cast<float*>(dq);
  f.out[1] = static_cast<float*>(dk);
  f.out[2] = static_cast<float*>(dv);
  f.d_out[0] = d_q; f.d_out[1] = d_k; f.d_out[2] = d_v;
  for (int p = 0; p < 3; ++p) f.tiles[p] = (f.d_out[p] + kExpandCols - 1) / kExpandCols;
  const int* id = static_cast<const int*>(ids);
  float* hp = static_cast<float*>(h);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case 0:
      return dispatch_f<float>(f_dtype, x, f, id, hp, B, S, d_in, N, R, perturb, st);
    case 1:
      return dispatch_f<__nv_bfloat16>(f_dtype, x, f, id, hp, B, S, d_in, N, R, perturb, st);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* skypilot_qkv_lora_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
