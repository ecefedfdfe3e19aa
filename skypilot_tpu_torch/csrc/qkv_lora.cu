// Multi-tenant QKV LoRA deltas for Hopper (sm_90a): one cluster-launched
// kernel per call.
//
// Replaces the TPU kernel `_qkv_lora_kernel` of
// skypilot_tpu/ops/pallas_paged.py:386 (launched through
// `fused_qkv_lora_delta`, :396).
//
// What it computes, for each batch row b with adapter id = ids[b] and each
// projection p in {q, k, v}:
//   h_p = x[b] (f32) @ a_p[id] (f32)          [S, r]
//   d_p = h_p @ b_p[id] (f32) * (1 + perturb)  [S, d_out_p], written as f32
// with no LoRA scale (the caller adds `scale * d` after casting). Factors
// are stacked per adapter slot: a_p [N, d_in, r], b_p [N, r, d_out_p]; slot
// 0 is the base model, whose factors are zeros, and is read like any other.
// An id outside [0, N) yields NaN rows rather than a read out of bounds.
//
// What bounds it on an H100: the factor bytes of the distinct adapters in
// the batch plus x and the f32 outputs (~2.6 MB at Llama-3-8B width, B=8,
// r=16, 4 distinct ids: 0.78 us at 3.35 TB/s). At decode that is less than
// the fixed cost of one launch, so a call is made of fixed costs and memory
// latency: the design keeps it to one launch, reads each distinct adapter's
// factors once, and puts every byte a block needs in flight at once. What
// is left is a chain of dependent steps a block cannot overlap: the ids'
// round trip, the round trip of its slice (whose cold bytes arrive at the
// same rate per SM whether fetched by cp.async, a bulk copy or plain
// loads), two cluster barriers and the expand. With one block an SM and
// few warps, the instructions on that chain count too: copy loops and
// k-step loops carry no division, and no stage is waited for twice.
//
// Design. Grid (8, column tiles of q|k|v, G) with clusters of 8 blocks
// along x; `G` is an upper bound, from B, S and N alone, on the number of
// (adapter, row tile) pairs (ops/lora_kernel.py `grid_tiles`), so the grid
// never depends on the ids and the host never reads them.
//  1. Grouping, on the device. Every block reads ids and computes each
//     row's adapter key (ids outside [0, N) share the key N), the distinct
//     keys in sorted order, their row counts and, in that order, their row
//     tiles: a tile holds up to 64 (b, s) rows of one adapter. B <= 32 takes
//     one warp (a row a lane: __match_any_sync, ballots and shuffles), more
//     rows every thread in O(B) each. Cluster z takes the z-th tile;
//     clusters past the real count leave at once, all blocks of a cluster
//     together, before any cluster barrier.
//  2. Shrink. Block c of the cluster takes d_in rows [c L, (c + 1) L), L =
//     ceil(d_in / 8) rounded up to 16, and computes the partial h_c = x[rows,
//     slice] @ a_p[id][slice] (f32, [m, r]). Its x rows and factor rows
//     arrive by 16-byte cp.async on one mbarrier a stage: the whole slice in
//     1-8 stages of at most 512 rows where it fits beside the rest in half
//     an SM's shared memory (at decode one stage: 16 KB of a_p at r=16),
//     else a ring of 64- (32-, 16-) row stages. Each thread's copy roles
//     and each lane's fragment offsets are computed once. bf16 x with bf16
//     factors multiply on the tensor cores (mma.sync m16n8k16 from ldmatrix
//     fragments, f32 accumulators: bf16 products are exact in f32, so this
//     computes the reference's function); any f32 operand takes f32 FMAs in
//     the same tiling. A warp owns (16-row, 16-column) tiles of h; where
//     they are fewer than the warps, the warps also split the k steps, and
//     their sums are added in a fixed order.
//  3. Reduce. After a cluster barrier each block sums the 8 partials
//     through distributed shared memory in the fixed order c = 0..7, so h
//     never touches device memory and two calls give bit-identical results.
//  4. Expand. Block c then computes its share of the projection's columns
//     (at most 512, 256 or 128 as the tile holds <= 16, <= 32 or <= 64
//     rows), out = h @ b_p[id][:, cols] in f32 FMAs (h is f32; rounding it
//     to bf16 would change the function), from a b_p slice whose loads were
//     issued right after the shrink's. q has 4x the columns of k/v at Llama
//     width; where a block's share would exceed its cap, the projection
//     takes more clusters (column tiles), each recomputing h (from L2).
//  5. A last cluster barrier keeps every block alive until its peers have
//     read its partial (its arrival, after the reduce, publishes nothing).
// Blocks use <= 80 registers and all of the SM's unified memory may be
// shared memory, so three blocks fit an SM (decode B=32 in one wave).
// The TPU kernel gathered each row's factors by scalar-prefetched index
// maps and ran the three chains in one grid step per row; here rows that
// share an adapter share its reads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <climits>

#include "hopper.cuh"

namespace {

using namespace hopper;

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = 8;       // blocks of a cluster: the d_in split
constexpr int kTileRows = 64;     // (b, s) rows of one adapter in a tile
constexpr int kMaxRank = 128;
constexpr int kMaxStages = 8;
constexpr int kMaxChunk = 512;    // d_in rows of a stage
constexpr int kPad = 8;           // elements past each shared row (bank spread)
constexpr int kMaxPairs = 4;      // (16-row, 16-column) tiles of h per warp
constexpr int kMaxSmem = 227 * 1024;
constexpr int kBSliceBytes = 32 * 1024;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

struct Params {
  const void* x;      // [B, S, d_in]
  const void* a[3];   // [N, d_in, R]
  const void* b[3];   // [N, R, d_out_p]
  float* out[3];      // [B, S, d_out_p]
  const int* ids;     // [B]
  int d_out[3];
  int col_tiles[3];   // clusters across each projection's columns
  int width[3];       // columns a block expands (a multiple of 8)
  int B, S, d_in, N, R;
  int slice;          // d_in rows per block (a multiple of 16)
  int kc;             // d_in rows per stage (a multiple of 16, <= kMaxChunk)
  int stages;         // ring slots
  int m_pad;          // tile rows the stages hold (a multiple of 16)
  int wmax;           // largest width: the b slice's row stride
  int astride;        // a stage's row stride: r rounded up to 8, plus kPad
  int stage_vec, b_vec;  // 16-byte copies possible for x and a_p / for b_p
  float scale;        // 1 + perturb
  int x_stage, stage;       // bytes of a stage's x part, of a stage
  int off_b, off_hc, off_misc;
};

// Element p of a kernel-parameter array, read with constant indices: a
// runtime index would copy the whole parameter struct to local memory.
template <typename T>
__device__ __forceinline__ T pick(const T (&v)[3], int p) {
  return p == 0 ? v[0] : (p == 1 ? v[1] : v[2]);
}

__device__ __forceinline__ float kNaN() { return __int_as_float(0x7fc00000); }

__device__ __forceinline__ int tiles_of(int rows) { return (rows + kTileRows - 1) / kTileRows; }

// A thread's share of a copy of `rows` rows of `per_row` 16-byte chunks
// (per_row <= kThreads): chunk `col` of rows row0, row0 + step, ...
// Computed once, so the copy loops carry no division.
struct Role {
  int col, row0, step;
};

__device__ __forceinline__ Role role(int per_row) {
  const int t = threadIdx.x, step = kThreads / per_row;
  if (t >= step * per_row) return Role{0, 1 << 30, step};
  return Role{t % per_row, t / per_row, step};
}

// d_in rows [r0, r0 + rows) of x (each tile row) and of a_p[id] into ring
// slot `dst` (shared address), zeros past `rows` up to kc; then this
// thread's arrival on `bar`. Every thread calls it once per stage.
template <typename XT, typename FT>
__device__ __forceinline__ void load_stage(const Params& p, uint32_t dst, uint8_t* dst_ptr,
                                           uint64_t* bar, const XT* x, const FT* a,
                                           const int* row_off, int m, int r0, int rows,
                                           const Role& xr, const Role& ar) {
  constexpr int xe = 16 / sizeof(XT), fe = 16 / sizeof(FT);
  const int xstride = p.kc + kPad;
  if (p.stage_vec) {
    const int e = xr.col * xe, n = min(max(rows - e, 0), xe);
    for (int r = xr.row0; r < m; r += xr.step) {
      const XT* src = x + (size_t)row_off[r] * p.d_in + r0 + e;
      cp_async16_n(dst + (r * xstride + e) * (int)sizeof(XT), n ? src : x, n * (int)sizeof(XT));
    }
    const uint32_t as = dst + p.x_stage;
    const FT* src = a + (size_t)r0 * p.R + ar.col * fe;
    for (int k = ar.row0; k < p.kc; k += ar.step) {
      const bool ok = k < rows;
      cp_async16(as + (k * p.astride + ar.col * fe) * (int)sizeof(FT), ok ? src + k * p.R : a,
                 ok);
    }
    cp_async_arrive(bar);
  } else {
    XT* xs = reinterpret_cast<XT*>(dst_ptr);
    FT* as = reinterpret_cast<FT*>(dst_ptr + p.x_stage);
    for (int i = threadIdx.x; i < m * p.kc; i += kThreads) {
      const int r = i / p.kc, e = i % p.kc;
      xs[r * xstride + e] = e < rows ? x[(size_t)row_off[r] * p.d_in + r0 + e] : XT(0.f);
    }
    for (int i = threadIdx.x; i < p.kc * p.R; i += kThreads) {
      const int k = i / p.R, e = i % p.R;
      as[k * p.astride + e] = k < rows ? a[(size_t)(r0 + k) * p.R + e] : FT(0.f);
    }
    bar_arrive(bar);  // release: the plain stores above are seen by the waiters
  }
}

// One k16 step of a (16-row, 16-column) h tile at byte offsets xo / ao of
// the stage's x and a parts (this lane's ldmatrix row already added): d[0..3]
// is columns 0..7 of the tile, d[4..7] columns 8..15, in the mma C layout.
__device__ __forceinline__ void mma_step(float (&d)[8], uint32_t xo, uint32_t ao) {
  uint32_t a[4], b[4];
  ldsm_x4(a, xo);
  ldsm_x4_trans(b, ao);
  mma_16816(d, a, b[0], b[1]);
  mma_16816(d + 4, a, b[2], b[3]);
}

// The same step in f32 FMAs (any f32 operand): lane (g, t) of the C layout.
template <typename XT, typename FT>
__device__ __forceinline__ void fma_step(float (&d)[8], const XT* x0, const FT* a0, int xstride,
                                         int astride) {
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const float xa = to_f32(x0[k]), xb = to_f32(x0[8 * xstride + k]);
    const FT* ak = a0 + k * astride;
    const float b0 = to_f32(ak[0]), b1 = to_f32(ak[1]), b2 = to_f32(ak[8]), b3 = to_f32(ak[9]);
    d[0] = fmaf(xa, b0, d[0]);
    d[1] = fmaf(xa, b1, d[1]);
    d[2] = fmaf(xb, b0, d[2]);
    d[3] = fmaf(xb, b1, d[3]);
    d[4] = fmaf(xa, b2, d[4]);
    d[5] = fmaf(xa, b3, d[5]);
    d[6] = fmaf(xb, b2, d[6]);
    d[7] = fmaf(xb, b3, d[7]);
  }
}

// Cluster z's share of the grouping: the rows' adapter keys (ids outside
// [0, N) share the key N), the distinct keys in sorted order and, in that
// order, each key's tiles of up to kTileRows (b, s) rows. Writes sel = (key,
// tile of the key, rows of the key), or sel[0] = -1 past the real count,
// and members = the key's batch rows in order.
//
// B <= 32: one warp, a row a lane.
__device__ __forceinline__ void group_warp(const Params& p, int z, int* sel, int* members) {
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x % 32;
  const bool in = lane < p.B;
  const int id = in ? p.ids[lane] : 0;
  const int key = in ? ((id >= 0 && id < p.N) ? id : p.N) : INT_MAX;
  const unsigned same = __match_any_sync(kAll, key) & __ballot_sync(kAll, in);
  const int pos = __popc(same & ((1u << lane) - 1u));
  const int rows = __popc(same);
  const int tiles = in && pos == 0 ? tiles_of(rows * p.S) : 0;  // on each key's first row
  int start = 0;  // tiles of the smaller keys
  for (int j = 0; j < 32; ++j) {
    const int kj = __shfl_sync(kAll, key, j), tj = __shfl_sync(kAll, tiles, j);
    start += kj < key ? tj : 0;
  }
  const unsigned hit = __ballot_sync(kAll, tiles > 0 && z >= start && z < start + tiles);
  const int src = hit ? __ffs(hit) - 1 : 0;
  const int gkey = __shfl_sync(kAll, key, src);
  const int gstart = __shfl_sync(kAll, start, src), grows = __shfl_sync(kAll, rows, src);
  if (hit && key == gkey) members[pos] = lane;
  if (lane == 0) {
    sel[0] = hit ? gkey : -1;
    sel[1] = z - gstart;
    sel[2] = grows;
  }
}

// Any B: every thread, O(B) per row; `scratch` holds 3 B ints.
__device__ __forceinline__ void group_block(const Params& p, int z, int* sel, int* members,
                                            int* scratch) {
  const int B = p.B, tid = threadIdx.x;
  int* key = scratch;
  int* cnt = key + B;
  int* pos = cnt + B;
  for (int b = tid; b < B; b += kThreads) {
    const int id = p.ids[b];
    key[b] = (id >= 0 && id < p.N) ? id : p.N;
  }
  if (tid == 0) sel[0] = -1;
  __syncthreads();
  for (int b = tid; b < B; b += kThreads) {  // rows of b's key, and those before b
    const int k = key[b];
    int n = 0, before = 0;
    for (int j = 0; j < B; ++j) {
      const bool same = key[j] == k;
      n += same;
      before += same && j < b;
    }
    cnt[b] = n;
    pos[b] = before;
  }
  __syncthreads();
  for (int b = tid; b < B; b += kThreads) {  // the first row of each key
    if (pos[b] != 0) continue;
    const int k = key[b];
    int start = 0;  // tiles of the smaller keys
    for (int j = 0; j < B; ++j)
      if (pos[j] == 0 && key[j] < k) start += tiles_of(cnt[j] * p.S);
    if (z >= start && z < start + tiles_of(cnt[b] * p.S)) {
      sel[0] = k;
      sel[1] = z - start;
      sel[2] = cnt[b];
    }
  }
  __syncthreads();
  const int gkey = sel[0];
  for (int b = tid; b < B; b += kThreads)
    if (key[b] == gkey) members[pos[b]] = b;
}

template <typename XT, typename FT>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 3)
    qkv_lora_kernel(const __grid_constant__ Params p) {
  constexpr bool kMma = sizeof(XT) == 2 && sizeof(FT) == 2;
  constexpr int xe = 16 / sizeof(XT), fe = 16 / sizeof(FT);
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int c = blockIdx.x;  // rank in the cluster: clusters are 8 x 1 x 1
  int y = blockIdx.y, proj = 0;
  if (y >= p.col_tiles[0]) {
    y -= p.col_tiles[0];
    proj = 1;
    if (y >= p.col_tiles[1]) {
      y -= p.col_tiles[1];
      proj = 2;
    }
  }
  const int d_out = pick(p.d_out, proj), width = pick(p.width, proj);
  const int col0 = (y * kCluster + c) * width;
  const int ncols = max(0, min(width, d_out - col0));
  float* out = pick(p.out, proj);
  const int B = p.B, S = p.S, R = p.R;

  int* row_off = reinterpret_cast<int*>(smem + p.off_misc);  // [kTileRows]: b * S + s
  int* sel = row_off + kTileRows;                            // key, tile, rows of the key
  uint64_t* bars = reinterpret_cast<uint64_t*>(sel + 4);     // ring stages, then the b slice

  // 1. Group the rows by adapter.
  int* members = reinterpret_cast<int*>(smem);  // at the ring's place, as is the scratch
  if (tid == 0)
    for (int s = 0; s <= p.stages; ++s) bar_init(bars + s, kThreads);
  if (B <= 32) {
    if (warp == 0) group_warp(p, blockIdx.z, sel, members);
  } else {
    group_block(p, blockIdx.z, sel, members, members + B);
  }
  if (tid == 0) bar_init_fence();
  __syncthreads();
  const int gkey = sel[0];
  if (gkey < 0) return;  // past the real count: every block of the cluster leaves here
  const int first = sel[1] * kTileRows;
  const int m = min(kTileRows, sel[2] * S - first);
  if (tid < m) row_off[tid] = members[(first + tid) / S] * S + (first + tid) % S;
  __syncthreads();

  if (gkey == p.N) {  // ids outside [0, N): NaN rows (uniform over the cluster)
    for (int i = tid; i < m * ncols; i += kThreads)
      out[(size_t)row_off[i / ncols] * d_out + col0 + i % ncols] = kNaN();
    return;
  }

  // 2. Issue every ring stage that fits, then the b slice (needed last).
  const XT* x = static_cast<const XT*>(p.x);
  const FT* a = static_cast<const FT*>(pick(p.a, proj)) + (size_t)gkey * p.d_in * R;
  const FT* bm = static_cast<const FT*>(pick(p.b, proj)) + (size_t)gkey * R * d_out + col0;
  FT* bs = reinterpret_cast<FT*>(smem + p.off_b);
  uint64_t* bbar = bars + p.stages;
  // (The roles matter only where stage_vec holds: then R % 8 == 0.)
  const Role xr = role(p.kc / xe), ar = role(max(1, R / fe));
  const int k0 = min(c * p.slice, p.d_in);
  const int kn = min(p.slice, p.d_in - k0);
  const int nk = (kn + p.kc - 1) / p.kc;
  const uint32_t ring = smem_addr(smem);
  for (int i = 0; i < min(nk, p.stages); ++i)
    load_stage<XT, FT>(p, ring + i * p.stage, smem + i * p.stage, bars + i, x, a, row_off, m,
                       k0 + i * p.kc, min(p.kc, kn - i * p.kc), xr, ar);
  if (p.b_vec) {
    const Role br = role(p.wmax / fe);
    const int e = br.col * fe;
    if (e < ncols)
      for (int j = br.row0; j < R; j += br.step)
        cp_async16(smem_addr(bs + j * p.wmax + e), bm + (size_t)j * d_out + e, true);
    cp_async_arrive(bbar);
  } else {
    for (int i = tid; i < R * ncols; i += kThreads)
      bs[(i / ncols) * p.wmax + i % ncols] = bm[(size_t)(i / ncols) * d_out + i % ncols];
    bar_arrive(bbar);
  }

  // 3. Shrink: warps own (16-row, 16-column) tiles of h and, where the
  // tiles are fewer than the warps, every kw-th k step.
  const int mt_n = (m + 15) / 16, nt_n = (R + 15) / 16, tiles = mt_n * nt_n;
  const int gw = min(kWarps, tiles), kw = kWarps / gw;
  const int gi = warp % gw, ks = warp / gw;
  const int xstride = p.kc + kPad, steps = p.kc / 16;
  float acc[kMaxPairs][8];
  uint32_t xo[kMaxPairs], ao[kMaxPairs];  // this lane's byte offsets of each tile
#pragma unroll
  for (int q = 0; q < kMaxPairs; ++q) {
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[q][e] = 0.f;
    const int t = gi + gw * q, mt = t / nt_n, nt = t % nt_n;
    if (kMma) {
      xo[q] = ((mt * 16 + lane % 16) * xstride + (lane / 16) * 8) * 2;
      ao[q] = p.x_stage + ((lane % 8 + ((lane / 8) % 2) * 8) * p.astride + nt * 16 +
                           (lane / 16) * 8) * 2;
    } else {
      xo[q] = ((mt * 16 + lane / 4) * xstride) * sizeof(XT);
      ao[q] = p.x_stage + (nt * 16 + 2 * (lane % 4)) * sizeof(FT);
    }
  }
  int gs = warp < gw * kw ? ks : 1 << 30;  // this warp's next global k step
  for (int i = 0; i < nk; ++i) {
    const int slot = i % p.stages;
    const int end = i * steps + (min(p.kc, kn - i * p.kc) + 15) / 16;
    if (gs < end) {
      bar_wait(bars + slot, (i / p.stages) & 1);
      const uint32_t base = ring + slot * p.stage;
      for (; gs < end; gs += kw) {
        const int kk = (gs - i * steps) * 16;
#pragma unroll
        for (int q = 0; q < kMaxPairs; ++q) {
          if (gi + gw * q >= tiles) break;
          if constexpr (kMma) {
            mma_step(acc[q], base + xo[q] + kk * 2, base + ao[q] + kk * p.astride * 2);
          } else {
            const uint8_t* sb = smem + slot * p.stage;
            fma_step<XT, FT>(acc[q], reinterpret_cast<const XT*>(sb + xo[q]) + kk,
                             reinterpret_cast<const FT*>(sb + ao[q]) + kk * p.astride, xstride,
                             p.astride);
          }
        }
      }
    }
    if (i + p.stages < nk) {
      __syncthreads();  // every warp is done with this slot
      load_stage<XT, FT>(p, ring + slot * p.stage, smem + slot * p.stage, bars + slot, x, a,
                         row_off, m, k0 + (i + p.stages) * p.kc,
                         min(p.kc, kn - (i + p.stages) * p.kc), xr, ar);
    }
  }
  __syncthreads();  // the ring is free
  float* hc = reinterpret_cast<float*>(smem + p.off_hc);  // this block's partial [m][R]
  float* part = kw == 1 ? hc : reinterpret_cast<float*>(smem);  // [kw][m][R]
  if (warp < gw * kw) {
    const int g = lane / 4, t = lane % 4;
#pragma unroll
    for (int q = 0; q < kMaxPairs; ++q) {
      const int tile = gi + gw * q;
      if (tile >= tiles) break;
      const int r0 = (tile / nt_n) * 16 + g, n0 = (tile % nt_n) * 16 + 2 * t;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int r = r0 + ((e / 2) % 2) * 8, n = n0 + (e / 4) * 8 + e % 2;
        if (r < m && n < R) part[(ks * m + r) * R + n] = acc[q][e];
      }
    }
  }
  if (kw > 1) {
    __syncthreads();
    for (int e = tid; e < m * R; e += kThreads) {
      float w[kWarps];  // all kw loads in flight, then the sum in order
#pragma unroll
      for (int s = 0; s < kWarps; ++s) w[s] = s < kw ? part[s * m * R + e] : 0.f;
      float v = w[0];
#pragma unroll
      for (int s = 1; s < kWarps; ++s)
        if (s < kw) v += w[s];
      hc[e] = v;
    }
  }

  // 4. Reduce the cluster's partials in the fixed order c = 0..7.
  cluster_arrive();
  cluster_wait();
  float* h = reinterpret_cast<float*>(smem);  // [m][R], at the ring's place
  const uint32_t hc_addr = smem_addr(hc);
  const int n4 = (m * R) / 4;
  for (int e = tid; e < n4; e += kThreads) {
    float4 w[kCluster];
#pragma unroll
    for (int r = 0; r < kCluster; ++r) w[r] = ld_cluster_v4(cluster_map(hc_addr + 16 * e, r));
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int r = 0; r < kCluster; ++r) {
      v.x += w[r].x;
      v.y += w[r].y;
      v.z += w[r].z;
      v.w += w[r].w;
    }
    reinterpret_cast<float4*>(h)[e] = v;
  }
  for (int e = 4 * n4 + tid; e < m * R; e += kThreads) {
    float v = 0.f;
#pragma unroll
    for (int r = 0; r < kCluster; ++r) v += ld_cluster(cluster_map(hc_addr + 4 * e, r));
    h[e] = v;
  }
  cluster_arrive_relaxed();  // this block has read its peers' partials
  __syncthreads();

  // 5. Expand: thread (rg, cg) owns columns 8 cg .. 8 cg + 7 of rows rg +
  // k * rgs, k < 4.
  const int cgs = p.wmax / 8, rgs = kThreads / cgs;  // 16 x 16 or 32 x 8
  const int cg = tid % cgs, rg = tid / cgs, lc = 8 * cg;
  const int nr = lc < ncols ? min(4, (m - rg + rgs - 1) / rgs) : 0;  // rows of this thread
  bar_wait(bbar, 0);
  if (nr > 0) {
    float o[4][8];
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int e = 0; e < 8; ++e) o[k][e] = 0.f;
    const FT* bcol = bs + lc;
    const float* hrow = h + rg * R;
    int j = 0;
    for (; j + 4 <= R; j += 4) {
      float bv[4][8];
#pragma unroll
      for (int u = 0; u < 4; ++u) load8(bcol + (j + u) * p.wmax, bv[u]);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (k < nr) {
          float hv[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) hv[u] = hrow[k * rgs * R + j + u];
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int e = 0; e < 8; ++e) o[k][e] = fmaf(hv[u], bv[u][e], o[k][e]);
        }
      }
    }
    for (; j < R; ++j) {
      float bv[8];
      load8(bcol + j * p.wmax, bv);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (k < nr) {
          const float hv = hrow[k * rgs * R + j];
#pragma unroll
          for (int e = 0; e < 8; ++e) o[k][e] = fmaf(hv, bv[e], o[k][e]);
        }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (k >= nr) break;
      float* dst = out + (size_t)row_off[rg + k * rgs] * d_out + col0 + lc;
      if (p.b_vec && lc + 8 <= ncols) {
        reinterpret_cast<float4*>(dst)[0] = make_float4(o[k][0] * p.scale, o[k][1] * p.scale,
                                                        o[k][2] * p.scale, o[k][3] * p.scale);
        reinterpret_cast<float4*>(dst)[1] = make_float4(o[k][4] * p.scale, o[k][5] * p.scale,
                                                        o[k][6] * p.scale, o[k][7] * p.scale);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (lc + e < ncols) dst[e] = o[k][e] * p.scale;
      }
    }
  }
  cluster_wait();  // no block leaves while a peer still reads its partial
}

int round_up(int v, int to) { return (v + to - 1) / to * to; }

template <typename XT, typename FT>
cudaError_t launch(Params p, int tiles, cudaStream_t stream) {
  const int sx = sizeof(XT), sf = sizeof(FT);
  const long long rows = (long long)p.B * p.S;
  const int m_max = (int)(rows < kTileRows ? rows : kTileRows);
  p.m_pad = round_up(m_max, 16);
  p.slice = round_up((p.d_in + kCluster - 1) / kCluster, 16);
  // Columns a block expands: a thread holds at most 4 rows of 8 columns,
  // and the b slice at most kBSliceBytes.
  p.wmax = 128;
  for (int w = 512; w > 128; w /= 2)
    if (m_max * w <= 4 * kThreads * 8 && p.R * w * sf <= kBSliceBytes) {
      p.wmax = w;
      break;
    }
  int col_tiles = 0;
  for (int i = 0; i < 3; ++i) {
    p.col_tiles[i] = (p.d_out[i] + kCluster * p.wmax - 1) / (kCluster * p.wmax);
    p.width[i] = round_up((p.d_out[i] + p.col_tiles[i] * kCluster - 1) /
                              (p.col_tiles[i] * kCluster), 8);
    col_tiles += p.col_tiles[i];
  }
  p.astride = round_up(p.R, 8) + kPad;
  const int b_bytes = round_up(p.R * p.wmax * sf, 16), hc_bytes = round_up(4 * m_max * p.R, 16);
  // The ring: the whole slice in flight at once (in 1..8 stages of at most
  // kMaxChunk rows) where it fits beside the rest in half an SM's shared
  // memory (two blocks an SM); else a ring of 64- (32-, 16-) row stages.
  const int budget = std::max(kMaxSmem / 2 - b_bytes - hc_bytes - 512, 8 * 1024);
  auto stage_bytes = [&](int kc) {
    return p.m_pad * (kc + kPad) * sx + round_up(kc * p.astride * sf, 16);
  };
  p.stages = 0;
  for (int nk = 1; nk <= kMaxStages && !p.stages; ++nk) {
    p.kc = round_up((p.slice + nk - 1) / nk, 16);
    if (p.kc <= kMaxChunk && nk * stage_bytes(p.kc) <= budget) p.stages = nk;
  }
  if (!p.stages) {
    for (p.kc = 64; p.kc > 16 && 2 * stage_bytes(p.kc) > budget; p.kc /= 2) {
    }
    p.stages = std::max(1, std::min(kMaxStages, budget / stage_bytes(p.kc)));
  }
  p.stage = stage_bytes(p.kc);
  p.x_stage = p.m_pad * (p.kc + kPad) * sx;
  size_t region = (size_t)p.stages * p.stage;                    // ring
  region = std::max(region, (size_t)16 * p.B);                   // grouping
  // Warp partials: kw * m * R floats, kw * (h tiles) <= 8 where kw > 1.
  region = std::max(region, (size_t)4 * std::max(8 * 256, m_max * p.R));
  p.off_b = round_up((int)region, 16);
  p.off_hc = p.off_b + b_bytes;
  p.off_misc = p.off_hc + hc_bytes;
  const size_t smem = p.off_misc + (kTileRows + 4) * 4 + (p.stages + 1) * 8;
  if (smem > (size_t)kMaxSmem || tiles > 65535 || col_tiles > 65535)
    return cudaErrorInvalidValue;
  static PerDevice<size_t> configured(0);
  static PerDevice<bool> carved(false);
  cudaError_t err = allow_smem(qkv_lora_kernel<XT, FT>, smem, configured);
  if (err == cudaSuccess) err = max_shared_carveout(qkv_lora_kernel<XT, FT>, carved);
  if (err != cudaSuccess) return err;
  const dim3 grid(kCluster, col_tiles, tiles);
  qkv_lora_kernel<XT, FT><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename XT>
cudaError_t dispatch_f(int f_dtype, const Params& p, int tiles, cudaStream_t stream) {
  switch (f_dtype) {
    case 0:
      return launch<XT, float>(p, tiles, stream);
    case 1:
      return launch<XT, bf16>(p, tiles, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

}  // namespace

// Dtype codes: 0 = float32, 1 = bfloat16 (x, and the six factor arrays,
// which share one dtype). Shapes: x [B, S, d_in]; a_p [N, d_in, R]; b_p
// [N, R, d_out_p]; ids int32 [B]; outputs f32 [B, S, d_out_p]. All
// contiguous and on one device. `tiles` is the grid's bound on (adapter,
// row tile) pairs, ceil(B S / 64) + min(B, N + 1) - 1 (ops/lora_kernel.py
// `grid_tiles`). One launch on `stream`; returns its cudaError_t, or
// cudaSuccess.
extern "C" int skypilot_qkv_lora(const void* x, const void* aq, const void* bq,
                                 const void* ak, const void* bk, const void* av,
                                 const void* bv, const void* ids, void* dq, void* dk, void* dv,
                                 int B, int S, int d_in, int N, int R, int d_q, int d_k, int d_v,
                                 int tiles, int x_dtype, int f_dtype, float perturb,
                                 void* stream) {
  if (B <= 0 || S <= 0) return cudaSuccess;
  if (d_in <= 0 || N <= 0 || R < 1 || R > kMaxRank || d_q <= 0 || d_k <= 0 || d_v <= 0 ||
      tiles <= 0 || (long long)B * S > (1 << 30))
    return cudaErrorInvalidValue;
  Params p;
  p.x = x;
  p.a[0] = aq; p.a[1] = ak; p.a[2] = av;
  p.b[0] = bq; p.b[1] = bk; p.b[2] = bv;
  p.out[0] = static_cast<float*>(dq);
  p.out[1] = static_cast<float*>(dk);
  p.out[2] = static_cast<float*>(dv);
  p.ids = static_cast<const int*>(ids);
  p.d_out[0] = d_q; p.d_out[1] = d_k; p.d_out[2] = d_v;
  p.B = B; p.S = S; p.d_in = d_in; p.N = N; p.R = R;
  p.scale = 1.f + perturb;
  p.stage_vec = aligned16(x) && d_in % 8 == 0 && R % 8 == 0;
  p.b_vec = true;
  for (int i = 0; i < 3; ++i) {
    p.stage_vec = p.stage_vec && aligned16(p.a[i]);
    p.b_vec = p.b_vec && aligned16(p.b[i]) && aligned16(p.out[i]) && p.d_out[i] % 8 == 0;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case 0:
      return dispatch_f<float>(f_dtype, p, tiles, st);
    case 1:
      return dispatch_f<bf16>(f_dtype, p, tiles, st);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* skypilot_qkv_lora_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
