// The serving grid's collective over a row of cards: sum, max, gather along
// the last axis and broadcast, each one launch a card, the cards exchanging
// their partials over NVLink through peer-mapped buffers.
//
// It replaces no Pallas kernel. On the TPU the reference serves one model
// over `stages x tensor` devices as one XLA program, and GSPMD inserts the
// all-reduces after `wo` and `w_down` (skypilot_tpu/parallel/serving.py:1-24)
// as collectives over ICI inside that program. This kernel stands for them on
// H100s: the grid's sums, the int8 pool's absmax, the head's vocab gather and
// the sampled tokens' broadcast run on the cards, inside each card's captured
// decode graph, with no host and no home card between the shards.
//
// What bounds it: latency. A decode partial is 8 x 4096 bf16 (64 KiB); its
// (T-1) x 64 KiB over NVLink at 450 GB/s a direction is ~0.15 us, under the
// two flag round trips (~1-2 us each over NVLink) that every op needs. A
// prefill chunk's partial (256 x 4096 bf16, 2 MiB) is bytes-bound (~4.7 us at
// T = 2). The design spends nothing it does not need: one launch a card, no
// grid-wide barrier (each block signals and waits for its own segment), and
// 16-byte loads of the peers' segments straight into registers.
//
// Block b of every op takes the same bytes, [b, b + 1) x kBlockBytes of each
// rank's part (an op is at most kMaxBlocks of them; the wrapper cuts a larger
// one into pieces): block b of one card then writes, and block b of its peers
// reads, the same bytes of a slot in every op, so block b's own flags guard
// them whatever ops of other sizes ran before.
//
// Protocol (a team of N ranks on C distinct cards; each card's launch acts for
// the ranks that live on it):
//   every card holds an exchange buffer of two halves x N slots and a flag
//   area: ready[b][c], done[b][c] (the epoch at which card c's block b wrote
//   its segment / finished reading this card's segment) and epoch[b] (ops
//   block b has run in this team). Block b of op e (= epoch[b] + 1):
//     1. waits until every peer has read this card's half e % 2 at epoch e - 2
//        (done >= e - 2): double buffering, so a card may run one op ahead
//        (epochs of different blocks drift apart, as an op of one block
//        advances block 0 alone; block b's bytes are touched by block b
//        only, so that is safe);
//     2. copies its local ranks' segment b into half e % 2 (where a peer reads
//        it);
//     3. releases ready = e to every peer (st.release.sys after
//        __threadfence_system: the segment is visible before the flag);
//     4. acquires ready >= e of every card it reads (ld.acquire.sys);
//     5. combines: each rank's segment, local from its input, remote from the
//        peer's half e % 2 over NVLink (ld.global.cg), sums in f32 in rank
//        order 0..N-1 and casts back (every card computes the same bits);
//     6. releases done = e to every peer, and stores epoch[b] = e.
//   The epoch lives in device memory and the kernel advances it: a graph
//   replay needs no counter from the host. A wait that outlasts timeout_ns
//   (a peer that never launched) prints which and traps, so a broken barrier
//   fails the run instead of hanging it. With every rank on one card (one
//   card named N times) the single launch reads the inputs directly and
//   spins on nothing.
//
// Every launch runs on the caller's stream, allocates nothing and
// synchronises nothing: it can be captured into a CUDA graph.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

#include "hopper.cuh"

namespace {

constexpr int kMaxRanks = 8;
constexpr int kMaxCards = 8;
constexpr int kMaxBlocks = 128;
// Bytes of a part that block b takes: [b, b + 1) x kBlockBytes, in every op.
constexpr long long kBlockBytes = 16 << 10;
// Bytes of one rank's slot in a half of a card's exchange buffer: the most an
// op takes.
constexpr long long kSlotBytes = kMaxBlocks * kBlockBytes;
constexpr int kThreads = 512;
// The flag area of a card, in 32-bit words: ready, done, epoch.
constexpr int kReadyAt = 0;
constexpr int kDoneAt = kMaxBlocks * kMaxCards;
constexpr int kEpochAt = 2 * kMaxBlocks * kMaxCards;
constexpr int kFlagWords = kEpochAt + kMaxBlocks;
// Codes the wrapper reads.
constexpr int kNoPeerAccess = -1;

enum Op { kSum = 0, kMax = 1, kGather = 2, kBroadcast = 3 };
enum Dtype { kF32 = 0, kBF16 = 1 };

struct Params {
  int op;
  int dtype;             // sum / max: kF32 or kBF16 (gather / broadcast copy bytes)
  int nranks;
  int ncards;
  int me;                // this card's index among the team's cards
  int root;              // gather / broadcast: the root rank
  int unit;              // bytes a thread copies at once: 16, 8, 4, 2 or 1
  int card_of[kMaxRanks];
  const uint8_t* in[kMaxRanks];  // local ranks' inputs (null for remote ranks)
  uint8_t* out;                  // this card's output (null: it writes none)
  uint8_t* xbuf[kMaxCards];      // each card's exchange buffer
  uint32_t* flags[kMaxCards];    // each card's flag area
  long long nbytes;              // bytes of each rank's input
  long long row_bytes;           // gather: bytes of a rank's row
  unsigned long long timeout_ns;
};

// -- flags ------------------------------------------------------------------
__device__ __forceinline__ uint32_t ld_acquire_sys(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.acquire.sys.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release_sys(uint32_t* p, uint32_t v) {
  asm volatile("st.release.sys.global.u32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// Spin until *flag has reached `want` (epochs compare modulo 2^32); trap with
// a message after timeout_ns.
__device__ void wait_flag(const Params& p, const uint32_t* flag, uint32_t want, int peer,
                          const char* what) {
  if (static_cast<int32_t>(ld_acquire_sys(flag) - want) >= 0) return;
  const uint64_t t0 = hopper::global_ns();
  while (static_cast<int32_t>(ld_acquire_sys(flag) - want) < 0) {
    if (hopper::global_ns() - t0 > p.timeout_ns) {
      printf("grid_collective: card %d of %d, block %d, waited %llu ns for card %d's %s flag to "
             "reach epoch %u (it holds %u): a peer never launched this op; trapping\n",
             p.me, p.ncards, blockIdx.x, p.timeout_ns, peer, what, want, ld_acquire_sys(flag));
      __trap();
    }
  }
}

// Whether peers read this card's segments, and whether this card reads card c's.
__device__ __forceinline__ bool peers_read_me(const Params& p) {
  if (p.op == kGather) return p.card_of[p.root] != p.me;
  if (p.op == kBroadcast) return p.card_of[p.root] == p.me;
  return true;
}

__device__ __forceinline__ bool reads_card(const Params& p, int c) {
  if (p.op == kGather) return p.card_of[p.root] == p.me;
  if (p.op == kBroadcast) return p.card_of[p.root] == c && c != p.me;
  return true;
}

// Rank r's bytes: its input on this card, else its slot in its card's half h.
__device__ __forceinline__ const uint8_t* source(const Params& p, int r, int h) {
  if (p.card_of[r] == p.me) return p.in[r];
  return p.xbuf[p.card_of[r]] + (static_cast<long long>(h) * p.nranks + r) * kSlotBytes;
}

// -- loads and element helpers ---------------------------------------------
template <typename U>
__device__ __forceinline__ U load(const uint8_t* base, long long off, bool remote) {
  const U* q = reinterpret_cast<const U*>(base + off);
  return remote ? __ldcg(q) : *q;
}

__device__ __forceinline__ float bf16_bits_to_f(uint32_t bits) {
  return __uint_as_float(bits << 16);
}

// torch.maximum: NaN wins.
__device__ __forceinline__ float max_nan(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}

template <int kDtype>
__device__ __forceinline__ float widen(uint32_t bits) {
  return kDtype == kF32 ? __uint_as_float(bits) : bf16_bits_to_f(bits);
}

template <int kDtype>
__device__ __forceinline__ uint32_t narrow(float v) {
  if (kDtype == kF32) return __float_as_uint(v);
  const __nv_bfloat16 h = __float2bfloat16_rn(v);
  return static_cast<uint32_t>(*reinterpret_cast<const unsigned short*>(&h));
}

// Combine one element of every rank: f32 sums in rank order (or the max).
template <bool kIsMax>
__device__ __forceinline__ float combine(float acc, float v, int r) {
  if (r == 0) return v;
  return kIsMax ? max_nan(acc, v) : acc + v;
}

// Sum or max of bytes [lo, hi) of every rank into out: 16-byte vectors, then
// the tail element by element.
template <int kDtype, bool kIsMax>
__device__ void reduce_range(const Params& p, int h, long long lo, long long hi) {
  constexpr int kSize = kDtype == kF32 ? 4 : 2;
  constexpr int kPer = 16 / kSize;
  const long long vec_hi = lo + ((hi - lo) / 16) * 16;
  for (long long off = lo + 16ll * threadIdx.x; off < vec_hi; off += 16ll * kThreads) {
    float acc[kPer];
    for (int r = 0; r < p.nranks; ++r) {
      const uint4 raw = load<uint4>(source(p, r, h), off, p.card_of[r] != p.me);
      const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const uint32_t bits = kSize == 4 ? w[k] : (w[k / 2] >> (16 * (k % 2))) & 0xffffu;
        acc[k] = combine<kIsMax>(acc[k], widen<kDtype>(bits), r);
      }
    }
    uint32_t o[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      o[i] = kSize == 4 ? narrow<kDtype>(acc[i])
                        : narrow<kDtype>(acc[2 * i]) | (narrow<kDtype>(acc[2 * i + 1]) << 16);
    }
    *reinterpret_cast<uint4*>(p.out + off) = make_uint4(o[0], o[1], o[2], o[3]);
  }
  for (long long off = vec_hi + kSize * threadIdx.x; off < hi; off += kSize * kThreads) {
    float acc = 0.f;
    for (int r = 0; r < p.nranks; ++r) {
      const bool remote = p.card_of[r] != p.me;
      const uint32_t bits = kSize == 4 ? load<uint32_t>(source(p, r, h), off, remote)
                                       : load<uint16_t>(source(p, r, h), off, remote);
      acc = combine<kIsMax>(acc, widen<kDtype>(bits), r);
    }
    if (kSize == 4) {
      *reinterpret_cast<uint32_t*>(p.out + off) = narrow<kDtype>(acc);
    } else {
      *reinterpret_cast<uint16_t*>(p.out + off) = static_cast<uint16_t>(narrow<kDtype>(acc));
    }
  }
}

// Bytes [lo, hi) of src to dst, at the same offsets or (`mapped`) at the
// gather's place of rank `rank`'s bytes in the output.
template <typename U>
__device__ void copy_range(const Params& p, uint8_t* dst, const uint8_t* src, bool remote,
                           long long lo, long long hi, int rank, bool mapped) {
  for (long long off = lo + static_cast<long long>(sizeof(U)) * threadIdx.x; off < hi;
       off += static_cast<long long>(sizeof(U)) * kThreads) {
    long long to = off;
    if (mapped) {
      const long long row = off / p.row_bytes;
      to = row * p.nranks * p.row_bytes + rank * p.row_bytes + (off - row * p.row_bytes);
    }
    *reinterpret_cast<U*>(dst + to) = load<U>(src, off, remote);
  }
}

__device__ void copy_any(const Params& p, uint8_t* dst, const uint8_t* src, bool remote,
                         long long lo, long long hi, int rank, bool mapped) {
  switch (p.unit) {
    case 16: copy_range<uint4>(p, dst, src, remote, lo, hi, rank, mapped); break;
    case 8: copy_range<uint2>(p, dst, src, remote, lo, hi, rank, mapped); break;
    case 4: copy_range<uint32_t>(p, dst, src, remote, lo, hi, rank, mapped); break;
    case 2: copy_range<uint16_t>(p, dst, src, remote, lo, hi, rank, mapped); break;
    default: copy_range<uint8_t>(p, dst, src, remote, lo, hi, rank, mapped); break;
  }
}

__global__ void __launch_bounds__(kThreads) collective_kernel(const __grid_constant__ Params p) {
  const int b = blockIdx.x;
  const long long lo = static_cast<long long>(b) * kBlockBytes;
  const long long hi = lo + kBlockBytes < p.nbytes ? lo + kBlockBytes : p.nbytes;
  const bool peers = p.ncards > 1;
  const int c = threadIdx.x;  // a thread per peer card signals and waits
  __shared__ uint32_t s_epoch;
  uint32_t e = 0;
  int h = 0;
  uint32_t* mine = peers ? p.flags[p.me] : nullptr;
  if (peers) {
    if (threadIdx.x == 0) s_epoch = *reinterpret_cast<volatile uint32_t*>(mine + kEpochAt + b) + 1;
    __syncthreads();
    e = s_epoch;
    h = e & 1;
    // 1. This card's half h is free once every peer read it at epoch e - 2.
    if (c < p.ncards && c != p.me) {
      wait_flag(p, mine + kDoneAt + b * kMaxCards + c, e - 2, c, "done");
    }
    __syncthreads();
    // 2. The local ranks' segment into half h, where the peers read it.
    if (peers_read_me(p) && lo < hi) {
      for (int r = 0; r < p.nranks; ++r) {
        if (p.card_of[r] != p.me) continue;
        if (p.op == kBroadcast && r != p.root) continue;
        uint8_t* slot =
            p.xbuf[p.me] + (static_cast<long long>(h) * p.nranks + r) * kSlotBytes;
        copy_any(p, slot, p.in[r], false, lo, hi, r, false);
      }
    }
    __syncthreads();
    // 3. Release: the segment is visible to every peer before its flag.
    if (c < p.ncards && c != p.me) {
      __threadfence_system();
      st_release_sys(p.flags[c] + kReadyAt + b * kMaxCards + p.me, e);
    }
    // 4. Acquire the segments of every card this one reads.
    if (c < p.ncards && c != p.me && reads_card(p, c)) {
      wait_flag(p, mine + kReadyAt + b * kMaxCards + c, e, c, "ready");
    }
    __syncthreads();
  }
  // 5. Combine.
  if (p.out != nullptr && lo < hi) {
    if (p.op == kSum || p.op == kMax) {
      if (p.dtype == kF32) {
        if (p.op == kSum) reduce_range<kF32, false>(p, h, lo, hi);
        else reduce_range<kF32, true>(p, h, lo, hi);
      } else {
        if (p.op == kSum) reduce_range<kBF16, false>(p, h, lo, hi);
        else reduce_range<kBF16, true>(p, h, lo, hi);
      }
    } else if (p.op == kGather) {
      for (int r = 0; r < p.nranks; ++r) {
        copy_any(p, p.out, source(p, r, h), p.card_of[r] != p.me, lo, hi, r, true);
      }
    } else {
      copy_any(p, p.out, source(p, p.root, h), p.card_of[p.root] != p.me, lo, hi, p.root, false);
    }
  }
  if (peers) {
    __syncthreads();
    // 6. Every peer may reuse its half h once this card is done with it.
    if (c < p.ncards && c != p.me) {
      st_release_sys(p.flags[c] + kDoneAt + b * kMaxCards + p.me, e);
    }
    if (threadIdx.x == 0) *reinterpret_cast<volatile uint32_t*>(mine + kEpochAt + b) = e;
  }
}

bool aligned(const void* ptr, int n) { return reinterpret_cast<uintptr_t>(ptr) % n == 0; }

}  // namespace

// Enable peer access between every pair of `devs`, and allocate on each card
// its exchange buffer (two halves of `nranks` slots) and its zeroed flag
// area. A pair without peer access returns kNoPeerAccess with the pair in
// bad[0], bad[1].
extern "C" int skypilot_grid_open(int ncards, const int* devs, int nranks, void** bufs,
                                  void** flags, int* bad) {
  if (ncards < 2 || ncards > kMaxCards || nranks < ncards || nranks > kMaxRanks)
    return cudaErrorInvalidValue;
  const long long buf_bytes = 2 * nranks * kSlotBytes;
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return err;
  for (int i = 0; i < ncards; ++i) bufs[i] = flags[i] = nullptr;
  for (int i = 0; i < ncards && err == cudaSuccess; ++i) {
    err = cudaSetDevice(devs[i]);
    for (int j = 0; j < ncards && err == cudaSuccess; ++j) {
      if (j == i) continue;
      int ok = 0;
      err = cudaDeviceCanAccessPeer(&ok, devs[i], devs[j]);
      if (err != cudaSuccess) break;
      if (!ok) {
        bad[0] = devs[i];
        bad[1] = devs[j];
        cudaSetDevice(prev);
        return kNoPeerAccess;
      }
      err = cudaDeviceEnablePeerAccess(devs[j], 0);
      if (err == cudaErrorPeerAccessAlreadyEnabled) {
        cudaGetLastError();  // not a failure: clear it
        err = cudaSuccess;
      }
    }
    if (err == cudaSuccess) err = cudaMalloc(&bufs[i], buf_bytes);
    if (err == cudaSuccess) err = cudaMalloc(&flags[i], kFlagWords * sizeof(uint32_t));
    if (err == cudaSuccess) err = cudaMemset(flags[i], 0, kFlagWords * sizeof(uint32_t));
    if (err == cudaSuccess) err = cudaDeviceSynchronize();
  }
  cudaSetDevice(prev);
  return err;
}

extern "C" int skypilot_grid_close(int ncards, const int* devs, void** bufs, void** flags) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return err;
  for (int i = 0; i < ncards; ++i) {
    if (cudaSetDevice(devs[i]) != cudaSuccess) continue;
    if (bufs[i] != nullptr) cudaFree(bufs[i]);
    if (flags[i] != nullptr) cudaFree(flags[i]);
  }
  cudaSetDevice(prev);
  return cudaSuccess;
}

// One card's launch of one op of at most kSlotBytes a rank (see the file's
// comment). `inputs` has one pointer a rank (null for ranks on other cards);
// `bufs` and `flags` one a card (unused with one card).
extern "C" int skypilot_grid_collective(int op, int dtype, int nranks, int ncards, int me,
                                        int root, const int* card_of,
                                        const void* const* inputs, void* out,
                                        void* const* bufs, void* const* flags,
                                        long long nbytes, long long row_bytes,
                                        unsigned long long timeout_ns, void* stream) {
  if (nbytes <= 0) return cudaSuccess;
  if (op < kSum || op > kBroadcast || nranks < 1 || nranks > kMaxRanks || ncards < 1 ||
      ncards > kMaxCards || me < 0 || me >= ncards || root < 0 || root >= nranks ||
      nbytes > kSlotBytes || (op == kGather && (row_bytes <= 0 || nbytes % row_bytes != 0)))
    return cudaErrorInvalidValue;
  if ((op == kSum || op == kMax) && dtype != kF32 && dtype != kBF16) return cudaErrorInvalidValue;
  Params p;
  p.op = op;
  p.dtype = dtype;
  p.nranks = nranks;
  p.ncards = ncards;
  p.me = me;
  p.root = root;
  p.out = static_cast<uint8_t*>(out);
  p.nbytes = nbytes;
  p.row_bytes = row_bytes;
  p.timeout_ns = timeout_ns;
  const int blocks = static_cast<int>((nbytes + kBlockBytes - 1) / kBlockBytes);
  for (int c = 0; c < kMaxCards; ++c) {
    p.xbuf[c] = c < ncards && ncards > 1 ? static_cast<uint8_t*>(bufs[c]) : nullptr;
    p.flags[c] = c < ncards && ncards > 1 ? static_cast<uint32_t*>(flags[c]) : nullptr;
    if (c < ncards && ncards > 1 && (p.xbuf[c] == nullptr || p.flags[c] == nullptr ||
                                     !aligned(p.xbuf[c], 16)))
      return cudaErrorInvalidValue;
  }
  // The widest copy every pointer and length allows.
  long long span = op == kGather ? row_bytes : nbytes;
  int unit = 16;
  for (int r = 0; r < kMaxRanks; ++r) {
    p.card_of[r] = r < nranks ? card_of[r] : 0;
    p.in[r] = r < nranks ? static_cast<const uint8_t*>(inputs[r]) : nullptr;
    if (r >= nranks) continue;
    if (card_of[r] < 0 || card_of[r] >= ncards) return cudaErrorInvalidValue;
    if (card_of[r] == me && p.in[r] == nullptr && (op != kBroadcast || r == root))
      return cudaErrorInvalidValue;
    while (unit > 1 && p.in[r] != nullptr && !aligned(p.in[r], unit)) unit /= 2;
  }
  while (unit > 1 && ((p.out != nullptr && !aligned(p.out, unit)) || span % unit != 0)) unit /= 2;
  if ((op == kSum || op == kMax) && (unit < 16 && nbytes >= 16)) {
    // The reductions' vector loads need every pointer on 16 bytes.
    for (int r = 0; r < nranks; ++r)
      if (p.in[r] != nullptr && !aligned(p.in[r], 16)) return cudaErrorInvalidValue;
    if (p.out != nullptr && !aligned(p.out, 16)) return cudaErrorInvalidValue;
  }
  p.unit = unit;
  collective_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}

extern "C" int skypilot_grid_flag_words() { return kFlagWords; }

extern "C" long long skypilot_grid_slot_bytes() { return kSlotBytes; }

extern "C" const char* skypilot_grid_error_string(int err) {
  if (err == kNoPeerAccess) return "no peer access between two cards";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
