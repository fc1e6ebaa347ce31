// Batched TurboSHAKE128 kernels (Keccak-p[1600,12]) for sm_90a.
//
// K1 janus_keccak_squeeze replaces janus_tpu/ops/keccak_pallas.py
//    _squeeze_kernel (via _squeeze_call): one padded single-block message
//    per report -> nb output blocks of 42 u32 words.
// K2 janus_keccak_absorb replaces keccak_pallas.py _absorb_kernel (via
//    _absorb_call): na padded message blocks per report -> the first
//    out_words (<= 42) words of the squeeze.
//    janus_keccak_absorb_select is its variant for per-row message lengths
//    (canonical shape padding; the plain version is
//    janus_tpu_torch/ops/keccak.py turboshake128_batch_select, the
//    counterpart of janus_tpu/ops/keccak_jax.py:202): each report names its
//    own final block, and its group stores the rate state after that block.
//    The tile pipeline and the warp's barriers still run over all na blocks.
//
// Layout: word-major planes (W, B) of u32, plane w = stream word w of every
// report; 64-bit lane l of the state is words (2l, 2l+1) = (lo, hi).  The
// rotation offsets are the rho schedule of janus_tpu_torch/xof.py.
//
// What bounds them on the H100: each report's sponge is a serial chain of
// permutations (9,524 at the SumVec shape), so the least time is at least
// the chain's: nb x 12 rounds x the fewest dependent ALU steps a round needs
// (5: two LOP3 levels for theta's column parity, one funnel shift, since
// rho distributes over theta's XORs, one LOP3 joining the rotated lane and
// parities, one LOP3 for chi; iota folds into the next round's LOP3s) x
// the ALU's dependent-issue latency (about 4 cycles).  That is the bound up
// to about 2,200 reports (the SumVec path's B = 1024); beyond, the
// operations (about 3.7k u32 per permutation and report) bound them.  This
// design's own chain is longer: it applies theta before rho (a funnel shift
// each) and adds a shuffle and a shared-memory exchange a round.
//
// Design.  Each report's state is spread over a group of 5 threads, column
// sliced: thread x holds lanes A[x][0..4] as ten u32 registers.
// - theta: the column parity is local; C[x-1] and rotl(C[x+1], 1) come from
//   the group's neighbours by 4 shuffles.
// - rho: per-thread funnel shifts by the lane's own amount (registers); a
//   rotation by 32 or more swaps the two words, done by where they are stored.
// - pi: an all-to-all within the group through a per-report slot of shared
//   memory (two buffers, alternating by round, so one __syncwarp a round);
//   each thread then reads its own column and the two chi needs (x+1, x+2).
// - chi and iota: LOP3s; the 12 rounds are unrolled with the round
//   constants as immediates.
// A block is one warp of 6 reports (lanes 15 and 31 mirror lanes 14 and 30
// and store nothing), so B = 1024 gives 171 blocks over the 132 SMs.  The
// slot layout (column stride 8 bytes, row stride 112 bytes, group stride
// 1064 bytes) makes chi's 64-bit loads conflict-free; the 32-bit pi stores
// are at most 2-way.  Shared memory a block: 6,384 bytes (K1), 10,416 with
// K2's load ring; 66 (K1) and 79 (K2) registers a thread, no spills.  A
// round is bound by the warp's own shuffle and shared-memory latency
// (about 235 cycles on an H100), so two warps can share an SM at no cost.
// - K1 stores each output block straight from registers: the stores do not
//   wait, so the next permutation starts at once; a warp's row segment is 24
//   bytes either way, and L2 merges neighbouring blocks' segments.
// - K2 keeps a ring of kStages input tiles (42 words x 6 reports) per block
//   in shared memory, filled by 4-byte cp.async (any B, any alignment) and
//   kept kStages - 1 blocks ahead, so block j+3 loads while block j is
//   permuted; the ragged edge copies nothing past column B.
#include <cstdint>
#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace {

constexpr int kThreads = 32;
constexpr int kGroups = 6;  // reports per block
constexpr int kRateWords = 42;
constexpr int kStages = 4;  // K2's input ring
constexpr unsigned kFull = 0xFFFFFFFFu;

// pi slot, in u32 words: lane (c, r) at 2 * (c + 14 r) + {0: lo, 1: hi};
// the second buffer at +128, the next group at +266 (= 10 mod 32).
constexpr int kRowWords = 28;
constexpr int kBufWords = 128;
constexpr int kGroupWords = 266;
constexpr int kTileWords = kRateWords * kGroups;
constexpr int kCopies = (kTileWords + kThreads - 1) / kThreads;  // per thread and tile

__constant__ unsigned char kRho[25] = {0,  1,  62, 28, 27, 36, 44, 6,  55, 20, 3,  10, 43,
                                       25, 39, 41, 45, 15, 21, 8,  18, 2,  61, 56, 14};

// What a thread of a group needs besides the state: its place and the
// per-lane shift amounts and slot offsets.
struct Thread {
  int g, x;          // group (report within the block) and column
  bool stores;       // not a mirror lane
  int src_m1, src_p1;  // lanes holding columns x-1 and x+1
  uint32_t iota;     // all ones on column 0 (it holds lane 0)
  uint32_t shift[5];
  int off_u[5], off_v[5];  // slot words of the two rotated words of lane y
  int rd[3];               // slot word of B[x+k][0], k = 0, 1, 2
};

__device__ __forceinline__ Thread thread_setup() {
  Thread t;
  const int lane = threadIdx.x;
  const int half = lane >> 4;
  const int i = min(lane & 15, 14);
  t.g = 3 * half + i / 5;
  t.x = i % 5;
  t.stores = (lane & 15) != 15;
  const int base = 16 * half + 5 * (i / 5);
  t.src_m1 = base + (t.x + 4) % 5;
  t.src_p1 = base + (t.x + 1) % 5;
  t.iota = t.x == 0 ? kFull : 0u;
#pragma unroll
  for (int y = 0; y < 5; ++y) {
    const int r = kRho[t.x + 5 * y];
    t.shift[y] = (uint32_t)(r & 31);
    // pi: lane (x, y) moves to (y, 2x + 3y).  For r < 32 the rotated pair
    // is (hi, lo) = (u, v); for r >= 32 it is (v, u).
    const int dst = 2 * (y + 14 * ((2 * t.x + 3 * y) % 5));
    t.off_u[y] = dst + (r >= 32 ? 0 : 1);
    t.off_v[y] = dst + (r >= 32 ? 1 : 0);
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) t.rd[k] = 2 * ((t.x + k) % 5);
  return t;
}

// One round on the group; `buf` is this round's buffer of the group's slot.
__device__ __forceinline__ void keccak_round(uint32_t lo[5], uint32_t hi[5], const Thread& t,
                                             uint32_t* buf, uint32_t rc_lo, uint32_t rc_hi) {
  // theta
  const uint32_t cl = lo[0] ^ lo[1] ^ lo[2] ^ lo[3] ^ lo[4];
  const uint32_t ch = hi[0] ^ hi[1] ^ hi[2] ^ hi[3] ^ hi[4];
  const uint32_t rl = __funnelshift_l(ch, cl, 1);
  const uint32_t rh = __funnelshift_l(cl, ch, 1);
  const uint32_t ml = __shfl_sync(kFull, cl, t.src_m1);
  const uint32_t mh = __shfl_sync(kFull, ch, t.src_m1);
  const uint32_t pl = __shfl_sync(kFull, rl, t.src_p1);
  const uint32_t ph = __shfl_sync(kFull, rh, t.src_p1);
  // theta applied, rho, pi
#pragma unroll
  for (int y = 0; y < 5; ++y) {
    const uint32_t l = lo[y] ^ ml ^ pl;
    const uint32_t h = hi[y] ^ mh ^ ph;
    buf[t.off_u[y]] = __funnelshift_l(l, h, t.shift[y]);
    buf[t.off_v[y]] = __funnelshift_l(h, l, t.shift[y]);
  }
  __syncwarp();
  // chi, iota
#pragma unroll
  for (int y = 0; y < 5; ++y) {
    const uint2 b0 = *reinterpret_cast<const uint2*>(buf + t.rd[0] + kRowWords * y);
    const uint2 b1 = *reinterpret_cast<const uint2*>(buf + t.rd[1] + kRowWords * y);
    const uint2 b2 = *reinterpret_cast<const uint2*>(buf + t.rd[2] + kRowWords * y);
    lo[y] = b0.x ^ (~b1.x & b2.x);
    hi[y] = b0.y ^ (~b1.y & b2.y);
  }
  lo[0] ^= rc_lo & t.iota;
  hi[0] ^= rc_hi & t.iota;
}

// Keccak-p[1600,12] on the group's state; `slot` is the group's pi slot.
__device__ __forceinline__ void keccak_p12(uint32_t lo[5], uint32_t hi[5], const Thread& t,
                                           uint32_t* slot) {
  uint32_t* b0 = slot;
  uint32_t* b1 = slot + kBufWords;
  keccak_round(lo, hi, t, b0, 0x8000808Bu, 0x00000000u);
  keccak_round(lo, hi, t, b1, 0x0000008Bu, 0x80000000u);
  keccak_round(lo, hi, t, b0, 0x00008089u, 0x80000000u);
  keccak_round(lo, hi, t, b1, 0x00008003u, 0x80000000u);
  keccak_round(lo, hi, t, b0, 0x00008002u, 0x80000000u);
  keccak_round(lo, hi, t, b1, 0x00000080u, 0x80000000u);
  keccak_round(lo, hi, t, b0, 0x0000800Au, 0x00000000u);
  keccak_round(lo, hi, t, b1, 0x8000000Au, 0x80000000u);
  keccak_round(lo, hi, t, b0, 0x80008081u, 0x80000000u);
  keccak_round(lo, hi, t, b1, 0x00008080u, 0x80000000u);
  keccak_round(lo, hi, t, b0, 0x80000001u, 0x00000000u);
  keccak_round(lo, hi, t, b1, 0x80008008u, 0x80000000u);
}

// Rate lanes x + 5y < 21 of thread x: y < 4, and y = 4 for x = 0.
__device__ __forceinline__ bool rate_lane(int x, int y) { return x + 5 * y < 21; }

// Words base + 2(x+5y) + {0, 1} of the report, where < out_words.
__device__ __forceinline__ void store_rate(const uint32_t lo[5], const uint32_t hi[5], const Thread& t,
                                           uint32_t* out, size_t B, size_t b, int base, int out_words) {
#pragma unroll
  for (int y = 0; y < 5; ++y) {
    if (!rate_lane(t.x, y)) continue;
    const int w = base + 2 * (t.x + 5 * y);
    if (w < out_words) out[(size_t)w * B + b] = lo[y];
    if (w + 1 < out_words) out[(size_t)(w + 1) * B + b] = hi[y];
  }
}

__global__ void __launch_bounds__(kThreads)
squeeze_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out, int B, int nb,
               int out_words) {
  __shared__ __align__(16) uint32_t slots[kGroups * kGroupWords];
  const Thread t = thread_setup();
  const size_t Bs = (size_t)B;
  const size_t b = (size_t)blockIdx.x * kGroups + t.g;
  const bool live = b < Bs;
  uint32_t lo[5], hi[5];
#pragma unroll
  for (int y = 0; y < 5; ++y) {
    const bool load = live && rate_lane(t.x, y);
    const size_t w = 2 * (t.x + 5 * y);
    lo[y] = load ? in[w * Bs + b] : 0u;
    hi[y] = load ? in[(w + 1) * Bs + b] : 0u;
  }
  uint32_t* slot = slots + t.g * kGroupWords;
  const bool stores = live && t.stores;
  for (int j = 0; j < nb; ++j) {
    keccak_p12(lo, hi, t, slot);
    if (stores) store_rate(lo, hi, t, out, Bs, b, kRateWords * j, out_words);
  }
}

using janus::cp_async4;
using janus::cp_async_commit;
using janus::cp_async_wait;

// A thread's share of a tile copy: tile words i = lane + 32k, at row i / 6
// and column i % 6 of the block's planes, worked out once per kernel.
struct TileCopy {
  int src[kCopies];  // row * B + col
  unsigned live;     // bit k: word k is in the tile and its column is < B
};

__device__ __forceinline__ TileCopy tile_copy_setup(int B, size_t b0) {
  TileCopy c;
  c.live = 0;
#pragma unroll
  for (int k = 0; k < kCopies; ++k) {
    const int i = threadIdx.x + kThreads * k;
    const int col = i % kGroups;
    c.src[k] = (i / kGroups) * B + col;
    if (i < kTileWords && b0 + col < (size_t)B) c.live |= 1u << k;
  }
  return c;
}

// Start copying a block's tile; `blk` is the block's first plane at column b0.
__device__ __forceinline__ void load_tile(uint32_t* tile, const uint32_t* blk, const TileCopy& c) {
#pragma unroll
  for (int k = 0; k < kCopies; ++k)
    if (c.live >> k & 1u) cp_async4(tile + threadIdx.x + kThreads * k, blk + c.src[k]);
}

// K2's body.  kSelect: `last` (B,) names each report's final block; the
// group stores its rate state after that block instead of after block na - 1.
template <bool kSelect>
__device__ __forceinline__ void absorb_body(const uint32_t* __restrict__ in, const int* __restrict__ last,
                                            uint32_t* __restrict__ out, int B, int na, int out_words) {
  __shared__ __align__(16) uint32_t slots[kGroups * kGroupWords];
  __shared__ __align__(16) uint32_t ring[kStages * kTileWords];
  const Thread t = thread_setup();
  const size_t Bs = (size_t)B;
  const size_t b0 = (size_t)blockIdx.x * kGroups;
  const size_t b = b0 + t.g;
  uint32_t lo[5] = {0, 0, 0, 0, 0}, hi[5] = {0, 0, 0, 0, 0};
  uint32_t* slot = slots + t.g * kGroupWords;
  const TileCopy copy = tile_copy_setup(B, b0);
  const size_t block_words = kRateWords * Bs;
  const bool stores = b < Bs && t.stores;
  const int final_block = kSelect && b < Bs ? last[b] : -1;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < na) load_tile(ring + s * kTileWords, in + s * block_words + b0, copy);
    cp_async_commit();
  }
  for (int j = 0; j < na; ++j) {
    // Refill the slot block j-1 used (read before the last permutation's
    // barriers) with block j + kStages - 1, then wait for block j.
    const int ahead = j + kStages - 1;
    if (ahead < na) load_tile(ring + (ahead % kStages) * kTileWords, in + ahead * block_words + b0, copy);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncwarp();
    const uint32_t* tile = ring + (j % kStages) * kTileWords;
#pragma unroll
    for (int y = 0; y < 5; ++y) {
      if (!rate_lane(t.x, y)) continue;
      const int w = 2 * (t.x + 5 * y);
      lo[y] ^= tile[w * kGroups + t.g];
      hi[y] ^= tile[(w + 1) * kGroups + t.g];
    }
    keccak_p12(lo, hi, t, slot);
    if constexpr (kSelect) {
      if (stores && j == final_block) store_rate(lo, hi, t, out, Bs, b, 0, out_words);
    }
  }
  if constexpr (!kSelect) {
    if (stores) store_rate(lo, hi, t, out, Bs, b, 0, out_words);
  }
}

__global__ void __launch_bounds__(kThreads)
absorb_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out, int B, int na, int out_words) {
  absorb_body<false>(in, nullptr, out, B, na, out_words);
}

__global__ void __launch_bounds__(kThreads)
absorb_select_kernel(const uint32_t* __restrict__ in, const int* __restrict__ last, uint32_t* __restrict__ out,
                     int B, int na, int out_words) {
  absorb_body<true>(in, last, out, B, na, out_words);
}

}  // namespace

// in: (42, B) padded single-block messages; out: (out_words, B),
// out_words <= 42 * nb.  Returns cudaGetLastError() after the launch.
extern "C" int janus_keccak_squeeze(const uint32_t* in, uint32_t* out, int B, int nb,
                                    int out_words, void* stream) {
  if (B <= 0) return 0;
  const int grid = (B + kGroups - 1) / kGroups;
  squeeze_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(in, out, B, nb, out_words);
  return (int)cudaGetLastError();
}

// in: (na * 42, B) padded message blocks; out: (out_words, B), out_words <= 42.
extern "C" int janus_keccak_absorb(const uint32_t* in, uint32_t* out, int B, int na,
                                   int out_words, void* stream) {
  if (B <= 0) return 0;
  const int grid = (B + kGroups - 1) / kGroups;
  absorb_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(in, out, B, na, out_words);
  return (int)cudaGetLastError();
}

// in: (na * 42, B) padded message blocks, each report padded at its own
// length; last: (B,) int32, report b's final block (0 <= last[b] < na);
// out: (out_words, B), the rate state after that block, out_words <= 42.
extern "C" int janus_keccak_absorb_select(const uint32_t* in, const int* last, uint32_t* out, int B,
                                          int na, int out_words, void* stream) {
  if (B <= 0) return 0;
  const int grid = (B + kGroups - 1) / kGroups;
  absorb_select_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(in, last, out, B, na, out_words);
  return (int)cudaGetLastError();
}
