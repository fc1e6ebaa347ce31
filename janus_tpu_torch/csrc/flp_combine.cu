// Planar combine-decide (K4) for sm_90a.
//
// Replaces janus_tpu/ops/flp_pallas.py _combine_decide_kernel (via
// combine_decide_planar).  For every report b, the ParallelSum(Mul) gadget
// over the combined wires:
//
//   g = sum_{u < chunk} mont_mul(he[u] + pe[u], ho[u] + po[u])
//
// he/ho are our even/odd wire planes (chunk, 4, B) of u32 words.  The peer's
// verifier is read where it arrives, as rows (B, VER, 4) of int64 words: its
// zipped wires are elements 1 + 2u (even) and 2 + 2u (odd), so one report's
// pair for column u is 8 int64 words, 64 contiguous bytes, of which the low
// 32 bits (little-endian, word stride 2) are the limbs.  The JAX package
// transposes those rows into planes first, for Mosaic's (8, 128) tiling; on
// this card that pass moves more bytes than the kernel.  g (4, B) is
// canonical and scaled by R^-1 (two canonical operands); the caller
// compares it with gpoly(t) * R^-1.  The Pallas kernel's 8-sublane partials
// are TPU tiling: this kernel folds everything and writes only g.
//
// What bounds it on the H100: bytes.  Per report it reads 8 * chunk u32
// words of he/ho and 8 * chunk int64 words of the peer's wires (124 MB at
// chunk 316 and B = 4096, 0.037 ms at 3.35 TB/s) for one Montgomery product
// and three additions a column (a few microseconds of the integer pipes).
// To stream near that rate every SM needs tens of KB of loads in flight,
// from many warps that wait on nothing but their loads:
// - A warp is one column slice of 32 consecutive reports, a lane a report.
//   Our wires arrive as 16-byte loads: lane q of each group of 4 lanes loads
//   limb plane q of the group's 4 reports (8 lanes of a limb read 128
//   contiguous bytes), and 3 shuffles in the group hand each lane its own
//   report's limbs.  A lane reads its report's peer pair as four 16-byte
//   loads, two whole 32-byte sectors.  Few registers, no spills, and no
//   shared memory in the loop.  (Four reports a lane, each held across the
//   column, needed more than the 64 registers 32 warps allow, spilled, and
//   ran slower at 32 warps than at 16.)
// - A block is 32 warps (1024 threads) over 32 column slices of 32 reports,
//   one block an SM: 128 blocks at B = 4096.  The warps fold their sums in
//   shared memory and the first writes g.  One launch, no atomics, no
//   scratch.  (A batch of a few hundred reports leaves most SMs idle; no
//   path runs K4 at such a batch, so the launch does not split the columns
//   further for it.)
// - Where B is not a multiple of 4 or a base is not 16-byte aligned, a lane
//   reads its own words one at a time.
// Modular addition is exact, so the order of the sums does not change the
// canonical result.
#include <cstdint>
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

using janus::F128;

constexpr int kWarps = 32;     // column slices a block, one warp each
constexpr int kThreads = 32 * kWarps;

__device__ __forceinline__ uint32_t pick(uint32_t w0, uint32_t w1, uint32_t w2, uint32_t w3, int i) {
  return i == 0 ? w0 : i == 1 ? w1 : i == 2 ? w2 : w3;
}

// Our wires of one column for report b (zero past the batch); plane points
// at the column's limb-0 row.  Every lane of the warp must call it.
template <bool kVec>
__device__ __forceinline__ F128 load_ours(const uint32_t* __restrict__ plane, int B, int b) {
  if (kVec) {
    const int q = b & 3;
    const int b0 = b - q;
    uint4 h = make_uint4(0, 0, 0, 0);
    // Read once: evict-first, so the caches keep the peer rows' sectors.
    if (b0 < B) h = __ldcs(reinterpret_cast<const uint4*>(plane + (size_t)q * B + b0));
    // h is limb q of reports b0 .. b0 + 3; lane q ^ i of the group holds
    // limb q ^ i, and sends this lane its report's word of it.
    const uint32_t r1 = __shfl_xor_sync(0xFFFFFFFFu, pick(h.x, h.y, h.z, h.w, q ^ 1), 1);
    const uint32_t r2 = __shfl_xor_sync(0xFFFFFFFFu, pick(h.x, h.y, h.z, h.w, q ^ 2), 2);
    const uint32_t r3 = __shfl_xor_sync(0xFFFFFFFFu, pick(h.x, h.y, h.z, h.w, q ^ 3), 3);
    const uint32_t own = pick(h.x, h.y, h.z, h.w, q);
    const uint32_t l0 = pick(own, r1, r2, r3, q), l1 = pick(own, r1, r2, r3, q ^ 1);
    const uint32_t l2 = pick(own, r1, r2, r3, q ^ 2), l3 = pick(own, r1, r2, r3, q ^ 3);
    return F128{(uint64_t)l0 | ((uint64_t)l1 << 32), (uint64_t)l2 | ((uint64_t)l3 << 32)};
  }
  return b < B ? janus::f128_load(plane + b, (size_t)B) : F128{0, 0};
}

// The peer's even and odd wires of one report and column: the 8 int64 words
// at p, whose low 32 bits are the limbs.
template <bool kVec>
__device__ __forceinline__ void load_peer(const uint64_t* __restrict__ p, F128& e, F128& o) {
  if (kVec) {
    const uint4* q = reinterpret_cast<const uint4*>(p);
    const uint4 a = __ldg(q), b = __ldg(q + 1), c = __ldg(q + 2), d = __ldg(q + 3);
    e = F128{(uint64_t)a.x | ((uint64_t)a.z << 32), (uint64_t)b.x | ((uint64_t)b.z << 32)};
    o = F128{(uint64_t)c.x | ((uint64_t)c.z << 32), (uint64_t)d.x | ((uint64_t)d.z << 32)};
  } else {
    const unsigned long long* q = reinterpret_cast<const unsigned long long*>(p);
    uint64_t w[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) w[k] = __ldg(q + k) & 0xFFFFFFFFull;
    e = F128{w[0] | (w[1] << 32), w[2] | (w[3] << 32)};
    o = F128{w[4] | (w[5] << 32), w[6] | (w[7] << 32)};
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
combine_kernel(const uint32_t* __restrict__ he, const uint32_t* __restrict__ ho,
               const uint64_t* __restrict__ pv, uint32_t* __restrict__ g, int B, int chunk,
               int ver) {
  __shared__ F128 red[kWarps][32];
  const int lane = threadIdx.x;
  const int s = threadIdx.y;
  const int b = blockIdx.x * 32 + lane;
  F128 acc = {0, 0};
  // u is the same across the warp, so every lane reaches the shuffles.
  for (int u = s; u < chunk; u += kWarps) {
    const F128 xe = load_ours<kVec>(he + (size_t)u * 4 * B, B, b);
    const F128 xo = load_ours<kVec>(ho + (size_t)u * 4 * B, B, b);
    if (b < B) {
      F128 pe, po;
      load_peer<kVec>(pv + ((size_t)b * ver + 1 + 2 * u) * 4, pe, po);
      acc = janus::f128_add(acc, janus::f128_mont_mul(janus::f128_add(xe, pe), janus::f128_add(xo, po)));
    }
  }
  // Fold the block's warps in shared memory, halving each round.
  red[s][lane] = acc;
  __syncthreads();
#pragma unroll
  for (int h = kWarps / 2; h > 0; h /= 2) {
    if (s < h) {
      acc = janus::f128_add(acc, red[s + h][lane]);
      red[s][lane] = acc;
    }
    __syncthreads();
  }
  if (s == 0 && b < B) janus::f128_store(g + b, (size_t)B, acc);
}

bool aligned(int B, const void* he, const void* ho, const void* pv) {
  return B % 4 == 0 && (((uintptr_t)he | (uintptr_t)ho | (uintptr_t)pv) % 16) == 0;
}

}  // namespace

// he/ho are word-major u32 planes (chunk*4, B); pv is the peer's verifier,
// rows (B, ver, 4) of int64 words (ver >= 1 + 2*chunk); g (4, B) u32.
// Returns cudaGetLastError() after the launch.
extern "C" int janus_combine_decide(const uint32_t* he, const uint32_t* ho, const uint64_t* pv,
                                    uint32_t* g, int B, int chunk, int ver, void* stream) {
  if (B <= 0) return 0;
  const dim3 grid((B + 31) / 32), block(32, kWarps);
  if (aligned(B, he, ho, pv)) {
    combine_kernel<true><<<grid, block, 0, (cudaStream_t)stream>>>(he, ho, pv, g, B, chunk, ver);
  } else {
    combine_kernel<false><<<grid, block, 0, (cudaStream_t)stream>>>(he, ho, pv, g, B, chunk, ver);
  }
  return (int)cudaGetLastError();
}
