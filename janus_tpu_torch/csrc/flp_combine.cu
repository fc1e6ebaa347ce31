// Planar combine-decide (K4) for sm_90a.
//
// Replaces janus_tpu/ops/flp_pallas.py _combine_decide_kernel (via
// combine_decide_planar).  For every report b, the ParallelSum(Mul) gadget
// over the combined wires:
//
//   g = sum_{u < chunk} mont_mul(he[u] + pe[u], ho[u] + po[u])
//
// he/ho are our even/odd wire planes (chunk, 4, B); the peer's verifier
// planes pv (VER, 4, B) hold its zipped wires at rows 1 + 2u (even) and
// 2 + 2u (odd), read in place.  g (4, B) is canonical and scaled by R^-1
// (two canonical operands); the caller compares it with gpoly(t) * R^-1.
// The Pallas kernel's 8-sublane partials are TPU tiling: this kernel folds
// everything and writes only g.
//
// A block is 32 reports by 8 column slices: thread (x, y) sums columns
// u = y, y + 8, ... of report x, so each warp's loads of one limb plane are
// 32 consecutive reports (128 bytes), and the 8 partial sums meet in shared
// memory.  Modular addition is exact, so the order of the sum does not
// change the canonical result.
//
// What bounds it on the H100: it reads 4 * chunk elements per report
// (82 MB at chunk 316 and B = 4096, 0.025 ms of HBM) and does one Montgomery
// product and three additions per column; 4096 reports make 128 blocks,
// about one per SM, so latency rather than either rate sets its time.
#include <cstdint>
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

using janus::F128;

constexpr int kLanes = 32;
constexpr int kSlices = 8;

__global__ void __launch_bounds__(kLanes * kSlices)
combine_kernel(const uint32_t* __restrict__ he, const uint32_t* __restrict__ ho,
               const uint32_t* __restrict__ pv, uint32_t* __restrict__ g, int B, int chunk) {
  __shared__ F128 part[kSlices][kLanes];
  const int b = blockIdx.x * kLanes + threadIdx.x;
  const int j = threadIdx.y;
  const size_t Bs = (size_t)B;
  const size_t el = 4 * Bs;
  F128 acc = {0, 0};
  if (b < B) {
    for (int u = j; u < chunk; u += kSlices) {
      const F128 xe = janus::f128_add(janus::f128_load(he + (size_t)u * el + b, Bs),
                                      janus::f128_load(pv + (size_t)(1 + 2 * u) * el + b, Bs));
      const F128 xo = janus::f128_add(janus::f128_load(ho + (size_t)u * el + b, Bs),
                                      janus::f128_load(pv + (size_t)(2 + 2 * u) * el + b, Bs));
      acc = janus::f128_add(acc, janus::f128_mont_mul(xe, xo));
    }
  }
  part[j][threadIdx.x] = acc;
  __syncthreads();
  if (j == 0 && b < B) {
#pragma unroll
    for (int i = 1; i < kSlices; ++i) acc = janus::f128_add(acc, part[i][threadIdx.x]);
    janus::f128_store(g + b, Bs, acc);
  }
}

}  // namespace

// Planes are word-major u32: he/ho (chunk*4, B), pv (>= (1 + 2*chunk)*4, B);
// g (4, B).  Returns cudaGetLastError() after the launch.
extern "C" int janus_combine_decide(const uint32_t* he, const uint32_t* ho, const uint32_t* pv,
                                    uint32_t* g, int B, int chunk, void* stream) {
  if (B <= 0) return 0;
  const dim3 block(kLanes, kSlices);
  const dim3 grid((B + kLanes - 1) / kLanes);
  combine_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(he, ho, pv, g, B, chunk);
  return (int)cudaGetLastError();
}
