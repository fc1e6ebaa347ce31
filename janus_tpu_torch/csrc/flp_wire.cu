// Histogram wire evaluations (K3) for sm_90a.
//
// Replaces janus_tpu/ops/flp_pallas.py _wire_kernel (via wire_evals_planar).
// For every chunk column u < chunk and report b:
//
//   evens[u] = (sum_k m[k*chunk + u] * kl[k]) * r_ch[u]
//   odds[u]  =  sum_k m[k*chunk + u] * lagk[k]  -  ccorr
//   ev[u] = seed_even[u] * lag0 + evens[u],  od[u] = seed_odd[u] * lag0 + odds[u]
//
// with the seeds de-interleaved from the proof (proof elements 2u, 2u+1) and
// m read straight from the measurement-share squeeze stream (element e,
// limb l at word e*4 + l).  Positions k*chunk + u >= meas_len are the
// circuit's zero padding; their product is zero, so the loop stops there
// and never reads past the stream (the Pallas kernel read Mosaic edge
// padding under a mask instead).  Outputs are canonical.
//
// What bounds it on the H100: bytes.  It moves 16 bytes per element of m,
// the proof's wire seeds, r_ch and the two outputs, about 171 MB at the
// flagship shape (B = 4096, 0.051 ms of HBM).  Done as Montgomery products,
// the two sums over calls cost about as much again in 32-bit multiplies and
// their carry adds, and a thread's loads and products do not overlap well.
//
// The design: one thread per (report, column), reports along x, so each
// limb-plane load and store is contiguous across a warp, with 1.3M threads
// to cover latency.  The two sums over calls stay unreduced 256-bit sums of
// full products (janus::Wide, 16 32x32 products a term where a Montgomery
// product takes 24), reduced once at the end.  Tiles of 2 and 4 columns a
// thread, which read kl_k and lagk_k once a tile, ran slower on the H100:
// their registers cost more warps than the L2 reads they save.
#include <cstdint>
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

using janus::F128;
using janus::Wide;

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
wire_kernel(const uint32_t* __restrict__ m, const uint32_t* __restrict__ proof,
            const uint32_t* __restrict__ rch, const uint32_t* __restrict__ kl,
            const uint32_t* __restrict__ lagk, const uint32_t* __restrict__ lag0,
            const uint32_t* __restrict__ ccorr, uint32_t* __restrict__ ev,
            uint32_t* __restrict__ od, int B, int meas_len, int chunk, int calls) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const int u = blockIdx.y;
  if (b >= B) return;
  const size_t Bs = (size_t)B;
  const size_t el = 4 * Bs;  // words per element plane
  Wide s1 = {}, s2 = {};
  for (int k = 0; k < calls; ++k) {
    const int e = k * chunk + u;
    if (e >= meas_len) break;
    const F128 x = janus::f128_load(m + (size_t)e * el + b, Bs);
    janus::wide_mac(s1, x, janus::f128_load(kl + (size_t)k * el + b, Bs));
    janus::wide_mac(s2, x, janus::f128_load(lagk + (size_t)k * el + b, Bs));
  }
  const F128 evens = janus::f128_mont_mul(janus::wide_reduce(s1), janus::f128_load(rch + (size_t)u * el + b, Bs));
  const F128 odds = janus::f128_sub(janus::wide_reduce(s2), janus::f128_load(ccorr + b, Bs));
  const F128 l0 = janus::f128_load(lag0 + b, Bs);
  const F128 swe = janus::f128_load(proof + (size_t)(2 * u) * el + b, Bs);
  const F128 swo = janus::f128_load(proof + (size_t)(2 * u + 1) * el + b, Bs);
  janus::f128_store(ev + (size_t)u * el + b, Bs, janus::f128_add(janus::f128_mont_mul(swe, l0), evens));
  janus::f128_store(od + (size_t)u * el + b, Bs, janus::f128_add(janus::f128_mont_mul(swo, l0), odds));
}

}  // namespace

// Planes are word-major u32: m (meas_len*4, B), proof (>= 2*chunk*4, B),
// rch (chunk*4, B), kl/lagk (calls*4, B), lag0/ccorr (4, B); ev/od
// (chunk*4, B).  Returns cudaGetLastError() after the launch.
extern "C" int janus_wire_evals(const uint32_t* m, const uint32_t* proof, const uint32_t* rch,
                                const uint32_t* kl, const uint32_t* lagk, const uint32_t* lag0,
                                const uint32_t* ccorr, uint32_t* ev, uint32_t* od, int B,
                                int meas_len, int chunk, int calls, void* stream) {
  if (B <= 0 || chunk <= 0) return 0;
  const dim3 grid((B + kThreads - 1) / kThreads, chunk);
  wire_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(m, proof, rch, kl, lagk, lag0, ccorr,
                                                           ev, od, B, meas_len, chunk, calls);
  return (int)cudaGetLastError();
}
