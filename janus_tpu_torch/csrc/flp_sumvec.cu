// SumVec wire evaluations (K5) for sm_90a.
//
// Replaces janus_tpu/ops/flp_pallas.py _sumvec_partial_kernel, which the
// JAX package runs under a lax.scan over slabs of 8 calls, with XLA building
// each slab's coefficient table klu[k,u] = jr_k^(u+1) * lag_{k+1} in memory
// (janus_tpu/ops/prepare.py _sumvec_wires_planar).  One launch here covers
// every call and the whole wire epilogue.  For every chunk column u < chunk
// and report b:
//
//   evens[u] = sum_k m[k*chunk + u] * jr_k^(u+1) * lag_{k+1}
//   odds[u]  = sum_k m[k*chunk + u] * lag_{k+1}  -  ccorr
//   ev[u] = seed_even[u] * lag0 + evens[u],  od[u] = seed_odd[u] * lag0 + odds[u]
//
// jr_k^(u+1) is made in registers by square-and-multiply from jr_k
// (Montgomery form), so klu is never written to memory.  m is read straight
// from the measurement-share stream (element e, limb l at word e*4 + l);
// positions k*chunk + u >= meas_len are the circuit's zero padding, so the
// call loop stops there and never reads past the stream.  Every product
// pairs one canonical operand with one Montgomery operand (or two Montgomery
// ones for the powers), so outputs are canonical and byte-equal to the plain
// version.
//
// One thread per (report, column): blockIdx.y = u, so the exponent u + 1 and
// the square-and-multiply branches are uniform across a block, and reports
// run along x, so each limb-plane load and store is contiguous across a warp.
//
// What bounds it on the H100: m is 1.6 GB at 100000 elements and B = 1024
// (0.5 ms of HBM), but each (column, call) costs up to about 16 Montgomery
// products on 64-bit words (about 9 squarings and 4 multiplies for the power,
// then three more), so the 64-bit multiplies bound it.  A later design can
// carry the power along u within a thread and cut that to about 3.
#include <cstdint>
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

using janus::F128;

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
sumvec_kernel(const uint32_t* __restrict__ m, const uint32_t* __restrict__ proof,
              const uint32_t* __restrict__ jr, const uint32_t* __restrict__ lagk,
              const uint32_t* __restrict__ lag0, const uint32_t* __restrict__ ccorr,
              uint32_t* __restrict__ ev, uint32_t* __restrict__ od, int B, int meas_len,
              int chunk, int calls) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const int u = blockIdx.y;
  if (b >= B) return;
  const size_t Bs = (size_t)B;
  const size_t el = 4 * Bs;  // words per element plane
  const unsigned e1 = (unsigned)u + 1;
  const int top = 31 - __clz((int)e1);  // highest set bit of u + 1
  F128 s1 = {0, 0}, s2 = {0, 0};
  for (int k = 0; k < calls; ++k) {
    const int e = k * chunk + u;
    if (e >= meas_len) break;
    const F128 r = janus::f128_load(jr + (size_t)k * el + b, Bs);
    const F128 lag = janus::f128_load(lagk + (size_t)k * el + b, Bs);
    F128 pw = r;
    for (int i = top - 1; i >= 0; --i) {
      pw = janus::f128_mont_mul(pw, pw);
      if ((e1 >> i) & 1u) pw = janus::f128_mont_mul(pw, r);
    }
    const F128 x = janus::f128_load(m + (size_t)e * el + b, Bs);
    s1 = janus::f128_add(s1, janus::f128_mont_mul(x, janus::f128_mont_mul(pw, lag)));
    s2 = janus::f128_add(s2, janus::f128_mont_mul(x, lag));
  }
  const F128 odds = janus::f128_sub(s2, janus::f128_load(ccorr + b, Bs));
  const F128 l0 = janus::f128_load(lag0 + b, Bs);
  const F128 swe = janus::f128_load(proof + (size_t)(2 * u) * el + b, Bs);
  const F128 swo = janus::f128_load(proof + (size_t)(2 * u + 1) * el + b, Bs);
  janus::f128_store(ev + (size_t)u * el + b, Bs, janus::f128_add(janus::f128_mont_mul(swe, l0), s1));
  janus::f128_store(od + (size_t)u * el + b, Bs, janus::f128_add(janus::f128_mont_mul(swo, l0), odds));
}

}  // namespace

// Planes are word-major u32: m (>= meas_len*4, B), proof (>= 2*chunk*4, B),
// jr/lagk (calls*4, B), lag0/ccorr (4, B); ev/od (chunk*4, B).  Returns
// cudaGetLastError() after the launch.
extern "C" int janus_sumvec_wires(const uint32_t* m, const uint32_t* proof, const uint32_t* jr,
                                  const uint32_t* lagk, const uint32_t* lag0,
                                  const uint32_t* ccorr, uint32_t* ev, uint32_t* od, int B,
                                  int meas_len, int chunk, int calls, void* stream) {
  if (B <= 0 || chunk <= 0) return 0;
  const dim3 grid((B + kThreads - 1) / kThreads, chunk);
  sumvec_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(m, proof, jr, lagk, lag0, ccorr, ev,
                                                             od, B, meas_len, chunk, calls);
  return (int)cudaGetLastError();
}
