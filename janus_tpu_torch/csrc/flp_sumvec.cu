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
// m is read straight from the measurement-share stream (element e, limb l
// at word e*4 + l); positions k*chunk + u >= meas_len are the circuit's zero
// padding, so a call's columns stop there and nothing past the stream is
// read.  Outputs are canonical and byte-equal to the plain version.
//
// What bounds it on the H100: the integer pipes.  Per (call, column) the
// function needs the power step c <- c * jr_k (one Montgomery product, 24
// 32x32 products for this p: n' = -1 and p's low word 1 cost none) and the
// two products m * c and m * lag, whose reduction can wait for the column's
// sum (16 products each): 112 multiply results and about 120 adds, 0.74 ms
// at the card's integer ALU rate for m of 100000 elements at B = 1024
// (1.6 GB, 0.49 ms of HBM).  A column step here compiles to about 276
// instructions, 58 of them wide multiplies, so the multiply and ALU pipes
// together set the floor near 1 ms; the rest is the latency of the
// dependent carry chains at 16 warps an SM.
//
// The design:
// - A thread owns one report and a tile of kTile consecutive columns, and
//   carries c = jr_k^(u+1) * lag_k along them, one Montgomery product a
//   column.  It reads jr_k and lag_k once a tile.
// - The two column sums stay unreduced 256-bit sums of full products
//   (janus::Wide, 16 32x32 products a term where a Montgomery product takes
//   24), reduced once a column after the last call.
// - The start of the power, jr_k^(u0+1) * lag_k, comes from the tile to the
//   left, which ends its run at exactly that power: the tiles of a report
//   form a chain in one block and hand c on through shared memory.  Tile t
//   of the block takes call (s - t) mod calls at step s, so the hand-off
//   made at step s - 1 is for the call it takes at step s, and no tile
//   waits for the chain to fill; only at step 0 (and for the first tile of
//   a block past the first, where chunk exceeds a block) does a tile build
//   its power by square-and-multiply.
// - The sums of a report's whole chunk live in registers (18 words a
//   column), which sets the tile: 5 columns, 128 registers, 16 warps an SM;
//   wider tiles hold fewer warps and ran slower on the H100.
// - A block is kLanes reports by up to kMaxTiles tiles (chunk 316 = 63 * 5
//   + 1 in one block); a warp is 8 reports by 4 tiles, so each limb-plane
//   load is four whole 32-byte sectors.
// - The steps meet at a barrier (the hand-off), so a thread stages its next
//   call's kTile elements of m into shared memory by cp.async while it
//   works on this call's, and the loads overlap the products.
// - A block's work does not shrink with B, so where the batch leaves SMs
//   idle (B = 128 is 16 blocks on 132 SMs) the calls are split over a
//   thread block cluster of up to kMaxParts blocks along z, each taking a
//   run of calls.  Each block reduces its sums into its shared memory, and
//   after a cluster barrier the blocks add up the cluster's partial sums
//   over distributed shared memory, a share of the tiles each, and run the
//   epilogue.  The launcher picks the cluster size that takes the fewest
//   waves times calls a block, from the card's cluster occupancy.
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "cp_async.cuh"
#include "field.cuh"

namespace {

namespace cg = cooperative_groups;
using janus::F128;
using janus::Wide;

constexpr int kTile = 5;
constexpr int kLanes = 8;
constexpr int kMaxTiles = 64;
constexpr int kMaxParts = 8;  // the largest portable cluster
constexpr int kWords = 4 * kTile;  // words of m a thread stages a call

__global__ void __launch_bounds__(kLanes * kMaxTiles)
sumvec_kernel(const uint32_t* __restrict__ m, const uint32_t* __restrict__ proof,
              const uint32_t* __restrict__ jr, const uint32_t* __restrict__ lagk,
              const uint32_t* __restrict__ lag0, const uint32_t* __restrict__ ccorr,
              uint32_t* __restrict__ ev, uint32_t* __restrict__ od, int B, int meas_len,
              int chunk, int calls) {
  __shared__ F128 handoff[2][kMaxTiles][kLanes];
  // [2][kWords][threads] words of m while the calls run; then this block's
  // reduced sums, [2 * kTile][threads] elements (the same bytes).
  extern __shared__ __align__(16) uint32_t staged[];
  cg::cluster_group cluster = cg::this_cluster();
  const int parts = (int)cluster.num_blocks();
  const int part = (int)cluster.block_rank();
  const int lane = threadIdx.x;
  const int t = threadIdx.y;
  const int threads = kLanes * blockDim.y;
  const int b = blockIdx.x * kLanes + lane;
  const int u0 = (blockIdx.y * blockDim.y + t) * kTile;
  const int nt = max(0, min(kTile, chunk - u0));  // this tile's columns
  const bool live = b < B && nt > 0;
  // Whether the next tile of the block takes its power from this one.
  const bool hands_on = nt == kTile && t + 1 < (int)blockDim.y && u0 + kTile < chunk;
  const size_t Bs = (size_t)B;
  const size_t el = 4 * Bs;  // words per element plane
  // This block's run of calls: k0, k0 + 1, ..., k0 + n - 1 (n >= 1).
  const int k0 = (int)((long long)calls * part / parts);
  const int n = (int)((long long)calls * (part + 1) / parts) - k0;
  uint32_t* const mine = staged + t * kLanes + lane;
  // Step s takes call k0 + (s - t) mod n, and the tile's columns of it that
  // lie in the stream (none where the thread is idle).
  auto call = [&](int s) {
    const int k = (s - t) % n;
    return k0 + (k < 0 ? k + n : k);
  };
  auto columns = [&](int k) { return live ? min(nt, meas_len - k * chunk - u0) : 0; };
  auto stage = [&](int s) {
    const int k = call(s);
    const int v = columns(k);
    const uint32_t* mk = m + (size_t)(k * chunk + u0) * el + b;
    uint32_t* dst = mine + (s & 1) * kWords * threads;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      if (j < v) {
#pragma unroll
        for (int l = 0; l < 4; ++l) janus::cp_async4(dst + (4 * j + l) * threads, mk + j * el + l * Bs);
      }
    }
    janus::cp_async_commit();
  };
  Wide s1[kTile] = {}, s2[kTile] = {};
  stage(0);
  for (int s = 0; s < n; ++s) {
    if (s + 1 < n) {
      stage(s + 1);
    } else {
      janus::cp_async_commit();  // an empty group keeps the wait below uniform
    }
    janus::cp_async_wait<1>();
    const int k = call(s);
    const int v = columns(k);
    if (v > 0) {
      const F128 r = janus::f128_load(jr + (size_t)k * el + b, Bs);
      const F128 lag = janus::f128_load(lagk + (size_t)k * el + b, Bs);
      const uint32_t* xs = mine + (s & 1) * kWords * threads;
      F128 c = (s == 0 || t == 0) ? janus::f128_mont_mul(janus::f128_pow(r, u0 + 1), lag)
                                  : handoff[(s - 1) & 1][t - 1][lane];
#pragma unroll
      for (int j = 0; j < kTile; ++j) {
        if (j < v) {
          const F128 x = janus::f128_load(xs + 4 * j * threads, threads);
          janus::wide_mac(s1[j], x, c);
          janus::wide_mac(s2[j], x, lag);
          if (j + 1 < v || hands_on) c = janus::f128_mont_mul(c, r);
        }
      }
      if (hands_on && v == kTile) handoff[s & 1][t][lane] = c;
    }
    __syncthreads();
  }
  // Every copy has landed (the last group waited on was the empty one) and
  // the barrier above ended the reads of m, so the sums take its place.
  F128* const sums = reinterpret_cast<F128*>(staged);
  const int me = t * kLanes + lane;
#pragma unroll
  for (int j = 0; j < kTile; ++j) {
    if (live && j < nt) {
      sums[(2 * j) * threads + me] = janus::wide_reduce(s1[j]);
      sums[(2 * j + 1) * threads + me] = janus::wide_reduce(s2[j]);
    }
  }
  cluster.sync();
  if (live && t % parts == part) {
    const F128 l0 = janus::f128_load(lag0 + b, Bs);
    const F128 cc = janus::f128_load(ccorr + b, Bs);
    for (int j = 0; j < nt; ++j) {
      F128 evens = sums[(2 * j) * threads + me];
      F128 odds = sums[(2 * j + 1) * threads + me];
      for (int r = 0; r < parts; ++r) {
        if (r == part) continue;
        const F128* theirs = cluster.map_shared_rank(sums, r);
        evens = janus::f128_add(evens, theirs[(2 * j) * threads + me]);
        odds = janus::f128_add(odds, theirs[(2 * j + 1) * threads + me]);
      }
      const size_t u = (size_t)(u0 + j);
      const F128 swe = janus::f128_load(proof + 2 * u * el + b, Bs);
      const F128 swo = janus::f128_load(proof + (2 * u + 1) * el + b, Bs);
      janus::f128_store(ev + u * el + b, Bs, janus::f128_add(janus::f128_mont_mul(swe, l0), evens));
      janus::f128_store(od + u * el + b, Bs,
                        janus::f128_add(janus::f128_mont_mul(swo, l0), janus::f128_sub(odds, cc)));
    }
  }
  cluster.sync();  // no block leaves while another reads its sums
}

}  // namespace

// Planes are word-major u32: m (>= meas_len*4, B), proof (>= 2*chunk*4, B),
// jr/lagk (calls*4, B), lag0/ccorr (4, B); ev/od (chunk*4, B).  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue, launching
// nothing, where chunk needs more than 65535 blocks of tiles).
extern "C" int janus_sumvec_wires(const uint32_t* m, const uint32_t* proof, const uint32_t* jr,
                                  const uint32_t* lagk, const uint32_t* lag0,
                                  const uint32_t* ccorr, uint32_t* ev, uint32_t* od, int B,
                                  int meas_len, int chunk, int calls, void* stream) {
  if (B <= 0 || chunk <= 0) return 0;
  const int tiles = (chunk + kTile - 1) / kTile;
  const int groups = (tiles + kMaxTiles - 1) / kMaxTiles;
  if (groups > 65535) return (int)cudaErrorInvalidValue;
  const int per_block = (tiles + groups - 1) / groups;
  const size_t smem = 2 * kWords * kLanes * per_block * sizeof(uint32_t);
  cudaError_t err =
      cudaFuncSetAttribute(sumvec_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((B + kLanes - 1) / kLanes, groups, 1);
  cfg.blockDim = dim3(kLanes, per_block);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // The cluster size: the fewest waves of clusters times calls a block.
  const long long clusters = (long long)cfg.gridDim.x * groups;
  long long best = 0;
  int parts = 1;
  for (int g = 1; g <= kMaxParts && g <= calls; ++g) {
    cfg.gridDim.z = g;
    attr[0].val.clusterDim.z = g;
    int active = 0;
    err = cudaOccupancyMaxActiveClusters(&active, sumvec_kernel, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (active == 0) break;
    const long long cost = (clusters + active - 1) / active * ((calls + g - 1) / g);
    if (g == 1 || cost < best) {
      best = cost;
      parts = g;
    }
  }
  cfg.gridDim.z = parts;
  attr[0].val.clusterDim.z = parts;
  err = cudaLaunchKernelEx(&cfg, sumvec_kernel, m, proof, jr, lagk, lag0, ccorr, ev, od, B,
                           meas_len, chunk, calls);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
