// The reduce pass of the limb-digit matmul (ops/field.py mat_mul_mont) for
// sm_90a.
//
// Replaces janus_tpu/ops/field_jax.py JField._lazy_reduce_digits, which XLA
// fuses into one pass after the digit-plane dot_general.  The product
// before it is a float64 matmul over base-2^8 digit planes (D = 4n digits an
// element), so its partial sums P[d, e] = sum_k a_d[k] b_e[k] are integers
// below K * 255^2 <= 2^32, exact in float64.  For every output element:
//
//   S[g]  = sum_{d + e = g} lo16(P[d, e]) + sum_{d + e + 2 = g} hi16(P[d, e])
//   U     = sum_g S[g] 2^(8g) = U0 + R U1 + R^2 U2     (R = 2^(32n))
//   out   = U R^-1 mod p = from_mont(U0) + U1 + mont_mul(U2, R^2)
//
// A column S[g] sums at most 2D halves below 2^16, so it stays below 2^21;
// U < 2^(64n + 16) fits the 2n + 1 u32 limbs.  Each of the three terms is
// the canonical residue of its value, so the sum is the unique canonical
// limbs of sum_k mont_mul(a_k, b_k), as the JAX pass gives.
//
// What bounds it on the H100: bytes.  It reads 8 bytes a partial sum, D^2
// of them an output element (2 KB for Field128), and writes 4n bytes.
//
// The design: one thread an output element, elements of one row along x,
// so a warp reads one contiguous run of partial sums (a thread's D sums of
// one digit d are contiguous: 16-byte loads).  The columns, the carry pass
// and the fold stay in registers (the digit loops unroll fully); Field128
// takes field.cuh's core, Field64 the word-sized Montgomery product below.
#include <cstdint>
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

using janus::F128;
using janus::u128;

constexpr int kThreads = 128;

// Field64: p = 2^64 - 2^32 + 1, R = 2^64, n' = -p^-1 mod 2^64.
constexpr uint64_t kP64 = 0xFFFFFFFF00000001ull;
constexpr uint64_t kNPrime64 = 0xFFFFFFFEFFFFFFFFull;

// a*b*R^-1 mod p for a < 2^64, b < p: t = (a*b + m*p) / R < 2p.  The low
// words of a*b and m*p sum to 0 or 2^64 (the carry is 1 exactly when the
// low word of a*b is not 0).
__device__ __forceinline__ uint64_t f64_mont_mul(uint64_t a, uint64_t b) {
  const u128 x = (u128)a * b;
  const uint64_t m = (uint64_t)x * kNPrime64;
  const u128 t = (x >> 64) + (((u128)m * kP64) >> 64) + (uint64_t)((uint64_t)x != 0);
  return t >= kP64 ? (uint64_t)(t - kP64) : (uint64_t)t;
}

// (a + b) mod p for a, b < p.
__device__ __forceinline__ uint64_t f64_add(uint64_t a, uint64_t b) {
  const u128 s = (u128)a + b;
  return s >= kP64 ? (uint64_t)(s - kP64) : (uint64_t)s;
}

template <int N>
__global__ void __launch_bounds__(kThreads)
digit_reduce_kernel(const double* __restrict__ P, uint32_t* __restrict__ out, long long total, int cols,
                    uint64_t r2_lo, uint64_t r2_hi) {
  constexpr int D = 4 * N;
  constexpr int L = 2 * N + 1;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const long long row = t / cols;
  const long long v = t - row * cols;

  uint32_t S[4 * L];
#pragma unroll
  for (int g = 0; g < 4 * L; ++g) S[g] = 0;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const double2* p = reinterpret_cast<const double2*>(P + ((row * D + d) * cols + v) * D);
#pragma unroll
    for (int h = 0; h < D / 2; ++h) {
      const double2 x = p[h];
      const uint32_t x0 = __double2uint_rn(x.x);
      const uint32_t x1 = __double2uint_rn(x.y);
      S[d + 2 * h] += x0 & 0xFFFFu;
      S[d + 2 * h + 2] += x0 >> 16;
      S[d + 2 * h + 1] += x1 & 0xFFFFu;
      S[d + 2 * h + 3] += x1 >> 16;
    }
  }

  // carry the base-2^8 columns into the 2n + 1 limbs of U (the last carry
  // is 0: U < 2^(32 L))
  uint32_t U[L];
  uint64_t carry = 0;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const uint64_t w = (uint64_t)S[4 * j] + ((uint64_t)S[4 * j + 1] << 8) + ((uint64_t)S[4 * j + 2] << 16) +
                       ((uint64_t)S[4 * j + 3] << 24) + carry;
    U[j] = (uint32_t)w;
    carry = w >> 32;
  }

  uint32_t* o = out + t * N;
  if constexpr (N == 4) {
    const F128 u0{(uint64_t)U[0] | ((uint64_t)U[1] << 32), (uint64_t)U[2] | ((uint64_t)U[3] << 32)};
    const uint64_t u1_lo = (uint64_t)U[4] | ((uint64_t)U[5] << 32);
    const uint64_t u1_hi = (uint64_t)U[6] | ((uint64_t)U[7] << 32);
    const F128 from_mont = janus::f128_mont_mul(u0, F128{1, 0});
    const F128 u1 = janus::f128_cond_sub(u1_lo, u1_hi, 0);  // U1 < 2^128 < 2p
    const F128 u2 = janus::f128_mont_mul(F128{U[8], 0}, F128{r2_lo, r2_hi});
    const F128 r = janus::f128_add(janus::f128_add(from_mont, u1), u2);
    o[0] = (uint32_t)r.lo;
    o[1] = (uint32_t)(r.lo >> 32);
    o[2] = (uint32_t)r.hi;
    o[3] = (uint32_t)(r.hi >> 32);
  } else {
    const uint64_t u0 = (uint64_t)U[0] | ((uint64_t)U[1] << 32);
    uint64_t u1 = (uint64_t)U[2] | ((uint64_t)U[3] << 32);
    u1 = u1 >= kP64 ? u1 - kP64 : u1;  // U1 < 2^64 < 2p
    const uint64_t r = f64_add(f64_add(f64_mont_mul(u0, 1), u1), f64_mont_mul(U[4], r2_lo));
    o[0] = (uint32_t)r;
    o[1] = (uint32_t)(r >> 32);
  }
}

}  // namespace

// P: (rows, D, cols, D) float64 partial sums, contiguous and 16-byte
// aligned (D = 4n); out: (rows, cols, n) u32 canonical limbs; n is 2
// (Field64) or 4 (Field128); R^2 mod p as two 64-bit words.  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for another n).
extern "C" int janus_digit_reduce(const double* P, uint32_t* out, long long rows, int cols, int n,
                                  unsigned long long r2_lo, unsigned long long r2_hi, void* stream) {
  const long long total = rows * (long long)cols;
  if (total <= 0) return 0;
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  if (n == 4) {
    digit_reduce_kernel<4><<<blocks, kThreads, 0, s>>>(P, out, total, cols, r2_lo, r2_hi);
  } else if (n == 2) {
    digit_reduce_kernel<2><<<blocks, kThreads, 0, s>>>(P, out, total, cols, r2_lo, r2_hi);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
