// Field128 arithmetic for the CUDA kernels: p = 2^128 - 7*2^66 + 1.
//
// Counterpart of JField's u32-limb CIOS core (janus_tpu/ops/field_jax.py).
// An element is two 64-bit words; in memory it is four u32 words, limb l of
// element e at word e*4 + l of a word-major (W, B) plane, so a warp's loads
// of one limb are contiguous across reports.  Montgomery form uses
// R = 2^128, the R JField uses for Field128, so the word-by-word reduction
// yields the same integer t = (a*b + M*p) / R as the u32-limb version
// (M = -a*b*p^-1 mod R is unique) and, after the single conditional
// subtraction both perform, the same limbs.
#pragma once

#include <cstdint>

namespace janus {

typedef unsigned __int128 u128;

struct F128 {
  uint64_t lo, hi;
};

constexpr uint64_t kPLo = 1ull;
constexpr uint64_t kPHi = 0xFFFFFFFFFFFFFFE4ull;  // 2^64 - 28
// -p^-1 mod 2^64: p = 1 mod 2^64, so p^-1 = 1 and n' = 2^64 - 1.
constexpr uint64_t kNPrime = 0xFFFFFFFFFFFFFFFFull;

// Load/store one element from a word-major plane: words at p[0], p[s],
// p[2s], p[3s] (s = the plane stride, the batch size).
__device__ __forceinline__ F128 f128_load(const uint32_t* p, size_t s) {
  F128 r;
  r.lo = (uint64_t)p[0] | ((uint64_t)p[s] << 32);
  r.hi = (uint64_t)p[2 * s] | ((uint64_t)p[3 * s] << 32);
  return r;
}

__device__ __forceinline__ void f128_store(uint32_t* p, size_t s, F128 x) {
  p[0] = (uint32_t)x.lo;
  p[s] = (uint32_t)(x.lo >> 32);
  p[2 * s] = (uint32_t)x.hi;
  p[3 * s] = (uint32_t)(x.hi >> 32);
}

// (extra:hi:lo) minus p once if that value is >= p.
__device__ __forceinline__ F128 f128_cond_sub(uint64_t lo, uint64_t hi, uint64_t extra) {
  const uint64_t dlo = lo - kPLo;
  const uint64_t b0 = lo < kPLo;
  const uint64_t dhi = hi - kPHi - b0;
  const bool borrow = (hi < kPHi) || (hi == kPHi && b0);
  if (extra || !borrow) return F128{dlo, dhi};
  return F128{lo, hi};
}

__device__ __forceinline__ F128 f128_add(F128 a, F128 b) {
  const u128 s0 = (u128)a.lo + b.lo;
  const u128 s1 = (u128)a.hi + b.hi + (uint64_t)(s0 >> 64);
  return f128_cond_sub((uint64_t)s0, (uint64_t)s1, (uint64_t)(s1 >> 64));
}

__device__ __forceinline__ F128 f128_sub(F128 a, F128 b) {
  const uint64_t dlo = a.lo - b.lo;
  const uint64_t b0 = a.lo < b.lo;
  const uint64_t dhi = a.hi - b.hi - b0;
  const bool borrow = (a.hi < b.hi) || (a.hi == b.hi && b0);
  if (!borrow) return F128{dlo, dhi};
  const uint64_t slo = dlo + kPLo;
  return F128{slo, dhi + kPHi + (uint64_t)(slo < dlo)};
}

// CIOS Montgomery product a*b*R^-1 mod p with 64-bit words.
__device__ __forceinline__ F128 f128_mont_mul(F128 a, F128 b) {
  uint64_t t0 = 0, t1 = 0, t2 = 0;
  const uint64_t as[2] = {a.lo, a.hi};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    u128 x = (u128)as[i] * b.lo + t0;
    t0 = (uint64_t)x;
    uint64_t c = (uint64_t)(x >> 64);
    x = (u128)as[i] * b.hi + t1 + c;
    t1 = (uint64_t)x;
    c = (uint64_t)(x >> 64);
    x = (u128)t2 + c;
    t2 = (uint64_t)x;
    const uint64_t t3 = (uint64_t)(x >> 64);
    const uint64_t m = t0 * kNPrime;
    x = (u128)m * kPLo + t0;  // low word becomes zero
    c = (uint64_t)(x >> 64);
    x = (u128)m * kPHi + t1 + c;
    t0 = (uint64_t)x;
    c = (uint64_t)(x >> 64);
    x = (u128)t2 + c;
    t1 = (uint64_t)x;
    t2 = t3 + (uint64_t)(x >> 64);
  }
  return f128_cond_sub(t0, t1, t2);
}

// r^e (e >= 1) by square-and-multiply, r and the result in Montgomery form.
__device__ __forceinline__ F128 f128_pow(F128 r, unsigned e) {
  F128 pw = r;
  for (int i = 30 - __clz((int)e); i >= 0; --i) {
    pw = f128_mont_mul(pw, pw);
    if ((e >> i) & 1u) pw = f128_mont_mul(pw, r);
  }
  return pw;
}

// A sum of 128x128-bit products, not reduced: 256 bits in four 64-bit words
// and the count of carries out of them.  Summing full products and reducing
// once at the end costs 16 32x32 products a term where a Montgomery product
// costs 24 (16 and the reduction's 8: n' = -1 and p's low word 1 cost
// none), and gives the same residue.
struct Wide {
  uint64_t w0, w1, w2, w3;
  uint32_t c;
};

// acc += a*b, exactly.
__device__ __forceinline__ void wide_mac(Wide& acc, F128 a, F128 b) {
  const u128 p00 = (u128)a.lo * b.lo;
  const u128 p01 = (u128)a.lo * b.hi;
  const u128 p10 = (u128)a.hi * b.lo;
  const u128 p11 = (u128)a.hi * b.hi;
  u128 t = (u128)acc.w0 + (uint64_t)p00;
  acc.w0 = (uint64_t)t;
  t = (t >> 64) + acc.w1 + (uint64_t)(p00 >> 64) + (uint64_t)p01 + (uint64_t)p10;
  acc.w1 = (uint64_t)t;
  t = (t >> 64) + acc.w2 + (uint64_t)(p01 >> 64) + (uint64_t)(p10 >> 64) + (uint64_t)p11;
  acc.w2 = (uint64_t)t;
  t = (t >> 64) + acc.w3 + (uint64_t)(p11 >> 64);
  acc.w3 = (uint64_t)t;
  acc.c += (uint32_t)(t >> 64);
}

// (ex:hi:lo) < 3p, reduced to [0, p).
__device__ __forceinline__ F128 f128_reduce3(uint64_t lo, uint64_t hi, uint64_t ex) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint64_t dlo = lo - kPLo;
    const uint64_t b0 = lo < kPLo;
    const uint64_t dhi = hi - kPHi - b0;
    const uint64_t borrow = (hi < kPHi) || (hi == kPHi && b0);
    if (ex || !borrow) {  // (ex:hi:lo) >= p
      lo = dlo;
      hi = dhi;
      ex -= borrow;
    }
  }
  return F128{lo, hi};
}

// The canonical residue of acc * R^-1, so that reducing a sum of products
// a*b gives the sum of their Montgomery products mont(a, b).  Two word-by-
// word Montgomery steps take the low 256 bits w to (w + M*p) / R < R + p;
// the carries fold in as c * 2^256 * R^-1 = c * R = c * (R - p) mod p, with
// R - p = 28 * 2^64 - 1.
__device__ __forceinline__ F128 wide_reduce(const Wide& acc) {
  uint64_t t[5] = {acc.w0, acc.w1, acc.w2, acc.w3, 0};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint64_t m = t[i] * kNPrime;
    u128 x = (u128)m * kPLo + t[i];  // low word becomes zero
    x = (u128)m * kPHi + t[i + 1] + (uint64_t)(x >> 64);
    t[i + 1] = (uint64_t)x;
#pragma unroll
    for (int j = i + 2; j < 5; ++j) {
      x = (u128)t[j] + (uint64_t)(x >> 64);
      t[j] = (uint64_t)x;
    }
  }
  const u128 fold = ((u128)(28ull * acc.c) << 64) - acc.c;
  const u128 lo = (u128)t[2] + (uint64_t)fold;
  const u128 hi = (u128)t[3] + (uint64_t)(fold >> 64) + (uint64_t)(lo >> 64);
  return f128_reduce3((uint64_t)lo, (uint64_t)hi, t[4] + (uint64_t)(hi >> 64));
}

}  // namespace janus
