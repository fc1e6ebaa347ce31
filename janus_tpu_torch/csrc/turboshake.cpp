// Host TurboSHAKE128 sponge and VDAF XOF field expansion.
//
// The CPU side of the port: the oracle's XOF expansion (the client's
// shard, oracle recompute rows and journal replays), which dominates
// oracle wall time for wide VDAFs.  The batched prepare on the card uses
// the Keccak kernels in keccak.cu instead.
//
// Exposed via a C ABI consumed with ctypes (janus_tpu_torch/native.py):
//   ts128_hash:        one-shot TurboSHAKE128
//   ts128_expand_vdaf: draft-08 XofTurboShake128 (len(dst)||dst||seed||binder,
//                      domain 0x01) squeezed as a raw stream
//   ts128_next_vec:    rejection-sampled field-element expansion for
//                      Field64 / Field128, little-endian u64 limb pairs
//
// Byte equality with the pure Python sponge is asserted in
// tests/test_torch_native.py; the Python sponge remains the fallback.

#include <cstdint>
#include <cstring>
#include <cstddef>

namespace {

constexpr int ROUNDS = 12;  // TurboSHAKE uses Keccak-p[1600,12]
constexpr size_t RATE = 168; // bytes; 1344-bit rate for 128-bit security

constexpr uint64_t RC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808aULL,
    0x8000000080008000ULL, 0x000000000000808bULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008aULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000aULL,
    0x000000008000808bULL, 0x800000000000008bULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800aULL, 0x800000008000000aULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL,
};

constexpr int RHO[25] = {0,  1,  62, 28, 27, 36, 44, 6,  55, 20, 3,  10, 43,
                         25, 39, 41, 45, 15, 21, 8,  18, 2,  61, 56, 14};

inline uint64_t rotl(uint64_t v, int r) {
  return r == 0 ? v : (v << r) | (v >> (64 - r));
}

void keccak_p(uint64_t s[25]) {
  uint64_t b[25], c[5], d[5];
  for (int round = 24 - ROUNDS; round < 24; round++) {
    // theta
    for (int x = 0; x < 5; x++)
      c[x] = s[x] ^ s[x + 5] ^ s[x + 10] ^ s[x + 15] ^ s[x + 20];
    for (int x = 0; x < 5; x++)
      d[x] = c[(x + 4) % 5] ^ rotl(c[(x + 1) % 5], 1);
    for (int i = 0; i < 25; i++) s[i] ^= d[i % 5];
    // rho + pi
    for (int x = 0; x < 5; x++)
      for (int y = 0; y < 5; y++)
        b[y + 5 * ((2 * x + 3 * y) % 5)] = rotl(s[x + 5 * y], RHO[x + 5 * y]);
    // chi
    for (int y = 0; y < 5; y++)
      for (int x = 0; x < 5; x++)
        s[x + 5 * y] =
            b[x + 5 * y] ^ (~b[(x + 1) % 5 + 5 * y] & b[(x + 2) % 5 + 5 * y]);
    // iota
    s[0] ^= RC[round];
  }
}

struct Sponge {
  uint64_t state[25] = {0};
  size_t absorb_pos = 0;   // bytes into the current rate block
  size_t squeeze_pos = 0;  // bytes squeezed from the current block
  bool squeezing = false;

  void absorb(const uint8_t* data, size_t len) {
    auto* st = reinterpret_cast<uint8_t*>(state);
    while (len) {
      size_t take = RATE - absorb_pos;
      if (take > len) take = len;
      for (size_t i = 0; i < take; i++) st[absorb_pos + i] ^= data[i];
      absorb_pos += take;
      data += take;
      len -= take;
      if (absorb_pos == RATE) {
        keccak_p(state);
        absorb_pos = 0;
      }
    }
  }

  void finish(uint8_t domain) {
    auto* st = reinterpret_cast<uint8_t*>(state);
    st[absorb_pos] ^= domain;
    st[RATE - 1] ^= 0x80;
    keccak_p(state);
    squeezing = true;
    squeeze_pos = 0;
  }

  void squeeze(uint8_t* out, size_t len) {
    auto* st = reinterpret_cast<uint8_t*>(state);
    while (len) {
      if (squeeze_pos == RATE) {
        keccak_p(state);
        squeeze_pos = 0;
      }
      size_t take = RATE - squeeze_pos;
      if (take > len) take = len;
      std::memcpy(out, st + squeeze_pos, take);
      squeeze_pos += take;
      out += take;
      len -= take;
    }
  }
};

constexpr uint64_t F64_P = 0xffffffff00000001ULL;  // 2^64 - 2^32 + 1
// Field128 p = 2^128 - 7*2^66 + 1 = (2^64 - 0x1c) << 64 | 1.

}  // namespace

extern "C" {

// One-shot TurboSHAKE128.
void ts128_hash(const uint8_t* msg, size_t msg_len, uint8_t domain,
                uint8_t* out, size_t out_len) {
  Sponge sp;
  sp.absorb(msg, msg_len);
  sp.finish(domain);
  sp.squeeze(out, out_len);
}

// draft-08 XofTurboShake128 stream: message = len(dst)||dst||seed||binder.
void ts128_expand_vdaf(const uint8_t* seed, const uint8_t* dst, size_t dst_len,
                       const uint8_t* binder, size_t binder_len, uint8_t* out,
                       size_t out_len) {
  Sponge sp;
  uint8_t prefix = static_cast<uint8_t>(dst_len);
  sp.absorb(&prefix, 1);
  sp.absorb(dst, dst_len);
  sp.absorb(seed, 16);
  sp.absorb(binder, binder_len);
  sp.finish(0x01);
  sp.squeeze(out, out_len);
}

// Rejection-sampled next_vec for Field64 (field=0) or Field128 (field=1).
// out: n_elems * 2 u64 little-endian limbs (hi limb zero for Field64).
// Returns 0 on success.
int ts128_next_vec(const uint8_t* seed, const uint8_t* dst, size_t dst_len,
                   const uint8_t* binder, size_t binder_len, int field,
                   uint64_t* out, size_t n_elems) {
  Sponge sp;
  uint8_t prefix = static_cast<uint8_t>(dst_len);
  sp.absorb(&prefix, 1);
  sp.absorb(dst, dst_len);
  sp.absorb(seed, 16);
  sp.absorb(binder, binder_len);
  sp.finish(0x01);

  const uint64_t f128_hi = 0xffffffffffffffe4ULL;  // top limb of 2^128-7*2^66+1
  size_t got = 0;
  uint8_t buf[16];
  while (got < n_elems) {
    if (field == 0) {
      sp.squeeze(buf, 8);
      uint64_t v;
      std::memcpy(&v, buf, 8);
      if (v < F64_P) {
        out[2 * got] = v;
        out[2 * got + 1] = 0;
        got++;
      }
    } else {
      sp.squeeze(buf, 16);
      uint64_t lo, hi;
      std::memcpy(&lo, buf, 8);
      std::memcpy(&hi, buf + 8, 8);
      // accept iff value < p = (f128_hi << 64) | 1
      if (hi < f128_hi || (hi == f128_hi && lo < 1)) {
        out[2 * got] = lo;
        out[2 * got + 1] = hi;
        got++;
      }
    }
  }
  return 0;
}

}  // extern "C"
