"""TurboSHAKE128, ``XofTurboShake128``, ``XofFixedKeyAes128`` and
``XofHmacSha256Aes128`` — the bit-exact CPU oracles of the VDAF XOFs.

Implements the TurboSHAKE128 sponge (Keccak-p[1600,12], rate 168, domain
separation byte) and the Prio3 XOF built on it (draft-irtf-cfrg-vdaf-08
§6.2.1, seed size 16).  Pure Python: this is the truth the batched CUDA
Keccak kernels in ``janus_tpu_torch.ops.keccak_kernels`` are held against,
and the per-row path the CUDA backend takes for rows the device flagged;
``XofTurboShake128.expand_into_vec`` takes the C++ sponge of
``native.py`` for Field64 and Field128.
``XofHmacSha256Aes128`` is libprio-rs's non-standard XOF of the HMAC
multiproof VDAF (Daphne interop); it has no device twin and runs on the
host for ``HybridXofBackend``.  ``XofFixedKeyAes128`` is the IDPF tree
walk's XOF (draft-irtf-cfrg-vdaf-08 §6.2.2); the batched walks in
``janus_tpu_torch.ops.poplar1_batch`` are held against it.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List

from . import native
from .fields import next_power_of_2

_M64 = (1 << 64) - 1

# Standard Keccak-f[1600] round constants; Keccak-p[1600,12] (TurboSHAKE) uses
# the final 12.
ROUND_CONSTANTS = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

# Rotation offsets, generated from the rho step schedule (index = x + 5*y).
_RHO = [0] * 25
_x, _y = 1, 0
for _t in range(24):
    _RHO[_x + 5 * _y] = ((_t + 1) * (_t + 2) // 2) % 64
    _x, _y = _y, (2 * _x + 3 * _y) % 5


def _rotl(v: int, r: int) -> int:
    return ((v << r) | (v >> (64 - r))) & _M64


def keccak_p(lanes: List[int], rounds: int) -> List[int]:
    """Keccak-p[1600, rounds] permutation on 25 u64 lanes (index = x + 5*y)."""
    a = list(lanes)
    for rc in ROUND_CONSTANTS[24 - rounds :]:
        # theta
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        a = [a[i] ^ d[i % 5] for i in range(25)]
        # rho + pi
        b = [0] * 25
        for x in range(5):
            for y in range(5):
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rotl(a[x + 5 * y], _RHO[x + 5 * y])
        # chi
        a = [
            b[i] ^ ((b[(i % 5 + 1) % 5 + 5 * (i // 5)] ^ _M64) & b[(i % 5 + 2) % 5 + 5 * (i // 5)])
            for i in range(25)
        ]
        # iota
        a[0] ^= rc
    return a


class _Sponge:
    """Keccak sponge in absorb-then-squeeze mode with TurboSHAKE padding."""

    def __init__(self, rate: int, rounds: int, domain: int):
        self.rate = rate
        self.rounds = rounds
        self.domain = domain
        self._buf = bytearray()
        self._state = [0] * 25
        self._squeezing = False
        self._out = bytearray()

    def update(self, data: bytes) -> None:
        if self._squeezing:
            raise ValueError("cannot absorb after squeezing")
        self._buf += data
        while len(self._buf) >= self.rate:
            self._absorb_block(bytes(self._buf[: self.rate]))
            del self._buf[: self.rate]

    def _absorb_block(self, block: bytes) -> None:
        for i in range(self.rate // 8):
            self._state[i] ^= int.from_bytes(block[8 * i : 8 * i + 8], "little")
        self._state = keccak_p(self._state, self.rounds)

    def _pad_and_finish(self) -> None:
        block = bytearray(self._buf)
        del self._buf[:]
        block.append(self.domain)
        block += b"\x00" * (self.rate - len(block))
        block[self.rate - 1] ^= 0x80
        for i in range(self.rate // 8):
            self._state[i] ^= int.from_bytes(block[8 * i : 8 * i + 8], "little")
        self._squeezing = True

    def squeeze(self, n: int) -> bytes:
        if not self._squeezing:
            self._pad_and_finish()
        while len(self._out) < n:
            self._state = keccak_p(self._state, self.rounds)
            for i in range(self.rate // 8):
                self._out += self._state[i].to_bytes(8, "little")
        out = bytes(self._out[:n])
        del self._out[:n]
        return out


def turboshake128(message: bytes, domain: int, length: int) -> bytes:
    """One-shot TurboSHAKE128 (rate 168, 12 rounds)."""
    s = _Sponge(rate=168, rounds=12, domain=domain)
    s.update(message)
    return s.squeeze(length)


class Xof:
    """Streaming XOF interface per draft-irtf-cfrg-vdaf-08 §6.2."""

    SEED_SIZE: int

    def next(self, length: int) -> bytes:
        raise NotImplementedError

    def next_vec(self, field: type, length: int) -> List[int]:
        """Rejection-sample field elements from the stream (§6.2.1)."""
        mask = next_power_of_2(field.MODULUS) - 1
        vec: List[int] = []
        while len(vec) < length:
            x = int.from_bytes(self.next(field.ENCODED_SIZE), "little") & mask
            if x < field.MODULUS:
                vec.append(x)
        return vec

    @classmethod
    def expand_into_vec(
        cls, field: type, seed: bytes, dst: bytes, binder: bytes, length: int
    ) -> List[int]:
        return cls(seed, dst, binder).next_vec(field, length)


class XofTurboShake128(Xof):
    SEED_SIZE = 16

    def __init__(self, seed: bytes, dst: bytes, binder: bytes):
        if len(seed) != self.SEED_SIZE:
            raise ValueError("bad seed size")
        if len(dst) > 255:
            raise ValueError("dst too long")
        self._sponge = _Sponge(rate=168, rounds=12, domain=0x01)
        self._sponge.update(bytes([len(dst)]))
        self._sponge.update(dst)
        self._sponge.update(seed)
        self._sponge.update(binder)

    def next(self, length: int) -> bytes:
        return self._sponge.squeeze(length)

    @classmethod
    def expand_into_vec(
        cls, field: type, seed: bytes, dst: bytes, binder: bytes, length: int
    ) -> List[int]:
        # The C++ sponge (native.py) for the two moduli its rejection
        # sampler hardcodes — gated on the EXACT modulus, since another
        # 8- or 16-byte field must not be sampled against their bounds.
        if field.MODULUS in native.MODULI:
            out = native.next_vec(seed, dst, binder, field.MODULUS, length)
            if out is not None:
                return out
            native.note_fallback()
        return cls(seed, dst, binder).next_vec(field, length)


@lru_cache(maxsize=4096)
def _fixed_key_aes128(dst: bytes, binder: bytes) -> bytes:
    """The AES key of one (dst, binder) context: TurboSHAKE128 with domain
    byte 2 over len(dst) || dst || binder."""
    return turboshake128(bytes([len(dst)]) + dst + binder, 0x02, 16)


class XofFixedKeyAes128(Xof):
    """Fixed-key AES-128 XOF for the IDPF tree walk (draft-irtf-cfrg-vdaf-08
    §6.2.2): one TurboSHAKE-derived AES key per (dst, binder) context, then
    stream block i = hash_block(seed XOR le128(i)) with
    hash_block(x) = AES128(k, sigma(x)) XOR sigma(x),
    sigma(x_L || x_R) = x_R || (x_L XOR x_R).

    The block cipher is always the host's (``cryptography`` where it works,
    the numpy soft AES otherwise): this is the per-report oracle; the
    batched walk runs its AES on the card (``ops/aes.py``)."""

    SEED_SIZE = 16

    def __init__(self, seed: bytes, dst: bytes, binder: bytes):
        from .utils.softaes import aes128_ecb_encryptor

        if len(seed) != self.SEED_SIZE:
            raise ValueError("bad seed size")
        if len(dst) > 255:
            raise ValueError("dst too long")
        # the key depends only on (dst, binder): two values per report for
        # a whole IDPF walk, so the TurboSHAKE derivation is cached
        self._enc = aes128_ecb_encryptor(_fixed_key_aes128(dst, binder))
        self._seed = seed
        self._index = 0
        self._buf = b""

    def _hash_block(self, x: bytes) -> bytes:
        sigma = x[8:] + bytes(a ^ b for a, b in zip(x[:8], x[8:]))
        return bytes(a ^ b for a, b in zip(self._enc.update(sigma), sigma))

    def next(self, length: int) -> bytes:
        while len(self._buf) < length:
            block = bytes(a ^ b for a, b in zip(self._seed, self._index.to_bytes(16, "little")))
            self._buf += self._hash_block(block)
            self._index += 1
        out, self._buf = self._buf[:length], self._buf[length:]
        return out


class XofHmacSha256Aes128(Xof):
    """libprio-rs XofHmacSha256Aes128 (non-standard; Daphne interop): HMAC-
    SHA256 over len(dst) || dst || binder keyed by the seed gives an AES-128
    key and IV, and the stream is AES-128-CTR of zeros."""

    SEED_SIZE = 32

    def __init__(self, seed: bytes, dst: bytes, binder: bytes):
        import hashlib
        import hmac

        from .utils.softaes import aes128_ctr_encryptor

        if len(seed) != self.SEED_SIZE:
            raise ValueError("bad seed size")
        if len(dst) > 255:
            raise ValueError("dst too long")
        mac = hmac.new(seed, digestmod=hashlib.sha256)
        mac.update(bytes([len(dst)]))
        mac.update(dst)
        mac.update(binder)
        key_block = mac.digest()
        # `cryptography`'s AES-NI CTR where it works, the numpy soft AES
        # otherwise
        self._enc = aes128_ctr_encryptor(key_block[:16], key_block[16:])

    def next(self, length: int) -> bytes:
        return self._enc.update(b"\x00" * length)
