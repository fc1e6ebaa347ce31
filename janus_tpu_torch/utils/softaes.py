"""Pure-numpy AES-128-ECB encryption: the `cryptography`-less fallback.

In the port this is the block cipher under ``utils/gcm.py``'s AES-GCM
fallback, which HPKE and the datastore's ``Crypter`` run on when the
`cryptography` package is absent or not functional, and under the host
walk of Poplar1's IDPF (the reference the card walk is held against): a
vectorized table-based AES encryptor over (N, 16)
u8 blocks, and a per-report multikey form over (B, K, 16).  The card
walk's AES is ``ops/aes.py``.

Performance posture: numpy table lookups run the whole batch per round
(~20 vector ops per 10-round block set), plenty for tests and scaled
bench rows.  Production hosts install `cryptography` (AES-NI at GB/s) and
never reach this path.

Correctness is anchored to the FIPS-197 appendix C.1 vector at import
time (a table typo must fail loudly, never walk a wrong tree).
"""

from __future__ import annotations

import numpy as np

# FIPS-197 S-box, generated from the GF(2^8) inverse + affine map so the
# table cannot drift from the spec by a transcription typo.
def _build_sbox() -> np.ndarray:
    # multiplicative inverse in GF(2^8) mod x^8+x^4+x^3+x+1
    exp = [0] * 512
    log = [0] * 256
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        # multiply by generator 0x03
        x ^= ((x << 1) ^ (0x1B if x & 0x80 else 0)) & 0xFF
    for i in range(255, 512):
        exp[i] = exp[i - 255]
    sbox = np.zeros(256, dtype=np.uint8)
    for v in range(256):
        inv = 0 if v == 0 else exp[255 - log[v]]
        b = inv
        res = 0x63
        for _ in range(4):
            b = ((b << 1) | (b >> 7)) & 0xFF
            res ^= b
        sbox[v] = res ^ inv
    return sbox


_SBOX = _build_sbox()
_MUL2 = np.array(
    [((v << 1) ^ (0x1B if v & 0x80 else 0)) & 0xFF for v in range(256)],
    dtype=np.uint8,
)
_MUL3 = _MUL2 ^ np.arange(256, dtype=np.uint8)
#: ShiftRows as a flat-index permutation: byte i sits at (row=i%4,
#: col=i//4); row r rotates left by r columns.
_SHIFT = np.array(
    [(i % 4) + 4 * (((i // 4) + (i % 4)) % 4) for i in range(16)], dtype=np.intp
)
#: FIPS-197 appendix C.1: AES-128 of this plaintext under key 00..0f
_C1_PLAIN = "00112233445566778899aabbccddeeff"
_C1_CIPHER = "69c4e0d86a7b0430d8cdb78070b4c55a"
_RCON = (0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40, 0x80, 0x1B, 0x36)


def _expand_key(key: bytes) -> np.ndarray:
    """(11, 16) u8 round keys."""
    if len(key) != 16:
        raise ValueError("AES-128 key must be 16 bytes")
    words = [list(key[4 * i : 4 * i + 4]) for i in range(4)]
    sbox = _SBOX
    for i in range(4, 44):
        t = list(words[i - 1])
        if i % 4 == 0:
            t = t[1:] + t[:1]
            t = [int(sbox[b]) for b in t]
            t[0] ^= _RCON[i // 4 - 1]
        words.append([a ^ b for a, b in zip(words[i - 4], t)])
    flat = [b for w in words for b in w]
    return np.array(flat, dtype=np.uint8).reshape(11, 16)


def _expand_key_256(key: bytes) -> np.ndarray:
    """(15, 16) u8 round keys (AES-256: 8-word key, 14 rounds)."""
    if len(key) != 32:
        raise ValueError("AES-256 key must be 32 bytes")
    words = [list(key[4 * i : 4 * i + 4]) for i in range(8)]
    sbox = _SBOX
    for i in range(8, 60):
        t = list(words[i - 1])
        if i % 8 == 0:
            t = t[1:] + t[:1]
            t = [int(sbox[b]) for b in t]
            t[0] ^= _RCON[i // 8 - 1]
        elif i % 8 == 4:
            t = [int(sbox[b]) for b in t]
        words.append([a ^ b for a, b in zip(words[i - 8], t)])
    flat = [b for w in words for b in w]
    return np.array(flat, dtype=np.uint8).reshape(15, 16)


def expand_key_any(key: bytes) -> np.ndarray:
    """Round keys for a 16- or 32-byte key; ``encrypt_blocks`` derives the
    round count from the schedule's first-axis length."""
    return _expand_key(key) if len(key) == 16 else _expand_key_256(key)


def _mix_columns(s: np.ndarray) -> np.ndarray:
    """(N, 16) -> (N, 16); state reshaped (N, 4 cols, 4 rows)."""
    a = s.reshape(-1, 4, 4)
    a0, a1, a2, a3 = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    out = np.empty_like(a)
    out[..., 0] = _MUL2[a0] ^ _MUL3[a1] ^ a2 ^ a3
    out[..., 1] = a0 ^ _MUL2[a1] ^ _MUL3[a2] ^ a3
    out[..., 2] = a0 ^ a1 ^ _MUL2[a2] ^ _MUL3[a3]
    out[..., 3] = _MUL3[a0] ^ a1 ^ a2 ^ _MUL2[a3]
    return out.reshape(-1, 16)


def encrypt_blocks(round_keys: np.ndarray, blocks: np.ndarray) -> np.ndarray:
    """AES encrypt (N, 16) u8 blocks with precomputed round keys; the
    round count comes from the schedule (11 keys = AES-128, 15 = AES-256)."""
    rounds = len(round_keys) - 1
    s = blocks ^ round_keys[0]
    for rnd in range(1, rounds):
        s = _SBOX[s][:, _SHIFT]
        s = _mix_columns(s) ^ round_keys[rnd]
    return _SBOX[s][:, _SHIFT] ^ round_keys[rounds]


def encrypt_blocks_multikey(round_keys: np.ndarray, blocks: np.ndarray) -> np.ndarray:
    """AES-128 with one key schedule a report: (B, 11, 16) u8 round keys over
    (B, K, 16) u8 blocks -> (B, K, 16), all reports in one numpy pass."""
    B, K = blocks.shape[0], blocks.shape[1]
    rk = np.repeat(np.asarray(round_keys, dtype=np.uint8), K, axis=0)  # (B*K, 11, 16): a block's schedule
    s = blocks.reshape(B * K, 16) ^ rk[:, 0]
    for rnd in range(1, 10):
        s = _SBOX[s][:, _SHIFT]
        s = _mix_columns(s) ^ rk[:, rnd]
    return (_SBOX[s][:, _SHIFT] ^ rk[:, 10]).reshape(B, K, 16)


class SoftAesCtr:
    """Duck-type of ``Cipher(AES(key), CTR(iv)).encryptor()``: stateful
    keystream over a big-endian 128-bit counter starting at ``iv`` —
    exactly the construction XofHmacSha256Aes128 streams from."""

    def __init__(self, key: bytes, iv: bytes):
        if len(iv) != 16:
            raise ValueError("CTR IV must be 16 bytes")
        self._rk = expand_key_any(key)
        self._counter = int.from_bytes(iv, "big")
        self._buf = b""

    def update(self, data: bytes) -> bytes:
        need = len(data) - len(self._buf)
        if need > 0:
            nblocks = (need + 15) // 16
            ctrs = np.frombuffer(
                b"".join(
                    ((self._counter + i) % (1 << 128)).to_bytes(16, "big")
                    for i in range(nblocks)
                ),
                dtype=np.uint8,
            ).reshape(-1, 16)
            self._counter = (self._counter + nblocks) % (1 << 128)
            self._buf += encrypt_blocks(self._rk, ctrs).tobytes()
        stream, self._buf = self._buf[: len(data)], self._buf[len(data) :]
        return bytes(a ^ b for a, b in zip(data, stream))


#: cached functional-Cipher probe (None = not yet probed): the
#: dev-container crypto shim imports fine but miscomputes, so the real
#: library is trusted only after a known-answer check, paid once.
_CTR_FUNCTIONAL = None


def _ctr_functional() -> bool:
    global _CTR_FUNCTIONAL
    if _CTR_FUNCTIONAL is None:
        try:
            from cryptography.hazmat.primitives.ciphers import (
                Cipher,
                algorithms,
                modes,
            )

            probe = Cipher(
                algorithms.AES(b"\x00" * 16), modes.CTR(b"\x00" * 16)
            ).encryptor()
            # AES-128-CTR of zeros at iv=0 starts with E(K, 0) (FIPS-197)
            _CTR_FUNCTIONAL = probe.update(b"\x00" * 16) == bytes.fromhex(
                "66e94bd4ef8a2c3b884cfa59ca342b2e"
            )
        except Exception:
            _CTR_FUNCTIONAL = False
    return _CTR_FUNCTIONAL


def aes128_ctr_encryptor(key: bytes, iv: bytes):
    """An AES-128-CTR encryptor: `cryptography`'s Cipher when functional
    (AES-NI), the numpy fallback otherwise — the seam XofHmacSha256Aes128
    streams through, so HMAC-XOF VDAFs run on cryptography-less hosts."""
    if _ctr_functional():
        from cryptography.hazmat.primitives.ciphers import Cipher, algorithms, modes

        return Cipher(algorithms.AES(key), modes.CTR(iv)).encryptor()
    return SoftAesCtr(key, iv)


#: cached known-answer probe of `cryptography`'s AES-ECB (None = not yet)
_ECB_FUNCTIONAL = None


def _ecb_functional() -> bool:
    global _ECB_FUNCTIONAL
    if _ECB_FUNCTIONAL is None:
        try:
            from cryptography.hazmat.primitives.ciphers import Cipher, algorithms, modes

            probe = Cipher(algorithms.AES(bytes(range(16))), modes.ECB()).encryptor()
            _ECB_FUNCTIONAL = probe.update(bytes.fromhex(_C1_PLAIN)) == bytes.fromhex(_C1_CIPHER)
        except Exception:
            _ECB_FUNCTIONAL = False
    return _ECB_FUNCTIONAL


def aes128_ecb_encryptor(key: bytes):
    """A host AES-128-ECB encryptor (``.update(bytes) -> bytes``):
    `cryptography`'s when its Cipher passes the FIPS-197 known answer, the
    numpy ``SoftAes128Ecb`` otherwise.  The per-report oracle
    (``XofFixedKeyAes128``) and the batched host walk, the reference the
    card walk is held against, run on it."""
    if _ecb_functional():
        from cryptography.hazmat.primitives.ciphers import Cipher, algorithms, modes

        return Cipher(algorithms.AES(key), modes.ECB()).encryptor()
    return SoftAes128Ecb(key)


class SoftAes128Ecb:
    """Duck-type of ``Cipher(AES(key), ECB()).encryptor()``: stateless ECB,
    so ``update`` just encrypts every 16-byte block of its input."""

    def __init__(self, key: bytes):
        self._rk = _expand_key(key)

    def update(self, data: bytes) -> bytes:
        if len(data) % 16:
            raise ValueError("ECB input must be a multiple of 16 bytes")
        if not data:
            return b""
        blocks = np.frombuffer(data, dtype=np.uint8).reshape(-1, 16)
        return encrypt_blocks(self._rk, blocks).tobytes()


# -- import-time anchor (FIPS-197 C.1) ---------------------------------------
_vec = SoftAes128Ecb(bytes(range(16))).update(bytes.fromhex(_C1_PLAIN))
if _vec != bytes.fromhex(_C1_CIPHER):  # pragma: no cover
    raise AssertionError("softaes self-test failed (table corruption)")
del _vec
