"""Pure-Python/numpy AEADs: the `cryptography`-less fallback tier.

core/hpke.py and datastore/crypter.py need exactly three AEAD
constructions from the `cryptography` package — AES-128-GCM, AES-256-GCM
and ChaCha20-Poly1305 — plus nothing else from its hazmat layer that the
soft fallbacks in this package cannot provide (softaes supplies AES, and
utils/purecurves.py supplies the DH curves).  Dev containers without
`cryptography` (or with a nonfunctional test shim) used to lose the whole
HPKE tier, the datastore's column encryption, and with them most of the
service/chaos suites, to those imports.  This module is the
gate-don't-skip answer for the AEAD half:

* :class:`SoftAesGcm` — AES-GCM (128- and 256-bit keys) over the
  vectorized table AES in utils/softaes.py, with a 4-bit-table GHASH in
  plain Python ints (SP 800-38D right-shift construction).
* :class:`SoftChaCha20Poly1305` — RFC 8439 ChaCha20-Poly1305 in plain
  Python.
* :func:`aesgcm` / :func:`chacha20poly1305` — the backend seam: prefer
  `cryptography`'s implementations whenever they are importable AND
  functional (the functional probe matters: dev-container crypto shims
  import fine but compute garbage), soft fallbacks otherwise.

Performance posture: the fallbacks run at ~0.1-1 ms per small message —
plenty for tests, soak harnesses and scaled bench rows.  Production
hosts install `cryptography` (AES-NI / vectorized ChaCha at GB/s) and
never reach this path.  None of the fallback code is constant-time; it
must never be preferred over a functional `cryptography`.

Correctness is anchored at import time to NIST GCM test case 4 and the
RFC 8439 §2.8.2 vector (a table or rotation bug must fail loudly, never
silently mis-seal a share), and the RFC 9180 KAT suite in tests/test_hpke.py
runs every supported HPKE suite through whichever backend this seam picks.
"""

from __future__ import annotations

import struct
from typing import Optional

import numpy as np

from .softaes import encrypt_blocks, expand_key_any


class InvalidTagError(Exception):
    """AEAD authentication failed (the fallback's InvalidTag analog)."""


#: Exception types that mean "authentication failed" across both AEAD
#: backends — catch sites (Crypter key rotation, HPKE open) must treat
#: the real library's InvalidTag and the fallback's identically.
try:  # pragma: no cover - exercised only where cryptography is installed
    from cryptography.exceptions import InvalidTag as _RealInvalidTag

    INVALID_TAG_EXCEPTIONS = (InvalidTagError, _RealInvalidTag)
except ImportError:  # pragma: no cover
    INVALID_TAG_EXCEPTIONS = (InvalidTagError,)


# -- GHASH (SP 800-38D §6.3, right-shift table construction) -----------------

_R = 0xE1 << 120  # the GCM reduction polynomial, string-order


def _gf_shift_right(v: int) -> int:
    """Multiply by x in the GCM bit order (one right shift + reduce)."""
    if v & 1:
        return (v >> 1) ^ _R
    return v >> 1


class GhashKey:
    """H with a 16-entry (4-bit Shoup) multiplication table: ~32 table
    lookups + shifts per block, all plain Python ints."""

    def __init__(self, h: int):
        self.h = h
        # table[n] = (n as a 4-bit string-order prefix) * H: bit 3 of n is
        # the FIRST string bit, so table[0b1000] == H and each lower bit
        # is H shifted one further right.
        table = [0] * 16
        table[0b1000] = h
        for i in (0b0100, 0b0010, 0b0001):
            table[i] = _gf_shift_right(table[i << 1])
        for n in range(16):
            if n not in (0, 1, 2, 4, 8):
                table[n] = table[n & 8] ^ table[n & 4] ^ table[n & 2] ^ table[n & 1]
        self._table = table
        # Horner-by-nibble shifts the accumulated product right by 4 each
        # step; red[n] is the reduction term for a dropped low nibble n.
        red = [0] * 16
        for n in range(1, 16):
            v = n
            for _ in range(4):
                v = _gf_shift_right(v)
            red[n] = v
        self._red = red

    def mult(self, x: int) -> int:
        """x * H in GF(2^128).  The STRING-order head nibble (the
        integer's top bits) carries x^0 and the tail x^124, so Horner
        runs from the integer's low bits upward — each step multiplies
        the accumulated tail-side sum by x^4 (a 4-bit right shift with
        reduction) before adding the next nibble's table entry."""
        table, red = self._table, self._red
        z = 0
        for shift in range(0, 128, 4):
            if shift:
                z = (z >> 4) ^ red[z & 0xF]
            z ^= table[(x >> shift) & 0xF]
        return z

    def ghash(self, data: bytes) -> int:
        """GHASH over ``data`` (length must be a block multiple)."""
        assert len(data) % 16 == 0
        y = 0
        for off in range(0, len(data), 16):
            y = self.mult(y ^ int.from_bytes(data[off : off + 16], "big"))
        return y


def _gcm_pad(aad: bytes, ct: bytes) -> bytes:
    """aad || pad || ct || pad || bitlen(aad) || bitlen(ct)."""
    out = aad + b"\x00" * (-len(aad) % 16) + ct + b"\x00" * (-len(ct) % 16)
    return out + struct.pack(">QQ", 8 * len(aad), 8 * len(ct))


class SoftAesGcm:
    """Duck-type of ``cryptography``'s AESGCM over softaes + GhashKey.
    Accepts 16- or 32-byte keys; nonces must be 12 bytes (the only length
    HPKE/DAP and the datastore Crypter ever use)."""

    def __init__(self, key: bytes):
        if len(key) not in (16, 32):
            raise ValueError("AES-GCM key must be 16 or 32 bytes")
        self._rk = expand_key_any(key)
        h = encrypt_blocks(self._rk, np.zeros((1, 16), dtype=np.uint8)).tobytes()
        self._ghash = GhashKey(int.from_bytes(h, "big"))

    def _keystream(self, j0: bytes, nblocks: int) -> bytes:
        """E(K, J0), E(K, inc32(J0)), ...: block 0 is the tag mask."""
        prefix = j0[:12]
        ctr0 = struct.unpack(">I", j0[12:])[0]
        blocks = np.frombuffer(
            b"".join(
                prefix + struct.pack(">I", (ctr0 + i) & 0xFFFFFFFF)
                for i in range(nblocks)
            ),
            dtype=np.uint8,
        ).reshape(-1, 16)
        return encrypt_blocks(self._rk, blocks).tobytes()

    def _tag(self, j0: bytes, aad: bytes, ct: bytes, tag_mask: bytes) -> bytes:
        s = self._ghash.ghash(_gcm_pad(aad, ct))
        return (s ^ int.from_bytes(tag_mask, "big")).to_bytes(16, "big")

    def encrypt(self, nonce: bytes, data: bytes, aad: Optional[bytes]) -> bytes:
        if len(nonce) != 12:
            raise ValueError("soft AES-GCM supports 12-byte nonces only")
        aad = aad or b""
        nblocks = (len(data) + 15) // 16
        j0 = nonce + b"\x00\x00\x00\x01"
        stream = self._keystream(j0, 1 + nblocks)
        ct = bytes(a ^ b for a, b in zip(data, stream[16:]))
        return ct + self._tag(j0, aad, ct, stream[:16])

    def decrypt(self, nonce: bytes, data: bytes, aad: Optional[bytes]) -> bytes:
        if len(nonce) != 12:
            raise ValueError("soft AES-GCM supports 12-byte nonces only")
        if len(data) < 16:
            raise InvalidTagError("ciphertext shorter than the tag")
        aad = aad or b""
        ct, tag = data[:-16], data[-16:]
        nblocks = (len(ct) + 15) // 16
        j0 = nonce + b"\x00\x00\x00\x01"
        stream = self._keystream(j0, 1 + nblocks)
        if self._tag(j0, aad, ct, stream[:16]) != tag:
            raise InvalidTagError("AES-GCM tag mismatch")
        return bytes(a ^ b for a, b in zip(ct, stream[16:]))


# -- ChaCha20-Poly1305 (RFC 8439) --------------------------------------------


def _rotl32(v: int, n: int) -> int:
    return ((v << n) | (v >> (32 - n))) & 0xFFFFFFFF


def _chacha20_block(key_words, counter: int, nonce_words) -> bytes:
    state = [
        0x61707865, 0x3320646E, 0x79622D32, 0x6B206574,
        *key_words,
        counter, *nonce_words,
    ]
    x = list(state)

    def qr(a, b, c, d):
        x[a] = (x[a] + x[b]) & 0xFFFFFFFF; x[d] = _rotl32(x[d] ^ x[a], 16)
        x[c] = (x[c] + x[d]) & 0xFFFFFFFF; x[b] = _rotl32(x[b] ^ x[c], 12)
        x[a] = (x[a] + x[b]) & 0xFFFFFFFF; x[d] = _rotl32(x[d] ^ x[a], 8)
        x[c] = (x[c] + x[d]) & 0xFFFFFFFF; x[b] = _rotl32(x[b] ^ x[c], 7)

    for _ in range(10):
        qr(0, 4, 8, 12); qr(1, 5, 9, 13); qr(2, 6, 10, 14); qr(3, 7, 11, 15)
        qr(0, 5, 10, 15); qr(1, 6, 11, 12); qr(2, 7, 8, 13); qr(3, 4, 9, 14)
    return struct.pack(
        "<16I", *(((a + b) & 0xFFFFFFFF) for a, b in zip(x, state))
    )


def _chacha20_xor(key: bytes, counter: int, nonce: bytes, data: bytes) -> bytes:
    key_words = struct.unpack("<8I", key)
    nonce_words = struct.unpack("<3I", nonce)
    out = bytearray()
    for off in range(0, len(data), 64):
        block = _chacha20_block(key_words, counter + off // 64, nonce_words)
        chunk = data[off : off + 64]
        out += bytes(a ^ b for a, b in zip(chunk, block))
    return bytes(out)


def _poly1305(key: bytes, msg: bytes) -> bytes:
    r = int.from_bytes(key[:16], "little") & 0x0FFFFFFC0FFFFFFC0FFFFFFC0FFFFFFF
    s = int.from_bytes(key[16:], "little")
    p = (1 << 130) - 5
    acc = 0
    for off in range(0, len(msg), 16):
        chunk = msg[off : off + 16]
        n = int.from_bytes(chunk, "little") + (1 << (8 * len(chunk)))
        acc = ((acc + n) * r) % p
    return ((acc + s) & ((1 << 128) - 1)).to_bytes(16, "little")


class SoftChaCha20Poly1305:
    """Duck-type of ``cryptography``'s ChaCha20Poly1305 (RFC 8439 AEAD)."""

    def __init__(self, key: bytes):
        if len(key) != 32:
            raise ValueError("ChaCha20-Poly1305 key must be 32 bytes")
        self._key = key

    def _mac(self, nonce: bytes, aad: bytes, ct: bytes) -> bytes:
        otk = _chacha20_block(
            struct.unpack("<8I", self._key), 0, struct.unpack("<3I", nonce)
        )[:32]
        msg = (
            aad + b"\x00" * (-len(aad) % 16)
            + ct + b"\x00" * (-len(ct) % 16)
            + struct.pack("<QQ", len(aad), len(ct))
        )
        return _poly1305(otk, msg)

    def encrypt(self, nonce: bytes, data: bytes, aad: Optional[bytes]) -> bytes:
        if len(nonce) != 12:
            raise ValueError("ChaCha20-Poly1305 nonce must be 12 bytes")
        aad = aad or b""
        ct = _chacha20_xor(self._key, 1, nonce, data)
        return ct + self._mac(nonce, aad, ct)

    def decrypt(self, nonce: bytes, data: bytes, aad: Optional[bytes]) -> bytes:
        if len(nonce) != 12:
            raise ValueError("ChaCha20-Poly1305 nonce must be 12 bytes")
        if len(data) < 16:
            raise InvalidTagError("ciphertext shorter than the tag")
        aad = aad or b""
        ct, tag = data[:-16], data[-16:]
        if self._mac(nonce, aad, ct) != tag:
            raise InvalidTagError("Poly1305 tag mismatch")
        return _chacha20_xor(self._key, 1, nonce, ct)


# -- the backend seam ---------------------------------------------------------


def _probe_real_cryptography() -> bool:
    """Is a FUNCTIONAL `cryptography` present?  Known-answer probed for
    EVERY primitive this flag gates — AES-GCM (NIST test case 1),
    ChaCha20-Poly1305 (RFC 8439), X25519 (RFC 7748 §6.1), and P-256
    (NIST CAVP ECDH) — because a dev-container shim may fake them
    independently; one real primitive must not vouch for a garbage
    curve.  All-or-nothing: any failing probe lands the whole suite on
    the soft fallbacks."""
    try:
        from cryptography.hazmat.primitives.asymmetric import ec
        from cryptography.hazmat.primitives.asymmetric.x25519 import (
            X25519PrivateKey,
            X25519PublicKey,
        )
        from cryptography.hazmat.primitives.ciphers.aead import (
            AESGCM,
            ChaCha20Poly1305,
        )

        if AESGCM(b"\x00" * 16).encrypt(b"\x00" * 12, b"", b"") != bytes.fromhex(
            "58e2fccefa7e3061367f1d57a4e7455a"
        ):
            return False
        if ChaCha20Poly1305(b"\x00" * 32).encrypt(
            b"\x00" * 12, b"", b""
        ) != bytes.fromhex("4eb972c9a8fb3a1b382bb4d36f5ffad1"):
            return False
        # X25519: RFC 7748 §6.1 — K = X25519(a, X25519(b, 9))
        a = bytes.fromhex(
            "77076d0a7318a57d3c16c17251b26645df4c2f87ebc0992ab177fba51db92c2a"
        )
        b_pub = bytes.fromhex(
            "de9edb7d7b7dc1b4d35b61c2ece435373f8343c85b78674dadfc7e146f882b4f"
        )
        if X25519PrivateKey.from_private_bytes(a).exchange(
            X25519PublicKey.from_public_bytes(b_pub)
        ) != bytes.fromhex(
            "4a5d9d5ba4ce2de1728e3bf480350f25e07e21c947d19e3376f09b3c1e161742"
        ):
            return False
        # P-256: NIST CAVP ECDH vector (count 0)
        d = 0x7D7DC5F71EB29DDAF80D6214632EEAE03D9058AF1FB6D22ED80BADB62BC1A534
        qx = 0x700C48F77F56584C5CC632CA65640DB91B6BACCE3A4DF6B42CE7CC838833D287
        qy = 0xDB71E509E3FD9B060DDB20BA5C51DCC5948D46FBF640DFE0441782CAB85FA4AC
        peer = ec.EllipticCurvePublicNumbers(qx, qy, ec.SECP256R1()).public_key()
        shared = ec.derive_private_key(d, ec.SECP256R1()).exchange(ec.ECDH(), peer)
        return shared == (
            0x46FC62106420FF012E54A434FBDD2D25CCC5852060561E68040DD7778997BD7B
        ).to_bytes(32, "big")
    except Exception:
        return False


HAVE_FUNCTIONAL_CRYPTOGRAPHY = _probe_real_cryptography()


def aesgcm(key: bytes):
    """An AES-GCM AEAD (.encrypt/.decrypt(nonce, data, aad)): the real
    library when functional, the soft fallback otherwise."""
    if HAVE_FUNCTIONAL_CRYPTOGRAPHY:
        from cryptography.hazmat.primitives.ciphers.aead import AESGCM

        return AESGCM(key)
    return SoftAesGcm(key)


def chacha20poly1305(key: bytes):
    """A ChaCha20-Poly1305 AEAD, same seam as :func:`aesgcm`."""
    if HAVE_FUNCTIONAL_CRYPTOGRAPHY:
        from cryptography.hazmat.primitives.ciphers.aead import ChaCha20Poly1305

        return ChaCha20Poly1305(key)
    return SoftChaCha20Poly1305(key)


# -- import-time anchors ------------------------------------------------------
# NIST GCM test case 4 (AES-128): a GHASH table or counter bug must fail
# loudly at import, never mis-open a share.
_k = bytes.fromhex("feffe9928665731c6d6a8f9467308308")
_gcm = SoftAesGcm(_k)
_ct = _gcm.encrypt(
    bytes.fromhex("cafebabefacedbaddecaf888"),
    bytes.fromhex(
        "d9313225f88406e5a55909c5aff5269a86a7a9531534f7da2e4c303d8a318a72"
        "1c3c0c95956809532fcf0e2449a6b525b16aedf5aa0de657ba637b39"
    ),
    bytes.fromhex("feedfacedeadbeeffeedfacedeadbeefabaddad2"),
)
if _ct != bytes.fromhex(
    "42831ec2217774244b7221b784d0d49ce3aa212f2c02a4e035c17e2329aca12e"
    "21d514b25466931c7d8f6a5aac84aa051ba30b396a0aac973d58e091"
    "5bc94fbc3221a5db94fae95ae7121a47"
):  # pragma: no cover
    raise AssertionError("soft AES-GCM self-test failed (GHASH/CTR corruption)")
# RFC 8439 §2.8.2
_cc = SoftChaCha20Poly1305(bytes(range(0x80, 0xA0)))
_ct = _cc.encrypt(
    bytes.fromhex("070000004041424344454647"),
    b"Ladies and Gentlemen of the class of '99: If I could offer you "
    b"only one tip for the future, sunscreen would be it.",
    bytes.fromhex("50515253c0c1c2c3c4c5c6c7"),
)
if _ct[-16:] != bytes.fromhex("1ae10b594f09e26a7e902ecbd0600691"):  # pragma: no cover
    raise AssertionError("soft ChaCha20-Poly1305 self-test failed")
del _k, _gcm, _cc, _ct
