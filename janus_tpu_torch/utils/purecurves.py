"""Pure-Python ECDH curves: the `cryptography`-less KEM fallback.

core/hpke.py's two KEMs need exactly two primitives from the
`cryptography` package: X25519 (RFC 7748) and P-256 ECDH.  This module
supplies both in plain Python ints so the HPKE tier — and everything
downstream of it (client report sealing, upload opens, the RFC 9180 KAT
suite) — runs on hosts without the wheel.

* :func:`x25519` — the RFC 7748 §5 Montgomery ladder (constant
  structure, not constant time).
* :func:`p256_ecdh` / :func:`p256_public` — short-Weierstrass scalar
  multiplication in Jacobian coordinates with a single final inversion,
  X9.62 uncompressed-point encoding, and on-curve validation of peer
  points (an off-curve point must fail exactly like the real library's
  ``from_encoded_point``).

Performance posture: a scalar multiplication costs single-digit
milliseconds — fine for tests, soaks, and scaled bench rows; production
hosts install `cryptography` and never reach this path.  NONE of this is
constant-time; the functional-probe seam in core/hpke.py prefers the
real library whenever it actually works.

Correctness is anchored by the RFC 7748 §5.2 and NIST CAVP ECDH vectors
in tests/test_hpke.py's KAT suite (every supported HPKE suite exercises
decap/encap through whichever backend the seam picks).
"""

from __future__ import annotations

# -- X25519 (RFC 7748) --------------------------------------------------------

_P25519 = 2**255 - 19
_A24 = 121665


def _clamp(k: bytes) -> int:
    a = bytearray(k)
    a[0] &= 248
    a[31] &= 127
    a[31] |= 64
    return int.from_bytes(a, "little")


def x25519(scalar: bytes, u: bytes) -> bytes:
    """RFC 7748 §5 X25519(k, u): the Montgomery ladder."""
    if len(scalar) != 32 or len(u) != 32:
        raise ValueError("X25519 scalar and u-coordinate must be 32 bytes")
    k = _clamp(scalar)
    # mask the high bit of u (RFC 7748: the top bit is ignored)
    x1 = int.from_bytes(u, "little") & ((1 << 255) - 1)
    p = _P25519
    x2, z2, x3, z3 = 1, 0, x1, 1
    swap = 0
    for t in range(254, -1, -1):
        k_t = (k >> t) & 1
        if swap ^ k_t:
            x2, x3 = x3, x2
            z2, z3 = z3, z2
        swap = k_t
        a = (x2 + z2) % p
        aa = a * a % p
        b = (x2 - z2) % p
        bb = b * b % p
        e = (aa - bb) % p
        c = (x3 + z3) % p
        d = (x3 - z3) % p
        da = d * a % p
        cb = c * b % p
        x3 = (da + cb) % p
        x3 = x3 * x3 % p
        z3 = (da - cb) % p
        z3 = x1 * (z3 * z3) % p
        x2 = aa * bb % p
        z2 = e * (aa + _A24 * e) % p
    if swap:
        x2, z2 = x3, z3
    return (x2 * pow(z2, p - 2, p) % p).to_bytes(32, "little")


def x25519_public(scalar: bytes) -> bytes:
    """Public key = X25519(k, 9)."""
    return x25519(scalar, (9).to_bytes(32, "little"))


# -- P-256 (secp256r1) --------------------------------------------------------

_P256_P = 0xFFFFFFFF00000001000000000000000000000000FFFFFFFFFFFFFFFFFFFFFFFF
_P256_A = _P256_P - 3
_P256_B = 0x5AC635D8AA3A93E7B3EBBD55769886BC651D06B0CC53B0F63BCE3C3E27D2604B
_P256_N = 0xFFFFFFFF00000000FFFFFFFFFFFFFFFFBCE6FAADA7179E84F3B9CAC2FC632551
_P256_G = (
    0x6B17D1F2E12C4247F8BCE6E563A440F277037D812DEB33A0F4A13945D898C296,
    0x4FE342E2FE1A7F9B8EE7EB4A7C0F9E162BCE33576B315ECECBB6406837BF51F5,
)


def _jac_double(X, Y, Z, p=_P256_P):
    if Y == 0 or Z == 0:
        return 0, 1, 0
    # a = -3 doubling (dbl-2001-b)
    delta = Z * Z % p
    gamma = Y * Y % p
    beta = X * gamma % p
    alpha = 3 * (X - delta) * (X + delta) % p
    X3 = (alpha * alpha - 8 * beta) % p
    Z3 = ((Y + Z) * (Y + Z) - gamma - delta) % p
    Y3 = (alpha * (4 * beta - X3) - 8 * gamma * gamma) % p
    return X3, Y3, Z3


def _jac_add_affine(X1, Y1, Z1, x2, y2, p=_P256_P):
    """Mixed Jacobian + affine addition."""
    if Z1 == 0:
        return x2, y2, 1
    Z1Z1 = Z1 * Z1 % p
    U2 = x2 * Z1Z1 % p
    S2 = y2 * Z1 * Z1Z1 % p
    H = (U2 - X1) % p
    r = (S2 - Y1) % p
    if H == 0:
        if r == 0:
            return _jac_double(X1, Y1, Z1, p)
        return 0, 1, 0  # inverse points: infinity
    HH = H * H % p
    HHH = H * HH % p
    V = X1 * HH % p
    X3 = (r * r - HHH - 2 * V) % p
    Y3 = (r * (V - X3) - Y1 * HHH) % p
    Z3 = Z1 * H % p
    return X3, Y3, Z3


def _p256_scalar_mult(k: int, point):
    """k * point (affine in, affine out; None = infinity)."""
    x2, y2 = point
    X, Y, Z = 0, 1, 0
    for bit in range(k.bit_length() - 1, -1, -1):
        X, Y, Z = _jac_double(X, Y, Z)
        if (k >> bit) & 1:
            X, Y, Z = _jac_add_affine(X, Y, Z, x2, y2)
    if Z == 0:
        return None
    p = _P256_P
    zinv = pow(Z, p - 2, p)
    z2 = zinv * zinv % p
    return X * z2 % p, Y * z2 * zinv % p


def _p256_check_on_curve(x: int, y: int) -> None:
    p = _P256_P
    if not (0 <= x < p and 0 <= y < p) or (
        y * y - (x * x * x + _P256_A * x + _P256_B)
    ) % p != 0:
        raise ValueError("point is not on P-256")


def p256_decode_point(data: bytes):
    """X9.62 uncompressed point -> (x, y), validated on-curve."""
    if len(data) != 65 or data[0] != 4:
        raise ValueError("expected a 65-byte uncompressed P-256 point")
    x = int.from_bytes(data[1:33], "big")
    y = int.from_bytes(data[33:], "big")
    _p256_check_on_curve(x, y)
    return x, y


def p256_encode_point(point) -> bytes:
    x, y = point
    return b"\x04" + x.to_bytes(32, "big") + y.to_bytes(32, "big")


def p256_public(scalar: bytes) -> bytes:
    """Uncompressed public point for a 32-byte big-endian scalar."""
    k = int.from_bytes(scalar, "big") % _P256_N
    if k == 0:
        raise ValueError("P-256 private scalar is zero mod n")
    pt = _p256_scalar_mult(k, _P256_G)
    return p256_encode_point(pt)


def p256_ecdh(scalar: bytes, peer_point: bytes) -> bytes:
    """ECDH shared secret: the x-coordinate of k * peer, 32 bytes."""
    k = int.from_bytes(scalar, "big") % _P256_N
    if k == 0:
        raise ValueError("P-256 private scalar is zero mod n")
    pt = _p256_scalar_mult(k, p256_decode_point(peer_point))
    if pt is None:
        raise ValueError("P-256 ECDH produced the point at infinity")
    return pt[0].to_bytes(32, "big")
