"""RFC 9180 HPKE (base mode), host-side crypto shell.

The analog of the reference's wrapper over ``hpke-dispatch`` (reference:
core/src/hpke.rs:167 seal, :192 open, :212 keypair generation, :54-89
application-info labels).  DAP uses one-shot single-message contexts, so seal
creates a fresh context per call.

Supported suite matrix (all combinations):
  KEM:  DHKEM(X25519, HKDF-SHA256) 0x0020, DHKEM(P-256, HKDF-SHA256) 0x0010
  KDF:  HKDF-SHA256/384/512
  AEAD: AES-128-GCM, AES-256-GCM, ChaCha20-Poly1305

Anchored to the CFRG RFC 9180 test vectors in tests/test_hpke.py (vendored
data file: the same test-vectors.json the reference vendors at
core/src/test-vectors.json).
"""

from __future__ import annotations

import hashlib
import hmac as _hmac
import os
from dataclasses import dataclass, field
from typing import Optional, Tuple

try:
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.hazmat.primitives.asymmetric.x25519 import (
        X25519PrivateKey,
        X25519PublicKey,
    )
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM, ChaCha20Poly1305
    from cryptography.hazmat.primitives.serialization import (
        Encoding,
        NoEncryption,
        PrivateFormat,
        PublicFormat,
    )

    HAVE_CRYPTOGRAPHY = True
except ImportError:  # pragma: no cover - baked into the prod image
    # Import gate for environments without the ``cryptography`` wheel
    # (compute-only containers): this module — and everything that imports
    # it, e.g. the datastore and job drivers — stays importable; any
    # actual KEM/AEAD operation raises ModuleNotFoundError at call time.
    HAVE_CRYPTOGRAPHY = False

    class _MissingCryptography:
        """Defers the missing-dependency error from import to first use."""

        def __init__(self, name: str):
            self._name = name

        def __getattr__(self, item: str):
            if item.startswith("__"):
                raise AttributeError(item)
            return _MissingCryptography(f"{self._name}.{item}")

        def __call__(self, *args, **kwargs):
            raise ModuleNotFoundError(
                f"the 'cryptography' package is required for HPKE "
                f"(tried to call {self._name})"
            )

    ec = _MissingCryptography("ec")
    X25519PrivateKey = _MissingCryptography("X25519PrivateKey")
    X25519PublicKey = _MissingCryptography("X25519PublicKey")
    AESGCM = _MissingCryptography("AESGCM")
    ChaCha20Poly1305 = _MissingCryptography("ChaCha20Poly1305")
    Encoding = _MissingCryptography("Encoding")
    NoEncryption = _MissingCryptography("NoEncryption")
    PrivateFormat = _MissingCryptography("PrivateFormat")
    PublicFormat = _MissingCryptography("PublicFormat")

# De-shim: the HPKE tier no longer DIES without a functional
# `cryptography` — pure-Python RFC 7748 X25519 + P-256 ECDH
# (utils/purecurves.py) and soft AES-GCM / ChaCha20-Poly1305
# (utils/gcm.py) carry every supported suite, KAT-anchored by the same
# RFC 9180 vendored vectors.  HAVE_FUNCTIONAL_CRYPTOGRAPHY is a
# known-answer probe, not an import check: dev-container shims that
# import fine but compute garbage land on the fallbacks too.  The real
# library is preferred whenever it actually works (AES-NI, constant-time
# curves); the fallbacks are NOT constant-time and exist for dev/test
# hosts, never as a production preference.
from ..utils import purecurves as _curves
from ..utils.gcm import HAVE_FUNCTIONAL_CRYPTOGRAPHY
from ..utils.gcm import aesgcm as _aesgcm
from ..utils.gcm import chacha20poly1305 as _chacha20poly1305

from ..messages import (
    HpkeAeadId,
    HpkeCiphertext,
    HpkeConfig,
    HpkeKdfId,
    HpkeKemId,
    HpkePublicKey,
    Role,
)


class HpkeError(Exception):
    pass


class Label:
    """Message-specific application-info label (reference: core/src/hpke.rs:54)."""

    INPUT_SHARE = b"dap-09 input share"
    AGGREGATE_SHARE = b"dap-09 aggregate share"


@dataclass(frozen=True)
class HpkeApplicationInfo:
    """label || sender_role || recipient_role (reference: core/src/hpke.rs:75)."""

    raw: bytes

    @classmethod
    def new(cls, label: bytes, sender_role: Role, recipient_role: Role) -> "HpkeApplicationInfo":
        return cls(label + bytes([sender_role.value, recipient_role.value]))


# --- HKDF ------------------------------------------------------------------

_HASHES = {
    HpkeKdfId.HKDF_SHA256: hashlib.sha256,
    HpkeKdfId.HKDF_SHA384: hashlib.sha384,
    HpkeKdfId.HKDF_SHA512: hashlib.sha512,
}


def _hkdf_extract(hash_fn, salt: bytes, ikm: bytes) -> bytes:
    if not salt:
        salt = b"\x00" * hash_fn().digest_size
    return _hmac.new(salt, ikm, hash_fn).digest()


def _hkdf_expand(hash_fn, prk: bytes, info: bytes, length: int) -> bytes:
    out = b""
    t = b""
    i = 1
    while len(out) < length:
        t = _hmac.new(prk, t + info + bytes([i]), hash_fn).digest()
        out += t
        i += 1
    return out[:length]


def _labeled_extract(hash_fn, suite_id: bytes, salt: bytes, label: bytes, ikm: bytes) -> bytes:
    return _hkdf_extract(hash_fn, salt, b"HPKE-v1" + suite_id + label + ikm)


def _labeled_expand(hash_fn, suite_id: bytes, prk: bytes, label: bytes, info: bytes, length: int) -> bytes:
    return _hkdf_expand(
        hash_fn, prk, length.to_bytes(2, "big") + b"HPKE-v1" + suite_id + label + info, length
    )


# --- KEMs ------------------------------------------------------------------


class _X25519Kem:
    ID = HpkeKemId.X25519_HKDF_SHA256
    N_SECRET = 32
    N_PK = 32
    N_SK = 32
    _hash = hashlib.sha256

    @classmethod
    def _suite_id(cls) -> bytes:
        return b"KEM" + cls.ID.value.to_bytes(2, "big")

    @staticmethod
    def _exchange(sk_bytes: bytes, pk_bytes: bytes) -> bytes:
        if HAVE_FUNCTIONAL_CRYPTOGRAPHY:
            sk = X25519PrivateKey.from_private_bytes(sk_bytes)
            return sk.exchange(X25519PublicKey.from_public_bytes(pk_bytes))
        dh = _curves.x25519(sk_bytes, pk_bytes)
        # mirror the real library: an all-zero shared secret (small-order
        # peer point) is rejected, not silently key-scheduled
        if dh == b"\x00" * 32:
            raise ValueError("X25519 produced an all-zero shared secret")
        return dh

    @classmethod
    def generate_keypair(cls) -> Tuple[bytes, bytes]:
        if HAVE_FUNCTIONAL_CRYPTOGRAPHY:
            sk = X25519PrivateKey.generate()
            return (
                sk.private_bytes(Encoding.Raw, PrivateFormat.Raw, NoEncryption()),
                sk.public_key().public_bytes(Encoding.Raw, PublicFormat.Raw),
            )
        sk_bytes = os.urandom(32)
        return sk_bytes, _curves.x25519_public(sk_bytes)

    @classmethod
    def public_from_private(cls, sk_bytes: bytes) -> bytes:
        if HAVE_FUNCTIONAL_CRYPTOGRAPHY:
            sk = X25519PrivateKey.from_private_bytes(sk_bytes)
            return sk.public_key().public_bytes(Encoding.Raw, PublicFormat.Raw)
        return _curves.x25519_public(sk_bytes)

    @classmethod
    def _extract_and_expand(cls, dh: bytes, kem_context: bytes) -> bytes:
        suite = cls._suite_id()
        eae_prk = _labeled_extract(cls._hash, suite, b"", b"eae_prk", dh)
        return _labeled_expand(cls._hash, suite, eae_prk, b"shared_secret", kem_context, cls.N_SECRET)

    @classmethod
    def encap(cls, pk_r: bytes, ephemeral_sk: Optional[bytes] = None) -> Tuple[bytes, bytes]:
        """Returns (shared_secret, enc).  ephemeral_sk injectable for KATs."""
        sk_e_bytes = ephemeral_sk if ephemeral_sk is not None else os.urandom(32)
        enc = cls.public_from_private(sk_e_bytes)
        dh = cls._exchange(sk_e_bytes, pk_r)
        return cls._extract_and_expand(dh, enc + pk_r), enc

    @classmethod
    def decap(cls, enc: bytes, sk_r: bytes, pk_r: Optional[bytes] = None) -> bytes:
        """``pk_r`` (the recipient public key, which every HpkeKeypair
        already carries) skips re-deriving it from the private scalar —
        one whole ladder per open on the pure-Python path."""
        dh = cls._exchange(sk_r, enc)
        if pk_r is None:
            pk_r = cls.public_from_private(sk_r)
        return cls._extract_and_expand(dh, enc + pk_r)


class _P256Kem:
    ID = HpkeKemId.P256_HKDF_SHA256
    N_SECRET = 32
    N_PK = 65
    N_SK = 32
    _hash = hashlib.sha256
    # evaluated at class-definition time, so guarded by the import gate
    _curve = ec.SECP256R1() if HAVE_CRYPTOGRAPHY else None

    @classmethod
    def _suite_id(cls) -> bytes:
        return b"KEM" + cls.ID.value.to_bytes(2, "big")

    @classmethod
    def generate_keypair(cls) -> Tuple[bytes, bytes]:
        if HAVE_FUNCTIONAL_CRYPTOGRAPHY:
            sk = ec.generate_private_key(cls._curve)
            return (
                sk.private_numbers().private_value.to_bytes(32, "big"),
                sk.public_key().public_bytes(Encoding.X962, PublicFormat.UncompressedPoint),
            )
        while True:
            sk_bytes = os.urandom(32)
            try:
                return sk_bytes, _curves.p256_public(sk_bytes)
            except ValueError:  # pragma: no cover - scalar == 0 mod n
                continue

    @classmethod
    def public_from_private(cls, sk_bytes: bytes) -> bytes:
        if HAVE_FUNCTIONAL_CRYPTOGRAPHY:
            sk = ec.derive_private_key(int.from_bytes(sk_bytes, "big"), cls._curve)
            return sk.public_key().public_bytes(Encoding.X962, PublicFormat.UncompressedPoint)
        return _curves.p256_public(sk_bytes)

    @classmethod
    def _extract_and_expand(cls, dh: bytes, kem_context: bytes) -> bytes:
        suite = cls._suite_id()
        eae_prk = _labeled_extract(cls._hash, suite, b"", b"eae_prk", dh)
        return _labeled_expand(cls._hash, suite, eae_prk, b"shared_secret", kem_context, cls.N_SECRET)

    @classmethod
    def _exchange(cls, sk_bytes: bytes, pk_bytes: bytes) -> bytes:
        if HAVE_FUNCTIONAL_CRYPTOGRAPHY:
            sk = ec.derive_private_key(int.from_bytes(sk_bytes, "big"), cls._curve)
            peer = ec.EllipticCurvePublicKey.from_encoded_point(cls._curve, pk_bytes)
            return sk.exchange(ec.ECDH(), peer)
        return _curves.p256_ecdh(sk_bytes, pk_bytes)

    @classmethod
    def encap(cls, pk_r: bytes, ephemeral_sk: Optional[bytes] = None) -> Tuple[bytes, bytes]:
        if ephemeral_sk is None:
            ephemeral_sk, enc = cls.generate_keypair()
        else:
            enc = cls.public_from_private(ephemeral_sk)
        dh = cls._exchange(ephemeral_sk, pk_r)
        return cls._extract_and_expand(dh, enc + pk_r), enc

    @classmethod
    def decap(cls, enc: bytes, sk_r: bytes, pk_r: Optional[bytes] = None) -> bytes:
        dh = cls._exchange(sk_r, enc)
        if pk_r is None:
            pk_r = cls.public_from_private(sk_r)
        return cls._extract_and_expand(dh, enc + pk_r)


_KEMS = {k.ID: k for k in (_X25519Kem, _P256Kem)}

#: aead_id -> (key len, nonce len, AEAD factory).  The factories are the
#: utils/gcm.py seam: `cryptography`'s implementations when functional,
#: the KAT-anchored soft fallbacks otherwise — either way the returned
#: object answers .encrypt/.decrypt(nonce, data, aad).
_AEAD_PARAMS = {
    HpkeAeadId.AES_128_GCM: (16, 12, _aesgcm),
    HpkeAeadId.AES_256_GCM: (32, 12, _aesgcm),
    HpkeAeadId.CHACHA20_POLY1305: (32, 12, _chacha20poly1305),
}


def is_hpke_config_supported(config: HpkeConfig) -> bool:
    """reference: core/src/hpke.rs:31"""
    return (
        config.kem_id in _KEMS
        and config.kdf_id in _HASHES
        and config.aead_id in _AEAD_PARAMS
    )


def _key_schedule(kem_id, kdf_id, aead_id, shared_secret: bytes, info: bytes):
    """RFC 9180 §5.1 key schedule, base mode.  Returns (key, base_nonce)."""
    hash_fn = _HASHES[kdf_id]
    suite_id = (
        b"HPKE"
        + kem_id.value.to_bytes(2, "big")
        + kdf_id.value.to_bytes(2, "big")
        + aead_id.value.to_bytes(2, "big")
    )
    nk, nn, _cls = _AEAD_PARAMS[aead_id]
    psk_id_hash = _labeled_extract(hash_fn, suite_id, b"", b"psk_id_hash", b"")
    info_hash = _labeled_extract(hash_fn, suite_id, b"", b"info_hash", info)
    ks_context = b"\x00" + psk_id_hash + info_hash  # mode_base = 0x00
    secret = _labeled_extract(hash_fn, suite_id, shared_secret, b"secret", b"")
    key = _labeled_expand(hash_fn, suite_id, secret, b"key", ks_context, nk)
    base_nonce = _labeled_expand(hash_fn, suite_id, secret, b"base_nonce", ks_context, nn)
    return key, base_nonce


@dataclass(frozen=True)
class HpkeKeypair:
    """Public config + private key (reference: core/src/hpke.rs HpkeKeypair)."""

    config: HpkeConfig
    # Secret hygiene: the private key never reaches logs through repr
    # (reference: aggregator_core/src/lib.rs:28).
    private_key: bytes = field(repr=False)

    @classmethod
    def generate(
        cls,
        config_id: int,
        kem_id: HpkeKemId = HpkeKemId.X25519_HKDF_SHA256,
        kdf_id: HpkeKdfId = HpkeKdfId.HKDF_SHA256,
        aead_id: HpkeAeadId = HpkeAeadId.AES_128_GCM,
    ) -> "HpkeKeypair":
        """reference: core/src/hpke.rs:212 generate_hpke_config_and_private_key"""
        kem = _KEMS.get(kem_id)
        if kem is None:
            raise HpkeError(f"unsupported KEM {kem_id}")
        sk, pk = kem.generate_keypair()
        return cls(
            HpkeConfig(config_id, kem_id, kdf_id, aead_id, HpkePublicKey(pk)), sk
        )


def seal(
    recipient_config: HpkeConfig,
    application_info: HpkeApplicationInfo,
    plaintext: bytes,
    associated_data: bytes,
    _ephemeral_sk: Optional[bytes] = None,
) -> HpkeCiphertext:
    """One-shot base-mode seal (reference: core/src/hpke.rs:167)."""
    if not is_hpke_config_supported(recipient_config):
        raise HpkeError("unsupported HPKE configuration")
    kem = _KEMS[recipient_config.kem_id]
    shared_secret, enc = kem.encap(recipient_config.public_key.raw, _ephemeral_sk)
    key, base_nonce = _key_schedule(
        recipient_config.kem_id,
        recipient_config.kdf_id,
        recipient_config.aead_id,
        shared_secret,
        application_info.raw,
    )
    _nk, _nn, aead_cls = _AEAD_PARAMS[recipient_config.aead_id]
    ct = aead_cls(key).encrypt(base_nonce, plaintext, associated_data)  # seq 0
    return HpkeCiphertext(recipient_config.id, enc, ct)


def open_(
    recipient_keypair: HpkeKeypair,
    application_info: HpkeApplicationInfo,
    ciphertext: HpkeCiphertext,
    associated_data: bytes,
) -> bytes:
    """One-shot base-mode open (reference: core/src/hpke.rs:192)."""
    config = recipient_keypair.config
    if not is_hpke_config_supported(config):
        raise HpkeError("unsupported HPKE configuration")
    kem = _KEMS[config.kem_id]
    try:
        shared_secret = kem.decap(
            ciphertext.encapsulated_key,
            recipient_keypair.private_key,
            pk_r=config.public_key.raw,
        )
        key, base_nonce = _key_schedule(
            config.kem_id, config.kdf_id, config.aead_id, shared_secret, application_info.raw
        )
        _nk, _nn, aead_cls = _AEAD_PARAMS[config.aead_id]
        return aead_cls(key).decrypt(base_nonce, ciphertext.payload, associated_data)
    except HpkeError:
        raise
    except Exception as e:
        raise HpkeError(f"HPKE open failed: {type(e).__name__}") from e
