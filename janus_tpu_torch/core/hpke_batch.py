"""Batched HPKE open: the upload front door's crypto, one call a batch.

``Aggregator.handle_upload`` used to HPKE-open every report inline, one
at a time, on the handler's event loop.  This module opens a BATCH of
concurrent uploads' ciphertexts in one call (the caller runs it on a
worker thread): per-report KEM decap + HKDF key schedule, then each
report's AEAD body with the key it derived.

This is the host path of the reference module.  Its vectorized AES-GCM
pass (a table-AES kernel over every AES-128-GCM body of the batch with a
vectorized GHASH) comes with the upload vector pass (ROADMAP queue 1,
"The upload vector pass"); until then :func:`vector_pass_preferred` is
False.  Robustness
contract: a malformed ciphertext rejects ONLY its own report (per-item
error slots).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from .hpke import (
    _AEAD_PARAMS,
    _KEMS,
    HpkeApplicationInfo,
    HpkeError,
    HpkeKeypair,
    _key_schedule,
    is_hpke_config_supported,
)

__all__ = ["OpenRequest", "open_batch", "vector_pass_preferred"]

#: An open request: (recipient keypair, application info, ciphertext, aad).
OpenRequest = Tuple[HpkeKeypair, HpkeApplicationInfo, object, bytes]


def vector_pass_preferred() -> bool:
    """Should AES-128-GCM bodies take a vectorized AES pass?  Not in the
    port yet (ROADMAP queue 1, the upload vector pass): every body opens
    per report."""
    return False


# -- the batch face -----------------------------------------------------------


def _open_one(keypair, info, ciphertext, aad):
    """Per-report inline open, errors as values."""
    from .hpke import open_

    try:
        return open_(keypair, info, ciphertext, aad)
    except HpkeError as e:
        return e
    except Exception as e:  # pragma: no cover - defensive
        return HpkeError(f"HPKE open failed: {type(e).__name__}")


def open_batch(requests: Sequence[OpenRequest]) -> List[object]:
    """Open a batch of HPKE ciphertexts; one result slot per request —
    plaintext bytes on success, an :class:`HpkeError` value on failure
    (never raised: a malformed row must reject only itself).

    Per-report KEM decap + key schedule and the AEAD open run here (the
    caller is expected to be on a worker thread)."""
    results: List[object] = [None] * len(requests)
    for i, (keypair, info, ciphertext, aad) in enumerate(requests):
        config = keypair.config
        if not is_hpke_config_supported(config):
            results[i] = HpkeError("unsupported HPKE configuration")
            continue
        kem = _KEMS[config.kem_id]
        try:
            shared_secret = kem.decap(
                ciphertext.encapsulated_key,
                keypair.private_key,
                pk_r=config.public_key.raw,
            )
            key, base_nonce = _key_schedule(
                config.kem_id, config.kdf_id, config.aead_id, shared_secret, info.raw
            )
        except Exception as e:
            results[i] = HpkeError(f"HPKE open failed: {type(e).__name__}")
            continue
        _nk, _nn, aead_factory = _AEAD_PARAMS[config.aead_id]
        try:
            results[i] = aead_factory(key).decrypt(base_nonce, ciphertext.payload, aad)
        except Exception as e:
            results[i] = HpkeError(f"HPKE open failed: {type(e).__name__}")
    return results
