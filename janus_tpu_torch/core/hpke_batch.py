"""Batched HPKE open: the upload front door's crypto, one call a batch.

``Aggregator.handle_upload`` used to HPKE-open every report inline, one
at a time, on the handler's event loop.  This module opens a BATCH of
concurrent uploads' ciphertexts in one call (the caller runs it on a
worker thread):

1. per-report KEM decap + HKDF key schedule (X25519 / P-256 DH: serial
   math on the host), then
2. ONE vectorized AES-GCM pass over every AES-128-GCM body in the batch:
   the AES-CTR keystream (plus each report's GHASH key H = E(K, 0) and
   tag mask E(K, J0)) through ``ops/aes.py``'s multikey table AES on the
   configured device, one key schedule a report, and GHASH as a
   Horner loop of per-report 4-bit table multiplies (numpy, on the host),
   LEFT-zero-padding each report's block sequence so one unmasked loop
   serves ragged lengths (leading zero blocks are GHASH no-ops).

Suites the vector pass does not cover (AES-256-GCM, ChaCha20-Poly1305)
open per report inside the same batch call, so the caller's contract is
uniform.  A malformed ciphertext rejects ONLY its own report (per-item
error slots).  A failure of the vector pass as a whole (the device, its
AES tables, a launch) is not a verdict on any report: it raises
:class:`VectorPassError`, which the callers answer with a retryable 503;
nothing falls back to another AES on its account.

Every open is counted by route on ``janus_hpke_open_rows_total``:
``vector`` (the AES-128-GCM bodies of a vector pass), ``aead`` (a body
opened per report with the key this batch derived) and ``inline`` (a whole
per-report ``open_``).
"""

from __future__ import annotations

import hmac
import math
import os
import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..messages import HpkeAeadId
from .hpke import (
    _AEAD_PARAMS,
    _KEMS,
    HpkeApplicationInfo,
    HpkeError,
    HpkeKeypair,
    _key_schedule,
    is_hpke_config_supported,
)

__all__ = [
    "OpenRequest",
    "VectorPassError",
    "aesgcm_open_batch",
    "open_batch",
    "vector_pass_preferred",
]

#: An open request: (recipient keypair, application info, ciphertext, aad).
OpenRequest = Tuple[HpkeKeypair, HpkeApplicationInfo, object, bytes]

#: Below this many AES-128-GCM bodies the vectorized pass is dispatch
#: overhead, not a win: open per report instead.
MIN_VECTOR_BATCH = 2

#: ``1`` forces the vector pass, ``0`` the per-report AEAD (tests force both)
VECTOR_GCM_ENV = "JANUS_TPU_TORCH_UPLOAD_VECTOR_GCM"


class VectorPassError(Exception):
    """The AES-128-GCM vector pass failed as a whole (a device, table or
    launch fault): no report was judged, and none may be opened another
    way on its account."""


def configured_device(device=None) -> str:
    """The vector pass's device: ``device`` (the caller's
    ``Config.vdaf_device``), else the card, as the prepare backend's
    default."""
    return str(device or "cuda")


def vector_pass_preferred(device=None) -> bool:
    """Should AES-128-GCM bodies take the vector pass?

    Where it was built for: a configured device that is a CUDA card
    (table gathers there are wide vector operations), and hosts with NO
    functional `cryptography` (nothing constant-time exists to prefer).
    On the CPU with a working `cryptography`, per-report AES-NI is both
    constant-time and faster than table lookups: the table AES must never
    be preferred there (the utils/gcm.py invariant).
    ``JANUS_TPU_TORCH_UPLOAD_VECTOR_GCM=1|0`` overrides."""
    force = os.environ.get(VECTOR_GCM_ENV, "")
    if force in ("0", "1"):
        return force == "1"
    from ..utils.gcm import HAVE_FUNCTIONAL_CRYPTOGRAPHY

    if not HAVE_FUNCTIONAL_CRYPTOGRAPHY:
        return True
    import torch

    return torch.device(configured_device(device)).type == "cuda" and torch.cuda.is_available()


#: the routes an open is counted on
ROUTES = ("vector", "aead", "inline")


def _count_rows(stage: str, route: str, rows: int) -> None:
    from .metrics import GLOBAL_METRICS

    if rows and GLOBAL_METRICS.registry is not None:
        GLOBAL_METRICS.hpke_open_rows.labels(stage=stage, route=route).inc(rows)


def route_rows(stage: str) -> dict:
    """This process's HPKE opens of ``stage`` by route."""
    from .metrics import GLOBAL_METRICS

    return {
        route: int(GLOBAL_METRICS.get_sample_value("janus_hpke_open_rows_total", {"stage": stage, "route": route}) or 0)
        for route in ROUTES
    }


_R_HI = np.uint64(0xE100000000000000)  # GCM reduction poly, high u64

#: from this many blocks a report, GHASH runs its Horner loop by chunks
CHUNKED_FROM = 64


# -- vectorized GHASH ---------------------------------------------------------
#
# Field elements ride as (B, ..., 2) u64 arrays whose MEMORY holds the
# element's 16 bytes in string order, so XOR works on them as they are and
# ``.view(np.uint8)`` gives the bytes.  Multiplying by a per-report H is 32
# lookups (Shoup's 4-bit tables): the element's 32 nibbles index 32 tables
# of 16 products each, whose XOR is the product.


def _times_x8_table() -> np.ndarray:
    """What the 8 bits shifted out of an element's low half fold into its
    high half when it is multiplied by x^8: bit j of the low byte leaves
    at shift j + 1, XORs in R, and R then shifts right 7 - j more times."""
    u = np.arange(256, dtype=np.uint64)
    out = np.zeros(256, dtype=np.uint64)
    for j in range(8):
        out ^= ((u >> np.uint64(j)) & np.uint64(1)) * (_R_HI >> np.uint64(7 - j))
    return out


_X8 = _times_x8_table()


def _mul_tables(h: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Multiply-by-H tables for each row of ``h`` ((B, 2), string-order
    memory): the (hi, lo) u64 halves of row ``(b * 32 + d) * 16 + v``, the
    product of H_b with the element whose nibble ``d`` is ``v`` and all
    others 0 (``d`` < 16: the high nibble of byte ``d``; else the low
    nibble of byte ``d - 16``, as :func:`_mul` orders them).

    Built from V_t = H * x^t for t in [0, 128) on the element as an
    integer (bit 0 of the GCM spec = the integer's MSB): V_0..V_7 by the
    SP 800-38D right shift, then each next 8 as the last 8 times x^8."""
    b = len(h)
    v = np.empty((b, 16, 8, 2), dtype=np.uint64)
    h_int = h.view(">u8").astype(np.uint64)
    chi, clo = h_int[:, 0].copy(), h_int[:, 1].copy()
    one = np.uint64(1)
    s56, s63, s8 = np.uint64(56), np.uint64(63), np.uint64(8)
    for t in range(8):
        v[:, 0, t, 0] = chi
        v[:, 0, t, 1] = clo
        lsb = clo & one
        clo = (clo >> one) | ((chi & one) << s63)
        chi = (chi >> one) ^ (lsb * _R_HI)
    for k in range(1, 16):
        hi, lo = v[:, k - 1, :, 0], v[:, k - 1, :, 1]
        v[:, k, :, 0] = (hi >> s8) ^ _X8[lo & np.uint64(0xFF)]
        v[:, k, :, 1] = (lo >> s8) | (hi << s56)
    # (B, byte, nibble high/low, bit, half) -> (half, bit, B, digit)
    v = v.astype(">u8").view(np.uint64).reshape(b, 16, 2, 4, 2).transpose(4, 3, 0, 2, 1).reshape(2, 4, b, 32)
    tables = []
    for half in v:
        table = np.zeros((1, b, 32), dtype=np.uint64)  # (nibble value, B, digit)
        for i in range(3, -1, -1):  # nibble value bit 3 - i selects V of bit i
            table = np.concatenate([table, table ^ half[i]])
        tables.append(np.ascontiguousarray(table.transpose(1, 2, 0)).reshape(-1))
    return tables[0], tables[1]


def _mul(tables: Tuple[np.ndarray, np.ndarray], base: np.ndarray, x: np.ndarray) -> np.ndarray:
    """x * H per report: ``x`` is (B, ..., 2), ``base`` (B, ..., 32) each
    row's first table row (broadcast over the middle axes)."""
    xb = x.view(np.uint8)
    idx = np.concatenate((xb >> 4, xb & 15), axis=-1) + base
    out = np.empty(x.shape, dtype=np.uint64)
    for k in (0, 1):
        np.bitwise_xor.reduce(np.take(tables[k], idx), axis=-1, out=out[..., k])
    return out


def _ghash_batch(h_blocks: np.ndarray, datas: Sequence[bytes]) -> np.ndarray:
    """GHASH_H(data) per report, vectorized across the batch.

    ``h_blocks`` is (B, 16) u8 (each report's H = E(K, 0)); each
    ``datas[i]`` must already be a block multiple (the caller appends the
    GCM length block).  Ragged lengths are LEFT-padded with zero blocks
    to the common maximum: a leading zero block leaves the Horner
    accumulator at 0, so padding changes nothing.  Returns (B, 16) u8.

    From CHUNKED_FROM blocks on, the m blocks of a report are cut into
    c ~ sqrt(m) chunks of l blocks, and the Horner loop Y <- (Y ^ X_j) * H
    runs over every chunk of every report at once (l steps, not m); the
    chunk values R_k then combine as Y <- Y * H^l ^ R_k (c steps).  H^l
    comes from one more chunk per report, [1, 0, ..., 0], whose Horner
    value is H^l."""
    b = len(h_blocks)
    nblocks = [len(d) // 16 for d in datas]
    m = max(nblocks, default=0)
    c = math.isqrt(m) if m >= CHUNKED_FROM else 1
    l = -(-m // c)
    lead = l if c > 1 else 0  # chunk 0, the [1, 0, ..., 0] that yields H^l
    padded = np.zeros((b, lead * 16 + c * l * 16), dtype=np.uint8)
    if lead:
        padded[:, 0] = 0x80  # the field's 1
    for i, d in enumerate(datas):
        if d:
            padded[i, padded.shape[1] - len(d) :] = np.frombuffer(d, dtype=np.uint8)
    blocks = padded.view(np.uint64).reshape(b, -1, l, 2) if l else np.zeros((b, 1, 0, 2), dtype=np.uint64)
    base = (np.arange(b * 32, dtype=np.intp) * 16).reshape(b, 1, 32)
    tables = _mul_tables(np.ascontiguousarray(h_blocks).view(np.uint64).reshape(b, 2))
    y = np.zeros((b, blocks.shape[1], 2), dtype=np.uint64)
    for j in range(l):
        y = _mul(tables, base, y ^ blocks[:, :, j])
    if c == 1:
        return y[:, 0].view(np.uint8).reshape(b, 16).copy()
    tables_l = _mul_tables(np.ascontiguousarray(y[:, 0]))
    acc = y[:, 1].copy()
    for k in range(2, c + 1):
        acc = _mul(tables_l, base[:, 0], acc) ^ y[:, k]
    return acc.view(np.uint8).reshape(b, 16).copy()


# -- vectorized AES-128-GCM open ---------------------------------------------


def _keystream(keys: Sequence[bytes], nonces: Sequence[bytes], kmax: int, device) -> np.ndarray:
    """(B, kmax, 16) u8: block 0 is E(K, 0) (the GHASH key), block j >= 1
    is E(K, nonce || BE32(j)) (block 1 the tag mask E(K, J0), block 2 + c
    the keystream of ciphertext block c), each report under its own key,
    through ``ops/aes.py``'s multikey AES on ``device``.  The counter
    blocks are built on the device; nothing is padded (PyTorch compiles
    nothing per shape)."""
    import torch

    from ..ops.aes import encrypt_blocks_multikey, expand_keys, to_device_bytes

    dev = torch.device(device)
    b = len(keys)
    round_keys = to_device_bytes(expand_keys(keys), dev)
    nonce = to_device_bytes(np.frombuffer(b"".join(nonces), dtype=np.uint8).reshape(b, 12), dev)
    blocks = torch.zeros((b, kmax, 16), dtype=torch.int64, device=dev)
    blocks[:, 1:, :12] = nonce[:, None, :]
    ctr = torch.arange(1, kmax, dtype=torch.int64, device=dev)
    for k in range(4):
        blocks[:, 1:, 12 + k] = (ctr >> (8 * (3 - k))) & 0xFF
    return encrypt_blocks_multikey(round_keys, blocks).to(torch.uint8).cpu().numpy()


def _ghash_inputs(aads: Sequence[bytes], cts: Sequence[bytes]) -> List[bytes]:
    """Each report's GHASH input: aad and ciphertext zero-padded to blocks,
    then the lengths block."""
    return [
        aad
        + b"\x00" * (-len(aad) % 16)
        + ct
        + b"\x00" * (-len(ct) % 16)
        + struct.pack(">QQ", 8 * len(aad), 8 * len(ct))
        for aad, ct in zip(aads, cts)
    ]


def aesgcm_open_batch(
    keys: Sequence[bytes],
    nonces: Sequence[bytes],
    ciphertexts: Sequence[bytes],
    aads: Sequence[bytes],
    device,
) -> List[Optional[bytes]]:
    """Open B AES-128-GCM one-shot messages as one vectorized pass, the
    AES on ``device``.

    Returns a plaintext per slot, or None where authentication failed
    (tag mismatch / input under 16 bytes): per-report isolation is the
    contract.  All nonces must be 12 bytes (the only length RFC 9180
    produces).  Raises :class:`VectorPassError` when the pass itself
    fails."""
    cts, tags, ok = [], [], []
    for ct in ciphertexts:
        if len(ct) < 16:
            cts.append(b"")
            tags.append(b"")
            ok.append(False)
        else:
            cts.append(ct[:-16])
            tags.append(ct[-16:])
            ok.append(True)
    nblocks = [(len(c) + 15) // 16 for c in cts]
    try:
        out = _keystream(keys, nonces, 2 + max(nblocks, default=0), device)
        s = _ghash_batch(np.ascontiguousarray(out[:, 0]), _ghash_inputs(aads, cts))
    except Exception as e:
        raise VectorPassError(f"AES-128-GCM vector pass on {device} failed: {type(e).__name__}: {e}") from e
    tags_got = s ^ out[:, 1]
    results: List[Optional[bytes]] = []
    for i, ct in enumerate(cts):
        if not ok[i] or not hmac.compare_digest(tags_got[i].tobytes(), tags[i]):
            results.append(None)
            continue
        stream = out[i, 2 : 2 + nblocks[i]].reshape(-1)[: len(ct)]
        results.append((np.frombuffer(ct, dtype=np.uint8) ^ stream).tobytes())
    return results


# -- the batch face -----------------------------------------------------------


def _open_one(keypair, info, ciphertext, aad, stage: str = "upload"):
    """Per-report inline open, errors as values."""
    from .hpke import open_

    _count_rows(stage, "inline", 1)
    try:
        return open_(keypair, info, ciphertext, aad)
    except HpkeError as e:
        return e
    except Exception as e:  # pragma: no cover - defensive
        return HpkeError(f"HPKE open failed: {type(e).__name__}")


def open_batch(requests: Sequence[OpenRequest], device=None, stage: str = "upload") -> List[object]:
    """Open a batch of HPKE ciphertexts; one result slot per request:
    plaintext bytes on success, an :class:`HpkeError` value on failure
    (never raised: a malformed row must reject only itself).

    Per-report KEM decap + key schedule run here (the caller is expected
    to be on a worker thread); all AES-128-GCM bodies then open as ONE
    vector pass on ``device`` (None: :func:`configured_device`) where
    :func:`vector_pass_preferred` says so, other suites per report.  A
    failed vector pass raises :class:`VectorPassError`.  ``stage`` labels
    the route counts (``upload``, ``aggregate_init``)."""
    results: List[object] = [None] * len(requests)
    gcm_idx: List[int] = []
    gcm_keys: List[bytes] = []
    gcm_nonces: List[bytes] = []
    gcm_cts: List[bytes] = []
    gcm_aads: List[bytes] = []
    aead_rows = 0
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
        if config.aead_id == HpkeAeadId.AES_128_GCM:
            gcm_idx.append(i)
            gcm_keys.append(key)
            gcm_nonces.append(base_nonce)
            gcm_cts.append(ciphertext.payload)
            gcm_aads.append(aad)
        else:
            aead_rows += 1
            results[i] = _aead_open(config.aead_id, key, base_nonce, ciphertext.payload, aad)
    if len(gcm_idx) >= MIN_VECTOR_BATCH and vector_pass_preferred(device):
        opened = aesgcm_open_batch(gcm_keys, gcm_nonces, gcm_cts, gcm_aads, configured_device(device))
        for i, pt in zip(gcm_idx, opened):
            results[i] = pt if pt is not None else HpkeError("HPKE open failed: InvalidTag")
        _count_rows(stage, "vector", len(gcm_idx))
    else:
        # per-report AEAD with the ALREADY-derived keys (the KEM work above
        # is never repeated): the path for tiny batches and for CPU hosts
        # where `cryptography`'s constant-time AES-NI must be preferred
        for i, key, nonce, ct, aad in zip(gcm_idx, gcm_keys, gcm_nonces, gcm_cts, gcm_aads):
            results[i] = _aead_open(HpkeAeadId.AES_128_GCM, key, nonce, ct, aad)
        aead_rows += len(gcm_idx)
    _count_rows(stage, "aead", aead_rows)
    return results


def _aead_open(aead_id, key: bytes, nonce: bytes, ct: bytes, aad: bytes):
    """One body under its derived key, errors as values."""
    _nk, _nn, aead_factory = _AEAD_PARAMS[aead_id]
    try:
        return aead_factory(key).decrypt(nonce, ct, aad)
    except Exception as e:
        return HpkeError(f"HPKE open failed: {type(e).__name__}")
