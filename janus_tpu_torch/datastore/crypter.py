"""AES-128-GCM encryption of sensitive datastore columns.

The analog of the reference's ``Crypter`` (reference:
aggregator_core/src/datastore.rs:5622-5720): values are sealed with
AAD = (table, row-identifier, column) so ciphertexts cannot be swapped
between rows/columns; multiple keys support rotation — the first key
encrypts, every key is tried on decrypt.

The AEAD comes from the utils/gcm.py seam:
`cryptography`'s AESGCM whenever it is importable AND functional
(known-answer probed — AES-NI in production), the KAT-anchored soft
fallback otherwise, so the datastore — and every suite that needs one —
runs on cryptography-less dev hosts too.
"""

from __future__ import annotations

import os
import secrets
from typing import List, Sequence

from ..utils.gcm import INVALID_TAG_EXCEPTIONS, aesgcm

#: Kept for callers that used to gate on the wheel: the AEAD seam always
#: works now (soft fallback), so this is about which BACKEND serves.
from ..utils.gcm import HAVE_FUNCTIONAL_CRYPTOGRAPHY as HAVE_CRYPTOGRAPHY  # noqa: F401

KEY_LEN = 16
NONCE_LEN = 12


class CrypterError(Exception):
    pass


def generate_key() -> bytes:
    return secrets.token_bytes(KEY_LEN)


class Crypter:
    def __init__(self, keys: Sequence[bytes]):
        if not keys:
            raise CrypterError("Crypter requires at least one key")
        for k in keys:
            if len(k) != KEY_LEN:
                raise CrypterError(f"datastore keys must be {KEY_LEN} bytes")
        self._aeads: List[object] = [aesgcm(k) for k in keys]

    @staticmethod
    def _aad(table: str, row: bytes, column: str) -> bytes:
        return table.encode() + b"/" + row + b"/" + column.encode()

    def encrypt(self, table: str, row: bytes, column: str, value: bytes) -> bytes:
        nonce = os.urandom(NONCE_LEN)
        ct = self._aeads[0].encrypt(nonce, value, self._aad(table, row, column))
        return nonce + ct

    def decrypt(self, table: str, row: bytes, column: str, value: bytes) -> bytes:
        if len(value) < NONCE_LEN:
            raise CrypterError("ciphertext too short")
        nonce, ct = value[:NONCE_LEN], value[NONCE_LEN:]
        aad = self._aad(table, row, column)
        for aead in self._aeads:
            try:
                return aead.decrypt(nonce, ct, aad)
            except INVALID_TAG_EXCEPTIONS:
                continue
        raise CrypterError(f"unable to decrypt {table}.{column}")
