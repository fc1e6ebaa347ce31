"""Fixed-key AES-128 in plain PyTorch: the card half of the IDPF walk.

Counterpart of ``janus_tpu/ops/aes_jax.py``.  The Poplar1 tree walk's bulk
work is AES-128 over (B, K, 16) blocks, one key schedule a report
(``xof.XofFixedKeyAes128``'s hash_block, draft-irtf-cfrg-vdaf-08 §6.2.2).
This module runs the same table-based layout as whole-tensor operations on
the tensors' device: the S-box and xtime tables as gathers, ShiftRows as a
static column permutation, MixColumns as four XOR rows.  The state byte i
sits at (row i % 4, column i // 4), as in ``utils/softaes.py``, whose
GF(2^8)-generated tables and key schedule this module reuses.

PyTorch on the CPU has no unsigned shifts or compares, and a uint8 tensor
used as an index is read as a mask; the bytes are therefore carried as
int64 values in [0, 256), which every gather takes as an index as it is.

Unlike the JAX version no axis is padded: PyTorch compiles nothing per
shape, so a frontier of any width launches as it is.  The FIPS-197
appendix C.1 vector is checked once a device, at its first use (a table
or layout fault must fail loudly, never walk a wrong tree).
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from ..utils.softaes import _C1_CIPHER, _C1_PLAIN, _MUL2, _MUL3, _SBOX, _SHIFT, _expand_key

__all__ = ["encrypt_blocks_multikey", "expand_keys", "to_device_bytes"]

#: per-device constant tables: (sbox, mul2, mul3, shift index)
_TABLES: Dict[torch.device, tuple] = {}


def _tables(device: torch.device) -> tuple:
    t = _TABLES.get(device)
    if t is None:
        t = tuple(
            torch.from_numpy(np.asarray(a, dtype=np.int64)).to(device)
            for a in (_SBOX, _MUL2, _MUL3, _SHIFT)
        )
        _TABLES[device] = t
        _anchor(device)
    return t


def _sub_shift(s: torch.Tensor, tables) -> torch.Tensor:
    """SubBytes + ShiftRows on (..., 16) state."""
    sbox, _m2, _m3, shift = tables
    return sbox[s].index_select(-1, shift)


def _mix_columns(s: torch.Tensor, tables) -> torch.Tensor:
    """MixColumns on (..., 16) state, viewed as (..., 4 columns, 4 rows)."""
    _sbox, mul2, mul3, _shift = tables
    a = s.reshape(s.shape[:-1] + (4, 4))
    a0, a1, a2, a3 = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    out = torch.stack(
        [
            mul2[a0] ^ mul3[a1] ^ a2 ^ a3,
            a0 ^ mul2[a1] ^ mul3[a2] ^ a3,
            a0 ^ a1 ^ mul2[a2] ^ mul3[a3],
            mul3[a0] ^ a1 ^ a2 ^ mul2[a3],
        ],
        dim=-1,
    )
    return out.reshape(s.shape)


def encrypt_blocks_multikey(round_keys: torch.Tensor, blocks: torch.Tensor) -> torch.Tensor:
    """One key a report: (B, 11, 16) round keys over (B, K, 16) blocks ->
    (B, K, 16), int64 bytes: the IDPF walk's shape, every frontier node of
    every report in one pass."""
    tables = _tables(blocks.device)
    rk = round_keys[:, None, :, :]
    s = blocks ^ rk[..., 0, :]
    for rnd in range(1, 10):
        s = _mix_columns(_sub_shift(s, tables), tables) ^ rk[..., rnd, :]
    return _sub_shift(s, tables) ^ rk[..., 10, :]


def expand_keys(keys: Sequence[bytes]) -> np.ndarray:
    """(B, 11, 16) uint8 round-key schedules of a sequence of 16-byte keys."""
    return np.stack([_expand_key(bytes(k)) for k in keys])


def to_device_bytes(arr: np.ndarray, device) -> torch.Tensor:
    """A uint8 host array -> int64 byte tensor on ``device``."""
    return torch.from_numpy(np.array(arr, dtype=np.uint8)).to(device).to(torch.int64)


def _anchor(device: torch.device) -> None:
    """FIPS-197 C.1 on ``device``; raises on a wrong table or layout."""
    rk = to_device_bytes(_expand_key(bytes(range(16)))[None], device)
    blk = to_device_bytes(np.frombuffer(bytes.fromhex(_C1_PLAIN), dtype=np.uint8).reshape(1, 1, 16), device)
    got = encrypt_blocks_multikey(rk, blk).to(torch.uint8).cpu().numpy().tobytes()
    if got != bytes.fromhex(_C1_CIPHER):
        _TABLES.pop(device, None)
        raise AssertionError(f"AES self-test failed on {device} (table or layout fault)")
