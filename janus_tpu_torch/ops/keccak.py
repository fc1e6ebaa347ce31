"""Batched TurboSHAKE128 in plain PyTorch (the reference for the CUDA Keccak).

Counterpart of ``janus_tpu/ops/keccak_jax.py``.  The 25 Keccak lanes are
stacked on a leading axis as int64 tensors holding the u64 bit patterns, so
each round step is a handful of whole-state tensor operations: the column
parities, a per-lane rotation with a vector of shift amounts, the pi lane
permutation as a gather, and chi as two gathers.  ``>>`` on int64 is
arithmetic, so logical right shifts are masked.

Byte streams are uint8 tensors; words are int64 values in [0, 2^32),
little-endian.  Bit-exact against ``janus_tpu_torch.xof``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..xof import ROUND_CONSTANTS, _RHO
from .field import M32

RATE = 168  # bytes
RATE_WORDS = RATE // 4  # 42 u32 words = 21 lanes
_ROUNDS = 12


def _signed64(x: int) -> int:
    return x - (1 << 64) if x >= 1 << 63 else x


_RC = [_signed64(rc) for rc in ROUND_CONSTANTS[24 - _ROUNDS :]]
# pi: b[y + 5*((2x + 3y) % 5)] = rotl(a[x + 5y], RHO[x + 5y])
_PI_SRC = [0] * 25
for _x in range(5):
    for _y in range(5):
        _PI_SRC[_y + 5 * ((2 * _x + 3 * _y) % 5)] = _x + 5 * _y
_CHI1 = [(i % 5 + 1) % 5 + 5 * (i // 5) for i in range(25)]
_CHI2 = [(i % 5 + 2) % 5 + 5 * (i // 5) for i in range(25)]
_MOD5 = [i % 5 for i in range(25)]
_THETA_PREV = [4, 0, 1, 2, 3]
_THETA_NEXT = [1, 2, 3, 4, 0]


def _rotl_vec(x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Rotate u64 lanes (int64 bit patterns) left by per-lane amounts r."""
    return (x << r) | ((x >> (64 - r)) & ((1 << r) - 1))


def keccak_p_batch(a: torch.Tensor) -> torch.Tensor:
    """Keccak-p[1600,12] on lanes (25, ...) int64 (lane index = x + 5*y)."""
    dev = a.device
    extra = (1,) * (a.dim() - 1)
    rho = torch.tensor(_RHO, dtype=torch.int64, device=dev).reshape((25,) + extra)
    one = torch.ones((5,) + extra, dtype=torch.int64, device=dev)
    pi = torch.tensor(_PI_SRC, device=dev)
    chi1 = torch.tensor(_CHI1, device=dev)
    chi2 = torch.tensor(_CHI2, device=dev)
    mod5 = torch.tensor(_MOD5, device=dev)
    prev = torch.tensor(_THETA_PREV, device=dev)
    nxt = torch.tensor(_THETA_NEXT, device=dev)
    for rc in _RC:
        c = a[0:5] ^ a[5:10] ^ a[10:15] ^ a[15:20] ^ a[20:25]
        d = c[prev] ^ _rotl_vec(c[nxt], one)
        a = a ^ d[mod5]
        b = _rotl_vec(a, rho)[pi]
        a = b ^ (~b[chi1] & b[chi2])
        a[0] ^= rc
    return a


def words_to_lanes(w: torch.Tensor) -> torch.Tensor:
    """(2k, ...) u32 words -> (k, ...) u64 lanes."""
    return w[0::2] | (w[1::2] << 32)


def lanes_to_words(a: torch.Tensor) -> torch.Tensor:
    """(k, ...) u64 lanes -> (2k, ...) u32 words."""
    lo = a & M32
    hi = (a >> 32) & M32
    return torch.stack([lo, hi], dim=1).reshape((2 * a.shape[0],) + a.shape[1:])


def bytes_to_words(b: torch.Tensor) -> torch.Tensor:
    """(..., 4k) uint8 -> (..., k) int64 words, little-endian."""
    w = b.reshape(b.shape[:-1] + (b.shape[-1] // 4, 4)).to(torch.int64)
    return w[..., 0] | (w[..., 1] << 8) | (w[..., 2] << 16) | (w[..., 3] << 24)


def words_to_bytes(w: torch.Tensor) -> torch.Tensor:
    """(..., k) int64 words -> (..., 4k) uint8, little-endian."""
    parts = torch.stack([(w >> (8 * i)) & 0xFF for i in range(4)], dim=-1)
    return parts.to(torch.uint8).reshape(w.shape[:-1] + (w.shape[-1] * 4,))


def pad_message(msg: torch.Tensor, domain: int) -> torch.Tensor:
    """TurboSHAKE pad of (..., L) uint8: append the domain byte, zero-fill to
    the rate, xor 0x80 into the last byte of the final block."""
    L = msg.shape[-1]
    nblocks = L // RATE + 1
    pad_len = nblocks * RATE - L
    pad = np.zeros(pad_len, dtype=np.uint8)
    pad[0] = domain
    pad[-1] ^= 0x80
    pad_t = torch.from_numpy(pad).to(msg.device).expand(msg.shape[:-1] + (pad_len,))
    return torch.cat([msg, pad_t], dim=-1)


def xof_message(seed: torch.Tensor, dst: bytes, binder: torch.Tensor) -> torch.Tensor:
    """XofTurboShake128 message len(dst) || dst || seed || binder, (B, L) uint8."""
    B = seed.shape[0]
    prefix = torch.from_numpy(np.frombuffer(bytes([len(dst)]) + dst, dtype=np.uint8).copy())
    parts = [prefix.to(seed.device).expand(B, -1), seed]
    if binder.shape[-1]:
        parts.append(binder)
    return torch.cat(parts, dim=-1)


def absorb_words(words_: torch.Tensor) -> torch.Tensor:
    """Absorb padded message words (nblocks*42, ...) -> lanes (25, ...)."""
    nblocks = words_.shape[0] // RATE_WORDS
    state = torch.zeros((25,) + words_.shape[1:], dtype=torch.int64, device=words_.device)
    for i in range(nblocks):
        blk = words_to_lanes(words_[i * RATE_WORDS : (i + 1) * RATE_WORDS])
        state = torch.cat([state[:21] ^ blk, state[21:]], dim=0)
        state = keccak_p_batch(state)
    return state


def check_final_blocks(last_block: torch.Tensor, nblocks: int) -> None:
    """Raise ValueError unless every row's final block lies in [0, nblocks)
    (one reduction and one read back)."""
    lo, hi = torch.stack(torch.aminmax(last_block)).tolist()
    if lo < 0 or hi >= nblocks:
        raise ValueError(f"a final block lies outside the {nblocks} message blocks")


def absorb_words_select(words_: torch.Tensor, last_block: torch.Tensor) -> torch.Tensor:
    """Absorb padded message words (nblocks*42, B) over every block and keep,
    per report b, the state after its own final block ``last_block[b]``
    (B,) -> lanes (25, B)."""
    nblocks = words_.shape[0] // RATE_WORDS
    check_final_blocks(last_block, nblocks)
    last = last_block.to(torch.int64)
    state = torch.zeros((25,) + words_.shape[1:], dtype=torch.int64, device=words_.device)
    selected = state
    for i in range(nblocks):
        blk = words_to_lanes(words_[i * RATE_WORDS : (i + 1) * RATE_WORDS])
        state = keccak_p_batch(torch.cat([state[:21] ^ blk, state[21:]], dim=0))
        selected = torch.where(last == i, state, selected)
    return selected


def select_pad(msg: torch.Tensor, domain: int, msg_len: torch.Tensor) -> torch.Tensor:
    """TurboSHAKE pad of per-row message lengths: msg (B, Lmax) uint8, zero at
    and past each row's ``msg_len`` (B,) -> (B, nblocks*RATE) uint8 with the
    domain byte at msg_len and 0x80 xored into the last byte of the row's
    own final block (nblocks = Lmax // RATE + 1, the longest row's)."""
    B, Lmax = msg.shape
    nblocks = Lmax // RATE + 1
    buf = torch.cat([msg, torch.zeros((B, nblocks * RATE - Lmax), dtype=torch.uint8, device=msg.device)], dim=-1)
    ml = msg_len.to(torch.int64)[:, None]
    idx = torch.arange(nblocks * RATE, device=msg.device)[None, :]
    buf = torch.where(idx == ml, torch.tensor(domain, dtype=torch.uint8, device=msg.device), buf)
    last = (ml // RATE + 1) * RATE - 1
    return buf ^ torch.where(idx == last, 0x80, 0).to(torch.uint8)


def turboshake128_batch_select(msg: torch.Tensor, domain: int, out_len: int, msg_len: torch.Tensor) -> torch.Tensor:
    """TurboSHAKE128 over per-row message lengths (canonical shape padding,
    ``vdaf/canonical.py``): msg (B, Lmax) uint8 with every byte at or past
    the row's ``msg_len`` (B,) zero -> (B, out_len) uint8, equal row for
    row to ``turboshake128_batch(msg[b, :msg_len[b]])``.  Every block before
    a row's final block is byte-identical to its true absorb, so the state
    kept after that block squeezes the row's own output; ``out_len`` must
    fit one squeeze block (a seed does).  The plain version of the K2 select
    kernel (``keccak_kernels.absorb_select``); counterpart of
    ``keccak_jax.turboshake128_batch_select``."""
    if out_len > RATE:
        raise NotImplementedError("the select absorb serves seed-sized outputs")
    padded = select_pad(msg, domain, msg_len)
    w = bytes_to_words(padded).transpose(0, 1)  # (nblocks*42, B)
    state = absorb_words_select(w, msg_len.to(torch.int64) // RATE)
    return words_to_bytes(lanes_to_words(state[:21]).transpose(0, 1))[:, :out_len]


def squeeze_words(state: torch.Tensor, out_words: int, first_permuted: bool) -> torch.Tensor:
    """Squeeze ``out_words`` stream words from lanes (25, ...).

    ``first_permuted``: the state already went through the permutation that
    yields the first output block (after an absorb); otherwise each output
    block is preceded by a permutation (a padded single block xored into a
    zero state, as the squeeze kernel starts)."""
    outs = []
    have = 0
    while have < out_words:
        if not first_permuted or have:
            state = keccak_p_batch(state)
        outs.append(lanes_to_words(state[:21]))
        have += RATE_WORDS
    return torch.cat(outs, dim=0)[:out_words]


def turboshake128_batch(msg: torch.Tensor, domain: int, out_len: int) -> torch.Tensor:
    """One-shot TurboSHAKE128 over a batch: (B, L) uint8 -> (B, out_len) uint8."""
    padded = pad_message(msg, domain)
    w = bytes_to_words(padded).transpose(0, 1)  # (nblocks*42, B)
    nblocks = w.shape[0] // RATE_WORDS
    state = absorb_words(w[: (nblocks - 1) * RATE_WORDS]) if nblocks > 1 else None
    if state is None:
        state = torch.zeros((25,) + w.shape[1:], dtype=torch.int64, device=w.device)
    last = words_to_lanes(w[(nblocks - 1) * RATE_WORDS :])
    state = torch.cat([state[:21] ^ last, state[21:]], dim=0)
    out = squeeze_words(state, -(-out_len // 4), first_permuted=False)
    return words_to_bytes(out.transpose(0, 1))[:, :out_len]


def xof_turboshake128_batch(
    seed: torch.Tensor, dst: bytes, binder: torch.Tensor, out_len: int
) -> torch.Tensor:
    """Batched XofTurboShake128(seed, dst, binder).next(out_len):
    seed (B, 16) uint8, binder (B, k) uint8 -> (B, out_len) uint8."""
    return turboshake128_batch(xof_message(seed, dst, binder), 0x01, out_len)
