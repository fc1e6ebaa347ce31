"""Planar TurboSHAKE128: the K1 squeeze and K2 absorb kernels and their wrappers.

Counterpart of ``janus_tpu/ops/keccak_pallas.py``.  Streams are word-major
planes ``(W, B)`` of u32 words in int32 storage: plane w holds stream word w
of every report.  For B a multiple of 128 that is the same memory as the
Pallas kernels' ``(W, B // 128, 128)``, so ``janus_tpu_torch.state`` adapts
between them with a reshape; the port drops the ``B % 1024`` gate.

- ``squeeze`` (K1, ``csrc/keccak.cu`` janus_keccak_squeeze) replaces
  ``_squeeze_kernel``: TurboSHAKE128 of one padded block, nb output blocks.
- ``absorb`` (K2, janus_keccak_absorb) replaces ``_absorb_kernel``: a
  multi-block absorb, first <= 42 output words.
- ``absorb_select`` (K2's select variant, janus_keccak_absorb_select): the
  same absorb over messages padded at per-row lengths, each row's output
  taken after its own final block (canonical shape padding; plain version
  ``keccak.turboshake128_batch_select``, counterpart of
  ``keccak_jax.turboshake128_batch_select``, plain ``jnp`` in the JAX
  package).

Each wrapper launches its CUDA kernel for a tensor on the card, or raises,
and takes the plain PyTorch version beside it only for a tensor on the CPU.
``launches`` on each wrapper counts its kernel launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from .field import storage, words
from .keccak import (
    RATE_WORDS,
    absorb_words,
    absorb_words_select,
    bytes_to_words,
    check_final_blocks,
    lanes_to_words,
    pad_message,
    squeeze_words,
    words_to_lanes,
    xof_message,
)

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib(source: str = "keccak"):
    """The loaded Keccak library (or that of another source with its C
    interface, see ``_build.source_path``), its entry points typed."""
    lib = _build.load(source)
    for fn in (lib.janus_keccak_squeeze, lib.janus_keccak_absorb):
        fn.argtypes = [_P, _P, _I, _I, _I, _P]
        fn.restype = _I
    lib.janus_keccak_absorb_select.argtypes = [_P, _P, _P, _I, _I, _I, _P]
    lib.janus_keccak_absorb_select.restype = _I
    return lib


def _check_planes(x: torch.Tensor, rows_multiple: int, what: str) -> None:
    if x.dtype != torch.int32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"{what}: want a contiguous int32 (W, B) plane tensor")
    if x.shape[0] % rows_multiple:
        raise ValueError(f"{what}: {x.shape[0]} words is not a multiple of {rows_multiple}")


def _stream(x: torch.Tensor) -> int:
    """The current stream of ``x``'s card.  The C entry points launch on
    the CUDA runtime's current device, so every launch below runs inside
    ``torch.cuda.device(x.device)``: a tensor on another card than the
    current one launches on its own card."""
    return torch.cuda.current_stream(x.device).cuda_stream


# -- K1: squeeze ---------------------------------------------------------------

def squeeze_plain(msg: torch.Tensor, out_words: int) -> torch.Tensor:
    """Plain version of K1: (42, B) padded one-block messages -> (out_words, B)."""
    w = words(msg)
    zeros = torch.zeros((4,) + w.shape[1:], dtype=torch.int64, device=w.device)
    state = torch.cat([words_to_lanes(w), zeros], dim=0)
    return storage(squeeze_words(state, out_words, first_permuted=False))


def squeeze(msg: torch.Tensor, out_words: int) -> torch.Tensor:
    """K1 wrapper: (42, B) int32 padded messages -> (out_words, B) int32 stream."""
    _check_planes(msg, RATE_WORDS, "squeeze")
    if msg.shape[0] != RATE_WORDS:
        raise ValueError("squeeze takes exactly one 42-word block per report")
    if msg.device.type == "cpu":
        return squeeze_plain(msg, out_words)
    B = msg.shape[1]
    nb = -(-out_words // RATE_WORDS)
    out = torch.empty((out_words, B), dtype=torch.int32, device=msg.device)
    lib = _lib()
    with torch.cuda.device(msg.device):
        err = lib.janus_keccak_squeeze(msg.data_ptr(), out.data_ptr(), B, nb, out_words, _stream(msg))
    _build.check(err, "janus_keccak_squeeze")
    squeeze.launches += 1
    return out


squeeze.launches = 0


# -- K2: absorb ----------------------------------------------------------------

def absorb_plain(msg: torch.Tensor, out_words: int) -> torch.Tensor:
    """Plain version of K2: (na*42, B) padded blocks -> (out_words, B)."""
    state = absorb_words(words(msg))
    return storage(lanes_to_words(state[:21])[:out_words])


def absorb(msg: torch.Tensor, out_words: int) -> torch.Tensor:
    """K2 wrapper: (na*42, B) int32 padded message blocks -> (out_words, B)."""
    _check_planes(msg, RATE_WORDS, "absorb")
    if out_words > RATE_WORDS:
        raise NotImplementedError("multi-block squeeze after a multi-block absorb")
    if msg.device.type == "cpu":
        return absorb_plain(msg, out_words)
    B = msg.shape[1]
    na = msg.shape[0] // RATE_WORDS
    out = torch.empty((out_words, B), dtype=torch.int32, device=msg.device)
    lib = _lib()
    with torch.cuda.device(msg.device):
        err = lib.janus_keccak_absorb(msg.data_ptr(), out.data_ptr(), B, na, out_words, _stream(msg))
    _build.check(err, "janus_keccak_absorb")
    absorb.launches += 1
    return out


absorb.launches = 0


def absorb_select_plain(msg: torch.Tensor, last_block: torch.Tensor, out_words: int) -> torch.Tensor:
    """Plain version of the K2 select variant: (na*42, B) blocks, each row
    padded at its own length, and its final block (B,) -> (out_words, B)."""
    state = absorb_words_select(words(msg), last_block)
    return storage(lanes_to_words(state[:21])[:out_words])


def absorb_select(msg: torch.Tensor, last_block: torch.Tensor, out_words: int) -> torch.Tensor:
    """K2 select wrapper: (na*42, B) int32 message blocks, each row padded
    at its own length, and ``last_block`` (B,) int32, each row's final block
    (0 <= last_block < na) -> (out_words, B), the rate state after that
    block."""
    _check_planes(msg, RATE_WORDS, "absorb_select")
    if out_words > RATE_WORDS:
        raise NotImplementedError("multi-block squeeze after a multi-block absorb")
    B = msg.shape[1]
    if last_block.dtype != torch.int32 or last_block.shape != (B,) or not last_block.is_contiguous():
        raise ValueError("absorb_select: want a contiguous int32 (B,) final-block tensor")
    if last_block.device != msg.device:
        raise ValueError("absorb_select: the message and the final blocks lie on different devices")
    if msg.device.type == "cpu":
        return absorb_select_plain(msg, last_block, out_words)
    na = msg.shape[0] // RATE_WORDS
    # a row whose final block is out of range would never store: refuse it
    # as the plain version does (one reduction and a sync)
    check_final_blocks(last_block, na)
    out = torch.empty((out_words, B), dtype=torch.int32, device=msg.device)
    lib = _lib()
    with torch.cuda.device(msg.device):
        err = lib.janus_keccak_absorb_select(
            msg.data_ptr(), last_block.data_ptr(), out.data_ptr(), B, na, out_words, _stream(msg)
        )
    _build.check(err, "janus_keccak_absorb_select")
    absorb_select.launches += 1
    return out


absorb_select.launches = 0


# -- planar XOF entry points ---------------------------------------------------

def rows_to_planes(rows: torch.Tensor) -> torch.Tensor:
    """(B, W) row-major words -> (W, B) planes."""
    return rows.transpose(0, 1).contiguous()


def planes_to_rows(planes: torch.Tensor) -> torch.Tensor:
    """(W, B) planes -> (B, W) row-major words."""
    return planes.transpose(0, 1).contiguous()


def padded_message_planes(seed: torch.Tensor, dst: bytes, binder: torch.Tensor) -> torch.Tensor:
    """XofTurboShake128 message, TurboSHAKE-padded, as (nblocks*42, B) int32."""
    padded = pad_message(xof_message(seed, dst, binder), 0x01)
    return rows_to_planes(storage(bytes_to_words(padded)))


def xof_planes(seed: torch.Tensor, dst: bytes, binder: torch.Tensor, out_words: int) -> torch.Tensor:
    """Batched XofTurboShake128 stream in planes, for a one-block message:
    seed (B, 16) uint8, binder (B, k) uint8 -> (out_words, B) int32."""
    msg = padded_message_planes(seed, dst, binder)
    if msg.shape[0] != RATE_WORDS:
        raise NotImplementedError("xof_planes requires a single-block message")
    return squeeze(msg, out_words)


def xof_words(seed: torch.Tensor, dst: bytes, binder: torch.Tensor, out_words: int) -> torch.Tensor:
    """Batched XofTurboShake128 -> (out_words, B) planes: the squeeze kernel
    for a one-block message, the absorb kernel (out_words <= 42) otherwise."""
    msg = padded_message_planes(seed, dst, binder)
    if msg.shape[0] == RATE_WORDS:
        return squeeze(msg, out_words)
    return absorb(msg, out_words)


def absorb_planes(msg_planes: torch.Tensor, out_words: int) -> torch.Tensor:
    """Absorb a caller-built, already padded planar message -> (out_words, B)."""
    return absorb(msg_planes, out_words)


def const_word_planes(data: bytes, B: int, device) -> torch.Tensor:
    """Constant bytes (a multiple of 4) as (len/4, B) int64 word planes."""
    w = np.frombuffer(data, dtype="<u4").astype(np.int64)
    return torch.from_numpy(w).to(device)[:, None].expand(-1, B)
