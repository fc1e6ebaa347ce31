"""Incremental Distributed Point Function (IdpfPoplar).

The IDPF underlying Poplar1 (draft-irtf-cfrg-vdaf-08 §8; consumed by the
reference through the prio crate's ``idpf`` module, SURVEY.md §2.2): a
two-party sharing of the function that is ``beta_inner[l]`` on every prefix
of ``alpha`` at inner level ``l``, ``beta_leaf`` at the leaf, and zero
everywhere else.  Inner nodes live in Field64, leaves in Field255.

Tree walk per level: ``extend`` (seed → two child seeds + control bits) and
``convert`` (seed → next seed + value-share vector), both via the fixed-key
AES XOF keyed by the nonce.  Key generation emits one correction word per
level; evaluation applies it gated on the evaluator's control bit.

Copy of ``janus_tpu/vdaf/idpf.py`` for the port: the per-report oracle the
batched walks in ``janus_tpu_torch.ops.poplar1_batch`` are held against.
tests/test_torch_poplar1.py holds its keys, public shares and evaluations
byte for byte against the JAX package's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

from ..fields import Field64, Field255
from ..xof import XofFixedKeyAes128
from .prio3 import VdafError

KEY_SIZE = 16


def _xor(a: bytes, b: bytes) -> bytes:
    return bytes(x ^ y for x, y in zip(a, b))


def _dst(usage: int) -> bytes:
    # (version 8, algorithm class 1 = IDPF, usage)
    return bytes([8, 1, 0, 0, 0, 0, 0, usage])


@dataclass
class IdpfCorrectionWord:
    seed_cw: bytes
    ctrl_cw: Tuple[int, int]
    w_cw: List[int]


class IdpfPoplar:
    """Two-party IDPF with VALUE_LEN-element payloads."""

    SHARES = 2

    def __init__(self, bits: int, value_len: int = 1):
        if bits < 1:
            raise ValueError("bits must be >= 1")
        self.BITS = bits
        self.VALUE_LEN = value_len
        self.RAND_SIZE = 2 * KEY_SIZE

    def field_at(self, level: int) -> type:
        return Field255 if level == self.BITS - 1 else Field64

    # ------------------------------------------------------------------
    def _extend(self, seed: bytes, nonce: bytes):
        """seed -> ([seed_L, seed_R], [ctrl_L, ctrl_R])"""
        xof = XofFixedKeyAes128(seed, _dst(0), nonce)
        s = [bytearray(xof.next(KEY_SIZE)) for _ in range(2)]
        ctrl = [s[0][0] & 1, s[1][0] & 1]
        s[0][0] &= 0xFE
        s[1][0] &= 0xFE
        return [bytes(s[0]), bytes(s[1])], ctrl

    def _convert(self, level: int, seed: bytes, nonce: bytes):
        """seed -> (next_seed, value-share vector at this level's field)"""
        xof = XofFixedKeyAes128(seed, _dst(1), nonce)
        next_seed = xof.next(KEY_SIZE)
        field = self.field_at(level)
        return next_seed, xof.next_vec(field, self.VALUE_LEN)

    # ------------------------------------------------------------------
    def gen(
        self,
        alpha: int,
        beta_inner: Sequence[Sequence[int]],
        beta_leaf: Sequence[int],
        nonce: bytes,
        rand: bytes,
    ) -> Tuple[List[IdpfCorrectionWord], List[bytes]]:
        """Returns (public_share = correction words, [key_0, key_1])."""
        if alpha >> self.BITS:
            raise VdafError("alpha out of range")
        if len(rand) != self.RAND_SIZE:
            raise VdafError("bad idpf rand size")
        if len(beta_inner) != self.BITS - 1:
            raise VdafError("wrong number of inner beta values")
        init_seed = [rand[0:KEY_SIZE], rand[KEY_SIZE : 2 * KEY_SIZE]]
        seed = list(init_seed)
        ctrl = [0, 1]
        correction_words: List[IdpfCorrectionWord] = []
        for level in range(self.BITS):
            field = self.field_at(level)
            bit = (alpha >> (self.BITS - 1 - level)) & 1
            keep, lose = bit, 1 - bit
            s0, t0 = self._extend(seed[0], nonce)
            s1, t1 = self._extend(seed[1], nonce)
            seed_cw = _xor(s0[lose], s1[lose])
            ctrl_cw = (t0[0] ^ t1[0] ^ bit ^ 1, t0[1] ^ t1[1] ^ bit)

            x0 = _xor(s0[keep], seed_cw) if ctrl[0] else s0[keep]
            x1 = _xor(s1[keep], seed_cw) if ctrl[1] else s1[keep]
            next_ctrl0 = t0[keep] ^ (ctrl[0] & ctrl_cw[keep])
            next_ctrl1 = t1[keep] ^ (ctrl[1] & ctrl_cw[keep])
            seed[0], w0 = self._convert(level, x0, nonce)
            seed[1], w1 = self._convert(level, x1, nonce)
            ctrl = [next_ctrl0, next_ctrl1]

            beta = beta_leaf if level == self.BITS - 1 else beta_inner[level]
            if len(beta) != self.VALUE_LEN:
                raise VdafError("bad beta length")
            # w_cw = beta - w0 + w1, negated if party 1's control bit is set
            w_cw = [
                field.sub(field.add(b, y1), y0) for b, y0, y1 in zip(beta, w0, w1)
            ]
            if ctrl[1]:
                w_cw = [field.neg(x) for x in w_cw]
            correction_words.append(IdpfCorrectionWord(seed_cw, ctrl_cw, w_cw))
        return correction_words, list(init_seed)

    # ------------------------------------------------------------------
    def eval(
        self,
        agg_id: int,
        public_share: Sequence[IdpfCorrectionWord],
        key: bytes,
        level: int,
        prefixes: Sequence[int],
        nonce: bytes,
    ) -> List[List[int]]:
        """Evaluate this party's share at each ``level``-bit prefix."""
        if agg_id not in (0, 1):
            raise VdafError("bad aggregator id")
        if not 0 <= level < self.BITS:
            raise VdafError("level out of range")
        for prefix in prefixes:
            if prefix >> (level + 1):
                raise VdafError("prefix out of range for level")

        # Shared-prefix path memoization: sibling prefixes reuse every
        # ancestor's extend/convert, so evaluating P prefixes costs ~O(P)
        # tree nodes instead of O(P * level).
        memo = {}

        def node(l: int, p: int):
            """State after level ``l`` on prefix ``p``: (seed, ctrl, value)."""
            hit = memo.get((l, p))
            if hit is not None:
                return hit
            if l == 0:
                parent_seed, parent_ctrl = key, agg_id  # party 1 starts set
            else:
                parent_seed, parent_ctrl, _ = node(l - 1, p >> 1)
            cw = public_share[l]
            s, t = self._extend(parent_seed, nonce)
            if parent_ctrl:
                s = [_xor(s[0], cw.seed_cw), _xor(s[1], cw.seed_cw)]
                t = [t[0] ^ cw.ctrl_cw[0], t[1] ^ cw.ctrl_cw[1]]
            bit = p & 1
            seed, w = self._convert(l, s[bit], nonce)
            ctrl = t[bit]
            field = self.field_at(l)
            if ctrl:
                w = [field.add(x, c) for x, c in zip(w, cw.w_cw)]
            value = [field.neg(x) for x in w] if agg_id == 1 else w
            memo[(l, p)] = (seed, ctrl, value)
            return memo[(l, p)]

        return [list(node(level, p)[2]) for p in prefixes]

    # ------------------------------------------------------------------
    # codec (public share <-> bytes; key is raw 16 bytes)

    def encode_public_share(self, correction_words: Sequence[IdpfCorrectionWord]) -> bytes:
        # packed control bits first, then per-level seed + value words
        # (mirrors the spec's packed encoding shape)
        out = bytearray()
        bits = []
        for cw in correction_words:
            bits.extend(cw.ctrl_cw)
        for i in range(0, len(bits), 8):
            byte = 0
            for j, b in enumerate(bits[i : i + 8]):
                byte |= b << j
            out.append(byte)
        for level, cw in enumerate(correction_words):
            field = self.field_at(level)
            out += cw.seed_cw
            out += field.encode_vec(cw.w_cw)
        return bytes(out)

    def decode_public_share(self, data: bytes) -> List[IdpfCorrectionWord]:
        nbits = 2 * self.BITS
        nbytes = (nbits + 7) // 8
        if len(data) < nbytes:
            raise VdafError("truncated idpf public share")
        bits = []
        for i in range(nbits):
            bits.append((data[i // 8] >> (i % 8)) & 1)
        # trailing bits in the last byte must be zero (canonical encoding)
        for i in range(nbits, nbytes * 8):
            if (data[i // 8] >> (i % 8)) & 1:
                raise VdafError("non-canonical idpf public share")
        pos = nbytes
        out = []
        for level in range(self.BITS):
            field = self.field_at(level)
            if len(data) < pos + KEY_SIZE + field.ENCODED_SIZE * self.VALUE_LEN:
                raise VdafError("truncated idpf public share")
            seed_cw = data[pos : pos + KEY_SIZE]
            pos += KEY_SIZE
            w_cw = field.decode_vec(
                data[pos : pos + field.ENCODED_SIZE * self.VALUE_LEN]
            )
            pos += field.ENCODED_SIZE * self.VALUE_LEN
            out.append(
                IdpfCorrectionWord(
                    seed_cw, (bits[2 * level], bits[2 * level + 1]), w_cw
                )
            )
        if pos != len(data):
            raise VdafError("trailing idpf public share bytes")
        return out
