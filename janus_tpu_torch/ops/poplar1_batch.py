"""Batched Poplar1 preparation: the IDPF walk and the sketch on the card.

Counterpart of ``janus_tpu/ops/poplar1_batch.py``.  Poplar1's prepare cost
splits into two halves:

* the IDPF tree walk — per (report, prefix) chains of fixed-key-AES
  extend/convert steps (draft-irtf-cfrg-vdaf-08 §8).  The batch walks
  level-synchronously: the frontier at level l is the set of distinct
  l-bit ancestors of the prefixes, and every node of every report at one
  level goes through one AES pass per usage (extend, convert).  The card
  walk (``_eval_batch_dev``, the one that serves) keeps the frontier seeds
  and control bits as tensors on the device across levels and hands the
  values out as a (B, P, n) limb matrix; the host walk
  (``eval_batch_host``) runs the same steps in numpy over `cryptography`'s
  AES-NI or the numpy soft AES, and is the reference the card walk is held
  against.
* the sketch — the z/zs inner products of the prefix values with the verify
  randomness: ``TField`` limb arithmetic over (B, P, n) on the device,
  Field64 (n = 2) at inner levels and Field255 (n = 8) at the leaf.

The TurboSHAKE work per report (the AES keys of the walk, the verify
randomness, the helper's correlated randomness) runs on the host, batched
over the reports (``ops/keccak.py`` on CPU tensors); a row whose
rejection sampling skips a candidate is recomputed by the scalar XOF.

A row whose value share took a rejected first candidate (``ok`` False)
is prepared by the per-report oracle, as the protocol's exact rule for the
row; ``oracle_recompute_rows`` counts such rows.  Byte parity with the
oracle (``janus_tpu_torch/vdaf/poplar1.py``) and with the JAX package's
batch is asserted in tests/test_torch_poplar1.py.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..fields import Field64, Field255, next_power_of_2
from ..vdaf.idpf import KEY_SIZE, _dst
from ..vdaf.prio3 import VdafError
from . import keccak
from .field import TField, tensor_to_u32

# -- the per-report TurboSHAKE, batched over the rows -----------------------


def _turboshake_rows(messages: np.ndarray, domain: int, length: int) -> np.ndarray:
    """TurboSHAKE128 of each row of ``messages`` ((B, L) uint8, one length
    for all rows) -> (B, length) uint8, on the host's CPU tensors."""
    return keccak.turboshake128_batch(torch.from_numpy(np.array(messages, dtype=np.uint8)), domain, length).numpy()


def _xof_turboshake_rows(seeds: Sequence[bytes], dst: bytes, binders: Sequence[bytes], length: int) -> np.ndarray:
    """``XofTurboShake128(seed, dst, binder).next(length)`` for each row."""
    head = bytes([len(dst)]) + dst
    msgs = np.frombuffer(b"".join(head + s + b for s, b in zip(seeds, binders)), dtype=np.uint8)
    return _turboshake_rows(msgs.reshape(len(seeds), -1), 0x01, length)


def _field_rows(field: type, stream: np.ndarray, count: int) -> Tuple[np.ndarray, np.ndarray]:
    """The first ``count`` rejection-sampling candidates of each row's XOF
    stream as (B, count, n) uint32 limbs (masked), and (B,) True where none
    was rejected — only then are they the row's ``next_vec(field, count)``."""
    B = stream.shape[0]
    n = field.ENCODED_SIZE // 4
    limbs = np.ascontiguousarray(stream[:, : count * field.ENCODED_SIZE]).view("<u4").reshape(B, count, n)
    mask = next_power_of_2(field.MODULUS) - 1
    mask_l = np.array([(mask >> (32 * i)) & 0xFFFFFFFF for i in range(n)], dtype=np.uint32)
    limbs = limbs & mask_l
    p_l = [(field.MODULUS >> (32 * i)) & 0xFFFFFFFF for i in range(n)]
    # lexicographic compare from the top limb: candidate < p
    lt = np.zeros((B, count), dtype=bool)
    eq = np.ones((B, count), dtype=bool)
    for i in range(n - 1, -1, -1):
        lt |= eq & (limbs[..., i] < p_l[i])
        eq &= limbs[..., i] == p_l[i]
    return limbs.astype(np.uint32), lt.all(axis=1)


# -- the walk's AES keys ----------------------------------------------------


def _fixed_keys(nonces: Sequence[bytes], usage: int) -> np.ndarray:
    """(B, 16) uint8: ``xof._fixed_key_aes128(_dst(usage), nonce)`` a row."""
    dst = _dst(usage)
    head = bytes([len(dst)]) + dst
    msgs = np.frombuffer(b"".join(head + n for n in nonces), dtype=np.uint8)
    return _turboshake_rows(msgs.reshape(len(nonces), -1), 0x02, 16)


class _HostWalkKeys:
    """The host walk's AES: per report and usage, `cryptography`'s AES-NI
    encryptor where it works (one ``update`` a report a level), else the
    numpy soft AES over the whole batch at once (one key schedule a row)."""

    def __init__(self, nonces: Sequence[bytes]):
        from ..utils.softaes import _ecb_functional, aes128_ecb_encryptor
        from .aes import expand_keys

        keys = [_fixed_keys(nonces, usage) for usage in (0, 1)]
        if _ecb_functional():
            self.enc = [[aes128_ecb_encryptor(k.tobytes()) for k in ku] for ku in keys]
            self.rk = None
        else:
            self.enc = None
            self.rk = [expand_keys(ku) for ku in keys]

    def encrypt(self, usage: int, blocks: np.ndarray) -> np.ndarray:
        """(B, K, 16) uint8 -> (B, K, 16) uint8 under each row's key."""
        if self.rk is not None:
            from ..utils.softaes import encrypt_blocks_multikey

            return encrypt_blocks_multikey(self.rk[usage], blocks)
        out = np.empty_like(blocks)
        for b, enc in enumerate(self.enc[usage]):
            out[b] = np.frombuffer(enc.update(blocks[b].tobytes()), dtype=np.uint8).reshape(blocks.shape[1:])
        return out


def _device_round_keys(nonces: Sequence[bytes], device: torch.device) -> List[torch.Tensor]:
    """The card walk's AES round keys: (B, 11, 16) int64 bytes a usage (0 =
    extend, 1 = convert) on ``device``.  Key derivation stays on the host
    (one TurboSHAKE a report and usage); only the block cipher runs on the
    device."""
    from .aes import expand_keys, to_device_bytes

    return [to_device_bytes(expand_keys(_fixed_keys(nonces, usage)), device) for usage in (0, 1)]


def _le128_index(nblocks: int) -> np.ndarray:
    """(nblocks, 16) uint8: le128(i) for i < nblocks."""
    idx = np.zeros((nblocks, 16), dtype=np.uint8)
    for i in range(nblocks):
        idx[i, :8] = np.frombuffer(int(i).to_bytes(8, "little"), dtype=np.uint8)
    return idx


def _hash_blocks(keys: _HostWalkKeys, usage: int, blocks: np.ndarray) -> np.ndarray:
    """The fixed-key hash over (B, K, 16) uint8 blocks, one AES pass:
    hash(x) = AES(k, sigma(x)) ^ sigma(x), sigma(xL||xR) = xR || (xL^xR)."""
    sigma = np.concatenate([blocks[..., 8:], blocks[..., :8] ^ blocks[..., 8:]], axis=-1)
    return keys.encrypt(usage, sigma) ^ sigma


def _xof_stream(keys: _HostWalkKeys, usage: int, seeds: np.ndarray, nblocks: int) -> np.ndarray:
    """XofFixedKeyAes128 streams of (B, K, 16) seeds -> (B, K, nblocks*16):
    block i hashes seed ^ le128(i); every seed and index in one pass."""
    B, K = seeds.shape[:2]
    blocks = seeds[:, :, None, :] ^ _le128_index(nblocks)[None, None]
    out = _hash_blocks(keys, usage, blocks.reshape(B, K * nblocks, 16))
    return out.reshape(B, K, nblocks * 16)


def _check_level(idpf, level: int, prefixes: Sequence[int]) -> List[List[int]]:
    """Validate (level, prefixes); the ancestor frontier of each level."""
    if not 0 <= level < idpf.BITS:
        raise VdafError("level out of range")
    for p in prefixes:
        if p >> (level + 1):
            raise VdafError("prefix out of range for level")
    return [sorted({p >> (level - l) for p in prefixes}) for l in range(level + 1)]


def _correction_words(public_shares: Sequence, level: int) -> Tuple[np.ndarray, np.ndarray, List[int]]:
    """Levels 0..level of every report's correction words: seeds (B, L, 16)
    uint8, control bits (B, L, 2) uint8, and the leaf level's value word."""
    B, L = len(public_shares), level + 1
    seed_cw = np.frombuffer(b"".join(cw.seed_cw for ps in public_shares for cw in ps[:L]), dtype=np.uint8)
    ctrl_cw = np.array([cw.ctrl_cw for ps in public_shares for cw in ps[:L]], dtype=np.uint8)
    w_cw = [int(ps[level].w_cw[0]) for ps in public_shares]
    return seed_cw.reshape(B, L, 16), ctrl_cw.reshape(B, L, 2), w_cw


@dataclass
class _WalkResult:
    """One agg-param group's staged walk: the per-(report, prefix) value
    shares plus what the sketch launch needs.  The card walk's values stay
    on the device (``y_limbs``, (B, P, n) int64 words); ``y_host`` holds
    the reference walk's host ints."""

    ok: np.ndarray  # (B,) — False: rejection-sampled value, redo on oracle
    abc: List[Tuple[int, int, int]]
    field: type
    y_host: Optional[np.ndarray] = None  # (B, P) object ints (host walk)
    y_limbs: Optional[torch.Tensor] = None  # (B, P, n) words (card walk)


@dataclass
class _StagedPoplar:
    """A staged poplar mega-batch: per-agg-param groups with their walks
    done, awaiting the sketch launch (the executor's stage/launch seam —
    walk k+1 overlaps sketch k on the stage/launch threads)."""

    agg_id: int
    n_requests: int
    #: (agg_param, idxs, per-request row counts, vks, rows, _WalkResult|None)
    groups: List[tuple]


class _PoplarSketchPlane:
    """The accumulator store's minting face for sketch vectors kept on the
    device: per-(field, prefix-count) sums and readback over (B, P, n)
    limb matrices, as ``CudaBackend.accumulate_rows`` / ``read_accum_buffer``
    do for Prio3 out shares.  Level fencing is the bucket key's job (it
    carries the encoded agg param), so one plane serves every flush of its
    (field, P) shape."""

    def __init__(self, tf: TField, field: type, prefixes_len: int, device: torch.device):
        self.tf = tf
        self.device = device
        #: drain-time field for the store (accumulator._evict / drain_all)
        self.accum_field = field
        #: bytes of one row of a retained matrix (int64 words)
        self.row_nbytes = prefixes_len * tf.n * 8

    def resident_byte_budget(self) -> Optional[int]:
        """A quarter of the card's memory (the store's default budget for
        the flushes this plane mints); None off the card."""
        if self.device.type != "cuda":
            return None
        return torch.cuda.get_device_properties(self.device).total_memory // 4

    def accumulate_rows(self, buffer, matrix, mask):
        """Add the ``mask``-selected rows of a (B, P, n) matrix to ``buffer``
        ((P, n) words on the device; None starts one).  No readback; a
        matrix the store evicted to the host goes back to the device."""
        m = matrix.to(self.device)
        sel = torch.from_numpy(np.asarray(mask, dtype=bool)).to(self.device)
        delta = self.tf.sum(torch.where(sel[:, None, None], m, torch.zeros_like(m)), axis=0)
        return delta if buffer is None else self.tf.add(buffer, delta)

    def read_accum_buffer(self, buffer) -> List[int]:
        """The drain's readback: ONE (P,) field vector."""
        return self.tf.from_limbs(tensor_to_u32(buffer))


def sketch_limbs(tf: TField, y_l: torch.Tensor, r_l: torch.Tensor, a_l: torch.Tensor, b_l: torch.Tensor) -> torch.Tensor:
    """The sketch's device half: (B, P, n) values y and verify randomness r,
    (B, n) correlated a and b (canonical words) -> (B, 2, n) rows of
    z = a + Σ r_i y_i and zs = b + Σ r_i² y_i."""
    r_m = tf.to_mont(r_l)
    ry = tf.mont_mul(r_m, y_l)  # r_i * y_i, canonical
    z = tf.add(a_l, tf.sum(ry, axis=1))
    rry = tf.mont_mul(r_m, ry)  # r_i^2 * y_i
    zs = tf.add(b_l, tf.sum(rry, axis=1))
    return torch.stack([z, zs], dim=1)


class BatchedPoplar1:
    """Level-synchronous batched IDPF evaluation and sketch for one Poplar1.

    The walk and the sketch run on tensors on ``device``; the walk keeps
    the frontier and the values there, and with a retain store the prepare
    states carry ResidentRefs in place of host vectors (zero sketch
    readback).  ``eval_batch_host`` and ``prep_init_batch_host`` are the
    same steps over the host's AES: the reference, which serves nothing."""

    def __init__(self, poplar1, device="cuda"):
        self.vdaf = poplar1
        self.idpf = poplar1.idpf
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("the Poplar1 walk needs a CUDA card, and none is available")
        self._tf: Dict[type, TField] = {}
        self._planes: Dict[tuple, _PoplarSketchPlane] = {}
        #: card-walked rows whose sketch vectors were read back to the host
        #: (0 while every flush keeps its vectors resident)
        self.sketch_readback_rows = 0
        #: rows whose ``ok`` flag was False, prepared by the oracle
        self.oracle_recompute_rows = 0

    def _tfield(self, field) -> TField:
        tf = self._tf.get(field)
        if tf is None:
            tf = self._tf[field] = TField(field)
        return tf

    def _plane(self, field, prefixes_len: int) -> _PoplarSketchPlane:
        key = (field, prefixes_len)
        plane = self._planes.get(key)
        if plane is None:
            plane = self._planes[key] = _PoplarSketchPlane(self._tfield(field), field, prefixes_len, self.device)
        return plane

    # -- batched IDPF eval ------------------------------------------------
    def eval_batch(self, agg_id: int, public_shares, keys: Sequence[bytes], level: int, prefixes, nonces):
        """Per-report, per-prefix value shares -> ((B, P) python-int array,
        (B,) ok), through the card walk, read back to the host."""
        y_limbs, ok = self._eval_batch_dev(agg_id, public_shares, keys, level, prefixes, nonces)
        return self._materialize_y(y_limbs, self.idpf.field_at(level)), ok

    def eval_batch_host(self, agg_id, public_shares, keys, level, prefixes, nonces):
        """The reference walk, numpy over the host's AES: ((B, P) python
        ints, (B,) ok), equal to :meth:`eval_batch`'s."""
        B, P = len(keys), len(prefixes)
        frontier = _check_level(self.idpf, level, prefixes)
        walk_keys = _HostWalkKeys(nonces)
        seed_cw, ctrl_cw, w_cw = _correction_words(public_shares, level)
        seeds = np.frombuffer(b"".join(keys), dtype=np.uint8).reshape(B, 1, 16)
        ctrl = np.full((B, 1), agg_id, dtype=np.uint8)
        prev = [0]
        for l in range(level + 1):
            field = self.idpf.field_at(l)
            conv_blocks = -(-(KEY_SIZE + field.ENCODED_SIZE) // 16)
            # extend every parent (the previous frontier) of every report
            ext = _xof_stream(walk_keys, 0, seeds, 2).reshape(B, len(prev), 2, 16).copy()
            t = ext[..., 0] & 1  # (B, NP, 2)
            ext[..., 0] &= 0xFE
            applied = ctrl.astype(bool)
            s = np.where(applied[:, :, None, None], ext ^ seed_cw[:, l, None, None, :], ext)
            t = np.where(applied[:, :, None], t ^ ctrl_cw[:, l, None, :], t)
            # convert the kept child of every frontier node
            nodes = frontier[l]
            pi = np.array([prev.index(n >> 1) for n in nodes])
            bit = np.array([n & 1 for n in nodes])
            x = s[:, pi, bit, :]  # (B, NF, 16)
            ctrl = t[:, pi, bit]  # (B, NF)
            conv = _xof_stream(walk_keys, 1, x, conv_blocks)  # (B, NF, conv_blocks*16)
            seeds = np.ascontiguousarray(conv[:, :, :KEY_SIZE])
            prev = nodes
        # the value shares at ``level``: the masked first candidate; a
        # rejected one flags the report for the oracle (exact, and rare)
        field = self.idpf.field_at(level)
        cand = conv[:, :, KEY_SIZE : KEY_SIZE + field.ENCODED_SIZE].reshape(B, -1)
        limbs, _ = _field_rows(field, cand, len(prev))
        raw = np.array(self._tfield(field).from_limbs(limbs), dtype=object).reshape(B, -1)
        ok = np.ones(B, dtype=bool)
        col = {node: i for i, node in enumerate(frontier[level])}
        y = np.empty((B, P), dtype=object)
        for b in range(B):
            for j, p in enumerate(prefixes):
                w = raw[b, col[p]]
                if w >= field.MODULUS:
                    ok[b] = False
                    w %= field.MODULUS  # placeholder; the row is redone
                if ctrl[b, col[p]]:
                    w = field.add(w, w_cw[b])
                y[b, j] = field.neg(w) if agg_id == 1 else w
        return y, ok

    def _materialize_y(self, y_limbs: torch.Tensor, field) -> np.ndarray:
        """Read a card-walked (B, P, n) matrix back to host ints — the
        readback the resident path exists to avoid; counted so a run can
        hold it at 0."""
        B, P = int(y_limbs.shape[0]), int(y_limbs.shape[1])
        ints = self._tfield(field).from_limbs(tensor_to_u32(y_limbs))
        y = np.empty((B, P), dtype=object)
        y.ravel()[:] = ints
        self.sketch_readback_rows += B
        from ..core.metrics import GLOBAL_METRICS

        if GLOBAL_METRICS.registry is not None:
            GLOBAL_METRICS.poplar_sketch_readback_rows.inc(B)
        return y

    # -- the card walk ------------------------------------------------------
    def _eval_batch_dev(self, agg_id: int, public_shares, keys: Sequence[bytes], level: int, prefixes, nonces):
        """The card walk: the same level-synchronous steps as the host
        walk, with the frontier seeds and control bits kept as tensors on
        the device across levels, and the values handed out as a (B, P, n)
        canonical limb matrix (int64 words) that the sketch and the
        resident store consume in place.  Bit-exact with the host walk:
        the same AES stream and byte order, the same rejection-sample
        masking (a rejected first candidate flags the row for the
        oracle), the same correction-word and
        sign handling.  Returns (y_limbs, ok)."""
        from .aes import encrypt_blocks_multikey, to_device_bytes

        dev = self.device
        B = len(keys)
        frontier = _check_level(self.idpf, level, prefixes)
        rk = _device_round_keys(nonces, dev)
        seed_cw_np, ctrl_cw_np, w_cw = _correction_words(public_shares, level)
        seed_cw = to_device_bytes(seed_cw_np, dev)  # (B, L, 16)
        ctrl_cw = to_device_bytes(ctrl_cw_np, dev)  # (B, L, 2)

        def xof_blocks(rks, seeds, nblocks: int):
            """Hashed XofFixedKeyAes128 blocks of (B, K, 16) seeds ->
            (B, K, nblocks, 16): block i = hash(seed ^ le128(i))."""
            k = seeds.shape[1]
            idx = to_device_bytes(_le128_index(nblocks), dev)
            blocks = (seeds[:, :, None, :] ^ idx[None, None]).reshape(B, k * nblocks, 16)
            sigma = torch.cat([blocks[..., 8:], blocks[..., :8] ^ blocks[..., 8:]], dim=-1)
            return (encrypt_blocks_multikey(rks, sigma) ^ sigma).reshape(B, k, nblocks, 16)

        seeds = to_device_bytes(np.frombuffer(b"".join(keys), dtype=np.uint8).reshape(B, 1, 16), dev)
        ctrl = torch.full((B, 1), agg_id, dtype=torch.int64, device=dev)
        prev = [0]
        for l in range(level + 1):
            field = self.idpf.field_at(l)
            conv_blocks = -(-(KEY_SIZE + field.ENCODED_SIZE) // 16)
            ext = xof_blocks(rk[0], seeds, 2)  # (B, NP, 2, 16)
            t = ext[..., 0] & 1  # (B, NP, 2)
            s = torch.cat([(ext[..., :1] & 0xFE), ext[..., 1:]], dim=-1)
            applied = ctrl.bool()
            s = torch.where(applied[:, :, None, None], s ^ seed_cw[:, l, None, None, :], s)
            t = torch.where(applied[:, :, None], t ^ ctrl_cw[:, l, None, :], t)
            nodes = frontier[l]
            pi = torch.tensor([prev.index(n >> 1) for n in nodes], dtype=torch.int64, device=dev)
            bit = torch.tensor([n & 1 for n in nodes], dtype=torch.int64, device=dev)
            x = s[:, pi, bit, :]  # (B, NF, 16)
            ctrl = t[:, pi, bit]  # (B, NF)
            conv = xof_blocks(rk[1], x, conv_blocks).reshape(B, len(nodes), conv_blocks * 16)
            seeds = conv[:, :, :KEY_SIZE]
            prev = nodes
        field = self.idpf.field_at(level)
        tf = self._tfield(field)
        n = tf.n
        raw = conv[:, :, KEY_SIZE : KEY_SIZE + field.ENCODED_SIZE].reshape(B, len(prev), n, 4)
        limbs = raw[..., 0] | (raw[..., 1] << 8) | (raw[..., 2] << 16) | (raw[..., 3] << 24)
        mask = next_power_of_2(field.MODULUS) - 1
        mask_l = torch.tensor([(mask >> (32 * i)) & 0xFFFFFFFF for i in range(n)], dtype=torch.int64, device=dev)
        limb_list = tf._split(limbs & mask_l)
        geq = ~tf.is_canonical_limbs(limb_list)  # (B, NF)
        w = tf._join(tf._cond_sub_p(limb_list, torch.zeros_like(limb_list[0])))
        w_cw_l = torch.from_numpy(tf.to_limbs(w_cw).astype(np.int64)).to(dev)  # (B, n)
        corrected = tf.add(w, w_cw_l[:, None, :])
        w = torch.where(ctrl.bool()[..., None], corrected, w)
        if agg_id == 1:
            w = tf.sub(torch.zeros_like(w), w)
        col = {node: i for i, node in enumerate(prev)}
        sel = torch.tensor([col[p] for p in prefixes], dtype=torch.int64, device=dev)
        y_limbs = w.index_select(1, sel)
        ok = (~torch.any(geq, dim=1)).cpu().numpy().copy()
        return y_limbs, ok

    # -- batched sketch ---------------------------------------------------
    def _verify_rands(self, verify_keys: Sequence[bytes], nonces: Sequence[bytes], agg_param) -> np.ndarray:
        """(B, P, n) uint32 limbs: each row's ``Poplar1._verify_rands``."""
        vdaf = self.vdaf
        field = vdaf.field_for_agg_param(agg_param)
        P = len(agg_param.prefixes)
        from ..vdaf.poplar1 import USAGE_VERIFY_RANDOMNESS

        level_be = struct.pack(">H", agg_param.level)
        # exactly P candidates a row; a row that rejects one of them is
        # recomputed by the scalar XOF
        stream = _xof_turboshake_rows(
            verify_keys, vdaf._dst(USAGE_VERIFY_RANDOMNESS), [n + level_be for n in nonces], P * field.ENCODED_SIZE
        )
        limbs, clean = _field_rows(field, stream, P)
        tf = self._tfield(field)
        for b in np.flatnonzero(~clean):
            limbs[b] = tf.to_limbs(vdaf._verify_rands(verify_keys[b], nonces[b], agg_param))
        return limbs

    def sketch_batch(self, verify_key, agg_id: int, agg_param, nonces, y, abc, y_limbs=None):
        """(z, zs) shares a report in one device pass.

        z = a + Σ r_i y_i ;  zs = b + Σ r_i² y_i — the (B, P) double inner
        product runs as TField limb math on the device; the verify
        randomness comes from the host TurboSHAKE (batched over the
        reports).  ``verify_key`` may be one per report (a sequence): the
        executor's poplar_init mega-batches carry rows of several tasks.
        ``y`` is the host walk's (B, P) ints, or None with ``y_limbs``,
        the card walk's (B, P, n) words, consumed in place."""
        vdaf = self.vdaf
        dev = self.device
        field = vdaf.field_for_agg_param(agg_param)
        tf = self._tfield(field)
        B, P = y.shape if y is not None else tuple(y_limbs.shape[:2])
        vks = [verify_key] * B if isinstance(verify_key, (bytes, bytearray)) else list(verify_key)

        def put(arr) -> torch.Tensor:
            return torch.from_numpy(np.asarray(arr, dtype=np.uint32).astype(np.int64)).to(dev)

        y_l = y_limbs if y_limbs is not None else put(tf.to_limbs([int(v) for v in y.ravel()]).reshape(B, P, tf.n))
        r_l = put(self._verify_rands(vks, nonces, agg_param))
        a_l = put(tf.to_limbs([int(a) for (a, _, _) in abc]))
        b_l = put(tf.to_limbs([int(b) for (_, b, _) in abc]))
        ints = tf.from_limbs(tensor_to_u32(sketch_limbs(tf, y_l, r_l, a_l, b_l)))  # (B, 2) elements
        return list(zip(ints[0::2], ints[1::2]))

    # -- the full batched round-0 prep ------------------------------------
    def prep_init_batch(self, verify_key: bytes, agg_id: int, agg_param, reports):
        """Batched ``Poplar1.prep_init`` over (nonce, public_share,
        input_share): per-report (state, share), byte-identical to the
        oracle's."""
        return self._prep_rows([verify_key] * len(reports), agg_id, agg_param, reports)

    def prep_init_batch_host(self, verify_key: bytes, agg_id: int, agg_param, reports):
        """:meth:`prep_init_batch` through the host walk (the sketch still on
        ``device``): the reference the card walk is held against."""
        walk = self._walk_rows(agg_id, agg_param, reports, host=True)
        return self._sketch_rows(agg_id, agg_param, [verify_key] * len(reports), reports, walk)

    def _corr_abc(self, agg_param, reports) -> List[Tuple[int, int, int]]:
        """Each report's (a, b, c) correlated-randomness share at the
        level: the leader's explicit triples, or the helper's expanded from
        its seed (batched over the helper rows)."""
        from ..vdaf.poplar1 import USAGE_CORR_INNER, USAGE_CORR_LEAF

        vdaf = self.vdaf
        level = agg_param.level
        leaf = level == vdaf.bits - 1
        abc: List[Optional[Tuple[int, int, int]]] = []
        seeded = []
        for i, (_nonce, _pub, share) in enumerate(reports):
            if share.corr_seed is None:
                abc.append(share.corr_leaf if leaf else share.corr_inner[level])
            else:
                abc.append(None)
                seeded.append(i)
        if not seeded:
            return abc
        # the helper's triple at ``level`` is candidates 3*level .. 3*level+2
        # of its inner stream (or 0..2 of its leaf stream)
        field, usage, first = (Field255, USAGE_CORR_LEAF, 0) if leaf else (Field64, USAGE_CORR_INNER, 3 * level)
        count = first + 3
        stream = _xof_turboshake_rows(
            [reports[i][2].corr_seed for i in seeded],
            vdaf._dst(usage),
            [b"\x01" + reports[i][0] for i in seeded],
            count * field.ENCODED_SIZE,
        )
        limbs, clean = _field_rows(field, stream, count)
        vals = self._tfield(field).from_limbs(limbs[:, first:count])
        for j, i in enumerate(seeded):
            if clean[j]:
                abc[i] = tuple(vals[3 * j : 3 * j + 3])
            else:
                inner, leaf_t = vdaf._corr_triples(reports[i][2].corr_seed, reports[i][0], 1)
                abc[i] = leaf_t if leaf else inner[level]
        return abc

    def _walk_rows(self, agg_id: int, agg_param, reports, host: bool = False) -> _WalkResult:
        """The WALK half: the IDPF eval plus the correlated-randomness
        triples — everything the sketch launch consumes.  The card walk's
        value shares stay on the device; ``host`` takes the reference
        walk."""
        vdaf = self.vdaf
        level = agg_param.level
        prefixes = list(agg_param.prefixes)
        nonces = [r[0] for r in reports]
        pubs = [r[1] for r in reports]
        keys = [r[2].idpf_key for r in reports]
        field = vdaf.field_for_agg_param(agg_param)
        abc = self._corr_abc(agg_param, reports)
        if host:
            y, ok = self.eval_batch_host(agg_id, pubs, keys, level, prefixes, nonces)
            return _WalkResult(ok=ok, abc=abc, field=field, y_host=y)
        from ..core.metrics import GLOBAL_METRICS

        if GLOBAL_METRICS.registry is not None:
            GLOBAL_METRICS.poplar_walk_rows.labels(backend="cuda").inc(len(reports))
        y_limbs, ok = self._eval_batch_dev(agg_id, pubs, keys, level, prefixes, nonces)
        return _WalkResult(ok=ok, abc=abc, field=field, y_limbs=y_limbs)

    def _sketch_rows(self, agg_id: int, agg_param, verify_keys, reports, walk: _WalkResult, retain_store=None):
        """The SKETCH half: one device pass for the (z, z*) inner products
        over the staged walk, then per-row state assembly.  With
        ``retain_store`` and a card-walked group, the store adopts the
        (B, P, n) value matrix and the prepare states carry ResidentRef
        rows in place of host vectors: the y values never leave the device
        (the commit sums rows in place; the drain reads ONE vector a
        bucket)."""
        from ..vdaf.poplar1 import Poplar1PrepareShare, Poplar1PrepareState, _field_tag

        vdaf = self.vdaf
        level = agg_param.level
        P = len(agg_param.prefixes)
        nonces = [r[0] for r in reports]
        B = len(reports)
        field = walk.field
        zzs = self.sketch_batch(verify_keys, agg_id, agg_param, nonces, walk.y_host, walk.abc, y_limbs=walk.y_limbs)
        fid = None
        if retain_store is not None and walk.y_limbs is not None:
            plane = self._plane(field, P)
            fid = retain_store.retain_flush(plane, walk.y_limbs, rows=B, nbytes=B * plane.row_nbytes)
        y_host = walk.y_host
        if fid is None and y_host is None:
            y_host = self._materialize_y(walk.y_limbs, field)
        if fid is not None:
            from ..executor.accumulator import ResidentRef
        out = []
        dead = []
        try:
            for b, ((z, zs), (a, bb, c)) in enumerate(zip(zzs, walk.abc)):
                if not walk.ok[b]:
                    # the first rejection-sampling candidate of some tree
                    # value was >= p: the oracle prepares the row, and its
                    # retained row is released so the matrix can free
                    self.oracle_recompute_rows += 1
                    if fid is not None:
                        dead.append(ResidentRef(fid, b))
                    out.append(
                        vdaf.prep_init(verify_keys[b], agg_id, agg_param, reports[b][0], reports[b][1], reports[b][2])
                    )
                    continue
                y_val = ResidentRef(fid, b) if fid is not None else [int(v) for v in y_host[b]]
                state = Poplar1PrepareState(
                    agg_id=agg_id, level=level, round=0, y_flat=y_val, a=a, b=bb, c=c, zs_share=zs
                )
                out.append((state, Poplar1PrepareShare(_field_tag(field), [z, zs])))
        except BaseException:
            # a failure after the retain must not pin the whole matrix: no
            # caller saw these refs, so every row is released first
            if fid is not None:
                retain_store.release_refs([ResidentRef(fid, b) for b in range(B)])
            raise
        if dead:
            retain_store.release_refs(dead)
        return out

    def _prep_rows(self, verify_keys, agg_id: int, agg_param, reports, retain_store=None):
        """One tree walk + one sketch pass for rows that may span several
        tasks (each row's own verify key seeds its sketch randomness)."""
        walk = self._walk_rows(agg_id, agg_param, reports)
        return self._sketch_rows(agg_id, agg_param, verify_keys, reports, walk, retain_store=retain_store)

    def stage_init_multi(self, agg_id: int, requests) -> _StagedPoplar:
        """The WALK half of :meth:`prep_init_multi`: group the flush's
        submissions by aggregation parameter and walk each group, leaving
        the value shares staged on the device for the sketch launch.  The
        executor runs this on its staging thread so walk k+1 overlaps
        sketch k."""
        groups_idx: Dict[object, List[int]] = {}
        for i, (_vk, agg_param, _reports) in enumerate(requests):
            groups_idx.setdefault(agg_param, []).append(i)
        groups = []
        for agg_param, idxs in groups_idx.items():
            vks: List[bytes] = []
            rows: list = []
            counts: List[int] = []
            for i in idxs:
                vk, _p, reports = requests[i]
                vks.extend([vk] * len(reports))
                rows.extend(reports)
                counts.append(len(reports))
            walk = self._walk_rows(agg_id, agg_param, rows) if rows else None
            groups.append((agg_param, idxs, counts, vks, rows, walk))
        return _StagedPoplar(agg_id, len(requests), groups)

    def launch_init_multi(self, staged: _StagedPoplar, retain_store=None):
        """The SKETCH half: a sketch pass per group and per-row state
        assembly over a staged walk.  Results return per request,
        byte-identical to separate ``prep_init_batch`` calls.  A later
        group's failure releases every earlier group's retained rows
        (their refs reached no caller) before re-raising."""
        results: List[Optional[list]] = [None] * staged.n_requests
        try:
            for agg_param, idxs, counts, vks, rows, walk in staged.groups:
                outs = (
                    self._sketch_rows(staged.agg_id, agg_param, vks, rows, walk, retain_store=retain_store)
                    if rows
                    else []
                )
                start = 0
                for i, n in zip(idxs, counts):
                    results[i] = outs[start : start + n]
                    start += n
        except BaseException:
            if retain_store is not None:
                from ..executor.accumulator import ResidentRef

                refs = [
                    st.y_flat
                    for outs in results
                    if outs
                    for st, _sh in (o for o in outs if isinstance(o, tuple))
                    if isinstance(st.y_flat, ResidentRef)
                ]
                if refs:
                    retain_store.release_refs(refs)
            raise
        return results

    def prep_init_multi(self, agg_id: int, requests, retain_store=None):
        """One walk serving rows of several jobs or tasks: the executor's
        poplar_init mega-batch form.  ``requests``: (verify_key,
        agg_param, reports) a submission.  Submissions sharing an
        aggregation parameter (jobs of one task at one tree level) run as
        one walk and one sketch pass with per-row verify keys; distinct
        parameters run one walk each (the frontier and the sketch binder
        are parameter-shaped).  Results return per request, byte-identical
        to separate ``prep_init_batch`` calls."""
        if not requests:
            return []
        return self.launch_init_multi(self.stage_init_multi(agg_id, requests), retain_store=retain_store)
