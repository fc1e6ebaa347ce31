"""Execution backends for Prio3 preparation: CPU oracle and CUDA batch.

Counterpart of ``janus_tpu/vdaf/backend.py`` (``StagedPrepInit``,
``OracleBackend``, ``TpuBackend``).  ``CudaBackend`` has the same
duck-typed surface the executor calls: it marshals a flush of reports into
tensors on the card, runs one batched prepare through the CUDA kernels, reads
the results back and hands out oracle-level types (``Prio3PrepareState``,
``Prio3PrepareShare``), byte-identical to the oracle.

A row whose device ``ok`` flag is False (an XOF candidate >= p that the
protocol's rejection sampling skips, or a query point on a root of unity) is
recomputed by the oracle: that is the protocol's exact rule for the row, not
a device fallback, and ``oracle_recompute_rows`` counts such rows.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..fields import next_power_of_2
from ..ops.field import tensor_to_u32, u32_to_tensor
from ..ops.prepare import BatchedPrio3
from ..xof import XofTurboShake128
from .prio3 import Prio3, Prio3InputShare, Prio3PrepareShare, Prio3PrepareState, VdafError

#: A per-report prepare outcome: either a result or the error that rejected it.
PrepOutcome = Union[Tuple[Prio3PrepareState, Prio3PrepareShare], VdafError]
#: (nonce, public share, input share) of one report.
Report = Tuple[bytes, Optional[List[bytes]], Prio3InputShare]


@dataclass
class StagedPrepInit:
    """Device-resident half of a prepare launch: marshalled inputs already on
    the card (``stage_prep_init_multi``), consumed by ``launch_prep_init_multi``."""

    agg_id: int
    placed: Dict[str, torch.Tensor]
    #: padded batch size the launch runs at
    pad_to: int
    #: real rows in the batch (readbacks slice to this)
    rows: int


class OracleBackend:
    """Scalar per-report loop over the CPU oracle."""

    name = "oracle"

    def __init__(self, vdaf: Prio3):
        self.vdaf = vdaf

    def prep_init_batch(self, verify_key: bytes, agg_id: int, reports: Sequence[Report]) -> List[PrepOutcome]:
        out: List[PrepOutcome] = []
        for nonce, public_share, input_share in reports:
            try:
                out.append(self.vdaf.prep_init(verify_key, agg_id, nonce, public_share, input_share))
            except VdafError as e:
                out.append(e)
        return out

    def prep_shares_to_prep_batch(
        self, prep_shares: Sequence[Sequence[Prio3PrepareShare]]
    ) -> List[Union[Optional[bytes], VdafError]]:
        out: List[Union[Optional[bytes], VdafError]] = []
        for shares in prep_shares:
            try:
                out.append(self.vdaf.prep_shares_to_prep(shares))
            except VdafError as e:
                out.append(e)
        return out


def _req_parts(req):
    """A request is (verify_key, reports) or (verify_key, reports, actual_vdaf)."""
    return req[0], req[1], (req[2] if len(req) > 2 else None)


def _shape_key(vdaf) -> tuple:
    valid = vdaf.flp.valid
    params = tuple(sorted((k, v) for k, v in vars(valid).items() if isinstance(v, (int, str, bool))))
    return (vdaf.algorithm_id, type(valid).__name__, params, vdaf.num_shares, vdaf.num_proofs)


class CudaBackend:
    """Batched prepare on the card: one pass of CUDA kernels per flush."""

    name = "cuda"

    def __init__(self, vdaf: Prio3, device="cuda"):
        if vdaf.xof is not XofTurboShake128:
            raise VdafError("the CUDA backend requires the TurboSHAKE XOF")
        self.vdaf = vdaf
        self.device = torch.device(device)
        self.bp = BatchedPrio3(vdaf, device=self.device)
        self.oracle = OracleBackend(vdaf)
        self._oracles: Dict[tuple, OracleBackend] = {}
        #: out-share rows read back from the card by prepare launches
        self.outshare_readback_rows = 0
        #: rows whose device ok flag was False, recomputed by the oracle
        self.oracle_recompute_rows = 0

    def oracle_for(self, vdaf=None) -> OracleBackend:
        """The bit-exact CPU oracle for ``vdaf`` (None or own = this backend's)."""
        if vdaf is None or vdaf is self.vdaf:
            return self.oracle
        key = _shape_key(vdaf)
        o = self._oracles.get(key)
        if o is None:
            o = self._oracles[key] = OracleBackend(vdaf)
        return o

    # -- marshaling ------------------------------------------------------
    def _marshal(self, agg_id: int, reports: Sequence[Report], pad_to: int) -> Dict[str, np.ndarray]:
        """Host arrays of one flush, padded to ``pad_to`` rows by repeating
        the last row (the padding rows are sliced off after the launch)."""
        vdaf, flp, f = self.vdaf, self.vdaf.flp, self.bp.f
        B = len(reports)
        seed_size = vdaf.xof.SEED_SIZE

        def pad_rows(arr: np.ndarray) -> np.ndarray:
            return np.concatenate([arr, np.repeat(arr[-1:], pad_to - B, axis=0)])

        def stack_bytes(rows, width) -> np.ndarray:
            return pad_rows(np.frombuffer(b"".join(rows), dtype=np.uint8).reshape(B, width))

        kw: Dict[str, np.ndarray] = {"nonces_u8": stack_bytes([r[0] for r in reports], vdaf.NONCE_SIZE)}
        if flp.JOINT_RAND_LEN > 0:
            kw["public_parts_u8"] = stack_bytes(
                [b"".join(r[1]) for r in reports], vdaf.num_shares * seed_size
            ).reshape(pad_to, vdaf.num_shares, seed_size)
            kw["blinds_u8"] = stack_bytes([r[2].joint_rand_blind for r in reports], seed_size)
        if agg_id == 0:
            meas = f.to_limbs([x for r in reports for x in r[2].meas_share])
            proofs = f.to_limbs([x for r in reports for x in r[2].proofs_share])
            kw["meas_limbs"] = pad_rows(meas.reshape(B, flp.MEAS_LEN, f.n))
            kw["proofs_limbs"] = pad_rows(proofs.reshape(B, flp.PROOF_LEN * vdaf.num_proofs, f.n))
        else:
            kw["share_seeds_u8"] = stack_bytes([r[2].share_seed for r in reports], seed_size)
        return kw

    def _pad_to(self, B: int) -> int:
        """Power-of-two buckets, as the JAX backend pads."""
        return next_power_of_2(B)

    def _place(self, kw: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        placed = {}
        for k, v in kw.items():
            if v.dtype == np.uint32:
                placed[k] = u32_to_tensor(v, self.device)
            else:
                placed[k] = torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
        return placed

    # -- batch APIs ------------------------------------------------------
    def prep_init_batch(self, verify_key: bytes, agg_id: int, reports: Sequence[Report]) -> List[PrepOutcome]:
        """Single-task form of ``prep_init_multi``."""
        if not reports:
            return []
        return self.prep_init_multi(agg_id, [(verify_key, reports)])[0]

    def stage_prep_init_multi(self, agg_id: int, requests, pad_to: Optional[int] = None) -> Optional[StagedPrepInit]:
        """Host half of a launch: flatten the requests, marshal, pad to the
        power-of-two bucket and copy to the card.  None when no rows."""
        flat: List[Report] = []
        vk_rows: List[np.ndarray] = []
        for req in requests:
            verify_key, reports, _actual = _req_parts(req)
            flat.extend(reports)
            vk_rows.extend([np.frombuffer(verify_key, dtype=np.uint8)] * len(reports))
        if not flat:
            return None
        B = len(flat)
        pad_to = max(pad_to or 0, self._pad_to(B))
        kw = self._marshal(agg_id, flat, pad_to)
        vk = np.stack(vk_rows)
        kw["verify_key_u8"] = np.concatenate([vk, np.repeat(vk[-1:], pad_to - B, axis=0)])
        return StagedPrepInit(agg_id=agg_id, placed=self._place(kw), pad_to=pad_to, rows=B)

    def _prep_fn(self, agg_id: int, pad_to: int):
        """The prepare that serves a flush padded to ``pad_to`` rows, chosen
        up front from the padded size as the JAX ``TpuBackend._prep_fn``
        chooses: the planar path for Histogram and one-bit SumVec, the row
        path for everything else (Count, Sum, SumVec with bits > 1,
        Histogram with MEAS_LEN > 65535, any flush past 65535 rows).  Where
        the JAX package takes its limb-planar Count/Sum path, the port takes
        the row path, which is the faster one on the card."""
        return getattr(self.bp, self.bp.prep_route(agg_id, pad_to))

    def launch_prep_init_multi(self, staged: StagedPrepInit, requests) -> List[List[PrepOutcome]]:
        """Device half: run the batched prepare, read back once, slice the
        results per request."""
        agg_id, B = staged.agg_id, staged.rows
        kw = dict(staged.placed)
        vk = kw.pop("verify_key_u8")
        out = self._prep_fn(agg_id, staged.pad_to)(
            agg_id,
            vk,
            kw["nonces_u8"],
            share_seeds_u8=kw.get("share_seeds_u8"),
            meas_limbs=kw.get("meas_limbs"),
            proofs_limbs=kw.get("proofs_limbs"),
            blinds_u8=kw.get("blinds_u8"),
            public_parts_u8=kw.get("public_parts_u8"),
        )
        outputs = {
            "ok": out["ok"][:B].cpu().numpy(),
            "verifiers": tensor_to_u32(out["verifiers"][:B]),
            "out_share": tensor_to_u32(out["out_share"][:B]),
        }
        if self.vdaf.flp.JOINT_RAND_LEN > 0:
            outputs["joint_rand_part"] = out["joint_rand_part"][:B].cpu().numpy()
            outputs["corrected_seed"] = out["corrected_seed"][:B].cpu().numpy()
        self.outshare_readback_rows += B
        results: List[List[PrepOutcome]] = []
        start = 0
        for req in requests:
            verify_key, reports, actual = _req_parts(req)
            n = len(reports)
            view = {k: v[start : start + n] for k, v in outputs.items()}
            results.append(self._unmarshal_prep(verify_key, agg_id, reports, view, actual_vdaf=actual))
            start += n
        return results

    def prep_init_multi(self, agg_id: int, requests) -> List[List[PrepOutcome]]:
        """One launch preparing the reports of several tasks that share this
        backend's VDAF shape; per-row verify keys, per-request results."""
        if not requests:
            return []
        staged = self.stage_prep_init_multi(agg_id, requests)
        if staged is None:
            return [[] for _ in requests]
        return self.launch_prep_init_multi(staged, requests)

    def _unmarshal_prep(self, verify_key, agg_id, reports, out, actual_vdaf=None) -> List[PrepOutcome]:
        flp, f = self.vdaf.flp, self.bp.f
        out_len = (actual_vdaf or self.vdaf).flp.OUTPUT_LEN
        oracle = self.oracle_for(actual_vdaf)
        has_jr = flp.JOINT_RAND_LEN > 0
        results: List[PrepOutcome] = []
        for b in range(len(reports)):
            if not out["ok"][b]:
                self.oracle_recompute_rows += 1
                results.extend(oracle.prep_init_batch(verify_key, agg_id, [reports[b]]))
                continue
            state = Prio3PrepareState(
                out_share=f.from_limbs(out["out_share"][b, :out_len]),
                corrected_joint_rand_seed=out["corrected_seed"][b].tobytes() if has_jr else None,
            )
            share = Prio3PrepareShare(
                verifiers_share=f.from_limbs(out["verifiers"][b]),
                joint_rand_part=out["joint_rand_part"][b].tobytes() if has_jr else None,
            )
            results.append((state, share))
        return results

    def prep_shares_to_prep_batch(
        self, prep_shares: Sequence[Sequence[Prio3PrepareShare]]
    ) -> List[Union[Optional[bytes], VdafError]]:
        """Combine the aggregators' prepare shares and decide, per report."""
        if not prep_shares:
            return []
        vdaf, flp, f = self.vdaf, self.vdaf.flp, self.bp.f
        S = vdaf.num_shares
        bad_rows = {i for i, row in enumerate(prep_shares) if len(row) != S}
        if bad_rows:
            good = iter(self.prep_shares_to_prep_batch([r for i, r in enumerate(prep_shares) if i not in bad_rows]))
            return [
                VdafError("wrong number of prepare shares") if i in bad_rows else next(good)
                for i in range(len(prep_shares))
            ]
        B = len(prep_shares)
        pad_to = self._pad_to(B)
        has_jr = flp.JOINT_RAND_LEN > 0
        ver_len = flp.VERIFIER_LEN * vdaf.num_proofs
        vs, parts = [], []
        for a in range(S):
            limbs = f.to_limbs([x for row in prep_shares for x in row[a].verifiers_share])
            limbs = limbs.reshape(B, ver_len, f.n)
            limbs = np.concatenate([limbs, np.repeat(limbs[-1:], pad_to - B, axis=0)])
            vs.append(torch.from_numpy(limbs.astype(np.int64)).to(self.device))
            if has_jr:
                arr = np.frombuffer(
                    b"".join(row[a].joint_rand_part for row in prep_shares), dtype=np.uint8
                ).reshape(B, vdaf.xof.SEED_SIZE)
                arr = np.concatenate([arr, np.repeat(arr[-1:], pad_to - B, axis=0)])
                parts.append(torch.from_numpy(arr).to(self.device))
        out = self.bp.prep_shares_to_prep(vs, parts if has_jr else None)
        decide = out["decide"][:B].cpu().numpy()
        seeds = out["prep_msg_seed"][:B].cpu().numpy() if has_jr else None
        results: List[Union[Optional[bytes], VdafError]] = []
        for b in range(B):
            if not decide[b]:
                results.append(VdafError("proof verification failed"))
            elif has_jr:
                results.append(seeds[b].tobytes())
            else:
                results.append(None)
        return results

    # -- aggregation -------------------------------------------------------
    def accumulate_rows(self, buffer, matrix: torch.Tensor, mask: np.ndarray):
        """Add the ``mask``-selected rows of an out-share matrix (pad, OUT, n)
        on the card to ``buffer`` ((OUT, n) limbs; None starts one)."""
        f = self.bp.f
        m = torch.from_numpy(np.asarray(mask, dtype=bool)).to(self.device)
        delta = self.bp.aggregate(matrix, m)
        if buffer is None:
            return delta
        return f.add(buffer, delta)

    def read_accum_buffer(self, buffer) -> List[int]:
        return self.bp.f.from_limbs(tensor_to_u32(buffer))

    def aggregate_batch(self, out_shares_limbs, mask) -> List[int]:
        """Masked out-share sum on the card: (B, OUT, n) uint32 limbs and a
        (B,) bool mask -> the aggregate share as field integers."""
        shares = np.asarray(out_shares_limbs, dtype=np.uint32)
        m = np.asarray(mask, dtype=bool)
        B = shares.shape[0]
        pad_to = self._pad_to(B)
        if pad_to != B:  # zero rows masked off: no effect on the sum
            shares = np.concatenate([shares, np.zeros((pad_to - B,) + shares.shape[1:], np.uint32)])
            m = np.concatenate([m, np.zeros(pad_to - B, dtype=bool)])
        agg = self.bp.aggregate(u32_to_tensor(shares, self.device), torch.from_numpy(m).to(self.device))
        return self.bp.f.from_limbs(tensor_to_u32(agg))
