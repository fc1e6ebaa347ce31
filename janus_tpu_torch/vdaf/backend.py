"""Execution backends for VDAF preparation: CPU oracle and CUDA batch.

Counterpart of ``janus_tpu/vdaf/backend.py`` (``StagedPrepInit``,
``OracleBackend``, ``TpuBackend``, ``HybridXofBackend`` and the module
functions the executor and the aggregator call).  ``CudaBackend`` has the
same duck-typed surface the executor calls: it marshals a flush of reports
into tensors on the card, runs one batched prepare through the CUDA
kernels, reads the results back and hands out oracle-level types
(``Prio3PrepareState``, ``Prio3PrepareShare``), byte-identical to the
oracle.  With a
``retain_store`` (``executor/accumulator.py``) the flush's out-share matrix
stays on the card and each state carries a ``ResidentRef``.

The leader's measurement and proof shares are marshalled from their
encoding: an encoded field element is its little-endian u32 limbs, so a
flush becomes one ``np.frombuffer``.  A share decoded from the wire keeps
the bytes it arrived in (``Prio3InputShare.encoded_vectors``); a share
built from field integers is encoded first.

A row whose device ``ok`` flag is False (an XOF candidate >= p that the
protocol's rejection sampling skips, or a query point on a root of unity) is
recomputed by the oracle: that is the protocol's exact rule for the row, not
a device fallback, and ``oracle_recompute_rows`` counts such rows.

``CudaBackend(twin, canonical=True)`` serves every task of a canonical
bucket (``vdaf/canonical.py``): its VDAF is the bucket's padded twin, and a
request ``(verify_key, reports, task_vdaf)`` names the task's own VDAF.  A
flush whose rows all belong to one task shape runs that shape's own
prepare, unpadded (planar where the shape is eligible).  A flush that mixes
shapes runs the twin: the marshal puts the leader's measurement limbs in the
leading columns, leaves the pad columns zero and gives each row its
``meas_len``, and the masked row path prepares.  Either way out shares come
back at the task's OUTPUT_LEN, and a not-ok row is recomputed by the task's
oracle, never the twin's.

A Prio3 whose XOF is not TurboSHAKE128 (the HMAC-SHA256-AES128 multiproof
SumVec) has no XOF on the card: ``HybridXofBackend`` runs its XOF on the
host and its FLP query and decide on the card.  A Poplar1 is served by
``Poplar1Backend``: the IDPF walk and the sketch of ``ops/poplar1_batch.py``
behind the executor's ``poplar_init`` kind.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor, wait
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core import faults
from ..fields import next_power_of_2
from ..ops.field import tensor_to_u32, u32_to_tensor, words
from ..ops.prepare import FIELD_BACKENDS, BatchedPrio3
from ..xof import XofTurboShake128
from .prio3 import (
    USAGE_JOINT_RAND_PART,
    USAGE_JOINT_RANDOMNESS,
    USAGE_MEAS_SHARE,
    USAGE_PROOF_SHARE,
    USAGE_QUERY_RANDOMNESS,
    Prio3,
    Prio3InputShare,
    Prio3PrepareShare,
    Prio3PrepareState,
    VdafError,
)

#: A per-report prepare outcome: either a result or the error that rejected it.
PrepOutcome = Union[Tuple[Prio3PrepareState, Prio3PrepareShare], VdafError]
#: (nonce, public share, input share) of one report.
Report = Tuple[bytes, Optional[List[bytes]], Prio3InputShare]


@dataclass
class StagedPrepInit:
    """Device-resident half of a prepare launch: marshalled inputs already on
    the card (``stage_prep_init_multi``), consumed by ``launch_prep_init_multi``."""

    agg_id: int
    #: the marshalled tensors on the card; on a ``MeshBackend`` one dict a
    #: shard, each on its shard's device
    placed: Union[Dict[str, torch.Tensor], List[Dict[str, torch.Tensor]]]
    #: padded batch size the launch runs at
    pad_to: int
    #: real rows in the batch (readbacks slice to this)
    rows: int
    #: canonical mode: the one task VDAF of every row, whose own unpadded,
    #: unmasked prepare serves the flush; None: the backend's VDAF (masked
    #: when the backend is canonical)
    exact: Optional[Prio3] = None


def _observe_prepare(backend: str, phase: str, reports: int, seconds: float) -> None:
    """Per-backend prepare throughput and latency (``janus_prepare_*``), and
    the same seconds attributed to the calling thread's task scope
    (``core/costs.py``), as the reference's hook does."""
    from ..core import costs
    from ..core.metrics import GLOBAL_METRICS

    if GLOBAL_METRICS.registry is not None:
        GLOBAL_METRICS.observe_prepare(backend, phase, reports, seconds)
    costs.attribute_prepare(backend, phase, seconds)


class OracleBackend:
    """Scalar per-report loop over the CPU oracle."""

    name = "oracle"

    def __init__(self, vdaf: Prio3):
        self.vdaf = vdaf
        #: rows this oracle prepared (``init``) and combined (``combine``):
        #: a device backend's oracle serves only fallbacks and recomputes
        self.rows = {"init": 0, "combine": 0}

    def prep_init_batch(self, verify_key: bytes, agg_id: int, reports: Sequence[Report]) -> List[PrepOutcome]:
        t0 = time.monotonic()
        self.rows["init"] += len(reports)
        out: List[PrepOutcome] = []
        for nonce, public_share, input_share in reports:
            try:
                out.append(self.vdaf.prep_init(verify_key, agg_id, nonce, public_share, input_share))
            except VdafError as e:
                out.append(e)
        _observe_prepare(self.name, "init", len(out), time.monotonic() - t0)
        return out

    def prep_shares_to_prep_batch(
        self, prep_shares: Sequence[Sequence[Prio3PrepareShare]]
    ) -> List[Union[Optional[bytes], VdafError]]:
        t0 = time.monotonic()
        self.rows["combine"] += len(prep_shares)
        out: List[Union[Optional[bytes], VdafError]] = []
        for shares in prep_shares:
            try:
                out.append(self.vdaf.prep_shares_to_prep(shares))
            except VdafError as e:
                out.append(e)
        _observe_prepare(self.name, "combine", len(out), time.monotonic() - t0)
        return out


def oracle_backend_for(backend, vdaf):
    """The bit-exact CPU oracle for serving ``vdaf``'s reports when
    ``backend`` cannot (the replay of out shares a lost flush held):
    ``backend.oracle_for(vdaf)`` where it has one, else its ``.oracle``
    (or None when there is none)."""
    if hasattr(backend, "oracle_for"):
        return backend.oracle_for(vdaf)
    return getattr(backend, "oracle", None)


def prep_request(backend, verify_key: bytes, reports, vdaf) -> tuple:
    """The executor's prepare request for ``reports`` of a task on ``vdaf``:
    a canonical backend's names the task's VDAF as its third element."""
    if getattr(backend, "canonical", False):
        return (verify_key, reports, vdaf)
    return (verify_key, reports)


def default_field_backend() -> str:
    """The process default field layout of the card backends:
    ``JANUS_TPU_TORCH_FIELD_BACKEND`` ("vpu" or "mxu"), else "vpu".  The
    variable carries the port's prefix, so that one shell cannot switch
    both packages."""
    return os.environ.get("JANUS_TPU_TORCH_FIELD_BACKEND", "vpu")


def _resolve_field_backend(field_backend: Optional[str]) -> str:
    """``field_backend`` (None: the process default), checked against
    ``FIELD_BACKENDS``: "vpu", the limb core, or "mxu", the limb-digit
    matmul layout (``ops/field.py``), the same bytes either way."""
    fb = field_backend or default_field_backend()
    if fb not in FIELD_BACKENDS:
        raise VdafError(f"unknown field_backend {fb!r} (one of {', '.join(FIELD_BACKENDS)})")
    return fb


def _req_parts(req):
    """A prepare request is ``(verify_key, reports)`` or — on a canonical
    backend — ``(verify_key, reports, task_vdaf)``, the third element naming
    the task's own (unpadded) VDAF so that the marshal pads its rows to the
    bucket shape and the unmarshal slices them back."""
    return req[0], req[1], (req[2] if len(req) > 2 else None)


class CudaBackend:
    """Batched prepare on the card: one pass of CUDA kernels per flush."""

    name = "cuda"
    #: a flush's out shares can stay on the card, handed back as
    #: ResidentRefs (executor/accumulator.py) instead of field vectors
    supports_resident_out_shares = True
    #: leading-axis rows of an accumulator buffer (one card)
    accum_buffer_rows = 1

    def __init__(self, vdaf: Prio3, device="cuda", canonical: bool = False, field_backend: Optional[str] = None):
        if vdaf.xof is not XofTurboShake128:
            raise VdafError("the CUDA backend requires the TurboSHAKE XOF")
        self.vdaf = vdaf
        #: "vpu" | "mxu": the field layout of every prepare this backend
        #: runs (None resolves to ``default_field_backend()``); under "mxu"
        #: every flush takes the row path
        self.field_backend = _resolve_field_backend(field_backend)
        #: canonical mode: ``vdaf`` is a bucket's padded twin shared by every
        #: task of the bucket; requests carry the task's VDAF (3-tuples); a
        #: flush of one task shape runs that shape's prepare, a flush that
        #: mixes shapes carries per-row measurement lengths and runs the
        #: twin's masked row path
        self.canonical = canonical
        self.device = torch.device(device)
        self.bp = BatchedPrio3(vdaf, device=self.device, field_backend=self.field_backend)
        self.oracle = OracleBackend(vdaf)
        self._oracles: Dict[tuple, OracleBackend] = {}
        #: canonical mode: each task shape's own batched prepare
        self._exact_bps: Dict[tuple, BatchedPrio3] = {}
        #: canonical mode: a flush whose rows are all of one shape runs that
        #: shape's own prepare (False: the twin's masked row path, as the
        #: JAX package's canonical backend runs every flush)
        self.one_shape_exact = True
        #: out-share rows read back from the card by prepare launches (0
        #: while every flush keeps its out shares resident)
        self.outshare_readback_rows = 0
        #: rows whose device ok flag was False, recomputed by the oracle
        self.oracle_recompute_rows = 0
        #: host seconds converting verifier shares: ``from_limbs`` after a
        #: launch (``verifiers_out``) and ``to_limbs`` before a combine
        #: (``verifiers_in``)
        self.host_seconds = {"verifiers_out": 0.0, "verifiers_in": 0.0}
        #: leader rows marshalled from the bytes their shares arrived in
        #: (``bytes``) and from their field values (``values``)
        self.leader_marshal_rows = {"bytes": 0, "values": 0}

    def build_kernels(self) -> None:
        """Build the CUDA kernels now (one nvcc per source, in parallel) so
        that no launch pays for it; nothing to build for a CPU backend."""
        if self.device.type == "cuda":
            from .. import _build

            _build.build()

    def resident_byte_budget(self) -> Optional[int]:
        """The accumulator store's resident-byte budget for the flushes this
        backend mints: a quarter of the card's memory, leaving the rest to
        the prepare's own working set; None off the card (the store's host
        default holds)."""
        if self.device.type != "cuda":
            return None
        return torch.cuda.get_device_properties(self.device).total_memory // 4

    def _sync(self) -> None:
        """Wait for the card, so that a timer or span closed next measures
        device work and not an enqueue."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def oracle_for(self, vdaf=None) -> OracleBackend:
        """The bit-exact CPU oracle for ``vdaf`` (None or own = this
        backend's).  A canonical backend's own oracle computes the twin's
        padded circuit, so its callers name the task's VDAF."""
        if vdaf is None or vdaf is self.vdaf:
            return self.oracle
        key = vdaf_shape_key(vdaf)
        o = self._oracles.get(key)
        if o is None:
            o = self._oracles[key] = OracleBackend(vdaf)
        return o

    def _bp_for(self, vdaf=None) -> BatchedPrio3:
        """The batched prepare of ``vdaf`` (None or own = this backend's);
        canonical mode builds one per task shape on first use."""
        if vdaf is None or vdaf is self.vdaf:
            return self.bp
        key = vdaf_shape_key(vdaf)
        bp = self._exact_bps.get(key)
        if bp is None:
            bp = self._exact_bps[key] = BatchedPrio3(vdaf, device=self.device, field_backend=self.field_backend)
        return bp

    def _one_shape(self, segments):
        """Canonical mode: the task VDAF shared by every row of a flush, when
        its rows are all of one shape (that shape's own prepare serves it,
        narrower than the twin and planar where eligible); None when the
        flush mixes shapes (the twin's masked row path serves it)."""
        shapes = {vdaf_shape_key(v): v for _rows, v in segments}
        return next(iter(shapes.values())) if len(shapes) == 1 else None

    # -- marshaling ------------------------------------------------------
    def _marshal(
        self, agg_id: int, reports: Sequence[Report], pad_to: int, segments=None, vdaf=None
    ) -> Dict[str, np.ndarray]:
        """Host arrays of one flush of ``vdaf`` (None: this backend's),
        padded to ``pad_to`` rows by repeating the last row (the padding
        rows are sliced off after the launch).

        ``segments`` (canonical mode, a flush that mixes shapes):
        ``[(rows, task_vdaf)]`` per request, in order.  The leader's
        measurement limbs of a task land in the leading MEAS_LEN columns of
        the twin-width matrix (the pad columns stay zero: the row mask and
        the select absorb's pad need it), and every row gets its task's
        MEAS_LEN as ``meas_len``."""
        vdaf = vdaf or self.vdaf
        flp, f = vdaf.flp, self.bp.f
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
            if segments is None:
                meas, proofs = leader_limbs(vdaf, reports, self.leader_marshal_rows)
            else:
                meas = np.zeros((B, flp.MEAS_LEN, f.n), dtype=np.uint32)
                proofs = np.empty((B, flp.PROOF_LEN * vdaf.num_proofs, f.n), dtype=np.uint32)
                row = 0
                for rows, task_vdaf in segments:
                    m, pr = leader_limbs(task_vdaf, reports[row : row + rows], self.leader_marshal_rows)
                    meas[row : row + rows, : m.shape[1]] = m
                    proofs[row : row + rows] = pr
                    row += rows
            kw["meas_limbs"] = pad_rows(meas)
            kw["proofs_limbs"] = pad_rows(proofs)
        else:
            kw["share_seeds_u8"] = stack_bytes([r[2].share_seed for r in reports], seed_size)
        if segments is not None:
            lens = np.concatenate([np.full(rows, v.flp.MEAS_LEN, dtype=np.int32) for rows, v in segments])
            kw["meas_len"] = pad_rows(lens)
        return kw

    def _pad_to(self, B: int) -> int:
        """Power-of-two buckets, as the JAX backend pads."""
        return next_power_of_2(B)

    def _place(self, kw: Dict[str, np.ndarray]):
        return _place_on(kw, self.device)

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
        segments: Optional[List] = [] if self.canonical else None
        for req in requests:
            verify_key, reports, task_vdaf = _req_parts(req)
            flat.extend(reports)
            vk_rows.extend([np.frombuffer(verify_key, dtype=np.uint8)] * len(reports))
            if segments is not None and reports:
                # a 2-tuple request (the warmup's rows) is shaped for the
                # twin itself: its rows keep the full width
                segments.append((len(reports), task_vdaf or self.vdaf))
        if not flat:
            return None
        B = len(flat)
        pad_to = max(pad_to or 0, self._pad_to(B))
        exact = self._one_shape(segments) if segments and self.one_shape_exact else None
        kw = self._marshal(agg_id, flat, pad_to, segments=None if exact else segments, vdaf=exact)
        vk = np.stack(vk_rows)
        kw["verify_key_u8"] = np.concatenate([vk, np.repeat(vk[-1:], pad_to - B, axis=0)])
        return StagedPrepInit(agg_id=agg_id, placed=self._place(kw), pad_to=pad_to, rows=B, exact=exact)

    def _prep_fn(self, agg_id: int, pad_to: int, exact=None, device=None):
        """The prepare that serves a flush padded to ``pad_to`` rows, chosen
        up front from the padded size as the JAX ``TpuBackend._prep_fn``
        chooses: the planar path for Histogram and one-bit SumVec, the row
        path for everything else (Count, Sum, SumVec with bits > 1,
        Histogram with MEAS_LEN > 65535, any flush past 65535 rows, and a
        canonical backend's flush that mixes shapes, whose masks the planar
        kernels do not take).  ``exact`` is a canonical flush's one task
        shape: its own prepare serves.  Where the JAX package takes its
        limb-planar Count/Sum path, the port takes the row path, which is
        the faster one on the card.  ``device`` names a mesh shard's card
        (one card here: unused)."""
        bp = self._bp_for(exact)
        return getattr(bp, bp.prep_route(agg_id, pad_to, masked=self.canonical and exact is None))

    def _launch_prepare(self, agg_id: int, placed: Dict[str, torch.Tensor], pad_to: int, exact=None, device=None):
        """One prepare over ``placed`` (one card's tensors) -> its device
        outputs; the route is ``_prep_fn``'s for a flush of ``pad_to``."""
        kw = dict(placed)
        vk = kw.pop("verify_key_u8")
        masks = {"meas_len": kw["meas_len"]} if "meas_len" in kw else {}
        return self._prep_fn(agg_id, pad_to, exact, device)(
            agg_id,
            vk,
            kw["nonces_u8"],
            share_seeds_u8=kw.get("share_seeds_u8"),
            meas_limbs=kw.get("meas_limbs"),
            proofs_limbs=kw.get("proofs_limbs"),
            blinds_u8=kw.get("blinds_u8"),
            public_parts_u8=kw.get("public_parts_u8"),
            **masks,
        )

    def _read_prepare(self, out: Dict[str, torch.Tensor], rows: int, retain: bool) -> Dict[str, np.ndarray]:
        """The host outputs of a prepare's first ``rows`` rows: ok, the
        verifiers, the joint-rand part and corrected seed, and (unless the
        out shares stay on the card, ``retain``) the out shares."""
        outputs = {"ok": out["ok"][:rows].cpu().numpy(), "verifiers": tensor_to_u32(out["verifiers"][:rows])}
        if self.vdaf.flp.JOINT_RAND_LEN > 0:
            outputs["joint_rand_part"] = out["joint_rand_part"][:rows].cpu().numpy()
            outputs["corrected_seed"] = out["corrected_seed"][:rows].cpu().numpy()
        if not retain:
            outputs["out_share"] = tensor_to_u32(out["out_share"][:rows])
        return outputs

    def _prepare(self, staged: StagedPrepInit, retain: bool):
        """The device work of a launch: the prepare and its readback.
        Returns (host outputs of the real rows, the (pad, OUT, n) out-share
        matrix left on the card when ``retain``, else None)."""
        out = self._launch_prepare(staged.agg_id, staged.placed, staged.pad_to, staged.exact)
        outputs = self._read_prepare(out, staged.rows, retain)
        matrix = out["out_share"] if retain else None
        del out
        self._sync()
        return outputs, matrix

    def launch_prep_init_multi(self, staged: StagedPrepInit, requests, retain_store=None) -> List[List[PrepOutcome]]:
        """Device half: run the batched prepare, read back once, slice the
        results per request.

        With ``retain_store`` (a DeviceAccumulatorStore) the (pad, OUT, n)
        out-share matrix stays on the card, adopted by the store, and each
        ok row's state carries a ResidentRef: only the verdict outputs (ok,
        verifiers, joint-rand parts) are read back."""
        # Failure-domain boundary: an injected launch fault stands for a
        # lost or failing card; the executor's breaker and the driver's
        # retries must degrade gracefully.  The oracle has no such point.
        faults.fire("backend.launch")
        faults.fire("backend.device_lost")
        agg_id, B = staged.agg_id, staged.rows
        from ..core.metrics import GLOBAL_METRICS
        from ..core.trace import trace_span

        if GLOBAL_METRICS.registry is not None:
            GLOBAL_METRICS.device_launches.labels(backend=self.name).inc()
            GLOBAL_METRICS.device_reports.labels(backend=self.name).inc(B)
        t0 = time.monotonic()
        resident = None
        try:
            with trace_span("prep_launch", cat="device", backend=self.name, batch=B):
                outputs, matrix = self._prepare(staged, retain_store is not None)
                if retain_store is not None:
                    nbytes = matrix.numel() * matrix.element_size()
                    resident = (retain_store.retain_flush(self, matrix, B, nbytes), 0)
                else:
                    self.outshare_readback_rows += B
                del matrix
            _observe_prepare(self.name, "init", B, time.monotonic() - t0)
            results: List[List[PrepOutcome]] = []
            start = 0
            for req in requests:
                verify_key, reports, task_vdaf = _req_parts(req)
                n = len(reports)
                view = {k: v[start : start + n] for k, v in outputs.items()}
                results.append(
                    self._unmarshal_prep(
                        verify_key,
                        agg_id,
                        reports,
                        view,
                        resident=None if resident is None else (resident[0], start),
                        task_vdaf=task_vdaf,
                    )
                )
                start += n
        except Exception:
            if resident is not None:
                # a failure after the store adopted the matrix must not
                # strand the flush: release every row (release is idempotent)
                from ..executor.accumulator import ResidentRef

                retain_store.release_refs([ResidentRef(resident[0], r) for r in range(B)])
            raise
        if resident is not None:
            # rows the oracle recomputed (device ok False) minted no ref;
            # release them so the flush can free
            from ..executor.accumulator import ResidentRef

            dead = [ResidentRef(resident[0], r) for r in np.flatnonzero(~outputs["ok"]).tolist()]
            if dead:
                retain_store.release_refs(dead)
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

    def _unmarshal_prep(self, verify_key, agg_id, reports, out, resident=None, task_vdaf=None) -> List[PrepOutcome]:
        """``resident=(flush_id, start_row)`` means the out-share matrix
        stayed on the card (accumulator store): states carry ResidentRefs
        instead of field vectors.  A row whose device ``ok`` is False is
        recomputed by the oracle (the protocol's rule).  ``task_vdaf``
        (canonical mode) slices the twin-width out share back to the task's
        OUTPUT_LEN (its pad tail is zero) and names the oracle that
        recomputes a not-ok row: the task's, never the twin's."""
        flp, f = self.vdaf.flp, self.bp.f
        out_len = (task_vdaf or self.vdaf).flp.OUTPUT_LEN
        # a canonical task's refs name its width: the bucket's drain clips
        # the twin-width sum back to it
        width = out_len if out_len < flp.OUTPUT_LEN else None
        oracle = self.oracle_for(task_vdaf)
        has_jr = flp.JOINT_RAND_LEN > 0
        t0 = time.perf_counter()
        ver_len = out["verifiers"].shape[1]
        verifiers = f.from_limbs(out["verifiers"])
        self.host_seconds["verifiers_out"] += time.perf_counter() - t0
        if resident is not None:
            from ..executor.accumulator import ResidentRef

            flush_id, start_row = resident
        results: List[PrepOutcome] = []
        for b in range(len(reports)):
            if not out["ok"][b]:
                self.oracle_recompute_rows += 1
                results.extend(oracle.prep_init_batch(verify_key, agg_id, [reports[b]]))
                continue
            state = Prio3PrepareState(
                out_share=f.from_limbs(out["out_share"][b, :out_len])
                if resident is None
                else ResidentRef(flush_id, start_row + b, width),
                corrected_joint_rand_seed=out["corrected_seed"][b].tobytes() if has_jr else None,
            )
            share = Prio3PrepareShare(
                verifiers_share=verifiers[b * ver_len : (b + 1) * ver_len],
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
        faults.fire("backend.combine")
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
            t0 = time.perf_counter()
            limbs = f.to_limbs([x for row in prep_shares for x in row[a].verifiers_share])
            self.host_seconds["verifiers_in"] += time.perf_counter() - t0
            limbs = limbs.reshape(B, ver_len, f.n)
            vs.append(np.concatenate([limbs, np.repeat(limbs[-1:], pad_to - B, axis=0)]).astype(np.int64))
            if has_jr:
                arr = np.frombuffer(
                    b"".join(row[a].joint_rand_part for row in prep_shares), dtype=np.uint8
                ).reshape(B, vdaf.xof.SEED_SIZE)
                parts.append(np.concatenate([arr, np.repeat(arr[-1:], pad_to - B, axis=0)]))
        t0 = time.monotonic()
        decide, seeds = self._combine(vs, parts if has_jr else None, B)
        _observe_prepare(self.name, "combine", B, time.monotonic() - t0)
        results: List[Union[Optional[bytes], VdafError]] = []
        for b in range(B):
            if not decide[b]:
                results.append(VdafError("proof verification failed"))
            elif has_jr:
                results.append(seeds[b].tobytes())
            else:
                results.append(None)
        return results

    def _combine(self, vs: List[np.ndarray], parts: Optional[List[np.ndarray]], rows: int):
        """The device half of a combine: every aggregator's padded verifier
        rows (pad, VER, n) int64 and joint-rand parts (pad, SEED) uint8 ->
        (decide, prep-message seeds or None) of the first ``rows`` rows."""
        out = _combine_on(self.bp, self.device, vs, parts, rows)
        self._sync()
        return out

    # -- aggregation -------------------------------------------------------
    def accumulate_rows(self, buffer, matrix: torch.Tensor, mask: np.ndarray):
        """Add the ``mask``-selected rows of an out-share matrix (pad, OUT, n)
        to ``buffer`` ((OUT, n) int64 words on the card; None starts one).
        Device work only, no readback; a matrix the store evicted to the
        host goes back to the card for the sum."""
        return _accumulate_on(self.bp, self.device, self.vdaf.flp.OUTPUT_LEN, buffer, matrix, mask)

    def read_accum_buffer(self, buffer) -> List[int]:
        """The drain's readback: ONE (OUT,) field vector."""
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


def _place_on(kw: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """Host marshal arrays -> tensors on ``device`` (uint32 limbs as int32
    storage)."""
    placed = {}
    for k, v in kw.items():
        if v.dtype == np.uint32:
            placed[k] = u32_to_tensor(v, device)
        else:
            placed[k] = torch.from_numpy(np.ascontiguousarray(v)).to(device)
    return placed


def _combine_on(bp: BatchedPrio3, device, vs, parts, rows: int):
    """``bp``'s combine and decide of padded verifier rows and joint-rand
    parts (host arrays) on ``device`` -> (decide, seeds or None) of the first
    ``rows`` rows, read back."""
    vs = [torch.from_numpy(v).to(device) for v in vs]
    parts = None if parts is None else [torch.from_numpy(np.ascontiguousarray(p)).to(device) for p in parts]
    out = bp.prep_shares_to_prep(vs, parts)
    decide = out["decide"][:rows].cpu().numpy()
    seeds = out["prep_msg_seed"][:rows].cpu().numpy() if parts is not None else None
    return decide, seeds


def _accumulate_on(bp: BatchedPrio3, device, out_len: int, buffer, matrix: torch.Tensor, mask: np.ndarray):
    """``buffer`` ((OUT, n) int64 words on ``device``, None: zero) plus the
    ``mask``-selected rows of ``matrix`` (rows, OUT', n), moved to ``device``
    if it is not there (an evicted host copy).  A canonical flush served at
    its task's own shape (OUT' < OUT) is narrower than the twin's buffers:
    zero columns fill the twin's tail."""
    m = torch.from_numpy(np.asarray(mask, dtype=bool)).to(device)
    delta = bp.aggregate(matrix.to(device), m)
    pad = out_len - delta.shape[0]
    if pad > 0:
        delta = torch.nn.functional.pad(delta, (0, 0, 0, pad))
    if buffer is None:
        return delta
    return bp.f.add(buffer, delta)


def leader_limbs(vdaf: Prio3, reports: Sequence[Report], marshal_rows: Dict[str, int]) -> Tuple[np.ndarray, np.ndarray]:
    """The leader shares' (B, MEAS_LEN, n) and (B, num_proofs * PROOF_LEN, n)
    uint32 limbs: the shares' encodings joined and read by one
    ``np.frombuffer``.  A decoded share's encoding is the bytes it arrived
    in (``decode_vec`` has refused any element >= p, so they are canonical
    limbs); any other share is encoded here.  ``marshal_rows`` counts the
    rows of each kind ("bytes", "values")."""
    flp, field, B = vdaf.flp, vdaf.flp.field, len(reports)
    width = flp.MEAS_LEN + flp.PROOF_LEN * vdaf.num_proofs
    kept = [getattr(r[2], "encoded_vectors", None) for r in reports]
    encoded = b"".join(
        k or field.encode_vec(r[2].meas_share) + field.encode_vec(r[2].proofs_share)
        for k, r in zip(kept, reports)
    )
    n_kept = sum(k is not None for k in kept)
    marshal_rows["bytes"] += n_kept
    marshal_rows["values"] += B - n_kept
    both = np.frombuffer(encoded, dtype="<u4").reshape(B, width, field.ENCODED_SIZE // 4)
    return both[:, : flp.MEAS_LEN], both[:, flp.MEAS_LEN :]


class ShardedRows:
    """One row-sharded tensor of a ``MeshBackend``: its per-shard pieces,
    each on its shard's device, in shard order.  A retained flush's
    (pad, OUT, n) out-share matrix is one (each piece (pad / shards, OUT,
    n)), and so is an accumulator buffer (one (OUT, n) partial row a
    shard).  It has what the accumulator store asks of a tensor: ``shape``
    (a matrix's: the rows of every piece together), ``numel``,
    ``element_size`` and ``cpu`` (the eviction's host copy, piece by
    piece)."""

    def __init__(self, pieces: Sequence[torch.Tensor]):
        self.pieces = list(pieces)

    @property
    def shape(self) -> Tuple[int, ...]:
        return (sum(p.shape[0] for p in self.pieces),) + tuple(self.pieces[0].shape[1:])

    def numel(self) -> int:
        return sum(p.numel() for p in self.pieces)

    def element_size(self) -> int:
        return self.pieces[0].element_size()

    def cpu(self) -> "ShardedRows":
        return ShardedRows([p.cpu() for p in self.pieces])


def local_mesh(device=None) -> List[torch.device]:
    """The devices of a one-process mesh for a backend on ``device``: every
    visible card for a card (None, ``"cuda"`` or any ``"cuda:i"``: one
    process, every local card), else ``device`` alone.  VdafError when a
    card is asked for and none is visible: no quiet fallback."""
    device = torch.device(device or "cuda")
    if device.type != "cuda":
        return [device]
    if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
        raise VdafError("the mesh backend needs a CUDA card, and none is available")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _on_device(device):
    """``torch.cuda.device(device)`` for a card, a no-op context for the
    CPU."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


class MeshBackend(CudaBackend):
    """Batched prepare over the cards of one process: each flush's rows are
    split into equal contiguous shards, one a device in ``devices``, and
    every shard runs on its card the prepare a one-card flush of its size
    runs, with the same kernels (counterpart of the JAX ``MeshBackend``,
    ``janus_tpu/vdaf/backend.py:698-916``, whose ``shard_map`` runs the
    same per-shard program on every chip of a local mesh).

    The flush is marshalled once on the host, padded to a power of two
    rounded up to a multiple of the shard count, and each slice of rows is
    placed on its card; the shards launch from one worker thread per
    distinct device (owned by the backend), each inside
    ``torch.cuda.device(d)`` on that card's current stream, so a host
    synchronisation inside one shard's prepare does not hold up another
    card.  The prepare route is chosen from the shard's rows, as JAX
    evaluates ``planar_eligible`` per shard.  Results are read back in
    shard order and equal one ``CudaBackend``'s on the same rows, byte for
    byte.  A failing shard raises out of the launch after every shard has
    ended; nothing retained is adopted, and no shard's rows move to
    another card or to the oracle.

    Out shares kept resident stay per shard (``ShardedRows``): each card
    sums its mask-selected rows into its own (OUT, n) partial row
    (``accumulate_rows``, no cross-card traffic), and the partial rows
    cross cards once, at drain (``read_accum_buffer``: copied to the first
    device and summed there with the modular field sum).

    ``devices`` may repeat a device: repeats are logical shards of one card
    (or of the CPU, for tests), which share its SMs and measure overhead,
    not scaling.  None is every visible card (``local_mesh``).  The
    gang-scheduled multi-process mesh (the JAX package's
    ``JANUS_TPU_MESH_SPAN=global`` over ``jax.distributed``) is not here.
    """

    name = "mesh"

    def __init__(self, vdaf: Prio3, devices=None, canonical: bool = False, field_backend: Optional[str] = None):
        devs = local_mesh() if devices is None else [torch.device(d) for d in devices]
        if not devs:
            raise VdafError("a mesh needs at least one device")
        if any(d.type == "cuda" for d in devs) and not torch.cuda.is_available():
            raise VdafError("the mesh backend needs a CUDA card, and none is available")
        super().__init__(vdaf, device=devs[0], canonical=canonical, field_backend=field_backend)
        #: the shards' devices, in shard order (a device may repeat)
        self.devices = devs
        #: the mesh's identity: the breaker domain every shape on this
        #: device set shares (executor/service.py ``breaker_domain``)
        self.mesh_devices = tuple(str(d) for d in devs)
        #: accumulator buffers keep one (OUT, n) partial row a shard
        self.accum_buffer_rows = len(devs)
        self._distinct = list(dict.fromkeys(devs))
        #: (task shape key or None for the own VDAF, device) -> its batched
        #: prepare: one per distinct card, so its constants are built once
        #: a card
        self._mesh_bps: Dict[tuple, BatchedPrio3] = {(None, str(devs[0])): self.bp}
        for d in self._distinct[1:]:
            self._mesh_bps[(None, str(d))] = BatchedPrio3(vdaf, device=d, field_backend=self.field_backend)
        #: one worker thread a distinct device, started on first use
        self._pools: Dict[str, ThreadPoolExecutor] = {}
        self._pool_lock = threading.Lock()

    # -- shards ------------------------------------------------------------
    def _bp_for(self, vdaf=None, device=None) -> BatchedPrio3:
        """The batched prepare of ``vdaf`` (None or own: this backend's) on
        ``device`` (None: the first shard's)."""
        device = torch.device(device) if device is not None else self.devices[0]
        own = vdaf is None or vdaf is self.vdaf
        key = (None if own else vdaf_shape_key(vdaf), str(device))
        bp = self._mesh_bps.get(key)
        if bp is None:
            bp = self._mesh_bps[key] = BatchedPrio3(
                self.vdaf if own else vdaf, device=device, field_backend=self.field_backend
            )
        return bp

    def _pool(self, device: torch.device):
        """The worker thread that issues every shard on ``device``."""
        with self._pool_lock:
            pool = self._pools.get(str(device))
            if pool is None:
                pool = self._pools[str(device)] = ThreadPoolExecutor(1, thread_name_prefix=f"janus-mesh-{device}")
            return pool

    def _each_shard(self, fn) -> list:
        """``fn(i)`` for every shard i on its device's worker thread, inside
        ``torch.cuda.device`` of that device; waits for every shard, then
        raises the first failure in shard order, else returns the results
        in shard order."""

        def run(i):
            with _on_device(self.devices[i]):
                return fn(i)

        futures = [self._pool(d).submit(run, i) for i, d in enumerate(self.devices)]
        wait(futures)
        return [f.result() for f in futures]

    def _shard_rows(self, total: int) -> int:
        return total // len(self.devices)

    def _real_rows(self, real: int, per: int, i: int) -> int:
        """Of ``real`` rows padded and split ``per`` a shard, shard i's."""
        return min(max(real - i * per, 0), per)

    def _pad_to(self, B: int) -> int:
        """The power-of-two bucket (at least one row a shard) rounded up to
        a multiple of the shard count, so that every shard gets the same
        rows (JAX ``MeshBackend._pad_to``)."""
        return self._align_pad(max(next_power_of_2(B), len(self.devices)))

    def _align_pad(self, pad_to: int) -> int:
        n = len(self.devices)
        return -(-pad_to // n) * n

    def _sync(self) -> None:
        for d in self._distinct:
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def resident_byte_budget(self) -> Optional[int]:
        """The mesh's budget: a quarter of each distinct card's memory,
        summed; None off the card."""
        cards = [d for d in self._distinct if d.type == "cuda"]
        if not cards:
            return None
        return sum(torch.cuda.get_device_properties(d).total_memory // 4 for d in cards)

    # -- prepare -------------------------------------------------------------
    def stage_prep_init_multi(self, agg_id: int, requests, pad_to: Optional[int] = None) -> Optional[StagedPrepInit]:
        """Marshal once on the host, then place each shard's rows on its
        device (``StagedPrepInit.placed``: one dict a shard).  A requested
        ``pad_to`` (the warmup's) is rounded up to a multiple of the
        shard count."""
        return super().stage_prep_init_multi(agg_id, requests, pad_to=self._align_pad(pad_to) if pad_to else None)

    def _place(self, kw: Dict[str, np.ndarray]) -> List[Dict[str, torch.Tensor]]:
        rows = self._shard_rows(len(kw["nonces_u8"]))
        return [
            _place_on({k: v[i * rows : (i + 1) * rows] for k, v in kw.items()}, d) for i, d in enumerate(self.devices)
        ]

    def _prep_fn(self, agg_id: int, pad_to: int, exact=None, device=None):
        """As ``CudaBackend._prep_fn``, with the route chosen from the
        shard's rows (``pad_to`` / shards) and the prepare of ``device``."""
        bp = self._bp_for(exact, device)
        rows = self._shard_rows(pad_to)
        return getattr(bp, bp.prep_route(agg_id, rows, masked=self.canonical and exact is None))

    def _prepare(self, staged: StagedPrepInit, retain: bool):
        rows = self._shard_rows(staged.pad_to)

        def shard(i):
            device = self.devices[i]
            out = self._launch_prepare(staged.agg_id, staged.placed[i], staged.pad_to, staged.exact, device)
            outputs = self._read_prepare(out, self._real_rows(staged.rows, rows, i), retain)
            piece = out["out_share"] if retain else None
            del out
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            return outputs, piece

        results = self._each_shard(shard)
        outputs = {k: np.concatenate([r[0][k] for r in results]) for k in results[0][0]}
        return outputs, (ShardedRows([r[1] for r in results]) if retain else None)

    def _combine(self, vs: List[np.ndarray], parts: Optional[List[np.ndarray]], rows: int):
        """The combine split as the prepare is: each shard combines and
        decides its rows on its card; read back in shard order."""
        per = self._shard_rows(vs[0].shape[0])

        def shard(i):
            cut = slice(i * per, (i + 1) * per)
            out = _combine_on(
                self._bp_for(None, self.devices[i]),
                self.devices[i],
                [v[cut] for v in vs],
                None if parts is None else [p[cut] for p in parts],
                self._real_rows(rows, per, i),
            )
            if self.devices[i].type == "cuda":
                torch.cuda.synchronize(self.devices[i])
            return out

        results = self._each_shard(shard)
        decide = np.concatenate([r[0] for r in results])
        seeds = None if parts is None else np.concatenate([r[1] for r in results])
        return decide, seeds

    # -- aggregation -----------------------------------------------------------
    def accumulate_rows(self, buffer, matrix: ShardedRows, mask: np.ndarray) -> ShardedRows:
        """Each shard adds the ``mask``-selected rows of its piece of the
        out-share matrix (evicted pieces go back to their card) to its own
        (OUT, n) partial row, on its card: no cross-card traffic.  The mask
        is split as the rows are."""
        mask = np.asarray(mask, dtype=bool)
        pieces, start = [], 0
        for i, (device, piece) in enumerate(zip(self.devices, matrix.pieces)):
            rows = piece.shape[0]
            with _on_device(device):
                pieces.append(
                    _accumulate_on(
                        self._bp_for(None, device),
                        device,
                        self.vdaf.flp.OUTPUT_LEN,
                        None if buffer is None else buffer.pieces[i],
                        piece,
                        mask[start : start + rows],
                    )
                )
            start += rows
        return ShardedRows(pieces)

    def read_accum_buffer(self, buffer: ShardedRows) -> List[int]:
        """The one cross-card step: each shard's partial row is copied to
        the first device and the rows are summed there with the modular
        field sum (an integer sum of the limbs would lose the carries),
        then ONE (OUT,) vector is read back."""
        first, f = self.devices[0], self.bp.f
        total = None
        with _on_device(first):
            for piece in buffer.pieces:
                row = piece.to(first)
                total = row if total is None else f.add(total, row)
            return f.from_limbs(tensor_to_u32(total))

    def aggregate_batch(self, out_shares_limbs, mask) -> List[int]:
        """Masked out-share sum over the mesh: each shard sums its rows on
        its card, then the partial rows are summed as at drain."""
        shares = np.asarray(out_shares_limbs, dtype=np.uint32)
        m = np.asarray(mask, dtype=bool)
        B = shares.shape[0]
        pad_to = self._pad_to(B)
        if pad_to != B:  # zero rows masked off: no effect on the sum
            shares = np.concatenate([shares, np.zeros((pad_to - B,) + shares.shape[1:], np.uint32)])
            m = np.concatenate([m, np.zeros(pad_to - B, dtype=bool)])
        per = self._shard_rows(pad_to)
        pieces = ShardedRows([u32_to_tensor(shares[i * per : (i + 1) * per], d) for i, d in enumerate(self.devices)])
        return self.read_accum_buffer(self.accumulate_rows(None, pieces, m))


class HybridXofBackend:
    """Host XOF and card FLP for a Prio3 whose XOF has no device twin: the
    HMAC-SHA256-AES128 multiproof SumVec (reference: core/src/vdaf.rs:178-
    195).  Per report the host derives, as ``Prio3.prep_init`` does, the
    helper's expanded shares, the query randomness and the joint-rand part,
    seed and vector, each vector read in bulk as limbs; the FLP queries of
    every proof (``BatchedPrio3.query_batch``) and the decide
    (``decide_batch``) run on the card over the batch padded to the next
    power of two.  No executor surface: the control plane calls
    ``prep_init_batch`` and ``prep_shares_to_prep_batch`` directly, and the
    out shares come back to the host.  Byte for byte the oracle's, as
    ``CudaBackend`` is."""

    name = "cuda-hybrid"

    def __init__(self, vdaf: Prio3, device="cuda", field_backend: Optional[str] = None):
        self.vdaf = vdaf
        self.device = torch.device(device)
        #: the field layout of the FLP query (see ``CudaBackend``)
        self.field_backend = _resolve_field_backend(field_backend)
        self.bp = BatchedPrio3(
            vdaf, device=self.device, require_device_xof=False, field_backend=self.field_backend
        )
        self.oracle = OracleBackend(vdaf)
        #: rows whose device ok flag was False, recomputed by the oracle
        self.oracle_recompute_rows = 0
        #: leader rows marshalled from the bytes their shares arrived in
        #: (``bytes``) and from their field values (``values``)
        self.leader_marshal_rows = {"bytes": 0, "values": 0}
        #: host seconds of the XOF (``xof``: shares, randomness, joint-rand
        #: part and seed), of the conversions from limbs (``from_limbs``)
        #: and of the card's query and decide up to their readback
        #: (``device``)
        self.host_seconds = {"xof": 0.0, "from_limbs": 0.0, "device": 0.0}
        mask = next_power_of_2(self.bp.f.p) - 1
        self._top_mask = (mask >> (32 * (self.bp.f.n - 1))) & 0xFFFFFFFF

    def _expand(self, seed: bytes, usage: int, binder: bytes, length: int) -> np.ndarray:
        """``vdaf.xof.expand_into_vec`` as (length, n) uint32 limbs: the
        candidates are read in bulk and those >= p skipped, as ``next_vec``
        skips them, so the stream position and the result are the same."""
        f = self.bp.f
        xof = self.vdaf.xof(seed, self.vdaf._dst(usage), binder)
        parts, need = [], length
        while need:
            cand = np.frombuffer(xof.next(need * 4 * f.n), dtype="<u4").reshape(need, f.n).copy()
            cand[:, -1] &= self._top_mask
            # canonical: below p, compared limb by limb from the top
            below, equal = np.zeros(need, dtype=bool), np.ones(need, dtype=bool)
            for limb, p_limb in reversed(list(zip(cand.T, f.p_limbs))):
                below |= equal & (limb < p_limb)
                equal &= limb == p_limb
            keep = cand[below]
            parts.append(keep)
            need -= len(keep)
        return np.concatenate(parts)

    def _to_device(self, rows: np.ndarray, pad_to: int) -> torch.Tensor:
        """(B, L, n) uint32 limbs padded to ``pad_to`` rows by repeating the
        last -> canonical int64 words on the card."""
        rows = np.concatenate([rows, np.repeat(rows[-1:], pad_to - len(rows), axis=0)])
        return words(u32_to_tensor(np.ascontiguousarray(rows), self.device))

    def prep_init_batch(self, verify_key: bytes, agg_id: int, reports: Sequence[Report]) -> List[PrepOutcome]:
        if not reports:
            return []
        vdaf, flp, f = self.vdaf, self.vdaf.flp, self.bp.f
        t_start = time.monotonic()
        B, P = len(reports), vdaf.num_proofs
        has_jr = flp.JOINT_RAND_LEN > 0
        if agg_id == 0:
            meas, proofs = leader_limbs(vdaf, reports, self.leader_marshal_rows)
        t0 = time.perf_counter()
        if agg_id > 0:
            binder = bytes([agg_id])
            meas = np.stack([self._expand(r[2].share_seed, USAGE_MEAS_SHARE, binder, flp.MEAS_LEN) for r in reports])
            proofs = np.stack(
                [self._expand(r[2].share_seed, USAGE_PROOF_SHARE, binder, flp.PROOF_LEN * P) for r in reports]
            )
        qr = np.stack([self._expand(verify_key, USAGE_QUERY_RANDOMNESS, r[0], flp.QUERY_RAND_LEN * P) for r in reports])
        parts: List[Optional[bytes]] = [None] * B
        corrected: List[Optional[bytes]] = [None] * B
        jr = None
        if has_jr:
            jr_rows = []
            for b, (nonce, public_share, share) in enumerate(reports):
                # enc(meas) is the limbs' little-endian bytes
                binder = bytes([agg_id]) + nonce + meas[b].astype("<u4").tobytes()
                parts[b] = vdaf.xof(share.joint_rand_blind, vdaf._dst(USAGE_JOINT_RAND_PART), binder).next(
                    vdaf.xof.SEED_SIZE
                )
                public = list(public_share)
                public[agg_id] = parts[b]
                corrected[b] = vdaf._joint_rand_seed(public)
                jr_rows.append(self._expand(corrected[b], USAGE_JOINT_RANDOMNESS, b"", flp.JOINT_RAND_LEN * P))
            jr = np.stack(jr_rows)
        self.host_seconds["xof"] += time.perf_counter() - t0

        t0 = time.perf_counter()
        pad_to = next_power_of_2(B)
        out = self.bp.query_batch(
            self._to_device(meas, pad_to),
            self._to_device(proofs, pad_to),
            None if jr is None else self._to_device(jr, pad_to),
            self._to_device(qr, pad_to),
        )
        ok = out["ok"][:B].cpu().numpy()
        verifiers = tensor_to_u32(out["verifiers"][:B])
        out_shares = tensor_to_u32(out["out_share"][:B])
        del out
        self.host_seconds["device"] += time.perf_counter() - t0

        t0 = time.perf_counter()
        results: List[PrepOutcome] = []
        for b in range(B):
            if not ok[b]:
                # The protocol's rule for the row, inside this batch's
                # measured span: the oracle's seconds are not attributed a
                # second time to the task.
                from ..core import costs

                self.oracle_recompute_rows += 1
                results.extend(
                    costs.run_in_task_scope(
                        None, lambda b=b: self.oracle.prep_init_batch(verify_key, agg_id, [reports[b]])
                    )
                )
                continue
            state = Prio3PrepareState(out_share=f.from_limbs(out_shares[b]), corrected_joint_rand_seed=corrected[b])
            share = Prio3PrepareShare(verifiers_share=f.from_limbs(verifiers[b]), joint_rand_part=parts[b])
            results.append((state, share))
        self.host_seconds["from_limbs"] += time.perf_counter() - t0
        _observe_prepare(self.name, "init", B, time.monotonic() - t_start)
        return results

    def prep_shares_to_prep_batch(
        self, prep_shares: Sequence[Sequence[Prio3PrepareShare]]
    ) -> List[Union[Optional[bytes], VdafError]]:
        """Combine on the host, decide on the card, per report."""
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
        t_start = time.monotonic()
        B = len(prep_shares)
        ver_len = flp.VERIFIER_LEN * vdaf.num_proofs
        combined = [row[0].verifiers_share for row in prep_shares]
        for a in range(1, S):
            combined = [flp.field.vec_add(prev, row[a].verifiers_share) for prev, row in zip(combined, prep_shares)]
        limbs = f.to_limbs([x for row in combined for x in row]).reshape(B, ver_len, f.n)
        t0 = time.perf_counter()
        decide = self.bp.decide_batch(self._to_device(limbs, next_power_of_2(B)))[:B].cpu().numpy()
        self.host_seconds["device"] += time.perf_counter() - t0
        results: List[Union[Optional[bytes], VdafError]] = []
        for b in range(B):
            if not decide[b]:
                results.append(VdafError("proof verification failed"))
            elif flp.JOINT_RAND_LEN > 0:
                results.append(vdaf._joint_rand_seed([row.joint_rand_part for row in prep_shares[b]]))
            else:
                results.append(None)
        _observe_prepare(self.name, "combine", B, time.monotonic() - t_start)
        return results


class Poplar1Oracle:
    """Scalar per-report Poplar1 prepare: the bit-exact CPU oracle of
    ``Poplar1Backend`` (the replay of a lost resident row, and the rows the
    batch's ``ok`` mask flags), as ``OracleBackend`` is for Prio3."""

    name = "poplar1-oracle"

    def __init__(self, vdaf):
        self.vdaf = vdaf
        #: rows this oracle prepared
        self.rows = {"init": 0}

    def prep_init_batch_poplar(self, verify_key, agg_id, agg_param, reports):
        t0 = time.monotonic()
        self.rows["init"] += len(reports)
        out = []
        for nonce, public_share, input_share in reports:
            try:
                out.append(self.vdaf.prep_init(verify_key, agg_id, agg_param, nonce, public_share, input_share))
            except VdafError as e:
                out.append(e)
        _observe_prepare(self.name, "init", len(out), time.monotonic() - t0)
        return out


class Poplar1Backend:
    """Batched prepare for Poplar1 (heavy hitters): the IDPF tree walk and
    the sketch inner products on ``device`` — see ``ops/poplar1_batch.py``.
    Through the device executor it serves the ``poplar_init`` submission
    kind: mega-batches whose bucket carries the aggregation parameter's
    tree level, so the jobs of one level coalesce into one walk and one
    sketch pass (``prep_init_multi_poplar``).  The walk never degrades to
    the host walk or the oracle: with no card it raises.  Its flushes may
    keep the sketch vectors on the device (``retain_store``)."""

    name = "poplar1-batch"

    def __init__(self, vdaf, device="cuda"):
        from ..ops.poplar1_batch import BatchedPoplar1

        self.vdaf = vdaf
        self.device = torch.device(device)
        self.bp = BatchedPoplar1(vdaf, device=self.device)
        #: the bit-exact per-report CPU oracle (the ``ok``-mask rows and the
        #: replay of lost resident rows use the VDAF's own prep_init)
        self.oracle = Poplar1Oracle(vdaf)

    @property
    def sketch_readback_rows(self) -> int:
        """Rows whose y vectors were read back to the host (0 on the
        device-resident path)."""
        return self.bp.sketch_readback_rows

    @property
    def oracle_recompute_rows(self) -> int:
        """Rows the ``ok`` mask flagged, prepared by the oracle."""
        return self.bp.oracle_recompute_rows

    def oracle_for(self, vdaf=None) -> "Poplar1Oracle":
        """Uniform fallback-resolution face (``oracle_backend_for``)."""
        return self.oracle

    def prep_init_batch_poplar(self, verify_key, agg_id, agg_param, reports):
        """Batched round-0 prep: per-report (state, share), oracle parity."""
        return self.prep_init_multi_poplar(agg_id, [(verify_key, agg_param, reports)])[0]

    def stage_poplar_init_multi(self, agg_id, requests):
        """The WALK half of a poplar flush: the IDPF eval per agg-param
        group, value shares staged on the card.  Runs
        on the executor's staging thread so walk k+1 overlaps sketch k."""
        return self.bp.stage_init_multi(agg_id, requests)

    def launch_poplar_init_multi(self, staged, retain_store=None):
        """The SKETCH half: the device inner products and state assembly
        over a staged walk.  The named fault points fire here, so the
        per-shape breaker treats a sick sketch as a sick launch.
        ``retain_store`` (the accumulator store) adopts the walked y
        matrices: states then carry ResidentRefs and the flush pays no
        sketch readback."""
        faults.fire("backend.launch")
        faults.fire("backend.device_lost")
        rows = sum(len(r) for _p, _i, _c, _v, r, _w in staged.groups)
        from ..core.metrics import GLOBAL_METRICS
        from ..core.trace import trace_span

        if GLOBAL_METRICS.registry is not None:
            GLOBAL_METRICS.device_launches.labels(backend=self.name).inc()
            GLOBAL_METRICS.device_reports.labels(backend=self.name).inc(rows)
        t0 = time.monotonic()
        with trace_span("prep_launch", cat="device", backend=self.name, batch=rows):
            out = self.bp.launch_init_multi(staged, retain_store=retain_store)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        _observe_prepare(self.name, "init", rows, time.monotonic() - t0)
        return out

    def prep_init_multi_poplar(self, agg_id, requests, retain_store=None):
        """One walk and one sketch pass for rows of several jobs
        (``requests``: (verify_key, agg_param, reports) a submission — the
        executor's poplar_init flush form), composed from the stage and
        launch halves."""
        return self.launch_poplar_init_multi(self.stage_poplar_init_multi(agg_id, requests), retain_store=retain_store)


BACKENDS = {"oracle": OracleBackend, "cuda": CudaBackend, "mesh": MeshBackend}


def vdaf_shape_key(vdaf) -> tuple:
    """Key a VDAF by its full parameterization: tasks sharing it share one
    backend instance, one executor bucket and one breaker.  Every public
    scalar circuit parameter takes part (derived lengths alone are
    ambiguous: SumVec(length=100, bits=2) and SumVec(length=200, bits=1)
    share MEAS_LEN but not OUTPUT_LEN), and so does the XOF.  Equal to the
    reference's ``vdaf_shape_key`` for the same VDAF, so both packages land
    the same VDAF in the same buckets."""
    flp = getattr(vdaf, "flp", None)
    valid = getattr(flp, "valid", None)
    circuit_params = None
    if valid is not None:
        circuit_params = tuple(
            sorted(
                (k, v if isinstance(v, (int, str, bool)) else getattr(v, "__name__", str(v)))
                for k, v in vars(valid).items()
                if not k.startswith("_") and not isinstance(v, (list, dict))
            )
        )
    return (
        type(vdaf).__name__,
        type(valid).__name__ if valid is not None else None,
        circuit_params,
        getattr(vdaf, "algorithm_id", None),
        getattr(vdaf, "num_shares", None),
        getattr(vdaf, "num_proofs", None),
        getattr(getattr(vdaf, "xof", None), "__name__", None),
        # FLP-less VDAFs (Poplar1) parameterize by their input bit width
        getattr(vdaf, "bits", None) if valid is None else None,
    )


#: Circuits the port's device prepare serves (``ops/prepare.py``
#: ``_device_circuit``), as a name set so that a control-plane process can
#: classify a VDAF without building anything: every Prio3 circuit.
DEVICE_CIRCUITS = {"Count", "Sum", "SumVec", "Histogram", "FixedPointBoundedL2VecSum"}


def device_supported(vdaf) -> Tuple[bool, str]:
    """Whether the port's CUDA prepare serves this VDAF: (ok, reason).  A
    Prio3 whose XOF is not TurboSHAKE128 is served by ``HybridXofBackend``
    (host XOF, card FLP); any number of proofs is served.

    A Poplar1 is served by ``Poplar1Backend`` (the IDPF walk and the
    sketch on the card).

    Duck-typed (a Prio3 is anything with an ``flp``), so it classifies the
    reference's VDAF objects too."""
    if getattr(vdaf, "flp", None) is None:
        name = type(vdaf).__name__
        if name == "Poplar1":
            return True, ""
        return False, f"{name} is not a Prio3 VDAF"
    circuit = type(vdaf.flp.valid).__name__
    if circuit not in DEVICE_CIRCUITS:
        return False, f"no device circuit for {circuit}"
    return True, ""


def _host_xof(vdaf) -> bool:
    """True for a Prio3 whose XOF has no device twin (served by
    ``HybridXofBackend``)."""
    xof = getattr(vdaf, "xof", None) if getattr(vdaf, "flp", None) is not None else XofTurboShake128
    return getattr(xof, "__name__", None) != XofTurboShake128.__name__


def device_path_label(vdaf) -> str:
    """Human-readable routing status for provisioning surfaces: which
    accelerated path serves this VDAF, or the oracle's reason."""
    ok, reason = device_supported(vdaf)
    if not ok:
        return f"cpu-oracle ({reason})"
    if type(vdaf).__name__ == "Poplar1":
        return "poplar1-batch: IDPF walk + sketch on the card, executor kind=poplar_init (level-keyed buckets)"
    if _host_xof(vdaf):
        return "cuda-hybrid: host XOF + card FLP, no executor (direct prep_init/combine)"
    if type(vdaf.flp.valid).__name__ == "FixedPointBoundedL2VecSum":
        return "cuda: multi-gadget batched device prepare (gradient aggregation), executor kind=prep_init/combine"
    return "cuda: batched device prepare, executor kind=prep_init/combine"


def make_backend(
    vdaf,
    backend: str = "cuda",
    device=None,
    canonical: bool = False,
    field_backend: Optional[str] = None,
    devices=None,
):
    """Backend factory: ``"cuda"`` (the default, on ``device``, the card
    unless the caller names another: ``CudaBackend``, for a Prio3 whose
    XOF is not TurboSHAKE128 ``HybridXofBackend``, for a Poplar1
    ``Poplar1Backend``) or ``"oracle"``
    (the CPU oracle, only when named).  An unknown name raises VdafError,
    and so does ``"cuda"`` with no card to run on: there is no quiet
    fallback to the oracle.  ``canonical`` marks ``vdaf`` as a bucket's
    padded twin (``vdaf/canonical.py``): only ``CudaBackend`` honours it
    (the oracle, hybrid and Poplar1 paths are never canonicalized).
    ``field_backend`` ("vpu" | "mxu", None: ``default_field_backend()``)
    is the Prio3 card backends' field layout; an unknown value raises
    VdafError there, and the oracle and Poplar1 have no field layer and
    ignore it.

    ``"mesh"`` is ``MeshBackend`` over ``devices`` (None: ``local_mesh(device)``,
    every visible card unless ``device`` names the CPU); with no card it
    raises VdafError as ``"cuda"`` does.  A Poplar1 and a Prio3 with a host
    XOF keep their one-card backends on the mesh's first device, as the
    JAX ``_meshify`` passes them through."""
    if backend not in BACKENDS:
        raise VdafError(f"unknown backend {backend!r}")
    if backend == "oracle":
        return OracleBackend(vdaf)
    if backend == "mesh":
        devs = local_mesh(device) if devices is None else [torch.device(d) for d in devices]
        device = devs[0]
    device = torch.device(device or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise VdafError(f"the {backend} backend needs a CUDA card, and none is available")
    if type(vdaf).__name__ == "Poplar1":
        return Poplar1Backend(vdaf, device=device)
    if _host_xof(vdaf):
        return HybridXofBackend(vdaf, device=device, field_backend=field_backend)
    if backend == "mesh":
        return MeshBackend(vdaf, devices=devs, canonical=canonical, field_backend=field_backend)
    return CudaBackend(vdaf, device=device, canonical=canonical, field_backend=field_backend)
