"""The port's multi-card prepare (``MeshBackend``, janus_tpu_torch/vdaf/backend.py)
on logical CPU shards.

``MeshBackend(devices=["cpu"] * 4)`` splits each flush into four equal
shards and runs each on its own worker thread, as it runs one shard a card
on the card.  Held byte for byte against ``CudaBackend(device="cpu")`` and
the JAX package's ``OracleBackend`` (verdicts, prepare shares, joint-rand
parts, out shares, combine and aggregate) for Count, a narrow Histogram, an
uneven batch of 13, the mxu layout and a canonical twin's mixed-shape
flush; and against the JAX ``MeshBackend`` itself on the conftest's 8
virtual CPU devices (``tests/test_mesh.py``'s harness)."""

import numpy as np
import pytest

from janus_tpu.vdaf import instances as jax_instances
from janus_tpu.vdaf.backend import OracleBackend as JaxOracleBackend
from janus_tpu_torch.executor import AccumulatorConfig, DeviceAccumulatorStore
from janus_tpu_torch.vdaf import instances
from janus_tpu_torch.vdaf.backend import (
    CudaBackend,
    HybridXofBackend,
    MeshBackend,
    Poplar1Backend,
    ShardedRows,
    VdafError,
    make_backend,
)

SHARDS = ["cpu"] * 4


def _shard(jvdaf, measure, count, seed):
    rng = np.random.default_rng(seed)
    reports = []
    for _ in range(count):
        nonce = rng.bytes(16)
        public, shares = jvdaf.shard(measure(rng), nonce, rng.bytes(jvdaf.RAND_SIZE))
        reports.append((nonce, public, shares))
    return reports


def _side(reports, agg_id):
    return [(n, p, s[agg_id]) for n, p, s in reports]


def _assert_same_outcomes(vdaf, jvdaf, got, want):
    assert len(got) == len(want)
    for (gs, gp), (ws, wp) in zip(got, want):
        assert gp.encode(vdaf) == wp.encode(jvdaf)
        assert gp.joint_rand_part == wp.joint_rand_part
        assert gs.out_share == ws.out_share
        assert gs.corrected_joint_rand_seed == ws.corrected_joint_rand_seed


def _out_limbs(backend, outcomes):
    f = backend.bp.f
    return f.to_limbs([x for state, _ in outcomes for x in state.out_share]).reshape(len(outcomes), -1, f.n)


def _hold_mesh(vdaf, jvdaf, reports, vk, **kw):
    """Both sides and the combine on a 4-shard mesh against one CPU card
    backend and the JAX oracle; the mesh's aggregate against the oracle's.
    Returns the mesh."""
    mesh = MeshBackend(vdaf, devices=SHARDS, **kw)
    one = CudaBackend(vdaf, device="cpu", **kw)
    oracle = JaxOracleBackend(jvdaf)
    sides = []
    for agg_id in (0, 1):
        rows = _side(reports, agg_id)
        got = mesh.prep_init_batch(vk, agg_id, rows)
        _assert_same_outcomes(vdaf, vdaf, got, one.prep_init_batch(vk, agg_id, rows))
        _assert_same_outcomes(vdaf, jvdaf, got, oracle.prep_init_batch(vk, agg_id, rows))
        sides.append(got)
    pairs = [[sides[0][b][1], sides[1][b][1]] for b in range(len(reports))]
    msgs = mesh.prep_shares_to_prep_batch(pairs)
    assert msgs == one.prep_shares_to_prep_batch(pairs)
    assert not any(isinstance(m, Exception) for m in msgs)
    for side in sides:
        mask = np.ones(len(reports), dtype=bool)
        mask[::3] = False
        want = jvdaf.aggregate([s.out_share for (s, _), keep in zip(side, mask) if keep])
        assert mesh.aggregate_batch(_out_limbs(mesh, side), mask) == want
    return mesh


CIRCUITS = {
    "count": (lambda m: m.prio3_count(), lambda r: int(r.integers(0, 2)), 8, {}),
    "histogram": (lambda m: m.prio3_histogram(17, 5), lambda r: int(r.integers(0, 17)), 8, {}),
    "uneven13": (lambda m: m.prio3_histogram(17, 5), lambda r: int(r.integers(0, 17)), 13, {}),
    "mxu": (lambda m: m.prio3_count(), lambda r: int(r.integers(0, 2)), 6, {"field_backend": "mxu"}),
}


@pytest.mark.parametrize("name", sorted(CIRCUITS))
def test_mesh_matches_one_card_and_the_oracle(name):
    """Count, a narrow Histogram, an uneven batch (13 rows pad to 16, four
    rows a shard, the last shard one real row) and Count under the mxu
    layout: every output byte-equal to one ``CudaBackend`` and the JAX
    oracle, the aggregate exact."""
    make, measure, count, kw = CIRCUITS[name]
    vdaf, jvdaf = make(instances), make(jax_instances)
    reports = _shard(jvdaf, measure, count, seed=len(name))
    mesh = _hold_mesh(vdaf, jvdaf, reports, b"\x11" * 16, **kw)
    assert mesh._pad_to(count) % len(SHARDS) == 0
    assert mesh.field_backend == kw.get("field_backend", mesh.field_backend)


def test_canonical_twin_mixed_flush_matches_each_tasks_oracle():
    """A canonical twin mesh (Histogram(9, 3) serving (7, 3) and (8, 3)):
    one flush that mixes both shapes, split over four shards with per-row
    measurement lengths, equals each task's JAX oracle and one card twin."""
    from janus_tpu_torch.vdaf.canonical import executor_shape

    tasks = [(instances.prio3_histogram(n, 3), jax_instances.prio3_histogram(n, 3)) for n in (7, 8)]
    _key, twin = executor_shape(tasks[0][0])
    mesh = MeshBackend(twin, devices=SHARDS, canonical=True)
    one = CudaBackend(twin, device="cpu", canonical=True)
    vks = (b"\x05" * 16, b"\x06" * 16)
    reports = [_shard(j, lambda r, n=v.flp.valid.length: int(r.integers(0, n)), 3 + i, 40 + i)
               for i, (v, j) in enumerate(tasks)]
    for agg_id in (0, 1):
        requests = [(vk, _side(rows, agg_id), v) for vk, rows, (v, _j) in zip(vks, reports, tasks)]
        staged = mesh.stage_prep_init_multi(agg_id, requests)
        assert staged.exact is None and len(staged.placed) == len(SHARDS)
        assert all("meas_len" in placed for placed in staged.placed)
        got = mesh.launch_prep_init_multi(staged, requests)
        same = one.prep_init_multi(agg_id, requests)
        for t, ((vdaf, jvdaf), (vk, rows, _v)) in enumerate(zip(tasks, requests)):
            _assert_same_outcomes(vdaf, vdaf, got[t], same[t])
            _assert_same_outcomes(vdaf, jvdaf, got[t], JaxOracleBackend(jvdaf).prep_init_batch(vk, agg_id, rows))
            assert all(len(s.out_share) == vdaf.flp.OUTPUT_LEN for s, _ in got[t])


def test_resident_out_shares_stay_per_shard_until_the_drain():
    """A retained flush's out shares stay as one piece a shard; the
    accumulator store counts every shard's partial row, a masked commit
    sums per shard, and the drain's one cross-shard modular sum equals the
    oracle's aggregate; no out-share row is read back.  An evicted flush
    (host pieces) sums the same."""
    vdaf, jvdaf = instances.prio3_histogram(17, 5), jax_instances.prio3_histogram(17, 5)
    reports = _shard(jvdaf, lambda r: int(r.integers(0, 17)), 11, 7)
    mesh = MeshBackend(vdaf, devices=SHARDS)
    store = DeviceAccumulatorStore(AccumulatorConfig(enabled=True))
    vk = b"\x2a" * 16
    rows = _side(reports, 0)
    staged = mesh.stage_prep_init_multi(0, [(vk, rows)])
    (out,) = mesh.launch_prep_init_multi(staged, [(vk, rows)], retain_store=store)
    assert mesh.outshare_readback_rows == 0
    refs = [state.out_share for state, _ in out]
    (flush,) = store._flushes.values()
    assert isinstance(flush.matrix, ShardedRows) and len(flush.matrix.pieces) == len(SHARDS)
    assert flush.matrix.shape[0] == staged.pad_to == 16
    keep = [i for i in range(len(refs)) if i % 2 == 0]
    store.commit_rows(("b",), mesh, refs[:4:2], job_token=1, report_ids=[rows[i][0] for i in (0, 2)])
    store._evict(flush)  # the rest of the flush from host pieces
    assert isinstance(flush.matrix, ShardedRows) and all(p.device.type == "cpu" for p in flush.matrix.pieces)
    store.commit_rows(("b",), mesh, [refs[i] for i in keep[2:]], job_token=2,
                      report_ids=[rows[i][0] for i in keep[2:]])
    store.release_refs([refs[i] for i in range(len(refs)) if i % 2])
    buffer_bytes = mesh.accum_buffer_rows * vdaf.flp.OUTPUT_LEN * mesh.bp.f.n * 8
    assert store._buckets[("b",)].buffer_nbytes == buffer_bytes
    vector, _rids = store.drain(("b",), vdaf.flp.field)
    want = JaxOracleBackend(jvdaf).prep_init_batch(vk, 0, rows)
    assert vector == jvdaf.aggregate([want[i][0].out_share for i in keep])
    assert mesh.outshare_readback_rows == 0 and store.stats()["resident_bytes"] == 0


def test_a_failing_shard_raises_and_adopts_nothing(monkeypatch):
    """One shard's prepare fails: the launch raises after every shard has
    ended, the store adopts no flush and no row is served elsewhere."""
    vdaf, jvdaf = instances.prio3_count(), jax_instances.prio3_count()
    mesh = MeshBackend(vdaf, devices=SHARDS)
    rows = _side(_shard(jvdaf, lambda r: int(r.integers(0, 2)), 8, 3), 1)
    real = mesh._launch_prepare
    calls = []

    def launch(agg_id, placed, pad_to, exact=None, device=None):
        calls.append(placed["nonces_u8"][0, 0].item())
        if len(calls) == 3:
            raise RuntimeError("card lost")
        return real(agg_id, placed, pad_to, exact, device)

    monkeypatch.setattr(mesh, "_launch_prepare", launch)
    store = DeviceAccumulatorStore(AccumulatorConfig(enabled=True))
    staged = mesh.stage_prep_init_multi(1, [(b"\x01" * 16, rows)])
    with pytest.raises(RuntimeError, match="card lost"):
        mesh.launch_prep_init_multi(staged, [(b"\x01" * 16, rows)], retain_store=store)
    assert len(calls) == len(SHARDS)
    assert store.stats()["resident_bytes"] == 0 and not store._flushes
    assert mesh.oracle.rows == {"init": 0, "combine": 0}


def test_matches_the_jax_mesh_backend():
    """The same Count reports through the JAX ``MeshBackend`` on 8 virtual
    CPU devices and the port's on 8 CPU shards: the same prepare shares,
    out shares, prep messages and sharded aggregate."""
    import jax

    from janus_tpu.vdaf.backend import MeshBackend as JaxMeshBackend

    vdaf, jvdaf = instances.prio3_count(), jax_instances.prio3_count()
    reports = _shard(jvdaf, lambda r: int(r.integers(0, 2)), 11, 99)
    vk = b"\x2b" * 16
    devices = jax.devices("cpu")
    assert len(devices) >= 8, "conftest must provision 8 virtual CPU devices"
    theirs = JaxMeshBackend(jvdaf, devices=devices[:8])
    ours = MeshBackend(vdaf, devices=["cpu"] * 8)
    assert ours._pad_to(11) == theirs._pad_to(11) == 16
    sides = []
    for agg_id in (0, 1):
        rows = _side(reports, agg_id)
        got = ours.prep_init_batch(vk, agg_id, rows)
        _assert_same_outcomes(vdaf, jvdaf, got, theirs.prep_init_batch(vk, agg_id, rows))
        sides.append(got)
    pairs = [[sides[0][b][1], sides[1][b][1]] for b in range(len(reports))]
    assert ours.prep_shares_to_prep_batch(pairs) == theirs.prep_shares_to_prep_batch(pairs)
    mask = np.ones(len(reports), dtype=bool)
    limbs = _out_limbs(ours, sides[1])
    assert ours.aggregate_batch(limbs, mask) == theirs.aggregate_batch(limbs, mask)


def test_make_backend_mesh():
    """``make_backend(..., "mesh", devices=)`` builds the mesh (one
    batched prepare a distinct device); Poplar1 and the HMAC hybrid keep
    their one-card backends; with no card and no explicit devices "mesh"
    raises VdafError, as "cuda" does."""
    import torch

    vdaf = instances.prio3_count()
    mesh = make_backend(vdaf, "mesh", devices=["cpu", "cpu"], field_backend="mxu")
    assert type(mesh) is MeshBackend and mesh.accum_buffer_rows == 2 and mesh.field_backend == "mxu"
    assert mesh.mesh_devices == ("cpu", "cpu") and len(mesh._mesh_bps) == 1
    assert make_backend(vdaf, "mesh", device="cpu").devices == [torch.device("cpu")]
    assert type(make_backend(instances.vdaf_from_instance({"type": "Poplar1", "bits": 4}), "mesh",
                             devices=["cpu"] * 2)) is Poplar1Backend
    hybrid = instances.prio3_sum_vec_field64_multiproof_hmacsha256_aes128(2, 4, 1, 2)
    assert type(make_backend(hybrid, "mesh", devices=["cpu"] * 2)) is HybridXofBackend
    if not torch.cuda.is_available():
        for kwargs in ({}, {"device": "cuda"}, {"devices": ["cuda:0", "cuda:0"]}):
            with pytest.raises(VdafError):
                make_backend(vdaf, "mesh", **kwargs)


def test_sharded_rows_holder():
    import torch

    pieces = [torch.zeros((4, 3, 2), dtype=torch.int32) for _ in range(3)]
    rows = ShardedRows(pieces)
    assert rows.shape == (12, 3, 2) and rows.numel() == 72 and rows.element_size() == 4
    partial = ShardedRows([torch.zeros((3, 2), dtype=torch.int64)] * 2)
    assert partial.numel() * partial.element_size() == 96
    assert isinstance(rows.cpu(), ShardedRows)


def test_dryrun_multichip_on_cpu_shards(capsys):
    from janus_tpu_torch.dryrun import dryrun_multichip

    assert dryrun_multichip(4, device="cpu") == 4
    assert "dryrun_multichip ok: 4 devices, 8 reports, count=4" in capsys.readouterr().out
