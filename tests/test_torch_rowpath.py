"""The port's row-major prepare against its planar path, the backend's
choice between the prepares against the JAX package's rules, and the exact
aggregate of a flush past the lazy-sum bound, on the CPU."""

from unittest import mock

import numpy as np
import pytest
import torch

from janus_tpu.ops import keccak_pallas
from janus_tpu.ops.prepare import BatchedPrio3 as JaxBatchedPrio3
from janus_tpu.vdaf import instances as jax_instances
from janus_tpu.vdaf.backend import OracleBackend as JaxOracleBackend
from janus_tpu_torch.ops.field import u32_to_tensor
from janus_tpu_torch.ops.prepare import LAZY_SUM_MAX, BatchedPrio3
from janus_tpu_torch.vdaf import instances
from janus_tpu_torch.vdaf.backend import CudaBackend
from test_torch_small import VK, shard, staged_inputs


@pytest.mark.parametrize("agg_id", [0, 1])
@pytest.mark.parametrize(
    "port_ctor,jax_ctor,measure",
    [
        (lambda: instances.prio3_histogram(40, 7), lambda: jax_instances.prio3_histogram(40, 7),
         lambda rng: int(rng.integers(0, 40))),
        (lambda: instances.prio3_sum_vec(10, 1, 3), lambda: jax_instances.prio3_sum_vec(10, 1, 3),
         lambda rng: [int(x) for x in rng.integers(0, 2, 10)]),
        (lambda: instances.prio3_histogram(17, 5), lambda: jax_instances.prio3_histogram(17, 5),
         lambda rng: int(rng.integers(0, 17))),
        (lambda: instances.prio3_sum_vec(9, 1, 4), lambda: jax_instances.prio3_sum_vec(9, 1, 4),
         lambda rng: [int(x) for x in rng.integers(0, 2, 9)]),
    ],
    ids=["histogram40x7", "sumvec10x1x3", "histogram17x5", "sumvec9x1x4"],
)
def test_row_path_matches_planar(port_ctor, jax_ctor, measure, agg_id):
    """prep_init and prep_init_planar on the same staged inputs at B = 8
    (a tampered row among them): every output equal, dtype and all.  The
    last two shapes zero-pad their last call."""
    vdaf = port_ctor()
    bp = BatchedPrio3(vdaf, device="cpu")
    reports = shard(jax_ctor(), measure, 8, seed=30 + agg_id, tamper={3})
    vk, nonces, kw = staged_inputs(vdaf, reports, agg_id)
    assert bp.prep_route(agg_id, 8) == "prep_init_planar"
    planar = bp.prep_init_planar(agg_id, vk, nonces, **kw)
    row = bp.prep_init(agg_id, vk, nonces, **kw)
    assert set(planar) == set(row)
    for k in planar:
        assert planar[k].dtype == row[k].dtype and torch.equal(planar[k], row[k]), k


#: (port constructor, JAX constructor) of every circuit family the routing
#: distinguishes; Histogram(65600, 4100) has MEAS_LEN past 65535.
ROUTED = {
    "count": (instances.prio3_count, jax_instances.prio3_count),
    "sum8": (lambda: instances.prio3_sum(8), lambda: jax_instances.prio3_sum(8)),
    "sumvec4x1x3": (lambda: instances.prio3_sum_vec(4, 1, 3), lambda: jax_instances.prio3_sum_vec(4, 1, 3)),
    "sumvec4x2x3": (lambda: instances.prio3_sum_vec(4, 2, 3), lambda: jax_instances.prio3_sum_vec(4, 2, 3)),
    "histogram10x3": (lambda: instances.prio3_histogram(10, 3), lambda: jax_instances.prio3_histogram(10, 3)),
    "histogram65600x4100": (
        lambda: instances.prio3_histogram(65600, 4100),
        lambda: jax_instances.prio3_histogram(65600, 4100),
    ),
}


@pytest.mark.parametrize("name", list(ROUTED))
def test_routing_matches_jax_rules(name):
    """The backend's chooser picks, from the padded flush size, the planar
    path where the JAX package's TpuBackend._prep_fn picks it by its
    planar_eligible rules (its B % 1024 tile rule left out): Histogram and
    one-bit SumVec up to 65,535 rows.  Count and Sum, which the JAX package
    serves on its limb-planar path up to that size, and everything else
    take the row path.  No prepare runs."""
    port_ctor, jax_ctor = ROUTED[name]
    backend = CudaBackend(port_ctor(), device="cpu")
    jbp = JaxBatchedPrio3(jax_ctor())
    small = name in ("count", "sum8")
    with mock.patch.object(keccak_pallas, "pallas_enabled", lambda batch: True):
        assert jbp.planar_eligible(0, 8) == (name != "sumvec4x2x3" and name != "histogram65600x4100")
        for B in (8, 4096, 40000, 65535, 131072):
            pad = backend._pad_to(B)
            for agg_id in (0, 1):
                planar = jbp.planar_eligible(agg_id, pad) and not small
                want = "prep_init_planar" if planar else "prep_init"
                assert backend._prep_fn(agg_id, pad).__name__ == want, (B, agg_id)
    # 40,000 reports pad to 65,536, past the lazy-sum bound: the row path.
    assert backend._prep_fn(0, backend._pad_to(40000)).__name__ == "prep_init"
    if name == "histogram65600x4100":
        assert backend._prep_fn(0, 8).__name__ == "prep_init"
    with pytest.raises(NotImplementedError):
        backend.bp.prep_init_planar(0, VK, torch.zeros((LAZY_SUM_MAX + 1, 16), dtype=torch.uint8))


def test_flush_padded_past_the_bound_is_served_by_the_row_path(monkeypatch):
    """A Count flush staged at 65,536 rows takes prep_init (here on its
    first 8 rows, to keep the CPU run small) and its rows equal the oracle."""
    vdaf = instances.prio3_count()
    backend = CudaBackend(vdaf, device="cpu")
    jvdaf = jax_instances.prio3_count()
    reports = shard(jvdaf, lambda rng: int(rng.integers(0, 2)), 3, seed=41)
    real = backend.bp.prep_init
    calls = []

    def first_rows(agg_id, vk, nonces, **kw):
        calls.append(nonces.shape[0])
        return real(agg_id, vk[:8], nonces[:8], **{k: v[:8] for k, v in kw.items() if v is not None})

    monkeypatch.setattr(backend.bp, "prep_init", first_rows)
    for agg_id in (0, 1):
        rows = [(nonce, public, shares[agg_id]) for _, nonce, public, shares in reports]
        staged = backend.stage_prep_init_multi(agg_id, [(VK, rows)], pad_to=LAZY_SUM_MAX + 1)
        got = backend.launch_prep_init_multi(staged, [(VK, rows)])[0]
        want = JaxOracleBackend(jvdaf).prep_init_batch(VK, agg_id, rows)
        assert [p.verifiers_share for _, p in got] == [p.verifiers_share for _, p in want]
        assert [s.out_share for s, _ in got] == [s.out_share for s, _ in want]
        assert all(p.joint_rand_part is None and s.corrected_joint_rand_seed is None for s, p in got)
    assert calls == [LAZY_SUM_MAX + 1] * 2


@pytest.mark.parametrize("ctor", [instances.prio3_count, lambda: instances.prio3_sum(8)], ids=["field64", "field128"])
def test_aggregate_past_the_lazy_sum_bound_is_exact(ctor):
    """aggregate over 65,541 masked rows (the pairwise add tree) against
    the integer sum."""
    bp = BatchedPrio3(ctor(), device="cpu")
    f = bp.f
    rng = np.random.default_rng(5)
    B = LAZY_SUM_MAX + 6
    limbs = rng.integers(0, 2**32, size=(B, 1, f.n), dtype=np.uint64).astype(np.uint32)
    limbs[:, 0, f.n - 1] >>= 1  # below 2^(32n - 1) < p: canonical
    mask = rng.integers(0, 2, B).astype(bool)
    got = f.from_limbs(bp.aggregate(u32_to_tensor(limbs, "cpu"), torch.from_numpy(mask)).numpy().astype(np.uint32))
    values = f.from_limbs(limbs[:, 0])
    assert got == [sum(v for v, k in zip(values, mask) if k) % f.p]
