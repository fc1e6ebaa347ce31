"""No VDAF silently runs off the card in the port's control plane.

The driver, provisioning and metrics cases of tests/test_backend_fallback.py
on the port's copy.  The port's rule differs from the reference's in one
way: the oracle serves a task only where ``device_supported`` is False
(the Fake* VDAFs here), logged and counted; for a circuit the card serves,
an error from building ``CudaBackend`` propagates instead of landing on the
oracle."""

import asyncio
import logging

import pytest

from janus_tpu_torch.aggregator import aggregator as aggregator_mod
from janus_tpu_torch.aggregator.aggregation_job_driver import AggregationJobDriver, DriverConfig
from janus_tpu_torch.core.auth_tokens import AuthenticationToken
from janus_tpu_torch.core.hpke import HpkeKeypair
from janus_tpu_torch.core.time import MockClock
from janus_tpu_torch.datastore import AggregatorTask, TaskQueryType
from janus_tpu_torch.datastore.test_util import EphemeralDatastore
from janus_tpu_torch.datastore.task import vdaf_verify_key_length
from janus_tpu_torch.messages import Duration, Role, TaskId, Time
from janus_tpu_torch.vdaf.backend import CudaBackend, HybridXofBackend, OracleBackend, device_path_label

FALLBACK_LOG = "falls back to the CPU oracle"


def make_task(vdaf, role=Role.LEADER):
    return AggregatorTask(
        task_id=TaskId.random(),
        peer_aggregator_endpoint="inproc://peer/",
        query_type=TaskQueryType.time_interval(),
        vdaf=vdaf,
        role=role,
        vdaf_verify_key=b"\x01" * vdaf_verify_key_length(vdaf),
        min_batch_size=10,
        time_precision=Duration(3600),
        aggregator_auth_token=AuthenticationToken.new_bearer("token-abc") if role == Role.LEADER else None,
        aggregator_auth_token_hash=AuthenticationToken.new_bearer("token-abc").hash() if role == Role.HELPER else None,
        collector_auth_token_hash=AuthenticationToken.new_bearer("col-tok").hash() if role == Role.LEADER else None,
        hpke_keys=[HpkeKeypair.generate(1)],
    )


def _driver(**config):
    return AggregationJobDriver(None, session_factory=lambda: None, config=DriverConfig(vdaf_device="cpu", **config))


def test_driver_fallback_is_logged(caplog):
    """A Prio3 whose circuit has no device arm (a renamed SumVec stand-in)
    logs and counts on first dispatch and lands on the oracle; the cached
    second dispatch does not re-log."""
    from janus_tpu_torch.fields import Field128
    from janus_tpu_torch.flp import FlpGeneric, SumVec
    from janus_tpu_torch.vdaf.prio3 import ALG_PRIO3_SUMVEC, Prio3

    class FrontierVec(SumVec):
        """A circuit type outside DEVICE_CIRCUITS."""

    driver = _driver()
    task = make_task({"type": "Prio3Count"})
    vdaf = Prio3(FlpGeneric(FrontierVec(length=3, bits=1, chunk_length=2, field=Field128)), ALG_PRIO3_SUMVEC)
    with caplog.at_level(logging.WARNING):
        backend = driver._backend_for(task, vdaf)
    assert isinstance(backend, OracleBackend)
    assert any(FALLBACK_LOG in r.message for r in caplog.records)
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        assert driver._backend_for(task, vdaf) is backend
    assert not caplog.records


def test_driver_fpvec_resolves_to_the_oracle_and_served_circuits_to_the_card(caplog):
    """FixedPointBoundedL2VecSum rides the multi-gadget row path: the driver
    resolves it to ``CudaBackend`` (here on the CPU) without a warning, as
    it does a served single-gadget circuit, and resolving again hits the
    cache."""
    driver = _driver()
    task = make_task({"type": "Prio3FixedPointBoundedL2VecSum", "bitsize": "BitSize16", "length": 3})
    with caplog.at_level(logging.WARNING):
        backend = driver._backend_for(task, task.vdaf_instance())
    assert isinstance(backend, CudaBackend) and backend.device.type == "cpu"
    assert backend.bp.prep_route(0, 8) == "prep_init"
    assert not caplog.records
    task = make_task({"type": "Prio3Histogram", "length": 4, "chunk_length": 2})
    with caplog.at_level(logging.WARNING):
        backend = driver._backend_for(task, task.vdaf_instance())
    assert isinstance(backend, CudaBackend) and backend.device.type == "cpu"
    assert not caplog.records
    assert driver._backend_for(task, task.vdaf_instance()) is backend


def test_served_circuit_build_failure_raises_and_is_not_served_by_the_oracle(monkeypatch):
    """The reference turns a failed device build into the oracle; the port
    does not: the driver's resolution and the helper's ``TaskAggregator``
    both raise the build error for a circuit the card serves."""

    def broken_build(vdaf, backend="cuda", device=None, field_backend=None):
        raise RuntimeError("nvcc failed")

    monkeypatch.setattr(aggregator_mod, "make_backend", broken_build)
    task = make_task({"type": "Prio3Sum", "bits": 8})
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _driver()._backend_for(task, task.vdaf_instance())
    ta = aggregator_mod.TaskAggregator(make_task({"type": "Prio3Sum", "bits": 8}, Role.HELPER), "cuda", "cpu")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        ta.backend


def test_default_backend_is_the_card():
    """The configs default to "cuda" on the card; with no card here,
    resolving a served circuit raises rather than fall back."""
    import torch

    from janus_tpu_torch.vdaf.prio3 import VdafError

    assert aggregator_mod.Config().vdaf_backend == DriverConfig().vdaf_backend == "cuda"
    assert aggregator_mod.Config().vdaf_device is None and DriverConfig().vdaf_device is None
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default backend builds")
    task = make_task({"type": "Prio3Count"})
    driver = AggregationJobDriver(None, session_factory=lambda: None, config=DriverConfig())
    with pytest.raises(VdafError, match="needs a CUDA card"):
        driver._backend_for(task, task.vdaf_instance())


def test_provisioning_warns_for_oracle_only_vdaf(caplog):
    """A provisioned task's first use resolves its backend: the Fake test
    double warns and takes the oracle, and its ``device_path_label`` says
    so; Prio3Count and FixedPointBoundedL2VecSum take ``CudaBackend`` and
    the HMAC multiproof SumVec ``HybridXofBackend``, without a warning.  (The management API that prints these
    labels comes with the port's binaries, ROADMAP queue 1 item 11.)"""
    eds = EphemeralDatastore(MockClock(Time(1_600_002_000)))
    agg = aggregator_mod.Aggregator(eds.datastore, eds.clock, aggregator_mod.Config(vdaf_device="cpu"))
    cases = [
        ({"type": "Fake"}, OracleBackend, "cpu-oracle"),
        ({"type": "Prio3FixedPointBoundedL2VecSum", "bitsize": 16, "length": 3}, CudaBackend, "cuda: multi-gadget"),
        ({"type": "Prio3SumVecField64MultiproofHmacSha256Aes128", "proofs": 2, "length": 4, "bits": 1,
          "chunk_length": 2}, HybridXofBackend, "cuda-hybrid:"),
        ({"type": "Prio3Count"}, CudaBackend, "cuda:"),
    ]
    try:
        for vdaf, kind, label in cases:
            task = make_task(vdaf)
            eds.datastore.run_tx("put", lambda tx, t=task: tx.put_aggregator_task(t))
            caplog.clear()
            with caplog.at_level(logging.WARNING):
                ta = asyncio.run(agg.task_aggregator_for(task.task_id))
                assert isinstance(ta.backend, kind), vdaf
            warned = any(FALLBACK_LOG in r.message for r in caplog.records)
            assert warned == (kind is OracleBackend), vdaf
            assert device_path_label(ta.vdaf).startswith(label), vdaf
    finally:
        asyncio.run(agg.shutdown())
        eds.cleanup()


def test_per_backend_prepare_metrics():
    """Every prepare/combine batch records reports and wall time per
    backend, so an oracle-pinned task stays visible."""
    from janus_tpu_torch.core import metrics as metrics_mod
    from janus_tpu_torch.vdaf.instances import prio3_count

    if not metrics_mod.HAVE_PROMETHEUS:
        pytest.skip("prometheus_client unavailable")
    fresh = metrics_mod.Metrics()
    old = metrics_mod.GLOBAL_METRICS
    metrics_mod.GLOBAL_METRICS = fresh
    try:
        vdaf = prio3_count()
        be = OracleBackend(vdaf)
        vk, nonce = b"\x01" * 16, b"\x02" * 16
        pub, shares = vdaf.shard(1, nonce, bytes(range(vdaf.RAND_SIZE)))
        (_st0, ps0), = be.prep_init_batch(vk, 0, [(nonce, pub, shares[0])])
        (_st1, ps1), = be.prep_init_batch(vk, 1, [(nonce, pub, shares[1])])
        be.prep_shares_to_prep_batch([[ps0, ps1]])
        text = fresh.export().decode()
        assert 'janus_vdaf_prepare_reports_total{backend="oracle",phase="init"} 2.0' in text
        assert 'janus_vdaf_prepare_reports_total{backend="oracle",phase="combine"} 1.0' in text
        assert 'janus_vdaf_prepare_duration_seconds_count{backend="oracle",phase="init"}' in text
        assert be.rows == {"init": 2, "combine": 1}
    finally:
        metrics_mod.GLOBAL_METRICS = old
