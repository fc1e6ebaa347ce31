"""Fault injection in the port's control plane (janus_tpu_torch/core/faults.py).

Every ``KNOWN_POINTS`` name is fired at its call site in the port, the
control plane's points included (``collection.aggregate_share`` and
``clock.skew`` among them), and ``SkewedClock`` applies the registry's
offsets, as tests/test_chaos.py holds for the JAX package."""

from pathlib import Path

import pytest

import janus_tpu_torch
from janus_tpu_torch.core import faults
from janus_tpu_torch.core.faults import FaultSpec, SkewedClock
from janus_tpu_torch.core.time import MockClock
from janus_tpu_torch.messages import Duration, Time

PORT = Path(janus_tpu_torch.__file__).parent

WIRING = {
    "datastore.tx.begin": "datastore/datastore.py",
    "datastore.tx.commit": "datastore/datastore.py",
    "http.request": "core/retries.py",
    "executor.flush": "executor/service.py",
    "backend.launch": "vdaf/backend.py",
    "backend.device_lost": "vdaf/backend.py",
    "backend.combine": "vdaf/backend.py",
    "clock.skew": "core/faults.py",
    "upload.open": "aggregator/report_writer.py",
    "report_writer.flush": "aggregator/report_writer.py",
    "gc.run": "aggregator/garbage_collector.py",
    "key_rotator.run": "aggregator/key_rotator.py",
    "accumulator.spill": "executor/accumulator.py",
    "accumulator.evict": "executor/accumulator.py",
    "accumulator.replay": "aggregator/collection_job_driver.py",
    "ingest.journal": "core/ingest.py",
    "collection.aggregate_share": "aggregator/collection_job_driver.py",
    "journal.corrupt": "datastore/datastore.py",
}


@pytest.fixture(autouse=True)
def _clean():
    faults.clear()
    yield
    faults.clear()


def test_wiring_table_covers_known_points():
    assert set(WIRING) == set(faults.KNOWN_POINTS)


@pytest.mark.parametrize("point", sorted(WIRING))
def test_every_known_point_is_wired(point):
    """Each name appears, quoted, at its call site (a renamed point must
    fail here, not silently stop injecting)."""
    assert f'"{point}"' in (PORT / WIRING[point]).read_text(), (point, WIRING[point])


def test_skewed_clock_applies_registry_offsets():
    base = MockClock(Time(1_600_000_000))
    clock = SkewedClock(base)
    assert clock.now().seconds == 1_600_000_000  # faults off: no skew
    faults.configure([FaultSpec("clock.skew", "skew", 1.0, skew_s=30)], seed=7)
    seen = {clock.now().seconds - base.now().seconds for _ in range(32)}
    assert seen - {0}, "skew must fire at p=1"
    assert all(-30 <= s <= 30 for s in seen)
    assert all(isinstance(clock.now(), Time) for _ in range(4))
    clock.advance(Duration(60))  # delegation to the wrapped MockClock
    assert base.now().seconds == 1_600_000_060
