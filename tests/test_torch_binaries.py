"""The port's service binaries (``janus_tpu_torch/binaries``): the config
loader against the JAX package's (the cases of ``tests/test_binaries.py``,
one case per key the port refuses, ``field_backend: mxu`` reaching the
aggregator's and the driver's configs, and the JAX tests' YAML texts loaded by
both loaders to equal fields), the ops CLI's commands, the ``collect``
binary's usage checks, the statusz and build-root wiring, the torch
profiler listener, and one boot of the ``aggregator`` binary in a
subprocess on the CPU (``vdaf_device: cpu``): ``/statusz`` and
``/metrics`` answer, an upload returns 201 and SIGTERM exits 0.  With
``vdaf_backend: cuda`` and no card the binary fails at startup."""

import base64
import dataclasses
import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import pytest
from click.testing import CliRunner

from janus_tpu_torch.binaries.config import (
    AggregatorConfig,
    ConfigError,
    JobCreatorConfig,
    JobDriverBinaryConfig,
    datastore_keys_from_env,
    load_config,
)
from janus_tpu_torch.binaries.janus_cli import cli

REPO = Path(__file__).resolve().parent.parent


def b64(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


class TestConfig:
    def test_defaults(self):
        cfg = load_config(AggregatorConfig)
        assert cfg.listen_address == "0.0.0.0:8080"
        assert cfg.common.database.path == "janus_tpu.sqlite3"
        assert cfg.vdaf_backend == "cuda" and cfg.vdaf_device is None
        assert cfg.device_executor.accumulator.byte_budget is None

    def test_yaml_overrides(self):
        cfg = load_config(
            AggregatorConfig,
            text="""
common:
  database:
    path: /tmp/x.sqlite3
  log_level: DEBUG
listen_address: "127.0.0.1:9999"
vdaf_backend: oracle
vdaf_device: cpu
""",
        )
        assert cfg.common.database.path == "/tmp/x.sqlite3"
        assert cfg.listen_address == "127.0.0.1:9999"
        assert cfg.vdaf_backend == "oracle" and cfg.vdaf_device == "cpu"

    def test_unknown_key_rejected(self):
        with pytest.raises(ConfigError):
            load_config(AggregatorConfig, text="nonsense_key: 1")

    def test_job_driver_nested(self):
        cfg = load_config(
            JobDriverBinaryConfig,
            text="""
job_driver:
  max_concurrent_job_workers: 3
  worker_lease_duration_s: 120
device_executor:
  enabled: true
  warmup_rows: 1024
  accumulator: {enabled: true, drain_interval_s: 1, maintenance_interval_s: 0.5}
""",
        )
        assert cfg.job_driver.max_concurrent_job_workers == 3
        assert cfg.job_driver.worker_lease_duration_s == 120
        ec = cfg.device_executor.to_executor_config()
        assert ec.warmup_rows == 1024 and ec.accumulator.drain_interval_s == 1
        assert ec.accumulator.byte_budget is None  # the minting backend's

    def test_json_config_file(self, tmp_path):
        path = tmp_path / "cfg.json"
        path.write_text(json.dumps({"listen_address": "127.0.0.1:1", "vdaf_device": "cpu"}))
        cfg = load_config(AggregatorConfig, str(path))
        assert cfg.listen_address == "127.0.0.1:1" and cfg.vdaf_device == "cpu"

    def test_datastore_keys_env(self, monkeypatch):
        monkeypatch.setenv("DATASTORE_KEYS", b64(b"\x01" * 16))
        assert datastore_keys_from_env() == [b"\x01" * 16]
        monkeypatch.delenv("DATASTORE_KEYS")
        with pytest.raises(ConfigError):
            datastore_keys_from_env()


@pytest.mark.parametrize(
    "cls,text,reason",
    [
        (AggregatorConfig, "field_backend: tpu", "unknown field_backend"),
        (AggregatorConfig, "common: {distributed_coordinator: '10.0.0.2:8476'}", "multi-device"),
        (JobDriverBinaryConfig, "common: {distributed_coordinator: '10.0.0.2:8476'}", "multi-device"),
        (AggregatorConfig, "poplar_backend: jax", "card walk"),
        (JobDriverBinaryConfig, "poplar_backend: host", "card walk"),
        (JobDriverBinaryConfig, "warmup_wait_s: 2.0", "never falls to the oracle"),
        (AggregatorConfig, "vdaf_backend: tpu", "JAX package"),
    ],
)
def test_refused_keys_name_their_reason(cls, text, reason):
    with pytest.raises(ConfigError, match=reason):
        load_config(cls, text=text)


@pytest.mark.parametrize(
    "cls,build",
    [(AggregatorConfig, "aggregator_config"), (JobDriverBinaryConfig, "aggregation_driver_config")],
)
def test_field_backend_mxu_reaches_the_config(cls, build):
    """``field_backend: mxu`` loads and reaches the aggregator's ``Config``
    and the aggregation-job driver's ``DriverConfig`` as the binaries build
    them."""
    from janus_tpu_torch.binaries import main

    cfg = load_config(cls, text="field_backend: mxu")
    assert cfg.field_backend == "mxu"
    assert getattr(main, build)(cfg).field_backend == "mxu"
    assert getattr(main, build)(load_config(cls, text="")).field_backend == "vpu"


@pytest.mark.parametrize(
    "cls,text,want",
    [
        (AggregatorConfig, "device_executor: {canonical_shapes: true}", True),
        (JobDriverBinaryConfig, "device_executor: {canonical_shapes: false}", False),
        (JobDriverBinaryConfig, "device_executor: {enabled: true}", True),
    ],
)
def test_canonical_shapes_loads_with_the_reference_default(cls, text, want):
    """``canonical_shapes`` loads as set, defaults to True as the JAX
    package's does, and reaches the executor's config."""
    cfg = load_config(cls, text=text)
    assert cfg.device_executor.canonical_shapes is want
    assert cfg.device_executor.to_executor_config().canonical_shapes is want


#: the JAX tests' YAML texts (tests/test_binaries.py,
#: tests/test_torch_accumulator.py) and a fuller deployment's
PARITY_TEXTS = [
    (AggregatorConfig, """
common:
  database:
    path: /tmp/x.sqlite3
  log_level: DEBUG
listen_address: "127.0.0.1:9999"
vdaf_backend: oracle
"""),
    (JobDriverBinaryConfig, """
job_driver:
  max_concurrent_job_workers: 3
  worker_lease_duration_s: 120
"""),
    (JobDriverBinaryConfig, """
device_executor:
  enabled: true
  fair_quota_rows: 4096
  accumulator:
    enabled: true
    byte_budget: 1048576
    drain_interval_s: 1
"""),
    (AggregatorConfig, """
common:
  health_check_listen_address: 127.0.0.1:9001
  status_sample_interval_s: 0.5
  fault_injection: {enabled: true, seed: 7, points: {datastore.tx.begin: {mode: error, probability: 0.05}}}
  slos: {commit_age: {objective: 0.99, threshold_s: 60}}
  fleet: {enabled: true, replica_id: agg-1}
  db_health: {failure_threshold: 5}
max_upload_batch_write_delay_ms: 10
upload_open_backend: inline
ingest: {mode: journaled, journal_batch_size: 10}
task_api_listen_address: 127.0.0.1:9081
task_api_auth_tokens: [admin]
device_executor: {enabled: true, flush_window_ms: 2, accumulator: {enabled: true}}
"""),
    (JobCreatorConfig, """
aggregation_job_creation_interval_s: 1
min_aggregation_job_size: 1
max_aggregation_job_size: 256
"""),
]

#: defaults the port sets apart on purpose: the card backend and the
#: minting backend's byte budget (``canonical_shapes`` is the reference's
#: True, so it is compared like any other field)
PORT_DEFAULTS = {"vdaf_backend": "cuda", "byte_budget": None}


def _assert_same_fields(port: dict, jax: dict, where=""):
    assert set(jax) - set(port) <= {"poplar_backend"}, where
    for key, value in port.items():
        if key not in jax:  # vdaf_device: the port's own
            continue
        if isinstance(value, dict) and isinstance(jax[key], dict) and key not in ("points", "slos"):
            _assert_same_fields(value, jax[key], f"{where}.{key}")
        elif not (key in PORT_DEFAULTS and value == PORT_DEFAULTS[key]):
            assert value == jax[key], f"{where}.{key}"


@pytest.mark.parametrize("i", range(len(PARITY_TEXTS)))
def test_jax_yaml_loads_to_equal_fields(i):
    """A deployment's YAML loads unchanged into the port, and every field
    the port keeps equals the JAX package's reading of it."""
    import janus_tpu.binaries.config as jax_config

    cls, text = PARITY_TEXTS[i]
    port = load_config(cls, text=text)
    jax = jax_config.load_config(getattr(jax_config, cls.__name__), text=text)
    _assert_same_fields(dataclasses.asdict(port), dataclasses.asdict(jax))


class TestCli:
    def test_create_datastore_key(self):
        result = CliRunner().invoke(cli, ["create-datastore-key"])
        assert result.exit_code == 0
        assert len(base64.urlsafe_b64decode(result.output.strip() + "==")) == 16

    def test_generate_hpke_key(self):
        from janus_tpu_torch.messages import HpkeConfig

        result = CliRunner().invoke(cli, ["generate-hpke-key", "--id", "5"])
        assert result.exit_code == 0
        doc = json.loads(result.output)
        assert HpkeConfig.get_decoded(base64.urlsafe_b64decode(doc["config"] + "==")).id == 5

    def test_provision_and_datastore_commands(self, tmp_path, monkeypatch):
        """provision-tasks, the global HPKE key commands, the taskprov peer
        and quarantine list/purge, each against the config's datastore."""
        from janus_tpu_torch.core.time import RealClock
        from janus_tpu_torch.datastore import Crypter, Datastore

        monkeypatch.setenv("DATASTORE_KEYS", b64(b"\x02" * 16))
        db = tmp_path / "cli.sqlite3"
        cfg = tmp_path / "cfg.yaml"
        cfg.write_text(f"common:\n  database:\n    path: {db}\n")
        runner = CliRunner()
        hpke = json.loads(runner.invoke(cli, ["generate-hpke-key", "--id", "1"]).output)
        tasks = tmp_path / "tasks.yaml"
        tasks.write_text(
            f"""
- peer_aggregator_endpoint: https://peer.example.com/
  query_type: {{kind: TimeInterval}}
  vdaf: {{type: Prio3Histogram, length: 4, chunk_length: 2}}
  role: Leader
  vdaf_verify_key: {b64(b"\x03" * 16)}
  min_batch_size: 10
  time_precision_s: 3600
  aggregator_auth_token: tok-123
  collector_auth_token_for_hash: col-456
  collector_hpke_config: {hpke["config"]}
  hpke_keys:
    - config: {hpke["config"]}
      private_key: {hpke["private_key"]}
"""
        )
        conf = ["--config-file", str(cfg)]
        result = runner.invoke(cli, ["provision-tasks", str(tasks), *conf])
        assert result.exit_code == 0, result.output
        assert "provisioned task" in result.output
        assert runner.invoke(cli, ["generate-global-hpke-key", "--id", "7", *conf]).exit_code == 0
        assert runner.invoke(cli, ["set-global-hpke-key-state", "--id", "7", "--state", "Active", *conf]).exit_code == 0
        peer = [
            "add-taskprov-peer-aggregator", "--endpoint", "https://peer.example.com/", "--role", "Helper",
            "--verify-key-init", b64(b"\x05" * 32), "--collector-hpke-config", hpke["config"],
            "--aggregator-auth-token", "peer-tok",
        ]
        assert runner.invoke(cli, [*peer, *conf]).exit_code == 0

        ds = Datastore(str(db), Crypter([b"\x02" * 16]), RealClock())
        try:
            stored = ds.run_tx("get", lambda tx: tx.get_aggregator_tasks())
            assert [t.vdaf for t in stored] == [{"type": "Prio3Histogram", "length": 4, "chunk_length": 2}]
            keys = ds.run_tx("keys", lambda tx: tx.get_global_hpke_keypairs())
            assert [(k.config.id, k.state.value) for k in keys] == [(7, "Active")]
            peers = ds.run_tx("peers", lambda tx: tx.get_taskprov_peer_aggregators())
            assert [p.endpoint for p in peers] == ["https://peer.example.com/"]
            ds.run_tx("q", lambda tx: tx.put_quarantined_report("ab", b"\x01" * 16, "prep_init", "VdafError"))
        finally:
            ds.close()
        listed = runner.invoke(cli, ["quarantine-list", *conf])
        assert listed.exit_code == 0 and json.loads(listed.output.splitlines()[0])["stage"] == "prep_init"
        purged = runner.invoke(cli, ["quarantine-purge", "--yes", *conf])
        assert purged.exit_code == 0 and "purged 1" in purged.output

    def test_dap_decode(self, tmp_path):
        from janus_tpu_torch.messages import CollectionReq, Duration, Interval, Query, Time

        req = CollectionReq(Query.new_time_interval(Interval(Time(3600), Duration(3600))), b"")
        f = tmp_path / "msg.bin"
        f.write_bytes(req.get_encoded())
        result = CliRunner().invoke(cli, ["dap-decode", str(f), "--media-type", "application/dap-collect-req"])
        assert result.exit_code == 0, result.output
        assert "CollectionReq" in result.output


def test_collect_usage_and_unported_binaries(capsys, tmp_path):
    """``collect`` refuses a query it cannot build; ``canary`` loads its
    ``CanaryBinaryConfig`` (an unknown canary key fails the load); an
    interop binary's ``--port`` without a value exits 2."""
    from janus_tpu_torch.binaries.collect import collect
    from janus_tpu_torch.binaries.config import CanaryBinaryConfig
    from janus_tpu_torch.binaries.main import main

    args = ["--task-id", b64(b"\x00" * 32), "--leader", "http://127.0.0.1:1/", "--vdaf", "count",
            "--hpke-config", "AA", "--hpke-private-key", "AA", "--authorization-bearer-token", "t"]
    result = CliRunner().invoke(collect, args, obj={})
    assert result.exit_code == 2 and "exactly one of" in result.output
    cfg = load_config(CanaryBinaryConfig, text="canary: {families: [prio3_sum], probe_interval_s: 1}")
    assert cfg.canary.families == ["prio3_sum"] and cfg.canary.probe_interval_s == 1
    assert load_config(CanaryBinaryConfig).canary.families == ["prio3_sum", "prio3_histogram"]
    bad = tmp_path / "canary.yaml"
    bad.write_text("canary: {probe_every: 1}\n")
    with pytest.raises(ConfigError, match="unknown CanaryConfig keys"):
        main(["canary", "--config-file", str(bad)])
    assert main(["janus_interop_aggregator", "--port"]) == 2
    assert "--port requires a value" in capsys.readouterr().err
    assert main([]) == 2


def test_statusz_names_the_executor_and_the_device(monkeypatch, tmp_path):
    """/statusz reports the executor a binary hands it (buckets, build
    ledger) and the torch device; ``compile_cache_dir`` moves the build
    root of the kernels and the host XOF."""
    import asyncio

    from janus_tpu_torch import _build
    from janus_tpu_torch.binaries.main import _build_executor
    from janus_tpu_torch.core import statusz

    cfg = load_config(JobDriverBinaryConfig, text="device_executor: {enabled: true}")
    ex = _build_executor(cfg.device_executor)
    try:
        doc = asyncio.run(statusz.statusz_snapshot(executor=ex))
        assert doc["executor"]["enabled"] and doc["executor"]["buckets"] == {}
        assert doc["device"]["devices"] and doc["device"]["torch"]
        assert doc["canary"] == {"enabled": False}  # no prober in this process
        assert statusz.retire_idle_executor_buckets(600.0, ex) == 0
    finally:
        ex.shutdown()
    assert asyncio.run(statusz.statusz_snapshot())["executor"] == {"enabled": False}
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    _build.set_build_dir(tmp_path)
    assert _build.library_path("keccak").parent == tmp_path


def test_profiler_server_returns_a_chrome_trace():
    from janus_tpu_torch.core.trace import start_profiler_server

    port = _free_port()
    assert start_profiler_server(port)
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/profile?seconds=0.05", timeout=60) as resp:
        assert "traceEvents" in json.loads(resp.read())
    assert not start_profiler_server(port)  # taken: logged, never fatal


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get(url: str, timeout: float = 5.0) -> bytes:
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.read()


def _boot(tmp_path, extra: str):
    """Seed a leader task into a fresh SQLite file and start the port's
    aggregator binary on it; returns (process, ports, task, log path)."""
    from janus_tpu_torch.core.hpke import HpkeKeypair
    from janus_tpu_torch.core.time import RealClock
    from janus_tpu_torch.datastore import AggregatorTask, Crypter, Datastore, TaskQueryType
    from janus_tpu_torch.messages import Duration, Role, TaskId

    key = b"\x09" * 16
    db = tmp_path / "leader.sqlite3"
    task = AggregatorTask(
        task_id=TaskId.random(), peer_aggregator_endpoint="http://127.0.0.1:1/",
        query_type=TaskQueryType.time_interval(), vdaf={"type": "Prio3Count"}, role=Role.LEADER,
        vdaf_verify_key=b"\x2a" * 16, min_batch_size=1, time_precision=Duration(3600),
        hpke_keys=[HpkeKeypair.generate(1)], collector_hpke_config=HpkeKeypair.generate(2).config,
    )
    ds = Datastore(str(db), Crypter([key]), RealClock())
    ds.run_tx("put", lambda tx: tx.put_aggregator_task(task))
    ds.close()
    port, health = _free_port(), _free_port()
    cfg = tmp_path / "leader.yaml"
    cfg.write_text(
        f"common:\n  database: {{path: {db}}}\n  health_check_listen_address: 127.0.0.1:{health}\n"
        f"listen_address: 127.0.0.1:{port}\nmax_upload_batch_write_delay_ms: 10\n{extra}"
    )
    env = dict(os.environ, DATASTORE_KEYS=b64(key), PYTHONPATH=str(REPO))
    log = tmp_path / "leader.log"
    with open(log, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "janus_tpu_torch.binaries", "aggregator", "--config-file", str(cfg)],
            env=env, cwd=str(tmp_path), stdout=out, stderr=subprocess.STDOUT,
        )
    return proc, port, health, task, log


def test_aggregator_binary_boots_serves_and_stops_on_the_cpu(tmp_path):
    """The port's aggregator on ``vdaf_device: cpu``: /statusz and /metrics
    answer, an upload returns 201, SIGTERM exits 0."""
    from janus_tpu_torch.client import prepare_report
    from janus_tpu_torch.messages import Duration
    from janus_tpu_torch.vdaf.instances import vdaf_from_instance

    proc, port, health, task, log = _boot(tmp_path, "vdaf_device: cpu\n")
    try:
        deadline = time.monotonic() + 60  # a loaded host starts it slowly
        while True:
            try:
                _get(f"http://127.0.0.1:{health}/healthz", 1)
                break
            except OSError:
                assert proc.poll() is None and time.monotonic() < deadline, log.read_text()
                time.sleep(0.1)
        status = json.loads(_get(f"http://127.0.0.1:{health}/statusz"))
        assert status["pid"] == proc.pid and status["journal"]["outstanding_rows"] == 0
        cfg = task.hpke_keys[0].config
        report = prepare_report(vdaf_from_instance(task.vdaf), task.task_id, cfg, cfg, Duration(3600), 1)
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/tasks/{task.task_id}/reports", data=report.get_encoded(), method="PUT",
            headers={"Content-Type": "application/dap-report"},
        )
        with urllib.request.urlopen(req, timeout=10) as resp:
            assert resp.status == 201
        assert b"janus_" in _get(f"http://127.0.0.1:{health}/metrics")
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0, log.read_text()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_cuda_backend_without_a_card_fails_at_startup(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc, _port, _health, _task, log = _boot(tmp_path, "")
    try:
        assert proc.wait(timeout=60) != 0
    finally:
        if proc.poll() is None:
            proc.kill()
    assert "needs a CUDA card" in log.read_text()
