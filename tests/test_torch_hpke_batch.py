"""The port's upload vector pass (``janus_tpu_torch/core/hpke_batch.py``)
held against the JAX package's module on the CPU: its numpy GHASH and its
batched AES-128-GCM open (the AES on CPU tensors here, on the card in
production) byte for byte, ``open_batch`` slot for slot over every suite on
both routes, the RFC 9180 vectors through the batched path, the routing
rule, and the port's one deliberate difference: a vector pass that fails
as a whole answers the upload, and the helper's aggregate-init, with a
retryable 503 and opens nothing another way."""

import asyncio
import json
import os
import secrets
from dataclasses import replace

import numpy as np
import pytest

import janus_tpu.core.hpke as jax_hpke
import janus_tpu.core.hpke_batch as jax_batch
import janus_tpu.messages as jax_messages
from janus_tpu_torch.aggregator import Aggregator, Config
from janus_tpu_torch.aggregator.error import ServiceUnavailable
from janus_tpu_torch.aggregator.report_writer import UploadOpenBatcher
from janus_tpu_torch.aggregator.test_util import InProcessNetwork
from janus_tpu_torch.client import prepare_report
from janus_tpu_torch.core import hpke_batch
from janus_tpu_torch.core.auth_tokens import AuthenticationToken
from janus_tpu_torch.core.hpke import HpkeApplicationInfo, HpkeError, HpkeKeypair, Label, open_, seal
from janus_tpu_torch.core.metrics import GLOBAL_METRICS
from janus_tpu_torch.core.time import MockClock
from janus_tpu_torch.datastore import AggregatorTask, TaskQueryType
from janus_tpu_torch.datastore.test_util import EphemeralDatastore
from janus_tpu_torch.messages import (
    Duration,
    HpkeAeadId,
    HpkeCiphertext,
    HpkeConfig,
    HpkeKdfId,
    HpkeKemId,
    HpkePublicKey,
    Interval,
    Role,
    TaskId,
    Time,
)

INFO = HpkeApplicationInfo.new(Label.INPUT_SHARE, Role.CLIENT, Role.LEADER)
NOW = 1_600_002_000
PRECISION = 3600
ROUTE_ENV = {"port": hpke_batch.VECTOR_GCM_ENV, "jax": "JANUS_TPU_UPLOAD_VECTOR_GCM"}


def _sample(name, labels):
    return GLOBAL_METRICS.get_sample_value(name, labels) or 0.0


def _gcm_batch(rng, lengths, aad_lengths):
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM

    keys = [rng.integers(0, 256, 16, dtype=np.uint8).tobytes() for _ in lengths]
    nonces = [rng.integers(0, 256, 12, dtype=np.uint8).tobytes() for _ in lengths]
    pts = [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in lengths]
    aads = [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in aad_lengths]
    cts = [AESGCM(k).encrypt(n, p, a) for k, n, p, a in zip(keys, nonces, pts, aads)]
    return keys, nonces, pts, aads, cts


@pytest.mark.parametrize("longest", [100, 1500])
def test_ghash_batch_matches_the_reference(longest):
    """Ragged GHASH streams (an empty and a one-byte body among them,
    with and without aad) hash to the JAX package's bytes, with a longest
    body under and over the chunked Horner loop's threshold."""
    assert 100 // 16 + 3 < hpke_batch.CHUNKED_FROM <= 1500 // 16
    rng = np.random.default_rng(7)
    lengths = [0, 1, 15, 16, 17, longest, 0]
    aads = [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in (0, 0, 3, 16, 21, 5, 9)]
    cts = [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in lengths]
    datas = hpke_batch._ghash_inputs(aads, cts)
    h = rng.integers(0, 256, (len(datas), 16), dtype=np.uint8)
    got = hpke_batch._ghash_batch(h, datas)
    assert got.dtype == np.uint8 and got.shape == (len(datas), 16)
    assert got.tobytes() == jax_batch._ghash_batch(h, datas).tobytes()


def test_aesgcm_open_batch_matches_the_reference_and_cryptography():
    """One pass over ragged bodies on CPU tensors: every slot equals the
    JAX package's pass and ``cryptography``'s AESGCM; a flipped tag bit
    and a body under 16 bytes reject only their own slots."""
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM

    rng = np.random.default_rng(11)
    keys, nonces, pts, aads, cts = _gcm_batch(rng, [0, 1, 16, 33, 200, 5], [0, 4, 0, 16, 7, 3])
    cts[3] = cts[3][:-1] + bytes([cts[3][-1] ^ 0x80])  # a flipped tag bit
    cts[5] = cts[5][:15]  # under 16 bytes: no room for the tag
    got = hpke_batch.aesgcm_open_batch(keys, nonces, cts, aads, "cpu")
    assert got == jax_batch.aesgcm_open_batch(keys, nonces, cts, aads)
    for i, (k, n, c, a) in enumerate(zip(keys, nonces, cts, aads)):
        if i in (3, 5):
            assert got[i] is None
        else:
            assert got[i] == AESGCM(k).decrypt(n, c, a) == pts[i]


def _to_jax(request):
    """A port open request as the JAX package's types."""
    keypair, info, ct, aad = request
    config = jax_messages.HpkeConfig.get_decoded(keypair.config.get_encoded())
    return (
        jax_hpke.HpkeKeypair(config, keypair.private_key),
        jax_hpke.HpkeApplicationInfo(info.raw),
        jax_messages.HpkeCiphertext.get_decoded(ct.get_encoded()),
        aad,
    )


@pytest.mark.parametrize("vector_pass", ["1", "0"])
def test_open_batch_parity_all_suites(vector_pass, monkeypatch):
    """Every supported suite in ONE batch: the port's ``open_batch`` equals
    the JAX package's and the inline ``open_`` slot for slot, and a
    corrupted AES-128-GCM row rejects only itself, on both routes (the
    vector pass, and the per-report AEAD a CPU host with `cryptography`
    prefers); the rows are counted on the route that opened them."""
    for env in ROUTE_ENV.values():
        monkeypatch.setenv(env, vector_pass)
    rng = secrets.SystemRandom()
    requests, want = [], []
    for kem in (HpkeKemId.X25519_HKDF_SHA256, HpkeKemId.P256_HKDF_SHA256):
        for aead in (HpkeAeadId.AES_128_GCM, HpkeAeadId.AES_256_GCM, HpkeAeadId.CHACHA20_POLY1305):
            kp = HpkeKeypair.generate(rng.randrange(256), kem_id=kem, aead_id=aead)
            for n in range(3):
                pt = secrets.token_bytes(1 + 37 * n)  # ragged, sub-block to multi-block
                aad = secrets.token_bytes(n * 11)
                requests.append((kp, INFO, seal(kp.config, INFO, pt, aad), aad))
                want.append(pt)
    bad = 2  # an AES-128-GCM row
    kp, info, ct, aad = requests[bad]
    requests[bad] = (kp, info, HpkeCiphertext(ct.config_id, ct.encapsulated_key,
                                              ct.payload[:-1] + bytes([ct.payload[-1] ^ 1])), aad)
    routes = {r: _sample("janus_hpke_open_rows_total", {"stage": "upload", "route": r}) for r in ("vector", "aead")}
    results = hpke_batch.open_batch(requests, device="cpu")
    reference = jax_batch.open_batch([_to_jax(r) for r in requests])
    gcm = sum(1 for r in requests if r[0].config.aead_id == HpkeAeadId.AES_128_GCM)
    moved = {r: _sample("janus_hpke_open_rows_total", {"stage": "upload", "route": r}) - v for r, v in routes.items()}
    assert moved == ({"vector": gcm, "aead": len(requests) - gcm} if vector_pass == "1"
                     else {"vector": 0, "aead": len(requests)})
    for i, (keypair, info, ciphertext, aad) in enumerate(requests):
        try:
            inline = open_(keypair, info, ciphertext, aad)
        except HpkeError as e:
            inline = e
        if i == bad:
            assert isinstance(results[i], HpkeError) and isinstance(inline, HpkeError)
            assert isinstance(reference[i], jax_hpke.HpkeError)
        else:
            assert results[i] == inline == reference[i] == want[i], f"slot {i} diverged"


def test_rfc9180_vectors_through_the_vector_pass(monkeypatch):
    """The vendored CFRG vectors open through ``open_batch`` with the vector
    pass forced, the AES-128-GCM ones in one pass."""
    monkeypatch.setenv(hpke_batch.VECTOR_GCM_ENV, "1")
    with open(os.path.join(os.path.dirname(__file__), "data", "rfc9180-test-vectors.json")) as f:
        vectors = json.load(f)
    requests, want = [], []
    for v in vectors:
        if v["mode"] != 0 or v["kem_id"] not in (0x20, 0x10):
            continue
        if v["kdf_id"] not in (1, 2, 3) or v["aead_id"] not in (1, 2, 3):
            continue
        config = HpkeConfig(1, HpkeKemId(v["kem_id"]), HpkeKdfId(v["kdf_id"]), HpkeAeadId(v["aead_id"]),
                            HpkePublicKey(bytes.fromhex(v["pkRm"])))
        first = v["encryptions"][0]
        requests.append((HpkeKeypair(config, bytes.fromhex(v["skRm"])), HpkeApplicationInfo(bytes.fromhex(v["info"])),
                         HpkeCiphertext(1, bytes.fromhex(v["enc"]), bytes.fromhex(first["ct"])),
                         bytes.fromhex(first["aad"])))
        want.append(bytes.fromhex(first["pt"]))
    assert len(requests) >= 10
    assert sum(1 for r in requests if r[0].config.aead_id == HpkeAeadId.AES_128_GCM) >= hpke_batch.MIN_VECTOR_BATCH
    before = _sample("janus_hpke_open_rows_total", {"stage": "upload", "route": "vector"})
    assert hpke_batch.open_batch(requests, device="cpu") == want
    assert _sample("janus_hpke_open_rows_total", {"stage": "upload", "route": "vector"}) > before


@pytest.mark.parametrize(
    "env,functional,device,card,expect",
    [
        ("1", True, "cpu", False, True),
        ("0", False, "cuda", True, False),
        ("", False, "cpu", False, True),  # no functional `cryptography`: nothing constant-time to prefer
        ("", True, "cuda", True, True),  # a CUDA card configured
        ("", True, None, True, True),  # no device given: the card, as the backend defaults
        ("", True, "cuda", False, False),  # the card is configured but absent
        ("", True, "cpu", True, False),  # the CPU with `cryptography`: AES-NI, never the table AES
    ],
)
def test_vector_pass_preferred(env, functional, device, card, expect, monkeypatch):
    import torch

    import janus_tpu_torch.utils.gcm as gcm

    monkeypatch.setenv(hpke_batch.VECTOR_GCM_ENV, env)
    monkeypatch.setattr(gcm, "HAVE_FUNCTIONAL_CRYPTOGRAPHY", functional)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: card)
    assert hpke_batch.vector_pass_preferred(device) is expect


def test_configured_device_is_the_callers_else_the_card(monkeypatch):
    """The device has one source, the caller's ``Config.vdaf_device``: no
    environment variable moves the vector pass off the card."""
    monkeypatch.setenv("JANUS_TPU_TORCH_VDAF_DEVICE", "cpu")
    assert hpke_batch.configured_device() == "cuda"
    assert hpke_batch.configured_device("cpu") == "cpu"
    assert hpke_batch.configured_device("cuda:1") == "cuda:1"


# ---------------------------------------------------------------------------
# a failed vector pass: 503, never an inline open


def _leader_task(vdaf_desc=None):
    desc = vdaf_desc or {"type": "Prio3Count"}
    common = dict(task_id=TaskId(secrets.token_bytes(32)), query_type=TaskQueryType.time_interval(), vdaf=desc,
                  vdaf_verify_key=b"\x2a" * 16, min_batch_size=1, time_precision=Duration(PRECISION),
                  collector_hpke_config=HpkeKeypair.generate(9).config, peer_aggregator_endpoint="inproc://helper/")
    leader = AggregatorTask(role=Role.LEADER, aggregator_auth_token=AuthenticationToken.new_bearer("a"),
                            collector_auth_token_hash=AuthenticationToken.new_bearer("c").hash(),
                            hpke_keys=[HpkeKeypair.generate(1)], **common)
    helper_keys = HpkeKeypair.generate(2)
    return leader, helper_keys


def _reports(leader, helper_keys, n):
    return [prepare_report(leader.vdaf_instance(), leader.task_id, leader.hpke_keys[0].config, helper_keys.config,
                           Duration(PRECISION), i % 2, time=Time(NOW)) for i in range(n)]


@pytest.fixture()
def broken_pass(monkeypatch):
    """The vector pass forced on and failing as a whole; any inline open
    or per-report AEAD of an AES-128-GCM body is recorded."""
    calls = {"inline": 0, "aead": 0, "vector": 0}
    monkeypatch.setenv(hpke_batch.VECTOR_GCM_ENV, "1")

    def failing(*args, **kwargs):
        calls["vector"] += 1
        raise hpke_batch.VectorPassError("AES-128-GCM vector pass on cuda failed: RuntimeError: device lost")

    open_one, aead_open = hpke_batch._open_one, hpke_batch._aead_open

    def counted_one(*a, **kw):
        calls["inline"] += 1
        return open_one(*a, **kw)

    def counted_aead(*a, **kw):
        calls["aead"] += 1
        return aead_open(*a, **kw)

    monkeypatch.setattr(hpke_batch, "aesgcm_open_batch", failing)
    monkeypatch.setattr(hpke_batch, "_open_one", counted_one)
    monkeypatch.setattr(hpke_batch, "_aead_open", counted_aead)
    return calls


def test_failed_vector_pass_answers_uploads_503_and_opens_nothing_inline(broken_pass):
    """Three concurrent uploads in one open batch whose vector pass fails:
    each PUT answers 503 with Retry-After, the batch is not bisected, no
    report is opened inline or per report, nothing is stored, and the
    failure is counted on /metrics and in the batcher's stats."""
    leader, helper_keys = _leader_task()
    eds = EphemeralDatastore(MockClock(Time(NOW)))
    eds.datastore.run_tx("put", lambda tx: tx.put_aggregator_task(leader))
    agg = Aggregator(eds.datastore, eds.clock, Config(vdaf_backend="oracle", upload_open_batch_delay=0.05,
                                                      vdaf_device="cpu"))
    net = InProcessNetwork()
    url = net.add("leader", agg)
    reports = _reports(leader, helper_keys, 3)
    failures = _sample("janus_hpke_vector_pass_failures_total", {"stage": "upload"})

    async def flow():
        session = net.session()

        async def put(report):
            async with session.put(f"{url}tasks/{leader.task_id}/reports", data=report.get_encoded()) as r:
                return r.status, r.headers.get("Retry-After")

        try:
            return await asyncio.gather(*(put(r) for r in reports))
        finally:
            await session.close()
            await agg.shutdown()

    try:
        answers = asyncio.run(flow())
        assert answers == [(503, "1")] * 3
        assert broken_pass == {"inline": 0, "aead": 0, "vector": 1}
        stats = agg.upload_opener.stats()
        assert stats["vector_pass_failures"] == 1 and stats["bisections"] == 0
        assert _sample("janus_hpke_vector_pass_failures_total", {"stage": "upload"}) == failures + 1
        whole = Interval(Time(0), Duration(2 * NOW))
        assert eds.datastore.run_tx("rows", lambda tx: tx.get_client_reports_for_interval(
            leader.task_id, whole, 100)) == []
    finally:
        eds.cleanup()


def test_failed_vector_pass_stops_a_bisection(broken_pass, monkeypatch):
    """A batch-level fault of another kind sends the batch to bisection;
    when the vector pass then fails, the bisection stops and raises it: no
    singleton is opened per report on its account."""
    from janus_tpu_torch.aggregator import report_writer
    from janus_tpu_torch.core import faults

    leader, helper_keys = _leader_task()
    requests = [(leader.hpke_keys[0], INFO, r.leader_encrypted_input_share, b"") for r in
                _reports(leader, helper_keys, 4)]
    with pytest.raises(hpke_batch.VectorPassError):
        report_writer._open_bisect_worker(requests, "cpu")
    assert broken_pass == {"inline": 0, "aead": 0, "vector": 1}
    batcher = UploadOpenBatcher(max_batch_delay=0.05, device="cpu")
    faults.configure([faults.FaultSpec("upload.open", "error", 1.0)], seed=7)

    async def flow():
        return await asyncio.gather(*(batcher.open(*req) for req in requests), return_exceptions=True)

    try:
        outcomes = asyncio.run(flow())
    finally:
        faults.clear()
    assert all(isinstance(o, ServiceUnavailable) for o in outcomes), outcomes
    assert broken_pass["inline"] == broken_pass["aead"] == 0
    assert batcher.stats()["vector_pass_failures"] == 1


def test_failed_vector_pass_answers_aggregate_init_503(monkeypatch):
    """The helper's aggregate-init opens: with the vector pass failing the
    helper answers the leader's init 503 (counted), opens no report share
    another way, and the job is left for the leader to retry; once the pass
    works again the job completes and the collection is exact."""
    from test_torch_pair import FAMILIES, Pair, run_pair

    desc, measure = FAMILIES["count"]
    pair = Pair(desc, "janus_tpu_torch", "janus_tpu_torch", "inproc", oracle=True)
    seen = {}

    async def scenario(lds, session_factory, clock, collect):
        from janus_tpu_torch.aggregator import AggregationJobCreator, AggregationJobDriver, CreatorConfig, DriverConfig
        from janus_tpu_torch.core.retries import HttpRetryPolicy

        ds = lds.datastore
        await asyncio.sleep(0.05)  # the upload batcher's write delay
        await AggregationJobCreator(ds, CreatorConfig(min_aggregation_job_size=1, max_aggregation_job_size=8)).run_once()
        driver = AggregationJobDriver(ds, session_factory, DriverConfig(
            vdaf_backend="oracle", http_retry=HttpRetryPolicy(0.01, 0.02, 2.0, 2.0, 2)))
        calls = {"inline": 0, "aead": 0}
        open_one, aead_open = hpke_batch._open_one, hpke_batch._aead_open

        def failing(*args, **kwargs):
            raise hpke_batch.VectorPassError("AES-128-GCM vector pass on cuda failed: RuntimeError: device lost")

        def counted(name, fn):
            def wrapped(*a, **kw):
                calls[name] += 1
                return fn(*a, **kw)
            return wrapped

        async def step_all():
            leases = await ds.run_tx_async("acq", lambda tx: tx.acquire_incomplete_aggregation_jobs(Duration(600), 10))
            for lease in leases:
                await driver.step_aggregation_job(lease)
            return len(leases)

        failures = _sample("janus_hpke_vector_pass_failures_total", {"stage": "aggregate_init"})
        try:
            with monkeypatch.context() as m:
                m.setenv(hpke_batch.VECTOR_GCM_ENV, "1")
                m.setattr(hpke_batch, "aesgcm_open_batch", failing)
                m.setattr(hpke_batch, "_open_one", counted("inline", open_one))
                m.setattr(hpke_batch, "_aead_open", counted("aead", aead_open))
                seen["jobs"] = await step_all()
            seen["calls"] = dict(calls)
            seen["failures"] = _sample("janus_hpke_vector_pass_failures_total", {"stage": "aggregate_init"}) - failures
            for _ in range(5):  # the pass works again: the leader's retry completes the job
                clock.advance(Duration(700))
                retried = await step_all()
                seen.setdefault("retried", retried)
                if not retried:
                    break
        finally:
            await driver.close()
        return await collect_after(ds, session_factory, collect)

    async def collect_after(ds, session_factory, collect):
        from janus_tpu_torch.aggregator import CollectionJobDriver

        coll = CollectionJobDriver(ds, session_factory)
        collecting = asyncio.ensure_future(collect())
        try:
            for _ in range(50):
                await asyncio.sleep(0.02)
                for lease in await ds.run_tx_async(
                        "acq_coll", lambda tx: tx.acquire_incomplete_collection_jobs(Duration(600), 10)):
                    await coll.step_collection_job(lease)
                if collecting.done():
                    break
            return await asyncio.wait_for(collecting, 10)
        finally:
            collecting.cancel()
            await coll.close()

    result, meas = run_pair(pair, measure, seed=9, tamper=False, scenario=scenario)
    assert seen["jobs"] >= 1 and seen["retried"] == seen["jobs"], seen
    assert seen["calls"] == {"inline": 0, "aead": 0}, seen
    assert seen["failures"] >= seen["jobs"], seen
    assert result.report_count == len(meas) and result.aggregate_result == sum(meas)


def test_batched_vector_pass_stores_what_the_inline_open_stores(monkeypatch):
    """The same sealed reports through ``upload_open_backend: inline`` and
    through the batched front door with the vector pass forced (on CPU
    tensors) store byte-identical rows; a corrupted ciphertext in the
    batch rejects only itself."""
    monkeypatch.setenv(hpke_batch.VECTOR_GCM_ENV, "1")
    leader, helper_keys = _leader_task()
    reports = _reports(leader, helper_keys, 6)
    share = reports[3].leader_encrypted_input_share
    reports[3] = replace(reports[3], leader_encrypted_input_share=HpkeCiphertext(
        share.config_id, share.encapsulated_key, share.payload[:-1] + bytes([share.payload[-1] ^ 1])))
    stored = {}
    for backend in ("inline", "batched"):
        eds = EphemeralDatastore(MockClock(Time(NOW)))
        eds.datastore.run_tx("put", lambda tx: tx.put_aggregator_task(leader))
        agg = Aggregator(eds.datastore, eds.clock, Config(vdaf_backend="oracle", vdaf_device="cpu",
                                                          upload_open_backend=backend, upload_open_batch_delay=0.02))

        async def flow():
            try:
                return await asyncio.gather(*(agg.handle_upload(leader.task_id, r) for r in reports),
                                            return_exceptions=True)
            finally:
                await agg.shutdown()

        try:
            results = asyncio.run(flow())
            assert [r is None for r in results] == [True, True, True, False, True, True], results
            whole = Interval(Time(0), Duration(2 * NOW))
            stored[backend] = eds.datastore.run_tx("rows", lambda tx: sorted(
                (r.report_id.data, r.public_share, r.leader_input_share, r.helper_encrypted_input_share.payload)
                for r in tx.get_client_reports_for_interval(leader.task_id, whole, 100)))
        finally:
            eds.cleanup()
    assert len(stored["batched"]) == 5 and stored["batched"] == stored["inline"]
    assert agg.upload_opener.stats()["routes"]["vector"] >= 5
