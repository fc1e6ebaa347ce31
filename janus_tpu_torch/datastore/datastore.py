"""SQLite-backed datastore with the reference's Postgres semantics.

The analog of ``Datastore``/``Transaction`` (reference:
aggregator_core/src/datastore.rs:108,249): all framework components
coordinate exclusively through this store; every protocol step commits a
state machine transition, so the database is the checkpoint.

Mapping of Postgres machinery onto SQLite:

- ``run_tx`` retry loop (reference datastore.rs:249-298): transactions run
  under ``BEGIN IMMEDIATE`` (writer) and retry on SQLITE_BUSY the way the
  reference retries serialization failures at RepeatableRead.
- ``FOR UPDATE SKIP LOCKED`` lease acquisition (reference datastore.rs:1916):
  SQLite has one writer at a time, so a single atomic
  ``UPDATE … WHERE id IN (SELECT …) RETURNING`` has the same effect — two
  concurrent acquirers can never lease the same job.
- Column crypto: AES-GCM via :class:`~janus_tpu_torch.datastore.crypter.Crypter`
  with AAD = (table, row-ident, column) (reference datastore.rs:5622).

The SQL dialect is confined behind backend_sql.py: the default is this
module's documented SQLite mapping, and a ``postgres://`` database path
selects the shared-Postgres backend with real ``FOR UPDATE SKIP LOCKED``
lease scans and serialization-failure retries — the reference's deployment
shape — behind the same Transaction API.
"""

from __future__ import annotations

import asyncio
import json
import secrets
import sqlite3
import threading
import time as _time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, TypeVar

from ..core import faults
from ..core.quarantine import chain_crc
from ..core.auth_tokens import AuthenticationToken, AuthenticationTokenHash
from ..core.hpke import HpkeKeypair
from ..core.time import Clock
from ..messages import (
    AggregationJobId,
    AggregationJobStep,
    BatchId,
    CollectionJobId,
    Duration,
    Extension,
    FixedSize,
    HpkeCiphertext,
    HpkeConfig,
    Interval,
    PrepareError,
    PrepareResp,
    Query,
    ReportId,
    ReportIdChecksum,
    ReportMetadata,
    Role,
    TaskId,
    Time,
    TimeInterval,
)
from ..messages.codec import Decoder, Encoder
from .crypter import Crypter
from .models import (
    AccumulatorJournalEntry,
    AcquiredAggregationJob,
    AcquiredCollectionJob,
    AggregateShareJob,
    AggregationJob,
    AggregationJobState,
    BatchAggregation,
    BatchAggregationState,
    CollectionJob,
    CollectionJobState,
    FleetMember,
    GlobalHpkeKeypair,
    HpkeKeyState,
    Lease,
    LeaseToken,
    LeaderStoredReport,
    OutstandingBatch,
    ReportAggregation,
    ReportAggregationMetadata,
    ReportAggregationState,
    TaskUploadCounter,
)
from .schema import MIGRATIONS, SUPPORTED_SCHEMA_VERSIONS
from .task import AggregatorTask, TaskQueryType

T = TypeVar("T")

#: task-level query-type kind -> wire query-type class
QUERY_TYPES = {"TimeInterval": TimeInterval, "FixedSize": FixedSize}

#: (job_type, table, active-state) per leasable job table.  The
#: "acquirable" predicate these imply — ``state = <active> AND
#: lease_expiry <= now`` — MUST stay in lockstep with the
#: acquire_incomplete_*_jobs queries; Transaction.lease_summary() is the
#: single read-side source for those counts (/statusz + the
#: janus_acquirable_jobs sampler).
_JOB_LEASE_TABLES = (
    ("aggregation", "aggregation_jobs", "InProgress"),
    ("collection", "collection_jobs", "Start"),
)


class DatastoreError(Exception):
    pass


class DatastoreUnavailable(DatastoreError):
    """A transaction exhausted its retry budget on TRANSIENT failures
    (lock contention, serialization, injected faults) — the datastore is
    unreachable-or-overloaded right now, not wrong.  The HTTP layer maps
    this — and only this — DatastoreError shape to a DAP-retryable 503:
    permanent conditions (missing rows, schema mismatch) stay loud."""


class TxConflict(DatastoreError):
    """A uniqueness/state conflict the caller must handle (maps the
    reference's Error::MutationTargetAlreadyExists and friends)."""


class TaskNotFound(DatastoreError):
    pass


def _encode_extensions(extensions: Sequence[Extension]) -> bytes:
    w = Encoder()
    w.items_u16(extensions, lambda ww, e: e.encode(ww))
    return w.take()


def _decode_extensions(data: bytes) -> List[Extension]:
    r = Decoder(data)
    out = r.items_u16(Extension._decode)
    r.finish()
    return out


def _report_journal_crc(
    rid: bytes,
    ts: int,
    ext_b: Optional[bytes],
    public_share: Optional[bytes],
    enc_share: Optional[bytes],
    helper_b: Optional[bytes],
) -> int:
    """CRC32C witness over a report_journal row's payload columns.  Computed at write time over the bytes as stored (the share
    ciphertext, not its plaintext) so verification never needs a decrypt."""
    return chain_crc(
        rid, int(ts).to_bytes(8, "big"), ext_b, public_share, enc_share, helper_b
    )


def _accumulator_journal_crc(
    batch_identifier: bytes, param: bytes, job_id: bytes, rids_b: bytes
) -> int:
    """CRC32C witness over an accumulator_journal row's payload columns."""
    return chain_crc(batch_identifier, param, job_id, rids_b)


def _metrics_tx(name: str, status: str) -> None:
    """reference: datastore.rs:186-224 per-tx status metrics."""
    from ..core.metrics import GLOBAL_METRICS

    if GLOBAL_METRICS.registry is not None:
        GLOBAL_METRICS.tx_total.labels(name=name, status=status).inc()


class Datastore:
    """Thread-safe handle; one backend connection per thread.

    ``path`` is an SQLite file path (hermetic default) or a
    ``postgres://`` DSN selecting the shared-Postgres backend
    (backend_sql.py; reference DbConfig url, config.rs:75).
    """

    def __init__(
        self,
        path: str,
        crypter: Crypter,
        clock: Clock,
        max_transaction_retries: int = 30,
        migrate_on_open: bool = True,
        _migrations_override: Optional[List[str]] = None,
    ):
        from .backend_sql import backend_for

        self.path = path
        self.backend = backend_for(path)
        self.crypter = crypter
        self.clock = clock
        self.max_transaction_retries = max_transaction_retries
        #: True (hermetic default): apply pending schema migrations on open.
        #: False: the production deploy shape — an operator migrates, the
        #: binary only checks SUPPORTED_SCHEMA_VERSIONS.
        self.migrate_on_open = migrate_on_open
        self._migrations_override = _migrations_override  # tests only
        self._local = threading.local()
        self._init_schema()

    # -- connections ----------------------------------------------------
    def _conn(self):
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = self.backend.connect()
            self._local.conn = conn
        return conn

    def _current_schema_version(self, conn) -> int:
        """Transaction-safe: probes the catalog first, so a missing table
        never errors (a failed SELECT would abort a Postgres transaction)."""
        exists = conn.execute(
            self.backend.table_exists_sql, ("schema_version",)
        ).fetchone()
        if exists is None:
            return 0
        row = conn.execute("SELECT version FROM schema_version").fetchone()
        return 0 if row is None else int(row[0])

    def _init_schema(self) -> None:
        conn = self._conn()
        current = self._current_schema_version(conn)
        migrations = self._migrations_override or MIGRATIONS
        target = len(migrations)
        if current > target:
            raise DatastoreError(
                f"database schema version {current} is newer than this build "
                f"supports ({target}); refusing to touch it"
            )
        if not self.migrate_on_open:
            # Production deploy shape: an operator applies migrations; the
            # binary only gates (reference: supported_schema_versions!,
            # datastore.rs:77-104).
            supported = (
                (target,) if self._migrations_override else SUPPORTED_SCHEMA_VERSIONS
            )
            if current not in supported:
                raise DatastoreError(
                    f"unsupported schema version {current} "
                    f"(supported: {supported})"
                )
            return
        for v in range(current, target):
            # One migration per transaction, DDL and version stamp TOGETHER:
            # a crash can never commit DDL without advancing the stamp, so
            # non-idempotent future migrations stay re-runnable.  (SQLite
            # runs DDL transactionally; Postgres supports transactional DDL
            # outright.)  The version is RE-READ under the write lock:
            # concurrent replica startups serialize here, and a replica
            # that lost the race skips the migration another already
            # applied instead of double-applying it.
            conn.execute(self.backend.begin_sql)
            try:
                if self._current_schema_version(conn) != v:
                    conn.rollback()
                    continue
                self.backend.init_schema(conn, migrations[v])
                if v == 0:
                    conn.execute(
                        "INSERT INTO schema_version (version) VALUES (?)", (1,)
                    )
                else:
                    conn.execute("UPDATE schema_version SET version = ?", (v + 1,))
                conn.commit()
            except BaseException:
                try:
                    conn.rollback()
                except Exception:
                    pass
                raise

    def close(self) -> None:
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            conn.close()
            self._local.conn = None

    def _evict_conn(self) -> None:
        """Drop this thread's cached connection (it may be dead — e.g. a
        network backend's server restarted).  The next _conn() reconnects."""
        conn = getattr(self._local, "conn", None)
        self._local.conn = None
        if conn is not None:
            try:
                conn.close()
            except Exception:
                pass

    # -- transactions ---------------------------------------------------
    def run_tx(
        self,
        name: str,
        fn: Callable[["Transaction"], T],
        deadline_s: Optional[float] = None,
    ) -> T:
        """Run ``fn`` in one transaction, retrying on lock contention /
        serialization failure (reference: datastore.rs:249 run_tx /
        :298 run_tx_once; retry classification is per-backend).

        Every transient (retryable) failure feeds the process-wide
        datastore health tracker (core/db_health.py) and sleeps a
        full-jitter exponential backoff; a commit resets it.  Permanent
        errors (schema, integrity) raise immediately and say nothing
        about datastore health.

        ``deadline_s`` bounds the retry loop's total wall time: a
        lease-holding caller (a job driver releasing mid-brownout) sets
        it so the release attempt always returns in-band instead of
        holding the lease through ``max_transaction_retries`` sleeps —
        exhausting the deadline raises ``DatastoreUnavailable`` exactly
        like exhausting the attempt budget."""
        from ..core.db_health import tracker as db_tracker

        deadline = (
            _time.monotonic() + deadline_s if deadline_s is not None else None
        )
        last_err: Optional[BaseException] = None
        for attempt in range(self.max_transaction_retries):
            conn = self._conn()
            try:
                # Failure-domain boundary: an injected begin fault is
                # indistinguishable from lock contention and retries the
                # same way (core/faults.py; off by default).
                faults.fire("datastore.tx.begin")
                conn.execute(self.backend.begin_sql)
            except Exception as e:
                if not self._is_retryable(e):
                    # Non-retryable BEGIN failure usually means the cached
                    # connection is dead (server restart on a network
                    # backend): reconnect before surfacing the error.
                    # Retryable failures (SQLite lock contention) keep the
                    # healthy connection — re-opening per retry would add
                    # connection churn to the contended hot path.
                    self._evict_conn()
                    raise
                last_err = e
                if not self._retry_backoff(e, attempt, deadline):
                    break
                continue
            tx = Transaction(self, conn)
            try:
                result = fn(tx)
                # Commit-boundary fault: rolls back and re-runs fn, exactly
                # like a serialization failure at COMMIT would.
                faults.fire("datastore.tx.commit")
                conn.commit()
                _metrics_tx(name, "committed")
                db_tracker().record_tx_success()
                return result
            except BaseException as e:
                try:
                    conn.rollback()
                except Exception:
                    # Never mask the original error with a rollback failure
                    # on a broken connection; reconnect next attempt.
                    self._evict_conn()
                if self._is_retryable(e):
                    last_err = e
                    if not self._retry_backoff(e, attempt, deadline):
                        break
                    continue
                raise
        _metrics_tx(name, "exhausted")
        raise DatastoreUnavailable(
            f"transaction {name!r} exhausted retries: {last_err}"
        )

    def _retry_backoff(
        self,
        err: BaseException,
        attempt: int,
        deadline: Optional[float],
    ) -> bool:
        """One transient-failure bookkeeping step for ``run_tx``: feed the
        health tracker, drop a disconnect-shaped connection (retrying a
        dead socket forever is not a retry), then sleep the jittered
        backoff.  Returns False when the sleep would cross ``deadline`` —
        the caller breaks to the exhausted raise instead of sleeping."""
        from ..core.db_health import backoff_s
        from ..core.db_health import tracker as db_tracker

        db_tracker().record_tx_failure()
        if self.backend.is_disconnect(err):
            self._evict_conn()
        delay = backoff_s(attempt)
        if deadline is not None and _time.monotonic() + delay >= deadline:
            return False
        _time.sleep(delay)
        return True

    def _is_retryable(self, e: BaseException) -> bool:
        """Backend retry classification, plus injected faults — which
        impersonate transient infrastructure failures by contract."""
        return isinstance(e, faults.FaultInjectedError) or self.backend.is_retryable(e)

    async def run_tx_async(
        self,
        name: str,
        fn: Callable[["Transaction"], T],
        deadline_s: Optional[float] = None,
    ) -> T:
        """Async wrapper: runs the (synchronous) transaction in a worker
        thread so the aiohttp event loop is never blocked on the database."""
        return await asyncio.get_running_loop().run_in_executor(
            None, lambda: self.run_tx(name, fn, deadline_s=deadline_s)
        )

    def now(self) -> Time:
        return self.clock.now()


class Transaction:
    """Typed query methods over one open transaction
    (reference: aggregator_core/src/datastore.rs Transaction)."""

    def __init__(self, ds: Datastore, conn: sqlite3.Connection):
        self.ds = ds
        self.conn = conn
        self.crypter = ds.crypter
        self.clock = ds.clock

    # ------------------------------------------------------------------
    # helpers

    def _task_pk(self, task_id: TaskId) -> int:
        row = self.conn.execute(
            "SELECT id FROM tasks WHERE task_id = ?", (task_id.data,)
        ).fetchone()
        if row is None:
            raise TaskNotFound(str(task_id))
        return row[0]

    def _now_s(self) -> int:
        return self.clock.now().seconds

    # ------------------------------------------------------------------
    # tasks (reference: datastore.rs put_aggregator_task / get_aggregator_task)

    def put_aggregator_task(self, task: AggregatorTask) -> None:
        enc_vk = self.crypter.encrypt(
            "tasks", task.task_id.data, "vdaf_verify_key", task.vdaf_verify_key
        )
        agg_token = agg_token_type = None
        if task.aggregator_auth_token is not None:
            agg_token_type = task.aggregator_auth_token.kind
            agg_token = self.crypter.encrypt(
                "tasks",
                task.task_id.data,
                "aggregator_auth_token",
                task.aggregator_auth_token.as_bytes(),
            )
        returning = self.ds.backend.supports_returning
        try:
            cur = self.conn.execute(
                """INSERT INTO tasks (task_id, aggregator_role,
                    peer_aggregator_endpoint, query_type, vdaf, task_expiration,
                    report_expiry_age, min_batch_size, time_precision,
                    tolerable_clock_skew, collector_hpke_config, vdaf_verify_key,
                    aggregator_auth_token_type, aggregator_auth_token,
                    aggregator_auth_token_hash, collector_auth_token_hash,
                    created_at)
                   VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?)"""
                + (" RETURNING id" if returning else ""),
                (
                    task.task_id.data,
                    task.role.name.capitalize() if isinstance(task.role, Role) else str(task.role),
                    task.peer_aggregator_endpoint,
                    task.query_type.to_json(),
                    json.dumps(task.vdaf, sort_keys=True),
                    task.task_expiration.seconds if task.task_expiration else None,
                    task.report_expiry_age.seconds if task.report_expiry_age else None,
                    task.min_batch_size,
                    task.time_precision.seconds,
                    task.tolerable_clock_skew.seconds,
                    task.collector_hpke_config.get_encoded()
                    if task.collector_hpke_config
                    else None,
                    enc_vk,
                    agg_token_type,
                    agg_token,
                    json.dumps(task.aggregator_auth_token_hash.to_dict())
                    if task.aggregator_auth_token_hash
                    else None,
                    json.dumps(task.collector_auth_token_hash.to_dict())
                    if task.collector_auth_token_hash
                    else None,
                    self._now_s(),
                ),
            )
        except self.ds.backend.integrity_errors as e:
            raise TxConflict(f"task {task.task_id} already exists") from e
        # RETURNING id works on both dialects (cursor.lastrowid does not:
        # psycopg has no usable lastrowid for PG tables); pre-3.35 SQLite
        # lacks RETURNING but its lastrowid is reliable.
        pk = cur.fetchone()[0] if returning else cur.lastrowid
        for kp in task.hpke_keys:
            enc_sk = self.crypter.encrypt(
                "task_hpke_keys", task.task_id.data, "private_key", kp.private_key
            )
            self.conn.execute(
                """INSERT INTO task_hpke_keys (task_id, config_id, config, private_key)
                   VALUES (?,?,?,?)""",
                (pk, kp.config.id, kp.config.get_encoded(), enc_sk),
            )

    def _task_from_row(self, row: sqlite3.Row) -> AggregatorTask:
        (
            pk,
            task_id_b,
            role_s,
            peer,
            query_type_s,
            vdaf_s,
            expiration,
            expiry_age,
            min_batch,
            precision,
            skew,
            collector_cfg_b,
            enc_vk,
            tok_type,
            tok_enc,
            agg_hash_s,
            col_hash_s,
        ) = row
        task_id = TaskId(task_id_b)
        vk = self.crypter.decrypt("tasks", task_id_b, "vdaf_verify_key", enc_vk)
        token = None
        if tok_enc is not None:
            raw = self.crypter.decrypt("tasks", task_id_b, "aggregator_auth_token", tok_enc)
            token = AuthenticationToken(tok_type, raw.decode())
        keys = []
        for cfg_b, sk_enc in self.conn.execute(
            "SELECT config, private_key FROM task_hpke_keys WHERE task_id = ?"
            " ORDER BY config_id",
            (pk,),
        ):
            sk = self.crypter.decrypt("task_hpke_keys", task_id_b, "private_key", sk_enc)
            keys.append(HpkeKeypair(HpkeConfig.get_decoded(cfg_b), sk))
        return AggregatorTask(
            task_id=task_id,
            peer_aggregator_endpoint=peer,
            query_type=TaskQueryType.from_json(query_type_s),
            vdaf=json.loads(vdaf_s),
            role=Role[role_s.upper()],
            vdaf_verify_key=vk,
            min_batch_size=min_batch,
            time_precision=Duration(precision),
            task_expiration=Time(expiration) if expiration is not None else None,
            report_expiry_age=Duration(expiry_age) if expiry_age is not None else None,
            tolerable_clock_skew=Duration(skew),
            aggregator_auth_token=token,
            aggregator_auth_token_hash=AuthenticationTokenHash.from_dict(
                json.loads(agg_hash_s)
            )
            if agg_hash_s
            else None,
            collector_auth_token_hash=AuthenticationTokenHash.from_dict(
                json.loads(col_hash_s)
            )
            if col_hash_s
            else None,
            collector_hpke_config=HpkeConfig.get_decoded(collector_cfg_b)
            if collector_cfg_b
            else None,
            hpke_keys=keys,
        )

    _TASK_COLS = """id, task_id, aggregator_role, peer_aggregator_endpoint,
        query_type, vdaf, task_expiration, report_expiry_age, min_batch_size,
        time_precision, tolerable_clock_skew, collector_hpke_config,
        vdaf_verify_key, aggregator_auth_token_type, aggregator_auth_token,
        aggregator_auth_token_hash, collector_auth_token_hash"""

    def get_aggregator_task(self, task_id: TaskId) -> Optional[AggregatorTask]:
        row = self.conn.execute(
            f"SELECT {self._TASK_COLS} FROM tasks WHERE task_id = ?",
            (task_id.data,),
        ).fetchone()
        return self._task_from_row(row) if row else None

    def get_aggregator_tasks(self) -> List[AggregatorTask]:
        rows = self.conn.execute(
            f"SELECT {self._TASK_COLS} FROM tasks ORDER BY id"
        ).fetchall()
        return [self._task_from_row(r) for r in rows]

    def delete_task(self, task_id: TaskId) -> None:
        cur = self.conn.execute("DELETE FROM tasks WHERE task_id = ?", (task_id.data,))
        if cur.rowcount == 0:
            raise TaskNotFound(str(task_id))

    def update_task_expiration(self, task_id: TaskId, expiration: Optional[Time]) -> None:
        cur = self.conn.execute(
            "UPDATE tasks SET task_expiration = ? WHERE task_id = ?",
            (expiration.seconds if expiration else None, task_id.data),
        )
        if cur.rowcount == 0:
            raise TaskNotFound(str(task_id))

    def get_task_ids(self) -> List[TaskId]:
        return [
            TaskId(r[0])
            for r in self.conn.execute("SELECT task_id FROM tasks ORDER BY id")
        ]

    # ------------------------------------------------------------------
    # client reports (reference: datastore.rs:1254,1393,1590,1663)

    def put_client_report(self, report: LeaderStoredReport) -> None:
        pk = self._task_pk(report.task_id)
        row_ident = report.task_id.data + report.report_id.data
        enc_share = self.crypter.encrypt(
            "client_reports", row_ident, "leader_input_share", report.leader_input_share
        )
        try:
            self.conn.execute(
                """INSERT INTO client_reports (task_id, report_id, client_timestamp,
                    extensions, public_share, leader_input_share,
                    helper_encrypted_input_share, trace_id, created_at)
                   VALUES (?,?,?,?,?,?,?,?,?)""",
                (
                    pk,
                    report.report_id.data,
                    report.time.seconds,
                    _encode_extensions(report.leader_extensions),
                    report.public_share,
                    enc_share,
                    report.helper_encrypted_input_share.get_encoded(),
                    report.trace_id,
                    self._now_s(),
                ),
            )
        except self.ds.backend.integrity_errors as e:
            raise TxConflict(f"report {report.report_id} already exists") from e

    def get_client_report(
        self, task_id: TaskId, report_id: ReportId
    ) -> Optional[LeaderStoredReport]:
        pk = self._task_pk(task_id)
        row = self.conn.execute(
            """SELECT client_timestamp, extensions, public_share,
                      leader_input_share, helper_encrypted_input_share, trace_id
               FROM client_reports WHERE task_id = ? AND report_id = ?""",
            (pk, report_id.data),
        ).fetchone()
        if row is None:
            return None
        ts, ext_b, public_share, enc_share, helper_b, trace_id = row
        if enc_share is None:
            return None  # scrubbed
        row_ident = task_id.data + report_id.data
        share = self.crypter.decrypt(
            "client_reports", row_ident, "leader_input_share", enc_share
        )
        return LeaderStoredReport(
            task_id=task_id,
            metadata=ReportMetadata(report_id, Time(ts)),
            public_share=public_share,
            leader_extensions=_decode_extensions(ext_b) if ext_b else [],
            leader_input_share=share,
            helper_encrypted_input_share=HpkeCiphertext.get_decoded(helper_b),
            trace_id=trace_id,
        )

    def check_client_report_exists(self, task_id: TaskId, report_id: ReportId) -> bool:
        pk = self._task_pk(task_id)
        return (
            self.conn.execute(
                "SELECT 1 FROM client_reports WHERE task_id = ? AND report_id = ?",
                (pk, report_id.data),
            ).fetchone()
            is not None
        )

    def get_unaggregated_client_reports_for_task(
        self, task_id: TaskId, limit: int
    ) -> List[ReportMetadata]:
        """Atomically claim up to ``limit`` unaggregated reports (sets
        aggregation_started, reference datastore.rs:1254 + the partial
        index).  Claimed reports must be assigned to jobs or released via
        ``mark_reports_unaggregated``."""
        pk = self._task_pk(task_id)
        if self.ds.backend.supports_returning:
            rows = self.conn.execute(
                """UPDATE client_reports SET aggregation_started = 1
                   WHERE id IN (
                       SELECT id FROM client_reports
                       WHERE task_id = ? AND aggregation_started = 0
                       ORDER BY client_timestamp LIMIT ?)
                   RETURNING report_id, client_timestamp""",
                (pk, limit),
            ).fetchall()
        else:
            # select-then-mutate fallback (pre-3.35 SQLite): atomic under
            # BEGIN IMMEDIATE's single writer
            picked = self.conn.execute(
                """SELECT id, report_id, client_timestamp FROM client_reports
                   WHERE task_id = ? AND aggregation_started = 0
                   ORDER BY client_timestamp LIMIT ?""",
                (pk, limit),
            ).fetchall()
            self.conn.executemany(
                "UPDATE client_reports SET aggregation_started = 1 WHERE id = ?",
                [(r[0],) for r in picked],
            )
            rows = [(r[1], r[2]) for r in picked]
        return [ReportMetadata(ReportId(r[0]), Time(r[1])) for r in rows]

    def mark_reports_unaggregated(
        self, task_id: TaskId, report_ids: Sequence[ReportId]
    ) -> None:
        """reference: datastore.rs:1393 mark_report_unaggregated"""
        pk = self._task_pk(task_id)
        self.conn.executemany(
            "UPDATE client_reports SET aggregation_started = 0"
            " WHERE task_id = ? AND report_id = ?",
            [(pk, rid.data) for rid in report_ids],
        )

    def scrub_client_report(self, task_id: TaskId, report_id: ReportId) -> None:
        """Null out share payloads once packed into an aggregation job
        (reference: datastore.rs:1663)."""
        pk = self._task_pk(task_id)
        self.conn.execute(
            """UPDATE client_reports SET extensions = NULL, public_share = NULL,
               leader_input_share = NULL, helper_encrypted_input_share = NULL,
               aggregation_started = 1
               WHERE task_id = ? AND report_id = ?""",
            (pk, report_id.data),
        )

    def get_client_reports_for_interval(
        self, task_id: TaskId, interval: Interval, limit: int
    ) -> List[LeaderStoredReport]:
        """Full (unscrubbed) reports in an interval — the collection-driven
        creation path for aggregation-parameter VDAFs, whose reports are
        re-aggregated at every level and therefore never scrubbed.  One
        query; per-row work is only the column decrypt."""
        pk = self._task_pk(task_id)
        rows = self.conn.execute(
            """SELECT report_id, client_timestamp, extensions, public_share,
                      leader_input_share, helper_encrypted_input_share, trace_id
               FROM client_reports
               WHERE task_id = ? AND client_timestamp >= ? AND client_timestamp < ?
                 AND leader_input_share IS NOT NULL
               ORDER BY client_timestamp LIMIT ?""",
            (pk, interval.start.seconds, interval.end().seconds, limit),
        ).fetchall()
        out = []
        for rid, ts, ext_b, public_share, enc_share, helper_b, trace_id in rows:
            share = self.crypter.decrypt(
                "client_reports", task_id.data + rid, "leader_input_share", enc_share
            )
            out.append(
                LeaderStoredReport(
                    task_id=task_id,
                    metadata=ReportMetadata(ReportId(rid), Time(ts)),
                    public_share=public_share,
                    leader_extensions=_decode_extensions(ext_b) if ext_b else [],
                    leader_input_share=share,
                    helper_encrypted_input_share=HpkeCiphertext.get_decoded(helper_b),
                    trace_id=trace_id,
                )
            )
        return out

    def get_aggregation_params_by_report_for_interval(
        self, task_id: TaskId, interval: Interval
    ) -> Dict[bytes, List[bytes]]:
        """report_id -> distinct aggregation params, for every report in the
        interval, in one query (the batch form of
        get_aggregation_params_for_report)."""
        pk = self._task_pk(task_id)
        rows = self.conn.execute(
            """SELECT DISTINCT ra.report_id, aj.aggregation_param
               FROM report_aggregations ra
               JOIN aggregation_jobs aj ON ra.aggregation_job_id = aj.id
               WHERE ra.task_id = ? AND ra.client_timestamp >= ?
                 AND ra.client_timestamp < ?""",
            (pk, interval.start.seconds, interval.end().seconds),
        ).fetchall()
        out: Dict[bytes, List[bytes]] = {}
        for rid, param in rows:
            out.setdefault(rid, []).append(param)
        return out

    def count_client_reports_for_interval(
        self, task_id: TaskId, interval: Interval
    ) -> int:
        pk = self._task_pk(task_id)
        return self.conn.execute(
            """SELECT COUNT(*) FROM client_reports
               WHERE task_id = ? AND client_timestamp >= ? AND client_timestamp < ?""",
            (pk, interval.start.seconds, interval.end().seconds),
        ).fetchone()[0]

    def get_aggregated_report_trace_ids(
        self,
        task_id: TaskId,
        interval: Optional[Interval] = None,
        batch_id: Optional[BatchId] = None,
        limit: int = 512,
    ) -> List[str]:
        """Distinct upload trace ids of reports AGGREGATED into a batch: the collection driver links them into its
        collection-finish span so the merged timeline runs client ingress
        -> collection.  Membership is by report_aggregations join — not a
        bare client_reports time scan — so unaggregated leftovers and
        (for fixed-size tasks, via ``batch_id``) reports packed into
        OTHER batches in the same time range never leak into another
        collection's merged trace.  Scrubbing nulls the share columns but
        keeps trace_id, so linked ids survive packing; GC-deleted rows
        simply drop out."""
        pk = self._task_pk(task_id)
        sql = """SELECT DISTINCT cr.trace_id
                 FROM report_aggregations ra
                 JOIN aggregation_jobs aj ON ra.aggregation_job_id = aj.id
                 JOIN client_reports cr
                   ON cr.task_id = ra.task_id AND cr.report_id = ra.report_id
                 WHERE ra.task_id = ? AND cr.trace_id IS NOT NULL"""
        params: list = [pk]
        if batch_id is not None:
            sql += " AND aj.batch_id = ?"
            params.append(batch_id.data)
        if interval is not None:
            sql += " AND ra.client_timestamp >= ? AND ra.client_timestamp < ?"
            params += [interval.start.seconds, interval.end().seconds]
        sql += " ORDER BY cr.trace_id LIMIT ?"
        params.append(limit)
        return [r[0] for r in self.conn.execute(sql, params).fetchall()]

    def count_unaggregated_client_reports_for_interval(
        self, task_id: TaskId, interval: Interval
    ) -> int:
        """Collection readiness gate input (reference:
        collection_job_driver.rs:124-262)."""
        pk = self._task_pk(task_id)
        return self.conn.execute(
            """SELECT COUNT(*) FROM client_reports
               WHERE task_id = ? AND aggregation_started = 0
                 AND client_timestamp >= ? AND client_timestamp < ?""",
            (pk, interval.start.seconds, interval.end().seconds),
        ).fetchone()[0]

    def delete_expired_client_reports(self, task_id: TaskId, expiry: Time, limit: int) -> int:
        """reference: datastore.rs:4691

        Reports with an OUTSTANDING report-journal row are skipped — the
        same guard shape as ``delete_expired_aggregation_artifacts``'s
        accumulator-journal clause.  A journal row outliving its
        materialized client_reports row would RESURRECT the report on
        replay after GC deleted it (or double-pack it if a staged
        consumer raced the delete); the replay/materializer consumes the
        row first and the next GC pass collects the report."""
        pk = self._task_pk(task_id)
        cur = self.conn.execute(
            """DELETE FROM client_reports WHERE id IN (
                 SELECT cr.id FROM client_reports cr
                 WHERE cr.task_id = ? AND cr.client_timestamp < ?
                   AND NOT EXISTS (
                     SELECT 1 FROM report_journal rj
                     WHERE rj.task_id = cr.task_id
                       AND rj.report_id = cr.report_id)
                 LIMIT ?)""",
            (pk, expiry.seconds, limit),
        )
        return cur.rowcount

    # ------------------------------------------------------------------
    # aggregation jobs (reference: datastore.rs:1916-2188)

    def put_aggregation_job(self, job: AggregationJob) -> None:
        pk = self._task_pk(job.task_id)
        now = self._now_s()
        try:
            self.conn.execute(
                """INSERT INTO aggregation_jobs (task_id, aggregation_job_id,
                    aggregation_param, batch_id, client_timestamp_interval_start,
                    client_timestamp_interval_duration, state, step,
                    last_request_hash, trace_id, created_at, updated_at)
                   VALUES (?,?,?,?,?,?,?,?,?,?,?,?)""",
                (
                    pk,
                    job.aggregation_job_id.data,
                    job.aggregation_parameter,
                    job.partial_batch_identifier.data
                    if job.partial_batch_identifier
                    else None,
                    job.client_timestamp_interval.start.seconds,
                    job.client_timestamp_interval.duration.seconds,
                    job.state.value,
                    int(job.step),
                    job.last_request_hash,
                    job.trace_id,
                    now,
                    now,
                ),
            )
        except self.ds.backend.integrity_errors as e:
            raise TxConflict(f"aggregation job {job.aggregation_job_id} exists") from e

    def get_aggregation_job(
        self, task_id: TaskId, aggregation_job_id: AggregationJobId
    ) -> Optional[AggregationJob]:
        pk = self._task_pk(task_id)
        row = self.conn.execute(
            """SELECT aggregation_param, batch_id, client_timestamp_interval_start,
                      client_timestamp_interval_duration, state, step,
                      last_request_hash, trace_id
               FROM aggregation_jobs WHERE task_id = ? AND aggregation_job_id = ?""",
            (pk, aggregation_job_id.data),
        ).fetchone()
        if row is None:
            return None
        param, batch_id, istart, idur, state, step, req_hash, trace_id = row
        return AggregationJob(
            task_id=task_id,
            aggregation_job_id=aggregation_job_id,
            aggregation_parameter=param,
            partial_batch_identifier=BatchId(batch_id) if batch_id else None,
            client_timestamp_interval=Interval(Time(istart), Duration(idur)),
            state=AggregationJobState(state),
            step=AggregationJobStep(step),
            last_request_hash=req_hash,
            trace_id=trace_id,
        )

    def update_aggregation_job(self, job: AggregationJob) -> None:
        pk = self._task_pk(job.task_id)
        cur = self.conn.execute(
            """UPDATE aggregation_jobs SET state = ?, step = ?,
                 last_request_hash = ?, updated_at = ?
               WHERE task_id = ? AND aggregation_job_id = ?""",
            (
                job.state.value,
                int(job.step),
                job.last_request_hash,
                self._now_s(),
                pk,
                job.aggregation_job_id.data,
            ),
        )
        if cur.rowcount == 0:
            raise DatastoreError(f"no aggregation job {job.aggregation_job_id}")

    def get_aggregation_jobs_for_task(self, task_id: TaskId) -> List[AggregationJob]:
        pk = self._task_pk(task_id)
        rows = self.conn.execute(
            """SELECT aggregation_job_id, aggregation_param, batch_id,
                      client_timestamp_interval_start,
                      client_timestamp_interval_duration, state, step,
                      last_request_hash, trace_id
               FROM aggregation_jobs WHERE task_id = ? ORDER BY id""",
            (pk,),
        ).fetchall()
        return [
            AggregationJob(
                task_id=task_id,
                aggregation_job_id=AggregationJobId(job_id),
                aggregation_parameter=param,
                partial_batch_identifier=BatchId(batch_id) if batch_id else None,
                client_timestamp_interval=Interval(Time(istart), Duration(idur)),
                state=AggregationJobState(state),
                step=AggregationJobStep(step),
                last_request_hash=req_hash,
                trace_id=trace_id,
            )
            for (
                job_id,
                param,
                batch_id,
                istart,
                idur,
                state,
                step,
                req_hash,
                trace_id,
            ) in rows
        ]

    def get_task_peer_index(self) -> List[Tuple[bytes, str]]:
        """(task_id bytes, peer aggregator endpoint) for every task — the
        task -> peer index behind peer-health-aware job acquisition
        (job_driver.suspect_task_ids): tasks of a suspect peer are
        filtered at the acquire query instead of acquired-then-released."""
        return [
            (r[0], r[1])
            for r in self.conn.execute(
                "SELECT task_id, peer_aggregator_endpoint FROM tasks"
            ).fetchall()
        ]

    def _task_exclusion_clause(self, exclude_task_ids):
        """(SQL fragment, params) excluding jobs of the named tasks from an
        acquisition pick.  Empty/None excludes nothing."""
        ids = list(exclude_task_ids or ())
        if not ids:
            return "", []
        marks = ",".join("?" * len(ids))
        return (
            f" AND task_id NOT IN (SELECT id FROM tasks WHERE task_id IN ({marks}))",
            ids,
        )

    def acquire_incomplete_aggregation_jobs(
        self,
        lease_duration: Duration,
        limit: int,
        exclude_task_ids: Optional[Sequence[bytes]] = None,
    ) -> List[Lease]:
        """Lease InProgress jobs whose lease expired — the reference's
        ``FOR UPDATE … SKIP LOCKED`` loop (datastore.rs:1916-1985), expressed
        as one atomic UPDATE under SQLite's single-writer transaction.
        ``exclude_task_ids`` filters suspect-peer tasks AT THE QUERY
        (peer-health-aware acquisition): their jobs stay acquirable by
        replicas that still reach the peer, without this replica paying an
        acquire-then-release tx round trip per job per poll."""
        now = self._now_s()
        expiry = now + lease_duration.seconds
        token = secrets.token_bytes(16)
        excl_sql, excl_params = self._task_exclusion_clause(exclude_task_ids)
        if self.ds.backend.supports_returning:
            rows = self.conn.execute(
                f"""UPDATE aggregation_jobs
                   SET lease_expiry = ?, lease_token = ?, lease_attempts = lease_attempts + 1,
                       updated_at = ?
                   WHERE id IN (
                       SELECT id FROM aggregation_jobs
                       WHERE state = 'InProgress' AND lease_expiry <= ?{excl_sql}
                       ORDER BY id LIMIT ? /*skip-locked*/)
                   RETURNING task_id, aggregation_job_id, lease_attempts,
                             trace_id, created_at""",
                (expiry, token, now, now, *excl_params, limit),
            ).fetchall()
        else:
            picked = self.conn.execute(
                f"""SELECT id, task_id, aggregation_job_id, lease_attempts,
                          trace_id, created_at
                   FROM aggregation_jobs
                   WHERE state = 'InProgress' AND lease_expiry <= ?{excl_sql}
                   ORDER BY id LIMIT ?""",
                (now, *excl_params, limit),
            ).fetchall()
            self.conn.executemany(
                """UPDATE aggregation_jobs SET lease_expiry = ?, lease_token = ?,
                     lease_attempts = lease_attempts + 1, updated_at = ?
                   WHERE id = ?""",
                [(expiry, token, now, r[0]) for r in picked],
            )
            rows = [(r[1], r[2], r[3] + 1, r[4], r[5]) for r in picked]
        leases = []
        for task_pk, job_id, attempts, trace_id, created_at in rows:
            trow = self.conn.execute(
                "SELECT task_id, query_type, vdaf FROM tasks WHERE id = ?", (task_pk,)
            ).fetchone()
            leases.append(
                Lease(
                    leased=AcquiredAggregationJob(
                        task_id=TaskId(trow[0]),
                        aggregation_job_id=AggregationJobId(job_id),
                        query_type=TaskQueryType.from_json(trow[1]).kind,
                        vdaf=json.loads(trow[2]),
                        trace_id=trace_id,
                        age_seconds=float(max(0, now - (created_at or now))),
                    ),
                    lease_expiry=Time(expiry),
                    lease_token=LeaseToken(token),
                    lease_attempts=attempts,
                )
            )
        return leases

    def release_aggregation_job(
        self, lease: Lease, reacquire_delay: Optional[Duration] = None
    ) -> None:
        """reference: datastore.rs:1991 (release_aggregation_job); the token
        check fences stale lease holders."""
        job = lease.leased
        pk = self._task_pk(job.task_id)
        new_expiry = (
            self._now_s() + reacquire_delay.seconds if reacquire_delay is not None else 0
        )
        cur = self.conn.execute(
            """UPDATE aggregation_jobs SET lease_expiry = ?, lease_token = NULL
               WHERE task_id = ? AND aggregation_job_id = ? AND lease_token = ?""",
            (new_expiry, pk, job.aggregation_job_id.data, lease.lease_token.data),
        )
        if cur.rowcount == 0:
            raise TxConflict("lease no longer held")

    # ------------------------------------------------------------------
    # report aggregations (reference: datastore.rs:2190-2519)

    def put_report_aggregation(self, ra: ReportAggregation) -> None:
        pk = self._task_pk(ra.task_id)
        jrow = self.conn.execute(
            "SELECT id FROM aggregation_jobs WHERE task_id = ? AND aggregation_job_id = ?",
            (pk, ra.aggregation_job_id.data),
        ).fetchone()
        if jrow is None:
            raise DatastoreError(f"no aggregation job {ra.aggregation_job_id}")
        cols = self._ra_payload_cols(ra)
        try:
            self.conn.execute(
                """INSERT INTO report_aggregations (task_id, aggregation_job_id, ord,
                    report_id, client_timestamp, last_prep_resp, state, public_share,
                    leader_extensions, leader_input_share, helper_encrypted_input_share,
                    leader_prep_transition, helper_prep_state, error_code)
                   VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?,?)""",
                (
                    pk,
                    jrow[0],
                    ra.ord,
                    ra.report_id.data,
                    ra.time.seconds,
                    ra.last_prep_resp.get_encoded() if ra.last_prep_resp else None,
                    ra.state.value,
                    *cols,
                ),
            )
        except self.ds.backend.integrity_errors as e:
            raise TxConflict(f"report aggregation ord {ra.ord} already exists") from e

    def _ra_payload_cols(self, ra: ReportAggregation) -> Tuple:
        row_ident = ra.task_id.data + ra.aggregation_job_id.data + ra.report_id.data
        enc_input = (
            self.crypter.encrypt(
                "report_aggregations", row_ident, "leader_input_share",
                ra.leader_input_share,
            )
            if ra.leader_input_share is not None
            else None
        )
        enc_transition = (
            self.crypter.encrypt(
                "report_aggregations", row_ident, "leader_prep_transition",
                ra.leader_prep_transition,
            )
            if ra.leader_prep_transition is not None
            else None
        )
        enc_helper_state = (
            self.crypter.encrypt(
                "report_aggregations", row_ident, "helper_prep_state",
                ra.helper_prep_state,
            )
            if ra.helper_prep_state is not None
            else None
        )
        return (
            ra.public_share,
            _encode_extensions(ra.leader_extensions) if ra.leader_extensions else None,
            enc_input,
            ra.helper_encrypted_input_share.get_encoded()
            if ra.helper_encrypted_input_share
            else None,
            enc_transition,
            enc_helper_state,
            int(ra.error) if ra.error is not None else None,
        )

    def update_report_aggregation(self, ra: ReportAggregation) -> None:
        pk = self._task_pk(ra.task_id)
        cols = self._ra_payload_cols(ra)
        cur = self.conn.execute(
            """UPDATE report_aggregations SET last_prep_resp = ?, state = ?,
                 public_share = ?, leader_extensions = ?, leader_input_share = ?,
                 helper_encrypted_input_share = ?, leader_prep_transition = ?,
                 helper_prep_state = ?, error_code = ?
               WHERE task_id = ? AND report_id = ? AND aggregation_job_id =
                 (SELECT id FROM aggregation_jobs
                  WHERE task_id = ? AND aggregation_job_id = ?)""",
            (
                ra.last_prep_resp.get_encoded() if ra.last_prep_resp else None,
                ra.state.value,
                *cols,
                pk,
                ra.report_id.data,
                pk,
                ra.aggregation_job_id.data,
            ),
        )
        if cur.rowcount == 0:
            raise DatastoreError(f"no report aggregation for {ra.report_id}")

    def get_report_aggregations_for_aggregation_job(
        self, task_id: TaskId, aggregation_job_id: AggregationJobId
    ) -> List[ReportAggregation]:
        pk = self._task_pk(task_id)
        rows = self.conn.execute(
            """SELECT ra.ord, ra.report_id, ra.client_timestamp, ra.last_prep_resp,
                      ra.state, ra.public_share, ra.leader_extensions,
                      ra.leader_input_share, ra.helper_encrypted_input_share,
                      ra.leader_prep_transition, ra.helper_prep_state, ra.error_code
               FROM report_aggregations ra
               JOIN aggregation_jobs aj ON ra.aggregation_job_id = aj.id
               WHERE aj.task_id = ? AND aj.aggregation_job_id = ?
               ORDER BY ra.ord""",
            (pk, aggregation_job_id.data),
        ).fetchall()
        out = []
        for (
            ord_,
            rid,
            ts,
            prep_resp_b,
            state,
            public_share,
            ext_b,
            enc_input,
            helper_b,
            enc_trans,
            enc_hstate,
            err,
        ) in rows:
            row_ident = task_id.data + aggregation_job_id.data + rid
            out.append(
                ReportAggregation(
                    task_id=task_id,
                    aggregation_job_id=aggregation_job_id,
                    report_id=ReportId(rid),
                    time=Time(ts),
                    ord=ord_,
                    state=ReportAggregationState(state),
                    last_prep_resp=PrepareResp.get_decoded(prep_resp_b)
                    if prep_resp_b
                    else None,
                    public_share=public_share,
                    leader_extensions=_decode_extensions(ext_b) if ext_b else [],
                    leader_input_share=self.crypter.decrypt(
                        "report_aggregations", row_ident, "leader_input_share", enc_input
                    )
                    if enc_input
                    else None,
                    helper_encrypted_input_share=HpkeCiphertext.get_decoded(helper_b)
                    if helper_b
                    else None,
                    leader_prep_transition=self.crypter.decrypt(
                        "report_aggregations", row_ident, "leader_prep_transition", enc_trans
                    )
                    if enc_trans
                    else None,
                    helper_prep_state=self.crypter.decrypt(
                        "report_aggregations", row_ident, "helper_prep_state", enc_hstate
                    )
                    if enc_hstate
                    else None,
                    error=PrepareError(err) if err is not None else None,
                )
            )
        return out

    def put_report_aggregation_metadata(self, meta: ReportAggregationMetadata) -> None:
        """Creator path: StartLeader rows without payloads (the report data is
        scrubbed from client_reports only after packing; reference
        aggregation_job_creator.rs:718-731 stores metadata-only rows)."""
        pk = self._task_pk(meta.task_id)
        jrow = self.conn.execute(
            "SELECT id FROM aggregation_jobs WHERE task_id = ? AND aggregation_job_id = ?",
            (pk, meta.aggregation_job_id.data),
        ).fetchone()
        if jrow is None:
            raise DatastoreError(f"no aggregation job {meta.aggregation_job_id}")
        try:
            self.conn.execute(
                """INSERT INTO report_aggregations (task_id, aggregation_job_id, ord,
                    report_id, client_timestamp, state)
                   VALUES (?,?,?,?,?,?)""",
                (
                    pk,
                    jrow[0],
                    meta.ord,
                    meta.report_id.data,
                    meta.time.seconds,
                    ReportAggregationState.START_LEADER.value,
                ),
            )
        except self.ds.backend.integrity_errors as e:
            raise TxConflict(f"report aggregation ord {meta.ord} already exists") from e

    def get_aggregation_params_for_report(
        self,
        task_id: TaskId,
        report_id: ReportId,
        exclude_aggregation_job_id: Optional[AggregationJobId] = None,
    ) -> List[bytes]:
        """Distinct aggregation parameters of jobs this report is already in
        (the VDAF decides which of them CONFLICT with a new one)."""
        pk = self._task_pk(task_id)
        sql = """SELECT DISTINCT aj.aggregation_param FROM report_aggregations ra
                 JOIN aggregation_jobs aj ON ra.aggregation_job_id = aj.id
                 WHERE ra.task_id = ? AND ra.report_id = ?"""
        args: List[Any] = [pk, report_id.data]
        if exclude_aggregation_job_id is not None:
            sql += " AND aj.aggregation_job_id != ?"
            args.append(exclude_aggregation_job_id.data)
        return [r[0] for r in self.conn.execute(sql, args)]

    def check_report_aggregation_exists(
        self,
        task_id: TaskId,
        report_id: ReportId,
        aggregation_parameter: bytes = b"",
        exclude_aggregation_job_id: Optional[AggregationJobId] = None,
    ) -> bool:
        """Exact-parameter replay check, expressed over
        get_aggregation_params_for_report so the two can't diverge.  Role
        logic uses the VDAF's conflict key on the params list instead
        (reference: aggregator.rs:1765 dup-report-ID check)."""
        return aggregation_parameter in self.get_aggregation_params_for_report(
            task_id, report_id, exclude_aggregation_job_id
        )

    # ------------------------------------------------------------------
    # batch aggregations (reference: datastore.rs:3626-4008)

    def put_batch_aggregation(self, ba: BatchAggregation) -> None:
        pk = self._task_pk(ba.task_id)
        try:
            self.conn.execute(
                """INSERT INTO batch_aggregations (task_id, batch_identifier,
                    aggregation_param, ord, state, aggregate_share, report_count,
                    checksum, client_timestamp_interval_start,
                    client_timestamp_interval_duration, aggregation_jobs_created,
                    aggregation_jobs_terminated, created_at)
                   VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?)""",
                (
                    pk,
                    ba.batch_identifier,
                    ba.aggregation_parameter,
                    ba.ord,
                    ba.state.value,
                    ba.aggregate_share,
                    ba.report_count,
                    ba.checksum.data,
                    ba.client_timestamp_interval.start.seconds,
                    ba.client_timestamp_interval.duration.seconds,
                    ba.aggregation_jobs_created,
                    ba.aggregation_jobs_terminated,
                    self._now_s(),
                ),
            )
        except self.ds.backend.integrity_errors as e:
            raise TxConflict("batch aggregation shard already exists") from e

    def update_batch_aggregation(self, ba: BatchAggregation) -> None:
        pk = self._task_pk(ba.task_id)
        cur = self.conn.execute(
            """UPDATE batch_aggregations SET state = ?, aggregate_share = ?,
                 report_count = ?, checksum = ?,
                 client_timestamp_interval_start = ?,
                 client_timestamp_interval_duration = ?,
                 aggregation_jobs_created = ?, aggregation_jobs_terminated = ?
               WHERE task_id = ? AND batch_identifier = ? AND aggregation_param = ?
                 AND ord = ?""",
            (
                ba.state.value,
                ba.aggregate_share,
                ba.report_count,
                ba.checksum.data,
                ba.client_timestamp_interval.start.seconds,
                ba.client_timestamp_interval.duration.seconds,
                ba.aggregation_jobs_created,
                ba.aggregation_jobs_terminated,
                pk,
                ba.batch_identifier,
                ba.aggregation_parameter,
                ba.ord,
            ),
        )
        if cur.rowcount == 0:
            raise DatastoreError("no batch aggregation shard to update")

    def get_batch_aggregation(
        self,
        task_id: TaskId,
        batch_identifier: bytes,
        aggregation_parameter: bytes,
        ord: int,
    ) -> Optional[BatchAggregation]:
        rows = self._get_batch_aggregations(
            task_id, batch_identifier, aggregation_parameter, ord
        )
        return rows[0] if rows else None

    def get_batch_aggregations_for_batch(
        self, task_id: TaskId, batch_identifier: bytes, aggregation_parameter: bytes
    ) -> List[BatchAggregation]:
        return self._get_batch_aggregations(task_id, batch_identifier, aggregation_parameter)

    def _get_batch_aggregations(
        self,
        task_id: TaskId,
        batch_identifier: bytes,
        aggregation_parameter: bytes,
        ord: Optional[int] = None,
    ) -> List[BatchAggregation]:
        pk = self._task_pk(task_id)
        sql = """SELECT ord, state, aggregate_share, report_count, checksum,
                        client_timestamp_interval_start,
                        client_timestamp_interval_duration,
                        aggregation_jobs_created, aggregation_jobs_terminated
                 FROM batch_aggregations
                 WHERE task_id = ? AND batch_identifier = ? AND aggregation_param = ?"""
        args: List[Any] = [pk, batch_identifier, aggregation_parameter]
        if ord is not None:
            sql += " AND ord = ?"
            args.append(ord)
        sql += " ORDER BY ord"
        out = []
        for row in self.conn.execute(sql, args):
            (
                ord_,
                state,
                share,
                count,
                checksum,
                istart,
                idur,
                created,
                terminated,
            ) = row
            out.append(
                BatchAggregation(
                    task_id=task_id,
                    batch_identifier=batch_identifier,
                    aggregation_parameter=aggregation_parameter,
                    ord=ord_,
                    state=BatchAggregationState(state),
                    aggregate_share=share,
                    report_count=count,
                    checksum=ReportIdChecksum(checksum),
                    client_timestamp_interval=Interval(Time(istart), Duration(idur)),
                    aggregation_jobs_created=created,
                    aggregation_jobs_terminated=terminated,
                )
            )
        return out

    def get_batch_aggregations_overlapping_interval(
        self, task_id: TaskId, interval: Interval
    ) -> List[Tuple[bytes, bytes]]:
        """(batch_identifier, aggregation_param) pairs whose client timestamp
        interval overlaps — used for TimeInterval collection validation."""
        pk = self._task_pk(task_id)
        rows = self.conn.execute(
            """SELECT DISTINCT batch_identifier, aggregation_param
               FROM batch_aggregations
               WHERE task_id = ?
                 AND client_timestamp_interval_start < ?
                 AND client_timestamp_interval_start
                     + client_timestamp_interval_duration > ?""",
            (pk, interval.end().seconds, interval.start.seconds),
        ).fetchall()
        return [(r[0], r[1]) for r in rows]

    # ------------------------------------------------------------------
    # collection jobs (reference: datastore.rs:3222-3397)

    def put_collection_job(self, job: CollectionJob) -> None:
        pk = self._task_pk(job.task_id)
        row_ident = job.task_id.data + job.collection_job_id.data
        enc_share = (
            self.crypter.encrypt(
                "collection_jobs", row_ident, "leader_aggregate_share",
                job.leader_aggregate_share,
            )
            if job.leader_aggregate_share is not None
            else None
        )
        now = self._now_s()
        try:
            self.conn.execute(
                """INSERT INTO collection_jobs (task_id, collection_job_id, query,
                    aggregation_param, batch_identifier, state, report_count,
                    client_timestamp_interval_start, client_timestamp_interval_duration,
                    leader_aggregate_share, helper_aggregate_share, trace_id,
                    created_at, updated_at)
                   VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?,?)""",
                (
                    pk,
                    job.collection_job_id.data,
                    job.query.get_encoded(),
                    job.aggregation_parameter,
                    job.batch_identifier,
                    job.state.value,
                    job.report_count,
                    job.client_timestamp_interval.start.seconds
                    if job.client_timestamp_interval
                    else None,
                    job.client_timestamp_interval.duration.seconds
                    if job.client_timestamp_interval
                    else None,
                    enc_share,
                    job.helper_aggregate_share.get_encoded()
                    if job.helper_aggregate_share
                    else None,
                    job.trace_id,
                    now,
                    now,
                ),
            )
        except self.ds.backend.integrity_errors as e:
            raise TxConflict(f"collection job {job.collection_job_id} exists") from e

    def get_collection_job(
        self, task_id: TaskId, collection_job_id: CollectionJobId, query_kind: str
    ) -> Optional[CollectionJob]:
        pk = self._task_pk(task_id)
        row = self.conn.execute(
            """SELECT query, aggregation_param, batch_identifier, state,
                      report_count, client_timestamp_interval_start,
                      client_timestamp_interval_duration, leader_aggregate_share,
                      helper_aggregate_share, trace_id
               FROM collection_jobs WHERE task_id = ? AND collection_job_id = ?""",
            (pk, collection_job_id.data),
        ).fetchone()
        if row is None:
            return None
        return self._collection_job_from_row(task_id, collection_job_id, query_kind, row)

    def _collection_job_from_row(
        self, task_id, collection_job_id, query_kind: str, row
    ) -> CollectionJob:
        (
            query_b,
            param,
            batch_ident,
            state,
            count,
            istart,
            idur,
            enc_share,
            helper_b,
            trace_id,
        ) = row
        row_ident = task_id.data + collection_job_id.data
        return CollectionJob(
            task_id=task_id,
            collection_job_id=collection_job_id,
            query=Query.get_decoded(query_b, QUERY_TYPES[query_kind]),
            aggregation_parameter=param,
            batch_identifier=batch_ident,
            state=CollectionJobState(state),
            report_count=count,
            client_timestamp_interval=Interval(Time(istart), Duration(idur))
            if istart is not None
            else None,
            leader_aggregate_share=self.crypter.decrypt(
                "collection_jobs", row_ident, "leader_aggregate_share", enc_share
            )
            if enc_share
            else None,
            helper_aggregate_share=HpkeCiphertext.get_decoded(helper_b)
            if helper_b
            else None,
            trace_id=trace_id,
        )

    def update_collection_job(self, job: CollectionJob) -> None:
        pk = self._task_pk(job.task_id)
        row_ident = job.task_id.data + job.collection_job_id.data
        enc_share = (
            self.crypter.encrypt(
                "collection_jobs", row_ident, "leader_aggregate_share",
                job.leader_aggregate_share,
            )
            if job.leader_aggregate_share is not None
            else None
        )
        cur = self.conn.execute(
            """UPDATE collection_jobs SET state = ?, report_count = ?,
                 client_timestamp_interval_start = ?,
                 client_timestamp_interval_duration = ?,
                 leader_aggregate_share = ?, helper_aggregate_share = ?,
                 updated_at = ?
               WHERE task_id = ? AND collection_job_id = ?""",
            (
                job.state.value,
                job.report_count,
                job.client_timestamp_interval.start.seconds
                if job.client_timestamp_interval
                else None,
                job.client_timestamp_interval.duration.seconds
                if job.client_timestamp_interval
                else None,
                enc_share,
                job.helper_aggregate_share.get_encoded()
                if job.helper_aggregate_share
                else None,
                self._now_s(),
                pk,
                job.collection_job_id.data,
            ),
        )
        if cur.rowcount == 0:
            raise DatastoreError(f"no collection job {job.collection_job_id}")

    def get_collection_jobs_by_batch_identifier(
        self, task_id: TaskId, batch_identifier: bytes, query_kind: str
    ) -> List[CollectionJob]:
        pk = self._task_pk(task_id)
        rows = self.conn.execute(
            """SELECT collection_job_id, query, aggregation_param, batch_identifier,
                      state, report_count, client_timestamp_interval_start,
                      client_timestamp_interval_duration, leader_aggregate_share,
                      helper_aggregate_share, trace_id
               FROM collection_jobs WHERE task_id = ? AND batch_identifier = ?""",
            (pk, batch_identifier),
        ).fetchall()
        return [
            self._collection_job_from_row(task_id, CollectionJobId(r[0]), query_kind, r[1:])
            for r in rows
        ]

    def increment_collection_job_step_attempts(
        self, task_id: TaskId, collection_job_id: CollectionJobId
    ) -> int:
        pk = self._task_pk(task_id)
        if self.ds.backend.supports_returning:
            row = self.conn.execute(
                """UPDATE collection_jobs SET step_attempts = step_attempts + 1
                   WHERE task_id = ? AND collection_job_id = ?
                   RETURNING step_attempts""",
                (pk, collection_job_id.data),
            ).fetchone()
        else:
            cur = self.conn.execute(
                """UPDATE collection_jobs SET step_attempts = step_attempts + 1
                   WHERE task_id = ? AND collection_job_id = ?""",
                (pk, collection_job_id.data),
            )
            row = (
                self.conn.execute(
                    "SELECT step_attempts FROM collection_jobs"
                    " WHERE task_id = ? AND collection_job_id = ?",
                    (pk, collection_job_id.data),
                ).fetchone()
                if cur.rowcount
                else None
            )
        if row is None:
            raise DatastoreError(f"no collection job {collection_job_id}")
        return row[0]

    def acquire_incomplete_collection_jobs(
        self,
        lease_duration: Duration,
        limit: int,
        exclude_task_ids: Optional[Sequence[bytes]] = None,
    ) -> List[Lease]:
        """reference: datastore.rs:3295.  ``exclude_task_ids``: the same
        suspect-peer acquisition filter as the aggregation form."""
        now = self._now_s()
        expiry = now + lease_duration.seconds
        token = secrets.token_bytes(16)
        excl_sql, excl_params = self._task_exclusion_clause(exclude_task_ids)
        if self.ds.backend.supports_returning:
            rows = self.conn.execute(
                f"""UPDATE collection_jobs
                   SET lease_expiry = ?, lease_token = ?, lease_attempts = lease_attempts + 1,
                       updated_at = ?
                   WHERE id IN (
                       SELECT id FROM collection_jobs
                       WHERE state = 'Start' AND lease_expiry <= ?{excl_sql}
                       ORDER BY id LIMIT ? /*skip-locked*/)
                   RETURNING task_id, collection_job_id, lease_attempts, step_attempts,
                             trace_id, created_at""",
                (expiry, token, now, now, *excl_params, limit),
            ).fetchall()
        else:
            picked = self.conn.execute(
                f"""SELECT id, task_id, collection_job_id, lease_attempts, step_attempts,
                          trace_id, created_at
                   FROM collection_jobs
                   WHERE state = 'Start' AND lease_expiry <= ?{excl_sql}
                   ORDER BY id LIMIT ?""",
                (now, *excl_params, limit),
            ).fetchall()
            self.conn.executemany(
                """UPDATE collection_jobs SET lease_expiry = ?, lease_token = ?,
                     lease_attempts = lease_attempts + 1, updated_at = ?
                   WHERE id = ?""",
                [(expiry, token, now, r[0]) for r in picked],
            )
            rows = [(r[1], r[2], r[3] + 1, r[4], r[5], r[6]) for r in picked]
        leases = []
        for task_pk, job_id, attempts, step_attempts, trace_id, created_at in rows:
            trow = self.conn.execute(
                "SELECT task_id, query_type, vdaf FROM tasks WHERE id = ?", (task_pk,)
            ).fetchone()
            leases.append(
                Lease(
                    leased=AcquiredCollectionJob(
                        task_id=TaskId(trow[0]),
                        collection_job_id=CollectionJobId(job_id),
                        query_type=TaskQueryType.from_json(trow[1]).kind,
                        vdaf=json.loads(trow[2]),
                        step_attempts=step_attempts,
                        trace_id=trace_id,
                        age_seconds=float(max(0, now - (created_at or now))),
                    ),
                    lease_expiry=Time(expiry),
                    lease_token=LeaseToken(token),
                    lease_attempts=attempts,
                )
            )
        return leases

    def release_collection_job(
        self, lease: Lease, reacquire_delay: Optional[Duration] = None
    ) -> None:
        """reference: datastore.rs:3397"""
        job = lease.leased
        pk = self._task_pk(job.task_id)
        new_expiry = (
            self._now_s() + reacquire_delay.seconds if reacquire_delay is not None else 0
        )
        cur = self.conn.execute(
            """UPDATE collection_jobs SET lease_expiry = ?, lease_token = NULL
               WHERE task_id = ? AND collection_job_id = ? AND lease_token = ?""",
            (new_expiry, pk, job.collection_job_id.data, lease.lease_token.data),
        )
        if cur.rowcount == 0:
            raise TxConflict("lease no longer held")

    # ------------------------------------------------------------------
    # aggregate share jobs (reference: datastore.rs:4086-4328)

    def put_aggregate_share_job(self, job: AggregateShareJob) -> None:
        pk = self._task_pk(job.task_id)
        row_ident = job.task_id.data + job.batch_identifier
        enc = self.crypter.encrypt(
            "aggregate_share_jobs", row_ident, "helper_aggregate_share",
            job.helper_aggregate_share,
        )
        try:
            self.conn.execute(
                """INSERT INTO aggregate_share_jobs (task_id, batch_identifier,
                    aggregation_param, helper_aggregate_share, report_count,
                    checksum, created_at)
                   VALUES (?,?,?,?,?,?,?)""",
                (
                    pk,
                    job.batch_identifier,
                    job.aggregation_parameter,
                    enc,
                    job.report_count,
                    job.checksum.data,
                    self._now_s(),
                ),
            )
        except self.ds.backend.integrity_errors as e:
            raise TxConflict("aggregate share job already exists") from e

    def get_aggregate_share_job(
        self, task_id: TaskId, batch_identifier: bytes, aggregation_parameter: bytes
    ) -> Optional[AggregateShareJob]:
        pk = self._task_pk(task_id)
        row = self.conn.execute(
            """SELECT helper_aggregate_share, report_count, checksum
               FROM aggregate_share_jobs
               WHERE task_id = ? AND batch_identifier = ? AND aggregation_param = ?""",
            (pk, batch_identifier, aggregation_parameter),
        ).fetchone()
        if row is None:
            return None
        row_ident = task_id.data + batch_identifier
        return AggregateShareJob(
            task_id=task_id,
            batch_identifier=batch_identifier,
            aggregation_parameter=aggregation_parameter,
            helper_aggregate_share=self.crypter.decrypt(
                "aggregate_share_jobs", row_ident, "helper_aggregate_share", row[0]
            ),
            report_count=row[1],
            checksum=ReportIdChecksum(row[2]),
        )

    def count_aggregate_share_jobs_for_batch(
        self, task_id: TaskId, batch_identifier: bytes
    ) -> int:
        pk = self._task_pk(task_id)
        return self.conn.execute(
            "SELECT COUNT(*) FROM aggregate_share_jobs"
            " WHERE task_id = ? AND batch_identifier = ?",
            (pk, batch_identifier),
        ).fetchone()[0]

    # ------------------------------------------------------------------
    # outstanding batches (reference: datastore.rs:4394-4646)

    def put_outstanding_batch(
        self, task_id: TaskId, batch_id: BatchId, time_bucket_start: Optional[Time]
    ) -> None:
        pk = self._task_pk(task_id)
        try:
            self.conn.execute(
                """INSERT INTO outstanding_batches (task_id, batch_id,
                    time_bucket_start, created_at) VALUES (?,?,?,?)""",
                (
                    pk,
                    batch_id.data,
                    time_bucket_start.seconds if time_bucket_start else None,
                    self._now_s(),
                ),
            )
        except self.ds.backend.integrity_errors as e:
            raise TxConflict("outstanding batch already exists") from e

    def get_unfilled_outstanding_batches(
        self, task_id: TaskId, time_bucket_start: Optional[Time]
    ) -> List[OutstandingBatch]:
        pk = self._task_pk(task_id)
        if time_bucket_start is None:
            rows = self.conn.execute(
                """SELECT batch_id, time_bucket_start FROM outstanding_batches
                   WHERE task_id = ? AND filled = 0 AND time_bucket_start IS NULL""",
                (pk,),
            ).fetchall()
        else:
            rows = self.conn.execute(
                """SELECT batch_id, time_bucket_start FROM outstanding_batches
                   WHERE task_id = ? AND filled = 0 AND time_bucket_start = ?""",
                (pk, time_bucket_start.seconds),
            ).fetchall()
        out = []
        for batch_id_b, bucket in rows:
            size_min, size_max = self._outstanding_batch_size(pk, batch_id_b)
            out.append(
                OutstandingBatch(
                    task_id=task_id,
                    batch_id=BatchId(batch_id_b),
                    time_bucket_start=Time(bucket) if bucket is not None else None,
                    size_min=size_min,
                    size_max=size_max,
                )
            )
        return out

    def _outstanding_batch_size(self, task_pk: int, batch_id: bytes) -> Tuple[int, int]:
        """Possible report-count range for a batch: min counts Finished report
        aggregations, max also counts in-flight ones
        (reference: datastore.rs read_batch_size)."""
        row = self.conn.execute(
            """SELECT
                 SUM(CASE WHEN ra.state = 'Finished' THEN 1 ELSE 0 END),
                 SUM(CASE WHEN ra.state != 'Failed' THEN 1 ELSE 0 END)
               FROM report_aggregations ra
               JOIN aggregation_jobs aj ON ra.aggregation_job_id = aj.id
               WHERE aj.task_id = ? AND aj.batch_id = ?""",
            (task_pk, batch_id),
        ).fetchone()
        return (row[0] or 0, row[1] or 0)

    def mark_outstanding_batch_filled(self, task_id: TaskId, batch_id: BatchId) -> None:
        pk = self._task_pk(task_id)
        self.conn.execute(
            "UPDATE outstanding_batches SET filled = 1 WHERE task_id = ? AND batch_id = ?",
            (pk, batch_id.data),
        )

    def acquire_filled_outstanding_batch(
        self, task_id: TaskId, min_size: int
    ) -> Optional[BatchId]:
        """Pick (and remove) one outstanding batch with at least ``min_size``
        finished reports — serves FixedSizeQuery::CurrentBatch
        (reference: datastore.rs acquire_outstanding_batch_with_report_count)."""
        pk = self._task_pk(task_id)
        for (batch_id_b,) in self.conn.execute(
            "SELECT batch_id FROM outstanding_batches WHERE task_id = ? ORDER BY created_at",
            (pk,),
        ).fetchall():
            size_min, _ = self._outstanding_batch_size(pk, batch_id_b)
            if size_min >= min_size:
                self.conn.execute(
                    "DELETE FROM outstanding_batches WHERE task_id = ? AND batch_id = ?",
                    (pk, batch_id_b),
                )
                return BatchId(batch_id_b)
        return None

    def delete_outstanding_batch(self, task_id: TaskId, batch_id: BatchId) -> None:
        pk = self._task_pk(task_id)
        self.conn.execute(
            "DELETE FROM outstanding_batches WHERE task_id = ? AND batch_id = ?",
            (pk, batch_id.data),
        )

    # ------------------------------------------------------------------
    # GC (reference: datastore.rs:4733,4793)

    def delete_expired_aggregation_artifacts(
        self, task_id: TaskId, expiry: Time, limit: int
    ) -> int:
        """Delete aggregation jobs (and their report aggregations, via
        cascade) whose entire client-timestamp interval is before expiry.
        Jobs with an OUTSTANDING accumulator-journal row are skipped:
        their FINISHED rows' retained payloads are the only material the
        journal replay can re-derive the missing shares from — deleting
        them would either wedge the batch's readiness gate (row kept) or
        silently corrupt its aggregate (row dropped with the count
        already committed).  The replay consumes the row, and the next
        GC pass collects the job."""
        pk = self._task_pk(task_id)
        cur = self.conn.execute(
            """DELETE FROM aggregation_jobs WHERE id IN (
                 SELECT j.id FROM aggregation_jobs j
                 WHERE j.task_id = ?
                   AND j.client_timestamp_interval_start
                       + j.client_timestamp_interval_duration < ?
                   AND j.state != 'InProgress'
                   AND NOT EXISTS (
                     SELECT 1 FROM accumulator_journal aj
                     WHERE aj.task_id = j.task_id
                       AND aj.aggregation_job_id = j.aggregation_job_id)
                 LIMIT ?)""",
            (pk, expiry.seconds, limit),
        )
        return cur.rowcount

    def count_accumulator_journal_entries(self, task_id: TaskId) -> int:
        """Task-wide outstanding-row count (one indexed COUNT — the
        collection driver's cheap pre-replay probe)."""
        pk = self._task_pk(task_id)
        return self.conn.execute(
            "SELECT COUNT(*) FROM accumulator_journal WHERE task_id = ?", (pk,)
        ).fetchone()[0]

    def delete_expired_collection_artifacts(
        self, task_id: TaskId, expiry: Time, limit: int
    ) -> int:
        pk = self._task_pk(task_id)
        n = self.conn.execute(
            """DELETE FROM collection_jobs WHERE id IN (
                 SELECT id FROM collection_jobs
                 WHERE task_id = ? AND state IN ('Finished','Abandoned','Deleted')
                   AND client_timestamp_interval_start IS NOT NULL
                   AND client_timestamp_interval_start
                       + client_timestamp_interval_duration < ?
                 LIMIT ?)""",
            (pk, expiry.seconds, limit),
        ).rowcount
        n += self.conn.execute(
            """DELETE FROM batch_aggregations WHERE id IN (
                 SELECT id FROM batch_aggregations
                 WHERE task_id = ? AND state != 'Aggregating'
                   AND client_timestamp_interval_start
                       + client_timestamp_interval_duration < ?
                 LIMIT ?)""",
            (pk, expiry.seconds, limit),
        ).rowcount
        n += self.conn.execute(
            """DELETE FROM aggregate_share_jobs WHERE id IN (
                 SELECT id FROM aggregate_share_jobs
                 WHERE task_id = ? AND created_at < ? LIMIT ?)""",
            (pk, expiry.seconds, limit),
        ).rowcount
        return n

    # ------------------------------------------------------------------
    # global HPKE keys (reference: datastore.rs:4857-4983)

    def put_global_hpke_keypair(self, keypair: HpkeKeypair) -> None:
        enc = self.crypter.encrypt(
            "global_hpke_keys",
            bytes([keypair.config.id]),
            "private_key",
            keypair.private_key,
        )
        try:
            self.conn.execute(
                """INSERT INTO global_hpke_keys (config_id, config, private_key,
                    state, updated_at) VALUES (?,?,?,?,?)""",
                (
                    keypair.config.id,
                    keypair.config.get_encoded(),
                    enc,
                    HpkeKeyState.PENDING.value,
                    self._now_s(),
                ),
            )
        except self.ds.backend.integrity_errors as e:
            raise TxConflict("global HPKE key id already exists") from e

    def get_global_hpke_keypairs(self) -> List[GlobalHpkeKeypair]:
        out = []
        for config_id, cfg_b, enc, state, updated in self.conn.execute(
            "SELECT config_id, config, private_key, state, updated_at"
            " FROM global_hpke_keys ORDER BY config_id"
        ):
            sk = self.crypter.decrypt(
                "global_hpke_keys", bytes([config_id]), "private_key", enc
            )
            out.append(
                GlobalHpkeKeypair(
                    config=HpkeConfig.get_decoded(cfg_b),
                    private_key=sk,
                    state=HpkeKeyState(state),
                    updated_at=Time(updated),
                )
            )
        return out

    def set_global_hpke_keypair_state(self, config_id: int, state: HpkeKeyState) -> None:
        cur = self.conn.execute(
            "UPDATE global_hpke_keys SET state = ?, updated_at = ? WHERE config_id = ?",
            (state.value, self._now_s(), config_id),
        )
        if cur.rowcount == 0:
            raise DatastoreError(f"no global HPKE key {config_id}")

    def delete_global_hpke_keypair(self, config_id: int) -> None:
        cur = self.conn.execute(
            "DELETE FROM global_hpke_keys WHERE config_id = ?", (config_id,)
        )
        if cur.rowcount == 0:
            raise DatastoreError(f"no global HPKE key {config_id}")

    # ------------------------------------------------------------------
    # taskprov peer aggregators (reference: datastore.rs:4983-5326)

    def put_taskprov_peer_aggregator(self, peer) -> None:
        from ..aggregator.taskprov import PeerAggregator  # noqa: F401 (type)

        row_ident = peer.endpoint.encode() + bytes([peer.role.value])
        enc_init = self.crypter.encrypt(
            "taskprov_peer_aggregators", row_ident, "verify_key_init",
            peer.verify_key_init,
        )
        tok_type = tok_enc = None
        if peer.aggregator_auth_token is not None:
            tok_type = peer.aggregator_auth_token.kind
            tok_enc = self.crypter.encrypt(
                "taskprov_peer_aggregators", row_ident, "aggregator_auth_token",
                peer.aggregator_auth_token.as_bytes(),
            )
        try:
            self.conn.execute(
                """INSERT INTO taskprov_peer_aggregators (endpoint, role,
                    verify_key_init, collector_hpke_config, report_expiry_age,
                    tolerable_clock_skew, aggregator_auth_token_type,
                    aggregator_auth_token, aggregator_auth_token_hash,
                    collector_auth_token_hash)
                   VALUES (?,?,?,?,?,?,?,?,?,?)""",
                (
                    peer.endpoint,
                    peer.role.name.capitalize(),
                    enc_init,
                    peer.collector_hpke_config.get_encoded(),
                    peer.report_expiry_age.seconds if peer.report_expiry_age else None,
                    peer.tolerable_clock_skew.seconds,
                    tok_type,
                    tok_enc,
                    json.dumps(peer.aggregator_auth_token_hash.to_dict())
                    if peer.aggregator_auth_token_hash
                    else None,
                    json.dumps(peer.collector_auth_token_hash.to_dict())
                    if peer.collector_auth_token_hash
                    else None,
                ),
            )
        except self.ds.backend.integrity_errors as e:
            raise TxConflict("taskprov peer already exists") from e

    def _peer_from_row(self, row):
        from ..aggregator.taskprov import PeerAggregator

        (
            endpoint,
            role_s,
            enc_init,
            cfg_b,
            expiry_age,
            skew,
            tok_type,
            tok_enc,
            agg_hash_s,
            col_hash_s,
        ) = row
        role = Role[role_s.upper()]
        row_ident = endpoint.encode() + bytes([role.value])
        token = None
        if tok_enc is not None:
            raw = self.crypter.decrypt(
                "taskprov_peer_aggregators", row_ident, "aggregator_auth_token", tok_enc
            )
            token = AuthenticationToken(tok_type, raw.decode())
        return PeerAggregator(
            endpoint=endpoint,
            role=role,
            verify_key_init=self.crypter.decrypt(
                "taskprov_peer_aggregators", row_ident, "verify_key_init", enc_init
            ),
            collector_hpke_config=HpkeConfig.get_decoded(cfg_b),
            report_expiry_age=Duration(expiry_age) if expiry_age is not None else None,
            tolerable_clock_skew=Duration(skew),
            aggregator_auth_token=token,
            aggregator_auth_token_hash=AuthenticationTokenHash.from_dict(
                json.loads(agg_hash_s)
            )
            if agg_hash_s
            else None,
            collector_auth_token_hash=AuthenticationTokenHash.from_dict(
                json.loads(col_hash_s)
            )
            if col_hash_s
            else None,
        )

    _PEER_COLS = """endpoint, role, verify_key_init, collector_hpke_config,
        report_expiry_age, tolerable_clock_skew, aggregator_auth_token_type,
        aggregator_auth_token, aggregator_auth_token_hash,
        collector_auth_token_hash"""

    def get_taskprov_peer_aggregator(self, endpoint: str, role: Role):
        row = self.conn.execute(
            f"SELECT {self._PEER_COLS} FROM taskprov_peer_aggregators"
            " WHERE endpoint = ? AND role = ?",
            (endpoint, role.name.capitalize()),
        ).fetchone()
        return self._peer_from_row(row) if row else None

    def get_taskprov_peer_aggregators(self):
        rows = self.conn.execute(
            f"SELECT {self._PEER_COLS} FROM taskprov_peer_aggregators ORDER BY id"
        ).fetchall()
        return [self._peer_from_row(r) for r in rows]

    def delete_taskprov_peer_aggregator(self, endpoint: str, role: Role) -> None:
        cur = self.conn.execute(
            "DELETE FROM taskprov_peer_aggregators WHERE endpoint = ? AND role = ?",
            (endpoint, role.name.capitalize()),
        )
        if cur.rowcount == 0:
            raise DatastoreError("no such taskprov peer")

    # ------------------------------------------------------------------
    # lease reaping (crash recovery: a killed replica's leases expire and
    # are re-acquirable anyway, but reaping makes the redelivery PROMPT
    # and — more importantly — observable: each reaped row is a lease that
    # expired without release, i.e. a holder that died or wedged)

    def reap_expired_aggregation_job_leases(self) -> int:
        """Clear the lease token of every InProgress aggregation job whose
        lease expired without being released (the holder never came back).
        Returns the number of reaped leases.  ``lease_attempts`` is left
        untouched — it was incremented at acquire time, so the
        delivery-count budgets survive the holder's death."""
        cur = self.conn.execute(
            """UPDATE aggregation_jobs SET lease_token = NULL, lease_expiry = 0
               WHERE state = 'InProgress' AND lease_token IS NOT NULL
                 AND lease_expiry <= ?""",
            (self._now_s(),),
        )
        return cur.rowcount

    def reap_expired_collection_job_leases(self) -> int:
        cur = self.conn.execute(
            """UPDATE collection_jobs SET lease_token = NULL, lease_expiry = 0
               WHERE state = 'Start' AND lease_token IS NOT NULL
                 AND lease_expiry <= ?""",
            (self._now_s(),),
        )
        return cur.rowcount

    # ------------------------------------------------------------------
    # fleet introspection (the binaries' status sampler and the
    # /statusz endpoint — cheap indexed COUNTs, no payload reads)

    def accumulator_journal_stats(self) -> Tuple[int, Optional[int]]:
        """(outstanding rows, oldest created_at) across every task — the
        freshness sampler's journal-age input."""
        count, oldest = self.conn.execute(
            "SELECT COUNT(*), MIN(created_at) FROM accumulator_journal"
        ).fetchone()
        return int(count or 0), (int(oldest) if oldest is not None else None)

    def lease_summary(self) -> Dict[str, Dict[str, int]]:
        """Per-job-type lease occupancy: held (live lease), expired_held
        (lease token outstanding past expiry — a dead/wedged holder the
        reaper has not cleared yet), acquirable.  The single source for
        the acquirable-backlog counts (/statusz AND the
        janus_acquirable_jobs sampler)."""
        now = self._now_s()
        out: Dict[str, Dict[str, int]] = {}
        for job_type, table, state in _JOB_LEASE_TABLES:
            held, expired, acquirable, active = self.conn.execute(
                f"""SELECT
                      SUM(CASE WHEN lease_token IS NOT NULL AND lease_expiry > ?
                          THEN 1 ELSE 0 END),
                      SUM(CASE WHEN lease_token IS NOT NULL AND lease_expiry <= ?
                          THEN 1 ELSE 0 END),
                      SUM(CASE WHEN lease_expiry <= ? THEN 1 ELSE 0 END),
                      COUNT(*)
                    FROM {table} WHERE state = ?""",
                (now, now, now, state),
            ).fetchone()
            out[job_type] = {
                "active": int(active or 0),
                "held": int(held or 0),
                "expired_held": int(expired or 0),
                "acquirable": int(acquirable or 0),
            }
        return out

    # ------------------------------------------------------------------
    # fleet control plane membership (core/fleet.py; schema.py
    # _FLEET_MEMBERS_SCHEMA).  One row per registered driver replica;
    # the heartbeat write doubles as the suspect-set advertisement.

    def upsert_fleet_member(
        self,
        replica_id: str,
        role: str,
        suspect_peers: Sequence[str] = (),
    ) -> None:
        """Register ``replica_id`` or refresh its heartbeat to tx-now.

        ``started_at`` is preserved across refreshes (it is only set on
        first insert); ``suspect_peers``/``suspect_updated_at`` are
        rewritten on every heartbeat so a healed peer un-publishes by
        simply advertising an empty set."""
        now = self._now_s()
        encoded = json.dumps(sorted(set(suspect_peers)))
        cur = self.conn.execute(
            "UPDATE fleet_members SET role = ?, heartbeat = ?,"
            " suspect_peers = ?, suspect_updated_at = ?"
            " WHERE replica_id = ?",
            (role, now, encoded, now, replica_id),
        )
        if cur.rowcount == 0:
            try:
                self.conn.execute(
                    "INSERT INTO fleet_members (replica_id, role, heartbeat,"
                    " started_at, suspect_peers, suspect_updated_at)"
                    " VALUES (?, ?, ?, ?, ?, ?)",
                    (replica_id, role, now, now, encoded, now),
                )
            except self.ds.backend.integrity_errors as e:
                # Two handles racing the same replica_id's first heartbeat;
                # the retry loop's next attempt takes the UPDATE path.
                raise TxConflict(f"fleet member insert race: {e}") from e

    def get_fleet_members(self, role: Optional[str] = None) -> List[FleetMember]:
        """Every registered member (optionally one role), stale included —
        liveness is the *caller's* TTL judgment, so routers and /statusz
        can both see dead rows (the latter reports them as such)."""
        if role is None:
            rows = self.conn.execute(
                "SELECT replica_id, role, heartbeat, started_at,"
                " suspect_peers, suspect_updated_at FROM fleet_members"
                " ORDER BY replica_id"
            ).fetchall()
        else:
            rows = self.conn.execute(
                "SELECT replica_id, role, heartbeat, started_at,"
                " suspect_peers, suspect_updated_at FROM fleet_members"
                " WHERE role = ? ORDER BY replica_id",
                (role,),
            ).fetchall()
        out = []
        for rid, mrole, hb, started, suspects, sus_at in rows:
            try:
                peers = tuple(json.loads(suspects)) if suspects else ()
            except ValueError:
                peers = ()
            out.append(
                FleetMember(
                    replica_id=rid,
                    role=mrole,
                    heartbeat=Time(int(hb)),
                    started_at=Time(int(started)),
                    suspect_peers=peers,
                    suspect_updated_at=(
                        Time(int(sus_at)) if sus_at is not None else None
                    ),
                )
            )
        return out

    def delete_fleet_member(self, replica_id: str) -> bool:
        """Graceful deregistration (clean shutdown): the member drops out
        of the rendezvous domain immediately instead of after the TTL."""
        cur = self.conn.execute(
            "DELETE FROM fleet_members WHERE replica_id = ?", (replica_id,)
        )
        return cur.rowcount > 0

    def prune_fleet_members(self, older_than: Duration) -> int:
        """Delete rows whose heartbeat is older than ``older_than`` — dead
        replicas that never deregistered.  Routers treat stale rows as
        non-live regardless, so pruning is pure hygiene and any live
        replica may do it opportunistically."""
        cutoff = self._now_s() - older_than.seconds
        cur = self.conn.execute(
            "DELETE FROM fleet_members WHERE heartbeat < ?", (cutoff,)
        )
        return cur.rowcount

    # ------------------------------------------------------------------
    # accumulator journal (deferred device-resident drains; see
    # executor/accumulator.py and schema.py _ACCUMULATOR_JOURNAL_SCHEMA)

    def put_accumulator_journal_entry(
        self,
        task_id: TaskId,
        batch_identifier: bytes,
        aggregation_parameter: bytes,
        aggregation_job_id: AggregationJobId,
        report_ids: Sequence[bytes],
        drain_interval_s: Optional[float] = None,
    ) -> None:
        """Record one job's un-drained resident delta.  Must run in the
        SAME transaction as the writer commit that records these reports
        Finished — the journal row and the FINISHED states are one fact.
        ``drain_interval_s`` is the owning accumulator's drain cadence."""
        pk = self._task_pk(task_id)
        rids_b = b"".join(report_ids)
        row_crc = _accumulator_journal_crc(
            batch_identifier, aggregation_parameter, aggregation_job_id.data, rids_b
        )
        # corruption fault point AFTER the CRC: stored bytes may lie, the
        # checksum witnesses what SHOULD have been stored
        rids_b = faults.corrupt_bytes(
            "journal.corrupt", rids_b, target="accumulator_journal"
        )
        try:
            self.conn.execute(
                """INSERT INTO accumulator_journal (task_id, batch_identifier,
                    aggregation_param, aggregation_job_id, report_ids, created_at,
                    row_crc, drain_interval_s)
                   VALUES (?,?,?,?,?,?,?,?)""",
                (
                    pk,
                    batch_identifier,
                    aggregation_parameter,
                    aggregation_job_id.data,
                    rids_b,
                    self._now_s(),
                    row_crc,
                    drain_interval_s,
                ),
            )
        except self.ds.backend.integrity_errors as e:
            raise TxConflict(
                f"accumulator journal entry for job {aggregation_job_id} exists"
            ) from e

    def get_accumulator_journal_entries(
        self, task_id: TaskId, batch_identifier: Optional[bytes] = None
    ) -> List[AccumulatorJournalEntry]:
        pk = self._task_pk(task_id)
        sql = """SELECT id, batch_identifier, aggregation_param, aggregation_job_id,
                        report_ids, created_at, row_crc, drain_interval_s
                 FROM accumulator_journal WHERE task_id = ?"""
        args: List[Any] = [pk]
        if batch_identifier is not None:
            sql += " AND batch_identifier = ?"
            args.append(batch_identifier)
        sql += " ORDER BY id"
        out = []
        for rowid, ident, param, job_id, rids_b, created, row_crc, interval in self.conn.execute(
            sql, args
        ):
            # NULL row_crc = pre-migration row, accepted unverified
            if row_crc is not None and row_crc != _accumulator_journal_crc(
                ident, param, job_id, rids_b or b""
            ):
                self._quarantine_corrupt_journal_row(
                    "accumulator_journal",
                    "DELETE FROM accumulator_journal WHERE id = ?",
                    rowid,
                    task_hex=task_id.data.hex(),
                    payload=rids_b,
                )
                continue
            out.append(
                AccumulatorJournalEntry(
                    task_id=task_id,
                    batch_identifier=ident,
                    aggregation_parameter=param,
                    aggregation_job_id=AggregationJobId(job_id),
                    report_ids=tuple(
                        rids_b[i : i + 16] for i in range(0, len(rids_b), 16)
                    ),
                    created_at=Time(created),
                    drain_interval_s=interval,
                )
            )
        return out

    def _quarantine_corrupt_journal_row(
        self,
        stage: str,
        delete_sql: str,
        rowid: int,
        task_hex: Optional[str],
        payload: Optional[bytes],
        report_id: Optional[bytes] = None,
    ) -> None:
        """Pull a checksum-failed durable row out of its journal: record it
        in quarantined_reports and DELETE it in the same transaction (a
        corrupt row left in place would wedge collection readiness gates
        and re-fail every materialize pass forever).  Counting happens via
        the process recorder; a tx retry may double-count the metric but
        the SQL effects re-apply atomically."""
        from ..core import quarantine

        self.put_quarantined_report(
            task=task_hex,
            report_id=report_id,
            stage=stage,
            error_class="ChecksumMismatch",
            payload_digest=quarantine.payload_digest(payload or b""),
        )
        self.conn.execute(delete_sql, (rowid,))
        quarantine.note_corrupt_row(stage)

    def count_accumulator_journal_entries_for_batch(
        self,
        task_id: TaskId,
        batch_identifier: bytes,
        aggregation_parameter: Optional[bytes] = None,
    ) -> int:
        """Collection readiness input: >0 means counted reports whose
        shares are not yet merged into batch_aggregations.  Filter by
        aggregation parameter when gating ONE parameter's collection —
        another parameter's outstanding rows do not affect its
        accumulators (and the replay only consumes matching rows)."""
        pk = self._task_pk(task_id)
        sql = (
            "SELECT COUNT(*) FROM accumulator_journal"
            " WHERE task_id = ? AND batch_identifier = ?"
        )
        args: List[Any] = [pk, batch_identifier]
        if aggregation_parameter is not None:
            sql += " AND aggregation_param = ?"
            args.append(aggregation_parameter)
        return self.conn.execute(sql, args).fetchone()[0]

    def delete_accumulator_journal_entry(
        self,
        task_id: TaskId,
        batch_identifier: bytes,
        aggregation_parameter: bytes,
        aggregation_job_id: AggregationJobId,
    ) -> bool:
        """Consume one journal row; returns False when it was already
        consumed (a drain and a crash-recovery replay raced — the loser
        MUST NOT merge its vector, or the delta double-counts)."""
        pk = self._task_pk(task_id)
        cur = self.conn.execute(
            """DELETE FROM accumulator_journal
               WHERE task_id = ? AND batch_identifier = ?
                 AND aggregation_param = ? AND aggregation_job_id = ?""",
            (pk, batch_identifier, aggregation_parameter, aggregation_job_id.data),
        )
        return cur.rowcount > 0

    # ------------------------------------------------------------------
    # report journal (write-behind ingest, core/ingest.py; schema.py
    # _REPORT_JOURNAL_SCHEMA).  One row per ACKed-but-unmaterialized
    # report; the journal-flush transaction that inserts it is the
    # client's durability ACK and the ONLY place report_success is
    # counted — materialization/consumption never touches counters.

    def put_report_journal_row(self, report: LeaderStoredReport) -> None:
        """Park one ACKed report's full payload until the background
        materializer (or crash replay, or a surviving replica's creator)
        consumes it.  The share ciphertext is bound to the client_reports
        AAD — deliberately, so materialization is a verbatim column copy
        with no decrypt/re-encrypt hop."""
        pk = self._task_pk(report.task_id)
        row_ident = report.task_id.data + report.report_id.data
        enc_share = self.crypter.encrypt(
            "client_reports", row_ident, "leader_input_share", report.leader_input_share
        )
        ext_b = _encode_extensions(report.leader_extensions)
        helper_b = report.helper_encrypted_input_share.get_encoded()
        row_crc = _report_journal_crc(
            report.report_id.data,
            report.time.seconds,
            ext_b,
            report.public_share,
            enc_share,
            helper_b,
        )
        # corruption fault point AFTER the CRC: a fired corrupt-mode spec
        # stores mangled ciphertext under the honest checksum — exactly
        # what a torn write / bit rot looks like to the verify pass
        enc_share = faults.corrupt_bytes(
            "journal.corrupt", enc_share, target="report_journal"
        )
        try:
            self.conn.execute(
                """INSERT INTO report_journal (task_id, report_id, client_timestamp,
                    extensions, public_share, leader_input_share,
                    helper_encrypted_input_share, trace_id, created_at, row_crc)
                   VALUES (?,?,?,?,?,?,?,?,?,?)""",
                (
                    pk,
                    report.report_id.data,
                    report.time.seconds,
                    ext_b,
                    report.public_share,
                    enc_share,
                    helper_b,
                    report.trace_id,
                    self._now_s(),
                    row_crc,
                ),
            )
        except self.ds.backend.integrity_errors as e:
            raise TxConflict(
                f"journal row for report {report.report_id} already exists"
            ) from e

    def delete_report_journal_row(self, task_id: TaskId, report_id: ReportId) -> bool:
        """Consume one journal row; returns False when it was already
        consumed (the materializer and a staged-cohort consumer raced —
        the loser MUST NOT write anything for this report, or it lands in
        client_reports / an aggregation job twice)."""
        pk = self._task_pk(task_id)
        cur = self.conn.execute(
            "DELETE FROM report_journal WHERE task_id = ? AND report_id = ?",
            (pk, report_id.data),
        )
        return cur.rowcount > 0

    def get_report_journal_reports(
        self, task_id: TaskId, limit: int = 512
    ) -> List[LeaderStoredReport]:
        """Full (decrypted) journaled reports for one task, oldest first —
        introspection and the per-task replay fallback; the bulk path is
        ``materialize_report_journal_rows``, which never decrypts."""
        pk = self._task_pk(task_id)
        rows = self.conn.execute(
            """SELECT id, report_id, client_timestamp, extensions, public_share,
                      leader_input_share, helper_encrypted_input_share, trace_id,
                      row_crc
               FROM report_journal WHERE task_id = ? ORDER BY id LIMIT ?""",
            (pk, limit),
        ).fetchall()
        out = []
        for rowid, rid, ts, ext_b, public_share, enc_share, helper_b, trace_id, crc in rows:
            # checksum fence BEFORE the decrypt: a torn/bit-flipped
            # ciphertext would fail its AEAD tag and crash the replay —
            # quarantine + skip instead (NULL crc = pre-migration row)
            if crc is not None and crc != _report_journal_crc(
                rid, ts, ext_b, public_share, enc_share, helper_b
            ):
                self._quarantine_corrupt_journal_row(
                    "journal",
                    "DELETE FROM report_journal WHERE id = ?",
                    rowid,
                    task_hex=task_id.data.hex(),
                    payload=enc_share,
                    report_id=rid,
                )
                continue
            share = self.crypter.decrypt(
                "client_reports", task_id.data + rid, "leader_input_share", enc_share
            )
            out.append(
                LeaderStoredReport(
                    task_id=task_id,
                    metadata=ReportMetadata(ReportId(rid), Time(ts)),
                    public_share=public_share,
                    leader_extensions=_decode_extensions(ext_b) if ext_b else [],
                    leader_input_share=share,
                    helper_encrypted_input_share=HpkeCiphertext.get_decoded(helper_b),
                    trace_id=trace_id,
                )
            )
        return out

    def count_report_journal_rows(self, task_id: Optional[TaskId] = None) -> int:
        if task_id is None:
            return self.conn.execute(
                "SELECT COUNT(*) FROM report_journal"
            ).fetchone()[0]
        pk = self._task_pk(task_id)
        return self.conn.execute(
            "SELECT COUNT(*) FROM report_journal WHERE task_id = ?", (pk,)
        ).fetchone()[0]

    def materialize_report_journal_rows(
        self, limit: int, min_age_s: float = 0.0
    ) -> Tuple[int, int]:
        """Move up to ``limit`` journal rows (oldest first, across every
        task) into client_reports and consume them; returns (consumed,
        materialized).  A row whose report already exists in
        client_reports (a duplicate that raced in through the synchronous
        path) is consumed without inserting — counters were settled at
        journal-flush time either way.  Pure SQL column copies: the share
        ciphertext moves between tables without ever being decrypted.

        ``min_age_s`` restricts the pass to rows at least that old — the
        creator's periodic pre-pass uses it as a grace window so it does
        not steal rows out from under the upload replica's direct
        staged-cohort consumer (stealing is SAFE — the row delete
        linearizes the race — but it downgrades a zero-copy packing to a
        read-back for no reason).

        Every candidate row's CRC32C is verified first: a
        checksum-failed row is quarantined + consumed WITHOUT materializing
        — corruption costs one counted report, never a crashed binary or a
        materializer that re-fails the same fold forever.  Corrupt rows
        count as consumed in the returned tuple."""
        candidates = self.conn.execute(
            """SELECT rj.id, rj.report_id, rj.client_timestamp, rj.extensions,
                      rj.public_share, rj.leader_input_share,
                      rj.helper_encrypted_input_share, rj.row_crc, t.task_id
               FROM report_journal rj JOIN tasks t ON t.id = rj.task_id
               WHERE rj.created_at <= ? ORDER BY rj.id LIMIT ?""",
            (self._now_s() - min_age_s, limit),
        ).fetchall()
        ids = []
        for rowid, rid, ts, ext_b, public, enc, helper_b, crc, task_blob in candidates:
            if crc is not None and crc != _report_journal_crc(
                rid, ts, ext_b, public, enc, helper_b
            ):
                self._quarantine_corrupt_journal_row(
                    "journal",
                    "DELETE FROM report_journal WHERE id = ?",
                    rowid,
                    task_hex=bytes(task_blob).hex(),
                    payload=enc,
                    report_id=rid,
                )
                continue
            ids.append(rowid)
        if not ids:
            return len(candidates), 0
        ph = ",".join("?" * len(ids))
        cur = self.conn.execute(
            f"""INSERT INTO client_reports (task_id, report_id, client_timestamp,
                    extensions, public_share, leader_input_share,
                    helper_encrypted_input_share, trace_id, created_at)
                SELECT rj.task_id, rj.report_id, rj.client_timestamp,
                       rj.extensions, rj.public_share, rj.leader_input_share,
                       rj.helper_encrypted_input_share, rj.trace_id, rj.created_at
                FROM report_journal rj
                WHERE rj.id IN ({ph}) AND NOT EXISTS (
                    SELECT 1 FROM client_reports cr
                    WHERE cr.task_id = rj.task_id
                      AND cr.report_id = rj.report_id)""",
            ids,
        )
        materialized = cur.rowcount
        self.conn.execute(f"DELETE FROM report_journal WHERE id IN ({ph})", ids)
        return len(candidates), materialized

    def report_journal_stats(self) -> Tuple[int, Optional[int]]:
        """(outstanding rows, oldest created_at) across every task — the
        /statusz ingest section + journal-depth sampler input."""
        count, oldest = self.conn.execute(
            "SELECT COUNT(*), MIN(created_at) FROM report_journal"
        ).fetchone()
        return int(count or 0), (int(oldest) if oldest is not None else None)

    def put_scrubbed_client_report(
        self,
        task_id: TaskId,
        report_id: ReportId,
        client_timestamp: Time,
        trace_id: Optional[str],
    ) -> bool:
        """Tombstone insert for the direct-staged consumption path
        (core/ingest.py): the report goes straight from the upload batch
        into an aggregation job, so its client_reports row is born
        already scrubbed (NULL payloads, aggregation_started) — exactly
        what put + scrub would have left, minus the round-trip; trace_id
        is kept so collection-time trace linking still sees the upload.
        Returns False when a row already exists (a synchronous-mode
        duplicate raced us in): the caller must NOT pack the report —
        the existing row's owner already has it."""
        pk = self._task_pk(task_id)
        cur = self.conn.execute(
            """INSERT INTO client_reports (task_id, report_id, client_timestamp,
                aggregation_started, trace_id, created_at)
               VALUES (?,?,?,1,?,?)
               ON CONFLICT(task_id, report_id) DO NOTHING""",
            (pk, report_id.data, client_timestamp.seconds, trace_id, self._now_s()),
        )
        return cur.rowcount > 0

    # ------------------------------------------------------------------
    # quarantined reports (blast-radius isolation, core/quarantine.py;
    # schema.py _QUARANTINE_SCHEMA).  The durable offender ledger: rows
    # pulled out of a vectorized cohort by bisection, or durable journal
    # rows that failed their CRC.  Writes are idempotent (dedupe index +
    # DO NOTHING) so replays and client retries of the same poison report
    # record once.

    def put_quarantined_report(
        self,
        task: Optional[str],
        report_id: Optional[bytes],
        stage: str,
        error_class: str,
        payload_digest: Optional[str] = None,
    ) -> bool:
        cur = self.conn.execute(
            """INSERT INTO quarantined_reports
                   (task, report_id, stage, error_class, payload_digest,
                    created_at)
               VALUES (?,?,?,?,?,?)
               ON CONFLICT DO NOTHING""",
            (task, report_id, stage, error_class, payload_digest, self._now_s()),
        )
        return cur.rowcount > 0

    def get_quarantined_reports(
        self,
        task: Optional[str] = None,
        stage: Optional[str] = None,
        limit: int = 256,
    ) -> List[Dict[str, Any]]:
        sql = (
            "SELECT task, report_id, stage, error_class, payload_digest,"
            " created_at FROM quarantined_reports"
        )
        conds, args = [], []
        if task is not None:
            conds.append("task = ?")
            args.append(task)
        if stage is not None:
            conds.append("stage = ?")
            args.append(stage)
        if conds:
            sql += " WHERE " + " AND ".join(conds)
        sql += " ORDER BY id LIMIT ?"
        args.append(limit)
        return [
            {
                "task": t,
                "report_id": bytes(rid).hex() if rid is not None else None,
                "stage": s,
                "error_class": ec,
                "payload_digest": dig,
                "created_at": int(created),
            }
            for t, rid, s, ec, dig, created in self.conn.execute(sql, args)
        ]

    def count_quarantined_reports(self, stage: Optional[str] = None) -> int:
        if stage is None:
            return self.conn.execute(
                "SELECT COUNT(*) FROM quarantined_reports"
            ).fetchone()[0]
        return self.conn.execute(
            "SELECT COUNT(*) FROM quarantined_reports WHERE stage = ?", (stage,)
        ).fetchone()[0]

    def purge_quarantined_reports(
        self, task: Optional[str] = None, stage: Optional[str] = None
    ) -> int:
        sql = "DELETE FROM quarantined_reports"
        conds, args = [], []
        if task is not None:
            conds.append("task = ?")
            args.append(task)
        if stage is not None:
            conds.append("stage = ?")
            args.append(stage)
        if conds:
            sql += " WHERE " + " AND ".join(conds)
        cur = self.conn.execute(sql, args)
        return cur.rowcount

    # ------------------------------------------------------------------
    # upload counters (reference: datastore.rs:5326-5429)

    def increment_task_upload_counter(
        self, task_id: TaskId, ord: int, counter: TaskUploadCounter
    ) -> None:
        pk = self._task_pk(task_id)
        self.conn.execute(
            """INSERT INTO task_upload_counters (task_id, ord) VALUES (?, ?)
               ON CONFLICT(task_id, ord) DO NOTHING""",
            (pk, ord),
        )
        sets = ", ".join(f"{c} = {c} + ?" for c in TaskUploadCounter.COLUMNS)
        self.conn.execute(
            f"UPDATE task_upload_counters SET {sets} WHERE task_id = ? AND ord = ?",
            tuple(getattr(counter, c) for c in TaskUploadCounter.COLUMNS) + (pk, ord),
        )

    def get_task_upload_counter(self, task_id: TaskId) -> TaskUploadCounter:
        pk = self._task_pk(task_id)
        sums = ", ".join(f"COALESCE(SUM({c}), 0)" for c in TaskUploadCounter.COLUMNS)
        row = self.conn.execute(
            f"SELECT {sums} FROM task_upload_counters WHERE task_id = ?", (pk,)
        ).fetchone()
        return TaskUploadCounter(
            task_id, **dict(zip(TaskUploadCounter.COLUMNS, row))
        )
