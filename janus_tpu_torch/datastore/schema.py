"""Datastore SQL schema + migrations.

The analog of the reference's migrations (reference:
db/00000000000001_initial_schema.up.sql and siblings).  SQLite dialect:
BLOBs for ids and ciphertexts, INTEGER seconds for times/durations, TEXT for
JSON-serialized enums/configs.  Structure (tables, uniqueness, indexes incl.
the partial index on unaggregated reports and lease-expiry indexes) mirrors
the reference schema; GiST interval indexes become ordinary (start, end)
b-trees.

``MIGRATIONS[k]`` is the DDL taking a version-k store to version k+1; a
fresh database applies all of them in order, an existing one only the tail
past its stamped version (Datastore._init_schema).  The binary-side
compatibility gate is ``SUPPORTED_SCHEMA_VERSIONS``, the analog of the
reference's ``supported_schema_versions!``
(aggregator_core/src/datastore.rs:77-104): with migrate_on_open disabled
(the production deploy shape, where an operator runs migrations), the
datastore refuses to operate on any version not in this set.
"""

_INITIAL_SCHEMA = """
CREATE TABLE IF NOT EXISTS schema_version (
    version INTEGER NOT NULL
);

-- reference: initial_schema.up.sql `tasks`
CREATE TABLE IF NOT EXISTS tasks (
    id INTEGER PRIMARY KEY,
    task_id BLOB NOT NULL UNIQUE,
    aggregator_role TEXT NOT NULL,              -- 'Leader' | 'Helper'
    peer_aggregator_endpoint TEXT NOT NULL,
    query_type TEXT NOT NULL,                   -- TaskQueryType JSON
    vdaf TEXT NOT NULL,                         -- VdafInstance JSON
    task_expiration INTEGER,
    report_expiry_age INTEGER,
    min_batch_size INTEGER NOT NULL,
    time_precision INTEGER NOT NULL,
    tolerable_clock_skew INTEGER NOT NULL,
    collector_hpke_config BLOB,
    vdaf_verify_key BLOB NOT NULL,              -- encrypted
    aggregator_auth_token_type TEXT,
    aggregator_auth_token BLOB,                 -- encrypted (leader only)
    aggregator_auth_token_hash TEXT,            -- JSON (helper only)
    collector_auth_token_hash TEXT,             -- JSON (leader only)
    created_at INTEGER NOT NULL
);

-- reference: initial_schema.up.sql `task_hpke_keys`
CREATE TABLE IF NOT EXISTS task_hpke_keys (
    id INTEGER PRIMARY KEY,
    task_id INTEGER NOT NULL REFERENCES tasks(id) ON DELETE CASCADE,
    config_id INTEGER NOT NULL,
    config BLOB NOT NULL,
    private_key BLOB NOT NULL,                  -- encrypted
    UNIQUE(task_id, config_id)
);

-- reference: initial_schema.up.sql `client_reports` (:204 partial index)
CREATE TABLE IF NOT EXISTS client_reports (
    id INTEGER PRIMARY KEY,
    task_id INTEGER NOT NULL REFERENCES tasks(id) ON DELETE CASCADE,
    report_id BLOB NOT NULL,
    client_timestamp INTEGER NOT NULL,
    extensions BLOB,
    public_share BLOB,
    leader_input_share BLOB,                    -- encrypted
    helper_encrypted_input_share BLOB,
    aggregation_started INTEGER NOT NULL DEFAULT 0,
    created_at INTEGER NOT NULL,
    UNIQUE(task_id, report_id)
);
CREATE INDEX IF NOT EXISTS client_reports_task_unaggregated
    ON client_reports(task_id, client_timestamp) WHERE aggregation_started = 0;

-- reference: initial_schema.up.sql `aggregation_jobs` (lease index :239)
CREATE TABLE IF NOT EXISTS aggregation_jobs (
    id INTEGER PRIMARY KEY,
    task_id INTEGER NOT NULL REFERENCES tasks(id) ON DELETE CASCADE,
    aggregation_job_id BLOB NOT NULL,
    aggregation_param BLOB NOT NULL,
    batch_id BLOB,                              -- fixed-size tasks only
    client_timestamp_interval_start INTEGER NOT NULL,
    client_timestamp_interval_duration INTEGER NOT NULL,
    state TEXT NOT NULL,                        -- AggregationJobState
    step INTEGER NOT NULL DEFAULT 0,
    last_request_hash BLOB,
    lease_expiry INTEGER NOT NULL DEFAULT 0,
    lease_token BLOB,
    lease_attempts INTEGER NOT NULL DEFAULT 0,
    created_at INTEGER NOT NULL,
    updated_at INTEGER NOT NULL,
    UNIQUE(task_id, aggregation_job_id)
);
CREATE INDEX IF NOT EXISTS aggregation_jobs_state_lease
    ON aggregation_jobs(state, lease_expiry) WHERE state = 'InProgress';

-- reference: initial_schema.up.sql `report_aggregations`
CREATE TABLE IF NOT EXISTS report_aggregations (
    id INTEGER PRIMARY KEY,
    task_id INTEGER NOT NULL REFERENCES tasks(id) ON DELETE CASCADE,
    aggregation_job_id INTEGER NOT NULL
        REFERENCES aggregation_jobs(id) ON DELETE CASCADE,
    ord INTEGER NOT NULL,
    report_id BLOB NOT NULL,
    client_timestamp INTEGER NOT NULL,
    last_prep_resp BLOB,
    state TEXT NOT NULL,                        -- ReportAggregationState
    -- state-specific payloads (reference: models.rs:898-1105):
    public_share BLOB,                          -- StartLeader
    leader_extensions BLOB,                     -- StartLeader
    leader_input_share BLOB,                    -- StartLeader, encrypted
    helper_encrypted_input_share BLOB,          -- StartLeader
    leader_prep_transition BLOB,                -- WaitingLeader, encrypted
    helper_prep_state BLOB,                     -- WaitingHelper, encrypted
    error_code INTEGER,                         -- Failed
    UNIQUE(aggregation_job_id, ord)
);
CREATE INDEX IF NOT EXISTS report_aggregations_by_report
    ON report_aggregations(task_id, report_id);

-- reference: initial_schema.up.sql `batch_aggregations` (sharded accumulators)
CREATE TABLE IF NOT EXISTS batch_aggregations (
    id INTEGER PRIMARY KEY,
    task_id INTEGER NOT NULL REFERENCES tasks(id) ON DELETE CASCADE,
    batch_identifier BLOB NOT NULL,             -- encoded Interval or BatchId
    aggregation_param BLOB NOT NULL,
    ord INTEGER NOT NULL,                       -- shard index
    state TEXT NOT NULL,                        -- Aggregating|Collected|Scrubbed
    aggregate_share BLOB,
    report_count INTEGER NOT NULL DEFAULT 0,
    checksum BLOB,
    client_timestamp_interval_start INTEGER NOT NULL,
    client_timestamp_interval_duration INTEGER NOT NULL,
    aggregation_jobs_created INTEGER NOT NULL DEFAULT 0,
    aggregation_jobs_terminated INTEGER NOT NULL DEFAULT 0,
    created_at INTEGER NOT NULL,
    UNIQUE(task_id, batch_identifier, aggregation_param, ord)
);
CREATE INDEX IF NOT EXISTS batch_aggregations_by_interval
    ON batch_aggregations(task_id, client_timestamp_interval_start);

-- reference: initial_schema.up.sql `collection_jobs` (GiST :363 -> b-tree)
CREATE TABLE IF NOT EXISTS collection_jobs (
    id INTEGER PRIMARY KEY,
    task_id INTEGER NOT NULL REFERENCES tasks(id) ON DELETE CASCADE,
    collection_job_id BLOB NOT NULL,
    query BLOB NOT NULL,
    aggregation_param BLOB NOT NULL,
    batch_identifier BLOB NOT NULL,
    state TEXT NOT NULL,                        -- Start|Finished|Abandoned|Deleted
    report_count INTEGER,
    client_timestamp_interval_start INTEGER,
    client_timestamp_interval_duration INTEGER,
    leader_aggregate_share BLOB,                -- encrypted
    helper_aggregate_share BLOB,
    lease_expiry INTEGER NOT NULL DEFAULT 0,
    lease_token BLOB,
    lease_attempts INTEGER NOT NULL DEFAULT 0,
    step_attempts INTEGER NOT NULL DEFAULT 0,
    created_at INTEGER NOT NULL,
    updated_at INTEGER NOT NULL,
    UNIQUE(task_id, collection_job_id)
);
CREATE INDEX IF NOT EXISTS collection_jobs_state_lease
    ON collection_jobs(state, lease_expiry) WHERE state = 'Start';
CREATE INDEX IF NOT EXISTS collection_jobs_by_batch
    ON collection_jobs(task_id, batch_identifier);

-- reference: initial_schema.up.sql `aggregate_share_jobs` (helper cache)
CREATE TABLE IF NOT EXISTS aggregate_share_jobs (
    id INTEGER PRIMARY KEY,
    task_id INTEGER NOT NULL REFERENCES tasks(id) ON DELETE CASCADE,
    batch_identifier BLOB NOT NULL,
    aggregation_param BLOB NOT NULL,
    helper_aggregate_share BLOB NOT NULL,       -- encrypted
    report_count INTEGER NOT NULL,
    checksum BLOB NOT NULL,
    created_at INTEGER NOT NULL,
    UNIQUE(task_id, batch_identifier, aggregation_param)
);

-- reference: initial_schema.up.sql `outstanding_batches`
CREATE TABLE IF NOT EXISTS outstanding_batches (
    id INTEGER PRIMARY KEY,
    task_id INTEGER NOT NULL REFERENCES tasks(id) ON DELETE CASCADE,
    batch_id BLOB NOT NULL,
    time_bucket_start INTEGER,
    filled INTEGER NOT NULL DEFAULT 0,
    created_at INTEGER NOT NULL,
    UNIQUE(task_id, batch_id)
);
CREATE INDEX IF NOT EXISTS outstanding_batches_open
    ON outstanding_batches(task_id, time_bucket_start) WHERE filled = 0;

-- reference: initial_schema.up.sql `global_hpke_keys`
CREATE TABLE IF NOT EXISTS global_hpke_keys (
    config_id INTEGER PRIMARY KEY,
    config BLOB NOT NULL,
    private_key BLOB NOT NULL,                  -- encrypted
    state TEXT NOT NULL,                        -- Pending|Active|Expired
    updated_at INTEGER NOT NULL
);

-- reference: taskprov_* tables
CREATE TABLE IF NOT EXISTS taskprov_peer_aggregators (
    id INTEGER PRIMARY KEY,
    endpoint TEXT NOT NULL,
    role TEXT NOT NULL,
    verify_key_init BLOB NOT NULL,              -- encrypted
    collector_hpke_config BLOB NOT NULL,
    report_expiry_age INTEGER,
    tolerable_clock_skew INTEGER NOT NULL,
    aggregator_auth_token_type TEXT,
    aggregator_auth_token BLOB,                 -- encrypted
    aggregator_auth_token_hash TEXT,            -- JSON
    collector_auth_token_hash TEXT,             -- JSON
    UNIQUE(endpoint, role)
);

-- reference: task_upload_counters (:5326), sharded
CREATE TABLE IF NOT EXISTS task_upload_counters (
    id INTEGER PRIMARY KEY,
    task_id INTEGER NOT NULL REFERENCES tasks(id) ON DELETE CASCADE,
    ord INTEGER NOT NULL,
    interval_collected INTEGER NOT NULL DEFAULT 0,
    report_decode_failure INTEGER NOT NULL DEFAULT 0,
    report_decrypt_failure INTEGER NOT NULL DEFAULT 0,
    report_expired INTEGER NOT NULL DEFAULT 0,
    report_outdated_key INTEGER NOT NULL DEFAULT 0,
    report_success INTEGER NOT NULL DEFAULT 0,
    report_too_early INTEGER NOT NULL DEFAULT 0,
    task_expired INTEGER NOT NULL DEFAULT 0,
    UNIQUE(task_id, ord)
);
"""

_ACCUMULATOR_JOURNAL_SCHEMA = """
-- Device-resident accumulator journal (executor/accumulator.py): one row
-- per (aggregation job, batch) whose FINISHED reports' out shares are
-- still resident in some replica's device accumulator (deferred drains).
-- Written in the SAME transaction as the AggregationJobWriter commit that
-- records the reports Finished; deleted by the drain transaction that
-- merges the resident delta into batch_aggregations, or by the
-- collection-time oracle replay that re-derives the shares from the
-- retained report_aggregations payloads after the owning process died.
-- An outstanding row therefore means exactly: "these reports are counted
-- but their shares are not yet in batch_aggregations".
CREATE TABLE IF NOT EXISTS accumulator_journal (
    id INTEGER PRIMARY KEY,
    task_id INTEGER NOT NULL REFERENCES tasks(id) ON DELETE CASCADE,
    batch_identifier BLOB NOT NULL,
    aggregation_param BLOB NOT NULL,
    aggregation_job_id BLOB NOT NULL,
    report_ids BLOB NOT NULL,                   -- concatenated 16-byte ids
    created_at INTEGER NOT NULL,
    UNIQUE(task_id, batch_identifier, aggregation_param, aggregation_job_id)
);
CREATE INDEX IF NOT EXISTS accumulator_journal_by_batch
    ON accumulator_journal(task_id, batch_identifier);
"""

_TRACE_CONTEXT_SCHEMA = """
-- Cross-process trace correlation (core/trace.py): a W3C-style
-- 32-hex trace id minted at job creation (leader) or inherited from the
-- peer's traceparent header (helper), carried on every lease acquisition
-- so any replica stepping the job binds the same id into its logs and
-- chrome-trace spans.  TEXT, nullable: rows from older schema versions
-- simply have no trace.
ALTER TABLE aggregation_jobs ADD COLUMN trace_id TEXT;
ALTER TABLE collection_jobs ADD COLUMN trace_id TEXT;
"""

_UPLOAD_TRACE_SCHEMA = """
-- Upload-minted trace ids (core/trace.py): the client-ingress
-- hop of cross-process correlation.  handle_upload adopts a strict-hex
-- client ``traceparent`` (or mints a fresh 32-hex id when the header is
-- absent/malformed) and the report writer persists it here, so the
-- aggregation-job creator can link each job's span back to the upload
-- traces of the reports it packs — one merged timeline from client
-- ingress through prepare to collection.  TEXT, nullable: rows from
-- older schema versions simply have no upload trace.
ALTER TABLE client_reports ADD COLUMN trace_id TEXT;
"""

_FLEET_MEMBERS_SCHEMA = """
-- Fleet control plane membership (core/fleet.py): one row per
-- registered driver replica, heartbeat-refreshed on the replica's
-- heartbeat cadence.  The LIVE member set (heartbeat within the TTL) is
-- the rendezvous-hash domain for task -> replica routing; a member whose
-- heartbeat goes stale simply drops out of the set, which re-routes its
-- tasks to the survivors (migration) with no coordination beyond this
-- table.  ``role`` scopes membership per job type (aggregation vs
-- collection drivers are separate rendezvous domains — a collection
-- replica must never absorb ownership of aggregation acquisition).
-- ``suspect_peers`` is the fleet-shared suspect set: a JSON array of
-- peer origins this replica's in-memory tracker currently holds SUSPECT,
-- republished (or emptied, on heal) with every heartbeat so replicas
-- that never talked to a partitioned peer skip its tasks too;
-- ``suspect_updated_at`` bounds its staleness on the consumer side.
CREATE TABLE IF NOT EXISTS fleet_members (
    replica_id TEXT PRIMARY KEY,
    role TEXT NOT NULL,
    heartbeat INTEGER NOT NULL,
    started_at INTEGER NOT NULL,
    suspect_peers TEXT,
    suspect_updated_at INTEGER
);
CREATE INDEX IF NOT EXISTS fleet_members_by_role
    ON fleet_members(role, heartbeat);
"""

_REPORT_JOURNAL_SCHEMA = """
-- Write-behind report journal (core/ingest.py): one row per
-- report that has been ACKed to its client but whose authoritative
-- client_reports row is not yet materialized.  The journaled ingest mode
-- commits THIS row on the upload critical path (the durability ACK) and
-- defers the client_reports insert to a bounded background materializer
-- (write-behind for the aggregation-visibility path, never for the ACK).
-- An outstanding row therefore means exactly: "this report was accepted
-- and counted, but client_reports does not know it yet" — crash replay
-- (and the surviving replicas' creators, for the migration handoff)
-- materialize or consume it, and the report_success counter was already
-- incremented by the journal-flush transaction, so neither path touches
-- counters.  Columns mirror client_reports verbatim; leader_input_share
-- is encrypted under the SAME ("client_reports", task||report,
-- "leader_input_share") AAD so materialization is a ciphertext column
-- copy — no decrypt/re-encrypt round-trip on the background path.
CREATE TABLE IF NOT EXISTS report_journal (
    id INTEGER PRIMARY KEY,
    task_id INTEGER NOT NULL REFERENCES tasks(id) ON DELETE CASCADE,
    report_id BLOB NOT NULL,
    client_timestamp INTEGER NOT NULL,
    extensions BLOB,
    public_share BLOB,
    leader_input_share BLOB,                    -- encrypted (client_reports AAD)
    helper_encrypted_input_share BLOB,
    trace_id TEXT,
    created_at INTEGER NOT NULL,
    UNIQUE(task_id, report_id)
);
CREATE INDEX IF NOT EXISTS report_journal_by_task
    ON report_journal(task_id, client_timestamp);
"""

_QUARANTINE_SCHEMA = """
-- Blast-radius isolation (core/quarantine.py).
--
-- quarantined_reports: the durable offender ledger.  A row means a report
-- (or durable journal row) was pulled out of a vectorized cohort — poison
-- isolated by batch bisection, or a CRC32C checksum failure at journal
-- materialize/replay — so the healthy remainder could proceed.  `task` is
-- the hex task id (TEXT: executor stages may only know an opaque task
-- label); `report_id` is NULL for offenders with no per-report identity
-- (combine rows, torn journal rows whose id column itself is suspect).
-- The UNIQUE index + ON CONFLICT DO NOTHING writes make recording
-- idempotent across replays and client retries of the same poison report.
CREATE TABLE IF NOT EXISTS quarantined_reports (
    id INTEGER PRIMARY KEY,
    task TEXT,
    report_id BLOB,
    stage TEXT NOT NULL,
    error_class TEXT NOT NULL,
    payload_digest TEXT,
    created_at INTEGER NOT NULL
);
CREATE UNIQUE INDEX IF NOT EXISTS quarantined_reports_dedupe
    ON quarantined_reports(task, report_id, stage);
CREATE INDEX IF NOT EXISTS quarantined_reports_by_stage
    ON quarantined_reports(stage, created_at);

-- row_crc: CRC32C over a length-prefixed concatenation of the row's
-- payload columns, computed at write time and verified at materialize /
-- replay / readback.  NULL marks a pre-migration row (accepted
-- unverified — the checksum cannot be retrofitted without the plaintext).
ALTER TABLE report_journal ADD COLUMN row_crc INTEGER;
ALTER TABLE accumulator_journal ADD COLUMN row_crc INTEGER;
"""

_JOURNAL_DRAIN_INTERVAL_SCHEMA = """
-- The owner's cadence: drain_interval_s is the deferred-drain interval of
-- the accumulator that holds the row's shares.  A collection step leaves a
-- row younger than a few of these intervals to that owner's drain and
-- replays only older rows (the owner is presumed dead).  NULL marks a
-- pre-migration row, replayed at once as before.
ALTER TABLE accumulator_journal ADD COLUMN drain_interval_s REAL;
"""

#: MIGRATIONS[k]: DDL taking schema version k -> k+1.  Append-only — never
#: edit an entry that has shipped (existing stores have already applied it).
MIGRATIONS = [
    _INITIAL_SCHEMA,
    _ACCUMULATOR_JOURNAL_SCHEMA,
    _TRACE_CONTEXT_SCHEMA,
    _UPLOAD_TRACE_SCHEMA,
    _FLEET_MEMBERS_SCHEMA,
    _REPORT_JOURNAL_SCHEMA,
    _QUARANTINE_SCHEMA,
    _JOURNAL_DRAIN_INTERVAL_SCHEMA,
]

SCHEMA_VERSION = len(MIGRATIONS)

#: Versions this build can operate against without migrating.
SUPPORTED_SCHEMA_VERSIONS = (SCHEMA_VERSION,)

#: Back-compat alias (full schema for a fresh store at version 1).
SCHEMA = _INITIAL_SCHEMA
