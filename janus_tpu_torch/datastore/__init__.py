"""Persistence layer: the database IS the checkpoint.

The analog of the reference's ``aggregator_core`` crate: Datastore/Transaction
with lease-based work distribution, column crypto, task model, datastore
models/state machines, and query-type strategies (reference:
aggregator_core/src/{datastore.rs,task.rs,query_type.rs}, db/).
"""

from .crypter import Crypter, CrypterError, generate_key
from .datastore import (
    Datastore,
    DatastoreError,
    TaskNotFound,
    Transaction,
    TxConflict,
)
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
    LeaderStoredReport,
    Lease,
    LeaseToken,
    OutstandingBatch,
    ReportAggregation,
    ReportAggregationMetadata,
    ReportAggregationState,
    TaskUploadCounter,
)
from .query_type import (
    FixedSizeStrategy,
    TimeIntervalStrategy,
    decode_interval_identifier,
    encode_interval_identifier,
    strategy_for,
)
from .task import (
    AggregatorTask,
    TaskQueryType,
    generate_vdaf_verify_key,
    validate_vdaf_instance,
    vdaf_verify_key_length,
)

__all__ = [n for n in dir() if not n.startswith("_")]
