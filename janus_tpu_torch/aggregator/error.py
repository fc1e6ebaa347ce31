"""Aggregator error taxonomy → DAP problem documents.

The analog of the reference's error enum + report rejection reasons
(reference: aggregator/src/aggregator/error.rs:220, problem_details.rs).
Each error carries the DapProblemType it maps to at the HTTP boundary.
"""

from __future__ import annotations

import json
from typing import Dict, Optional, Tuple

from ..messages.problem_type import DapProblemType, problem_document

PROBLEM_CONTENT_TYPE = "application/problem+json"


class AggregatorError(Exception):
    """Base; ``problem`` is None for internal (500) errors."""

    problem: Optional[DapProblemType] = None
    status = 500
    #: seconds for a Retry-After header on the response (None = no
    #: header).  The leader's retry_http_request honors it — capped at
    #: its policy's max interval — so helper-side backpressure shapes
    #: the peer's backoff instead of blind exponential sleeps.
    retry_after: Optional[int] = None

    def __init__(self, detail: str = ""):
        super().__init__(detail)
        self.detail = detail


class ServiceUnavailable(AggregatorError):
    """Transient capacity exhaustion (device executor backpressure): the
    peer should retry — 503 lands in the leader's retryable (>= 500)
    classification, so the lease machinery redelivers the job."""

    status = 503
    retry_after = 1


class UploadShed(ServiceUnavailable):
    """Front-door load shedding: the bounded upload queue is
    past its depth or delay budget, so this report is refused BEFORE any
    datastore or crypto work with the DAP-retryable 503 + Retry-After —
    overload becomes client retry pressure instead of event-loop
    collapse.  Counted in janus_upload_shed_total."""


class UnrecognizedTask(AggregatorError):
    problem = DapProblemType.UNRECOGNIZED_TASK
    status = 404


class UnrecognizedAggregationJob(AggregatorError):
    problem = DapProblemType.UNRECOGNIZED_AGGREGATION_JOB
    status = 404


class UnrecognizedCollectionJob(AggregatorError):
    problem = None
    status = 404


class UnauthorizedRequest(AggregatorError):
    problem = DapProblemType.UNAUTHORIZED_REQUEST
    status = 403


class InvalidMessage(AggregatorError):
    problem = DapProblemType.INVALID_MESSAGE
    status = 400


class UnsupportedExtension(AggregatorError):
    problem = DapProblemType.INVALID_MESSAGE
    status = 400


class StepMismatch(AggregatorError):
    problem = DapProblemType.STEP_MISMATCH
    status = 400


class RoundMismatch(AggregatorError):
    problem = DapProblemType.STEP_MISMATCH
    status = 400


class OutdatedHpkeConfig(AggregatorError):
    problem = DapProblemType.OUTDATED_CONFIG
    status = 400


class ReportRejectedError(AggregatorError):
    problem = DapProblemType.REPORT_REJECTED
    status = 400


class ReportTooEarly(AggregatorError):
    problem = DapProblemType.REPORT_TOO_EARLY
    status = 400


class BatchInvalid(AggregatorError):
    problem = DapProblemType.BATCH_INVALID
    status = 400


class InvalidBatchSize(AggregatorError):
    problem = DapProblemType.INVALID_BATCH_SIZE
    status = 400


class BatchMismatch(AggregatorError):
    problem = DapProblemType.BATCH_MISMATCH
    status = 400


class QueryMismatch(AggregatorError):
    problem = DapProblemType.BATCH_INVALID
    status = 400


class BatchQueriedTooManyTimes(AggregatorError):
    problem = DapProblemType.BATCH_QUERIED_TOO_MANY_TIMES
    status = 400


class BatchOverlap(AggregatorError):
    problem = DapProblemType.BATCH_OVERLAP
    status = 400


class ForbiddenMutation(AggregatorError):
    """Idempotency violation: same id, different request content
    (reference: aggregator/src/aggregator/error.rs ForbiddenMutation)."""

    problem = None
    status = 409


class DeletedCollectionJob(AggregatorError):
    problem = None
    status = 204


class ReportRejection(Exception):
    """Upload-path rejection with its counter category
    (reference: aggregator/src/aggregator/error.rs:220 ReportRejectionReason)."""

    # categories match TaskUploadCounter columns
    INTERVAL_COLLECTED = "interval_collected"
    DECODE_FAILURE = "report_decode_failure"
    DECRYPT_FAILURE = "report_decrypt_failure"
    EXPIRED = "report_expired"
    OUTDATED_KEY = "report_outdated_key"
    TOO_EARLY = "report_too_early"
    TASK_EXPIRED = "task_expired"

    def __init__(self, category: str, detail: str = ""):
        super().__init__(detail)
        self.category = category
        self.detail = detail

    def to_error(self) -> AggregatorError:
        if self.category == self.TOO_EARLY:
            return ReportTooEarly(self.detail)
        if self.category == self.OUTDATED_KEY:
            return OutdatedHpkeConfig(self.detail)
        return ReportRejectedError(self.detail)


def problem_response(err: AggregatorError, task_id=None) -> Tuple[int, bytes, Dict[str, str]]:
    """(status, body, headers) an AggregatorError answers with at the HTTP
    boundary: an RFC 7807 problem document where it maps to a DAP problem
    type, else its detail as text, and Retry-After where it carries one.
    ``dispatch.dispatch`` answers every refusal through it."""
    headers = {"Retry-After": str(err.retry_after)} if err.retry_after is not None else {}
    if err.problem is None:
        headers["Content-Type"] = "text/plain; charset=utf-8"
        return err.status, (err.detail or "").encode(), headers
    doc = problem_document(err.problem, task_id=task_id, detail=err.detail or None)
    headers["Content-Type"] = PROBLEM_CONTENT_TYPE
    return err.status, json.dumps(doc).encode(), headers
