"""DAP problem types (RFC 7807 problem-details URNs).

reference: messages/src/problem_type.rs:7 and the HTTP error mapping in
aggregator/src/aggregator/problem_details.rs.
"""

from __future__ import annotations

from enum import Enum


class DapProblemType(Enum):
    INVALID_MESSAGE = ("invalidMessage", "The message type for a response was incorrect or the payload was malformed.")
    UNRECOGNIZED_TASK = ("unrecognizedTask", "An endpoint received a message with an unknown task ID.")
    STEP_MISMATCH = ("stepMismatch", "The leader and helper are not on the same step of VDAF preparation.")
    MISSING_TASK_ID = ("missingTaskID", "HPKE configuration was requested without specifying a task ID.")
    UNRECOGNIZED_AGGREGATION_JOB = ("unrecognizedAggregationJob", "An endpoint received a message with an unknown aggregation job ID.")
    OUTDATED_CONFIG = ("outdatedConfig", "The message was generated using an outdated configuration.")
    REPORT_REJECTED = ("reportRejected", "Report could not be processed.")
    REPORT_TOO_EARLY = ("reportTooEarly", "Report could not be processed because it arrived too early.")
    BATCH_INVALID = ("batchInvalid", "The batch implied by the query is invalid.")
    INVALID_BATCH_SIZE = ("invalidBatchSize", "The number of reports included in the batch is invalid.")
    BATCH_QUERIED_TOO_MANY_TIMES = ("batchQueriedTooManyTimes", "The batch described by the query has been queried too many times.")
    BATCH_MISMATCH = ("batchMismatch", "Leader and helper disagree on reports aggregated in a batch.")
    UNAUTHORIZED_REQUEST = ("unauthorizedRequest", "The request's authorization is not valid.")
    BATCH_OVERLAP = ("batchOverlap", "The queried batch overlaps with a previously queried batch.")
    INVALID_TASK = ("invalidTask", "Aggregator has opted out of the indicated task.")

    @property
    def type_uri(self) -> str:
        return f"urn:ietf:params:ppm:dap:error:{self.value[0]}"

    @property
    def description(self) -> str:
        return self.value[1]

    @classmethod
    def from_uri(cls, uri: str) -> "DapProblemType":
        for v in cls:
            if v.type_uri == uri:
                return v
        raise ValueError(f"unknown DAP problem type {uri}")


def problem_document(problem_type: DapProblemType, task_id=None, detail=None) -> dict:
    """RFC 7807 JSON body the DAP HTTP layer returns on errors
    (reference: aggregator/src/aggregator/problem_details.rs)."""
    doc = {
        "type": problem_type.type_uri,
        "title": problem_type.description,
    }
    if detail is not None:
        doc["detail"] = detail
    if task_id is not None:
        doc["taskid"] = str(task_id)
    return doc
