"""Report-ID checksums: XOR of SHA-256 digests of report IDs, used for
cross-aggregator batch consistency checks.

reference: core/src/report_id.rs:7-34 (ReportIdChecksumExt).
"""

from __future__ import annotations

import hashlib

from ..messages import ReportId, ReportIdChecksum


def checksum_for_report_id(report_id: ReportId) -> ReportIdChecksum:
    return ReportIdChecksum(hashlib.sha256(report_id.data).digest())


def checksum_combined(a: ReportIdChecksum, b: ReportIdChecksum) -> ReportIdChecksum:
    return ReportIdChecksum(bytes(x ^ y for x, y in zip(a.data, b.data)))


def checksum_updated_with(
    checksum: ReportIdChecksum, report_id: ReportId
) -> ReportIdChecksum:
    return checksum_combined(checksum, checksum_for_report_id(report_id))
