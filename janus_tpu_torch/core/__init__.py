"""Shared kernel glue: HPKE, auth tokens, checksums, clock, retries.

The analog of the reference's ``janus_core`` crate (reference: core/src/).
"""

from .auth_tokens import (
    DAP_AUTH_HEADER,
    AuthenticationToken,
    AuthenticationTokenHash,
    extract_bearer_token,
)
from .hpke import (
    HpkeApplicationInfo,
    HpkeError,
    HpkeKeypair,
    Label,
    is_hpke_config_supported,
    open_,
    seal,
)
from .report_id import (
    checksum_combined,
    checksum_for_report_id,
    checksum_updated_with,
)
from .time import (
    Clock,
    MockClock,
    RealClock,
    interval_contains_interval,
    interval_merge,
    intervals_overlap,
    time_add,
    time_difference,
    time_is_after,
    time_sub,
    time_to_batch_interval,
    time_to_batch_interval_start,
)

__all__ = [n for n in dir() if not n.startswith("_")]
