"""Device executor: process-wide continuous cross-job batching.

Copy of ``janus_tpu/executor`` for the PyTorch port.  See service.py for
the design.  Importing this package does NOT import torch — control-plane
processes can hold an ExecutorConfig (and the
overload / circuit-breaker error types for retry classification) without
pulling in the device stack.
"""

from .accumulator import (
    AccumulatorConfig,
    AccumulatorError,
    AccumulatorUnavailable,
    DeviceAccumulatorStore,
    ResidentRef,
    StaleAccumulatorDelta,
)
from .service import (
    KIND_COMBINE,
    KIND_POPLAR_INIT,
    KIND_PREP_INIT,
    CircuitBreaker,
    CircuitOpenError,
    DeviceExecutor,
    ExecutorConfig,
    ExecutorOverloadedError,
    breaker_domain,
    bucket_label,
    shape_label,
)

__all__ = [
    "AccumulatorConfig",
    "AccumulatorError",
    "AccumulatorUnavailable",
    "CircuitBreaker",
    "CircuitOpenError",
    "DeviceAccumulatorStore",
    "DeviceExecutor",
    "ExecutorConfig",
    "ExecutorOverloadedError",
    "KIND_COMBINE",
    "KIND_POPLAR_INIT",
    "KIND_PREP_INIT",
    "ResidentRef",
    "StaleAccumulatorDelta",
    "breaker_domain",
    "bucket_label",
    "shape_label",
]
