"""Garbage collection of expired artifacts.

The analog of ``GarbageCollector`` (reference:
aggregator/src/aggregator/garbage_collector.rs:14-204): per task with a
``report_expiry_age``, batched deletion of expired client reports,
aggregation artifacts, and collection artifacts.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Optional

from ..core import faults
from ..core.db_health import janitor_skip as _janitor_skip
from ..core.time import time_sub
from ..datastore import Datastore
from ..messages import Role

logger = logging.getLogger("janus_tpu.garbage_collector")


@dataclass
class GcConfig:
    report_limit: int = 5000
    aggregation_limit: int = 500
    collection_limit: int = 50


class GarbageCollector:
    def __init__(self, datastore: Datastore, config: Optional[GcConfig] = None):
        self.datastore = datastore
        self.config = config or GcConfig()

    async def run_once(self) -> int:
        """One GC pass over every task; returns rows deleted."""
        if _janitor_skip("gc"):
            return 0
        tasks = await self.datastore.run_tx_async(
            "gc_tasks", lambda tx: tx.get_aggregator_tasks()
        )
        deleted = 0
        for task in tasks:
            if task.report_expiry_age is None:
                continue
            try:
                deleted += await self.datastore.run_tx_async(
                    "gc_task", lambda tx, task=task: self._gc_task(tx, task)
                )
            except Exception:
                logger.exception("GC failed for task %s", task.task_id)
        return deleted

    def _gc_task(self, tx, task) -> int:
        # Failure-domain boundary: a GC pass dying mid-task must stay
        # contained (run_once's per-task try logs and moves on).
        faults.fire("gc.run")
        now = self.datastore.now()
        if now.seconds <= task.report_expiry_age.seconds:
            return 0
        expiry = time_sub(now, task.report_expiry_age)
        n = tx.delete_expired_client_reports(
            task.task_id, expiry, self.config.report_limit
        )
        n += tx.delete_expired_aggregation_artifacts(
            task.task_id, expiry, self.config.aggregation_limit
        )
        n += tx.delete_expired_collection_artifacts(
            task.task_id, expiry, self.config.collection_limit
        )
        return n
