"""Global HPKE key rotation for the aggregator binary.

The analog of the reference aggregator's global-HPKE-key lifecycle
(reference: aggregator/src/binaries/aggregator.rs:31-150 runs the
long-lived maintenance loops beside the server; key states and their cache
propagation are aggregator_core/src/datastore/models.rs HpkeKeyState +
aggregator/src/cache.rs GlobalHpkeKeypairCache).  One rotator tick drives
the state machine inside a single transaction:

  bootstrap:  no keys at all -> insert one directly as ACTIVE
  pre-stage:  newest ACTIVE older than (active_duration - pending_duration)
              -> insert a PENDING key.  The pending window exists so every
              replica's refreshed key cache holds the key BEFORE it is
              advertised/attached to new tasks (cache.py refresh cadence).
  promote:    PENDING key older than pending_duration -> ACTIVE
  retire:     ACTIVE key older than (active_duration + pending_duration),
              while a newer ACTIVE exists -> EXPIRED.  The extra
              pending_duration keeps BOTH keys advertised across the
              promotion, so clients that fetched /hpke_config just before
              it never race the flip.
  reap:       EXPIRED key older than expired_duration -> deleted (task
              copies of the keypair keep decrypting in-flight reports).

Every transition is clock-driven and idempotent, so N replicas may run the
rotator concurrently against the shared datastore: serialization-failure
retries cover state flips, and an insert race on a fresh config id (two
replicas staging the same slot — a unique violation, which run_tx does NOT
retry) is swallowed as success since the losing tick's goal already holds.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

from ..core import faults
from ..core.db_health import janitor_skip as _janitor_skip
from ..core.hpke import HpkeKeypair
from ..datastore.datastore import Datastore, TxConflict
from ..datastore.models import HpkeKeyState
from ..messages import Duration

logger = logging.getLogger("janus_tpu.key_rotator")


@dataclass
class KeyRotatorConfig:
    # Defaults mirror a conservative deployment: new key staged a day before
    # rotation, keys live a week, expired keys reaped after another day.
    pending_duration: Duration = Duration(86400)
    active_duration: Duration = Duration(7 * 86400)
    expired_duration: Duration = Duration(86400)


class HpkeKeyRotator:
    def __init__(self, datastore: Datastore, config: KeyRotatorConfig = None):
        self.datastore = datastore
        self.config = config or KeyRotatorConfig()

    async def run(self) -> None:
        if _janitor_skip("key_rotator"):
            return
        try:
            await self.datastore.run_tx_async("key_rotator", self._tick)
        except TxConflict:
            # Another replica's rotator inserted the same config id in a
            # concurrent tick (run_tx does not retry unique violations).
            # The tick's goal — a key exists in that slot — is satisfied.
            logger.info("key rotator tick lost an insert race; treating as done")

    def run_sync(self) -> None:
        if _janitor_skip("key_rotator"):
            return
        try:
            self.datastore.run_tx("key_rotator", self._tick)
        except TxConflict:
            logger.info("key rotator tick lost an insert race; treating as done")

    def _next_config_id(self, keypairs) -> int:
        used = {kp.config.id for kp in keypairs}
        for cid in range(256):
            if cid not in used:
                return cid
        raise RuntimeError("all 256 HPKE config ids in use")

    def _tick(self, tx) -> None:
        # Failure-domain boundary: a rotator tick dying mid-transition must
        # roll back atomically (every transition is clock-driven and
        # idempotent, so the next tick simply redoes it).
        faults.fire("key_rotator.run")
        now = self.datastore.clock.now().seconds
        cfg = self.config
        keypairs = tx.get_global_hpke_keypairs()

        if not keypairs:
            kp = HpkeKeypair.generate(self._next_config_id(keypairs))
            tx.put_global_hpke_keypair(kp)
            tx.set_global_hpke_keypair_state(kp.config.id, HpkeKeyState.ACTIVE)
            logger.info("bootstrapped global HPKE key %d as Active", kp.config.id)
            return

        by_state = {}
        for kp in keypairs:
            by_state.setdefault(kp.state, []).append(kp)
        active = sorted(
            by_state.get(HpkeKeyState.ACTIVE, []), key=lambda k: k.updated_at.seconds
        )
        pending = sorted(
            by_state.get(HpkeKeyState.PENDING, []), key=lambda k: k.updated_at.seconds
        )

        # promote: pending long enough for caches/clients to have seen it.
        for kp in list(pending):
            if now - kp.updated_at.seconds >= cfg.pending_duration.seconds:
                tx.set_global_hpke_keypair_state(kp.config.id, HpkeKeyState.ACTIVE)
                logger.info("promoted global HPKE key %d to Active", kp.config.id)
                active.append(kp)
                pending.remove(kp)

        # pre-stage: newest active approaching rotation and nothing pending.
        if active and not pending:
            newest = max(kp.updated_at.seconds for kp in active)
            if now - newest >= cfg.active_duration.seconds - cfg.pending_duration.seconds:
                kp = HpkeKeypair.generate(self._next_config_id(keypairs))
                tx.put_global_hpke_keypair(kp)  # inserted as Pending
                logger.info("staged global HPKE key %d as Pending", kp.config.id)

        # retire: old actives, but never the most recent one, and only after
        # a pending_duration of overlap with its replacement (clients that
        # fetched /hpke_config just before the promotion keep a valid key).
        if len(active) > 1:
            newest_id = max(active, key=lambda k: k.updated_at.seconds).config.id
            retire_age = cfg.active_duration.seconds + cfg.pending_duration.seconds
            for kp in active:
                if kp.config.id != newest_id and now - kp.updated_at.seconds >= retire_age:
                    tx.set_global_hpke_keypair_state(
                        kp.config.id, HpkeKeyState.EXPIRED
                    )
                    logger.info("expired global HPKE key %d", kp.config.id)

        # reap: expired keys past the decrypt grace period.
        for kp in by_state.get(HpkeKeyState.EXPIRED, []):
            if now - kp.updated_at.seconds >= cfg.expired_duration.seconds:
                tx.delete_global_hpke_keypair(kp.config.id)
                logger.info("deleted expired global HPKE key %d", kp.config.id)
