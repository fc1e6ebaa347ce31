"""Fleet control plane: replica membership, task routing, live migration.

Janus scales by running N stateless replicas that coordinate only through
the shared datastore (PAPER.md: "all communication between components
happens implicitly through the database"), but without routing every
replica re-derives every task's compile cache, warmup ledger, and
device-resident accumulator.  This module is the missing tier (ROADMAP
direction 2): each driver binary registers a replica id with a heartbeat
row in ``fleet_members``, rendezvous-hashes ``task_id -> replica`` over
the live member set, and the acquisition path filters to owned tasks —
so each replica compiles and warms only its own tasks' shapes, and adding
a replica shrinks every replica's working set instead of duplicating it.

Design points:

- **Rendezvous (highest-random-weight) hashing** rather than a ring:
  deterministic from (member set, task_id) alone — no state to agree on
  beyond the membership table — and a membership change moves only the
  tasks whose highest-weight member changed (minimal reshuffle).
- **Membership = heartbeat rows.**  A member is live iff its heartbeat is
  within ``heartbeat_ttl_s`` of tx-time.  Liveness is judged per-reader;
  there is no coordinator.  A replica always counts *itself* live in its
  own view (a wedged local heartbeat must degrade toward too-much work,
  never toward "I own nothing" self-eviction); brief double-ownership
  during disagreement is safe because job leases still serialize.
- **Per-role domains.**  Aggregation and collection drivers register with
  distinct roles and hash over same-role members only — a collection
  replica must never absorb *ownership* of aggregation acquisition (the
  jobs would strand: it never acquires them).
- **Migration** is emergent: when an owner's heartbeat goes stale, it
  drops out of every survivor's live set and its tasks re-route.  The
  router counts owner transitions toward itself
  (``janus_fleet_migrations_total``) and applies ``takeover_grace_s``
  before acquiring a freshly-absorbed task, so an owner that was merely
  slow to heartbeat (or whose lease is in flight) gets a window to
  finish/resume before the new owner starts pulling its jobs.
- **Migration-storm suppression.**  Heartbeat liveness is only
  trustworthy while the datastore it lives in is: a brownout makes every
  member's row stale *simultaneously*, which is indistinguishable from
  mass death.  When the local datastore tracker (core/db_health.py) is
  suspect, or more than ``mass_staleness_fraction`` of previously-live
  same-role members go stale in one refresh, the router FREEZES its
  last-known ownership view — no takeovers, no releases — and counts
  ``janus_fleet_migration_suppressed_total``; it thaws only after the
  tracker heals and a full heartbeat TTL confirms the staleness was
  real.  See README "Datastore brownout tolerance".
- **Fleet-shared suspects.**  Each heartbeat republishes the origins this
  replica's peer-health tracker currently holds SUSPECT onto its member
  row; ``shared_suspects`` unions fresh advertisements from *other* live
  members so a replica that never talked to a partitioned peer also skips
  its tasks.  A healed peer un-publishes by advertising the empty set,
  and ``suspect_staleness_s`` bounds how long a stale advertisement is
  honored (a dead advertiser must not suspect-pin a healthy peer forever).

Everything is off unless ``fleet.enabled`` is set in config:
``fleet_router()`` returns None and the drivers' acquisition filter
reduces to the single-process suspect filter, bit-for-bit.
"""

from __future__ import annotations

import hashlib
import os
import secrets
import socket
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Set

from ..messages import Duration
from .metrics import GLOBAL_METRICS

#: Separator between member id and task id in the rendezvous digest input —
#: prevents ambiguity between ("ab", "c"||task) and ("a", "bc"||task).
_SEP = b"\x00"


def rendezvous_owner(task_id: bytes, members: Sequence[str]) -> Optional[str]:
    """Highest-random-weight owner of ``task_id`` among ``members``.

    Deterministic in the *set* (order-independent); ties — impossible in
    practice for SHA-256, but defined anyway — break toward the lexically
    larger member id so every caller agrees.
    """
    best: Optional[str] = None
    best_digest = b""
    for member in members:
        digest = hashlib.sha256(member.encode() + _SEP + task_id).digest()
        if best is None or digest > best_digest or (
            digest == best_digest and member > best  # type: ignore[operator]
        ):
            best, best_digest = member, digest
    return best


def default_replica_id() -> str:
    """hostname-pid-nonce: unique per process start, stable within one."""
    host = socket.gethostname().split(".")[0] or "replica"
    return f"{host}-{os.getpid()}-{secrets.token_hex(3)}"


class FleetRouter:
    """One replica's view of the fleet: membership, ownership, migration.

    Instantiable (tests run several routers against one datastore in one
    process); the module-level singleton below is only the binaries'
    default.  All datastore access takes a live Transaction so ownership
    decisions commit atomically with the acquisition they filter.
    """

    #: Rows with a heartbeat older than this many TTLs are pruned
    #: opportunistically during heartbeats — dead replicas that never
    #: deregistered.  Well past any takeover window, so pruning never
    #: races a routing decision.
    PRUNE_TTLS = 10

    def __init__(
        self,
        replica_id: str,
        role: str,
        *,
        heartbeat_ttl_s: float = 10.0,
        takeover_grace_s: float = 5.0,
        suspect_staleness_s: float = 30.0,
        mass_staleness_fraction: float = 0.5,
        enabled: bool = True,
    ):
        self.replica_id = replica_id
        self.role = role
        self.heartbeat_ttl_s = float(heartbeat_ttl_s)
        self.takeover_grace_s = float(takeover_grace_s)
        self.suspect_staleness_s = float(suspect_staleness_s)
        #: migration-storm trigger: if MORE than this fraction of the
        #: previously-live same-role members (excluding self — self is
        #: live by fiat and would dilute the signal) go stale in one
        #: refresh, the staleness is treated as correlated (datastore
        #: brownout, not mass death) and the ownership view freezes.
        self.mass_staleness_fraction = float(mass_staleness_fraction)
        self.enabled = enabled
        self._lock = threading.Lock()
        self._last_owner: Dict[bytes, str] = {}
        self._takeover_at: Dict[bytes, int] = {}
        self._migrations = 0
        self._tasks_owned = 0
        self._last_heartbeat_s: Optional[int] = None
        self._members_snapshot: List[dict] = []
        # -- migration-storm suppression state --------------
        #: live set as of the last UNSUPPRESSED refresh — the baseline
        #: the mass-staleness quorum check compares against
        self._prev_live: Optional[Set[str]] = None
        #: exclusion list as of the last unsuppressed refresh — what a
        #: suppressed refresh serves instead of recomputing ownership
        self._frozen_exclusions: Optional[List[bytes]] = None
        self._suppressed = False
        self._suppress_reason: Optional[str] = None
        self._suppressed_total = 0
        #: tx-time when thaw confirmation began: suppression lifts only
        #: after the datastore tracker is healthy AND a full heartbeat
        #: TTL passes with the trigger still absent — so staleness that
        #: was just brownout shadow (members heartbeat again the moment
        #: the datastore heals) never causes a takeover
        self._thaw_started_s: Optional[int] = None

    # -- membership ----------------------------------------------------

    def heartbeat(self, tx, suspect_origins: Iterable[str] = ()) -> None:
        """Refresh this replica's member row (registering it if absent),
        republish its suspect set, and snapshot the membership view for
        /statusz.  Called on the heartbeat cadence AND once synchronously
        at driver startup (registration must precede warmup so the first
        ownership computation already sees this replica)."""
        if not self.enabled:
            return
        tx.upsert_fleet_member(self.replica_id, self.role, list(suspect_origins))
        tx.prune_fleet_members(
            Duration(int(self.PRUNE_TTLS * self.heartbeat_ttl_s) + 1)
        )
        now = tx._now_s()
        snapshot = []
        live_count = 0
        for m in tx.get_fleet_members():
            age = max(0, now - m.heartbeat.seconds)
            live = m.replica_id == self.replica_id or age <= self.heartbeat_ttl_s
            if live and m.role == self.role:
                live_count += 1
            snapshot.append(
                {
                    "replica_id": m.replica_id,
                    "role": m.role,
                    "heartbeat_age_s": age,
                    "live": live,
                    "suspect_peers": list(m.suspect_peers),
                }
            )
        with self._lock:
            self._last_heartbeat_s = now
            self._members_snapshot = snapshot
        GLOBAL_METRICS.fleet_members.set(live_count)

    def deregister(self, tx) -> None:
        """Graceful shutdown: drop out of the rendezvous domain now
        instead of after the TTL, so survivors re-route immediately."""
        if self.enabled:
            tx.delete_fleet_member(self.replica_id)

    def _live_members(self, tx) -> List[str]:
        now = tx._now_s()
        live = {
            m.replica_id
            for m in tx.get_fleet_members(self.role)
            if now - m.heartbeat.seconds <= self.heartbeat_ttl_s
        }
        live.add(self.replica_id)  # self-eviction is never the right failure mode
        return sorted(live)

    # -- migration-storm suppression ------------------------

    def _suppression_verdict_locked(self, live: Set[str], now: int) -> Optional[str]:
        """Should this refresh be served from the frozen ownership view?
        Returns the reason string, or None to compute live.  Caller holds
        ``self._lock``.

        Triggers: the local datastore tracker says suspect/probing (a
        brownout makes every heartbeat row stale at once — trusting the
        table would start a migration storm), or at least two AND more
        than ``mass_staleness_fraction`` of the previously-live
        same-role members went stale since the last unsuppressed refresh
        (the correlated-staleness signature, caught even when this
        replica's own transactions happened to sail through).

        Thaw: once the tracker is healthy, suppression holds for one
        more full heartbeat TTL — members that were only brownout-shadow
        stale heartbeat again within it and the thawed refresh routes
        exactly as before; members still stale after it are genuinely
        dead and their tasks migrate for real.
        """
        from .db_health import tracker as db_tracker

        if db_tracker().is_suspect():
            self._thaw_started_s = None  # heal restarts the confirmation
            return "datastore_suspect"
        if self._suppressed:
            if self._thaw_started_s is None:
                self._thaw_started_s = now
            if now - self._thaw_started_s < self.heartbeat_ttl_s:
                return self._suppress_reason or "thaw_confirmation"
            return None  # confirmed: thaw this refresh
        prev = self._prev_live
        if prev:
            others = prev - {self.replica_id}
            stale = others - live
            # a storm needs PLURAL simultaneous staleness: one dead peer
            # is the normal single-failure takeover (2-replica fleets
            # rely on the datastore-suspect trigger instead — in a real
            # brownout this replica's own transactions fail too)
            if (
                len(stale) >= 2
                and len(stale) / len(others) > self.mass_staleness_fraction
            ):
                return "mass_staleness"
        return None

    # -- routing -------------------------------------------------------

    def not_owned_task_ids(self, tx) -> Optional[List[bytes]]:
        """Task ids this replica must NOT acquire right now: tasks owned
        by another live member, plus tasks absorbed so recently that the
        takeover grace window is still open.  Returns None (no filter)
        when disabled or when nothing is excluded.

        Also the migration detector: an ownership transition from another
        member to this one increments ``janus_fleet_migrations_total`` and
        opens the grace window.  While migration-storm suppression is
        active the FROZEN exclusion list is returned instead — no
        takeovers, no releases, no ``_last_owner`` churn — and
        ``janus_fleet_migration_suppressed_total`` counts the refresh.
        """
        if not self.enabled:
            return None
        live = self._live_members(tx)
        now = tx._now_s()
        frozen: Optional[List[bytes]] = None
        with self._lock:
            reason = self._suppression_verdict_locked(set(live), now)
            if reason is not None and self._frozen_exclusions is not None:
                self._suppressed = True
                self._suppress_reason = reason
                self._suppressed_total += 1
                frozen = list(self._frozen_exclusions)
            # reason with no frozen view (cold start): nothing useful to
            # freeze to — compute live below, which also seeds the view
        if frozen is not None:
            GLOBAL_METRICS.fleet_migration_suppressed.inc()
            return frozen or None
        excluded: List[bytes] = []
        owned = 0
        migrations = 0
        with self._lock:
            for task_id, _peer in tx.get_task_peer_index():
                owner = rendezvous_owner(task_id, live)
                prev = self._last_owner.get(task_id)
                if owner == self.replica_id:
                    if prev is not None and prev != self.replica_id:
                        migrations += 1
                        self._takeover_at[task_id] = now
                    taken_at = self._takeover_at.get(task_id)
                    if (
                        taken_at is not None
                        and now - taken_at < self.takeover_grace_s
                    ):
                        excluded.append(task_id)
                    else:
                        self._takeover_at.pop(task_id, None)
                        owned += 1
                else:
                    excluded.append(task_id)
                if owner is not None:
                    self._last_owner[task_id] = owner
            self._migrations += migrations
            self._tasks_owned = owned
            # an unsuppressed refresh is the new baseline: what a future
            # suppressed refresh freezes to, and what the mass-staleness
            # check compares against
            self._prev_live = set(live)
            self._frozen_exclusions = list(excluded)
            self._suppressed = False
            self._suppress_reason = None
            self._thaw_started_s = None
        if migrations:
            GLOBAL_METRICS.fleet_migrations.inc(migrations)
        GLOBAL_METRICS.fleet_tasks_owned.set(owned)
        return excluded or None

    def owns(self, tx, task_id: bytes) -> bool:
        """Pure ownership test (no migration/grace bookkeeping)."""
        if not self.enabled:
            return True
        return rendezvous_owner(task_id, self._live_members(tx)) == self.replica_id

    def filter_owned(self, tx, tasks):
        """Warmup filter: of ``tasks`` (AggregatorTask), the ones this
        replica owns — so a replica only compiles/warms its own tasks'
        shapes (the cache-affinity payoff, observable via compile_stats)."""
        if not self.enabled:
            return list(tasks)
        live = self._live_members(tx)
        return [
            t for t in tasks
            if rendezvous_owner(t.task_id.data, live) == self.replica_id
        ]

    # -- fleet-shared suspect set --------------------------------------

    def shared_suspects(self, tx) -> Set[str]:
        """Peer origins advertised suspect by OTHER live members with a
        fresh-enough advertisement.  Consumed beside the in-memory peer
        tracker in ``suspect_task_ids`` — fleet-wide partition awareness
        without every replica having to probe the peer itself."""
        if not self.enabled:
            return set()
        now = tx._now_s()
        out: Set[str] = set()
        for m in tx.get_fleet_members():
            if m.replica_id == self.replica_id:
                continue
            if now - m.heartbeat.seconds > self.heartbeat_ttl_s:
                continue  # dead advertiser: ignore
            if (
                m.suspect_updated_at is None
                or now - m.suspect_updated_at.seconds > self.suspect_staleness_s
            ):
                continue  # stale advertisement: a healed peer un-pins
            out.update(m.suspect_peers)
        return out

    # -- introspection -------------------------------------------------

    def stats(self) -> dict:
        """/statusz "fleet" section payload."""
        with self._lock:
            return {
                "enabled": self.enabled,
                "replica_id": self.replica_id,
                "role": self.role,
                "heartbeat_ttl_s": self.heartbeat_ttl_s,
                "takeover_grace_s": self.takeover_grace_s,
                "mass_staleness_fraction": self.mass_staleness_fraction,
                "tasks_owned": self._tasks_owned,
                "migrations_total": self._migrations,
                "suppressed": self._suppressed,
                "suppress_reason": self._suppress_reason,
                "suppressed_refreshes_total": self._suppressed_total,
                "thaw_started_s": self._thaw_started_s,
                "last_heartbeat_s": self._last_heartbeat_s,
                "members": list(self._members_snapshot),
            }


# -- process-wide default router (the binaries' singleton; tests build
#    their own FleetRouter instances and never touch this) --------------

_ROUTER: Optional[FleetRouter] = None


def configure_fleet(
    replica_id: str,
    role: str,
    *,
    heartbeat_ttl_s: float = 10.0,
    takeover_grace_s: float = 5.0,
    suspect_staleness_s: float = 30.0,
    mass_staleness_fraction: float = 0.5,
) -> FleetRouter:
    """Install the process-wide router (once, from the driver binary)."""
    global _ROUTER
    _ROUTER = FleetRouter(
        replica_id,
        role,
        heartbeat_ttl_s=heartbeat_ttl_s,
        takeover_grace_s=takeover_grace_s,
        suspect_staleness_s=suspect_staleness_s,
        mass_staleness_fraction=mass_staleness_fraction,
    )
    return _ROUTER


def fleet_router() -> Optional[FleetRouter]:
    """The process-wide router, or None when fleet mode is off."""
    return _ROUTER


def reset_fleet() -> None:
    """Test hook: forget the process-wide router."""
    global _ROUTER
    _ROUTER = None


def fleet_shared_suspects(tx) -> Set[str]:
    """The process router's shared-suspect view; empty when fleet is off.
    Split out so job_driver.suspect_task_ids has no import-time coupling
    to whether a router exists."""
    router = _ROUTER
    if router is None:
        return set()
    return router.shared_suspects(tx)
