"""Ephemeral datastore harness for tests.

The analog of ``EphemeralDatastore``/``EphemeralDatabase`` (reference:
aggregator_core/src/datastore/test_util.rs:33-120): a throwaway database per
test with a fresh crypter key and a MockClock, so every time-driven path is
deterministic.
"""

from __future__ import annotations

import os
import tempfile
from typing import Optional

from ..core.time import Clock, MockClock
from .crypter import Crypter, generate_key
from .datastore import Datastore


class EphemeralDatastore:
    def __init__(self, clock: Optional[Clock] = None):
        fd, self.path = tempfile.mkstemp(suffix=".sqlite3", prefix="janus-tpu-test-")
        os.close(fd)
        os.unlink(self.path)  # let SQLite create it fresh
        self.clock = clock if clock is not None else MockClock()
        #: raw crypter key, kept so cross-process tests (chaos soaks
        #: spawning replica binaries against this store) can export it
        #: as DATASTORE_KEYS
        self.key = generate_key()
        self.crypter = Crypter([self.key])
        self.datastore = Datastore(self.path, self.crypter, self.clock)

    def __enter__(self) -> Datastore:
        return self.datastore

    def __exit__(self, *exc) -> None:
        self.cleanup()

    def cleanup(self) -> None:
        self.datastore.close()
        for suffix in ("", "-wal", "-shm"):
            try:
                os.unlink(self.path + suffix)
            except FileNotFoundError:
                pass
