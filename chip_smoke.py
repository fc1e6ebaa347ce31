"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

Drives the port's paths once each, 2 shares each, over TurboSHAKE128 with
1 proof (Field128, and Field64 for Count), over HMAC-SHA256-AES128 with
2 proofs (Field64) and for Poplar1 (Field64 and Field255), and checks
them:

1. builds the CUDA kernels from ``janus_tpu_torch/csrc`` (one nvcc per
   source, all at once) and shards 64 distinct histogram reports from
   ``--seed``, while two worker processes shard the SumVec reports with the
   port's oracle (phase 4 needs them); every timed phase starts after the
   workers have ended, so none runs beside them;
2. **Histogram served path**, Prio3Histogram(length=1024, chunk_length=316)
   at B = 4096: the 64 reports tiled to 4032 rows, plus 64 rows whose
   leader measurement share is perturbed; leader
   and helper ``CudaBackend.prep_init_multi``, ``prep_shares_to_prep_batch``
   and ``aggregate_batch``; the aggregate is the exact histogram of the
   valid rows, every tampered row is rejected and 16 sampled rows equal the
   oracle's ``prep_init`` byte for byte;
3. **Histogram planar combine**: helper ``prep_init_planar(keep_planar=True)``
   and ``prep_shares_to_prep_planar`` against the leader's verifier rows as
   they arrive (K4 reads them in place) on the same staged batch; decide and
   the prep-message seed equal the served combine for all 4096 rows;
4. **SumVec100k through the backend**, Prio3SumVec(length=100000, bits=1,
   chunk_length=316) at B = 128: 2 distinct reports tiled to 120 rows plus 8
   tampered rows; the aggregate is the exact sum of the valid vectors, the
   tampered rows are rejected and one row per side per report equals the
   oracle;
5. **SumVec100k at device scale**: the staged 128 rows tiled x8 on the card
   to B = 1024 through ``BatchedPrio3`` directly; decide and the aggregate
   equal 8x those of phase 4; device time, profile and peak memory;
6. each kernel (K1 squeeze, K2 absorb, K3 histogram wires, K4 combine,
   K5 SumVec wires) at its path's shapes against its plain PyTorch version
   on the card; K1/K2 timed at the SumVec shape, and 8 of their columns
   there held against the plain version on the host; each kernel's bound
   is the largest of its bytes at the HBM rate and its integer work at the
   card's multiply, ALU and dispatch rates (``bound``), and K1/K2's also takes
   in their chain bound (``keccak_bound``); K5 also timed and checked at the
   served batch, B = 128, and K4 at B = 128 and 33; K3 and K4 also with the
   profiler's kernel time and the wrapper's host time a call, and K4 beside
   the transpose of the peer's rows into planes that it no longer needs;
7. **Histogram row path at full width**: ``BatchedPrio3.prep_init`` on
   phase 2's staged B = 4096 inputs, both sides; every output equals
   ``prep_init_planar``'s, and both paths' device times are taken;
8. **Count served**, Prio3Count (Field64) at 10,000 reports in one flush
   (padded to 16,384) on the row path: 64 distinct reports tiled to 9,936
   rows plus 64 tampered; checks as in phase 2; K1 at the flush's
   proof-share squeeze against its plain version;
9. **Sum served**, Prio3Sum(bits=32) at 100,000 reports in one flush
   (padded to 131,072) on the row path, built and checked the same way;
   then the first 4,096 of them as their own flush, whose every row equals
   the large flush's; K1 and K2 at the large flush's shapes against their
   plain versions;
10. **SumVec with bits > 1**, Prio3SumVec(1000, 8, 89) at 64 reports (one
    tampered) through the backend's row path, sharded by worker processes
    during the build; the aggregate is exact and sampled rows equal the
    oracle; K1 at its measurement-share squeeze (762 blocks a report) and
    K2 at its joint-rand-part absorb against their plain versions;
11. **Histogram through the executor**: phase 2's 4096 rows, the leader's
    input shares encoded and decoded as an upload delivers them, submitted
    to a ``DeviceExecutor`` with the device-resident accumulator as 4 jobs
    of 1024 rows a side with ``retain_out_shares``, after a warmup at the
    flush's size; the combine through the executor's combine kind; the
    accepted rows' ``ResidentRef``s committed per job and drained, the
    store at its default budget.  One prepare flush a side holds all 4
    jobs, no out-share row is read back, nothing is evicted,
    the drained aggregate is the exact histogram of the valid rows, every
    tampered row is rejected, 16 sampled rows' prepare shares equal the
    oracle's, and the leader flush is marshalled from the shares' bytes,
    which equal ``to_limbs`` of the same shares;
12. **SumVec100k through the executor**: phase 4's 128 rows tiled x8 to
    B = 1024 (the device batch of phase 5), 4 jobs of 256 rows a side, the
    same flow and checks; the drained aggregate equals 8x phase 4's; peak
    device memory;
13. **The leader/helper pair**: a leader and a helper ``Aggregator``, each
    with its own SQLite ``EphemeralDatastore`` and its own
    ``DeviceExecutor`` with the accumulator at its default budget, the
    backend ``make_backend``'s ``CudaBackend``, joined by the in-process
    transport (``aggregator/test_util.py``) on a ``MockClock``; one task a
    family at its published width on the time-interval query: Count and
    Sum(bits=32) at 1,024 reports sharded in the phase, Histogram(1024,
    316) at 512 (phase 1's 64 and 448 sharded by worker processes during
    the build), each with 8 tampered, and SumVec(100000, 1, 316) at phase
    4's 2 reports; each report uploaded under its shard nonce as report
    ID.  Each side's executor is warmed first; every report is sealed to
    both aggregators and uploaded through ``handle_upload``, the creator
    cuts jobs of 256, the driver steps the first job alone and the rest
    together, and a collector collects.  The aggregate and report count
    are exact, no out share is read back or recomputed, no oracle serves a
    row, no breaker trips, every leader row is marshalled from its bytes,
    each family's kernels launch, and a task of at least 16 uploads opened
    some of them on the card's vector pass (``core/hpke_batch.py``; the
    opens by route go under ``hpke_open_rows``); upload, creator, first job, the
    other jobs, collection and end-to-end seconds, uploads/s and
    reports/s, flushes a side, busy seconds by layer and peak memory go
    under ``pair`` in the ``end_to_end`` line.  Two more tasks, run
    after phases 14 and 15: FixedPointBoundedL2VecSum(BitSize16, 1000)
    with phase 14's distinct reports and 2 of its norm-lie reports, and
    the HMAC multiproof SumVec with phase 15's 2 reports (its FLP on the
    card, no port kernel launched: its XOF is on the host); no DP
    strategy, so each aggregate is exact.  The executors run the
    reference's default canonical shapes: Histogram(1024, 316), SumVec100k
    (317 gadget calls padded to 511) and FixedPoint(BitSize16, 1000)
    resolve to their buckets' twins (each record names its twin under
    ``served_as``), and since every flush holds one task it runs that
    task's own prepare: K1-K3 for the Histogram, K1, K2 and K5 for
    SumVec100k, and K2's select variant never; Count and Sum(32) sit on
    their buckets' ceilings and keep their exact shape;
14. **FixedPointBoundedL2VecSum at full width**, BitSize16 with 1,000
    entries (MEAS_LEN 16,030, chunk 126: gadget 0 has 128 calls, P = 256,
    the NTT; gadget 1 has 8 calls, P = 16, Horner), the registry's
    instance: distinct reports sharded with the oracle's prep_init of both
    sides by worker processes during the build, tiled to B = 1024 rows
    with 8 rows whose leader measurement share is perturbed and 8 rows of
    reports whose claimed norm disagrees with their entries; the direct
    backend path (``prep_init``), both sides: the aggregate is the exact
    sum of the valid rows' entries, every tampered row is rejected and 16
    sampled rows equal the oracle; device ms a side, a profiled call and
    peak memory; the same rows through the executor as 4 jobs of 256 a
    side with the accumulator (one flush a side, no readback, no
    eviction); K1 at the helper's measurement-share squeeze (1,527 blocks
    a report) and K2 at the leader's joint-rand-part absorb against their
    plain versions on the card, whole batch, the plain version timed on
    the one call that is compared;
15. **The HMAC multiproof SumVec at full width**,
    Prio3SumVecField64MultiproofHmacSha256Aes128(proofs=2, length=100000,
    bits=1, chunk_length=316): 2 reports sharded (with the oracle's
    prep_init of both sides) by worker processes, tiled to 120 rows plus 8
    tampered, B = 128, through ``make_backend``'s ``HybridXofBackend``,
    both sides: host XOF, the FLP of both proofs and the decide on the
    card (Field64, P = 512 on the NTT); the aggregate is exact, the
    tampered rows are rejected, one row per side per report equals the
    oracle, every leader row is marshalled from its bytes, no port kernel
    launches; host-XOF and device seconds; a profiled ``query_batch`` call
    a side must hold device activities;
16. **Poplar1 prepare on the card**: Poplar1(bits=16) at 1,024 reports a
    side (measurements skewed over 64 distinct values, sharded by worker
    processes during the build; 8 with a flipped leader IDPF key) at level
    8 over 64 candidate prefixes (Field64) and at the leaf over the 64
    values (Field255), and Poplar1(bits=256) at its leaf over 16 prefixes
    (16 reports tiled to 256 rows): ``Poplar1Backend`` with the walk on
    the card and on the host, both sides, direct and through an executor
    (4 jobs a side, one flush, the deferred accumulator).  Every state and
    share of the card walk equals the host walk's, 16 sampled rows (4 at
    bits 256) equal ``Poplar1Oracle``, the decided sketch accepts exactly
    the untampered rows, no row goes to the oracle, the executor's card
    walk keeps its vectors on the card (no readback) and the drained sums
    equal the host walk's; the walk's and the sketch's device ms (CUDA
    events), seconds a job, the device activities and idle share of one
    profiled flush (bits 16, level 8), peak memory.  No port kernel
    launches;
17. **The pair collects heavy hitters**: phase 13's pair with a
    Poplar1(bits=16) task, both sides walking on the card, both sides'
    accumulators deferred (the helper's continue steps journal their
    vectors into level buckets that its aggregate-share barrier drains),
    aggregation jobs of 256; phase 16's 1,024
    reports uploaded; a collection at level 7 over the 8-bit prefixes of
    the 64 values (padded to 64), then one at the leaf over the values
    under the prefixes counted at least 16 times.  Every prefix count is
    the plain count of the uploads, both sides' ``poplar_init/L7`` and
    ``/L15`` buckets flushed more jobs than flushes, no row goes to the
    oracle, no breaker trips, the leader reads no sketch vector back, the
    helper holds journal rows once a level's jobs are done and none after
    its collection, and no journal row is left.  Each collection job is stepped as soon as its
    level's jobs are, with no wait for the deferred drain: the collection
    step leaves young journal rows to the drain and asks again, and no row
    may be replayed on the oracle;
18. **The service binaries**: five processes of ``python -m
    janus_tpu_torch.binaries`` (the leader's and the helper's aggregator,
    the creator, the aggregation-job driver with the deferred accumulator
    and the collection-job driver; each side its own SQLite file, real
    localhost HTTP) serve one Prio3Histogram(1024, 316) task provisioned
    by ``janus_cli``: 1,024 reports and 8 tampered ones uploaded through
    the port's client, collected by the ``collect`` binary as soon as the
    jobs are stepped.  The aggregate and report count are exact; the
    leader's /metrics count uploads opened on the vector pass; the
    driver's and the helper's /metrics count cuda prepares of every report
    and no fallback; no journal row is replayed or left; both executor
    processes hold the card and launch K1-K3 after their warmup (their
    /statusz launch counts; the default canonical shapes resolve the task
    to its twin Histogram(1264, 316), and a flush of this one task runs the
    task's own planar prepare, so K2's select variant stays at 0);
    /statusz shows the Histogram buckets, a canonicalized plan and the
    card.  Then, with the fleet still running, the ``canary`` binary
    provisions a Prio3Sum(8) and a Prio3Histogram(4, 2) task through both
    aggregators' task APIs and probes them every second: each family
    reaches 2 ``ok`` verdicts within 120 s with no ``error``, ``timeout``
    or ``corrupt`` verdict and no backoff; its /statusz shows the fleet
    ``healthy`` with a last-good time a family; the driver's and the
    helper's cuda-prepared reports rose by at least the ok probes' reports,
    K1 launched again in both, with no fallback or journal replay; SIGTERM
    stops all six with exit 0.
    Startup-to-ready seconds, upload/s, seconds from the first upload to
    the collected aggregate, the flush counts and the canary's seconds to
    its ok probes and stage latencies are printed;
19. **Canonical buckets**: Histogram(1024, 316) and Histogram(1000, 316)
    (both 4 gadget calls, below their bucket's ceiling) share the twin
    Histogram(1264, 316): phase 1's 64 reports and 64 of the second task
    sharded during the build, each tiled to 2,016 rows plus 32 tampered
    rows, one job a task a side through one ``DeviceExecutor`` that
    resolves both tasks to one cached ``CudaBackend(twin,
    canonical=True)``, one B = 4096 flush a side.  Each task's aggregate is
    exact, every tampered row is rejected, 16 sampled rows a task equal
    that task's oracle byte for byte (prep share, out share, joint-rand
    seed), every out share has its task's length, one flush a side holds
    both jobs, the twin's oracle prepares nothing and the tasks' oracles
    only the not-ok rows (counted and printed), and no FLP kernel launches.
    K2's select variant is held against its plain version at that flush's
    joint-rand-part absorb and timed.  Then FixedPointBoundedL2VecSum
    (BitSize16) at 1,000 and 1,003 entries share the twin with 1,006: 504
    valid rows and 8 norm-lie rows a task, B = 1024, the same gates;
20. **The limb-digit matmul layout** (``field_backend: mxu``; the JAX
    package's ``MXU_AB_ROWS`` and FixedPoint): ``CudaBackend(field_backend=
    "mxu")`` serves Histogram(1024, 316) at phase 2's B = 4096 rows,
    Sum(32) at 4,096 rows of 64 reports sharded in the phase (64
    tampered), SumVec100k at phase 4's B = 128 and FixedPoint(BitSize16,
    1000) at 1,016 rows of phase 14's reports and 8 norm-lie rows, both
    sides, combined and aggregated, every flush on the row path: the
    aggregate is exact, every tampered row is rejected, sampled rows equal
    the oracle, K1, K2 and the digit reduce (``csrc/field_dot.cu``) launch
    and K3-K5 and K2's select variant do not.  On the staged rows both
    sides' prepare and the combine equal the vpu route's output for output;
    both routes' device ms a side, the mxu peak memory, a profiled mxu helper
    prepare at Histogram and FixedPoint (device activities, idle share); the
    digit reduce
    at the path's largest contraction against its plain version on its
    operands and on carry-saturating ones (every element p - 1), its ms,
    bound and launches and the digit matmul's ms.  Then the pair of phase
    13 with ``Config``/``DriverConfig(field_backend="mxu")`` collects
    Histogram(1024, 316) (phase 13's first 128 reports, 8 tampered) and FixedPoint (18
    reports, 2 norm lies) exactly, with the same gates and the digit reduce
    launched;
21. **The prepare across cards** (``MeshBackend``): Histogram(1024, 316)
    at phase 2's B = 4096 rows on a mesh over every visible card and on 2
    and 4 logical shards of the first card.  On the staged rows both
    sides' outputs (ok, verifiers, joint-rand parts, corrected seeds and
    the out-share pieces joined) equal one ``CudaBackend``'s, and so does
    the drain's cross-shard sum; the device prepare ms of each mesh and of
    one card (CUDA events) and the drain readback's ms.  Then one executor
    job of both sides on each mesh, as phase 11 runs it: one flush a side,
    out shares resident, the aggregate exact, tampered rows rejected, no
    out-share row read back, and each kernel launched shards x phase 11's
    count.  SumVec100k at B = 1024 on a 2-shard mesh against one card, K5
    on every shard.  Phase 13's Histogram pair task (its first 128
    uploads) with ``vdaf_backend="mesh"`` and with ``ExecutorConfig(mesh=True)``, exact,
    every backend a ``MeshBackend``.  ``dryrun_multichip`` over the visible
    cards and over 4 logical shards of the first card.  With one card the
    logical shards share its SMs: their times measure the mesh's overhead,
    not scaling;
22. **The interop binaries**: seven processes of ``python -m
    janus_tpu_torch.binaries janus_interop_<role> --port P`` (the leader's
    and the helper's aggregator with no backend in the environment, so on
    the card; 4 clients; a collector) driven only through
    ``/internal/test/*`` over localhost HTTP: Prio3Count with 1,024 uploads
    and Prio3Histogram(1024, 316) with 128, measurements from ``--seed``,
    sent concurrently round-robin over the clients, each collected in
    time-interval mode.  Each ``report_count`` and ``result`` is exact,
    nvidia-smi counts two more compute apps while the aggregators run, each
    aggregator's SIGTERM line shows K1-K3 launched and 0 backend fallbacks
    (the leader's, uploads opened on the vector pass), and all seven exit 0
    on SIGTERM.  Each process's startup-to-ready, each task's uploads/s and
    first upload to collected aggregate are printed;
23. **The upload vector pass**: random plaintexts of the byte length of
    one real encoded leader share of Histogram(1024, 316) and of Count,
    sealed to one leader key, opened through ``hpke_batch.open_batch`` in
    batches of 64 and 512 with 2 tampered rows a batch, once on the
    vector route (the AES pass on the card, GHASH on the host) and once
    per report.  Both routes' plaintexts are byte-equal to the sealed
    ones, only the tampered rows are rejected, and each route's counter
    moves by the batch's rows; each route's ms a batch, the AES pass's
    device ms (CUDA events) and GHASH's host ms are printed.

Every path runs with the kernel launch counters set to 0 just before it and
read just after; a kernel of the path that was never launched fails the run.
Prints each phase's seconds, the per-kernel JSON line, the card's name and
power limit, and as its last line ``{"ok": true, "device": {...}}``.

Run from the repository root: ``python3 chip_smoke.py [--seed N]``.  It
exits nonzero, printing no result, without a CUDA card or when any phase
fails.

``python3 chip_smoke.py --canonical-ab`` runs none of the phases above: it
times one task's executor job (both sides, 4 jobs a side in one flush, out
shares resident, commit and drain, as phases 11 and 12) three ways, in turns
exact, twin, selected, selected, twin, exact: the task's own ``CudaBackend``
(canonical shapes off), its bucket's twin running every flush on the masked
row path (as the JAX package's canonical backend does), and the twin as the
port runs it by default (a flush of one task shape on that shape's own
prepare).  Histogram(1024, 316) at B = 4096 and SumVec100k at B = 1024; each
job's aggregate is exact and its tampered rows rejected.
"""

from __future__ import annotations

import argparse
import functools
import json
import multiprocessing
import statistics
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import torch

LENGTH, CHUNK = 1024, 316
DISTINCT, TAMPERED, BATCH = 64, 64, 4096
SAMPLED = 16
#: Prio3SumVec(100000, 1, 316): BASELINE.json configs[3], the wide-vector FLP.
SV_LENGTH, SV_CHUNK = 100000, 316
SV_DISTINCT, SV_TAMPERED, SV_BATCH, SV_TILE = 2, 8, 128, 8
#: Submissions a side of the executor phases (11, 12), one flush in all.
EXECUTOR_JOBS = 4
#: Batches besides the path's at which K4 is also checked and timed: 128
#: fills 4 blocks; 33 is not a multiple of 4 (word-at-a-time loads) and
#: leaves a ragged block.
COMBINE_BATCHES = (128, 33)
#: Columns of K1/K2 at the SumVec shape held against the plain version on the host.
HOST_CHECK_COLUMNS = 8
#: Prio3Count, BASELINE.json configs[0] ("10k reports, single aggregation
#: job"): one flush, padded to 16,384, on the row path.
COUNT_REPORTS = 10000
#: Prio3Sum(bits=32), BASELINE.json configs[1] ("100k reports"): one flush,
#: padded to 131,072, on the row path; its first SUM_SMALL_FLUSH reports
#: also run as their own flush.
SUM_BITS, SUM_REPORTS, SUM_SMALL_FLUSH = 32, 100000, 4096
#: The Sum row path timed at the large flush's padded size, the staged
#: small flush tiled on the card.
SUM_TILE = 32
#: Prio3SumVec with bits > 1 at a test size (a routing check, not a
#: published width): (length, bits, chunk_length), reports, worker processes
#: that shard them.
SV8 = (1000, 8, 89)
SV8_REPORTS, SV8_WORKERS, SV8_SAMPLED = 64, 2, 4
#: Phase 13, the leader/helper pair: reports a task (each with its own
#: report ID), of which PAIR_TAMPERED carry a perturbed leader measurement
#: share; the creator's job size; the histogram reports beyond phase 2's 64,
#: sharded by worker processes during the build; concurrent uploads a wave.
PAIR_COUNT_REPORTS = PAIR_SUM_REPORTS = 1024
PAIR_HIST_REPORTS, PAIR_HIST_WORKERS = 512, 4
PAIR_TAMPERED, PAIR_JOB_SIZE, PAIR_UPLOAD_WAVE = 8, 256, 256
#: a pair task of at least this many uploads must open some on the vector pass
PAIR_VECTOR_MIN = 16
#: phases 20 and 21 run phase 13's Histogram task again (under the mxu
#: layout, the mesh backend and the executor's mesh flag) with the first
#: this many of its uploads: at 512, each run's uploads took 16-25 s on the
#: vector pass, which the smoke's time limit cannot hold three more times
PAIR_REPEAT_HIST_REPORTS = 128
#: Phase 14: Prio3FixedPointBoundedL2VecSum as the registry builds it at
#: the reference's BitSize16 (core/src/vdaf.rs:88-91) with 1,000 entries,
#: the JAX package's full-size fpvec row; distinct reports sharded by
#: FP_WORKERS worker processes (each also shards one report whose claimed
#: norm is 0 over nonzero entries), entries k / 2^15 with |k| <= FP_ENTRY_MAX
#: (the squared norm stays below the 2^30 the claim holds); the batch's
#: rows with a perturbed leader share and rows of the norm-lie reports.
FP_DESC = {"type": "Prio3FixedPointBoundedL2VecSum", "bitsize": "BitSize16", "length": 1000}
FP_DISTINCT, FP_WORKERS, FP_ENTRY_MAX = 16, 4, 1000
FP_BATCH, FP_TAMPERED, FP_LIE_ROWS = 1024, 8, 8
#: Phase 15: the HMAC-SHA256-AES128 multiproof SumVec at BASELINE.json
#: configs[3]'s width with 2 proofs, the fewest its constructor takes
#: (core/src/vdaf.rs:178-195); reports sharded by worker processes, batch.
MP_DESC = {"type": "Prio3SumVecField64MultiproofHmacSha256Aes128", "proofs": 2, "length": 100000, "bits": 1,
           "chunk_length": 316}
MP_DISTINCT, MP_TAMPERED, MP_BATCH = 2, 8, 128
#: The pair's FixedPoint task: phase 14's distinct reports and this many of
#: its norm-lie reports.
PAIR_FP_LIES = 2
#: Phase 16: Poplar1(bits=16) at POPLAR_REPORTS reports a side (the JAX
#: package's poplar1_hh row, bench.py:688-692, at 4x its 256 reports), the
#: measurements drawn with a skew from POPLAR_VALUES distinct values and
#: sharded by POPLAR_WORKERS worker processes during the build; level 8
#: over 64 candidate prefixes (Field64) and the leaf over the 64 values
#: (Field255); POPLAR_TAMPERED rows with a flipped leader IDPF key;
#: executor submissions a side.  Poplar1(bits=256), heavy hitters over
#: hashed strings, at its leaf over 16 prefixes: 16 distinct reports tiled
#: to 256 rows, a quarter of them tampered, POPLAR_WIDE_SAMPLED rows held
#: against the oracle (whose walk is 256 levels of Python a prefix).
POPLAR_BITS, POPLAR_VALUES, POPLAR_REPORTS, POPLAR_WORKERS = 16, 64, 1024, 2
POPLAR_INNER_LEVEL, POPLAR_PREFIXES, POPLAR_TAMPERED, POPLAR_JOBS = 8, 64, 8, 4
POPLAR_WIDE_BITS, POPLAR_WIDE_DISTINCT, POPLAR_WIDE_ROWS, POPLAR_WIDE_SAMPLED = 256, 16, 256, 4
#: Phase 17: the pair's aggregation-job size, its two collection levels,
#: the count a level-7 prefix needs for its leaves to be collected, and
#: the leader's deferred-drain interval, seconds (the collection step asks
#: again until the drain has run).
POPLAR_PAIR_JOB_SIZE, POPLAR_PAIR_LEVELS, POPLAR_THRESHOLD = 256, (7, 15), 16
POPLAR_DRAIN_S = 2.0
#: the helper's deferred-drain interval in phase 17: longer than the
#: phase, so that its aggregate-share barrier does the drains
POPLAR_HELPER_DRAIN_S = 3600.0
#: Phase 17's executor flush window, seconds (a flush closes earlier once
#: it holds every report of the level).
POPLAR_FLUSH_WINDOW_S = 1.0
#: Phase 18, the service binaries: reports uploaded beyond phase 13's 512
#: histogram shards (sharded in the phase by FLEET_SHARD_WORKERS worker
#: processes while the binaries start), the tampered ones among them, the
#: creator's job size and cadence, the driver's deferred-drain interval and
#: maintenance cadence, the executors' warmup batch and flush window, and
#: the seconds the fleet has to become ready and to collect.
FLEET_REPORTS, FLEET_TAMPERED, FLEET_SHARD_WORKERS = 1024, 8, 6
FLEET_JOB_SIZE, FLEET_CREATE_S, FLEET_DRAIN_S, FLEET_MAINTENANCE_S = 256, 0.5, 1.0, 0.25
FLEET_WARMUP_ROWS, FLEET_FLUSH_WINDOW_MS, FLEET_TIMEOUT_S = 1024, 20, 300.0
#: Phase 18's canary: the families it probes (the JAX package's defaults),
#: its probe cadence, collection poll and collection budget, seconds; the ok
#: probes each family must reach, and the seconds it has to reach them.
CANARY_FAMILIES = ("prio3_sum", "prio3_histogram")
CANARY_PROBE_S, CANARY_POLL_S, CANARY_COLLECT_S = 1.0, 0.5, 60.0
CANARY_OK, CANARY_TIMEOUT_S = 2, 120.0
#: Phase 22, the interop binaries: client processes (a Histogram(1024, 316)
#: upload shards and seals in the client's handler, about 0.3 s of a core),
#: each task as (name, interop VDAF object with its numbers as strings,
#: uploads), the uploads in flight at once, and the seconds the processes
#: have to answer ``ready`` and a task to collect.
INTEROP_CLIENTS = 4
INTEROP_TASKS = (("count", {"type": "Prio3Count"}, 1024),
                 ("histogram", {"type": "Prio3Histogram", "length": str(LENGTH), "chunk_length": str(CHUNK)}, 128))
INTEROP_IN_FLIGHT, INTEROP_READY_S, INTEROP_COLLECT_S = 32, 120.0, 120.0
#: Phase 23, the upload vector pass: random plaintexts of one real encoded
#: leader share's length (Histogram(1024, 316) and Count), sealed to one
#: leader key with UPLOAD_AAD bytes of aad, opened in batches of each of
#: UPLOAD_BATCHES with UPLOAD_TAMPERED tampered rows a batch
UPLOAD_BATCHES, UPLOAD_TAMPERED, UPLOAD_AAD = (64, 512), 2, 64
#: Phase 19, canonical buckets: two Histogram tasks below their bucket's
#: ceiling (calls 4, P = 8) that share the twin Histogram(1264, 316), each
#: with the phase's DISTINCT reports (the second task's sharded by
#: CANON_HIST_WORKERS worker processes during the build) tiled to
#: CANON_HIST_ROWS rows plus CANON_HIST_TAMPERED tampered ones, so that a
#: side's flush is B = 4096; and FixedPointBoundedL2VecSum(BitSize16, ·) at
#: the registry's width and at 1,003 entries, which share the twin with
#: 1,006 entries: phase 14's reports for the first, CANON_FP_WORKERS workers
#: of CANON_FP_PER_WORKER reports (and one norm lie each) for the second,
#: CANON_FP_ROWS valid rows and CANON_FP_LIES norm-lie rows a task (B =
#: 1024).
CANON_HIST_LENGTHS, CANON_HIST_WORKERS = (LENGTH, 1000), 2
CANON_HIST_ROWS, CANON_HIST_TAMPERED = 2016, 32
CANON_FP_LENGTHS, CANON_FP_WORKERS, CANON_FP_PER_WORKER = (1000, 1003), 2, 2
CANON_FP_ROWS, CANON_FP_LIES = 504, 8
#: Phase 20, the limb-digit matmul layout (``field_backend: mxu``): the JAX
#: package's MXU_AB_ROWS (bench.py:1197: Sum(32), Histogram(1024, 316),
#: SumVec100k) and FixedPoint(BitSize16, 1000), each at an earlier phase's
#: flush: Histogram at phase 2's B = 4096 rows, Sum(32) at SUM_SMALL_FLUSH
#: rows of MXU_SUM_DISTINCT reports sharded in the phase (MXU_SUM_TAMPERED
#: tampered), SumVec100k at phase 4's B = 128, FixedPoint at phase 14's B =
#: 1024 (FP_LIE_ROWS norm lies); rows held against the oracle a shape.
MXU_SUM_DISTINCT, MXU_SUM_TAMPERED, MXU_SAMPLED = 64, 64, 4
#: The kernels every mxu prepare launches: K1, K2 and the digit reduce.
MXU_NEEDS = ("keccak_squeeze", "keccak_absorb", "field_lazy_reduce")
#: Phase 21, the mesh: logical shard counts on the first card (run beside a
#: mesh over every visible card), the SumVec100k mesh's shard count, and the
#: timed calls a round of each mesh's device prepare and drain readback.
MESH_LOGICAL, MESH_SV_SHARDS, MESH_REPS = (2, 4), 2, 1
#: Type conversions from 64-bit floating point to 32-bit integers per SM and
#: clock (CUDA C++ Programming Guide, arithmetic instruction throughput, cc
#: 9.0): the digit reduce converts each float64 partial sum once.
CONVERT_F64_PER_CLK = 16
#: The five binaries of phase 18 and the binary each runs.
FLEET = {"leader": "aggregator", "helper": "aggregator", "creator": "aggregation_job_creator",
         "driver": "aggregation_job_driver", "collection": "collection_job_driver"}
#: Where the paths run (the card; a CPU rehearsal of the script sets "cpu").
DEVICE = "cuda"
#: Largest |kernel - plain| allowed over u32 words: the arithmetic is exact
#: integer work, so every kernel must equal its plain version bit for bit.
TOLERANCE = 0

#: H100 SXM device-memory rate (NVIDIA data sheet), bytes/s.
HBM_BYTES_PER_S = 3.35e12
#: Integer rates per SM and clock: 32-bit integer multiply and multiply-add
#: results (64) and 32-bit integer add, logic, shift and compare
#: instructions (64), from the CUDA C++ Programming Guide's arithmetic
#: instruction throughput table for compute capability 9.0; the four
#: schedulers dispatch at most 128 instructions in all (Hopper architecture
#: white paper: 64 INT32 lanes beside the 128 FP32 lanes of an SM).  Taken
#: at the card's largest SM clock over its SMs; the operations bound is the
#: largest of the three times.
INT_MUL_PER_CLK = 64
INT_ALU_PER_CLK = 64
DISPATCH_PER_CLK = 128

#: Counts as (32-bit multiply results, other integer instructions); a
#: 32x32->64 product is one instruction and two multiply results.  For
#: Field128's p = 2^128 - 7*2^66 + 1 the low word of p is 1 and n' = -1, so
#: a word-by-word Montgomery reduction step takes m = -t_i (one negation),
#: adds m into t_i (one add, its carry), and multiplies only m by p's two
#: high words (2 products, 4 adds): 8 products and 24 other instructions in
#: all.  A Field128 Montgomery product on 4 u32 limbs: the 16 products and
#: 32 adds of the 128x128 product and that reduction.
MONT_MUL = (48, 56)
#: A 128x128-bit product added into an unreduced 256-bit sum: 16 products
#: and 32 adds with carry of their words into the sum.
WIDE_MAC = (32, 32)
#: The Montgomery reduction of such a sum: the reduction above and 8 adds to
#: fold the carries.
WIDE_REDUCE = (16, 32)
#: A modular add or subtract: 4 adds with carry, 4 compares, 4 selects.
FIELD_ADD = (0, 12)
#: One Keccak-p[1600,12] on 64-bit lanes held as two u32 words, per round
#: with 3-input LOP3s and funnel shifts: theta's column parities 20 (two
#: LOP3s a word), C rotated by one 10, the theta XOR 50 (one LOP3 a word
#: takes both C terms), rho 48 (two funnel shifts a lane, 24 lanes), chi 50
#: (one LOP3 a word), iota 2; pi only renames registers.
KECCAK_P12 = (0, 12 * (20 + 10 + 50 + 48 + 50 + 2))
#: The fewest dependent ALU steps one Keccak-p round needs on u32 words with
#: 3-input LOP3s and funnel shifts, whatever the design: two LOP3 levels for
#: theta's 5-lane column parity C; one funnel shift, since rho distributes
#: over theta's XORs (rot(A ^ C[x-1] ^ rotl(C[x+1], 1), r) = rot(A, r) ^
#: rot(C[x-1], r) ^ rot(C[x+1], r + 1), and rot(A, r) is off the chain);
#: one LOP3 joining the three; one LOP3 for chi.  Iota's constant folds into
#: the next round's parity and theta LOP3s off the chain.  An output word of
#: theta-rho depends on about 22 input words, more than a funnel shift and
#: two LOP3 levels reach (18), and chi's AND needs two whole such words.
KECCAK_ROUND_DEPTH = 5
#: Cycles from one dependent ALU instruction's issue to the next one's.
ALU_DEPENDENT_CYCLES = 4

KERNEL_NAMES = ("keccak_squeeze", "keccak_absorb", "flp_wire_evals", "flp_combine_decide", "flp_sumvec_wires",
                "keccak_absorb_select", "field_lazy_reduce")
#: Each kernel's wrapper as ``/statusz`` names it (core/statusz.py).
STATUSZ_KERNELS = dict(zip(("keccak_kernels.squeeze", "keccak_kernels.absorb", "flp_kernels.wire_evals",
                            "flp_kernels.combine_decide", "flp_kernels.sumvec_wires", "keccak_kernels.absorb_select",
                            "field_kernels.lazy_reduce_digits"),
                           KERNEL_NAMES))
#: Each launch counter's kernel, as torch.profiler names its device events.
DEVICE_KERNELS = dict(zip(KERNEL_NAMES, ("squeeze_kernel", "absorb_kernel", "wire_kernel", "combine_kernel", "sumvec_kernel",
                                         "absorb_select_kernel", "digit_reduce_kernel")))
#: The kernels of a canonical twin's masked row path (no FLP kernel).
CANONICAL_KERNELS = ("keccak_squeeze", "keccak_absorb_select")
#: Small kernels a trace runs before the calls it measures: late in a long
#: process torch.profiler can miss the first few device activities of a
#: trace (PERF.md, section 5), so these stand first and are not counted.
#: A FixedPoint helper prepare's trace (47,000 activities) lost all 8 of an
#: earlier primer and its first squeeze besides.
PROFILE_PRIMER = 64
#: Seconds of quiet between the primer and the measured calls, which tell
#: their events apart, and the traces taken before a profile that keeps
#: losing kernel events fails.
PROFILE_MARGIN_S = 0.05
PROFILE_ATTEMPTS = 3
#: The profiler range around the measured calls.
MEASURED = "chip_smoke.measured"
#: The side whose prepare the direct paths' profiled call traces (Histogram,
#: SumVec100k, FixedPoint): the helper's, the bench's headline side.  The
#: leader's does the same work, and the profiler reads a trace of one such
#: prepare (32,000-47,000 device activities) for many seconds.
PROFILED_SIDES = (("helper", 1),)
#: Traces taken, primer events missing from them, and traces that lost
#: events of the port's kernels (logged at the end of the run).
TRACE_TALLY = {"traces": 0, "primer_events_missing": 0, "lost": 0}
#: Each counted path's kernel launches, by path.
PATH_LAUNCHES = {}
#: The FLP kernels (Field128 only): no Count, Sum or row-path run reaches them.
FLP_KERNELS = KERNEL_NAMES[2:5]


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_time_ms(fn, reps: int, rounds: int = 3) -> float:
    """Per-call device time after a warm-up: CUDA events around ``reps``
    back-to-back calls, so the host's enqueue of one call hides behind the
    device work of the one before; the median over ``rounds`` such runs."""
    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(rounds):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        per_call.append(start.elapsed_time(end) / reps)
    return statistics.median(per_call)


def traced(fn, reps: int = 1):
    """Device events of ``reps`` calls of ``fn`` under torch.profiler after
    a warm-up call: ([(name, microseconds)], wall seconds of the calls).

    The primer's events are left out.  Each port kernel's events must
    number its launches in the trace; a trace that lost some is logged and
    taken again, and after PROFILE_ATTEMPTS such traces the run fails."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    fns = counters()
    primer = torch.zeros(1, device=DEVICE)
    fn()
    torch.cuda.synchronize()
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        for w in fns.values():
            w.launches = 0
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILE_PRIMER):
                primer.add_(1)
            torch.cuda.synchronize()
            time.sleep(PROFILE_MARGIN_S)
            with record_function(MEASURED):
                t0 = time.perf_counter()
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        traced_events = prof.events()
        start = min(e.time_range.start for e in traced_events if e.name == MEASURED)
        # The range also leaves a device annotation event, which is no
        # device work; half the quiet margin absorbs any skew of device
        # timestamps.
        device = [e for e in traced_events if e.device_type == DeviceType.CUDA and e.name != MEASURED]
        events = [(e.name, e.time_range.elapsed_us()) for e in device if e.time_range.start >= start - PROFILE_MARGIN_S * 5e5]
        launched = {k: w.launches for k, w in fns.items()}
        seen = {k: sum(DEVICE_KERNELS[k] in name for name, _ in events) for k in fns}
        TRACE_TALLY["traces"] += 1
        TRACE_TALLY["primer_events_missing"] += PROFILE_PRIMER - (len(device) - len(events))
        if seen == launched:
            return events, wall
        TRACE_TALLY["lost"] += 1
        log(f"profiler: trace {attempt} holds {json.dumps(seen)} events of the port's kernels "
            f"for launches {json.dumps(launched)}")
    raise AssertionError(f"profiler: {PROFILE_ATTEMPTS} traces each lost events of the port's kernels")


def profiled_kernel_ms(fn, kernel: str, reps: int = 20) -> float:
    """The kernel's own device time a call: the median duration of the
    device events named ``kernel`` over ``reps`` traced calls of ``fn``."""
    events, _ = traced(fn, reps)
    return statistics.median(us for name, us in events if kernel in name) / 1e3


def host_us(fn, reps: int = 200) -> float:
    """The host's own time a call of ``fn`` (microseconds): ``reps`` calls
    enqueued back to back on the host clock, with no synchronisation among
    them, so the card's time hides behind the host's."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    per_call = (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    return per_call * 1e6


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest |a - b| over u32 words (0 when the two agree exactly)."""
    mask = 0xFFFFFFFF
    return int(((a.to(torch.int64) & mask) - (b.to(torch.int64) & mask)).abs().max().item())


def ops(*terms):
    """Sum of count x (multiply results, other instructions) terms."""
    return tuple(sum(n * c[i] for n, c in terms) for i in (0, 1))


def bound(bytes_moved: float, count, conversions: float = 0) -> dict:
    """The least time (ms) of a call that moves ``bytes_moved`` and does
    ``count`` = (multiply results, other integer instructions) and
    ``conversions`` float64-to-integer conversions: the largest of the
    bytes at the HBM rate, the multiplies at the integer multiply rate, the
    other instructions at the ALU rate, the conversions at their rate and
    all the instructions (a product's two results are one) at the dispatch
    rate.  ``bound_by`` is "bytes" or "operations"; ``bound_kind`` names
    which of the five was taken."""
    mul, alu = count
    per_ms = torch.cuda.get_device_properties(0).multi_processor_count * sm_clock_hz() / 1e3
    times = {
        "bytes": bytes_moved / HBM_BYTES_PER_S * 1e3,
        "multiplies": mul / (INT_MUL_PER_CLK * per_ms),
        "alu": alu / (INT_ALU_PER_CLK * per_ms),
        "conversions": conversions / (CONVERT_F64_PER_CLK * per_ms),
        "dispatch": (mul / 2 + alu + conversions) / (DISPATCH_PER_CLK * per_ms),
    }
    kind = max(times, key=times.get)
    return {"bound_ms": times[kind], "bound_by": "bytes" if kind == "bytes" else "operations", "bound_kind": kind}


def keccak_bound(moved: float, perms: int, B: int) -> dict:
    """The bound of a K1/K2 call whose reports each run a chain of ``perms``
    permutations: the larger of ``bound`` and the chain bound, perms x 12
    rounds x the round's least dependent depth x the ALU's latency from one
    dependent instruction to the next at the SM clock.  ``bound_by`` keeps
    the kernels line's two words (a chain is dependent operations);
    ``bound_kind`` is "chain" where the chain bound was taken."""
    chain = perms * 12 * KECCAK_ROUND_DEPTH * ALU_DEPENDENT_CYCLES / sm_clock_hz() * 1e3
    b = bound(moved, ops((perms * B, KECCAK_P12)))
    if chain > b["bound_ms"]:
        b = {"bound_ms": chain, "bound_by": "operations", "bound_kind": "chain"}
    return {**b, "chain_bound_ms": chain}


@functools.lru_cache(maxsize=None)
def sm_clock_hz() -> float:
    """The card's largest SM clock (nvidia-smi clocks.max.sm, "1980 MHz")."""
    return 1e6 * float(nvidia_smi("clocks.max.sm").split()[0])


def counters():
    """The launch-counting wrapper of every kernel, by name."""
    from janus_tpu_torch.ops import field_kernels, flp_kernels, keccak_kernels

    return dict(zip(KERNEL_NAMES, (
        keccak_kernels.squeeze, keccak_kernels.absorb, flp_kernels.wire_evals,
        flp_kernels.combine_decide, flp_kernels.sumvec_wires, keccak_kernels.absorb_select,
        field_kernels.lazy_reduce_digits,
    )))


def zero_counters():
    """Set every launch counter to 0, once the card has run what came
    before; returns the counted wrappers by name."""
    fns = counters()
    torch.cuda.synchronize()
    for w in fns.values():
        w.launches = 0
    return fns


def counted(path: str, needs, fn):
    """Run one path with every launch counter at 0 just before it and read
    just after; fail if a kernel the path needs was never launched."""
    fns = zero_counters()
    result = fn()
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in fns.items()}
    log(f"{path} launches: {json.dumps(launches)}")
    PATH_LAUNCHES[path] = launches
    missing = [k for k in needs if launches[k] == 0]
    if missing:
        raise AssertionError(f"{path}: kernels of the path never launched: {missing}")
    return result, launches


def no_flp_kernels(path: str, launches) -> None:
    """Fail if a path that must not reach the FLP kernels launched one."""
    reached = [k for k in FLP_KERNELS if launches[k]]
    if reached:
        raise AssertionError(f"{path}: launched {reached}, which this path must not reach")


def require_route(backend, batch: int, route: str) -> None:
    """Fail unless the backend's chooser sends a flush of ``batch`` reports
    to ``route``."""
    got = backend._prep_fn(0, backend._pad_to(batch)).__name__
    if got != route:
        raise AssertionError(f"a flush of {batch} reports takes {got}, not {route}")


def shard_reports(vdaf, rng, measure, count=DISTINCT):
    """``count`` distinct reports sharded by the oracle from ``rng``:
    (reports, measurements)."""
    reports, meas = [], []
    for _ in range(count):
        m = measure(rng)
        nonce = rng.integers(0, 256, vdaf.NONCE_SIZE, dtype=np.uint8).tobytes()
        rand = rng.integers(0, 256, vdaf.RAND_SIZE, dtype=np.uint8).tobytes()
        public, shares = vdaf.shard(m, nonce, rand)
        reports.append((nonce, public, shares))
        meas.append(m)
    return reports, meas


def sumvec_oracle_job(seed: int, index: int, verify_key: bytes):
    """One distinct SumVec100k report sharded by the port's oracle, and the
    oracle's prep_init of both sides (run in a worker process).  Returns
    (measurement, (nonce, public share, input shares), [(prep share bytes,
    out share, joint-rand seed) per side], shard seconds, prep seconds)."""
    from janus_tpu_torch.vdaf.instances import prio3_sum_vec

    vdaf = prio3_sum_vec(SV_LENGTH, 1, SV_CHUNK)
    rng = np.random.default_rng([seed, index])
    meas = [int(x) for x in rng.integers(0, 2, SV_LENGTH)]
    nonce = rng.integers(0, 256, vdaf.NONCE_SIZE, dtype=np.uint8).tobytes()
    rand = rng.integers(0, 256, vdaf.RAND_SIZE, dtype=np.uint8).tobytes()
    t0 = time.perf_counter()
    public, shares = vdaf.shard(meas, nonce, rand)
    shard_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    oracle = oracle_prep(vdaf, verify_key, (nonce, public, shares))
    return meas, (nonce, public, shares), oracle, shard_s, time.perf_counter() - t0


def sumvec_bits_shard_job(seed: int, worker: int, count: int):
    """``count`` distinct Prio3SumVec(1000, 8, 89) reports sharded by the
    port's oracle (run in a worker process): [(measurement, (nonce, public
    share, input shares))]."""
    from janus_tpu_torch.vdaf.instances import prio3_sum_vec

    vdaf = prio3_sum_vec(*SV8)
    rng = np.random.default_rng([seed, 100 + worker])
    reports, meas = shard_reports(vdaf, rng, lambda r: [int(x) for x in r.integers(0, 1 << SV8[1], SV8[0])], count)
    return list(zip(meas, reports))


def histogram_shard_job(seed: int, worker: int, count: int, length: int = LENGTH, chunk: int = CHUNK):
    """``count`` distinct Prio3Histogram(length, chunk) reports sharded by
    the port's oracle (run in a worker process): [(measurement, (nonce,
    public share, input shares))]."""
    from janus_tpu_torch.vdaf.instances import prio3_histogram

    vdaf = prio3_histogram(length, chunk)
    rng = np.random.default_rng([seed, 200 + worker])
    reports, meas = shard_reports(vdaf, rng, lambda r: int(r.integers(0, length)), count)
    return list(zip(meas, reports))


def oracle_prep(vdaf, verify_key, report):
    """The oracle's prep_init of both sides of one report: [(prep share
    bytes, out share, joint-rand seed) per side]."""
    nonce, public, shares = report
    out = []
    for agg_id in (0, 1):
        state, pshare = vdaf.prep_init(verify_key, agg_id, nonce, public, shares[agg_id])
        out.append((pshare.encode(vdaf), state.out_share, state.corrected_joint_rand_seed))
    return out


def fixedpoint_shard_job(seed: int, worker: int, count: int, verify_key: bytes, length: int = FP_DESC["length"]):
    """``count`` distinct FP_DESC reports (at ``length`` entries), each with
    the oracle's prep_init of both sides, and one report whose claimed norm
    is 0 over entries of norm > 0, sharded by the port's oracle (run in a
    worker process).  Returns ([(measurement, (nonce, public share, input
    shares), oracle)], norm-lie report, seconds)."""
    from janus_tpu_torch.vdaf.instances import vdaf_from_instance

    t0 = time.perf_counter()
    vdaf = vdaf_from_instance(dict(FP_DESC, length=length))
    valid = vdaf.flp.valid
    rng = np.random.default_rng([seed, 300 + worker])
    scale = 1 << (valid.bits_per_entry - 1)
    out = []
    for _ in range(count):
        reports, meas = shard_reports(
            vdaf, rng, lambda r: [int(k) / scale for k in r.integers(-FP_ENTRY_MAX, FP_ENTRY_MAX + 1, valid.entries)], 1
        )
        out.append((meas[0], reports[0], oracle_prep(vdaf, verify_key, reports[0])))
    lie = valid.encode(out[0][0])
    lie[valid.entries * valid.bits_per_entry :] = [0] * valid.bits_for_norm
    vdaf.flp.encode = lambda _m: list(lie)  # the client lies: shadows the method
    lies, _ = shard_reports(vdaf, rng, lambda r: None, 1)
    return out, lies[0], time.perf_counter() - t0


def multiproof_oracle_job(seed: int, index: int, verify_key: bytes):
    """One distinct MP_DESC report sharded by the port's oracle, and the
    oracle's prep_init of both sides (run in a worker process).  Returns
    (measurement, (nonce, public share, input shares), oracle, shard
    seconds, prep seconds)."""
    from janus_tpu_torch.vdaf.instances import vdaf_from_instance

    vdaf = vdaf_from_instance(MP_DESC)
    rng = np.random.default_rng([seed, 400 + index])
    t0 = time.perf_counter()
    reports, meas = shard_reports(vdaf, rng, lambda r: [int(x) for x in r.integers(0, 2, MP_DESC["length"])], 1)
    shard_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    oracle = oracle_prep(vdaf, verify_key, reports[0])
    return meas[0], reports[0], oracle, shard_s, time.perf_counter() - t0


def build_batch(vdaf, reports, rng, batch, tampered):
    """Tiled valid rows plus ``tampered`` rows with a perturbed leader
    measurement share, shuffled from the seed.  Returns (leader rows,
    helper rows, tampered flags, distinct report index per row)."""
    from janus_tpu_torch.vdaf.prio3 import Prio3InputShare

    p = vdaf.flp.field.MODULUS
    distinct = len(reports)
    rows = [(i % distinct, False) for i in range(batch - tampered)]
    rows += [(i % distinct, True) for i in range(tampered)]
    order = rng.permutation(len(rows))
    leader, helper, bad_rows, src = [], [], [], []
    for j in order:
        i, bad = rows[j]
        nonce, public, shares = reports[i]
        lead = shares[0]
        if bad:
            ms = list(lead.meas_share)
            ms[0] = (ms[0] + 1) % p
            lead = Prio3InputShare(
                meas_share=ms, proofs_share=lead.proofs_share, joint_rand_blind=lead.joint_rand_blind
            )
        leader.append((nonce, public, lead))
        helper.append((nonce, public, shares[1]))
        bad_rows.append(bad)
        src.append(i)
    return leader, helper, np.array(bad_rows), np.array(src)


def run_main_path(vdaf, backend, verify_key, leader_rows, helper_rows):
    """Leader and helper prepare, combine and aggregate, as the executor
    drives them.  Returns (aggregate, accepted mask, results, prep messages,
    seconds per phase)."""
    from janus_tpu_torch.ops.field import tensor_to_u32, u32_to_tensor

    secs = {}
    t0 = time.perf_counter()
    lead = backend.prep_init_batch(verify_key, 0, leader_rows)
    secs["leader_prep_init"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    help_ = backend.prep_init_batch(verify_key, 1, helper_rows)
    secs["helper_prep_init"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    msgs = backend.prep_shares_to_prep_batch([[lead[b][1], help_[b][1]] for b in range(len(lead))])
    secs["combine"] = time.perf_counter() - t0
    accepted = np.zeros(len(lead), dtype=bool)
    for b, msg in enumerate(msgs):
        if isinstance(msg, Exception):
            continue
        vdaf.prep_next(lead[b][0], msg)
        vdaf.prep_next(help_[b][0], msg)
        accepted[b] = True
    t0 = time.perf_counter()
    f = backend.bp.f
    out_len = vdaf.flp.OUTPUT_LEN
    aggs = []
    for side in (lead, help_):
        limbs = f.to_limbs([x for st, _ in side for x in st.out_share]).reshape(len(side), out_len, f.n)
        if hasattr(backend, "aggregate_batch"):
            aggs.append(backend.aggregate_batch(limbs, accepted))
        else:
            # HybridXofBackend has no aggregate surface: sum on the card
            # through its BatchedPrio3
            agg = backend.bp.aggregate(u32_to_tensor(limbs, DEVICE), torch.from_numpy(accepted).to(DEVICE))
            aggs.append(f.from_limbs(tensor_to_u32(agg)))
    secs["aggregate"] = time.perf_counter() - t0
    return aggs, accepted, (lead, help_), msgs, secs


def check_decisions(accepted, tampered) -> None:
    if accepted[tampered].any():
        raise AssertionError("a tampered row was accepted")
    if not accepted[~tampered].all():
        raise AssertionError("a valid row was rejected")


def device_prep(bp, placed, agg_id, route="prep_init_planar", **extra):
    """One batched prepare (``route`` names the BatchedPrio3 method) from
    staged tensors (no host marshal or readback)."""
    kw = dict(placed)
    vk = kw.pop("verify_key_u8")
    return getattr(bp, route)(agg_id, vk, kw.pop("nonces_u8"), **kw, **extra)


def equal_outputs(what: str, got: dict, want: dict, rows=None) -> None:
    """Every output tensor of two prepares equal (on their first ``rows``)."""
    if set(got) != set(want):
        raise AssertionError(f"{what}: outputs {sorted(got)} against {sorted(want)}")
    for k in got:
        a, b = got[k], want[k]
        if rows is not None:
            a, b = a[:rows], b[:rows]
        if a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError(f"{what}: {k} differs")


def keccak_select_bound(last: torch.Tensor, out_words: int) -> dict:
    """The bound of a K2 select call from this run's data: each report
    needs only its own blocks (its final block + 1), read once, and its
    output written once; the chain is the longest report's.  The kernel
    itself runs every report over the longest row's blocks."""
    need = last.to(torch.int64) + 1
    blocks, longest, B = int(need.sum()), int(need.max()), need.numel()
    moved = blocks * 168 + B * (4 * out_words + 4)
    chain = longest * 12 * KECCAK_ROUND_DEPTH * ALU_DEPENDENT_CYCLES / sm_clock_hz() * 1e3
    b = bound(moved, ops((blocks, KECCAK_P12)))
    if chain > b["bound_ms"]:
        b = {"bound_ms": chain, "bound_by": "operations", "bound_kind": "chain"}
    return {**b, "chain_bound_ms": chain, "blocks_needed": blocks}


def kernel_checks(backend, helper_rows, launches):
    """K1-K3 at the histogram path's shapes against their plain versions."""
    from janus_tpu_torch.ops import flp_kernels, keccak_kernels
    from janus_tpu_torch.vdaf.prio3 import USAGE_MEAS_SHARE, USAGE_PROOF_SHARE

    bp, f, flp = backend.bp, backend.bp.f, backend.vdaf.flp
    dev = backend.device
    B = len(helper_rows)
    n = f.n
    seeds, nonces, blinds = helper_byte_rows(helper_rows, dev)
    binder = torch.full((B, 1), 1, dtype=torch.uint8, device=dev)
    out = []

    # K1: the helper's measurement-share squeeze (98 blocks, 4096 words).
    msg = keccak_kernels.padded_message_planes(seeds, bp._dst(USAGE_MEAS_SHARE), binder)
    W = flp.MEAS_LEN * n
    got = keccak_kernels.squeeze(msg, W)
    want = keccak_kernels.squeeze_plain(msg, W)
    nb = -(-W // 42)
    kbound = keccak_bound(msg.numel() * 4 + got.numel() * 4, nb, B)
    out.append({
        "name": "keccak_squeeze", "route": "cuda", "source": "janus_tpu_torch/csrc/keccak.cu",
        "replaces": "janus_tpu/ops/keccak_pallas.py:126", "launches": launches["keccak_squeeze"],
        "max_abs_err": max_abs_err(got, want),
        "ms": cuda_time_ms(lambda: keccak_kernels.squeeze(msg, W), 20),
        "plain_ms": cuda_time_ms(lambda: keccak_kernels.squeeze_plain(msg, W), 1),
        **kbound, "library_ms": None, "tolerance": TOLERANCE,
        "shape": f"in (42, {B}) -> out ({W}, {B}), {nb} blocks",
    })
    meas_st = got
    proofs_st = keccak_kernels.squeeze(
        keccak_kernels.padded_message_planes(seeds, bp._dst(USAGE_PROOF_SHARE), binder), flp.PROOF_LEN * n
    )

    # K2: the joint-rand-part absorb over the funnel-shifted measurement.
    jmsg = bp._jr_part_message(1, blinds, nonces, meas_st)
    got = keccak_kernels.absorb(jmsg, 4)
    want = keccak_kernels.absorb_plain(jmsg, 4)
    na = jmsg.shape[0] // 42
    kbound = keccak_bound(jmsg.numel() * 4 + got.numel() * 4, na, B)
    out.append({
        "name": "keccak_absorb", "route": "cuda", "source": "janus_tpu_torch/csrc/keccak.cu",
        "replaces": "janus_tpu/ops/keccak_pallas.py:166", "launches": launches["keccak_absorb"],
        "max_abs_err": max_abs_err(got, want),
        "ms": cuda_time_ms(lambda: keccak_kernels.absorb(jmsg, 4), 20),
        "plain_ms": cuda_time_ms(lambda: keccak_kernels.absorb_plain(jmsg, 4), 1),
        **kbound, "library_ms": None, "tolerance": TOLERANCE,
        "shape": f"in ({jmsg.shape[0]}, {B}) -> out (4, {B}), {na} blocks",
    })

    # K3: wire evaluations over the real share streams with seeded random
    # coefficients at the path's shapes (top bit clear, so canonical).
    circ = bp.circ
    rand_field = seeded_field(B, n, dev, 7)
    coeffs = (rand_field(circ.chunk), rand_field(circ.calls), rand_field(circ.calls), rand_field(1)[0], rand_field(1)[0])
    args = (f, flp.MEAS_LEN, circ.chunk, meas_st, proofs_st) + coeffs
    ev, od = flp_kernels.wire_evals(*args)
    pev, pod = flp_kernels.wire_evals_plain(*args)
    # Per element of m two products whose reduction waits for the column;
    # per column the two reductions, three products (r_ch, both seeds) and
    # three additions.
    elem = 4 * n  # bytes per field element
    moved = elem * B * (flp.MEAS_LEN + 2 * circ.chunk + circ.chunk + 2 * circ.calls + 2 + 2 * circ.chunk)
    kb = bound(moved, ops((B * flp.MEAS_LEN * 2, WIDE_MAC),
                          (B * circ.chunk, ops((2, WIDE_REDUCE), (3, MONT_MUL), (3, FIELD_ADD)))))
    out.append({
        "name": "flp_wire_evals", "route": "cuda", "source": "janus_tpu_torch/csrc/flp_wire.cu",
        "replaces": "janus_tpu/ops/flp_pallas.py:68", "launches": launches["flp_wire_evals"],
        "max_abs_err": max(max_abs_err(ev, pev), max_abs_err(od, pod)),
        "ms": cuda_time_ms(lambda: flp_kernels.wire_evals(*args), 20),
        "kernel_ms": profiled_kernel_ms(lambda: flp_kernels.wire_evals(*args), "wire_kernel"),
        "host_us": host_us(lambda: flp_kernels.wire_evals(*args)),
        "plain_ms": cuda_time_ms(lambda: flp_kernels.wire_evals_plain(*args), 1),
        **kb, "library_ms": None, "tolerance": TOLERANCE,
        "shape": f"m ({flp.MEAS_LEN * n}, {B}), chunk {circ.chunk}, calls {circ.calls}",
    })
    return out


def combine_check(bp, own, peer_verifiers, launches):
    """K4 on the histogram path's real wires (chunk 316, B 4096) and the
    leader's verifier rows as they arrive, against its plain version, and
    again on the first 128 and 33 reports.  Beside it, the time of the pass
    that put the peer's rows into planes before the kernel read them in
    place (plain PyTorch, same rows)."""
    from janus_tpu_torch.ops.field import storage

    f, chunk = bp.f, bp.circ.chunk
    he, ho = own["wire_ev_pl"], own["wire_od_pl"]
    entry = {
        "name": "flp_combine_decide", "route": "cuda", "source": "janus_tpu_torch/csrc/flp_combine.cu",
        "replaces": "janus_tpu/ops/flp_pallas.py:262", "launches": launches["flp_combine_decide"],
        **combine_measure(f, chunk, he, ho, peer_verifiers),
        "removed_transpose_ms": cuda_time_ms(lambda: storage(peer_verifiers.permute(1, 2, 0)).contiguous(), 20),
        "library_ms": None, "tolerance": TOLERANCE,
    }
    entry["at_batches"] = {
        str(b): combine_measure(f, chunk, he[..., :b].contiguous(), ho[..., :b].contiguous(), peer_verifiers[:b])
        for b in COMBINE_BATCHES
    }
    entry["max_abs_err"] = max([entry["max_abs_err"]] + [v["max_abs_err"] for v in entry["at_batches"].values()])
    return entry


def combine_measure(f, chunk, he, ho, pv) -> dict:
    """K4 on these wires and peer rows against its plain version: the error,
    the times (events, the profiler's kernel time, the wrapper's host time)
    and the bound."""
    from janus_tpu_torch.ops import flp_kernels

    n, B = f.n, he.shape[-1]
    got = flp_kernels.combine_decide(f, chunk, he, ho, pv)
    want = flp_kernels.combine_decide_plain(f, chunk, he, ho, pv)
    # he and ho as int32 and the peer's 2*chunk wires as the int64 words
    # the kernel reads, each once, and g written once; per column 3
    # additions and 1 product, and chunk - 1 additions to fold.
    moved = 2 * 4 * n * B * chunk + 8 * n * B * 2 * chunk + 4 * n * B
    kb = bound(moved, ops((B * chunk, MONT_MUL), (B * (4 * chunk - 1), FIELD_ADD)))
    call = lambda: flp_kernels.combine_decide(f, chunk, he, ho, pv)  # noqa: E731
    return {
        "max_abs_err": max_abs_err(got, want),
        "ms": cuda_time_ms(call, 20),
        "kernel_ms": profiled_kernel_ms(call, "combine_kernel"),
        "host_us": host_us(call),
        "plain_ms": cuda_time_ms(lambda: flp_kernels.combine_decide_plain(f, chunk, he, ho, pv), 1),
        **kb, "shape": f"he/ho ({chunk}, {n}, {B}) int32, peer rows {tuple(pv.shape)} int64 -> g ({n}, {B})",
    }


def sumvec_checks(bp, helper_rows, launches):
    """K5 at (100000, 316, B 1024) on the real helper streams with seeded
    random coefficients, against its plain version, and again at the served
    batch (the first 128 reports of the same inputs).  K1 and K2 timed at the
    SumVec shape, and their outputs in HOST_CHECK_COLUMNS columns spread
    over the batch held against the plain version on the host: the plain
    Keccak is launch-bound (about 6 ms a block on an H100, 2-3 ms on one
    host CPU core at 8 columns), so the whole batch on the card would take
    minutes."""
    from janus_tpu_torch.ops import flp_kernels, keccak_kernels
    from janus_tpu_torch.vdaf.prio3 import USAGE_MEAS_SHARE, USAGE_PROOF_SHARE

    f, flp, circ = bp.f, bp.flp, bp.circ
    dev, n = bp.device, f.n
    seeds, nonces, blinds = helper_byte_rows(helper_rows, dev)
    B = seeds.shape[0]
    binder = torch.full((B, 1), 1, dtype=torch.uint8, device=dev)
    msg = keccak_kernels.padded_message_planes(seeds, bp._dst(USAGE_MEAS_SHARE), binder)
    W = flp.MEAS_LEN * n
    meas_st = keccak_kernels.squeeze(msg, W)
    proofs_st = keccak_kernels.squeeze(
        keccak_kernels.padded_message_planes(seeds, bp._dst(USAGE_PROOF_SHARE), binder), flp.PROOF_LEN * n
    )
    jmsg = bp._jr_part_message(1, blinds, nonces, meas_st)
    jr_part = keccak_kernels.absorb(jmsg, 4)
    nb, na = -(-W // 42), jmsg.shape[0] // 42
    cols = torch.linspace(0, B - 1, HOST_CHECK_COLUMNS).round().long().to(dev)
    shapes = {}
    for name, fn, plain, inp, got, moved, perms, shape in (
        ("keccak_squeeze", lambda: keccak_kernels.squeeze(msg, W), lambda x: keccak_kernels.squeeze_plain(x, W),
         msg, meas_st, msg.numel() * 4 + meas_st.numel() * 4, nb, f"in (42, {B}) -> out ({W}, {B}), {nb} blocks"),
        ("keccak_absorb", lambda: keccak_kernels.absorb(jmsg, 4), lambda x: keccak_kernels.absorb_plain(x, 4),
         jmsg, jr_part, jmsg.numel() * 4 + 4 * 4 * B, na, f"in ({jmsg.shape[0]}, {B}) -> out (4, {B}), {na} blocks"),
    ):
        kbound = keccak_bound(moved, perms, B)
        t0 = time.perf_counter()
        err = max_abs_err(got[:, cols].cpu(), plain(inp[:, cols].cpu().contiguous()))
        shapes[name] = {
            "ms": cuda_time_ms(fn, 3), **kbound, "shape": shape,
            "max_abs_err_host_columns": err, "host_columns": HOST_CHECK_COLUMNS,
            "plain_host_s": time.perf_counter() - t0,
        }
        log(f"{name} at the SumVec shape: {HOST_CHECK_COLUMNS} columns against the plain version on the host, "
            f"max_abs_err {err}, {shapes[name]['plain_host_s']:.2f} s")
    del jmsg, jr_part

    rand_field = seeded_field(B, n, dev, 11)
    coeffs = (rand_field(circ.calls), rand_field(circ.calls), rand_field(1)[0], rand_field(1)[0])
    entry = {
        "name": "flp_sumvec_wires", "route": "cuda", "source": "janus_tpu_torch/csrc/flp_sumvec.cu",
        "replaces": "janus_tpu/ops/flp_pallas.py:129", "launches": launches["flp_sumvec_wires"],
        **sumvec_check(f, flp, circ, meas_st, proofs_st, coeffs),
        "library_ms": None, "tolerance": TOLERANCE,
    }
    # The served path's batch: the first SV_BATCH reports of the same inputs.
    cut = [x[..., :SV_BATCH].contiguous() for x in (meas_st, proofs_st) + coeffs]
    entry["at_served_batch"] = sumvec_check(f, flp, circ, cut[0], cut[1], tuple(cut[2:]))
    entry["max_abs_err"] = max(entry["max_abs_err"], entry["at_served_batch"]["max_abs_err"])
    return entry, shapes


def sumvec_check(f, flp, circ, meas_st, proofs_st, coeffs) -> dict:
    """K5 on these streams and coefficients against its plain version: the
    error, the kernel's and the plain version's times and the bound."""
    from janus_tpu_torch.ops import flp_kernels

    n, B = f.n, meas_st.shape[-1]
    args = (f, flp.MEAS_LEN, circ.chunk, meas_st, proofs_st) + coeffs
    ev, od = flp_kernels.sumvec_wires(*args)
    pev, pod = flp_kernels.sumvec_wires_plain(*args)
    err = max(max_abs_err(ev, pev), max_abs_err(od, pod))
    del pev, pod
    # m, the wire seeds, jr, lagk, lag0, ccorr read once, ev/od written
    # once; per valid (call, column), which is per element of m, what the
    # function needs: the power step jr_k^(u+1) * lag_k (one Montgomery
    # product) and m times it and times lag_k (two products whose reduction
    # waits for the column); per column the two reductions, the seeds'
    # two products and three additions.
    moved = 4 * n * B * (flp.MEAS_LEN + 2 * circ.chunk + 2 * circ.calls + 2 + 2 * circ.chunk)
    kb = bound(moved, ops((B * flp.MEAS_LEN, ops((1, MONT_MUL), (2, WIDE_MAC))),
                          (B * circ.chunk, ops((2, WIDE_REDUCE), (2, MONT_MUL), (3, FIELD_ADD)))))
    return {
        "max_abs_err": err,
        "ms": cuda_time_ms(lambda: flp_kernels.sumvec_wires(*args), 5),
        "plain_ms": cuda_time_ms(lambda: flp_kernels.sumvec_wires_plain(*args), 1, rounds=1),
        **kb, "shape": f"m ({flp.MEAS_LEN * n}, {B}), chunk {circ.chunk}, calls {circ.calls}",
    }


def helper_byte_rows(helper_rows, dev):
    """(share seeds, nonces, joint-rand blinds) of helper rows, (B, 16) each."""
    B = len(helper_rows)

    def u8(rows):
        return torch.from_numpy(np.frombuffer(b"".join(rows), np.uint8).reshape(B, 16).copy()).to(dev)

    return (
        u8([r[2].share_seed for r in helper_rows]),
        u8([r[0] for r in helper_rows]),
        u8([r[2].joint_rand_blind for r in helper_rows]),
    )


def seeded_field(B, n, dev, seed):
    """Random canonical Field128 planes (top bit clear) from a seeded generator."""
    from janus_tpu_torch.ops.field import storage

    gen = torch.Generator(device="cpu").manual_seed(seed)

    def rand_field(elems):
        w = torch.randint(0, 1 << 32, (elems, n, B), generator=gen, dtype=torch.int64)
        w[:, n - 1] >>= 1
        return storage(w).to(dev).contiguous()

    return rand_field


def profile_device(fn) -> dict:
    """One traced call of ``fn``: wall time, device time of the port's
    kernels and of every other device activity, and the number of device
    activities (kernels, copies, fills)."""
    events, wall = traced(fn)
    if not events:
        return {"wall_ms": wall * 1e3, "device": "not measured (the profiler saw no device activity)"}
    port_us = sum(us for name, us in events if any(k in name for k in DEVICE_KERNELS.values()))
    other_us = sum(us for _, us in events) - port_us
    return {
        "wall_ms": wall * 1e3,
        "port_kernels_ms": port_us / 1e3,
        "other_device_ms": other_us / 1e3,
        "device_activities": len(events),
        "device_idle_share": max(0.0, 1.0 - (port_us + other_us) / 1e3 / (wall * 1e3)),
    }


def oracle_sample(vdaf, verify_key, leader_rows, helper_rows, results, rng, count=SAMPLED) -> None:
    """Sampled rows, both sides, against the oracle's prep_init, byte for byte."""
    lead, help_ = results
    for b in rng.choice(len(leader_rows), count, replace=False):
        for agg_id, rows, got in ((0, leader_rows, lead), (1, helper_rows, help_)):
            nonce, public, share = rows[b]
            state, pshare = vdaf.prep_init(verify_key, agg_id, nonce, public, share)
            compare_row(vdaf, b, agg_id, got[b], (pshare.encode(vdaf), state.out_share, state.corrected_joint_rand_seed))


def compare_row(vdaf, b, agg_id, got, want, resident=False) -> None:
    """One served row against the oracle's (prep share bytes, out share,
    seed).  With ``resident`` the row's out share must have stayed on the
    card (a ResidentRef; the drained aggregate holds its value)."""
    from janus_tpu_torch.executor import ResidentRef

    gstate, gshare = got
    if gshare.encode(vdaf) != want[0]:
        raise AssertionError(f"row {b} agg {agg_id}: prepare share differs from the oracle")
    if resident and not isinstance(gstate.out_share, ResidentRef):
        raise AssertionError(f"row {b} agg {agg_id}: out share left the card")
    if not resident and gstate.out_share != want[1]:
        raise AssertionError(f"row {b} agg {agg_id}: out share differs from the oracle")
    if gstate.corrected_joint_rand_seed != want[2]:
        raise AssertionError(f"row {b} agg {agg_id}: joint-rand seed differs from the oracle")


def histogram_phases(vdaf, reports, meas, verify_key, rng, phases):
    """Phases 2 and 3 on the sharded histogram reports.  Returns (kernel
    entries K1-K4, end-to-end record)."""
    from janus_tpu_torch.vdaf.backend import CudaBackend

    leader_rows, helper_rows, tampered, src = build_batch(vdaf, reports, rng, BATCH, TAMPERED)
    backend = CudaBackend(vdaf, device=DEVICE)
    bp = backend.bp

    # A warm-up pass settles allocator and library state; the counted run
    # below starts from zero.
    run_main_path(vdaf, backend, verify_key, leader_rows[:128], helper_rows[:128])
    t0 = time.perf_counter()
    (aggs, accepted, results, msgs, secs), launches = counted(
        "histogram served path", KERNEL_NAMES[:3],
        lambda: run_main_path(vdaf, backend, verify_key, leader_rows, helper_rows),
    )
    e2e = time.perf_counter() - t0
    got = vdaf.unshard(aggs, int(accepted.sum()))
    want = np.bincount(np.array(meas)[src[~tampered]], minlength=LENGTH).tolist()
    if got != want:
        raise AssertionError("aggregate differs from the expected histogram")
    check_decisions(accepted, tampered)
    log(f"aggregate: exact over {int(accepted.sum())} accepted rows; {int(tampered.sum())} tampered rows rejected; "
        f"oracle recomputed rows {backend.oracle_recompute_rows}")
    oracle_sample(vdaf, verify_key, leader_rows, helper_rows, results, rng)
    log(f"oracle: {SAMPLED} sampled rows match on both sides")
    phases["histogram_served"] = time.perf_counter() - t0

    # Device time of one batched prepare per side (no host marshal/readback).
    t0 = time.perf_counter()
    staged = {a: backend.stage_prep_init_multi(a, [(verify_key, rows)]) for a, rows in ((0, leader_rows), (1, helper_rows))}
    dev_ms = {a: cuda_time_ms(lambda a=a: device_prep(bp, staged[a].placed, a), 2) for a in (0, 1)}
    profile = {side: profile_device(lambda a=a: device_prep(bp, staged[a].placed, a)) for side, a in PROFILED_SIDES}
    phases["histogram_device_timing"] = time.perf_counter() - t0

    # Phase 3: the planar combine on the same staged batch (helper's view).
    t0 = time.perf_counter()

    def planar_path():
        lead = device_prep(bp, staged[0].placed, 0)
        own = device_prep(bp, staged[1].placed, 1, keep_planar=True)
        parts = [lead["joint_rand_part"], own["joint_rand_part"]]
        return lead, own, parts, bp.prep_shares_to_prep_planar(own, lead["verifiers"], parts)

    (lead, own, parts, planar), planar_launches = counted("histogram planar combine", KERNEL_NAMES[:4], planar_path)
    decide = planar["decide"].cpu().numpy()
    if not np.array_equal(decide, accepted):
        raise AssertionError("planar combine: decide differs from the served combine")
    seeds = planar["prep_msg_seed"].cpu().numpy()
    if any(seeds[b].tobytes() != msgs[b] for b in np.flatnonzero(accepted)):
        raise AssertionError("planar combine: prep-message seed differs from the served combine")
    help_rows = device_prep(bp, staged[1].placed, 1)
    row = bp.prep_shares_to_prep([lead["verifiers"], help_rows["verifiers"]], parts)
    if not torch.equal(row["prep_msg_seed"], planar["prep_msg_seed"]) or not torch.equal(row["decide"], planar["decide"]):
        raise AssertionError("planar combine: differs from the row-major device combine")
    combine_ms = {
        "planar": cuda_time_ms(lambda: bp.prep_shares_to_prep_planar(own, lead["verifiers"], parts), 5),
        "row_major": cuda_time_ms(lambda: bp.prep_shares_to_prep([lead["verifiers"], help_rows["verifiers"]], parts), 5),
    }
    log(f"planar combine: decide and seed equal the served combine on all {BATCH} rows "
        f"({int((~accepted).sum())} rejected); device ms {json.dumps(combine_ms)}")
    phases["histogram_planar_combine"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    row_ms = histogram_row_phase(bp, staged)
    phases["histogram_row_path"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    kernels = kernel_checks(backend, helper_rows, launches)
    kernels.append(combine_check(bp, own, lead["verifiers"], planar_launches))
    phases["histogram_kernel_checks"] = time.perf_counter() - t0
    record = {
        "reports": BATCH,
        "seconds": e2e,
        "reports_per_s": BATCH / e2e,
        "phases_s": secs,
        "device_prep_init_ms": {"leader": dev_ms[0], "helper": dev_ms[1]},
        "device_prep_init_profile": profile,
        "device_combine_ms": combine_ms,
        "device_prep_init_row_path_ms": row_ms,
    }
    return kernels, record, (leader_rows, helper_rows, tampered, src)


def histogram_row_phase(bp, staged) -> dict:
    """Phase 7: the row path on phase 2's staged B = 4096 inputs, both
    sides, against the planar path's every output; both paths' device ms."""
    def row_path():
        return {a: device_prep(bp, staged[a].placed, a, "prep_init") for a in (0, 1)}

    row, launches = counted("histogram row path", KERNEL_NAMES[:2], row_path)
    no_flp_kernels("histogram row path", launches)
    for a in (0, 1):
        equal_outputs(f"histogram row path, agg {a}", row[a], device_prep(bp, staged[a].placed, a))
    del row
    ms = {
        route: {side: cuda_time_ms(lambda a=a, route=route: device_prep(bp, staged[a].placed, a, route), 2)
                for side, a in (("leader", 0), ("helper", 1))}
        for route in ("prep_init_planar", "prep_init")
    }
    log(f"histogram row path at B = {BATCH}: every output equals the planar path's on both sides; "
        f"device ms {json.dumps(ms)}")
    return ms


def served_phase(name, vdaf, reports, meas, verify_key, rng, batch, tampered, route, needs, expect, sampled=SAMPLED):
    """One served flush of ``batch`` rows built from ``reports`` (``tampered``
    of them perturbed) through CudaBackend, both sides, combined and
    aggregated: the route is the chooser's, the aggregate equals
    ``expect(valid measurements)``, every tampered row is rejected and
    ``sampled`` rows equal the oracle.  Returns (backend, (leader rows,
    helper rows), results, record)."""
    from janus_tpu_torch.vdaf.backend import CudaBackend

    leader_rows, helper_rows, bad, src = build_batch(vdaf, reports, rng, batch, tampered)
    backend = CudaBackend(vdaf, device=DEVICE)
    require_route(backend, batch, route)
    t0 = time.perf_counter()
    (aggs, accepted, results, _msgs, secs), launches = counted(
        f"{name} served path", needs, lambda: run_main_path(vdaf, backend, verify_key, leader_rows, helper_rows)
    )
    e2e = time.perf_counter() - t0
    no_flp_kernels(name, launches)
    if vdaf.unshard(aggs, int(accepted.sum())) != expect([meas[i] for i in src[~bad]]):
        raise AssertionError(f"{name}: aggregate differs from the exact aggregate of the valid rows")
    check_decisions(accepted, bad)
    oracle_sample(vdaf, verify_key, leader_rows, helper_rows, results, rng, sampled)
    log(f"{name}: {batch} reports through {route}; exact aggregate over {int(accepted.sum())} rows; "
        f"{int(bad.sum())} tampered rows rejected; {sampled} sampled rows equal the oracle on both sides; "
        f"oracle recomputed rows {backend.oracle_recompute_rows}")
    record = {"reports": batch, "route": route, "seconds": e2e, "reports_per_s": batch / e2e, "phases_s": secs}
    return backend, (leader_rows, helper_rows), results, record


def staged_ms(bp, staged, route, reps) -> dict:
    """Device ms of one prepare a side on staged tensors (CUDA events)."""
    return {side: cuda_time_ms(lambda a=a: device_prep(bp, staged[a], a, route), reps)
            for side, a in (("leader", 0), ("helper", 1))}


def keccak_path_checks(bp, lead, helper, usage: int, elems: int, plain_rounds: int = 3) -> dict:
    """K1 at a path's helper share squeeze (``elems`` field elements of the
    stream ``usage`` names) and, where the circuit has joint randomness, K2
    at its leader's joint-rand-part absorb of agg_id || nonce || enc(meas),
    on the path's staged inputs, the whole batch, against their plain
    versions on the card; timed, with their bounds.  ``plain_rounds`` 0
    times the plain version on the one call that is compared (it takes
    seconds a call at the longest shapes).  Returns {kernel: entry}."""
    from janus_tpu_torch.ops import keccak_kernels
    from janus_tpu_torch.ops.field import words
    from janus_tpu_torch.ops.keccak import words_to_bytes
    from janus_tpu_torch.vdaf.prio3 import USAGE_JOINT_RAND_PART

    B = helper["share_seeds_u8"].shape[0]
    W = elems * bp.f.n
    binder = torch.ones((B, 1), dtype=torch.uint8, device=DEVICE)
    msg = keccak_kernels.padded_message_planes(helper["share_seeds_u8"], bp._dst(usage), binder)
    nb = -(-W // 42)
    checks = [("keccak_squeeze", keccak_kernels.squeeze, keccak_kernels.squeeze_plain, msg, W, nb,
               f"in (42, {B}) -> out ({W}, {B}), {nb} blocks")]
    if bp.flp.JOINT_RAND_LEN:
        part_binder = torch.cat([torch.zeros((B, 1), dtype=torch.uint8, device=DEVICE), lead["nonces_u8"],
                                 words_to_bytes(words(lead["meas_limbs"]).reshape(B, -1))], dim=-1)
        jmsg = keccak_kernels.padded_message_planes(lead["blinds_u8"], bp._dst(USAGE_JOINT_RAND_PART), part_binder)
        na = jmsg.shape[0] // 42
        checks.append(("keccak_absorb", keccak_kernels.absorb, keccak_kernels.absorb_plain, jmsg, 4, na,
                       f"in ({jmsg.shape[0]}, {B}) -> out (4, {B}), {na} blocks"))
    shapes = {}
    for name, fn, plain, inp, out_words, perms, shape in checks:
        got = fn(inp, out_words)
        if plain_rounds:
            want = plain(inp, out_words)
            plain_ms = cuda_time_ms(lambda plain=plain, inp=inp, w=out_words: plain(inp, w), 1, rounds=plain_rounds)
        else:
            want, plain_ms = one_call_ms(lambda plain=plain, inp=inp, w=out_words: plain(inp, w))
        shapes[name] = {
            "max_abs_err": max_abs_err(got, want),
            "ms": cuda_time_ms(lambda fn=fn, inp=inp, w=out_words: fn(inp, w), 10),
            "plain_ms": plain_ms,
            **keccak_bound(inp.numel() * 4 + got.numel() * 4, perms, B), "shape": shape,
        }
        del got, want
    return shapes


def one_call_ms(fn):
    """(result, device ms) of one call of ``fn`` between CUDA events."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def count_phase(verify_key, rng, phases):
    """Phase 8: Prio3Count at 10,000 reports, one flush (row path); K1 at
    the flush's proof-share squeeze.  Returns (record, K1 entry at the flush)."""
    from janus_tpu_torch.vdaf.instances import prio3_count
    from janus_tpu_torch.vdaf.prio3 import USAGE_PROOF_SHARE

    vdaf = prio3_count()
    t0 = time.perf_counter()
    reports, meas = shard_reports(vdaf, rng, lambda r: int(r.integers(0, 2)))
    shard_s = time.perf_counter() - t0
    backend, rows, _results, record = served_phase(
        "count", vdaf, reports, meas, verify_key, rng, COUNT_REPORTS, TAMPERED, "prep_init", ("keccak_squeeze",), sum,
    )
    bp = backend.bp
    staged = {a: backend.stage_prep_init_multi(a, [(verify_key, rows[a])]).placed for a in (0, 1)}
    record.update(shard_s=shard_s, device_batch=backend._pad_to(COUNT_REPORTS),
                  device_prep_init_ms=staged_ms(bp, staged, "prep_init", 2))
    shapes = keccak_path_checks(bp, staged[0], staged[1], USAGE_PROOF_SHARE, vdaf.flp.PROOF_LEN)
    log(f"count: device ms at B = {record['device_batch']} {json.dumps(record['device_prep_init_ms'])}")
    phases["count"] = time.perf_counter() - t0
    return record, shapes


def sum_phase(verify_key, rng, phases):
    """Phase 9: Prio3Sum(32) at 100,000 reports, one flush (row path); its
    first 4,096 reports as their own flush, row for row equal; the row path
    on the card at both sizes; K1 and K2 at the large flush's shapes.
    Returns (record, K1/K2 entries at the flush)."""
    from janus_tpu_torch.vdaf.instances import prio3_sum
    from janus_tpu_torch.vdaf.prio3 import USAGE_PROOF_SHARE

    vdaf = prio3_sum(SUM_BITS)
    t0 = time.perf_counter()
    reports, meas = shard_reports(vdaf, rng, lambda r: int(r.integers(0, 1 << SUM_BITS)))
    shard_s = time.perf_counter() - t0
    needs = ("keccak_squeeze", "keccak_absorb")
    backend, (leader_rows, helper_rows), results, record = served_phase(
        "sum", vdaf, reports, meas, verify_key, rng, SUM_REPORTS, TAMPERED, "prep_init", needs, sum,
    )
    bp = backend.bp

    # The first SUM_SMALL_FLUSH reports as their own flush.
    t1 = time.perf_counter()
    small_rows = (leader_rows[:SUM_SMALL_FLUSH], helper_rows[:SUM_SMALL_FLUSH])
    require_route(backend, SUM_SMALL_FLUSH, "prep_init")
    small, small_launches = counted(
        "sum small flush", needs,
        lambda: [backend.prep_init_multi(a, [(verify_key, small_rows[a])])[0] for a in (0, 1)],
    )
    no_flp_kernels("sum small flush", small_launches)
    for a in (0, 1):
        for b in range(SUM_SMALL_FLUSH):
            st, ps = results[a][b]
            compare_row(vdaf, b, a, small[a][b], (ps.encode(vdaf), st.out_share, st.corrected_joint_rand_seed))
    record["small_flush_seconds"] = time.perf_counter() - t1
    log(f"sum: the first {SUM_SMALL_FLUSH} reports as their own flush equal the {SUM_REPORTS}-report flush "
        f"row for row on both sides")

    # On the card: the small flush's staged inputs, and those tiled to the
    # large flush's padded size.
    staged = {a: backend.stage_prep_init_multi(a, [(verify_key, small_rows[a])]).placed for a in (0, 1)}
    tiled = {a: {k: v.repeat((SUM_TILE,) + (1,) * (v.dim() - 1)) for k, v in staged[a].items()} for a in (0, 1)}
    B = SUM_SMALL_FLUSH * SUM_TILE
    record.update(
        shard_s=shard_s,
        device_prep_init_ms={
            f"prep_init at B = {SUM_SMALL_FLUSH}": staged_ms(bp, staged, "prep_init", 2),
            f"prep_init at B = {B}": staged_ms(bp, tiled, "prep_init", 1),
        },
    )
    log(f"sum: device ms {json.dumps(record['device_prep_init_ms'])}")
    shapes = keccak_path_checks(bp, tiled[0], tiled[1], USAGE_PROOF_SHARE, vdaf.flp.PROOF_LEN)
    phases["sum"] = time.perf_counter() - t0
    return record, shapes


def sumvec_bits_phase(verify_key, rng, shards, phases):
    """Phase 10: Prio3SumVec(1000, 8, 89) at 64 reports through the row
    path; K1 at its measurement-share squeeze and K2 at its joint-rand-part
    absorb.  Returns (record, K1/K2 entries at its shapes)."""
    from janus_tpu_torch.vdaf.instances import prio3_sum_vec
    from janus_tpu_torch.vdaf.prio3 import USAGE_MEAS_SHARE

    t0 = time.perf_counter()
    meas = [m for m, _ in shards]
    reports = [r for _, r in shards]
    vdaf = prio3_sum_vec(*SV8)
    backend, rows, _results, record = served_phase(
        "sumvec bits=8", vdaf, reports, meas, verify_key, rng, SV8_REPORTS, 1, "prep_init",
        ("keccak_squeeze", "keccak_absorb"), lambda valid: np.sum(valid, axis=0).tolist(), sampled=SV8_SAMPLED,
    )
    staged = {a: backend.stage_prep_init_multi(a, [(verify_key, rows[a])]).placed for a in (0, 1)}
    # The plain Keccak takes some milliseconds a block, so one timed round.
    shapes = keccak_path_checks(backend.bp, staged[0], staged[1], USAGE_MEAS_SHARE, vdaf.flp.MEAS_LEN, plain_rounds=0)
    phases["sumvec_bits8"] = time.perf_counter() - t0
    return record, shapes


def sumvec_phases(verify_key, rng, done, phases):
    """Phases 4 and 5 and the K5 check on the workers' results.  Returns (K5
    entry, K1/K2 at the SumVec shape, end-to-end record)."""
    from janus_tpu_torch.ops.field import tensor_to_u32
    from janus_tpu_torch.vdaf.backend import CudaBackend
    from janus_tpu_torch.vdaf.instances import prio3_sum_vec

    shard_s = [d[3] for d in done]
    log(f"shard: {SV_DISTINCT} SumVec100k reports in {json.dumps(shard_s)} s (worker processes, in parallel); "
        f"oracle prep_init of both sides {json.dumps([d[4] for d in done])} s")
    meas = [d[0] for d in done]
    reports = [d[1] for d in done]
    oracle = [d[2] for d in done]
    vdaf = prio3_sum_vec(SV_LENGTH, 1, SV_CHUNK)
    p = vdaf.flp.field.MODULUS
    leader_rows, helper_rows, tampered, src = build_batch(vdaf, reports, rng, SV_BATCH, SV_TAMPERED)
    backend = CudaBackend(vdaf, device=DEVICE)
    bp = backend.bp

    # Phase 4: the served path at B = 128.
    t0 = time.perf_counter()
    (aggs, accepted, results, _msgs, secs), sv_launches = counted(
        "sumvec served path", ("keccak_squeeze", "keccak_absorb", "flp_sumvec_wires"),
        lambda: run_main_path(vdaf, backend, verify_key, leader_rows, helper_rows),
    )
    e2e = time.perf_counter() - t0
    valid_sum = np.sum([meas[i] for i in src[~tampered]], axis=0).tolist()
    if vdaf.unshard(aggs, int(accepted.sum())) != valid_sum:
        raise AssertionError("SumVec aggregate differs from the exact sum of the valid rows")
    check_decisions(accepted, tampered)
    for i in range(SV_DISTINCT):
        b = int(np.flatnonzero((src == i) & ~tampered)[0])
        for agg_id, side in ((0, results[0]), (1, results[1])):
            compare_row(vdaf, b, agg_id, side[b], oracle[i][agg_id])
    log(f"sumvec: exact aggregate over {int(accepted.sum())} rows; {int(tampered.sum())} tampered rows rejected; "
        f"one row per side per report equals the oracle; oracle recomputed rows {backend.oracle_recompute_rows}")
    phases["sumvec_served"] = time.perf_counter() - t0

    # Phase 5: the staged rows tiled x8 on the card, BatchedPrio3 directly.
    t0 = time.perf_counter()
    staged = {a: backend.stage_prep_init_multi(a, [(verify_key, rows)]) for a, rows in ((0, leader_rows), (1, helper_rows))}
    tiled = {a: {k: v.repeat((SV_TILE,) + (1,) * (v.dim() - 1)) for k, v in staged[a].placed.items()} for a in (0, 1)}
    del staged
    torch.cuda.reset_peak_memory_stats()

    def device_path():
        lead = device_prep(bp, tiled[0], 0)
        help_ = device_prep(bp, tiled[1], 1)
        res = bp.prep_shares_to_prep([lead["verifiers"], help_["verifiers"]], [lead["joint_rand_part"], help_["joint_rand_part"]])
        ok = lead["ok"] & help_["ok"]
        return ok, res["decide"], [bp.aggregate(o["out_share"], res["decide"]) for o in (lead, help_)]

    (ok, decide, dev_aggs), dev_launches = counted(
        "sumvec device path", ("keccak_squeeze", "keccak_absorb", "flp_sumvec_wires"), device_path
    )
    peak = torch.cuda.max_memory_allocated()
    if not bool(ok.all()):
        raise AssertionError("sumvec device path: a row was flagged for the oracle")
    if not np.array_equal(decide.cpu().numpy(), np.tile(accepted, SV_TILE)):
        raise AssertionError("sumvec device path: decide differs from 8x the B = 128 decisions")
    f = bp.f
    for side, agg in enumerate(dev_aggs):
        got = f.from_limbs(tensor_to_u32(agg))
        if got != [SV_TILE * x % p for x in aggs[side]]:
            raise AssertionError("sumvec device path: aggregate differs from 8x the B = 128 aggregate")
    del ok, decide, dev_aggs
    dev_ms = {a: cuda_time_ms(lambda a=a: device_prep(bp, tiled[a], a), 2) for a in (0, 1)}
    profile = {side: profile_device(lambda a=a: device_prep(bp, tiled[a], a)) for side, a in PROFILED_SIDES}
    log(f"sumvec device path at B = {SV_BATCH * SV_TILE}: decide and aggregate equal {SV_TILE}x the B = {SV_BATCH} results; "
        f"peak memory {peak} bytes")
    phases["sumvec_device"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    del tiled
    entry, shapes = sumvec_checks(bp, helper_rows * SV_TILE, sv_launches)
    phases["sumvec_kernel_checks"] = time.perf_counter() - t0
    record = {
        "reports": SV_BATCH,
        "seconds": e2e,
        "reports_per_s": SV_BATCH / e2e,
        "phases_s": secs,
        "shard_s": shard_s,
        "device_batch": SV_BATCH * SV_TILE,
        "device_prep_init_ms": {"leader": dev_ms[0], "helper": dev_ms[1]},
        "device_prep_init_profile": profile,
        "device_launches": dev_launches,
        "device_peak_memory_bytes": peak,
    }
    return entry, shapes, record, ((leader_rows, helper_rows, tampered, src), aggs, oracle)


def decoded_leader_rows(vdaf, rows):
    """Leader rows whose input shares went through ``encode`` and ``decode``,
    as an upload delivers them (one decode per distinct share object, which
    tiled rows share)."""
    from janus_tpu_torch.vdaf.prio3 import Prio3InputShare

    decoded = {}
    out = []
    for nonce, public, share in rows:
        if id(share) not in decoded:
            decoded[id(share)] = Prio3InputShare.decode(vdaf, 0, share.encode(vdaf))
        out.append((nonce, public, decoded[id(share)]))
    return out


def check_byte_marshal(backend, rows) -> int:
    """The leader marshal of decoded shares (read from the bytes they
    arrived in) against ``to_limbs`` of the same shares' values, on one row
    per distinct share object.  Returns the rows held."""
    from janus_tpu_torch.vdaf.backend import leader_limbs

    distinct = list({id(r[2]): r for r in rows}.values())
    if not all(r[2].encoded_vectors is not None for r in distinct):
        raise AssertionError("a decoded leader share does not carry its bytes")
    f, B = backend.bp.f, len(distinct)
    got = leader_limbs(backend.vdaf, distinct, backend.leader_marshal_rows)
    want = [f.to_limbs([x for r in distinct for x in getattr(r[2], name)]).reshape(B, -1, f.n)
            for name in ("meas_share", "proofs_share")]
    if not all(np.array_equal(g, w) for g, w in zip(got, want)):
        raise AssertionError("the byte-marshalled leader limbs differ from to_limbs of the same shares")
    return B


def executor_for(vdaf, batch: int, warmup: bool, make=None):
    """A ``DeviceExecutor`` with the accumulator at its default budget
    whose flushes close at ``batch`` rows, and a ``make_backend(vdaf,
    "cuda")`` backend a side (``make()`` where given; leader 0, helper 1),
    each warmed at ``batch``
    (kernel build and one launch) when ``warmup`` is set.  The warmup's synthetic row is read
    back; each backend's readback count then restarts at 0 for the job.
    Returns (executor, backends, warmup seconds or None)."""
    from janus_tpu_torch.executor import AccumulatorConfig, DeviceExecutor, ExecutorConfig
    from janus_tpu_torch.vdaf.backend import make_backend

    ex = DeviceExecutor(ExecutorConfig(flush_max_rows=batch, accumulator=AccumulatorConfig(enabled=True)))
    backends = {a: make() if make else make_backend(vdaf, "cuda", device=DEVICE) for a in (0, 1)}
    warm_s = None
    if warmup:
        t0 = time.perf_counter()
        for a, backend in backends.items():
            ex.warmup_backend(backend, agg_ids=(a,), pad_to=batch)
            backend.outshare_readback_rows = 0
        warm_s = time.perf_counter() - t0
    return ex, backends, warm_s


def executor_job(vdaf, ex, backends, verify_key, leader_rows, helper_rows, jobs):
    """One aggregation job of both sides through the executor ``ex`` and its
    accumulator: each side's rows of the task ``vdaf`` as ``jobs``
    submissions of equal size with ``retain_out_shares`` to its backend
    (``backends[agg_id]``, the task's own or its bucket's twin), one prepare
    flush a side; the combine through the executor's combine kind on the
    helper's backend; the accepted rows' out shares committed per job and
    drained per side.  Shuts ``ex`` down.  Returns (drained aggregate
    shares, accepted mask, (leader, helper) outcomes, record)."""
    import asyncio

    from janus_tpu_torch.core import trace
    from janus_tpu_torch.executor import KIND_COMBINE, KIND_PREP_INIT, ResidentRef
    from janus_tpu_torch.vdaf.backend import prep_request
    from janus_tpu_torch.vdaf.canonical import backend_shape_key

    B = len(leader_rows)
    size = B // jobs
    key = backend_shape_key(backends[0])
    secs = {}
    spans = []
    sink = lambda name, cat, start, dur, args: spans.append((name, dur))  # noqa: E731
    trace.register_span_sink(sink)

    async def prep(agg_id, rows):
        outs = await asyncio.gather(*[
            ex.submit(key, KIND_PREP_INIT, prep_request(backends[agg_id], verify_key, rows[j * size:(j + 1) * size], vdaf),
                      backend=backends[agg_id], agg_id=agg_id, retain_out_shares=True)
            for j in range(jobs)
        ])
        return [o for job in outs for o in job]

    async def combine(lead, help_):
        pairs = [[lead[b][1], help_[b][1]] for b in range(B)]
        outs = await asyncio.gather(*[
            ex.submit(key, KIND_COMBINE, pairs[j * size:(j + 1) * size], backend=backends[1]) for j in range(jobs)
        ])
        return [o for job in outs for o in job]

    async def job():
        t0 = time.perf_counter()
        lead = await prep(0, leader_rows)
        secs["leader_prep_init"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        help_ = await prep(1, helper_rows)
        secs["helper_prep_init"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        msgs = await combine(lead, help_)
        secs["combine"] = time.perf_counter() - t0
        return lead, help_, msgs

    try:
        t_job = time.perf_counter()
        lead, help_, msgs = asyncio.run(job())
        accepted = np.zeros(B, dtype=bool)
        for b, msg in enumerate(msgs):
            if isinstance(msg, Exception):
                continue
            vdaf.prep_next(lead[b][0], msg)
            vdaf.prep_next(help_[b][0], msg)
            accepted[b] = True
        t0 = time.perf_counter()
        store = ex.accumulator
        field = vdaf.flp.field
        for side, outcomes in enumerate((lead, help_)):
            for j in range(jobs):
                shares = [(b, outcomes[b][0].out_share) for b in range(j * size, (j + 1) * size)]
                # rows the oracle recomputed carry field vectors, not refs
                refs = [(b, s) for b, s in shares if accepted[b] and isinstance(s, ResidentRef)]
                host = [(b, s) for b, s in shares if accepted[b] and not isinstance(s, ResidentRef)]
                store.commit_rows(("job", side), backends[side], [s for _, s in refs], job_token=j,
                                  report_ids=[leader_rows[b][0] for b, _ in refs])
                store.commit_host_rows(("job", side), field, [s for _, s in host], job_token=j,
                                       report_ids=[leader_rows[b][0] for b, _ in host])
                store.release_refs([s for b, s in shares if not accepted[b] and isinstance(s, ResidentRef)])
        torch.cuda.synchronize()
        secs["commit"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        aggs = [store.drain(("job", side), field)[0] for side in (0, 1)]
        secs["drain"] = time.perf_counter() - t0
        e2e = time.perf_counter() - t_job
        stats = ex.stats()
        flights = ex.flight_recorder.snapshot(16)
        store_stats = store.stats()
    finally:
        trace.unregister_span_sink(sink)
        ex.shutdown()
    for a in (0, 1):
        label = next(k for k in stats if f"/a{a}/prep_init#" in k)
        if stats[label]["flushes"] != 1 or stats[label]["flushed_jobs"] != jobs:
            raise AssertionError(f"executor: {label} ran {stats[label]} (one flush of {jobs} jobs expected)")
    readback = {a: b.outshare_readback_rows for a, b in backends.items()}
    if any(readback.values()):
        raise AssertionError(f"executor: out-share rows were read back: {readback}")
    if store_stats["flushes_resident"] or store_stats["resident_bytes"] or store_stats["evictions"]:
        raise AssertionError(f"executor: the store evicted state or still holds it after the drain: {store_stats}")
    prep_flights = {r["bucket"].split("#")[0]: r for r in flights if "/prep_init" in r["bucket"]}
    span_s = {}
    for name, dur in spans:
        span_s.setdefault(name, []).append(dur)
    record = {
        "reports": B, "jobs": jobs, "seconds": e2e, "reports_per_s": B / e2e, "phases_s": secs,
        "stage_launch_s": {k: {"stage": r["stage_ms"] / 1e3, "launch": r["launch_ms"] / 1e3} for k, r in prep_flights.items()},
        "verifier_conversion_s": {("leader", "helper")[a]: dict(b.host_seconds) for a, b in backends.items()},
        "spans_s": {k: {"count": len(v), "total": sum(v), "max": max(v)} for k, v in span_s.items()},
        "executor_stats": stats, "accumulator": store_stats, "outshare_readback_rows": readback,
    }
    return aggs, accepted, (lead, help_), record


def histogram_executor_phase(vdaf, verify_key, batch, meas, rng, phases):
    """Phase 11: phase 2's batch through the executor and the accumulator,
    both sides, as 4 jobs of 1,024 rows.  Returns the record."""
    leader_rows, helper_rows, tampered, src = batch
    t0 = time.perf_counter()
    leader_rows = decoded_leader_rows(vdaf, leader_rows)
    decode_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ex, backends, warm_s = executor_for(vdaf, len(leader_rows), warmup=True)
    (aggs, accepted, results, record), _ = counted(
        "histogram executor path", KERNEL_NAMES[:3],
        lambda: executor_job(vdaf, ex, backends, verify_key, leader_rows, helper_rows, EXECUTOR_JOBS),
    )
    record["warmup_s"] = warm_s
    want = np.bincount(np.array(meas)[src[~tampered]], minlength=LENGTH).tolist()
    if vdaf.unshard(aggs, int(accepted.sum())) != want:
        raise AssertionError("histogram executor path: drained aggregate differs from the expected histogram")
    check_decisions(accepted, tampered)
    for b in rng.choice(len(leader_rows), SAMPLED, replace=False):
        for agg_id, rows in ((0, leader_rows), (1, helper_rows)):
            nonce, public, share = rows[b]
            state, pshare = vdaf.prep_init(verify_key, agg_id, nonce, public, share)
            compare_row(vdaf, b, agg_id, results[agg_id][b], (pshare.encode(vdaf), None, state.corrected_joint_rand_seed),
                        resident=True)
    record["byte_marshal_rows_checked"] = check_byte_marshal(backends[0], leader_rows)
    record["leader_decode_s"] = decode_s
    log(f"histogram executor path: one flush a side of {EXECUTOR_JOBS} jobs; drained aggregate exact over "
        f"{int(accepted.sum())} rows; {int(tampered.sum())} tampered rows rejected; no out-share readback; "
        f"{SAMPLED} sampled rows' prepare shares equal the oracle; job {record['seconds']:.3f} s")
    phases["histogram_executor"] = time.perf_counter() - t0
    return record


def sumvec_executor_phase(vdaf, verify_key, batch, served_aggs, oracle, phases):
    """Phase 12: phase 4's served batch tiled x8 to B = 1024 through the
    executor and the accumulator, 4 jobs of 256 rows.  Returns the record."""
    leader_rows, helper_rows, tampered, src = batch
    p = vdaf.flp.field.MODULUS
    t0 = time.perf_counter()
    leader_rows = decoded_leader_rows(vdaf, leader_rows) * SV_TILE
    helper_rows = helper_rows * SV_TILE
    decode_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ex, backends, _ = executor_for(vdaf, len(leader_rows), warmup=False)
    torch.cuda.reset_peak_memory_stats()
    (aggs, accepted, results, record), _ = counted(
        "sumvec executor path", ("keccak_squeeze", "keccak_absorb", "flp_sumvec_wires"),
        lambda: executor_job(vdaf, ex, backends, verify_key, leader_rows, helper_rows, EXECUTOR_JOBS),
    )
    record["device_peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    for side in (0, 1):
        if aggs[side] != [SV_TILE * x % p for x in served_aggs[side]]:
            raise AssertionError("sumvec executor path: drained aggregate differs from 8x the B = 128 aggregate")
    check_decisions(accepted, np.tile(tampered, SV_TILE))
    for i in range(SV_DISTINCT):
        b = int(np.flatnonzero((src == i) & ~tampered)[0])
        for agg_id in (0, 1):
            compare_row(vdaf, b, agg_id, results[agg_id][b], oracle[i][agg_id], resident=True)
    record["byte_marshal_rows_checked"] = check_byte_marshal(backends[0], leader_rows)
    record["leader_decode_s"] = decode_s
    log(f"sumvec executor path at B = {len(leader_rows)}: one flush a side of {EXECUTOR_JOBS} jobs; drained aggregate "
        f"equals {SV_TILE}x the B = {SV_BATCH} aggregate; {int((~accepted).sum())} tampered rows rejected; no out-share "
        f"readback; job {record['seconds']:.3f} s; peak memory {record['device_peak_memory_bytes']} bytes")
    phases["sumvec_executor"] = time.perf_counter() - t0
    return record


def fixedpoint_phase(verify_key, rng, fp_done, phases):
    """Phase 14: FixedPointBoundedL2VecSum(BitSize16, 1000) at B = 1024 on
    the direct path and through the executor, both sides; K1/K2 at its
    shapes.  Returns (record, K1/K2 entries at its shapes)."""
    from janus_tpu_torch.vdaf.backend import CudaBackend
    from janus_tpu_torch.vdaf.instances import vdaf_from_instance
    from janus_tpu_torch.vdaf.prio3 import USAGE_MEAS_SHARE

    t0 = time.perf_counter()
    vdaf = vdaf_from_instance(FP_DESC)
    shards = [x for done, _lie, _s in fp_done for x in done]
    lies = [lie for _done, lie, _s in fp_done]
    meas, reports, oracle = zip(*shards)
    # Tiled valid rows and rows with a perturbed leader share, then the
    # norm-lie rows, shuffled together.
    leader_rows, helper_rows, bad, src = build_batch(vdaf, list(reports), rng, FP_BATCH - FP_LIE_ROWS, FP_TAMPERED)
    lie_rows = [lies[i % len(lies)] for i in range(FP_LIE_ROWS)]
    order = rng.permutation(FP_BATCH)
    leader_rows = [(leader_rows + [(n, p, s[0]) for n, p, s in lie_rows])[j] for j in order]
    helper_rows = [(helper_rows + [(n, p, s[1]) for n, p, s in lie_rows])[j] for j in order]
    bad = np.concatenate([bad, np.ones(FP_LIE_ROWS, dtype=bool)])[order]
    src = np.concatenate([src, -np.ones(FP_LIE_ROWS, dtype=src.dtype)])[order]
    leader_rows = decoded_leader_rows(vdaf, leader_rows)
    build_s = time.perf_counter() - t0

    backend = CudaBackend(vdaf, device=DEVICE)
    bp = backend.bp
    require_route(backend, FP_BATCH, "prep_init")
    t0 = time.perf_counter()
    (aggs, accepted, results, _msgs, secs), launches = counted(
        "fixedpoint served path", ("keccak_squeeze", "keccak_absorb"),
        lambda: run_main_path(vdaf, backend, verify_key, leader_rows, helper_rows),
    )
    e2e = time.perf_counter() - t0
    no_flp_kernels("fixedpoint", launches)
    valid = [meas[i] for i in src[~bad]]
    want = [sum(m[j] for m in valid) for j in range(FP_DESC["length"])]
    if vdaf.unshard(aggs, int(accepted.sum())) != want:
        raise AssertionError("fixedpoint: aggregate differs from the exact sum of the valid rows' entries")
    check_decisions(accepted, bad)
    for b in rng.choice(np.flatnonzero(~bad), SAMPLED, replace=False):
        for agg_id in (0, 1):
            compare_row(vdaf, b, agg_id, results[agg_id][b], oracle[src[b]][agg_id])
    if backend.leader_marshal_rows != {"bytes": FP_BATCH, "values": 0}:
        raise AssertionError(f"fixedpoint: leader rows marshalled {backend.leader_marshal_rows}")
    log(f"fixedpoint: {FP_BATCH} reports through prep_init; exact aggregate over {int(accepted.sum())} rows; "
        f"{int(bad.sum())} tampered rows rejected ({FP_TAMPERED} perturbed, {FP_LIE_ROWS} norm lies); {SAMPLED} "
        f"sampled rows equal the oracle on both sides; oracle recomputed rows {backend.oracle_recompute_rows}; "
        f"{e2e:.3f} s")
    phases["fixedpoint_served"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    staged = {a: backend.stage_prep_init_multi(a, [(verify_key, rows)]).placed
              for a, rows in ((0, leader_rows), (1, helper_rows))}
    torch.cuda.reset_peak_memory_stats()
    # a call takes over a second here: one a round
    dev_ms = staged_ms(bp, staged, "prep_init", 1)
    peak = torch.cuda.max_memory_allocated()
    profile = {side: profile_device(lambda a=a: device_prep(bp, staged[a], a, "prep_init")) for side, a in PROFILED_SIDES}
    log(f"fixedpoint: device ms at B = {FP_BATCH} {json.dumps(dev_ms)}; peak memory {peak} bytes")
    phases["fixedpoint_device"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    ex, backends, warm_s = executor_for(vdaf, FP_BATCH, warmup=True)
    (ex_aggs, ex_accepted, ex_results, ex_record), _ = counted(
        "fixedpoint executor path", ("keccak_squeeze", "keccak_absorb"),
        lambda: executor_job(vdaf, ex, backends, verify_key, leader_rows, helper_rows, EXECUTOR_JOBS),
    )
    ex_record["warmup_s"] = warm_s
    if ex_aggs != aggs or not np.array_equal(ex_accepted, accepted):
        raise AssertionError("fixedpoint executor path: drained aggregate or decisions differ from the direct path")
    for b in rng.choice(np.flatnonzero(~bad), SAMPLED, replace=False):
        for agg_id in (0, 1):
            compare_row(vdaf, b, agg_id, ex_results[agg_id][b], oracle[src[b]][agg_id], resident=True)
    ex_record["byte_marshal_rows_checked"] = check_byte_marshal(backends[0], leader_rows)
    log(f"fixedpoint executor path: one flush a side of {EXECUTOR_JOBS} jobs; drained aggregate equals the direct "
        f"path's; no out-share readback; job {ex_record['seconds']:.3f} s")
    phases["fixedpoint_executor"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    del ex, backends
    shapes = keccak_path_checks(bp, staged[0], staged[1], USAGE_MEAS_SHARE, vdaf.flp.MEAS_LEN, plain_rounds=0)
    phases["fixedpoint_kernel_checks"] = time.perf_counter() - t0
    record = {
        "reports": FP_BATCH, "distinct": len(shards), "tampered": int(bad.sum()), "route": "prep_init",
        "seconds": e2e, "reports_per_s": FP_BATCH / e2e, "phases_s": secs, "batch_build_s": build_s,
        "shard_s": [s for _d, _l, s in fp_done],
        "device_prep_init_ms": dev_ms, "device_prep_init_profile": profile, "device_peak_memory_bytes": peak,
        "host_seconds": dict(backend.host_seconds), "executor": ex_record,
    }
    return record, shapes


def multiproof_phase(verify_key, rng, mp_done, phases):
    """Phase 15: the HMAC multiproof SumVec at B = 128 through
    ``make_backend``'s ``HybridXofBackend``, both sides.  Returns the
    record."""
    from janus_tpu_torch.vdaf.backend import HybridXofBackend, make_backend
    from janus_tpu_torch.vdaf.instances import vdaf_from_instance

    t_phase = time.perf_counter()
    log(f"shard: {MP_DISTINCT} multiproof reports in {json.dumps([d[3] for d in mp_done])} s (worker processes); "
        f"oracle prep_init of both sides {json.dumps([d[4] for d in mp_done])} s")
    vdaf = vdaf_from_instance(MP_DESC)
    meas = [d[0] for d in mp_done]
    leader_rows, helper_rows, tampered, src = build_batch(vdaf, [d[1] for d in mp_done], rng, MP_BATCH, MP_TAMPERED)
    t0 = time.perf_counter()
    leader_rows = decoded_leader_rows(vdaf, leader_rows)
    decode_s = time.perf_counter() - t0
    backend = make_backend(vdaf, "cuda", device=DEVICE)
    if not isinstance(backend, HybridXofBackend) or backend.bp.device.type != torch.device(DEVICE).type:
        raise AssertionError(f"multiproof: make_backend gave {type(backend).__name__} on {backend.bp.device}")
    # Keep each side's query_batch inputs (on the card) to time and
    # profile the FLP alone afterwards.
    query_batch = backend.bp.query_batch
    inputs = []

    def keep_inputs(*args):
        inputs.append(args)
        return query_batch(*args)

    backend.bp.query_batch = keep_inputs
    t0 = time.perf_counter()
    (aggs, accepted, results, _msgs, secs), launches = counted(
        "multiproof served path", (), lambda: run_main_path(vdaf, backend, verify_key, leader_rows, helper_rows)
    )
    e2e = time.perf_counter() - t0
    backend.bp.query_batch = query_batch
    if any(launches.values()):
        raise AssertionError(f"multiproof: the host-XOF path launched port kernels: {launches}")
    valid_sum = np.sum([meas[i] for i in src[~tampered]], axis=0).tolist()
    if vdaf.unshard(aggs, int(accepted.sum())) != valid_sum:
        raise AssertionError("multiproof: aggregate differs from the exact sum of the valid rows")
    check_decisions(accepted, tampered)
    for i in range(MP_DISTINCT):
        b = int(np.flatnonzero((src == i) & ~tampered)[0])
        for agg_id in (0, 1):
            compare_row(vdaf, b, agg_id, results[agg_id][b], mp_done[i][2][agg_id])
    if backend.leader_marshal_rows != {"bytes": MP_BATCH, "values": 0} or backend.oracle_recompute_rows:
        raise AssertionError(f"multiproof: leader rows marshalled {backend.leader_marshal_rows}, "
                             f"oracle recomputed {backend.oracle_recompute_rows}")
    host_seconds = dict(backend.host_seconds)
    bp = backend.bp
    query_ms = {side: cuda_time_ms(lambda a=a: query_batch(*inputs[a]), 2) for side, a in (("leader", 0), ("helper", 1))}
    profile = {side: profile_device(lambda a=a: query_batch(*inputs[a])) for side, a in (("leader", 0), ("helper", 1))}
    if any(not p.get("device_activities") for p in profile.values()):
        raise AssertionError(f"multiproof: a profiled query_batch call holds no device activity: {profile}")
    del inputs
    log(f"multiproof: {MP_BATCH} reports through HybridXofBackend, FLP on {bp.device}; exact aggregate over "
        f"{int(accepted.sum())} rows; {int(tampered.sum())} tampered rows rejected; one row per side per report "
        f"equals the oracle; leader rows from bytes; host seconds {json.dumps(host_seconds)}; query_batch device ms "
        f"{json.dumps(query_ms)}; {e2e:.3f} s")
    phases["multiproof"] = time.perf_counter() - t_phase
    return {
        "reports": MP_BATCH, "route": "cuda-hybrid", "flp_device": str(bp.device), "seconds": e2e,
        "reports_per_s": MP_BATCH / e2e, "phases_s": secs, "leader_decode_s": decode_s,
        "shard_s": [d[3] for d in mp_done], "host_seconds": host_seconds,
        "leader_marshal_rows": dict(backend.leader_marshal_rows), "device_query_ms": query_ms,
        "device_query_profile": profile, "phase_s": phases["multiproof"],
    }


def tamper(vdaf, shares):
    """The input shares with the leader's first measurement element
    perturbed, which the proof then fails."""
    from janus_tpu_torch.vdaf.prio3 import Prio3InputShare

    lead = shares[0]
    ms = list(lead.meas_share)
    ms[0] = (ms[0] + 1) % vdaf.flp.field.MODULUS
    bad = Prio3InputShare(meas_share=ms, proofs_share=lead.proofs_share, joint_rand_blind=lead.joint_rand_blind)
    return [bad] + list(shares[1:])


def tally_calls(owner, attr: str, tally: dict, key: str):
    """Wrap ``owner.attr`` (a function or coroutine function, on an
    instance or a module) so that each call adds its seconds to
    ``tally[key]`` as [calls, total, max].  Returns the undo.  Calls on
    worker threads overlap, so a total is busy time, not wall time."""
    import inspect

    orig = getattr(owner, attr)
    had = attr in vars(owner)
    slot = tally.setdefault(key, [0, 0.0, 0.0])

    def add(t0):
        d = time.perf_counter() - t0
        slot[0] += 1
        slot[1] += d
        slot[2] = max(slot[2], d)

    if inspect.iscoroutinefunction(orig):
        async def wrapped(*a, **k):
            t0 = time.perf_counter()
            try:
                return await orig(*a, **k)
            finally:
                add(t0)
    else:
        def wrapped(*a, **k):
            t0 = time.perf_counter()
            try:
                return orig(*a, **k)
            finally:
                add(t0)
    setattr(owner, attr, wrapped)
    return lambda: setattr(owner, attr, orig) if had else delattr(owner, attr)


def pair_run(name, desc, shards, tampered, expect, verify_key, needs, field_backend=None, vdaf_backend="cuda",
             mesh=False):
    """One task through the leader/helper pair on the card: each side an
    ``Aggregator`` with its own ``EphemeralDatastore`` and its own
    ``DeviceExecutor`` with the accumulator on (``make_backend``'s
    ``CudaBackend`` at the default budget), joined by the in-process
    transport, on a ``MockClock``.  ``shards`` are (measurement, (nonce,
    public share, input shares)); report i goes up under report ID nonce i,
    with its leader share perturbed where ``tampered[i]``.  Every report is
    sealed to both aggregators and uploaded through ``handle_upload``, the
    creator cuts jobs of PAIR_JOB_SIZE, the driver steps the first job alone
    and the rest together (the helper answers through its executor), and a
    collector collects.  Raises unless the aggregate is ``expect`` over
    exactly the untampered reports, no out share was read back or recomputed,
    no oracle served a row, no breaker tripped, every leader row was
    marshalled from its bytes and the kernels ``needs`` launched.  The
    executors run the reference's default, canonical shapes: a task below
    its bucket's ceiling resolves to the bucket's twin, which the record
    names under ``served_as``; each flush holds this one task, so it runs
    the task's own prepare (K2's select variant may not launch).
    ``field_backend`` goes into both sides' ``Config``, the driver's
    ``DriverConfig`` and the warmed backends (None: the default, "vpu"), and
    every backend that served must carry it.  ``vdaf_backend`` goes into
    both sides' ``Config`` and the driver's (``"mesh"``: every card of the
    process) and ``mesh`` into both executors' ``ExecutorConfig``; with
    either, every backend that served must be a ``MeshBackend``.  Returns
    the record."""
    import asyncio

    from janus_tpu_torch.core import hpke_batch, trace
    from janus_tpu_torch.aggregator import (
        AggregationJobCreator, AggregationJobDriver, Aggregator, CollectionJobDriver, Config, CreatorConfig,
        DriverConfig,
    )
    from janus_tpu_torch.aggregator.test_util import InProcessNetwork
    from janus_tpu_torch.client import seal_report
    from janus_tpu_torch.collector import Collector
    from janus_tpu_torch.core.auth_tokens import AuthenticationToken
    from janus_tpu_torch.core.hpke import HpkeKeypair
    from janus_tpu_torch.core.time import MockClock
    from janus_tpu_torch.datastore import AggregatorTask, TaskQueryType
    from janus_tpu_torch.datastore.test_util import EphemeralDatastore
    from janus_tpu_torch.executor import AccumulatorConfig, DeviceExecutor, ExecutorConfig
    from janus_tpu_torch.messages import Duration, Interval, Query, ReportId, Role, TaskId, Time
    from janus_tpu_torch.utils.gcm import HAVE_FUNCTIONAL_CRYPTOGRAPHY
    from janus_tpu_torch.vdaf.backend import make_backend
    from janus_tpu_torch.vdaf.canonical import executor_shape
    from janus_tpu_torch.vdaf.instances import vdaf_from_instance

    precision = 3600
    now = 1_600_002_000
    start = now - now % precision
    agg_token, col_token = AuthenticationToken.new_bearer("pair-agg"), AuthenticationToken.new_bearer("pair-col")
    vdaf = vdaf_from_instance(desc)
    # the key and backend the driver and the helper resolve: the bucket's
    # twin where the task has one (the executors' default canonical shapes)
    key, twin = executor_shape(vdaf)
    secs = {}
    rec = {"reports": len(shards), "tampered": int(sum(tampered)),
           "hpke_route": "cryptography" if HAVE_FUNCTIONAL_CRYPTOGRAPHY else "pure"}
    if twin is not None:
        tv = twin.flp.valid
        rec["served_as"] = {"twin": {k: v for k, v in vars(tv).items() if isinstance(v, int) and not k.startswith("_")},
                            "calls": [list(vdaf.flp.valid.GADGET_CALLS), list(tv.GADGET_CALLS)],
                            "meas_len": [vdaf.flp.MEAS_LEN, twin.flp.MEAS_LEN]}
    # busy seconds by layer: [calls, total, max] of the handlers, the
    # datastore transactions, the HPKE opens, the driver's steps and the
    # executor's spans
    layers = {}
    spans = []
    sink = lambda name, cat, start, dur, args: spans.append((name, dur))  # noqa: E731

    async def run():
        clock = MockClock(Time(now))
        ds = {side: EphemeralDatastore(clock) for side in ("leader", "helper")}
        ex = {side: DeviceExecutor(ExecutorConfig(mesh=mesh, accumulator=AccumulatorConfig(enabled=True)))
              for side in ds}
        aggs = {side: Aggregator(ds[side].datastore, clock, Config(
            vdaf_backend=vdaf_backend, vdaf_device=DEVICE, device_executor=ex[side],
            max_upload_batch_write_delay=0.02, field_backend=field_backend)) for side in ds}
        net = InProcessNetwork()
        urls = {side: net.add(side, agg) for side, agg in aggs.items()}
        undo = [tally_calls(aggs["leader"], "handle_upload", layers, "leader upload handler"),
                tally_calls(aggs["helper"], "handle_aggregate_init", layers, "helper aggregate-init handler"),
                tally_calls(aggs["leader"], "handle_create_collection_job", layers, "leader collection handler"),
                tally_calls(aggs["helper"], "handle_aggregate_share", layers, "helper aggregate-share handler"),
                tally_calls(hpke_batch, "open_batch", layers, "hpke open_batch")]
        undo += [tally_calls(ds[side].datastore, "run_tx", layers, f"{side} datastore tx") for side in ds]
        trace.register_span_sink(sink)
        try:
            task_id = TaskId.random()
            collector_keys = HpkeKeypair.generate(9)
            common = dict(task_id=task_id, query_type=TaskQueryType.time_interval(), vdaf=desc,
                          vdaf_verify_key=verify_key, min_batch_size=1, time_precision=Duration(precision),
                          collector_hpke_config=collector_keys.config)
            tasks = {
                "leader": AggregatorTask(peer_aggregator_endpoint=urls["helper"], role=Role.LEADER,
                                         aggregator_auth_token=agg_token, collector_auth_token_hash=col_token.hash(),
                                         hpke_keys=[HpkeKeypair.generate(1)], **common),
                "helper": AggregatorTask(peer_aggregator_endpoint=urls["leader"], role=Role.HELPER,
                                         aggregator_auth_token_hash=agg_token.hash(),
                                         hpke_keys=[HpkeKeypair.generate(2)], **common),
            }
            for side in ds:
                ds[side].datastore.run_tx("put", lambda tx, t=tasks[side]: tx.put_aggregator_task(t))
            # Warm each side's executor before the first upload: its backend
            # (the one the driver and the helper will take from the cache)
            # builds the kernels and launches once at the flush size of this
            # task's jobs.  The launch counters then go back to 0, so that
            # they count the pair's own run and nothing of the warmup.
            t0 = time.perf_counter()
            backends = {}
            for agg_id, side in enumerate(ds):
                b = backends[side] = ex[side].backend_for(
                    key, lambda: make_backend(twin or vdaf, vdaf_backend, device=DEVICE, canonical=twin is not None,
                                              field_backend=field_backend))
                # a backend with no executor surface (HybridXofBackend) has
                # no launch to warm
                if ex[side].warmup_backend(b, agg_ids=(agg_id,), pad_to=min(PAIR_JOB_SIZE, len(shards))):
                    b.outshare_readback_rows = 0
                    b.leader_marshal_rows = {"bytes": 0, "values": 0}
                    b.oracle.rows = {"init": 0, "combine": 0}
            secs["warmup"] = time.perf_counter() - t0
            zero_counters()
            configs = [tasks[side].hpke_keys[0].config for side in ("leader", "helper")]
            t0 = time.perf_counter()
            sealed = [seal_report(vdaf, task_id, *configs, ReportId(nonce), Time(start), public,
                                  tamper(vdaf, shares) if bad else shares)
                      for (_m, (nonce, public, shares)), bad in zip(shards, tampered)]
            secs["seal"] = time.perf_counter() - t0
            session = net.session()
            t_e2e = time.perf_counter()

            async def upload(report):
                async with session.put(f"{urls['leader']}tasks/{task_id}/reports", data=report.get_encoded()) as r:
                    if r.status != 201:
                        raise AssertionError(f"pair {name}: upload answered {r.status}: {await r.text()}")

            for i in range(0, len(sealed), PAIR_UPLOAD_WAVE):
                await asyncio.gather(*[upload(r) for r in sealed[i:i + PAIR_UPLOAD_WAVE]])
            secs["upload"] = time.perf_counter() - t_e2e
            t0 = time.perf_counter()
            await AggregationJobCreator(ds["leader"].datastore, CreatorConfig(
                min_aggregation_job_size=1, max_aggregation_job_size=PAIR_JOB_SIZE)).run_once()
            secs["creator"] = time.perf_counter() - t0
            driver = AggregationJobDriver(ds["leader"].datastore, net.session, DriverConfig(
                vdaf_backend=vdaf_backend, vdaf_device=DEVICE, device_executor=ex["leader"],
                field_backend=field_backend))
            undo.append(tally_calls(driver, "step_aggregation_job", layers, "leader driver step"))
            leases = await ds["leader"].datastore.run_tx_async(
                "acquire", lambda tx: tx.acquire_incomplete_aggregation_jobs(Duration(600), 1 << 10))
            rec["jobs"] = len(leases)
            t0 = time.perf_counter()
            await driver.step_aggregation_job(leases[0])
            secs["first_job"] = time.perf_counter() - t0
            rec["first_job_helper_init_s"] = layers["helper aggregate-init handler"][1]
            t0 = time.perf_counter()
            await asyncio.gather(*[driver.step_aggregation_job(lease) for lease in leases[1:]])
            secs["other_jobs"] = time.perf_counter() - t0
            left = await ds["leader"].datastore.run_tx_async(
                "acquire", lambda tx: tx.acquire_incomplete_aggregation_jobs(Duration(600), 1 << 10))
            if left:
                raise AssertionError(f"pair {name}: {len(left)} aggregation jobs still incomplete after one step")
            await driver.close()
            collector = Collector(task_id=task_id, leader_endpoint=urls["leader"], vdaf=vdaf, auth_token=col_token,
                                  hpke_keypair=collector_keys, poll_interval=0.02, max_poll_time=600.0)
            collection_driver = CollectionJobDriver(ds["leader"].datastore, net.session)

            async def drive_collection():
                while True:
                    leases = await ds["leader"].datastore.run_tx_async(
                        "acquire", lambda tx: tx.acquire_incomplete_collection_jobs(Duration(600), 8))
                    for lease in leases:
                        await collection_driver.step_collection_job(lease)
                    if leases:
                        return
                    await asyncio.sleep(0.01)

            t0 = time.perf_counter()
            query = Query.new_time_interval(Interval(Time(start), Duration(precision)))
            result, _ = await asyncio.gather(collector.collect(query, session=session), drive_collection())
            secs["collection"] = time.perf_counter() - t0
            secs["end_to_end"] = time.perf_counter() - t_e2e
            await collection_driver.close()
            # The helper calls a backend with no executor surface
            # (HybridXofBackend) directly: its task aggregator's.
            if not hasattr(backends["helper"], "stage_prep_init_multi"):
                backends["helper"] = (await aggs["helper"].task_aggregator_for(task_id)).backend
            return result, backends, {s: ex[s].stats() for s in ex}, {s: ex[s].circuit_stats() for s in ex}
        finally:
            trace.unregister_span_sink(sink)
            for u in undo:
                u()
            for side in ds:
                await aggs[side].shutdown()
                ex[side].shutdown()
                ds[side].cleanup()

    torch.cuda.reset_peak_memory_stats()
    routes_before = {stage: hpke_batch.route_rows(stage) for stage in ("upload", "aggregate_init")}
    (result, backends, stats, circuits), launches = counted(f"pair {name}", needs, lambda: asyncio.run(run()))
    routes = {stage: {k: v - routes_before[stage][k] for k, v in hpke_batch.route_rows(stage).items()}
              for stage in routes_before}
    # the leader's uploads take the card's vector pass (a batch of one
    # AES-128-GCM body opens per report, so a task of a few reports may not)
    if DEVICE == "cuda" and len(shards) >= PAIR_VECTOR_MIN and not routes["upload"]["vector"]:
        raise AssertionError(f"pair {name}: no upload took the vector pass: {routes}")
    valid = [m for (m, _r), bad in zip(shards, tampered) if not bad]
    if result.report_count != len(valid) or result.aggregate_result != expect(valid):
        raise AssertionError(f"pair {name}: collected {result.report_count} reports, not the exact aggregate of the "
                             f"{len(valid)} untampered ones")
    readback = {side: getattr(b, "outshare_readback_rows", 0) for side, b in backends.items()}
    for side, b in backends.items():
        extra = [o.rows for o in getattr(b, "_oracles", {}).values()]
        if readback[side] or b.oracle_recompute_rows or any(any(r.values()) for r in [b.oracle.rows] + extra):
            raise AssertionError(f"pair {name}: the {side} read back {readback[side]} out shares, "
                                 f"recomputed {b.oracle_recompute_rows} rows, oracle rows {b.oracle.rows} {extra}")
        if b.bp.device.type != torch.device(DEVICE).type:
            raise AssertionError(f"pair {name}: the {side}'s FLP ran on {b.bp.device}")
        if b.bp.field_backend != (field_backend or "vpu"):
            raise AssertionError(f"pair {name}: the {side} prepared under {b.bp.field_backend}, not {field_backend}")
        if any(c["trips"] or c["state"] != "closed" for c in circuits[side].values()):
            raise AssertionError(f"pair {name}: a breaker of the {side} tripped: {circuits[side]}")
        if (mesh or vdaf_backend == "mesh") and type(b).__name__ != "MeshBackend":
            raise AssertionError(f"pair {name}: the {side} served from {type(b).__name__}, not a MeshBackend")
    marshal = backends["leader"].leader_marshal_rows
    if marshal != {"bytes": len(shards), "values": 0}:
        raise AssertionError(f"pair {name}: leader rows marshalled {marshal}, not all {len(shards)} from their bytes")
    if twin is not None:
        for side, b in backends.items():
            if not getattr(b, "canonical", False) or b.vdaf is not twin:
                raise AssertionError(f"pair {name}: the {side} served from {type(b).__name__}, not the canonical twin")
        if launches["keccak_absorb_select"]:
            raise AssertionError(f"pair {name}: a flush of one task took the twin's masked row path: {launches}")
        rec["served_as"]["route"] = backends["leader"]._prep_fn(0, PAIR_JOB_SIZE, vdaf).__name__
    flushes = {side: sum(v["flushes"] for k, v in st.items() if "/prep_init#" in k) for side, st in stats.items()}
    for span, dur in spans:
        slot = layers.setdefault(f"span {span}", [0, 0.0, 0.0])
        slot[0] += 1
        slot[1] += dur
        slot[2] = max(slot[2], dur)
    rec.update({
        "layer_busy_s": {k: {"calls": v[0], "total": v[1], "max": v[2]} for k, v in layers.items()},
        "seconds": secs, "uploads_per_s": len(shards) / secs["upload"], "reports_per_s": len(shards) / secs["end_to_end"],
        "helper_init_s": {"first": rec.pop("first_job_helper_init_s")},
        "prep_init_flushes": flushes, "executor_stats": stats, "leader_marshal_rows": marshal,
        "outshare_readback_rows": readback, "backend": type(backends["leader"]).__name__,
        "device_peak_memory_bytes": torch.cuda.max_memory_allocated(), "launches": launches,
        "report_count": result.report_count, "field_backend": field_backend or "vpu",
        "vdaf_backend": vdaf_backend, "executor_mesh": mesh,
        "mesh_devices": list(getattr(backends["leader"], "mesh_devices", ())), "hpke_open_rows": routes,
    })
    served = (f"; served by the twin {json.dumps(rec['served_as'])}" if twin is not None else "; exact shape")
    log(f"pair {name}: {len(shards)} reports ({rec['tampered']} tampered, rejected) in {rec['jobs']} jobs; aggregate "
        f"exact; {flushes} prepare flushes a side; upload {secs['upload']:.3f} s ({rec['uploads_per_s']:.1f}/s, "
        f"{rec['hpke_route']} HPKE, opens by route {json.dumps(routes['upload'])}); first job {secs['first_job']:.3f} s; end to end {secs['end_to_end']:.3f} s "
        f"({rec['reports_per_s']:.1f} reports/s){served}")
    return rec


def pair_phase(verify_key, rng, hist_shards, sv_done, fp_done, mp_done, mp_verify_key, phases):
    """Phase 13: one task a family through the leader/helper pair.  Returns
    the records by task."""
    from janus_tpu_torch.vdaf.instances import prio3_count, prio3_sum

    t0 = time.perf_counter()
    out = {}

    def tampered_flags(n, k):
        flags = np.zeros(n, dtype=bool)
        flags[rng.choice(n, k, replace=False)] = True
        return flags.tolist()

    count = shard_reports(prio3_count(), rng, lambda r: int(r.integers(0, 2)), PAIR_COUNT_REPORTS)
    out["count"] = pair_run("count", {"type": "Prio3Count"}, list(zip(count[1], count[0])),
                            tampered_flags(PAIR_COUNT_REPORTS, PAIR_TAMPERED), sum, verify_key, ("keccak_squeeze",))
    sums = shard_reports(prio3_sum(SUM_BITS), rng, lambda r: int(r.integers(0, 1 << SUM_BITS)), PAIR_SUM_REPORTS)
    out["sum"] = pair_run("sum", {"type": "Prio3Sum", "bits": SUM_BITS}, list(zip(sums[1], sums[0])),
                          tampered_flags(PAIR_SUM_REPORTS, PAIR_TAMPERED), sum, verify_key,
                          ("keccak_squeeze", "keccak_absorb"))
    torch.cuda.empty_cache()
    # Histogram(1024, 316), SumVec100k and FixedPoint(BitSize16, 1000) sit
    # below their buckets' ceilings: under the default canonical shapes
    # they resolve to their twins, whose flushes of one task run the task's
    # own prepare (planar K3 and K5 where eligible; pair_run holds K2's
    # select variant at 0)
    out["histogram"] = pair_run(
        "histogram", {"type": "Prio3Histogram", "length": LENGTH, "chunk_length": CHUNK}, hist_shards,
        tampered_flags(len(hist_shards), PAIR_TAMPERED),
        lambda valid: np.bincount(valid, minlength=LENGTH).tolist(), verify_key, KERNEL_NAMES[:3])
    torch.cuda.empty_cache()
    out["sumvec"] = pair_run(
        "sumvec", {"type": "Prio3SumVec", "length": SV_LENGTH, "bits": 1, "chunk_length": SV_CHUNK},
        [(d[0], d[1]) for d in sv_done], [False] * len(sv_done),
        lambda valid: np.sum(valid, axis=0).tolist(), verify_key,
        ("keccak_squeeze", "keccak_absorb", "flp_sumvec_wires"))
    torch.cuda.empty_cache()
    fp_shards = [(m, r) for done, _lie, _s in fp_done for m, r, _o in done]
    fp_lies = [(None, lie) for _d, lie, _s in fp_done][:PAIR_FP_LIES]
    out["fixedpoint"] = pair_run(
        "fixedpoint", FP_DESC, fp_shards + fp_lies, [False] * len(fp_shards) + [True] * len(fp_lies),
        lambda valid: [sum(m[j] for m in valid) for j in range(FP_DESC["length"])], verify_key,
        ("keccak_squeeze", "keccak_absorb"))
    torch.cuda.empty_cache()
    out["multiproof"] = pair_run(
        "multiproof", MP_DESC, [(d[0], d[1]) for d in mp_done], [False] * len(mp_done),
        lambda valid: np.sum(valid, axis=0).tolist(), mp_verify_key, ())
    if any(out["multiproof"]["launches"].values()):
        raise AssertionError(f"pair multiproof: the host-XOF path launched port kernels: {out['multiproof']['launches']}")
    phases["pair"] = time.perf_counter() - t0
    return out


def poplar_value_set(seed: int):
    """The POPLAR_VALUES distinct 16-bit values of phases 16-17 and their
    skewed weights (value i draws with weight 1 / (i + 1))."""
    rng = np.random.default_rng([seed, 16])
    values = sorted(int(v) for v in rng.choice(1 << POPLAR_BITS, POPLAR_VALUES, replace=False))
    weights = 1.0 / np.arange(1, POPLAR_VALUES + 1)
    order = rng.permutation(POPLAR_VALUES)  # the heavy values spread over the tree
    return values, (weights / weights.sum())[order]


def poplar_shard_job(seed: int, worker: int, count: int):
    """``count`` Poplar1(bits=16) reports of skewed measurements sharded by
    the port's oracle (run in a worker process): [(measurement, (nonce,
    public share, input shares))], each nonce distinct."""
    from janus_tpu_torch.vdaf.poplar1 import Poplar1

    vdaf = Poplar1(POPLAR_BITS)
    values, weights = poplar_value_set(seed)
    rng = np.random.default_rng([seed, 300 + worker])
    reports, meas = shard_reports(vdaf, rng, lambda r: int(r.choice(values, p=weights)), count)
    return list(zip(meas, reports))


def poplar_prefixes(values, bits: int, level: int, count: int):
    """The ``level`` prefixes of ``values``, padded with the smallest other
    prefixes to ``count`` candidates, sorted."""
    have = {v >> (bits - 1 - level) for v in values}
    pad = (p for p in range(1 << (level + 1)) if p not in have)
    while len(have) < count:
        have.add(next(pad))
    return tuple(sorted(have))


def poplar_side_rows(shards, tampered):
    """Each side's (nonce, public share, input share) rows; a tampered row's
    leader IDPF key is flipped (its sketch then fails)."""
    import dataclasses

    rows = {0: [], 1: []}
    for (_m, (nonce, public, shares)), bad in zip(shards, tampered):
        lead = shares[0]
        if bad:
            lead = dataclasses.replace(lead, idpf_key=bytes(b ^ 0x5A for b in lead.idpf_key))
        rows[0].append((nonce, public, lead))
        rows[1].append((nonce, public, shares[1]))
    return rows


def poplar_decide(vdaf, ap, lead, help_):
    """Both sides' round-0 outcomes through the two sketch rounds: (B,)
    accepted mask (an honest row's sketch verifies, a tampered one's
    fails)."""
    from janus_tpu_torch.vdaf.prio3 import VdafError

    accepted = np.zeros(len(lead), dtype=bool)
    for b, ((ls, lsh), (hs, hsh)) in enumerate(zip(lead, help_)):
        msg = vdaf.ping_pong_prep_shares_to_prep(ap, [lsh, hsh], round=0)
        sigma = [vdaf.ping_pong_decode_prep_share(vdaf.ping_pong_prep_next(st, msg)[2], round=1) for st in (ls, hs)]
        try:
            vdaf.ping_pong_prep_shares_to_prep(ap, sigma, round=1)
            accepted[b] = True
        except VdafError:
            pass
    return accepted


def poplar_equal(what, got, want, values=True):
    """Per-row prepare outcomes equal: shares and (a, b, c, zs); with
    ``values`` the states' prefix values too (host vectors both)."""
    for b, ((gs, gsh), (ws, wsh)) in enumerate(zip(got, want)):
        if gsh.encode() != wsh.encode() or (gs.a, gs.b, gs.c, gs.zs_share) != (ws.a, ws.b, ws.c, ws.zs_share):
            raise AssertionError(f"{what}: row {b} differs")
        if values and gs.y_flat != ws.y_flat:
            raise AssertionError(f"{what}: row {b}'s prefix values differ")


def poplar_executor(vdaf, backend, verify_key, ap, rows, jobs):
    """Both sides' rows through a ``DeviceExecutor`` with the accumulator
    (deferred, so a card walk's vectors stay resident): ``jobs``
    submissions a side with ``retain_out_shares``, one flush a side.
    Returns ({side: outcomes}, executor stats, seconds, store)."""
    import asyncio

    from janus_tpu_torch.executor import KIND_POPLAR_INIT, AccumulatorConfig, DeviceExecutor, ExecutorConfig
    from janus_tpu_torch.vdaf.backend import vdaf_shape_key

    B = len(rows[0])
    size = B // jobs
    ex = DeviceExecutor(ExecutorConfig(flush_max_rows=B, flush_window_s=0.05,
                                       accumulator=AccumulatorConfig(enabled=True, drain_interval_s=3600.0)))
    key = vdaf_shape_key(vdaf)

    async def side(agg_id):
        outs = await asyncio.gather(*[
            ex.submit(key, KIND_POPLAR_INIT, (verify_key, ap, rows[agg_id][j * size:(j + 1) * size]), backend=backend,
                      agg_id=agg_id, retain_out_shares=True, agg_param_key=ap.level)
            for j in range(jobs)
        ])
        return [o for job in outs for o in job]

    async def both():
        return {a: await side(a) for a in (0, 1)}

    t0 = time.perf_counter()
    try:
        outs = asyncio.run(both())
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        stats = ex.stats()
    except BaseException:
        ex.shutdown()
        raise
    for a in (0, 1):
        label = next(k for k in stats if f"/a{a}/poplar_init/L{ap.level}#" in k)
        if stats[label]["flushes"] != 1 or stats[label]["flushed_jobs"] != jobs:
            ex.shutdown()
            raise AssertionError(f"poplar executor: {label} ran {stats[label]} (one flush of {jobs} jobs expected)")
    return outs, stats, secs, ex


def poplar_case(name, vdaf, shards, tampered, level, prefixes, verify_key, rng, sampled, walk_rounds=3,
                profile=False):
    """One Poplar1 shape on the card, both sides: the card walk direct and
    through the executor, and the host walk (the reference) direct.
    Raises unless every state and share of the card walk equals the host
    walk's, ``sampled`` rows equal ``Poplar1Oracle``, the decided sketch
    accepts exactly the untampered rows, no row went to the oracle, the
    executor's flush kept its vectors on the card (no readback) and the
    drained sums equal the host walk's.  The card walk is timed over
    ``walk_rounds`` calls; with ``profile`` one flush is traced (a trace
    of a 100k-activity flush takes the profiler about a minute to read).
    Returns the record."""
    from janus_tpu_torch.executor import ResidentRef
    from janus_tpu_torch.ops.poplar1_batch import sketch_limbs
    from janus_tpu_torch.vdaf.backend import make_backend
    from janus_tpu_torch.vdaf.poplar1 import Poplar1AggregationParam

    ap = Poplar1AggregationParam(level, tuple(prefixes))
    rows = poplar_side_rows(shards, tampered)
    B = len(shards)
    card = make_backend(vdaf, "cuda", device=DEVICE)
    rec = {"bits": vdaf.bits, "level": level, "prefixes": len(prefixes), "rows": B, "tampered": int(sum(tampered)),
           "field": vdaf.field_for_agg_param(ap).__name__}
    secs = {}
    torch.cuda.reset_peak_memory_stats()

    def direct(walk, prep):
        out = {}
        for a in (0, 1):
            t0 = time.perf_counter()
            out[a] = prep(verify_key, a, ap, rows[a])
            torch.cuda.synchronize()
            secs[f"{walk} walk direct a{a}"] = time.perf_counter() - t0
        return out

    card_out = direct("cuda", card.prep_init_batch_poplar)
    host_out = direct("host", card.bp.prep_init_batch_host)
    for a in (0, 1):
        poplar_equal(f"{name} a{a} card walk vs host walk", card_out[a], host_out[a])
    accepted = poplar_decide(vdaf, ap, card_out[0], card_out[1])
    if not np.array_equal(accepted, ~np.asarray(tampered)):
        raise AssertionError(f"{name}: the sketch accepted {int(accepted.sum())} rows, not the "
                             f"{B - int(sum(tampered))} untampered ones")
    t0 = time.perf_counter()
    for b in rng.choice(B, sampled, replace=False):
        for a in (0, 1):
            want = card.oracle.prep_init_batch_poplar(verify_key, a, ap, [rows[a][b]])
            poplar_equal(f"{name} a{a} card walk vs the oracle", [card_out[a][b]], want)
    secs["oracle_sample"] = time.perf_counter() - t0
    card.oracle.rows["init"] = 0

    # device times: the card walk (CUDA events around the whole walk: the
    # host's key derivation and marshalling included) and the sketch's
    # device half alone on its staged inputs
    bp = card.bp
    nonces = [r[0] for r in rows[0]]
    pubs = [r[1] for r in rows[0]]
    keys = [r[2].idpf_key for r in rows[0]]
    rec["walk_ms"] = cuda_time_ms(
        lambda: bp._eval_batch_dev(0, pubs, keys, level, list(prefixes), nonces), 1, walk_rounds
    )
    t0 = time.perf_counter()
    bp.eval_batch_host(0, pubs, keys, level, list(prefixes), nonces)
    rec["host_walk_ms"] = (time.perf_counter() - t0) * 1e3
    walk = bp._walk_rows(0, ap, rows[0])
    tf = bp._tfield(walk.field)

    def put(arr):
        return torch.from_numpy(np.asarray(arr, dtype=np.uint32).astype(np.int64)).to(DEVICE)

    r_l = put(bp._verify_rands([verify_key] * B, nonces, ap))
    a_l = put(tf.to_limbs([int(a) for a, _b, _c in walk.abc]))
    b_l = put(tf.to_limbs([int(b) for _a, b, _c in walk.abc]))
    rec["sketch_ms"] = cuda_time_ms(lambda: sketch_limbs(tf, walk.y_limbs, r_l, a_l, b_l), 5, 3)
    t0 = time.perf_counter()
    bp._verify_rands([verify_key] * B, nonces, ap)
    secs["verify_rands_host"] = time.perf_counter() - t0
    if profile:
        rec["profiled_flush"] = profile_device(lambda: card.prep_init_batch_poplar(verify_key, 0, ap, rows[0]))

    # through the executor with the accumulator, 4 jobs a side, each walk
    field = vdaf.field_for_agg_param(ap)
    want = {a: [0] * len(prefixes) for a in (0, 1)}
    for a in (0, 1):
        for b in np.flatnonzero(accepted):
            want[a] = field.vec_add(want[a], host_out[a][b][0].y_flat)
    readback0 = bp.sketch_readback_rows
    outs, stats, seconds, ex = poplar_executor(vdaf, card, verify_key, ap, rows, POPLAR_JOBS)
    try:
        for a in (0, 1):
            poplar_equal(f"{name} a{a} executor", outs[a], card_out[a], values=False)
        if not np.array_equal(poplar_decide(vdaf, ap, outs[0], outs[1]), accepted):
            raise AssertionError(f"{name}: the executor decided differently")
        store = ex.accumulator
        t0 = time.perf_counter()
        for a in (0, 1):
            refs = [outs[a][b][0].y_flat for b in range(B)]
            if not all(isinstance(r, ResidentRef) for r in refs):
                raise AssertionError(f"{name}: the executor's vectors left the card")
            ids = [int(b).to_bytes(4, "big") for b in np.flatnonzero(accepted)]
            store.commit_rows(("poplar", a), card, [refs[b] for b in np.flatnonzero(accepted)],
                              job_token=0, report_ids=ids)
            store.release_refs([refs[b] for b in np.flatnonzero(~accepted)])
            if store.drain(("poplar", a), field)[0] != want[a]:
                raise AssertionError(f"{name}: the executor's drained sum a{a} differs from the host walk's")
        commit_s = time.perf_counter() - t0
        store_stats = store.stats()
    finally:
        ex.shutdown()
    if store_stats["flushes_resident"] or store_stats["resident_bytes"]:
        raise AssertionError(f"{name}: the store still holds state after the drain: {store_stats}")
    rec["executor"] = {
        "seconds": seconds, "seconds_a_job": seconds / (2 * POPLAR_JOBS), "commit_drain_s": commit_s,
        "flushes": {k.split("#")[0]: v["flushes"] for k, v in stats.items()},
    }
    if bp.sketch_readback_rows != readback0:
        raise AssertionError(f"{name}: the executor's card walk read back "
                             f"{bp.sketch_readback_rows - readback0} sketch rows")
    if card.oracle_recompute_rows or card.oracle.rows["init"]:
        raise AssertionError(f"{name}: rows went to the oracle")
    rec.update({"seconds": secs, "oracle_recompute_rows": 0, "executor_sketch_readback_rows": 0,
                "device_peak_memory_bytes": torch.cuda.max_memory_allocated()})
    log(f"poplar1 {name}: {B} rows a side ({rec['tampered']} tampered, rejected), card walk = host walk on every "
        f"row, {sampled} rows = oracle; walk {rec['walk_ms']:.2f} ms (host walk {rec['host_walk_ms']:.2f} ms), "
        f"sketch {rec['sketch_ms']:.3f} ms on the card; "
        f"executor {rec['executor']['seconds_a_job']:.4f} s a job")
    return rec


def poplar_phase(seed, verify_key, rng, shards16, phases):
    """Phase 16: Poplar1 prepare on the card at three shapes.  Returns the
    records by shape."""
    from janus_tpu_torch.vdaf.poplar1 import Poplar1

    t0 = time.perf_counter()
    out = {}
    vdaf = Poplar1(POPLAR_BITS)
    values, _w = poplar_value_set(seed)
    tampered = np.zeros(len(shards16), dtype=bool)
    tampered[rng.choice(len(shards16), POPLAR_TAMPERED, replace=False)] = True
    inner = poplar_prefixes(values, POPLAR_BITS, POPLAR_INNER_LEVEL, POPLAR_PREFIXES)

    def run():
        out["bits16_level8"] = poplar_case("bits16 level 8", vdaf, shards16, tampered.tolist(), POPLAR_INNER_LEVEL,
                                           inner, verify_key, rng, SAMPLED, profile=True)
        out["bits16_leaf"] = poplar_case("bits16 leaf", vdaf, shards16, tampered.tolist(), POPLAR_BITS - 1,
                                         values, verify_key, rng, SAMPLED)
        wide = Poplar1(POPLAR_WIDE_BITS)
        t1 = time.perf_counter()
        reports, meas = shard_reports(wide, rng, lambda r: int.from_bytes(r.bytes(32), "big"), POPLAR_WIDE_DISTINCT)
        shard_s = time.perf_counter() - t1
        tile = POPLAR_WIDE_ROWS // POPLAR_WIDE_DISTINCT
        wide_shards = list(zip(meas, reports)) * tile
        wide_tampered = [i < POPLAR_WIDE_DISTINCT // 4 for i in range(POPLAR_WIDE_DISTINCT)] * tile
        out["bits256_leaf"] = poplar_case("bits256 leaf", wide, wide_shards, wide_tampered, POPLAR_WIDE_BITS - 1,
                                          sorted(meas), verify_key, rng, POPLAR_WIDE_SAMPLED, walk_rounds=1)
        out["bits256_leaf"]["shard_s"] = shard_s

    _, launches = counted("poplar1 prepare", (), run)
    if any(launches.values()):
        raise AssertionError(f"poplar1 prepare launched port kernels: {launches}")
    phases["poplar1"] = time.perf_counter() - t0
    return out


def poplar_pair_phase(seed, verify_key, shards16, phases):
    """Phase 17: the leader/helper pair collects heavy hitters.  A
    Poplar1(bits=16) task, both sides' ``Poplar1Backend`` walking on the
    card behind their own executor (the leader's accumulator deferred, so
    its sketch vectors stay on the card across the WAITING_LEADER hop),
    ``max_agg_param_job_size`` 256; the 1,024 reports uploaded; a
    collection at level 7 over the 8-bit prefixes of the 64 values (padded
    to 64 candidates), then one at the leaf over the values under the
    prefixes whose count reached POPLAR_THRESHOLD.  Each collection
    creates its level's 4 jobs; the driver steps them together.  Raises
    unless every prefix count is the plain count of the uploads, both
    sides' level buckets coalesced jobs, no row went to the oracle, no
    breaker tripped, the leader read no sketch vector back and no journal
    row is left.  The harness steps the collection job as soon as a
    level's jobs are done, before their deferred bucket comes due, with no
    wait: the collection step leaves the young journal rows to the
    driver's drain (the accumulator maintenance pass the loop runs on its
    cadence) and asks again, so no row may be replayed on the oracle.  The
    clock runs in real time from a fixed start (journal rows age as the
    drain interval does).  Returns the record."""
    import asyncio

    from janus_tpu_torch.aggregator import AggregationJobDriver, Aggregator, CollectionJobDriver, Config, DriverConfig
    from janus_tpu_torch.aggregator.test_util import InProcessNetwork
    from janus_tpu_torch.client import seal_report
    from janus_tpu_torch.collector import Collector
    from janus_tpu_torch.core.auth_tokens import AuthenticationToken
    from janus_tpu_torch.core.hpke import HpkeKeypair
    from janus_tpu_torch.core.time import Clock
    from janus_tpu_torch.datastore import AggregatorTask, TaskQueryType
    from janus_tpu_torch.datastore.test_util import EphemeralDatastore
    from janus_tpu_torch.executor import AccumulatorConfig, DeviceExecutor, ExecutorConfig
    from janus_tpu_torch.messages import Duration, Interval, Query, ReportId, Role, TaskId, Time
    from janus_tpu_torch.vdaf.backend import Poplar1Backend, vdaf_shape_key

    class RunningClock(Clock):
        """Real time from ``now``: the reports' fixed batch stays current."""

        def __init__(self, base):
            self.base, self.t0 = base, time.monotonic()

        def now(self):
            return Time(self.base + int(time.monotonic() - self.t0))
    from janus_tpu_torch.vdaf.instances import vdaf_from_instance
    from janus_tpu_torch.vdaf.poplar1 import Poplar1AggregationParam

    t_phase = time.perf_counter()
    desc = {"type": "Poplar1", "bits": POPLAR_BITS}
    precision, now = 3600, 1_600_002_000
    start = now - now % precision
    agg_token, col_token = AuthenticationToken.new_bearer("hh-agg"), AuthenticationToken.new_bearer("hh-col")
    vdaf = vdaf_from_instance(desc)
    values, _w = poplar_value_set(seed)
    meas = [m for m, _r in shards16]
    secs, levels, replays = {}, {}, {}
    undo = []

    async def run():
        clock = RunningClock(now)
        ds = {side: EphemeralDatastore(clock) for side in ("leader", "helper")}
        # both sides deferred: the leader drains on its maintenance
        # cadence, the helper's interval outlasts the run, so that its
        # aggregate-share barrier drains the continue steps' journal rows
        acc = {"leader": AccumulatorConfig(enabled=True, drain_interval_s=POPLAR_DRAIN_S),
               "helper": AccumulatorConfig(enabled=True, drain_interval_s=POPLAR_HELPER_DRAIN_S)}
        # a level's jobs flush together once all their rows are in (or
        # at the window's end): each side's requests arrive spread by
        # their HPKE opens and decodes
        ex = {side: DeviceExecutor(ExecutorConfig(flush_max_rows=len(shards16), flush_window_s=POPLAR_FLUSH_WINDOW_S,
                                                  accumulator=acc[side])) for side in ds}
        aggs = {side: Aggregator(ds[side].datastore, clock, Config(
            vdaf_device=DEVICE, device_executor=ex[side], max_upload_batch_write_delay=0.02,
            max_agg_param_job_size=POPLAR_PAIR_JOB_SIZE)) for side in ds}
        net = InProcessNetwork()
        urls = {side: net.add(side, agg) for side, agg in aggs.items()}
        try:
            task_id = TaskId.random()
            collector_keys = HpkeKeypair.generate(9)
            common = dict(task_id=task_id, query_type=TaskQueryType.time_interval(), vdaf=desc,
                          vdaf_verify_key=verify_key, min_batch_size=1, time_precision=Duration(precision),
                          collector_hpke_config=collector_keys.config)
            tasks = {
                "leader": AggregatorTask(peer_aggregator_endpoint=urls["helper"], role=Role.LEADER,
                                         aggregator_auth_token=agg_token, collector_auth_token_hash=col_token.hash(),
                                         hpke_keys=[HpkeKeypair.generate(1)], **common),
                "helper": AggregatorTask(peer_aggregator_endpoint=urls["leader"], role=Role.HELPER,
                                         aggregator_auth_token_hash=agg_token.hash(),
                                         hpke_keys=[HpkeKeypair.generate(2)], **common),
            }
            for side in ds:
                ds[side].datastore.run_tx("put", lambda tx, t=tasks[side]: tx.put_aggregator_task(t))
            configs = [tasks[side].hpke_keys[0].config for side in ("leader", "helper")]
            sealed = [seal_report(vdaf, task_id, *configs, ReportId(nonce), Time(start), public, shares)
                      for _m, (nonce, public, shares) in shards16]
            session = net.session()
            t0 = time.perf_counter()

            async def upload(report):
                async with session.put(f"{urls['leader']}tasks/{task_id}/reports", data=report.get_encoded()) as r:
                    if r.status != 201:
                        raise AssertionError(f"poplar pair: upload answered {r.status}: {await r.text()}")

            for i in range(0, len(sealed), PAIR_UPLOAD_WAVE):
                await asyncio.gather(*[upload(r) for r in sealed[i:i + PAIR_UPLOAD_WAVE]])
            secs["upload"] = time.perf_counter() - t0
            driver = AggregationJobDriver(ds["leader"].datastore, net.session, DriverConfig(
                vdaf_device=DEVICE, device_executor=ex["leader"]))
            collection_driver = CollectionJobDriver(ds["leader"].datastore, net.session)
            undo.append(tally_calls(collection_driver, "_replay_journal_entry", replays, "journal replays"))
            collector = Collector(task_id=task_id, leader_endpoint=urls["leader"], vdaf=vdaf, auth_token=col_token,
                                  hpke_keypair=collector_keys, poll_interval=0.02, max_poll_time=600.0)
            query = Query.new_time_interval(Interval(Time(start), Duration(precision)))

            def helper_rows():
                return ds["helper"].datastore.run_tx(
                    "helper_journal", lambda tx: tx.count_accumulator_journal_entries(task_id))

            async def drive(done):
                rounds = {"job_steps": [], "drains": 0, "collection_steps": [], "helper_journal_rows": None}
                while not done.is_set():
                    t0 = time.perf_counter()
                    leases = await ds["leader"].datastore.run_tx_async(
                        "acquire", lambda tx: tx.acquire_incomplete_aggregation_jobs(Duration(600), 64))
                    await asyncio.gather(*[driver.step_aggregation_job(lease) for lease in leases])
                    if leases:
                        rounds["job_steps"].append([len(leases), time.perf_counter() - t0])
                        continue
                    if rounds["job_steps"] and rounds["helper_journal_rows"] is None:
                        # the level's jobs are done and nothing has asked
                        # the helper for its share yet
                        rounds["helper_journal_rows"] = helper_rows()
                    # no wait for the bucket: the maintenance pass drains
                    # it once due, and the collection step asks again
                    # until it has
                    rounds["drains"] += await driver.run_accumulator_maintenance()
                    t0 = time.perf_counter()
                    coll = await ds["leader"].datastore.run_tx_async(
                        "acquire_coll", lambda tx: tx.acquire_incomplete_collection_jobs(Duration(600), 8))
                    for lease in coll:
                        await collection_driver.step_collection_job(lease)
                    if coll:
                        rounds["collection_steps"].append(time.perf_counter() - t0)
                    await asyncio.sleep(0.05)
                return rounds

            async def collect_level(level, prefixes):
                ap = Poplar1AggregationParam(level, tuple(prefixes))
                done = asyncio.Event()

                async def collect():
                    try:
                        return await collector.collect(query, vdaf.encode_agg_param(ap), session=session)
                    finally:
                        done.set()

                t0 = time.perf_counter()
                result, rounds = await asyncio.gather(collect(), drive(done))
                secs[f"level {level}"] = time.perf_counter() - t0
                want = [sum(1 for m in meas if m >> (POPLAR_BITS - 1 - level) == p) for p in prefixes]
                if result.report_count != len(meas) or result.aggregate_result != want:
                    raise AssertionError(f"poplar pair: level {level} counts are not the plain counts")
                rounds["helper_journal_rows_after"] = helper_rows()
                if not rounds["helper_journal_rows"] or rounds["helper_journal_rows_after"]:
                    raise AssertionError(f"poplar pair: level {level}: {rounds['helper_journal_rows']} helper journal "
                                         f"rows before the collection, {rounds['helper_journal_rows_after']} after")
                levels[level] = {"prefixes": len(prefixes), "seconds": secs[f"level {level}"],
                                 "top_counts": sorted(want, reverse=True)[:8], **rounds}
                return result.aggregate_result

            coarse = poplar_prefixes(values, POPLAR_BITS, POPLAR_PAIR_LEVELS[0], POPLAR_PREFIXES)
            counts = await collect_level(POPLAR_PAIR_LEVELS[0], coarse)
            heavy = {p for p, c in zip(coarse, counts) if c >= POPLAR_THRESHOLD}
            shift = POPLAR_BITS - 1 - POPLAR_PAIR_LEVELS[0]
            leaves = [v for v in values if v >> shift in heavy]
            await collect_level(POPLAR_PAIR_LEVELS[1], leaves)
            await driver.close()
            await collection_driver.close()
            backends = {s: ex[s].cached_backend(vdaf_shape_key(vdaf)) for s in ex}
            journal = ds["leader"].datastore.run_tx("journal", lambda tx: tx.count_accumulator_journal_entries(task_id))
            return backends, {s: ex[s].stats() for s in ex}, {s: ex[s].circuit_stats() for s in ex}, journal
        finally:
            for u in undo:
                u()
            for side in ds:
                await aggs[side].shutdown()
                ex[side].shutdown()
                ds[side].cleanup()

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    (backends, stats, circuits, journal), launches = counted("poplar1 pair", (), lambda: asyncio.run(run()))
    secs["end_to_end"] = time.perf_counter() - t0
    if any(launches.values()):
        raise AssertionError(f"poplar pair launched port kernels: {launches}")
    for side, b in backends.items():
        if not isinstance(b, Poplar1Backend) or b.device.type != torch.device(DEVICE).type:
            raise AssertionError(f"poplar pair: the {side} did not walk on the card: {b}")
        if b.oracle_recompute_rows or b.oracle.rows["init"]:
            raise AssertionError(f"poplar pair: the {side} sent rows to the oracle")
        if any(c["trips"] or c["state"] != "closed" for c in circuits[side].values()):
            raise AssertionError(f"poplar pair: a breaker of the {side} tripped: {circuits[side]}")
        for level in POPLAR_PAIR_LEVELS:
            label = [k for k in stats[side] if f"/poplar_init/L{level}#" in k]
            if len(label) != 1 or stats[side][label[0]]["flushed_jobs"] <= stats[side][label[0]]["flushes"]:
                raise AssertionError(f"poplar pair: the {side}'s level {level} bucket did not coalesce jobs: "
                                     f"{[stats[side][k] for k in label]}")
    if backends["leader"].sketch_readback_rows:
        raise AssertionError(f"poplar pair: the leader read back {backends['leader'].sketch_readback_rows} sketch rows")
    if journal or replays.get("journal replays", [0])[0]:
        raise AssertionError(f"poplar pair: {journal} journal rows left, {replays} replayed on the oracle")
    rec = {
        "reports": len(shards16), "levels": levels, "seconds": secs, "uploads_per_s": len(shards16) / secs["upload"],
        "executor_stats": stats, "sketch_readback_rows": {s: b.sketch_readback_rows for s, b in backends.items()},
        "device_peak_memory_bytes": torch.cuda.max_memory_allocated(), "launches": launches,
    }
    phases["poplar1_pair"] = time.perf_counter() - t_phase
    level_s = ", ".join("%.3f s (%d collection steps)" % (v["seconds"], len(v["collection_steps"]))
                        for v in levels.values())
    log(f"poplar1 pair: {len(shards16)} reports; level {POPLAR_PAIR_LEVELS[0]} over {levels[POPLAR_PAIR_LEVELS[0]]['prefixes']} "
        f"prefixes and level {POPLAR_PAIR_LEVELS[1]} over {levels[POPLAR_PAIR_LEVELS[1]]['prefixes']} leaves, counts exact; "
        f"upload {secs['upload']:.3f} s, levels {level_s}, end to end {secs['end_to_end']:.3f} s")
    return rec


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def http_get(url: str, timeout: float = 10.0) -> bytes:
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.read()


def prometheus_samples(text: str):
    """[(name, {label: value}, value)] of a Prometheus text exposition."""
    import re

    out = []
    for line in text.splitlines():
        m = re.match(r"^([a-zA-Z_:][\w:]*)(?:\{(.*)\})?\s+(\S+)$", line)
        if m and not line.startswith("#"):
            labels = dict(re.findall(r'(\w+)="((?:[^"\\]|\\.)*)"', m.group(2) or ""))
            out.append((m.group(1), labels, float(m.group(3))))
    return out


def compute_app_pids():
    """The pids ``nvidia-smi --query-compute-apps`` lists, one a process
    that holds a context on a card."""
    return subprocess.run(["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.split()


def metric_sum(samples, name: str, **labels) -> float:
    return sum(v for n, lab, v in samples if n == name and all(lab.get(k) == x for k, x in labels.items()))


def fleet_canary(work, root, env, url, task_api, health, procs, logs, statusz, metrics):
    """Phase 18's canary: ``python -m janus_tpu_torch.binaries canary``
    against the running fleet, its tasks provisioned through both
    aggregators' task APIs, probing CANARY_FAMILIES every CANARY_PROBE_S.
    Raises unless each family reaches CANARY_OK ``ok`` verdicts within
    CANARY_TIMEOUT_S with no ``error``, ``timeout`` or ``corrupt`` verdict
    and no backoff; the canary's /statusz shows the fleet verdict
    ``healthy`` and a last-good time a family; the driver's and the
    helper's cuda-prepared reports rose by at least the reports of the ok
    probes, K1 launched again in both, and no backend fallback or journal
    replay was counted.  Leaves the canary running (the caller stops it);
    returns the record."""
    import os

    from janus_tpu_torch.core.canary import FAMILIES

    port = free_port()
    health["canary"] = f"http://127.0.0.1:{port}/"
    config = {
        "common": {"health_check_listen_address": f"127.0.0.1:{port}"},
        "canary": {
            "leader_endpoint": url["leader"], "helper_endpoint": url["helper"],
            "leader_task_api": f"http://127.0.0.1:{task_api['leader']}",
            "helper_task_api": f"http://127.0.0.1:{task_api['helper']}", "task_api_auth_token": "fleet-api",
            "families": list(CANARY_FAMILIES), "probe_interval_s": CANARY_PROBE_S,
            "poll_interval_s": CANARY_POLL_S, "collect_timeout_s": CANARY_COLLECT_S,
        },
    }
    path = os.path.join(work, "canary.json")
    with open(path, "w") as f:
        json.dump(config, f)
    sides = ("driver", "helper")
    prepared = {n: metric_sum(metrics(n), "janus_vdaf_prepare_reports_total", backend="cuda") for n in sides}
    launched = {n: statusz(n)["device"]["kernel_launches"] for n in sides}
    t0 = time.perf_counter()
    with open(logs["canary"], "w") as out:
        procs["canary"] = subprocess.Popen([sys.executable, "-m", "janus_tpu_torch.binaries", "canary", "--config-file",
                                            path], cwd=root, env=env, stdout=out, stderr=subprocess.STDOUT)
    while True:
        if procs["canary"].poll() is not None:
            raise AssertionError(f"canary: the binary exited {procs['canary'].returncode}")
        try:
            samples = metrics("canary")
        except OSError:
            samples = None
        if samples is not None:
            verdicts = {(lab["task"], lab["outcome"]): v for n, lab, v in samples if n == "janus_canary_verdict_total"}
            bad = {f"{t}/{o}": v for (t, o), v in verdicts.items() if o != "ok" and v}
            backoffs = metric_sum(samples, "janus_canary_backoffs_total")
            if bad or backoffs:
                raise AssertionError(f"canary: verdicts {bad}, {backoffs} backoffs")
            ok = {fam: verdicts.get((fam, "ok"), 0) for fam in CANARY_FAMILIES}
            if all(v >= CANARY_OK for v in ok.values()):
                break
        if time.perf_counter() - t0 > CANARY_TIMEOUT_S:
            raise AssertionError(f"canary: not {CANARY_OK} ok probes a family after {CANARY_TIMEOUT_S} s")
        time.sleep(0.25)
    rec = {"seconds_to_ok": time.perf_counter() - t0, "ok": ok}
    t1 = time.perf_counter()
    doc = statusz("canary")["canary"]
    rec["statusz_s"] = time.perf_counter() - t1
    rec["verdict"] = doc["verdict"]
    rec["last_good_unix"] = {fam: doc["families"][fam]["last_good_unix"] for fam in CANARY_FAMILIES}
    rec["stage_latency_s"] = doc["stage_latency_s"]
    if doc["verdict"] != "healthy" or None in rec["last_good_unix"].values():
        raise AssertionError(f"canary: /statusz shows {doc}")
    want = sum(len(FAMILIES[fam].measurements) * ok[fam] for fam in CANARY_FAMILIES)
    m = {n: metrics(n) for n in (*sides, "collection")}
    rec["cuda_prepared"], rec["launches"] = {}, {}
    for n in sides:
        rose = metric_sum(m[n], "janus_vdaf_prepare_reports_total", backend="cuda") - prepared[n]
        rec["cuda_prepared"][n] = rose
        if rose < want:
            raise AssertionError(f"canary: the {n} prepared {rose} reports on cuda, fewer than the ok probes' {want}")
        if metric_sum(m[n], "janus_vdaf_backend_fallback_total"):
            raise AssertionError(f"canary: the {n} counted backend fallbacks")
        launches = {STATUSZ_KERNELS[k]: v - launched[n][k] for k, v in statusz(n)["device"]["kernel_launches"].items()}
        PATH_LAUNCHES[f"canary {n}"] = rec["launches"][n] = launches
        log(f"canary {n} launches: {json.dumps(launches)}")
        if launches["keccak_squeeze"] <= 0 and DEVICE == "cuda":  # a CPU rehearsal takes the plain versions
            raise AssertionError(f"canary: the {n} launched no K1 while the canary probed")
    replays = sum(metric_sum(m[n], "janus_accumulator_journal_consumed_total", path="replay") for n in m)
    if replays:
        raise AssertionError(f"canary: {replays} journal rows replayed")
    return rec


def binaries_phase(seed, verify_key, hist_shards, phases):
    """Phase 18: the service binaries on the card.  Five processes of
    ``python -m janus_tpu_torch.binaries``: the leader's aggregator, the
    helper's aggregator with a device executor, the leader's aggregation-job
    creator, its aggregation-job driver with a device executor and the
    deferred accumulator (drain interval FLEET_DRAIN_S), and its
    collection-job driver; each side its own SQLite file, real localhost
    HTTP between them.  One Prio3Histogram(1024, 316) task in time-interval
    mode, provisioned on both sides with ``janus_cli provision-tasks``.
    While the binaries start (warmup and kernel build included), worker
    processes shard the reports beyond phase 13's (the port's client, the
    native host XOF); 1,024 reports and FLEET_TAMPERED tampered ones go up
    over HTTP to the leader; once the jobs are stepped the ``collect``
    binary collects at once (no drain wait).  Raises unless the aggregate is
    the plain histogram of the valid reports with ``report_count`` 1,024;
    the driver's and the helper's /metrics count cuda prepare launches, at
    least 1,024 cuda-prepared reports a side and no backend fallback; no
    journal row was replayed and the drains consumed every row written,
    one for each job that accepted a report (a job of rejected reports
    only writes none); no journal row is left on either datastore; both executor
    processes hold the card (``nvidia-smi --query-compute-apps``); both
    /statusz documents show the executor's Histogram buckets, a
    canonicalized plan and the card; K1-K3 launched in both after their
    warmup (under the reference's default canonical shapes Histogram(1024,
    316) resolves to its twin Histogram(1264, 316), and a flush of this one
    task runs the task's own planar prepare: K2's select variant stays at
    0); and SIGTERM stops all five with exit 0.  On a failure it prints the check, the traceback and
    the last 40 lines of each binary's log.  Returns the record."""
    import asyncio
    import base64
    import os
    import signal
    import tempfile
    import traceback

    import aiohttp

    from janus_tpu_torch.client import seal_report
    from janus_tpu_torch.core.hpke import HpkeKeypair
    from janus_tpu_torch.core.time import RealClock
    from janus_tpu_torch.datastore import Crypter, Datastore, ReportAggregationState
    from janus_tpu_torch.messages import Duration, Interval, ReportId, TaskId, Time
    from janus_tpu_torch.vdaf.canonical import canonical_vdaf_for
    from janus_tpu_torch.vdaf.instances import vdaf_from_instance

    t_phase = time.perf_counter()
    b64 = lambda b: base64.urlsafe_b64encode(b).rstrip(b"=").decode()  # noqa: E731
    root = os.path.dirname(os.path.abspath(__file__))
    work = tempfile.mkdtemp(prefix="janus-fleet-")
    desc = {"type": "Prio3Histogram", "length": LENGTH, "chunk_length": CHUNK}
    vdaf = vdaf_from_instance(desc)
    canonical = canonical_vdaf_for(vdaf) is not None
    precision = 3600
    start = int(time.time()) // precision * precision
    rng = np.random.default_rng([seed, 18])
    ds_key = rng.integers(0, 256, 16, dtype=np.uint8).tobytes()
    env = dict(os.environ, DATASTORE_KEYS=b64(ds_key))
    ports = {name: free_port() for name in FLEET}
    dap = {side: free_port() for side in ("leader", "helper")}
    task_api = {side: free_port() for side in dap}
    url = {side: f"http://127.0.0.1:{dap[side]}/" for side in dap}
    health = {name: f"http://127.0.0.1:{port}/" for name, port in ports.items()}
    db = {side: os.path.join(work, f"{side}.sqlite3") for side in dap}
    device = "" if DEVICE == "cuda" else f"vdaf_device: {DEVICE}\n"
    executor = (f"device_executor:\n  enabled: true\n  warmup_rows: {FLEET_WARMUP_ROWS}\n"
                f"  flush_window_ms: {FLEET_FLUSH_WINDOW_MS}\n  accumulator:\n    enabled: true\n")
    common = lambda name, side: (  # noqa: E731
        f"common:\n  database: {{path: {db[side]}}}\n  health_check_listen_address: 127.0.0.1:{ports[name]}\n"
        f"  status_sample_interval_s: 0.5\n")
    api = lambda side: f"task_api_listen_address: 127.0.0.1:{task_api[side]}\ntask_api_auth_tokens: [fleet-api]\n"  # noqa: E731
    configs = {
        "leader": common("leader", "leader") + f"listen_address: 127.0.0.1:{dap['leader']}\n"
                  f"max_upload_batch_write_delay_ms: 20\n{api('leader')}{device}",
        "helper": common("helper", "helper") + f"listen_address: 127.0.0.1:{dap['helper']}\n{api('helper')}"
                  f"{device}{executor}",
        "creator": common("creator", "leader") + f"aggregation_job_creation_interval_s: {FLEET_CREATE_S}\n"
                   f"min_aggregation_job_size: 1\nmax_aggregation_job_size: {FLEET_JOB_SIZE}\n",
        "driver": common("driver", "leader") + "job_driver: {job_discovery_interval_s: 0.1, max_concurrent_job_workers: 16}\n"
                  + device + executor + f"    drain_interval_s: {FLEET_DRAIN_S}\n"
                  f"    maintenance_interval_s: {FLEET_MAINTENANCE_S}\n",
        "collection": common("collection", "leader") + "job_driver: {job_discovery_interval_s: 0.1}\n",
    }
    for name, text in configs.items():
        with open(os.path.join(work, f"{name}.yaml"), "w") as f:
            f.write(text)
    logs = {name: os.path.join(work, f"{name}.log") for name in (*FLEET, "canary")}
    procs, secs, rec = {}, {}, {"reports": FLEET_REPORTS, "tampered": FLEET_TAMPERED}

    def binary(*args, timeout=120):
        out = subprocess.run([sys.executable, "-m", "janus_tpu_torch.binaries", *args], cwd=root, env=env,
                             capture_output=True, text=True, timeout=timeout)
        if out.returncode != 0:
            raise AssertionError(f"binaries {args[0]} {args[1]} exited {out.returncode}: {out.stderr[-2000:]}")
        return out.stdout

    def statusz(name):
        return json.loads(http_get(health[name] + "statusz"))

    def metrics(name):
        return prometheus_samples(http_get(health[name] + "metrics").decode())

    try:
        # -- the task, on both sides, through janus_cli provision-tasks
        task_id = TaskId.random()
        collector_keys = HpkeKeypair.generate(9)
        keys = {"leader": HpkeKeypair.generate(1), "helper": HpkeKeypair.generate(2)}
        t0 = time.perf_counter()
        for side in dap:
            peer = url["helper" if side == "leader" else "leader"]
            auth = ("aggregator_auth_token: fleet-agg\n  collector_auth_token_for_hash: fleet-col"
                    if side == "leader" else "aggregator_auth_token_for_hash: fleet-agg")
            path = os.path.join(work, f"{side}-tasks.yaml")
            with open(path, "w") as f:
                f.write(
                    f"- task_id: {b64(task_id.data)}\n  peer_aggregator_endpoint: {peer}\n"
                    f"  query_type: {{kind: TimeInterval}}\n  vdaf: {json.dumps(desc)}\n"
                    f"  role: {side.capitalize()}\n  vdaf_verify_key: {b64(verify_key)}\n  min_batch_size: 1\n"
                    f"  time_precision_s: {precision}\n  {auth}\n"
                    f"  collector_hpke_config: {b64(collector_keys.config.get_encoded())}\n"
                    f"  hpke_keys:\n    - config: {b64(keys[side].config.get_encoded())}\n"
                    f"      private_key: {b64(keys[side].private_key)}\n")
            if "provisioned task" not in binary("janus_cli", "provision-tasks", path, "--config-file",
                                                os.path.join(work, f"{side}.yaml")):
                raise AssertionError(f"janus_cli provision-tasks did not provision the {side}'s task")
        secs["provision"] = time.perf_counter() - t0

        # -- the five binaries, and the reports sharded meanwhile
        apps_before = compute_app_pids() if DEVICE == "cuda" else []
        t_boot = {}
        for name, kind in FLEET.items():
            t_boot[name] = time.perf_counter()
            with open(logs[name], "w") as out:
                procs[name] = subprocess.Popen(
                    [sys.executable, "-m", "janus_tpu_torch.binaries", kind, "--config-file",
                     os.path.join(work, f"{name}.yaml")], cwd=root, env=env, stdout=out, stderr=subprocess.STDOUT)
        extra = FLEET_REPORTS - len(hist_shards) + FLEET_TAMPERED
        per = -(-extra // FLEET_SHARD_WORKERS)
        with ProcessPoolExecutor(max_workers=FLEET_SHARD_WORKERS, mp_context=multiprocessing.get_context("spawn")) as pool:
            shard_jobs = [pool.submit(histogram_shard_job, seed, 100 + w, per, LENGTH, CHUNK)
                          for w in range(FLEET_SHARD_WORKERS)]
            ready = {}
            deadline = time.perf_counter() + FLEET_TIMEOUT_S
            while len(ready) < len(FLEET):
                for name in FLEET:
                    if name in ready:
                        continue
                    if procs[name].poll() is not None:
                        raise AssertionError(f"the {name} binary exited {procs[name].returncode} while starting")
                    try:
                        doc = statusz(name)
                    except OSError:
                        continue
                    compile_ = (doc.get("executor") or {}).get("compile")
                    if compile_ is None or (compile_ and all(c["state"] == "warm" for c in compile_.values())):
                        ready[name] = time.perf_counter() - t_boot[name]
                if time.perf_counter() > deadline:
                    raise AssertionError(f"binaries not ready after {FLEET_TIMEOUT_S} s: ready {sorted(ready)}")
                time.sleep(0.1)
            t0 = time.perf_counter()
            fresh = [x for j in shard_jobs for x in j.result()][:extra]
            secs["shard_wait"] = time.perf_counter() - t0
        secs["shard_and_start"] = time.perf_counter() - min(t_boot.values())
        rec["startup_to_ready_s"] = ready
        warm_launches = {name: statusz(name)["device"]["kernel_launches"] for name in ("driver", "helper")}

        # -- uploads over HTTP through the port's client
        shards = list(hist_shards)[:FLEET_REPORTS] + fresh
        tampered = [False] * FLEET_REPORTS + [True] * FLEET_TAMPERED
        hpke = [keys[side].config for side in ("leader", "helper")]
        sealed = [seal_report(vdaf, task_id, *hpke, ReportId(nonce), Time(start), public,
                              tamper(vdaf, shares) if bad else shares)
                  for (_m, (nonce, public, shares)), bad in zip(shards, tampered)]

        async def upload_all():
            async with aiohttp.ClientSession() as session:
                async def put(report):
                    async with session.put(f"{url['leader']}tasks/{task_id}/reports", data=report.get_encoded(),
                                           headers={"Content-Type": "application/dap-report"}) as r:
                        if r.status != 201:
                            raise AssertionError(f"binaries: upload answered {r.status}: {await r.text()}")

                for i in range(0, len(sealed), PAIR_UPLOAD_WAVE):
                    await asyncio.gather(*[put(r) for r in sealed[i:i + PAIR_UPLOAD_WAVE]])

        t_first = time.perf_counter()
        asyncio.run(upload_all())
        secs["upload"] = time.perf_counter() - t_first
        rec["uploads_per_s"] = len(sealed) / secs["upload"]

        # -- the jobs are stepped: collect at once
        leader_ds = Datastore(db["leader"], Crypter([ds_key]), RealClock())
        interval = Interval(Time(start), Duration(precision))

        def pending(tx):
            return (tx.count_unaggregated_client_reports_for_interval(task_id, interval),
                    tx.lease_summary()["aggregation"]["active"])

        while leader_ds.run_tx("fleet_pending", pending) != (0, 0):
            if time.perf_counter() - t_first > FLEET_TIMEOUT_S:
                raise AssertionError("binaries: the aggregation jobs did not finish")
            time.sleep(0.05)
        secs["aggregate"] = time.perf_counter() - t_first - secs["upload"]
        def job_outcomes(tx):
            # a job writes its journal row only for the reports it accepted:
            # one whose reports were all rejected (the tampered tail can be a
            # job of its own) writes none and leaves nothing to drain
            return [any(ra.state == ReportAggregationState.FINISHED for ra in
                        tx.get_report_aggregations_for_aggregation_job(task_id, job.aggregation_job_id))
                    for job in tx.get_aggregation_jobs_for_task(task_id)]

        outcomes = leader_ds.run_tx("fleet_jobs", job_outcomes)
        jobs, journaled_jobs = len(outcomes), sum(outcomes)
        t0 = time.perf_counter()
        out = binary("collect", "--task-id", b64(task_id.data), "--leader", url["leader"], "--vdaf", "histogram",
                     "--length", str(LENGTH), "--chunk-length", str(CHUNK),
                     "--authorization-bearer-token", "fleet-col", "--batch-interval-start", str(start),
                     "--batch-interval-duration", str(precision),
                     "--hpke-config", b64(collector_keys.config.get_encoded()),
                     "--hpke-private-key", b64(collector_keys.private_key), timeout=FLEET_TIMEOUT_S)
        secs["collect"] = time.perf_counter() - t0
        secs["end_to_end"] = time.perf_counter() - t_first
        result = json.loads(out.strip().splitlines()[-1])
        valid = [m for (m, _r), bad in zip(shards, tampered) if not bad]
        if result["report_count"] != FLEET_REPORTS or result["aggregate_result"] != np.bincount(
                valid, minlength=LENGTH).tolist():
            raise AssertionError(f"binaries: collected {result['report_count']} reports, not the exact histogram "
                                 f"of the {len(valid)} valid ones")

        # -- the gates on /metrics, /statusz, the datastores and the card
        m = {name: metrics(name) for name in ("leader", "driver", "helper", "collection")}
        rec["hpke_open_rows"] = {
            f"{name} {stage}": {r: metric_sum(m[name], "janus_hpke_open_rows_total", stage=stage, route=r)
                                for r in ("vector", "aead", "inline")}
            for name, stage in (("leader", "upload"), ("helper", "aggregate_init"))}
        if DEVICE == "cuda" and not rec["hpke_open_rows"]["leader upload"]["vector"]:
            raise AssertionError(f"binaries: no upload took the leader's vector pass: {rec['hpke_open_rows']}")
        for side in ("driver", "helper"):
            if metric_sum(m[side], "janus_device_prepare_launches_total", backend="cuda") <= 0:
                raise AssertionError(f"binaries: the {side} counted no cuda prepare launch")
            got = metric_sum(m[side], "janus_vdaf_prepare_reports_total", backend="cuda")
            if got < FLEET_REPORTS:
                raise AssertionError(f"binaries: the {side} prepared {got} reports on cuda, fewer than {FLEET_REPORTS}")
            fallbacks = metric_sum(m[side], "janus_vdaf_backend_fallback_total")
            if fallbacks:
                raise AssertionError(f"binaries: the {side} counted {fallbacks} backend fallbacks")
        replays = sum(metric_sum(m[n], "janus_accumulator_journal_consumed_total", path="replay") for n in m)
        drains = metric_sum(m["driver"], "janus_accumulator_journal_consumed_total", path="drain")
        written = metric_sum(m["driver"], "janus_accumulator_journal_entries_total")
        if replays or not journaled_jobs or drains != written or written != journaled_jobs:
            raise AssertionError(f"binaries: {written} journal rows written and consumed by {drains} drains and "
                                 f"{replays} replays for {journaled_jobs} jobs with accepted reports of {jobs}")
        rec.update(jobs=jobs, journaled_jobs=journaled_jobs, journal_rows=written, journal_drains=drains,
                   journal_replays=replays)
        helper_journal = Datastore(db["helper"], Crypter([ds_key]), RealClock())
        try:
            left = [d.run_tx("journal", lambda tx: tx.count_accumulator_journal_entries(task_id))
                    for d in (leader_ds, helper_journal)]
        finally:
            helper_journal.close()
            leader_ds.close()
        if any(left):
            raise AssertionError(f"binaries: journal rows left on the leader, helper: {left}")
        if DEVICE == "cuda":
            apps = compute_app_pids()
            rec["compute_app_pids"] = apps
            ours = {str(p.pid) for p in procs.values()} | {str(os.getpid())}
            if set(apps) & ours:
                missing = [name for name in ("driver", "helper") if str(procs[name].pid) not in apps]
            else:
                # nvidia-smi sees another PID namespace (inside a container
                # it may list every compute app under one pid): count the
                # apps instead, the smoke's own and one a binary holding a
                # context
                holding = [n for n in FLEET if statusz(n)["device"].get("cuda_initialized")]
                missing = [] if len(apps) - len(apps_before) >= len(holding) else ["driver", "helper"]
                missing += [n for n in ("driver", "helper") if n not in holding]
                rec["compute_apps"] = {"before": len(apps_before), "running": len(apps), "holding": holding}
            if missing:
                raise AssertionError(f"binaries: nvidia-smi lists no compute app of the {missing} "
                                     f"(pids {[procs[n].pid for n in missing]}; listed {apps})")
        card = torch.cuda.get_device_name(0) if DEVICE == "cuda" else "cpu"
        rec["launches"] = {}
        for name in ("driver", "helper"):
            doc = statusz(name)
            if DEVICE == "cuda" and not doc["device"].get("memory_allocated_bytes"):
                raise AssertionError(f"binaries: the {name} holds no memory on the card: {doc['device']}")
            buckets = doc["executor"]["buckets"]
            hist = {k: {f: v[f] for f in ("flushes", "flushed_jobs") if f in v}
                    for k, v in buckets.items() if k.startswith("Histogram/")}
            if not hist or card not in doc["device"]["devices"]:
                raise AssertionError(f"binaries: the {name}'s /statusz shows buckets {sorted(buckets)} and devices "
                                     f"{doc['device']['devices']}, not Histogram buckets on {card}")
            rec.setdefault("statusz_flushes", {})[name] = hist
            plans = doc["executor"]["canonicalization"]
            rec.setdefault("statusz_canonicalization", {})[name] = plans
            if canonical and not plans.get("canonicalized"):
                raise AssertionError(f"binaries: the {name}'s /statusz shows no canonicalized plan: {plans}")
            launches = {STATUSZ_KERNELS[k]: v - warm_launches[name][k] for k, v in doc["device"]["kernel_launches"].items()}
            PATH_LAUNCHES[f"binaries {name}"] = rec["launches"][name] = launches
            log(f"binaries {name} launches: {json.dumps(launches)}")
            missing = [k for k in KERNEL_NAMES[:3] if launches[k] <= 0]
            if missing and DEVICE == "cuda":  # a CPU rehearsal takes the plain versions
                raise AssertionError(f"binaries: the {name} never launched {missing} after its warmup")
            if launches["keccak_absorb_select"]:
                raise AssertionError(f"binaries: the {name}'s flushes of one task took the twin's masked path: {launches}")

        # -- the canary probes the running fleet, its tasks provisioned
        # through both task APIs
        t0 = time.perf_counter()
        rec["canary"] = fleet_canary(work, root, env, url, task_api, health, procs, logs, statusz, metrics)
        secs["canary"] = time.perf_counter() - t0

        # -- SIGTERM stops all six with exit 0, the canary first
        codes = {}
        for name in ["canary"] + [n for n in procs if n != "canary"]:
            procs[name].send_signal(signal.SIGTERM)
            if name == "canary":
                codes[name] = procs[name].wait(timeout=CANARY_COLLECT_S + 30)
        codes.update({name: p.wait(timeout=60) for name, p in procs.items() if name != "canary"})
        if any(codes.values()):
            raise AssertionError(f"binaries: SIGTERM exit codes {codes}")
    except BaseException:
        log(f"binaries: phase failed:\n{traceback.format_exc()}")
        for name, path in logs.items():
            if os.path.exists(path):
                with open(path, errors="replace") as f:
                    tail = f.read().splitlines()[-40:]
                log(f"--- the {name} binary's log, last {len(tail)} lines:\n" + "\n".join(tail))
        raise
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    rec["seconds"] = secs
    phases["binaries"] = time.perf_counter() - t_phase
    log(f"binaries: canary {json.dumps(rec['canary'])}")
    log(f"binaries: {FLEET_REPORTS} reports ({FLEET_TAMPERED} tampered, rejected) through 5 processes in {jobs} jobs; "
        f"aggregate exact; upload {secs['upload']:.3f} s ({rec['uploads_per_s']:.1f}/s; HPKE opens by route "
        f"{json.dumps(rec['hpke_open_rows'])}); first upload to collected "
        f"aggregate {secs['end_to_end']:.3f} s; startup to ready {json.dumps({k: round(v, 3) for k, v in ready.items()})} s; "
        f"statusz flushes {json.dumps(rec['statusz_flushes'])}; journal rows drained {drains:.0f}, replayed {replays:.0f}")
    return rec


def interop_phase(seed, phases):
    """Phase 22: the interop binaries on the card, through nothing but the
    ``/internal/test/*`` API over localhost HTTP.  Seven processes of
    ``python -m janus_tpu_torch.binaries janus_interop_<role> --port P``:
    the leader's and the helper's aggregator with no backend in the
    environment (the card), INTEROP_CLIENTS clients and a collector.  After
    ``ready`` on all seven, each task of INTEROP_TASKS is added to the
    collector (for its HPKE config) and to both aggregators, in
    time-interval mode with ``min_batch_size`` its uploads; its seeded
    measurements go up concurrently, round-robin over the clients, then
    ``collection_start`` and ``collection_poll`` until it succeeds within
    INTEROP_COLLECT_S.  Raises unless each ``report_count`` and ``result``
    is exact (Count: the sum; Histogram: every count, as strings), nvidia-smi
    counts two more compute apps while the aggregators run, each
    aggregator's SIGTERM line shows K1-K3 launched and no backend
    fallback, and all seven exit 0 on SIGTERM.  On a failure it prints the
    check, the traceback and each process's last 40 log lines.  Returns
    the record: each process's startup-to-ready, each task's uploads/s and
    seconds from its first upload to its collected aggregate, and the
    phase's seconds."""
    import asyncio
    import base64
    import os
    import signal
    import tempfile
    import traceback

    import aiohttp

    t_phase = time.perf_counter()
    b64 = lambda b: base64.urlsafe_b64encode(b).rstrip(b"=").decode()  # noqa: E731
    root = os.path.dirname(os.path.abspath(__file__))
    work = tempfile.mkdtemp(prefix="janus-interop-")
    env = {k: v for k, v in os.environ.items() if not k.startswith("JANUS_TPU_TORCH_VDAF_")}
    env["TMPDIR"] = work  # the aggregators' SQLite files
    if DEVICE != "cuda":
        env["JANUS_TPU_TORCH_VDAF_DEVICE"] = DEVICE
    roles = {"leader": "aggregator", "helper": "aggregator",
             **{f"client{i}": "client" for i in range(INTEROP_CLIENTS)}, "collector": "collector"}
    clients = [n for n, r in roles.items() if r == "client"]
    ports = {name: free_port() for name in roles}
    base = {name: f"http://127.0.0.1:{port}/internal/test/" for name, port in ports.items()}
    logs = {name: os.path.join(work, f"{name}.log") for name in roles}
    rng = np.random.default_rng([seed, 22])
    procs, rec = {}, {"tasks": {}}
    precision = 3600

    async def drive():
        async with aiohttp.ClientSession() as session:
            async def call(name, path, body):
                async with session.post(base[name] + path, json=body) as r:
                    if r.status != 200:
                        raise AssertionError(f"interop: {name} {path} answered {r.status}: {await r.text()}")
                    doc = await r.json()
                if doc.get("status") not in ("success", "in progress"):
                    raise AssertionError(f"interop: {name} {path}: {doc}")
                return doc

            # -- ready on all seven
            ready, deadline = {}, time.perf_counter() + INTEROP_READY_S
            while len(ready) < len(roles):
                for name in roles:
                    if name in ready:
                        continue
                    if procs[name].poll() is not None:
                        raise AssertionError(f"interop: the {name} exited {procs[name].returncode} before ready")
                    try:
                        async with session.post(base[name] + "ready", json={}) as r:
                            if r.status == 200:
                                ready[name] = time.perf_counter() - t_boot[name]
                    except (aiohttp.ClientError, OSError):
                        pass
                if time.perf_counter() > deadline:
                    raise AssertionError(f"interop: not ready after {INTEROP_READY_S} s: ready {sorted(ready)}")
                await asyncio.sleep(0.1)
            rec["startup_to_ready_s"] = ready
            dap = {side: base[side].split("/internal/")[0] + (await call(side, "endpoint_for_task", {}))["endpoint"]
                   for side in ("leader", "helper")}

            # -- the tasks: the collector first, for its HPKE config
            tasks = []
            for name, vdaf, uploads in INTEROP_TASKS:
                task_id = b64(rng.integers(0, 256, 32, dtype=np.uint8).tobytes())
                doc = await call("collector", "add_task", {"task_id": task_id, "leader": dap["leader"], "vdaf": vdaf,
                                                           "collector_authentication_token": "interop-col",
                                                           "query_type": 1})
                common = {"task_id": task_id, "leader": dap["leader"], "helper": dap["helper"], "vdaf": vdaf,
                          "leader_authentication_token": "interop-agg",
                          "vdaf_verify_key": b64(rng.integers(0, 256, 16, dtype=np.uint8).tobytes()),
                          "min_batch_size": uploads, "time_precision": precision, "query_type": 1,
                          "collector_hpke_config": doc["collector_hpke_config"]}
                await call("leader", "add_task", {**common, "role": "Leader",
                                                  "collector_authentication_token": "interop-col"})
                await call("helper", "add_task", {**common, "role": "Helper"})
                top = 2 if vdaf["type"] == "Prio3Count" else int(vdaf["length"])
                tasks.append((name, vdaf, task_id, rng.integers(0, top, uploads).tolist()))

            async def run_task(name, vdaf, task_id, meas, uploaded):
                flight = asyncio.Semaphore(INTEROP_IN_FLIGHT)

                async def upload(i, m):
                    async with flight:
                        await call(clients[i % len(clients)], "upload",
                                   {"task_id": task_id, "leader": dap["leader"], "helper": dap["helper"],
                                    "vdaf": vdaf, "measurement": str(m), "time_precision": precision})

                t_first = time.time()
                t0 = time.perf_counter()
                await asyncio.gather(*[upload(i, m) for i, m in enumerate(meas)])
                upload_s = time.perf_counter() - t0
                uploaded.set()
                start = int(t_first) // precision * precision
                doc = await call("collector", "collection_start", {
                    "task_id": task_id, "agg_param": "",
                    "query": {"type": 1, "batch_interval_start": start, "batch_interval_duration": 2 * precision}})
                while True:
                    result = await call("collector", "collection_poll", {"handle": doc["handle"]})
                    if result["status"] == "success":
                        break
                    if time.perf_counter() - t0 > upload_s + INTEROP_COLLECT_S:
                        raise AssertionError(f"interop: {name} not collected {INTEROP_COLLECT_S} s after its uploads")
                    await asyncio.sleep(0.25)
                e2e = time.perf_counter() - t0
                want = (str(sum(meas)) if vdaf["type"] == "Prio3Count"
                        else [str(c) for c in np.bincount(meas, minlength=int(vdaf["length"]))])
                if result["report_count"] != len(meas) or result["result"] != want:
                    raise AssertionError(f"interop: {name} collected {result['report_count']} reports and a result "
                                         f"other than the plain aggregate of its {len(meas)} measurements")
                rec["tasks"][name] = {"vdaf": vdaf, "uploads": len(meas), "upload_s": upload_s,
                                      "uploads_per_s": len(meas) / upload_s, "first_upload_to_collected_s": e2e}

            # the tasks upload one after the other; a task's collection
            # runs while the next one uploads
            gates = [asyncio.Event() for _ in tasks]
            async def after(i, task):
                if i:
                    await gates[i - 1].wait()
                await run_task(*task, gates[i])

            await asyncio.gather(*[after(i, t) for i, t in enumerate(tasks)])

    try:
        apps_before = compute_app_pids() if DEVICE == "cuda" else []
        t_boot = {}
        for name, role in roles.items():
            t_boot[name] = time.perf_counter()
            with open(logs[name], "w") as out:
                procs[name] = subprocess.Popen(
                    [sys.executable, "-m", "janus_tpu_torch.binaries", f"janus_interop_{role}", "--port",
                     str(ports[name])], cwd=root, env=env, stdout=out, stderr=subprocess.STDOUT)
        asyncio.run(drive())
        if DEVICE == "cuda":
            apps = compute_app_pids()
            rec["compute_apps"] = {"before": len(apps_before), "running": len(apps)}
            if len(apps) - len(apps_before) < 2:
                raise AssertionError(f"interop: nvidia-smi lists {len(apps)} compute apps, not 2 more than the "
                                     f"{len(apps_before)} before the aggregators started")

        # -- SIGTERM stops all seven with exit 0; each aggregator prints its
        # launch line as it stops
        for p in procs.values():
            p.send_signal(signal.SIGTERM)
        codes = {name: p.wait(timeout=60) for name, p in procs.items()}
        if any(codes.values()):
            raise AssertionError(f"interop: SIGTERM exit codes {codes}")
        rec["launches"] = {}
        for side in ("leader", "helper"):
            with open(logs[side]) as f:
                lines = [json.loads(x)["interop_aggregator"] for x in f if x.startswith('{"interop_aggregator"')]
            if len(lines) != 1:
                raise AssertionError(f"interop: the {side} printed {len(lines)} launch lines")
            line = lines[0]
            launches = {STATUSZ_KERNELS[k]: v for k, v in line["kernel_launches"].items()}
            PATH_LAUNCHES[f"interop {side}"] = rec["launches"][side] = launches
            log(f"interop {side} launches: {json.dumps(launches)}")
            missing = [k for k in KERNEL_NAMES[:3] if launches.get(k, 0) <= 0]
            if line["vdaf_backend"] != "cuda" or (missing and DEVICE == "cuda"):
                raise AssertionError(f"interop: the {side} ran {line['vdaf_backend']} and never launched {missing}")
            if line["janus_vdaf_backend_fallback_total"]:
                raise AssertionError(f"interop: the {side} counted {line['janus_vdaf_backend_fallback_total']} "
                                     f"backend fallbacks")
            rec.setdefault("hpke_open_rows", {})[side] = line["hpke_open_rows"]
            if side == "leader" and DEVICE == "cuda" and not line["hpke_open_rows"]["upload"]["vector"]:
                raise AssertionError(f"interop: no upload took the leader's vector pass: {line['hpke_open_rows']}")
    except BaseException:
        log(f"interop: phase failed:\n{traceback.format_exc()}")
        for name, path in logs.items():
            if os.path.exists(path):
                with open(path, errors="replace") as f:
                    tail = f.read().splitlines()[-40:]
                log(f"--- the {name} process's log, last {len(tail)} lines:\n" + "\n".join(tail))
        raise
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    phases["interop"] = rec["seconds"] = time.perf_counter() - t_phase
    log(f"interop: {json.dumps(rec)}")
    return rec


def upload_phase(seed, hist_vdaf, hist_report, phases):
    """Phase 23: the upload vector pass on the card.  Random plaintexts of
    the byte length of one real encoded leader share of Histogram(1024,
    316) (``hist_report``) and of Count, sealed with the port's
    ``core/hpke.py`` to one leader key, are opened in batches of each
    size in UPLOAD_BATCHES through ``hpke_batch.open_batch`` on DEVICE:
    once on the vector route (the card's AES pass and the host GHASH, the
    route the default rule picks on the card) and once on the per-report
    route (``JANUS_TPU_TORCH_UPLOAD_VECTOR_GCM=0``), each batch with
    UPLOAD_TAMPERED rows whose ciphertext has a flipped byte.  Raises
    unless both routes' plaintexts are byte-equal to each other and to the
    sealed ones, the tampered rows are rejected and only those, and each
    route's counter moved by exactly the batch's rows.  Times: each
    route's whole open a batch (host clock), the AES pass's device ms
    (CUDA events, ``ops/aes.py`` ``encrypt_blocks_multikey`` over the
    batch's blocks), the keystream with its copies in and out (host clock,
    synchronised), and GHASH's host ms.  Returns the record."""
    import os

    from janus_tpu_torch.client import seal_report
    from janus_tpu_torch.core import hpke_batch
    from janus_tpu_torch.core.hpke import HpkeApplicationInfo, HpkeError, HpkeKeypair, Label, seal
    from janus_tpu_torch.messages import HpkeCiphertext, ReportId, Role, TaskId, Time
    from janus_tpu_torch.ops.aes import encrypt_blocks_multikey, expand_keys, to_device_bytes
    from janus_tpu_torch.vdaf.instances import prio3_count

    t_phase = time.perf_counter()
    rng = np.random.default_rng([seed, 23])
    keys = HpkeKeypair.generate(1)
    info = HpkeApplicationInfo.new(Label.INPUT_SHARE, Role.CLIENT, Role.LEADER)
    count_vdaf = prio3_count()
    (count_report,), _m = shard_reports(count_vdaf, rng, lambda r: 1, 1)
    bodies = {}
    for name, vdaf, (nonce, public, shares) in (("histogram", hist_vdaf, hist_report),
                                                ("count", count_vdaf, count_report)):
        sealed = seal_report(vdaf, TaskId(bytes(32)), keys.config, keys.config, ReportId(nonce), Time(0), public,
                             shares)
        bodies[name] = len(sealed.leader_encrypted_input_share.payload) - 16  # less the tag
    rec = {"plaintext_bytes": bodies, "aad_bytes": UPLOAD_AAD, "batches": {}}
    saved_env = os.environ.pop(hpke_batch.VECTOR_GCM_ENV, None)

    def routed(route, fn):
        """(result, whole ms, rows counted by route) of one open; the
        vector route as the default rule picks it on the card (forced on a
        CPU rehearsal), the per-report route forced."""
        force = "0" if route == "aead" else (None if DEVICE == "cuda" else "1")
        if force is None:
            os.environ.pop(hpke_batch.VECTOR_GCM_ENV, None)
        else:
            os.environ[hpke_batch.VECTOR_GCM_ENV] = force
        before = hpke_batch.route_rows("upload")
        t0 = time.perf_counter()
        out = fn()
        ms = (time.perf_counter() - t0) * 1e3
        after = hpke_batch.route_rows("upload")
        return out, ms, {k: after[k] - before[k] for k in after}

    def run():
        # the first pass on a device builds its AES tables and checks them
        # against FIPS-197: not part of any batch's time
        hpke_batch._keystream([bytes(16)] * 2, [bytes(12)] * 2, 4, DEVICE)
        for name, n in bodies.items():
            top = max(UPLOAD_BATCHES)
            pts = [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for _ in range(top)]
            aads = [rng.integers(0, 256, UPLOAD_AAD, dtype=np.uint8).tobytes() for _ in range(top)]
            cts = [seal(keys.config, info, p, a) for p, a in zip(pts, aads)]
            kmax = 2 + -(-n // 16)
            for B in UPLOAD_BATCHES:
                bad = set(rng.choice(B, UPLOAD_TAMPERED, replace=False).tolist())
                requests = []
                for i in range(B):
                    ct = cts[i]
                    if i in bad:
                        ct = HpkeCiphertext(ct.config_id, ct.encapsulated_key, bytes([ct.payload[0] ^ 1]) + ct.payload[1:])
                    requests.append((keys, info, ct, aads[i]))
                opened, ms = {}, {}
                for route in ("vector", "aead"):
                    opened[route], ms[route], moved = routed(route, lambda: hpke_batch.open_batch(requests, DEVICE))
                    if moved != {"vector": B if route == "vector" else 0, "aead": 0 if route == "vector" else B,
                                 "inline": 0}:
                        raise AssertionError(f"upload {name} B = {B}: the {route} route counted {moved}")
                for i in range(B):
                    if i in bad:
                        if not all(isinstance(opened[r][i], HpkeError) for r in opened):
                            raise AssertionError(f"upload {name} B = {B}: tampered row {i} was opened")
                    elif not opened["vector"][i] == opened["aead"][i] == pts[i]:
                        raise AssertionError(f"upload {name} B = {B}: row {i} opened to other bytes")
                aes_keys = [rng.integers(0, 256, 16, dtype=np.uint8).tobytes() for _ in range(B)]
                nonces = [rng.integers(0, 256, 12, dtype=np.uint8).tobytes() for _ in range(B)]
                rk = to_device_bytes(expand_keys(aes_keys), DEVICE)
                blocks = to_device_bytes(rng.integers(0, 256, (B, kmax, 16), dtype=np.uint8), DEVICE)
                aes_ms = cuda_time_ms(lambda: encrypt_blocks_multikey(rk, blocks), reps=2)
                del rk, blocks
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                stream = hpke_batch._keystream(aes_keys, nonces, kmax, DEVICE)
                keystream_ms = (time.perf_counter() - t0) * 1e3
                datas = hpke_batch._ghash_inputs(aads[:B], [c.payload[:-16] for c in cts[:B]])
                t0 = time.perf_counter()
                hpke_batch._ghash_batch(np.ascontiguousarray(stream[:, 0]), datas)
                ghash_ms = (time.perf_counter() - t0) * 1e3
                rec["batches"][f"{name} B={B}"] = {
                    "rows": B, "tampered": len(bad), "aes_blocks": B * kmax, "ghash_steps": len(datas[0]) // 16,
                    "vector_ms": ms["vector"], "aead_ms": ms["aead"], "aes_device_ms": aes_ms,
                    "keystream_ms": keystream_ms, "ghash_host_ms": ghash_ms,
                }
                log(f"upload {name} ({n} bytes) B = {B}: vector route {ms['vector']:.2f} ms (AES on the card "
                    f"{aes_ms:.3f} ms device, keystream with copies {keystream_ms:.2f} ms, GHASH on the host "
                    f"{ghash_ms:.2f} ms), per-report route {ms['aead']:.2f} ms; {len(bad)} tampered rows rejected")

    try:
        _r, launches = counted("upload vector pass", (), run)
    finally:
        if saved_env is None:
            os.environ.pop(hpke_batch.VECTOR_GCM_ENV, None)
        else:
            os.environ[hpke_batch.VECTOR_GCM_ENV] = saved_env
    if any(launches.values()):
        raise AssertionError(f"the upload vector pass launched port kernels: {launches}")
    phases["upload"] = rec["seconds"] = time.perf_counter() - t_phase
    return rec


def fixedpoint_rows(vdaf, fp_done, rng, rows: int, lie_rows: int):
    """FixedPoint rows as phase 14 builds them: the distinct reports of
    ``fp_done`` tiled to ``rows`` and ``lie_rows`` rows of its norm-lie
    reports, shuffled, the leader's shares decoded as an upload delivers
    them.  Returns (leader rows, helper rows, rejected flags, distinct
    report per row (-1 for a lie), measurements, oracle outputs)."""
    shards = [x for done, _lie, _s in fp_done for x in done]
    lies = [lie for _done, lie, _s in fp_done]
    meas, reports, oracle = zip(*shards)
    leader_rows, helper_rows, bad, src = build_batch(vdaf, list(reports), rng, rows, 0)
    extra = [lies[i % len(lies)] for i in range(lie_rows)]
    order = rng.permutation(rows + lie_rows)
    leader_rows = [(leader_rows + [(n, p, s[0]) for n, p, s in extra])[j] for j in order]
    helper_rows = [(helper_rows + [(n, p, s[1]) for n, p, s in extra])[j] for j in order]
    bad = np.concatenate([bad, np.ones(lie_rows, dtype=bool)])[order]
    src = np.concatenate([src, -np.ones(lie_rows, dtype=src.dtype)])[order]
    return decoded_leader_rows(vdaf, leader_rows), helper_rows, bad, src, meas, oracle


def canonical_bucket(name, tasks, verify_key, rng):
    """One canonical bucket on the card: the tasks (dicts of ``vdaf``,
    ``leader``/``helper`` rows, ``bad`` flags, ``expect`` (accepted mask ->
    aggregate) and ``oracle`` (row, agg_id -> the oracle's prep share
    bytes, out share and seed)) all resolve through one ``DeviceExecutor``
    to one cached ``CudaBackend(twin, canonical=True)``, warmed at the
    flush's size; each side's jobs (one a task, 3-tuple requests) flush
    once together, and so do the combines.  Raises unless the tasks share
    one key and one backend, one flush a side holds every task, each
    aggregate is exact, every rejected row is rejected and no other, every
    out share has its task's length, SAMPLED rows a task equal its oracle
    byte for byte (prep share, out share, joint-rand seed), every leader
    row was marshalled from its bytes, the twin's oracle prepared nothing
    and the tasks' oracles only the not-ok rows, and no FLP kernel
    launched.  Returns (record, backend, the helper's staged flush)."""
    import asyncio

    from janus_tpu_torch.executor import KIND_COMBINE, KIND_PREP_INIT, DeviceExecutor, ExecutorConfig
    from janus_tpu_torch.vdaf.backend import make_backend
    from janus_tpu_torch.vdaf.canonical import executor_shape

    shapes = [executor_shape(t["vdaf"]) for t in tasks]
    key, twin = shapes[0]
    if twin is None or any(k != key for k, _ in shapes):
        raise AssertionError(f"canonical {name}: the tasks do not share one canonical key")
    batch = sum(len(t["leader"]) for t in tasks)
    ex = DeviceExecutor(ExecutorConfig(flush_max_rows=batch))
    resolved = [ex.backend_for(k, lambda: make_backend(twin, "cuda", device=DEVICE, canonical=True)) for k, _ in shapes]
    backend = resolved[0]
    if any(b is not backend for b in resolved) or not backend.canonical or backend.vdaf is not twin:
        raise AssertionError(f"canonical {name}: the tasks resolved {len({id(b) for b in resolved})} backends")
    t0 = time.perf_counter()
    ex.warmup_backend(backend, pad_to=batch)
    warm_s = time.perf_counter() - t0
    backend.outshare_readback_rows = 0
    backend.leader_marshal_rows = {"bytes": 0, "values": 0}
    route = backend._prep_fn(0, batch).__name__
    if route != "prep_init":
        raise AssertionError(f"canonical {name}: a flush of {batch} rows takes {route}, not the masked row path")

    async def job():
        secs, preps = {}, {}
        for agg_id, side in ((0, "leader"), (1, "helper")):
            t0 = time.perf_counter()
            preps[agg_id] = await asyncio.gather(*[
                ex.submit(key, KIND_PREP_INIT, (verify_key, t[side], t["vdaf"]), backend=backend, agg_id=agg_id,
                          task_ident=bytes([i]))
                for i, t in enumerate(tasks)
            ])
            secs[f"{side}_prep_init"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        msgs = await asyncio.gather(*[
            ex.submit(key, KIND_COMBINE, [[a[1], h[1]] for a, h in zip(preps[0][i], preps[1][i])], backend=backend,
                      agg_id=1, task_ident=bytes([i]))
            for i in range(len(tasks))
        ])
        secs["combine"] = time.perf_counter() - t0
        return preps, msgs, secs

    try:
        t_job = time.perf_counter()
        (preps, msgs, secs), launches = counted(f"canonical {name}", CANONICAL_KERNELS, lambda: asyncio.run(job()))
        e2e = time.perf_counter() - t_job
        stats = ex.stats()
    finally:
        ex.shutdown()
    no_flp_kernels(f"canonical {name}", launches)
    prep_stats = {k: v for k, v in stats.items() if "/prep_init#" in k}
    if len(prep_stats) != 2 or any(v["flushes"] != 1 or v["flushed_jobs"] != len(tasks) for v in prep_stats.values()):
        raise AssertionError(f"canonical {name}: prepare buckets {prep_stats}, not one flush a side of {len(tasks)} jobs")
    f = backend.bp.f
    record = {"twin": {k: v for k, v in vars(twin.flp.valid).items() if isinstance(v, int) and not k.startswith("_")},
              "batch": batch, "route": route, "seconds": e2e, "phases_s": secs, "warmup_s": warm_s,
              "executor_stats": stats, "launches": launches, "tasks": []}
    t0 = time.perf_counter()
    for i, t in enumerate(tasks):
        vdaf, bad = t["vdaf"], t["bad"]
        lead, help_ = preps[0][i], preps[1][i]
        accepted = np.zeros(len(lead), dtype=bool)
        for b, msg in enumerate(msgs[i]):
            if isinstance(msg, Exception):
                continue
            vdaf.prep_next(lead[b][0], msg)
            vdaf.prep_next(help_[b][0], msg)
            accepted[b] = True
        check_decisions(accepted, bad)
        out_len = vdaf.flp.OUTPUT_LEN
        if any(len(st.out_share) != out_len for side in (lead, help_) for st, _ in side):
            raise AssertionError(f"canonical {name}: an out share of task {i} is not {out_len} long")
        aggs = []
        for side in (lead, help_):
            limbs = f.to_limbs([x for st, _ in side for x in st.out_share]).reshape(len(side), out_len, f.n)
            aggs.append(backend.aggregate_batch(limbs, accepted))
        if vdaf.unshard(aggs, int(accepted.sum())) != t["expect"](accepted):
            raise AssertionError(f"canonical {name}: task {i}'s aggregate differs from the exact one")
        for b in rng.choice(np.flatnonzero(~bad), SAMPLED, replace=False):
            for agg_id in (0, 1):
                compare_row(vdaf, b, agg_id, preps[agg_id][i][b], t["oracle"](b, agg_id))
        record["tasks"].append({"meas_len": vdaf.flp.MEAS_LEN, "output_len": out_len, "rows": len(lead),
                                "accepted": int(accepted.sum()), "rejected": int((~accepted).sum())})
    record["checks_s"] = time.perf_counter() - t0
    recomputed = backend.oracle_recompute_rows
    task_oracle_rows = sum(o.rows["init"] for o in backend._oracles.values())
    if any(backend.oracle.rows.values()) or task_oracle_rows != recomputed:
        raise AssertionError(f"canonical {name}: the twin's oracle rows {backend.oracle.rows}, the tasks' "
                             f"{task_oracle_rows} for {recomputed} not-ok rows")
    if backend.leader_marshal_rows != {"bytes": batch, "values": 0}:
        raise AssertionError(f"canonical {name}: leader rows marshalled {backend.leader_marshal_rows}")
    record.update(oracle_recompute_rows=recomputed, host_seconds=dict(backend.host_seconds),
                  outshare_readback_rows=backend.outshare_readback_rows)
    staged = backend.stage_prep_init_multi(1, [(verify_key, t["helper"], t["vdaf"]) for t in tasks])
    log(f"canonical {name}: {len(tasks)} tasks of MEAS_LEN {[t['vdaf'].flp.MEAS_LEN for t in tasks]} on one twin "
        f"(MEAS_LEN {twin.flp.MEAS_LEN}), one flush a side of B = {batch} on {route}; aggregates exact; "
        f"{sum(int(t['bad'].sum()) for t in tasks)} tampered rows rejected; {SAMPLED} sampled rows a task equal its "
        f"oracle; {recomputed} not-ok rows recomputed by the tasks' oracles; job {e2e:.3f} s")
    return record, backend, staged


def canonical_phase(verify_key, rng, hist, h1000_shards, fp_done, fp1003_done, phases):
    """Phase 19: canonical buckets on the card.  Histogram(1024, 316) and
    Histogram(1000, 316) through one twin at B = 4096 a side; the K2 select
    kernel against its plain version at that flush's joint-rand-part
    absorb; FixedPoint(BitSize16, 1000) and (1003) through one twin at B =
    1024 a side.  Returns (record, the K2 select kernel's entry)."""
    from janus_tpu_torch.ops import keccak_kernels
    from janus_tpu_torch.ops.field import storage
    from janus_tpu_torch.vdaf.instances import prio3_histogram, vdaf_from_instance

    t_phase = time.perf_counter()
    record = {}
    reports, meas = hist
    sources = {CANON_HIST_LENGTHS[0]: (reports, meas),
               CANON_HIST_LENGTHS[1]: ([r for _m, r in h1000_shards], [m for m, _r in h1000_shards])}
    tasks = []
    for length in CANON_HIST_LENGTHS:
        vdaf = prio3_histogram(length, CHUNK)
        reps, ms = sources[length]
        lead, help_, bad, src = build_batch(vdaf, reps, rng, CANON_HIST_ROWS + CANON_HIST_TAMPERED, CANON_HIST_TAMPERED)
        lead = decoded_leader_rows(vdaf, lead)

        def oracle(b, agg_id, vdaf=vdaf, rows=(lead, help_)):
            nonce, public, share = rows[agg_id][b]
            state, pshare = vdaf.prep_init(verify_key, agg_id, nonce, public, share)
            return pshare.encode(vdaf), state.out_share, state.corrected_joint_rand_seed

        tasks.append({"vdaf": vdaf, "leader": lead, "helper": help_, "bad": bad, "oracle": oracle,
                      "expect": lambda acc, ms=ms, src=src, n=length: np.bincount(
                          np.array(ms)[src[acc]], minlength=n).tolist()})
    torch.cuda.reset_peak_memory_stats()
    record["histogram"], backend, staged = canonical_bucket("histogram", tasks, verify_key, rng)
    record["histogram"]["device_peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    phases["canonical_histogram"] = time.perf_counter() - t_phase

    # K2's select variant at the flush's shape: the helper's joint-rand-part
    # absorb over both tasks' rows, each padded at its own length.
    t0 = time.perf_counter()
    bp, kw = backend.bp, staged.placed
    B = staged.pad_to
    ml = kw["meas_len"].long()
    meas_rows = storage(bp.helper_shares(1, kw["share_seeds_u8"])[0].reshape(B, -1))
    jmsg = bp._jr_part_message(1, kw["blinds_u8"], kw["nonces_u8"], keccak_kernels.rows_to_planes(meas_rows), ml)
    last = ((bp._jr_part_head_len(kw["blinds_u8"], kw["nonces_u8"]) + 4 * bp.f.n * ml) // 168).to(torch.int32)
    na = jmsg.shape[0] // 42
    got = keccak_kernels.absorb_select(jmsg, last, 4)
    want = keccak_kernels.absorb_select_plain(jmsg, last, 4)
    entry = {
        "name": "keccak_absorb_select", "route": "cuda", "source": "janus_tpu_torch/csrc/keccak.cu",
        "replaces": "janus_tpu/ops/keccak_pallas.py:166",
        "variant_of": "keccak_absorb, for janus_tpu/ops/keccak_jax.py:202 (turboshake128_batch_select)",
        "launches": PATH_LAUNCHES["canonical histogram"]["keccak_absorb_select"],
        "max_abs_err": max_abs_err(got, want),
        # the wrapper's time holds its final-block check (one read back);
        # the profiler's is the kernel's own
        "ms": cuda_time_ms(lambda: keccak_kernels.absorb_select(jmsg, last, 4), 20),
        "kernel_ms": profiled_kernel_ms(lambda: keccak_kernels.absorb_select(jmsg, last, 4), "absorb_select_kernel"),
        "plain_ms": cuda_time_ms(lambda: keccak_kernels.absorb_select_plain(jmsg, last, 4), 1),
        **keccak_select_bound(last, 4), "library_ms": None, "tolerance": TOLERANCE,
        "shape": f"in ({jmsg.shape[0]}, {B}) -> out (4, {B}), {na} blocks run, final blocks "
                 f"{sorted(set((last + 1).tolist()))}",
    }
    entry["share_of_bound"] = entry["bound_ms"] / entry["ms"]
    del got, want, jmsg, meas_rows, staged, backend, bp
    log(f"canonical K2 select: {json.dumps(entry)}")
    phases["canonical_select_check"] = time.perf_counter() - t0
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    tasks = []
    for length, done in zip(CANON_FP_LENGTHS, (fp_done, fp1003_done)):
        vdaf = vdaf_from_instance(dict(FP_DESC, length=length))
        lead, help_, bad, src, ms, oracle = fixedpoint_rows(vdaf, done, rng, CANON_FP_ROWS, CANON_FP_LIES)
        tasks.append({
            "vdaf": vdaf, "leader": lead, "helper": help_, "bad": bad,
            "oracle": lambda b, agg_id, oracle=oracle, src=src: oracle[src[b]][agg_id],
            "expect": lambda acc, ms=ms, src=src, n=length: [sum(ms[i][j] for i in src[acc]) for j in range(n)],
        })
    torch.cuda.reset_peak_memory_stats()
    record["fixedpoint"], _backend, _staged = canonical_bucket("fixedpoint", tasks, verify_key, rng)
    record["fixedpoint"]["device_peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    record["fixedpoint"]["shard_s"] = [s for _d, _l, s in fp1003_done]
    phases["canonical_fixedpoint"] = time.perf_counter() - t0
    phases["canonical"] = time.perf_counter() - t_phase
    return record, entry


#: ``--canonical-ab``: the variants of one task's executor job, in turns.
AB_ORDER = ("exact", "twin", "selected", "selected", "twin", "exact")


def ab_backends(variant, vdaf):
    """Both sides' backends of one ``--canonical-ab`` variant: the task's own
    ``CudaBackend`` (``exact``), or its bucket's twin that runs every flush
    on the masked row path (``twin``) or a flush of one shape on that
    shape's own prepare (``selected``, the default).  The selected twin's
    prepare of the task's shape is built here, before the clock starts, as
    the exact backend's is.  Returns (backends, seconds that build took)."""
    from janus_tpu_torch.vdaf.backend import CudaBackend
    from janus_tpu_torch.vdaf.canonical import canonical_vdaf_for

    if variant == "exact":
        return {a: CudaBackend(vdaf, device=DEVICE) for a in (0, 1)}, 0.0
    twin = canonical_vdaf_for(vdaf)
    backends = {a: CudaBackend(twin, device=DEVICE, canonical=True) for a in (0, 1)}
    t0 = time.perf_counter()
    for b in backends.values():
        b.one_shape_exact = variant == "selected"
        if b.one_shape_exact:
            b._bp_for(vdaf)
    return backends, time.perf_counter() - t0


def ab_case(name, vdaf, verify_key, batch, expect, needs):
    """One task's executor job (``executor_job``: both sides, EXECUTOR_JOBS
    jobs a side in one flush, out shares resident, commit and drain) for
    each variant of AB_ORDER, each warmed at the flush's size.  Raises
    unless every aggregate is ``expect`` of the accepted rows, the tampered
    rows are rejected, ``needs[variant]`` launched, the twin launched no FLP
    kernel and the others not K2's select variant.  Returns the records."""
    from janus_tpu_torch.executor import AccumulatorConfig, DeviceExecutor, ExecutorConfig

    leader_rows, helper_rows, tampered, src = batch
    B = len(leader_rows)
    records = []
    for variant in AB_ORDER:
        backends, bp_s = ab_backends(variant, vdaf)
        ex = DeviceExecutor(ExecutorConfig(flush_max_rows=B, accumulator=AccumulatorConfig(enabled=True)))
        t0 = time.perf_counter()
        for a, b in backends.items():
            ex.warmup_backend(b, agg_ids=(a,), pad_to=B)
            b.outshare_readback_rows = 0
        warm_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        (aggs, accepted, _results, record), launches = counted(
            f"canonical ab {name} {variant}", needs[variant],
            lambda: executor_job(vdaf, ex, backends, verify_key, leader_rows, helper_rows, EXECUTOR_JOBS))
        if vdaf.unshard(aggs, int(accepted.sum())) != expect(src[accepted]):
            raise AssertionError(f"canonical ab {name} {variant}: the drained aggregate is not the exact one")
        check_decisions(accepted, tampered)
        if variant == "twin":
            no_flp_kernels(f"canonical ab {name} {variant}", launches)
        elif launches["keccak_absorb_select"]:
            raise AssertionError(f"canonical ab {name} {variant}: K2's select variant launched: {launches}")
        records.append({"variant": variant, "seconds": record["seconds"], "phases_s": record["phases_s"],
                        "stage_launch_s": record["stage_launch_s"], "warmup_s": warm_s, "task_prepare_build_s": bp_s,
                        "launches": launches, "device_peak_memory_bytes": torch.cuda.max_memory_allocated()})
        log(f"canonical ab {name} {variant}: job {record['seconds']:.3f} s, {json.dumps(record['phases_s'])}")
        del backends, ex, aggs, _results
        torch.cuda.empty_cache()
    return records


def canonical_ab(seed: int) -> dict:
    """``--canonical-ab``: Histogram(1024, 316) at B = 4096 (phase 1's 64
    reports tiled to 4032 rows plus 64 tampered) and SumVec100k at B = 1024
    (2 reports from worker processes tiled to 960 rows plus 64 tampered)
    through ``ab_case``.  Returns the records by task."""
    from janus_tpu_torch import _build
    from janus_tpu_torch.vdaf.instances import prio3_histogram, prio3_sum_vec

    rng = np.random.default_rng(seed)
    verify_key = rng.integers(0, 256, 16, dtype=np.uint8).tobytes()
    with ProcessPoolExecutor(max_workers=SV_DISTINCT, mp_context=multiprocessing.get_context("spawn")) as pool:
        jobs = [pool.submit(sumvec_oracle_job, seed, i, verify_key) for i in range(SV_DISTINCT)]
        _build.build()
        hist = prio3_histogram(LENGTH, CHUNK)
        reports, meas = shard_reports(hist, rng, lambda r: int(r.integers(0, LENGTH)))
        done = [j.result() for j in jobs]
    out = {}
    lead, help_, bad, src = build_batch(hist, reports, rng, BATCH, TAMPERED)
    planar = {v: KERNEL_NAMES[:3] for v in ("exact", "selected")}
    out["histogram"] = ab_case(
        "histogram", hist, verify_key, (decoded_leader_rows(hist, lead), help_, bad, src),
        lambda rows: np.bincount(np.array(meas)[rows], minlength=LENGTH).tolist(), dict(planar, twin=CANONICAL_KERNELS))
    sv = prio3_sum_vec(SV_LENGTH, 1, SV_CHUNK)
    sv_meas = [d[0] for d in done]
    lead, help_, bad, src = build_batch(sv, [d[1] for d in done], rng, SV_BATCH * SV_TILE, SV_TAMPERED * SV_TILE)
    planar = {v: ("keccak_squeeze", "keccak_absorb", "flp_sumvec_wires") for v in ("exact", "selected")}
    out["sumvec"] = ab_case(
        "sumvec", sv, verify_key, (decoded_leader_rows(sv, lead), help_, bad, src),
        lambda rows: np.sum([sv_meas[i] for i in rows], axis=0).tolist(), dict(planar, twin=CANONICAL_KERNELS))
    return out


def reduce_bound(P: torch.Tensor, n: int) -> dict:
    """The bound of one digit-reduce call on partial sums P (..., M, D, N,
    D): each float64 sum read once and the (..., M, N, n) u32 limbs written
    once; a sum's conversion, its two halves (a mask and a shift) and their
    two column adds; the carry pass's 9 instructions a limb of U (2n + 1
    limbs); the two Montgomery products and four modular adds of the fold.
    The products and adds are Field128's counts (MONT_MUL, FIELD_ADD)."""
    D = 4 * n
    outputs = P.numel() // (D * D)
    sums = P.numel()
    count = ops((sums, (0, 4)), (outputs * (2 * n + 1), (0, 9)), (2 * outputs, MONT_MUL), (4 * outputs, FIELD_ADD))
    return bound(sums * 8 + outputs * n * 4, count, conversions=sums)


def reduce_check(f, a, b) -> dict:
    """The digit reduce at one contraction's operands a (R, K, M, n), b (K,
    N, n) or (R, K, N, n) as the path gave them (one batch slice): against
    its plain version on the digit product of a and b and on that of
    carry-saturating operands of the same shapes (every element p - 1); the
    matmul's and the kernel's ms (CUDA events), the plain version's, the
    bound."""
    from janus_tpu_torch.ops import field_kernels

    D = 4 * f.n
    R, M, N = a.shape[0], a.shape[2], b.shape[-2]
    lhs, rhs = f.digit_operands(a, b)
    P = torch.matmul(lhs, rhs).reshape(R, M, D, N, D)
    err = max_abs_err(field_kernels.lazy_reduce_digits(f, P), field_kernels.lazy_reduce_digits_plain(f, P))
    top = torch.from_numpy(f._int_to_limbs_np(f.p - 1).astype(np.int64)).to(a.device)
    sl, sr = f.digit_operands(top.expand_as(a).contiguous(), top.expand_as(b).contiguous())
    Ps = torch.matmul(sl, sr).reshape(R, M, D, N, D)
    err_sat = max_abs_err(field_kernels.lazy_reduce_digits(f, Ps), field_kernels.lazy_reduce_digits_plain(f, Ps))
    del sl, sr, Ps
    rec = {
        "max_abs_err": max(err, err_sat), "max_abs_err_random": err, "max_abs_err_saturated": err_sat,
        "ms": cuda_time_ms(lambda: field_kernels.lazy_reduce_digits(f, P), 5),
        "plain_ms": cuda_time_ms(lambda: field_kernels.lazy_reduce_digits_plain(f, P), 1, rounds=1),
        "matmul_ms": cuda_time_ms(lambda: torch.matmul(lhs, rhs), 5),
        "digit_operands_ms": cuda_time_ms(lambda: f.digit_operands(a, b), 5),
        **reduce_bound(P, f.n), "library_ms": None, "tolerance": TOLERANCE,
        "shape": f"a {tuple(a.shape)} x b {tuple(b.shape)} -> partial sums {tuple(P.shape)} float64",
    }
    rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
    return rec


def mxu_case(name, vdaf, verify_key, batch, expect, oracle_check, rng, profile=False) -> dict:
    """One shape under ``field_backend="mxu"`` (phase 20): the served path
    through ``CudaBackend(field_backend="mxu")``, both sides, combined and
    aggregated, with K1, K2 and the digit reduce launched and K3-K5 and K2's
    select variant not; the aggregate is ``expect(valid rows)``, every
    tampered row is rejected and ``oracle_check(results)`` holds rows
    against the oracle.  On the staged rows both sides' prepare and the
    combine equal the vpu route's (the chooser's: planar where eligible)
    output for output; both routes' device ms a side, the mxu peak memory
    and, with ``profile``, a profiled mxu helper prepare (device activities,
    idle share; the vpu route's are phases 2 and 14's); the digit reduce at the path's largest contraction
    (``reduce_check``).  Returns the record."""
    from janus_tpu_torch.vdaf.backend import CudaBackend

    leader_rows, helper_rows, bad, src = batch
    B = len(leader_rows)
    vpu = CudaBackend(vdaf, device=DEVICE)
    mxu = CudaBackend(vdaf, device=DEVICE, field_backend="mxu")
    require_route(mxu, B, "prep_init")
    vpu_route = vpu._prep_fn(0, vpu._pad_to(B)).__name__
    t0 = time.perf_counter()
    (aggs, accepted, results, _msgs, secs), launches = counted(
        f"mxu {name} served path", MXU_NEEDS, lambda: run_main_path(vdaf, mxu, verify_key, leader_rows, helper_rows)
    )
    e2e = time.perf_counter() - t0
    no_flp_kernels(f"mxu {name}", launches)
    if launches["keccak_absorb_select"]:
        raise AssertionError(f"mxu {name}: launched K2's select variant: {launches}")
    if vdaf.unshard(aggs, int(accepted.sum())) != expect(src[~bad]):
        raise AssertionError(f"mxu {name}: aggregate differs from the exact aggregate of the valid rows")
    check_decisions(accepted, bad)
    oracle_check(results)

    # the same staged rows through both routes on the card
    staged = {a: mxu.stage_prep_init_multi(a, [(verify_key, rows)]).placed for a, rows in ((0, leader_rows), (1, helper_rows))}
    f = mxu.bp.f
    largest = {"size": 0}
    real = f.digit_operands

    def spy(a, b):
        size = a.shape[0] * a.shape[2] * b.shape[-2]
        if size > largest["size"]:
            largest.update(size=size, a=a, b=b)
        return real(a, b)

    f.digit_operands = spy
    torch.cuda.reset_peak_memory_stats()
    try:
        got = {a: device_prep(mxu.bp, staged[a], a, "prep_init") for a in (0, 1)}
    finally:
        del f.digit_operands
    peak = torch.cuda.max_memory_allocated()
    want = {a: device_prep(vpu.bp, staged[a], a, vpu_route) for a in (0, 1)}
    for a in (0, 1):
        equal_outputs(f"mxu {name}, agg {a}, against {vpu_route}", got[a], want[a])
    parts = [got[a]["joint_rand_part"] for a in (0, 1)]
    msg = {route: bp.prep_shares_to_prep([o[a]["verifiers"] for a in (0, 1)], parts)
           for route, bp, o in (("mxu", mxu.bp, got), ("vpu", vpu.bp, want))}
    equal_outputs(f"mxu {name} combine", msg["mxu"], msg["vpu"])
    if not np.array_equal(msg["mxu"]["decide"][:B].cpu().numpy(), accepted):
        raise AssertionError(f"mxu {name}: the device combine decides otherwise than the served path")
    del got, want, msg
    reps = 1 if B * vdaf.flp.MEAS_LEN > 1 << 23 else 3
    dev_ms = {route: {side: cuda_time_ms(lambda a=a, bp=bp, r=r: device_prep(bp, staged[a], a, r), 1, rounds=reps)
                      for side, a in (("leader", 0), ("helper", 1))}
              for route, bp, r in (("mxu", mxu.bp, "prep_init"), ("vpu " + vpu_route, vpu.bp, vpu_route))}
    profile = profile_device(lambda: device_prep(mxu.bp, staged[1], 1, "prep_init")) if profile else None
    reduce = reduce_check(f, largest["a"], largest["b"])
    reduce["launches"] = launches["field_lazy_reduce"]
    del largest, staged
    log(f"mxu {name}: {B} reports through prep_init; exact aggregate over {int(accepted.sum())} rows; "
        f"{int(bad.sum())} tampered rows rejected; both sides' prepare and the combine equal {vpu_route}'s on the "
        f"card; device ms {json.dumps(dev_ms)}; "
        + (f"a profiled mxu helper prepare {json.dumps(profile)}; " if profile else "")
        + f"peak memory {peak} bytes; reduce at {reduce['shape']}: "
        f"{reduce['ms']:.5f} ms (bound {reduce['bound_ms']:.5f}, {reduce['bound_kind']}; plain "
        f"{reduce['plain_ms']:.3f}), matmul {reduce['matmul_ms']:.5f} ms, {reduce['launches']} launches a job; "
        f"served {e2e:.3f} s")
    return {"reports": B, "route": "prep_init", "vpu_route": vpu_route, "seconds": e2e, "phases_s": secs,
            "launches": launches, "device_prep_init_ms": dev_ms, "device_prep_init_profile": profile,
            "device_peak_memory_bytes": peak, "reduce": reduce}


def mxu_phase(verify_key, rng, hist, hist_meas, sv_served, fp_done, hist_shards, phases):
    """Phase 20: the limb-digit matmul layout on the card at the published
    widths (``mxu_case`` a shape), then the pair with ``Config`` and
    ``DriverConfig(field_backend="mxu")`` for Histogram(1024, 316) and
    FixedPoint(BitSize16, 1000).  Returns (the reduce kernel's entry, its
    entries at the other shapes, the record)."""
    from janus_tpu_torch.vdaf.instances import prio3_histogram, prio3_sum, prio3_sum_vec, vdaf_from_instance

    t_phase = time.perf_counter()
    out = {}

    def sampled(vdaf, rows):
        def check(results):
            oracle_sample(vdaf, verify_key, rows[0], rows[1], results, rng, MXU_SAMPLED)
        return check

    hv = prio3_histogram(LENGTH, CHUNK)
    out["histogram"] = mxu_case("histogram", hv, verify_key, hist,
                                lambda valid: np.bincount(np.array(hist_meas)[valid], minlength=LENGTH).tolist(),
                                sampled(hv, hist), rng, profile=True)
    torch.cuda.empty_cache()
    sv = prio3_sum(SUM_BITS)
    reports, meas = shard_reports(sv, rng, lambda r: int(r.integers(0, 1 << SUM_BITS)), MXU_SUM_DISTINCT)
    batch = build_batch(sv, reports, rng, SUM_SMALL_FLUSH, MXU_SUM_TAMPERED)
    out["sum"] = mxu_case("sum", sv, verify_key, batch, lambda valid: sum(meas[i] for i in valid), sampled(sv, batch),
                          rng)
    torch.cuda.empty_cache()
    svv = prio3_sum_vec(SV_LENGTH, 1, SV_CHUNK)
    sv_batch, sv_aggs, sv_oracle = sv_served

    def sv_oracle_check(results):
        _lead, _help, bad, src = sv_batch
        for i in range(len(sv_oracle)):
            b = int(np.flatnonzero((src == i) & ~bad)[0])
            for agg_id in (0, 1):
                compare_row(svv, b, agg_id, results[agg_id][b], sv_oracle[i][agg_id])

    sv_expect = svv.unshard(sv_aggs, int((~sv_batch[2]).sum()))
    out["sumvec"] = mxu_case("sumvec", svv, verify_key, sv_batch, lambda valid: sv_expect, sv_oracle_check, rng)
    torch.cuda.empty_cache()
    fv = vdaf_from_instance(FP_DESC)
    lead, help_, bad, src, fp_meas, fp_oracle = fixedpoint_rows(fv, fp_done, rng, FP_BATCH - FP_LIE_ROWS, FP_LIE_ROWS)

    def fp_oracle_check(results):
        for b in rng.choice(np.flatnonzero(~bad), MXU_SAMPLED, replace=False):
            for agg_id in (0, 1):
                compare_row(fv, b, agg_id, results[agg_id][b], fp_oracle[src[b]][agg_id])

    out["fixedpoint"] = mxu_case(
        "fixedpoint", fv, verify_key, (lead, help_, bad, src),
        lambda valid: [sum(fp_meas[i][j] for i in valid) for j in range(FP_DESC["length"])], fp_oracle_check, rng,
        profile=True)
    torch.cuda.empty_cache()

    # end to end: the pair under Config/DriverConfig(field_backend="mxu")
    def tampered_flags(n, k):
        flags = np.zeros(n, dtype=bool)
        flags[rng.choice(n, k, replace=False)] = True
        return flags.tolist()

    pair = {}
    pair["histogram"] = pair_run(
        "histogram mxu", {"type": "Prio3Histogram", "length": LENGTH, "chunk_length": CHUNK}, hist_shards,
        tampered_flags(len(hist_shards), PAIR_TAMPERED), lambda valid: np.bincount(valid, minlength=LENGTH).tolist(),
        verify_key, MXU_NEEDS, field_backend="mxu")
    torch.cuda.empty_cache()
    fp_shards = [(m, r) for done, _lie, _s in fp_done for m, r, _o in done]
    fp_lies = [(None, lie) for _d, lie, _s in fp_done][:PAIR_FP_LIES]
    pair["fixedpoint"] = pair_run(
        "fixedpoint mxu", FP_DESC, fp_shards + fp_lies, [False] * len(fp_shards) + [True] * len(fp_lies),
        lambda valid: [sum(m[j] for m in valid) for j in range(FP_DESC["length"])], verify_key, MXU_NEEDS,
        field_backend="mxu")
    for name, rec in pair.items():
        no_flp_kernels(f"pair {name} mxu", rec["launches"])
    out["pair"] = {k: {key: rec[key] for key in ("seconds", "reports_per_s", "launches", "prep_init_flushes",
                                                 "device_peak_memory_bytes", "field_backend")}
                   for k, rec in pair.items()}
    torch.cuda.empty_cache()
    phases["mxu"] = time.perf_counter() - t_phase

    head = out["histogram"]["reduce"]
    entry = {
        "name": "field_lazy_reduce", "route": "cuda", "source": "janus_tpu_torch/csrc/field_dot.cu",
        "replaces": "janus_tpu/ops/field_jax.py:736 (JField._lazy_reduce_digits, XLA-fused; no Pallas kernel)",
        "launches": out["histogram"]["launches"]["field_lazy_reduce"],
        **{k: head[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "bound_kind", "library_ms",
                                "tolerance", "shape", "matmul_ms", "max_abs_err_saturated", "share_of_bound")},
    }
    shapes = {f"mxu_{k}": {"field_lazy_reduce": out[k]["reduce"]} for k in ("sum", "sumvec", "fixedpoint")}
    return entry, shapes, out

def mesh_layouts():
    """(name, devices) of each mesh phase 21 runs: every visible card, then
    MESH_LOGICAL shards on the first card."""
    from janus_tpu_torch.vdaf.backend import local_mesh

    cards = local_mesh(DEVICE)
    return [(f"cards{len(cards)}", cards)] + [(f"logical{n}", [cards[0]] * n) for n in MESH_LOGICAL]


def one_card_base(one, verify_key, sides, reps=MESH_REPS) -> dict:
    """Each side's prepare on one card (``one``), out shares kept on the
    card: by side, (host outputs, out-share matrix, device prepare ms, the
    drained sum of every row)."""
    base = {}
    for side, (agg_id, rows) in sides.items():
        staged = one.stage_prep_init_multi(agg_id, [(verify_key, rows)])
        want, matrix = one._prepare(staged, True)
        ms = cuda_time_ms(lambda: one._prepare(staged, True), reps)
        mask = np.zeros(staged.pad_to, dtype=bool)
        mask[: len(rows)] = True
        base[side] = (want, matrix, ms, one.read_accum_buffer(one.accumulate_rows(None, matrix, mask)))
    return base


def mesh_staged(name, base, mesh, verify_key, sides, reps=MESH_REPS) -> dict:
    """Both sides' prepare of the same rows on ``mesh``, out shares kept on
    the cards, against one card's (``base``, from ``one_card_base``): the
    mesh's host outputs equal the card's array for array and its out-share
    pieces, joined, equal the card's matrix; its device prepare ms (CUDA
    events around calls that end only when every shard has synchronised:
    one call, then 3 rounds of ``reps``); then the drain: the mesh's
    per-shard sums of every row read back as one vector
    (``read_accum_buffer``, timed) equal the card's.  Returns the record."""
    rec = {"devices": list(mesh.mesh_devices), "shards": len(mesh.devices), "prep_ms": {}, "drain_ms": {}}
    for side, (agg_id, rows) in sides.items():
        s_mesh = mesh.stage_prep_init_multi(agg_id, [(verify_key, rows)])
        want, matrix, one_ms, drained = base[side]
        got, pieces = mesh._prepare(s_mesh, True)
        for k in want:
            if not np.array_equal(got[k], want[k]):
                raise AssertionError(f"mesh {name}: the {side}'s {k} differs from one card's")
        joined = torch.cat([p.to(matrix.device) for p in pieces.pieces])
        if not torch.equal(joined[: len(rows)], matrix[: len(rows)]):
            raise AssertionError(f"mesh {name}: the {side}'s out shares differ from one card's")
        mask = np.zeros(s_mesh.pad_to, dtype=bool)
        mask[: len(rows)] = True
        buffer = mesh.accumulate_rows(None, pieces, mask)
        if mesh.read_accum_buffer(buffer) != drained:
            raise AssertionError(f"mesh {name}: the {side}'s drained sum differs from one card's")
        rec["prep_ms"][side] = {"mesh": cuda_time_ms(lambda: mesh._prepare(s_mesh, True), reps), "one_card": one_ms}
        rec["drain_ms"][side] = cuda_time_ms(lambda: mesh.read_accum_buffer(buffer), reps)
        del got, pieces, joined, buffer
    rec["route"] = mesh._prep_fn(1, mesh._pad_to(len(rows))).__name__
    return rec


def mesh_phase(vdaf, verify_key, batch, meas, sv_served, hist_shards, rng, phases):
    """Phase 21: the prepare across cards.  Histogram(1024, 316) at phase
    2's B = 4096 rows on a MeshBackend over every visible card and over
    MESH_LOGICAL logical shards of the first card: held against one
    CudaBackend on the same staged rows (``mesh_staged``), then one
    executor job of both sides (one flush a side, out shares resident, the
    accumulator's drain) with an exact aggregate, the tampered rows
    rejected, no out-share row read back, and each kernel launched
    shards x phase 11's launches (every shard launches what a one-card
    flush of its size launches, on the same route).  SumVec100k at B = 1024
    on a MESH_SV_SHARDS-shard mesh (K5 on every shard) against one card.
    Phase 13's Histogram pair task (``hist_shards``) under ``vdaf_backend="mesh"`` and under
    ``ExecutorConfig(mesh=True)``, exact.  ``dryrun_multichip`` over the
    visible cards and over 4 logical shards.  Returns the record."""
    from janus_tpu_torch.dryrun import dryrun_multichip
    from janus_tpu_torch.vdaf.backend import CudaBackend, MeshBackend
    from janus_tpu_torch.vdaf.instances import prio3_sum_vec

    t_phase = time.perf_counter()
    leader_rows, helper_rows, tampered, src = batch
    leader_rows = decoded_leader_rows(vdaf, leader_rows)
    B = len(leader_rows)
    want = np.bincount(np.array(meas)[src[~tampered]], minlength=LENGTH).tolist()
    one_card = PATH_LAUNCHES["histogram executor path"]
    sides = {"leader": (0, leader_rows), "helper": (1, helper_rows)}
    base = one_card_base(CudaBackend(vdaf, device=DEVICE), verify_key, sides)
    out = {"histogram": {}}
    for name, devices in mesh_layouts():
        t0 = time.perf_counter()
        rec = mesh_staged(name, base, MeshBackend(vdaf, devices=devices), verify_key, sides)
        ex, backends, warm_s = executor_for(vdaf, B, warmup=True, make=lambda: MeshBackend(vdaf, devices=devices))
        (aggs, accepted, _results, job), launches = counted(
            f"mesh {name} executor path", KERNEL_NAMES[:3],
            lambda: executor_job(vdaf, ex, backends, verify_key, leader_rows, helper_rows, EXECUTOR_JOBS),
        )
        if vdaf.unshard(aggs, int(accepted.sum())) != want:
            raise AssertionError(f"mesh {name}: the drained aggregate differs from the expected histogram")
        check_decisions(accepted, tampered)
        shards = len(devices)
        wrong = {k: (v, shards * one_card[k]) for k, v in launches.items() if v != shards * one_card[k]}
        if wrong:
            raise AssertionError(f"mesh {name}: launches (got, {shards} x one card's) differ: {wrong}")
        rec.update(job=job, warmup_s=warm_s, launches=launches, seconds=time.perf_counter() - t0)
        out["histogram"][name] = rec
        log(f"mesh {name} ({shards} shards on {sorted(set(rec['devices']))}): outputs equal one card's; job "
            f"{job['seconds']:.3f} s, aggregate exact, no out-share readback; route {rec['route']}; device prepare ms "
            f"{json.dumps(rec['prep_ms'])}; drain readback ms {json.dumps(rec['drain_ms'])}")
        del ex, backends
        torch.cuda.empty_cache()
    del base
    phases["mesh_histogram"] = time.perf_counter() - t_phase

    t0 = time.perf_counter()
    sv_vdaf = prio3_sum_vec(SV_LENGTH, 1, SV_CHUNK)
    (sv_lead, sv_help, _t, _s), _aggs, _oracle = sv_served
    sv_sides = {"leader": (0, decoded_leader_rows(sv_vdaf, sv_lead) * SV_TILE), "helper": (1, sv_help * SV_TILE)}
    cards = mesh_layouts()[0][1]
    sv_devices = cards[:MESH_SV_SHARDS] if len(cards) >= MESH_SV_SHARDS else [cards[0]] * MESH_SV_SHARDS
    sv_mesh = MeshBackend(sv_vdaf, devices=sv_devices)
    sv_base = one_card_base(CudaBackend(sv_vdaf, device=DEVICE), verify_key, sv_sides)
    rec, launches = counted("mesh sumvec staged path", ("keccak_squeeze", "keccak_absorb", "flp_sumvec_wires"),
                            lambda: mesh_staged("sumvec", sv_base, sv_mesh, verify_key, sv_sides))
    if rec["route"] != "prep_init_planar":
        raise AssertionError(f"mesh sumvec: a shard of {SV_BATCH * SV_TILE // MESH_SV_SHARDS} rows took {rec['route']}")
    # every mesh prepare of the window (a compared call, a warm-up call and
    # 3 timed rounds a side) launched K5 once on each shard
    k5 = MESH_SV_SHARDS * 2 * (2 + 3 * MESH_REPS)
    if launches["flp_sumvec_wires"] != k5:
        raise AssertionError(f"mesh sumvec: K5 launched {launches['flp_sumvec_wires']} times, not {k5}")
    rec["launches"] = launches
    out["sumvec"] = rec
    log(f"mesh sumvec ({MESH_SV_SHARDS} shards on {sorted(set(rec['devices']))}, B = {SV_BATCH * SV_TILE}): outputs "
        f"equal one card's; device prepare ms {json.dumps(rec['prep_ms'])}")
    del sv_sides, sv_mesh, sv_base
    torch.cuda.empty_cache()
    phases["mesh_sumvec"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    flags = np.zeros(len(hist_shards), dtype=bool)
    flags[rng.choice(len(hist_shards), PAIR_TAMPERED, replace=False)] = True
    desc = {"type": "Prio3Histogram", "length": LENGTH, "chunk_length": CHUNK}
    expect = lambda valid: np.bincount(valid, minlength=LENGTH).tolist()  # noqa: E731
    out["pair"] = {
        "vdaf_backend_mesh": pair_run("histogram mesh backend", desc, hist_shards, flags.tolist(), expect, verify_key,
                                      KERNEL_NAMES[:3], vdaf_backend="mesh"),
        "executor_mesh": pair_run("histogram executor mesh", desc, hist_shards, flags.tolist(), expect, verify_key,
                                  KERNEL_NAMES[:3], mesh=True),
    }
    phases["mesh_pair"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    out["dryrun"] = {}
    for name, kw in ((f"cards{len(cards)}", {"n_devices": len(cards)}),
                     ("logical4", {"n_devices": 4, "device": str(cards[0])})):
        total, launches = counted(f"mesh dryrun {name}", ("keccak_squeeze",), lambda kw=kw: dryrun_multichip(**kw))
        out["dryrun"][name] = {"count": total, "launches": launches}
    phases["mesh_dryrun"] = time.perf_counter() - t0
    phases["mesh"] = time.perf_counter() - t_phase
    out["seconds"] = phases["mesh"]
    return out


def nvidia_smi(query: str) -> str:
    """The first card's line of ``nvidia-smi --query-gpu=<query>``."""
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--canonical-ab", action="store_true",
                    help="time one task's executor job on its own backend and on its bucket's twin, and nothing else")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2

    from janus_tpu_torch import _build, native
    from janus_tpu_torch.vdaf.instances import prio3_histogram, prio3_sum_vec

    # the oracle's XOF (every shard below, the pair's client) must take the
    # C++ sponge wherever the smoke runs: a silent fallback to the pure
    # Python sponge fails the run
    if native.load() is None:
        raise AssertionError("the native host XOF did not load")

    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"largest SM clock {sm_clock_hz() / 1e6:.0f} MHz")
    if args.canonical_ab:
        log(json.dumps({"canonical_ab": canonical_ab(args.seed)}))
        log(nvidia_smi("name,power.limit"))
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
        return 0
    rng = np.random.default_rng(args.seed)
    verify_key = rng.integers(0, 256, 16, dtype=np.uint8).tobytes()
    # the HMAC multiproof's 32-byte key, from its own generator so that the
    # earlier phases draw what they drew before it
    mp_verify_key = np.random.default_rng([args.seed, 32]).integers(0, 256, 32, dtype=np.uint8).tobytes()
    phases = {}
    start = time.perf_counter()

    # The pure-Python oracle takes tens of seconds to shard and prove each
    # SumVec100k report (the multiproof's two proofs, the FixedPoint
    # reports); worker processes do it during the build and the histogram
    # sharding, the longest first, and end before any timed phase starts.
    workers = (MP_DISTINCT + SV_DISTINCT + SV8_WORKERS + PAIR_HIST_WORKERS + FP_WORKERS + POPLAR_WORKERS
               + CANON_HIST_WORKERS + CANON_FP_WORKERS)
    with ProcessPoolExecutor(max_workers=workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        mp_jobs = [pool.submit(multiproof_oracle_job, args.seed, i, mp_verify_key) for i in range(MP_DISTINCT)]
        jobs = [pool.submit(sumvec_oracle_job, args.seed, i, verify_key) for i in range(SV_DISTINCT)]
        fp_jobs = [pool.submit(fixedpoint_shard_job, args.seed, w, FP_DISTINCT // FP_WORKERS, verify_key)
                   for w in range(FP_WORKERS)]
        sv8_jobs = [pool.submit(sumvec_bits_shard_job, args.seed, w, SV8_REPORTS // SV8_WORKERS) for w in range(SV8_WORKERS)]
        extra = (PAIR_HIST_REPORTS - DISTINCT) // PAIR_HIST_WORKERS
        hist_jobs = [pool.submit(histogram_shard_job, args.seed, w, extra) for w in range(PAIR_HIST_WORKERS)]
        poplar_jobs = [pool.submit(poplar_shard_job, args.seed, w, POPLAR_REPORTS // POPLAR_WORKERS)
                       for w in range(POPLAR_WORKERS)]
        # phase 19's second task of each bucket
        h1000_jobs = [pool.submit(histogram_shard_job, args.seed, 10 + w, DISTINCT // CANON_HIST_WORKERS,
                                  CANON_HIST_LENGTHS[1], CHUNK) for w in range(CANON_HIST_WORKERS)]
        fp1003_jobs = [pool.submit(fixedpoint_shard_job, args.seed, 10 + w, CANON_FP_PER_WORKER, verify_key,
                                   CANON_FP_LENGTHS[1]) for w in range(CANON_FP_WORKERS)]
        t0 = time.perf_counter()
        _build.build()
        phases["build"] = time.perf_counter() - t0
        log(f"build: {phases['build']:.2f} s")
        for name in _build.BUILD_LOGS:
            for line in _build.ptxas_report(name):
                log(f"ptxas {name}: {line}")
        hist_vdaf = prio3_histogram(LENGTH, CHUNK)
        t0 = time.perf_counter()
        reports, meas = shard_reports(hist_vdaf, rng, lambda r: int(r.integers(0, LENGTH)))
        phases["histogram_shard"] = time.perf_counter() - t0
        log(f"shard: {DISTINCT} histogram reports in {phases['histogram_shard']:.2f} s (beside the workers)")
        t0 = time.perf_counter()
        done = [j.result() for j in jobs]
        sv8_shards = [x for j in sv8_jobs for x in j.result()]
        hist_shards = list(zip(meas, reports)) + [x for j in hist_jobs for x in j.result()]
        phases["sumvec_shard_wait"] = time.perf_counter() - t0
        fp_done = [j.result() for j in fp_jobs]
        mp_done = [j.result() for j in mp_jobs]
        poplar_shards = [x for j in poplar_jobs for x in j.result()]
        h1000_shards = [x for j in h1000_jobs for x in j.result()]
        fp1003_done = [j.result() for j in fp1003_jobs]
        phases["shard_wait_total"] = time.perf_counter() - t0
    log(f"shard: FixedPoint reports {json.dumps([d[2] for d in fp_done])} s a worker; phases so far "
        f"{json.dumps(phases)}")
    kernels, histogram, hist_batch = histogram_phases(hist_vdaf, reports, meas, verify_key, rng, phases)
    torch.cuda.empty_cache()
    sv_entry, sv_shapes, sumvec, sv_served = sumvec_phases(verify_key, rng, done, phases)
    kernels.append(sv_entry)
    torch.cuda.empty_cache()
    path_shapes = {}
    count, path_shapes["count_flush"] = count_phase(verify_key, rng, phases)
    sum_record, path_shapes["sum_flush"] = sum_phase(verify_key, rng, phases)
    torch.cuda.empty_cache()
    sumvec_bits, path_shapes["sumvec_bits8"] = sumvec_bits_phase(verify_key, rng, sv8_shards, phases)
    torch.cuda.empty_cache()
    histogram_executor = histogram_executor_phase(hist_vdaf, verify_key, hist_batch, meas, rng, phases)
    torch.cuda.empty_cache()
    sumvec_executor = sumvec_executor_phase(prio3_sum_vec(SV_LENGTH, 1, SV_CHUNK), verify_key, *sv_served, phases)
    torch.cuda.empty_cache()
    log(f"phases so far {json.dumps(phases)}; {time.perf_counter() - start:.1f} s since the start")
    fixedpoint, path_shapes["fixedpoint"] = fixedpoint_phase(verify_key, rng, fp_done, phases)
    torch.cuda.empty_cache()
    multiproof = multiproof_phase(mp_verify_key, rng, mp_done, phases)
    torch.cuda.empty_cache()
    pair = pair_phase(verify_key, rng, hist_shards, done, fp_done, mp_done, mp_verify_key, phases)
    torch.cuda.empty_cache()
    poplar1 = poplar_phase(args.seed, verify_key, rng, poplar_shards, phases)
    torch.cuda.empty_cache()
    poplar1_pair = poplar_pair_phase(args.seed, verify_key, poplar_shards, phases)
    torch.cuda.empty_cache()
    binaries = binaries_phase(args.seed, verify_key, hist_shards, phases)
    torch.cuda.empty_cache()
    canonical, select_entry = canonical_phase(verify_key, rng, (reports, meas), h1000_shards, fp_done, fp1003_done,
                                              phases)
    kernels.append(select_entry)
    torch.cuda.empty_cache()
    reduce_entry, mxu_shapes, mxu = mxu_phase(verify_key, rng, hist_batch, meas, sv_served, fp_done,
                                              hist_shards[:PAIR_REPEAT_HIST_REPORTS], phases)
    kernels.append(reduce_entry)
    path_shapes.update(mxu_shapes)
    torch.cuda.empty_cache()
    mesh = mesh_phase(hist_vdaf, verify_key, hist_batch, meas, sv_served, hist_shards[:PAIR_REPEAT_HIST_REPORTS], rng,
                      phases)
    torch.cuda.empty_cache()
    interop = interop_phase(args.seed, phases)
    torch.cuda.empty_cache()
    upload = upload_phase(args.seed, hist_vdaf, reports[0], phases)
    for k in kernels:
        # a process that never loaded a kernel's wrapper (a binary that
        # never ran the mxu layout) launched it no time
        k["launches_by_path"] = {path: launches.get(k["name"], 0) for path, launches in PATH_LAUNCHES.items()}
        for path, shapes in path_shapes.items():
            if k["name"] in shapes:
                k[f"at_{path}"] = shapes[k["name"]]
    if native.fallbacks():
        raise AssertionError(f"{native.fallbacks()} XOF expansions fell back to the pure Python sponge")
    log(f"native host XOF: {native.library_path().name}, 0 fallbacks")
    bad = [k["name"] for k in kernels if k["max_abs_err"] > TOLERANCE]
    bad += [f"{k} at the SumVec shape" for k, v in sv_shapes.items() if v["max_abs_err_host_columns"] > TOLERANCE]
    bad += [f"{k} at {path}" for path, shapes in path_shapes.items() for k, v in shapes.items()
            if v["max_abs_err"] > TOLERANCE]
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: {bad}")
    phases["total"] = time.perf_counter() - start

    log(json.dumps({"phases_s": phases, "profiler_traces": TRACE_TALLY}))
    log(json.dumps({"end_to_end": {"histogram": histogram, "sumvec": sumvec, "count": count, "sum": sum_record,
                                   "sumvec_bits8": sumvec_bits, "histogram_executor": histogram_executor,
                                   "sumvec_executor": sumvec_executor, "fixedpoint": fixedpoint,
                                   "multiproof": multiproof, "pair": pair, "poplar1": poplar1,
                                   "poplar1_pair": poplar1_pair, "binaries": binaries, "canonical": canonical,
                                   "mxu": mxu, "mesh": mesh, "interop": interop, "upload": upload}}))
    log(json.dumps({"sumvec_shape_kernels": sv_shapes}))
    smi = nvidia_smi("name,power.limit")
    log(json.dumps({"kernels": kernels}))
    log(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
