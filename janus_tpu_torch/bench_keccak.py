"""Time the K1 squeeze and K2 absorb kernels of Keccak sources against each
other on one card, at the shapes of the port's main paths.

    python -m janus_tpu_torch.bench_keccak [--source PATH.cu ...]

Each source is a ``.cu`` file with the C interface of ``csrc/keccak.cu``
(``janus_keccak_squeeze`` and ``janus_keccak_absorb``); the default is that
file alone.  The sources are built and loaded as the port's own are
(``_build``, one nvcc each, all at once) and run on the same random word
planes:

- SumVec100k: K1 (42, 1024) -> 400,000 words (9,524 blocks); K2 9,525
  blocks x 1024 -> 4 words;
- Histogram(1024): K1 (42, 4096) -> 4,096 words (98 blocks); K2 98 blocks
  x 4096 -> 4 words;
- K1 at the histogram's 98 blocks at smaller batches (792 to 3168),
  where the busiest SM holds 1 to 4 warps.

Every source's outputs must equal the first's bit for bit.  Times are CUDA
events around back-to-back launches, the median of 3 rounds taken with the
sources in turns (A B ... B A), so that a drift of the card's clock falls on
all of them alike.  Prints each source's ptxas lines, then one JSON line per
source with the card's name, power limit and largest SM clock.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import torch

from . import _build
from .ops.keccak_kernels import _lib

ROUNDS = 3
#: (name, kernel, B, blocks, out_words, back-to-back launches per round)
SHAPES = (
    ("sumvec", "squeeze", 1024, 9524, 400000, 3),
    ("sumvec", "absorb", 1024, 9525, 4, 3),
    ("histogram", "squeeze", 4096, 98, 4096, 20),
    ("histogram", "absorb", 4096, 98, 4, 20),
) + tuple((f"B{B}", "squeeze", B, 98, 4096, 20) for B in (792, 1024, 1584, 2376, 3168))


def launcher(fn, msg, out, B, blocks, out_words):
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        _build.check(fn(msg.data_ptr(), out.data_ptr(), B, blocks, out_words, stream), fn.__name__)

    return launch


def time_ms(launch, reps: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        launch()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", action="append", help="a keccak .cu source (repeatable)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_keccak: no CUDA device")
    sources = args.source or ["keccak"]
    _build.build(sources)
    for s in sources:
        print(json.dumps({"source": s, "ptxas": _build.ptxas_report(s)}))
    libs = [_lib(s) for s in sources]
    gen = torch.Generator(device="cuda").manual_seed(0)
    times = {s: {} for s in sources}
    for shape, kernel, B, blocks, out_words, reps in SHAPES:
        rows = 42 if kernel == "squeeze" else 42 * blocks
        msg = torch.randint(-(2**31), 2**31, (rows, B), generator=gen, device="cuda", dtype=torch.int32)
        outs = [torch.empty((out_words, B), dtype=torch.int32, device="cuda") for _ in sources]
        launches = [launcher(getattr(lib, f"janus_keccak_{kernel}"), msg, out, B, blocks, out_words)
                    for lib, out in zip(libs, outs)]
        for launch in launches:
            launch()
        torch.cuda.synchronize()
        for s, out in zip(sources[1:], outs[1:]):
            if not torch.equal(out, outs[0]):
                raise AssertionError(f"{s}: {kernel} at the {shape} shape differs from {sources[0]}")
        per = [[] for _ in sources]
        order = list(range(len(sources)))
        for r in range(ROUNDS):
            for i in order if r % 2 == 0 else order[::-1]:
                per[i].append(time_ms(launches[i], reps))
        for s, samples in zip(sources, per):
            times[s][f"{kernel}_{shape}_ms"] = statistics.median(samples)
        del msg, outs
        torch.cuda.empty_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    for s in sources:
        print(json.dumps({"source": s, "card": smi, **times[s]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
