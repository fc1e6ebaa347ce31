"""Build the CUDA kernels in ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into
``build/janus_tpu_torch/lib<name>-<hash>.so`` (or under the directory
given to :func:`set_build_dir`; ``sm_90a``, a plain C
interface, no PyTorch headers), keyed by a hash of its source, the shared
headers beside it and the flags, so an edited source rebuilds and an
unchanged one is reused.  ``build()`` starts one nvcc per source, all at
once, and waits for them all.  A source is named as ``"keccak"``
(``csrc/keccak.cu``) or given as a path to a ``.cu`` file with the same C
interface (to time one source against another).  There is no fallback: a
missing nvcc or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parent / "csrc"
#: where built libraries go, the CUDA kernels' and the host XOF's
#: (``native.py``); :func:`set_build_dir` moves it
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "janus_tpu_torch"
SOURCES = ("keccak", "flp_wire", "flp_sumvec", "flp_combine", "field_dot")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

#: nvcc's output (ptxas register and spill report) of the builds this
#: process ran, by source name.
BUILD_LOGS: Dict[str, str] = {}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


class BuildError(RuntimeError):
    pass


def set_build_dir(path) -> None:
    """Build into ``path`` from now on (a fleet's shared build root: every
    library is named by a hash of its source and flags, and written to a
    per-process temporary name and renamed, so processes and versions can
    share it)."""
    global BUILD_DIR
    BUILD_DIR = Path(path)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(cand):
        raise BuildError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return cand


def source_path(name: str) -> Path:
    """``csrc/<name>.cu``, or ``name`` itself where it is a ``.cu`` path."""
    return Path(name).resolve() if name.endswith(".cu") else CSRC / f"{name}.cu"


def library_path(name: str) -> Path:
    source = source_path(name)
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(source.parent.glob("*.cuh")) + [source]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_DIR / f"lib{source.stem}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> None:
    """Compile every named source whose library is missing, in parallel."""
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(source_path(name))]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        procs[name] = (proc, tmp, out)
    errors = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOGS[name] = log
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            errors.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if errors:
        raise BuildError("\n".join(errors))


def ptxas_report(name: str) -> List[str]:
    """The entry-function, register, shared-memory and spill lines of ptxas's
    report on the build of ``name`` that this process ran (none where it
    reused a library)."""
    keys = ("entry function", "registers", "spill")
    return [line.strip() for line in BUILD_LOGS.get(name, "").splitlines() if any(k in line for k in keys)]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")
