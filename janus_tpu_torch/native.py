"""The host TurboSHAKE128 XOF in C++, loaded with ctypes.

Builds ``csrc/turboshake.cpp`` (the C++ TurboSHAKE128 sponge and VDAF XOF
field expansion) with one ``g++ -O3 -shared -fPIC`` into the build
directory of ``_build.py`` as ``libjanusts-<hash>.so``, named by a hash of
the source, and loads it.  The build writes a per-process temporary file
and renames it, so that several binaries starting cold at once never load
a half-written library.  ``XofTurboShake128.expand_into_vec`` takes this
path for Field64 and Field128; the pure Python sponge stays for any other
field, and for these two when the library is unavailable (no compiler, a
failed build, or ``JANUS_TPU_TORCH_NATIVE=0``).  Every such fallback is
counted (:func:`fallbacks`) and the first is logged.  The outputs are
byte-equal either way (``tests/test_torch_native.py``).

This is host code: the batched prepare on the card squeezes with the
Keccak kernels of ``csrc/keccak.cu``.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np

from . import _build

logger = logging.getLogger("janus_tpu_torch.native")

SOURCE = _build.CSRC / "turboshake.cpp"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")
#: the two moduli the C++ rejection sampler hardcodes: Field64, Field128
MODULI = (2**64 - 2**32 + 1, 2**128 - 7 * 2**66 + 1)

_lib: Optional[ctypes.CDLL] = None
_tried = False
_lock = threading.Lock()
_fallbacks = 0


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return _build.BUILD_DIR / f"libjanusts-{h.hexdigest()[:16]}.so"


def _build_library(out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(
            ["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE)],
            check=True,
            capture_output=True,
            timeout=120,
        )
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)


def load() -> Optional[ctypes.CDLL]:
    """The loaded library, built on first use; None where it is switched
    off or cannot be built or loaded (logged once)."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if os.environ.get("JANUS_TPU_TORCH_NATIVE", "1") == "0":
            logger.info("native host XOF switched off (JANUS_TPU_TORCH_NATIVE=0)")
            return None
        try:
            path = library_path()
            if not path.exists():
                _build_library(path)
            lib = ctypes.CDLL(str(path))
        except Exception as e:
            logger.warning("native host XOF unavailable, using the pure Python sponge: %s", e)
            return None
        lib.ts128_hash.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_uint8,
            ctypes.c_char_p, ctypes.c_size_t,
        ]
        lib.ts128_expand_vdaf.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_size_t,
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p, ctypes.c_size_t,
        ]
        lib.ts128_next_vec.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_size_t,
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_size_t,
        ]
        lib.ts128_next_vec.restype = ctypes.c_int
        _lib = lib
        return _lib


def fallbacks() -> int:
    """Expansions over Field64 or Field128 that took the pure Python
    sponge because the library was unavailable."""
    return _fallbacks


def note_fallback() -> None:
    global _fallbacks
    with _lock:
        _fallbacks += 1


def _validate(seed: bytes, dst: bytes) -> None:
    """The Python XOF's input contract: the C ABI reads exactly 16 seed
    bytes and one byte of dst length."""
    if len(seed) != 16:
        raise ValueError("bad seed size")
    if len(dst) > 255:
        raise ValueError("dst too long")


def turboshake128(message: bytes, domain: int, length: int) -> Optional[bytes]:
    lib = load()
    if lib is None:
        return None
    out = ctypes.create_string_buffer(length)
    lib.ts128_hash(message, len(message), domain, out, length)
    return out.raw


def xof_stream(seed: bytes, dst: bytes, binder: bytes, length: int) -> Optional[bytes]:
    """``length`` bytes of the XofTurboShake128 stream."""
    lib = load()
    if lib is None:
        return None
    _validate(seed, dst)
    out = ctypes.create_string_buffer(length)
    lib.ts128_expand_vdaf(seed, dst, len(dst), binder, len(binder), out, length)
    return out.raw


def next_vec(seed: bytes, dst: bytes, binder: bytes, modulus: int, length: int) -> Optional[List[int]]:
    """``length`` rejection-sampled elements of the field of ``modulus``
    (one of :data:`MODULI`); None where the library is unavailable."""
    lib = load()
    if lib is None:
        return None
    _validate(seed, dst)
    wide = MODULI.index(modulus)
    out = (ctypes.c_uint64 * (2 * length))()
    if lib.ts128_next_vec(seed, dst, len(dst), binder, len(binder), wide, out, length) != 0:
        return None
    pairs = np.frombuffer(out, dtype=np.uint64).reshape(length, 2)
    if not wide:
        return pairs[:, 0].tolist()
    return [lo | (hi << 64) for lo, hi in pairs.tolist()]
