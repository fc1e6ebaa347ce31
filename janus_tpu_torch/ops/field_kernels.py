"""The limb-digit matmul's reduce kernel and its wrapper.

``TField.mat_mul_mont`` (``ops/field.py``) contracts base-2^8 digit planes
as one float64 matmul and hands the digit-pair partial sums P (..., M, D, N,
D) (D = 4n, integers below 2^32) to ``lazy_reduce_digits``, which folds
each output element's D^2 sums into canonical limbs with one Montgomery
reduction.  Counterpart of ``JField._lazy_reduce_digits``
(``janus_tpu/ops/field_jax.py``), which XLA fuses into one pass; on the card
it is one launch of ``csrc/field_dot.cu``, where eager PyTorch would issue a
few hundred elementwise launches.

The wrapper launches the kernel for a tensor on the card (or raises) and
takes the plain version, ``TField._lazy_reduce_digits``, only for a tensor
on the CPU; ``lazy_reduce_digits.launches`` counts its kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .field import TField, storage


def _entry():
    entry = _build.load("field_dot").janus_digit_reduce
    entry.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                      ctypes.c_uint64, ctypes.c_uint64, ctypes.c_void_p]
    entry.restype = ctypes.c_int
    return entry


def lazy_reduce_digits_plain(f: TField, P: torch.Tensor) -> torch.Tensor:
    """Plain version of the reduce kernel (same input and output)."""
    return storage(f._lazy_reduce_digits(P))


def lazy_reduce_digits(f: TField, P: torch.Tensor) -> torch.Tensor:
    """Digit-pair partial sums P (..., M, D, N, D) -> canonical limbs (...,
    M, N, n) in int32 storage: sum_k mont_mul(a_k, b_k) for the digit planes
    of a and b whose product P is.  On the card P must be contiguous
    float64, as the digit matmul gives it."""
    n, D = f.n, 4 * f.n
    if P.dim() < 4 or P.shape[-3] != D or P.shape[-1] != D:
        raise ValueError(f"lazy_reduce_digits: want partial sums (..., M, {D}, N, {D}), got {tuple(P.shape)}")
    if P.device.type == "cpu":
        return lazy_reduce_digits_plain(f, P)
    if P.dtype != torch.float64 or not P.is_contiguous() or P.data_ptr() % 16:
        raise ValueError("lazy_reduce_digits: want contiguous, 16-byte aligned float64 partial sums")
    if n not in (2, 4):
        raise NotImplementedError("the CUDA reduce kernel serves Field64 and Field128")
    cols = P.shape[-2]
    out = torch.empty(P.shape[:-3] + (cols, n), dtype=torch.int32, device=P.device)
    rows = P.numel() // (D * cols * D)
    r2 = [int(x) for x in f.r2_np] + [0] * (4 - n)
    entry = _entry()
    # the C entry launches on the runtime's current device: make it P's card
    with torch.cuda.device(P.device):
        err = entry(P.data_ptr(), out.data_ptr(), rows, cols, n, r2[0] | (r2[1] << 32), r2[2] | (r2[3] << 32),
                    torch.cuda.current_stream(P.device).cuda_stream)
    _build.check(err, "janus_digit_reduce")
    lazy_reduce_digits.launches += 1
    return out


lazy_reduce_digits.launches = 0
