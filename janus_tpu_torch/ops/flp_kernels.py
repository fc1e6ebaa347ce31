"""FLP kernels and their wrappers: histogram wires (K3), SumVec wires (K5)
and the planar combine-decide (K4).

Counterparts of ``janus_tpu/ops/flp_pallas.py``.  Inputs are word-major
planes in int32 storage (all but K4's peer verifier, below): m and the
proof are the raw share streams (element e, limb l at word e*n + l);
coefficient planes are (elems, n, B); outputs are (elems, n, B) canonical
with no pad columns past chunk.

K3, ``wire_evals`` (Pallas ``_wire_kernel``), for every chunk column u:

    evens[u] = (sum_k m[k*chunk + u] * kl[k]) * r_ch[u]
    odds[u]  =  sum_k m[k*chunk + u] * lagk[k]  -  ccorr
    ev[u]    =  seed_even[u] * lag0 + evens[u]
    od[u]    =  seed_odd[u]  * lag0 + odds[u]

with r_ch (chunk, n, B), kl/lagk (calls, n, B), lag0/ccorr (n, B) in
Montgomery form (ccorr canonical).

K5, ``sumvec_wires`` (Pallas ``_sumvec_partial_kernel`` under the slab scan
of ``_sumvec_wires_planar``): the same with the SumVec coefficient, whose
joint rand is per call and whose power resets each call,

    evens[u] = sum_k m[k*chunk + u] * jr_k^(u+1) * lagk[k]

with jr (calls, n, B) Montgomery; odds, ev and od as above.

K4, ``combine_decide`` (Pallas ``_combine_decide_kernel``): the
ParallelSum(Mul) gadget over the combined wires,

    g = sum_u mont_mul(he[u] + pe[u], ho[u] + po[u])

with he/ho our (chunk, n, B) wire planes and pe/po the peer's zipped wires,
elements 1 + 2u and 2 + 2u of its verifier rows (B, VER, n) of int64 words,
read as they arrive -> g (n, B).

Each wrapper launches its ``csrc/`` kernel for tensors on the card (or
raises) and takes its ``*_plain`` version only for tensors on the CPU;
``launches`` on each wrapper counts its kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .. import _build
from .field import TField, field_words, limb_list, limb_stack, storage, words

_P = ctypes.c_void_p
_I = ctypes.c_int


def _kernel(source: str, fn: str, pointers: int, ints: int):
    """The C entry point ``fn`` of ``csrc/<source>.cu``: ``pointers`` device
    pointers, then ``ints`` ints, then the stream; returns cudaError_t."""
    entry = getattr(_build.load(source), fn)
    entry.argtypes = [_P] * pointers + [_I] * ints + [_P]
    entry.restype = _I
    return entry


def _check_planes(what: str, B: int, *planes: torch.Tensor) -> None:
    if any(t.dtype != torch.int32 or not t.is_contiguous() or t.shape[-1] != B for t in planes):
        raise ValueError(f"{what}: want contiguous int32 planes with the report axis last")
    if any(t.device != planes[0].device for t in planes):
        raise ValueError(f"{what}: every plane must lie on the same device")


def _stream(x: torch.Tensor) -> int:
    """The current stream of ``x``'s card; every launch runs inside
    ``torch.cuda.device(x.device)``, since the C entry points launch on the
    CUDA runtime's current device (K5's shared-memory attribute is set
    there too)."""
    return torch.cuda.current_stream(x.device).cuda_stream


def wire_evals_plain(
    f: TField,
    meas_len: int,
    chunk: int,
    m: torch.Tensor,
    proof: torch.Tensor,
    rch: torch.Tensor,
    kl: torch.Tensor,
    lagk: torch.Tensor,
    lag0: torch.Tensor,
    ccorr: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K3 (same inputs and outputs as ``wire_evals``)."""
    n = f.n
    B = m.shape[-1]
    calls = kl.numel() // (n * B)
    m_el = field_words(words(m), meas_len, n)  # (meas_len, n, B)
    kl_el = words(kl).reshape(calls, n, B)
    lagk_el = words(lagk).reshape(calls, n, B)
    s1 = s2 = None
    for k in range(calls):
        mk = m_el[k * chunk : min((k + 1) * chunk, meas_len)]
        if mk.shape[0] < chunk:  # the circuit's zero padding of the last call
            pad = torch.zeros((chunk - mk.shape[0], n, B), dtype=torch.int64, device=m.device)
            mk = torch.cat([mk, pad], dim=0)
        mk = limb_list(mk)
        t1 = f.mont_mul_limbs(mk, limb_list(kl_el[k : k + 1]))
        t2 = f.mont_mul_limbs(mk, limb_list(lagk_el[k : k + 1]))
        s1 = t1 if s1 is None else f.add_limbs(s1, t1)
        s2 = t2 if s2 is None else f.add_limbs(s2, t2)
    evens = f.mont_mul_limbs(s1, limb_list(words(rch).reshape(chunk, n, B)))
    odds = f.sub_limbs(s2, limb_list(words(ccorr).reshape(1, n, B)))
    lag0_l = limb_list(words(lag0).reshape(1, n, B))
    seeds = field_words(words(proof), 2 * chunk, n)
    ev = f.add_limbs(f.mont_mul_limbs(limb_list(seeds[0::2]), lag0_l), evens)
    od = f.add_limbs(f.mont_mul_limbs(limb_list(seeds[1::2]), lag0_l), odds)
    return storage(limb_stack(ev)), storage(limb_stack(od))


def wire_evals(
    f: TField,
    meas_len: int,
    chunk: int,
    m: torch.Tensor,
    proof: torch.Tensor,
    rch: torch.Tensor,
    kl: torch.Tensor,
    lagk: torch.Tensor,
    lag0: torch.Tensor,
    ccorr: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3 wrapper -> (ev, od), each (chunk, n, B) int32 canonical."""
    n = f.n
    B = m.shape[-1]
    calls = kl.numel() // (n * B)
    args = (m, proof, rch, kl, lagk, lag0, ccorr)
    _check_planes("wire_evals", B, *args)
    if m.numel() // B < meas_len * n or proof.numel() // B < 2 * chunk * n:
        raise ValueError("wire_evals: share streams are shorter than the circuit")
    if kl.numel() != calls * n * B or lagk.numel() != kl.numel():
        raise ValueError("wire_evals: kl and lagk must both be (calls, n, B)")
    if rch.numel() // B != chunk * n or lag0.numel() // B != n or ccorr.numel() // B != n:
        raise ValueError("wire_evals: coefficient planes have the wrong shape")
    if m.device.type == "cpu":
        return wire_evals_plain(f, meas_len, chunk, m, proof, rch, kl, lagk, lag0, ccorr)
    if n != 4:
        raise NotImplementedError("the CUDA wire kernel serves Field128 only")
    if chunk > 65535:
        raise NotImplementedError("chunk exceeds the kernel's grid y dimension")
    ev = torch.empty((chunk, n, B), dtype=torch.int32, device=m.device)
    od = torch.empty_like(ev)
    entry = _kernel("flp_wire", "janus_wire_evals", 9, 4)
    with torch.cuda.device(m.device):
        err = entry(
            *(t.data_ptr() for t in args), ev.data_ptr(), od.data_ptr(), B, meas_len, chunk, calls, _stream(m),
        )
    _build.check(err, "janus_wire_evals")
    wire_evals.launches += 1
    return ev, od


wire_evals.launches = 0


# -- K5: SumVec wires ----------------------------------------------------------

def sumvec_wires_plain(
    f: TField,
    meas_len: int,
    chunk: int,
    m: torch.Tensor,
    proof: torch.Tensor,
    jr: torch.Tensor,
    lagk: torch.Tensor,
    lag0: torch.Tensor,
    ccorr: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K5 (same inputs and outputs as ``sumvec_wires``).
    The calls are taken 32 at a time, so the (calls, chunk) power table is
    never whole in memory."""
    slab = 32
    n = f.n
    B = m.shape[-1]
    calls = jr.numel() // (n * B)
    m_el = field_words(words(m), meas_len, n)
    pad = calls * chunk - meas_len  # the circuit's zero padding of the last call
    if pad:
        m_el = torch.cat([m_el, torch.zeros((pad, n, B), dtype=torch.int64, device=m.device)])
    m_el = m_el.reshape(calls, chunk, n, B)
    jr_el = words(jr).reshape(calls, n, B)
    lag_el = words(lagk).reshape(calls, n, B)
    s1 = s2 = None
    for k0 in range(0, calls, slab):
        mk = limb_list(m_el[k0 : k0 + slab])  # n x (kc, chunk, B)
        lk = [x[:, None] for x in limb_list(lag_el[k0 : k0 + slab])]  # n x (kc, 1, B)
        pw = [x.transpose(1, 2) for x in f.pow_range_limbs(limb_list(jr_el[k0 : k0 + slab]), chunk)]
        klu = f.mont_mul_limbs(pw, lk)  # jr_k^(u+1) * lag_{k+1}, Montgomery
        t1 = f.sum(torch.stack(f.mont_mul_limbs(mk, klu), dim=-1), axis=0)  # (chunk, B, n)
        t2 = f.sum(torch.stack(f.mont_mul_limbs(mk, lk), dim=-1), axis=0)
        s1 = t1 if s1 is None else f.add(s1, t1)
        s2 = t2 if s2 is None else f.add(s2, t2)
    odds = f.sub(s2, words(ccorr).reshape(n, B).transpose(0, 1))
    lag0_r = words(lag0).reshape(n, B).transpose(0, 1)
    seeds = field_words(words(proof), 2 * chunk, n).permute(0, 2, 1)  # (2*chunk, B, n)
    ev = f.add(f.mont_mul(seeds[0::2], lag0_r), s1)
    od = f.add(f.mont_mul(seeds[1::2], lag0_r), odds)
    return storage(ev.permute(0, 2, 1)).contiguous(), storage(od.permute(0, 2, 1)).contiguous()


def sumvec_wires(
    f: TField,
    meas_len: int,
    chunk: int,
    m: torch.Tensor,
    proof: torch.Tensor,
    jr: torch.Tensor,
    lagk: torch.Tensor,
    lag0: torch.Tensor,
    ccorr: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5 wrapper -> (ev, od), each (chunk, n, B) int32 canonical."""
    n = f.n
    B = m.shape[-1]
    calls = jr.numel() // (n * B)
    args = (m, proof, jr, lagk, lag0, ccorr)
    _check_planes("sumvec_wires", B, *args)
    if m.numel() // B < meas_len * n or proof.numel() // B < 2 * chunk * n:
        raise ValueError("sumvec_wires: share streams are shorter than the circuit")
    if jr.numel() != calls * n * B or lagk.numel() != jr.numel() or calls * chunk < meas_len:
        raise ValueError("sumvec_wires: jr and lagk must both be (calls, n, B) with calls*chunk >= meas_len")
    if lag0.numel() // B != n or ccorr.numel() // B != n:
        raise ValueError("sumvec_wires: lag0 and ccorr must be (n, B)")
    if m.device.type == "cpu":
        return sumvec_wires_plain(f, meas_len, chunk, m, proof, jr, lagk, lag0, ccorr)
    if n != 4:
        raise NotImplementedError("the CUDA SumVec wire kernel serves Field128 only")
    ev = torch.empty((chunk, n, B), dtype=torch.int32, device=m.device)
    od = torch.empty_like(ev)
    entry = _kernel("flp_sumvec", "janus_sumvec_wires", 8, 4)
    with torch.cuda.device(m.device):
        err = entry(
            *(t.data_ptr() for t in args), ev.data_ptr(), od.data_ptr(), B, meas_len, chunk, calls, _stream(m),
        )
    _build.check(err, "janus_sumvec_wires")
    sumvec_wires.launches += 1
    return ev, od


sumvec_wires.launches = 0


# -- K4: planar combine-decide ---------------------------------------------------

def combine_decide_plain(
    f: TField, chunk: int, he: torch.Tensor, ho: torch.Tensor, pv: torch.Tensor
) -> torch.Tensor:
    """Plain version of K4 (same inputs and output as ``combine_decide``)."""
    wires = words(pv[:, 1 : 1 + 2 * chunk]).permute(1, 2, 0)  # (2*chunk, n, B)
    xe = f.add_limbs(limb_list(words(he)), limb_list(wires[0::2]))
    xo = f.add_limbs(limb_list(words(ho)), limb_list(wires[1::2]))
    g = f.sum(torch.stack(f.mont_mul_limbs(xe, xo), dim=-1), axis=0)  # (B, n)
    return storage(g.transpose(0, 1)).contiguous()


def combine_decide(
    f: TField, chunk: int, he: torch.Tensor, ho: torch.Tensor, pv: torch.Tensor
) -> torch.Tensor:
    """K4 wrapper: our wire planes he/ho (chunk, n, B) int32 canonical and
    the peer's verifier pv as it arrives, rows (B, 2*chunk + 2, n) of int64
    canonical words (read in place: the low 32 bits of each) -> g (n, B)
    int32 canonical, scaled by R^-1."""
    n = f.n
    B = he.shape[-1]
    _check_planes("combine_decide", B, he, ho)
    if he.shape != (chunk, n, B) or ho.shape != he.shape:
        raise ValueError("combine_decide: he and ho must both be (chunk, n, B)")
    if pv.dtype != torch.int64 or not pv.is_contiguous() or pv.shape != (B, 2 * chunk + 2, n):
        raise ValueError("combine_decide: the peer verifier must be contiguous int64 rows (B, 2*chunk + 2, n)")
    if pv.device != he.device:
        raise ValueError("combine_decide: every tensor must lie on the same device")
    if he.device.type == "cpu":
        return combine_decide_plain(f, chunk, he, ho, pv)
    if n != 4:
        raise NotImplementedError("the CUDA combine kernel serves Field128 only")
    g = torch.empty((n, B), dtype=torch.int32, device=he.device)
    entry = _kernel("flp_combine", "janus_combine_decide", 4, 3)
    with torch.cuda.device(he.device):
        err = entry(
            he.data_ptr(), ho.data_ptr(), pv.data_ptr(), g.data_ptr(), B, chunk, pv.shape[1], _stream(he),
        )
    _build.check(err, "janus_combine_decide")
    combine_decide.launches += 1
    return g


combine_decide.launches = 0
