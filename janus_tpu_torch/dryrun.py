"""A dry run of the multi-card prepare: ``dryrun_multichip(n_devices)``.

The port's twin of the JAX package's ``__graft_entry__.dryrun_multichip``:
Prio3Count with 2n reports sharded by the port's oracle, both aggregators'
prepare over an n-shard ``MeshBackend``, then the combine, the decide and
the aggregate, checked against the exact count.  On the card by default:
the shards go round-robin over the visible cards (more shards than cards
makes logical shards, which share a card); ``device="cpu"`` (or any one
device) puts all n shards on that device.

Run as ``python -m janus_tpu_torch.dryrun N [--device cpu]``.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np
import torch


def mesh_devices(n_devices: int, device=None) -> List[torch.device]:
    """n shard devices: round-robin over the visible cards (``device``
    None), else ``device`` n times."""
    from .vdaf.prio3 import VdafError

    if n_devices < 1:
        raise ValueError("a mesh needs at least one shard")
    if device is not None:
        return [torch.device(device)] * n_devices
    if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
        raise VdafError("dryrun_multichip runs on the card, and none is available (pass device='cpu')")
    cards = torch.cuda.device_count()
    return [torch.device("cuda", i % cards) for i in range(n_devices)]


def dryrun_multichip(n_devices: int, device: Optional[str] = None) -> int:
    """Both aggregators prepare 2n Prio3Count reports over an n-shard mesh,
    combine, decide and aggregate; raises unless every report is accepted
    and the unsharded aggregate is the exact count.  Prints
    ``dryrun_multichip ok: {n} devices, {B} reports, count={total}`` and
    returns the count."""
    from .vdaf.backend import MeshBackend
    from .vdaf.instances import prio3_count

    devices = mesh_devices(n_devices, device)
    vdaf = prio3_count()
    rng = np.random.default_rng(1234)
    verify_key = rng.bytes(vdaf.VERIFY_KEY_SIZE)
    B = 2 * n_devices
    measurements = [i % 2 for i in range(B)]
    reports = []
    for m in measurements:
        nonce = rng.bytes(vdaf.NONCE_SIZE)
        public_share, input_shares = vdaf.shard(m, nonce, rng.bytes(vdaf.RAND_SIZE))
        reports.append((nonce, public_share, input_shares))

    mesh = MeshBackend(vdaf, devices=devices)
    sides = []
    for agg_id in range(vdaf.num_shares):
        outcomes = mesh.prep_init_batch(verify_key, agg_id, [(n, p, s[agg_id]) for n, p, s in reports])
        bad = [b for b, o in enumerate(outcomes) if isinstance(o, Exception)]
        if bad:
            raise AssertionError(f"dryrun_multichip: aggregator {agg_id} rejected valid reports {bad}")
        sides.append(outcomes)
    msgs = mesh.prep_shares_to_prep_batch([[side[b][1] for side in sides] for b in range(B)])
    rejected = [b for b, m in enumerate(msgs) if isinstance(m, Exception)]
    if rejected:
        raise AssertionError(f"dryrun_multichip: the decide rejected valid reports {rejected}")
    f = mesh.bp.f
    mask = np.ones(B, dtype=bool)
    aggs = []
    for side in sides:
        limbs = f.to_limbs([x for state, _share in side for x in state.out_share]).reshape(B, -1, f.n)
        aggs.append(mesh.aggregate_batch(limbs, mask))
    total = vdaf.unshard(aggs, B)
    if total != sum(measurements):
        raise AssertionError(f"dryrun_multichip: aggregate {total} != {sum(measurements)}")
    print(f"dryrun_multichip ok: {n_devices} devices, {B} reports, count={total}")
    return total


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_devices", type=int)
    ap.add_argument("--device", default=None, help="put every shard on this device (e.g. cpu)")
    args = ap.parse_args()
    dryrun_multichip(args.n_devices, args.device)


if __name__ == "__main__":
    main()
